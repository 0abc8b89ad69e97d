"""Decompose insert_batch wall time on the card.

Times three jitted programs (median of 5, slope-free: these are steady-state
per-batch costs) at the config-4 shape (active depth 16, K=4096):

  * sort   — the 9-key packed lexicographic sort over N+K entries
  * hash   — the exact hash schedule of the width-switch update path
             (leaf hash3 at 2K + dirty hash2 levels + full-rebuild chain)
  * step   — the full _insert_batch_fn program

step − (sort + hash) ≈ planner glue (gathers/scatters/cummax/cummin).

Usage: python tools/profile_batch.py [--depth 16] [--k 4096]
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

# imt_tpu is an installed package (pip install -e . — pyproject.toml)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--depth", type=int, default=16)
    ap.add_argument("--k", type=int, default=4096)
    args = ap.parse_args()

    import jax
    from imt_tpu.utils.cache import setup_compile_cache
    setup_compile_cache()
    import jax.numpy as jnp
    import numpy as np
    from imt_tpu.ops import field, hashing
    from imt_tpu.tree import indexed

    depth, k = args.depth, args.k
    n, m = 1 << depth, (1 << depth) + k

    import random
    rng = random.Random(1)
    tree = indexed.IndexedMerkleTree(depth)
    tree.insert_batch([rng.randrange(1, 1 << 253) for _ in range(k)])
    new_vals = jnp.asarray(field.ints_to_limbs(
        [rng.randrange(1, 1 << 253) for _ in range(k)]))

    @jax.jit
    def sort_only(vals, nv):
        all_vals = jnp.concatenate([vals, nv], axis=1)
        packed = tuple(
            (all_vals[2 * j + 1] << 16) | all_vals[2 * j]
            for j in range(field.LIMBS // 2 - 1, -1, -1))
        out = jax.lax.sort(
            packed + (jnp.arange(m, dtype=jnp.uint32),
                      jnp.arange(m, dtype=jnp.int32)), num_keys=9)
        return out[-1][:1]

    cross = indexed._crossover(depth, k)

    @jax.jit
    def hash_only(vals, nv, levels):
        # leaf hash3 of the dirty set + the slab/low level schedule
        h = hashing.hash3_leaf(vals[:, :2 * k], vals[:, :2 * k],
                               vals[:, :2 * k])
        low_idx = jnp.arange(k, dtype=jnp.int32) * 3 % (n - 1)
        out = indexed._update_paths_batch(
            levels, low_idx, h[:, :k], jnp.int32(1), h[:, k:], depth, cross)
        return hashing.dec_nodes(out[-1])

    step = indexed._insert_batch_fn(depth, k, tree.node_repr)

    @jax.jit
    def null_prog(vals):
        return vals[:1, :1] + 1

    # planner stage prefixes (XLA DCE trims everything not needed by the
    # returned slice, so each is a true prefix of _plan_batch's cost)
    @jax.jit
    def plan_sorted(vals, nvs, nis, nv):
        all_vals = jnp.concatenate([vals, nv], axis=1)
        packed = tuple((all_vals[2 * j + 1] << 16) | all_vals[2 * j]
                       for j in range(field.LIMBS // 2 - 1, -1, -1))
        sorted_ops = jax.lax.sort(
            packed + (jnp.arange(m, dtype=jnp.uint32),
                      jnp.arange(m, dtype=jnp.int32)), num_keys=9)
        order = sorted_ops[-1]
        sv = jnp.take(all_vals, order, axis=1)
        return sv[:, :1]

    @jax.jit
    def plan_full(vals, nvs, nis, nv):
        out = indexed._plan_batch(vals, nvs, nis, nv, jnp.int32(tree.count),
                                  n, k)
        (vals2, nvs2, nis2, low_idx, low_hash, slab_start, slab_hash,
         ok) = out
        return (vals2[:, :1], nvs2[:, :1], nis2[:, :1], low_idx[:1],
                low_hash[:, :1], slab_hash[:, :1], ok[:1])

    from imt_tpu.tree.batch_witness import _insert_batch_witness_fn
    wstep = _insert_batch_witness_fn(depth, k, depth, tree.node_repr)

    @jax.jit
    def whash_only(vals, levels):
        # the witness walk's hash floor: depth levels of width-2K hash2
        # plus the 2K leaf hash3 (no sorts, no merges)
        cur = hashing.hash3_leaf(vals[:, :2 * k], vals[:, :2 * k],
                                 vals[:, :2 * k])
        for _ in range(depth):
            cur = hashing.hash2_nodes(cur, cur)
        return hashing.dec_nodes(cur[:, :1])

    progs = {
        "null": lambda: null_prog(tree.vals),   # fixed per-sync RPC floor
        "plan_sorted": lambda: plan_sorted(tree.vals, tree.next_vals,
                                           tree.next_idxs, new_vals),
        "plan_full": lambda: plan_full(tree.vals, tree.next_vals,
                                       tree.next_idxs, new_vals),
        "sort": lambda: sort_only(tree.vals, new_vals),
        "hash": lambda: hash_only(tree.vals, new_vals, tree.levels),
        "step": lambda: step(tree.vals, tree.next_vals, tree.next_idxs,
                             tree.levels, new_vals, jnp.int32(tree.count))[1],
        "whash": lambda: whash_only(tree.vals, tree.levels),
        # return proofs + roots + a column of every state level so neither
        # the level walk nor the final-state scatters are DCE'd
        "wstep": lambda: (lambda st, w: (w["new_root"][:, :1],
                                         w["low_leaf_proof"][:1, :, :1],
                                         w["new_leaf_proof"][:1, :, :1],
                                         tuple(l[:, -1:] for l in st[3])))(
            *wstep(tree.vals, tree.next_vals, tree.next_idxs,
                   tree.levels, new_vals, jnp.int32(tree.count))),
    }
    for name, f in progs.items():
        t0 = time.time()
        np.asarray(jax.tree_util.tree_leaves(f())[0])
        print(f"compile {name}: {time.time()-t0:.0f}s", flush=True)
    for name, f in progs.items():
        ts = []
        for _ in range(5):
            t0 = time.time()
            np.asarray(jax.tree_util.tree_leaves(f())[0])
            ts.append(time.time() - t0)
        print(f"{name:5s}: median {statistics.median(ts)*1e3:7.2f} ms "
              f"(min {min(ts)*1e3:.2f})", flush=True)


if __name__ == "__main__":
    main()

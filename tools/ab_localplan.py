"""Shard-local planner overhead at D=1 on one card.

Multi-device efficiency assumes local-plan compute ~= the single-device
batched step.  The local planner pays work that exists even at D=1: the
replicated planning work, the D-redundant wr-lane hashing, and the
candidate exchange.  This tool measures both paths on the SAME pre-staged
batches at the config-4/5 shapes, interleaved rounds + warm-round discard +
median (the repo's steady-state protocol), and prints the overhead ratio.

Usage:  python tools/ab_localplan.py [--config 4|5] [--rounds 4]
"""

from __future__ import annotations

import argparse
import statistics
import time

# imt_tpu is an installed package (pip install -e . — pyproject.toml)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=["4", "5"], default="4")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()

    import jax
    from imt_tpu.utils.cache import setup_compile_cache
    setup_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from imt_tpu.ops import field
    from imt_tpu.parallel import local_plan, sharded
    from imt_tpu.tree.sparse import SparseIndexedMerkleTree

    if args.config == "4":
        depth, k, iters = 24, 4096, 14
    else:
        depth, k, iters = 32, 65536, 15
    cap = max(14, (k * (iters + 1) + 2).bit_length())
    mesh = sharded.make_mesh(1)

    print(f"config {args.config}: depth={depth} K={k} iters={iters} "
          f"cap=2^{cap} (D=1 mesh)", flush=True)
    batches = [jax.device_put(field.random_limbs(0xAB10 + i, k))
               for i in range(iters + 1)]
    for b_ in batches:
        b_.block_until_ready()

    def fresh():
        return SparseIndexedMerkleTree(depth, initial_capacity_log2=cap)

    # --- path A: plain single-device batched step (indexed._insert_batch_fn)
    def run_plain():
        t = fresh()
        np.asarray(t.insert_batch(batches[0], as_numpy=False))     # warm
        t0 = time.time()
        oks = [t.insert_batch(v, as_numpy=False) for v in batches[1:]]
        np.asarray(jnp.stack(oks)).sum()
        return iters * k / (time.time() - t0)

    # --- path B: shard-local planner on a 1-device mesh
    def run_local():
        t = fresh()
        np.asarray(local_plan.local_insert_batch(t, batches[0], mesh, k))
        t0 = time.time()
        oks = [local_plan.local_insert_batch(t, v, mesh, k)
               for v in batches[1:]]
        np.asarray(jnp.stack(oks)).sum()
        return iters * k / (time.time() - t0)

    paths = {"plain": run_plain, "local": run_local}
    # compile + first-execution warmup outside the timed rounds
    for name, fn in paths.items():
        t0 = time.time()
        fn()
        print(f"{name}: compile+first round {time.time()-t0:.1f}s",
              flush=True)

    rates = {name: [] for name in paths}
    for r in range(args.rounds):
        for name, fn in paths.items():
            rates[name].append(fn())
            print(f"round {r} {name}: {rates[name][-1]:,.0f} inserts/s"
                  + (" (warmup, discarded)" if r == 0 else ""), flush=True)

    med = {}
    print("\n=== medians (round 0 discarded) ===")
    for name in paths:
        med[name] = statistics.median(rates[name][1:]) \
            if args.rounds > 1 else rates[name][0]
        print(f"{name:6s} {med[name]:,.0f} inserts/s")
    print(f"\nlocal-plan D=1 overhead: local/plain = "
          f"{med['local'] / med['plain']:.3f} "
          f"(~1.0 expected; <0.8 means the replicated planning + "
          f"wr-lane redundancy is material)")


if __name__ == "__main__":
    main()

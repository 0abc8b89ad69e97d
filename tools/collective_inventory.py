"""Compiled-HLO collective inventory of the GSPMD-partitioned tree ops.

Multi-device scaling assumes XLA partitions the batched-insert step
without materializing full-state collectives.  This tool CHECKS that:
it compiles the sharded programs on an N-virtual-device CPU mesh (GSPMD
partitioning is platform-independent — the collective structure is decided
at partitioning time, not by the target), inventories every collective in
the optimized HLO (kind, operand shape, bytes), and fails loudly if any
collective moves more than the new-values themselves + per-shard boundary
rows (i.e. if a full-state all-gather appears).

Usage:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python tools/collective_inventory.py [--devices 8] [--depth 12] [--k 256]

Writes the per-op table to stdout (markdown).
"""

from __future__ import annotations

import argparse
import os
import sys

# imt_tpu is an installed package (pip install -e . — pyproject.toml)

# shared audit core (also the failing test's backend —
# tests/test_parallel.py::test_collective_n_independence)
from imt_tpu.parallel.collective_audit import (   # noqa: E402
    audit_local_plan, inventory, shape_bytes)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--depth", type=int, default=12)
    ap.add_argument("--k", type=int, default=256)
    args = ap.parse_args()

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={args.devices}"
        ).strip()
    import jax
    try:
        jax.config.update("jax_platforms", "cpu")
    except Exception:
        pass
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from imt_tpu.ops import field
    from imt_tpu.parallel import sharded
    from imt_tpu.tree import indexed

    d = args.devices
    depth, k = args.depth, args.k
    n = 1 << depth
    mesh = sharded.make_mesh(d)
    shard = NamedSharding(mesh, P(None, "shard"))
    repl = NamedSharding(mesh, P())

    tree = indexed.IndexedMerkleTree(depth)
    state = (
        jax.device_put(tree.vals, shard),
        jax.device_put(tree.next_vals, shard),
        jax.device_put(tree.next_idxs, shard),
        tuple(jax.device_put(l, shard if l.shape[1] >= d else repl)
              for l in tree.levels),
    )
    import random
    rng = random.Random(7)
    new_vals = jax.device_put(jnp.asarray(field.ints_to_limbs(
        [rng.randrange(1, field.P) for _ in range(k)])), repl)

    state_bytes = n * 16 * 4            # one [16, N] uint32 leaf array
    reports = {}

    def report(name, fn, fn_args):
        hlo = jax.jit(fn).lower(*fn_args).compile().as_text()
        rows = inventory(hlo)
        agg = {}
        for kind, shape, nbytes in rows:
            key = (kind, shape, nbytes)
            agg[key] = agg.get(key, 0) + 1
        print(f"\n### {name} (devices={d}, depth={depth}, K={k})\n")
        print("| collective | output shape | bytes | count |")
        print("|---|---|---|---|")
        total = 0
        for (kind, shape, nbytes), cnt in sorted(
                agg.items(), key=lambda x: -x[0][2]):
            print(f"| {kind} | `{shape}` | {nbytes:,} | {cnt} |")
            total += nbytes * cnt
        print(f"\ntotal collective bytes/step: {total:,} "
              f"(one [16,N] state array = {state_bytes:,})")
        reports[name] = (rows, total)
        return rows, total

    step = indexed._insert_batch_fn(depth, k, tree.node_repr)
    report("insert_batch (GSPMD)", step, (*state, new_vals, jnp.int32(0)))

    from imt_tpu.tree.batch_witness import _insert_batch_witness_fn
    wstep = _insert_batch_witness_fn(depth, k, depth, tree.node_repr)
    report("insert_batch witness (GSPMD)", wstep,
           (*state, new_vals, jnp.int32(0)))

    qstep = indexed._non_inclusion_witness_fn(depth, k, depth, tree.node_repr)
    report("non_inclusion_witness (GSPMD)", qstep, (*state, new_vals))

    # the shard-local planner (parallel/local_plan.py): collectives must be
    # O(K) — candidate gathers, the sharded dirty-hash gather, one root
    # gather — with NOTHING proportional to N
    from imt_tpu.parallel import local_plan
    key = (tuple(dev.id for dev in mesh.devices.flat),)
    local_plan._MESHES[key] = mesh
    lstep = local_plan._local_insert_batch_fn(depth, k, d, key,
                                              tree.node_repr)
    nv1 = new_vals[None]                       # planner run takes [B, 16, K]
    lrows, _ = report("insert_batch (shard-local planner)", lstep.run,
                      (*state[:3], *state[3], nv1, jnp.int32(0)))

    # chained shard-local insert_batches: b batches, ONE program — per-batch
    # O(K) candidate exchange + dirty-hash gather, ONE root gather total
    bchain = 4
    lchain = local_plan._local_insert_batch_fn(depth, k, d, key,
                                               tree.node_repr, bchain)
    nvb = jnp.broadcast_to(new_vals, (bchain, *new_vals.shape))
    lcrows, _ = report(f"insert_batches chain b={bchain} (shard-local)",
                       lchain.run, (*state[:3], *state[3], nvb, jnp.int32(0)))

    lq = local_plan._local_non_inclusion_fn(depth, k, d, key, depth,
                                            tree.node_repr)
    lqrows, _ = report("non_inclusion_witness (shard-local)", lq.run,
                       (*state[:3], *state[3], new_vals))

    lw = local_plan._local_insert_batch_witness_fn(depth, k, d, key, depth,
                                                   tree.node_repr)
    lwrows, _ = report("insert_batch witness (shard-local)", lw.run,
                       (*state[:3], *state[3], new_vals, jnp.int32(0)))
    lrows = lrows + lqrows + lwrows

    # the check multi-device scaling hinges on: the LOCAL-PLAN paths'
    # collective volume must be INDEPENDENT OF N (O(K) / O(K·depth_loc) —
    # candidates, base/proof psums proportional to the witness output, one
    # root gather).  A fixed-size threshold can't separate O(K·depth) from
    # O(N) at toy shapes, so compile each local op at 4x the tree size and
    # assert the collective bytes are unchanged.  (The GSPMD defaults are
    # known to all-gather the state through the sort — reported above.)
    for name, (rows, _) in reports.items():
        bad = [(kind, shape, nbytes) for kind, shape, nbytes in rows
               if nbytes >= state_bytes]
        tag = ("contains >=state-size collectives"
               if bad else "all collectives < state size")
        print(f"{name}: {tag}")

    # two-size N-independence check — shared with the slow-tier regression
    # test (imt_tpu/parallel/collective_audit.py)
    res = audit_local_plan(devices=d, depth=depth, k=k, chain=bchain)
    print()
    print(res.summary())
    if res.failures:
        print("\nFAIL: local-plan collectives grow with tree size:",
              [p.name for p in res.failures])
        sys.exit(1)
    print("\nOK: every shard-local path's collective volume is independent "
          "of the tree size (O(K / K*depth_loc), never O(N))")


if __name__ == "__main__":
    main()

"""A/B: per-call pipelined insert_batch vs chained insert_batches.

In-process interleaved rounds over warm programs, so both sides share one
card and one process (the first execution after a compile pays program
load, which is why `_median_rounds` in bench.py discards round 0).

Usage: python tools/ab_chained.py [--depth 24 --cap 16 --k 4096 --iters 8]
"""

from __future__ import annotations

import argparse
import sys
import time

# imt_tpu is an installed package (pip install -e . — pyproject.toml)


def log(m):
    print(m, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--depth", type=int, default=24)
    ap.add_argument("--cap", type=int, default=16)
    ap.add_argument("--k", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--group", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    import jax
    from imt_tpu.utils.cache import setup_compile_cache
    setup_compile_cache()
    import numpy as np
    import jax.numpy as jnp
    import random
    from imt_tpu.ops import field
    from imt_tpu.tree.sparse import SparseIndexedMerkleTree

    rng = random.Random(0xAB)
    k, iters = args.k, args.iters
    n_pre = iters * (args.rounds + 1) * 6 + 3

    log(f"pre-packing {n_pre} batches of {k} ...")
    # pre-STAGE on device: uploads stay out of every timed loop below
    batches = [jax.device_put(field.random_limbs(0xAB00 + i, k))
               for i in range(n_pre)]
    for b_ in batches:
        b_.block_until_ready()
    bi = [0]

    def take(n):
        out = batches[bi[0]:bi[0] + n]
        bi[0] += n
        return out

    def fresh():
        return SparseIndexedMerkleTree(args.depth,
                                       initial_capacity_log2=args.cap)

    def run_percall(tag):
        tree = fresh()
        warm = take(1)[0]
        t0 = time.time()
        tree.insert_batch(warm, as_numpy=True)
        log(f"{tag}: compile+first {time.time()-t0:.1f}s")
        bs = take(iters)
        t0 = time.time()
        oks = [tree.insert_batch(b, as_numpy=False) for b in bs]
        total = int(np.asarray(jnp.stack(oks)).sum())
        dt = time.time() - t0
        log(f"{tag}: {iters*k} inserts in {dt:.3f}s -> "
            f"{iters*k/dt:,.0f}/s (accepted {total})")
        return iters * k / dt

    def run_chained(tag, b):
        tree = fresh()
        # warm with a half group when a full warm+timed sequence would
        # overflow the 2^cap slots (b=8, iters=8: 16 batches = cap)
        wb = b if (b + iters) * k < (1 << args.cap) - 1 else b // 2
        warm = jnp.stack(take(wb))
        t0 = time.time()
        tree.insert_batches(warm, as_numpy=True)
        log(f"{tag}: compile+first {time.time()-t0:.1f}s")
        n_groups = iters // b
        gs = [jnp.stack(take(b)) for _ in range(n_groups)]
        for g_ in gs:
            g_.block_until_ready()
        t0 = time.time()
        oks = [tree.insert_batches(g, as_numpy=False) for g in gs]
        total = int(np.asarray(jnp.concatenate(oks)).sum())
        dt = time.time() - t0
        n = n_groups * b * k
        log(f"{tag}: {n} inserts in {dt:.3f}s -> {n/dt:,.0f}/s "
            f"(accepted {total})")
        return n / dt

    import os
    from imt_tpu.tree import indexed

    # build each chained variant's jitted program ONCE (compiles are paid a
    # single time; rounds then interleave warm programs)
    nr = fresh().node_repr
    fn_u = {b: indexed._insert_batches_fn(args.cap, k, b, nr, False)
            for b in (4, 8)}
    fn_s = {4: indexed._insert_batches_fn(args.cap, k, 4, nr, True)}
    table = {}

    def dispatch(depth, k_, b, nr_="", scan=False):
        return table[b]
    indexed._insert_batches_fn = dispatch

    def chained(tag, b, fns):
        table[b] = fns[b]
        if b // 2 in fns:
            table[b // 2] = fns[b // 2]   # half-group warm (see run_chained)
        return run_chained(tag, b)

    variants = [
        ("percall", lambda tag: run_percall(tag)),
        ("chain4u", lambda tag: chained(tag, 4, fn_u)),
        ("chain8u", lambda tag: chained(tag, 8, fn_u)),
        ("chain4s", lambda tag: chained(tag, 4, fn_s)),
    ]
    results = {tag: [] for tag, _ in variants}
    for r in range(args.rounds):
        for tag, fn in variants:
            results[tag].append(fn(f"r{r} {tag}"))
    import statistics
    for tag, vs in results.items():
        log(f"median {tag}: {statistics.median(vs):,.0f} inserts/s "
            f"(discard-r0 median "
            f"{statistics.median(vs[1:]) if len(vs) > 1 else vs[0]:,.0f})")


if __name__ == "__main__":
    main()

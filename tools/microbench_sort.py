"""Measure XLA lax.sort / gather / scatter costs at the planner shapes.

The batched-insert planner's 9-key packed sort runs over M = N + K entries
(tree/indexed.py _plan_batch); at config 5 that is ~1.1M rows.  This tool
times, on the card (slope protocol: K repeats inside one jitted
fori_loop, (K2-K1)/[K2-K1] slope, median of rounds):

  * sort9_<M>   — the exact 9-key uint32 sort + int32 payload
  * sort2_<M>   — a 2-key sort (merge-resolver shape, batch_witness)
  * gather_<M>  — [16, M] take at M random indices (planner traffic unit)
  * bisect_<M>  — 20 rounds of 2-level gather + 16-limb compare over [16, K]
                  from [16, M] (the searchsorted alternative to sort9)

Usage: python tools/microbench_sort.py [--m 1114112] [--k 65536]
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

# imt_tpu is an installed package (pip install -e . — pyproject.toml)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=(1 << 20) + (1 << 16))
    ap.add_argument("--k", type=int, default=1 << 16)
    ap.add_argument("--r1", type=int, default=1)
    ap.add_argument("--r2", type=int, default=3)
    args = ap.parse_args()

    import jax
    from imt_tpu.utils.cache import setup_compile_cache
    setup_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    m, k = args.m, args.k

    def timed(name, make):
        fns = {}
        for r in (args.r1, args.r2):
            f = make(r)
            t0 = time.time()
            np.asarray(f(jnp.uint32(1)))
            print(f"  {name} reps={r}: compile+first {time.time()-t0:.1f}s",
                  flush=True)
            fns[r] = f
        slopes = []
        for i in range(5):
            ts = {}
            for r in (args.r1, args.r2):
                t0 = time.time()
                np.asarray(fns[r](jnp.uint32(2 + i)))
                ts[r] = time.time() - t0
            slopes.append((ts[args.r2] - ts[args.r1]) / (args.r2 - args.r1))
        med = statistics.median(slopes)
        print(f"{name:14s}: {med*1e3:8.2f} ms/op (median of 5 slopes)",
              flush=True)
        return med

    def make_sort(nkeys, mm):
        def mk(reps):
            @jax.jit
            def f(seed):
                base = jax.lax.broadcasted_iota(jnp.uint32, (nkeys, mm), 1)
                keys = tuple((base[i] * jnp.uint32(2654435761) + i) ^ seed
                             for i in range(nkeys))

                def body(i, carry):
                    ops = jax.lax.sort(
                        tuple(kk ^ i.astype(jnp.uint32) for kk in keys)
                        + (jnp.arange(mm, dtype=jnp.int32),),
                        num_keys=nkeys)
                    return carry + ops[-1][:1]

                return jax.lax.fori_loop(
                    0, reps, body, jnp.zeros((1,), jnp.int32))
            return f
        return mk

    def make_gather(mm):
        def mk(reps):
            @jax.jit
            def f(seed):
                src = (jax.lax.broadcasted_iota(jnp.uint32, (16, mm), 1)
                       ^ seed).astype(jnp.uint32)
                idx = (jax.lax.broadcasted_iota(jnp.uint32, (mm,), 0)
                       * jnp.uint32(2654435761) % mm).astype(jnp.int32)

                def body(i, carry):
                    g = jnp.take(src, (idx + i) % mm, axis=1)
                    return carry + g[:, :1]

                return jax.lax.fori_loop(
                    0, reps, body, jnp.zeros((16, 1), jnp.uint32))
            return f
        return mk

    def make_bisect(mm, kk):
        rounds = int(np.ceil(np.log2(mm))) + 1

        def mk(reps):
            @jax.jit
            def f(seed):
                svals = (jax.lax.broadcasted_iota(jnp.uint32, (16, mm), 1)
                         ^ seed).astype(jnp.uint32)
                perm = ((jax.lax.broadcasted_iota(jnp.uint32, (mm,), 0)
                         * jnp.uint32(2654435761)) % mm).astype(jnp.int32)
                q = (jax.lax.broadcasted_iota(jnp.uint32, (16, kk), 1)
                     ^ (seed * 7)).astype(jnp.uint32)

                def body(i, carry):
                    lo = jnp.zeros((kk,), jnp.int32)
                    hi = jnp.full((kk,), mm, jnp.int32)
                    for _ in range(rounds):
                        mid = jnp.clip((lo + hi) // 2, 0, mm - 1)
                        mv = jnp.take(svals, jnp.take(perm, mid), axis=1)
                        le = jnp.zeros((kk,), bool)
                        eq = jnp.ones((kk,), bool)
                        for j in range(15, -1, -1):
                            le |= eq & (mv[j] < q[j])
                            eq &= mv[j] == q[j]
                        le |= eq
                        lo = jnp.where(le, mid + 1, lo)
                        hi = jnp.where(le, hi, mid)
                    return carry + lo[:1]

                return jax.lax.fori_loop(
                    0, reps, body, jnp.zeros((1,), jnp.int32))
            return f
        return mk

    timed(f"sort9_{m}", make_sort(9, m))
    timed(f"sort9_{k}", make_sort(9, k))
    timed(f"sort2_{8 * (k // 2)}", make_sort(2, 8 * (k // 2)))
    timed(f"gather_{m}", make_gather(m))
    timed(f"bisect_{m}x{k}", make_bisect(m, k))


if __name__ == "__main__":
    main()

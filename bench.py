"""Benchmark runner: prints ONE JSON line per run.

Headline: Poseidon permutations/s on one card (the permutation is the hot
inner loop of the entire system — SURVEY §3.1), for the engine the trees use
(``rns``).  The reference publishes no numbers, so there is no baseline
ratio.

Protocol: the permutation runs K times inside ONE jitted fori_loop with
inputs derived on the device, every run ends in block_until_ready, and the
rate comes from the (K2 - K1) slope, which cancels dispatch and transfer.

Every line names the device it ran on (platform, device_kind, device count,
the card's name and power limit).  Without a GPU the bench exits non-zero:
it never falls back to the CPU.

Usage:
    python bench.py                 # permutation slope bench (rns engine)
    python bench.py --smoke         # tiny + quick
    python bench.py --engine cios   # uint32 CIOS engine instead
    python bench.py --insert        # secondary: batched leaf-inserts/s
    python bench.py --config 5      # one tree config (2, 3, 3w, 4, 5)
    python bench.py --artifact      # on-card parity + every config
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def bench_perms(batch: int, engine: str, k1: int, k2: int) -> float:
    """Permutations/s of one engine at one batch width (slope protocol)."""
    import jax.numpy as jnp

    from imt_tpu.ops.engine_timing import permutation_loop

    f = permutation_loop(engine, batch)
    t0 = time.perf_counter()
    f(jnp.uint32(1), k1).block_until_ready()
    log(f"compile+first {time.perf_counter() - t0:.1f}s")
    times = {}
    for k in (k1, k2):
        t0 = time.perf_counter()
        f(jnp.uint32(2), k).block_until_ready()
        times[k] = time.perf_counter() - t0
        log(f"K={k}: run {times[k] * 1e3:.1f} ms")
    slope = (times[k2] - times[k1]) / (k2 - k1)
    rate = batch / slope
    log(f"{slope * 1e3:.2f} ms/permutation-batch -> {rate / 1e6:.3f} M perms/s")
    return rate


def bench_insert(depth: int, k: int, iters: int) -> float:
    import random
    import numpy as np

    from imt_tpu.tree import indexed

    log(f"building depth-{depth} tree ...")
    from imt_tpu.ops import field

    tree = indexed.IndexedMerkleTree(depth)
    rng = random.Random(0x1A5)
    # pre-pack every batch's limbs (python bigint -> limb packing is host
    # work that would otherwise serialize into the timed loop)
    batches = [field.ints_to_limbs(
        [rng.randrange(1, 1 << 253) for _ in range(k)])
        for _ in range(iters + 1)]
    t0 = time.time()
    ok = tree.insert_batch(batches[0])
    log(f"compile+first batch: {time.time()-t0:.1f}s (accepted {ok.sum()}/{k})")
    t0 = time.time()
    total = 0
    for vals in batches[1:]:
        ok = tree.insert_batch(vals)
        total += int(ok.sum())
    tree.levels[-1].block_until_ready()
    dt = time.time() - t0
    log(f"{total} inserts in {dt:.3f}s -> {total/dt:,.0f} inserts/s (depth {depth})")
    return total / dt


def _median_rounds(run_round, rounds: int, tag: str) -> float:
    """Steady-state protocol: run `rounds` identical timed rounds, DISCARD
    the first (the first executions after a compile pay program load and
    allocator warm-up), report the median of the rest."""
    import statistics
    rates = []
    for r in range(rounds):
        rates.append(run_round(r))
        log(f"{tag} round {r}: {rates[-1]:,.0f}/s"
            + (" (warmup, discarded)" if r == 0 else ""))
    return statistics.median(rates[1:]) if len(rates) > 1 else rates[0]


def bench_non_inclusion(depth: int, n_leaves: int, k: int,
                        iters: int, rounds: int = 4) -> float:
    """Config 2: non-membership witness + verify throughput."""
    import jax
    import random
    import numpy as np
    from imt_tpu.tree import indexed

    tree = indexed.IndexedMerkleTree(depth)
    rng = random.Random(0xBEEF)
    tree.insert_batch([rng.randrange(1, 1 << 253)
                       for _ in range(n_leaves - 2)])

    from imt_tpu.ops import field
    verify = jax.jit(indexed.verify_non_inclusion)   # one program, not
    # one dispatch per op

    # pre-pack AND pre-stage all query batches on device: host-to-device
    # input is outside this number (ROADMAP Reach 2.1)
    qbatches = [jax.device_put(field.random_limbs(0xBEEF + i, k))
                for i in range(iters + 1)]
    for q_ in qbatches:
        q_.block_until_ready()

    def round_trip(qlimbs):
        # witness stays on device and chains straight into the jitted
        # verifier (no host round trip)
        w = tree.non_inclusion_witness(qlimbs, as_numpy=False)
        return verify(
            w.root, w.low_leaf_val, w.low_leaf_next_val, w.low_leaf_next_idx,
            w.low_leaf_proof, w.low_leaf_proof_helper, qlimbs,
            w.is_new_leaf_largest)

    t0 = time.time()
    np.asarray(round_trip(qbatches[0]))
    log(f"compile+first: {time.time()-t0:.1f}s")
    from imt_tpu.utils.observability import trace

    def one_round(r):
        t0 = time.time()
        with trace(f"non_inclusion_d{depth}_k{k}"):
            oks = [round_trip(q) for q in qbatches[1:]]   # async dispatch
            jax.block_until_ready(oks)
        return iters * k / (time.time() - t0)

    return _median_rounds(one_round, rounds, "cfg2")


def bench_single_insert(depth: int, iters: int, chunk: int = 16) -> float:
    """Config 3: sequential witness inserts/s, depth-16 tree.

    Strictly sequential semantics (each insert sees the previous one's tree,
    full witness bundle per insert — reference src/indexed_merkle_tree.rs:
    710-802), dispatched in scan-chained chunks (insert_seq): one dispatch
    per `chunk` inserts instead of one per insert.  Witnesses are
    bit-identical to per-call insert() (tests/test_chained.py)."""
    import numpy as np
    from imt_tpu.ops import field
    from imt_tpu.tree.sparse import SparseIndexedMerkleTree

    import jax
    chunks = [jax.device_put(field.random_limbs(0xF00D + i, chunk))
              for i in range(iters // chunk + 1)]
    for c_ in chunks:
        c_.block_until_ready()
    tree = SparseIndexedMerkleTree(depth, initial_capacity_log2=12)
    t0 = time.time()
    tree.insert_seq(chunks[0])
    log(f"compile+first chunk: {time.time()-t0:.1f}s")

    n = chunk * (len(chunks) - 1)

    def one_round(r):
        # fresh tree per round (sequential inserts consume slots); programs
        # are cached after round 0
        t = SparseIndexedMerkleTree(depth, initial_capacity_log2=12)
        t0 = time.time()
        for c in chunks[1:]:
            w = t.insert_seq(c, as_numpy=False)
        jax.block_until_ready(w)
        return n / (time.time() - t0)

    return _median_rounds(one_round, 4, "cfg3")


def bench_batch_insert_sparse(depth: int, k: int, iters: int,
                              witness: bool = False,
                              rounds: int = 4) -> float:
    """Configs 4/5: batched inserts/s into a sparse-prefix tree.

    witness=True measures the witness-producing batched path (every insert
    emits the full insert_leaf bundle — the batch-rate replacement for the
    sequential config 3).

    Steady-state protocol: every round replays the SAME pre-packed batches
    into a FRESH tree (programs cached after round 0; acceptance identical),
    round 0 is discarded (_median_rounds)."""
    import numpy as np
    import jax.numpy as jnp
    from imt_tpu.tree.sparse import SparseIndexedMerkleTree

    from imt_tpu.ops import field
    from imt_tpu.utils.observability import trace

    cap = max(14, (k * (iters + 1) + 2).bit_length())
    log(f"pre-packing {iters + 1} batches of {k} values ...")
    # pre-STAGE on device: input staging is pipeline work (a deployment
    # streams it asynchronously), not part of the insert op
    import jax
    batches = [jax.device_put(field.random_limbs(0xCAFE + i, k))
               for i in range(iters + 1)]
    for b_ in batches:
        b_.block_until_ready()

    def fresh():
        return SparseIndexedMerkleTree(depth, initial_capacity_log2=cap)

    if witness:
        tree = fresh()
        t0 = time.time()
        ok = np.asarray(tree.insert_batch(batches[0], witness=True,
                                          as_numpy=False).ok)
        log(f"compile+first batch: {time.time()-t0:.1f}s "
            f"(accepted {ok.sum()}/{k})")

        def one_round(r):
            t = fresh()
            # SYNC warm insert (materialized ok): an async warm dispatch
            # would leak its device time into the timed window below
            np.asarray(t.insert_batch(batches[0], witness=True,
                                      as_numpy=False).ok)
            t0 = time.time()
            oks = []
            with trace(f"batch_insert_d{depth}_k{k}_w"):
                for vals in batches[1:]:
                    # as_numpy=False: witness bundle stays device-resident so
                    # chained batches pipeline under async dispatch
                    oks.append(t.insert_batch(vals, witness=True,
                                              as_numpy=False).ok)
                jax.block_until_ready(oks)
            return iters * k / (time.time() - t0)

        return _median_rounds(one_round, rounds, "cfgW")

    # plain batches: chained groups (insert_batches, unrolled b<=8) — one
    # dispatch per `group` batches; state-identical to per-call
    # insert_batch (tests/test_chained.py)
    group = 8 if iters >= 8 else 1
    # warm group: half-size when a full warm+timed sequence would overflow
    # the 2^cap slots (warmup only needs state+program heat; round 0 of
    # _median_rounds warms the timed `group` program itself)
    wb = group if 2 * group * k < (1 << cap) - 1 else max(1, group // 2)
    warm_arr = jnp.stack(batches[:wb])
    n_g = (iters + 1 - wb) // group
    groups = [jnp.stack(batches[wb + i * group:wb + (i + 1) * group])
              for i in range(n_g)]
    for g_ in groups:
        g_.block_until_ready()
    tree = fresh()
    t0 = time.time()
    ok = np.asarray(tree.insert_batches(warm_arr))
    log(f"compile+first group of {wb}: {time.time()-t0:.1f}s "
        f"(accepted {ok.sum()}/{wb * k})")

    n_done = group * n_g * k

    def one_round(r):
        t = fresh()
        np.asarray(t.insert_batches(warm_arr, as_numpy=False))   # SYNC warm
        t0 = time.time()
        oks = []
        with trace(f"batch_insert_d{depth}_k{k}"):
            for arr in groups:
                oks.append(t.insert_batches(arr, as_numpy=False))
            jax.block_until_ready(oks)
        return n_done / (time.time() - t0)

    return _median_rounds(one_round, rounds, "cfgB")


def bench_oracle(batch: int, iters: int) -> float:
    """Reference-equivalent CPU baseline: the C++ 4x64 Montgomery Poseidon
    (the same algorithm/structure as the reference's pse-poseidon dependency)
    hashing on one host core.  Gives vs-reference context since the reference
    publishes no numbers."""
    import numpy as np

    from imt_tpu.native import oracle

    rng = np.random.default_rng(5)
    a = rng.integers(0, 1 << 62, (batch, 4), dtype=np.uint64)
    b = rng.integers(0, 1 << 62, (batch, 4), dtype=np.uint64)
    oracle.hash2_u64(a[:8], b[:8])                     # build + warm
    t0 = time.time()
    for _ in range(iters):
        oracle.hash2_u64(a, b)
    dt = time.time() - t0
    rate = batch * iters / dt
    log(f"C++ oracle: {rate:,.0f} hashes/s ({2*rate:,.0f} perms/s) "
        f"single-core")
    return rate


def config_result(cfg: str, smoke: bool = False) -> dict:
    """One tree config -> its JSON record (also used by --artifact)."""
    rounds = 2 if smoke else 4
    if cfg == "2":
        rate = bench_non_inclusion(8, 256, 8192, 2 if smoke else 8,
                                   rounds=rounds)
        metric, unit = "non-membership verifies/s (depth 8)", "verifies/s"
    elif cfg == "3":
        # chunk=64: one lax.scan dispatch per 64 strictly-sequential inserts
        # (witnesses bit-identical to per-call insert — tests/test_chained.py)
        rate = bench_single_insert(16, 8 if smoke else 256,
                                   chunk=4 if smoke else 64)
        metric, unit = "sequential witness inserts/s (depth 16)", "inserts/s"
    elif cfg == "3w":
        rate = bench_batch_insert_sparse(16, 4096, 2 if smoke else 8,
                                         witness=True, rounds=rounds)
        metric, unit = ("witness-batch inserts/s (depth 16, batch 4096, "
                        "full insert_leaf bundles)", "inserts/s")
    elif cfg == "4":
        # iters=14 keeps the active prefix at 2^16 (15 batches of 4096)
        rate = bench_batch_insert_sparse(24, 4096, 2 if smoke else 14,
                                         rounds=rounds)
        metric, unit = "batched inserts/s (depth 24, batch 4096)", "inserts/s"
    else:
        k, iters = (4096, 2) if smoke else (65536, 15)
        rate = bench_batch_insert_sparse(32, k, iters, rounds=rounds)
        metric, unit = (f"batched inserts/s (depth 32, batch {k}, ~1M total)",
                        "inserts/s")
    return {"config": cfg, "metric": metric, "value": rate, "unit": unit}


def main(argv=None) -> None:
    from imt_tpu.ops.engine_timing import ENGINES

    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--insert", action="store_true")
    ap.add_argument("--oracle", action="store_true",
                    help="C++ reference-equivalent CPU Poseidon baseline")
    ap.add_argument("--config", choices=["2", "3", "3w", "4", "5"],
                    help="one tree benchmark config")
    ap.add_argument("--artifact", action="store_true",
                    help="on-card parity check + configs 2/3/3w/4/5")
    ap.add_argument("--engine", choices=ENGINES, default="rns")
    ap.add_argument("--batch", type=int, default=1 << 16)
    args = ap.parse_args(argv)

    from imt_tpu.utils.cache import setup_compile_cache
    from imt_tpu.utils.device import device_record, require_gpu

    devs = require_gpu()
    setup_compile_cache()
    device = device_record(devs[:1])        # every bench runs on one card

    def emit(rec: dict) -> None:
        print(json.dumps({**rec, **device}))

    if args.oracle:
        rate = bench_oracle(4096, 2 if args.smoke else 32)
        emit({"metric": "C++ reference-equivalent Poseidon hashes/s "
                        "(1 host core)", "value": rate, "unit": "hashes/s"})
        return

    if args.artifact:
        # on-card correctness FIRST: the reference replay vs the python
        # oracle (chip_smoke phase 2); raises on any mismatch
        log("=== parity (reference replay on the card) ===")
        from chip_smoke import phase_reference_replay
        parity = phase_reference_replay()
        results = []
        for cfg in ["2", "3", "3w", "4", "5"]:
            log(f"=== config {cfg} ===")
            results.append(config_result(cfg, args.smoke))
        emit({"metric": "configs recorded", "parity": parity,
              "configs": results})
        return

    if args.config:
        emit(config_result(args.config, args.smoke))
        return

    if args.insert:
        depth, k, iters = (6, 8, 2) if args.smoke else (20, 1024, 4)
        rate = bench_insert(depth, k, iters)
        emit({"metric": f"batched leaf-inserts/s (depth {depth})",
              "value": rate, "unit": "inserts/s"})
        return

    batch = 2048 if args.smoke else args.batch
    rate = bench_perms(batch, args.engine,
                       *((1, 3) if args.smoke else (2, 12)))
    emit({"metric": f"Poseidon perms/s ({args.engine}, batch {batch})",
          "value": rate, "unit": "perms/s"})


if __name__ == "__main__":
    main()

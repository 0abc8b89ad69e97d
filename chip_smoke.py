"""Run the engine's main path once on an NVIDIA GPU and prove it bit-exact.

    python chip_smoke.py                     # phases 1-5 on one card
    python chip_smoke.py --leaves-log2 24    # phase 4 at 2^24 slots
    python chip_smoke.py --devices 4         # sharded tree over 4 cards only

Phases (one card):
  1. hash parity: hashing.hash2/hash3 (default engine) on 65,536 random lanes
     plus edge values vs the C++ oracle, and the H(0,0,0) anchor;
  2. reference replay vs the python oracle (tree/reference_oracle.py);
  3. 4,096 inserts into a depth-32 sparse tree vs the C++ NativeIndexedTree;
  4. a deployment-size tree (2^22 slots, ~4.1M values with repeats and
     zeros, config 5's batch of 65,536): acceptance vs a numpy model,
     65,536 non-inclusion queries, a 4,096-value witness batch, the sorted-
     successor invariant over the whole prefix, 256 sampled proofs folded
     by the C++ oracle, and utils/health.check_tree;
  5. one permutation batch of the rns and cios engines at widths 2^10-2^16.

With --devices N the script runs only the sharded path: a
ShardedIndexedMerkleTree over N cards against a SparseIndexedMerkleTree on
card 0, loaded with the same ~2^23 values, then dryrun_multichip(N).

The script exits non-zero and prints no ok line unless JAX's first device
is a GPU and every phase passed.  Its last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H(0,0,0): the reference's zero-leaf anchor (src/indexed_merkle_tree.rs:247-251)
ANCHOR = 1960587138944869480785025106734196872454309951825657414575195034687326603497
DEPTH = 32
BATCH = 65536          # config 5's batch
# batches per insert_batches dispatch: above 8 the chain is a lax.scan, one
# compiled body (an unrolled chain of 7 at 2^22 slots took 388 s of XLA
# compile for an H100)
GROUP = 9
WITNESS_K = 4096


def ok_line(platform: str, kind: str, count: int) -> str:
    """The final line: the one JSON object a caller reads."""
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Host-side data helpers (numpy; independent of the device engines)
# ---------------------------------------------------------------------------

def limbs_to_u64(limbs: np.ndarray) -> np.ndarray:
    """uint32[16, B] 16-bit limbs -> uint64[B, 4] (the C++ oracle layout)."""
    l = np.asarray(limbs).astype(np.uint64)
    out = np.zeros((l.shape[1], 4), dtype=np.uint64)
    for i in range(4):
        for j in range(4):
            out[:, i] |= l[4 * i + j] << np.uint64(16 * j)
    return out


def be_keys(limbs: np.ndarray) -> np.ndarray:
    """uint32[16, N] -> S32[N] big-endian byte strings, whose byte order is
    the numeric order (sortable, searchable, hashable by numpy)."""
    be = np.ascontiguousarray(np.asarray(limbs)[::-1].T).astype(">u2")
    return np.ascontiguousarray(be).view("S32").ravel()


def make_stream(seed: int, n: int, batch: int) -> np.ndarray:
    """uint32[16, n] nonzero random values < 2^253, then ~1% of the lanes
    overwritten with an earlier lane (half from the same batch, half from
    anywhere before) and a few set to zero."""
    from imt_tpu.ops import field
    rng = np.random.default_rng(seed)
    vals = field.random_limbs(seed, n)
    n_dup = max(1, n // 100)
    dst = rng.choice(np.arange(1, n), size=min(n_dup, n - 1), replace=False)
    within = rng.random(dst.size) < 0.5
    lo = np.where(within, (dst // batch) * batch, 0)
    src = lo + (rng.random(dst.size) * (dst - lo)).astype(np.int64)
    vals[:, dst] = vals[:, src]
    vals[:, rng.choice(n, size=min(3, n), replace=False)] = 0
    return vals


def first_occurrence_model(limbs: np.ndarray) -> np.ndarray:
    """bool[N]: the engine's acceptance contract — a value is accepted iff
    it is nonzero and no earlier lane (in this stream) holds it."""
    _, first = np.unique(be_keys(limbs), return_index=True)
    acc = np.zeros(limbs.shape[1], dtype=bool)
    acc[first] = True
    return acc & np.asarray(limbs).any(axis=0)


def _timed(fn):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Phase 1: hash parity at real width vs the C++ oracle
# ---------------------------------------------------------------------------

def phase_hash_parity(lanes: int = 65536, seed: int = 0) -> dict:
    import jax.numpy as jnp
    from imt_tpu.native import oracle
    from imt_tpu.ops import field, hashing

    if hashing.backend() != "rns":
        raise AssertionError(f"default engine is {hashing.backend()!r}")
    P = field.P
    edges = [0, 1, P - 1, P, P + 1, 2 * P - 1, (1 << 254) - 1, (1 << 256) - 1]
    ea = [x for x in edges for _ in edges]
    eb = [y for _ in edges for y in edges]
    ec = [edges[(i * 3) % len(edges)] for i in range(len(ea))]

    def raw(xs):          # unreduced limbs: inputs >= p go to the device as is
        out = np.zeros((field.LIMBS, len(xs)), dtype=np.uint32)
        for j, x in enumerate(xs):
            out[:, j] = field._int_to_limbs_list(x)
        return out

    cols = [field.random_limbs(seed + i, lanes) for i in range(3)]
    dev = [np.concatenate([c, raw(e)], axis=1)
           for c, e in zip(cols, (ea, eb, ec))]
    host = [np.concatenate([limbs_to_u64(c), oracle.ints_to_u64(e)])
            for c, e in zip(cols, (ea, eb, ec))]
    out = {}
    for name, fn, n_in, ref in (
            ("hash2", hashing.hash2, 2, oracle.hash2_u64),
            ("hash3", hashing.hash3, 3, oracle.hash3_u64)):
        args = [jnp.asarray(d) for d in dev[:n_in]]
        _, t_first = _timed(lambda: fn(*args))
        got, t_warm = _timed(lambda: fn(*args))
        want = ref(*host[:n_in])
        bad = np.nonzero((limbs_to_u64(np.asarray(got)) != want).any(axis=1))[0]
        if bad.size:
            raise AssertionError(f"{name}: {bad.size} of {want.shape[0]} "
                                 f"lanes differ from the C++ oracle, first "
                                 f"{bad[:8].tolist()}")
        out[name] = {"lanes": int(want.shape[0]), "compile_first_s": t_first,
                     "warm_s": t_warm}
    z = jnp.zeros((field.LIMBS, 1), dtype=jnp.uint32)
    anchor = field.limbs_to_int(np.asarray(hashing.hash3(z, z, z))[:, 0])
    if anchor != ANCHOR:
        raise AssertionError(f"H(0,0,0) anchor mismatch: {anchor}")
    return out


# ---------------------------------------------------------------------------
# Phase 2: reference replay vs the python oracle
# ---------------------------------------------------------------------------

def spine_fold_oracle(root: int, depth: int, full_depth: int, params) -> int:
    """Active-prefix root -> full-depth root over the zero-subtree spine
    (host twin of tree/indexed._spine_fold)."""
    from imt_tpu.ops.poseidon_ref import hash_fixed
    zs = [hash_fixed([0, 0, 0], params)]
    for _ in range(full_depth - 1):
        zs.append(hash_fixed([zs[-1], zs[-1]], params))
    for lvl in range(depth, full_depth):
        root = hash_fixed([root, zs[lvl]], params)
    return root


def phase_reference_replay() -> dict:
    """The reference insertion sequence (src/indexed_merkle_tree.rs:679-803)
    and a batched depth-32 sparse insert, every root against the python
    oracle; a witness batch against the insert_leaf predicate."""
    import random

    from imt_tpu.ops.poseidon_ref import generate_params
    from imt_tpu.tree import indexed
    from imt_tpu.tree.reference_oracle import OracleIndexedTree
    from imt_tpu.tree.sparse import SparseIndexedMerkleTree

    params = generate_params()
    t = indexed.IndexedMerkleTree(3)
    o = OracleIndexedTree(depth=3, params=params)
    for v in [30, 10, 20, 5, 50, 35]:
        w = t.insert(v)
        o.insert(v)
        if not bool(w.ok.all()) or t.get_root_int() != o.get_root():
            raise AssertionError(f"sequential replay: root mismatch at {v}")

    rng = random.Random(3)
    vals = [rng.randrange(1, 1 << 253) for _ in range(16)]
    tb = SparseIndexedMerkleTree(DEPTH, initial_capacity_log2=5)
    if not tb.insert_batch(vals).all():
        raise AssertionError("batched sparse insert rejected fresh values")
    ob = OracleIndexedTree(depth=5, params=params)
    for v in vals:
        ob.insert(v)
    if tb.get_root_int() != spine_fold_oracle(ob.get_root(), 5, DEPTH, params):
        raise AssertionError("batched sparse root mismatch")

    tw = indexed.IndexedMerkleTree(8)
    wb = tw.insert_batch(vals, witness=True)
    if not wb.ok.all():
        raise AssertionError("witness batch rejected fresh values")
    indexed.check_insert_witness(wb)
    return {"sequential_replay_d3": True, "batched_sparse_d32": True,
            "witness_batch_predicate": True}


# ---------------------------------------------------------------------------
# Phase 3: independent mid-size root vs the C++ incremental tree
# ---------------------------------------------------------------------------

def spine_fold_native(root: int, depth: int, full_depth: int) -> int:
    """spine_fold_oracle with the C++ oracle's hash."""
    from imt_tpu.native import oracle
    zs = oracle.hash3([0], [0], [0])
    for _ in range(full_depth - 1):
        zs += oracle.hash2(zs[-1:], zs[-1:])
    for lvl in range(depth, full_depth):
        root = oracle.hash2([root], [zs[lvl]])[0]
    return root


def phase_native_mid_root(n: int = 4096, batch: int = 1024,
                          seed: int = 0) -> dict:
    """The C++ tree is dense, so it holds the 2^ceil(log2(n+1)) prefix and
    its root is folded up the zero spine to depth 32 by the C++ hash."""
    from imt_tpu.native.oracle import NativeIndexedTree
    from imt_tpu.ops import field
    from imt_tpu.tree.sparse import SparseIndexedMerkleTree

    stream = make_stream(seed + 3, n, batch)
    prefix = (n + 1).bit_length()       # room for all n: no growth, one program
    tree = SparseIndexedMerkleTree(DEPTH, initial_capacity_log2=prefix)
    t0 = time.perf_counter()
    oks = np.concatenate([tree.insert_batch(stream[:, i:i + batch])
                          for i in range(0, n, batch)])
    root = tree.get_root_int()
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    nat = NativeIndexedTree(prefix)
    nok = nat.insert_batch(field.limbs_to_ints(stream))
    nat_root = spine_fold_native(nat.get_root(), prefix, DEPTH)
    t_host = time.perf_counter() - t0
    if not (oks == nok).all():
        raise AssertionError(f"acceptance differs from NativeIndexedTree at "
                             f"lanes {np.nonzero(oks != nok)[0][:8].tolist()}")
    if not (oks == first_occurrence_model(stream)).all():
        raise AssertionError("acceptance differs from the numpy model")
    if root != nat_root:
        raise AssertionError("root differs from NativeIndexedTree")
    return {"inserts": n, "accepted": int(oks.sum()), "device_s": t_dev,
            "native_s": t_host}


# ---------------------------------------------------------------------------
# Phase 4: deployment-size tree
# ---------------------------------------------------------------------------

def check_leaf_state(vals_h, nvs_h, nis_h, count: int, stream, accepted):
    """Whole-prefix host audit.  Slot i+1 holds lane i iff it was accepted
    (else zero); the participants (sentinel slot 0 + nonzero slots) form the
    sorted linked list: each one's (next_val, next_idx) is its successor's
    (value, slot), (0, 0) for the largest; every other slot is all zero."""
    n_slots = vals_h.shape[1]
    want = np.where(accepted[None], stream, 0)
    if not ((vals_h[:, 1:count + 1] == want).all()
            and not vals_h[:, 0].any() and not vals_h[:, count + 1:].any()):
        raise AssertionError("leaf values differ from the acceptance model")
    part = np.concatenate([[0], 1 + np.nonzero(accepted)[0]])
    part = part[np.argsort(be_keys(vals_h[:, part]), kind="stable")]
    succ = np.concatenate([part[1:], [0]])
    nv_want = np.zeros_like(nvs_h)
    nv_want[:, part[:-1]] = vals_h[:, part[1:]]
    ni_want = np.zeros_like(nis_h)
    ni_want[0, part] = succ & 0xFFFF
    ni_want[1, part] = succ >> 16
    if not (nvs_h == nv_want).all():
        bad = np.nonzero((nvs_h != nv_want).any(axis=0))[0]
        raise AssertionError(f"next_val breaks the sorted-successor "
                             f"invariant at slots {bad[:8].tolist()} "
                             f"(of {n_slots})")
    if not (nis_h == ni_want).all():
        bad = np.nonzero((nis_h != ni_want).any(axis=0))[0]
        raise AssertionError(f"next_idx breaks the sorted-successor "
                             f"invariant at slots {bad[:8].tolist()}")


def fold_proofs_native(tree, slots, vals_h, nvs_h, nis_h) -> np.ndarray:
    """bool[len(slots)]: H(val, next_val, next_idx) of each slot, folded up
    its get_proof path by the C++ oracle, equals the device root."""
    from imt_tpu.native import oracle
    from imt_tpu.ops import field

    root = limbs_to_u64(field.ints_to_limbs([tree.get_root_int()]))[0]
    acc = oracle.hash3_u64(limbs_to_u64(vals_h[:, slots]),
                           limbs_to_u64(nvs_h[:, slots]),
                           limbs_to_u64(nis_h[:, slots]))
    proofs = np.stack([np.asarray(tree.get_proof(int(s))[0])[:, :, 0]
                       for s in slots])                    # [S, depth, 16]
    idx = np.array(slots, dtype=np.int64)          # a copy: shifted below
    for d in range(proofs.shape[1]):
        sib = limbs_to_u64(proofs[:, d, :].T)
        left = (idx % 2 == 0)[:, None]
        acc = oracle.hash2_u64(np.where(left, acc, sib),
                               np.where(left, sib, acc))
        idx >>= 1
    return (acc == root).all(axis=1)


def _planner_sort_fn(m: int):
    """The batched planner's 9-key sort over m rows (tree/indexed.py
    _plan_batch), alone, for timing."""
    import jax
    import jax.numpy as jnp
    from imt_tpu.ops import field

    @jax.jit
    def f(all_vals):
        packed = tuple((all_vals[2 * j + 1] << 16) | all_vals[2 * j]
                       for j in range(field.LIMBS // 2 - 1, -1, -1))
        return jax.lax.sort(packed + (jnp.arange(m, dtype=jnp.uint32),
                                      jnp.arange(m, dtype=jnp.int32)),
                            num_keys=9)[-1]
    return f


def phase_deployment(leaves_log2: int = 22, batch: int = BATCH,
                     group: int = GROUP, queries: int = 65536,
                     witness_k: int = WITNESS_K, samples: int = 256,
                     seed: int = 0) -> dict:
    import jax
    import jax.numpy as jnp
    from imt_tpu.ops import field
    from imt_tpu.tree import indexed
    from imt_tpu.utils import health
    from imt_tpu.utils.config import EngineConfig

    out = {}
    rng = np.random.default_rng(seed + 4)
    tree = EngineConfig(tree_depth=DEPTH,
                        initial_capacity_log2=leaves_log2).build_tree()
    cap = 1 << leaves_log2
    n_groups = (cap - witness_k - 1) // (batch * group)
    n = n_groups * group * batch
    t0 = time.perf_counter()
    stream = make_stream(seed + 4, n, batch)
    model = first_occurrence_model(stream)
    staged = [jax.device_put(np.ascontiguousarray(
        stream[:, g * group * batch:(g + 1) * group * batch]
        .reshape(field.LIMBS, group, batch).transpose(1, 0, 2)))
        for g in range(n_groups)]
    jax.block_until_ready(staged)
    out["setup_s"] = time.perf_counter() - t0

    # load: the first dispatch compiles; the rest is the steady stream
    t0 = time.perf_counter()
    oks = [jax.block_until_ready(tree.insert_batches(staged[0],
                                                     as_numpy=False))]
    t_first = time.perf_counter() - t0
    t1 = time.perf_counter()
    oks += [tree.insert_batches(g, as_numpy=False) for g in staged[1:]]
    oks = np.asarray(jnp.concatenate(oks)).reshape(-1)
    t_rest = time.perf_counter() - t1
    out.update(values=n, batches=n_groups * group, active_slots=cap,
               load_s=time.perf_counter() - t0, first_group_s=t_first)
    if n_groups > 1:
        per_group = t_rest / (n_groups - 1)
        out["per_batch_s"] = per_group / group
        out["compile_s"] = t_first - per_group
    del staged
    if not (oks == model).all():
        bad = np.nonzero(oks != model)[0]
        raise AssertionError(f"acceptance differs from the numpy model at "
                             f"{bad.size} lanes, first {bad[:8].tolist()}")

    sort = _planner_sort_fn(cap + batch)
    sort_in = jnp.concatenate([tree.vals, tree.vals[:, :batch]], axis=1)
    _, out["sort_compile_first_s"] = _timed(lambda: sort(sort_in))
    out["sort_s"] = min(_timed(lambda: sort(sort_in))[1] for _ in range(3))
    del sort_in

    # non-inclusion: half present (accepted values), half fresh
    acc_sorted = np.sort(be_keys(stream[:, model]))
    present = stream[:, rng.choice(np.nonzero(model)[0], queries // 2)]
    fresh = field.random_limbs(seed + 5, queries - queries // 2)
    q = np.concatenate([present, fresh], axis=1)
    qk = be_keys(q)
    pos = np.searchsorted(acc_sorted, qk)
    absent = ~(acc_sorted[np.minimum(pos, acc_sorted.size - 1)] == qk)
    verify = jax.jit(indexed.verify_non_inclusion)
    qd = jnp.asarray(q)

    def non_inclusion():
        w = tree.non_inclusion_witness(qd, as_numpy=False)
        return w, verify(w.root, w.low_leaf_val, w.low_leaf_next_val,
                         w.low_leaf_next_idx, w.low_leaf_proof,
                         w.low_leaf_proof_helper, qd, w.is_new_leaf_largest)

    _, out["non_inclusion_compile_first_s"] = _timed(non_inclusion)
    (w, ver), out["non_inclusion_s"] = _timed(non_inclusion)
    ok, ver = np.asarray(w.ok), np.asarray(ver)
    if not ((ok == absent).all() and (ver == absent).all()):
        raise AssertionError(
            f"non-inclusion: {int((ok != absent).sum())} witness and "
            f"{int((ver != absent).sum())} verify lanes differ from numpy")
    low_want = np.where(pos > 0, acc_sorted[np.maximum(pos - 1, 0)], b"")
    low_got = be_keys(np.asarray(w.low_leaf_val))
    if not (low_got[absent] == low_want[absent]).all():
        raise AssertionError("non-inclusion low leaf differs from numpy's "
                             "searchsorted predecessor")

    # witness batch: fresh values plus repeats of loaded values, a repeat
    # inside the batch and a zero
    wv = field.random_limbs(seed + 6, witness_k)
    loaded = rng.choice(np.nonzero(model)[0], max(1, witness_k // 64))
    wv[:, 1:1 + loaded.size] = stream[:, loaded]
    wv[:, -1] = wv[:, -2]
    wv[:, -3] = 0
    wk = be_keys(wv)
    wpos = np.minimum(np.searchsorted(acc_sorted, wk), acc_sorted.size - 1)
    w_want = first_occurrence_model(wv) & (acc_sorted[wpos] != wk)
    t0 = time.perf_counter()
    wit = tree.insert_batch(wv, witness=True)
    out["witness_batch_s"] = time.perf_counter() - t0
    if not (wit.ok == w_want).all():
        raise AssertionError("witness batch acceptance differs from numpy")
    indexed.check_insert_witness(wit)

    # host checks over the whole prefix
    t0 = time.perf_counter()
    vals_h, nvs_h, nis_h = (np.asarray(a) for a in
                            (tree.vals, tree.next_vals, tree.next_idxs))
    check_leaf_state(vals_h, nvs_h, nis_h, tree.count,
                     np.concatenate([stream, wv], axis=1),
                     np.concatenate([model, w_want]))
    slots = np.sort(rng.choice(tree.count + 1, min(samples, tree.count + 1),
                               replace=False))
    folded = fold_proofs_native(tree, slots, vals_h, nvs_h, nis_h)
    if not folded.all():
        raise AssertionError(f"proofs of slots {slots[~folded][:8].tolist()} "
                             f"do not fold to the device root")
    health.check_tree(tree)
    out["host_checks_s"] = time.perf_counter() - t0
    out["accepted"] = int(model.sum() + w_want.sum())
    return out


# ---------------------------------------------------------------------------
# Phase 5: permutation engines, one batch at each width
# ---------------------------------------------------------------------------

def phase_engine_timing(widths=(1 << 10, 1 << 12, 1 << 14, 1 << 16),
                        k1: int = 2, k2: int = 10) -> list:
    """Per-batch time from the (k2 - k1) slope, which cancels dispatch."""
    import jax.numpy as jnp
    from imt_tpu.ops.engine_timing import ENGINES, permutation_loop
    rows = []
    for name in ENGINES:
        for w in widths:
            f = permutation_loop(name, w)
            _, t_c = _timed(lambda: f(jnp.uint32(1), k1))
            t = {k: min(_timed(lambda: f(jnp.uint32(2), k))[1]
                        for _ in range(2)) for k in (k1, k2)}
            per = (t[k2] - t[k1]) / (k2 - k1)
            rows.append({"engine": name, "width": w, "compile_first_s": t_c,
                         "us_per_batch": per * 1e6,
                         "perms_per_s": w / per if per > 0 else float("nan")})
    return rows


# ---------------------------------------------------------------------------
# --devices N: the sharded tree over N cards vs the single-card tree
# ---------------------------------------------------------------------------

def _drive(tree, groups, wv, q) -> dict:
    """Load `groups` ([B, 16, K] each) through insert_batches, then one
    witness batch and one non-inclusion batch; everything as host arrays."""
    t0 = time.perf_counter()
    oks = np.concatenate([np.asarray(tree.insert_batches(g)).reshape(-1)
                          for g in groups])
    out = {"load_s": time.perf_counter() - t0, "oks": oks,
           "root_loaded": tree.get_root_int()}
    w = tree.insert_batch(wv, witness=True)
    out["witness"] = {k: np.asarray(v) for k, v in vars(w).items()}
    ni = tree.non_inclusion_witness(q)
    out["non_inclusion"] = {k: np.asarray(v) for k, v in vars(ni).items()}
    out["root_final"] = tree.get_root_int()
    return out


def _sharded_compile_jobs(st, chain_shape, wv, q) -> list:
    """Callables that compile, without running, the three multi-device
    programs _drive runs on the sharded tree `st` (the chained insert, the
    witness batch, the non-inclusion batch), each returning its compile
    time.  They lower with the arguments _drive's calls pass, so those
    calls find their programs compiled."""
    import jax
    import jax.numpy as jnp
    from imt_tpu.parallel import local_plan

    t, mesh = st._inner, st._mesh
    d = mesh.devices.size
    key = (tuple(dev.id for dev in mesh.devices.flat),)
    local_plan._MESHES[key] = mesh
    state = (t.vals, t.next_vals, t.next_idxs, *t.levels)
    ad = t.active_depth
    b, _, k = chain_shape

    def repl(a):
        return jax.device_put(np.asarray(a, dtype=np.uint32), st._repl)

    progs = (
        (local_plan._local_insert_batch_fn(ad, k, d, key, t.node_repr, b),
         (repl(np.zeros(chain_shape)), jnp.int32(0))),
        (local_plan._local_insert_batch_witness_fn(
            ad, wv.shape[1], d, key, t.tree_depth, t.node_repr),
         (repl(wv), jnp.int32(0))),
        (local_plan._local_non_inclusion_fn(
            ad, q.shape[1], d, key, t.tree_depth, t.node_repr),
         (repl(q),)),
    )

    def job(prog, args):
        t0 = time.perf_counter()
        prog.run.lower(*state, *args).compile()
        return time.perf_counter() - t0
    return [lambda p=p, a=a: job(p, a) for p, a in progs]


def phase_sharded(n_devices: int, leaves_log2: int = 23, batch: int = BATCH,
                  group: int = GROUP, queries: int = 65536,
                  witness_k: int = WITNESS_K, seed: int = 0) -> dict:
    """The sharded tree over n_devices against a SparseIndexedMerkleTree on
    device 0, both loaded with the same stream, then one witness batch and
    one non-inclusion batch on each, compared field by field; and
    dryrun_multichip(n_devices).

    A tree program takes minutes to compile for an H100, so the work is
    spread over threads.  Multi-device programs run from this thread only
    (see dryrun_multichip): it runs the dry run first, while worker
    threads compile the sharded tree's three programs ahead of time, run
    the device-0 tree, and compile its witness and non-inclusion programs
    on two empty twins of it (same shapes, so the same programs)."""
    from concurrent.futures import ThreadPoolExecutor

    import jax.numpy as jnp
    from imt_tpu.ops import field
    from imt_tpu.parallel.sharded import ShardedIndexedMerkleTree, make_mesh
    from imt_tpu.tree.sparse import SparseIndexedMerkleTree

    import __graft_entry__

    t0 = time.perf_counter()
    st = ShardedIndexedMerkleTree(DEPTH, mesh=make_mesh(n_devices),
                                  sparse=True,
                                  initial_capacity_log2=leaves_log2)
    cap = 1 << leaves_log2
    n_groups = (cap - witness_k - 1) // (batch * group)
    n = n_groups * group * batch
    stream = make_stream(seed + 7, n, batch)
    model = first_occurrence_model(stream)
    groups = [jnp.asarray(np.ascontiguousarray(
        stream[:, g * group * batch:(g + 1) * group * batch]
        .reshape(field.LIMBS, group, batch).transpose(1, 0, 2)))
        for g in range(n_groups)]
    wv = field.random_limbs(seed + 8, witness_k)
    wv[:, 0] = stream[:, np.nonzero(model)[0][0]]
    q = np.concatenate([stream[:, :queries // 2],
                        field.random_limbs(seed + 9, queries - queries // 2)],
                       axis=1)
    out = {"values": n, "setup_s": time.perf_counter() - t0}
    log(f"  {n} values staged in {out['setup_s']:.1f} s")

    def twin_witness():
        SparseIndexedMerkleTree(DEPTH, leaves_log2).insert_batch(
            wv, witness=True)

    def twin_non_inclusion():
        SparseIndexedMerkleTree(DEPTH, leaves_log2).non_inclusion_witness(q)

    def submit(label, fn, *args):
        """Run fn in a worker; log when it ends, so a cut run shows how
        far each thread got."""
        f = pool.submit(fn, *args)
        f.add_done_callback(lambda f: log(
            f"  {label} {'failed' if f.exception() else 'done'} at "
            f"{time.perf_counter() - t0:.1f} s"))
        return f

    t0 = time.perf_counter()
    with ThreadPoolExecutor(6) as pool:
        compiles = [submit(f"sharded {name} compile", job) for name, job in
                    zip(("chain", "witness", "non-inclusion"),
                        _sharded_compile_jobs(st, groups[0].shape, wv, q))]
        twins = [submit("card-0 witness compile (twin)", twin_witness),
                 submit("card-0 non-inclusion compile (twin)",
                        twin_non_inclusion)]
        f_ref = submit("card-0 tree", _drive, SparseIndexedMerkleTree(
            DEPTH, leaves_log2), groups, wv, q)
        __graft_entry__.dryrun_multichip(n_devices)
        out["dryrun_s"] = time.perf_counter() - t0
        log(f"  dryrun_multichip({n_devices}) ok at {out['dryrun_s']:.1f} s")
        out["sharded_compile_s"] = [f.result() for f in compiles]
        got = _drive(st, groups, wv, q)
        log(f"  sharded tree done at {time.perf_counter() - t0:.1f} s")
        want = f_ref.result()
        for f in twins:
            f.result()
    out.update(sharded_load_s=got["load_s"], single_load_s=want["load_s"],
               concurrent_wall_s=time.perf_counter() - t0)
    if not ((got["oks"] == model).all() and (want["oks"] == model).all()):
        raise AssertionError("acceptance masks differ from the numpy model")
    for key in ("root_loaded", "root_final"):
        if got[key] != want[key]:
            raise AssertionError(f"{key}: sharded root differs from card 0")
    for part in ("witness", "non_inclusion"):
        for name, v in want[part].items():
            if not (got[part][name] == v).all():
                raise AssertionError(f"{part} field {name} differs")
    out["bit_exact"] = True
    return out


# ---------------------------------------------------------------------------

def _require_checkout() -> None:
    """Run only against the package in this checkout, never another copy."""
    try:
        import imt_tpu
    except ImportError:
        raise SystemExit("chip_smoke.py: the imt_tpu package is not beside "
                         "this script; run it from a checkout") from None
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(imt_tpu.__file__)))
    if pkg != HERE:
        raise SystemExit(f"chip_smoke.py: imt_tpu was imported from {pkg}, "
                         f"not from this checkout")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="N > 1: run only the sharded path over N cards")
    ap.add_argument("--leaves-log2", type=int, default=None,
                    help="phase-4 slots (default 22; 23 with --devices)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    _require_checkout()
    from imt_tpu.utils.device import parse_smi_line, require_gpu, smi_line
    devs = require_gpu()
    if len(devs) < args.devices:
        raise SystemExit(f"need {args.devices} GPUs, have {len(devs)}")
    used = devs[:args.devices]
    import jax
    from imt_tpu.utils.cache import setup_compile_cache

    cache = setup_compile_cache()
    smi = smi_line()
    card, limit = parse_smi_line(smi)
    tag = f"[{card}, {limit}]"
    log(f"nvidia-smi: {smi}")
    log(f"device_kind: {used[0].device_kind} x{len(used)} "
        f"({len(devs)} visible)")
    log(f"jax {jax.__version__}")
    log(f"compile cache: {cache}")

    def run(label, fn):
        log(f"{label}: started")
        t0 = time.perf_counter()
        res = fn()
        dt = time.perf_counter() - t0
        log(f"{label}: ok in {dt:.3f} s {tag}")
        log(f"  {json.dumps(res)}")
        return res

    t_start = time.perf_counter()
    if args.devices > 1:
        run(f"sharded tree over {args.devices} cards vs card 0",
            lambda: phase_sharded(args.devices, args.leaves_log2 or 23,
                                  seed=args.seed))
    else:
        run("phase 1 hash parity (65,536 lanes + edges vs C++ oracle)",
            lambda: phase_hash_parity(seed=args.seed))
        run("phase 2 reference replay vs python oracle",
            phase_reference_replay)
        run("phase 3 4,096 inserts vs NativeIndexedTree",
            lambda: phase_native_mid_root(seed=args.seed))
        leaves = args.leaves_log2 or 22
        run(f"phase 4 deployment tree (2^{leaves} slots, depth {DEPTH})",
            lambda: phase_deployment(leaves, seed=args.seed))
        rows = run("phase 5 permutation engines", phase_engine_timing)
        log(f"{'engine':6} {'width':>6} {'us/batch':>12} {'perms/s':>14}")
        for r in rows:
            log(f"{r['engine']:6} {r['width']:>6} {r['us_per_batch']:>12.1f} "
                f"{r['perms_per_s']:>14.0f} {tag}")
    log(f"total: {time.perf_counter() - t_start:.1f} s {tag}")
    print(ok_line(used[0].platform, used[0].device_kind, len(used)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

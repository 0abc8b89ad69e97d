"""Shard-local batched-insert planner: bit-exact vs the single-device
planner, with only O(K) collectives (see parallel/local_plan.py and
tools/collective_inventory.py).  Runs in a subprocess with a 4-virtual-
device CPU mesh (same rationale as tests/test_parallel.py)."""

import os
import subprocess
import sys

_SCRIPT = r"""
import jax
jax.config.update("jax_platforms", "cpu")
import os
from imt_tpu.utils.cache import setup_compile_cache
setup_compile_cache()
import random
import numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from imt_tpu.ops import field
from imt_tpu.parallel import sharded, local_plan
from imt_tpu.tree.indexed import IndexedMerkleTree

assert len(jax.devices()) == 4, jax.devices()
mesh = sharded.make_mesh(4)
rng = random.Random(0x10CA1)

depth, k = 7, 8
st = IndexedMerkleTree(depth)
# place state shard-wise like ShardedIndexedMerkleTree does
shard = NamedSharding(mesh, P(None, "shard"))
repl = NamedSharding(mesh, P())
def place(t):
    t.vals = jax.device_put(t.vals, shard)
    t.next_vals = jax.device_put(t.next_vals, shard)
    t.next_idxs = jax.device_put(t.next_idxs, shard)
    t.levels = tuple(
        jax.device_put(l, shard if l.shape[1] % 4 == 0 and l.shape[1] >= 4
                       else repl) for l in t.levels)
place(st)
ref = IndexedMerkleTree(depth)

batches = []
inserted = []
for b in range(5):
    vals = []
    for _ in range(k):
        r = rng.random()
        if r < 0.2 and inserted:
            vals.append(rng.choice(inserted))          # duplicate of existing
        elif r < 0.3 and vals:
            vals.append(vals[0])                       # intra-batch duplicate
        elif r < 0.35:
            vals.append(0)                             # zero (rejected)
        else:
            v = rng.randrange(1, field.P)
            vals.append(v)
    batches.append(vals)
    inserted += [v for v in vals if v]

for b, vals in enumerate(batches):
    arr = field.ints_to_limbs(vals)
    ok_l = np.asarray(local_plan.local_insert_batch(
        st, jax.device_put(jnp.asarray(arr), repl), mesh, k))
    ok_r = np.asarray(ref.insert_batch(list(vals)))
    assert ok_l.tolist() == ok_r.tolist(), (b, ok_l, ok_r)
    assert st.get_root_int() == ref.get_root_int(), f"root mismatch batch {b}"
    # full leaf-state parity, not just the root
    for name in ("vals", "next_vals", "next_idxs"):
        assert (np.asarray(getattr(st, name))
                == np.asarray(getattr(ref, name))).all(), (b, name)

# proofs from the locally-planned tree verify like the reference ones
proof, helpers = st.get_proof(1)
rp, rh = ref.get_proof(1)
assert (np.asarray(proof) == np.asarray(rp)).all()

# small-K config exercises the dirty-path branch below the local width
# switch (the K=8 config switches to full local rebuild at level 0)
st2, ref2 = IndexedMerkleTree(8), IndexedMerkleTree(8)
place(st2)
for b in range(3):
    vals = [rng.randrange(1, field.P) for _ in range(2)]
    arr = jax.device_put(jnp.asarray(field.ints_to_limbs(vals)), repl)
    ok_l = np.asarray(local_plan.local_insert_batch(st2, arr, mesh, 2))
    ok_r = np.asarray(ref2.insert_batch(list(vals)))
    assert ok_l.tolist() == ok_r.tolist(), b
    assert st2.get_root_int() == ref2.get_root_int(), b

# shard-local WITNESS-producing batch insert: full per-insert insert_leaf
# bundles, field-exact vs the single-device witness path on accepted lanes
stw = IndexedMerkleTree(depth)
refw = IndexedMerkleTree(depth)
place(stw)
for b in range(3):
    vals = [rng.randrange(1, field.P) for _ in range(k)]
    if b == 1:
        vals[2] = vals[0]                     # intra-batch duplicate
        vals[5] = 0                           # zero (rejected)
    arr = jax.device_put(jnp.asarray(field.ints_to_limbs(vals)), repl)
    wl = local_plan.local_insert_batch_witness(stw, arr, mesh, k)
    wr = refw.insert_batch(list(vals), witness=True)
    assert np.asarray(wl["ok"]).tolist() == wr.ok.tolist(), b
    okm = np.asarray(wl["ok"])
    for f_ in ("old_root", "new_root", "low_leaf_val", "low_leaf_next_val",
               "low_leaf_next_idx", "low_leaf_proof",
               "low_leaf_proof_helper", "new_leaf_val", "new_leaf_next_val",
               "new_leaf_next_idx", "new_leaf_index", "new_leaf_proof",
               "new_leaf_proof_helper", "is_new_leaf_largest"):
        a, b_ = np.asarray(wl[f_]), np.asarray(getattr(wr, f_))
        assert (a[..., okm] == b_[..., okm]).all(), (b, f_)
    assert stw.get_root_int() == refw.get_root_int(), b
    for name in ("vals", "next_vals", "next_idxs"):
        assert (np.asarray(getattr(stw, name))
                == np.asarray(getattr(refw, name))).all(), (b, name)
# every accepted lane satisfies the insert_leaf predicate
from imt_tpu.tree.indexed import insert_leaf
pred = np.asarray(insert_leaf(
    wl["old_root"], wl["low_leaf_val"], wl["low_leaf_next_val"],
    wl["low_leaf_next_idx"], wl["low_leaf_proof"],
    wl["low_leaf_proof_helper"], wl["new_root"], wl["new_leaf_val"],
    wl["new_leaf_next_val"], wl["new_leaf_next_idx"],
    jnp.asarray(np.asarray(wl["new_leaf_index"])), wl["new_leaf_proof"],
    wl["new_leaf_proof_helper"],
    jnp.asarray(np.asarray(wl["is_new_leaf_largest"]))))
assert pred[okm].all(), "insert_leaf predicate rejected local-plan witness"

# shard-local non-inclusion witness: field-exact vs the single-device path,
# including duplicate (present) queries -> ok=False
queries = ([rng.randrange(1, field.P) for _ in range(5)]
           + [inserted[0], inserted[-1], 0])
qarr = jax.device_put(jnp.asarray(field.ints_to_limbs(queries)), repl)
wl = local_plan.local_non_inclusion_witness(st, qarr, mesh, len(queries))
wr = ref.non_inclusion_witness(list(queries))
assert np.asarray(wl["ok"]).tolist() == wr.ok.tolist()
assert not np.asarray(wl["ok"])[5:7].any(), "present values must fail"
for f_ in ("root", "low_leaf_val", "low_leaf_next_val", "low_leaf_next_idx",
           "low_leaf_proof", "low_leaf_proof_helper", "is_new_leaf_largest"):
    okm = np.asarray(wl["ok"])
    a, b_ = np.asarray(wl[f_]), np.asarray(getattr(wr, f_))
    assert (a[..., okm] == b_[..., okm]).all(), f_
# and the verify predicate accepts every ok lane
from imt_tpu.tree.indexed import verify_non_inclusion
pred = np.asarray(verify_non_inclusion(
    wl["root"], wl["low_leaf_val"], wl["low_leaf_next_val"],
    wl["low_leaf_next_idx"], wl["low_leaf_proof"],
    wl["low_leaf_proof_helper"], jnp.asarray(np.asarray(qarr)),
    jnp.asarray(np.asarray(wl["is_new_leaf_largest"]))))
assert (pred[np.asarray(wl["ok"])]).all()

# chained shard-local batches: ONE shard_map program for B batches must be
# state-identical to B separate planned batches (cross-batch duplicate
# included) and to the single-device chained program
stc, refc = IndexedMerkleTree(depth), IndexedMerkleTree(depth)
place(stc)
cbatches = [[rng.randrange(1, field.P) for _ in range(4)] for _ in range(3)]
cbatches[1][2] = cbatches[0][1]                 # cross-batch duplicate
arrs = np.stack([field.ints_to_limbs(v) for v in cbatches])
oks_c = np.asarray(local_plan.local_insert_batches(
    stc, jax.device_put(jnp.asarray(arrs), repl), mesh, 4, 3))
oks_r = np.stack([np.asarray(refc.insert_batch(list(v))) for v in cbatches])
assert oks_c.tolist() == oks_r.tolist()
assert stc.get_root_int() == refc.get_root_int(), "chained root mismatch"
for name in ("vals", "next_vals", "next_idxs"):
    assert (np.asarray(getattr(stc, name))
            == np.asarray(getattr(refc, name))).all(), name

# the container API: local_plan=True is the DEFAULT; the GSPMD path
# (local_plan=False) is the explicit comparator
from imt_tpu.parallel.sharded import ShardedIndexedMerkleTree
sp = ShardedIndexedMerkleTree(24, mesh=mesh, sparse=True,
                              initial_capacity_log2=4)
assert sp.local_plan, "local_plan must default on"
rp24 = ShardedIndexedMerkleTree(24, mesh=mesh, sparse=True,
                                initial_capacity_log2=4, local_plan=False)
for b in range(2):
    vals = [rng.randrange(1, field.P) for _ in range(8)]
    assert sp.insert_batch(vals).tolist() == rp24.insert_batch(vals).tolist()
    assert sp.get_root_int() == rp24.get_root_int(), b
# container-level local witness batch on the sharded-sparse tree (full
# tree_depth=24 bundles over the zero spine)
wv = [rng.randrange(1, field.P) for _ in range(8)]
wls2 = sp.insert_batch(wv, witness=True)
wrs2 = rp24.insert_batch(wv, witness=True)
assert wls2.ok.tolist() == wrs2.ok.tolist()
assert (np.asarray(wls2.new_root) == np.asarray(wrs2.new_root)).all()
assert (np.asarray(wls2.new_leaf_proof)
        == np.asarray(wrs2.new_leaf_proof)).all()
assert sp.get_root_int() == rp24.get_root_int()
# container-level local non-inclusion witness on the sharded-sparse tree
# (full tree_depth=24 proofs over the zero spine)
qs = [rng.randrange(1, field.P) for _ in range(4)]
wls = sp.non_inclusion_witness(qs)
wrs = rp24.non_inclusion_witness(qs)
assert wls.ok.tolist() == wrs.ok.tolist()
assert (np.asarray(wls.low_leaf_proof)[..., wls.ok]
        == np.asarray(wrs.low_leaf_proof)[..., wls.ok]).all()
assert (np.asarray(wls.root) == np.asarray(wrs.root)).all()
# container-level chained insert_batches (local-plan chain vs GSPMD chain)
cb = [[rng.randrange(1, field.P) for _ in range(4)] for _ in range(2)]
assert sp.insert_batches(cb).tolist() == rp24.insert_batches(cb).tolist()
assert sp.get_root_int() == rp24.get_root_int()
# insert_seq routes to the shard-local witness batch (bit-identical to
# sequential insertion) — compare with the GSPMD container's true
# sequential scan
sv = [rng.randrange(1, field.P) for _ in range(3)]
wseq_l = sp.insert_seq(sv)
wseq_r = rp24.insert_seq(sv)
assert wseq_l.ok.tolist() == wseq_r.ok.tolist()
assert (np.asarray(wseq_l.new_root) == np.asarray(wseq_r.new_root)).all()
assert (np.asarray(wseq_l.new_leaf_proof)
        == np.asarray(wseq_r.new_leaf_proof)).all()
assert sp.get_root_int() == rp24.get_root_int()
print("LOCAL-PLAN-OK")
"""


def test_local_plan_bit_exact_subprocess():
    here = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(here, "_local_plan_check.py")
    with open(script, "w") as f:
        f.write(_SCRIPT)
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=4").strip()
    env["JAX_PLATFORMS"] = "cpu"
    repo_root = os.path.dirname(here)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, script], env=env,
                         capture_output=True, text=True, timeout=1500,
                         cwd=os.path.dirname(here))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOCAL-PLAN-OK" in out.stdout


def test_rank_plan_unit():
    """Direct contract test of local_plan._rank_plan against a brute-force
    sequential simulation — crafted lanes the integration A/Bs only hit by
    luck: duplicate-of-participant, intra-batch duplicate, zero, a low that
    is another accepted new entry, and two accepted entries whose naive low
    would be the same participant (uniqueness of wr targets)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import jax.numpy as jnp
    from imt_tpu.ops import field
    from imt_tpu.parallel.local_plan import _rank_plan

    # participants: sentinel (0, slot 0) + values 100 (slot 1), 200 (slot 2)
    parts = [(0, 0), (100, 1), (200, 2)]
    new = [150, 150, 300, 100, 0, 120]
    k = len(new)
    count = 2
    slots_py = [count + 1 + i for i in range(k)]

    # qpos: query positions in a (value, is_query, idx)-sorted local table —
    # only the RELATIVE order of queries matters; emulate with (value, idx)
    order = sorted(range(k), key=lambda i: (new[i], i))
    qpos_py = [0] * k
    for r, i in enumerate(order):
        qpos_py[i] = r

    # brute-force global below1/above1 per query (ties: below1 catches ==)
    blo, bhi = [], []
    for v in new:
        below = [pv for pv in parts if pv[0] <= v]
        above = [pv for pv in parts if pv[0] > v]
        blo.append(max(below) if below else None)
        bhi.append(min(above) if above else None)

    def col(ints):
        return jnp.asarray(field.ints_to_limbs(ints))

    rp = _rank_plan(
        col(new), jnp.asarray(slots_py, jnp.int32),
        jnp.asarray(qpos_py, jnp.int32),
        col([b[0] if b else 0 for b in blo]),
        jnp.asarray([b[1] if b else 0 for b in blo], jnp.int32),
        jnp.asarray([b is not None for b in blo]),
        col([b[0] if b else 0 for b in bhi]),
        jnp.asarray([b[1] if b else 0 for b in bhi], jnp.int32),
        jnp.asarray([b is not None for b in bhi]), k)

    # brute-force sequential acceptance + FINAL-list neighbors
    live = {v: s for v, s in parts}            # value -> slot
    ok_exp, low_exp, succ_exp = [], [], []
    for i, v in enumerate(new):
        if v in live:
            ok_exp.append(False)
            low_exp.append(None)
            succ_exp.append(None)
            continue
        ok_exp.append(True)
        live[v] = slots_py[i]
        low_exp.append(i)
        succ_exp.append(i)
    fin = sorted(live)
    ok = np.asarray(rp["ok"])
    assert list(ok) == ok_exp, (list(ok), ok_exp)
    low_slot = np.asarray(rp["low_slot"])
    fs_val = field.limbs_to_ints(np.asarray(rp["fin_succ_val"]))
    fs_slot = np.asarray(rp["fin_succ_slot"])
    has_fin = np.asarray(rp["has_fin"])
    lo_is_new = np.asarray(rp["lo_is_new"])
    for i, v in enumerate(new):
        if not ok_exp[i]:
            continue
        pos = fin.index(v)
        exp_low_val = fin[pos - 1]             # sentinel 0 guarantees pos>0
        exp_low_slot = live[exp_low_val]
        assert low_slot[i] == exp_low_slot, (i, low_slot[i], exp_low_slot)
        acc_new_vals = {new[j] for j in range(k) if ok_exp[j]}
        assert bool(lo_is_new[i]) == (exp_low_val in acc_new_vals), i
        if pos + 1 < len(fin):
            assert bool(has_fin[i]) and fs_val[i] == fin[pos + 1] \
                and fs_slot[i] == live[fin[pos + 1]], i
        else:
            assert not bool(has_fin[i]) and fs_val[i] == 0 \
                and fs_slot[i] == 0, i
    # wr-target uniqueness: accepted lanes whose low is an existing entry
    wr_targets = [int(low_slot[i]) for i in range(k)
                  if ok_exp[i] and not lo_is_new[i]]
    assert len(wr_targets) == len(set(wr_targets)), wr_targets
    # the crafted case: 120 and 150 both sit above participant 100, but
    # only 120 (the lower) rewrites it — 150's low must be the NEW 120
    i120, i150 = new.index(120), new.index(150)
    assert not lo_is_new[i120] and low_slot[i120] == 1
    assert lo_is_new[i150] and low_slot[i150] == slots_py[i120]

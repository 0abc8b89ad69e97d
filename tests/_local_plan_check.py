
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

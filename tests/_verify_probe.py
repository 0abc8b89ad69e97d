"""Package-boundary verify probes (the /verify skill's drive recipes 1-3),
runnable standalone from outside the repo dir."""
from imt_tpu.utils.cache import setup_compile_cache

setup_compile_cache()
import numpy as np

from imt_tpu.ops.poseidon_ref import generate_params, hash_fixed

params = generate_params()
ANCHOR = 1960587138944869480785025106734196872454309951825657414575195034687326603497
assert hash_fixed([0, 0, 0], params) == ANCHOR
print("1. anchor OK", flush=True)

from imt_tpu.tree.indexed import IndexedMerkleTree
from imt_tpu.tree.reference_oracle import OracleIndexedTree

t, o = IndexedMerkleTree(3), OracleIndexedTree(3)
for v in [30, 10, 20, 5, 50, 35]:
    w = t.insert(v)
    assert w.ok.all()
    o.insert(v)
    assert t.get_root_int() == o.get_root()
assert not t.insert_batch([20]).any()
assert t.non_inclusion_witness([20, 21]).ok.tolist() == [False, True]
print("3. tree replay OK", flush=True)

t2, o2 = IndexedMerkleTree(4), OracleIndexedTree(4)
assert t2.insert_batch([30, 10, 20, 5, 50, 35]).all()
for v in [30, 10, 20, 5, 50, 35]:
    o2.insert(v)
assert t2.get_root_int() == o2.get_root()
print("3b. diet batch planner vs oracle OK", flush=True)

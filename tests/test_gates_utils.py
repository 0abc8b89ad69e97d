"""Gadget surface (gates.py) + utils (config/checkpoint/observability)."""

import random

import numpy as np
import pytest

import jax.numpy as jnp

from imt_tpu.ops import field, gates
from imt_tpu.tree.indexed import IndexedMerkleTree
from imt_tpu.utils import checkpoint
from imt_tpu.utils.config import EngineConfig
from imt_tpu.utils.observability import Metrics

rng = random.Random(0x6A7E5)


def test_select_matches_reference_semantics():
    # reference test_select: s=false -> output == b (src/indexed_merkle_tree.rs:349-358)
    a = field.ints_to_limbs([69])
    b = field.ints_to_limbs([420])
    out = gates.select(np.array([False]), a, b)
    assert field.limbs_to_ints(np.asarray(out)) == [420]
    out = gates.select(np.array([True]), a, b)
    assert field.limbs_to_ints(np.asarray(out)) == [69]


def test_dual_mux():
    a = field.ints_to_limbs([1, 1])
    b = field.ints_to_limbs([2, 2])
    l, r = gates.dual_mux(a, b, np.array([True, False]))
    assert field.limbs_to_ints(np.asarray(l)) == [1, 2]
    assert field.limbs_to_ints(np.asarray(r)) == [2, 1]


def test_assert_bit():
    gates.assert_bit(np.array([0, 1, 1]))
    with pytest.raises(ValueError):
        gates.assert_bit(np.array([0, 2]))


def test_is_less_than_128_split_semantics():
    pow128 = 1 << 128
    cases = [
        (5, 7), (7, 5), (5, 5),
        (3 * pow128 + 10, 3 * pow128 + 11),
        (2 * pow128 + 9, 5 * pow128 + 1),
        (5 * pow128 + 1, 2 * pow128 + 9),
        # the reference's masked-typo class: equal low limbs, differing high
        (7 * pow128 + 42, 9 * pow128 + 42),
        (9 * pow128 + 42, 7 * pow128 + 42),
    ]
    for _ in range(300):
        cases.append((rng.getrandbits(254) % field.P,
                      rng.getrandbits(254) % field.P))
    a = field.ints_to_limbs([c[0] for c in cases])
    b = field.ints_to_limbs([c[1] for c in cases])
    got = np.asarray(gates.less_than_254(a, b))
    assert (got == np.array([x < y for x, y in cases])).all()


def test_verify_merkle_proof_gadget():
    tree = IndexedMerkleTree(3)
    tree.insert_batch([4, 9, 2, 7, 5, 3])
    proof, helpers = tree.get_proof(2)
    from imt_tpu.ops.poseidon_jax import hash3
    v, nv, ni = tree.get_leaf_ints(2)
    leaf = hash3(*[jnp.asarray(field.ints_to_limbs([x])) for x in (v, nv, ni)])
    assert np.asarray(gates.verify_merkle_proof(
        tree.get_root(), leaf, proof, helpers)).all()
    bad = jnp.asarray(field.ints_to_limbs([12345]))
    assert not np.asarray(gates.verify_merkle_proof(
        tree.get_root(), bad, proof, helpers)).any()


def test_checkpoint_roundtrip(tmp_path):
    tree = IndexedMerkleTree(3)
    tree.insert_batch([11, 5, 19, 3, 7, 2])
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(tree, path)
    restored = checkpoint.load(path)
    assert restored.get_root_int() == tree.get_root_int()
    assert restored.count == tree.count
    # resumed tree keeps working
    restored.insert(100)
    tree.insert(100)
    assert restored.get_root_int() == tree.get_root_int()


def test_config_and_metrics():
    cfg = EngineConfig()
    assert cfg.poseidon.r_p == 57 and cfg.hash_engine == "auto"
    m = Metrics()
    m.record_hashes(10)
    m.record_inserts(5, rejected=1)
    snap = m.snapshot()
    assert snap["permutations"] == 20 and snap["inserts_rejected"] == 1
    assert snap["perms_per_s"] > 0


def test_config_builds_engine_and_engine_updates_metrics():
    """EngineConfig actually drives construction, and the engine paths
    actually update GLOBAL_METRICS (insert / insert_batch / queries)."""
    import pytest

    from imt_tpu.tree.indexed import IndexedMerkleTree
    from imt_tpu.tree.sparse import SparseIndexedMerkleTree
    from imt_tpu.utils.config import PoseidonConfig
    from imt_tpu.utils.observability import GLOBAL_METRICS

    # unsupported Poseidon spec is rejected (bit-exactness pin)
    with pytest.raises(ValueError):
        EngineConfig(poseidon=PoseidonConfig(r_p=56)).apply()

    t = EngineConfig(tree_depth=4, mesh_devices=0).build_tree()
    assert isinstance(t, IndexedMerkleTree)
    ts = EngineConfig(tree_depth=24, mesh_devices=0,
                      initial_capacity_log2=3).build_tree()
    assert isinstance(ts, SparseIndexedMerkleTree)

    before = GLOBAL_METRICS.snapshot()
    t.insert(7)
    ok = t.insert_batch([9, 9])           # one accepted, one duplicate
    assert list(ok) == [True, False]
    t.non_inclusion_witness([8])
    after = GLOBAL_METRICS.snapshot()
    assert after["inserts"] == before["inserts"] + 2
    assert after["inserts_rejected"] == before["inserts_rejected"] + 1
    assert after["non_inclusion_queries"] == before["non_inclusion_queries"] + 1
    assert after["hashes"] > before["hashes"]


def test_trace_scope(tmp_path):
    import jax.numpy as jnp

    from imt_tpu.utils import observability

    with observability.trace("unit"):                  # annotation-only
        x = jnp.arange(4.0) * 2
    assert float(x[1]) == 2.0
    with observability.trace("unit2", trace_dir=str(tmp_path)):
        jnp.arange(8.0).sum().block_until_ready()
    # a profile capture must have been written
    assert any(tmp_path.rglob("*")), "profiler wrote nothing"

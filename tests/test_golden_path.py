"""Literal replay of the reference's primary integration test.

Mirrors test_insert_leaf (reference src/indexed_merkle_tree.rs:360-596)
exactly: a depth-3 tree of H(0,0,0) leaves, a random 254-bit value inserted
as the LARGEST element (index 1, is_new_leaf_largest=true), then the fixed
value 42 inserted as a MIDDLE element (index 2, low leaf = leaf 0 pointing at
the first value, is_new_leaf_largest=false).  For each insertion the witness
bundle is built two ways:

  1. by the engine (IndexedMerkleTree.insert), and
  2. by the reference's own discipline — manual low-leaf bookkeeping plus a
     FULL tree rebuild through the plain MerkleTree (the reference rebuilds
     all leaves and calls IndexedMerkleTree::new, :545-547),

and the insert_leaf predicate must accept it (the expect_satisfied(true)
analog, :492-496).
"""

import random

import numpy as np

import jax.numpy as jnp

from imt_tpu.ops import field, hashing
from imt_tpu.tree import indexed
from imt_tpu.tree.merkle import MerkleTree

rng = random.Random()        # unseeded, like the reference's thread_rng


def _leaf_hashes(preimages):
    """[(val, next_val, next_idx)] -> canonical leaf-hash limb array."""
    a = field.ints_to_limbs([p[0] for p in preimages])
    b = field.ints_to_limbs([p[1] for p in preimages])
    c = field.ints_to_limbs([p[2] for p in preimages])
    return hashing.hash3(a, b, c)


def _assert_witness_matches_manual(w, old_root, new_root, low,
                                   low_proof, low_helpers,
                                   new_leaf, new_index,
                                   new_proof, new_helpers, is_largest):
    assert bool(w.ok.all())
    got = lambda x: np.asarray(x)[..., 0]
    assert field.limbs_to_int(got(w.old_root)) == old_root
    assert field.limbs_to_int(got(w.new_root)) == new_root
    assert field.limbs_to_int(got(w.low_leaf_val)) == low[0]
    assert field.limbs_to_int(got(w.low_leaf_next_val)) == low[1]
    assert field.limbs_to_int(got(w.low_leaf_next_idx)) == low[2]
    assert int(got(w.new_leaf_index)) == new_index
    assert field.limbs_to_int(got(w.new_leaf_val)) == new_leaf[0]
    assert field.limbs_to_int(got(w.new_leaf_next_val)) == new_leaf[1]
    assert field.limbs_to_int(got(w.new_leaf_next_idx)) == new_leaf[2]
    assert bool(got(w.is_new_leaf_largest)) == is_largest
    assert (np.asarray(w.low_leaf_proof)[:, :, 0]
            == np.asarray(low_proof)[:, :, 0]).all()
    assert (np.asarray(w.low_leaf_proof_helper)[:, 0]
            == np.asarray(low_helpers)[:, 0]).all()
    assert (np.asarray(w.new_leaf_proof)[:, :, 0]
            == np.asarray(new_proof)[:, :, 0]).all()
    assert (np.asarray(w.new_leaf_proof_helper)[:, 0]
            == np.asarray(new_helpers)[:, 0]).all()


def _assert_predicate_satisfied(w):
    ok = indexed.insert_leaf(
        w.old_root, w.low_leaf_val, w.low_leaf_next_val, w.low_leaf_next_idx,
        w.low_leaf_proof, w.low_leaf_proof_helper, w.new_root,
        w.new_leaf_val, w.new_leaf_next_val, w.new_leaf_next_idx,
        jnp.asarray(np.asarray(w.new_leaf_index)), w.new_leaf_proof,
        w.new_leaf_proof_helper, jnp.asarray(np.asarray(w.is_new_leaf_largest)))
    assert bool(np.asarray(ok).all())


def test_reference_golden_path():
    # random 254-bit value mod r, like the reference (:380-387); regenerate
    # on the (vanishing) chance it collides with the fixed second insert
    a = rng.getrandbits(254) % field.P
    while a in (0, 42):
        a = rng.getrandbits(254) % field.P

    t = indexed.IndexedMerkleTree(3)

    # ---- reference-style manual witness, insertion 1 (largest) ----------
    preimages = [(0, 0, 0)] * 8
    tree0 = MerkleTree.build(_leaf_hashes(preimages))
    old_root_1 = tree0.get_root_int()
    low_proof_1, low_helpers_1 = tree0.get_proof(0)
    # low leaf is leaf 0 = (0,0,0); rewrite + append at index 1 (:404-411)
    preimages = [(0, a, 1), (a, 0, 0)] + [(0, 0, 0)] * 6
    tree1 = MerkleTree.build(_leaf_hashes(preimages))
    new_proof_1, new_helpers_1 = tree1.get_proof(1)
    new_root_1 = tree1.get_root_int()

    w1 = t.insert(a)
    _assert_witness_matches_manual(
        w1, old_root_1, new_root_1, (0, 0, 0), low_proof_1, low_helpers_1,
        (a, 0, 0), 1, new_proof_1, new_helpers_1, True)
    _assert_predicate_satisfied(w1)

    # ---- insertion 2: the fixed 42, middle element (:492-537) ------------
    old_root_2 = new_root_1
    low_proof_2, low_helpers_2 = tree1.get_proof(0)
    # low leaf = (0, a, 1); new low = (0, 42, 2); new leaf at index 2
    preimages = [(0, 42, 2), (a, 0, 0), (42, a, 1)] + [(0, 0, 0)] * 5
    tree2 = MerkleTree.build(_leaf_hashes(preimages))
    new_proof_2, new_helpers_2 = tree2.get_proof(2)
    new_root_2 = tree2.get_root_int()

    w2 = t.insert(42)
    _assert_witness_matches_manual(
        w2, old_root_2, new_root_2, (0, a, 1), low_proof_2, low_helpers_2,
        (42, a, 1), 2, new_proof_2, new_helpers_2, False)
    _assert_predicate_satisfied(w2)

    assert t.get_root_int() == new_root_2


def test_reference_golden_path_batched():
    """The same two insertions as ONE witness-producing batch."""
    a = rng.getrandbits(254) % field.P
    while a in (0, 42):
        a = rng.getrandbits(254) % field.P
    t_seq = indexed.IndexedMerkleTree(3)
    w_seq = [t_seq.insert(a), t_seq.insert(42)]
    t_b = indexed.IndexedMerkleTree(3)
    wb = t_b.insert_batch([a, 42], witness=True)
    assert wb.ok.all()
    _assert_predicate_satisfied(wb)
    for i, ws in enumerate(w_seq):
        assert (np.asarray(wb.new_root)[:, i]
                == np.asarray(ws.new_root)[:, 0]).all()
    assert t_b.get_root_int() == t_seq.get_root_int()

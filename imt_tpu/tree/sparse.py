"""Sparse-prefix indexed Merkle tree — deep trees without dense storage.

The reference's native tree materializes every level densely
(src/utils.rs:20-57), which caps practical depth (~2^20 leaves).  Aztec-style
nullifier trees are specified at depth 32+; a dense level-0 array there would
be 2^32 field elements.  Insertions, however, only ever occupy slots
0..count (the slot cursor appends left-to-right — reference test planner,
src/indexed_merkle_tree.rs:632-660), so the tree is always an *active
prefix* of 2^ad leaves plus an all-empty right flank.

This class stores only the active prefix (dense arrays, doubled on demand)
plus the per-level zero-subtree hashes; roots and proofs are extended to
full depth with the left-spine fold (indexed._spine_fold / _extend_proof).
Bit-exactness: a SparseIndexedMerkleTree(depth) produces the same roots and
witnesses as IndexedMerkleTree(depth) for any insert sequence — enforced by
tests/test_sparse.py.

Capacity growth rehashes all active leaves once per doubling (amortized
O(1) hashes per insert).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from ..ops import field
from ..ops import hashing as poseidon_jax
from ..utils.observability import GLOBAL_METRICS, log_event
from . import indexed
from .indexed import InsertWitness


class SparseIndexedMerkleTree:
    """Indexed Merkle tree over 2^depth slots with sparse-prefix storage.

    Same API and witness semantics as indexed.IndexedMerkleTree; depth may
    be up to 48+.  initial_capacity_log2 sets the starting active prefix."""

    def __init__(self, depth: int, initial_capacity_log2: int = 10):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.tree_depth = depth
        self.active_depth = min(max(initial_capacity_log2, 1), depth)
        self.count = 0
        self.node_repr = indexed._repr_key()
        self._alloc(self.active_depth)

    def _alloc(self, ad: int):
        n = 1 << ad
        z = jnp.zeros((field.LIMBS, n), dtype=jnp.uint32)
        self.vals, self.next_vals, self.next_idxs = z, z, z
        self.levels = indexed._zero_levels(ad)   # node representation

    def _grow_to(self, need: int):
        """Double the active prefix until it holds `need` slots."""
        ad = self.active_depth
        while (1 << ad) < need:
            ad += 1
        if ad == self.active_depth:
            return
        if ad > self.tree_depth:
            raise ValueError("tree full")
        pad = (1 << ad) - self.vals.shape[1]
        zcol = jnp.zeros((field.LIMBS, pad), dtype=jnp.uint32)
        self.vals = jnp.concatenate([self.vals, zcol], axis=1)
        self.next_vals = jnp.concatenate([self.next_vals, zcol], axis=1)
        self.next_idxs = jnp.concatenate([self.next_idxs, zcol], axis=1)
        leaves = poseidon_jax.hash3_leaf(self.vals, self.next_vals,
                                         self.next_idxs)
        self.levels = indexed._build_levels_fn(ad, self.node_repr)(leaves)
        GLOBAL_METRICS.record_hashes((2 << ad) - 1)
        log_event("sparse_grow", active_depth=ad, slots=1 << ad)
        self.active_depth = ad

    # -- queries -------------------------------------------------------------

    _check_repr = indexed.IndexedMerkleTree._check_repr

    def get_root(self):
        self._check_repr()
        return indexed._root_fold_fn(self.active_depth, self.tree_depth,
                                     self.node_repr)(self.levels[-1])

    def get_root_int(self) -> int:
        return field.limbs_to_int(np.asarray(self.get_root())[:, 0])

    def get_leaf_ints(self, index: int):
        v = field.limbs_to_int(np.asarray(self.vals)[:, index])
        nv = field.limbs_to_int(np.asarray(self.next_vals)[:, index])
        ni = field.limbs_to_int(np.asarray(self.next_idxs)[:, index])
        return (v, nv, ni)

    def non_inclusion_witness(self, values,
                              as_numpy: bool = True) -> indexed.NonInclusionWitness:
        """Batched non-membership witnesses (full-depth proofs/roots).

        `values` is a list of python ints or a pre-packed limb array
        uint32[16, K]; as_numpy=False keeps every field device-resident
        (same contract as IndexedMerkleTree.non_inclusion_witness)."""
        self._check_repr()
        queries, k = indexed._as_limb_batch(values)
        GLOBAL_METRICS.record_queries(k)
        f = indexed._non_inclusion_witness_fn(
            self.active_depth, k, self.tree_depth, self.node_repr)
        w = f(self.vals, self.next_vals, self.next_idxs, self.levels, queries)
        if not as_numpy:
            return indexed.NonInclusionWitness(**w)
        wit = indexed.NonInclusionWitness(ok=np.asarray(w["ok"]), **{
            key: v for key, v in w.items() if key != "ok"})
        if indexed._debug_witness:
            indexed.check_non_inclusion_witness(wit, queries)
        return wit

    def get_proof(self, index: int):
        """Full-depth Merkle proof of the leaf at `index`: the active-prefix
        path extended with the zero-subtree spine (helper=1 above the
        prefix).  Matches IndexedMerkleTree.get_proof's (proof, helpers)."""
        self._check_repr()
        proof, helpers = indexed._get_proof_fn(
            self.active_depth, self.node_repr)(self.levels, jnp.int32(index))
        ext = self.tree_depth - self.active_depth
        if ext:
            sibs = jnp.asarray(indexed._zero_sib_cols(
                self.active_depth, self.tree_depth))        # [ext, 16, 1]
            proof = jnp.concatenate([proof, sibs])
            helpers = jnp.concatenate(
                [helpers, jnp.ones((ext, 1), helpers.dtype)])
        return proof, helpers

    def verify_proof(self, leaf, index, root, proof) -> bool:
        """Full-depth verify by index parity (reference src/utils.rs:87-107).
        Stateless: recomputes the root from the proof alone."""
        from . import merkle
        idx = jnp.asarray(np.asarray([index], dtype=np.int32))
        root_b = jnp.broadcast_to(jnp.asarray(root), (field.LIMBS, 1))
        return bool(np.asarray(merkle._verify_fn(proof.shape[0])(
            jnp.asarray(leaf), idx, root_b, jnp.asarray(proof)))[0])

    # -- mutation ------------------------------------------------------------

    def insert(self, value: int, as_numpy: bool = True) -> InsertWitness:
        """Sequential insert; witness proofs/roots are FULL tree depth.

        as_numpy=False keeps the witness device-resident (async-dispatch
        pipelining across chained inserts — see IndexedMerkleTree.insert).
        Prefer insert_seq for sequences (one dispatch per chunk instead of
        one per insert)."""
        self._check_repr()
        indexed._count_bare_insert()
        if self.count + 1 >= (1 << self.tree_depth):
            raise ValueError("tree full")
        self._grow_to(self.count + 2)
        step = indexed._insert_step_fn(self.active_depth, self.tree_depth,
                                       self.node_repr)
        new_val = jnp.asarray(field.int_to_limbs(value))[:, None]
        (self.vals, self.next_vals, self.next_idxs, self.levels), w = step(
            self.vals, self.next_vals, self.next_idxs, self.levels,
            new_val, jnp.int32(self.count))
        self.count += 1
        # 2 leaf hashes + 2 active paths + 2 zero-spine folds (old+new root)
        GLOBAL_METRICS.record_hashes(2 + 2 * self.tree_depth)
        if not as_numpy:
            GLOBAL_METRICS.record_submitted(1)
            return InsertWitness(**w)
        ok = np.asarray(w["ok"])
        GLOBAL_METRICS.record_inserts(int(ok.sum()), 1 - int(ok.sum()))
        wit = InsertWitness(ok=ok, **{
            k: v for k, v in w.items() if k != "ok"})
        if indexed._debug_witness:
            indexed.check_insert_witness(wit)
        return wit

    def insert_batch(self, values, witness: bool = False,
                     as_numpy: bool = True):
        """Batched insert; witness=True emits full-depth per-insert witness
        bundles (proofs/roots extended over the zero spine) — see
        IndexedMerkleTree.insert_batch."""
        self._check_repr()
        new_vals, k = indexed._as_limb_batch(values)
        if self.count + k >= (1 << self.tree_depth):
            raise ValueError("tree full")
        self._grow_to(self.count + k + 1)
        if witness:
            from .batch_witness import _insert_batch_witness_fn
            step = _insert_batch_witness_fn(
                self.active_depth, k, self.tree_depth, self.node_repr)
            (self.vals, self.next_vals, self.next_idxs, self.levels), w = \
                step(self.vals, self.next_vals, self.next_idxs, self.levels,
                     new_vals, jnp.int32(self.count))
            self.count += k
            GLOBAL_METRICS.record_hashes(2 * k * (1 + self.active_depth))
            if not as_numpy:
                GLOBAL_METRICS.record_submitted(k)
                return indexed.InsertWitness(**w)
            okw = np.asarray(w["ok"])
            GLOBAL_METRICS.record_inserts(int(okw.sum()),
                                          k - int(okw.sum()))
            wit = indexed.InsertWitness(ok=okw, **{
                key: v for key, v in w.items() if key != "ok"})
            if indexed._debug_witness:
                indexed.check_insert_witness(wit)
            return wit
        step = indexed._insert_batch_fn(self.active_depth, k,
                                        self.node_repr)
        (self.vals, self.next_vals, self.next_idxs, self.levels), ok = step(
            self.vals, self.next_vals, self.next_idxs, self.levels,
            new_vals, jnp.int32(self.count))
        self.count += k
        GLOBAL_METRICS.record_hashes(
            indexed._batch_hash_count(self.active_depth, k))
        if not as_numpy:
            GLOBAL_METRICS.record_submitted(k)
            return ok
        ok = np.asarray(ok)
        GLOBAL_METRICS.record_inserts(int(ok.sum()), k - int(ok.sum()))
        return ok

    def insert_seq(self, values, as_numpy: bool = True) -> InsertWitness:
        """Scan-chained strictly-sequential inserts with full-depth witness
        bundles in ONE jitted dispatch — see IndexedMerkleTree.insert_seq."""
        self._check_repr()
        new_vals, c = indexed._as_limb_batch(values)
        if self.count + c >= (1 << self.tree_depth):
            raise ValueError("tree full")
        self._grow_to(self.count + c + 1)
        xs = jnp.moveaxis(jnp.asarray(new_vals), 0, 1)[:, :, None]
        seq = indexed._insert_seq_fn(self.active_depth, c, self.tree_depth,
                                     self.node_repr)
        (self.vals, self.next_vals, self.next_idxs, self.levels), w = seq(
            self.vals, self.next_vals, self.next_idxs, self.levels,
            xs, jnp.int32(self.count))
        self.count += c
        GLOBAL_METRICS.record_hashes(c * (2 + 2 * self.tree_depth))
        return indexed.IndexedMerkleTree._package_witness(
            self, w, c, as_numpy)

    def insert_batches(self, values, as_numpy: bool = True):
        """Scan-chained batch inserts ([B, 16, K] or list of B lists) in ONE
        jitted dispatch — see IndexedMerkleTree.insert_batches."""
        self._check_repr()
        arr = indexed._as_batch_stack(values)
        b, _, k = arr.shape
        if self.count + b * k >= (1 << self.tree_depth):
            raise ValueError("tree full")
        self._grow_to(self.count + b * k + 1)
        run = indexed._insert_batches_fn(self.active_depth, k, b,
                                         self.node_repr,
                                         indexed._chain_scan_flag())
        (self.vals, self.next_vals, self.next_idxs, self.levels), oks = run(
            self.vals, self.next_vals, self.next_idxs, self.levels,
            arr, jnp.int32(self.count))
        self.count += b * k
        GLOBAL_METRICS.record_hashes(
            indexed._batches_hash_count(self.active_depth, k, b))
        if not as_numpy:
            GLOBAL_METRICS.record_submitted(b * k)
            return oks
        oks = np.asarray(oks)
        GLOBAL_METRICS.record_inserts(int(oks.sum()), b * k - int(oks.sum()))
        return oks

    # -- serialization -------------------------------------------------------

    def to_arrays(self) -> dict:
        return {
            "depth": np.int64(self.tree_depth),
            "count": np.int64(self.count),
            "vals": np.asarray(self.vals),
            "next_vals": np.asarray(self.next_vals),
            "next_idxs": np.asarray(self.next_idxs),
            "sparse": np.int64(1),
        }

    @classmethod
    def from_arrays(cls, arrays: dict) -> "SparseIndexedMerkleTree":
        n = int(arrays["vals"].shape[1])
        tree = cls(int(arrays["depth"]),
                   initial_capacity_log2=max(n.bit_length() - 1, 1))
        tree.count = int(arrays["count"])
        tree.vals = jnp.asarray(arrays["vals"])
        tree.next_vals = jnp.asarray(arrays["next_vals"])
        tree.next_idxs = jnp.asarray(arrays["next_idxs"])
        leaves = poseidon_jax.hash3_leaf(tree.vals, tree.next_vals,
                                         tree.next_idxs)
        tree.levels = indexed._build_levels_fn(
            tree.active_depth, tree.node_repr)(leaves)
        return tree

"""Poseidon Merkle tree with device-resident levels.

Capability parity with the reference's native tree (src/utils.rs:6-108):

* ``MerkleTree.build(leaves)``   — bottom-up pairwise-hash build
  (reference ``IndexedMerkleTree::new``, src/utils.rs:20-57).  The whole
  build is ONE jitted computation per tree size: a python loop over levels
  inside jit, each level a single batched hash2 (the level-parallel redesign
  of the reference's sequential per-pair loop).
* ``get_root``                   — cached root (src/utils.rs:59-61).
* ``get_proof`` / ``get_proofs`` — sibling path + helper bits, helper=1 iff
  the node is a LEFT child (src/utils.rs:63-85); batched gathers.
* ``verify_proof`` / ``verify_proofs`` — recompute root by index parity
  (src/utils.rs:87-107), vmapped over a batch of proofs.
* ``compute_root_from_helpers``  — the helper-bit fold convention of the
  in-circuit gadget (dual_mux + hash: src/indexed_merkle_tree.rs:78-96,
  helper=1 => running hash goes LEFT).

Error contract mirrors the reference: empty leaves rejected; a single leaf is
its own root; odd (>1) leaf counts rejected.  The reference also crashes on
even non-power-of-two counts (index out of bounds at src/utils.rs:45); we
reject those explicitly.

All field elements are canonical 16x16-bit limb arrays, limb axis leading:
uint32[16, N].
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp

from ..ops import field
from ..ops import hashing as poseidon_jax


@lru_cache(maxsize=None)
def _build_fn(depth: int):
    """Jitted full-tree build for a 2^depth-leaf tree.

    Returns all levels, leaves first, root (length-1 level) last."""

    @jax.jit
    def build(leaves):
        levels = [leaves]
        cur = leaves
        for _ in range(depth):
            cur = poseidon_jax.hash2(cur[:, 0::2], cur[:, 1::2])
            levels.append(cur)
        return levels

    return build


@lru_cache(maxsize=None)
def _verify_fn(depth: int):
    """Jitted batched proof verification by index parity."""

    @jax.jit
    def verify(leaf, index, root, proof):
        # leaf: [16, K]; index: int32[K]; root: [16, K]; proof: [depth, 16, K]
        def body(carry, sib):
            acc, idx = carry
            is_left = (idx & 1) == 0
            l = field.select(is_left, acc, sib)
            r = field.select(is_left, sib, acc)
            return (poseidon_jax.hash2(l, r), idx >> 1), None

        (acc, _), _ = jax.lax.scan(body, (leaf, index), proof)
        return field.eq(acc, root)

    return verify


@lru_cache(maxsize=None)
def _root_from_helpers_fn(depth: int):
    """Jitted batched root recompute with helper bits (helper=1 => acc LEFT),
    the dual_mux convention of the circuit gadget
    (src/indexed_merkle_tree.rs:78-96)."""

    @jax.jit
    def compute(leaf, proof, helpers):
        # leaf: [16, K]; proof: [depth, 16, K]; helpers: bool/int32 [depth, K]
        def body(acc, x):
            sib, h = x
            acc_left = h != 0
            l = field.select(acc_left, acc, sib)
            r = field.select(acc_left, sib, acc)
            return poseidon_jax.hash2(l, r), None

        acc, _ = jax.lax.scan(body, leaf, (proof, helpers))
        return acc

    return compute


def compute_root_from_helpers(leaf, proof, helpers):
    """Batched helper-bit root fold.  leaf [16,K], proof [d,16,K], helpers [d,K]."""
    return _root_from_helpers_fn(proof.shape[0])(leaf, proof, helpers)


class MerkleTree:
    """Device-resident Poseidon Merkle tree over canonical limb arrays."""

    def __init__(self, levels: list):
        self.levels = levels  # levels[0] = leaves ... levels[-1] = [16, 1] root

    # -- construction --------------------------------------------------------

    @classmethod
    def build(cls, leaves) -> "MerkleTree":
        """leaves: uint32[16, N] canonical limbs.  N must be 1 or a power of 2."""
        n = leaves.shape[1]
        if n == 0:
            raise ValueError("Cannot create Merkle Tree with no leaves")
        if n == 1:
            return cls([jnp.asarray(leaves)])
        if n % 2 == 1:
            raise ValueError("Leaves must be even")
        if n & (n - 1):
            raise ValueError("Leaf count must be a power of two")
        depth = n.bit_length() - 1
        return cls(_build_fn(depth)(jnp.asarray(leaves)))

    @classmethod
    def from_ints(cls, values: list) -> "MerkleTree":
        return cls.build(field.ints_to_limbs(values))

    # -- queries --------------------------------------------------------------

    @property
    def depth(self) -> int:
        return len(self.levels) - 1

    @property
    def num_leaves(self) -> int:
        return int(self.levels[0].shape[1])

    def get_root(self):
        """Root as canonical limbs [16, 1]."""
        return self.levels[-1]

    def get_root_int(self) -> int:
        return field.limbs_to_int(np.asarray(self.get_root())[:, 0])

    def get_proofs(self, indices):
        """Batched Merkle proofs.

        indices: int array [K] -> (proof [depth, 16, K], helpers int32 [depth, K]).
        helpers[d] = 1 iff the path node at level d is a left child."""
        idx = np.asarray(indices, dtype=np.int64)
        proof, helpers = [], []
        for d in range(self.depth):
            level = self.levels[d]
            sib_idx = idx ^ 1
            proof.append(jnp.take(level, jnp.asarray(sib_idx), axis=1))
            helpers.append((idx % 2 == 0).astype(np.int32))
            idx = idx >> 1
        return (jnp.stack(proof), jnp.asarray(np.stack(helpers)))

    def get_proof(self, index: int):
        """Single proof, matching the reference API (src/utils.rs:63-85)."""
        proof, helpers = self.get_proofs([index])
        return proof, helpers

    def verify_proofs(self, leaves, indices, root, proofs) -> np.ndarray:
        """Batched verify by index parity (src/utils.rs:87-107) -> bool[K]."""
        k = leaves.shape[1]
        idx = jnp.asarray(np.asarray(indices, dtype=np.int32))
        root_b = jnp.broadcast_to(jnp.asarray(root), (field.LIMBS, k))
        return np.asarray(_verify_fn(proofs.shape[0])(
            jnp.asarray(leaves), idx, root_b, jnp.asarray(proofs)))

    def verify_proof(self, leaf, index: int, root, proof) -> bool:
        return bool(self.verify_proofs(leaf, [index], root, proof)[0])

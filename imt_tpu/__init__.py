"""imt_tpu — an accelerator-resident indexed-Merkle-tree engine.

A from-scratch JAX/XLA framework with the full capability surface of
aerius-labs/indexed-merkle-tree-halo2 (Aztec-style nullifier tree over
Poseidon/BN254): residue/limb-decomposed field arithmetic on the vector and
matrix units, batched level-parallel tree ops, sort-based batched
insertion, and mesh-sharded scaling.  It runs on an NVIDIA GPU (and on the
CPU for tests).

Quick start::

    from imt_tpu import IndexedMerkleTree
    tree = IndexedMerkleTree(depth=8)
    witness = tree.insert(42)          # sequential insert + circuit witness
    tree.insert_batch([30, 10, 20])    # batched (sort-resolved) insertion
    root = tree.get_root_int()
"""

from .tree.indexed import (  # noqa: F401
    IndexedMerkleTree,
    InsertWitness,
    NonInclusionWitness,
    ZERO_LEAF_HASH,
    insert_leaf,
    verify_non_inclusion,
)
from .tree.sparse import SparseIndexedMerkleTree  # noqa: F401
from .tree.merkle import MerkleTree, compute_root_from_helpers  # noqa: F401
# multi-chip container (lazy heavy deps are fine: parallel.sharded only
# imports jax + ops, both already loaded transitively above)
from .parallel.sharded import ShardedIndexedMerkleTree  # noqa: F401
from .ops import hashing  # noqa: F401
from .ops.field import P as FIELD_MODULUS  # noqa: F401

__version__ = "0.1.0"

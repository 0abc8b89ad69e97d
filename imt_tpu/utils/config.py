"""Typed configuration for the engine.

The reference's only configuration is compile-time const generics (T/RATE on
the tree and hasher, R_F/R_P at construction — src/utils.rs:6,
src/indexed_merkle_tree.rs:362-365) plus the circuit-size builder (k,
lookup_bits — :434-437).  Here the same knobs are a dataclass; circuit-size
knobs have no device analog and are replaced by batching/mesh shape.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield


@dataclass(frozen=True)
class PoseidonConfig:
    t: int = 3
    rate: int = 2
    r_f: int = 8
    r_p: int = 57


@dataclass(frozen=True)
class EngineConfig:
    poseidon: PoseidonConfig = dfield(default_factory=PoseidonConfig)
    tree_depth: int = 32
    # "rns" (f32 residue channels + bf16 base-extension dots), "cios"
    # (uint32 16-bit-limb CIOS); "auto" = ops/hashing.py's default (rns)
    hash_engine: str = "auto"
    batch_size: int = 4096
    # sparse-prefix storage: None = auto (depth > 20), matching the
    # ShardedIndexedMerkleTree default
    sparse: bool | None = None
    initial_capacity_log2: int = 10
    # mesh: 0 devices = single-device tree; None = all visible devices
    mesh_axis: str = "shard"
    mesh_devices: int | None = 0
    # fail-fast witness re-verification (the reference's prover-side
    # assert_eq! discipline, src/indexed_merkle_tree.rs:158-167)
    debug_witness: bool = False

    def __post_init__(self):
        from ..ops.hashing import ENGINES
        if self.hash_engine != "auto" and self.hash_engine not in ENGINES:
            raise ValueError(f"unknown hash engine {self.hash_engine!r}: "
                             f"expected 'auto' or one of {ENGINES}")

    def apply(self) -> None:
        """Validate and install the global knobs this config carries.

        The Poseidon spec is pinned by reference bit-exactness
        (T=3/RATE=2/R_F=8/R_P=57, src/indexed_merkle_tree.rs:362-365):
        any other spec is rejected rather than silently mis-hashed."""
        if self.poseidon != PoseidonConfig():
            raise ValueError(
                f"unsupported Poseidon spec {self.poseidon}: the engine is "
                f"pinned to T=3/RATE=2/R_F=8/R_P=57 for reference parity")
        from ..ops import hashing
        hashing.set_backend(
            None if self.hash_engine == "auto" else self.hash_engine)
        from ..tree import indexed
        indexed.set_debug_witness(self.debug_witness)
        from .observability import log_event
        log_event("engine_config", depth=self.tree_depth,
                  engine=self.hash_engine, batch=self.batch_size,
                  mesh=self.mesh_devices)

    def build_tree(self):
        """apply() + construct the tree this config describes:
        single-device dense/sparse, or mesh-sharded when mesh_devices
        is None (all) or >= 2."""
        self.apply()
        if self.mesh_devices is None or self.mesh_devices >= 2:
            from ..parallel.sharded import (ShardedIndexedMerkleTree,
                                            make_mesh)
            mesh = make_mesh(self.mesh_devices, axis=self.mesh_axis)
            return ShardedIndexedMerkleTree(
                self.tree_depth, mesh=mesh, sparse=self.sparse,
                initial_capacity_log2=self.initial_capacity_log2)
        sparse = self.sparse if self.sparse is not None else \
            self.tree_depth > 20
        if sparse:
            from ..tree.sparse import SparseIndexedMerkleTree
            return SparseIndexedMerkleTree(self.tree_depth,
                                           self.initial_capacity_log2)
        from ..tree.indexed import IndexedMerkleTree
        return IndexedMerkleTree(self.tree_depth)

"""Multi-chip sharding for the indexed-Merkle-tree engine.

The reference is single-threaded Rust (SURVEY §2.3: no parallel or
distributed machinery exists there); this module is the data-parallel
scaling design from SURVEY §7.2 L4.  The mesh is flat: the cards of one
host reach each other all to all at one rate, so nothing gains from a
host/card hierarchy.

* Mesh axis ``shard``: tree leaves (and hash batches) are sharded over it.
* Hash batches are embarrassingly data-parallel — jit with a NamedSharding on
  the batch axis; XLA inserts no collectives.
* Tree build: each shard reduces its local subtree level-by-level
  (hash2 pairs never straddle shard boundaries while the local width is
  even), then ONE all_gather of the [16, D] shard roots and a tiny replicated
  top-tree reduction.  This keeps the latency-bound top levels to a single
  collective (SURVEY §7.4 hard-part 4).
* Batched insert: the whole jitted insert-batch step can be GSPMD-partitioned
  (sort/scatter get XLA-inserted collectives) by passing sharded inputs.
"""

from __future__ import annotations

from functools import lru_cache, partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import field
from ..ops import hashing as poseidon_jax


def make_mesh(n_devices: int | None = None, axis: str = "shard") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def shard_batch(arr, mesh: Mesh, axis: str = "shard"):
    """Place a [16, B] limb array with B sharded over the mesh."""
    return jax.device_put(arr, NamedSharding(mesh, P(None, axis)))


@lru_cache(maxsize=None)
def _sharded_build_fn(local_depth: int, n_shards: int, mesh_key):
    mesh = _MESHES[mesh_key]

    # check_vma=False: the field core's lax.scan carries start from constant
    # zeros (unvarying) and combine with per-shard data, which the varying-
    # manual-axes checker rejects; the computation is shard-local by design.
    @jax.jit
    @partial(jax.shard_map, mesh=mesh, in_specs=(P(None, "shard"),),
             out_specs=(P(None, "shard"), P(None, None)), check_vma=False)
    def build(local_leaves):
        # local_leaves: [16, N/D] on each shard
        cur = local_leaves
        for _ in range(local_depth):
            cur = poseidon_jax.hash2(cur[:, 0::2], cur[:, 1::2])
        # cur: [16, 1] local subtree root; gather all shard roots (tiny)
        roots = jax.lax.all_gather(cur, "shard", axis=1, tiled=True)  # [16, D]
        top = [roots]
        while top[-1].shape[1] > 1:
            t = top[-1]
            top.append(poseidon_jax.hash2(t[:, 0::2], t[:, 1::2]))
        return cur, jnp.concatenate(top, axis=1)

    return build


# shard_map needs the mesh at trace time; key meshes for the lru cache.
_MESHES: dict = {}


def sharded_tree_root(leaves, mesh: Mesh):
    """Root of the Poseidon Merkle tree over sharded leaves.

    leaves: [16, N] (N = power of two, divisible by mesh size).  Returns
    (shard_roots [16, D], top_nodes [16, 2D-1]) — top_nodes[:, -1] is the
    global root; bit-exact with the single-device MerkleTree build."""
    n = leaves.shape[1]
    d = mesh.devices.size
    if n % d or (n // d) & (n // d - 1):
        raise ValueError("leaves per shard must be a power of two")
    local_depth = (n // d).bit_length() - 1
    key = (tuple(d.id for d in mesh.devices.flat),)
    _MESHES[key] = mesh
    shard_roots, top = _sharded_build_fn(local_depth, d, key)(
        shard_batch(leaves, mesh))
    return shard_roots, top


def sharded_root(leaves, mesh: Mesh):
    _, top = sharded_tree_root(leaves, mesh)
    return top[:, -1:]


def sharded_hash2(a, b, mesh: Mesh):
    """Data-parallel batched 2-to-1 hash over the mesh (batch sharded)."""
    sh = NamedSharding(mesh, P(None, "shard"))
    f = jax.jit(poseidon_jax.hash2,
                in_shardings=(sh, sh), out_shardings=sh)
    return f(jax.device_put(a, sh), jax.device_put(b, sh))


def sharded_hash3(a, b, c, mesh: Mesh):
    sh = NamedSharding(mesh, P(None, "shard"))
    f = jax.jit(poseidon_jax.hash3,
                in_shardings=(sh, sh, sh), out_shardings=sh)
    return f(jax.device_put(a, sh), jax.device_put(b, sh),
             jax.device_put(c, sh))


class ShardedIndexedMerkleTree:
    """Indexed Merkle tree with mesh-sharded state — the multi-chip flagship.

    Same API as tree.indexed.IndexedMerkleTree (insert / insert_batch incl.
    witness=True / non_inclusion_witness / roots / checkpointing via
    to_arrays), but the slot dimension of the leaf state and of every tree
    level wide enough to split lives sharded over the mesh axis.  The jitted
    insert/witness steps are the SAME cached programs as single-device;
    GSPMD partitions the global sort, gathers and dirty-path scatters and
    inserts the collectives (the reference has no distributed machinery at
    all — SURVEY §2.3; this is the multi-device scaling answer).

    ``sparse=True`` (default for depth > 20) backs the tree with the
    sparse-prefix container: only the active prefix is materialized and
    sharded, so depth-32+ trees scale across the mesh (bench config 5).

    Narrow levels (width < mesh size) stay replicated: the top of the tree
    is latency-bound, so collectives there would cost more than they save.

    Placement discipline: state is placed once at construction and after
    capacity growth; after each jitted step `_place()` re-asserts the
    shardings, which is a NO-OP (same-sharding device_put returns the array
    unchanged) whenever GSPMD already propagated them — no per-op state
    copy happens on the steady path.
    """

    def __init__(self, depth: int, mesh: Mesh | None = None,
                 sparse: bool | None = None,
                 initial_capacity_log2: int = 10,
                 local_plan: bool = True):
        from ..tree.indexed import IndexedMerkleTree
        from ..tree.sparse import SparseIndexedMerkleTree
        self._mesh = mesh or make_mesh()
        if sparse is None:
            sparse = depth > 20
        self.sparse = sparse
        # local_plan=True (the DEFAULT): insert_batch / non_inclusion_witness
        # / insert_batches run the shard-local planner (parallel/local_plan.py)
        # — O(K) collectives independent of tree size, instead of the GSPMD
        # full-state all-gather the collective inventory measured as fatal at
        # config-5 scale.  Falls back to the GSPMD path only when the
        # active prefix is too small to shard, or on a 1-device mesh: at
        # D=1 the planner's replicated planning work is pure overhead and
        # the inner single-device program needs no collectives at all.
        self.local_plan = local_plan
        self._inner = (SparseIndexedMerkleTree(depth, initial_capacity_log2)
                       if sparse else IndexedMerkleTree(depth))
        self._shard = NamedSharding(self._mesh, P(None, "shard"))
        self._repl = NamedSharding(self._mesh, P())
        self._place()

    def _put(self, arr):
        d = self._mesh.devices.size
        wide = arr.shape[1] % d == 0 and arr.shape[1] >= d
        return jax.device_put(arr, self._shard if wide else self._repl)

    def _place(self):
        t = self._inner
        t.vals = self._put(t.vals)
        t.next_vals = self._put(t.next_vals)
        t.next_idxs = self._put(t.next_idxs)
        t.levels = tuple(self._put(l) for l in t.levels)

    # -- delegated API ---------------------------------------------------------

    @property
    def tree_depth(self) -> int:
        return self._inner.tree_depth

    @property
    def count(self) -> int:
        return self._inner.count

    @property
    def active_depth(self) -> int:
        return getattr(self._inner, "active_depth", self._inner.tree_depth)

    def get_root(self):
        return self._inner.get_root()

    def get_root_int(self) -> int:
        return self._inner.get_root_int()

    def get_leaf_ints(self, index: int):
        return self._inner.get_leaf_ints(index)

    def get_proof(self, index: int):
        return self._inner.get_proof(index)

    def verify_proof(self, leaf, index, root, proof) -> bool:
        return self._inner.verify_proof(leaf, index, root, proof)

    def insert(self, value: int, as_numpy: bool = True):
        """Single insert with full witness bundle.

        With local_plan (the default) this routes through the shard-local
        WITNESS batch at K=1 (parallel/local_plan.py) — O(1) collectives
        instead of the inner tree's GSPMD `_insert_step_fn`, whose planner
        masks/argmaxes over all N slots and therefore moves full-state
        collectives on a mesh (the pattern the collective inventory calls
        fatal at scale).  Witnesses are bit-identical to the
        sequential inner insert (temporal ANSV at K=1; asserted vs the
        dense reference tree in tests/_sharded_check.py).  The bare-insert
        dispatch footgun warning still applies — prefer insert_seq /
        insert_batch for sequences."""
        if self.local_plan:
            from ..tree.indexed import _count_bare_insert
            _count_bare_insert()
            # insert_batch handles growth, placement, and the
            # too-small-to-shard GSPMD-witness fallback
            return self.insert_batch([value], witness=True,
                                     as_numpy=as_numpy)
        before = self.active_depth
        w = self._inner.insert(value, as_numpy=as_numpy)
        if self.active_depth != before:
            self._place()
        return w

    def insert_batch(self, values, witness: bool = False,
                     as_numpy: bool = True):
        from ..tree.indexed import (InsertWitness, _as_limb_batch,
                                    _debug_witness, check_insert_witness)
        vals, k = _as_limb_batch(values)
        before = self.active_depth
        if self.local_plan:
            from . import local_plan
            t = self._inner
            if hasattr(t, "_grow_to"):
                t._grow_to(t.count + k + 1)
            elif t.count + k >= t.num_slots:
                # same capacity contract as IndexedMerkleTree.insert_batch —
                # without it, overflow would silently drop the out-of-range
                # new-slot scatters while still advancing count
                raise ValueError("tree full")
            d = self._mesh.devices.size
            ad = self.active_depth
            if d > 1 and (1 << ad) % d == 0 and (1 << ad) >= 2 * d:
                if self.active_depth != before:
                    self._place()
                from ..utils.observability import GLOBAL_METRICS
                if witness:
                    w = local_plan.local_insert_batch_witness(
                        t, jax.device_put(vals, self._repl), self._mesh, k)
                    # mesh-wide convention (matches hash_count): the witness
                    # walk + leaf timeline run replicated on all d shards
                    GLOBAL_METRICS.record_hashes(d * 2 * k * (1 + ad))
                    if not as_numpy:
                        GLOBAL_METRICS.record_submitted(k)
                        return InsertWitness(**w)
                    okw = np.asarray(w["ok"])
                    GLOBAL_METRICS.record_inserts(int(okw.sum()),
                                                  k - int(okw.sum()))
                    wit = InsertWitness(ok=okw, **{
                        key: v for key, v in w.items() if key != "ok"})
                    if _debug_witness:
                        check_insert_witness(wit)
                    return wit
                ok = local_plan.local_insert_batch(
                    t, jax.device_put(vals, self._repl), self._mesh, k)
                GLOBAL_METRICS.record_hashes(
                    local_plan.hash_count(ad, k, d))
                if not as_numpy:
                    GLOBAL_METRICS.record_submitted(k)
                    return ok
                ok = np.asarray(ok)
                GLOBAL_METRICS.record_inserts(int(ok.sum()),
                                              k - int(ok.sum()))
                return ok
            # active prefix too small to shard: GSPMD fallback below
        out = self._inner.insert_batch(jax.device_put(vals, self._repl),
                                       witness=witness, as_numpy=as_numpy)
        if self.active_depth != before:
            self._place()
        return out

    def insert_seq(self, values, as_numpy: bool = True):
        """Strictly-sequential inserts with full witness bundles.

        With local_plan (the default) this routes to the shard-local
        WITNESS batch: its per-insert bundles are bit-identical to
        sequential insertion by construction (temporal ANSV planning —
        tree/batch_witness.py; asserted in tests/test_chained.py and
        tests/test_local_plan.py), so sequential semantics cost one O(K)
        planned step instead of a GSPMD scan over the full state."""
        from ..tree.indexed import _as_limb_batch
        if self.local_plan:
            vals, k = _as_limb_batch(values)
            d = self._mesh.devices.size
            t = self._inner
            before = self.active_depth
            if hasattr(t, "_grow_to"):
                t._grow_to(t.count + k + 1)
            elif t.count + k >= t.num_slots:
                raise ValueError("tree full")
            if self.active_depth != before:
                self._place()          # growth re-placement (shard-wise)
            ad = self.active_depth
            if d > 1 and (1 << ad) % d == 0 and (1 << ad) >= 2 * d:
                return self.insert_batch(vals, witness=True,
                                         as_numpy=as_numpy)
        before = self.active_depth
        w = self._inner.insert_seq(values, as_numpy=as_numpy)
        if self.active_depth != before:
            self._place()
        return w

    def insert_batches(self, values, as_numpy: bool = True):
        """Scan-chained batch inserts — [B, 16, K] (or B value lists) run as
        B consecutive insert_batch steps in ONE dispatch.  With local_plan
        (the default) the whole chain is ONE shard_map program: per batch an
        O(K) candidate exchange + sharded slab/low subtree update, with the
        root gather + replicated top rebuild paid once at the end (the
        config-5 shape).  Falls back to the inner tree's chained
        program when the active prefix is too small to shard."""
        from ..tree.indexed import _as_batch_stack
        from ..utils.observability import GLOBAL_METRICS
        arr = _as_batch_stack(values)
        b, _, k = arr.shape
        before = self.active_depth
        if self.local_plan:
            from . import local_plan
            t = self._inner
            if hasattr(t, "_grow_to"):
                t._grow_to(t.count + b * k + 1)
            elif t.count + b * k >= t.num_slots:
                raise ValueError("tree full")
            d = self._mesh.devices.size
            ad = self.active_depth
            if d > 1 and (1 << ad) % d == 0 and (1 << ad) >= 2 * d:
                if self.active_depth != before:
                    self._place()
                oks = local_plan.local_insert_batches(
                    t, jax.device_put(arr, self._repl), self._mesh, k, b)
                GLOBAL_METRICS.record_hashes(
                    local_plan.hash_count(ad, k, d, b))
                if not as_numpy:
                    GLOBAL_METRICS.record_submitted(b * k)
                    return oks
                oks = np.asarray(oks)
                GLOBAL_METRICS.record_inserts(int(oks.sum()),
                                              b * k - int(oks.sum()))
                return oks
            # active prefix too small to shard: inner chained path below
        out = self._inner.insert_batches(arr, as_numpy=as_numpy)
        if self.active_depth != before:
            self._place()
        return out

    def non_inclusion_witness(self, values, as_numpy: bool = True):
        from ..tree.indexed import (NonInclusionWitness, _as_limb_batch,
                                    _debug_witness,
                                    check_non_inclusion_witness)
        queries, k = _as_limb_batch(values)
        d = self._mesh.devices.size
        if self.local_plan:
            # shard-local path: O(K) collectives instead of the GSPMD
            # full-state all-gather (parallel/local_plan.py)
            from . import local_plan
            ad = self.active_depth
            if d > 1 and (1 << ad) % d == 0 and (1 << ad) >= 2 * d:
                from ..utils.observability import GLOBAL_METRICS
                GLOBAL_METRICS.record_queries(k)
                w = local_plan.local_non_inclusion_witness(
                    self._inner, jax.device_put(queries, self._repl),
                    self._mesh, k)
                if not as_numpy:
                    return NonInclusionWitness(**w)
                wit = NonInclusionWitness(ok=np.asarray(w["ok"]), **{
                    key: v for key, v in w.items() if key != "ok"})
                if _debug_witness:
                    check_non_inclusion_witness(wit, queries)
                return wit
            # active prefix too small to shard: GSPMD fallback below
        qsh = self._shard if (k % d == 0 and k >= d) else self._repl
        # dense and sparse inner trees share the signature — forward
        # as_numpy unconditionally so the device-resident pipelining
        # contract (tree/indexed.py) holds on the sharded-sparse flagship
        return self._inner.non_inclusion_witness(
            jax.device_put(queries, qsh), as_numpy=as_numpy)

    def to_arrays(self) -> dict:
        return self._inner.to_arrays()

    @classmethod
    def from_arrays(cls, arrays: dict, mesh: Mesh | None = None,
                    local_plan: bool = True) -> "ShardedIndexedMerkleTree":
        """Resume a checkpoint onto a mesh: rebuild the inner tree from the
        leaf SoA (the reference's rebuild discipline,
        src/indexed_merkle_tree.rs:726-730), then place state shard-wise."""
        from ..tree.indexed import IndexedMerkleTree
        from ..tree.sparse import SparseIndexedMerkleTree
        sparse = bool(int(arrays.get("sparse", 0)))
        inner = (SparseIndexedMerkleTree.from_arrays(arrays) if sparse
                 else IndexedMerkleTree.from_arrays(arrays))
        self = cls.__new__(cls)
        self._mesh = mesh or make_mesh()
        self.sparse = sparse
        self.local_plan = local_plan
        self._inner = inner
        self._shard = NamedSharding(self._mesh, P(None, "shard"))
        self._repl = NamedSharding(self._mesh, P())
        self._place()
        return self

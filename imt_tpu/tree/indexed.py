"""Indexed Merkle tree (Aztec-style nullifier tree) — the device engine.

Replicates the full capability surface of the reference
(aerius-labs/indexed-merkle-tree-halo2) as data-parallel JAX computations:

* Leaf semantics ``(val, next_val, next_idx)`` — a sorted linked list over
  the leaf slots (reference src/utils.rs:12-17, src/indexed_merkle_tree.rs:13-17).
* The insertion planner (low-leaf discovery + pointer rewrite) — reference
  test helper ``update_idx_leaf`` (src/indexed_merkle_tree.rs:632-660),
  vectorized over all slots (no host scan).
* Sequential ``insert`` producing the exact witness bundle the reference
  circuit consumes (old/new roots, low/new leaves, proofs, helper bits,
  is_new_leaf_largest) with the reference's witness discipline: the new-leaf
  proof is taken against the ALREADY-UPDATED tree
  (src/indexed_merkle_tree.rs:734, SURVEY §3.4).
* Batched ``insert_batch`` — the flagship op.  Sequentially inserting a
  batch yields a final linked list equal to the sorted successor structure
  over {existing values} ∪ {accepted new values}, so the whole batch
  resolves with ONE lexicographic sort (intra-batch low-leaf chains
  included), one batched 3-to-1 rehash of dirty leaves, and a level-by-level
  dirty-path tree update.  No sequential host loop.

State layout: struct-of-arrays, canonical limbs ``uint32[16, N]`` per field
(val / next_val / next_idx), plus the Merkle levels of the leaf-hash tree.
Levels are stored in the hash engine's NATIVE node representation
(hashing.node_repr — Montgomery RNS residues ``f32[48, W]`` for the
rns engine): every per-level hash in a tree walk then skips the
canonical-limb round trip (to_limbs is a full CRT reconstruction, roughly a
permutation's worth of work), and decoding happens once at the witness/API
boundary (roots, proofs, checkpoints are canonical limbs as before).

Divergences from the reference (documented, deliberate):
* Inserting a duplicate or zero is REJECTED (ok=False, slot consumed but
  left as a zero leaf, pointers untouched).  The reference's host helper
  silently no-ops on duplicates and then fails circuit verification
  (src/indexed_merkle_tree.rs:639-660 falls through); zero is the list
  sentinel.  Sequential and batched paths implement identical semantics.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp

from ..ops import field
from ..ops import hashing as poseidon_jax
from ..utils.observability import GLOBAL_METRICS, log_event
from .merkle import compute_root_from_helpers, _verify_fn

# H(0,0,0): the empty-slot leaf hash, hard-coded by the reference chip
# (src/indexed_merkle_tree.rs:247-251).
ZERO_LEAF_HASH = 1960587138944869480785025106734196872454309951825657414575195034687326603497

# Fail-fast witness checking — the reference runs assert_eq! during witness
# generation (src/indexed_merkle_tree.rs:158-167, :190, :213-217) so a bad
# witness dies before the prover does.  With this flag on (IMT_DEBUG_WITNESS=1
# or EngineConfig(debug_witness=True)), every materialized witness bundle is
# immediately re-verified by the insert_leaf / verify_non_inclusion predicate
# and an AssertionError raised if any accepted lane fails.
import os as _os

_debug_witness = _os.environ.get("IMT_DEBUG_WITNESS") == "1"


def set_debug_witness(on: bool) -> None:
    global _debug_witness
    _debug_witness = bool(on)


def debug_witness_enabled() -> bool:
    return _debug_witness


# One-time per-process nudge away from the bare-insert() footgun: each call
# is a full host→device dispatch and host sync, while the bit-identical
# chained insert_seq pays one per chunk.  Process-global on purpose: the
# cost is per-dispatch, not per-tree.
_bare_insert_calls = 0
# 32 bare calls is already ~32x the chained per-insert cost — warn early
# enough to matter in a short script, late enough that interactive pokes
# and tests stay quiet (100 was too generous).
_BARE_INSERT_WARN_AT = 32


def _count_bare_insert() -> None:
    global _bare_insert_calls
    _bare_insert_calls += 1
    if _bare_insert_calls == _BARE_INSERT_WARN_AT + 1:
        import warnings
        warnings.warn(
            f"over {_BARE_INSERT_WARN_AT} sequential "
            "IndexedMerkleTree.insert() calls — each is one device dispatch "
            "and host sync. insert_seq(values) produces bit-identical "
            "witnesses in one dispatch per chunk; "
            "insert_batch/insert_batches are faster still for bulk loads.",
            RuntimeWarning, stacklevel=3)


def check_insert_witness(w: "InsertWitness") -> None:
    """Raise AssertionError if any accepted lane of `w` fails insert_leaf."""
    ok = np.asarray(w.ok)
    pred = np.asarray(insert_leaf(
        w.old_root, w.low_leaf_val, w.low_leaf_next_val, w.low_leaf_next_idx,
        w.low_leaf_proof, w.low_leaf_proof_helper, w.new_root,
        w.new_leaf_val, w.new_leaf_next_val, w.new_leaf_next_idx,
        jnp.asarray(np.asarray(w.new_leaf_index)), w.new_leaf_proof,
        w.new_leaf_proof_helper,
        jnp.asarray(np.asarray(w.is_new_leaf_largest))))
    bad = ok & ~pred
    if bad.any():
        raise AssertionError(
            f"witness-generation inconsistency: insert_leaf predicate "
            f"rejected accepted lanes {np.nonzero(bad)[0].tolist()}")


def check_non_inclusion_witness(w: "NonInclusionWitness", queries) -> None:
    """Raise AssertionError if any ok lane of `w` fails verify_non_inclusion."""
    ok = np.asarray(w.ok)
    pred = np.asarray(verify_non_inclusion(
        w.root, w.low_leaf_val, w.low_leaf_next_val, w.low_leaf_next_idx,
        w.low_leaf_proof, w.low_leaf_proof_helper, jnp.asarray(queries),
        jnp.asarray(np.asarray(w.is_new_leaf_largest))))
    bad = ok & ~pred
    if bad.any():
        raise AssertionError(
            f"witness-generation inconsistency: verify_non_inclusion "
            f"rejected ok lanes {np.nonzero(bad)[0].tolist()}")


@dataclass
class InsertWitness:
    """The argument bundle of the reference's insert_leaf chip
    (src/indexed_merkle_tree.rs:231-244), as device arrays (K lanes)."""

    ok: np.ndarray                      # bool[K]
    old_root: jnp.ndarray               # [16, K]
    low_leaf_val: jnp.ndarray           # [16, K]
    low_leaf_next_val: jnp.ndarray      # [16, K]
    low_leaf_next_idx: jnp.ndarray      # [16, K]
    low_leaf_proof: jnp.ndarray         # [depth, 16, K]
    low_leaf_proof_helper: jnp.ndarray  # [depth, K]
    new_root: jnp.ndarray               # [16, K]
    new_leaf_val: jnp.ndarray           # [16, K]
    new_leaf_next_val: jnp.ndarray      # [16, K]
    new_leaf_next_idx: jnp.ndarray      # [16, K]
    new_leaf_index: jnp.ndarray         # int32[K]
    new_leaf_proof: jnp.ndarray         # [depth, 16, K]
    new_leaf_proof_helper: jnp.ndarray  # [depth, K]
    is_new_leaf_largest: jnp.ndarray    # bool[K]


@dataclass
class NonInclusionWitness:
    """Witness bundle for verify_non_inclusion (K query lanes): everything
    the reference's standalone chip entry needs (src/indexed_merkle_tree.rs:127)."""

    ok: np.ndarray                      # bool[K] (low leaf found)
    root: jnp.ndarray                   # [16, K]
    low_leaf_val: jnp.ndarray           # [16, K]
    low_leaf_next_val: jnp.ndarray      # [16, K]
    low_leaf_next_idx: jnp.ndarray      # [16, K]
    low_leaf_proof: jnp.ndarray         # [depth, 16, K]
    low_leaf_proof_helper: jnp.ndarray  # [depth, K]
    is_new_leaf_largest: jnp.ndarray    # bool[K]


def _as_limb_batch(values):
    """List of python ints OR packed uint32[16, K] -> (jnp array, K)."""
    if isinstance(values, (np.ndarray, jnp.ndarray)) and values.ndim == 2:
        if values.shape[0] != field.LIMBS:
            raise ValueError(f"expected [16, K] limb array, got {values.shape}")
        return jnp.asarray(values), values.shape[1]
    return (jnp.asarray(field.ints_to_limbs([int(v) for v in values])),
            len(values))


def _as_batch_stack(values):
    """List of B equal-length int lists OR packed uint32[B, 16, K] ->
    jnp array [B, 16, K]."""
    if isinstance(values, (np.ndarray, jnp.ndarray)):
        if values.ndim != 3 or values.shape[1] != field.LIMBS:
            raise ValueError(
                f"expected [B, 16, K] limb array, got {values.shape}")
        return jnp.asarray(values)
    ks = {len(v) for v in values}
    if len(ks) != 1:
        raise ValueError("all batches must have equal length")
    return jnp.asarray(np.stack(
        [np.asarray(field.ints_to_limbs([int(x) for x in v]))
         for v in values]))


def index_to_limbs(idx):
    """int32[...] -> [16, ...] canonical limbs (indices < 2^31)."""
    lo = (idx & field.MASK).astype(jnp.uint32)
    hi = (jnp.right_shift(idx, field.LIMB_BITS)).astype(jnp.uint32)
    rest = jnp.zeros((field.LIMBS - 2,) + lo.shape, dtype=jnp.uint32)
    return jnp.concatenate([lo[None], hi[None], rest])


def _dec_path(proof):
    """Node-representation proof stack [depth, CH, K] -> canonical limbs
    [depth, 16, K] (identity under the limbs representation)."""
    if poseidon_jax.node_repr() == "limbs":
        return proof
    return jnp.moveaxis(
        poseidon_jax.dec_nodes(jnp.moveaxis(proof, 1, 0)), 0, 1)


def _gather_proof(levels, idx, depth: int):
    """Sibling path + helper bits for one traced index (helper=1 iff the
    path node is a left child — reference src/utils.rs:70-79).

    `levels` hold nodes in the hash engine's native representation
    (hashing.node_repr); the returned proof stack is in that representation
    too — decode at the witness boundary with _dec_path."""
    proof, helpers = [], []
    cur = idx
    for _ in range(depth):
        proof.append(jnp.take(levels[len(proof)], cur ^ 1, axis=1))
        helpers.append((cur % 2 == 0).astype(jnp.int32))
        cur = cur >> 1
    return jnp.stack(proof)[:, :, None], jnp.stack(helpers)[:, None]


def _batch_hash_count(depth: int, k: int) -> int:
    """Fixed-length hashes one insert_batch performs (metrics accounting),
    mirroring _update_paths_batch's static slab/low split: the contiguous
    new-slot slab halves per level (K + K/2 + ...), the K low leaves ride
    gathered dirty paths, and levels above the crossover rebuild fully."""
    total, slab, full = 2 * k, k, False       # 2k leaf hashes
    for d in range(depth):
        w = (1 << depth) >> d
        if full or k >= w // 2:
            full = True
            total += w // 2
        else:
            slab = slab // 2 + 1
            total += k + slab
    return total


def _crossover(depth: int, d_width: int) -> int:
    """First level index at which _update_paths switches to full-level
    rebuild for a dirty set of d_width entries (static, shapes only)."""
    for d in range(depth):
        if d_width >= ((1 << depth) >> d) // 2:
            return d
    return depth


def _batches_hash_count(depth: int, k: int, b: int) -> int:
    """Fixed-length hashes one chained insert_batches(b, k) call performs
    (metrics accounting for _insert_batches_fn's truncated-carry schedule
    with the slab/low split)."""
    cross = _crossover(depth, k)
    per_batch, slab = 2 * k, k
    for _ in range(cross):
        slab = slab // 2 + 1
        per_batch += k + slab
    return b * per_batch + (((1 << depth) >> cross) - 1)


def _update_paths_batch(levels, low_idx, low_hash, slab_start, slab_hash,
                        depth: int, cross: int):
    """Batched dirty-path update exploiting the slot-cursor structure: the
    K new slots are CONTIGUOUS ([count+1, count+K]), so their subtree is a
    dense slab whose width HALVES per level (K + K/2 + ... ≈ 2K hashes
    total, no gather/scatter) — only the K low leaves need gathered dirty
    paths.  vs the former uniform treatment (2K arbitrary columns carried
    through every level) this runs ~1.5x fewer hashes at the
    config-4 shape and crosses over to full-level rebuild one level lower.

    low_idx: int32[K]; low_hash: [CH, K]; slab_start: traced int32 scalar;
    slab_hash: [CH, K].  `cross` = _crossover(depth, K) (static)."""
    k = low_hash.shape[1]
    lvl0 = jax.lax.dynamic_update_slice_in_dim(
        levels[0].at[:, low_idx].set(low_hash), slab_hash,
        slab_start, axis=1)
    new_levels = [lvl0]
    cur_idx = low_idx
    s = slab_start
    w = k
    for d in range(cross):
        level = new_levels[d]
        width = level.shape[1]
        # --- slab parents: dense strided slice, halving width ------------
        # window [ps, ps + w//2 + 1) covers every parent of [s, s + w)
        # even when s is odd; ps is clamped so child/parent slices agree
        # at the right edge (recomputes there are idempotent)
        wp = w // 2 + 1
        ps = jnp.minimum(s >> 1, jnp.int32(width // 2 - wp))
        ps = jnp.maximum(ps, 0)
        kids = jax.lax.dynamic_slice_in_dim(level, 2 * ps, 2 * wp, axis=1)
        slab_par = poseidon_jax.hash2_nodes(kids[:, 0::2], kids[:, 1::2])
        nxt = jax.lax.dynamic_update_slice_in_dim(
            levels[d + 1], slab_par, ps, axis=1)
        # --- low-leaf parents: gathered dirty columns --------------------
        # (children read from the slab-updated child level, so slab/low
        # path collisions recompute identical values)
        parent_idx = cur_idx >> 1
        left = jnp.take(level, parent_idx * 2, axis=1)
        right = jnp.take(level, parent_idx * 2 + 1, axis=1)
        parent = poseidon_jax.hash2_nodes(left, right)
        new_levels.append(nxt.at[:, parent_idx].set(parent))
        cur_idx = parent_idx
        s = ps
        w = wp
    # --- full-level rebuild above the crossover --------------------------
    for d in range(cross, depth):
        level = new_levels[d]
        parent = poseidon_jax.hash2_nodes(level[:, 0::2], level[:, 1::2])
        new_levels.append(parent)
    return tuple(new_levels)


def _update_paths(levels, dirty_idx, dirty_leaves, depth: int):
    """Scatter updated leaves, then recompute ancestor nodes level-by-level.

    dirty_idx: int32[D]; dirty_leaves: [16, D].  Parents are recomputed from
    already-updated children, so duplicate or spurious dirty entries are
    idempotent-safe (they just rewrite the same value).  D stays static, so
    one compiled program serves any batch content.

    Width switch: once the dirty set covers at least half a level's width
    (D >= width/2), recomputing the WHOLE level is at most the same number
    of hashes and drops the gather/scatter traffic entirely; widths decay
    geometrically above that point, so a batch of K inserts costs
    ~2K x crossover_depth + width(crossover) hashes instead of
    2K x depth — 4-5x fewer for the config-4/5 shapes.  The
    decision is static (shapes only): one compiled program per (depth, D)."""
    d_width = dirty_idx.shape[0]
    new_levels = [levels[0].at[:, dirty_idx].set(dirty_leaves)]
    cur_idx = dirty_idx
    for d in range(depth):
        level = new_levels[d]
        if cur_idx is None or d_width >= level.shape[1] // 2:
            # full-level rebuild: every parent recomputed, no indexing
            parent = poseidon_jax.hash2_nodes(level[:, 0::2], level[:, 1::2])
            new_levels.append(parent)
            cur_idx = None
            continue
        parent_idx = cur_idx >> 1
        left = jnp.take(level, parent_idx * 2, axis=1)
        right = jnp.take(level, parent_idx * 2 + 1, axis=1)
        parent = poseidon_jax.hash2_nodes(left, right)
        new_levels.append(levels[d + 1].at[:, parent_idx].set(parent))
        cur_idx = parent_idx
    return tuple(new_levels)


# ---------------------------------------------------------------------------
# Zero-subtree spine (sparse-prefix support)
#
# A depth-`full_depth` tree whose occupied slots all sit in the leftmost
# 2^depth leaves is represented by the dense active prefix alone; every
# ancestor above the prefix root is H(node, zero_subtree[level]) and every
# proof sibling above it is the zero-subtree hash of its level (helper = 1:
# the path hugs the left spine).  This unlocks depth-32 trees (a dense
# level-0 array would be 2^32 leaves) at the reference's exact semantics.
# ---------------------------------------------------------------------------

def _zero_sib_cols(depth: int, full_depth: int) -> np.ndarray:
    """uint32[full_depth - depth, 16, 1]: zero-subtree hash per level."""
    roots = _zero_level_roots(full_depth)
    return np.stack([field.int_to_limbs(roots[d]) for d in
                     range(depth, full_depth)])[:, :, None]


def _zero_sib_nodes(depth: int, full_depth: int):
    """[full_depth - depth, CH, 1] zero-subtree hashes in the node
    representation (traced constants; XLA folds the encoding)."""
    cols = _zero_sib_cols(depth, full_depth)                 # [ext, 16, 1]
    enc = poseidon_jax.enc_nodes(jnp.asarray(cols[:, :, 0].T))  # [CH, ext]
    return enc.T[:, :, None]


def _spine_fold(root_col, depth: int, full_depth: int):
    """Active-prefix root [CH, 1] -> full-depth root [CH, 1] (traced, node
    representation in and out).

    lax.scan over the zero-sibling columns: ONE compiled hash2 body instead
    of full_depth - depth inlined permutation graphs."""
    if full_depth == depth:
        return root_col
    sibs = _zero_sib_nodes(depth, full_depth)                # [ext, CH, 1]

    def body(r, sib):
        # r may be [CH, K] (a per-insert root series); broadcast the
        # zero-subtree sibling column to match
        return poseidon_jax.hash2_nodes(
            r, jnp.broadcast_to(sib, r.shape)), None

    root_col, _ = jax.lax.scan(body, root_col, sibs)
    return root_col


def _extend_proof(proof, helpers, depth: int, full_depth: int):
    """Append the zero-spine siblings/helpers to an active-depth proof
    (node representation)."""
    ext = full_depth - depth
    k = proof.shape[-1]
    sibs = jnp.broadcast_to(_zero_sib_nodes(depth, full_depth),
                            (ext, proof.shape[1], k))
    ones = jnp.ones((ext, k), dtype=helpers.dtype)
    return (jnp.concatenate([proof, sibs]),
            jnp.concatenate([helpers, ones]))


def _repr_key() -> str:
    """Cache key for the jitted step builders: the node representation the
    program will be traced with.  Keying every lru_cache'd builder on this
    (plus the instance check in IndexedMerkleTree._check_repr) closes the
    backend-switch footgun: a tree built under one representation can never
    silently reuse a step program traced under another."""
    return poseidon_jax.node_repr()


@lru_cache(maxsize=None)
def _get_proof_fn(depth: int, nr: str = ""):
    """Jitted O(depth) proof query: gather the sibling path in node
    representation, decode ONLY those depth columns through the CRT (the
    former API path decoded every level — ~2^depth nodes per call)."""

    @jax.jit
    def f(levels, idx):
        proof, helpers = _gather_proof(levels, idx, depth)
        return _dec_path(proof), helpers

    return f


@lru_cache(maxsize=None)
def _root_fold_fn(depth: int, full_depth: int, nr: str = ""):
    @jax.jit
    def f(root_col):
        # node-repr active root -> canonical full-depth root [16, 1]
        return poseidon_jax.dec_nodes(
            _spine_fold(root_col, depth, full_depth))
    return f


@lru_cache(maxsize=None)
def _build_levels_fn(depth: int, nr: str = ""):
    """Jitted full-tree build over node-representation leaves: returns all
    levels (leaves first, [CH, 1] root last) — the repr twin of
    merkle._build_fn."""

    @jax.jit
    def build(leaves):
        levels = [leaves]
        cur = leaves
        for _ in range(depth):
            cur = poseidon_jax.hash2_nodes(cur[:, 0::2], cur[:, 1::2])
            levels.append(cur)
        return tuple(levels)

    return build


# ---------------------------------------------------------------------------
# Sequential insert step (witness path)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _insert_step_fn(depth: int, full_depth: int | None = None, nr: str = ""):
    n = 1 << depth
    fd = full_depth or depth

    @jax.jit
    def step(vals, nvs, nis, levels, new_val, count):
        # vals/nvs/nis: [16, N]; levels: tuple([16, N >> d]); new_val: [16, 1]
        # count: int32 scalar (prior inserts; this insert takes slot count+1)
        old_root = levels[-1]

        # --- planner: vectorized update_idx_leaf -----------------------------
        # Only linked-list participants (slot 0 sentinel or occupied slots)
        # are low-leaf candidates.  The reference's host loop also matches
        # EMPTY slots for duplicate values (src/indexed_merkle_tree.rs:647
        # with val=0, next_val=0), silently corrupting the list; we reject
        # duplicates instead (ok=False, no state change).
        nv_b = jnp.broadcast_to(new_val, (field.LIMBS, n))
        occupied = jnp.concatenate(
            [jnp.ones((1,), dtype=bool), ~field.is_zero(vals)[1:]])
        mask = occupied & field.less_than(vals, nv_b) & (
            field.less_than(nv_b, nvs) | field.is_zero(nvs))
        ok = jnp.any(mask)
        low_idx = jnp.argmax(mask).astype(jnp.int32)

        low_val = jnp.take(vals, low_idx, axis=1)[:, None]
        low_nv = jnp.take(nvs, low_idx, axis=1)[:, None]
        low_ni = jnp.take(nis, low_idx, axis=1)[:, None]

        low_proof, low_helpers = _gather_proof(levels, low_idx, depth)

        # --- pointer rewrite -------------------------------------------------
        s = (count + 1).astype(jnp.int32)
        s_limbs = index_to_limbs(s[None])  # [16, 1]
        new_leaf_nv = low_nv
        new_leaf_ni = low_ni

        vals2 = vals.at[:, s].set(new_val[:, 0])
        nvs2 = nvs.at[:, low_idx].set(new_val[:, 0]).at[:, s].set(new_leaf_nv[:, 0])
        nis2 = nis.at[:, low_idx].set(s_limbs[:, 0]).at[:, s].set(new_leaf_ni[:, 0])

        # --- rehash the two touched leaves, update both paths ----------------
        pair_idx = jnp.stack([low_idx, s])
        pair_hash = poseidon_jax.hash3_leaf(
            jnp.take(vals2, pair_idx, axis=1),
            jnp.take(nvs2, pair_idx, axis=1),
            jnp.take(nis2, pair_idx, axis=1))
        new_levels = _update_paths(levels, pair_idx, pair_hash, depth)

        # --- new-leaf proof against the UPDATED tree (reference :734) --------
        new_proof, new_helpers = _gather_proof(new_levels, s, depth)
        old_root_n, new_root_n = levels[-1], new_levels[-1]
        if fd != depth:
            old_root_n = _spine_fold(old_root_n, depth, fd)
            new_root_n = _spine_fold(new_root_n, depth, fd)
            low_proof, low_helpers = _extend_proof(
                low_proof, low_helpers, depth, fd)
            new_proof, new_helpers = _extend_proof(
                new_proof, new_helpers, depth, fd)
        # witness boundary: decode roots + proofs to canonical limbs
        old_root = poseidon_jax.dec_nodes(old_root_n)
        new_root = poseidon_jax.dec_nodes(new_root_n)
        low_proof = _dec_path(low_proof)
        new_proof = _dec_path(new_proof)

        vals_out = jnp.where(ok, vals2, vals)
        nvs_out = jnp.where(ok, nvs2, nvs)
        nis_out = jnp.where(ok, nis2, nis)
        levels_out = tuple(jnp.where(ok, a, b)
                           for a, b in zip(new_levels, levels))

        witness = dict(
            ok=ok[None], old_root=old_root,
            low_leaf_val=low_val, low_leaf_next_val=low_nv,
            low_leaf_next_idx=low_ni,
            low_leaf_proof=low_proof, low_leaf_proof_helper=low_helpers,
            new_root=new_root,
            new_leaf_val=new_val, new_leaf_next_val=new_leaf_nv,
            new_leaf_next_idx=new_leaf_ni,
            new_leaf_index=s[None],
            new_leaf_proof=new_proof, new_leaf_proof_helper=new_helpers,
            is_new_leaf_largest=field.is_zero(new_leaf_nv),
        )
        return (vals_out, nvs_out, nis_out, levels_out), witness

    return step


@lru_cache(maxsize=None)
def _insert_seq_fn(depth: int, chunk: int, full_depth: int | None = None,
                   nr: str = ""):
    """Scan-chained sequential inserts: `chunk` strictly-sequential insert
    steps (identical semantics and witnesses to calling insert() chunk
    times) inside ONE jitted program: one dispatch and one host sync per
    chunk instead of per insert, the throughput lever for the sequential
    witness path (bench config 3).  Witnesses come back stacked in the batch convention ([16, C] /
    [depth, 16, C]) — the same layout insert_batch(witness=True) uses."""
    step = _insert_step_fn(depth, full_depth, nr)

    @jax.jit
    def seq(vals, nvs, nis, levels, new_vals, count0):
        # new_vals: [C, 16, 1] (scan xs); count0: int32 scalar
        def body(carry, nv):
            vals, nvs, nis, levels, count = carry
            (vals, nvs, nis, levels), w = step(
                vals, nvs, nis, levels, nv, count)
            return (vals, nvs, nis, levels, count + 1), w

        (vals, nvs, nis, levels, _), ws = jax.lax.scan(
            body, (vals, nvs, nis, levels, count0), new_vals)
        # restack [C, ...] leading dim into the batch-witness convention
        witness = dict(
            ok=ws["ok"][:, 0],
            old_root=ws["old_root"][:, :, 0].T,
            low_leaf_val=ws["low_leaf_val"][:, :, 0].T,
            low_leaf_next_val=ws["low_leaf_next_val"][:, :, 0].T,
            low_leaf_next_idx=ws["low_leaf_next_idx"][:, :, 0].T,
            low_leaf_proof=jnp.moveaxis(ws["low_leaf_proof"][..., 0], 0, -1),
            low_leaf_proof_helper=ws["low_leaf_proof_helper"][:, :, 0].T,
            new_root=ws["new_root"][:, :, 0].T,
            new_leaf_val=ws["new_leaf_val"][:, :, 0].T,
            new_leaf_next_val=ws["new_leaf_next_val"][:, :, 0].T,
            new_leaf_next_idx=ws["new_leaf_next_idx"][:, :, 0].T,
            new_leaf_index=ws["new_leaf_index"][:, 0],
            new_leaf_proof=jnp.moveaxis(ws["new_leaf_proof"][..., 0], 0, -1),
            new_leaf_proof_helper=ws["new_leaf_proof_helper"][:, :, 0].T,
            is_new_leaf_largest=ws["is_new_leaf_largest"][:, 0],
        )
        return (vals, nvs, nis, levels), witness

    return seq


def _chain_scan_flag() -> bool:
    """Resolve the IMT_CHAIN_SCAN env override at CALL time so it is part of
    `_insert_batches_fn`'s cache key (reading it at trace time inside the
    lru-cached builder silently ignored toggles after the first build)."""
    return _os.environ.get("IMT_CHAIN_SCAN") == "1"


@lru_cache(maxsize=None)
def _insert_batches_fn(depth: int, k: int, b: int, nr: str = "",
                       scan: bool = False):
    """Scan-chained batch inserts: `b` consecutive insert_batch steps in ONE
    jitted program (one dispatch instead of b) — state-identical to
    b separate insert_batch calls.

    Work-saving structure: _update_paths rebuilds every level above the
    width-switch crossover FROM ITS CHILD LEVEL ALONE, so intermediate
    batches never need the top of the tree.  The scan carries only
    levels[0..cross] and the top is rebuilt ONCE after the last batch —
    for b batches that deletes (b-1)/b of the full-rebuild hashes (~40% of
    the per-batch hash schedule at the config-4/5 shapes) plus all
    narrow-width top-of-tree dispatches of the intermediate batches."""
    n = 1 << depth
    cross = _crossover(depth, k)

    @jax.jit
    def run(vals, nvs, nis, levels, new_vals, count0):
        # new_vals: [B, 16, K]
        lower = tuple(levels[:cross + 1])
        b = new_vals.shape[0]

        def body(carry, nv):
            vals, nvs, nis, lower, count = carry
            (vals2, nvs2, nis2, low_idx, low_hash, slab_start, slab_hash,
             ok) = _plan_batch(vals, nvs, nis, nv, count, n, k)
            lower = _update_paths_batch(lower, low_idx, low_hash,
                                        slab_start, slab_hash, cross, cross)
            return (vals2, nvs2, nis2, lower, count + k), ok

        carry = (vals, nvs, nis, lower, count0)
        if b <= 8 and not scan:
            # unrolled: lax.scan's loop carries constrain XLA scheduling
            # and buffer aliasing around the per-batch hash calls; small
            # chains inline the b bodies
            oks = []
            for i in range(b):
                carry, ok = body(carry, new_vals[i])
                oks.append(ok)
            oks = jnp.stack(oks)
        else:
            carry, oks = jax.lax.scan(body, carry, new_vals)
        vals, nvs, nis, lower, _ = carry
        # ONE full top rebuild for the whole chain
        out = list(lower)
        for _ in range(cross, depth):
            out.append(poseidon_jax.hash2_nodes(out[-1][:, 0::2],
                                                out[-1][:, 1::2]))
        return (vals, nvs, nis, tuple(out)), oks     # oks: [B, K]

    return run


# ---------------------------------------------------------------------------
# Batched non-inclusion witness (the prover side of verify_non_inclusion —
# the reference computes these witnesses with its native tree + host planner,
# src/indexed_merkle_tree.rs:714-722; here it is one vectorized device step)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _non_inclusion_witness_fn(depth: int, k: int, full_depth: int,
                              nr: str = ""):
    n = 1 << depth

    m = n + k

    @jax.jit
    def f(vals, nvs, nis, levels, queries):
        # queries: [16, K] canonical values.  For each query find the low
        # leaf: the linked-list participant (slot 0 sentinel or occupied
        # slot) with the largest val < q.  Resolved with ONE packed-key sort
        # over [existing slots + queries] — O((N+K) log) and no [N, K]
        # broadcast (the former mask formulation materialized 16*N*K lanes,
        # OOM above ~2^20 active slots).  Same trick as _insert_batch_fn.
        occupied = jnp.concatenate(
            [jnp.ones((1,), dtype=bool), ~field.is_zero(vals)[1:]])
        all_vals = jnp.concatenate([vals, queries], axis=1)        # [16, M]
        participant = jnp.concatenate(
            [occupied, jnp.zeros(k, dtype=bool)])
        # tie-break: an existing entry with val == q sorts BEFORE the query
        # (key 9 = is_query), so the query's predecessor is that entry and
        # low.val < q then fails -> ok=False (present value, no witness).
        is_query = jnp.concatenate(
            [jnp.zeros(n, jnp.uint32), jnp.ones(k, jnp.uint32)])
        packed = tuple(
            (all_vals[2 * j + 1] << 16) | all_vals[2 * j]
            for j in range(field.LIMBS // 2 - 1, -1, -1))
        sorted_ops = jax.lax.sort(
            packed + (is_query, jnp.arange(m, dtype=jnp.int32)),
            num_keys=9)
        order = sorted_ops[-1]
        part_s = jnp.take(participant, order)
        # last participant strictly before each sorted position
        pos = jnp.arange(m, dtype=jnp.int32)
        prv = jax.lax.cummax(jnp.where(part_s, pos, -1))
        prv = jnp.concatenate([jnp.full((1,), -1, jnp.int32), prv[:-1]])
        found_s = prv >= 0
        cand_s = jnp.take(order, jnp.clip(prv, 0, m - 1))   # original entry id
        # scatter back to query lanes (entries n..m-1 are the queries)
        inv = jnp.zeros((m,), jnp.int32).at[order].set(pos)
        qpos = inv[n:]                                       # [K]
        low_idx = jnp.take(cand_s, qpos).astype(jnp.int32)   # slot per query
        found = jnp.take(found_s, qpos)
        low_idx = jnp.where(found, low_idx, 0)

        low_val = jnp.take(vals, low_idx, axis=1)
        low_nv = jnp.take(nvs, low_idx, axis=1)
        low_ni = jnp.take(nis, low_idx, axis=1)

        # a witness exists iff low.val < q and (q < low.next_val or the low
        # leaf is the list tail) — identical to the former mask semantics
        ok = (found & field.less_than(low_val, queries)
              & (field.less_than(queries, low_nv) | field.is_zero(low_nv)))

        # sibling path per query (vectorized gather per level)
        proof, helpers = [], []
        cur = low_idx
        for d in range(depth):
            proof.append(jnp.take(levels[d], cur ^ 1, axis=1))
            helpers.append((cur % 2 == 0).astype(jnp.int32))
            cur = cur >> 1
        proof = jnp.stack(proof)                    # [depth, CH, K] node repr
        helpers = jnp.stack(helpers)                # [depth, K]
        root_n = levels[-1]
        if full_depth != depth:
            proof, helpers = _extend_proof(proof, helpers, depth, full_depth)
            root_n = _spine_fold(root_n, depth, full_depth)
        # witness boundary: decode to canonical limbs
        proof = _dec_path(proof)
        root = jnp.broadcast_to(poseidon_jax.dec_nodes(root_n),
                                (field.LIMBS, k))
        return dict(ok=ok, root=root, low_leaf_val=low_val,
                    low_leaf_next_val=low_nv, low_leaf_next_idx=low_ni,
                    low_leaf_proof=proof, low_leaf_proof_helper=helpers,
                    is_new_leaf_largest=field.is_zero(low_nv))

    return f


# ---------------------------------------------------------------------------
# Batched insert (compute path, sort-based chain resolution)
# ---------------------------------------------------------------------------

def _plan_batch(vals, nvs, nis, new_vals, count, n: int, k: int):
    """The batched-insert planner (sort-resolved sequential semantics):
    returns (vals2, nvs2, nis2, dirty, dirty_hash, ok) — the post-batch leaf
    SoA, the dirty slot set (low leaves + new slots), their leaf hashes and
    the per-insert acceptance mask.  Pure traced jnp; shared by the single-
    step and scan-chained insert programs."""
    m = n + k
    slots = count + 1 + jnp.arange(k, dtype=jnp.int32)

    # Entry table: every existing slot + every new value.
    all_vals = jnp.concatenate([vals, new_vals], axis=1)       # [16, M]
    all_slots = jnp.concatenate(
        [jnp.arange(n, dtype=jnp.int32), slots])               # [M]

    # Ascending sort by (value, slot).  ONE lax.sort call with 9 keys:
    # 8 uint32 keys packing two 16-bit limbs each (most-significant
    # first), then the slot as tie-break — vs 17 stable lexsort passes.
    # The slot tie-break encodes sequential acceptance priority:
    # existing slots numerically precede new slots, and new slots
    # follow batch order.  The iota payload comes back as the sort
    # permutation.
    packed = tuple(
        (all_vals[2 * j + 1] << 16) | all_vals[2 * j]
        for j in range(field.LIMBS // 2 - 1, -1, -1))
    sorted_ops = jax.lax.sort(
        packed + (all_slots.astype(jnp.uint32),
                  jnp.arange(m, dtype=jnp.int32)),
        num_keys=9)
    order = sorted_ops[-1]
    ss = sorted_ops[8].astype(jnp.int32)    # sorted slots (the 9th sort key)

    # Participation: position 0 is the slot-0 sentinel (value 0, slot 0 is
    # the global minimum pair).  Any later entry equal to its predecessor
    # is a duplicate: empty existing slots tie the sentinel's 0, duplicate
    # or zero new values tie their first occurrence -> all rejected.
    # Value equality reads the SORTED KEYS (keys 0..7 are exactly the 254
    # value bits) — no [16, M] gather of sorted values is ever materialized.
    eq_prev = sorted_ops[0][1:] == sorted_ops[0][:-1]
    for r in range(1, 8):
        eq_prev &= sorted_ops[r][1:] == sorted_ops[r][:-1]
    accepted = jnp.concatenate([jnp.ones(1, dtype=bool), ~eq_prev])

    # Successor/predecessor positions among accepted entries.
    pos = jnp.arange(m, dtype=jnp.int32)
    nxt = jax.lax.cummin(jnp.where(accepted, pos, m), reverse=True)
    nxt = jnp.concatenate([nxt[1:], jnp.full((1,), m, jnp.int32)])  # strict >
    prv = jax.lax.cummax(jnp.where(accepted, pos, -1))
    prv = jnp.concatenate([jnp.zeros((1,), jnp.int32), prv[:-1]])

    # Everything below is K-sized: only the K new entries and their low
    # leaves can change state.  An existing OCCUPIED slot's value never
    # changes; its pointers change iff it is the low leaf of an accepted
    # new entry (its sorted successor is that entry); empty slots stay
    # zero.  The former formulation materialized the full final list
    # ([16, M] where/gather chains — ~40% of the config-5 step); this one
    # touches O(K) columns.
    inv_order = jnp.zeros((m,), jnp.int32).at[order].set(pos)
    pos_new = inv_order[n:]                                    # [K]
    ok = jnp.take(accepted, pos_new)
    okm = ok[None]

    nxt_new = jnp.take(nxt, pos_new)
    has_succ = nxt_new < m
    nxt_c = jnp.clip(nxt_new, 0, m - 1)
    succ_entry = jnp.take(order, nxt_c)                        # entry id
    succ_val = jnp.where(has_succ & ok,
                         jnp.take(all_vals, succ_entry, axis=1), 0)
    succ_slot = jnp.where(has_succ & ok, jnp.take(ss, nxt_c), 0)
    prev_slot = jnp.take(ss, jnp.clip(jnp.take(prv, pos_new), 0, m - 1))

    # new-slot rows (zeros on rejected lanes — the consumed-slot contract)
    row_val = jnp.where(okm, new_vals, 0)
    row_ni = index_to_limbs(succ_slot)
    # low-leaf pointer rewrites: target may itself be a new slot, in which
    # case the new-row scatter that FOLLOWS overwrites it with the same
    # successor — ordering makes the chain consistent.
    low_tgt = jnp.where(ok, prev_slot, n)                      # n = dropped
    vals2 = vals.at[:, slots].set(row_val)
    nvs2 = nvs.at[:, low_tgt].set(jnp.where(okm, new_vals, 0),
                                  mode="drop").at[:, slots].set(succ_val)
    nis2 = nis.at[:, low_tgt].set(index_to_limbs(jnp.where(ok, slots, 0)),
                                  mode="drop").at[:, slots].set(row_ni)

    # --- dirty leaves: the contiguous new-slot slab + the K low leaves ---
    # (rejected lanes contribute their unchanged low leaf — an idempotent
    # rehash of an untouched column).  ONE width-2K hash3; the halves feed
    # _update_paths_batch's slab/low split.
    low_idx = prev_slot.astype(jnp.int32)
    slab_start = (count + 1).astype(jnp.int32)
    hashes = poseidon_jax.hash3_leaf(
        jnp.concatenate([jnp.take(vals2, low_idx, axis=1),
                         jax.lax.dynamic_slice_in_dim(
                             vals2, slab_start, k, axis=1)], axis=1),
        jnp.concatenate([jnp.take(nvs2, low_idx, axis=1),
                         jax.lax.dynamic_slice_in_dim(
                             nvs2, slab_start, k, axis=1)], axis=1),
        jnp.concatenate([jnp.take(nis2, low_idx, axis=1),
                         jax.lax.dynamic_slice_in_dim(
                             nis2, slab_start, k, axis=1)], axis=1))
    low_hash, slab_hash = hashes[:, :k], hashes[:, k:]
    return vals2, nvs2, nis2, low_idx, low_hash, slab_start, slab_hash, ok


@lru_cache(maxsize=None)
def _insert_batch_fn(depth: int, k: int, nr: str = ""):
    n = 1 << depth
    cross = _crossover(depth, k)

    @jax.jit
    def step(vals, nvs, nis, levels, new_vals, count):
        # new_vals: [16, K] taking slots count+1 .. count+K (batch order)
        vals2, nvs2, nis2, low_idx, low_hash, slab_start, slab_hash, ok = \
            _plan_batch(vals, nvs, nis, new_vals, count, n, k)
        new_levels = _update_paths_batch(levels, low_idx, low_hash,
                                         slab_start, slab_hash, depth, cross)
        return (vals2, nvs2, nis2, new_levels), ok

    return step


# ---------------------------------------------------------------------------
# Verifier predicates (the reference chip's constraints as batched booleans)
# ---------------------------------------------------------------------------

def verify_non_inclusion(root, low_leaf_val, low_leaf_next_val,
                         low_leaf_next_idx, low_leaf_proof,
                         low_leaf_proof_helper, new_leaf_value,
                         is_new_leaf_largest):
    """Batched non-membership check — the reference's verify_non_inclusion
    (src/indexed_merkle_tree.rs:127-229) as a device predicate.

    All value args are canonical limbs [16, K]; proofs [depth, 16, K];
    helpers [depth, K]; is_new_leaf_largest bool[K].  Returns bool[K]."""
    next_is_zero = field.is_zero(low_leaf_next_val)
    next_greater = field.less_than(new_leaf_value, low_leaf_next_val)
    bound_ok = jnp.where(is_new_leaf_largest, next_is_zero, next_greater)

    low_hash = poseidon_jax.hash3(low_leaf_val, low_leaf_next_val,
                                  low_leaf_next_idx)
    computed = compute_root_from_helpers(low_hash, low_leaf_proof,
                                         low_leaf_proof_helper)
    membership_ok = field.eq(computed, root)
    val_less = field.less_than(low_leaf_val, new_leaf_value)
    return bound_ok & membership_ok & val_less


def insert_leaf(old_root, low_leaf_val, low_leaf_next_val, low_leaf_next_idx,
                low_leaf_proof, low_leaf_proof_helper, new_root,
                new_leaf_val, new_leaf_next_val, new_leaf_next_idx,
                new_leaf_index, new_leaf_proof, new_leaf_proof_helper,
                is_new_leaf_largest):
    """Batched insertion verification — the reference's insert_leaf chip
    (src/indexed_merkle_tree.rs:231-314) as a device predicate.

    new_leaf_index: int32[K].  Returns bool[K] (all constraints hold)."""
    k = old_root.shape[1]
    ni = verify_non_inclusion(old_root, low_leaf_val, low_leaf_next_val,
                              low_leaf_next_idx, low_leaf_proof,
                              low_leaf_proof_helper, new_leaf_val,
                              is_new_leaf_largest)

    # interim root: low leaf rewritten to point at the new leaf (:265-284)
    new_low_hash = poseidon_jax.hash3(
        low_leaf_val, new_leaf_val, index_to_limbs(new_leaf_index))
    interim_root = compute_root_from_helpers(
        new_low_hash, low_leaf_proof, low_leaf_proof_helper)

    # the target slot must hold the zero leaf under the interim root (:286-294)
    zero_hash = jnp.broadcast_to(
        jnp.asarray(field.int_to_limbs(ZERO_LEAF_HASH))[:, None],
        (field.LIMBS, k))
    slot_empty = field.eq(
        compute_root_from_helpers(zero_hash, new_leaf_proof,
                                  new_leaf_proof_helper),
        interim_root)

    # pointer inheritance (:296-297)
    inherit = field.eq(new_leaf_next_val, low_leaf_next_val) & \
        field.eq(new_leaf_next_idx, low_leaf_next_idx)

    # final root (:299-313)
    new_leaf_hash = poseidon_jax.hash3(new_leaf_val, new_leaf_next_val,
                                       new_leaf_next_idx)
    root_ok = field.eq(
        compute_root_from_helpers(new_leaf_hash, new_leaf_proof,
                                  new_leaf_proof_helper),
        new_root)

    return ni & slot_empty & inherit & root_ok


# ---------------------------------------------------------------------------
# Host-facing tree container
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _zero_level_roots(depth: int) -> list[int]:
    """Node value per level of an all-empty tree: h_0 = H(0,0,0),
    h_{d+1} = H2(h_d, h_d).  Computed with the python oracle (depth hashes)."""
    from ..ops.poseidon_ref import generate_params, hash_fixed
    params = generate_params()
    h = [ZERO_LEAF_HASH]
    for _ in range(depth):
        h.append(hash_fixed([h[-1], h[-1]], params))
    return h


def _zero_levels(depth: int):
    """All-empty tree levels in the node representation: level d is the
    zero-subtree hash of height d broadcast to its width."""
    n = 1 << depth
    cols = np.stack([field.int_to_limbs(h)
                     for h in _zero_level_roots(depth)], axis=1)  # [16, d+1]
    enc = poseidon_jax.enc_nodes(jnp.asarray(cols))               # [CH, d+1]
    return tuple(
        jnp.broadcast_to(enc[:, d:d + 1], (enc.shape[0], n >> d))
        for d in range(depth + 1))


class IndexedMerkleTree:
    """Indexed Merkle tree over 2^depth slots, all-empty at construction
    (every preimage (0,0,0) — the reference's test initialization at
    src/indexed_merkle_tree.rs:692-698)."""

    def __init__(self, depth: int):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.tree_depth = depth
        n = 1 << depth
        self.num_slots = n
        self.count = 0  # inserts performed (slot cursor)
        z = jnp.zeros((field.LIMBS, n), dtype=jnp.uint32)
        self.vals, self.next_vals, self.next_idxs = z, z, z
        # levels store nodes in the hash engine's native representation
        # (hashing.node_repr); decode at the API boundary only.  The
        # representation is frozen per instance: _check_repr raises if the
        # hash backend is switched to an incompatible one mid-lifetime.
        self.node_repr = _repr_key()
        self.levels = _zero_levels(depth)

    def _check_repr(self):
        if _repr_key() != self.node_repr:
            raise RuntimeError(
                f"tree was built under node representation "
                f"{self.node_repr!r} but the active hash backend now uses "
                f"{_repr_key()!r}; call hashing.set_backend BEFORE "
                f"constructing trees (or rebuild via to_arrays/from_arrays)")

    # -- queries -------------------------------------------------------------

    def get_root(self):
        self._check_repr()
        return poseidon_jax.dec_nodes(self.levels[-1])

    def get_root_int(self) -> int:
        return field.limbs_to_int(np.asarray(self.get_root())[:, 0])

    def get_proof(self, index: int):
        """Sibling path + helper bits (reference src/utils.rs:63-85) —
        O(depth) gathers; only the depth path columns are CRT-decoded."""
        self._check_repr()
        return _get_proof_fn(self.tree_depth, self.node_repr)(
            self.levels, jnp.int32(index))

    def verify_proof(self, leaf, index, root, proof) -> bool:
        """Verify by index parity (reference src/utils.rs:87-107).
        Stateless: recomputes the root from the proof alone."""
        idx = jnp.asarray(np.asarray([index], dtype=np.int32))
        root_b = jnp.broadcast_to(jnp.asarray(root), (field.LIMBS, 1))
        return bool(np.asarray(_verify_fn(proof.shape[0])(
            jnp.asarray(leaf), idx, root_b, jnp.asarray(proof)))[0])

    def get_leaf_ints(self, index: int):
        v = field.limbs_to_int(np.asarray(self.vals)[:, index])
        nv = field.limbs_to_int(np.asarray(self.next_vals)[:, index])
        ni = field.limbs_to_int(np.asarray(self.next_idxs)[:, index])
        return (v, nv, ni)

    def non_inclusion_witness(self, values,
                              as_numpy: bool = True) -> NonInclusionWitness:
        """Batched non-membership witnesses for `values` (prover side of
        the standalone verify_non_inclusion predicate).  ok=False lanes mean
        the value is present (or 0) — no witness exists.

        `values` is a list of python ints or a pre-packed canonical limb
        array uint32[16, K].  as_numpy=False leaves every witness field on
        device (jnp arrays) so a downstream jitted consumer (e.g.
        verify_non_inclusion) can chain without a host round trip."""
        self._check_repr()
        queries, k = _as_limb_batch(values)
        GLOBAL_METRICS.record_queries(k)
        f = _non_inclusion_witness_fn(self.tree_depth, k, self.tree_depth,
                                      self.node_repr)
        w = f(self.vals, self.next_vals, self.next_idxs, self.levels,
              jnp.asarray(queries))
        if not as_numpy:
            return NonInclusionWitness(**w)
        wit = NonInclusionWitness(ok=np.asarray(w["ok"]), **{
            key: v for key, v in w.items() if key != "ok"})
        if _debug_witness:
            check_non_inclusion_witness(wit, queries)
        return wit

    # -- mutation ------------------------------------------------------------

    def insert(self, value: int, as_numpy: bool = True) -> InsertWitness:
        """Sequential insert with full witness bundle (reference parity).

        Prefer ``insert_seq`` for sequences: it is bit-identical (same
        witnesses, same roots) but chains all inserts into one dispatch.
        A one-time warning fires after 32 bare ``insert`` calls in a
        process.

        as_numpy=False keeps the whole witness (incl. `ok`) device-resident
        so chained inserts pipeline under async dispatch — no per-insert
        host sync.  Callers then materialize when they need the values."""
        self._check_repr()
        _count_bare_insert()
        if self.count + 1 >= self.num_slots:
            raise ValueError("tree full")
        step = _insert_step_fn(self.tree_depth, None, self.node_repr)
        new_val = jnp.asarray(field.int_to_limbs(value))[:, None]
        (self.vals, self.next_vals, self.next_idxs, self.levels), w = step(
            self.vals, self.next_vals, self.next_idxs, self.levels,
            new_val, jnp.int32(self.count))
        self.count += 1
        GLOBAL_METRICS.record_hashes(2 + 2 * self.tree_depth)
        if not as_numpy:
            GLOBAL_METRICS.record_submitted(1)
            return InsertWitness(**w)
        ok = np.asarray(w["ok"])
        GLOBAL_METRICS.record_inserts(int(ok.sum()), 1 - int(ok.sum()))
        wit = InsertWitness(ok=ok, **{
            k: v for k, v in w.items() if k != "ok"})
        if _debug_witness:
            check_insert_witness(wit)
        return wit

    def insert_batch(self, values, witness: bool = False,
                     as_numpy: bool = True):
        """Batched insert (sequential semantics, sort-resolved).  `values` is
        a list of python ints, or an already-packed canonical limb array
        uint32[16, K].

        witness=False: returns the per-value acceptance mask (bool[K]).
        witness=True: additionally materializes the full per-insert
        InsertWitness bundle (the reference insert_leaf chip's arguments,
        src/indexed_merkle_tree.rs:231-244), bit-identical on accepted lanes
        to sequential insertion, computed level-synchronously in ONE jitted
        call (see tree/batch_witness.py).

        as_numpy=False keeps the result device-resident (the acceptance
        mask, and with witness=True the whole bundle): chained batches then
        pipeline under async dispatch instead of paying a host round trip
        per batch."""
        self._check_repr()
        new_vals, k = _as_limb_batch(values)
        if self.count + k >= self.num_slots:
            raise ValueError("tree full")
        if witness:
            from .batch_witness import _insert_batch_witness_fn
            step = _insert_batch_witness_fn(
                self.tree_depth, k, self.tree_depth, self.node_repr)
            (self.vals, self.next_vals, self.next_idxs, self.levels), w = \
                step(self.vals, self.next_vals, self.next_idxs, self.levels,
                     new_vals, jnp.int32(self.count))
            self.count += k
            GLOBAL_METRICS.record_hashes(2 * k * (1 + self.tree_depth))
            if not as_numpy:
                GLOBAL_METRICS.record_submitted(k)
                return InsertWitness(**w)
            okw = np.asarray(w["ok"])
            GLOBAL_METRICS.record_inserts(int(okw.sum()), k - int(okw.sum()))
            wit = InsertWitness(ok=okw, **{
                key: v for key, v in w.items() if key != "ok"})
            if _debug_witness:
                check_insert_witness(wit)
            return wit
        step = _insert_batch_fn(self.tree_depth, k, self.node_repr)
        (self.vals, self.next_vals, self.next_idxs, self.levels), ok = step(
            self.vals, self.next_vals, self.next_idxs, self.levels,
            new_vals, jnp.int32(self.count))
        self.count += k
        GLOBAL_METRICS.record_hashes(_batch_hash_count(self.tree_depth, k))
        if not as_numpy:
            GLOBAL_METRICS.record_submitted(k)
            return ok
        ok = np.asarray(ok)
        GLOBAL_METRICS.record_inserts(int(ok.sum()), k - int(ok.sum()))
        return ok

    def _package_witness(self, w: dict, k: int, as_numpy: bool):
        if not as_numpy:
            GLOBAL_METRICS.record_submitted(k)
            return InsertWitness(**w)
        ok = np.asarray(w["ok"])
        GLOBAL_METRICS.record_inserts(int(ok.sum()), k - int(ok.sum()))
        wit = InsertWitness(ok=ok, **{
            key: v for key, v in w.items() if key != "ok"})
        if _debug_witness:
            check_insert_witness(wit)
        return wit

    def insert_seq(self, values, as_numpy: bool = True) -> InsertWitness:
        """Strictly sequential inserts (each sees the tree state left by the
        previous one — the reference's test loop discipline,
        src/indexed_merkle_tree.rs:710-802) with full per-insert witness
        bundles, chained inside ONE jitted dispatch via lax.scan.  Witnesses
        and roots are bit-identical to calling insert() len(values) times;
        only the host boundary moves (one dispatch per chunk instead of one
        per insert).  Returns an InsertWitness with K =
        len(values) lanes in the batch layout."""
        self._check_repr()
        new_vals, c = _as_limb_batch(values)
        if self.count + c >= self.num_slots:
            raise ValueError("tree full")
        xs = jnp.moveaxis(jnp.asarray(new_vals), 0, 1)[:, :, None]  # [C,16,1]
        seq = _insert_seq_fn(self.tree_depth, c, None, self.node_repr)
        (self.vals, self.next_vals, self.next_idxs, self.levels), w = seq(
            self.vals, self.next_vals, self.next_idxs, self.levels,
            xs, jnp.int32(self.count))
        self.count += c
        GLOBAL_METRICS.record_hashes(c * (2 + 2 * self.tree_depth))
        return self._package_witness(w, c, as_numpy)

    def insert_batches(self, values, as_numpy: bool = True):
        """Chained batch inserts: values [B, 16, K] (or a list of B
        equal-length value lists) runs B consecutive insert_batch steps in
        ONE jitted dispatch — state-identical to B separate insert_batch
        calls.  Returns the stacked acceptance mask bool[B, K]."""
        self._check_repr()
        arr = _as_batch_stack(values)
        b, _, k = arr.shape
        if self.count + b * k >= self.num_slots:
            raise ValueError("tree full")
        run = _insert_batches_fn(self.tree_depth, k, b, self.node_repr,
                                 _chain_scan_flag())
        (self.vals, self.next_vals, self.next_idxs, self.levels), oks = run(
            self.vals, self.next_vals, self.next_idxs, self.levels,
            arr, jnp.int32(self.count))
        self.count += b * k
        GLOBAL_METRICS.record_hashes(_batches_hash_count(self.tree_depth, k, b))
        if not as_numpy:
            GLOBAL_METRICS.record_submitted(b * k)
            return oks
        oks = np.asarray(oks)
        GLOBAL_METRICS.record_inserts(int(oks.sum()), b * k - int(oks.sum()))
        return oks

    # -- serialization (checkpoint/resume; the serde-derive hook of the
    #    reference, src/utils.rs:12) ----------------------------------------

    def to_arrays(self) -> dict:
        return {
            "depth": np.int64(self.tree_depth),
            "count": np.int64(self.count),
            "vals": np.asarray(self.vals),
            "next_vals": np.asarray(self.next_vals),
            "next_idxs": np.asarray(self.next_idxs),
        }

    @classmethod
    def from_arrays(cls, arrays: dict) -> "IndexedMerkleTree":
        tree = cls(int(arrays["depth"]))
        tree.count = int(arrays["count"])
        tree.vals = jnp.asarray(arrays["vals"])
        tree.next_vals = jnp.asarray(arrays["next_vals"])
        tree.next_idxs = jnp.asarray(arrays["next_idxs"])
        leaves = poseidon_jax.hash3_leaf(tree.vals, tree.next_vals,
                                         tree.next_idxs)
        tree.levels = _build_levels_fn(tree.tree_depth, tree.node_repr)(leaves)
        return tree

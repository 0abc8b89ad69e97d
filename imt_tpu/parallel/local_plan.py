"""Shard-local batched-insert planner — O(K) collectives regardless of N.

tools/collective_inventory.py measures that GSPMD partitions the global
9-key sort of `_insert_batch_fn` by ALL-GATHERING the full [16, N] value
array (plus an all-reduce of the [16, N+K] sorted product): fine at toy
sizes, fatal at config-5 scale (67 MB per step per device).  This module
is the mitigation: plan locally, exchange only O(K) candidates.

Algorithm (mesh of D shards, each owning C = N/D contiguous slots):

1. LOCAL candidate search (distributed sort work, C+K rows per shard):
   one 9-key packed sort of [local slots + queries] per shard yields, per
   query q, the shard-local candidates
     below1 = largest local participant with value <= q   (ties: equal
              values sort BEFORE the query, so below1 catches duplicates)
     above1 = smallest local participant with value  > q
2. EXCHANGE: all_gather of the candidate (val, slot, found) triples —
   2 × D × K × 68 B, independent of N.
3. REPLICATED rank-space planning (round 5 — O(K) elementwise, no table
   sort): lexicographic max/min across shards give the global
   below1/above1 per query; in new-value rank order (recovered from step
   1's local sort by a 1-key argsort) those candidate lists are monotone,
   so acceptance, low/successor resolution and the existing-entry rewrite
   rows reduce to cumulative scans + field compares (`_rank_plan` — its
   docstring carries the per-reduction proofs).  Sufficiency of the
   candidates is unchanged from the entry-table formulation: every
   pointer that can change belongs to a below1/above1 candidate (if some
   non-included participant sat between a rewritten entry and its new
   successor, it would itself be a below1/above1 of that successor —
   contradiction), and an existing entry's pointers are written ONLY when
   an accepted NEW entry lands directly after it.
4. LOCAL application: each shard scatters the rows it owns (new slots +
   flagged candidates), the 2K dirty leaf hashes are computed SHARDED
   (each shard hashes its 1/D slice, one all_gather of the [48, ·] hash
   columns), the local subtree updates dirty paths level-by-level, and ONE
   all_gather of the D subtree roots feeds a replicated top rebuild —
   the only tree-level collective (SURVEY §7.4 hard-part 4).

Bit-exactness vs the single-device `_insert_batch_fn` is enforced by
tests/test_local_plan.py and the dryrun_multichip A/B.
"""

from __future__ import annotations

from functools import lru_cache, partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import field
from ..ops import hashing
from ..tree import indexed

_MESHES: dict = {}


def _pack_keys(vals):
    """uint32[16, M] canonical limbs -> 8 packed sort keys, MSB first."""
    return tuple((vals[2 * j + 1] << 16) | vals[2 * j]
                 for j in range(field.LIMBS // 2 - 1, -1, -1))


def _rank_plan(new_vals, slots, qpos, blo_v, blo_s, blo_f,
               bhi_v, bhi_s, bhi_f, k: int):
    """Rank-space reduced planner (round 5) — replaces the replicated
    (3K+1)-row 9-key entry-table sort of the original step 3.

    Sorting the entry table is unnecessary: in new-value rank order the
    global below1/above1 candidate lists are monotone, so acceptance, the
    final predecessor/successor, and the existing-entry rewrite rows all
    resolve with O(K) cumulative scans and field compares.  The rank
    permutation itself comes free from step 1's local sort: the K queries'
    relative order there IS (value, batch-index) order — identical to the
    entry table's (value, slot) tie-break because new slots are assigned
    in batch order and participant slots (<= count) precede them — so ONE
    1-key argsort of the query positions replaces the 9-key sort.  The
    replicated planning term drops from a 3K-row multiway sort to K-row
    elementwise work.

    Correctness of the reductions (all values below are per rank r):
    * acceptance: a new value is rejected iff it ties a participant
      (below1 catches ties: equal values sort before the query, so
      blo_v == v) or ties the previous rank's value (intra-batch dup;
      value 0 ties the slot-0 sentinel, so zeros reject automatically).
    * low: max(blo, previous ACCEPTED new value) — no other entry can lie
      between them (blo is the largest participant below v, and accepted
      new values are distinct from every participant, so the compare is
      strict).
    * final successor: min(bhi, next accepted new value), has-successor
      iff either exists.
    * wr rows: an existing entry is rewritten iff it is the low of an
      accepted new entry, i.e. acc & ~lo_is_new; at most one accepted
      rank per blo target (an earlier accepted rank with the same blo
      would itself become the later rank's low), so the scatter targets
      stay unique.

    qpos: int32[K] — each query's position in the step-1 local sort
    (any shard's; the relative order of queries is shard-independent).
    Returns a dict of per-insert facts in BATCH order, plus the rank
    permutation pair (vrank, brank) and rank-order acceptance for the
    temporal (witness) planner.
    """
    iota = jnp.arange(k, dtype=jnp.int32)
    _, vrank = jax.lax.sort((qpos, iota), num_keys=1)   # rank -> batch
    brank = jnp.zeros((k,), jnp.int32).at[vrank].set(iota)  # batch -> rank
    t_r = lambda a: jnp.take(a, vrank, axis=-1)
    b_r = lambda a: jnp.take(a, brank, axis=-1)

    v_r = t_r(new_vals)
    slot_r = t_r(slots)
    blo_v_r, blo_s_r, blo_f_r = t_r(blo_v), t_r(blo_s), t_r(blo_f)
    bhi_v_r, bhi_f_r = t_r(bhi_v), t_r(bhi_f)

    dup_prev = jnp.concatenate(
        [jnp.zeros((1,), bool),
         jnp.all(v_r[:, 1:] == v_r[:, :-1], axis=0)])
    dup_part = blo_f_r & jnp.all(v_r == blo_v_r, axis=0)
    acc_r = ~dup_prev & ~dup_part

    pa = jax.lax.cummax(jnp.where(acc_r, iota, -1))     # prev accepted rank
    pa = jnp.concatenate([jnp.full((1,), -1, jnp.int32), pa[:-1]])
    pa_c = jnp.clip(pa, 0, k - 1)
    v_pa = jnp.take(v_r, pa_c, axis=1)
    lo_is_new_r = (pa >= 0) & (~blo_f_r | field.less_than(blo_v_r, v_pa))
    low_val_r = jnp.where(lo_is_new_r[None], v_pa, blo_v_r)
    low_slot_r = jnp.where(lo_is_new_r, jnp.take(slot_r, pa_c), blo_s_r)

    na = jax.lax.cummin(jnp.where(acc_r, iota, k), reverse=True)
    na = jnp.concatenate([na[1:], jnp.full((1,), k, jnp.int32)])
    has_na = na < k
    na_c = jnp.clip(na, 0, k - 1)
    v_na = jnp.take(v_r, na_c, axis=1)
    succ_is_new_r = has_na & (~bhi_f_r | field.less_than(v_na, bhi_v_r))
    fin_succ_val_r = jnp.where(
        succ_is_new_r[None], v_na, jnp.where(bhi_f_r[None], bhi_v_r, 0))
    fin_succ_slot_r = jnp.where(
        succ_is_new_r, jnp.take(slot_r, na_c),
        jnp.where(bhi_f_r, t_r(bhi_s), 0))
    has_fin_r = has_na | bhi_f_r

    return dict(
        vrank=vrank, brank=brank, acc_r=acc_r,
        ok=b_r(acc_r),
        lo_is_new=b_r(lo_is_new_r),
        low_val=b_r(low_val_r), low_slot=b_r(low_slot_r),
        fin_succ_val=b_r(fin_succ_val_r),
        fin_succ_slot=b_r(fin_succ_slot_r),
        has_fin=b_r(has_fin_r),
    )


def _lex_reduce(cand_val, cand_slot, cand_found, take_max: bool):
    """[D, 16, K]/[D, K] candidates -> global best per query (max or min
    by value; participant values are globally unique so no tie-break)."""
    d = cand_val.shape[0]
    best_v, best_s, best_f = cand_val[0], cand_slot[0], cand_found[0]
    for i in range(1, d):
        v, s, f = cand_val[i], cand_slot[i], cand_found[i]
        if take_max:
            better = f & (~best_f | field.less_than(best_v, v))
        else:
            better = f & (~best_f | field.less_than(v, best_v))
        best_v = jnp.where(better[None], v, best_v)
        best_s = jnp.where(better, s, best_s)
        best_f = best_f | f
    return best_v, best_s, best_f


@lru_cache(maxsize=None)
def _local_insert_batch_fn(depth: int, k: int, d: int, mesh_key,
                           nr: str = "", b: int = 1):
    """Shard-local planner program for `b` chained batches of K inserts
    (b=1 is the plain insert_batch step).

    Chaining (b > 1): every batch runs the full plan/exchange/apply body
    on the SHARDED lower levels only; the root gather + replicated top
    rebuild happens ONCE after the last batch — the multi-chip twin of
    indexed._insert_batches_fn's truncated-carry schedule.

    Subtree update uses the slab/low split on LOCAL coordinates (the
    single-device design of indexed._update_paths_batch ported per shard):
    the K new slots are globally contiguous, so each shard covers its
    overlap with a K-wide clamped dense window whose width halves per
    level — writes outside the true overlap recompute unchanged parents
    (idempotent).  Only the ≤K pointer-rewrite rows (one lane per insert
    straight out of the rank-space planner — each accepted new entry has
    at most one existing-entry predecessor) ride gathered dirty paths."""
    mesh = _MESHES[mesh_key]
    n = 1 << depth
    c = n // d                       # slots per shard
    l_loc = c.bit_length() - 1       # sharded levels: 0..l_loc
    m_loc = c + k

    def batch_body(vals, nvs, nis, lower, new_vals, count, sid, off, gslot):
        # ---- 1. local candidate search --------------------------------
        participant = (~field.is_zero(vals)) | (gslot == 0)
        all_vals = jnp.concatenate([vals, new_vals], axis=1)   # [16, M_loc]
        is_query = jnp.concatenate(
            [jnp.zeros(c, jnp.uint32), jnp.ones(k, jnp.uint32)])
        part_all = jnp.concatenate([participant, jnp.zeros(k, bool)])
        sorted_ops = jax.lax.sort(
            _pack_keys(all_vals) + (is_query,
                                    jnp.arange(m_loc, dtype=jnp.int32)),
            num_keys=9)
        order = sorted_ops[-1]
        part_s = jnp.take(part_all, order)
        pos = jnp.arange(m_loc, dtype=jnp.int32)
        prv = jax.lax.cummax(jnp.where(part_s, pos, -1))
        prv = jnp.concatenate([jnp.full((1,), -1, jnp.int32), prv[:-1]])
        nxt = jax.lax.cummin(jnp.where(part_s, pos, m_loc), reverse=True)
        nxt = jnp.concatenate([nxt[1:], jnp.full((1,), m_loc, jnp.int32)])
        inv = jnp.zeros((m_loc,), jnp.int32).at[order].set(pos)
        qpos = inv[c:]                                          # [K]
        lo_p = jnp.take(prv, qpos)
        hi_p = jnp.take(nxt, qpos)
        lo_found = lo_p >= 0
        hi_found = hi_p < m_loc
        lo_e = jnp.take(order, jnp.clip(lo_p, 0, m_loc - 1))    # entry idx
        hi_e = jnp.take(order, jnp.clip(hi_p, 0, m_loc - 1))
        lo_val = jnp.take(all_vals, lo_e, axis=1) * lo_found
        hi_val = jnp.take(all_vals, hi_e, axis=1) * hi_found
        lo_slot = jnp.where(lo_found, off + lo_e, 0)
        hi_slot = jnp.where(hi_found, off + hi_e, 0)

        # ---- 2. exchange O(K) candidates ------------------------------
        ag = lambda x: jax.lax.all_gather(x, "shard")
        blo_v, blo_s, blo_f = _lex_reduce(ag(lo_val), ag(lo_slot),
                                          ag(lo_found), take_max=True)
        bhi_v, bhi_s, bhi_f = _lex_reduce(ag(hi_val), ag(hi_slot),
                                          ag(hi_found), take_max=False)

        # ---- 3. replicated rank-space planning (O(K), no table sort) ----
        slots = count + 1 + jnp.arange(k, dtype=jnp.int32)
        rp = _rank_plan(new_vals, slots, qpos, blo_v, blo_s, blo_f,
                        bhi_v, bhi_s, bhi_f, k)
        ok = rp["ok"]
        okm = ok[None]
        nrow_val = jnp.where(okm, new_vals, 0)
        nrow_nv = jnp.where(okm, rp["fin_succ_val"], 0)
        nrow_ni_slot = jnp.where(ok, rp["fin_succ_slot"], 0)
        nrow_ni = indexed.index_to_limbs(nrow_ni_slot)

        # existing-entry pointer rewrites: the low of an accepted new entry
        # when that low is an existing participant — already K lanes, no
        # compaction sort needed (targets unique: see _rank_plan docstring)
        wr_k = ok & ~rp["lo_is_new"]
        wr_slot = jnp.where(wr_k, blo_s, n)                # n = drop
        wr_nv = jnp.where(wr_k[None], new_vals, 0)
        wr_ni = indexed.index_to_limbs(jnp.where(wr_k, slots, 0))
        wr_val = jnp.where(wr_k[None], blo_v, 0)

        # ---- 4a. scatter owned rows -----------------------------------
        def loc(g):
            owned = (g >= off) & (g < off + c)
            return jnp.where(owned, g - off, c)       # c = drop
        vals2 = vals.at[:, loc(slots)].set(nrow_val, mode="drop")
        nvs2 = nvs.at[:, loc(slots)].set(nrow_nv, mode="drop")
        nis2 = nis.at[:, loc(slots)].set(nrow_ni, mode="drop")
        wl = loc(wr_slot)
        nvs2 = nvs2.at[:, wl].set(wr_nv, mode="drop")
        nis2 = nis2.at[:, wl].set(wr_ni, mode="drop")

        # ---- 4b. dirty leaf hashes (2K lanes), sharded over the mesh ----
        dirty_g = jnp.concatenate([slots, wr_slot])              # [2K]
        dh_val = jnp.concatenate([nrow_val, wr_val], axis=1)
        dh_nv = jnp.concatenate([nrow_nv, wr_nv], axis=1)
        dh_ni = jnp.concatenate([nrow_ni, wr_ni], axis=1)
        n_dirty = dirty_g.shape[0]
        pad = (-n_dirty) % d
        if pad:
            dirty_g = jnp.concatenate(
                [dirty_g, jnp.full((pad,), n, jnp.int32)])
            zp = jnp.zeros((field.LIMBS, pad), jnp.uint32)
            dh_val = jnp.concatenate([dh_val, zp], axis=1)
            dh_nv = jnp.concatenate([dh_nv, zp], axis=1)
            dh_ni = jnp.concatenate([dh_ni, zp], axis=1)
        per = (n_dirty + pad) // d
        sl = sid * per
        local_hash = hashing.hash3_leaf(
            jax.lax.dynamic_slice_in_dim(dh_val, sl, per, axis=1),
            jax.lax.dynamic_slice_in_dim(dh_nv, sl, per, axis=1),
            jax.lax.dynamic_slice_in_dim(dh_ni, sl, per, axis=1))
        dirty_hash = jax.lax.all_gather(local_hash, "shard",
                                        axis=1, tiled=True)      # [CH, 2K+p]

        # ---- 4c. local tree update: slab/low split on local widths ------
        # The K new slots are globally contiguous; each shard covers its
        # overlap with a K-wide dense window clamped into [0, c-K] (writes
        # outside the overlap recompute unchanged parents — idempotent).
        # The ≤K wr rows ride gathered dirty paths (sentinel c>>l drops).
        lvl0 = lower[0].at[:, loc(dirty_g[:2 * k])].set(
            dirty_hash[:, :2 * k], mode="drop")
        new_lower = [lvl0]
        cur = loc(wr_slot)                       # local wr path, sentinel c
        s = jnp.clip(slots[0] - off, 0, max(c - k, 0))
        w = k
        full = False
        for l in range(l_loc):
            level = new_lower[l]
            width = c >> l
            if full or 2 * k >= width // 2:
                full = True
                new_lower.append(
                    hashing.hash2_nodes(level[:, 0::2], level[:, 1::2]))
                continue
            # slab parents: dense strided slice, halving window
            wp = w // 2 + 1
            ps = jnp.clip(jnp.minimum(s >> 1, width // 2 - wp), 0, None)
            kids = jax.lax.dynamic_slice_in_dim(level, 2 * ps, 2 * wp,
                                                axis=1)
            slab_par = hashing.hash2_nodes(kids[:, 0::2], kids[:, 1::2])
            nxt_lvl = jax.lax.dynamic_update_slice_in_dim(
                lower[l + 1], slab_par, ps, axis=1)
            # wr parents: gathered dirty columns (read from the already
            # slab-updated child level; collisions recompute identically)
            parent = cur >> 1                    # drop c>>l -> c>>(l+1)
            left = jnp.take(level, parent * 2, axis=1)
            right = jnp.take(level, parent * 2 + 1, axis=1)
            ph = hashing.hash2_nodes(left, right)
            new_lower.append(nxt_lvl.at[:, parent].set(ph, mode="drop"))
            cur = parent
            s = ps
            w = wp
        return (vals2, nvs2, nis2, tuple(new_lower), ok)

    def shard_fn(vals, nvs, nis, *rest):
        lower = rest[:l_loc + 1]
        new_vals, count = rest[-2], rest[-1]     # [B, 16, K], scalar
        sid = jax.lax.axis_index("shard")
        off = sid * c
        gslot = off + jnp.arange(c, dtype=jnp.int32)

        if b <= 8:
            oks = []
            for i in range(b):
                vals, nvs, nis, lower, ok = batch_body(
                    vals, nvs, nis, lower, new_vals[i], count + i * k,
                    sid, off, gslot)
                oks.append(ok)
            oks = jnp.stack(oks)
        else:
            def body(carry, nv):
                vals, nvs, nis, lower, cnt = carry
                vals, nvs, nis, lower, ok = batch_body(
                    vals, nvs, nis, lower, nv, cnt, sid, off, gslot)
                return (vals, nvs, nis, lower, cnt + k), ok
            (vals, nvs, nis, lower, _), oks = jax.lax.scan(
                body, (vals, nvs, nis, lower, count), new_vals)

        # ---- ONE root gather + replicated top rebuild for the chain -----
        roots = jax.lax.all_gather(lower[-1], "shard",
                                   axis=1, tiled=True)           # [CH, D]
        new_top = [roots]
        while new_top[-1].shape[1] > 1:
            t = new_top[-1]
            new_top.append(hashing.hash2_nodes(t[:, 0::2], t[:, 1::2]))
        return (vals, nvs, nis) + tuple(lower) \
            + tuple(new_top[1:]) + (oks,)

    sharded = P(None, "shard")
    repl = P()
    in_specs = ((sharded,) * 3 + (sharded,) * (l_loc + 1)
                + (repl,) * (depth - l_loc) + (repl, repl))
    out_specs = ((sharded,) * 3 + (sharded,) * (l_loc + 1)
                 + (repl,) * (depth - l_loc) + (repl,))

    @jax.jit
    @partial(jax.shard_map, mesh=mesh, in_specs=in_specs,
             out_specs=out_specs, check_vma=False)
    def run(*args):
        return shard_fn(*args)

    def step(vals, nvs, nis, levels, new_vals, count):
        # new_vals: [16, K] for b=1, [B, 16, K] for chains
        if b == 1 and new_vals.ndim == 2:
            new_vals = new_vals[None]
        out = run(vals, nvs, nis, *levels, new_vals, count)
        vals2, nvs2, nis2 = out[:3]
        levels2 = out[3:3 + depth + 1]
        oks = out[-1]
        if b == 1:
            oks = oks[0]
        return (vals2, nvs2, nis2, tuple(levels2)), oks

    step.run = run          # raw jitted program (collective inventory)
    return step


def hash_count(depth: int, k: int, d: int, b: int = 1) -> int:
    """Fixed-length hashes `b` chained local-planned batches perform across
    the whole mesh (metrics accounting, mirrors batch_body's static
    slab/low schedule; the top rebuild is paid once per chain)."""
    c = (1 << depth) // d
    nd = 2 * k + ((-2 * k) % d)
    per_batch = nd                     # sharded leaf hashes (mesh-wide)
    slab, full = k, False
    for l in range(c.bit_length() - 1):
        w = c >> l
        if full or 2 * k >= w // 2:
            full = True
            per_batch += (w // 2) * d
        else:
            slab = slab // 2 + 1
            # every shard runs the slab window + the K wr lanes
            per_batch += (slab + k) * d
    total = b * per_batch
    total += d - 1                     # replicated top rebuild (per chain)
    return total


def local_insert_batch(tree, new_vals, mesh: Mesh, k: int):
    """Run one shard-local-planned batch insert on `tree` (the inner dense
    or sparse-prefix tree of a ShardedIndexedMerkleTree).  Mutates the tree
    state; returns the device-resident acceptance mask bool[K]."""
    d = mesh.devices.size
    depth = getattr(tree, "active_depth", tree.tree_depth)
    if (1 << depth) % d or (1 << depth) < 2 * d:
        raise ValueError(f"2^{depth} slots not shardable over {d} devices")
    key = (tuple(dev.id for dev in mesh.devices.flat),)
    _MESHES[key] = mesh
    step = _local_insert_batch_fn(depth, k, d, key, tree.node_repr)
    (tree.vals, tree.next_vals, tree.next_idxs, tree.levels), ok = step(
        tree.vals, tree.next_vals, tree.next_idxs, tree.levels,
        jnp.asarray(new_vals), jnp.int32(tree.count))
    tree.count += k
    return ok


def local_insert_batches(tree, new_vals, mesh: Mesh, k: int, b: int):
    """Chained shard-local batch inserts: `new_vals` [B, 16, K] runs B
    consecutive planned batches in ONE jitted shard_map program (sharded
    lower levels carried through the chain, top rebuilt once).  Mutates the
    tree state; returns the device-resident acceptance masks bool[B, K]."""
    d = mesh.devices.size
    depth = getattr(tree, "active_depth", tree.tree_depth)
    if (1 << depth) % d or (1 << depth) < 2 * d:
        raise ValueError(f"2^{depth} slots not shardable over {d} devices")
    key = (tuple(dev.id for dev in mesh.devices.flat),)
    _MESHES[key] = mesh
    step = _local_insert_batch_fn(depth, k, d, key, tree.node_repr, b)
    (tree.vals, tree.next_vals, tree.next_idxs, tree.levels), oks = step(
        tree.vals, tree.next_vals, tree.next_idxs, tree.levels,
        jnp.asarray(new_vals), jnp.int32(tree.count))
    tree.count += b * k
    return oks


# ---------------------------------------------------------------------------
# Shard-local non-inclusion witness — the query-side twin of the planner.
#
# The GSPMD-partitioned `_non_inclusion_witness_fn` pays the same measured
# full-state all-gather through its 9-key sort.  Here each
# shard finds its local below1 candidate per query (largest local
# participant <= q; an equal value sorts BEFORE the query, so duplicates are
# caught and ok comes back False), one O(K) exchange reduces the global low
# leaf, and the proof is assembled with O(K·depth) gathers: the owner shard
# contributes the sharded-level siblings (combined with ONE psum — exact,
# every non-owner adds zeros), and the top of the tree is replicated.
# Witness semantics identical to tree/indexed._non_inclusion_witness_fn
# (reference verify_non_inclusion, src/indexed_merkle_tree.rs:127-229).
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _local_non_inclusion_fn(depth: int, k: int, d: int, mesh_key,
                            full_depth: int, nr: str = ""):
    mesh = _MESHES[mesh_key]
    n = 1 << depth
    c = n // d                       # slots per shard
    l_loc = c.bit_length() - 1       # sharded levels: 0..l_loc
    m_loc = c + k

    def shard_fn(vals, nvs, nis, *rest):
        lower = rest[:l_loc + 1]     # sharded levels 0..l_loc
        top = rest[l_loc + 1:-1]     # replicated levels l_loc+1..depth
        queries = rest[-1]           # replicated [16, K]
        sid = jax.lax.axis_index("shard")
        off = sid * c
        gslot = off + jnp.arange(c, dtype=jnp.int32)

        # ---- 1. local below1 candidate per query -----------------------
        participant = (~field.is_zero(vals)) | (gslot == 0)
        all_vals = jnp.concatenate([vals, queries], axis=1)    # [16, M_loc]
        is_query = jnp.concatenate(
            [jnp.zeros(c, jnp.uint32), jnp.ones(k, jnp.uint32)])
        part_all = jnp.concatenate([participant, jnp.zeros(k, bool)])
        sorted_ops = jax.lax.sort(
            _pack_keys(all_vals) + (is_query,
                                    jnp.arange(m_loc, dtype=jnp.int32)),
            num_keys=9)
        order = sorted_ops[-1]
        part_s = jnp.take(part_all, order)
        pos = jnp.arange(m_loc, dtype=jnp.int32)
        prv = jax.lax.cummax(jnp.where(part_s, pos, -1))
        prv = jnp.concatenate([jnp.full((1,), -1, jnp.int32), prv[:-1]])
        inv = jnp.zeros((m_loc,), jnp.int32).at[order].set(pos)
        qpos = inv[c:]                                          # [K]
        lo_p = jnp.take(prv, qpos)
        lo_found = lo_p >= 0
        lo_e = jnp.take(order, jnp.clip(lo_p, 0, m_loc - 1))    # local slot
        lo_c = jnp.clip(lo_e, 0, c - 1)    # participants are slots (< c)
        lo_val = jnp.take(vals, lo_c, axis=1) * lo_found
        lo_nv = jnp.take(nvs, lo_c, axis=1) * lo_found
        lo_ni = jnp.take(nis, lo_c, axis=1) * lo_found
        lo_slot = jnp.where(lo_found, off + lo_c, 0)

        # ---- 2. O(K) exchange + global reduction ------------------------
        ag = lambda x: jax.lax.all_gather(x, "shard")
        cand_v, cand_s, cand_f = ag(lo_val), ag(lo_slot), ag(lo_found)
        cand_nv, cand_ni = ag(lo_nv), ag(lo_ni)
        best_v, best_s, best_f = cand_v[0], cand_s[0], cand_f[0]
        best_nv, best_ni = cand_nv[0], cand_ni[0]
        for i in range(1, d):
            v, f = cand_v[i], cand_f[i]
            better = f & (~best_f | field.less_than(best_v, v))
            bm = better[None]
            best_v = jnp.where(bm, v, best_v)
            best_nv = jnp.where(bm, cand_nv[i], best_nv)
            best_ni = jnp.where(bm, cand_ni[i], best_ni)
            best_s = jnp.where(better, cand_s[i], best_s)
            best_f = best_f | f
        low_slot_g = jnp.where(best_f, best_s, 0)

        # witness exists iff low.val < q and (q < low.next_val or tail)
        ok = (best_f & field.less_than(best_v, queries)
              & (field.less_than(queries, best_nv)
                 | field.is_zero(best_nv)))

        # ---- 3. proof: owner-shard gathers + ONE psum -------------------
        owned = (low_slot_g >= off) & (low_slot_g < off + c)
        proof, helpers = [], []
        cur = jnp.clip(low_slot_g - off, 0, c - 1)
        for l in range(l_loc):
            width = c >> l
            sib = jnp.take(lower[l],
                           jnp.clip(cur, 0, width - 1) ^ 1, axis=1)
            contrib = jnp.where(owned[None], sib, 0)
            proof.append(jax.lax.psum(contrib, "shard"))
            helpers.append(((low_slot_g >> l) % 2 == 0).astype(jnp.int32))
            cur = cur >> 1
        # shard-root level + replicated top
        roots = jax.lax.all_gather(lower[l_loc], "shard",
                                   axis=1, tiled=True)           # [CH, D]
        rep_levels = [roots] + list(top)
        cur_g = low_slot_g >> l_loc
        for l in range(l_loc, depth):
            sib = jnp.take(rep_levels[l - l_loc], cur_g ^ 1, axis=1)
            proof.append(sib)
            helpers.append(((low_slot_g >> l) % 2 == 0).astype(jnp.int32))
            cur_g = cur_g >> 1
        proof = jnp.stack(proof)                    # [depth, CH, K]
        helpers = jnp.stack(helpers)                # [depth, K]
        root_n = rep_levels[-1]
        if full_depth != depth:
            proof, helpers = indexed._extend_proof(
                proof, helpers, depth, full_depth)
            root_n = indexed._spine_fold(root_n, depth, full_depth)

        # witness boundary: decode to canonical limbs
        proof = indexed._dec_path(proof)
        root = jnp.broadcast_to(hashing.dec_nodes(root_n),
                                (field.LIMBS, k))
        return (ok, root, best_v, best_nv, best_ni, proof, helpers,
                field.is_zero(best_nv))

    sharded = P(None, "shard")
    repl = P()
    in_specs = ((sharded,) * 3 + (sharded,) * (l_loc + 1)
                + (repl,) * (depth - l_loc) + (repl,))
    out_specs = (repl,) * 8

    @jax.jit
    @partial(jax.shard_map, mesh=mesh, in_specs=in_specs,
             out_specs=out_specs, check_vma=False)
    def run(*args):
        return shard_fn(*args)

    def query(vals, nvs, nis, levels, queries):
        out = run(vals, nvs, nis, *levels, queries)
        return dict(ok=out[0], root=out[1], low_leaf_val=out[2],
                    low_leaf_next_val=out[3], low_leaf_next_idx=out[4],
                    low_leaf_proof=out[5], low_leaf_proof_helper=out[6],
                    is_new_leaf_largest=out[7])

    query.run = run         # raw jitted program (collective inventory)
    return query


def local_non_inclusion_witness(tree, queries, mesh: Mesh, k: int):
    """Shard-local non-inclusion witnesses for `queries` on `tree` (the
    inner dense or sparse-prefix tree of a ShardedIndexedMerkleTree).
    Read-only; returns the device-resident witness dict."""
    d = mesh.devices.size
    depth = getattr(tree, "active_depth", tree.tree_depth)
    if (1 << depth) % d or (1 << depth) < 2 * d:
        raise ValueError(f"2^{depth} slots not shardable over {d} devices")
    key = (tuple(dev.id for dev in mesh.devices.flat),)
    _MESHES[key] = mesh
    f = _local_non_inclusion_fn(depth, k, d, key, tree.tree_depth,
                                tree.node_repr)
    return f(tree.vals, tree.next_vals, tree.next_idxs, tree.levels,
             jnp.asarray(queries))


# ---------------------------------------------------------------------------
# Shard-local WITNESS-producing batched insert.
#
# Same O(K) candidate exchange as the insert planner; the temporal
# planner (ANSV) runs replicated over the reduced entry table (every
# temporal low/successor of an insert is either another new entry or a
# below1/above1 candidate — same sufficiency argument as §3 of the module
# docstring).  The witness walk's per-level base lookups are pre-gathered
# with ONE owner-masked psum (the query nodes l_path^1 / n_path^1 per
# level are known BEFORE the walk), the walk itself runs replicated
# (hash width 2K per level — the same hash floor as single-chip), and the
# final-state scatters are owner-masked into the sharded levels.  No
# full-state collective anywhere: candidates O(K), bases O(K·depth_loc),
# no root gather (the walk computes the top levels replicated).
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _local_insert_batch_witness_fn(depth: int, k: int, d: int, mesh_key,
                                   full_depth: int, nr: str = ""):
    mesh = _MESHES[mesh_key]
    n = 1 << depth
    c = n // d
    l_loc = c.bit_length() - 1       # sharded levels: 0..l_loc
    m_loc = c + k

    def shard_fn(vals, nvs, nis, *rest):
        from ..tree.batch_witness import _ansv_prev, _witness_walk
        lower = rest[:l_loc + 1]
        top = rest[l_loc + 1:-2]
        new_vals, count = rest[-2], rest[-1]
        sid = jax.lax.axis_index("shard")
        off = sid * c
        gslot = off + jnp.arange(c, dtype=jnp.int32)
        big = jnp.iinfo(jnp.int32).max

        # ---- 1. local below1/above1 candidates (as the insert planner) --
        participant = (~field.is_zero(vals)) | (gslot == 0)
        all_vals = jnp.concatenate([vals, new_vals], axis=1)
        is_query = jnp.concatenate(
            [jnp.zeros(c, jnp.uint32), jnp.ones(k, jnp.uint32)])
        part_all = jnp.concatenate([participant, jnp.zeros(k, bool)])
        sorted_ops = jax.lax.sort(
            _pack_keys(all_vals) + (is_query,
                                    jnp.arange(m_loc, dtype=jnp.int32)),
            num_keys=9)
        order = sorted_ops[-1]
        part_s = jnp.take(part_all, order)
        pos = jnp.arange(m_loc, dtype=jnp.int32)
        prv = jax.lax.cummax(jnp.where(part_s, pos, -1))
        prv = jnp.concatenate([jnp.full((1,), -1, jnp.int32), prv[:-1]])
        nxt = jax.lax.cummin(jnp.where(part_s, pos, m_loc), reverse=True)
        nxt = jnp.concatenate([nxt[1:], jnp.full((1,), m_loc, jnp.int32)])
        inv = jnp.zeros((m_loc,), jnp.int32).at[order].set(pos)
        qpos = inv[c:]
        lo_p = jnp.take(prv, qpos)
        hi_p = jnp.take(nxt, qpos)
        lo_found = lo_p >= 0
        hi_found = hi_p < m_loc
        lo_e = jnp.take(order, jnp.clip(lo_p, 0, m_loc - 1))
        hi_e = jnp.take(order, jnp.clip(hi_p, 0, m_loc - 1))
        lo_val = jnp.take(all_vals, lo_e, axis=1) * lo_found
        hi_val = jnp.take(all_vals, hi_e, axis=1) * hi_found
        lo_slot = jnp.where(lo_found, off + lo_e, 0)
        hi_slot = jnp.where(hi_found, off + hi_e, 0)

        # ---- 2. O(K) exchange -------------------------------------------
        ag = lambda x: jax.lax.all_gather(x, "shard")
        blo_v, blo_s, blo_f = _lex_reduce(ag(lo_val), ag(lo_slot),
                                          ag(lo_found), take_max=True)
        bhi_v, bhi_s, bhi_f = _lex_reduce(ag(hi_val), ag(hi_slot),
                                          ag(hi_found), take_max=False)

        # ---- 3. replicated rank-space planning (O(K), no table sort) ----
        slots = count + 1 + jnp.arange(k, dtype=jnp.int32)
        rp = _rank_plan(new_vals, slots, qpos, blo_v, blo_s, blo_f,
                        bhi_v, bhi_s, bhi_f, k)
        ok = rp["ok"]
        okm = ok[None]

        # final-state (post-batch) successor/predecessor per insert
        fin_succ_val = jnp.where(okm & rp["has_fin"][None],
                                 rp["fin_succ_val"], 0)
        fin_succ_slot = jnp.where(ok & rp["has_fin"], rp["fin_succ_slot"], 0)
        low_tgt = jnp.where(ok, rp["low_slot"], n)

        def loc(g):
            owned = (g >= off) & (g < off + c)
            return jnp.where(owned, g - off, c)       # c = drop
        vals2 = vals.at[:, loc(slots)].set(jnp.where(okm, new_vals, 0),
                                           mode="drop")
        nvs2 = nvs.at[:, loc(low_tgt)].set(jnp.where(okm, new_vals, 0),
                                           mode="drop")
        nvs2 = nvs2.at[:, loc(slots)].set(fin_succ_val, mode="drop")
        nis2 = nis.at[:, loc(low_tgt)].set(
            indexed.index_to_limbs(jnp.where(ok, slots, 0)), mode="drop")
        nis2 = nis2.at[:, loc(slots)].set(
            indexed.index_to_limbs(fin_succ_slot), mode="drop")

        # ---- temporal planning (ANSV in rank space) ----------------------
        # Insert i's TEMPORAL low/successor = its neighbors among existing
        # participants (== the blo/bhi candidates — no other participant
        # can sit between a value and its below1/above1) and the accepted
        # new entries whose STEP precedes i's.  The intra-batch part is the
        # same ANSV descent as before, run directly over rank order; the
        # participant part is a field compare against blo/bhi instead of a
        # positional max/min in the (now gone) sorted entry table.
        vrank, brank, acc_r = rp["vrank"], rp["brank"], rp["acc_r"]
        t_r = lambda a: jnp.take(a, vrank, axis=-1)
        t_b = lambda a: jnp.take(a, brank, axis=-1)
        v_r = t_r(new_vals)
        slot_r = t_r(slots)
        blo_v_r, blo_s_r, blo_f_r = t_r(blo_v), t_r(blo_s), t_r(blo_f)
        bhi_v_r, bhi_s_r, bhi_f_r = t_r(bhi_v), t_r(bhi_s), t_r(bhi_f)

        sigma = jnp.where(acc_r, vrank, big)          # step of rank r
        lo_r, lo_f2 = _ansv_prev(sigma, vrank)
        hi_r_rev, hi_f_rev = _ansv_prev(sigma[::-1], vrank[::-1])
        hi_r = k - 1 - hi_r_rev[::-1]
        hi_f2 = hi_f_rev[::-1]

        lo_c = jnp.clip(lo_r, 0, k - 1)
        tl_val = jnp.take(v_r, lo_c, axis=1)          # temporal-new low
        tlo_new = lo_f2 & (~blo_f_r | field.less_than(blo_v_r, tl_val))
        low_val_r = jnp.where(tlo_new[None], tl_val, blo_v_r)
        low_slot_r = jnp.where(tlo_new, jnp.take(slot_r, lo_c), blo_s_r)
        hi_c = jnp.clip(hi_r, 0, k - 1)
        th_val = jnp.take(v_r, hi_c, axis=1)          # temporal-new succ
        thi_new = hi_f2 & (~bhi_f_r | field.less_than(th_val, bhi_v_r))
        succ_val_r = jnp.where(thi_new[None], th_val,
                               jnp.where(bhi_f_r[None], bhi_v_r, 0))
        succ_slot_r = jnp.where(thi_new, jnp.take(slot_r, hi_c),
                                jnp.where(bhi_f_r, bhi_s_r, 0))

        low_val, low_slot = t_b(low_val_r), t_b(low_slot_r)
        succ_val, succ_slot = t_b(succ_val_r), t_b(succ_slot_r)
        succ_idx = indexed.index_to_limbs(succ_slot)
        slots_limbs = indexed.index_to_limbs(slots)

        # ---- leaf-update timeline (replicated) ---------------------------
        u2_slot = jnp.where(ok, low_slot, slots)
        upd_node = jnp.concatenate([slots, u2_slot])
        upd_val = hashing.hash3_leaf(
            jnp.concatenate([jnp.where(okm, new_vals, 0),
                             jnp.where(okm, low_val, 0)], axis=1),
            jnp.concatenate([jnp.where(okm, succ_val, 0),
                             jnp.where(okm, new_vals, 0)], axis=1),
            jnp.concatenate([jnp.where(okm, succ_idx, 0),
                             jnp.where(okm, slots_limbs, 0)], axis=1))

        # ---- pre-gathered bases for the sharded levels (ONE psum) --------
        l_path, n_path = u2_slot, slots
        base_parts = []
        for lvl in range(l_loc + 1):
            qn = jnp.concatenate(
                [(l_path >> lvl) ^ 1, (n_path >> lvl) ^ 1])
            wloc = c >> lvl
            li = qn - sid * wloc
            owned_q = (li >= 0) & (li < wloc)
            base_parts.append(jnp.where(
                owned_q[None],
                jnp.take(lower[lvl], jnp.clip(li, 0, wloc - 1), axis=1), 0))
        bases = jax.lax.psum(jnp.concatenate(base_parts, axis=1), "shard")
        mm = 2 * k
        base_tab = [bases[:, i * mm:(i + 1) * mm]
                    for i in range(l_loc + 1)]

        def take_base(lvl, qnode):
            if lvl <= l_loc:
                return base_tab[lvl]
            return jnp.take(top[lvl - l_loc - 1], qnode, axis=1)

        new_lower = [None] * (l_loc + 1)
        new_top = [None] * (depth - l_loc)

        def scatter_level(lvl, idx, v):
            if lvl <= l_loc:
                wloc = c >> lvl
                li = idx - sid * wloc
                li = jnp.where((li >= 0) & (li < wloc), li, wloc)
                out = lower[lvl].at[:, li].set(v, mode="drop")
                new_lower[lvl] = out
            else:
                out = top[lvl - l_loc - 1].at[:, idx].set(v, mode="drop")
                new_top[lvl - l_loc - 1] = out
            return out

        root_col = top[-1] if depth > l_loc else lower[l_loc]
        (low_proof, new_proof, low_help, new_help, old_root, new_root,
         _) = _witness_walk(take_base, scatter_level, root_col,
                            l_path, n_path, upd_node, upd_val, k, depth, n)

        if full_depth != depth:
            old_root = indexed._spine_fold(old_root, depth, full_depth)
            new_root = indexed._spine_fold(new_root, depth, full_depth)
            low_proof, low_help = indexed._extend_proof(
                low_proof, low_help, depth, full_depth)
            new_proof, new_help = indexed._extend_proof(
                new_proof, new_help, depth, full_depth)

        witness = (ok, hashing.dec_nodes(old_root), low_val, succ_val,
                   succ_idx, indexed._dec_path(low_proof), low_help,
                   hashing.dec_nodes(new_root), new_vals, succ_val,
                   succ_idx, slots, indexed._dec_path(new_proof), new_help,
                   field.is_zero(succ_val))
        return ((vals2, nvs2, nis2) + tuple(new_lower) + tuple(new_top)
                + witness)

    sharded = P(None, "shard")
    repl = P()
    in_specs = ((sharded,) * 3 + (sharded,) * (l_loc + 1)
                + (repl,) * (depth - l_loc) + (repl, repl))
    out_specs = ((sharded,) * 3 + (sharded,) * (l_loc + 1)
                 + (repl,) * (depth - l_loc) + (repl,) * 15)

    @jax.jit
    @partial(jax.shard_map, mesh=mesh, in_specs=in_specs,
             out_specs=out_specs, check_vma=False)
    def run(*args):
        return shard_fn(*args)

    _KEYS = ("ok", "old_root", "low_leaf_val", "low_leaf_next_val",
             "low_leaf_next_idx", "low_leaf_proof", "low_leaf_proof_helper",
             "new_root", "new_leaf_val", "new_leaf_next_val",
             "new_leaf_next_idx", "new_leaf_index", "new_leaf_proof",
             "new_leaf_proof_helper", "is_new_leaf_largest")

    def step(vals, nvs, nis, levels, new_vals, count):
        out = run(vals, nvs, nis, *levels, new_vals, count)
        state = out[:3 + depth + 1]
        w = dict(zip(_KEYS, out[3 + depth + 1:]))
        return (state[0], state[1], state[2], tuple(state[3:])), w

    step.run = run          # raw jitted program (collective inventory)
    return step


def local_insert_batch_witness(tree, new_vals, mesh: Mesh, k: int):
    """Shard-local witness-producing batch insert on `tree` (the inner
    dense or sparse-prefix tree of a ShardedIndexedMerkleTree).  Mutates
    the tree state; returns the device-resident witness dict (same keys as
    tree/batch_witness, bit-identical on accepted lanes)."""
    d = mesh.devices.size
    depth = getattr(tree, "active_depth", tree.tree_depth)
    if (1 << depth) % d or (1 << depth) < 2 * d:
        raise ValueError(f"2^{depth} slots not shardable over {d} devices")
    key = (tuple(dev.id for dev in mesh.devices.flat),)
    _MESHES[key] = mesh
    step = _local_insert_batch_witness_fn(depth, k, d, key,
                                          tree.tree_depth, tree.node_repr)
    (tree.vals, tree.next_vals, tree.next_idxs, tree.levels), w = step(
        tree.vals, tree.next_vals, tree.next_idxs, tree.levels,
        jnp.asarray(new_vals), jnp.int32(tree.count))
    tree.count += k
    return w

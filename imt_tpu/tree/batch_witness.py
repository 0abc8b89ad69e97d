"""Witness-producing batched insertion — the flagship op, completed.

The reference's ``insert_leaf`` chip consumes a full witness bundle per
insertion (old/new roots, low/new leaves, both sibling paths, helper bits —
src/indexed_merkle_tree.rs:231-244), and its tests generate
those witnesses by strictly sequential host insertion (:710-802).  The plain
batched path (indexed._insert_batch_fn) resolves a whole batch with one sort
but only returns acceptance — it never materializes the per-insert
intermediate states the witnesses need.

This module produces the witnesses for ALL K inserts of a batch in ONE
jitted program, bit-identical (on accepted lanes) to sequential insertion,
with the hashing fully batched:

* Temporal planning.  Insert i's low leaf is the largest value below v_i in
  the list state AFTER inserts 0..i-1 — not in the final list (a later
  insert may land between them).  In value-sorted order this is "the nearest
  position to the left whose insertion step precedes mine": existing
  participants (step -1) resolve with one cumulative max, and intra-batch
  chains resolve with an all-nearest-smaller-values (ANSV) sparse-table
  descent over the K new entries — O(K log K), no sequential scan.  The
  temporal successor (-> new_leaf.next_*, is_new_leaf_largest) is the mirror
  query.

* Level-synchronous timelines.  Each insert updates exactly 2 leaves (its
  slot + its low leaf), so every tree level sees exactly 2K timestamped node
  updates.  Per level, ALL lookups ("value of node n at step t" = latest
  update <= t, else the pre-batch level) — the per-insert proof siblings
  (low path at step i-1, new path at step i: the reference's
  already-updated-tree discipline, src/indexed_merkle_tree.rs:734) and both
  parent-hash children — resolve in ONE stable sort-merge over updates +
  queries (one stable sort-merge per level, O((M+Q) log) total, no
  serialized binary-search gather rounds), and the 2K parent hashes run as
  ONE batched hash2 (width
  2K — the hash engine's happy regime).  The root level's merge yields
  every intermediate root: old_root_i = root at step i-1, new_root_i =
  root at step i.

Total hash work equals sequential insertion (2 leaf hashes + 2 paths per
insert) but every hash runs at batch width 2K instead of width 2.

Rejected lanes (duplicates / zero) return ok=False with well-defined but
unspecified witness fields (sequential's rejected-lane fields are slot-0
garbage; parity is defined over accepted lanes + the ok mask).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp

from ..ops import field
from ..ops import hashing
from . import indexed


def _ansv_prev(sigma, thresholds):
    """All-nearest-smaller-values, batched: for each query r (0..K-1) find
    the largest position r' < r with sigma[r'] < thresholds[r]; returns
    (pos, found).  Sparse-table binary descent: O(K log K) build, O(log K)
    per query, fully vectorized."""
    k = sigma.shape[0]
    logk = max((k - 1).bit_length(), 1)
    # m[j][r] = min sigma over [r - 2^j + 1, r]
    tables = [sigma]
    for j in range(1, logk + 1):
        prev = tables[-1]
        w = 1 << (j - 1)
        shifted = jnp.concatenate(
            [jnp.full((w,), jnp.iinfo(jnp.int32).max, sigma.dtype), prev[:-w]])
        tables.append(jnp.minimum(prev, shifted))
    pos = jnp.arange(k, dtype=jnp.int32)      # exclusive upper bound
    for j in range(logk, -1, -1):
        w = 1 << j
        blockmin = jnp.take(tables[j], jnp.clip(pos - 1, 0, k - 1))
        skip = (pos >= w) & (blockmin >= thresholds)
        pos = jnp.where(skip, pos - w, pos)
    found = pos > 0
    return jnp.clip(pos - 1, 0, k - 1), found


def _witness_walk(take_base, scatter_level, root_col, l_path, n_path,
                  upd_node, upd_val, k: int, depth: int, n: int):
    """The level-synchronous witness walk, parameterized over level access
    so the sharded (local-plan) build can inject pre-gathered bases and
    owner-masked scatters (parallel/local_plan.py).

    The N-path updates ride the CONTIGUOUS new-slot slab (n_path starts as
    ``slots = count+1 .. count+K`` — both callers guarantee this), so at
    level l the slab step range updating node q is a closed-form interval:
    j in [(q<<l) - s, ((q+1)<<l) - 1 - s] clipped to [0, K-1].  All N-side
    lookups — latest slab update <= a step, last slab update per node —
    therefore resolve with pure vector arithmetic, and the per-level
    sort-merge carries only the K low-path (L) updates + 2K queries
    (3K rows, down from 4K; the sort was ~30% of the 3w step).  A query's
    answer is the later of its L-merge hit and its arithmetic slab hit;
    ties are value-equal by construction (above the low/new LCA the two
    rows track the same node with identical values — the same-step select
    feeds each path the other's update — and rejected lanes write identity
    values on both rows).

    Same-step sibling values — the parent-hash children and the new path's
    already-updated-tree sibling (reference src/indexed_merkle_tree.rs:734)
    — never hit the merge: insert i updates exactly the nodes N_i and L_i
    at this level, so  sib(X)@i = (other path's node == sib(X)) ? other
    value : sib@i-1  — a pure vectorized select.

    take_base(lvl, qnode[2K]) -> [CH, 2K] pre-walk level values;
    scatter_level(lvl, scatter_idx[2K], vals[CH, 2K]) -> new level array
    (indices >= level width must be dropped; target indices are unique).
    root_col: [CH, 1] pre-batch root.  Returns (low_proof, new_proof,
    low_help, new_help, old_root, new_root, new_levels) — proofs stacked
    [depth, CH, K]."""
    steps_i = jnp.arange(k, dtype=jnp.int32)
    mm = 2 * k
    tot = k + mm                                  # L updates + 2K queries
    low_proof, low_help, new_proof, new_help = [], [], [], []
    new_levels = []
    ids_t = jnp.arange(tot, dtype=jnp.int32)
    kb = (2 * (k + 1) + 1).bit_length()           # bits needed by key2
    s0 = n_path[0]                                # slab start (traced)
    for lvl in range(depth):
        width = n >> lvl
        vN, vL = upd_val[:, :k], upd_val[:, k:]
        l_node = upd_node[k:]                     # L-row nodes this level
        qnode = jnp.concatenate([l_path ^ 1, n_path ^ 1])
        qstep = jnp.concatenate([steps_i - 1, steps_i - 1])

        # --- N-path (slab) hits: closed-form interval arithmetic ---------
        lo_q = (qnode << lvl) - s0                # first slab step at node
        hi_q = jnp.minimum(lo_q + (1 << lvl) - 1, k - 1)
        jstar = jnp.minimum(hi_q, qstep)          # latest slab step <= qstep
        n_hit = (jstar >= jnp.maximum(lo_q, 0)) & (lo_q <= k - 1)
        n_val = jnp.take(vN, jnp.clip(jstar, 0, k - 1), axis=1)

        # --- L-row merge: K updates + 2K queries (kind 0 before 1) -------
        node_all = jnp.concatenate([l_node, qnode])
        kind = jnp.concatenate(
            [jnp.zeros(k, jnp.int32), jnp.ones(mm, jnp.int32)])
        key2 = 2 * (jnp.concatenate([steps_i, qstep]) + 1) + kind
        if width.bit_length() + kb <= 31:
            # pack (node, key2) into ONE sort key — halves comparator work
            keys = (node_all * jnp.int32(1 << kb) + key2, ids_t)
            nk = 1
        else:
            keys = (node_all, key2, ids_t)
            nk = 2
        srt = jax.lax.sort(keys, num_keys=nk)
        ns, pid = ((srt[0] >> kb).astype(jnp.int32), srt[-1]) \
            if nk == 1 else (srt[0], srt[-1])
        ks = jnp.take(kind, pid)
        pos = jnp.arange(tot, dtype=jnp.int32)
        last_upd = jax.lax.cummax(jnp.where(ks == 0, pos, -1))
        p_c = jnp.clip(last_upd, 0, tot - 1)
        hit = (last_upd >= 0) & (jnp.take(ns, p_c) == ns)
        ans = jnp.take(pid, p_c)                  # L-row index == its step
        qid = jnp.where(ks == 1, pid - k, tot)
        res_idx = jnp.zeros((mm,), jnp.int32).at[qid].set(ans, mode="drop")
        res_hit = jnp.zeros((mm,), dtype=bool).at[qid].set(hit, mode="drop")

        # --- combine: later update wins (ties value-equal) ---------------
        base = take_base(lvl, qnode)
        l_val = jnp.take(vL, res_idx, axis=1)
        use_l = res_hit & (~n_hit | (res_idx >= jstar))
        res = jnp.where(use_l[None], l_val,
                        jnp.where(n_hit[None], n_val, base))
        lsib_prev, nsib_prev = res[:, :k], res[:, k:]

        # --- final state of this level -----------------------------------
        # last L per node, from the same sorted order
        nxt_upd = jax.lax.cummin(jnp.where(ks == 0, pos, tot), reverse=True)
        nxt_upd = jnp.concatenate(
            [nxt_upd[1:], jnp.full((1,), tot, jnp.int32)])
        nxt_c = jnp.clip(nxt_upd, 0, tot - 1)
        is_lastl_s = (ks == 0) & ((nxt_upd == tot)
                                  | (jnp.take(ns, nxt_c) != ns))
        is_lastl = jnp.zeros((k,), dtype=bool).at[
            jnp.where(ks == 0, pid, k)].set(is_lastl_s, mode="drop")
        # slab's last step at the L node (arithmetic); the L row wins its
        # node iff it is the node's last L update AND the slab never
        # touches the node later (ties are value-equal: pick L)
        l_lo = (l_node << lvl) - s0
        l_hi = jnp.minimum(l_lo + (1 << lvl) - 1, k - 1)
        l_in_slab = (jnp.maximum(l_lo, 0) <= l_hi) & (l_lo <= k - 1)
        l_wins = is_lastl & (~l_in_slab | (steps_i >= l_hi))
        # N winner: the node's last slab step, unless an L winner with a
        # strictly later step claims the node (claim scatter keeps the
        # target indices of the single scatter call unique)
        j_hi = jnp.minimum(((n_path + 1) << lvl) - 1 - s0, k - 1)
        is_lastn = steps_i == j_hi
        claimed = jnp.full((width,), -1, jnp.int32).at[
            jnp.where(l_wins, l_node, width)].set(steps_i, mode="drop")
        last_l_here = jnp.take(claimed, jnp.clip(n_path, 0, width - 1))
        n_wins = is_lastn & (last_l_here < steps_i)
        scatter_idx = jnp.concatenate(
            [jnp.where(n_wins, n_path, width),
             jnp.where(l_wins, l_node, width)])
        new_levels.append(scatter_level(lvl, scatter_idx, upd_val))

        # same-step sibling derivations (vN/vL = this level's update
        # values for the new/low path of each insert)
        lsib_t = jnp.where((n_path == (l_path ^ 1))[None], vN, lsib_prev)
        nsib_t = jnp.where((l_path == (n_path ^ 1))[None], vL, nsib_prev)

        low_proof.append(lsib_prev)            # low path vs OLD tree
        new_proof.append(nsib_t)               # new path vs UPDATED tree
        low_help.append((l_path % 2 == 0).astype(jnp.int32))
        new_help.append((n_path % 2 == 0).astype(jnp.int32))

        # parent hashes: children ordered by the path node's parity
        n_even = (n_path % 2 == 0)[None]
        l_even = (l_path % 2 == 0)[None]
        left = jnp.concatenate([jnp.where(n_even, vN, nsib_t),
                                jnp.where(l_even, vL, lsib_t)], axis=1)
        right = jnp.concatenate([jnp.where(n_even, nsib_t, vN),
                                 jnp.where(l_even, lsib_t, vL)], axis=1)
        upd_val = hashing.hash2_nodes(left, right)
        n_path = n_path >> 1
        l_path = l_path >> 1
        upd_node = upd_node >> 1

    # root series: the L-row (last-wins) update value per step; the
    # per-step old root is the previous step's new root
    new_root = upd_val[:, k:]
    old_root = jnp.concatenate([root_col, new_root[:, :k - 1]], axis=1)
    new_levels.append(scatter_level(
        depth, jnp.zeros((mm,), jnp.int32).at[0].set(0).at[1:].set(1),
        jnp.broadcast_to(new_root[:, k - 1:k], (new_root.shape[0], mm))))

    return (jnp.stack(low_proof), jnp.stack(new_proof),
            jnp.stack(low_help), jnp.stack(new_help),
            old_root, new_root, new_levels)


@lru_cache(maxsize=None)
def _insert_batch_witness_fn(depth: int, k: int, full_depth: int,
                             nr: str = ""):
    n = 1 << depth
    m = n + k
    fd = full_depth

    @jax.jit
    def step(vals, nvs, nis, levels, new_vals, count):
        slots = count + 1 + jnp.arange(k, dtype=jnp.int32)
        big = jnp.iinfo(jnp.int32).max

        # ---- final-list sort (identical planner to _insert_batch_fn) ----
        all_vals = jnp.concatenate([vals, new_vals], axis=1)       # [16, M]
        all_slots = jnp.concatenate(
            [jnp.arange(n, dtype=jnp.int32), slots])               # [M]
        is_new = jnp.concatenate(
            [jnp.zeros(n, dtype=bool), jnp.ones(k, dtype=bool)])
        packed = tuple(
            (all_vals[2 * j + 1] << 16) | all_vals[2 * j]
            for j in range(field.LIMBS // 2 - 1, -1, -1))
        sorted_ops = jax.lax.sort(
            packed + (all_slots.astype(jnp.uint32),
                      jnp.arange(m, dtype=jnp.int32)),
            num_keys=9)
        order = sorted_ops[-1]
        ss = sorted_ops[8].astype(jnp.int32)   # sorted slots (9th sort key)
        snew = jnp.take(is_new, order)

        # value equality from the sorted keys (keys 0..7 = the 254 value
        # bits) — no [16, M] sorted-value gather (same diet as _plan_batch)
        eq_prev = sorted_ops[0][1:] == sorted_ops[0][:-1]
        for r in range(1, 8):
            eq_prev &= sorted_ops[r][1:] == sorted_ops[r][:-1]
        accepted = jnp.concatenate([jnp.ones(1, dtype=bool), ~eq_prev])

        pos = jnp.arange(m, dtype=jnp.int32)
        nxt = jax.lax.cummin(jnp.where(accepted, pos, m), reverse=True)
        nxt = jnp.concatenate([nxt[1:], jnp.full((1,), m, jnp.int32)])
        prv_f = jax.lax.cummax(jnp.where(accepted, pos, -1))
        prv_f = jnp.concatenate([jnp.zeros((1,), jnp.int32), prv_f[:-1]])

        inv_order = jnp.zeros((m,), jnp.int32).at[order].set(pos)
        pos_new = inv_order[n:]                       # sorted position of i
        ok = jnp.take(accepted, pos_new)              # per insert, batch order
        okm = ok[None]

        # K-sized final state (see indexed._plan_batch: only new slots and
        # their FINAL low leaves change)
        nxt_new = jnp.take(nxt, pos_new)
        has_fin = nxt_new < m
        nxt_c = jnp.clip(nxt_new, 0, m - 1)
        fin_succ_entry = jnp.take(order, nxt_c)
        fin_succ_val = jnp.where(has_fin & ok,
                                 jnp.take(all_vals, fin_succ_entry, axis=1),
                                 0)
        fin_succ_slot = jnp.where(has_fin & ok, jnp.take(ss, nxt_c), 0)
        fin_prev_slot = jnp.take(
            ss, jnp.clip(jnp.take(prv_f, pos_new), 0, m - 1))
        low_tgt = jnp.where(ok, fin_prev_slot, n)
        vals2 = vals.at[:, slots].set(jnp.where(okm, new_vals, 0))
        nvs2 = nvs.at[:, low_tgt].set(jnp.where(okm, new_vals, 0),
                                      mode="drop").at[:, slots].set(
            fin_succ_val)
        nis2 = nis.at[:, low_tgt].set(
            indexed.index_to_limbs(jnp.where(ok, slots, 0)),
            mode="drop").at[:, slots].set(
            indexed.index_to_limbs(fin_succ_slot))

        # ---- temporal planning -------------------------------------------
        # sigma over sorted positions: -1 for existing participants (slot-0
        # sentinel or occupied slots), the insert step for accepted new
        # entries, +inf otherwise (empty slots, rejected duplicates).
        occupied = jnp.concatenate(
            [jnp.ones((1,), dtype=bool), ~field.is_zero(vals)[1:]])
        participant = jnp.concatenate([occupied, jnp.zeros(k, dtype=bool)])
        part_s = jnp.take(participant, order)
        step_of_entry = jnp.concatenate(
            [jnp.full((n,), -1, jnp.int32), jnp.arange(k, dtype=jnp.int32)])
        step_s = jnp.take(step_of_entry, order)
        acc_new_s = snew & accepted

        # nearest existing participant below / above each sorted position
        prv_e = jax.lax.cummax(jnp.where(part_s, pos, -1))
        prv_e = jnp.concatenate([jnp.full((1,), -1, jnp.int32), prv_e[:-1]])
        nxt_e = jax.lax.cummin(jnp.where(part_s, pos, m), reverse=True)
        nxt_e = jnp.concatenate([nxt_e[1:], jnp.full((1,), m, jnp.int32)])

        # intra-batch ANSV over the k new entries in value order
        spn, ids = jax.lax.sort(
            (pos_new, jnp.arange(k, dtype=jnp.int32)), num_keys=1)
        sigma = jnp.where(jnp.take(acc_new_s, spn),
                          jnp.take(step_s, spn), big)            # [k]
        my_rank = jnp.zeros((k,), jnp.int32).at[ids].set(
            jnp.arange(k, dtype=jnp.int32))
        thr = jnp.arange(k, dtype=jnp.int32)                      # step i
        lo_r, lo_f = _ansv_prev(sigma, jnp.take(thr, ids))        # by rank
        hi_r_rev, hi_f_rev = _ansv_prev(sigma[::-1], jnp.take(thr, ids)[::-1])
        # map back: rank-indexed answers -> per-insert (batch order)
        lo_pos_new = jnp.where(lo_f, jnp.take(spn, lo_r), -1)
        hi_r = k - 1 - hi_r_rev[::-1]
        hi_f = hi_f_rev[::-1]
        hi_pos_new = jnp.where(hi_f, jnp.take(spn, jnp.clip(hi_r, 0, k - 1)),
                               m)
        lo_pos_new_i = jnp.take(lo_pos_new, my_rank)              # batch order
        hi_pos_new_i = jnp.take(hi_pos_new, my_rank)

        # combine with existing participants; positions in sorted coords
        low_pos = jnp.maximum(jnp.take(prv_e, pos_new), lo_pos_new_i)
        low_pos_c = jnp.clip(low_pos, 0, m - 1)
        succ_pos = jnp.minimum(jnp.take(nxt_e, pos_new), hi_pos_new_i)
        has_succ = succ_pos < m
        succ_pos_c = jnp.clip(succ_pos, 0, m - 1)

        low_slot = jnp.take(ss, low_pos_c).astype(jnp.int32)      # L_i
        low_val = jnp.take(all_vals, jnp.take(order, low_pos_c),
                           axis=1)                                # [16, K]
        succ_val = jnp.where(
            has_succ,
            jnp.take(all_vals, jnp.take(order, succ_pos_c), axis=1), 0)
        succ_slot = jnp.where(has_succ, jnp.take(ss, succ_pos_c),
                              0).astype(jnp.int32)
        succ_idx = indexed.index_to_limbs(succ_slot)              # [16, K]
        slots_limbs = indexed.index_to_limbs(slots)

        # ---- leaf-update timeline (2 updates per step) -------------------
        # rejected steps degrade to identity updates of their own empty slot
        okm = ok[None]
        u1_slot = slots                                           # new leaf
        u1 = (jnp.where(okm, new_vals, 0), jnp.where(okm, succ_val, 0),
              jnp.where(okm, succ_idx, 0))
        u2_slot = jnp.where(ok, low_slot, slots)                  # low leaf
        u2 = (jnp.where(okm, low_val, 0), jnp.where(okm, new_vals, 0),
              jnp.where(okm, slots_limbs, 0))
        upd_node = jnp.concatenate([u1_slot, u2_slot])            # [2K]
        upd_step = jnp.concatenate(
            [jnp.arange(k, dtype=jnp.int32)] * 2)                 # [2K]
        upd_val = hashing.hash3_leaf(
            jnp.concatenate([u1[0], u2[0]], axis=1),
            jnp.concatenate([u1[1], u2[1]], axis=1),
            jnp.concatenate([u1[2], u2[2]], axis=1))              # [CH, 2K]

        # ---- level-synchronous walk --------------------------------------
        l_path = jnp.where(ok, low_slot, slots)       # low path node
        (low_proof, new_proof, low_help, new_help, old_root, new_root,
         new_levels) = _witness_walk(
            lambda lvl, qn: jnp.take(levels[lvl], qn, axis=1),
            lambda lvl, idx, v: levels[lvl].at[:, idx].set(v, mode="drop"),
            levels[depth], l_path, slots, upd_node, upd_val, k, depth, n)

        if fd != depth:
            old_root = indexed._spine_fold(old_root, depth, fd)
            new_root = indexed._spine_fold(new_root, depth, fd)
            low_proof, low_help = indexed._extend_proof(
                low_proof, low_help, depth, fd)
            new_proof, new_help = indexed._extend_proof(
                new_proof, new_help, depth, fd)

        witness = dict(
            ok=ok,
            old_root=hashing.dec_nodes(old_root),
            low_leaf_val=low_val,
            low_leaf_next_val=succ_val,
            low_leaf_next_idx=succ_idx,
            low_leaf_proof=indexed._dec_path(low_proof),
            low_leaf_proof_helper=low_help,
            new_root=hashing.dec_nodes(new_root),
            new_leaf_val=new_vals,
            new_leaf_next_val=succ_val,
            new_leaf_next_idx=succ_idx,
            new_leaf_index=slots,
            new_leaf_proof=indexed._dec_path(new_proof),
            new_leaf_proof_helper=new_help,
            is_new_leaf_largest=field.is_zero(succ_val),
        )
        return (vals2, nvs2, nis2, tuple(new_levels)), witness

    return step

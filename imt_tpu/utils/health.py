"""In-run failure detection for indexed trees (SURVEY §5 aux subsystem).

The reference has no failure machinery at all; long-running production
deployments need one.  Two layers here:

* ``check_tree(tree, sample=..)`` — a point-in-time invariant audit:
  (a) sampled leaf-hash/Merkle-path consistency: H(val, next_val,
      next_idx) of sampled slots must verify against the CURRENT root
      through the tree's own proof path (catches leaf/level divergence,
      i.e. a corrupted or stale level array);
  (b) sampled linked-list order invariants: val < next_val or
      next_val == 0 (the sorted-successor contract the reference's
      verify_non_inclusion depends on, src/indexed_merkle_tree.rs:127-229);
  (c) cursor sanity: count within capacity.
  Returns a HealthReport; raises TreeCorruption on failure (fail-fast, the
  same philosophy as the reference's prover-side assert_eq!).

* ``Watchdog`` — wraps a tree and audits it every ``interval`` mutating
  operations (insert / insert_batch / insert_batches / insert_seq pass
  through), so a silently-corrupting deployment halts within a bounded
  number of operations instead of producing unverifiable witnesses
  forever.  Audit cost is O(sample · depth) hashes — negligible against a
  batch step — and the cadence is configurable.

Checkpoint/resume (utils/checkpoint.py) plus this watchdog together form
the failure story: detect in-run, restart from the last atomic snapshot
(exercised end-to-end by tests/test_soak.py::test_soak_kill_resume).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import numpy as np

from ..ops import field
from ..ops.poseidon_ref import generate_params, hash_fixed
from .observability import log_event


class TreeCorruption(AssertionError):
    """An invariant audit failed — the tree state is not trustworthy."""


@dataclass
class HealthReport:
    ok: bool
    checked_slots: list
    failures: list = dc_field(default_factory=list)


def _sample_slots(count: int, sample: int, seed: int) -> np.ndarray:
    """Occupied slots to audit: slot 0 (the sentinel) + up to `sample`
    distinct occupied slots (1..count)."""
    rng = np.random.default_rng(seed)
    occ = np.arange(1, count + 1)
    if len(occ) > sample:
        occ = rng.choice(occ, size=sample, replace=False)
    return np.concatenate([[0], np.sort(occ)]).astype(np.int64)


def check_tree(tree, sample: int = 8, seed: int = 0) -> HealthReport:
    """Audit `tree` (dense IndexedMerkleTree, SparseIndexedMerkleTree, or
    ShardedIndexedMerkleTree).  Raises TreeCorruption on any failure."""
    inner = getattr(tree, "_inner", tree)
    params = generate_params()
    slots = _sample_slots(inner.count, sample, seed)
    root = tree.get_root_int()
    failures = []
    for s in slots:
        v, nv, ni = tree.get_leaf_ints(int(s))
        # (b) linked-list order invariant.  A ZERO value in an occupied
        # slot (1..count) is itself corruption — insertion never stores 0
        # (reserved for the sentinel/empty leaf), and skipping such slots
        # would let a zeroed-and-rehashed state evade the audit entirely.
        if v == 0 and s != 0:
            failures.append((int(s), "empty",
                             "occupied slot holds the reserved zero value"))
        elif v != 0 or s == 0:
            if nv != 0 and not (v < nv):
                failures.append((int(s), "order", f"val={v} next_val={nv}"))
        # (a) leaf hash consistent with the current root via the tree's
        # own proof path (python-oracle hash: independent of the device
        # engines being audited)
        leaf_hash = hash_fixed([v, nv, ni], params)
        proof, helpers = tree.get_proof(int(s))
        p = np.asarray(proof)
        acc = leaf_hash
        idx = int(s)
        for d in range(p.shape[0]):
            sib = field.limbs_to_int(p[d, :, 0])
            acc = (hash_fixed([acc, sib], params) if idx % 2 == 0
                   else hash_fixed([sib, acc], params))
            idx //= 2
        if acc != root:
            failures.append((int(s), "path", "leaf does not verify "
                             "against the current root"))
    # (c) cursor sanity
    cap = getattr(inner, "num_slots", 1 << inner.tree_depth)
    if not (0 <= inner.count < cap):
        failures.append((-1, "cursor", f"count={inner.count} cap={cap}"))
    report = HealthReport(ok=not failures,
                          checked_slots=[int(s) for s in slots],
                          failures=failures)
    if failures:
        log_event("health_check_failed", failures=failures)
        raise TreeCorruption(f"tree invariant audit failed: {failures}")
    return report


class Watchdog:
    """Wrap a tree; audit invariants every `interval` mutating ops.

    >>> t = Watchdog(IndexedMerkleTree(8), interval=64)
    >>> t.insert_batch([...])          # delegates; audits on cadence
    """

    _MUTATORS = ("insert", "insert_batch", "insert_batches", "insert_seq")

    def __init__(self, tree, interval: int = 256, sample: int = 8):
        self._tree = tree
        self._interval = interval
        self._sample = sample
        self._ops = 0
        self._audits = 0

    def __getattr__(self, name):
        attr = getattr(self._tree, name)
        if name in self._MUTATORS and callable(attr):
            def wrapped(*a, **kw):
                out = attr(*a, **kw)
                self._ops += 1
                if self._ops % self._interval == 0:
                    self.audit()
                return out
            return wrapped
        return attr

    def audit(self) -> HealthReport:
        self._audits += 1
        report = check_tree(self._tree, sample=self._sample,
                            seed=self._audits)
        log_event("health_check_ok", audits=self._audits,
                  slots=len(report.checked_slots))
        return report

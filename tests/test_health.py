"""In-run failure detection (utils/health.py): invariant audits catch
deliberate state corruption; the Watchdog audits on its op cadence."""

import numpy as np
import jax.numpy as jnp
import pytest

from imt_tpu.ops import hashing
from imt_tpu.tree.indexed import IndexedMerkleTree
from imt_tpu.tree.sparse import SparseIndexedMerkleTree
from imt_tpu.utils.health import TreeCorruption, Watchdog, check_tree


def test_check_tree_clean():
    t = IndexedMerkleTree(4)
    t.insert_batch([30, 10, 20, 5])
    report = check_tree(t, sample=4)
    assert report.ok and 0 in report.checked_slots


def test_check_tree_detects_leaf_corruption():
    """Flip one leaf value WITHOUT rehashing: the sampled path audit must
    see the leaf hash diverge from the root."""
    t = IndexedMerkleTree(4)
    t.insert_batch([30, 10, 20, 5])
    vals = np.asarray(t.vals).copy()
    vals[0, 2] ^= 1                      # silent bit-flip in the leaf SoA
    t.vals = jnp.asarray(vals)
    with pytest.raises(TreeCorruption):
        check_tree(t, sample=8)


def test_check_tree_detects_order_corruption():
    """Break the sorted-successor contract (val < next_val) directly."""
    t = IndexedMerkleTree(4)
    t.insert_batch([30, 10, 20])
    nvs = np.asarray(t.next_vals).copy()
    # make some occupied slot's next_val smaller than its val
    vals = np.asarray(t.vals)
    from imt_tpu.ops import field
    for s in range(1, 4):
        if field.limbs_to_int(vals[:, s]) > 1:
            nvs[:, s] = 0
            nvs[0, s] = 1                # next_val = 1 < val
            break
    t.next_vals = jnp.asarray(nvs)
    # rehash so the paths verify — only the ORDER invariant is broken
    leaves = hashing.hash3_leaf(t.vals, t.next_vals, t.next_idxs)
    from imt_tpu.tree.indexed import _build_levels_fn
    t.levels = _build_levels_fn(t.tree_depth, t.node_repr)(leaves)
    with pytest.raises(TreeCorruption):
        check_tree(t, sample=8)


def test_check_tree_detects_zeroed_occupied_slot():
    """An occupied slot zeroed AND rehashed (paths verify, order check
    vacuous for v=0) must still fail the audit — the 'empty' corruption
    class: insertion never stores the reserved 0 value."""
    t = IndexedMerkleTree(4)
    t.insert_batch([30, 10, 20])
    vals = np.asarray(t.vals).copy()
    nvs = np.asarray(t.next_vals).copy()
    nis = np.asarray(t.next_idxs).copy()
    vals[:, 2] = 0                       # zero out an occupied slot
    nvs[:, 2] = 0
    nis[:, 2] = 0
    t.vals, t.next_vals, t.next_idxs = (jnp.asarray(vals), jnp.asarray(nvs),
                                        jnp.asarray(nis))
    # rehash so every path verifies — only the occupancy contract is broken
    leaves = hashing.hash3_leaf(t.vals, t.next_vals, t.next_idxs)
    from imt_tpu.tree.indexed import _build_levels_fn
    t.levels = _build_levels_fn(t.tree_depth, t.node_repr)(leaves)
    with pytest.raises(TreeCorruption, match="empty|zero"):
        check_tree(t, sample=8)


def test_watchdog_cadence_and_delegation():
    wd = Watchdog(SparseIndexedMerkleTree(24, initial_capacity_log2=4),
                  interval=2, sample=4)
    assert wd.insert_batch([30, 10]).all()       # op 1
    assert wd.insert_batch([20, 5]).all()        # op 2 -> audit
    assert wd._audits == 1
    assert wd.count == 4
    w = wd.insert(50)                            # op 3
    assert bool(np.asarray(w.ok).all())
    assert wd.insert_batch([35]).all()           # op 4 -> audit
    assert wd._audits == 2
    assert wd.get_root_int() == wd._tree.get_root_int()

"""Sharded paths: bit-exact vs single-device.

The mesh checks run in a subprocess with a 4-virtual-device CPU backend:
the virtual multi-device CPU client multiplies thread pools and spin-locks
(~7 minutes of sys time across the suite on a 4-core host), so the main
pytest process stays single-device and only this file pays for a mesh.
"""

import os
import subprocess
import sys

import pytest

_SCRIPT = r"""
import jax
jax.config.update("jax_platforms", "cpu")
import os
from imt_tpu.utils.cache import setup_compile_cache
setup_compile_cache()
import random
import numpy as np
from imt_tpu.ops import field, poseidon_jax
from imt_tpu.parallel import sharded
from imt_tpu.tree.merkle import MerkleTree

assert len(jax.devices()) == 4, jax.devices()
rng = random.Random(0x5A4D)

# data-parallel sharded hashing == single device
mesh = sharded.make_mesh(4)
xs = field.ints_to_limbs([rng.randrange(field.P) for _ in range(64)])
ys = field.ints_to_limbs([rng.randrange(field.P) for _ in range(64)])
got = np.asarray(sharded.sharded_hash2(xs, ys, mesh))
want = np.asarray(poseidon_jax.hash2(xs, ys))
assert (got == want).all(), "sharded hash mismatch"

# shard_map tree reduction (local subtrees + all_gather + top tree)
leaves = [rng.randrange(field.P) for _ in range(64)]
arr = field.ints_to_limbs(leaves)
root = np.asarray(sharded.sharded_root(arr, mesh))
assert field.limbs_to_int(root[:, 0]) == MerkleTree.build(arr).get_root_int()

# smaller mesh
mesh2 = sharded.make_mesh(2)
root2 = np.asarray(sharded.sharded_root(arr[:, :32], mesh2))
assert field.limbs_to_int(root2[:, 0]) == \
    MerkleTree.build(arr[:, :32]).get_root_int()

# sharded indexed tree container: bit-exact vs single-device, state sharded
from imt_tpu.tree.indexed import IndexedMerkleTree
st = sharded.ShardedIndexedMerkleTree(6, mesh)
ref = IndexedMerkleTree(6)
vals = [30, 10, 20, 5, 50, 35, 7, 7]       # includes a duplicate
assert st.insert_batch(vals).tolist() == ref.insert_batch(vals).tolist()
w1, w2 = st.insert(42), ref.insert(42)
assert bool(w1.ok.all()) and bool(w2.ok.all())
assert (np.asarray(w1.new_root) == np.asarray(w2.new_root)).all()
assert st.get_root_int() == ref.get_root_int()
nw = st.non_inclusion_witness([21, 20])
assert nw.ok.tolist() == [True, False]
shard_names = {d for l in st._inner.levels
               for d in (getattr(l.sharding, "spec", None),)}
assert any(s is not None and "shard" in str(s) for s in shard_names), \
    "state not sharded"
print("SHARDED-OK")
"""


def test_sharded_paths_subprocess():
    here = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(here, "_sharded_check.py")
    with open(script, "w") as f:
        f.write(_SCRIPT)
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=4").strip()
    env["JAX_PLATFORMS"] = "cpu"
    repo_root = os.path.dirname(here)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, script], env=env,
                         capture_output=True, text=True, timeout=1500,
                         cwd=os.path.dirname(here))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "SHARDED-OK" in out.stdout


@pytest.mark.slow
def test_collective_n_independence():
    """Multi-device scaling's load-bearing property as a failing test:
    every shard-local program's collective volume
    must be independent of the tree size N.  Compiles the four shard-local
    programs at depth 12 AND depth 14 on an 8-virtual-device CPU mesh
    (tests/_collective_check.py -> imt_tpu/parallel/collective_audit.py) and
    fails on any >=state-size collective or any N-proportional growth —
    i.e. reverting the local planner to the GSPMD sort makes this red."""
    here = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(here, "_collective_check.py")
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8").strip()
    env["JAX_PLATFORMS"] = "cpu"
    repo_root = os.path.dirname(here)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, script], env=env,
                         capture_output=True, text=True, timeout=2400,
                         cwd=repo_root)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-3000:])
    assert "COLLECTIVE-OK" in out.stdout


def test_sharded_device_resident_witness():
    """non_inclusion_witness(as_numpy=False) stays device-resident through
    ShardedIndexedMerkleTree for BOTH inner backings (the sparse branch
    used to silently drop the flag)."""
    import jax
    import numpy as np
    from imt_tpu.parallel.sharded import ShardedIndexedMerkleTree, make_mesh

    mesh = make_mesh(1)
    for sparse in (False, True):
        t = ShardedIndexedMerkleTree(8, mesh=mesh, sparse=sparse,
                                     initial_capacity_log2=3)
        t.insert_batch([30, 10, 20])
        w = t.non_inclusion_witness([15, 25], as_numpy=False)
        assert isinstance(w.ok, jax.Array), (sparse, type(w.ok))
        assert isinstance(w.low_leaf_proof, jax.Array)
        # values still correct once materialized
        assert np.asarray(w.ok).tolist() == [True, True]
        wn = t.non_inclusion_witness([15, 25])
        assert isinstance(wn.ok, np.ndarray)
        assert (np.asarray(w.low_leaf_val) == np.asarray(
            wn.low_leaf_val)).all()


def test_one_device_mesh_routes_to_plain_step():
    """A ShardedIndexedMerkleTree on a 1-device mesh must NOT pay the
    shard-local planner (pure overhead at D=1): every batched API routes
    to the inner single-device
    program.  Results must equal the plain tree's."""
    from unittest import mock

    import numpy as np

    from imt_tpu.parallel import local_plan
    from imt_tpu.parallel.sharded import ShardedIndexedMerkleTree, make_mesh
    from imt_tpu.tree.indexed import IndexedMerkleTree

    mesh = make_mesh(1)
    t = ShardedIndexedMerkleTree(6, mesh=mesh)
    ref = IndexedMerkleTree(6)
    fail = mock.Mock(side_effect=AssertionError(
        "local planner must not run on a 1-device mesh"))
    with mock.patch.multiple(local_plan,
                             local_insert_batch=fail,
                             local_insert_batches=fail,
                             local_insert_batch_witness=fail,
                             local_non_inclusion_witness=fail):
        assert t.insert_batch([30, 10, 20]).tolist() == \
            ref.insert_batch([30, 10, 20]).tolist()
        w1, w2 = t.insert(42), ref.insert(42)
        assert (np.asarray(w1.new_root) == np.asarray(w2.new_root)).all()
        nw = t.non_inclusion_witness([21, 20])
        assert nw.ok.tolist() == [True, False]
    assert t.get_root_int() == ref.get_root_int()


def test_sharded_checkpoint_roundtrip(tmp_path):
    """ShardedIndexedMerkleTree: checkpoint on one mesh, resume on another
    (here the same 1-device mesh), same roots and further inserts agree."""
    import numpy as np
    from imt_tpu.parallel.sharded import ShardedIndexedMerkleTree, make_mesh
    from imt_tpu.utils import checkpoint

    mesh = make_mesh(1)
    t = ShardedIndexedMerkleTree(24, mesh=mesh, sparse=True,
                                 initial_capacity_log2=3)
    t.insert_batch([30, 10, 20])
    path = str(tmp_path / "sharded.npz")
    checkpoint.save(t, path)

    # symmetric file API: load() sees the `sharded` marker and restores a
    # ShardedIndexedMerkleTree (onto the passed mesh) — no from_arrays knowledge
    r = checkpoint.load(path, mesh=mesh)
    assert isinstance(r, ShardedIndexedMerkleTree)
    assert r.sparse and r.count == t.count
    assert r.get_root_int() == t.get_root_int()
    r.insert_batch([5])
    t.insert_batch([5])
    assert r.get_root_int() == t.get_root_int()

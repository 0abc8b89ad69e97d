"""Backend dispatch: the RNS engine is a drop-in for the tree layer.

Forces the rns backend and replays the reference insertion sequence
(src/indexed_merkle_tree.rs:683-690) — roots must match the python oracle,
i.e. the exact roots the cios-backed tree produces.  Runs in a subprocess so
the main process's jit caches (traced with the cios backend) stay untouched.
"""

import os
import subprocess
import sys

_SCRIPT = r"""
import jax
jax.config.update("jax_platforms", "cpu")
import os
from imt_tpu.utils.cache import setup_compile_cache
setup_compile_cache()

from imt_tpu.ops import hashing
hashing.set_backend("rns")

from imt_tpu import IndexedMerkleTree
from imt_tpu.tree.reference_oracle import OracleIndexedTree

t = IndexedMerkleTree(depth=3)
o = OracleIndexedTree(depth=3)
for v in [30, 10, 20, 5, 50, 35]:
    w = t.insert(v)
    o.insert(v)
    assert bool(w.ok.all()), v
    assert t.get_root_int() == o.get_root(), v

# batched path on the rns backend too
t2 = IndexedMerkleTree(depth=4)
o2 = OracleIndexedTree(depth=4)
vals = [97, 3, 2**200 + 1, 55]
t2.insert_batch(vals)
for v in vals:
    o2.insert(v)
assert t2.get_root_int() == o2.get_root()
print("RNS-BACKEND-OK")
"""


def test_rns_backend_tree_parity():
    here = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(here, "_rns_backend_check.py")
    with open(script, "w") as f:
        f.write(_SCRIPT)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo_root = os.path.dirname(here)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, script], env=env,
                         capture_output=True, text=True, timeout=560,
                         cwd=repo_root)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "RNS-BACKEND-OK" in out.stdout


def test_backend_switch_mid_tree_raises():
    """The backend-representation guard: a tree built under one node
    representation must raise (not silently corrupt) if the hash backend is
    switched to an incompatible one mid-lifetime.  Runs in a subprocess so
    the main process's backend state stays untouched."""
    script = r"""
import jax
jax.config.update("jax_platforms", "cpu")
from imt_tpu.ops import hashing
from imt_tpu import IndexedMerkleTree

hashing.set_backend("cios")           # node repr: canonical limbs
t = IndexedMerkleTree(depth=3)
t.insert(7)
hashing.set_backend("rns")            # node repr: rns residues
for op in (lambda: t.insert(9), lambda: t.insert_batch([11]),
           lambda: t.get_root(), lambda: t.non_inclusion_witness([5])):
    try:
        op()
    except RuntimeError as e:
        assert "node representation" in str(e), e
    else:
        raise SystemExit("backend switch did not raise")
print("GUARD-OK")
"""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    here = os.path.dirname(os.path.abspath(__file__))
    repo_root = os.path.dirname(here)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=560,
                         cwd=repo_root)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "GUARD-OK" in out.stdout

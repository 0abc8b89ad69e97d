"""chip_smoke.py's phases at small sizes on the CPU, its refusals, and the
device-neutral plumbing it relies on (backend default, cache helper,
nvidia-smi parsing, bench.py's GPU requirement, dryrun_multichip's use of
the devices it is given).

The phases' device arithmetic is the same jnp/lax code on the CPU and the
GPU; what only the card can show (compilation there, real widths, times)
is what chip_smoke.py itself checks when it runs on one.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _env(**extra):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


# -- phases 1-4 at small sizes ------------------------------------------------

def test_phase_hash_parity_small():
    out = cs.phase_hash_parity(lanes=64, seed=1)
    assert out["hash2"]["lanes"] == out["hash3"]["lanes"] == 64 + 64


def test_phase_reference_replay():
    assert cs.phase_reference_replay() == {
        "sequential_replay_d3": True, "batched_sparse_d32": True,
        "witness_batch_predicate": True}


def test_phase_native_mid_root_small():
    out = cs.phase_native_mid_root(n=48, batch=16, seed=2)
    assert out["inserts"] == 48 and 0 < out["accepted"] < 48


def test_phase_deployment_small():
    out = cs.phase_deployment(7, batch=8, group=3, queries=16, witness_k=8,
                              samples=8, seed=3)
    # (2^7 - 8 - 1) // (8 * 3) = 4 groups of 3 batches of 8
    assert out["values"] == 96 and out["batches"] == 12
    assert 0 < out["accepted"] < 96 + 8


def test_phase_sharded_small_on_four_virtual_devices():
    """--devices 4's path (sharded tree vs single-device tree, plus
    dryrun_multichip) on a 4-device CPU mesh, in a subprocess so the main
    process stays single-device."""
    script = ("import chip_smoke as cs\n"
              "print(cs.phase_sharded(4, 7, batch=8, group=3, queries=16,"
              " witness_k=8))\n")
    env = _env(XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=900,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "'bit_exact': True" in out.stdout


# -- the host audits must catch corruption ------------------------------------

@pytest.fixture(scope="module")
def small_tree():
    from imt_tpu.tree.sparse import SparseIndexedMerkleTree

    stream = cs.make_stream(11, 48, 16)
    model = cs.first_occurrence_model(stream)
    tree = SparseIndexedMerkleTree(32, initial_capacity_log2=6)
    oks = tree.insert_batches(np.ascontiguousarray(
        stream.reshape(16, 3, 16).transpose(1, 0, 2)))
    assert (np.asarray(oks).reshape(-1) == model).all()
    host = [np.asarray(a) for a in (tree.vals, tree.next_vals,
                                    tree.next_idxs)]
    return tree, stream, model, host


@pytest.mark.parametrize("field_i", [0, 1, 2],
                         ids=["val", "next_val", "next_idx"])
def test_leaf_state_check_catches_corrupted_leaf(small_tree, field_i):
    tree, stream, model, host = small_tree
    cs.check_leaf_state(*host, tree.count, stream, model)        # clean
    bad = [a.copy() for a in host]
    slot = 1 + int(np.nonzero(model)[0][5])
    bad[field_i][0, slot] ^= 1
    with pytest.raises(AssertionError):
        cs.check_leaf_state(*bad, tree.count, stream, model)


def test_proof_fold_catches_corrupted_proof(small_tree):
    tree, _, model, host = small_tree
    slots = np.array([0, 3, 17, tree.count])
    assert cs.fold_proofs_native(tree, slots, *host).all()

    class Corrupt:
        def __init__(self, inner):
            self.inner = inner

        def get_root_int(self):
            return self.inner.get_root_int()

        def get_proof(self, index):
            proof, helpers = self.inner.get_proof(index)
            if index == 17:
                proof = np.asarray(proof).copy()
                proof[4, 0, 0] ^= 1
            return proof, helpers

    assert cs.fold_proofs_native(Corrupt(tree), slots, *host).tolist() == \
        [True, True, False, True]


# -- host-side models -----------------------------------------------------------

def test_first_occurrence_model_matches_loop():
    from imt_tpu.ops import field

    stream = cs.make_stream(5, 400, 50)
    ints = field.limbs_to_ints(stream)
    seen, want = set(), []
    for v in ints:
        want.append(v != 0 and v not in seen)
        seen.add(v)
    assert cs.first_occurrence_model(stream).tolist() == want
    assert 0 in ints and len(seen) < len(ints) - 1    # zeros and repeats


def test_be_keys_sort_numerically_and_u64_layout():
    from imt_tpu.native import oracle
    from imt_tpu.ops import field

    xs = [0, 1, 65535, 65536, 2 ** 200 + 5, 2 ** 200, field.P - 1, 7 << 64]
    limbs = field.ints_to_limbs(xs)
    order = np.argsort(cs.be_keys(limbs), kind="stable")
    assert [xs[i] for i in order] == sorted(xs)
    assert (cs.limbs_to_u64(limbs) == oracle.ints_to_u64(xs)).all()


# -- output contract and refusals ---------------------------------------------

def test_ok_line_exact_keys():
    line = json.loads(cs.ok_line("gpu", "NVIDIA H100 80GB HBM3", 4))
    assert line == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}


@pytest.mark.parametrize("argv,count", [([], 1), (["--devices", "2"], 2)],
                         ids=["default", "devices2"])
def test_ok_line_counts_the_devices_used(monkeypatch, capsys, argv, count):
    """Four cards visible: the ok line and the header count the ones the
    run used, not every visible one."""
    from imt_tpu.utils import cache, device

    class FakeGpu:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(device, "require_gpu", lambda: [FakeGpu()] * 4)
    monkeypatch.setattr(device, "smi_line",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(cache, "setup_compile_cache", lambda: "/cache")
    for name in ("phase_hash_parity", "phase_reference_replay",
                 "phase_native_mid_root", "phase_deployment",
                 "phase_sharded"):
        monkeypatch.setattr(cs, name, lambda *a, **k: {})
    monkeypatch.setattr(cs, "phase_engine_timing", lambda: [])
    assert cs.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert f"x{count} (4 visible)" in lines[1]
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}}


def test_chip_smoke_refuses_cpu():
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         env=_env(), capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_chip_smoke_refuses_without_checkout(tmp_path):
    import shutil
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = _env()
    env.pop("PYTHONPATH")
    out = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("line,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", ("NVIDIA H100 80GB HBM3", "700.00 W")),
    ("NVIDIA H100, PCIe, 350.00 W", ("NVIDIA H100, PCIe", "350.00 W")),
    ("", None),
    ("NVIDIA H100 80GB HBM3", None),
])
def test_parse_smi_line(line, want):
    from imt_tpu.utils.device import parse_smi_line
    if want is None:
        with pytest.raises(ValueError):
            parse_smi_line(line)
    else:
        assert parse_smi_line(line) == want


def test_bench_refuses_cpu(capsys):
    import bench
    with pytest.raises(SystemExit) as exc:
        bench.main(["--smoke"])
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""


# -- engine selection ----------------------------------------------------------

def test_backend_default_is_rns_on_gpu(monkeypatch):
    import jax
    from imt_tpu.ops import hashing

    class FakeGpu:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(jax, "devices", lambda *a: [FakeGpu()])
    monkeypatch.delenv("IMT_HASH_ENGINE", raising=False)
    monkeypatch.setattr(hashing, "_backend", None)
    assert hashing.backend() == "rns"
    assert hashing.node_repr() == "rns"


def test_pallas_engine_refused():
    from imt_tpu.ops import hashing
    from imt_tpu.utils.config import EngineConfig

    with pytest.raises(ValueError):
        hashing.set_backend("pallas")
    with pytest.raises(ValueError):
        EngineConfig(hash_engine="pallas")
    assert hashing.backend() == "rns"


def test_phase_engine_timing_rows():
    rows = cs.phase_engine_timing(widths=(128,), k1=1, k2=2)
    assert [(r["engine"], r["width"]) for r in rows] == \
        [("rns", 128), ("cios", 128)]
    assert set(rows[0]) == {"engine", "width", "compile_first_s",
                            "us_per_batch", "perms_per_s"}


# -- compile cache ---------------------------------------------------------------

def test_cache_helper_honours_env_dir(tmp_path):
    script = (
        "import jax\n"
        "from imt_tpu.utils.cache import setup_compile_cache\n"
        "path = setup_compile_cache()\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.jit(lambda x: x * 3 + 1)(jax.numpy.arange(5)).block_until_ready()\n"
        "print(path)\n")
    out = subprocess.run([sys.executable, "-c", script],
                         env=_env(JAX_COMPILATION_CACHE_DIR=str(tmp_path)),
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == str(tmp_path)
    assert any(tmp_path.iterdir()), "nothing was cached in the env dir"


def test_cache_helper_default_is_fixed_checkout_path(monkeypatch):
    import jax
    from imt_tpu.utils import cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        first = cache.setup_compile_cache()
        assert first == cache.setup_compile_cache()
        assert os.path.dirname(first) == os.path.join(REPO, ".jax_cache")
        assert first == cache.host_cache_dir(os.path.join(REPO, ".jax_cache"))
        assert jax.config.jax_compilation_cache_dir == first
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


# -- multi-device dry run --------------------------------------------------------

def test_dryrun_multichip_uses_the_devices_it_is_given():
    """No switch to virtual CPU devices: with one device visible, asking
    for two fails instead of changing the platform behind the caller."""
    import jax

    import __graft_entry__

    flags = os.environ.get("XLA_FLAGS")
    platforms = jax.config.jax_platforms
    with pytest.raises(RuntimeError, match="need 2 devices, have 1"):
        __graft_entry__.dryrun_multichip(2)
    assert os.environ.get("XLA_FLAGS") == flags
    assert jax.config.jax_platforms == platforms

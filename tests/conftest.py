"""Test config: force JAX onto single-device CPU (multi-virtual-device
meshes thrash a small host; sharded tests spawn a subprocess with
xla_force_host_platform_device_count=4 — see tests/test_parallel.py).

jax.config.update runs before any backend initializes, so the suite stays
on the CPU even where a GPU is visible.  Tests that need the card live in
chip_smoke.py, which runs on the GPU.
"""

import os

import jax

jax.config.update("jax_platforms", "cpu")
# Persistent compilation cache: repeated test runs skip XLA recompiles
# (JAX_COMPILATION_CACHE_DIR if set, else .jax_cache/<host key> — XLA:CPU
# AOT entries from a different machine type can SIGILL when loaded).
# imt_tpu is an installed package: pip install -e . (pyproject.toml)
from imt_tpu.utils.cache import setup_compile_cache

setup_compile_cache()
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=1"
    ).strip()


# ---------------------------------------------------------------------------
# Suite-RSS bound: the full default tier compiles 100+ distinct programs;
# holding every engine lru_cache + pjit cache alive for the whole run grew
# the process past ~9.7 GB and intermittently segfaulted inside pjit.
# Dropping the program caches between test MODULES bounds RSS to the
# largest single module; recompiles hit the persistent on-disk
# cache so the cost is re-tracing only.
# ---------------------------------------------------------------------------

import pytest


@pytest.fixture(autouse=True, scope="module")
def _bound_suite_rss():
    yield
    from imt_tpu.utils.cache import clear_program_caches
    clear_program_caches()

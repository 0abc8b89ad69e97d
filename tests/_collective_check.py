"""Subprocess worker: N-independence audit of the shard-local programs.

Run by tests/test_parallel.py::test_collective_n_independence with
xla_force_host_platform_device_count=8.  Compiles the four shard-local
programs at depth 12 and depth 14 (4x the state) and fails if any
collective is >= one [16, N] state array or if total collective bytes grow
with N (imt_tpu/parallel/collective_audit.py).  Reverting the local
planner to the GSPMD sort (which all-gathers the state) makes this red.
"""

import jax

jax.config.update("jax_platforms", "cpu")
from imt_tpu.utils.cache import setup_compile_cache

setup_compile_cache()

assert len(jax.devices()) == 8, jax.devices()

from imt_tpu.parallel.collective_audit import audit_local_plan

res = audit_local_plan(devices=8, depth=12, k=256)
print(res.summary())
assert len(res.programs) == 4
assert not res.failures, (
    "shard-local collective volume regression:\n" + res.summary())
print("COLLECTIVE-OK")

"""Compiled-program cache control.

Every jitted builder in the engine is an ``functools.lru_cache`` over
(shape, depth, …) keys whose values close over compiled XLA executables.
A long-lived process that touches many shapes (the test suite compiles
~100+ distinct programs) accumulates all of them — plus jax's own pjit
caches — as unreclaimable RSS.  ``clear_program_caches()`` drops every
engine-level lru_cache across all loaded ``imt_tpu`` modules, then jax's
caches; recompiles afterwards hit the persistent on-disk compilation
cache, so the cost is re-tracing, not re-compiling.

Used by tests/conftest.py between test modules (bounds suite RSS to the
largest single module) and available to any long-lived service embedding
the engine.

``setup_compile_cache()`` is the one place that points JAX's persistent
compilation cache at a directory: every entry point (bench.py,
chip_smoke.py, tools/, the tests and their subprocess scripts) calls it.
"""

from __future__ import annotations

import functools
import gc
import hashlib
import os
import platform
import sys


def host_cache_dir(root: str) -> str:
    """Persistent-compilation-cache directory keyed by a host fingerprint.

    XLA:CPU persists AOT machine code; an entry compiled on a host with a
    different CPU feature set (containers migrate) can SIGILL/segfault when
    loaded — jax itself warns "This could lead to execution errors such as
    SIGILL".  Keying the directory on (machine, cpu-flags hash) makes every
    host population-fresh instead of sharing one poisoned pool."""
    tag = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    h = hashlib.sha256(line.encode()).hexdigest()[:12]
                    tag = f"{tag}-{h}"
                    break
    except OSError:
        pass
    path = os.path.join(root, tag)
    os.makedirs(path, exist_ok=True)
    return path


# <checkout>/.jax_cache — a fixed path: the directory is part of what a
# cache hit needs, so a per-process or temporary name would never hit.
DEFAULT_CACHE_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


# programs that compile faster than this are not written to the cache
MIN_COMPILE_SECS = 1.0


def setup_compile_cache() -> str:
    """Enable JAX's persistent compilation cache; returns its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and
    no directory is set here.  Otherwise the cache lives at
    ``.jax_cache/<host key>`` in the checkout (host_cache_dir)."""
    import jax
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        path = env
    else:
        path = host_cache_dir(DEFAULT_CACHE_ROOT)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      MIN_COMPILE_SECS)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path


def iter_engine_caches():
    """Yield every lru_cache-wrapped callable defined on a loaded
    ``imt_tpu`` module (module-level only; the engine defines no nested
    persistent caches)."""
    for name, mod in list(sys.modules.items()):
        if mod is None or not name.startswith("imt_tpu"):
            continue
        for attr in list(vars(mod).values()):
            if callable(attr) and hasattr(attr, "cache_clear") \
                    and hasattr(attr, "cache_info"):
                yield attr


def clear_program_caches(clear_jax: bool = True) -> int:
    """Drop all engine program caches (and jax's, unless told not to).
    Returns the number of cached entries released."""
    released = 0
    for fn in iter_engine_caches():
        released += fn.cache_info().currsize
        fn.cache_clear()
    if clear_jax:
        import jax
        jax.clear_caches()
    gc.collect()
    return released

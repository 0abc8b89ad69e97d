"""ctypes bindings for the C++ native oracle (imt_native.cpp).

Builds the shared library on first use (g++ -O2, no external deps) and
exposes batched hash2/hash3/mul/add/tree-build over numpy uint64 arrays.
Field elements cross the boundary as 4x64-bit little-endian limbs in
standard (non-Montgomery) form.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from ..ops import field
from ..ops.poseidon_ref import generate_params

_DIR = os.path.dirname(__file__)
_SRC = os.path.join(_DIR, "imt_native.cpp")
# IMT_NATIVE_SAN=1 builds/loads an AddressSanitizer+UBSan instrumented
# variant (the SURVEY §5 sanitizer job; run under LD_PRELOAD=libasan.so —
# see tests/test_sanitizers.py)
_SAN = os.environ.get("IMT_NATIVE_SAN") == "1"
_LIB = os.path.join(_DIR, "libimt_native_asan.so" if _SAN
                    else "libimt_native.so")

_lib = None


def _build() -> None:
    cmd = ["g++", "-O2", "-march=native", "-shared", "-fPIC"]
    if _SAN:
        cmd += ["-fsanitize=address,undefined", "-fno-sanitize-recover=all",
                "-g"]
    cmd += ["-o", _LIB, _SRC]
    subprocess.run(cmd, check=True, capture_output=True)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if (not os.path.exists(_LIB)
            or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
        _build()
    lib = ctypes.CDLL(_LIB)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.imt_init.argtypes = [u64p, u64p, ctypes.c_int, ctypes.c_int]
    for name, nargs in [("imt_hash2", 3), ("imt_mul_mod", 3),
                        ("imt_add_mod", 3), ("imt_hash3", 4)]:
        getattr(lib, name).argtypes = [u64p] * nargs + [ctypes.c_long]
    lib.imt_tree_build.argtypes = [u64p, u64p, ctypes.c_long]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.imt_idx_new.argtypes = [ctypes.c_int]
    lib.imt_idx_new.restype = ctypes.c_void_p
    lib.imt_idx_free.argtypes = [ctypes.c_void_p]
    lib.imt_idx_count.argtypes = [ctypes.c_void_p]
    lib.imt_idx_count.restype = ctypes.c_long
    lib.imt_idx_root.argtypes = [ctypes.c_void_p, u64p]
    lib.imt_idx_leaf.argtypes = [ctypes.c_void_p, ctypes.c_long, u64p]
    lib.imt_idx_insert.argtypes = [ctypes.c_void_p, u64p, u64p]
    lib.imt_idx_insert.restype = ctypes.c_int
    lib.imt_idx_insert_batch.argtypes = [ctypes.c_void_p, u64p,
                                         ctypes.c_long, u8p]
    lib.imt_idx_insert_batch.restype = ctypes.c_long
    lib.imt_idx_proof.argtypes = [ctypes.c_void_p, ctypes.c_long, u64p, u64p]

    params = generate_params()
    rc = np.zeros((params.n_rounds * params.t, 4), dtype=np.uint64)
    for r in range(params.n_rounds):
        for i in range(params.t):
            rc[r * params.t + i] = _int_to_u64(params.round_constants[r][i])
    mds = np.zeros((params.t * params.t, 4), dtype=np.uint64)
    for i in range(params.t):
        for j in range(params.t):
            mds[i * params.t + j] = _int_to_u64(params.mds[i][j])
    lib.imt_init(_ptr(rc), _ptr(mds), params.r_f, params.r_p)
    _lib = lib
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _int_to_u64(x: int) -> np.ndarray:
    return np.array([(x >> (64 * i)) & ((1 << 64) - 1) for i in range(4)],
                    dtype=np.uint64)


def ints_to_u64(xs) -> np.ndarray:
    out = np.zeros((len(xs), 4), dtype=np.uint64)
    for i, x in enumerate(xs):
        out[i] = _int_to_u64(x % field.P)
    return out


def u64_to_ints(a: np.ndarray) -> list[int]:
    a = np.ascontiguousarray(a, dtype=np.uint64)
    return [sum(int(row[i]) << (64 * i) for i in range(4)) for row in a]


def hash2(xs, ys) -> list[int]:
    lib = _load()
    a, b = ints_to_u64(xs), ints_to_u64(ys)
    out = np.zeros_like(a)
    lib.imt_hash2(_ptr(a), _ptr(b), _ptr(out), len(xs))
    return u64_to_ints(out)


def hash3(xs, ys, zs) -> list[int]:
    lib = _load()
    a, b, c = ints_to_u64(xs), ints_to_u64(ys), ints_to_u64(zs)
    out = np.zeros_like(a)
    lib.imt_hash3(_ptr(a), _ptr(b), _ptr(c), _ptr(out), len(xs))
    return u64_to_ints(out)


def mul_mod(xs, ys) -> list[int]:
    lib = _load()
    a, b = ints_to_u64(xs), ints_to_u64(ys)
    out = np.zeros_like(a)
    lib.imt_mul_mod(_ptr(a), _ptr(b), _ptr(out), len(xs))
    return u64_to_ints(out)


def add_mod(xs, ys) -> list[int]:
    lib = _load()
    a, b = ints_to_u64(xs), ints_to_u64(ys)
    out = np.zeros_like(a)
    lib.imt_add_mod(_ptr(a), _ptr(b), _ptr(out), len(xs))
    return u64_to_ints(out)


def tree_build(leaves) -> list[int]:
    """All tree levels (leaves first, root last) for 2^k leaves."""
    lib = _load()
    n = len(leaves)
    a = ints_to_u64(leaves)
    out = np.zeros((2 * n - 1, 4), dtype=np.uint64)
    lib.imt_tree_build(_ptr(a), _ptr(out), n)
    return u64_to_ints(out)


class NativeIndexedTree:
    """Native (C++) indexed Merkle tree — the reference's out-of-circuit
    witness-generation layer (src/utils.rs + the update_idx_leaf planner,
    src/indexed_merkle_tree.rs:632-660) as a native runtime component.

    Engine-parity semantics (imt_tpu/tree/indexed.py): duplicate/zero inserts
    are rejected but consume their slot.  Incremental path updates make each
    insert 2*(depth+1) hashes + an O(log n) planner lookup, vs the python
    oracle's full-tree rebuild — use this for large differential soaks.

    Witnesses for REJECTED inserts report the untouched tree (old==new root);
    the JAX engine instead reports an as-if-applied new_root in rejected
    lanes while leaving its state untouched — only accepted-lane witnesses
    are comparable across the two.
    """

    def __init__(self, depth: int):
        self._lib = _load()
        self.depth = depth
        self._h = ctypes.c_void_p(self._lib.imt_idx_new(depth))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.imt_idx_free(h)
            self._h = None

    @property
    def count(self) -> int:
        return self._lib.imt_idx_count(self._h)

    def get_root(self) -> int:
        out = np.zeros(4, dtype=np.uint64)
        self._lib.imt_idx_root(self._h, _ptr(out))
        return u64_to_ints(out[None])[0]

    def get_leaf_ints(self, i: int):
        out = np.zeros((3, 4), dtype=np.uint64)
        self._lib.imt_idx_leaf(self._h, i, _ptr(out))
        return tuple(u64_to_ints(out))

    def get_proof(self, index: int) -> tuple[list[int], list[int]]:
        proof = np.zeros((self.depth, 4), dtype=np.uint64)
        helpers = np.zeros(self.depth, dtype=np.uint64)
        self._lib.imt_idx_proof(self._h, index, _ptr(proof), _ptr(helpers))
        return u64_to_ints(proof), [int(x) for x in helpers]

    def insert(self, value: int) -> dict:
        """One insert; returns the witness bundle as python ints (same keys
        as tree/reference_oracle.py OracleIndexedTree.insert)."""
        d = self.depth
        wit = np.zeros(35 + 10 * d, dtype=np.uint64)
        v = _int_to_u64(value % field.P)
        r = self._lib.imt_idx_insert(self._h, _ptr(v), _ptr(wit))
        if r < 0:
            raise ValueError("tree full")
        u = lambda off: u64_to_ints(wit[off:off + 4][None])[0]
        vec = lambda off: u64_to_ints(wit[off:off + 4 * d].reshape(d, 4))
        tail = wit[32 + 10 * d:]
        return dict(
            ok=bool(r),
            old_root=u(0),
            low_leaf=(u(4), u(8), u(12)),
            new_root=u(16),
            new_leaf=(u(20), u(24), u(28)),
            low_leaf_proof=vec(32),
            new_leaf_proof=vec(32 + 4 * d),
            low_leaf_proof_helper=[int(x) for x in wit[32 + 8 * d:32 + 9 * d]],
            new_leaf_proof_helper=[int(x) for x in wit[32 + 9 * d:32 + 10 * d]],
            new_leaf_index=int(tail[0]),
            is_new_leaf_largest=bool(tail[1]),
        )

    def insert_batch(self, values) -> np.ndarray:
        """Sequential native batch insert; returns the acceptance mask."""
        vals = ints_to_u64(values)
        ok = np.zeros(len(values), dtype=np.uint8)
        r = self._lib.imt_idx_insert_batch(
            self._h, _ptr(vals), len(values), ok.ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint8)))
        if r < 0:
            raise ValueError("tree full")
        return ok.astype(bool)


# --- raw-array fast paths (no python-int conversion) -------------------------

def hash2_u64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lib = _load()
    a = np.ascontiguousarray(a, np.uint64)
    b = np.ascontiguousarray(b, np.uint64)
    out = np.zeros_like(a)
    lib.imt_hash2(_ptr(a), _ptr(b), _ptr(out), a.shape[0])
    return out


def hash3_u64(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    lib = _load()
    a = np.ascontiguousarray(a, np.uint64)
    b = np.ascontiguousarray(b, np.uint64)
    c = np.ascontiguousarray(c, np.uint64)
    out = np.zeros_like(a)
    lib.imt_hash3(_ptr(a), _ptr(b), _ptr(c), _ptr(out), a.shape[0])
    return out

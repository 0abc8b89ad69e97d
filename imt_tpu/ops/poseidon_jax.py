"""Batched Poseidon permutation + fixed-length hashes in JAX (XLA path).

Design notes:

* State layout is ``uint32[16 limbs, 3 words, B]`` — limb axis leading,
  batch trailing (the minor, contiguous axis).  Every op is elementwise over the
  trailing batch; there is no per-element control flow, so the whole
  permutation is a single fused XLA computation.

* All arithmetic is Montgomery-domain (values < 2p).  Inputs are converted
  to Montgomery form at absorb time (one mont_mul per word) and the output
  is converted back + canonicalized, so callers always see canonical
  standard-form limbs.

* The MDS layer computes all 9 products in one mont_mul call on a
  ``[16, 9, B]`` array (lane-parallel), then tree-adds in two add_mod calls.

* The 57 partial rounds run under ``lax.fori_loop`` (compiled once); the 8
  full rounds are unrolled.

Reference parity: per-round structure replicates the standard Poseidon
schedule pinned by the reference's dependency vectors (see poseidon_ref.py);
bit-exactness is enforced in tests against the python-int oracle and the
H(0,0,0) anchor (reference src/indexed_merkle_tree.rs:247-251).

Cost model (reference SURVEY §3.1): each 2- or 3-input hash is exactly two
permutations, so tree ops can budget hashes = permutations / 2.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from . import field
from .poseidon_spec import PoseidonSpecArrays, default_spec

# ---------------------------------------------------------------------------
# Constant preparation (host): rearrange to limb-major device layout
# ---------------------------------------------------------------------------


def _prep(spec: PoseidonSpecArrays):
    # rc: [rounds, t, 16] -> [rounds, 16, t, 1] (broadcast over batch)
    rc = np.transpose(spec.rc_mont, (0, 2, 1))[:, :, :, None].astype(np.uint32)
    # mds flattened row-major: products p[i*t+j] = M[i][j] * st[j]
    # -> [16, 9, 1]
    t = spec.t
    mds_flat = np.zeros((field.LIMBS, t * t, 1), dtype=np.uint32)
    for i in range(t):
        for j in range(t):
            mds_flat[:, i * t + j, 0] = spec.mds_mont[i, j]
    iv = np.transpose(spec.iv_mont, (1, 0))[:, :, None]  # [16, t, 1]
    one = spec.one_mont[:, None]  # [16, 1]
    return rc, mds_flat, iv, one


class Poseidon:
    """Batched Poseidon engine bound to one spec (default: BN254 t=3 8/57).

    unroll=False (default): rounds and CIOS limb loops run under lax.scan —
    small compiled graphs, best for CPU/tests and cold compiles.
    unroll=True: everything unrolled into one flat elementwise graph — no
    while-loop overhead (XLA fuses the whole permutation; compile is
    slower but cached)."""

    def __init__(self, spec: PoseidonSpecArrays | None = None,
                 unroll: bool = False):
        self.spec = spec or default_spec()
        self.unroll = unroll
        self._rc, self._mds_flat, self._iv, self._one = _prep(self.spec)

    # -- internals ---------------------------------------------------------

    def _mds_round(self, st, rc_round):
        """MDS multiply + next-round-constant add.  st: [16, t, B] (Montgomery).
        rc_round: [16, t, 1] (a zeros row is an identity add — used to elide
        the constant after the final round)."""
        t = self.spec.t
        b = st.shape[-1]
        # Products for all (i, j): gather st[j] per flattened index.
        st_g = jnp.concatenate([st] * t, axis=1)            # [16, t*t, B], index j fast
        prods = field.mont_mul(jnp.broadcast_to(self._mds_flat, (field.LIMBS, t * t, b)), st_g,
                               unroll=self.unroll)
        # Tree-add groups of t.
        acc = prods[:, 0::t, :]
        for j in range(1, t):
            acc = field.add_mod(acc, prods[:, j::t, :])
        return field.add_mod(acc, jnp.broadcast_to(rc_round, acc.shape))

    def _sbox_full(self, st):
        x2 = field.mont_mul(st, st, unroll=self.unroll)
        x4 = field.mont_mul(x2, x2, unroll=self.unroll)
        return field.mont_mul(x4, st, unroll=self.unroll)

    def permute(self, st):
        """One Poseidon permutation on state [16, t, B] (Montgomery, < 2p).

        Standard schedule (ARC -> sbox -> MDS per round), with round r+1's
        ARC folded into round r's MDS step so each scanned body is uniform.
        Rounds run under lax.scan: one compiled body per round type instead
        of 65 unrolled rounds (compile-time control; XLA still fuses within
        the body)."""
        spec = self.spec
        half = spec.r_f // 2
        rc = jnp.asarray(self._rc)

        st = field.add_mod(st, jnp.broadcast_to(rc[0], st.shape))

        def full_body(s, rc_row):
            s = self._sbox_full(s)
            return self._mds_round(s, rc_row), None

        def partial_body(s, rc_row):
            x0 = self._sbox_full(s[:, 0:1, :])
            s = jnp.concatenate([x0, s[:, 1:, :]], axis=1)
            return self._mds_round(s, rc_row), None

        rc_tail = jnp.concatenate([rc[half + 1 + spec.r_p:],
                                   jnp.zeros_like(rc[:1])])
        # Rounds stay scanned even in unroll mode: the inner field ops are
        # flat (no nested while loops), the per-round body fuses into a few
        # kernels, and the compiled graph stays small enough for remote
        # compile.  Full rounds (4 iterations) unroll inside the scan.
        st, _ = jax.lax.scan(full_body, st, rc[1:half + 1],
                             unroll=self.unroll)
        st, _ = jax.lax.scan(partial_body, st,
                             rc[half + 1:half + 1 + spec.r_p])
        st, _ = jax.lax.scan(full_body, st, rc_tail, unroll=self.unroll)
        return st

    # -- public hashing API ------------------------------------------------

    def hash2(self, a, b):
        """Batched 2-to-1 hash (Merkle node), canonical limbs [16, B] -> [16, B].

        Mirrors the native sponge: absorb [a, b], pad [1], 2 permutations
        (reference src/utils.rs:46-47)."""
        bsz = a.shape[1:]
        iv = jnp.broadcast_to(jnp.asarray(self._iv), (field.LIMBS, self.spec.t) + bsz)
        st = jnp.concatenate([
            iv[:, 0:1], field.to_mont(a, unroll=self.unroll)[:, None],
            field.to_mont(b, unroll=self.unroll)[:, None],
        ], axis=1)
        st = self.permute(st)
        one = jnp.broadcast_to(jnp.asarray(self._one)[:, None], (field.LIMBS, 1) + bsz)
        st = jnp.concatenate([
            st[:, 0:1], field.add_mod(st[:, 1:2], one),
            st[:, 2:3]], axis=1)
        st = self.permute(st)
        return field.normalize(field.from_mont(st[:, 1], unroll=self.unroll))

    def hash3(self, a, b, c):
        """Batched 3-to-1 hash (indexed leaf), canonical limbs [16, B].

        Mirrors the native sponge: absorb [a, b], permute, absorb [c, 1],
        permute (reference src/indexed_merkle_tree.rs:407-411)."""
        bsz = a.shape[1:]
        iv = jnp.broadcast_to(jnp.asarray(self._iv), (field.LIMBS, self.spec.t) + bsz)
        st = jnp.concatenate([
            iv[:, 0:1], field.to_mont(a, unroll=self.unroll)[:, None],
            field.to_mont(b, unroll=self.unroll)[:, None],
        ], axis=1)
        st = self.permute(st)
        one = jnp.broadcast_to(jnp.asarray(self._one)[:, None], (field.LIMBS, 1) + bsz)
        st = jnp.concatenate([
            st[:, 0:1],
            field.add_mod(st[:, 1:2], field.to_mont(c, unroll=self.unroll)[:, None]),
            field.add_mod(st[:, 2:3], one),
        ], axis=1)
        st = self.permute(st)
        return field.normalize(field.from_mont(st[:, 1], unroll=self.unroll))

    def hash_fixed(self, cols):
        """Arbitrary fixed-length hash — the halo2-base
        ``PoseidonHasher::hash_fix_len_array`` contract (reference
        src/indexed_merkle_tree.rs:92,:194) on the CIOS engine: absorb
        RATE=2 chunks with a permutation per full chunk, pad the final
        chunk with a single 1 (pse-poseidon sponge discipline, SURVEY
        §2.2).  cols: list of canonical limb arrays uint32[16, B]; returns
        uint32[16, B].  Lengths 2/3 agree with hash2/hash3 by
        construction; all lengths agree with the python sponge oracle
        (tests/test_poseidon_jax.py)."""
        if not cols:
            raise ValueError("hash_fixed needs at least one input")
        u = self.unroll
        xs = [field.to_mont(x, unroll=u) for x in cols]
        bsz = xs[0].shape[1:]
        iv0 = jnp.broadcast_to(jnp.asarray(self._iv)[:, 0:1],
                               (field.LIMBS, 1) + bsz)
        one = jnp.broadcast_to(jnp.asarray(self._one)[:, None],
                               (field.LIMBS, 1) + bsz)
        if len(xs) == 1:                    # single padded chunk [x, 1]
            st = jnp.concatenate([iv0, xs[0][:, None], one], axis=1)
            st = self.permute(st)
            return field.normalize(field.from_mont(st[:, 1], unroll=u))
        # first full chunk seeds words 1/2 directly (state starts at zero)
        st = jnp.concatenate([iv0, xs[0][:, None], xs[1][:, None]], axis=1)
        st = self.permute(st)
        i = 2
        while i + 2 <= len(xs):             # full RATE=2 chunks
            st = jnp.concatenate(
                [st[:, 0:1],
                 field.add_mod(st[:, 1:2], xs[i][:, None]),
                 field.add_mod(st[:, 2:3], xs[i + 1][:, None])],
                axis=1)
            st = self.permute(st)
            i += 2
        if i < len(xs):                     # trailing element + pad 1
            st = jnp.concatenate(
                [st[:, 0:1],
                 field.add_mod(st[:, 1:2], xs[i][:, None]),
                 field.add_mod(st[:, 2:3], one)], axis=1)
        else:                               # pad-only chunk [1]
            st = jnp.concatenate(
                [st[:, 0:1], field.add_mod(st[:, 1:2], one),
                 st[:, 2:3]], axis=1)
        st = self.permute(st)
        return field.normalize(field.from_mont(st[:, 1], unroll=u))


# Module-level default engine + jitted entry points.
_default_engine: Poseidon | None = None


def default_engine() -> Poseidon:
    global _default_engine
    if _default_engine is None:
        _default_engine = Poseidon()
    return _default_engine


@jax.jit
def hash2(a, b):
    return default_engine().hash2(a, b)


@jax.jit
def hash3(a, b, c):
    return default_engine().hash3(a, b, c)

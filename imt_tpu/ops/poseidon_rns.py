"""Batched Poseidon permutation over the RNS field core — the default engine.

Same sponge semantics and round schedule as poseidon_jax.py (and therefore
the same bit-exact outputs, enforced by tests), but the state lives as
f32[2n_channels, t, batch] RNS residues (field_rns.py) instead of uint32
limbs.  Rationale and exactness proofs: field_rns.py and rns_spec.py.

Per permutation: 8 full rounds (3 s-boxes) + 57 partial rounds (1 s-box),
each s-box x^5 = three Montgomery reductions, each MDS row one reduction
with the ARC add fused into the reduction's final mod — 438 reductions
total, each two bf16 dots + ~50 elementwise ops/channel.

Reference parity anchors: H(0,0,0) (reference src/indexed_merkle_tree.rs:247-251)
and the sponge discipline of pse-poseidon (2-input: src/utils.rs:46-47;
3-input: src/indexed_merkle_tree.rs:407-411), via the python-int oracle.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp

from .field import P
from . import field_rns
from .field_rns import RnsDeviceConsts, default_consts
from .poseidon_ref import generate_params


def _to_rns_mont_col(x: int, c: RnsDeviceConsts) -> np.ndarray:
    """Host: python int -> f32[2n] canonical residues of x*M1 mod p."""
    v = (x * c.spec.m1) % P
    return np.array([v % int(q) for q in c.spec.all_q()], dtype=np.float32)


@lru_cache(maxsize=None)
def _constants(t: int = 3):
    """RNS-Montgomery Poseidon constants: rc [rounds, 2n, t, 1],
    mds [2n, t, t, 1], iv0/one [2n]."""
    c = default_consts()
    params = generate_params()
    assert params.t == t
    n_rounds = params.n_rounds
    two_n = 2 * c.n
    rc = np.zeros((n_rounds, two_n, t, 1), dtype=np.float32)
    for r in range(n_rounds):
        for i in range(t):
            rc[r, :, i, 0] = _to_rns_mont_col(params.round_constants[r][i], c)
    mds = np.zeros((two_n, t, t, 1), dtype=np.float32)
    for i in range(t):
        for j in range(t):
            mds[:, i, j, 0] = _to_rns_mont_col(params.mds[i][j], c)
    iv0 = _to_rns_mont_col((1 << 64) % P, c)
    one = _to_rns_mont_col(1, c)
    return rc, mds, iv0, one, params.r_f, params.r_p


class PoseidonRns:
    """Batched RNS Poseidon engine (t=3, 8/57 — the reference spec)."""

    def __init__(self, consts: RnsDeviceConsts | None = None):
        self.c = consts or default_consts()
        self._rc, self._mds, self._iv0, self._one, self.r_f, self.r_p = \
            _constants()

    # -- internals ---------------------------------------------------------

    def _canon(self, st):
        return field_rns.mod_q(st, self.c.q_all, self.c.invq_all)

    def _sbox(self, x):
        """x^5 on quasi-canonical input (any trailing shape)."""
        x2 = field_rns.mul(x, x, consts=self.c)
        x4 = field_rns.mul(x2, x2, consts=self.c)
        return field_rns.mul(x4, x, consts=self.c)

    def _mds_round(self, st, rc_row):
        """MDS multiply + next-round ARC, one fused reduction per word.
        st: [2n, t, B] quasi-canonical; rc_row: [2n, t, 1]."""
        mds = jnp.asarray(self._mds)                 # [2n, t, t, 1]
        w = jnp.sum(mds * st[:, None, :, :], axis=2)  # [2n, t, B] < 2^24
        return field_rns.redc(w, rc=rc_row, consts=self.c)

    def permute(self, st):
        """One permutation.  st: f32[2n, t, B], channel values lazy < 2^13
        (absorb sums are fine); returns quasi-canonical state."""
        rc = jnp.asarray(self._rc)
        half = self.r_f // 2
        st = self._canon(st + rc[0])

        def full_body(s, rc_row):
            return self._mds_round(self._sbox(s), rc_row), None

        def partial_body(s, rc_row):
            x0 = self._sbox(s[:, 0:1, :])
            s = jnp.concatenate([x0, s[:, 1:, :]], axis=1)
            return self._mds_round(s, rc_row), None

        rc_tail = jnp.concatenate([rc[half + 1 + self.r_p:],
                                   jnp.zeros_like(rc[:1])])
        st, _ = jax.lax.scan(full_body, st, rc[1:half + 1])
        st, _ = jax.lax.scan(partial_body, st,
                             rc[half + 1:half + 1 + self.r_p])
        st, _ = jax.lax.scan(full_body, st, rc_tail)
        return st

    # -- public hashing API (canonical uint32 limbs in / out) --------------

    def _absorb2(self, a, b):
        xa = field_rns.from_limbs(a, self.c)
        xb = field_rns.from_limbs(b, self.c)
        iv = jnp.broadcast_to(jnp.asarray(self._iv0)[:, None, None],
                              xa.shape[:1] + (1,) + xa.shape[1:])
        return jnp.concatenate([iv, xa[:, None], xb[:, None]], axis=1)

    def hash2(self, a, b):
        """2-to-1 hash, canonical limbs uint32[16, B] -> uint32[16, B]."""
        st = self.permute(self._absorb2(a, b))
        one = jnp.asarray(self._one)[:, None]
        st = jnp.concatenate([st[:, 0:1], (st[:, 1] + one)[:, None],
                              st[:, 2:3]], axis=1)
        st = self.permute(st)
        return field_rns.to_limbs(st[:, 1], self.c)

    def hash3(self, a, b, c):
        """3-to-1 hash (indexed leaf), canonical limbs uint32[16, B]."""
        st = self.permute(self._absorb2(a, b))
        xc = field_rns.from_limbs(c, self.c)
        one = jnp.asarray(self._one)[:, None]
        st = jnp.concatenate([st[:, 0:1], (st[:, 1] + xc)[:, None],
                              (st[:, 2] + one)[:, None]], axis=1)
        st = self.permute(st)
        return field_rns.to_limbs(st[:, 1], self.c)

    # -- node-representation API (Montgomery residues f32[2n, B] in/out;
    #    the Merkle-level fast path — no limb conversions) ------------------

    def hash2_nodes(self, xa, xb):
        """2-to-1 hash on residue nodes f32[2n, B] -> f32[2n, B]."""
        iv = jnp.broadcast_to(jnp.asarray(self._iv0)[:, None, None],
                              xa.shape[:1] + (1,) + xa.shape[1:])
        st = self.permute(jnp.concatenate(
            [iv, xa[:, None], xb[:, None]], axis=1))
        one = jnp.asarray(self._one)[:, None]
        st = jnp.concatenate([st[:, 0:1], (st[:, 1] + one)[:, None],
                              st[:, 2:3]], axis=1)
        return self.permute(st)[:, 1]

    def hash3_leaf(self, a, b, c):
        """3-to-1 leaf hash: canonical limb inputs uint32[16, B],
        residue-node output f32[2n, B]."""
        st = self.permute(self._absorb2(a, b))
        xc = field_rns.from_limbs(c, self.c)
        one = jnp.asarray(self._one)[:, None]
        st = jnp.concatenate([st[:, 0:1], (st[:, 1] + xc)[:, None],
                              (st[:, 2] + one)[:, None]], axis=1)
        return self.permute(st)[:, 1]

    def hash_fixed(self, cols):
        """Arbitrary fixed-length hash — the halo2-base
        ``PoseidonHasher::hash_fix_len_array`` contract (reference
        src/indexed_merkle_tree.rs:92,:194; the sponge discipline of
        pse-poseidon: absorb RATE=2 chunks with a permutation per full
        chunk, pad the final chunk with a single 1 — SURVEY §2.2).

        cols: list of canonical limb arrays uint32[16, B] (length >= 1);
        returns uint32[16, B].  Lengths 2 and 3 match hash2/hash3."""
        if not cols:
            raise ValueError("hash_fixed needs at least one input")
        xs = [field_rns.from_limbs(x, self.c) for x in cols]
        b = xs[0].shape[-1:]
        iv = jnp.broadcast_to(jnp.asarray(self._iv0)[:, None, None],
                              xs[0].shape[:1] + (1,) + b)
        zero = jnp.zeros_like(xs[0])
        one = jnp.asarray(self._one)[:, None]

        # first full/partial chunk seeds the state directly
        w1 = xs[0]
        w2 = xs[1] if len(xs) >= 2 else zero
        st = jnp.concatenate([iv, w1[:, None], w2[:, None]], axis=1)
        i = 2
        if len(xs) == 1:                    # [x, 1] single padded chunk
            st = jnp.concatenate(
                [iv, w1[:, None], jnp.broadcast_to(
                    one[:, :, None], w2[:, None].shape)], axis=1)
            return field_rns.to_limbs(self.permute(st)[:, 1], self.c)
        st = self.permute(st)
        while i + 2 <= len(xs):             # full chunks
            st = jnp.concatenate(
                [st[:, 0:1], (st[:, 1] + xs[i])[:, None],
                 (st[:, 2] + xs[i + 1])[:, None]], axis=1)
            st = self.permute(st)
            i += 2
        if i < len(xs):                     # trailing element + pad 1
            st = jnp.concatenate(
                [st[:, 0:1], (st[:, 1] + xs[i])[:, None],
                 (st[:, 2] + one)[:, None]], axis=1)
        else:                               # pad-only chunk [1]
            st = jnp.concatenate(
                [st[:, 0:1], (st[:, 1] + one)[:, None], st[:, 2:3]], axis=1)
        st = self.permute(st)
        return field_rns.to_limbs(st[:, 1], self.c)


_default_engine: PoseidonRns | None = None


def default_engine() -> PoseidonRns:
    global _default_engine
    if _default_engine is None:
        _default_engine = PoseidonRns()
    return _default_engine


@jax.jit
def hash2(a, b):
    return default_engine().hash2(a, b)


@jax.jit
def hash3(a, b, c):
    return default_engine().hash3(a, b, c)


@jax.jit
def hash2_nodes(a, b):
    return default_engine().hash2_nodes(a, b)


@jax.jit
def hash3_leaf(a, b, c):
    return default_engine().hash3_leaf(a, b, c)


@jax.jit
def permute_bench(st):
    """Raw permutation entry for benchmarking: f32[2n, 3, B] -> same."""
    return default_engine().permute(st)

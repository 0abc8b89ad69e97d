"""Poseidon engine with matrix-unit linear layers and f32-digit arithmetic.

Execution plan (an engine kept for oracle diversity):

* S-box x^5: three f32-digit Montgomery multiplies per word (field_f32) —
  exact f32 schoolbook products + bf16 matmul reductions.
* MDS layer + round constant: ONE exact bf16 matmul computes all nine
  constant multiplications' digit-position sums at once
  ([B, 96] @ [96, 189]); the round constant (pre-multiplied by R so it
  survives the Montgomery reduction) is added to the position sums for
  free; one Montgomery reduction per output word finishes as a matmul.
* Rounds run under lax.scan (one compiled body per round type).

State: f32[32 digits, 3 words, B], Montgomery domain, < 2p.
Bit-exact with the reference-pinned spec: verified against the python-int
oracle and H(0,0,0) (reference src/indexed_merkle_tree.rs:247-251).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from . import field
from . import field_f32 as ff
from .poseidon_spec import PoseidonSpecArrays, default_spec


def _prep(spec: PoseidonSpecArrays):
    t = spec.t
    # MDS matmul weights: rows (j*32+v), cols (i*63+k); entry digit_{k-v}(M_ij)
    w = np.zeros((t * ff.DIGITS, t * (2 * ff.DIGITS - 1)), dtype=np.float32)
    for i in range(t):
        for j in range(t):
            m = field.limbs_to_int(spec.mds_mont[i, j])
            for v in range(ff.DIGITS):
                for d in range(ff.DIGITS):
                    dig = (m >> (ff.DBITS * d)) & ff.DMASK
                    if dig:
                        w[j * ff.DIGITS + v,
                          i * (2 * ff.DIGITS - 1) + v + d] = dig
    # round constants premultiplied by R, as 64-digit position constants:
    # rc_pos[r, :, i] = digits of rc_mont[r][i] * 2^256
    n = spec.r_f + spec.r_p
    rc_pos = np.zeros((n + 1, 2 * ff.DIGITS, t), dtype=np.float32)
    for r in range(n):
        for i in range(t):
            rc = field.limbs_to_int(spec.rc_mont[r, i])
            rc_pos[r, ff.DIGITS:, i] = ff.int_to_digits(rc)
    # plain Montgomery-form rc digits (for the pre-round ARC add)
    rc0 = np.stack([ff.int_to_digits(field.limbs_to_int(spec.rc_mont[0, i]))
                    for i in range(t)], axis=1)            # [32, t]
    iv0 = ff.int_to_digits(field.limbs_to_int(spec.iv_mont[0]))
    one_m = ff.int_to_digits(field.limbs_to_int(spec.one_mont))
    r2 = ff.int_to_digits(field.R2_MOD_P)
    one_std = ff.int_to_digits(1)
    return (jnp.asarray(w, jnp.bfloat16).astype(jnp.float32), jnp.asarray(rc_pos), jnp.asarray(rc0),
            jnp.asarray(iv0), jnp.asarray(one_m), jnp.asarray(r2),
            jnp.asarray(one_std))


class PoseidonMXU:
    """Drop-in engine with the same hash2/hash3 surface as poseidon_jax."""

    def __init__(self, spec: PoseidonSpecArrays | None = None):
        self.spec = spec or default_spec()
        (w_mds, self._rc_pos, self._rc0, self._iv0, self._one_m,
         self._r2, self._one_std) = _prep(self.spec)
        self._w_mds_t = jnp.asarray(np.asarray(w_mds).T, jnp.bfloat16)

    # -- internals -----------------------------------------------------------

    def _mds_arc(self, st, rc_pos_row):
        """st: [32, t, B] -> MDS * st + rc (Montgomery), via one bf16 matmul.
        rc_pos_row: [64, t] position constants (rc * R)."""
        t = self.spec.t
        b = st.shape[-1]
        npos = 2 * ff.DIGITS - 1
        # [32, t, B] -> [t*32, B] with row index (j*32 + v); the batch stays
        # on the lanes (leading-axis contraction, no batch relayout).
        x = jnp.reshape(jnp.transpose(st, (1, 0, 2)), (t * ff.DIGITS, b))
        pos = jax.lax.dot_general(
            self._w_mds_t, x.astype(jnp.bfloat16),
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)             # [t*63, B]
        pos = jnp.transpose(jnp.reshape(pos, (t, npos, b)), (1, 0, 2))
        # widen to 64 positions and add rc * R
        pos = jnp.concatenate(
            [pos, jnp.zeros((2 * ff.DIGITS - npos,) + pos.shape[1:],
                            jnp.float32)])
        pos = pos + rc_pos_row[:, :, None]
        # T < 3*(2p)^2 + p*R  ==>  T/R + p < 4.72p: two conditional 2p-folds
        return ff.mont_reduce(pos, extra=1)

    def _sbox(self, x):
        x2 = ff.mont_mul(x, x)
        x4 = ff.mont_mul(x2, x2)
        return ff.mont_mul(x4, x)

    def permute(self, st):
        """One permutation on [32, t, B] Montgomery digits (< 2p)."""
        spec = self.spec
        half = spec.r_f // 2
        rc_pos = self._rc_pos

        st = ff.add_mod(st, jnp.broadcast_to(
            self._rc0[:, :, None], st.shape))

        def full_body(s, rc_row):
            return self._mds_arc(self._sbox(s), rc_row), None

        def partial_body(s, rc_row):
            x0 = self._sbox(s[:, 0:1, :])
            s = jnp.concatenate([x0, s[:, 1:, :]], axis=1)
            return self._mds_arc(s, rc_row), None

        st, _ = jax.lax.scan(full_body, st, rc_pos[1:half + 1])
        st, _ = jax.lax.scan(partial_body, st,
                             rc_pos[half + 1:half + 1 + spec.r_p])
        st, _ = jax.lax.scan(full_body, st, rc_pos[half + 1 + spec.r_p:])
        return st

    # -- public hashing API (uint32 limb arrays in/out) -----------------------

    def _to_mont_digits(self, a):
        d = ff.limbs_to_digits(a)
        r2 = jnp.broadcast_to(self._r2[:, None], d.shape)
        return ff.mont_mul(d, r2)

    def _absorb2(self, a, b):
        bsz = a.shape[1:]
        iv = jnp.broadcast_to(self._iv0[:, None, None],
                              (ff.DIGITS, 1) + bsz)
        return jnp.concatenate([
            iv, self._to_mont_digits(a)[:, None], self._to_mont_digits(b)[:, None],
        ], axis=1)

    def _squeeze(self, st):
        out = ff.mont_mul(st[:, 1],
                          jnp.broadcast_to(self._one_std[:, None],
                                           st[:, 1].shape))
        return ff.digits_to_limbs(ff.normalize_final(out))

    def hash2(self, a, b):
        """Batched 2-to-1 hash, canonical uint32 limbs [16, B] in/out."""
        st = self._absorb2(a, b)
        st = self.permute(st)
        one = jnp.broadcast_to(self._one_m[:, None, None],
                               (ff.DIGITS, 1) + a.shape[1:])
        st = jnp.concatenate(
            [st[:, 0:1], ff.add_mod(st[:, 1:2], one), st[:, 2:3]], axis=1)
        st = self.permute(st)
        return self._squeeze(st)

    def hash3(self, a, b, c):
        """Batched 3-to-1 hash, canonical uint32 limbs [16, B] in/out."""
        st = self._absorb2(a, b)
        st = self.permute(st)
        one = jnp.broadcast_to(self._one_m[:, None, None],
                               (ff.DIGITS, 1) + a.shape[1:])
        st = jnp.concatenate(
            [st[:, 0:1],
             ff.add_mod(st[:, 1:2], self._to_mont_digits(c)[:, None]),
             ff.add_mod(st[:, 2:3], one)], axis=1)
        st = self.permute(st)
        return self._squeeze(st)

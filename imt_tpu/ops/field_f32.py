"""BN254 Fr arithmetic in float32 digit form with matrix-unit reductions.

Motivation: an accelerator whose vector unit emulates int32 multiply but
runs f32 FMA natively, and whose matrix unit (tensor cores on a GPU) sits
idle in a hash workload.  This module therefore represents a field element
as

    32 digits of 8 bits, held exactly in float32  (digit axis LEADING:
    f32[32, *batch], value = sum(d_k * 256^k), Montgomery domain, < 2p)

and implements multiplication as

    schoolbook product in f32 (exact: products <= 255^2, position sums of
    <= 96 terms < 2^23 < 2^24) followed by a Montgomery reduction whose two
    big multiplies are CONSTANT multiplications and therefore run as exact
    bf16 x bf16 -> f32 matmuls on the matrix unit / tensor cores:

        m     = (T * N') mod 2^256        ... T_digits @ W_nprime  (matmul)
        T'    = (T + m * N) / 2^256       ... m_digits @ W_n       (matmul)

    (N' = -N^{-1} mod 2^256.)  Carries are resolved with the same
    Kogge-Stone parallel prefix as the uint32 core, in f32.

Exactness argument, used throughout: every f32 value here is a nonnegative
integer < 2^24, every bf16 matmul input is an integer <= 255 (exact in bf16),
and every matmul accumulator sums at most 128 products of <= 255^2, staying
< 2^24 — all exactly representable.  There is no rounding anywhere.

This redesigns the reference's 4x64-bit Montgomery core (halo2curves
dependency, reference src/indexed_merkle_tree.rs:382-385): same field,
radically different decomposition chosen for a vector + matrix unit mix.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp

from .field import P, R, R2_MOD_P

DIGITS = 32           # 8-bit digits per element
DBITS = 8
DMASK = 255
TWO_P = 2 * P
# N' = -P^{-1} mod 2^256 (for the Montgomery m-step)
NPRIME = (-pow(P, -1, 1 << 256)) % (1 << 256)


def int_to_digits(x: int, n: int = DIGITS) -> np.ndarray:
    return np.array([(x >> (DBITS * k)) & DMASK for k in range(n)],
                    dtype=np.float32)


def digits_to_int(d) -> int:
    d = np.asarray(d)
    return sum(int(round(float(d[k]))) << (DBITS * k) for k in range(d.shape[0]))


# ---------------------------------------------------------------------------
# Constant matrices (host-built, baked into the jitted graphs as bf16)
# ---------------------------------------------------------------------------

def _conv_matrix(c: int, in_digits: int, out_digits: int) -> np.ndarray:
    """W[i, k] = digit_{k-i}(c): (x @ W) gives the digit-position sums of
    x * c for x given as in_digits digits."""
    cd = [(c >> (DBITS * k)) & DMASK for k in range(out_digits)]
    w = np.zeros((in_digits, out_digits), dtype=np.float32)
    for i in range(in_digits):
        for k in range(out_digits):
            j = k - i
            if 0 <= j < out_digits and (c >> (DBITS * j)) & DMASK:
                w[i, k] = (c >> (DBITS * j)) & DMASK
    return w


@lru_cache(maxsize=None)
def _reduction_mats():
    # Kept as numpy: converting to a device array here would leak a tracer if
    # first called inside a jit/scan trace.  Callers cast to bf16 per-use.
    # m = (T_low * N') mod 2^256: only output digits 0..31, inputs digits 0..31
    w_np = _conv_matrix(NPRIME, DIGITS, DIGITS)            # [32, 32]
    # m * N: full 64-digit product positions (N has 32 digits)
    w_n = np.zeros((DIGITS, 2 * DIGITS), dtype=np.float32)
    for i in range(DIGITS):
        for j in range(DIGITS):
            d = (P >> (DBITS * j)) & DMASK
            if d:
                w_n[i, i + j] = d
    return w_np, w_n


# ---------------------------------------------------------------------------
# Carry handling in f32 (digit axis leading)
# ---------------------------------------------------------------------------

def _shift_down(x, k: int):
    if k == 0:
        return x
    pad = jnp.zeros((k,) + x.shape[1:], x.dtype)
    return jnp.concatenate([pad, x[:-k]], axis=0)


def normalize_digits(t, out_digits: int):
    """Exact carry normalization: entries < 2^24 -> digits < 256.

    Local pass leaves x <= 255 + (2^24 >> 8) / ... ; pending carries are 0/1
    after the second local pass; a Kogge-Stone prefix finishes exactly."""
    k = t.shape[0]
    if out_digits > k:
        t = jnp.concatenate(
            [t, jnp.zeros((out_digits - k,) + t.shape[1:], t.dtype)])
    elif out_digits < k:
        t = t[:out_digits]
    k = out_digits

    inv = jnp.float32(1.0 / 256.0)
    # local pass 1: entries < 2^24 -> carry parts < 2^16
    hi = jnp.floor(t * inv)
    x = t - hi * 256.0 + _shift_down(hi, 1)        # <= 255 + 2^16
    # local pass 2: -> carry parts <= 257 -> x <= 255 + 257
    hi = jnp.floor(x * inv)
    x = x - hi * 256.0 + _shift_down(hi, 1)        # <= 255 + 257
    # local pass 3: -> carries 0/1
    hi = jnp.floor(x * inv)
    x = x - hi * 256.0 + _shift_down(hi, 1)        # <= 255 + 1 = 256
    g = x > 255.5                                   # generates (x == 256)
    p = x > 254.5                                   # propagates (x >= 255)
    p = p & ~g
    step = 1
    while step < k:
        g = g | (p & _shift_down(g, step))
        p = p & _shift_down(p, step)
        step <<= 1
    carry_in = _shift_down(g, 1).astype(jnp.float32)
    x = x + carry_in
    return x - jnp.floor(x * inv) * 256.0


def _borrow_lt(a, b):
    """Lexicographic a < b over digit arrays (leading digit axis)."""
    g = a < b
    p = a == b
    k = a.shape[0]
    step = 1
    while step < k:
        g = g | (p & _shift_down(g, step))
        p = p & _shift_down(p, step)
        step <<= 1
    return jnp.squeeze(jax.lax.slice_in_dim(g, k - 1, k, axis=0), axis=0)


def _cond_sub(t, modulus: int, width: int):
    """t (width digits, canonical) minus `modulus` where t >= modulus."""
    mod_d = jnp.asarray(int_to_digits(modulus, width))
    shape = (width,) + (1,) * (t.ndim - 1)
    ge = ~_borrow_lt(t, jnp.broadcast_to(jnp.reshape(mod_d, shape), t.shape))
    comp = jnp.asarray(int_to_digits((1 << (DBITS * width)) - modulus, width))
    diff = normalize_digits(
        t + jnp.reshape(comp, shape), width + 1)[:width]
    return jnp.where(ge[None], diff, t)


# ---------------------------------------------------------------------------
# Core ops: digit arrays f32[32, *batch], Montgomery domain, < 2p
# ---------------------------------------------------------------------------

def _conv_product(a, b):
    """Position sums of a*b: f32[63, ...], entries < 32*255^2 < 2^21.

    Schoolbook convolution as 32 roll-and-FMA steps: b is zero-padded to 63
    rows once, then rotated along the (sublane) digit axis — the wrapped tail
    is always inside the zero padding, so a roll IS a shift here.  Rolls on
    the leading axis are cheap sublane rotations and fuse far better than
    concat-built shifts."""
    n = DIGITS
    bp = jnp.concatenate(
        [b, jnp.zeros((n - 1,) + b.shape[1:], jnp.float32)], axis=0)  # [63,...]
    acc = a[0][None] * bp
    for i in range(1, n):
        acc = acc + a[i][None] * jnp.roll(bp, i, axis=0)
    return acc


def _matmul_digits(x, w):
    """x: f32[K, *batch] digits (<=255) -> position sums via a bf16 dot.

    Contracts the LEADING digit axis directly ([K_out, K] @ [K, ...]) so no
    transpose/relayout of the batch is ever needed; the batch stays on the
    lanes.  Exact by construction (see module docstring)."""
    wt = jnp.asarray(w.T, jnp.bfloat16)                     # [K_out, K]
    return jax.lax.dot_general(
        wt, x.astype(jnp.bfloat16),
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32)                  # [K_out, *batch]


def mont_reduce(t_pos, extra: int = 0):
    """Montgomery reduction of position sums t_pos (f32[63+, ...], entries
    < 2^23) -> digits f32[32, ...] of value (T * 2^-256) mod-ish p, < 2p for
    T < 4p^2, < (k+1)p then folded below 2p for T < k*4p^2 (pass extra
    cond-subtract rounds via `extra`)."""
    w_np, w_n = _reduction_mats()
    # exact low-half digits of T (for the m-step)
    t_low = normalize_digits(t_pos[:DIGITS], DIGITS)
    # carry out of the low half into position 32 (dropped in m, needed in T)
    # -> recompute from the true T: handled below by adding positions.
    m_pos = _matmul_digits(t_low, w_np)                     # [32, ...]
    m = normalize_digits(m_pos, DIGITS)                     # mod 2^256: top carry dropped
    mn_pos = _matmul_digits(m, w_n)                         # [64, ...]
    width = max(t_pos.shape[0], 2 * DIGITS)
    total = jnp.zeros((width,) + t_pos.shape[1:], jnp.float32)
    total = total.at[:t_pos.shape[0]].add(t_pos)
    total = total.at[:2 * DIGITS].add(mn_pos)
    # T + mN is divisible by 2^256; normalize fully, then take the high half.
    norm = normalize_digits(total, width + 4)
    hi = norm[DIGITS:]
    out = _cond_sub(hi, TWO_P, hi.shape[0])
    for _ in range(extra):
        out = _cond_sub(out, TWO_P, out.shape[0])
    return out[:DIGITS]


def mont_mul(a, b):
    """Montgomery product, digits in/out (< 2p)."""
    return mont_reduce(_conv_product(a, b))


def add_mod(a, b):
    s = normalize_digits(a + b, DIGITS + 1)
    return _cond_sub(s, TWO_P, DIGITS + 1)[:DIGITS]


def normalize_final(a):
    """< 2p -> canonical (< p)."""
    a = jnp.concatenate([a, jnp.zeros((1,) + a.shape[1:], a.dtype)])
    return _cond_sub(a, P, DIGITS + 1)[:DIGITS]


# ---------------------------------------------------------------------------
# Conversions to/from the uint32 16-bit-limb representation
# ---------------------------------------------------------------------------

def limbs_to_digits(limbs):
    """uint32[16, *batch] 16-bit limbs -> f32[32, *batch] 8-bit digits."""
    lo = (limbs & 0xFF).astype(jnp.float32)
    hi = ((limbs >> 8) & 0xFF).astype(jnp.float32)
    # interleave: digit 2k = lo_k, digit 2k+1 = hi_k
    stacked = jnp.stack([lo, hi], axis=1)           # [16, 2, ...]
    return jnp.reshape(stacked, (DIGITS,) + limbs.shape[1:])


def digits_to_limbs(d):
    """f32[32, *batch] digits (< 256, exact ints) -> uint32[16, *batch]."""
    di = d.astype(jnp.uint32)
    pairs = jnp.reshape(di, (16, 2) + d.shape[1:])
    return pairs[:, 0] + (pairs[:, 1] << 8)

"""BN254 Fr arithmetic in RNS (residue) form — the default engine's core.

Device-side implementation of the pipeline specified and modeled in
rns_spec.py.  A field element is f32[2n, *batch] (n=24 channels per RNS base,
channel axis LEADING so the batch is the minor, contiguous axis), value in Montgomery
domain (x*M1 mod p), each channel *quasi-canonical*: an integer in [0, q+2].

Key device facts this module is built on (all verified on host, see
rns_spec.py docstring + tools/validate_rns_mod.py):

* floor-mod  r = x - q*floor(x*invq)  with invq = nextafter(1/q, 0) is
  EXHAUSTIVELY PROVEN to land in [0, q+2] and never go negative for every
  integer x < 2^24 and every prime in the basis — so the hot loop contains
  no correction selects at all.
* Every f32 intermediate is a nonnegative integer < 2^24 (exact); every
  matmul input is an integer <= 255 (exact in bf16); every matmul
  accumulator stays < 2^24 (exact in f32).
* Each Montgomery reduction costs ~50 elementwise ops/channel plus two
  bf16 dots (matrix unit / tensor cores, f32 accumulation) of shape [3n+1, 2n] @ [2n, batch] — the Kawamura alpha estimate
  rides the dot as one extra lhs row (bf16 rounding of the 1/q row is
  within the proven 0.25 / 0.5-delta margins).

The reference implements this layer as 4x64-bit Montgomery in Rust
(halo2curves dep; modulus at reference src/indexed_merkle_tree.rs:382-385);
nothing here shares its structure — see rns_spec.py for the derivation.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp

from .field import P
from .rns_spec import RnsSpec, default_rns

F24 = 1 << 24


# ---------------------------------------------------------------------------
# Host-built device constant tables
# ---------------------------------------------------------------------------

def _split8(a: np.ndarray):
    """Integer matrix -> (hi, lo) 8-bit digit pair, both <= 255 (bf16-exact)."""
    a = a.astype(np.int64)
    return (a >> 8).astype(np.float32), (a & 255).astype(np.float32)


def _ext_lhs(a: np.ndarray, q_in: np.ndarray) -> np.ndarray:
    """Base-extension lhs [3n_out+1, n_in*2] in bf16-safe f32.

    Input layout (rhs rows): [s1 block (n_in), s0 block (n_in)] where
    sigma = 256*s1 + s0.  Output rows: S2 (scale 2^16), S1 (scale 2^8),
    S0 (scale 1), est (Kawamura sum of sigma/q)."""
    n_out, n_in = a.shape
    c1, c0 = _split8(a)
    lhs = np.zeros((3 * n_out + 1, 2 * n_in), dtype=np.float32)
    lhs[0:n_out, 0:n_in] = c1
    lhs[n_out:2 * n_out, 0:n_in] = c0
    lhs[n_out:2 * n_out, n_in:] = c1
    lhs[2 * n_out:3 * n_out, n_in:] = c0
    lhs[3 * n_out, 0:n_in] = 256.0 / q_in
    lhs[3 * n_out, n_in:] = 1.0 / q_in
    return lhs


def _col(v: np.ndarray) -> np.ndarray:
    return np.asarray(v, dtype=np.float32)[:, None]


class RnsDeviceConsts:
    """All device constant tables (numpy; jnp converts at trace time)."""

    def __init__(self, spec: RnsSpec | None = None):
        s = spec or default_rns()
        self.spec = s
        n = s.n
        self.n = n
        qall = s.all_q().astype(np.float64)
        self.q_all = _col(qall)                            # [2n, 1]
        self.invq_all = _col(np.nextafter(
            (1.0 / qall).astype(np.float32), np.float32(0.0)))
        self.k1 = _col(s.k1)
        self.c1 = _col(s.c1)
        self.c2 = _col(s.c2)
        self.e2 = _col(s.e2)
        self.neg_m1 = _col(s.neg_m1)
        self.neg_m2 = _col(s.neg_m2)
        self.c16_b2 = _col(np.array([(1 << 16) % int(q) for q in s.q2]))
        self.c16_b1 = _col(np.array([(1 << 16) % int(q) for q in s.q1]))
        self.ext1_lhs = _ext_lhs(s.a1, s.q1.astype(np.float64))
        self.ext2_lhs = _ext_lhs(s.a2, s.q2.astype(np.float64))
        # c2-fold: ext1 lhs digit blocks (and -M1) pre-scaled by c2 per
        # output channel, so redc's tau step consumes ext1's RAW tail and
        # ext1's final mod + the s_ext*c2 multiply disappear (value-exact
        # congruence; bound: w2*c1 + raw < 5.6M + 6.8M < 2^23.6).
        self.ext1_lhs_c2 = _ext_lhs((s.a1 * s.c2[:, None]) % s.q2[:, None],
                                    s.q1.astype(np.float64))
        self.neg_m1c2 = _col((s.neg_m1 * s.c2) % s.q2)

        # input conversion: canonical 8-bit digits -> w residues of
        # x * M1^2 mod p  (one redc away from Montgomery form)
        m1sq = pow(s.m1, 2, P)
        conv = np.array([[((1 << (8 * i)) * m1sq % P) % int(q)
                          for i in range(32)] for q in s.all_q()],
                        dtype=np.int64)                    # [2n, 32]
        i1, i0 = _split8(conv)
        self.in_lhs = np.concatenate([i1, i0], axis=0)     # [4n, 32]

        # CRT output: sigma = z_k * (M1/q_k)^{-1} mod q_k over B1, then
        # 8-bit position sums of sum_k sigma_k * (M1/q_k), alpha row fused.
        self.crt_sig = _col(np.array(
            [pow(s.m1 // int(q), -1, int(q)) for q in s.q1]))
        n_dig = (s.m1.bit_length() + 7) // 8               # 34 digits
        self.crt_digits = n_dig
        big = np.array([[(s.m1 // int(q) >> (8 * i)) & 255
                         for q in s.q1] for i in range(n_dig)],
                       dtype=np.float32)                   # [n_dig, n]
        est = (1.0 / s.q1.astype(np.float64)).astype(np.float32)[None]
        self.crt_lhs = np.concatenate([big, est], axis=0)  # [n_dig+1, n]
        # digits of alpha * (2^(8*(n_dig+1)) - M1): alpha <= n, table [n+1, n_dig+1]
        top = 1 << (8 * (n_dig + 1))
        self.crt_comp = np.array(
            [[((a * (top - s.m1)) >> (8 * i)) & 255 for i in range(n_dig + 1)]
             for a in range(n + 1)], dtype=np.float32)     # [n+1, n_dig+1]


@lru_cache(maxsize=None)
def default_consts() -> RnsDeviceConsts:
    return RnsDeviceConsts()


# ---------------------------------------------------------------------------
# Channel primitives
# ---------------------------------------------------------------------------

def _b(col, x):
    """Broadcast a [k, 1] host column against x's shape [k, *batch]."""
    return jnp.reshape(jnp.asarray(col), (x.shape[0],) + (1,) * (x.ndim - 1))


def mod_q(x, q_col, invq_col):
    """x (integer-valued f32 < 2^24, >= 0) -> quasi-canonical [0, q+2]."""
    q = _b(q_col, x)
    return x - q * jnp.floor(x * _b(invq_col, x))


def _dot(lhs_np, rhs):
    """Constant [R, C] @ rhs f32[C, *batch] -> f32[R, *batch] as a bf16 dot
    with f32 accumulation (explicit bf16 operands: TF32 never applies).

    rhs entries must be integers <= 256 (bf16-exact); lhs integer rows are
    <= 255, est rows are intentionally approximate (error margin proven)."""
    shape = rhs.shape
    r2 = jnp.reshape(rhs, (shape[0], -1)).astype(jnp.bfloat16)
    lhs = jnp.asarray(lhs_np, jnp.bfloat16)
    out = jax.lax.dot_general(lhs, r2, (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.float32)
    return jnp.reshape(out, (lhs_np.shape[0],) + shape[1:])


def _split_digits(sig):
    """sigma [0, q+2] -> (s1 <= 9, s0 <= 255), sigma = 256*s1 + s0."""
    s1 = jnp.floor(sig * (1.0 / 256.0))
    return s1, sig - 256.0 * s1


def _extend(sig, lhs_np, c16_col, q_col, invq_col, neg_m_col, delta: float,
            clamp: bool, rc=None, raw: bool = False):
    """One Kawamura base extension: sigma [n_in, *b] -> residues [n_out, *b].

    delta: alpha = floor(est + delta) (delta=-0.25 underestimates for ext1,
    +0.5 is exact for ext2).  clamp: max(alpha, 0) (ext1 only).
    rc (optional, broadcastable [n_out, ...]): fused ARC add before the
    final mod — pre-mod total < 2^23.8 and rc < 2^11.3, still exact f32.
    raw=True returns the pre-final-mod total (< 6.8M = 2^22.7) for callers
    that fold it into their own following mod (c2-folded ext1)."""
    s1, s0 = _split_digits(sig)
    out = _dot(lhs_np, jnp.concatenate([s1, s0], axis=0))
    n_out = (out.shape[0] - 1) // 3
    s2_blk, s1_blk, s0_blk, est = (out[:n_out], out[n_out:2 * n_out],
                                   out[2 * n_out:3 * n_out], out[3 * n_out])
    alpha = jnp.floor(est + delta)
    if clamp:
        alpha = jnp.maximum(alpha, 0.0)
    m1b = mod_q(s1_blk, q_col, invq_col)
    total = (s2_blk * _b(c16_col, s2_blk) + m1b * 256.0 + s0_blk
             + alpha[None] * _b(neg_m_col, s2_blk))
    if raw:
        return total
    if rc is not None:
        total = total + rc
    return mod_q(total, q_col, invq_col)


# ---------------------------------------------------------------------------
# Montgomery reduction + multiply
# ---------------------------------------------------------------------------

def redc(w, rc=None, consts: RnsDeviceConsts | None = None):
    """RNS Montgomery reduction.

    w: f32[2n, *batch], lazy channel values (integers < 2^24) of a value
    W < M1*p/64.  Returns quasi-canonical residues of W*M1^{-1} mod-ish p
    (value < 2.1p), in both bases.  If rc is given ([2n, 1] residue column of
    a Montgomery-domain round constant), it is added before the final mod —
    a free fused ARC add (bound: totals stay < 2^23.8 + q < 2^24)."""
    c = consts or default_consts()
    n = c.n
    wq = mod_q(w, c.q_all, c.invq_all)
    w1, w2 = wq[:n], wq[n:]

    # Kawamura digits of s = -W p^{-1} mod M1 (fold: npi * invE1)
    sig = mod_q(w1 * _b(c.k1, w1), c.q_all[:n], c.invq_all[:n])
    # c2-folded ext1: raw tail already carries the *c2 factor; its final
    # mod and the s_ext*c2 multiply ride tau's mod (see RnsDeviceConsts)
    s_raw = _extend(sig, c.ext1_lhs_c2, c.c16_b2, c.q_all[n:],
                    c.invq_all[n:], c.neg_m1c2, -0.25, clamp=True, raw=True)

    # tau = z * (M2/q)^{-1} mod q  where z = (W + s_ext*p)/M1
    t = w2 * _b(c.c1, w2) + s_raw
    tau = mod_q(t, c.q_all[n:], c.invq_all[n:])

    z2_raw = tau * _b(c.e2, tau)
    # ARC fused into ext2's final mod (B1 half) and z2's single mod (B2
    # half): saves one mod_q on n channels per redc-with-rc.
    z1 = _extend(tau, c.ext2_lhs, c.c16_b1, c.q_all[:n], c.invq_all[:n],
                 c.neg_m2, 0.5, clamp=False,
                 rc=None if rc is None else rc[:n])
    if rc is not None:
        # rc: jnp f32, shape broadcastable against w (e.g. [2n, t, 1]).
        z2_raw = z2_raw + rc[n:]
    z2 = mod_q(z2_raw, c.q_all[n:], c.invq_all[n:])
    return jnp.concatenate([z1, z2], axis=0)


def mul(x, y, rc=None, consts: RnsDeviceConsts | None = None):
    """Montgomery product of quasi-canonical residue arrays (values < 2.2p)."""
    return redc(x * y, rc=rc, consts=consts)


# ---------------------------------------------------------------------------
# Conversions: canonical uint32[16, *batch] limbs <-> RNS Montgomery
# ---------------------------------------------------------------------------

def from_limbs(limbs, consts: RnsDeviceConsts | None = None):
    """Canonical 16-bit limbs -> Montgomery-domain residues (< 2.1p)."""
    from .field_f32 import limbs_to_digits
    c = consts or default_consts()
    n = c.n
    d = limbs_to_digits(limbs)                       # f32[32, *batch] <= 255
    out = _dot(c.in_lhs, d)                          # [4n, *batch]
    s1b, s0b = out[:2 * n], out[2 * n:]
    m1b = mod_q(s1b, c.q_all, c.invq_all)
    w = mod_q(m1b * 256.0 + s0b, c.q_all, c.invq_all)
    return redc(w, consts=c)


def to_limbs(x, consts: RnsDeviceConsts | None = None):
    """Montgomery residues (value < 2.2p) -> canonical uint32 limbs (< p)."""
    from . import field
    from .field_f32 import normalize_digits, digits_to_limbs
    c = consts or default_consts()
    n = c.n
    nd = c.crt_digits
    z = redc(x, consts=c)                            # standard domain, < 2.1p
    sig = mod_q(z[:n] * _b(c.crt_sig, z[:n]), c.q_all[:n], c.invq_all[:n])
    s1, s0 = _split_digits(sig)
    pos0 = _dot(c.crt_lhs, s0)                       # [nd+1, *batch]
    pos1 = _dot(c.crt_lhs, s1)                       # shifted one byte up
    est = pos0[nd] + 256.0 * pos1[nd]
    alpha = jnp.floor(est + 0.5)                     # exact (z/M1 < 2^-12)
    # positions of sum sigma*(M1/q) + alpha*(2^(8*(nd+1)) - M1); the
    # alpha*2^(8*(nd+1)) part falls off the kept digit range, leaving z.
    comp = jnp.asarray(c.crt_comp)                   # [n+1, nd+1]
    comp_d = jnp.moveaxis(comp[alpha.astype(jnp.int32)], -1, 0)
    width = nd + 1
    pos = jnp.zeros((width,) + z.shape[1:], jnp.float32)
    pos = pos.at[:nd].add(pos0[:nd]).at[1:].add(pos1[:nd]).at[:].add(comp_d)
    digits = normalize_digits(pos, width)[:32]       # z < 2p fits 32 digits
    limbs = digits_to_limbs(digits)
    return field.normalize(limbs)                    # < 2p -> canonical < p

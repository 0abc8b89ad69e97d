"""RNS (residue number system) spec for BN254 Fr Montgomery arithmetic.

Host-side parameter generation + an exact pure-python reference model of the
RNS Montgomery pipeline.  The JAX device path (field_rns.py / poseidon_rns.py)
must agree with this model bit-for-bit; the model itself is property-tested
against plain python-int field arithmetic.

Why RNS (chosen for hardware whose vector unit emulates int32 multiply but
runs f32 FMA natively; whether it suits the GPU is ROADMAP Speed 1.2(d)):

* A field element becomes residues mod 2n small primes (~11.2 bits), so a
  variable*variable field multiply is ONE exact f32 multiply per channel
  instead of a ~2000-op CIOS limb convolution.
* The only cross-channel work is the pair of base extensions inside each
  Montgomery reduction (Bajard/Imbert/Kawamura RNS Montgomery).  Each
  extension is a constant-matrix multiply over the channel axis — a bf16
  matmul on the matrix unit / tensor cores, with the Kawamura alpha-estimate fused in as one extra lhs row.

This re-derives the capability of the reference's 4x64-bit Montgomery core
(halo2curves dependency; modulus quoted at reference
src/indexed_merkle_tree.rs:382-385) in a decomposition chosen for a
vector + matrix unit mix — it shares no structure with the Rust code.

Exactness rules (every device op must satisfy these; the model asserts them):

* every f32 intermediate is a nonnegative integer < 2^24;
* every bf16 matmul input is an integer <= 256 (exactly representable);
* every matmul accumulator sums products staying < 2^24;
* channel residues are *quasi-canonical*: in [0, q] (q, not q-1 — the
  floor-mod's one rare off-by-one is left uncorrected; all bounds budget q).

Prime ceiling: the MDS row sum 3*q^2 + q (three products of quasi-canonical
residues plus a round constant) must stay < 2^24  =>  q <= 2364.

Algorithm (one Montgomery reduction, value bounds in [.]):

  inputs X, Y < c*p (c ~ 2.01) as residues in both bases B1, B2
  w   = X*Y (or an MDS sum)                      [w < 3*c^2*p^2 + p]
  s'  = w * k1 mod q   (B1; k1 = -p^{-1}*(M1/q)^{-1})  -> Kawamura digits of
        s = -w*p^{-1} mod M1
  ext1: s_ext = s + beta*M1, beta in {0,1}       (alpha UNDER-estimated via
        floor(est - 1/4): never negative, never exceeds 2*M1)
  z   = (w + s_ext*p)/M1  exactly, computed per B2 channel as
        tau = (w*c1 + s_ext*c2) mod q  with  c1 = M1^{-1}*(M2/q)^{-1},
        c2 = p*M1^{-1}*(M2/q)^{-1}   (the (M2/q)^{-1} factor pre-folds the
        Kawamura digit for ext2);  z mod q = tau * (M2/q) mod q
        [z <= 3c^2 p^2/M1 + 2p < c*p]
  ext2: EXACT (alpha = floor(est + 1/2); exact because z/M2 < 2^-8 and the
        bf16 estimate error is < 0.1)            -> z's residues in B1

Montgomery domain: values are x*M1 mod p; all Poseidon constants are stored
pre-multiplied by M1.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from .field import P, LIMBS, LIMB_BITS

Q_MAX = 2364          # 3*q^2 + q < 2^24  (MDS row headroom)
N_PER_BASE = 24       # M1 ~ 2^267 >> 4p: ample Montgomery headroom
F24 = 1 << 24


def _primes_desc(limit: int, count: int) -> list[int]:
    """The `count` largest primes <= limit (deterministic sieve)."""
    sieve = np.ones(limit + 1, dtype=bool)
    sieve[:2] = False
    for i in range(2, int(limit ** 0.5) + 1):
        if sieve[i]:
            sieve[i * i::i] = False
    ps = np.nonzero(sieve)[0][::-1][:count]
    assert len(ps) == count
    return [int(q) for q in ps]


@dataclass
class RnsSpec:
    """All host-side constants.  Arrays indexed by channel: B1 channels are
    0..n-1, B2 channels n..2n-1 (device arrays hold both, axis 0)."""

    n: int
    q1: np.ndarray            # int64[n] primes of base 1
    q2: np.ndarray            # int64[n] primes of base 2
    m1: int                   # prod(q1)
    m2: int                   # prod(q2)
    # per-channel fold constants (int64[n] each)
    k1: np.ndarray            # B1: -p^{-1} * (M1/q)^{-1} mod q
    c1: np.ndarray            # B2: M1^{-1} * (M2/q)^{-1} mod q
    c2: np.ndarray            # B2: p * M1^{-1} * (M2/q)^{-1} mod q
    e2: np.ndarray            # B2: (M2/q) mod q  (tau -> z)
    # extension matrices (int64[n_out, n_in]) and -M mod q vectors
    a1: np.ndarray            # [j in B2, k in B1]: (M1/q_k) mod q_j
    neg_m1: np.ndarray        # B2: (-M1) mod q_j
    a2: np.ndarray            # [k in B1, j in B2]: (M2/q_j) mod q_k
    neg_m2: np.ndarray        # B1: (-M2) mod q_k

    def all_q(self) -> np.ndarray:
        return np.concatenate([self.q1, self.q2])


@lru_cache(maxsize=None)
def default_rns() -> RnsSpec:
    ps = _primes_desc(Q_MAX, 2 * N_PER_BASE)
    q1 = np.array(ps[0::2], dtype=np.int64)   # interleave: M1 ~ M2
    q2 = np.array(ps[1::2], dtype=np.int64)
    n = N_PER_BASE
    m1 = 1
    for q in q1:
        m1 *= int(q)
    m2 = 1
    for q in q2:
        m2 *= int(q)
    assert m1 > 256 * P and m2 > 256 * P   # K1 >= 2^8 for the bound analysis

    m1_inv_p = [pow(m1 // int(q), -1, int(q)) for q in q1]   # (M1/q)^-1 mod q
    m2_inv_p = [pow(m2 // int(q), -1, int(q)) for q in q2]
    k1 = np.array([((-pow(P, -1, int(q))) * inv) % int(q)
                   for q, inv in zip(q1, m1_inv_p)], dtype=np.int64)
    c1 = np.array([(pow(m1, -1, int(q)) * inv) % int(q)
                   for q, inv in zip(q2, m2_inv_p)], dtype=np.int64)
    c2 = np.array([(P * pow(m1, -1, int(q)) * inv) % int(q)
                   for q, inv in zip(q2, m2_inv_p)], dtype=np.int64)
    e2 = np.array([(m2 // int(q)) % int(q) for q in q2], dtype=np.int64)
    a1 = np.array([[(m1 // int(qk)) % int(qj) for qk in q1] for qj in q2],
                  dtype=np.int64)
    neg_m1 = np.array([(-m1) % int(q) for q in q2], dtype=np.int64)
    a2 = np.array([[(m2 // int(qj)) % int(qk) for qj in q2] for qk in q1],
                  dtype=np.int64)
    neg_m2 = np.array([(-m2) % int(q) for q in q1], dtype=np.int64)
    return RnsSpec(n=n, q1=q1, q2=q2, m1=m1, m2=m2, k1=k1, c1=c1, c2=c2,
                   e2=e2, a1=a1, neg_m1=neg_m1, a2=a2, neg_m2=neg_m2)


# ---------------------------------------------------------------------------
# Exact host model (python ints / int64 numpy).  Mirrors the device pipeline
# op-for-op, including the f32 alpha estimates (simulated in float64 with the
# bf16 constant rounding applied), and asserts every intermediate bound the
# f32/bf16 device path relies on.
# ---------------------------------------------------------------------------

def _bf16(x: np.ndarray) -> np.ndarray:
    """Round float64 array to bf16 precision (for simulating the est rows)."""
    f = np.asarray(x, dtype=np.float32)
    u = f.view(np.uint32)
    rounded = ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).view(np.float32)
    return rounded.astype(np.float64)


class RnsModel:
    """Reference model.  Values are integer residue vectors int64[2n]
    (quasi-canonical, in [0, q]); `int_value` recovers the represented
    integer by CRT over B1*B2 (for assertions only)."""

    def __init__(self, spec: RnsSpec | None = None):
        self.s = spec or default_rns()
        s = self.s
        self.qall = s.all_q()
        self.m12 = s.m1 * s.m2
        self._crt = [
            (self.m12 // int(q)) * pow(self.m12 // int(q), -1, int(q)) % self.m12
            for q in self.qall]

    # -- conversions --------------------------------------------------------

    def to_rns(self, x: int) -> np.ndarray:
        assert 0 <= x < self.m12
        return np.array([x % int(q) for q in self.qall], dtype=np.int64)

    def int_value(self, r: np.ndarray) -> int:
        acc = 0
        for rk, ck in zip(r, self._crt):
            acc = (acc + int(rk) * ck) % self.m12
        return acc

    # -- pipeline steps (each asserts its device-exactness bounds) ----------

    def mul_channels(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        """Channelwise product (the w of a plain multiply).  Lazy (< 2^24)."""
        w = x * y
        assert (w < F24).all(), "channel product overflows f32"
        return w

    def mod_channels(self, w: np.ndarray) -> np.ndarray:
        """Quasi-canonical reduction, w < 2^24 -> [0, q]."""
        assert (0 <= w).all() and (w < F24).all()
        return w % self.qall

    def redc(self, w: np.ndarray, int_bound: int) -> np.ndarray:
        """RNS Montgomery reduction of the (lazy) channel values w.

        int_bound: caller's bound on the represented integer W; asserts
        W < M1*p/64 so z = W/M1 + 2p stays < 2.1p."""
        s = self.s
        n = s.n
        assert int_bound < s.m1 * P // 64
        w_can = self.mod_channels(w)
        w1, w2 = w_can[:n], w_can[n:]

        # Kawamura digits of s1 = -W p^{-1} mod M1
        sig = self.mul_channels(w1, s.k1) % s.q1          # [0, q)
        # ext1 (underestimating): s_ext = s1 + beta*M1, beta in {0,1}
        est = float(np.sum(_bf16(256.0 / s.q1) * (sig >> 8)
                           + _bf16(1.0 / s.q1) * (sig & 255)))
        alpha = max(int(np.floor(est - 0.25)), 0)
        assert 0 <= alpha <= n
        s_ext = (s.a1 @ sig + alpha * s.neg_m1) % s.q2
        s_int = sum(int(x) * (s.m1 // int(q)) for x, q in zip(sig, s.q1))
        s_int -= alpha * s.m1
        assert 0 <= s_int < 2 * s.m1, "ext1 out of [0, 2*M1)"
        for j, q in enumerate(s.q2):
            assert s_ext[j] == s_int % int(q)

        # tau = z * (M2/q)^{-1} mod q, z = (W + s_ext*p)/M1
        t = self.mul_channels(w2, s.c1) + self.mul_channels(s_ext, s.c2)
        assert (t < F24).all()
        tau = t % s.q2
        z2 = self.mul_channels(tau, s.e2) % s.q2           # z mod q, B2

        # ext2 (exact)
        est2 = float(np.sum(_bf16(256.0 / s.q2) * (tau >> 8)
                            + _bf16(1.0 / s.q2) * (tau & 255)))
        alpha2 = int(np.floor(est2 + 0.5))
        z1 = (s.a2 @ tau + alpha2 * s.neg_m2) % s.q1

        # ground-truth check: z is exactly (W + s_int*p) / M1
        w_int = self.int_value(np.concatenate([w1, w2]))
        z_int = sum(int(x) * (s.m2 // int(q)) for x, q in zip(tau, s.q2))
        z_int -= alpha2 * s.m2
        assert z_int * s.m1 == w_int + s_int * P, "redc not exact"
        assert 0 <= z_int < int_bound // s.m1 + 2 * P + 1, "z bound"
        for k, q in enumerate(s.q1):
            assert z1[k] == z_int % int(q), "ext2 not exact"
        return np.concatenate([z1, z2])

    # -- field-level ops ----------------------------------------------------

    def mont_mul(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        """x, y residues of values < 2.1p -> residues of x*y*M1^{-1} mod-ish p
        (< 2.1p)."""
        bound = (21 * P // 10 + 1) ** 2
        return self.redc(self.mul_channels(x, y), bound)

    def to_mont(self, x: int) -> np.ndarray:
        """Canonical int -> Montgomery-domain residues (x*M1 mod p, < 2.1p)."""
        r = self.to_rns((x * pow(self.s.m1, 2, P)) % P)
        return self.redc(r, P)

    def from_mont(self, x: np.ndarray) -> int:
        """Montgomery residues (< 2.1p) -> canonical python int."""
        one = self.to_rns(1)
        z = self.redc(self.mul_channels(x, one), 3 * P)
        return self.int_value(z) % P

"""Optimized-spec Poseidon partial rounds (host-side derivation).

The reference's in-circuit hasher uses halo2-base's ``OptimizedPoseidonSpec``
(SURVEY §2.2): the 57 partial rounds are restructured so each applies the
S-box to word 0 only, adds a SCALAR constant to word 0 only, and multiplies
by a SPARSE matrix  Msp = [[m00, v1, v2], [w1, 1, 0], [w2, 0, 1]]  — with a
one-time dense correction folded into the preceding full round.  This module
derives that form from the standard parameters and PROVES it equivalent
(tests/test_poseidon_opt.py asserts permute_opt == permute on random states
and the H(0,0,0) anchor).

Derivation (all mod p, t=3; e0 = word-0 unit vector, S_0(y) = y + e0·(y0^5
- y0) the partial S-box):

* Constants: a partial round is x -> M·S_0(x + c).  Split c = c0·e0 + c~
  (c~ zero in word 0); S_0(x + c) = S_0(x + c0 e0) + c~, so
  M·S_0(x + c) = M·S_0(x + c0 e0) + M·c~ — the tail M·c~ merges into the
  NEXT round's constant.  Iterating forward leaves every partial round a
  scalar constant and spills the accumulated tail into the first trailing
  full round.
* Matrices: write M = [[m00, v], [w, M_hat]] (M_hat the lower-right 2x2).
  Then M = Msp · Mpre with  Msp = [[m00, v·M_hat^{-1}], [w, I]]  and
  Mpre = diag(1, M_hat).  Mpre commutes with S_0 and with scalar-constant
  addition (both touch disjoint words), so iterating BACKWARD over the
  partial chain — factor the current accumulated matrix, absorb its Mpre
  into the previous round's matrix (left-multiply) — yields per-round
  sparse matrices and one leftover dense Mpre folded into the MDS of the
  last leading full round.

A fused permutation can additionally keep the two column words UNREDUCED
for g rounds at a time (permute_opt_lazy models that schedule)
(their updates are w_i·S + x_i — constant times reduced S-box output, so
the represented integers grow only additively) and expands row 0's
consumption of the stale columns into combined coefficients
cc[d][j] = v1_d·w1_j + v2_d·w2_j over the period's S-box outputs.
"""

from __future__ import annotations

from dataclasses import dataclass

from .grain import P
from .poseidon_ref import PoseidonParams


def _inv2x2(m):
    ((a, b), (c, d)) = m
    det = (a * d - b * c) % P
    di = pow(det, -1, P)
    return (((d * di) % P, (-b * di) % P),
            ((-c * di) % P, (a * di) % P))


def _matmul(a, b, n):
    return tuple(tuple(sum(a[i][k] * b[k][j] for k in range(n)) % P
                       for j in range(n)) for i in range(n))


def _matvec(m, v, n):
    return tuple(sum(m[i][j] * v[j] for j in range(n)) % P for i in range(n))


@dataclass(frozen=True)
class OptPoseidonParams:
    """Optimized round structure for t=3, R_F full + R_P partial rounds.

    pre_rounds:  R_F/2 rows of 3 constants (standard leading full rounds;
                 the FIRST trailing row sits in post_rounds[0]).
    mds:         the standard dense MDS (full rounds).
    mds_last_pre: Mpre-folded MDS used by the LAST leading full round.
    partial_c0:  R_P scalar constants (word 0, pre-S-box).
    sparse:      R_P rows (m00, v1, v2, w1, w2).
    post_rounds: R_F/2 rows of 3 constants (trailing full rounds; row 0
                 includes the constant tail spilled out of the partials).
    """
    t: int
    r_f: int
    r_p: int
    pre_rounds: tuple
    mds: tuple
    mds_last_pre: tuple
    partial_c0: tuple
    sparse: tuple
    post_rounds: tuple


def optimize_params(params: PoseidonParams) -> OptPoseidonParams:
    assert params.t == 3, "derivation below is specialized to t=3"
    t, r_f, r_p = params.t, params.r_f, params.r_p
    half = r_f // 2
    M = params.mds
    rc = params.round_constants

    # ---- constants: forward pass over the partial rounds ------------------
    partial_c0 = []
    carry = (0, 0, 0)
    for r in range(half, half + r_p):
        c_eff = tuple((rc[r][i] + carry[i]) % P for i in range(t))
        partial_c0.append(c_eff[0])
        tail = (0, c_eff[1], c_eff[2])
        carry = _matvec(M, tail, t)
    first_post = tuple((rc[half + r_p][i] + carry[i]) % P for i in range(t))

    # ---- matrices: backward factoring pass --------------------------------
    sparse = [None] * r_p
    m_acc = M
    for ri in range(r_p - 1, -1, -1):
        m00 = m_acc[0][0]
        v = (m_acc[0][1], m_acc[0][2])
        w = (m_acc[1][0], m_acc[2][0])
        m_hat = ((m_acc[1][1], m_acc[1][2]), (m_acc[2][1], m_acc[2][2]))
        m_hat_inv = _inv2x2(m_hat)
        v_hat = ((v[0] * m_hat_inv[0][0] + v[1] * m_hat_inv[1][0]) % P,
                 (v[0] * m_hat_inv[0][1] + v[1] * m_hat_inv[1][1]) % P)
        sparse[ri] = (m00, v_hat[0], v_hat[1], w[0], w[1])
        mpre = ((1, 0, 0),
                (0, m_hat[0][0], m_hat[0][1]),
                (0, m_hat[1][0], m_hat[1][1]))
        if ri > 0:
            m_acc = _matmul(mpre, M, t)
        else:
            mds_last_pre = _matmul(mpre, M, t)

    pre = tuple(tuple(rc[r]) for r in range(half))
    post = (first_post,) + tuple(
        tuple(rc[r]) for r in range(half + r_p + 1, r_f + r_p))
    return OptPoseidonParams(
        t=t, r_f=r_f, r_p=r_p,
        pre_rounds=pre, mds=tuple(tuple(row) for row in M),
        mds_last_pre=mds_last_pre,
        partial_c0=tuple(partial_c0), sparse=tuple(sparse),
        post_rounds=post)


def permute_opt(state, opt: OptPoseidonParams):
    """Optimized-structure permutation over python ints — must equal
    poseidon_ref.permute bit-for-bit (tests/test_poseidon_opt.py)."""
    t = opt.t
    half = opt.r_f // 2
    x = list(state)

    def full(x, c, mds):
        y = [pow((x[i] + c[i]) % P, 5, P) for i in range(t)]
        return [sum(mds[i][j] * y[j] for j in range(t)) % P for i in range(t)]

    for r in range(half):
        mds = opt.mds_last_pre if r == half - 1 else opt.mds
        x = full(x, opt.pre_rounds[r], mds)
    for ri in range(opt.r_p):
        m00, v1, v2, w1, w2 = opt.sparse[ri]
        s = pow((x[0] + opt.partial_c0[ri]) % P, 5, P)
        x = [(m00 * s + v1 * x[1] + v2 * x[2]) % P,
             (w1 * s + x[1]) % P,
             (w2 * s + x[2]) % P]
    for r in range(half):
        x = full(x, opt.post_rounds[r], opt.mds)
    return x


def permute_opt_lazy(state, opt: OptPoseidonParams, g: int):
    """The KERNEL'S schedule over python ints: columns refreshed every g
    rounds, row 0 consuming stale columns via the combined coefficients
    cc[d][j] = v1_{b+d}·w1_{b+j} + v2_{b+d}·w2_{b+j}.  Algebraically
    identical to permute_opt (asserted in tests) — the reference for a
    fused permutation's period structure (ROADMAP Speed 1.2(b))."""
    t = opt.t
    half = opt.r_f // 2
    x = list(state)

    def full(x, c, mds):
        y = [pow((x[i] + c[i]) % P, 5, P) for i in range(t)]
        return [sum(mds[i][j] * y[j] for j in range(t)) % P for i in range(t)]

    for r in range(half):
        mds = opt.mds_last_pre if r == half - 1 else opt.mds
        x = full(x, opt.pre_rounds[r], mds)

    x0, x1r, x2r = x
    ri = 0
    while ri < opt.r_p:
        glen = min(g, opt.r_p - ri)
        svals = []
        for d in range(glen):
            r = ri + d
            m00, v1, v2, _, _ = opt.sparse[r]
            s = pow((x0 + opt.partial_c0[r]) % P, 5, P)
            svals.append(s)
            acc = (m00 * s + v1 * x1r + v2 * x2r) % P
            for j in range(d):
                w1j, w2j = opt.sparse[ri + j][3], opt.sparse[ri + j][4]
                cc = (v1 * w1j + v2 * w2j) % P
                acc = (acc + cc * svals[j]) % P
            x0 = acc
        # boundary refresh: columns catch up on the whole period
        for d in range(glen):
            w1d, w2d = opt.sparse[ri + d][3], opt.sparse[ri + d][4]
            x1r = (x1r + w1d * svals[d]) % P
            x2r = (x2r + w2d * svals[d]) % P
        ri += glen

    x = [x0, x1r, x2r]
    for r in range(half):
        x = full(x, opt.post_rounds[r], opt.mds)
    return x

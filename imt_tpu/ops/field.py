"""BN254 scalar-field (Fr) arithmetic as limb-decomposed JAX ops.

Design (data-parallel, not a port):

* A field element is 16 limbs of 16 bits held in ``uint32``.  The limb axis is
  the *leading* axis — device arrays are ``uint32[16, *batch]`` — so that the
  batch is the minor, contiguous axis.  All ops are elementwise over the
  batch; there is no scalar loop over batch anywhere.

* Montgomery arithmetic with R = 2^256, word radix 2^16 (CIOS with lazy
  carries).  ``mont_mul`` keeps the invariant: inputs/outputs are < 2p with
  all limbs < 2^16.  Full canonical reduction (< p) happens only at
  boundaries (hash outputs, comparisons, export).

* The reference implements this layer in Rust via halo2curves' 4x64-bit
  Montgomery form (reference Cargo.toml:14, src/indexed_merkle_tree.rs:382-385
  quotes the modulus).  The 16-bit radix keeps every product inside one
  ``uint32`` (16-bit limb products are exact) on hardware without a fast
  64-bit multiply.

Why < 2p ("incomplete") representation: with p < 2^254 and R = 2^256 we have
4p < R, so CIOS on inputs < 2p yields outputs < 2p without a final
conditional subtraction — one compare/select per multiply saved in the hot
loop.  (Standard redundant-Montgomery argument.)
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

# BN254 scalar field modulus r (reference src/indexed_merkle_tree.rs:382-385).
P = 21888242871839275222246405745257275088548364400416034343698204186575808495617

LIMBS = 16
LIMB_BITS = 16
MASK = (1 << LIMB_BITS) - 1
R = 1 << (LIMBS * LIMB_BITS)  # Montgomery radix 2^256
R_MOD_P = R % P
R2_MOD_P = (R * R) % P
# -p^{-1} mod 2^16 for the CIOS inner reduction step.
N0_INV = (-pow(P, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
TWO_P = 2 * P


def _int_to_limbs_list(x: int, n: int = LIMBS) -> list[int]:
    return [(x >> (LIMB_BITS * i)) & MASK for i in range(n)]


# Host-side constant limb tables (become XLA constants when closed over).
P_LIMBS = np.array(_int_to_limbs_list(P), dtype=np.uint32)
TWO_P_LIMBS_17 = np.array(_int_to_limbs_list(TWO_P, 17), dtype=np.uint32)
# 2^272 - 2p, for branch-free conditional subtraction on 17-limb values.
NEG_TWO_P_17 = np.array(_int_to_limbs_list((1 << 272) - TWO_P, 17), dtype=np.uint32)


# ---------------------------------------------------------------------------
# Host <-> device conversions (python ints <-> limb arrays)
# ---------------------------------------------------------------------------

def int_to_limbs(x: int) -> np.ndarray:
    """One python int -> uint32[16] (standard, non-Montgomery form)."""
    x %= P
    return np.array(_int_to_limbs_list(x), dtype=np.uint32)

def ints_to_limbs(xs) -> np.ndarray:
    """Iterable of python ints -> uint32[16, N] (limb-major batch)."""
    out = np.zeros((LIMBS, len(xs)), dtype=np.uint32)
    for j, x in enumerate(xs):
        out[:, j] = int_to_limbs(x)
    return out

def random_limbs(seed: int, k: int, bits: int = 253) -> np.ndarray:
    """uint32[16, K] of uniform random nonzero values < 2^bits (< p), packed
    directly with numpy — bench/tool batch generation without the per-value
    python-bigint path (ints_to_limbs costs ~1.5 ms/value; this is ~1 µs)."""
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 1 << LIMB_BITS, (LIMBS, k), dtype=np.uint32)
    top, rem = divmod(bits, LIMB_BITS)
    out[top + 1:] = 0
    if rem:
        out[top] &= (1 << rem) - 1
    else:
        out[top] = 0
    # nonzero (zero is the list sentinel, rejected): patch only all-zero
    # columns so the distribution over nonzero values stays uniform
    allz = ~out.any(axis=0)
    out[0, allz] = 1
    return out


def limbs_to_int(a) -> int:
    """uint32[16] -> python int."""
    a = np.asarray(a)
    return sum(int(a[i]) << (LIMB_BITS * i) for i in range(LIMBS))

def limbs_to_ints(a) -> list[int]:
    """uint32[16, N] -> list of python ints."""
    a = np.asarray(a)
    return [sum(int(a[i, j]) << (LIMB_BITS * i) for i in range(LIMBS))
            for j in range(a.shape[1])]

def int_to_mont_limbs(x: int) -> np.ndarray:
    return int_to_limbs((x * R) % P)


# ---------------------------------------------------------------------------
# Constant columns ([K, 1]-shaped, broadcast against [K, *batch] limb arrays)
# ---------------------------------------------------------------------------

def _np_col(vals, n):
    return np.array(_int_to_limbs_list(vals, n), dtype=np.uint32)[:, None]


_P_COL = _np_col(P, LIMBS)                           # modulus limbs
_NEG_TWO_P17 = _np_col((1 << 272) - TWO_P, 17)       # 2^272 - 2p
_TWO_P17 = _np_col(TWO_P, 17)
_P17 = _np_col(P, 17)
_NEG_P17 = _np_col((1 << 272) - P, 17)               # 2^272 - p
_R2_COL = _np_col(R2_MOD_P, LIMBS)                   # R^2 mod p, standard form
_ONE_COL = _np_col(1, LIMBS)


# ---------------------------------------------------------------------------
# Carry handling
# ---------------------------------------------------------------------------

def _shift_down(x, k: int):
    """Shift limb rows toward higher indices by k (zeros fill): out[j] = x[j-k]."""
    if k == 0:
        return x
    pad = jnp.zeros((k,) + x.shape[1:], x.dtype)
    return jnp.concatenate([pad, x[:-k]], axis=0)


def _propagate(t, out_limbs: int):
    """Exact carry propagation of a lazy limb array — fully parallel.

    t: uint32[K, ...] with entries < 2^23 interpreted as sum(t[j] * 2^16j).
    Returns uint32[out_limbs, ...] with entries < 2^16.  The true value must
    fit in out_limbs limbs.

    One local combine pass leaves digits x_j <= 2^16 + 127 whose pending
    carries are 0/1; a Kogge-Stone prefix over (generate, propagate) bits
    resolves them exactly in ceil(log2(K)) vector steps — no scan, no
    sequential limb walk (the data-parallel replacement for the carry loop a
    CPU bignum would use).
    """
    k = t.shape[0]
    if out_limbs > k:
        t = jnp.concatenate(
            [t, jnp.zeros((out_limbs - k,) + t.shape[1:], t.dtype)])
    elif out_limbs < k:
        t = t[:out_limbs]
    k = out_limbs

    # Local pass: entries < 2^23 ==> carried-up parts < 2^7, x <= 2^16 + 127.
    x = (t & MASK) + _shift_down(t >> LIMB_BITS, 1)
    g = x >> LIMB_BITS                         # 1 iff position generates a carry
    p = ((x & MASK) == MASK).astype(x.dtype)   # propagates an incoming carry
    # Kogge-Stone prefix: G[j] = "carry out of the prefix ending at j".
    step = 1
    while step < k:
        g = g | (p & _shift_down(g, step))
        p = p & _shift_down(p, step)
        step <<= 1
    carry_in = _shift_down(g, 1)
    return (x + carry_in) & MASK


def _borrow_lt(a, b):
    """Lexicographic a < b via a parallel borrow chain (Kogge-Stone over
    generate = a_j < b_j, propagate = a_j == b_j).  Pure elementwise ops +
    static shifts — no gathers, no scans; equal values -> False."""
    g = a < b
    p = a == b
    step = 1
    k = a.shape[0]
    while step < k:
        g = g | (p & _shift_down(g, step))
        p = p & _shift_down(p, step)
        step <<= 1
    # static slice + squeeze of the last prefix row
    return jnp.squeeze(jax.lax.slice_in_dim(g, k - 1, k, axis=0), axis=0)


def _ge_col(a, b_col):
    """Lexicographic a >= b; b is a broadcastable [K, 1...] column."""
    bvec = jnp.broadcast_to(
        jnp.reshape(b_col, (a.shape[0],) + (1,) * (a.ndim - 1)), a.shape)
    return ~_borrow_lt(a, bvec)


def _cond_sub_2p(t17):
    """t (17 canonical limbs, value < 4p) -> value mod-2p-folded (< 2p), 16 limbs."""
    ge = _ge_col(t17, _TWO_P17)
    neg = jnp.reshape(_NEG_TWO_P17, (17,) + (1,) * (t17.ndim - 1))
    diff = _propagate(t17 + neg, 17)
    # diff = t - 2p + 2^272; when ge, the 2^272 bit (limb 17) is dropped by
    # taking only 17 limbs and masking the top limb's overflow.
    sel = jnp.where(ge[None], diff, t17)
    return sel[:LIMBS]


# ---------------------------------------------------------------------------
# Core modular ops.  All arrays are uint32[16, *batch], value < 2p.
# ---------------------------------------------------------------------------

def _cios_body(b, n, zero_row):
    """CIOS iteration closure: fold one limb of `a` into the accumulator."""

    def body(t, ai):
        prod = ai[None] * b                                  # [16, ...] exact
        t = t + jnp.concatenate([prod & MASK, zero_row]) \
              + jnp.concatenate([zero_row, prod >> LIMB_BITS])
        m = ((t[0] & MASK) * N0_INV) & MASK                  # [...]
        q = m[None] * n                                      # [16, ...] exact
        t = t + jnp.concatenate([q & MASK, zero_row]) \
              + jnp.concatenate([zero_row, q >> LIMB_BITS])
        # t[0] is now divisible by 2^16: shift one limb down.
        t = jnp.concatenate([(t[1] + (t[0] >> LIMB_BITS))[None], t[2:], zero_row])
        return t, None

    return body


def mont_mul(a, b, unroll: bool = False):
    """Montgomery product a*b*R^{-1} mod p (CIOS, radix 2^16, lazy carries).

    Inputs < 2p with 16-bit limbs; output < 2p with 16-bit limbs.  The limb
    recursion runs as a lax.scan by default (small compiled graph); pass
    unroll=True for a fully unrolled body (a flat graph for XLA).
    """
    batch_shape = a.shape[1:]
    zero_row = jnp.zeros((1,) + batch_shape, dtype=jnp.uint32)
    t = jnp.zeros((LIMBS + 1,) + batch_shape, dtype=jnp.uint32)
    n = jnp.reshape(_P_COL, (LIMBS,) + (1,) * len(batch_shape))
    body = _cios_body(b, n, zero_row)
    if unroll:
        # plain python loop: gives XLA a flat graph
        for i in range(LIMBS):
            t, _ = body(t, a[i])
    else:
        t, _ = jax.lax.scan(body, t, a)
    # Lazy entries < ~2^23; value < 2p.  Canonicalize limbs.
    return _propagate(t, LIMBS)


def add_mod(a, b):
    """(a + b) folded below 2p.  Inputs < 2p (or < 4p combined headroom)."""
    return _cond_sub_2p(_propagate(a + b, LIMBS + 1))


_FOUR_P_17 = np.array(_int_to_limbs_list(4 * P, 17), dtype=np.uint32)


def sub_mod(a, b):
    """(a - b) mod p, result < 2p.  Inputs < 2p.

    Computed as a - b + 4p in signed-limb form (int32 lazy carries with
    arithmetic shifts), which is positive and in (2p, 6p); two conditional
    2p-folds bring it below 2p.
    """
    batch_dims = (None,) * (a.ndim - 1)
    fp = jnp.asarray(_FOUR_P_17.astype(np.int32))[(slice(None),) + batch_dims]
    pad = jnp.zeros((1,) + a.shape[1:], dtype=jnp.int32)
    t = jnp.concatenate([a.astype(jnp.int32), pad]) \
        - jnp.concatenate([b.astype(jnp.int32), pad]) + fp

    # Signed sequential carry propagation (arithmetic >> gives floor division).
    def body(carry, tj):
        v = tj + carry
        return v >> LIMB_BITS, (v & MASK).astype(jnp.uint32)

    _, s = jax.lax.scan(body, jnp.zeros_like(t[0]), t)
    s = _cond_sub_2p(s)
    s = _cond_sub_2p(jnp.concatenate([s, jnp.zeros_like(s[:1])]))
    return s


def normalize(a):
    """Reduce a (< 2p) to canonical form (< p)."""
    a17 = jnp.concatenate([a, jnp.zeros_like(a[:1])])
    ge = _ge_col(a17, _P17)
    neg = jnp.reshape(_NEG_P17, (17,) + (1,) * (a.ndim - 1))
    diff = _propagate(a17 + neg, 17)
    return jnp.where(ge[None], diff, a17)[:LIMBS]


def to_mont(a, unroll: bool = False):
    """Standard form -> Montgomery form (multiply by R^2 then reduce)."""
    r2 = jnp.reshape(_R2_COL, (LIMBS,) + (1,) * (a.ndim - 1))
    return mont_mul(a, jnp.broadcast_to(r2, a.shape), unroll=unroll)

def from_mont(a, unroll: bool = False):
    """Montgomery form -> standard form (< 2p; normalize() for canonical)."""
    o = jnp.reshape(_ONE_COL, (LIMBS,) + (1,) * (a.ndim - 1))
    return mont_mul(a, jnp.broadcast_to(o, a.shape), unroll=unroll)


# ---------------------------------------------------------------------------
# Comparisons / predicates (on canonical-form inputs)
# ---------------------------------------------------------------------------

def eq(a, b):
    """Bit-exact equality of canonical limb arrays -> bool[batch]."""
    return jnp.all(a == b, axis=0)

def is_zero(a):
    return jnp.all(a == 0, axis=0)

def less_than(a, b):
    """a < b on canonical values -> bool[batch] (parallel borrow chain;
    equal values -> False)."""
    return _borrow_lt(a, b)


def select(cond, a, b):
    """cond ? a : b elementwise over the batch (cond: bool[batch])."""
    return jnp.where(cond[None], a, b)

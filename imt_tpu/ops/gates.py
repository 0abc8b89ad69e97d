"""Gadget-level ops mirroring the reference chip's constraint-layer surface.

The reference builds its circuit from halo2-base GateChip/RangeChip gadgets
(src/indexed_merkle_tree.rs:32-125).  On the device there is no constraint system —
these are plain batched computations — but the SEMANTIC surface is replicated
1:1 so users of the reference find every gadget:

| reference                                  | here                      |
|--------------------------------------------|---------------------------|
| select (s*a + (1-s)*b, :33-45)             | select                    |
| dual_mux (cond swap, :47-63)               | dual_mux                  |
| compute_merkle_root (:78-96)               | tree.merkle.compute_root_from_helpers |
| verify_merkle_proof (:65-76)               | verify_merkle_proof       |
| is_less_than (128-bit limb split, :98-125) | is_less_than / split_128  |
| gate.is_equal / is_zero                    | field.eq / field.is_zero  |
| assert_bit                                 | assert_bit                |

All value arguments are canonical limb arrays uint32[16, K].
"""

from __future__ import annotations

import jax.numpy as jnp

from . import field
from ..tree.merkle import compute_root_from_helpers


def assert_bit(s) -> None:
    """Debug-mode analog of gate.assert_bit: raises on non-boolean input.
    (The reference constrains s*(s-1)=0; here booleans are typed, so this
    only guards untyped integer inputs.)"""
    import numpy as np
    arr = np.asarray(s)
    if arr.dtype != bool and not ((arr == 0) | (arr == 1)).all():
        raise ValueError("selector is not a bit")


def select(s, a, b):
    """s ? a : b per lane (reference select: s*a + (1-s)*b,
    src/indexed_merkle_tree.rs:33-45; s=1 -> a)."""
    return field.select(s, a, b)


def dual_mux(a, b, switch):
    """Conditional swap (reference dual_mux, src/indexed_merkle_tree.rs:47-63):
    switch=1 -> (a, b); switch=0 -> (b, a).  Returns (left, right)."""
    left = field.select(switch, a, b)
    right = field.select(switch, b, a)
    return left, right


def verify_merkle_proof(root, leaf, proof, proof_helper):
    """Helper-bit Merkle verification (reference verify_merkle_proof,
    src/indexed_merkle_tree.rs:65-76) -> bool[K]."""
    return field.eq(compute_root_from_helpers(leaf, proof, proof_helper), root)


def split_128(a):
    """Split canonical values at 2^128: returns (q, r) as full-width limb
    arrays (the witness decomposition of reference verify_non_inclusion,
    src/indexed_merkle_tree.rs:145-173)."""
    zeros = jnp.zeros_like(a[:8])
    r = jnp.concatenate([a[:8], zeros])
    q = jnp.concatenate([a[8:], zeros])
    return q, r


def is_less_than(a_q, a_r, b_q, b_r):
    """The reference's 254-bit comparator over 128-bit limb pairs
    (src/indexed_merkle_tree.rs:98-125):
        a < b  <=>  (a_q < b_q) | ((a_q == b_q) & (a_r < b_r))
    computed with the same boolean expansion (with the `a_r == b_q` typo of
    the reference's native test at :617 fixed)."""
    is_ll_msb = field.less_than(a_q, b_q)
    are_msb_eq = field.eq(a_q, b_q)
    is_ll_lsb = field.less_than(a_r, b_r)
    are_lsb_eq = field.eq(a_r, b_r)
    lhs = is_ll_msb & ~are_msb_eq
    rhs = (~is_ll_msb) & is_ll_lsb & are_msb_eq & ~are_lsb_eq
    return lhs | rhs


def less_than_254(a, b):
    """Direct 254-bit compare through the 128-bit split path (equivalent to
    field.less_than; exposed for parity with the reference's decomposition)."""
    aq, ar = split_128(a)
    bq, br = split_128(b)
    return is_less_than(aq, ar, bq, br)

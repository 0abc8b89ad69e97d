"""Chained-permutation programs for timing the Poseidon engines.

``permutation_loop(name, width)`` is the program behind ``bench.py``'s
headline rate and ``chip_smoke.py``'s engine table: k permutations of one
[.., 3, width] state inside one jitted ``fori_loop``, inputs made on the
device.  Timing it at two values of k and taking the slope cancels
dispatch and transfer.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

ENGINES = ("rns", "cios")


def engine(name: str):
    """(engine, state shape for width B, lazy-input mask, input cast)."""
    if name == "rns":
        from .poseidon_rns import PoseidonRns
        return (PoseidonRns(), lambda b: (48, 3, b), 0x7FF,
                lambda x: x.astype(jnp.float32))
    if name == "cios":
        from .poseidon_jax import Poseidon
        return Poseidon(), lambda b: (16, 3, b), 0x3FFF, lambda x: x
    raise ValueError(f"unknown engine {name!r}; expected one of {ENGINES}")


def permutation_loop(name: str, width: int):
    """jit(seed, k): k chained permutations of one [.., 3, width] state
    inside one fori_loop; returns a per-row sum so every lane is live."""
    eng, shape_of, mask, cast = engine(name)
    shape = shape_of(width)

    @jax.jit
    def f(seed, k):
        base = jax.lax.broadcasted_iota(jnp.uint32, shape, 2) ^ seed
        st = jax.lax.fori_loop(0, k, lambda i, s: eng.permute(s),
                               cast(base & jnp.uint32(mask)))
        return st.sum(axis=-1)
    return f

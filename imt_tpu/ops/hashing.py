"""Poseidon backend dispatch — one hash2/hash3 surface, two engines.

All tree/parallel code calls through this module; the engine is resolved at
trace time, so the choice is baked into each jitted program when it first
compiles.  Pick explicitly with set_backend()/IMT_HASH_ENGINE:

* ``rns``  — f32 residue arithmetic + bf16 base-extension dots on the
             matrix unit / tensor cores (poseidon_rns.py).  Bit-exact.
* ``cios`` — uint32 16-bit-limb CIOS Montgomery (poseidon_jax.py).  The
             engine the dedicated parity tests anchor on.

Default: ``rns`` on every platform.  On an NVIDIA H100 it runs 8-18x the
``cios`` engine at widths 2^10-2^16 (chip_smoke.py phase 5); on AVX-512
hosts the f32 residue ops also vectorize ~9x better than emulated uint32
CIOS, which keeps the CPU suite fast.

Switch BEFORE building trees: jitted tree steps cache the engine they were
traced with (functools.lru_cache on the step builders).
"""

from __future__ import annotations

import os

ENGINES = ("rns", "cios")

_backend: str | None = None      # explicit override; None = default


def set_backend(name: str | None) -> None:
    """Force a backend ("rns" | "cios") or None = the default."""
    global _backend
    if name is not None and name not in ENGINES:
        raise ValueError(f"unknown hash backend: {name!r}")
    _backend = name


def backend() -> str:
    if _backend is not None:
        return _backend
    env = os.environ.get("IMT_HASH_ENGINE")
    if env in ENGINES:
        return env
    return "rns"


def _mod():
    if backend() == "rns":
        from . import poseidon_rns as m
    else:
        from . import poseidon_jax as m
    return m


def hash2(a, b):
    """Batched 2-to-1 Poseidon hash, canonical limbs uint32[16, B]."""
    return _mod().hash2(a, b)


def hash3(a, b, c):
    """Batched 3-to-1 Poseidon hash (indexed leaf), canonical limbs."""
    return _mod().hash3(a, b, c)


# ---------------------------------------------------------------------------
# Node representation — engine-native Merkle node storage.
#
# Tree code stores interior nodes (hash outputs) in the hash engine's native
# representation and hashes node->node WITHOUT converting through canonical
# limbs: for the rns engine that is Montgomery-domain RNS residues
# f32[48, B], so the per-level to_limbs (a full CRT reconstruction + digit
# carry normalization, comparable in cost to a permutation) and from_limbs
# disappear from every tree walk.  For the cios engine the representation IS
# canonical limbs (identity).  Conversions happen only at witness/API
# boundaries (roots, proofs, checkpoints).
#
# Representations are NOT interchangeable across a cios<->rns backend
# switch — hashing.set_backend must be called before building trees (as
# documented above: jitted tree steps cache the engine they were traced
# with).
# ---------------------------------------------------------------------------

def node_repr() -> str:
    """The active node representation: "rns" (f32[48, B] Montgomery
    residues) or "limbs" (canonical uint32[16, B])."""
    return "limbs" if backend() == "cios" else "rns"


def enc_nodes(limbs):
    """Canonical limbs uint32[16, B] -> node representation."""
    if node_repr() == "limbs":
        return limbs
    from . import field_rns
    return field_rns.from_limbs(limbs)


def dec_nodes(nodes):
    """Node representation -> canonical limbs uint32[16, B]."""
    if node_repr() == "limbs":
        return nodes
    from . import field_rns
    return field_rns.to_limbs(nodes)


def hash2_nodes(a, b):
    """Batched 2-to-1 hash, node representation in AND out."""
    if node_repr() == "limbs":
        return hash2(a, b)
    from . import poseidon_rns
    return poseidon_rns.hash2_nodes(a, b)


def hash3_leaf(a, b, c):
    """Batched 3-to-1 leaf hash: canonical limb inputs (leaf field values),
    node-representation output."""
    if node_repr() == "limbs":
        return hash3(a, b, c)
    from . import poseidon_rns
    return poseidon_rns.hash3_leaf(a, b, c)


def hash_fixed(cols):
    """Batched fixed-length hash of any arity (the halo2-base
    hash_fix_len_array contract).  Lengths 2/3 route through the dispatched
    hash2/hash3 fast paths; other lengths run the ACTIVE backend's sponge
    (cios -> poseidon_jax, rns -> poseidon_rns)."""
    if len(cols) == 2:
        return hash2(*cols)
    if len(cols) == 3:
        return hash3(*cols)
    if backend() == "cios":
        from . import poseidon_jax
        return poseidon_jax.default_engine().hash_fixed(list(cols))
    from . import poseidon_rns
    return poseidon_rns.default_engine().hash_fixed(list(cols))

"""Device (JAX) Poseidon vs python-int oracle: bit-exact parity."""

import random

import numpy as np

from imt_tpu.ops import field, poseidon_jax
from imt_tpu.ops.poseidon_ref import generate_params, hash_fixed

rng = random.Random(0x9051D09)
PARAMS = generate_params()

ANCHOR_H000 = 1960587138944869480785025106734196872454309951825657414575195034687326603497


def test_hash3_zero_anchor_on_device():
    z = field.ints_to_limbs([0])
    out = np.asarray(poseidon_jax.hash3(z, z, z))
    assert field.limbs_to_ints(out) == [ANCHOR_H000]


def test_hash2_batch_parity():
    n = 16
    xs = [rng.randrange(field.P) for _ in range(n)]
    ys = [rng.randrange(field.P) for _ in range(n)]
    out = np.asarray(poseidon_jax.hash2(field.ints_to_limbs(xs),
                                        field.ints_to_limbs(ys)))
    got = field.limbs_to_ints(out)
    want = [hash_fixed([x, y], PARAMS) for x, y in zip(xs, ys)]
    assert got == want


def test_hash3_batch_parity():
    n = 16
    trips = [[rng.randrange(field.P) for _ in range(3)] for _ in range(n)]
    out = np.asarray(poseidon_jax.hash3(
        field.ints_to_limbs([t[0] for t in trips]),
        field.ints_to_limbs([t[1] for t in trips]),
        field.ints_to_limbs([t[2] for t in trips])))
    assert field.limbs_to_ints(out) == [hash_fixed(t, PARAMS) for t in trips]


def test_hash_fixed_arbitrary_arity_matches_oracle():
    """CIOS-engine sponge for L=1..7 vs the python oracle — the
    hash_fix_len_array contract on the cios path (arity >= 4 used to
    silently ignore set_backend("cios"))."""
    eng = poseidon_jax.default_engine()
    for L in range(1, 8):
        vals = [[rng.randrange(field.P) for _ in range(4)] for _ in range(L)]
        cols = [field.ints_to_limbs(v) for v in vals]
        got = field.limbs_to_ints(np.asarray(eng.hash_fixed(cols)))
        want = [hash_fixed([vals[i][j] for i in range(L)], PARAMS)
                for j in range(4)]
        assert got == want, f"arity {L}"


def test_hash_fixed_dispatch_respects_cios_backend():
    """hashing.hash_fixed at arity 4 routes to the cios engine when the
    cios backend is active (dispatch contract, ops/hashing.py)."""
    from unittest import mock

    from imt_tpu.ops import hashing, poseidon_rns
    cols = [field.ints_to_limbs([rng.randrange(field.P)]) for _ in range(4)]
    want = field.limbs_to_ints(np.asarray(
        poseidon_jax.default_engine().hash_fixed(cols)))
    with mock.patch.object(hashing, "_backend", "cios"):
        with mock.patch.object(poseidon_rns, "default_engine",
                               side_effect=AssertionError(
                                   "cios backend must not hit the rns "
                                   "sponge")):
            got = field.limbs_to_ints(np.asarray(hashing.hash_fixed(cols)))
    assert got == want


def test_hash_edge_values():
    edges = [0, 1, field.P - 1, field.P - 2, (1 << 128), (1 << 128) - 1]
    n = len(edges)
    a = field.ints_to_limbs(edges)
    b = field.ints_to_limbs(list(reversed(edges)))
    out = field.limbs_to_ints(np.asarray(poseidon_jax.hash2(a, b)))
    want = [hash_fixed([x, y], PARAMS)
            for x, y in zip(edges, reversed(edges))]
    assert out == want

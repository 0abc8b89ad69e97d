"""Pure-Python reference Poseidon over BN254 Fr (the bit-exactness oracle).

Implements the *unoptimized* Poseidon permutation (add-round-constant, S-box
x^5, MDS multiply each round) plus the sponge construction whose behavior the
reference pins through its `pse-poseidon` dependency:

  * state width T, rate RATE (reference uses T=3, RATE=2 —
    src/indexed_merkle_tree.rs:362-365)
  * initial state [2^64, 0, ..., 0] (capacity word encodes the domain)
  * absorb: add each RATE-chunk into state[1..1+RATE], then permute
  * squeeze: pad the pending chunk with a single 1, permute, return state[1]
    (2- and 3-input hashes therefore cost exactly 2 permutations each)

Ground truth: Poseidon(0,0,0) must equal
1960587138944869480785025106734196872454309951825657414575195034687326603497
(reference src/indexed_merkle_tree.rs:247-251, test at :805-810).

This module is host-side python-int math, used as the oracle that the JAX /
C++ implementations must match bit-exactly.
"""

from __future__ import annotations

from dataclasses import dataclass

from .grain import P, Grain, generate_mds, generate_round_constants


@dataclass(frozen=True)
class PoseidonParams:
    t: int
    rate: int
    r_f: int
    r_p: int
    round_constants: tuple  # (r_f + r_p) rows of t python ints
    mds: tuple              # t x t python ints

    @property
    def n_rounds(self) -> int:
        return self.r_f + self.r_p


def generate_params(t: int = 3, rate: int = 2, r_f: int = 8, r_p: int = 57,
                    rc_mode: str = "rej_msb", n_bits: int = 254) -> PoseidonParams:
    grain = Grain(t, r_f, r_p, n_bits=n_bits)
    rc = generate_round_constants(grain, t, r_f + r_p, mode=rc_mode)
    mds = generate_mds(grain, t)
    return PoseidonParams(
        t=t, rate=rate, r_f=r_f, r_p=r_p,
        round_constants=tuple(tuple(row) for row in rc),
        mds=tuple(tuple(row) for row in mds),
    )


def permute(state: list[int], params: PoseidonParams) -> list[int]:
    """One Poseidon permutation (standard, non-optimized round structure)."""
    t = params.t
    half_full = params.r_f // 2
    mds = params.mds
    for r in range(params.n_rounds):
        rc = params.round_constants[r]
        st = [(state[i] + rc[i]) % P for i in range(t)]
        if half_full <= r < half_full + params.r_p:
            # Partial round: S-box on word 0 only.
            st[0] = pow(st[0], 5, P)
        else:
            st = [pow(x, 5, P) for x in st]
        state = [sum(mds[i][j] * st[j] for j in range(t)) % P for i in range(t)]
    return state


class PoseidonSponge:
    """Stateful sponge mirroring the native-hasher API surface the reference
    relies on: update(elements) / squeeze_and_reset()."""

    def __init__(self, params: PoseidonParams):
        self.params = params
        self._reset()

    def _reset(self) -> None:
        self.state = [0] * self.params.t
        self.state[0] = (1 << 64) % P
        self.absorbing: list[int] = []

    def _absorb_chunk(self, chunk: list[int]) -> None:
        for i, v in enumerate(chunk):
            self.state[1 + i] = (self.state[1 + i] + v) % P
        self.state = permute(self.state, self.params)

    def update(self, elements: list[int]) -> None:
        buf = self.absorbing + [x % P for x in elements]
        self.absorbing = []
        rate = self.params.rate
        for i in range(0, len(buf), rate):
            chunk = buf[i:i + rate]
            if len(chunk) == rate:
                self._absorb_chunk(chunk)
            else:
                self.absorbing = chunk

    def squeeze(self) -> int:
        chunk = self.absorbing + [1]
        self.absorbing = []
        self._absorb_chunk(chunk)
        return self.state[1]

    def squeeze_and_reset(self) -> int:
        out = self.squeeze()
        self._reset()
        return out


def hash_fixed(inputs: list[int], params: PoseidonParams) -> int:
    """Fixed-length hash of `inputs` (the reference hashes 2 siblings or a
    3-word leaf this way — src/utils.rs:46-47, src/indexed_merkle_tree.rs:193)."""
    sponge = PoseidonSponge(params)
    sponge.update(inputs)
    return sponge.squeeze()

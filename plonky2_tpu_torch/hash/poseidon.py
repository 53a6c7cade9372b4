"""Host-side Poseidon permutation and sponge hashing (exact Python ints).

Used by the Fiat-Shamir challenger and other tiny host-side hashing; the
batched device version lives in ``ops.poseidon`` and is tested for
bit-exact agreement. Structure: 4 full rounds, 22 partial rounds,
4 full rounds; x^7 S-box; MDS = circulant(MDS_MATRIX_CIRC) + diag(8,0..0)
(reference: core/src/poseidon.rs:21-34,599-622 and the sponge semantics in
core/src/hashing.rs — including this fork's domain-separated hash_leaf).
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

from ..field.goldilocks import P, gadd, gmul
from .poseidon_constants import (
    ALL_ROUND_CONSTANTS,
    HALF_N_FULL_ROUNDS,
    MDS_MATRIX_CIRC,
    MDS_MATRIX_DIAG,
    N_PARTIAL_ROUNDS,
    N_ROUNDS,
    SPONGE_CAPACITY,
    SPONGE_RATE,
    SPONGE_WIDTH,
)

NUM_HASH_OUT_ELTS = 4

# Full 12x12 MDS matrix: M[r][j] = CIRC[(j - r) % 12] + (DIAG[r] if j == r)
MDS_FULL = [
    [
        MDS_MATRIX_CIRC[(j - r) % SPONGE_WIDTH]
        + (MDS_MATRIX_DIAG[r] if j == r else 0)
        for j in range(SPONGE_WIDTH)
    ]
    for r in range(SPONGE_WIDTH)
]


def _sbox(x: int) -> int:
    x2 = (x * x) % P
    x4 = (x2 * x2) % P
    x3 = (x * x2) % P
    return (x3 * x4) % P


def _mds(state: List[int]) -> List[int]:
    return [
        sum(m * s for m, s in zip(row, state)) % P for row in MDS_FULL
    ]


def permute(state: Sequence[int]) -> List[int]:
    """The width-12 Poseidon permutation over Goldilocks. Dispatches to
    the native C engine when available (native/host_hash.c)."""
    assert len(state) == SPONGE_WIDTH
    from .. import native

    if native.available():
        return native.poseidon_permute([x % P for x in state])
    s = [x % P for x in state]
    for r in range(N_ROUNDS):
        base = r * SPONGE_WIDTH
        s = [gadd(x, ALL_ROUND_CONSTANTS[base + i]) for i, x in enumerate(s)]
        full = r < HALF_N_FULL_ROUNDS or r >= HALF_N_FULL_ROUNDS + N_PARTIAL_ROUNDS
        if full:
            s = [_sbox(x) for x in s]
        else:
            s[0] = _sbox(s[0])
        s = _mds(s)
    return s


# ---------------------------------------------------------------------------
# Sponge constructions (core/src/hashing.rs)
# ---------------------------------------------------------------------------


def hash_n_to_m_no_pad(inputs: Sequence[int], num_outputs: int) -> List[int]:
    """Overwrite-mode sponge, no padding (hashing.rs hash_n_to_m_no_pad)."""
    state = [0] * SPONGE_WIDTH
    for start in range(0, len(inputs), SPONGE_RATE):
        chunk = inputs[start : start + SPONGE_RATE]
        state[: len(chunk)] = [x % P for x in chunk]
        state = permute(state)
    if len(inputs) == 0:
        pass  # matches reference: zero chunks -> no permutation before squeeze
    outputs: List[int] = []
    while True:
        for x in state[:SPONGE_RATE]:
            outputs.append(x)
            if len(outputs) == num_outputs:
                return outputs
        state = permute(state)


def hash_no_pad(inputs: Sequence[int]) -> Tuple[int, int, int, int]:
    return tuple(hash_n_to_m_no_pad(inputs, NUM_HASH_OUT_ELTS))


def hash_pad(inputs: Sequence[int]) -> Tuple[int, int, int, int]:
    """pad10*1 then hash (config.rs Hasher::hash_pad)."""
    padded = list(inputs) + [1]
    while (len(padded) + 1) % SPONGE_RATE != 0:
        padded.append(0)
    padded.append(1)
    return hash_no_pad(padded)


def hash_leaf(inputs: Sequence[int]) -> Tuple[int, int, int, int]:
    """Domain-separated Merkle leaf hash: capacity lane RATE holds len+1
    (this fork's hashing.rs hash_leaf)."""
    state = [0] * SPONGE_WIDTH
    state[SPONGE_RATE] = (len(inputs) + 1) % P
    for start in range(0, len(inputs), SPONGE_RATE):
        chunk = inputs[start : start + SPONGE_RATE]
        state[: len(chunk)] = [x % P for x in chunk]
        state = permute(state)
    return tuple(state[:NUM_HASH_OUT_ELTS])


def two_to_one(left: Sequence[int], right: Sequence[int]) -> Tuple[int, int, int, int]:
    """Compress two 4-element digests (hashing.rs compress): zero capacity."""
    state = [0] * SPONGE_WIDTH
    state[:NUM_HASH_OUT_ELTS] = [x % P for x in left]
    state[NUM_HASH_OUT_ELTS : 2 * NUM_HASH_OUT_ELTS] = [x % P for x in right]
    state = permute(state)
    return tuple(state[:NUM_HASH_OUT_ELTS])


def hash_or_noop(inputs: Sequence[int]) -> Tuple[int, int, int, int]:
    """Return inputs zero-padded if they fit in a digest, else hash
    (upstream GenericHashOut convention used for public-input hashing)."""
    if len(inputs) <= NUM_HASH_OUT_ELTS:
        return tuple(list(inputs) + [0] * (NUM_HASH_OUT_ELTS - len(inputs)))
    return hash_no_pad(inputs)

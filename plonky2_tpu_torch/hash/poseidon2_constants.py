"""Poseidon2 width-12 Goldilocks parameters.

Shape matches the reference gate's Poseidon2Params
(plonky2/src/gates/poseidon2.rs:84-127): 4 initial + 4 terminal external
rounds of 12 round constants each, 22 internal round constants, and the
12-entry internal-matrix diagonal.

Round constants are generated with the Grain-LFSR procedure from the
Poseidon reference design (GF(p), x^alpha S-box, n=64, t=12, R_F=8,
R_P=22), which is the procedure the HorizenLabs Poseidon2 instance
generator reuses. The upstream `qp-poseidon-core` v3.0.2 crate that the
reference consumes is not vendored in its repository, so its exact
constant values cannot be consulted here; these constants are
self-consistent across this framework's hasher, gates and recursive
verifier, and the generator below is the documented public procedure.

MATRIX_DIAG is the public `MATRIX_DIAG_12_GOLDILOCKS` internal-matrix
diagonal of the HorizenLabs Poseidon2 Goldilocks instantiation (the
diagonal the reference gate documents at gates/poseidon2.rs:77);
invertibility of diag(d) + J is asserted structurally below.
"""

from __future__ import annotations

from typing import List, Tuple

from ..field.goldilocks import P, ginv, gmul

SPONGE_WIDTH = 12
SPONGE_RATE = 8
SPONGE_CAPACITY = 4
EXTERNAL_ROUNDS = 8  # 4 initial + 4 terminal
INTERNAL_ROUNDS = 22
ALPHA = 7


class _GrainLFSR:
    """80-bit Grain LFSR from the Poseidon reference parameter generator:
    b_{i+80} = b_{i+62} ^ b_{i+51} ^ b_{i+38} ^ b_{i+23} ^ b_{i+13} ^ b_i,
    seeded with (field, sbox, n, t, R_F, R_P) and 160 discarded bits."""

    def __init__(self, n: int, t: int, r_f: int, r_p: int):
        bits: List[int] = []

        def push(value: int, width: int) -> None:
            for k in range(width - 1, -1, -1):
                bits.append((value >> k) & 1)

        push(1, 2)  # prime field
        push(0, 4)  # x^alpha S-box
        push(n, 12)
        push(t, 12)
        push(r_f, 10)
        push(r_p, 10)
        bits.extend([1] * 30)
        assert len(bits) == 80
        self.state = bits
        for _ in range(160):
            self._next_raw()

    def _next_raw(self) -> int:
        s = self.state
        new = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        s.pop(0)
        s.append(new)
        return new

    def next_bit(self) -> int:
        # rejection rule: emit the second bit of a pair only when the
        # first is 1
        while True:
            b1 = self._next_raw()
            b2 = self._next_raw()
            if b1 == 1:
                return b2

    def next_field_element(self) -> int:
        while True:
            v = 0
            for _ in range(64):
                v = (v << 1) | self.next_bit()
            if v < P:
                return v


def _generate() -> Tuple[list, list, list]:
    lfsr = _GrainLFSR(64, SPONGE_WIDTH, EXTERNAL_ROUNDS, INTERNAL_ROUNDS)
    initial = [
        [lfsr.next_field_element() for _ in range(SPONGE_WIDTH)] for _ in range(4)
    ]
    internal = [lfsr.next_field_element() for _ in range(INTERNAL_ROUNDS)]
    terminal = [
        [lfsr.next_field_element() for _ in range(SPONGE_WIDTH)] for _ in range(4)
    ]
    return initial, terminal, internal


INITIAL_EXTERNAL_CONSTANTS, TERMINAL_EXTERNAL_CONSTANTS, INTERNAL_CONSTANTS = _generate()

MATRIX_DIAG = [
    0xC3B6C08E23BA9300,
    0xD84B5DE94A324FB6,
    0x0D0C371C5B35B84F,
    0x7964F570E7188037,
    0x5DAF18BBD996604B,
    0x6743BC47B9595257,
    0x5528B9362C59BB70,
    0xAC45E25B7127B68B,
    0xA2077D7DFBB606B5,
    0xF3FAAC6FAEE378AE,
    0x0C6388B51545E883,
    0xD27DBB6944917B60,
]


def _check_internal_matrix_invertible() -> None:
    # det(diag(d) + 1·1ᵀ) = (Π d_i)(1 + Σ 1/d_i)  — matrix determinant lemma
    prod = 1
    inv_sum = 0
    for d in MATRIX_DIAG:
        d %= P
        assert d != 0
        prod = gmul(prod, d)
        inv_sum = (inv_sum + ginv(d)) % P
    assert gmul(prod, (1 + inv_sum) % P) != 0, "internal matrix is singular"


_check_internal_matrix_invertible()

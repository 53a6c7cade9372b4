"""Fiat-Shamir challenger: overwrite-mode duplex sponge on host.

Exact transcript semantics (reference: core/src/challenger.rs:12-160):
observations buffer up to RATE=8 elements and auto-duplex when full;
``get_challenge`` duplexes iff inputs are pending or outputs are
exhausted, then pops from the END of the 8-element squeeze buffer;
any observation clears buffered outputs. The sponge state is 12 field
elements; duplexing overwrites state[0..len(inputs)] then permutes.

The challenger handles only O(transcript) data, so it runs on host with
exact ints; the device Poseidon kernel is bit-identical so caps produced
on device feed straight in.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..field.goldilocks import P
from .poseidon import SPONGE_RATE, SPONGE_WIDTH, permute


class Challenger:
    def __init__(self, permutation=None):
        """permutation: width-12 challenger permutation; defaults to
        Poseidon. Keccak configs pass the pseudo-permutation
        (core/src/keccak.rs:12-60)."""
        self.permutation = permutation or permute
        self.sponge_state: List[int] = [0] * SPONGE_WIDTH
        self.input_buffer: List[int] = []
        self.output_buffer: List[int] = []

    # -- observations ------------------------------------------------------

    def observe_element(self, x: int) -> None:
        self.output_buffer.clear()
        self.input_buffer.append(x % P)
        if len(self.input_buffer) == SPONGE_RATE:
            self._duplex()

    def observe_elements(self, xs: Sequence[int]) -> None:
        for x in xs:
            self.observe_element(x)

    def observe_extension_element(self, e: Sequence[int]) -> None:
        self.observe_elements(list(e))

    def observe_extension_elements(self, es: Sequence[Sequence[int]]) -> None:
        for e in es:
            self.observe_extension_element(e)

    def observe_hash(self, h: Sequence[int]) -> None:
        self.observe_elements(list(h))

    def observe_cap(self, cap) -> None:
        """cap: iterable of 4-element digests (rows of a [2^h, 4] array)."""
        for h in cap:
            self.observe_hash([int(x) for x in h])

    # -- challenges ----------------------------------------------------------

    def get_challenge(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplex()
        return self.output_buffer.pop()

    def get_n_challenges(self, n: int) -> List[int]:
        return [self.get_challenge() for _ in range(n)]

    def get_hash(self) -> Tuple[int, int, int, int]:
        return tuple(self.get_n_challenges(4))

    def get_extension_challenge(self, d: int = 2) -> Tuple[int, ...]:
        return tuple(self.get_n_challenges(d))

    def get_n_extension_challenges(self, n: int, d: int = 2):
        return [self.get_extension_challenge(d) for _ in range(n)]

    # -- internals -----------------------------------------------------------

    def _duplex(self) -> None:
        assert len(self.input_buffer) <= SPONGE_RATE
        for i, x in enumerate(self.input_buffer):
            self.sponge_state[i] = x
        self.input_buffer.clear()
        self.sponge_state = self.permutation(self.sponge_state)
        self.output_buffer = list(self.sponge_state[:SPONGE_RATE])

    def compact(self) -> List[int]:
        """Flush pending inputs and return the sponge state (for PoW grinding,
        reference challenger.rs compact)."""
        if self.input_buffer:
            self._duplex()
        self.output_buffer.clear()
        return list(self.sponge_state)

"""In-circuit Fiat-Shamir challenger — mirrors hash/challenger.py exactly
over targets (reference: plonky2/src/iop/challenger.rs RecursiveChallenger).
Every duplex is one PoseidonGate row (swap = 0)."""

from __future__ import annotations

from typing import List, Sequence

from ..iop.target import ExtensionTarget, Target
from .poseidon_constants import SPONGE_RATE, SPONGE_WIDTH


class RecursiveChallenger:
    def __init__(self, builder):
        self.b = builder
        zero = builder.zero()
        self.sponge_state: List[Target] = [zero] * SPONGE_WIDTH
        self.input_buffer: List[Target] = []
        self.output_buffer: List[Target] = []

    # -- observations ------------------------------------------------------

    def observe_element(self, t: Target) -> None:
        self.output_buffer.clear()
        self.input_buffer.append(t)
        if len(self.input_buffer) == SPONGE_RATE:
            self._duplex()

    def observe_elements(self, ts: Sequence[Target]) -> None:
        for t in ts:
            self.observe_element(t)

    def observe_extension_element(self, e: ExtensionTarget) -> None:
        self.observe_elements(list(e.parts))

    def observe_extension_elements(self, es) -> None:
        for e in es:
            self.observe_extension_element(e)

    def observe_hash(self, h: Sequence[Target]) -> None:
        self.observe_elements(list(h))

    def observe_cap(self, cap) -> None:
        for h in cap.hashes:
            self.observe_hash(h)

    # -- challenges ----------------------------------------------------------

    def get_challenge(self) -> Target:
        if self.input_buffer or not self.output_buffer:
            self._duplex()
        return self.output_buffer.pop()

    def get_n_challenges(self, n: int) -> List[Target]:
        return [self.get_challenge() for _ in range(n)]

    def get_hash(self) -> List[Target]:
        return self.get_n_challenges(4)

    def get_extension_challenge(self) -> ExtensionTarget:
        return ExtensionTarget(tuple(self.get_n_challenges(2)))

    # -- internals -----------------------------------------------------------

    def _duplex(self) -> None:
        assert len(self.input_buffer) <= SPONGE_RATE
        state = list(self.sponge_state)
        for i, t in enumerate(self.input_buffer):
            state[i] = t
        self.input_buffer.clear()
        self.sponge_state = self.b.permute_poseidon(state)
        self.output_buffer = list(self.sponge_state[:SPONGE_RATE])

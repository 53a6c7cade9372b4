"""The Fiat-Shamir challenger of plonky2 (challenger.rs): an overwrite-mode
duplex sponge over the Poseidon permutation. Observations are buffered
and absorbed 8 at a time; a challenge duplexes when inputs are pending
or the outputs are spent, and is popped from the end of the 8 outputs;
any observation drops the outputs left."""

from __future__ import annotations

from typing import List, Sequence

from . import field as F
from .poseidon import RATE, WIDTH, permute_host


class Challenger:
    def __init__(self):
        self.state = [0] * WIDTH
        self.inputs: List[int] = []
        self.outputs: List[int] = []

    def observe(self, x: int) -> None:
        self.outputs = []
        self.inputs.append(int(x) % F.P)
        if len(self.inputs) == RATE:
            self._duplex()

    def observe_all(self, xs: Sequence[int]) -> None:
        for x in xs:
            self.observe(x)

    def observe_exts(self, es) -> None:
        for e in es:
            self.observe_all(e)

    def observe_cap(self, cap) -> None:
        for digest in cap:
            self.observe_all(digest)

    def challenge(self) -> int:
        if self.inputs or not self.outputs:
            self._duplex()
        return self.outputs.pop()

    def challenges(self, n: int) -> List[int]:
        return [self.challenge() for _ in range(n)]

    def ext_challenge(self) -> F.Ext:
        return tuple(self.challenges(2))

    def _duplex(self) -> None:
        for i, x in enumerate(self.inputs):
            self.state[i] = x
        self.inputs = []
        self.state = permute_host(self.state)
        self.outputs = list(self.state[:RATE])

    def grind_state(self):
        """(the state that a proof-of-work witness is absorbed into, the
        lane it takes): the sponge with the pending inputs laid over it."""
        state = list(self.state)
        for i, x in enumerate(self.inputs):
            state[i] = x
        return state, len(self.inputs)

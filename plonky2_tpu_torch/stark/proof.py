"""STARK proof containers (reference: starky/src/proof.rs:30-310)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..fri.proof import FriProof
from ..fri.structure import FriOpeningBatch, FriOpenings

Ext = Tuple[int, ...]


@dataclass
class StarkOpeningSet:
    local_values: List[Ext]
    next_values: List[Ext]
    auxiliary_polys: Optional[List[Ext]]
    auxiliary_polys_next: Optional[List[Ext]]
    ctl_zs_first: Optional[List[int]]
    quotient_polys: Optional[List[Ext]]

    def to_fri_openings(self) -> FriOpenings:
        batches = [
            FriOpeningBatch(
                values=(
                    self.local_values
                    + (self.auxiliary_polys or [])
                    + (self.quotient_polys or [])
                )
            ),
            FriOpeningBatch(
                values=self.next_values + (self.auxiliary_polys_next or [])
            ),
        ]
        if self.ctl_zs_first is not None:
            batches.append(
                FriOpeningBatch(values=[(v, 0) for v in self.ctl_zs_first])
            )
        return FriOpenings(batches=batches)


@dataclass
class StarkProof:
    trace_cap: np.ndarray
    auxiliary_polys_cap: Optional[np.ndarray]
    quotient_polys_cap: Optional[np.ndarray]
    openings: StarkOpeningSet
    opening_proof: FriProof


@dataclass
class StarkProofWithPublicInputs:
    proof: StarkProof
    public_inputs: List[int]


@dataclass
class StarkProofChallenges:
    lookup_challenges: Optional[List[int]]
    stark_alphas_prime: List[int]
    simulating_zetas: List[Ext]
    stark_zeta_prime: Ext
    stark_alphas: List[int]
    stark_zeta: Ext
    fri_challenges: object

"""Proof containers (reference: plonky2/src/plonk/proof.rs:32-369)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..fri.proof import FriProof
from ..fri.structure import FriOpeningBatch, FriOpenings

Ext = Tuple[int, ...]


@dataclass
class OpeningSet:
    constants: List[Ext]
    plonk_sigmas: List[Ext]
    wires: List[Ext]
    plonk_zs: List[Ext]
    plonk_zs_next: List[Ext]
    partial_products: List[Ext]
    quotient_polys: List[Ext]
    lookup_zs: List[Ext]
    lookup_zs_next: List[Ext]

    def to_fri_openings(self) -> FriOpenings:
        zeta_batch = FriOpeningBatch(
            self.constants
            + self.plonk_sigmas
            + self.wires
            + self.plonk_zs
            + self.partial_products
            + self.quotient_polys
            + self.lookup_zs
        )
        zeta_next_batch = FriOpeningBatch(self.plonk_zs_next + self.lookup_zs_next)
        return FriOpenings([zeta_batch, zeta_next_batch])


@dataclass
class Proof:
    wires_cap: np.ndarray  # [2^cap_height, 4] u64
    plonk_zs_partial_products_cap: np.ndarray
    quotient_polys_cap: np.ndarray
    openings: OpeningSet
    opening_proof: FriProof


@dataclass
class ProofWithPublicInputs:
    proof: Proof
    public_inputs: List[int]

    def get_public_inputs_hash(self, gc=None) -> Tuple[int, int, int, int]:
        if gc is not None:
            return gc.inner_hasher.hash_no_pad(self.public_inputs)
        from ..hash import poseidon as hp

        return hp.hash_no_pad(self.public_inputs)


@dataclass
class ProofChallenges:
    plonk_betas: List[int]
    plonk_gammas: List[int]
    plonk_alphas: List[int]
    plonk_deltas: List[int]
    plonk_zeta: Ext
    fri_challenges: object

"""FRI proof containers (host side).

Mirrors reference core/src/fri_proof.rs:24-85 (FriQueryStep /
FriInitialTreeProof / FriQueryRound / FriProof). Values are exact host
ints / numpy u64; caps are [2^cap_height, 4] u64 arrays. Compression
(path dedup + redundancy stripping) is tracked for a later round.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

Digest = Tuple[int, int, int, int]
Ext = Tuple[int, ...]


@dataclass
class MerkleProof:
    siblings: List[Digest]


@dataclass
class FriInitialTreeProof:
    # per oracle: (leaf values, merkle proof)
    evals_proofs: List[Tuple[List[int], MerkleProof]]

    def unsalted_eval(self, oracle_index: int, poly_index: int, salted: bool) -> int:
        evals = self.evals_proofs[oracle_index][0]
        if salted:
            evals = evals[:-4]  # SALT_SIZE
        return evals[poly_index]


@dataclass
class FriQueryStep:
    evals: List[Ext]
    merkle_proof: MerkleProof


@dataclass
class FriQueryRound:
    initial_trees_proof: FriInitialTreeProof
    steps: List[FriQueryStep]


@dataclass
class FriProof:
    commit_phase_merkle_caps: List[np.ndarray]  # each [2^cap_height, 4] u64
    query_round_proofs: List[FriQueryRound]
    final_poly: List[Ext]
    pow_witness: int

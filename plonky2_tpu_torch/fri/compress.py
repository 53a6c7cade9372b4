"""Compressed FRI proofs: query-round dedup, Merkle path compression and
inferable-eval removal (reference: core/src/fri_proof.rs:85-290).

A folding step stores one coset's evaluations once, without the element
that the first query to meet it can infer. ``decompress_fri_proof`` takes
the completed cosets; plonk/compressed_proof.py infers the missing elements
and completes them."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from ..hash.path_compression import (
    compress_merkle_proofs,
    decompress_merkle_proofs,
)
from .config import FriParams
from .proof import (
    FriInitialTreeProof,
    FriProof,
    FriQueryRound,
    FriQueryStep,
    MerkleProof,
)

Ext = Tuple[int, ...]


@dataclass
class CompressedFriQueryRounds:
    indices: List[int]
    initial_trees_proofs: Dict[int, FriInitialTreeProof]
    steps: List[Dict[int, FriQueryStep]]


@dataclass
class CompressedFriProof:
    commit_phase_merkle_caps: List
    query_round_proofs: CompressedFriQueryRounds
    final_poly: List[Ext]
    pow_witness: int


def compress_fri_proof(
    proof: FriProof, indices: Sequence[int], params: FriParams
) -> CompressedFriProof:
    cap_height = params.config.cap_height
    rab = params.reduction_arity_bits
    num_reductions = len(rab)
    num_initial = len(proof.query_round_proofs[0].initial_trees_proof.evals_proofs)

    it_indices = [[] for _ in range(num_initial)]
    it_leaves = [[] for _ in range(num_initial)]
    it_proofs = [[] for _ in range(num_initial)]
    st_indices = [[] for _ in range(num_reductions)]
    st_evals = [[] for _ in range(num_reductions)]
    st_proofs = [[] for _ in range(num_reductions)]

    for index, qrp in zip(indices, proof.query_round_proofs):
        for i, (leaves, mp) in enumerate(qrp.initial_trees_proof.evals_proofs):
            it_indices[i].append(index)
            it_leaves[i].append(leaves)
            it_proofs[i].append(mp.siblings)
        for i, step in enumerate(qrp.steps):
            within = index & ((1 << rab[i]) - 1)
            index >>= rab[i]
            st_indices[i].append(index)
            evals = list(step.evals)
            evals.pop(within)
            st_evals[i].append(evals)
            st_proofs[i].append(step.merkle_proof.siblings)

    it_comp = [
        compress_merkle_proofs(cap_height, idx, ps)
        for idx, ps in zip(it_indices, it_proofs)
    ]
    st_comp = [
        compress_merkle_proofs(cap_height, idx, ps)
        for idx, ps in zip(st_indices, st_proofs)
    ]

    cqr = CompressedFriQueryRounds(
        indices=list(indices),
        initial_trees_proofs={},
        steps=[{} for _ in range(num_reductions)],
    )
    for qi, index in enumerate(indices):
        if index not in cqr.initial_trees_proofs:
            cqr.initial_trees_proofs[index] = FriInitialTreeProof(
                evals_proofs=[
                    (it_leaves[j][qi], MerkleProof(it_comp[j][qi]))
                    for j in range(num_initial)
                ]
            )
        for j in range(num_reductions):
            index >>= rab[j]
            if index not in cqr.steps[j]:
                cqr.steps[j][index] = FriQueryStep(
                    evals=st_evals[j][qi],
                    merkle_proof=MerkleProof(st_comp[j][qi]),
                )
    return CompressedFriProof(
        commit_phase_merkle_caps=proof.commit_phase_merkle_caps,
        query_round_proofs=cqr,
        final_poly=proof.final_poly,
        pow_witness=proof.pow_witness,
    )


def decompress_fri_proof(
    cproof: CompressedFriProof,
    indices: Sequence[int],
    step_evals: Sequence[Dict[int, List[Ext]]],
    params: FriParams,
) -> FriProof:
    """step_evals[j][coset]: the full evaluations of folding step j's coset,
    for every coset the queries meet."""
    cap_height = params.config.cap_height
    rab = params.reduction_arity_bits
    num_reductions = len(rab)
    lde_bits = params.lde_bits

    first = cproof.query_round_proofs.initial_trees_proofs[indices[0]]
    num_initial = len(first.evals_proofs)

    # Reassemble per-occurrence compressed sibling lists + leaves, then
    # decompress per tree.
    it_leaves = [[] for _ in range(num_initial)]
    it_comp = [[] for _ in range(num_initial)]
    it_indices = [[] for _ in range(num_initial)]
    st_evals_full = [[] for _ in range(num_reductions)]
    st_comp = [[] for _ in range(num_reductions)]
    st_indices = [[] for _ in range(num_reductions)]

    seen_init = set()
    seen_steps = [set() for _ in range(num_reductions)]
    for index in indices:
        ip = cproof.query_round_proofs.initial_trees_proofs[index]
        fresh = index not in seen_init
        seen_init.add(index)
        for j in range(num_initial):
            it_indices[j].append(index)
            it_leaves[j].append(ip.evals_proofs[j][0])
            it_comp[j].append(ip.evals_proofs[j][1].siblings if fresh else [])
        idx = index
        for j in range(num_reductions):
            idx >>= rab[j]
            step = cproof.query_round_proofs.steps[j][idx]
            fresh_s = idx not in seen_steps[j]
            seen_steps[j].add(idx)
            st_evals_full[j].append(list(step_evals[j][idx]))
            st_comp[j].append(step.merkle_proof.siblings if fresh_s else [])
            st_indices[j].append(idx)

    it_full = [
        decompress_merkle_proofs(
            it_leaves[j], it_indices[j], it_comp[j], lde_bits, cap_height
        )
        for j in range(num_initial)
    ]
    bits = lde_bits
    st_full = []
    for j in range(num_reductions):
        bits -= rab[j]
        st_full.append(
            decompress_merkle_proofs(
                [[c for e in evals for c in e] for evals in st_evals_full[j]],
                st_indices[j],
                st_comp[j],
                bits,
                cap_height,
            )
        )

    rounds = []
    for qi in range(len(indices)):
        initial = FriInitialTreeProof(
            evals_proofs=[
                (it_leaves[j][qi], MerkleProof(it_full[j][qi]))
                for j in range(num_initial)
            ]
        )
        steps = [
            FriQueryStep(
                evals=[tuple(e) for e in st_evals_full[j][qi]],
                merkle_proof=MerkleProof(st_full[j][qi]),
            )
            for j in range(num_reductions)
        ]
        rounds.append(FriQueryRound(initial_trees_proof=initial, steps=steps))

    return FriProof(
        commit_phase_merkle_caps=cproof.commit_phase_merkle_caps,
        query_round_proofs=rounds,
        final_poly=cproof.final_poly,
        pow_witness=cproof.pow_witness,
    )

"""Compressed proofs: Merkle path dedup + FRI redundancy removal
(reference: plonk/proof.rs:130-250 CompressedProofWithPublicInputs)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from ..fri import verifier as fv
from ..fri.compress import (
    CompressedFriProof,
    compress_fri_proof,
    decompress_fri_proof,
)
from .proof import OpeningSet, Proof, ProofWithPublicInputs
from .verifier import get_challenges, verify


@dataclass
class CompressedProof:
    wires_cap: object
    plonk_zs_partial_products_cap: object
    quotient_polys_cap: object
    openings: OpeningSet
    opening_proof: CompressedFriProof


@dataclass
class CompressedProofWithPublicInputs:
    proof: CompressedProof
    public_inputs: List[int]


def compress_proof(
    pwp: ProofWithPublicInputs, verifier_data, common
) -> CompressedProofWithPublicInputs:
    pis_hash = pwp.get_public_inputs_hash()
    challenges = get_challenges(pwp, pis_hash, verifier_data.circuit_digest, common)
    indices = challenges.fri_challenges.fri_query_indices
    cfri = compress_fri_proof(pwp.proof.opening_proof, indices, common.fri_params)
    return CompressedProofWithPublicInputs(
        CompressedProof(
            wires_cap=pwp.proof.wires_cap,
            plonk_zs_partial_products_cap=pwp.proof.plonk_zs_partial_products_cap,
            quotient_polys_cap=pwp.proof.quotient_polys_cap,
            openings=pwp.proof.openings,
            opening_proof=cfri,
        ),
        list(pwp.public_inputs),
    )


def decompress_proof(
    cpwp: CompressedProofWithPublicInputs, verifier_data, common
) -> ProofWithPublicInputs:
    """Rebuild the full proof: recompute challenges from the compressed
    transcript (identical), infer the omitted evaluations, decompress."""
    # Challenges depend only on caps/openings/final poly/pow — identical
    # between compressed and full forms.
    proxy = ProofWithPublicInputs(
        Proof(
            wires_cap=cpwp.proof.wires_cap,
            plonk_zs_partial_products_cap=cpwp.proof.plonk_zs_partial_products_cap,
            quotient_polys_cap=cpwp.proof.quotient_polys_cap,
            openings=cpwp.proof.openings,
            opening_proof=_fri_proxy(cpwp.proof.opening_proof),
        ),
        list(cpwp.public_inputs),
    )
    pis_hash = proxy.get_public_inputs_hash()
    challenges = get_challenges(proxy, pis_hash, verifier_data.circuit_digest, common)
    indices = challenges.fri_challenges.fri_query_indices

    instance = common.get_fri_instance(challenges.plonk_zeta)
    openings = cpwp.proof.openings.to_fri_openings()
    step_evals = _completed_step_evals(
        instance, openings, challenges.fri_challenges, cpwp.proof.opening_proof,
        indices, common.fri_params,
    )
    full_fri = decompress_fri_proof(
        cpwp.proof.opening_proof, indices, step_evals, common.fri_params
    )
    return ProofWithPublicInputs(
        Proof(
            wires_cap=cpwp.proof.wires_cap,
            plonk_zs_partial_products_cap=cpwp.proof.plonk_zs_partial_products_cap,
            quotient_polys_cap=cpwp.proof.quotient_polys_cap,
            openings=cpwp.proof.openings,
            opening_proof=full_fri,
        ),
        list(cpwp.public_inputs),
    )


class _FriProxy:
    """Duck-typed stand-in exposing the transcript-relevant FRI fields."""

    def __init__(self, c: CompressedFriProof):
        self.commit_phase_merkle_caps = c.commit_phase_merkle_caps
        self.final_poly = c.final_poly
        self.pow_witness = c.pow_witness


def _fri_proxy(c: CompressedFriProof):
    return _FriProxy(c)


def _completed_step_evals(
    instance, openings, fri_challenges, cfri, indices, params
) -> List[Dict[int, List]]:
    """The full evaluations of every folding step's coset that the queries
    meet, by step and coset: the stored evaluations with the element that
    the first query to meet the coset infers put back (the fold chain needs
    only the initial evaluations and the step evaluations, all present).

    Two queries may meet one coset at different positions. The coset is
    completed from the first one's element and serves both; the JAX package
    inserts the second query's element into the first one's list, and its
    decompressed proof fails its Merkle check. The compressed bytes are the
    same in both."""
    from ..field import goldilocks as gl
    from ..utils.bits import log2_strict, reverse_bits

    n = params.lde_size
    log_n = log2_strict(n)
    rab = params.reduction_arity_bits
    precomputed = fv.PrecomputedReducedOpenings(openings, fri_challenges.fri_alpha)
    full_steps = [{} for _ in rab]
    for x_index in indices:
        subgroup_x = gl.gmul(
            gl.MULTIPLICATIVE_GROUP_GENERATOR,
            gl.gexp(gl.primitive_root_of_unity(log_n), reverse_bits(x_index, log_n)),
        )
        old_eval = fv.fri_combine_initial(
            instance, cfri.query_round_proofs.initial_trees_proofs[x_index],
            fri_challenges.fri_alpha, subgroup_x, precomputed, params,
        )
        idx = x_index
        for i, arity_bits in enumerate(rab):
            arity = 1 << arity_bits
            within = idx & (arity - 1)
            coset_index = idx >> arity_bits
            if coset_index not in full_steps[i]:
                evals = list(cfri.query_round_proofs.steps[i][coset_index].evals)
                evals.insert(within, tuple(old_eval))
                full_steps[i][coset_index] = evals
            evals = full_steps[i][coset_index]
            old_eval = fv.compute_evaluation(
                subgroup_x, within, arity_bits, evals, fri_challenges.fri_betas[i]
            )
            subgroup_x = gl.exp_power_of_2(subgroup_x, arity_bits)
            idx = coset_index
    return full_steps


def verify_compressed_proof(cpwp, verifier_data, common) -> None:
    full = decompress_proof(cpwp, verifier_data, common)
    verify(full, verifier_data, common)

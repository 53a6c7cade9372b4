"""Native proof verification + challenge derivation
(reference: plonky2/src/plonk/verifier.rs:17-120, get_challenges.rs:29-101).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..field import extension as ge
from ..field import goldilocks as gl
from ..fri import verifier as fv
from ..hash.challenger import Challenger
from .circuit_data import CommonCircuitData, VerifierOnlyCircuitData
from .proof import ProofChallenges, ProofWithPublicInputs
from .vanishing import NUM_COINS_LOOKUP, eval_vanishing_poly_host


class VerificationError(Exception):
    pass


def _ensure(cond, msg):
    if not cond:
        raise VerificationError(msg)


def get_challenges(
    proof_with_pis: ProofWithPublicInputs,
    public_inputs_hash,
    circuit_digest,
    common: CommonCircuitData,
    gc=None,
) -> ProofChallenges:
    from .generic_config import poseidon_goldilocks_config

    gc = gc or poseidon_goldilocks_config()
    proof = proof_with_pis.proof
    nc = common.config.num_challenges
    ch = Challenger(permutation=gc.hasher.permutation)
    common.fri_params.observe(ch)
    ch.observe_hash(circuit_digest)
    ch.observe_hash(public_inputs_hash)
    ch.observe_cap(proof.wires_cap)
    plonk_betas = ch.get_n_challenges(nc)
    plonk_gammas = ch.get_n_challenges(nc)
    if common.num_lookup_polys:
        additional = ch.get_n_challenges(NUM_COINS_LOOKUP * nc - 2 * nc)
        plonk_deltas = plonk_betas + plonk_gammas + additional
    else:
        plonk_deltas = []
    ch.observe_cap(proof.plonk_zs_partial_products_cap)
    plonk_alphas = ch.get_n_challenges(nc)
    ch.observe_cap(proof.quotient_polys_cap)
    plonk_zeta = ch.get_extension_challenge(2)
    fri_openings = proof.openings.to_fri_openings()
    for batch in fri_openings.batches:
        ch.observe_extension_elements(batch.values)
    fri_challenges = fv.fri_challenges(
        ch,
        proof.opening_proof.commit_phase_merkle_caps,
        proof.opening_proof.final_poly,
        proof.opening_proof.pow_witness,
        common.public_initial_degree_bits,
        common.config.fri_config,
    )
    return ProofChallenges(
        plonk_betas, plonk_gammas, plonk_alphas, plonk_deltas, plonk_zeta, fri_challenges
    )


def verify(
    proof_with_pis: ProofWithPublicInputs,
    verifier_data: VerifierOnlyCircuitData,
    common: CommonCircuitData,
    gc=None,
) -> None:
    from .generic_config import poseidon_goldilocks_config

    from .validate_shape import ProofShapeError, validate_proof_with_pis_shape

    gc = gc or poseidon_goldilocks_config()
    proof = proof_with_pis.proof
    # deliberate structural rejection before any value is consumed
    # (reference: plonk/validate_shape.rs via verifier.rs:22)
    try:
        validate_proof_with_pis_shape(proof_with_pis, common)
    except ProofShapeError as e:
        raise VerificationError(f"malformed proof shape: {e}") from e
    public_inputs_hash = proof_with_pis.get_public_inputs_hash(gc)
    challenges = get_challenges(
        proof_with_pis, public_inputs_hash, verifier_data.circuit_digest, common, gc=gc
    )
    verify_with_challenges(
        proof, public_inputs_hash, challenges, verifier_data, common, gc=gc
    )


def verify_with_challenges(
    proof,
    public_inputs_hash,
    challenges: ProofChallenges,
    verifier_data: VerifierOnlyCircuitData,
    common: CommonCircuitData,
    gc=None,
) -> None:
    o = proof.openings
    zeta = challenges.plonk_zeta
    vanishing = eval_vanishing_poly_host(
        common,
        zeta,
        o.constants,
        o.wires,
        public_inputs_hash,
        o.plonk_zs,
        o.plonk_zs_next,
        o.partial_products,
        o.plonk_sigmas,
        challenges.plonk_betas,
        challenges.plonk_gammas,
        challenges.plonk_alphas,
        local_lookup_zs=o.lookup_zs,
        next_lookup_zs=o.lookup_zs_next,
        deltas=challenges.plonk_deltas,
    )

    # vanishing(zeta) == Z_H(zeta) * t(zeta), per challenge
    zeta_pow_deg = ge.ext_exp(zeta, common.degree)
    z_h_zeta = ge.ext_sub(zeta_pow_deg, ge.ext_one(2))
    qdf = common.quotient_degree_factor
    for i in range(common.config.num_challenges):
        chunk = o.quotient_polys[i * qdf : (i + 1) * qdf]
        acc = ge.ext_zero(2)
        for c in reversed(chunk):
            acc = ge.ext_add(ge.ext_mul(acc, zeta_pow_deg), c)
        _ensure(
            vanishing[i] == ge.ext_mul(z_h_zeta, acc),
            f"quotient identity failed for challenge {i}",
        )

    merkle_caps = [
        verifier_data.constants_sigmas_cap,
        proof.wires_cap,
        proof.plonk_zs_partial_products_cap,
        proof.quotient_polys_cap,
    ]
    fv.verify_fri_proof(
        common.get_fri_instance(zeta),
        o.to_fri_openings(),
        challenges.fri_challenges,
        merkle_caps,
        proof.opening_proof,
        common.fri_params,
        hasher=gc.hasher if gc is not None else None,
    )

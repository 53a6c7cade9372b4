"""STARK verification on the host (reference: starky/src/verifier.rs:30-280,
get_challenges.rs; plonky2_tpu/stark/verifier.py), for a single table
without lookups, cross-table lookups or zero knowledge."""

from __future__ import annotations

from ..field import extension as ge
from ..field import goldilocks as gl
from ..fri import verifier as fv
from ..hash.challenger import Challenger
from .config import StarkConfig
from .proof import StarkProofChallenges, StarkProofWithPublicInputs
from .prover import verifier_circuit_padding
from .stark import Stark
from .vanishing import eval_vanishing_at_point, run_binding_step


class StarkVerificationError(Exception):
    pass


def _ensure(cond, msg):
    if not cond:
        raise StarkVerificationError(msg)


def get_challenges(
    stark: Stark,
    config: StarkConfig,
    proof_with_pis: StarkProofWithPublicInputs,
    degree_bits: int,
    verifier_circuit_fri_params=None,
) -> StarkProofChallenges:
    """Recompute the transcript (get_challenges.rs:36-199), padded as the
    prover padded it for a unified recursive verifier."""
    proof = proof_with_pis.proof
    _ensure(proof.auxiliary_polys_cap is None, "auxiliary polynomials are not ported")
    ch = Challenger()
    ch.observe_elements([p % gl.P for p in proof_with_pis.public_inputs])
    config.observe(ch)
    ch.observe_cap(proof.trace_cap)

    alphas_prime = ch.get_n_challenges(config.num_challenges)
    alphas = run_binding_step(
        stark, ch, proof_with_pis.public_inputs, alphas_prime, degree_bits
    )
    ch.observe_cap(proof.quotient_polys_cap)
    zeta = ch.get_extension_challenge(2)
    for batch in proof.openings.to_fri_openings().batches:
        ch.observe_extension_elements(batch.values)
    fpcl, mnqs = verifier_circuit_padding(verifier_circuit_fri_params)
    fri_challenges = fv.fri_challenges(
        ch,
        proof.opening_proof.commit_phase_merkle_caps,
        proof.opening_proof.final_poly,
        proof.opening_proof.pow_witness,
        degree_bits,
        config.fri_config,
        final_poly_coeff_len=fpcl,
        max_num_query_steps=mnqs,
    )
    return StarkProofChallenges(
        lookup_challenges=None,
        stark_alphas_prime=alphas_prime,
        simulating_zetas=[],
        stark_zeta_prime=(0, 0),
        stark_alphas=alphas,
        stark_zeta=zeta,
        fri_challenges=fri_challenges,
    )


def verify_stark_proof_with_challenges(
    stark: Stark,
    proof_with_pis: StarkProofWithPublicInputs,
    challenges: StarkProofChallenges,
    config: StarkConfig,
    degree_bits: int,
) -> None:
    """Check the quotient identity at zeta and the FRI opening proof
    (verifier.rs:68-280)."""
    proof = proof_with_pis.proof
    o = proof.openings
    zeta = challenges.stark_zeta
    vanishing = eval_vanishing_at_point(
        stark, o, proof_with_pis.public_inputs, challenges.stark_alphas, zeta,
        degree_bits,
    )

    zeta_pow_deg = ge.ext_exp(zeta, 1 << degree_bits)
    z_h_zeta = ge.ext_sub(zeta_pow_deg, ge.ext_one(2))
    qdf = stark.quotient_degree_factor()
    _ensure(
        len(o.quotient_polys) == qdf * config.num_challenges,
        "wrong number of quotient openings",
    )
    for i in range(config.num_challenges):
        chunk = o.quotient_polys[i * qdf : (i + 1) * qdf]
        acc = ge.ext_zero(2)
        for c in reversed(chunk):
            acc = ge.ext_add(ge.ext_mul(acc, zeta_pow_deg), c)
        _ensure(
            vanishing[i] == ge.ext_mul(z_h_zeta, acc),
            f"quotient identity failed for challenge {i}",
        )

    g = gl.primitive_root_of_unity(degree_bits)
    instance = stark.fri_instance(zeta, g, config)
    fv.verify_fri_proof(
        instance,
        o.to_fri_openings(),
        challenges.fri_challenges,
        [proof.trace_cap, proof.quotient_polys_cap],
        proof.opening_proof,
        config.fri_config.fri_params(degree_bits, leaf_hiding=False),
    )


def verify_stark_proof(
    stark: Stark,
    proof_with_pis: StarkProofWithPublicInputs,
    config: StarkConfig,
    degree_bits: int,
    verifier_circuit_fri_params=None,
) -> None:
    """verifier_circuit_fri_params: when the proof was made with its FRI
    transcript padded for a unified recursive verifier, the host verifier
    replays the same padded transcript."""
    _ensure(
        len(proof_with_pis.public_inputs) == stark.num_public_inputs(),
        "wrong number of public inputs",
    )
    _ensure(not stark.uses_lookups(), "STARK lookups are not ported")
    challenges = get_challenges(
        stark, config, proof_with_pis, degree_bits,
        verifier_circuit_fri_params=verifier_circuit_fri_params,
    )
    verify_stark_proof_with_challenges(
        stark, proof_with_pis, challenges, config, degree_bits
    )

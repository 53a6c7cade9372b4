"""STARK verification on the host (reference: starky/src/verifier.rs:30-280,
get_challenges.rs; plonky2_tpu/stark/verifier.py): a single table with or
without logUp lookups, a table of a CTL system (given the shared CTL
challenges and its entry layout: stark/multi.py), and zero-knowledge
proofs."""

from __future__ import annotations

from typing import Optional

from ..field import extension as ge
from ..field import goldilocks as gl
from ..fri import verifier as fv
from ..hash.challenger import Challenger
from .config import StarkConfig
from .lookup import get_grand_product_challenge_set
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
    challenger: Optional[Challenger] = None,
    ctl_challenges=None,
    ctl_entries=None,
    verifier_circuit_fri_params=None,
) -> StarkProofChallenges:
    """Recompute the transcript (get_challenges.rs:36-199), padded as the
    prover padded it for a unified recursive verifier. When ``challenger``
    is given, the caller has already observed the head (config, public
    inputs, trace cap) — the multi-STARK case."""
    proof = proof_with_pis.proof
    nc = config.num_challenges
    if challenger is None:
        ch = Challenger()
        ch.observe_elements([p % gl.P for p in proof_with_pis.public_inputs])
        config.observe(ch)
        ch.observe_cap(proof.trace_cap)
    else:
        ch = challenger

    # lookup challenges are drawn before the aux cap is observed
    # (get_challenges.rs:66-81); a table of a CTL system takes the CTL set
    lookup_challenge_set = None
    if ctl_challenges is not None:
        lookup_challenge_set = ctl_challenges
    elif proof.auxiliary_polys_cap is not None:
        lookup_challenge_set = get_grand_product_challenge_set(ch, nc)
    lookup_challenges = None
    if stark.uses_lookups():
        _ensure(lookup_challenge_set is not None, "a lookup STARK proof without auxiliary polynomials")
        lookup_challenges = [c.beta for c in lookup_challenge_set.challenges]
    if proof.auxiliary_polys_cap is not None:
        ch.observe_cap(proof.auxiliary_polys_cap)

    alphas_prime = ch.get_n_challenges(nc)
    num_aux = (
        len(proof.openings.auxiliary_polys)
        if proof.openings.auxiliary_polys is not None
        else 0
    )
    alphas = run_binding_step(
        stark,
        ch,
        proof_with_pis.public_inputs,
        alphas_prime,
        degree_bits,
        num_aux=num_aux,
        lookup_challenges=lookup_challenges,
        num_lookup_columns=stark.num_lookup_helper_columns(config),
        ctl_entries=ctl_entries,
        ctl_challenges=ctl_challenges,
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
        lookup_challenges=lookup_challenges,
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
    ctl_challenges=None,
    ctl_entries=None,
    num_ctl_helpers: int = 0,
    num_ctl_zs: int = 0,
    zero_knowledge: bool = False,
) -> None:
    """Check the quotient identity at zeta and the FRI opening proof
    (verifier.rs:68-280)."""
    proof = proof_with_pis.proof
    o = proof.openings
    zeta = challenges.stark_zeta
    num_lookup_columns = stark.num_lookup_helper_columns(config)
    num_aux = num_lookup_columns + num_ctl_helpers + num_ctl_zs
    if stark.uses_lookups() or stark.requires_ctls():
        _ensure(
            o.auxiliary_polys is not None
            and len(o.auxiliary_polys) == num_aux
            and len(o.auxiliary_polys_next) == num_aux,
            "wrong number of auxiliary openings",
        )
    vanishing = eval_vanishing_at_point(
        stark,
        o,
        proof_with_pis.public_inputs,
        challenges.stark_alphas,
        zeta,
        degree_bits,
        lookup_challenges=challenges.lookup_challenges,
        num_lookup_columns=num_lookup_columns,
        ctl_entries=ctl_entries,
        ctl_challenges=ctl_challenges,
    )

    zeta_pow_deg = ge.ext_exp(zeta, 1 << degree_bits)
    z_h_zeta = ge.ext_sub(zeta_pow_deg, ge.ext_one(2))
    # zero knowledge: one extra chunk a challenge (verifier.rs:143)
    qdf = stark.quotient_degree_factor() + (1 if zero_knowledge else 0)
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
    instance = stark.fri_instance(
        zeta, g, config, num_ctl_helpers=num_ctl_helpers, num_ctl_zs=num_ctl_zs,
        zk_degree=(1 << degree_bits) if zero_knowledge else 0,
    )
    merkle_caps = [proof.trace_cap]
    if proof.auxiliary_polys_cap is not None:
        merkle_caps.append(proof.auxiliary_polys_cap)
    merkle_caps.append(proof.quotient_polys_cap)
    fv.verify_fri_proof(
        instance,
        o.to_fri_openings(),
        challenges.fri_challenges,
        merkle_caps,
        proof.opening_proof,
        config.fri_config.fri_params(degree_bits, leaf_hiding=zero_knowledge),
    )


def verify_stark_proof(
    stark: Stark,
    proof_with_pis: StarkProofWithPublicInputs,
    config: StarkConfig,
    degree_bits: int,
    verifier_circuit_fri_params=None,
    zero_knowledge: bool = False,
) -> None:
    """verifier_circuit_fri_params: when the proof was made with its FRI
    transcript padded for a unified recursive verifier, the host verifier
    replays the same padded transcript. zero_knowledge: the proof commits
    Z_H-masked split trace halves with salted leaves (stark/prover.py
    prove)."""
    _ensure(
        len(proof_with_pis.public_inputs) == stark.num_public_inputs(),
        "wrong number of public inputs",
    )
    challenges = get_challenges(
        stark, config, proof_with_pis, degree_bits,
        verifier_circuit_fri_params=verifier_circuit_fri_params,
    )
    verify_stark_proof_with_challenges(
        stark, proof_with_pis, challenges, config, degree_bits,
        zero_knowledge=zero_knowledge,
    )

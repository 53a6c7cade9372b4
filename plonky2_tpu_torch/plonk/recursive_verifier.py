"""In-circuit verification of a plonky2 proof (reference:
plonky2/src/recursion/recursive_verifier.rs:20-136,
plonk/get_challenges.rs circuit duals, plonk/vanishing_poly.rs:728).

The vanishing-polynomial evaluation reuses the single-source constraint
terms (_vanishing_terms) instantiated with CircuitAlgebra, so every
gate's in-circuit constraint evaluation comes from the same code as the
prover kernel and host verifier.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..field import goldilocks as gl
from ..fri.recursive_verifier import (
    FriChallengesTarget,
    FriInstanceInfoTarget,
    fri_challenges_circuit,
    verify_fri_proof_circuit,
)
from ..gates.algebra import CircuitAlgebra
from ..hash.recursive_challenger import RecursiveChallenger
from ..iop.target import ExtensionTarget, Target
from .circuit_data import CommonCircuitData
from .gadgets import ReducingFactorTarget
from .proof_target import (
    MerkleCapTarget,
    ProofWithPublicInputsTarget,
    add_virtual_cap,
)
from .vanishing import _vanishing_terms


@dataclass
class VerifierCircuitTarget:
    constants_sigmas_cap: MerkleCapTarget
    circuit_digest: List[Target]


def add_virtual_verifier_data(builder, cap_height: int) -> VerifierCircuitTarget:
    return VerifierCircuitTarget(
        constants_sigmas_cap=add_virtual_cap(builder, cap_height),
        circuit_digest=builder.add_virtual_targets(4),
    )


def set_verifier_data_target(pw, vd_t: VerifierCircuitTarget, verifier_data) -> None:
    for hs, row in zip(vd_t.constants_sigmas_cap.hashes, verifier_data.constants_sigmas_cap):
        for t, v in zip(hs, row):
            pw.set_target(t, int(v))
    for t, v in zip(vd_t.circuit_digest, verifier_data.circuit_digest):
        pw.set_target(t, int(v))


@dataclass
class ProofChallengesTarget:
    plonk_betas: List[Target]
    plonk_gammas: List[Target]
    plonk_alphas: List[Target]
    plonk_zeta: ExtensionTarget
    fri_challenges: FriChallengesTarget
    plonk_deltas: List[Target] = None


def _observe_fri_params(builder, challenger: RecursiveChallenger, params) -> None:
    """FriParamsObserve as circuit constants (core/src/fri.rs:302-321)."""
    vals = [
        params.config.rate_bits,
        params.config.cap_height,
        params.config.proof_of_work_bits,
        *params.config.reduction_strategy.serialize(),
        params.config.num_query_rounds,
        1 if params.leaf_hiding else 0,
        params.degree_bits,
        *params.reduction_arity_bits,
    ]
    challenger.observe_elements([builder.constant(v) for v in vals])


def get_challenges_circuit(
    builder,
    pwp_t: ProofWithPublicInputsTarget,
    public_inputs_hash: List[Target],
    inner_verifier_data: VerifierCircuitTarget,
    inner_common: CommonCircuitData,
) -> ProofChallengesTarget:
    proof = pwp_t.proof
    nc = inner_common.config.num_challenges
    ch = RecursiveChallenger(builder)
    _observe_fri_params(builder, ch, inner_common.fri_params)
    ch.observe_hash(inner_verifier_data.circuit_digest)
    ch.observe_hash(public_inputs_hash)
    ch.observe_cap(proof.wires_cap)
    plonk_betas = ch.get_n_challenges(nc)
    plonk_gammas = ch.get_n_challenges(nc)
    plonk_deltas = []
    if inner_common.num_lookup_polys:
        from .vanishing import NUM_COINS_LOOKUP

        additional = ch.get_n_challenges(NUM_COINS_LOOKUP * nc - 2 * nc)
        plonk_deltas = plonk_betas + plonk_gammas + additional
    ch.observe_cap(proof.plonk_zs_partial_products_cap)
    plonk_alphas = ch.get_n_challenges(nc)
    ch.observe_cap(proof.quotient_polys_cap)
    plonk_zeta = ch.get_extension_challenge()
    for batch in proof.openings.to_fri_openings():
        ch.observe_extension_elements(batch)
    fri_ch = fri_challenges_circuit(
        builder,
        ch,
        proof.opening_proof.commit_phase_merkle_caps,
        proof.opening_proof.final_poly,
        proof.opening_proof.pow_witness,
        inner_common.fri_params.config,
    )
    return ProofChallengesTarget(
        plonk_betas, plonk_gammas, plonk_alphas, plonk_zeta, fri_ch, plonk_deltas
    )


def eval_vanishing_poly_circuit(
    builder,
    inner_common: CommonCircuitData,
    zeta: ExtensionTarget,
    openings,
    public_inputs_hash: List[Target],
    betas: List[Target],
    gammas: List[Target],
    alphas: List[Target],
    deltas: List[Target] = (),
) -> List[ExtensionTarget]:
    A = CircuitAlgebra(builder)
    n = inner_common.degree

    zeta_pow_n = builder.exp_power_of_2_extension(zeta, inner_common.degree_bits)
    one = builder.one_extension()
    z_h = builder.sub_extension(zeta_pow_n, one)
    den = builder.constant_scalar_mul_ext(n % gl.P, builder.sub_extension(zeta, one))
    l_0 = builder.div_extension(z_h, den)

    lut_evals = None
    if inner_common.num_lookup_polys:
        from .vanishing import NUM_COINS_LOOKUP, get_lut_poly_eval_circuit

        nc2 = inner_common.config.num_challenges
        num_lut_slots = inner_common.config.num_routed_wires // 3
        lut_evals = []
        for i in range(nc2):
            d4 = deltas[NUM_COINS_LOOKUP * i : NUM_COINS_LOOKUP * (i + 1)]
            evals_i = []
            for li in range(len(inner_common.luts)):
                rows = -(-len(inner_common.luts[li]) // num_lut_slots)
                degree = rows * num_lut_slots
                t = get_lut_poly_eval_circuit(builder, inner_common, li, d4, degree)
                evals_i.append(builder.convert_to_ext(t))
            lut_evals.append(evals_i)
    terms = _vanishing_terms(
        inner_common,
        A,
        zeta,
        l_0,
        list(openings.constants),
        list(openings.wires),
        [builder.convert_to_ext(t) for t in public_inputs_hash],
        list(openings.plonk_zs),
        list(openings.plonk_zs_next),
        list(openings.partial_products),
        list(openings.plonk_sigmas),
        [builder.convert_to_ext(t) for t in betas],
        [builder.convert_to_ext(t) for t in gammas],
        one,
        local_lookup_zs=list(openings.lookup_zs) or None,
        next_lookup_zs=list(openings.lookup_zs_next) or None,
        deltas=[builder.convert_to_ext(t) for t in deltas] or None,
        lut_evals=lut_evals,
    )
    out = []
    for a in alphas:
        rf = ReducingFactorTarget(builder.convert_to_ext(a))
        out.append(rf.reduce(builder, terms))
    return out


def verify_proof_circuit(
    builder,
    pwp_t: ProofWithPublicInputsTarget,
    inner_verifier_data: VerifierCircuitTarget,
    inner_common: CommonCircuitData,
) -> None:
    """builder.verify_proof — the recursion entry point."""
    assert len(pwp_t.public_inputs) == inner_common.num_public_inputs
    public_inputs_hash = builder.hash_n_to_hash_no_pad(list(pwp_t.public_inputs))
    challenges = get_challenges_circuit(
        builder, pwp_t, public_inputs_hash, inner_verifier_data, inner_common
    )
    verify_with_challenges_circuit(
        builder, pwp_t.proof, public_inputs_hash, challenges,
        inner_verifier_data, inner_common,
    )


def verify_with_challenges_circuit(
    builder,
    proof_t,
    public_inputs_hash: List[Target],
    challenges: ProofChallengesTarget,
    inner_verifier_data: VerifierCircuitTarget,
    inner_common: CommonCircuitData,
) -> None:
    o = proof_t.openings
    zeta = challenges.plonk_zeta
    vanishing = eval_vanishing_poly_circuit(
        builder, inner_common, zeta, o, public_inputs_hash,
        challenges.plonk_betas, challenges.plonk_gammas, challenges.plonk_alphas,
        deltas=challenges.plonk_deltas or (),
    )

    zeta_pow_deg = builder.exp_power_of_2_extension(zeta, inner_common.degree_bits)
    one = builder.one_extension()
    z_h_zeta = builder.sub_extension(zeta_pow_deg, one)
    qdf = inner_common.quotient_degree_factor
    for i in range(inner_common.config.num_challenges):
        chunk = o.quotient_polys[i * qdf : (i + 1) * qdf]
        acc = builder.eval_ext_poly_at(list(chunk), zeta_pow_deg)
        rhs = builder.mul_extension(z_h_zeta, acc)
        builder.connect_extension(vanishing[i], rhs)

    # FRI
    g = gl.primitive_root_of_unity(inner_common.degree_bits)
    zeta_next = builder.constant_scalar_mul_ext(g, zeta)
    static_instance = inner_common.get_fri_instance((0, 0))  # points unused
    instance_t = FriInstanceInfoTarget(
        static_info=static_instance, batch_points=[zeta, zeta_next]
    )
    merkle_caps = [
        inner_verifier_data.constants_sigmas_cap,
        proof_t.wires_cap,
        proof_t.plonk_zs_partial_products_cap,
        proof_t.quotient_polys_cap,
    ]
    verify_fri_proof_circuit(
        builder,
        instance_t,
        o.to_fri_openings(),
        challenges.fri_challenges,
        merkle_caps,
        proof_t.opening_proof,
        inner_common.fri_params,
    )

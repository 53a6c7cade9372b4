"""Recursive STARK verification: a STARK proof verified inside a plonky2
circuit (reference: starky/src/recursive_verifier.rs:32-404,
get_challenges.rs circuit duals — including this fork's constraint-
binding transcript step; plonky2_tpu/stark/recursive_verifier.py).

The Stark's constraints evaluate in-circuit through the same
single-source ``Stark.eval`` used by the prover kernel and host
verifier, instantiated with CircuitAlgebra; the logUp constraints of a
lookup STARK through the same eval_lookups. Cross-table lookups stay
outside the circuit, as in the JAX package, whose circuit has no CTL
branch: a STARK that requires CTLs is refused. Gadget code only: it builds
a circuit and launches nothing on a device."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..field import goldilocks as gl
from ..fri.recursive_verifier import (
    FriInstanceInfoTarget,
    fri_challenges_circuit,
    verify_fri_proof_circuit,
    verify_fri_proof_circuit_multi_degree,
)
from ..gates.algebra import CircuitAlgebra
from ..hash.recursive_challenger import RecursiveChallenger
from ..iop.target import ExtensionTarget, Target
from ..plonk.proof_target import (
    MerkleCapTarget,
    add_virtual_cap,
    add_virtual_fri_proof,
    _set_cap,
    _set_exts,
)
from ..utils.bits import log2_ceil
from .config import StarkConfig
from .lookup import LookupCheckVars, get_grand_product_challenge_set_target
from .stark import ConstraintConsumer, Stark, StarkFrame
from .vanishing import eval_vanishing_generic


def _refuse_ctls(stark: Stark) -> None:
    if stark.requires_ctls():
        raise NotImplementedError(
            "recursive verification of a STARK with cross-table lookups: the "
            "JAX package's circuit has no CTL branch either (verify the system "
            "with stark/multi.py verify_all_tables)"
        )


@dataclass
class StarkOpeningSetTarget:
    local_values: List[ExtensionTarget]
    next_values: List[ExtensionTarget]
    quotient_polys: List[ExtensionTarget]
    auxiliary_polys: List[ExtensionTarget] = None
    auxiliary_polys_next: List[ExtensionTarget] = None


@dataclass
class StarkProofTarget:
    trace_cap: MerkleCapTarget
    quotient_polys_cap: MerkleCapTarget
    openings: StarkOpeningSetTarget
    opening_proof: object  # FriProofTarget
    auxiliary_polys_cap: MerkleCapTarget = None
    # runtime degree for unified multi-degree verification
    # (reference proof.rs StarkProofTarget::degree_bits)
    degree_bits: Target = None


@dataclass
class StarkProofWithPublicInputsTarget:
    proof: StarkProofTarget
    public_inputs: List[Target]


def add_virtual_stark_proof_with_pis(
    builder, stark: Stark, config: StarkConfig, degree_bits: int,
    multi_degree: bool = False,
) -> StarkProofWithPublicInputsTarget:
    """degree_bits is the MAX supported degree; with multi_degree the
    proof carries its runtime degree_bits as a target and all FRI
    structures are allocated at the max shape (smaller proofs pad)."""
    _refuse_ctls(stark)
    cap_height = config.fri_config.cap_height

    class _CommonShim:
        fri_params = config.fri_params(degree_bits)

    # the lookup helper and Z columns: the auxiliary oracle
    num_aux = stark.num_lookup_helper_columns(config)
    widths = [stark.num_columns()] + ([num_aux] if num_aux else [])
    fri = add_virtual_fri_proof(
        builder, _CommonShim(), widths=widths + [stark.num_quotient_polys(config)]
    )
    openings = StarkOpeningSetTarget(
        local_values=builder.add_virtual_extension_targets(stark.num_columns()),
        next_values=builder.add_virtual_extension_targets(stark.num_columns()),
        quotient_polys=builder.add_virtual_extension_targets(
            stark.num_quotient_polys(config)
        ),
        auxiliary_polys=(
            builder.add_virtual_extension_targets(num_aux) if num_aux else None
        ),
        auxiliary_polys_next=(
            builder.add_virtual_extension_targets(num_aux) if num_aux else None
        ),
    )
    proof = StarkProofTarget(
        trace_cap=add_virtual_cap(builder, cap_height),
        quotient_polys_cap=add_virtual_cap(builder, cap_height),
        openings=openings,
        opening_proof=fri,
        auxiliary_polys_cap=add_virtual_cap(builder, cap_height) if num_aux else None,
        degree_bits=builder.add_virtual_target() if multi_degree else None,
    )
    pis = builder.add_virtual_targets(stark.num_public_inputs())
    return StarkProofWithPublicInputsTarget(proof, pis)


def _set_sibs_padded(pw, sibs_t, sibs) -> None:
    """Sibling digests, zero-padding target paths longer than the proof's
    (multi-degree: the circuit hashes the full max chain but selects the
    state at the real path length)."""
    for i, sib_t in enumerate(sibs_t):
        sib = sibs[i] if i < len(sibs) else (0, 0, 0, 0)
        for t, v in zip(sib_t, sib):
            pw.set_target(t, int(v))


def set_stark_proof_with_pis_target(
    pw, target: StarkProofWithPublicInputsTarget, pwp, degree_bits: int = None
) -> None:
    """Fill a (possibly larger, multi-degree) proof target from a concrete
    proof. Structures the target has but the proof lacks — commit-phase
    caps/steps of padded FRI rounds, long sibling chains, high final-poly
    coefficients — are zero-filled, matching the zero-cap / zero-coeff
    transcript padding the prover observed."""
    proof = pwp.proof
    for t, v in zip(target.public_inputs, pwp.public_inputs):
        pw.set_target(t, int(v))
    if target.proof.degree_bits is not None:
        assert degree_bits is not None, "multi-degree target needs degree_bits"
        pw.set_target(target.proof.degree_bits, degree_bits)
    _set_cap(pw, target.proof.trace_cap, proof.trace_cap)
    _set_cap(pw, target.proof.quotient_polys_cap, proof.quotient_polys_cap)
    if target.proof.auxiliary_polys_cap is not None:
        _set_cap(pw, target.proof.auxiliary_polys_cap, proof.auxiliary_polys_cap)
    o_t, o = target.proof.openings, proof.openings
    _set_exts(pw, o_t.local_values, o.local_values)
    _set_exts(pw, o_t.next_values, o.next_values)
    _set_exts(pw, o_t.quotient_polys, o.quotient_polys)
    if o_t.auxiliary_polys is not None:
        _set_exts(pw, o_t.auxiliary_polys, o.auxiliary_polys)
        _set_exts(pw, o_t.auxiliary_polys_next, o.auxiliary_polys_next)

    f_t, f = target.proof.opening_proof, proof.opening_proof
    zero_cap = [(0, 0, 0, 0)] * len(f_t.commit_phase_merkle_caps[0].hashes) if f_t.commit_phase_merkle_caps else []
    for i, cap_t in enumerate(f_t.commit_phase_merkle_caps):
        cap = (
            f.commit_phase_merkle_caps[i]
            if i < len(f.commit_phase_merkle_caps)
            else zero_cap
        )
        _set_cap(pw, cap_t, cap)
    for round_t, rnd in zip(f_t.query_round_proofs, f.query_round_proofs):
        for (evals_t, mp_t), (evals, mp) in zip(
            round_t.initial_trees_proof.evals_proofs,
            rnd.initial_trees_proof.evals_proofs,
        ):
            for t, v in zip(evals_t, evals):
                pw.set_target(t, int(v))
            _set_sibs_padded(pw, mp_t.siblings, mp.siblings)
        for i, step_t in enumerate(round_t.steps):
            if i < len(rnd.steps):
                step = rnd.steps[i]
                _set_exts(pw, step_t.evals, step.evals)
                _set_sibs_padded(pw, step_t.merkle_proof.siblings, step.merkle_proof.siblings)
            else:
                _set_exts(pw, step_t.evals, [(0, 0)] * len(step_t.evals))
                _set_sibs_padded(pw, step_t.merkle_proof.siblings, [])
    padded_final = list(f.final_poly) + [(0, 0)] * (
        len(f_t.final_poly) - len(f.final_poly)
    )
    _set_exts(pw, f_t.final_poly, padded_final)
    pw.set_target(f_t.pow_witness, int(f.pow_witness))


def _observe_config(builder, ch: RecursiveChallenger, config: StarkConfig) -> None:
    vals = [
        config.security_bits,
        config.num_challenges,
        config.fri_config.rate_bits,
        config.fri_config.cap_height,
        config.fri_config.proof_of_work_bits,
        *config.fri_config.reduction_strategy.serialize(),
        config.fri_config.num_query_rounds,
    ]
    ch.observe_elements([builder.constant(v) for v in vals])


def _runtime_degree_targets(builder, degree_bits_target: Target, max_degree_bits: int):
    """(degree, degree_bits_vec, g) as circuit values derived from the
    runtime degree_bits target (vanishing_poly.rs:223-237,
    recursive_verifier.rs:113-126): degree = 2^k via an exponentiation
    gate, g = POWER_OF_TWO_GENERATOR^(2^(TWO_ADICITY - k))."""
    two = builder.two()
    max_bits = max_degree_bits + 1
    degree = builder.exp(two, degree_bits_target, max_bits)
    degree_bits_vec = builder.split_le(degree, max_bits)
    two_adicity = builder.constant(gl.TWO_ADICITY)
    t = builder.sub(two_adicity, degree_bits_target)
    e = builder.exp(two, t, gl.TWO_ADICITY)
    g = builder.exp(builder.constant(gl.POWER_OF_TWO_GENERATOR), e, gl.TWO_ADICITY)
    return degree, degree_bits_vec, g


def _eval_vanishing_circuit(
    builder, stark, config, degree_bits, local_values, next_values, public_inputs,
    alphas_ext, zeta: ExtensionTarget,
    aux_local=None, aux_next=None, lookup_challenge_exts=None,
    runtime_degree=None,
) -> List[ExtensionTarget]:
    """Single-point in-circuit constraint evaluation via the shared
    consumer (vanishing_poly.rs eval_vanishing_poly_circuit +
    eval_l_0_and_l_last_circuit); logUp lookup constraints evaluate
    through the same algebra-generic path (lookup.rs:873-941).

    runtime_degree: optional (degree, degree_bits_vec, g) targets for
    unified multi-degree verification — Z_H, L_0, L_last and the last
    subgroup element are then computed from the proof's runtime degree
    (vanishing_poly.rs:194-241)."""
    A = CircuitAlgebra(builder)
    one = builder.one_extension()
    if runtime_degree is None:
        n = 1 << degree_bits
        g = gl.primitive_root_of_unity(degree_bits)
        z_x = builder.sub_extension(
            builder.exp_power_of_2_extension(zeta, degree_bits), one
        )
        l0_den = builder.constant_scalar_mul_ext(n % gl.P, builder.sub_extension(zeta, one))
        llast_den = builder.constant_scalar_mul_ext(
            n % gl.P,
            builder.sub_extension(builder.constant_scalar_mul_ext(g, zeta), one),
        )
        l_0 = builder.div_extension(z_x, l0_den)
        l_last = builder.div_extension(z_x, llast_den)
        last = gl.gexp(g, n - 1)
        z_last = builder.sub_extension(zeta, builder.constant_extension((last, 0)))
    else:
        degree_t, degree_bits_vec, g_t = runtime_degree
        z_x = builder.sub_extension(
            builder.exp_extension_from_bits(zeta, degree_bits_vec), one
        )
        n_ext = builder.convert_to_ext(degree_t)
        g_ext = builder.convert_to_ext(g_t)
        # L_0 = Z_H / (n (zeta - 1)); L_last = Z_H / (n (g zeta - 1))
        l0_den = builder.mul_extension(n_ext, builder.sub_extension(zeta, one))
        llast_den = builder.mul_extension(
            n_ext,
            builder.sub_extension(builder.mul_extension(g_ext, zeta), one),
        )
        l_0 = builder.div_extension(z_x, l0_den)
        l_last = builder.div_extension(z_x, llast_den)
        # last element g^(n-1) = g^-1
        z_last = builder.sub_extension(zeta, builder.inverse_extension(g_ext))

    frame = StarkFrame(
        local_values=list(local_values),
        next_values=list(next_values),
        public_inputs=[builder.convert_to_ext(t) for t in public_inputs],
    )
    consumer = ConstraintConsumer(A, alphas_ext, z_last, l_0, l_last)
    lookup_vars = None
    if lookup_challenge_exts is not None:
        num_lookup = stark.num_lookup_helper_columns(config)
        lookup_vars = LookupCheckVars(
            local_values=list(aux_local[:num_lookup]),
            next_values=list(aux_next[:num_lookup]),
            challenges=list(lookup_challenge_exts),
        )
    eval_vanishing_generic(stark, frame, consumer, A, lookup_vars)
    return consumer.accumulators()


def binding_step_circuit(
    builder,
    ch,
    stark: Stark,
    config: StarkConfig,
    degree_bits: int,
    public_inputs_t,
    *,
    num_aux: int = 0,
    lookup_challenge_exts=None,
    runtime_degree=None,
):
    """Constraint-binding transcript step (prover.rs:263-370), in-circuit:
    draw alphas', evaluate the constraints on transcript-derived dummy
    values at a random point, observe, then draw the real alphas. The
    circuit dual of stark/vanishing.py run_binding_step — shared by the
    single-table and batch-STARK recursive verifiers."""
    nc = config.num_challenges
    alphas_prime = ch.get_n_challenges(nc)
    C = stark.num_columns()
    total = C * 2 + num_aux * 2
    pow_degree = max(2, stark.constraint_degree() + 1)
    num_ext_powers = max(1, 50 // log2_ceil(pow_degree) - 1)
    num_zetas = -(-total // num_ext_powers)
    zetas = [ch.get_extension_challenge() for _ in range(num_zetas)]
    nb_per = min(num_ext_powers + 1, total)
    dummy: List[ExtensionTarget] = []
    for z in zetas:
        cur = z
        for _ in range(nb_per):
            dummy.append(cur)
            cur = builder.exp_u64_extension(cur, pow_degree)
    zeta_prime = ch.get_extension_challenge()
    constraints = _eval_vanishing_circuit(
        builder, stark, config, degree_bits,
        dummy[:C], dummy[C : 2 * C], public_inputs_t,
        [builder.convert_to_ext(a) for a in alphas_prime], zeta_prime,
        aux_local=dummy[2 * C : 2 * C + num_aux],
        aux_next=dummy[2 * C + num_aux : 2 * C + 2 * num_aux],
        lookup_challenge_exts=lookup_challenge_exts,
        runtime_degree=runtime_degree,
    )
    ch.observe_extension_elements(constraints)
    return ch.get_n_challenges(nc)


def verify_stark_proof_circuit(
    builder,
    stark: Stark,
    pwp_t: StarkProofWithPublicInputsTarget,
    config: StarkConfig,
    degree_bits: int,
    min_degree_bits_to_support: int = None,
) -> None:
    """degree_bits is the max supported degree. With
    min_degree_bits_to_support set (and a proof target allocated with
    multi_degree=True), ONE circuit verifies proofs of any degree in
    [min, max] — the unified multi-degree verifier
    (starky/src/recursive_verifier.rs:30-210)."""
    _refuse_ctls(stark)
    nc = config.num_challenges
    proof = pwp_t.proof
    multi = min_degree_bits_to_support is not None
    runtime_degree = None
    if multi:
        assert proof.degree_bits is not None, (
            "allocate the proof with multi_degree=True"
        )
        # degree_bits must be nonzero (recursive_verifier.rs:108)
        builder.inverse(proof.degree_bits)
        runtime_degree = _runtime_degree_targets(builder, proof.degree_bits, degree_bits)
    ch = RecursiveChallenger(builder)
    ch.observe_elements(pwp_t.public_inputs)
    _observe_config(builder, ch, config)
    ch.observe_cap(proof.trace_cap)

    # lookup grand-product challenges before the aux cap
    # (get_challenges.rs:66-81 circuit dual); a lookup uses the betas
    lookup_challenge_exts = None
    num_aux = stark.num_lookup_helper_columns(config)
    if stark.uses_lookups():
        challenge_set = get_grand_product_challenge_set_target(builder, ch, nc)
        lookup_challenge_exts = [
            builder.convert_to_ext(c.beta) for c in challenge_set.challenges
        ]
    if proof.auxiliary_polys_cap is not None:
        ch.observe_cap(proof.auxiliary_polys_cap)

    alphas = binding_step_circuit(
        builder, ch, stark, config, degree_bits, pwp_t.public_inputs,
        num_aux=num_aux,
        lookup_challenge_exts=lookup_challenge_exts,
        runtime_degree=runtime_degree,
    )

    ch.observe_cap(proof.quotient_polys_cap)
    zeta = ch.get_extension_challenge()

    o = proof.openings
    aux_vals = list(o.auxiliary_polys or [])
    aux_next_vals = list(o.auxiliary_polys_next or [])
    zeta_batch_vals = o.local_values + aux_vals + o.quotient_polys
    zeta_next_batch_vals = o.next_values + aux_next_vals
    for batch in (zeta_batch_vals, zeta_next_batch_vals):
        ch.observe_extension_elements(batch)

    fri_ch = fri_challenges_circuit(
        builder, ch,
        proof.opening_proof.commit_phase_merkle_caps,
        proof.opening_proof.final_poly,
        proof.opening_proof.pow_witness,
        config.fri_config,
    )

    # quotient identity at zeta
    vanishing = _eval_vanishing_circuit(
        builder, stark, config, degree_bits,
        o.local_values, o.next_values, pwp_t.public_inputs,
        [builder.convert_to_ext(a) for a in alphas], zeta,
        aux_local=aux_vals,
        aux_next=aux_next_vals,
        lookup_challenge_exts=lookup_challenge_exts,
        runtime_degree=runtime_degree,
    )
    one = builder.one_extension()
    if multi:
        _, degree_bits_vec, g_t = runtime_degree
        zeta_pow_deg = builder.exp_extension_from_bits(zeta, degree_bits_vec)
    else:
        zeta_pow_deg = builder.exp_power_of_2_extension(zeta, degree_bits)
    z_h_zeta = builder.sub_extension(zeta_pow_deg, one)
    qdf = stark.quotient_degree_factor()
    for i in range(nc):
        chunk = o.quotient_polys[i * qdf : (i + 1) * qdf]
        acc = builder.eval_ext_poly_at(list(chunk), zeta_pow_deg)
        builder.connect_extension(vanishing[i], builder.mul_extension(z_h_zeta, acc))

    # FRI
    g = gl.primitive_root_of_unity(degree_bits)
    static_instance = stark.fri_instance((0, 0), g, config)
    if multi:
        zeta_next = builder.scalar_mul_ext(g_t, zeta)
    else:
        zeta_next = builder.constant_scalar_mul_ext(g, zeta)
    instance_t = FriInstanceInfoTarget(
        static_info=static_instance, batch_points=[zeta, zeta_next]
    )
    caps = [proof.trace_cap]
    if proof.auxiliary_polys_cap is not None:
        caps.append(proof.auxiliary_polys_cap)
    caps.append(proof.quotient_polys_cap)
    if multi:
        degree_sub_one = builder.sub(runtime_degree[0], builder.one())
        degree_sub_one_bits_vec = builder.split_le(degree_sub_one, degree_bits)
        verify_fri_proof_circuit_multi_degree(
            builder,
            instance_t,
            [zeta_batch_vals, zeta_next_batch_vals],
            fri_ch,
            caps,
            proof.opening_proof,
            config.fri_params(degree_bits),
            proof.degree_bits,
            degree_sub_one_bits_vec,
            min_degree_bits_to_support,
        )
    else:
        verify_fri_proof_circuit(
            builder,
            instance_t,
            [zeta_batch_vals, zeta_next_batch_vals],
            fri_ch,
            caps,
            proof.opening_proof,
            config.fri_params(degree_bits),
        )

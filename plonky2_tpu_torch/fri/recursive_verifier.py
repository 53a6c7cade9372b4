"""In-circuit FRI verification (reference:
plonky2/src/fri/recursive_verifier.rs:32-580).

Mirrors fri/verifier.py over targets: PoW leading-zeros range check,
per-query Merkle paths via swap-ordered Poseidon rows, initial-opening
combination with ReducingFactorTargets, CosetInterpolationGate folds,
final-poly evaluation; and the unified multi-degree form, one circuit for
proofs of several degrees (the STARK recursive verifier's).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..field import goldilocks as gl
from ..gates.interpolation import CosetInterpolationGate
from ..plonk.gadgets import ReducingFactorTarget
from ..iop.target import ExtensionTarget, Target
from ..utils.bits import log2_strict
from .config import FriConfig, FriParams
from .structure import FriInstanceInfo


@dataclass
class FriChallengesTarget:
    fri_alpha: ExtensionTarget
    fri_betas: List[ExtensionTarget]
    fri_pow_response: Target
    fri_query_indices: List[Target]


@dataclass
class FriInstanceInfoTarget:
    """Same oracle/polynomial structure as FriInstanceInfo (static), but
    batch points are ExtensionTargets."""

    static_info: FriInstanceInfo
    batch_points: List[ExtensionTarget]


class PrecomputedReducedOpeningsTarget:
    def __init__(self, builder, opening_batches: List[List[ExtensionTarget]], alpha: ExtensionTarget):
        self.reduced_openings_at_point = []
        for values in opening_batches:
            rf = ReducingFactorTarget(alpha)
            self.reduced_openings_at_point.append(rf.reduce(builder, values))


def fri_verify_proof_of_work(builder, fri_pow_response: Target, config: FriConfig) -> None:
    builder.assert_leading_zeros(fri_pow_response, config.proof_of_work_bits)


def eval_opening_expression_target(builder, instance, expression, proof_t, point: ExtensionTarget, params):
    total = builder.zero_extension()
    for term in expression.terms:
        c = term.coefficient
        blinding = instance.static_info.oracles[term.polynomial.oracle_index].blinding
        salted = params.leaf_hiding and blinding
        raw = proof_t.unsalted_eval(
            term.polynomial.oracle_index, term.polynomial.polynomial_index, salted
        )
        raw_ext = builder.convert_to_ext(raw)
        if c.kind == "one":
            contrib = raw_ext
        elif c.kind == "point_power":
            p = builder.exp_u64_extension(point, c.power)
            contrib = builder.mul_extension(p, raw_ext)
        else:
            contrib = builder.mul_const_extension(c.constant, raw_ext)
        total = builder.add_extension(total, contrib)
    return total


def fri_combine_initial(
    builder,
    instance: FriInstanceInfoTarget,
    proof_t,
    alpha: ExtensionTarget,
    subgroup_x: Target,
    precomputed: PrecomputedReducedOpeningsTarget,
    params: FriParams,
) -> ExtensionTarget:
    sx = builder.convert_to_ext(subgroup_x)
    rf = ReducingFactorTarget(alpha)
    total = builder.zero_extension()
    for batch, point_t, reduced_opening in zip(
        instance.static_info.batches,
        instance.batch_points,
        precomputed.reduced_openings_at_point,
    ):
        evals = [
            eval_opening_expression_target(builder, instance, expr, proof_t, point_t, params)
            for expr in batch.openings
        ]
        reduced_evals = rf.reduce(builder, evals)
        numerator = builder.sub_extension(reduced_evals, reduced_opening)
        denominator = builder.sub_extension(sx, point_t)
        total = rf.shift(builder, total)
        total = builder.div_add_extension(numerator, denominator, total)
    return total


def compute_evaluation_target(
    builder,
    x: Target,
    x_index_within_coset_bits,
    arity_bits: int,
    evals: List[ExtensionTarget],
    beta: ExtensionTarget,
) -> ExtensionTarget:
    from ..utils.bits import reverse_index_bits_perm

    arity = 1 << arity_bits
    assert len(evals) == arity
    g = gl.primitive_root_of_unity(arity_bits)
    g_inv = gl.gexp(g, arity - 1)

    perm = reverse_index_bits_perm(arity)
    evals_nat = [evals[int(perm[i])] for i in range(arity)]
    # want g_inv^rev(x_index_within_coset): MSB-first bits of the REVERSED
    # value are the natural LE bits of the original (fri_verifier.rs:26-55)
    start = builder.exp_from_bits_const_base(g_inv, list(x_index_within_coset_bits))
    coset_start = builder.mul(start, x)

    gate = CosetInterpolationGate.with_max_degree(
        arity_bits, builder.config.max_quotient_degree_factor
    )
    return builder.interpolate_coset(gate, coset_start, evals_nat, beta)


def verify_fri_proof_circuit(
    builder,
    instance: FriInstanceInfoTarget,
    opening_batches: List[List[ExtensionTarget]],
    challenges: FriChallengesTarget,
    initial_merkle_caps,
    proof_t,
    params: FriParams,
) -> None:
    n = params.lde_size
    fri_verify_proof_of_work(builder, challenges.fri_pow_response, params.config)
    assert params.config.num_query_rounds == len(proof_t.query_round_proofs)

    precomputed = PrecomputedReducedOpeningsTarget(
        builder, opening_batches, challenges.fri_alpha
    )
    for x_index, round_proof in zip(
        challenges.fri_query_indices, proof_t.query_round_proofs
    ):
        _verify_query_round(
            builder, instance, challenges, precomputed, initial_merkle_caps,
            proof_t, x_index, n, round_proof, params,
        )


def _verify_query_round(
    builder,
    instance: FriInstanceInfoTarget,
    challenges: FriChallengesTarget,
    precomputed: PrecomputedReducedOpeningsTarget,
    initial_merkle_caps,
    proof_t,
    x_index: Target,
    n: int,
    round_proof,
    params: FriParams,
) -> None:
    n_log = log2_strict(n)
    x_index_bits = builder.low_bits(x_index, n_log, 64)
    cap_index = builder.le_sum(x_index_bits[len(x_index_bits) - params.config.cap_height :])

    # initial Merkle proofs
    for (evals, merkle_proof), cap in zip(
        round_proof.initial_trees_proof.evals_proofs, initial_merkle_caps
    ):
        builder.verify_merkle_proof_to_cap_with_cap_index(
            list(evals), x_index_bits, cap_index, cap, merkle_proof.siblings
        )

    # subgroup_x = shift * phi^rev(x_index)
    phi = gl.primitive_root_of_unity(n_log)
    # phi^rev(x_index): natural LE bits are MSB-first bits of rev(x_index)
    phi_pow = builder.exp_from_bits_const_base(phi, list(x_index_bits))
    subgroup_x = builder.mul_const(gl.MULTIPLICATIVE_GROUP_GENERATOR, phi_pow)

    old_eval = fri_combine_initial(
        builder, instance, round_proof.initial_trees_proof,
        challenges.fri_alpha, subgroup_x, precomputed, params,
    )

    for i, arity_bits in enumerate(params.reduction_arity_bits):
        evals = round_proof.steps[i].evals
        coset_index_bits = x_index_bits[arity_bits:]
        x_index_within_coset_bits = x_index_bits[:arity_bits]
        x_index_within_coset = builder.le_sum(x_index_within_coset_bits)

        new_eval = builder.random_access_extension(x_index_within_coset, list(evals))
        builder.connect_extension(new_eval, old_eval)

        old_eval = compute_evaluation_target(
            builder, subgroup_x, x_index_within_coset_bits, arity_bits,
            list(evals), challenges.fri_betas[i],
        )

        flat = [t for e in evals for t in e.parts]
        builder.verify_merkle_proof_to_cap_with_cap_index(
            flat, coset_index_bits, cap_index,
            proof_t.commit_phase_merkle_caps[i],
            round_proof.steps[i].merkle_proof.siblings,
        )

        for _ in range(arity_bits):
            subgroup_x = builder.mul(subgroup_x, subgroup_x)
        x_index_bits = coset_index_bits

    expected = builder.eval_ext_poly_at(
        proof_t.final_poly, builder.convert_to_ext(subgroup_x)
    )
    builder.connect_extension(expected, old_eval)


def verify_fri_proof_circuit_multi_degree(
    builder,
    instance: FriInstanceInfoTarget,
    opening_batches: List[List[ExtensionTarget]],
    challenges: FriChallengesTarget,
    initial_merkle_caps,
    proof_t,
    params: FriParams,
    current_degree_bits: Target,
    degree_sub_one_bits_vec,
    min_degree_bits_to_support: int,
) -> None:
    """Unified multi-degree FRI verification: one circuit, built for the
    MAX ``params.degree_bits``, verifies proofs of any degree in
    [min_degree_bits_to_support, params.degree_bits]. Random-access gates
    select the per-degree cap index / subgroup element / Merkle chain
    state, and ``degree_sub_one_bits_vec`` (LE bits of 2^k - 1) gates
    each fold step on whether the actual proof still needs it
    (reference: fri/recursive_verifier.rs:196-420,
    verify_fri_proof_with_multiple_degree_bits).

    The proof target must be allocated at max params; witnesses for
    smaller proofs pad missing steps/caps/siblings with zeros (the
    prover's max_num_query_steps/final_poly_coeff_len padding keeps the
    transcript aligned)."""
    log_n = params.config.rate_bits + params.degree_bits
    min_log_n = params.config.rate_bits + min_degree_bits_to_support
    assert min_log_n > params.config.cap_height

    rate_bits_t = builder.constant(params.config.rate_bits)
    current_log_n = builder.add(rate_bits_t, current_degree_bits)

    fri_verify_proof_of_work(builder, challenges.fri_pow_response, params.config)
    assert params.config.num_query_rounds == len(proof_t.query_round_proofs)

    precomputed = PrecomputedReducedOpeningsTarget(
        builder, opening_batches, challenges.fri_alpha
    )
    for x_index, round_proof in zip(
        challenges.fri_query_indices, proof_t.query_round_proofs
    ):
        _verify_query_round_multi(
            builder, instance, challenges, precomputed, initial_merkle_caps,
            proof_t, x_index, (min_log_n, log_n), current_log_n,
            degree_sub_one_bits_vec, round_proof, params,
        )


def _verify_query_round_multi(
    builder,
    instance: FriInstanceInfoTarget,
    challenges: FriChallengesTarget,
    precomputed: PrecomputedReducedOpeningsTarget,
    initial_merkle_caps,
    proof_t,
    x_index: Target,
    log_n_range,
    log_n: Target,
    degree_sub_one_bits_vec,
    round_proof,
    params: FriParams,
) -> None:
    min_log_n, max_log_n = log_n_range
    one = builder.one()
    min_log_n_t = builder.constant(min_log_n)
    n_index = builder.sub(log_n, min_log_n_t)

    # the full challenge decomposed to max bits; the actual index is the
    # low current_log_n bits, realized below by per-degree selection
    x_index_bits = builder.low_bits(x_index, max_log_n, 64)

    cap_indices = [
        builder.le_sum(x_index_bits[n - params.config.cap_height : n])
        for n in range(min_log_n, max_log_n + 1)
    ]
    cap_index = builder.random_access(n_index, cap_indices)

    # initial Merkle proofs — always active, path length selected by n
    for (evals, merkle_proof), cap in zip(
        round_proof.initial_trees_proof.evals_proofs, initial_merkle_caps
    ):
        builder.verify_merkle_proof_to_cap_with_cap_indices(
            one, list(evals), x_index_bits, log_n_range, n_index,
            cap_index, cap, merkle_proof.siblings,
        )

    # subgroup_x = shift * phi_n^rev(x_index) for the actual n
    subgroup_x_vec = []
    for n in range(min_log_n, max_log_n + 1):
        phi = gl.primitive_root_of_unity(n)
        phi_pow = builder.exp_from_bits_const_base(phi, list(x_index_bits[:n]))
        subgroup_x_vec.append(
            builder.mul_const(gl.MULTIPLICATIVE_GROUP_GENERATOR, phi_pow)
        )
    subgroup_x = builder.random_access(n_index, subgroup_x_vec)

    old_eval = fri_combine_initial(
        builder, instance, round_proof.initial_trees_proof,
        challenges.fri_alpha, subgroup_x, precomputed, params,
    )

    # degree_sub_one_bits_vec = LE bits of (2^k - 1): bit p set iff p < k,
    # so step i is active iff final_bits + sum(arities[:i]) < k
    idx_in_bits = len(degree_sub_one_bits_vec) - sum(params.reduction_arity_bits)
    for i, arity_bits in enumerate(params.reduction_arity_bits):
        evals = round_proof.steps[i].evals
        coset_index_bits = x_index_bits[arity_bits:]
        x_index_within_coset_bits = x_index_bits[:arity_bits]
        x_index_within_coset = builder.le_sum(x_index_within_coset_bits)

        step_active = degree_sub_one_bits_vec[idx_in_bits]

        new_eval = builder.random_access_extension(x_index_within_coset, list(evals))
        builder.conditional_assert_eq_ext(step_active.target, new_eval, old_eval)

        computed = compute_evaluation_target(
            builder, subgroup_x, x_index_within_coset_bits, arity_bits,
            list(evals), challenges.fri_betas[i],
        )
        old_eval = builder.select_ext(step_active, computed, old_eval)

        flat = [t for e in evals for t in e.parts]
        builder.verify_merkle_proof_to_cap_with_cap_indices(
            step_active.target, flat, coset_index_bits, log_n_range, n_index,
            cap_index, proof_t.commit_phase_merkle_caps[i],
            round_proof.steps[i].merkle_proof.siblings,
        )

        subgroup_x_cur = subgroup_x
        for _ in range(arity_bits):
            subgroup_x_cur = builder.mul(subgroup_x_cur, subgroup_x_cur)
        subgroup_x = builder.select(step_active, subgroup_x_cur, subgroup_x)

        x_index_bits = coset_index_bits
        idx_in_bits += arity_bits

    expected = builder.eval_ext_poly_at(
        proof_t.final_poly, builder.convert_to_ext(subgroup_x)
    )
    builder.connect_extension(expected, old_eval)


def fri_challenges_circuit(
    builder,
    challenger,
    commit_phase_merkle_caps,
    final_poly: List[ExtensionTarget],
    pow_witness: Target,
    config: FriConfig,
) -> FriChallengesTarget:
    """In-circuit analogue of fri/verifier.py fri_challenges."""
    fri_alpha = challenger.get_extension_challenge()
    fri_betas = []
    for cap in commit_phase_merkle_caps:
        challenger.observe_cap(cap)
        fri_betas.append(challenger.get_extension_challenge())
    for c in final_poly:
        challenger.observe_extension_element(c)
    challenger.observe_element(pow_witness)
    fri_pow_response = challenger.get_challenge()
    fri_query_indices = challenger.get_n_challenges(config.num_query_rounds)
    return FriChallengesTarget(fri_alpha, fri_betas, fri_pow_response, fri_query_indices)

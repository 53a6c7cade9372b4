"""In-circuit batch-FRI verification: one shared BatchMerkleTree oracle
holding polynomial groups of several degrees, absorbed one by one as the
fold reaches each size (reference:
plonky2/src/batch_fri/recursive_verifier.rs:22-330;
plonky2_tpu/fri/batch_recursive_verifier.py).

The host dual is fri/batch_oracle.py verify_batch_fri_proof; the circuit
mirrors it over targets, reusing the plain FRI gadgets. Gadget code only:
it builds a circuit and launches nothing on a device."""

from __future__ import annotations

from typing import List

from ..field import goldilocks as gl
from ..iop.target import ExtensionTarget, Target
from .config import FriParams
from .recursive_verifier import (
    FriChallengesTarget,
    FriInstanceInfoTarget,
    PrecomputedReducedOpeningsTarget,
    compute_evaluation_target,
    eval_opening_expression_target,
    fri_verify_proof_of_work,
)
from ..plonk.gadgets import ReducingFactorTarget


class _ProofLike:
    """Per-instance view of the shared batch leaf row: oracle i's evals
    are a contiguous slice (batch_fri/recursive_verifier.rs:106-145)."""

    def __init__(self, evals_proofs):
        self.evals_proofs = evals_proofs

    def unsalted_eval(self, oracle_index, poly_index, salted):
        evals = self.evals_proofs[oracle_index][0]
        return evals[poly_index]


def _instance_proof_view(instances_t, index, shared_rows):
    """shared_rows: per-oracle flat target lists; slice out instance
    `index`'s contiguous block per oracle."""
    ep = []
    for oi in range(len(shared_rows)):
        pos = 0
        for j in range(index):
            pos += instances_t[j].static_info.oracles[oi].num_polys
        num = instances_t[index].static_info.oracles[oi].num_polys
        ep.append((shared_rows[oi][pos : pos + num], None))
    return _ProofLike(ep)


def _batch_fri_combine_initial(
    builder,
    instance_t: FriInstanceInfoTarget,
    proof_like: _ProofLike,
    alpha: ExtensionTarget,
    subgroup_x: Target,
    precomputed: PrecomputedReducedOpeningsTarget,
    params: FriParams,
) -> ExtensionTarget:
    sx = builder.convert_to_ext(subgroup_x)
    rf = ReducingFactorTarget(alpha)
    total = builder.zero_extension()
    for batch, point_t, reduced_opening in zip(
        instance_t.static_info.batches,
        instance_t.batch_points,
        precomputed.reduced_openings_at_point,
    ):
        evals = [
            eval_opening_expression_target(
                builder, instance_t, expr, proof_like, point_t, params
            )
            for expr in batch.openings
        ]
        reduced_evals = rf.reduce(builder, evals)
        numerator = builder.sub_extension(reduced_evals, reduced_opening)
        denominator = builder.sub_extension(sx, point_t)
        total = rf.shift(builder, total)
        total = builder.div_add_extension(numerator, denominator, total)
    return total


def verify_batch_fri_proof_circuit(
    builder,
    degree_bits: List[int],
    instances_t: List[FriInstanceInfoTarget],
    opening_batches_list: List[List[List[ExtensionTarget]]],
    challenges: FriChallengesTarget,
    initial_merkle_caps,
    proof_t,
    params: FriParams,
) -> None:
    """degree_bits: per-instance degrees, strictly decreasing; params is
    at the largest degree. initial_merkle_caps: one per shared oracle
    (each a BatchMerkleTree over all degree groups)."""
    assert len(degree_bits) == len(instances_t)
    assert params.final_poly_len() == len(proof_t.final_poly)
    fri_verify_proof_of_work(builder, challenges.fri_pow_response, params.config)
    assert params.config.num_query_rounds == len(proof_t.query_round_proofs)

    precomputed = [
        PrecomputedReducedOpeningsTarget(builder, batches, challenges.fri_alpha)
        for batches in opening_batches_list
    ]
    lde_bits = [d + params.config.rate_bits for d in degree_bits]

    for x_index, round_proof in zip(
        challenges.fri_query_indices, proof_t.query_round_proofs
    ):
        _batch_query_round(
            builder, lde_bits, instances_t, challenges, precomputed,
            initial_merkle_caps, proof_t, x_index, round_proof, params,
        )


def _batch_query_round(
    builder,
    lde_bits: List[int],
    instances_t: List[FriInstanceInfoTarget],
    challenges: FriChallengesTarget,
    precomputed: List[PrecomputedReducedOpeningsTarget],
    initial_merkle_caps,
    proof_t,
    x_index: Target,
    round_proof,
    params: FriParams,
) -> None:
    n = lde_bits[0]
    x_index_bits = builder.low_bits(x_index, n, 64)
    cap_index = builder.le_sum(
        x_index_bits[len(x_index_bits) - params.config.cap_height :]
    )

    # initial batch-Merkle proofs: per shared oracle, the leaf is the
    # concatenation of every instance's group rows at that height
    shared_rows = []
    for oi, ((evals, merkle_proof), cap) in enumerate(
        zip(round_proof.initial_trees_proof.evals_proofs, initial_merkle_caps)
    ):
        leaves = []
        pos = 0
        for inst in instances_t:
            num = inst.static_info.oracles[oi].num_polys
            leaves.append(list(evals[pos : pos + num]))
            pos += num
        assert pos == len(evals), "batch leaf width mismatch"
        builder.verify_batch_merkle_proof_to_cap_with_cap_index(
            leaves, lde_bits, x_index_bits, cap_index, cap, merkle_proof.siblings
        )
        shared_rows.append(list(evals))

    phi = gl.primitive_root_of_unity(n)
    phi_pow = builder.exp_from_bits_const_base(phi, list(x_index_bits))
    subgroup_x = builder.mul_const(gl.MULTIPLICATIVE_GROUP_GENERATOR, phi_pow)

    batch_index = 0
    old_eval = _batch_fri_combine_initial(
        builder, instances_t[0],
        _instance_proof_view(instances_t, 0, shared_rows),
        challenges.fri_alpha, subgroup_x, precomputed[0], params,
    )
    batch_index += 1

    bits_n = n
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
        bits_n -= arity_bits

        if batch_index < len(lde_bits) and bits_n == lde_bits[batch_index]:
            # absorb the next degree group (verifier.rs:401-416 host dual):
            # old <- beta_i * old + combine(instance[batch_index])
            phi = gl.primitive_root_of_unity(bits_n)
            phi_pow = builder.exp_from_bits_const_base(phi, list(x_index_bits))
            subgroup_x_init = builder.mul_const(
                gl.MULTIPLICATIVE_GROUP_GENERATOR, phi_pow
            )
            eval2 = _batch_fri_combine_initial(
                builder, instances_t[batch_index],
                _instance_proof_view(instances_t, batch_index, shared_rows),
                challenges.fri_alpha, subgroup_x_init,
                precomputed[batch_index], params,
            )
            old_eval = builder.mul_extension(old_eval, challenges.fri_betas[i])
            old_eval = builder.add_extension(old_eval, eval2)
            batch_index += 1

    assert batch_index == len(instances_t), "wrong number of folded instances"
    expected = builder.eval_ext_poly_at(
        proof_t.final_poly, builder.convert_to_ext(subgroup_x)
    )
    builder.connect_extension(expected, old_eval)

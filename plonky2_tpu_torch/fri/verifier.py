"""Native FRI verification (host, exact ints).

Reference: core/src/fri_verifier.rs:26-335. O(polylog) work — PoW check,
per-query Merkle verification, initial-opening combination, per-round
barycentric coset-fold checks, final-poly evaluation.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..field import extension as ge
from ..field import goldilocks as gl
from ..field.interpolation import barycentric_weights, interpolate
from ..hash import poseidon as hp
from ..hash.challenger import Challenger
from ..utils.bits import log2_strict, reverse_bits, reverse_index_bits
from .config import FriConfig, FriParams
from .proof import FriInitialTreeProof, FriProof, FriQueryRound, MerkleProof
from .structure import (
    FriBatchInfo,
    FriChallenges,
    FriInstanceInfo,
    FriOpenings,
)

Ext = Tuple[int, ...]


class FriVerificationError(Exception):
    pass


def _ensure(cond: bool, msg: str) -> None:
    if not cond:
        raise FriVerificationError(msg)


def verify_merkle_proof_to_cap(
    leaf_data: List[int],
    leaf_index: int,
    cap: np.ndarray,
    proof: MerkleProof,
    hasher=None,
) -> None:
    h = hasher if hasher is not None else hp
    digest = h.hash_leaf(leaf_data)
    idx = leaf_index
    for sib in proof.siblings:
        if idx & 1:
            digest = h.two_to_one(sib, digest)
        else:
            digest = h.two_to_one(digest, sib)
        idx >>= 1
    _ensure(
        tuple(int(x) for x in cap[idx]) == digest,
        "Merkle proof does not match cap",
    )


def fri_verify_proof_of_work(pow_response: int, config: FriConfig) -> None:
    lz = 64 - pow_response.bit_length() if pow_response else 64
    _ensure(lz >= config.proof_of_work_bits, "Invalid proof of work witness")


def compute_evaluation(
    x: int, x_index_within_coset: int, arity_bits: int, evals: List[Ext], beta: Ext
) -> Ext:
    """Infer P'(x^arity) from the committed coset values
    (fri_verifier.rs:26-55)."""
    arity = 1 << arity_bits
    assert len(evals) == arity
    g = gl.primitive_root_of_unity(arity_bits)
    from ..utils.bits import reverse_index_bits_perm

    perm = reverse_index_bits_perm(arity)
    evs = [tuple(evals[int(perm[i])]) for i in range(arity)]
    rev_idx = reverse_bits(x_index_within_coset, arity_bits)
    coset_start = gl.gmul(x, gl.gexp(g, arity - rev_idx))
    points = []
    y = 1
    for e in evs:
        points.append((ge.from_base(gl.gmul(coset_start, y), 2), tuple(e)))
        y = gl.gmul(y, g)
    w = barycentric_weights(points)
    return interpolate(points, beta, w)


class PrecomputedReducedOpenings:
    def __init__(self, openings: FriOpenings, alpha: Ext):
        self.reduced_openings_at_point = [
            _reduce_ext(batch.values, alpha) for batch in openings.batches
        ]


def _reduce_ext(values: Sequence[Ext], alpha: Ext) -> Ext:
    """Horner: sum_i alpha^i v_i (reducing.rs reduce)."""
    acc = ge.ext_zero(2)
    for v in reversed(list(values)):
        acc = ge.ext_add(ge.ext_mul(acc, alpha), v)
    return acc


def eval_opening_expression(
    instance: FriInstanceInfo,
    expression,
    proof: FriInitialTreeProof,
    point: Ext,
    params: FriParams,
) -> Ext:
    total = ge.ext_zero(2)
    for term in expression.terms:
        c = term.coefficient
        if c.kind == "one":
            coeff = ge.ext_one(2)
        elif c.kind == "point_power":
            coeff = ge.ext_exp(point, c.power)
        else:
            coeff = c.constant
        blinding = instance.oracles[term.polynomial.oracle_index].blinding
        salted = params.leaf_hiding and blinding
        raw = proof.unsalted_eval(
            term.polynomial.oracle_index, term.polynomial.polynomial_index, salted
        )
        total = ge.ext_add(total, ge.ext_mul(coeff, ge.from_base(raw, 2)))
    return total


def fri_combine_initial(
    instance: FriInstanceInfo,
    proof: FriInitialTreeProof,
    alpha: Ext,
    subgroup_x: int,
    precomputed: PrecomputedReducedOpenings,
    params: FriParams,
) -> Ext:
    sx = ge.from_base(subgroup_x, 2)
    total_count = 0
    s = ge.ext_zero(2)
    for batch, reduced_opening in zip(
        instance.batches, precomputed.reduced_openings_at_point
    ):
        evals = [
            eval_opening_expression(instance, expr, proof, batch.point, params)
            for expr in batch.openings
        ]
        reduced_evals = _reduce_ext(evals, alpha)
        numerator = ge.ext_sub(reduced_evals, reduced_opening)
        denominator = ge.ext_sub(sx, batch.point)
        s = ge.ext_mul(s, ge.ext_exp(alpha, len(evals)))
        s = ge.ext_add(s, ge.ext_div(numerator, denominator))
    return s


def verify_fri_proof(
    instance: FriInstanceInfo,
    openings: FriOpenings,
    challenges: FriChallenges,
    initial_merkle_caps: Sequence[np.ndarray],
    proof: FriProof,
    params: FriParams,
    hasher=None,
) -> None:
    from .validate_shape import FriShapeError, validate_fri_proof_shape

    n = params.lde_size
    # structural validation first (core/src/fri_verifier.rs:69 calls
    # validate_fri_proof_shape before anything else)
    try:
        validate_fri_proof_shape(proof, instance, params)
    except FriShapeError as e:
        raise FriVerificationError(f"malformed FRI proof shape: {e}") from e
    fri_verify_proof_of_work(challenges.fri_pow_response, params.config)
    _ensure(
        params.config.num_query_rounds == len(proof.query_round_proofs),
        "Number of query rounds does not match config",
    )
    precomputed = PrecomputedReducedOpenings(openings, challenges.fri_alpha)
    for x_index, round_proof in zip(
        challenges.fri_query_indices, proof.query_round_proofs
    ):
        _verify_query_round(
            instance,
            challenges,
            precomputed,
            initial_merkle_caps,
            proof,
            x_index,
            n,
            round_proof,
            params,
            hasher=hasher,
        )


def _verify_query_round(
    instance: FriInstanceInfo,
    challenges: FriChallenges,
    precomputed: PrecomputedReducedOpenings,
    initial_merkle_caps: Sequence[np.ndarray],
    proof: FriProof,
    x_index: int,
    n: int,
    round_proof: FriQueryRound,
    params: FriParams,
    hasher=None,
) -> None:
    # initial Merkle proofs
    for (evals, mproof), cap in zip(
        round_proof.initial_trees_proof.evals_proofs, initial_merkle_caps
    ):
        verify_merkle_proof_to_cap(evals, x_index, cap, mproof, hasher=hasher)

    log_n = log2_strict(n)
    subgroup_x = gl.gmul(
        gl.MULTIPLICATIVE_GROUP_GENERATOR,
        gl.gexp(gl.primitive_root_of_unity(log_n), reverse_bits(x_index, log_n)),
    )
    old_eval = fri_combine_initial(
        instance,
        round_proof.initial_trees_proof,
        challenges.fri_alpha,
        subgroup_x,
        precomputed,
        params,
    )

    for i, arity_bits in enumerate(params.reduction_arity_bits):
        arity = 1 << arity_bits
        evals = round_proof.steps[i].evals
        coset_index = x_index >> arity_bits
        x_index_within_coset = x_index & (arity - 1)
        _ensure(
            tuple(evals[x_index_within_coset]) == tuple(old_eval),
            "FRI fold consistency check failed",
        )
        old_eval = compute_evaluation(
            subgroup_x, x_index_within_coset, arity_bits, evals, challenges.fri_betas[i]
        )
        flat = [c for e in evals for c in e]
        verify_merkle_proof_to_cap(
            flat, coset_index, proof.commit_phase_merkle_caps[i],
            round_proof.steps[i].merkle_proof, hasher=hasher,
        )
        subgroup_x = gl.exp_power_of_2(subgroup_x, arity_bits)
        x_index = coset_index

    # final poly evaluation
    expected = _eval_ext_poly(proof.final_poly, ge.from_base(subgroup_x, 2))
    _ensure(
        tuple(expected) == tuple(old_eval), "Final polynomial evaluation is invalid"
    )


def _eval_ext_poly(coeffs: Sequence[Ext], x: Ext) -> Ext:
    acc = ge.ext_zero(2)
    for c in reversed(list(coeffs)):
        acc = ge.ext_add(ge.ext_mul(acc, x), c)
    return acc


def fri_challenges(
    challenger: Challenger,
    commit_phase_merkle_caps: Sequence[np.ndarray],
    final_poly: Sequence[Ext],
    pow_witness: int,
    degree_bits: int,
    config: FriConfig,
    final_poly_coeff_len=None,
    max_num_query_steps=None,
) -> FriChallenges:
    """Recompute FRI challenges from the transcript
    (core/src/fri.rs:358-420 FriChallenger::fri_challenges)."""
    lde_size = 1 << (degree_bits + config.rate_bits)
    fri_alpha = challenger.get_extension_challenge(2)
    fri_betas = []
    for cap in commit_phase_merkle_caps:
        challenger.observe_cap(cap)
        fri_betas.append(challenger.get_extension_challenge(2))
    if max_num_query_steps is not None:
        zero_cap = [[0] * 4] * (1 << config.cap_height)
        for _ in range(len(commit_phase_merkle_caps), max_num_query_steps):
            challenger.observe_cap(zero_cap)
            challenger.get_extension_challenge(2)
    for c in final_poly:
        challenger.observe_extension_element(c)
    if final_poly_coeff_len is not None:
        for _ in range(len(final_poly), final_poly_coeff_len):
            challenger.observe_extension_element((0, 0))
    challenger.observe_element(pow_witness)
    fri_pow_response = challenger.get_challenge()
    fri_query_indices = [
        c % lde_size for c in challenger.get_n_challenges(config.num_query_rounds)
    ]
    return FriChallenges(fri_alpha, fri_betas, fri_pow_response, fri_query_indices)


def get_fri_inferred_elements(
    instance: FriInstanceInfo,
    openings: FriOpenings,
    challenges: FriChallenges,
    proof: FriProof,
    params: FriParams,
) -> List[Ext]:
    """The per-query per-step evaluations a verifier can infer (and a
    compressed proof therefore omits) — reference proof.rs
    get_inferred_elements."""
    from .validate_shape import validate_fri_initial_proof_shape

    # inference evaluates opening expressions before full proof-shape
    # validation runs, so leaf shapes must be checked here first
    # (fri_validate_shape.rs:85-108, #64696 hardening)
    for round_proof in proof.query_round_proofs:
        validate_fri_initial_proof_shape(
            round_proof.initial_trees_proof, [instance], params.leaf_hiding
        )
    n = params.lde_size
    log_n = log2_strict(n)
    precomputed = PrecomputedReducedOpenings(openings, challenges.fri_alpha)
    out: List[Ext] = []
    for x_index, round_proof in zip(
        challenges.fri_query_indices, proof.query_round_proofs
    ):
        subgroup_x = gl.gmul(
            gl.MULTIPLICATIVE_GROUP_GENERATOR,
            gl.gexp(gl.primitive_root_of_unity(log_n), reverse_bits(x_index, log_n)),
        )
        old_eval = fri_combine_initial(
            instance,
            round_proof.initial_trees_proof,
            challenges.fri_alpha,
            subgroup_x,
            precomputed,
            params,
        )
        for i, arity_bits in enumerate(params.reduction_arity_bits):
            out.append(tuple(old_eval))
            arity = 1 << arity_bits
            evals = round_proof.steps[i].evals
            coset_index = x_index >> arity_bits
            x_index_within_coset = x_index & (arity - 1)
            old_eval = compute_evaluation(
                subgroup_x, x_index_within_coset, arity_bits, evals,
                challenges.fri_betas[i],
            )
            subgroup_x = gl.exp_power_of_2(subgroup_x, arity_bits)
            x_index = coset_index
    return out

"""Structural validation of FRI proofs (deliberate rejection of malformed
proofs with typed errors, instead of incidental IndexErrors).

Capability parity with core/src/fri_validate_shape.rs:17-156 (incl. the
fork's #64696 hardening: opening terms must reference in-range oracle /
polynomial indices *before* any leaf is indexed) and the batch variant.
"""

from __future__ import annotations

from typing import List, Sequence

from .config import FriParams
from .proof import FriInitialTreeProof, FriProof
from .structure import FriInstanceInfo

SALT_SIZE = 4


class FriShapeError(Exception):
    """A FRI proof whose structure does not match the instance/params."""


def _ensure(cond: bool, msg: str) -> None:
    if not cond:
        raise FriShapeError(msg)


def _checked_leaf_lengths(
    instances: Sequence[FriInstanceInfo], leaf_hiding: bool
) -> List[int]:
    """Validate every opening term's (oracle, poly) indices and return the
    expected initial-tree leaf length per oracle. In batch FRI an oracle
    leaf concatenates the polys of every instance
    (fri_validate_shape.rs:37-76)."""
    if not instances:
        return []
    oracle_count = len(instances[0].oracles)
    total_num_polys = [0] * oracle_count
    leaf_len = [0] * oracle_count
    for inst in instances:
        _ensure(
            len(inst.oracles) == oracle_count,
            "FRI instances disagree on oracle count",
        )
        for i, oracle in enumerate(inst.oracles):
            total_num_polys[i] += oracle.num_polys
            leaf_len[i] += oracle.num_polys + (
                SALT_SIZE if (oracle.blinding and leaf_hiding) else 0
            )
    for inst in instances:
        for batch in inst.batches:
            for expression in batch.openings:
                for term in expression.terms:
                    oi = term.polynomial.oracle_index
                    _ensure(oi < oracle_count, "FRI oracle index out of range")
                    _ensure(
                        term.polynomial.polynomial_index < total_num_polys[oi],
                        "FRI polynomial index out of range",
                    )
    return leaf_len


def validate_fri_initial_proof_shape(
    initial_trees_proof: FriInitialTreeProof,
    instances: Sequence[FriInstanceInfo],
    leaf_hiding: bool,
) -> None:
    """Leaf-shape check used by the compressed verifier's inference step,
    which evaluates opening expressions before full validation runs
    (fri_validate_shape.rs:85-108)."""
    leaf_len = _checked_leaf_lengths(instances, leaf_hiding)
    _ensure(
        len(initial_trees_proof.evals_proofs) == len(leaf_len),
        "FRI oracle count mismatch",
    )
    for (leaf, _proof), expected in zip(initial_trees_proof.evals_proofs, leaf_len):
        _ensure(len(leaf) == expected, "FRI leaf length mismatch")


def validate_batch_fri_proof_shape(
    proof: FriProof,
    instances: Sequence[FriInstanceInfo],
    params: FriParams,
) -> None:
    """fri_validate_shape.rs:110-156."""
    leaf_len = _checked_leaf_lengths(instances, params.leaf_hiding)

    cap_height = params.config.cap_height
    for cap in proof.commit_phase_merkle_caps:
        _ensure(len(cap) == 1 << cap_height, "commit-phase cap height mismatch")

    _ensure(
        len(proof.query_round_proofs) == params.config.num_query_rounds,
        "wrong number of query rounds",
    )
    for round_proof in proof.query_round_proofs:
        itp = round_proof.initial_trees_proof
        _ensure(len(itp.evals_proofs) == len(leaf_len), "oracle count mismatch")
        for i, (leaf, merkle_proof) in enumerate(itp.evals_proofs):
            _ensure(len(leaf) == leaf_len[i], "initial leaf length mismatch")
            _ensure(
                len(merkle_proof.siblings) + cap_height == params.lde_bits,
                "initial Merkle path length mismatch",
            )
        _ensure(
            len(round_proof.steps) == len(params.reduction_arity_bits),
            "wrong number of query steps",
        )
        codeword_len_bits = params.lde_bits
        for step, arity_bits in zip(round_proof.steps, params.reduction_arity_bits):
            codeword_len_bits -= arity_bits
            _ensure(len(step.evals) == 1 << arity_bits, "coset eval count mismatch")
            _ensure(
                len(step.merkle_proof.siblings) + cap_height == codeword_len_bits,
                "step Merkle path length mismatch",
            )

    _ensure(
        len(proof.final_poly) == params.final_poly_len(),
        "final polynomial length mismatch",
    )


def validate_fri_proof_shape(
    proof: FriProof, instance: FriInstanceInfo, params: FriParams
) -> None:
    validate_batch_fri_proof_shape(proof, [instance], params)

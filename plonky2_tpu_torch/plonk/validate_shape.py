"""Structural validation of PLONK proofs before verification — malformed
proofs are rejected with typed errors rather than incidental exceptions
(capability parity: plonky2/src/plonk/validate_shape.rs:9-76; the FRI
opening proof is validated separately in fri/validate_shape.py)."""

from __future__ import annotations

from .circuit_data import CommonCircuitData
from .proof import Proof, ProofWithPublicInputs


class ProofShapeError(Exception):
    """A proof whose structure does not match the circuit data."""


def _ensure(cond: bool, msg: str) -> None:
    if not cond:
        raise ProofShapeError(msg)


def validate_proof_with_pis_shape(
    proof_with_pis: ProofWithPublicInputs, common: CommonCircuitData
) -> None:
    validate_proof_shape(proof_with_pis.proof, common)
    _ensure(
        len(proof_with_pis.public_inputs) == common.num_public_inputs,
        "Number of public inputs doesn't match circuit data",
    )


def validate_proof_shape(proof: Proof, common: CommonCircuitData) -> None:
    config = common.config
    o = proof.openings
    cap_len = 1 << common.fri_params.config.cap_height
    _ensure(len(proof.wires_cap) == cap_len, "wires cap height mismatch")
    _ensure(
        len(proof.plonk_zs_partial_products_cap) == cap_len,
        "zs/partial-products cap height mismatch",
    )
    _ensure(len(proof.quotient_polys_cap) == cap_len, "quotient cap height mismatch")
    _ensure(len(o.constants) == common.num_constants, "constants opening count")
    _ensure(len(o.plonk_sigmas) == config.num_routed_wires, "sigmas opening count")
    _ensure(len(o.wires) == config.num_wires, "wires opening count")
    _ensure(len(o.plonk_zs) == config.num_challenges, "Z opening count")
    _ensure(len(o.plonk_zs_next) == config.num_challenges, "Z-next opening count")
    _ensure(
        len(o.partial_products)
        == config.num_challenges * common.num_partial_products,
        "partial products opening count",
    )
    _ensure(
        len(o.quotient_polys) == common.num_quotient_polys(),
        "quotient opening count",
    )
    _ensure(
        len(o.lookup_zs) == common.num_all_lookup_polys(),
        "lookup Z opening count",
    )
    _ensure(
        len(o.lookup_zs_next) == common.num_all_lookup_polys(),
        "lookup Z-next opening count",
    )
    for ext in (
        o.constants
        + o.plonk_sigmas
        + o.wires
        + o.plonk_zs
        + o.plonk_zs_next
        + o.partial_products
        + o.quotient_polys
        + o.lookup_zs
        + o.lookup_zs_next
    ):
        _ensure(len(ext) == 2, "opening is not a quadratic extension element")

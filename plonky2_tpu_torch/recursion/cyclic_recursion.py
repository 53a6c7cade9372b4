"""Cyclic recursion (IVC): a circuit that verifies a proof of *itself*,
with the verifier data carried in the public inputs (reference:
plonky2/src/recursion/cyclic_recursion.rs:40-240).

`common_data_for_recursion` builds the recursion-shape fixpoint without
commitments; a chain of proofs (a base case, then recursive steps) is
proven with ``cyclic_base_proof`` and checked with ``verify_cyclic``.
"""

from __future__ import annotations

from typing import List, Optional

from ..iop.target import BoolTarget
from ..plonk.proof_target import ProofWithPublicInputsTarget
from ..plonk.recursive_verifier import VerifierCircuitTarget
from .conditional import conditionally_verify_proof


def register_verifier_data_public_inputs(builder, cap_height: int) -> VerifierCircuitTarget:
    """Allocate the circuit's own verifier data as public inputs
    (cyclic_recursion.rs:40-66). Returns the targets; the caller stores
    them on the builder for later constant-binding."""
    vd = VerifierCircuitTarget(
        constants_sigmas_cap=None,
        circuit_digest=None,
    )
    from ..plonk.proof_target import MerkleCapTarget

    hashes = []
    for _ in range(1 << cap_height):
        h = builder.add_virtual_targets(4)
        builder.register_public_inputs(h)
        hashes.append(h)
    digest = builder.add_virtual_targets(4)
    builder.register_public_inputs(digest)
    vd.constants_sigmas_cap = MerkleCapTarget(hashes)
    vd.circuit_digest = digest
    builder.verifier_data_public_input = vd
    return vd


def cyclic_base_and_step(
    builder,
    condition: BoolTarget,
    inner_proof: ProofWithPublicInputsTarget,
    common,
) -> VerifierCircuitTarget:
    """Wire the cyclic check: the inner proof's trailing public inputs must
    equal this circuit's own verifier data, and the proof verifies against
    exactly that data (cyclic_recursion.rs:109-170). `condition` selects
    between the real inner proof (step case) and a dummy (base case)."""
    vd_pi = getattr(builder, "verifier_data_public_input", None)
    assert vd_pi is not None, "call register_verifier_data_public_inputs first"

    # inner verifier data = the inner proof's own trailing public inputs
    num_vd_elts = len(vd_pi.constants_sigmas_cap.hashes) * 4 + 4
    inner_tail = inner_proof.public_inputs[-num_vd_elts:]
    from ..plonk.proof_target import MerkleCapTarget

    inner_vd = VerifierCircuitTarget(
        constants_sigmas_cap=MerkleCapTarget(
            [list(inner_tail[4 * i : 4 * i + 4]) for i in range(len(vd_pi.constants_sigmas_cap.hashes))]
        ),
        circuit_digest=list(inner_tail[-4:]),
    )
    # the inner proof must embed THIS circuit's verifier data
    for h0, h1 in zip(inner_vd.constants_sigmas_cap.hashes, vd_pi.constants_sigmas_cap.hashes):
        for a, b in zip(h0, h1):
            builder.connect(a, b)
    for a, b in zip(inner_vd.circuit_digest, vd_pi.circuit_digest):
        builder.connect(a, b)
    return inner_vd


def conditionally_verify_cyclic_proof_or_dummy(
    builder,
    condition: BoolTarget,
    inner_proof: ProofWithPublicInputsTarget,
    common,
    device=None,
):
    """IVC step: the inner proof must embed THIS circuit's verifier data
    (carried in the public inputs) and verifies against it when
    `condition`, against a dummy otherwise
    (cyclic_recursion.rs:109-207). The dummy is proven on ``device`` (None
    means the GPU)."""
    from .conditional import conditionally_verify_proof_or_dummy

    vd_pi = getattr(builder, "verifier_data_public_input", None)
    assert vd_pi is not None, "call register_verifier_data_public_inputs first"
    cyclic_base_and_step(builder, condition, inner_proof, common)
    out = conditionally_verify_proof_or_dummy(
        builder, condition, inner_proof, vd_pi, common, device=device
    )
    for g in common.gates:
        builder.add_gate_to_gate_set(g)
    return out


def cyclic_base_proof(dummy, verifier_only, nonzero_public_inputs=None, device=None):
    """Base-case dummy proof whose trailing public inputs carry the real
    cyclic circuit's verifier data (dummy_circuit.rs cyclic_base_proof).
    dummy: the circuit data of ``dummy_circuit`` over the cyclic circuit's
    common data (its DummyProofGenerator keeps one: ``circuit()``), proven
    on ``device`` (None means the GPU)."""
    from .dummy_circuit import dummy_proof

    common = dummy.common
    pis = dict(nonzero_public_inputs or {})
    cap_elts = (1 << common.fri_params.config.cap_height) * 4
    num_vd = cap_elts + 4
    base = common.num_public_inputs - num_vd
    flat = [int(x) for row in verifier_only.constants_sigmas_cap for x in row]
    flat += [int(x) for x in verifier_only.circuit_digest]
    for i, v in enumerate(flat):
        pis[base + i] = v
    return dummy_proof(dummy, pis, device=device)


def common_data_for_recursion(config=None, min_degree_bits: int = 12):
    """Shape fixpoint for cyclic recursion (cyclic_recursion.rs:256-286):
    an empty circuit, a circuit verifying it, and a padded circuit
    verifying THAT — whose common data equals its own recursive
    verifier's."""
    from ..gates.basic import NoopGate
    from ..plonk.circuit_builder import CircuitBuilder
    from ..plonk.config import CircuitConfig
    from ..plonk.proof_target import add_virtual_proof_with_pis
    from ..plonk.recursive_verifier import (
        add_virtual_verifier_data,
        verify_proof_circuit,
    )

    config = config or CircuitConfig.standard_recursion_config()
    data = CircuitBuilder(config).build(commit=False)
    for _ in range(2):
        b = CircuitBuilder(config)
        proof = add_virtual_proof_with_pis(b, data.common)
        vd = add_virtual_verifier_data(b, data.common.fri_params.config.cap_height)
        verify_proof_circuit(b, proof, vd, data.common)
        if data.common.degree_bits >= min_degree_bits:
            while b.num_gates() < (1 << min_degree_bits):
                b.add_gate(NoopGate(), [])
        data = b.build(commit=False)
    return data.common


def verify_cyclic(proof_with_pis, verifier_data, common, gc=None) -> None:
    """verify() + the embedded-verifier-data equality check
    (circuit_data verify_cyclic)."""
    from ..plonk.verifier import verify

    verify(proof_with_pis, verifier_data, common, gc=gc)
    check_cyclic_proof_verifier_data(proof_with_pis, verifier_data, common)


def check_cyclic_proof_verifier_data(proof_with_pis, verifier_data, common) -> None:
    """Host-side check that a cyclic proof's embedded verifier data equals
    the actual circuit's (cyclic_recursion.rs:217-240)."""
    cap_elts = (1 << common.fri_params.config.cap_height) * 4
    num_vd = cap_elts + 4
    tail = proof_with_pis.public_inputs[-num_vd:]
    flat_cap = [int(x) for row in verifier_data.constants_sigmas_cap for x in row]
    if tail[:cap_elts] != flat_cap:
        raise ValueError("cyclic proof embeds a different constants_sigmas_cap")
    if tuple(tail[cap_elts:]) != tuple(int(x) for x in verifier_data.circuit_digest):
        raise ValueError("cyclic proof embeds a different circuit digest")

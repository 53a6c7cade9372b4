"""Dummy circuits/proofs matching a given CommonCircuitData (reference:
plonky2/src/recursion/dummy_circuit.rs:39-160). Used as the base-case
branch of conditional/cyclic recursion."""

from __future__ import annotations

from typing import Dict, Optional

from dataclasses import dataclass

from ..iop.generator import SimpleGenerator
from ..iop.witness import PartialWitness
from ..plonk.circuit_builder import CircuitBuilder
from ..plonk.prover import prove


@dataclass
class _ZeroGenerator(SimpleGenerator):
    target: object

    def id(self) -> str:
        return "_ZeroGenerator"

    def dependencies(self):
        return []

    def run_once(self, witness, out) -> None:
        out.set_target(self.target, 0)


def dummy_circuit(common, device=None):
    """Generate a circuit whose CommonCircuitData matches `common`
    (dummy_circuit.rs:89-116). device: where its constants/sigmas
    commitment lives; None means the GPU (raises without one).

    If `common`'s gate set has no ConstantGate (its constants were all
    hosted in other gates' extra-constant wires), the dummy's constants
    (the PI-hash sponge's zero) must also avoid a ConstantGate: one row
    of a constant-bearing gate from `common`'s set hosts them."""
    from ..gates.basic import ConstantGate, NoopGate

    degree = common.degree
    num_noop = degree - -(-common.num_public_inputs // 8) - 2

    builder = CircuitBuilder(common.config)
    has_constant_gate = any(isinstance(g, ConstantGate) for g in common.gates)
    if not has_constant_gate:
        hosts = [g for g in common.gates if g.extra_constant_wires()]
        assert hosts, "no gate in the common set can host constants"
        host = hosts[0]
        row = builder.add_gate(host, [])
        # feed the host row's generators all-zero inputs so the witness
        # fixpoint completes (its constraints hold on the zero row)
        deps = []
        for g in host.generators(row, [0] * host.num_constants()):
            deps.extend(g.dependencies())
        for t in dict.fromkeys(deps):
            builder.add_simple_generator(_ZeroGenerator(t))
        num_noop -= 1
    for _ in range(num_noop):
        builder.add_gate(NoopGate(), [])
    for gate in common.gates:
        builder.add_gate_to_gate_set(gate)
    for _ in range(common.num_public_inputs):
        builder.add_virtual_public_input()
    data = builder.build(device=device)
    assert common_shape_eq(data.common, common), "dummy circuit shape mismatch"
    return data


def dummy_proof(
    circuit, nonzero_public_inputs: Optional[Dict[int, int]] = None, device=None
):
    """Prove the dummy circuit with (mostly zero) public inputs, on
    ``device`` (None means the GPU; the circuit's commitment must be there)."""
    nonzero_public_inputs = nonzero_public_inputs or {}
    pw = PartialWitness()
    for i in range(circuit.common.num_public_inputs):
        pw.set_target(
            circuit.prover_only.public_inputs[i], nonzero_public_inputs.get(i, 0)
        )
    return prove(circuit.prover_only, circuit.common, pw, device=device)


def common_shape_eq(a, b) -> bool:
    return (
        a.trace_degree_bits == b.trace_degree_bits
        and [g.id() for g in a.gates] == [g.id() for g in b.gates]
        and a.selectors_info.selector_indices == b.selectors_info.selector_indices
        and a.selectors_info.groups == b.selectors_info.groups
        and a.num_constants == b.num_constants
        and a.num_public_inputs == b.num_public_inputs
        and a.k_is == b.k_is
        and a.num_partial_products == b.num_partial_products
        and a.num_lookup_polys == b.num_lookup_polys
    )

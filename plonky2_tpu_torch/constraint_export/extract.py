"""Drive each gate's ``eval_unfiltered`` over the symbolic algebra to
extract its constraint polynomials (constraint-exporter/src/extract.rs).

The reference extracts three gates (Arithmetic, BaseSum<2>, Poseidon2);
the single-source algebra lets this exporter cover the whole gate set.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..gates.algebra import EvalVars
from . import symbolic as sym


@dataclass
class Extracted:
    """A named, extracted gate constraint set. Each constraint is an
    arena handle for a polynomial over w{i}, c{i}, pi{i} that must = 0."""

    name: str
    gate_id: str
    num_wires: int
    num_constants: int
    constraints: List[int]
    arena: List[tuple]  # snapshot of the node arena at extraction time


def extract(gate, name: str | None = None) -> Extracted:
    sym.reset()
    A = sym.SymbolicAlgebra()
    vars = EvalVars(
        local_constants=[sym.lconst(i) for i in range(gate.num_constants())],
        local_wires=[sym.wire(i) for i in range(gate.num_wires())],
        public_inputs_hash=[sym.pih(i) for i in range(4)],
    )
    constraints = gate.eval_unfiltered(vars, A)
    assert len(constraints) == gate.num_constraints(), (
        f"{gate.id()}: emitted {len(constraints)} constraints, "
        f"declares {gate.num_constraints()}"
    )
    return Extracted(
        name=name or _lean_name(gate),
        gate_id=gate.id(),
        num_wires=gate.num_wires(),
        num_constants=gate.num_constants(),
        constraints=list(constraints),
        arena=[sym.node(i) for i in range(sym.num_nodes())],
    )


def _lean_name(gate) -> str:
    base = type(gate).__name__
    return base[0].lower() + base[1:]


def default_gate_set():
    """One representative instance per gate type (mirrors the prover's
    DefaultGateSerializer coverage)."""
    from ..gates.basic import ArithmeticGate, ConstantGate, NoopGate, PublicInputGate
    from ..gates.extension import (
        ArithmeticExtensionGate,
        MulExtensionGate,
        ReducingExtensionGate,
        ReducingGate,
    )
    from ..gates.interpolation import CosetInterpolationGate, PoseidonMdsGate
    from ..gates.lookup import LookupGate, LookupTableGate
    from ..gates.misc import BaseSumGate, ExponentiationGate, RandomAccessGate
    from ..gates.poseidon import PoseidonGate
    from ..gates.poseidon2 import Poseidon2Gate, Poseidon2IntMixGate, Poseidon2MdsGate

    lut = tuple((i, (i * 7 + 3) % 64) for i in range(16))
    return [
        ArithmeticGate(num_ops=20),
        ConstantGate(num_consts=2),
        PublicInputGate(),
        NoopGate(),
        ArithmeticExtensionGate(num_ops=10),
        MulExtensionGate(num_ops=13),
        ReducingGate(num_coeffs=33),
        ReducingExtensionGate(num_coeffs=32),
        BaseSumGate(num_limbs=63, base=2),
        ExponentiationGate(num_power_bits=17),
        RandomAccessGate(bits=4, num_copies=4, num_extra_constants=2),
        CosetInterpolationGate(subgroup_bits=4, max_degree=8),
        PoseidonMdsGate(),
        PoseidonGate(),
        Poseidon2Gate(),
        Poseidon2MdsGate(),
        Poseidon2IntMixGate(),
        LookupGate(num_slots=5, lut=lut),
        LookupTableGate(num_slots=5, lut=lut, last_lut_row=0),
    ]


def extract_all() -> List[Extracted]:
    return [extract(g) for g in default_gate_set()]

"""Basic gates: Arithmetic, Constant, PublicInput, Noop
(reference: plonky2/src/gates/{arithmetic_base.rs,constant.rs,
public_input.rs,noop.rs})."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from ..iop.generator import SimpleGenerator
from ..iop.target import Target
from .algebra import EvalVars
from .gate import Gate


@dataclass(frozen=True)
class ArithmeticGate(Gate):
    """result = const_0 * x * y + const_1 * z; num_ops ops per row
    (4 routed wires each)."""

    num_ops: int

    @staticmethod
    def new_from_config(config) -> "ArithmeticGate":
        return ArithmeticGate(config.num_routed_wires // 4)

    def id(self) -> str:
        return f"ArithmeticGate {{ num_ops: {self.num_ops} }}"

    @staticmethod
    def wire_ith_multiplicand_0(i):
        return 4 * i

    @staticmethod
    def wire_ith_multiplicand_1(i):
        return 4 * i + 1

    @staticmethod
    def wire_ith_addend(i):
        return 4 * i + 2

    @staticmethod
    def wire_ith_output(i):
        return 4 * i + 3

    def num_wires(self) -> int:
        return 4 * self.num_ops

    def num_constants(self) -> int:
        return 2

    def degree(self) -> int:
        return 3

    def num_constraints(self) -> int:
        return self.num_ops

    def eval_unfiltered(self, vars: EvalVars, A) -> List:
        c0 = vars.local_constants[0]
        c1 = vars.local_constants[1]
        out = []
        for i in range(self.num_ops):
            m0 = vars.local_wires[self.wire_ith_multiplicand_0(i)]
            m1 = vars.local_wires[self.wire_ith_multiplicand_1(i)]
            addend = vars.local_wires[self.wire_ith_addend(i)]
            output = vars.local_wires[self.wire_ith_output(i)]
            computed = A.add(A.mul(A.mul(m0, m1), c0), A.mul(addend, c1))
            out.append(A.sub(output, computed))
        return out

    def generators(self, row: int, local_constants: Sequence[int]) -> List:
        return [
            ArithmeticBaseGenerator(row, local_constants[0], local_constants[1], i)
            for i in range(self.num_ops)
        ]


@dataclass
class ArithmeticBaseGenerator(SimpleGenerator):
    row: int
    const_0: int
    const_1: int
    i: int

    def id(self) -> str:
        return "ArithmeticBaseGenerator"

    def dependencies(self) -> List[Target]:
        return [
            Target.wire(self.row, ArithmeticGate.wire_ith_multiplicand_0(self.i)),
            Target.wire(self.row, ArithmeticGate.wire_ith_multiplicand_1(self.i)),
            Target.wire(self.row, ArithmeticGate.wire_ith_addend(self.i)),
        ]

    def run_once(self, witness, out) -> None:
        from ..field.goldilocks import gadd, gmul

        m0 = witness.get_target(Target.wire(self.row, ArithmeticGate.wire_ith_multiplicand_0(self.i)))
        m1 = witness.get_target(Target.wire(self.row, ArithmeticGate.wire_ith_multiplicand_1(self.i)))
        addend = witness.get_target(Target.wire(self.row, ArithmeticGate.wire_ith_addend(self.i)))
        result = gadd(gmul(gmul(m0, m1), self.const_0), gmul(addend, self.const_1))
        out.set_wire(self.row, ArithmeticGate.wire_ith_output(self.i), result)


@dataclass(frozen=True)
class ConstantGate(Gate):
    """Routes constants into the wire space: wire i == constant i."""

    num_consts: int

    def id(self) -> str:
        return f"ConstantGate {{ num_consts: {self.num_consts} }}"

    def num_wires(self) -> int:
        return self.num_consts

    def num_constants(self) -> int:
        return self.num_consts

    def degree(self) -> int:
        return 1

    def num_constraints(self) -> int:
        return self.num_consts

    def eval_unfiltered(self, vars: EvalVars, A) -> List:
        return [
            A.sub(vars.local_constants[i], vars.local_wires[i])
            for i in range(self.num_consts)
        ]

    def extra_constant_wires(self):
        return [(i, i) for i in range(self.num_consts)]

    def generators(self, row: int, local_constants: Sequence[int]) -> List:
        return []  # ConstantGenerators are added by the builder


@dataclass(frozen=True)
class PublicInputGate(Gate):
    """Routes the public-input hash: wires 0..4 == H(public_inputs)."""

    def id(self) -> str:
        return "PublicInputGate"

    @staticmethod
    def wires_public_inputs_hash():
        return [0, 1, 2, 3]

    def num_wires(self) -> int:
        return 4

    def num_constants(self) -> int:
        return 0

    def degree(self) -> int:
        return 1

    def num_constraints(self) -> int:
        return 4

    def eval_unfiltered(self, vars: EvalVars, A) -> List:
        return [
            A.sub(vars.local_wires[w], vars.public_inputs_hash[i])
            for i, w in enumerate(self.wires_public_inputs_hash())
        ]

    def generators(self, row: int, local_constants: Sequence[int]) -> List:
        return []


@dataclass(frozen=True)
class NoopGate(Gate):
    def id(self) -> str:
        return "NoopGate"

    def num_wires(self) -> int:
        return 0

    def num_constants(self) -> int:
        return 0

    def degree(self) -> int:
        return 0

    def num_constraints(self) -> int:
        return 0

    def eval_unfiltered(self, vars: EvalVars, A) -> List:
        return []

    def generators(self, row: int, local_constants: Sequence[int]) -> List:
        return []

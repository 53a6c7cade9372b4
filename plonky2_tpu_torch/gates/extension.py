"""Extension-arithmetic gates: ArithmeticExtensionGate, MulExtensionGate,
ReducingGate, ReducingExtensionGate (reference:
plonky2/src/gates/{arithmetic_extension.rs,multiplication_extension.rs,
reducing.rs,reducing_extension.rs}).

All operate on D=2 extension elements laid out as consecutive wire
pairs; constraints are expressed once over the generic ext-of-ext
algebra in gates/ext_algebra.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from ..field import extension as ge
from ..field import goldilocks as gl
from ..iop.generator import SimpleGenerator
from ..iop.target import Target
from . import ext_algebra as ea
from .algebra import EvalVars
from .gate import Gate

D = ea.D


def _ext(vars, rng):
    return [vars.local_wires[i] for i in rng]


@dataclass(frozen=True)
class ArithmeticExtensionGate(Gate):
    """result = c0 * x * y + c1 * z over GF(p^2); num_ops per row."""

    num_ops: int

    @staticmethod
    def new_from_config(config) -> "ArithmeticExtensionGate":
        return ArithmeticExtensionGate(config.num_routed_wires // (4 * D))

    def id(self) -> str:
        return f"ArithmeticExtensionGate {{ num_ops: {self.num_ops} }}"

    @staticmethod
    def wires_ith_multiplicand_0(i):
        return range(4 * D * i, 4 * D * i + D)

    @staticmethod
    def wires_ith_multiplicand_1(i):
        return range(4 * D * i + D, 4 * D * i + 2 * D)

    @staticmethod
    def wires_ith_addend(i):
        return range(4 * D * i + 2 * D, 4 * D * i + 3 * D)

    @staticmethod
    def wires_ith_output(i):
        return range(4 * D * i + 3 * D, 4 * D * i + 4 * D)

    def num_wires(self) -> int:
        return self.num_ops * 4 * D

    def num_constants(self) -> int:
        return 2

    def degree(self) -> int:
        return 3

    def num_constraints(self) -> int:
        return self.num_ops * D

    def eval_unfiltered(self, vars: EvalVars, A) -> List:
        c0 = vars.local_constants[0]
        c1 = vars.local_constants[1]
        out = []
        for i in range(self.num_ops):
            m0 = _ext(vars, self.wires_ith_multiplicand_0(i))
            m1 = _ext(vars, self.wires_ith_multiplicand_1(i))
            addend = _ext(vars, self.wires_ith_addend(i))
            output = _ext(vars, self.wires_ith_output(i))
            computed = ea.ea_add(
                A,
                ea.ea_scalar_mul(A, ea.ea_mul(A, m0, m1), c0),
                ea.ea_scalar_mul(A, addend, c1),
            )
            out.extend(ea.ea_sub(A, output, computed))
        return out

    def generators(self, row: int, local_constants: Sequence[int]) -> List:
        return [
            ArithmeticExtensionGenerator(
                row, local_constants[0], local_constants[1], i
            )
            for i in range(self.num_ops)
        ]


@dataclass
class ArithmeticExtensionGenerator(SimpleGenerator):
    row: int
    const_0: int
    const_1: int
    i: int

    def id(self) -> str:
        return "ArithmeticExtensionGenerator"

    def dependencies(self) -> List[Target]:
        g = ArithmeticExtensionGate
        return [
            Target.wire(self.row, w)
            for rng in (
                g.wires_ith_multiplicand_0(self.i),
                g.wires_ith_multiplicand_1(self.i),
                g.wires_ith_addend(self.i),
            )
            for w in rng
        ]

    def run_once(self, witness, out) -> None:
        g = ArithmeticExtensionGate
        ext = lambda rng: tuple(
            witness.get_target(Target.wire(self.row, w)) for w in rng
        )
        m0 = ext(g.wires_ith_multiplicand_0(self.i))
        m1 = ext(g.wires_ith_multiplicand_1(self.i))
        addend = ext(g.wires_ith_addend(self.i))
        res = ge.ext_add(
            ge.ext_scalar_mul(ge.ext_mul(m0, m1), self.const_0),
            ge.ext_scalar_mul(addend, self.const_1),
        )
        for w, v in zip(g.wires_ith_output(self.i), res):
            out.set_wire(self.row, w, v)


@dataclass(frozen=True)
class MulExtensionGate(Gate):
    """result = c0 * x * y over GF(p^2); num_ops per row."""

    num_ops: int

    @staticmethod
    def new_from_config(config) -> "MulExtensionGate":
        return MulExtensionGate(config.num_routed_wires // (3 * D))

    def id(self) -> str:
        return f"MulExtensionGate {{ num_ops: {self.num_ops} }}"

    @staticmethod
    def wires_ith_multiplicand_0(i):
        return range(3 * D * i, 3 * D * i + D)

    @staticmethod
    def wires_ith_multiplicand_1(i):
        return range(3 * D * i + D, 3 * D * i + 2 * D)

    @staticmethod
    def wires_ith_output(i):
        return range(3 * D * i + 2 * D, 3 * D * i + 3 * D)

    def num_wires(self) -> int:
        return self.num_ops * 3 * D

    def num_constants(self) -> int:
        return 1

    def degree(self) -> int:
        return 3

    def num_constraints(self) -> int:
        return self.num_ops * D

    def eval_unfiltered(self, vars: EvalVars, A) -> List:
        c0 = vars.local_constants[0]
        out = []
        for i in range(self.num_ops):
            m0 = _ext(vars, self.wires_ith_multiplicand_0(i))
            m1 = _ext(vars, self.wires_ith_multiplicand_1(i))
            output = _ext(vars, self.wires_ith_output(i))
            computed = ea.ea_scalar_mul(A, ea.ea_mul(A, m0, m1), c0)
            out.extend(ea.ea_sub(A, output, computed))
        return out

    def generators(self, row: int, local_constants: Sequence[int]) -> List:
        return [
            MulExtensionGenerator(row, local_constants[0], i)
            for i in range(self.num_ops)
        ]


@dataclass
class MulExtensionGenerator(SimpleGenerator):
    row: int
    const_0: int
    i: int

    def id(self) -> str:
        return "MulExtensionGenerator"

    def dependencies(self) -> List[Target]:
        g = MulExtensionGate
        return [
            Target.wire(self.row, w)
            for rng in (
                g.wires_ith_multiplicand_0(self.i),
                g.wires_ith_multiplicand_1(self.i),
            )
            for w in rng
        ]

    def run_once(self, witness, out) -> None:
        g = MulExtensionGate
        ext = lambda rng: tuple(
            witness.get_target(Target.wire(self.row, w)) for w in rng
        )
        m0 = ext(g.wires_ith_multiplicand_0(self.i))
        m1 = ext(g.wires_ith_multiplicand_1(self.i))
        res = ge.ext_scalar_mul(ge.ext_mul(m0, m1), self.const_0)
        for w, v in zip(g.wires_ith_output(self.i), res):
            out.set_wire(self.row, w, v)


@dataclass(frozen=True)
class ReducingGate(Gate):
    """acc' = acc * alpha + coeff, over base-field coefficients
    (util/reducing.rs ReducingFactorTarget::reduce)."""

    num_coeffs: int

    @staticmethod
    def max_coeffs_len(num_wires: int, num_routed_wires: int) -> int:
        return min(num_routed_wires - 3 * D, (num_wires - 2 * D) // (D + 1))

    def id(self) -> str:
        return f"ReducingGate {{ num_coeffs: {self.num_coeffs} }}"

    @staticmethod
    def wires_output():
        return range(0, D)

    @staticmethod
    def wires_alpha():
        return range(D, 2 * D)

    @staticmethod
    def wires_old_acc():
        return range(2 * D, 3 * D)

    def wires_coeffs(self):
        return range(3 * D, 3 * D + self.num_coeffs)

    def _start_accs(self) -> int:
        return 3 * D + self.num_coeffs

    def wires_accs(self, i: int):
        if i == self.num_coeffs - 1:
            return self.wires_output()
        return range(self._start_accs() + D * i, self._start_accs() + D * (i + 1))

    def num_wires(self) -> int:
        return self._start_accs() + D * (self.num_coeffs - 1)

    def num_constants(self) -> int:
        return 0

    def degree(self) -> int:
        return 2

    def num_constraints(self) -> int:
        return D * self.num_coeffs

    def eval_unfiltered(self, vars: EvalVars, A) -> List:
        alpha = _ext(vars, self.wires_alpha())
        acc = _ext(vars, self.wires_old_acc())
        out = []
        for i in range(self.num_coeffs):
            coeff = ea.ea_from_base(A, vars.local_wires[3 * D + i])
            acc_new = _ext(vars, self.wires_accs(i))
            computed = ea.ea_add(A, ea.ea_mul(A, acc, alpha), coeff)
            out.extend(ea.ea_sub(A, computed, acc_new))
            acc = acc_new
        return out

    def generators(self, row: int, local_constants: Sequence[int]) -> List:
        return [ReducingGenerator(row, self.num_coeffs)]


@dataclass
class ReducingGenerator(SimpleGenerator):
    row: int
    num_coeffs: int

    def id(self) -> str:
        return "ReducingGenerator"

    def dependencies(self) -> List[Target]:
        g = ReducingGate(self.num_coeffs)
        return [
            Target.wire(self.row, w)
            for w in [*g.wires_alpha(), *g.wires_old_acc(), *g.wires_coeffs()]
        ]

    def run_once(self, witness, out) -> None:
        g = ReducingGate(self.num_coeffs)
        ext = lambda rng: tuple(
            witness.get_target(Target.wire(self.row, w)) for w in rng
        )
        alpha = ext(g.wires_alpha())
        acc = ext(g.wires_old_acc())
        coeffs = [witness.get_target(Target.wire(self.row, w)) for w in g.wires_coeffs()]
        for i in range(self.num_coeffs):
            acc = ge.ext_add(ge.ext_mul(acc, alpha), ge.from_base(coeffs[i], D))
            for w, v in zip(g.wires_accs(i), acc):
                out.set_wire(self.row, w, v)


@dataclass(frozen=True)
class ReducingExtensionGate(Gate):
    """acc' = acc * alpha + coeff, extension coefficients
    (gates/reducing_extension.rs)."""

    num_coeffs: int

    @staticmethod
    def max_coeffs_len(num_wires: int, num_routed_wires: int) -> int:
        return min((num_routed_wires - 3 * D) // D, (num_wires - 2 * D) // (2 * D))

    def id(self) -> str:
        return f"ReducingExtensionGate {{ num_coeffs: {self.num_coeffs} }}"

    @staticmethod
    def wires_output():
        return range(0, D)

    @staticmethod
    def wires_alpha():
        return range(D, 2 * D)

    @staticmethod
    def wires_old_acc():
        return range(2 * D, 3 * D)

    @staticmethod
    def wires_coeff(i: int):
        return range(3 * D + D * i, 3 * D + D * (i + 1))

    def _start_accs(self) -> int:
        return 3 * D + D * self.num_coeffs

    def wires_accs(self, i: int):
        if i == self.num_coeffs - 1:
            return self.wires_output()
        return range(self._start_accs() + D * i, self._start_accs() + D * (i + 1))

    def num_wires(self) -> int:
        return self._start_accs() + D * (self.num_coeffs - 1)

    def num_constants(self) -> int:
        return 0

    def degree(self) -> int:
        return 2

    def num_constraints(self) -> int:
        return D * self.num_coeffs

    def eval_unfiltered(self, vars: EvalVars, A) -> List:
        alpha = _ext(vars, self.wires_alpha())
        acc = _ext(vars, self.wires_old_acc())
        out = []
        for i in range(self.num_coeffs):
            coeff = _ext(vars, self.wires_coeff(i))
            acc_new = _ext(vars, self.wires_accs(i))
            computed = ea.ea_add(A, ea.ea_mul(A, acc, alpha), coeff)
            out.extend(ea.ea_sub(A, computed, acc_new))
            acc = acc_new
        return out

    def eval_unfiltered_device(self, vars: EvalVars, A) -> List:
        """Batched device eval: every constraint is independent given the
        wires (acc_{i+1} is a wire, not the computed value), so all
        num_coeffs extension mul-adds run as one stacked [n, B]
        computation, a few launches in place of the generic path's
        hundreds. Same values, same constraint order (pinned by
        gate_testing.check_algebra_agreement)."""
        import torch

        from ..ops import gf
        from .ext_algebra import W as _W

        w = vars.local_wires
        n = self.num_coeffs
        prev_rows = [list(self.wires_old_acc())] + [
            list(self.wires_accs(i)) for i in range(n - 1)
        ]
        coeff_rows = [list(self.wires_coeff(i)) for i in range(n)]
        acc_rows = [list(self.wires_accs(i)) for i in range(n)]

        def gather(rows, comp):
            return torch.stack([w[r[comp]] for r in rows])  # [n, B]

        a0, a1 = gather(prev_rows, 0), gather(prev_rows, 1)
        b0, b1 = (w[j][None] for j in self.wires_alpha())
        # (a0 + a1 x)(b0 + b1 x) = a0b0 + W a1b1 + (a0b1 + a1b0) x
        c0 = gf.add(gf.mul(a0, b0), gf.mul_const(gf.mul(a1, b1), _W))
        c1 = gf.add(gf.mul(a0, b1), gf.mul(a1, b0))
        d0 = gf.sub(gf.add(c0, gather(coeff_rows, 0)), gather(acc_rows, 0))
        d1 = gf.sub(gf.add(c1, gather(coeff_rows, 1)), gather(acc_rows, 1))
        # constraints interleave the two components of each coefficient
        return list(torch.stack([d0, d1], dim=1).reshape(2 * n, -1).unbind(0))

    def generators(self, row: int, local_constants: Sequence[int]) -> List:
        return [ReducingExtensionGenerator(row, self.num_coeffs)]


@dataclass
class ReducingExtensionGenerator(SimpleGenerator):
    row: int
    num_coeffs: int

    def id(self) -> str:
        return "ReducingExtensionGenerator"

    def dependencies(self) -> List[Target]:
        g = ReducingExtensionGate(self.num_coeffs)
        deps = [*g.wires_alpha(), *g.wires_old_acc()]
        for i in range(self.num_coeffs):
            deps.extend(g.wires_coeff(i))
        return [Target.wire(self.row, w) for w in deps]

    def run_once(self, witness, out) -> None:
        g = ReducingExtensionGate(self.num_coeffs)
        ext = lambda rng: tuple(
            witness.get_target(Target.wire(self.row, w)) for w in rng
        )
        alpha = ext(g.wires_alpha())
        acc = ext(g.wires_old_acc())
        for i in range(self.num_coeffs):
            acc = ge.ext_add(ge.ext_mul(acc, alpha), ext(g.wires_coeff(i)))
            for w, v in zip(g.wires_accs(i), acc):
                out.set_wire(self.row, w, v)

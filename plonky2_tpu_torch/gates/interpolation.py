"""CosetInterpolationGate + PoseidonMdsGate (reference:
plonky2/src/gates/coset_interpolation.rs:40-553, gates/poseidon_mds.rs).

CosetInterpolationGate evaluates the interpolant of 2^subgroup_bits
values over a shifted 2-adic coset at an extension point, with the
barycentric running products chunked into bounded-degree intermediate
wires. Used by the recursive FRI verifier's arity folds.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

from ..field import extension as ge
from ..field import goldilocks as gl
from ..field.goldilocks import P
from ..hash.poseidon import MDS_FULL
from ..hash.poseidon_constants import SPONGE_WIDTH
from ..iop.generator import SimpleGenerator
from ..iop.target import Target
from . import ext_algebra as ea
from .algebra import EvalVars
from .gate import Gate

D = ea.D


def barycentric_weights(points: Sequence[int]) -> List[int]:
    """w_i = 1 / prod_{j != i} (x_i - x_j) (field/src/interpolation.rs:13)."""
    n = len(points)
    out = []
    for i in range(n):
        acc = 1
        for j in range(n):
            if j != i:
                acc = acc * ((points[i] - points[j]) % P) % P
        out.append(pow(acc, P - 2, P))
    return out


def _ea_const(A, c: int):
    return [A.const(c), A.zero()]


def _partial_interpolate(A, domain, values, weights, x, ev, pr):
    """Fold the barycentric recurrence over a chunk of points
    (coset_interpolation.rs:572-599)."""
    for x_i, v, wt in zip(domain, values, weights):
        term = ea.ea_sub(A, x, _ea_const(A, x_i))
        wv = [A.mul_const(c, wt) for c in v]
        ev = ea.ea_add(A, ea.ea_mul(A, ev, term), ea.ea_mul(A, wv, pr))
        pr = ea.ea_mul(A, pr, term)
    return ev, pr


@dataclass(frozen=True)
class CosetInterpolationGate(Gate):
    subgroup_bits: int
    max_degree: int = 8

    @staticmethod
    def with_max_degree(subgroup_bits: int, max_degree: int) -> "CosetInterpolationGate":
        return CosetInterpolationGate(subgroup_bits, max_degree)

    @property
    def gate_degree(self) -> int:
        n_points = 1 << self.subgroup_bits
        n_intermediates = (n_points - 2) // (self.max_degree - 1)
        return (n_points - 2) // (n_intermediates + 1) + 2

    def id(self) -> str:
        return (
            f"CosetInterpolationGate {{ subgroup_bits: {self.subgroup_bits}, "
            f"degree: {self.gate_degree} }}<D={D}>"
        )

    def num_points(self) -> int:
        return 1 << self.subgroup_bits

    def wire_shift(self) -> int:
        return 0

    def wires_value(self, i: int):
        return range(1 + i * D, 1 + (i + 1) * D)

    def _start_evaluation_point(self) -> int:
        return 1 + self.num_points() * D

    def wires_evaluation_point(self):
        s = self._start_evaluation_point()
        return range(s, s + D)

    def wires_evaluation_value(self):
        s = self._start_evaluation_point() + D
        return range(s, s + D)

    def _start_intermediates(self) -> int:
        return self._start_evaluation_point() + 2 * D

    def num_routed_wires(self) -> int:
        return self._start_intermediates()

    def num_intermediates(self) -> int:
        return (self.num_points() - 2) // (self.gate_degree - 1)

    def wires_intermediate_eval(self, i: int):
        s = self._start_intermediates() + D * i
        return range(s, s + D)

    def wires_intermediate_prod(self, i: int):
        s = self._start_intermediates() + D * (self.num_intermediates() + i)
        return range(s, s + D)

    def wires_shifted_evaluation_point(self):
        s = self._start_intermediates() + D * 2 * self.num_intermediates()
        return range(s, s + D)

    def wire_shift_inverse(self) -> int:
        return self._start_intermediates() + D * (2 * self.num_intermediates() + 1)

    def num_wires(self) -> int:
        return self.wire_shift_inverse() + 1

    def num_constants(self) -> int:
        return 0

    def degree(self) -> int:
        return self.gate_degree

    def num_constraints(self) -> int:
        return 1 + 2 * D + 2 * D * self.num_intermediates()

    def _domain(self) -> List[int]:
        return [int(x) for x in gl.two_adic_subgroup(self.subgroup_bits)]

    def _weights(self) -> List[int]:
        return barycentric_weights(self._domain())

    def eval_unfiltered(self, vars: EvalVars, A) -> List:
        w = vars.local_wires
        constraints = []
        shift = w[self.wire_shift()]
        shift_inverse = w[self.wire_shift_inverse()]
        evaluation_point = [w[i] for i in self.wires_evaluation_point()]
        shifted_point = [w[i] for i in self.wires_shifted_evaluation_point()]
        constraints.append(A.add_const(A.mul(shift, shift_inverse), P - 1))
        constraints.extend(
            ea.ea_sub(A, evaluation_point, ea.ea_scalar_mul(A, shifted_point, shift))
        )

        domain = self._domain()
        weights = self._weights()
        values = [[w[i] for i in self.wires_value(k)] for k in range(self.num_points())]
        deg = self.gate_degree

        ev, pr = _partial_interpolate(
            A, domain[:deg], values[:deg], weights[:deg], shifted_point,
            [A.zero(), A.zero()], [A.one(), A.zero()],
        )
        for i in range(self.num_intermediates()):
            int_ev = [w[j] for j in self.wires_intermediate_eval(i)]
            int_pr = [w[j] for j in self.wires_intermediate_prod(i)]
            constraints.extend(ea.ea_sub(A, int_ev, ev))
            constraints.extend(ea.ea_sub(A, int_pr, pr))
            start = 1 + (deg - 1) * (i + 1)
            end = min(start + deg - 1, self.num_points())
            ev, pr = _partial_interpolate(
                A, domain[start:end], values[start:end], weights[start:end],
                shifted_point, int_ev, int_pr,
            )

        evaluation_value = [w[i] for i in self.wires_evaluation_value()]
        constraints.extend(ea.ea_sub(A, evaluation_value, ev))
        return constraints

    def generators(self, row: int, local_constants: Sequence[int]) -> List:
        return [InterpolationGenerator(row, self.subgroup_bits, self.max_degree)]


@dataclass
class InterpolationGenerator(SimpleGenerator):
    row: int
    subgroup_bits: int
    max_degree: int

    def id(self) -> str:
        return "InterpolationGenerator"

    def _gate(self) -> CosetInterpolationGate:
        return CosetInterpolationGate(self.subgroup_bits, self.max_degree)

    def dependencies(self) -> List[Target]:
        g = self._gate()
        deps = [Target.wire(self.row, g.wire_shift())]
        deps += [Target.wire(self.row, i) for i in g.wires_evaluation_point()]
        for k in range(g.num_points()):
            deps += [Target.wire(self.row, i) for i in g.wires_value(k)]
        return deps

    def run_once(self, witness, out) -> None:
        g = self._gate()
        get = lambda col: witness.get_target(Target.wire(self.row, col))
        ext = lambda rng: tuple(get(i) for i in rng)

        shift = get(g.wire_shift())
        shift_inverse = pow(shift, P - 2, P)
        eval_point = ext(g.wires_evaluation_point())
        shifted_point = ge.ext_scalar_mul(eval_point, shift_inverse)
        out.set_wire(self.row, g.wire_shift_inverse(), shift_inverse)
        for w, v in zip(g.wires_shifted_evaluation_point(), shifted_point):
            out.set_wire(self.row, w, v)

        domain = g._domain()
        weights = g._weights()
        values = [ext(g.wires_value(k)) for k in range(g.num_points())]
        deg = g.gate_degree

        def chunk(ev, pr, lo, hi):
            for x_i, v, wt in zip(domain[lo:hi], values[lo:hi], weights[lo:hi]):
                term = ge.ext_sub(shifted_point, ge.from_base(x_i, D))
                wv = ge.ext_scalar_mul(v, wt)
                ev = ge.ext_add(ge.ext_mul(ev, term), ge.ext_mul(wv, pr))
                pr = ge.ext_mul(pr, term)
            return ev, pr

        ev, pr = chunk(ge.ext_zero(D), ge.ext_one(D), 0, deg)
        for i in range(g.num_intermediates()):
            for w, v in zip(g.wires_intermediate_eval(i), ev):
                out.set_wire(self.row, w, v)
            for w, v in zip(g.wires_intermediate_prod(i), pr):
                out.set_wire(self.row, w, v)
            start = 1 + (deg - 1) * (i + 1)
            end = min(start + deg - 1, g.num_points())
            ev, pr = chunk(ev, pr, start, end)

        for w, v in zip(g.wires_evaluation_value(), ev):
            out.set_wire(self.row, w, v)


@dataclass(frozen=True)
class PoseidonMdsGate(Gate):
    """One Poseidon MDS layer over 12 extension elements (poseidon_mds.rs)."""

    def id(self) -> str:
        return "PoseidonMdsGate(PhantomData<plonky2_field::goldilocks_field::GoldilocksField>)<WIDTH=12>"

    @staticmethod
    def wires_input(i: int):
        return range(i * D, (i + 1) * D)

    @staticmethod
    def wires_output(i: int):
        return range((SPONGE_WIDTH + i) * D, (SPONGE_WIDTH + i + 1) * D)

    def num_wires(self) -> int:
        return 2 * D * SPONGE_WIDTH

    def num_constants(self) -> int:
        return 0

    def degree(self) -> int:
        return 1

    def num_constraints(self) -> int:
        return SPONGE_WIDTH * D

    def eval_unfiltered(self, vars: EvalVars, A) -> List:
        w = vars.local_wires
        inputs = [
            [w[j] for j in self.wires_input(i)] for i in range(SPONGE_WIDTH)
        ]
        constraints = []
        for r in range(SPONGE_WIDTH):
            acc = None
            for c in range(SPONGE_WIDTH):
                term = [A.mul_const(x, MDS_FULL[r][c] % P) for x in inputs[c]]
                acc = term if acc is None else ea.ea_add(A, acc, term)
            output = [w[j] for j in self.wires_output(r)]
            constraints.extend(ea.ea_sub(A, acc, output))
        return constraints

    def generators(self, row: int, local_constants: Sequence[int]) -> List:
        return [PoseidonMdsGenerator(row)]


@dataclass
class PoseidonMdsGenerator(SimpleGenerator):
    row: int

    def id(self) -> str:
        return "PoseidonMdsGenerator"

    def dependencies(self) -> List[Target]:
        g = PoseidonMdsGate()
        return [
            Target.wire(self.row, j)
            for i in range(SPONGE_WIDTH)
            for j in g.wires_input(i)
        ]

    def run_once(self, witness, out) -> None:
        g = PoseidonMdsGate()
        ext = lambda rng: tuple(
            witness.get_target(Target.wire(self.row, j)) for j in rng
        )
        inputs = [ext(g.wires_input(i)) for i in range(SPONGE_WIDTH)]
        for r in range(SPONGE_WIDTH):
            acc = ge.ext_zero(D)
            for c in range(SPONGE_WIDTH):
                acc = ge.ext_add(acc, ge.ext_scalar_mul(inputs[c], MDS_FULL[r][c] % P))
            for w, v in zip(g.wires_output(r), acc):
                out.set_wire(self.row, w, v)

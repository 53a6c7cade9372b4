"""BaseSumGate, ExponentiationGate, RandomAccessGate (reference:
plonky2/src/gates/{base_sum.rs,exponentiation.rs,random_access.rs})."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from ..field import goldilocks as gl
from ..field.goldilocks import P
from ..iop.generator import SimpleGenerator
from ..iop.target import Target
from .algebra import EvalVars
from .gate import Gate


@dataclass(frozen=True)
class BaseSumGate(Gate):
    """sum = sum_i limb_i B^i, with each limb range-checked to [0, B)."""

    num_limbs: int
    base: int = 2

    WIRE_SUM = 0
    START_LIMBS = 1

    @staticmethod
    def new_from_config(config, base: int = 2) -> "BaseSumGate":
        num_limbs = min(
            _log_floor(P - 1, base), config.num_routed_wires - BaseSumGate.START_LIMBS
        )
        return BaseSumGate(num_limbs, base)

    def id(self) -> str:
        return f"BaseSumGate {{ num_limbs: {self.num_limbs} }} + Base: {self.base}"

    def limbs(self):
        return range(self.START_LIMBS, self.START_LIMBS + self.num_limbs)

    def num_wires(self) -> int:
        return 1 + self.num_limbs

    def num_constants(self) -> int:
        return 0

    def degree(self) -> int:
        return self.base

    def num_constraints(self) -> int:
        return 1 + self.num_limbs

    def eval_unfiltered(self, vars: EvalVars, A) -> List:
        s = vars.local_wires[self.WIRE_SUM]
        limbs = [vars.local_wires[i] for i in self.limbs()]
        computed = limbs[-1]
        for limb in reversed(limbs[:-1]):
            computed = A.add(A.mul_const(computed, self.base), limb)
        constraints = [A.sub(computed, s)]
        for limb in limbs:
            prod = limb
            for i in range(1, self.base):
                prod = A.mul(prod, A.add_const(limb, P - i))
            constraints.append(prod)
        return constraints

    def eval_unfiltered_device(self, vars: EvalVars, A) -> List:
        """Batched device eval: the recombination is a weighted sum
        (exactly equal to the Horner chain over the field) and the
        per-limb range products stack into one [num_limbs, B] pass, a few
        launches in place of the 63-limb chain's thousands. Same values,
        same constraint order (gate_testing.check_algebra_agreement)."""
        import torch

        from ..ops import gf

        w = vars.local_wires
        limbs = torch.stack([w[i] for i in self.limbs()])  # [L, B]
        pows = gl.np_powers(self.base, self.num_limbs)  # base^i
        weights = gf.from_u64(np.asarray(pows, dtype=np.uint64), limbs.device)
        computed = gf.weighted_sum(limbs, weights)  # [B]
        constraints = [gf.sub(computed, w[self.WIRE_SUM])]
        prod = limbs
        for i in range(1, self.base):
            prod = gf.mul(prod, gf.add(limbs, gf.full((1, 1), P - i, limbs.device)))
        constraints.extend(prod.unbind(0))
        return constraints

    def generators(self, row: int, local_constants: Sequence[int]) -> List:
        return [BaseSplitGenerator(row, self.num_limbs, self.base)]


def _log_floor(n: int, b: int) -> int:
    k = 0
    while n >= b:
        n //= b
        k += 1
    return k


@dataclass
class BaseSplitGenerator(SimpleGenerator):
    row: int
    num_limbs: int
    base: int

    def id(self) -> str:
        return f"BaseSplitGenerator + Base: {self.base}"

    def dependencies(self) -> List[Target]:
        return [Target.wire(self.row, BaseSumGate.WIRE_SUM)]

    def run_once(self, witness, out) -> None:
        s = witness.get_target(Target.wire(self.row, BaseSumGate.WIRE_SUM))
        acc = s
        for i in range(self.num_limbs):
            out.set_wire(self.row, BaseSumGate.START_LIMBS + i, acc % self.base)
            acc //= self.base
        # data check skipped under the witgen tracer (symbolic acc) — the
        # reference's equivalent is a debug_assert, absent in release mode
        assert not isinstance(acc, (int, np.integer)) or acc == 0, (
            "integer too large for the given number of limbs"
        )


@dataclass(frozen=True)
class ExponentiationGate(Gate):
    """output = base ^ (bits interpreted LE), via square-and-multiply
    intermediates stored as wires."""

    num_power_bits: int

    @staticmethod
    def new_from_config(config) -> "ExponentiationGate":
        return ExponentiationGate(
            min(config.num_routed_wires - 2, (config.num_wires - 2) // 2)
        )

    def id(self) -> str:
        return f"ExponentiationGate {{ num_power_bits: {self.num_power_bits} }}"

    def wire_base(self) -> int:
        return 0

    def wire_power_bit(self, i: int) -> int:
        return 1 + i

    def wire_output(self) -> int:
        return 1 + self.num_power_bits

    def wire_intermediate_value(self, i: int) -> int:
        return 2 + self.num_power_bits + i

    def num_wires(self) -> int:
        return self.wire_intermediate_value(self.num_power_bits - 1) + 1

    def num_constants(self) -> int:
        return 0

    def degree(self) -> int:
        return 4

    def num_constraints(self) -> int:
        return self.num_power_bits + 1

    def eval_unfiltered(self, vars: EvalVars, A) -> List:
        w = vars.local_wires
        base = w[self.wire_base()]
        bits = [w[self.wire_power_bit(i)] for i in range(self.num_power_bits)]
        ivs = [w[self.wire_intermediate_value(i)] for i in range(self.num_power_bits)]
        output = w[self.wire_output()]
        constraints = []
        for i in range(self.num_power_bits):
            prev = A.one() if i == 0 else A.mul(ivs[i - 1], ivs[i - 1])
            cur_bit = bits[self.num_power_bits - i - 1]
            not_bit = A.sub_from_const(1, cur_bit)
            computed = A.mul(prev, A.add(A.mul(cur_bit, base), not_bit))
            constraints.append(A.sub(computed, ivs[i]))
        constraints.append(A.sub(output, ivs[-1]))
        return constraints

    def generators(self, row: int, local_constants: Sequence[int]) -> List:
        return [ExponentiationGenerator(row, self.num_power_bits)]


@dataclass
class ExponentiationGenerator(SimpleGenerator):
    row: int
    num_power_bits: int

    def id(self) -> str:
        return "ExponentiationGenerator"

    def dependencies(self) -> List[Target]:
        g = ExponentiationGate(self.num_power_bits)
        deps = [Target.wire(self.row, g.wire_base())]
        deps += [
            Target.wire(self.row, g.wire_power_bit(i))
            for i in range(self.num_power_bits)
        ]
        return deps

    def run_once(self, witness, out) -> None:
        g = ExponentiationGate(self.num_power_bits)
        base = witness.get_target(Target.wire(self.row, g.wire_base()))
        bits = [
            witness.get_target(Target.wire(self.row, g.wire_power_bit(i)))
            for i in range(self.num_power_bits)
        ]
        iv = 1
        for i in range(self.num_power_bits):
            prev = 1 if i == 0 else gl.gmul(iv, iv)
            cur_bit = bits[self.num_power_bits - i - 1]
            iv = gl.gmul(prev, gl.gadd(gl.gmul(cur_bit, base), (1 - cur_bit) % P))
            out.set_wire(self.row, g.wire_intermediate_value(i), iv)
        out.set_wire(self.row, g.wire_output(), iv)


@dataclass(frozen=True)
class RandomAccessGate(Gate):
    """claimed_element == list[access_index], via binary index
    decomposition and log-depth pair selection."""

    bits: int
    num_copies: int
    num_extra_constants: int

    @staticmethod
    def new_from_config(config, bits: int) -> "RandomAccessGate":
        vec_size = 1 << bits
        max_copies = min(
            config.num_routed_wires // (2 + vec_size),
            config.num_wires // (2 + vec_size + bits),
        )
        max_extra = config.num_routed_wires - (2 + vec_size) * max_copies
        return RandomAccessGate(
            bits, max_copies, min(max_extra, config.num_constants)
        )

    def id(self) -> str:
        return (
            f"RandomAccessGate {{ bits: {self.bits}, num_copies: {self.num_copies}, "
            f"num_extra_constants: {self.num_extra_constants} }}"
        )

    def vec_size(self) -> int:
        return 1 << self.bits

    def wire_access_index(self, copy: int) -> int:
        return (2 + self.vec_size()) * copy

    def wire_claimed_element(self, copy: int) -> int:
        return (2 + self.vec_size()) * copy + 1

    def wire_list_item(self, i: int, copy: int) -> int:
        return (2 + self.vec_size()) * copy + 2 + i

    def _start_extra_constants(self) -> int:
        return (2 + self.vec_size()) * self.num_copies

    def wire_extra_constant(self, i: int) -> int:
        return self._start_extra_constants() + i

    def num_routed_wires(self) -> int:
        return self._start_extra_constants() + self.num_extra_constants

    def wire_bit(self, i: int, copy: int) -> int:
        return self.num_routed_wires() + copy * self.bits + i

    def num_wires(self) -> int:
        return self.wire_bit(self.bits - 1, self.num_copies - 1) + 1

    def num_constants(self) -> int:
        return self.num_extra_constants

    def degree(self) -> int:
        return self.bits + 1

    def num_constraints(self) -> int:
        return self.num_copies * (self.bits + 2) + self.num_extra_constants

    def extra_constant_wires(self):
        return [(i, self.wire_extra_constant(i)) for i in range(self.num_extra_constants)]

    def eval_unfiltered(self, vars: EvalVars, A) -> List:
        w = vars.local_wires
        constraints = []
        for copy in range(self.num_copies):
            access_index = w[self.wire_access_index(copy)]
            items = [w[self.wire_list_item(i, copy)] for i in range(self.vec_size())]
            claimed = w[self.wire_claimed_element(copy)]
            bits = [w[self.wire_bit(i, copy)] for i in range(self.bits)]
            for b in bits:
                constraints.append(A.mul(b, A.add_const(b, P - 1)))
            recon = A.zero()
            for b in reversed(bits):
                recon = A.add(A.add(recon, recon), b)
            constraints.append(A.sub(recon, access_index))
            for b in bits:
                items = [
                    A.add(items[2 * k], A.mul(b, A.sub(items[2 * k + 1], items[2 * k])))
                    for k in range(len(items) // 2)
                ]
            constraints.append(A.sub(items[0], claimed))
        for i in range(self.num_extra_constants):
            constraints.append(
                A.sub(vars.local_constants[i], w[self.wire_extra_constant(i)])
            )
        return constraints

    def generators(self, row: int, local_constants: Sequence[int]) -> List:
        return [
            RandomAccessGenerator(row, self.bits, self.num_copies, self.num_extra_constants, copy)
            for copy in range(self.num_copies)
        ]


@dataclass
class RandomAccessGenerator(SimpleGenerator):
    row: int
    bits: int
    num_copies: int
    num_extra_constants: int
    copy: int

    def id(self) -> str:
        return "RandomAccessGenerator"

    def _gate(self) -> RandomAccessGate:
        return RandomAccessGate(self.bits, self.num_copies, self.num_extra_constants)

    def dependencies(self) -> List[Target]:
        g = self._gate()
        deps = [Target.wire(self.row, g.wire_access_index(self.copy))]
        deps += [
            Target.wire(self.row, g.wire_list_item(i, self.copy))
            for i in range(g.vec_size())
        ]
        return deps

    def run_once(self, witness, out) -> None:
        g = self._gate()
        idx = witness.get_target(Target.wire(self.row, g.wire_access_index(self.copy)))
        assert idx < g.vec_size(), "access index out of range"
        items = [
            witness.get_target(Target.wire(self.row, g.wire_list_item(i, self.copy)))
            for i in range(g.vec_size())
        ]
        out.set_wire(self.row, g.wire_claimed_element(self.copy), items[idx])
        for i in range(self.bits):
            out.set_wire(self.row, g.wire_bit(i, self.copy), (idx >> i) & 1)

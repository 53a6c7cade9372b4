"""Gadget library: builder extension methods over base and extension
targets (reference: plonky2/src/gadgets/{arithmetic.rs,
arithmetic_extension.rs,select.rs,random_access.rs,range_check.rs,
split_base.rs,reducing.rs,interpolation.rs,polynomial.rs}).

Implemented as a mixin inherited by CircuitBuilder.
"""

from __future__ import annotations

import numpy as _np

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ..field import extension as ge
from ..field import goldilocks as gl
from ..gates.extension import (
    ArithmeticExtensionGate,
    MulExtensionGate,
    ReducingExtensionGate,
    ReducingGate,
)
from ..gates.interpolation import CosetInterpolationGate
from ..gates.misc import BaseSumGate, ExponentiationGate, RandomAccessGate
from ..iop.generator import SimpleGenerator
from ..iop.target import BoolTarget, ExtensionTarget, Target

D = 2
Ext = Tuple[int, ...]


@dataclass
class ExtInverseGenerator(SimpleGenerator):
    x: ExtensionTarget
    inv: ExtensionTarget

    def id(self) -> str:
        return "ExtInverseGenerator"

    def dependencies(self) -> List[Target]:
        return list(self.x.parts)

    def run_once(self, witness, out) -> None:
        xv = tuple(witness.get_target(t) for t in self.x.parts)
        invv = ge.ext_inv(xv)
        for t, v in zip(self.inv.parts, invv):
            out.set_target(t, v)


@dataclass
class LowHighGenerator(SimpleGenerator):
    """Splits x into (low, high) with x = low + 2^n_log * high
    (gadgets/split_join.rs)."""

    x: Target
    n_log: int
    low: Target
    high: Target

    def id(self) -> str:
        return "LowHighGenerator"

    def dependencies(self) -> List[Target]:
        return [self.x]

    def run_once(self, witness, out) -> None:
        xv = witness.get_target(self.x)
        out.set_target(self.low, xv & ((1 << self.n_log) - 1))
        out.set_target(self.high, xv >> self.n_log)


class GadgetMixin:
    # ---- extension targets ------------------------------------------------

    def add_virtual_extension_target(self) -> ExtensionTarget:
        return ExtensionTarget(tuple(self.add_virtual_targets(D)))

    def add_virtual_extension_targets(self, n: int) -> List[ExtensionTarget]:
        return [self.add_virtual_extension_target() for _ in range(n)]

    def constant_extension(self, c: Ext) -> ExtensionTarget:
        c = tuple(c) + (0,) * (D - len(c))
        return ExtensionTarget(tuple(self.constant(x) for x in c))

    def zero_extension(self) -> ExtensionTarget:
        return self.constant_extension((0, 0))

    def one_extension(self) -> ExtensionTarget:
        return self.constant_extension((1, 0))

    def two_extension(self) -> ExtensionTarget:
        return self.constant_extension((2, 0))

    def convert_to_ext(self, t: Target) -> ExtensionTarget:
        return ExtensionTarget((t, self.zero()))

    def connect_extension(self, x: ExtensionTarget, y: ExtensionTarget) -> None:
        for a, b in zip(x.parts, y.parts):
            self.connect(a, b)

    def target_as_constant_ext(self, x: ExtensionTarget) -> Optional[Ext]:
        vals = [self.target_as_constant(t) for t in x.parts]
        if any(v is None for v in vals):
            return None
        return tuple(vals)

    # ---- extension arithmetic (gadgets/arithmetic_extension.rs) -----------

    def arithmetic_extension(
        self,
        const_0: int,
        const_1: int,
        x: ExtensionTarget,
        y: ExtensionTarget,
        z: ExtensionTarget,
    ) -> ExtensionTarget:
        const_0 %= gl.P
        const_1 %= gl.P
        cx, cy, cz = (
            self.target_as_constant_ext(x),
            self.target_as_constant_ext(y),
            self.target_as_constant_ext(z),
        )
        if cx is not None and cy is not None and cz is not None:
            return self.constant_extension(
                ge.ext_add(
                    ge.ext_scalar_mul(ge.ext_mul(cx, cy), const_0),
                    ge.ext_scalar_mul(cz, const_1),
                )
            )
        gate = ArithmeticExtensionGate.new_from_config(self.config)
        row, i = self.find_slot(gate, [const_0, const_1], [const_0, const_1])
        for t, w in zip(x.parts, gate.wires_ith_multiplicand_0(i)):
            self.connect(t, Target.wire(row, w))
        for t, w in zip(y.parts, gate.wires_ith_multiplicand_1(i)):
            self.connect(t, Target.wire(row, w))
        for t, w in zip(z.parts, gate.wires_ith_addend(i)):
            self.connect(t, Target.wire(row, w))
        return ExtensionTarget(
            tuple(Target.wire(row, w) for w in gate.wires_ith_output(i))
        )

    def add_extension(self, a, b) -> ExtensionTarget:
        one = self.one_extension()
        return self.arithmetic_extension(1, 1, a, one, b)

    def add_ext_algebra(self, a, b):
        return [self.add_extension(x, y) for x, y in zip(a, b)]

    def sub_extension(self, a, b) -> ExtensionTarget:
        one = self.one_extension()
        return self.arithmetic_extension(1, gl.P - 1, a, one, b)

    def mul_extension(self, a, b) -> ExtensionTarget:
        return self.arithmetic_extension(1, 0, a, b, a)

    def mul_add_extension(self, a, b, c) -> ExtensionTarget:
        return self.arithmetic_extension(1, 1, a, b, c)

    def mul_sub_extension(self, a, b, c) -> ExtensionTarget:
        return self.arithmetic_extension(1, gl.P - 1, a, b, c)

    def square_extension(self, a) -> ExtensionTarget:
        return self.mul_extension(a, a)

    def scalar_mul_ext(self, s: Target, x: ExtensionTarget) -> ExtensionTarget:
        return self.mul_extension(self.convert_to_ext(s), x)

    def constant_scalar_mul_ext(self, c: int, x: ExtensionTarget) -> ExtensionTarget:
        one = self.one_extension()
        return self.arithmetic_extension(c, 0, x, one, x)

    def add_const_extension(self, x: ExtensionTarget, c: Ext) -> ExtensionTarget:
        return self.add_extension(x, self.constant_extension(c))

    def mul_const_extension(self, c: Ext, x: ExtensionTarget) -> ExtensionTarget:
        return self.mul_extension(self.constant_extension(c), x)

    def add_many_extension(self, terms) -> ExtensionTarget:
        acc = self.zero_extension()
        for t in terms:
            acc = self.add_extension(acc, t)
        return acc

    def mul_many_extension(self, terms) -> ExtensionTarget:
        acc = self.one_extension()
        for t in terms:
            acc = self.mul_extension(acc, t)
        return acc

    def inverse_extension(self, x: ExtensionTarget) -> ExtensionTarget:
        inv = self.add_virtual_extension_target()
        self.add_simple_generator(ExtInverseGenerator(x, inv))
        prod = self.mul_extension(x, inv)
        self.connect_extension(prod, self.one_extension())
        return inv

    def div_extension(self, a, b) -> ExtensionTarget:
        return self.mul_extension(a, self.inverse_extension(b))

    def exp_power_of_2_extension(self, x: ExtensionTarget, power_log: int) -> ExtensionTarget:
        for _ in range(power_log):
            x = self.square_extension(x)
        return x

    def exp_u64_extension(self, x: ExtensionTarget, e: int) -> ExtensionTarget:
        acc = self.one_extension()
        base = x
        while e:
            if e & 1:
                acc = self.mul_extension(acc, base)
            e >>= 1
            if e:
                base = self.square_extension(base)
        return acc

    # ---- extension-algebra ops (pairs of ExtensionTargets) -----------------
    # Used by gate constraint eval in-circuit via the generic ea layer.

    def mul_ext_algebra(self, a, b):
        """(a0 + a1 x)(b0 + b1 x), components are ExtensionTargets; W=7."""
        w_a1b1 = self.constant_scalar_mul_ext(7, self.mul_extension(a[1], b[1]))
        c0 = self.add_extension(self.mul_extension(a[0], b[0]), w_a1b1)
        c1 = self.add_extension(
            self.mul_extension(a[0], b[1]), self.mul_extension(a[1], b[0])
        )
        return [c0, c1]

    # ---- base-target helpers (gadgets/arithmetic.rs, select.rs) -----------

    def add_many(self, terms) -> Target:
        acc = self.zero()
        for t in terms:
            acc = self.add(acc, t)
        return acc

    def inverse(self, x: Target) -> Target:
        xe = self.convert_to_ext(x)
        return self.inverse_extension(xe).parts[0]

    def div(self, a: Target, b: Target) -> Target:
        q = self.div_extension(self.convert_to_ext(a), self.convert_to_ext(b))
        return q.parts[0]

    def exp_u64(self, base: Target, e: int) -> Target:
        acc = self.one()
        b = base
        while e:
            if e & 1:
                acc = self.mul(acc, b)
            e >>= 1
            if e:
                b = self.mul(b, b)
        return acc

    def select(self, b: BoolTarget, x: Target, y: Target) -> Target:
        """b ? x : y = b(x - y) + y."""
        diff = self.sub(x, y)
        return self.mul_add(b.target, diff, y)

    def select_ext(self, b: BoolTarget, x: ExtensionTarget, y: ExtensionTarget) -> ExtensionTarget:
        return ExtensionTarget(
            tuple(
                self.select(b, xt, yt) for xt, yt in zip(x.parts, y.parts)
            )
        )

    def add_virtual_bool_target_safe(self) -> BoolTarget:
        t = self.add_virtual_target()
        self.assert_bool_fresh(t)
        return BoolTarget(t)

    def add_virtual_bool_target_unsafe(self) -> BoolTarget:
        return BoolTarget(self.add_virtual_target())

    def assert_bool_fresh(self, t: Target) -> None:
        # b * b == b
        sq = self.mul(t, t)
        self.connect(sq, t)

    def is_equal(self, x: Target, y: Target) -> BoolTarget:
        """Returns x == y as a bool target (gadgets/arithmetic.rs:is_equal):
        equal = 1 - (x-y) * inv_or_zero(x-y), constrained by
        (x-y)*equal == 0."""
        diff = self.sub(x, y)
        inv = self.add_virtual_target()
        eq = self.add_virtual_target()
        self.add_simple_generator(InvOrZeroGenerator(diff, inv, eq))
        # eq == 1 - diff*inv
        one = self.one()
        diff_inv = self.mul(diff, inv)
        self.connect(self.add(eq, diff_inv), one)
        # diff * eq == 0
        prod = self.mul(diff, eq)
        self.assert_zero(prod)
        return BoolTarget(eq)

    def not_(self, b: BoolTarget) -> BoolTarget:
        one = self.one()
        return BoolTarget(self.sub(one, b.target))

    def and_(self, a: BoolTarget, b: BoolTarget) -> BoolTarget:
        return BoolTarget(self.mul(a.target, b.target))

    def or_(self, a: BoolTarget, b: BoolTarget) -> BoolTarget:
        # a + b - ab
        ab = self.mul(a.target, b.target)
        return BoolTarget(self.sub(self.add(a.target, b.target), ab))

    # ---- range checks / splits (gadgets/{range_check,split_base,split_join}.rs)

    def split_le(self, x: Target, num_bits: int) -> List[BoolTarget]:
        """Binary decomposition, LE; range-checks x < 2^num_bits.
        Spans multiple BaseSumGates for num_bits > 63 (split_join.rs:25-61)."""
        if num_bits == 0:
            return []
        gate = BaseSumGate.new_from_config(self.config, 2)
        k = -(-num_bits // gate.num_limbs)
        rows = [self.add_gate(gate, []) for _ in range(k)]
        bits = [
            BoolTarget(Target.wire(row, i)) for row in rows for i in gate.limbs()
        ]
        for b in bits[num_bits:]:
            self.assert_zero(b.target)
        bits = bits[:num_bits]
        base = (1 << gate.num_limbs) % gl.P
        acc = self.zero()
        one = self.one()
        for row in reversed(rows):
            s = Target.wire(row, BaseSumGate.WIRE_SUM)
            acc = self.arithmetic(base, 1, acc, one, s)  # base*acc + sum
        self.connect(acc, x)
        self.add_simple_generator(WireSplitGenerator(x, rows, gate.num_limbs))
        return bits

    def low_bits(self, x: Target, num_low_bits: int, num_bits: int) -> List[BoolTarget]:
        return self.split_le(x, num_bits)[:num_low_bits]

    def assert_leading_zeros(self, x: Target, leading_zeros: int) -> None:
        self.range_check(x, 64 - leading_zeros)

    def exp_from_bits_const_base(self, base: int, bits_msb_first) -> Target:
        """base^e for a constant base, exponent given MSB-first as bools."""
        acc = self.one()
        for b in bits_msb_first:
            # acc <- acc^2 * (1 + (base-1)*bit)
            sq = self.mul(acc, acc)
            m = self.arithmetic(base - 1, 1, b.target, self.one(), self.one())
            acc = self.mul(sq, m)
        return acc

    def range_check(self, x: Target, num_bits: int) -> None:
        self.split_le(x, num_bits)

    def split_low_high(self, x: Target, n_log: int, num_bits: int) -> Tuple[Target, Target]:
        low = self.add_virtual_target()
        high = self.add_virtual_target()
        self.add_simple_generator(LowHighGenerator(x, n_log, low, high))
        self.range_check(low, n_log)
        self.range_check(high, num_bits - n_log)
        combined = self.mul_add(self.constant(1 << n_log), high, low)
        self.connect(combined, x)
        return low, high

    def le_sum(self, bits: Sequence[BoolTarget]) -> Target:
        """Recombine LE bits into a target."""
        acc = self.zero()
        for b in reversed(list(bits)):
            acc = self.mul_add(self.two(), acc, b.target)
        return acc

    # ---- random access (gadgets/random_access.rs) --------------------------

    def random_access(self, access_index: Target, v: List[Target]) -> Target:
        """v[access_index], via RandomAccessGate."""
        vec_size = len(v)
        bits = max(1, (vec_size - 1).bit_length())
        padded = list(v) + [v[-1]] * ((1 << bits) - vec_size)
        claimed = self.add_virtual_target()
        gate = RandomAccessGate.new_from_config(self.config, bits)
        row, copy = self.find_slot(gate, [bits], [])
        self.connect(access_index, Target.wire(row, gate.wire_access_index(copy)))
        self.connect(claimed, Target.wire(row, gate.wire_claimed_element(copy)))
        for i, val in enumerate(padded):
            self.connect(val, Target.wire(row, gate.wire_list_item(i, copy)))
        return claimed

    def random_access_extension(
        self, access_index: Target, v: List[ExtensionTarget]
    ) -> ExtensionTarget:
        return ExtensionTarget(
            tuple(
                self.random_access(access_index, [e.parts[k] for e in v])
                for k in range(D)
            )
        )

    def random_access_hash(self, access_index: Target, v: List) -> List[Target]:
        """v is a list of 4-element digests (lists of Targets)."""
        return [
            self.random_access(access_index, [h[k] for h in v]) for k in range(4)
        ]

    # ---- exponentiation gate gadget ----------------------------------------

    def exp(self, base: Target, exponent: Target, num_bits: int) -> Target:
        """base^exponent for a runtime exponent (< 2^num_bits), used by the
        multi-degree verifier to derive degree-dependent constants
        (gadgets/arithmetic.rs exp)."""
        return self.exp_from_bits(base, self.split_le(exponent, num_bits))

    def exp_extension_from_bits(
        self, x: ExtensionTarget, bits: Sequence[BoolTarget]
    ) -> ExtensionTarget:
        """x^e with e given as LE bits: square-and-multiply with selected
        factors (gadgets/arithmetic_extension.rs exp_extension_from_bits)."""
        acc = self.one_extension()
        cur = x
        one = self.one_extension()
        bits = list(bits)
        for i, b in enumerate(bits):
            factor = self.select_ext(b, cur, one)
            acc = self.mul_extension(acc, factor)
            if i + 1 < len(bits):
                cur = self.mul_extension(cur, cur)
        return acc

    def exp_from_bits(self, base: Target, exponent_bits: Sequence[BoolTarget]) -> Target:
        gate = ExponentiationGate(len(exponent_bits))
        row = self.add_gate(gate, [])
        self.connect(base, Target.wire(row, gate.wire_base()))
        for i, b in enumerate(exponent_bits):
            self.connect(b.target, Target.wire(row, gate.wire_power_bit(i)))
        return Target.wire(row, gate.wire_output())

    # ---- reducing factor (util/reducing.rs ReducingFactorTarget) ----------

    # see ReducingFactorTarget class below

    # ---- hashing gadgets (hash/hashing.rs, merkle_proofs.rs) ---------------

    def permute_swapped(self, state: List[Target], swap: BoolTarget) -> List[Target]:
        """One PoseidonGate row with the swap wire driven by `swap`."""
        from ..gates.poseidon import PoseidonGate

        gate = PoseidonGate()
        row = self.add_gate(gate, [])
        self.connect(swap.target, Target.wire(row, PoseidonGate.WIRE_SWAP))
        for i, t in enumerate(state):
            self.connect(t, Target.wire(row, PoseidonGate.wire_input(i)))
        return [Target.wire(row, PoseidonGate.wire_output(i)) for i in range(12)]

    def hash_leaf_circuit(self, inputs: List[Target]) -> List[Target]:
        """Domain-separated Merkle leaf hash in-circuit: capacity lane RATE
        holds len+1 (hash/hashing.rs:126-143)."""
        zero = self.zero()
        state = [zero] * 12
        state[8] = self.constant(len(inputs) + 1)
        for start in range(0, len(inputs), 8):
            chunk = inputs[start : start + 8]
            for i, t in enumerate(chunk):
                state[i] = t
            state = self.permute_poseidon(state)
        return state[:4]

    def verify_merkle_proof_to_cap_with_cap_index(
        self,
        leaf_data: List[Target],
        leaf_index_bits: List[BoolTarget],
        cap_index: Target,
        merkle_cap,
        proof_siblings: List[List[Target]],
    ) -> None:
        """hash/merkle_proofs.rs:66-106 — swap-ordered two_to_one compressions
        up the path, then random-access the cap."""
        zero = self.zero()
        state = self.hash_leaf_circuit(leaf_data)
        for bit, sibling in zip(leaf_index_bits, proof_siblings):
            inputs = state + list(sibling) + [zero] * 4
            state = self.permute_swapped(inputs, bit)[:4]
        for i in range(4):
            got = self.random_access(cap_index, [h[i] for h in merkle_cap.hashes])
            self.connect(got, state[i])

    def conditional_assert_eq(self, condition: Target, x: Target, y: Target) -> None:
        """condition * (x - y) == 0 — an equality check that a zero
        condition disables (used by the multi-degree FRI verifier to skip
        inactive fold steps, recursive_verifier.rs:676)."""
        diff = self.sub(x, y)
        prod = self.mul(condition, diff)
        self.connect(prod, self.zero())

    def conditional_assert_eq_ext(
        self, condition: Target, x: ExtensionTarget, y: ExtensionTarget
    ) -> None:
        for a, b in zip(x.parts, y.parts):
            self.conditional_assert_eq(condition, a, b)

    def verify_merkle_proof_to_cap_with_cap_indices(
        self,
        condition: Target,
        leaf_data: List[Target],
        leaf_index_bits: List[BoolTarget],
        log_n_range,
        n_index: Target,
        cap_index: Target,
        merkle_cap,
        proof_siblings: List[List[Target]],
    ) -> None:
        """Multi-length Merkle verification: hash the FULL max-length
        sibling chain but keep a sliding window of intermediate states so
        the state after (actual_path_len) compressions can be selected by
        ``n_index`` = actual_log_n - min_log_n; the final equality is
        gated on ``condition`` (hash/merkle_proofs.rs:108-161).

        log_n_range: inclusive (min_log_n, max_log_n) pair."""
        min_log_n, max_log_n = log_n_range
        num_log_n = max_log_n - min_log_n + 1
        zero = self.zero()
        state = self.hash_leaf_circuit(leaf_data)
        final_states = [state] * num_log_n
        for bit, sibling in zip(leaf_index_bits, proof_siblings):
            inputs = state + list(sibling) + [zero] * 4
            state = self.permute_swapped(inputs, bit)[:4]
            # slide: after all siblings, final_states[-1] is the full
            # chain and final_states[-1-j] the chain short j compressions
            for n in range(num_log_n - 1):
                final_states[n] = final_states[n + 1]
            final_states[num_log_n - 1] = state
        for i in range(4):
            got = self.random_access(cap_index, [h[i] for h in merkle_cap.hashes])
            sel = self.random_access(n_index, [s[i] for s in final_states])
            self.conditional_assert_eq(condition, got, sel)

    def verify_batch_merkle_proof_to_cap_with_cap_index(
        self,
        leaf_data: List[List[Target]],
        leaf_heights: List[int],
        leaf_index_bits: List[BoolTarget],
        cap_index: Target,
        merkle_cap,
        proof_siblings: List[List[Target]],
    ) -> None:
        """Batch-tree path verification: compress up the tallest matrix,
        re-absorbing [digest ‖ next matrix row] whenever the chain reaches
        a shorter matrix's height (hash/merkle_proofs.rs:163-220; host
        dual in ops/merkle.py verify_batch_merkle_proof_to_cap)."""
        zero = self.zero()
        state = self.hash_leaf_circuit(list(leaf_data[0]))
        height = leaf_heights[0]
        data_index = 1
        for bit, sibling in zip(leaf_index_bits, proof_siblings):
            inputs = state + list(sibling) + [zero] * 4
            state = self.permute_swapped(inputs, bit)[:4]
            height -= 1
            if data_index < len(leaf_heights) and height == leaf_heights[data_index]:
                state = self.hash_leaf_circuit(state + list(leaf_data[data_index]))
                data_index += 1
        assert data_index == len(leaf_data), "arity schedule misses a matrix"
        for i in range(4):
            got = self.random_access(cap_index, [h[i] for h in merkle_cap.hashes])
            self.connect(got, state[i])

    # ---- misc extension helpers used by the recursive verifier -------------

    def div_add_extension(self, a, b, c) -> "ExtensionTarget":
        """a/b + c."""
        return self.add_extension(self.div_extension(a, b), c)

    def eval_ext_poly_at(self, coeffs: List[ExtensionTarget], x: ExtensionTarget) -> ExtensionTarget:
        acc = self.zero_extension()
        for cf in reversed(coeffs):
            acc = self.mul_add_extension(acc, x, cf)
        return acc

    # ---- coset interpolation (gadgets/interpolation.rs) --------------------

    def interpolate_coset(
        self,
        gate: CosetInterpolationGate,
        coset_shift: Target,
        values: List[ExtensionTarget],
        evaluation_point: ExtensionTarget,
    ) -> ExtensionTarget:
        row = self.add_gate(gate, [])
        self.connect(coset_shift, Target.wire(row, gate.wire_shift()))
        for i, v in enumerate(values):
            for t, w in zip(v.parts, gate.wires_value(i)):
                self.connect(t, Target.wire(row, w))
        for t, w in zip(evaluation_point.parts, gate.wires_evaluation_point()):
            self.connect(t, Target.wire(row, w))
        return ExtensionTarget(
            tuple(Target.wire(row, w) for w in gate.wires_evaluation_value())
        )


@dataclass
class WireSplitGenerator(SimpleGenerator):
    """Splits x across the WIRE_SUMs of several BaseSumGates
    (split_join.rs:114-158)."""

    x: Target
    rows: List[int]
    num_limbs: int

    def id(self) -> str:
        return "WireSplitGenerator"

    def dependencies(self) -> List[Target]:
        return [self.x]

    def run_once(self, witness, out) -> None:
        v = witness.get_target(self.x)
        for row in self.rows:
            out.set_wire(row, BaseSumGate.WIRE_SUM, v & ((1 << self.num_limbs) - 1))
            v >>= self.num_limbs
        assert not isinstance(v, (int, _np.integer)) or v == 0  # skipped under the witgen tracer


@dataclass
class InvOrZeroGenerator(SimpleGenerator):
    diff: Target
    inv: Target
    eq: Target

    def id(self) -> str:
        return "InvOrZeroGenerator"

    def dependencies(self) -> List[Target]:
        return [self.diff]

    def run_once(self, witness, out) -> None:
        d = witness.get_target(self.diff)
        inv = 0 if d == 0 else pow(d, gl.P - 2, gl.P)
        out.set_target(self.inv, inv)
        out.set_target(self.eq, 1 if d == 0 else 0)


class ReducingFactorTarget:
    """Running alpha-powers reduction in-circuit using Reducing gates
    (plonky2/src/util/reducing.rs)."""

    def __init__(self, alpha: ExtensionTarget):
        self.alpha = alpha
        self.count = 0

    def reduce_base(self, builder, terms: List[Target]) -> ExtensionTarget:
        """reduce over base-field coefficients, highest power for terms[0]...
        matches ReducingFactor::reduce which folds in reverse."""
        return self._reduce_base_rev(builder, list(reversed(terms)))

    def _reduce_base_rev(self, builder, coeffs_rev: List[Target]) -> ExtensionTarget:
        acc = builder.zero_extension()
        max_coeffs = ReducingGate.max_coeffs_len(
            builder.config.num_wires, builder.config.num_routed_wires
        )
        idx = 0
        while idx < len(coeffs_rev):
            chunk = coeffs_rev[idx : idx + max_coeffs]
            gate = ReducingGate(len(chunk))
            row = builder.add_gate(gate, [])
            for t, w in zip(self.alpha.parts, gate.wires_alpha()):
                builder.connect(t, Target.wire(row, w))
            for t, w in zip(acc.parts, gate.wires_old_acc()):
                builder.connect(t, Target.wire(row, w))
            for t, w in zip(chunk, gate.wires_coeffs()):
                builder.connect(t, Target.wire(row, w))
            acc = ExtensionTarget(
                tuple(Target.wire(row, w) for w in gate.wires_output())
            )
            idx += len(chunk)
            self.count += len(chunk)
        return acc

    def reduce(self, builder, terms: List[ExtensionTarget]) -> ExtensionTarget:
        """reduce over extension coefficients (terms[0] gets highest power)."""
        coeffs_rev = list(reversed(terms))
        acc = builder.zero_extension()
        max_coeffs = ReducingExtensionGate.max_coeffs_len(
            builder.config.num_wires, builder.config.num_routed_wires
        )
        idx = 0
        while idx < len(coeffs_rev):
            chunk = coeffs_rev[idx : idx + max_coeffs]
            gate = ReducingExtensionGate(len(chunk))
            row = builder.add_gate(gate, [])
            for t, w in zip(self.alpha.parts, gate.wires_alpha()):
                builder.connect(t, Target.wire(row, w))
            for t, w in zip(acc.parts, gate.wires_old_acc()):
                builder.connect(t, Target.wire(row, w))
            for i, c in enumerate(chunk):
                for t, w in zip(c.parts, gate.wires_coeff(i)):
                    builder.connect(t, Target.wire(row, w))
            acc = ExtensionTarget(
                tuple(Target.wire(row, w) for w in gate.wires_output())
            )
            idx += len(chunk)
            self.count += len(chunk)
        return acc

    def shift(self, builder, x: ExtensionTarget) -> ExtensionTarget:
        """x * alpha^count, then reset count."""
        alpha_pow = builder.exp_u64_extension(self.alpha, self.count)
        self.count = 0
        return builder.mul_extension(alpha_pow, x)

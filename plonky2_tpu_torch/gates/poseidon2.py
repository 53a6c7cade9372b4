"""Poseidon2 gates (reference: plonky2/src/gates/poseidon2.rs,
poseidon2_mds.rs, poseidon2_int_mix.rs).

Poseidon2Gate evaluates one full width-12 Poseidon2 permutation per row:
130 wires (12 in | 12 out | 7×12 external-round S-box checkpoints | 22
internal-round checkpoints), 118 constraints, degree 7. Round 0's S-box
needs no checkpoint (state is still degree 1 after the linear preamble).

Poseidon2MdsGate / Poseidon2IntMixGate apply one light-MDS / internal-mix
layer over 12 extension elements (both layers are linear, degree 1).
Constraints are single-source over the abstract algebra A; the
permutation gate adds a stacked device eval of the same constraints.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from ..field.goldilocks import P, gadd, gmul
from ..hash import poseidon2 as p2
from ..hash.poseidon2_constants import (
    EXTERNAL_ROUNDS,
    INITIAL_EXTERNAL_CONSTANTS,
    INTERNAL_CONSTANTS,
    INTERNAL_ROUNDS,
    MATRIX_DIAG,
    SPONGE_WIDTH,
    TERMINAL_EXTERNAL_CONSTANTS,
)
from ..iop.generator import SimpleGenerator
from ..iop.target import Target
from . import ext_algebra as ea
from .algebra import EvalVars
from .gate import Gate

W = SPONGE_WIDTH
D = 2


@dataclass(frozen=True)
class Poseidon2Gate(Gate):
    W_IN = 0
    W_OUT = W
    W_EXT_SBOX = 2 * W
    W_INT_SBOX = 2 * W + (EXTERNAL_ROUNDS - 1) * W

    def id(self) -> str:
        return f"Poseidon2Gate<WIDTH={W}>"

    @staticmethod
    def wire_input(i: int) -> int:
        return i

    @staticmethod
    def wire_output(i: int) -> int:
        return W + i

    @classmethod
    def wire_ext_sbox(cls, round: int, lane: int) -> int:
        # rounds 1..7 (round 0 elided); poseidon2.rs:474-480
        assert 1 <= round < EXTERNAL_ROUNDS
        return cls.W_EXT_SBOX + (round - 1) * W + lane

    @classmethod
    def wire_int_sbox(cls, round: int) -> int:
        return cls.W_INT_SBOX + round

    def num_wires(self) -> int:
        return self.W_INT_SBOX + INTERNAL_ROUNDS  # 130

    def num_constants(self) -> int:
        return 0

    def degree(self) -> int:
        return 7

    def num_constraints(self) -> int:
        return (EXTERNAL_ROUNDS - 1) * W + INTERNAL_ROUNDS + W  # 118

    def eval_unfiltered(self, vars: EvalVars, A) -> List:
        lw = vars.local_wires
        constraints = []
        state = [lw[self.wire_input(i)] for i in range(W)]
        state = p2.mds_light(A, state)
        ext_round_idx = 0
        for r in range(4):
            state = [
                A.add_const(x, INITIAL_EXTERNAL_CONSTANTS[r][i] % P)
                for i, x in enumerate(state)
            ]
            if ext_round_idx != 0:
                for i in range(W):
                    sbox_in = lw[self.wire_ext_sbox(ext_round_idx, i)]
                    constraints.append(A.sub(state[i], sbox_in))
                    state[i] = sbox_in
            state = [p2.sbox7(A, x) for x in state]
            state = p2.mds_light(A, state)
            ext_round_idx += 1
        for r in range(INTERNAL_ROUNDS):
            s0 = A.add_const(state[0], INTERNAL_CONSTANTS[r] % P)
            sbox_in = lw[self.wire_int_sbox(r)]
            constraints.append(A.sub(s0, sbox_in))
            state[0] = p2.sbox7(A, sbox_in)
            state = p2.internal_mix(A, state)
        for r in range(4):
            state = [
                A.add_const(x, TERMINAL_EXTERNAL_CONSTANTS[r][i] % P)
                for i, x in enumerate(state)
            ]
            for i in range(W):
                sbox_in = lw[self.wire_ext_sbox(ext_round_idx, i)]
                constraints.append(A.sub(state[i], sbox_in))
                state[i] = sbox_in
            state = [p2.sbox7(A, x) for x in state]
            state = p2.mds_light(A, state)
            ext_round_idx += 1
        for i in range(W):
            constraints.append(A.sub(lw[self.wire_output(i)], state[i]))
        return constraints

    def eval_unfiltered_device(self, vars: EvalVars, A) -> List:
        """The constraints of eval_unfiltered, in the same order, with the
        12 lanes stacked into one [12, B] tensor that goes through the
        batched permutation's layers (hash/poseidon2.py): about 2,400
        torch operations (a field product counted once) against about
        14,100 for the generic path, which runs each lane's layers one [B]
        tensor at a time. Under the Poseidon2 config every circuit's
        public-input hash is such a row, so every quotient evaluates this
        gate."""
        import torch

        from ..ops import gf

        w = vars.local_wires
        initial, terminal, internal, diag = p2.round_tables(w[0].device)

        def stack(cols):
            return torch.stack([w[c] for c in cols])

        def ext_wires(round):
            return stack([self.wire_ext_sbox(round, i) for i in range(W)])

        blocks = []
        state = p2.mds_light_lanes(stack([self.wire_input(i) for i in range(W)]))
        # external round 0 has no checkpoint wires
        state = p2.mds_light_lanes(p2.sbox_lanes(gf.add(state, initial[0])))
        for r in range(1, 4):
            sbox_in = ext_wires(r)
            blocks.append(gf.sub(gf.add(state, initial[r]), sbox_in))
            state = p2.mds_light_lanes(p2.sbox_lanes(sbox_in))
        for r in range(INTERNAL_ROUNDS):
            sbox_in = w[self.wire_int_sbox(r)]
            blocks.append(gf.sub(gf.add(state[0], internal[r]), sbox_in)[None])
            state = p2.internal_mix_lanes(
                torch.cat([p2.sbox_lanes(sbox_in)[None], state[1:]]), diag
            )
        for r in range(4):
            sbox_in = ext_wires(4 + r)
            blocks.append(gf.sub(gf.add(state, terminal[r]), sbox_in))
            state = p2.mds_light_lanes(p2.sbox_lanes(sbox_in))
        blocks.append(gf.sub(stack([self.wire_output(i) for i in range(W)]), state))
        return list(torch.cat(blocks).unbind(0))

    def generators(self, row: int, local_constants: Sequence[int]) -> List:
        return [Poseidon2Generator(row)]


@dataclass
class Poseidon2Generator(SimpleGenerator):
    """Forward permutation replay filling checkpoint + output wires
    (Poseidon2FullGen, poseidon2.rs:861-960)."""

    row: int

    def id(self) -> str:
        return "Poseidon2Generator"

    def dependencies(self) -> List[Target]:
        return [
            Target.wire(self.row, Poseidon2Gate.wire_input(i)) for i in range(W)
        ]

    def run_once(self, witness, out) -> None:
        g = Poseidon2Gate()
        state = [
            witness.get_target(Target.wire(self.row, g.wire_input(i)))
            for i in range(W)
        ]
        A = p2._HOST
        state = p2.mds_light(A, state)
        ext_round_idx = 0
        for r in range(4):
            state = [
                gadd(x, INITIAL_EXTERNAL_CONSTANTS[r][i])
                for i, x in enumerate(state)
            ]
            if ext_round_idx != 0:
                for i in range(W):
                    out.set_wire(self.row, g.wire_ext_sbox(ext_round_idx, i), state[i])
            state = [p2.sbox7(A, x) for x in state]
            state = p2.mds_light(A, state)
            ext_round_idx += 1
        for r in range(INTERNAL_ROUNDS):
            s0 = gadd(state[0], INTERNAL_CONSTANTS[r])
            out.set_wire(self.row, g.wire_int_sbox(r), s0)
            state[0] = p2.sbox7(A, s0)
            state = p2.internal_mix(A, state)
        for r in range(4):
            state = [
                gadd(x, TERMINAL_EXTERNAL_CONSTANTS[r][i])
                for i, x in enumerate(state)
            ]
            for i in range(W):
                out.set_wire(self.row, g.wire_ext_sbox(ext_round_idx, i), state[i])
            state = [p2.sbox7(A, x) for x in state]
            state = p2.mds_light(A, state)
            ext_round_idx += 1
        for i in range(W):
            out.set_wire(self.row, g.wire_output(i), state[i])


# ---------------------------------------------------------------------------
# Linear-layer gates over extension elements (poseidon2_mds.rs,
# poseidon2_int_mix.rs). Both layers have integer coefficients, so they act
# componentwise on the D extension components.
# ---------------------------------------------------------------------------


def _mds_light_components(A, elems: List[List]) -> List[List]:
    """elems: 12 extension elements, each a list of D algebra components."""
    out_components = []
    for c in range(D):
        col = [e[c] for e in elems]
        out_components.append(p2.mds_light(A, col))
    return [[out_components[c][i] for c in range(D)] for i in range(W)]


def _internal_mix_components(A, elems: List[List]) -> List[List]:
    out_components = []
    for c in range(D):
        col = [e[c] for e in elems]
        out_components.append(p2.internal_mix(A, col))
    return [[out_components[c][i] for c in range(D)] for i in range(W)]


@dataclass(frozen=True)
class Poseidon2MdsGate(Gate):
    """One Poseidon2 light-MDS layer over 12 extension elements."""

    def id(self) -> str:
        return f"Poseidon2MdsGate<WIDTH={W}>"

    @staticmethod
    def wires_input(i: int):
        return range(i * D, (i + 1) * D)

    @staticmethod
    def wires_output(i: int):
        return range((W + i) * D, (W + i + 1) * D)

    def num_wires(self) -> int:
        return 2 * D * W

    def num_constants(self) -> int:
        return 0

    def degree(self) -> int:
        return 1

    def num_constraints(self) -> int:
        return W * D

    def eval_unfiltered(self, vars: EvalVars, A) -> List:
        w = vars.local_wires
        inputs = [[w[j] for j in self.wires_input(i)] for i in range(W)]
        outs = _mds_light_components(A, inputs)
        constraints = []
        for i in range(W):
            expected = [w[j] for j in self.wires_output(i)]
            constraints.extend(ea.ea_sub(A, outs[i], expected))
        return constraints

    def generators(self, row: int, local_constants: Sequence[int]) -> List:
        return [Poseidon2MdsGenerator(self.__class__, row)]


@dataclass(frozen=True)
class Poseidon2IntMixGate(Gate):
    """One Poseidon2 internal-mix layer y_i = d_i·x_i + Σx over 12
    extension elements."""

    def id(self) -> str:
        return f"Poseidon2IntMixGate<WIDTH={W}>"

    @staticmethod
    def wires_input(i: int):
        return range(i * D, (i + 1) * D)

    @staticmethod
    def wires_output(i: int):
        return range((W + i) * D, (W + i + 1) * D)

    def num_wires(self) -> int:
        return 2 * D * W

    def num_constants(self) -> int:
        return 0

    def degree(self) -> int:
        return 1

    def num_constraints(self) -> int:
        return W * D

    def eval_unfiltered(self, vars: EvalVars, A) -> List:
        w = vars.local_wires
        inputs = [[w[j] for j in self.wires_input(i)] for i in range(W)]
        outs = _internal_mix_components(A, inputs)
        constraints = []
        for i in range(W):
            expected = [w[j] for j in self.wires_output(i)]
            constraints.extend(ea.ea_sub(A, outs[i], expected))
        return constraints

    def generators(self, row: int, local_constants: Sequence[int]) -> List:
        return [Poseidon2MdsGenerator(self.__class__, row)]


@dataclass
class Poseidon2MdsGenerator(SimpleGenerator):
    """Shared generator for both linear-layer gates: evaluates the layer on
    host extension values."""

    gate_cls: type
    row: int

    def id(self) -> str:
        return f"{self.gate_cls.__name__}Generator"

    def dependencies(self) -> List[Target]:
        return [
            Target.wire(self.row, j)
            for i in range(W)
            for j in self.gate_cls.wires_input(i)
        ]

    def run_once(self, witness, out) -> None:
        g = self.gate_cls()
        inputs = [
            [witness.get_target(Target.wire(self.row, j)) for j in g.wires_input(i)]
            for i in range(W)
        ]
        A = p2._HOST
        if isinstance(g, Poseidon2MdsGate):
            outs = _mds_light_components(A, inputs)
        else:
            outs = _internal_mix_components(A, inputs)
        for i in range(W):
            for wire, v in zip(g.wires_output(i), outs[i]):
                out.set_wire(self.row, wire, v)

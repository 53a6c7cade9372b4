"""PoseidonGate — one full width-12 Poseidon permutation per row, with a
swap flag for Merkle-sibling ordering (reference:
plonky2/src/gates/poseidon.rs:30-553).

Wire layout (135 wires): 12 inputs | 12 outputs | swap | 4 deltas |
36 sbox inputs for full rounds 1-3 | 22 partial-round sbox inputs |
48 sbox inputs for the final 4 full rounds. Constraints are expressed
once over the abstract algebra; the witness generator replays the same
fast-partial-round schedule on host ints.
"""

from __future__ import annotations

import numpy as _np

from dataclasses import dataclass
from typing import List, Sequence

from ..field.goldilocks import P
from ..hash import poseidon_fast as pf
from ..hash.poseidon_constants import (
    HALF_N_FULL_ROUNDS,
    N_PARTIAL_ROUNDS,
    SPONGE_WIDTH,
)
from ..iop.generator import SimpleGenerator
from ..iop.target import Target
from .algebra import EvalVars
from .gate import Gate

W = SPONGE_WIDTH


@dataclass(frozen=True)
class PoseidonGate(Gate):
    WIRE_SWAP = 2 * W
    START_DELTA = 2 * W + 1
    START_FULL_0 = START_DELTA + 4
    START_PARTIAL = START_FULL_0 + W * (HALF_N_FULL_ROUNDS - 1)
    START_FULL_1 = START_PARTIAL + N_PARTIAL_ROUNDS

    def id(self) -> str:
        return f"PoseidonGate(PhantomData<plonky2_field::goldilocks_field::GoldilocksField>)<WIDTH={W}>"

    @staticmethod
    def wire_input(i: int) -> int:
        return i

    @staticmethod
    def wire_output(i: int) -> int:
        return W + i

    @classmethod
    def wire_delta(cls, i: int) -> int:
        return cls.START_DELTA + i

    @classmethod
    def wire_full_sbox_0(cls, round: int, i: int) -> int:
        assert 0 < round < HALF_N_FULL_ROUNDS
        return cls.START_FULL_0 + W * (round - 1) + i

    @classmethod
    def wire_partial_sbox(cls, round: int) -> int:
        return cls.START_PARTIAL + round

    @classmethod
    def wire_full_sbox_1(cls, round: int, i: int) -> int:
        return cls.START_FULL_1 + W * round + i

    def num_wires(self) -> int:
        return self.START_FULL_1 + W * HALF_N_FULL_ROUNDS  # 135

    def num_constants(self) -> int:
        return 0

    def degree(self) -> int:
        return 7

    def num_constraints(self) -> int:
        return (
            1 + 4 + W * (HALF_N_FULL_ROUNDS - 1) + N_PARTIAL_ROUNDS
            + W * HALF_N_FULL_ROUNDS + W
        )

    def eval_unfiltered(self, vars: EvalVars, A) -> List:
        w = vars.local_wires
        constraints = []

        swap = w[self.WIRE_SWAP]
        constraints.append(A.mul(swap, A.add_const(swap, P - 1)))

        for i in range(4):
            delta = w[self.wire_delta(i)]
            diff = A.sub(w[self.wire_input(i + 4)], w[self.wire_input(i)])
            constraints.append(A.sub(A.mul(swap, diff), delta))

        state = [None] * W
        for i in range(4):
            delta = w[self.wire_delta(i)]
            state[i] = A.add(w[self.wire_input(i)], delta)
            state[i + 4] = A.sub(w[self.wire_input(i + 4)], delta)
        for i in range(8, W):
            state[i] = w[self.wire_input(i)]

        round_ctr = 0
        for r in range(HALF_N_FULL_ROUNDS):
            state = pf.constant_layer(A, state, round_ctr)
            if r != 0:
                for i in range(W):
                    sbox_in = w[self.wire_full_sbox_0(r, i)]
                    constraints.append(A.sub(state[i], sbox_in))
                    state[i] = sbox_in
            state = [pf.sbox_monomial(A, x) for x in state]
            state = pf.mds_layer(A, state)
            round_ctr += 1

        state = pf.partial_first_constant_layer(A, state)
        state = pf.mds_partial_layer_init(A, state)
        for r in range(N_PARTIAL_ROUNDS):
            sbox_in = w[self.wire_partial_sbox(r)]
            constraints.append(A.sub(state[0], sbox_in))
            state[0] = pf.sbox_monomial(A, sbox_in)
            if r < N_PARTIAL_ROUNDS - 1:
                state[0] = A.add_const(state[0], pf.FAST_PARTIAL_ROUND_CONSTANTS[r])
            state = pf.mds_partial_layer_fast(A, state, r)
        round_ctr += N_PARTIAL_ROUNDS

        for r in range(HALF_N_FULL_ROUNDS):
            state = pf.constant_layer(A, state, round_ctr)
            for i in range(W):
                sbox_in = w[self.wire_full_sbox_1(r, i)]
                constraints.append(A.sub(state[i], sbox_in))
                state[i] = sbox_in
            state = [pf.sbox_monomial(A, x) for x in state]
            state = pf.mds_layer(A, state)
            round_ctr += 1

        for i in range(W):
            constraints.append(A.sub(state[i], w[self.wire_output(i)]))
        return constraints

    # -- device batch eval ----------------------------------------------------
    # The state of every point as one [12, B] tensor: a round is a few
    # launches over all twelve lanes, where the generic per-wire path issues
    # one launch per scalar operation (about 80,000 a row type). Same
    # constraints, same order; agreement with eval_unfiltered is pinned by
    # gates/gate_testing.check_algebra_agreement.

    def eval_unfiltered_device(self, vars: EvalVars, A) -> List:
        import numpy as np
        import torch

        from ..hash.poseidon_constants import ALL_ROUND_CONSTANTS
        from ..ops import gf

        w = vars.local_wires
        device = w[0].device

        def cgf(arr):  # int nest -> constant tensor (exact: via object dtype)
            a = (np.asarray(arr, dtype=object) % P).astype(np.uint64)
            return gf.from_u64(a, device)

        def stack(cols):  # wire columns -> [k, B]
            return torch.stack([w[c] for c in cols])

        def sbox(x):
            x3 = gf.mul(x, gf.sqr(x))
            return gf.mul(x, gf.sqr(x3))

        mds_c = cgf(pf.MDS_FULL)[:, :, None]  # [12, 12, 1]

        def mds(state):  # [12, B] -> [12, B]
            return gf.sum_mod_p(gf.mul(state[None], mds_c), axis=1)

        constraints: List = []
        swap = w[self.WIRE_SWAP]
        constraints.append(gf.mul(swap, gf.sub(swap, torch.ones_like(swap))))

        in_l = stack([self.wire_input(i) for i in range(4)])
        in_r = stack([self.wire_input(i + 4) for i in range(4)])
        deltas = stack([self.wire_delta(i) for i in range(4)])
        constraints.extend(gf.sub(gf.mul(swap[None], gf.sub(in_r, in_l)), deltas).unbind(0))

        tail = stack([self.wire_input(i) for i in range(8, W)])
        state = torch.cat([gf.add(in_l, deltas), gf.sub(in_r, deltas), tail])

        rc = cgf(np.array(ALL_ROUND_CONSTANTS, dtype=np.uint64).reshape(-1, W))[:, :, None]

        # round 0 of the first full set (no sbox-input wires)
        state = mds(sbox(gf.add(state, rc[0])))

        def full_rounds(state, rounds, wire_rows):
            for r, cols in zip(rounds, wire_rows):
                wires = stack(cols)
                constraints.extend(gf.sub(gf.add(state, rc[r]), wires).unbind(0))
                state = mds(sbox(wires))
            return state

        state = full_rounds(
            state,
            range(1, HALF_N_FULL_ROUNDS),
            [[self.wire_full_sbox_0(r, i) for i in range(W)]
             for r in range(1, HALF_N_FULL_ROUNDS)],
        )

        # partial rounds, in the fast form of hash/poseidon_fast.py
        state = gf.add(state, cgf([[c] for c in pf.FAST_PARTIAL_FIRST_ROUND_CONSTANT]))
        init_c = cgf(pf.FAST_PARTIAL_ROUND_INITIAL_MATRIX)[:, :, None]  # [11, 11, 1]
        s0 = state[0]
        rest = gf.sum_mod_p(gf.mul(state[1:, None], init_c), axis=0)  # [11, B]
        p_rc = [int(c) % P for c in pf.FAST_PARTIAL_ROUND_CONSTANTS]
        wh_c = cgf(pf.FAST_PARTIAL_ROUND_W_HATS)[:, :, None]  # [22, 11, 1]
        vs_c = cgf(pf.FAST_PARTIAL_ROUND_VS)[:, :, None]  # [22, 11, 1]
        m00 = int(pf.MDS_0_0) % P
        for r in range(N_PARTIAL_ROUNDS):
            wire = w[self.wire_partial_sbox(r)]
            constraints.append(gf.sub(s0, wire))
            s0n = gf.add(sbox(wire), gf.full((1,), p_rc[r], device))
            d = gf.add(gf.mul(s0n, m00), gf.sum_mod_p(gf.mul(rest, wh_c[r]), axis=0))
            rest = gf.add(rest, gf.mul(s0n[None], vs_c[r]))
            s0 = d
        state = torch.cat([s0[None], rest])

        # second full set
        base = HALF_N_FULL_ROUNDS + N_PARTIAL_ROUNDS
        state = full_rounds(
            state,
            range(base, base + HALF_N_FULL_ROUNDS),
            [[self.wire_full_sbox_1(r, i) for i in range(W)]
             for r in range(HALF_N_FULL_ROUNDS)],
        )

        constraints.extend(gf.sub(state, stack([self.wire_output(i) for i in range(W)])).unbind(0))
        assert len(constraints) == self.num_constraints()
        return constraints

    def generators(self, row: int, local_constants: Sequence[int]) -> List:
        return [PoseidonGenerator(row)]


@dataclass
class PoseidonGenerator(SimpleGenerator):
    row: int

    def id(self) -> str:
        return "PoseidonGenerator"

    def dependencies(self) -> List[Target]:
        deps = [Target.wire(self.row, PoseidonGate.wire_input(i)) for i in range(W)]
        deps.append(Target.wire(self.row, PoseidonGate.WIRE_SWAP))
        return deps

    def run_once(self, witness, out) -> None:
        g = PoseidonGate
        get = lambda col: witness.get_target(Target.wire(self.row, col))
        A = pf._IntAlgebra()

        inputs = [get(g.wire_input(i)) for i in range(W)]
        swap = get(g.WIRE_SWAP)
        # data check skipped under the witgen tracer (symbolic swap); the
        # gate constraint s(s-1)=0 enforces it in the proof either way
        assert not isinstance(swap, (int, _np.integer)) or swap in (0, 1), "swap wire must be binary"

        state = list(inputs)
        for i in range(4):
            delta = (swap * ((inputs[i + 4] - inputs[i]) % P)) % P
            out.set_wire(self.row, g.wire_delta(i), delta)
            state[i] = (inputs[i] + delta) % P
            state[i + 4] = (inputs[i + 4] - delta) % P

        round_ctr = 0
        for r in range(HALF_N_FULL_ROUNDS):
            state = pf.constant_layer(A, state, round_ctr)
            if r != 0:
                for i in range(W):
                    out.set_wire(self.row, g.wire_full_sbox_0(r, i), state[i])
            state = [pf.sbox_monomial(A, x) for x in state]
            state = pf.mds_layer(A, state)
            round_ctr += 1

        state = pf.partial_first_constant_layer(A, state)
        state = pf.mds_partial_layer_init(A, state)
        for r in range(N_PARTIAL_ROUNDS):
            out.set_wire(self.row, g.wire_partial_sbox(r), state[0])
            state[0] = pf.sbox_monomial(A, state[0])
            if r < N_PARTIAL_ROUNDS - 1:
                state[0] = (state[0] + pf.FAST_PARTIAL_ROUND_CONSTANTS[r]) % P
            state = pf.mds_partial_layer_fast(A, state, r)
        round_ctr += N_PARTIAL_ROUNDS

        for r in range(HALF_N_FULL_ROUNDS):
            state = pf.constant_layer(A, state, round_ctr)
            for i in range(W):
                out.set_wire(self.row, g.wire_full_sbox_1(r, i), state[i])
            state = [pf.sbox_monomial(A, x) for x in state]
            state = pf.mds_layer(A, state)
            round_ctr += 1

        for i in range(W):
            out.set_wire(self.row, g.wire_output(i), state[i])

"""LookupGate + LookupTableGate (reference:
plonky2/src/gates/{lookup.rs,lookup_table.rs}).

Neither gate emits main-trace constraints: the logUp-style argument lives
in the RE/Sum/LDC auxiliary polynomials checked by the vanishing
polynomial's lookup terms (plonk/vanishing_poly.rs:341-512)."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

from ..iop.generator import SimpleGenerator
from ..iop.target import Target
from .algebra import EvalVars
from .gate import Gate

LookupTable = Tuple[Tuple[int, int], ...]  # ((input, output), ...) u16 pairs


def _lut_hash(lut: LookupTable) -> str:
    h = hashlib.sha256()
    for inp, out in lut:
        h.update(inp.to_bytes(2, "little"))
        h.update(out.to_bytes(2, "little"))
    return h.hexdigest()[:16]


@dataclass(frozen=True)
class LookupGate(Gate):
    """Stores (input, output) lookup pairs; no constraints of its own."""

    num_slots: int
    lut: LookupTable

    @staticmethod
    def num_slots_from_config(config) -> int:
        return config.num_routed_wires // 2

    @staticmethod
    def new_from_table(config, lut: LookupTable) -> "LookupGate":
        return LookupGate(LookupGate.num_slots_from_config(config), tuple(lut))

    def id(self) -> str:
        return f"LookupGate {{num_slots: {self.num_slots}, lut_hash: {_lut_hash(self.lut)}}}"

    @staticmethod
    def wire_ith_looking_inp(i: int) -> int:
        return 2 * i

    @staticmethod
    def wire_ith_looking_out(i: int) -> int:
        return 2 * i + 1

    def num_wires(self) -> int:
        return 2 * self.num_slots

    def num_constants(self) -> int:
        return 0

    def degree(self) -> int:
        return 0

    def num_constraints(self) -> int:
        return 0

    def eval_unfiltered(self, vars: EvalVars, A) -> List:
        return []

    def generators(self, row: int, local_constants: Sequence[int]) -> List:
        return [LookupGenerator(row, self.lut, i) for i in range(self.num_slots)]

    # slot packing handle: builder.find_slot uses num_ops
    @property
    def num_ops(self) -> int:
        return self.num_slots


@dataclass
class LookupGenerator(SimpleGenerator):
    row: int
    lut: LookupTable
    slot_nb: int

    def id(self) -> str:
        return "LookupGenerator"

    def dependencies(self) -> List[Target]:
        return [Target.wire(self.row, LookupGate.wire_ith_looking_inp(self.slot_nb))]

    def run_once(self, witness, out) -> None:
        inp = witness.get_target(
            Target.wire(self.row, LookupGate.wire_ith_looking_inp(self.slot_nb))
        )
        for i, o in self.lut:
            if i == inp:
                out.set_wire(
                    self.row, LookupGate.wire_ith_looking_out(self.slot_nb), o
                )
                return
        raise AssertionError(f"lookup input {inp} not found in the table")


@dataclass(frozen=True)
class LookupTableGate(Gate):
    """Holds the (looked_inp, looked_out, multiplicity) LUT rows."""

    num_slots: int
    lut: LookupTable
    last_lut_row: int

    @staticmethod
    def num_slots_from_config(config) -> int:
        return config.num_routed_wires // 3

    @staticmethod
    def new_from_table(config, lut: LookupTable, last_lut_row: int) -> "LookupTableGate":
        return LookupTableGate(
            LookupTableGate.num_slots_from_config(config), tuple(lut), last_lut_row
        )

    def id(self) -> str:
        return (
            f"LookupTableGate {{num_slots: {self.num_slots}, "
            f"lut_hash: {_lut_hash(self.lut)}, last_lut_row: {self.last_lut_row}}}"
        )

    @staticmethod
    def wire_ith_looked_inp(i: int) -> int:
        return 3 * i

    @staticmethod
    def wire_ith_looked_out(i: int) -> int:
        return 3 * i + 1

    @staticmethod
    def wire_ith_multiplicity(i: int) -> int:
        return 3 * i + 2

    def num_wires(self) -> int:
        return 3 * self.num_slots

    def num_constants(self) -> int:
        return 0

    def degree(self) -> int:
        return 0

    def num_constraints(self) -> int:
        return 0

    def eval_unfiltered(self, vars: EvalVars, A) -> List:
        return []

    def generators(self, row: int, local_constants: Sequence[int]) -> List:
        return [
            LookupTableGenerator(row, self.lut, i, self.num_slots, self.last_lut_row)
            for i in range(self.num_slots)
        ]


@dataclass
class LookupTableGenerator(SimpleGenerator):
    row: int
    lut: LookupTable
    slot_nb: int
    num_slots: int
    last_lut_row: int

    def id(self) -> str:
        return "LookupTableGenerator"

    def dependencies(self) -> List[Target]:
        return []

    def run_once(self, witness, out) -> None:
        first_row = self.last_lut_row + (len(self.lut) + self.num_slots - 1) // self.num_slots - 1
        slot = (first_row - self.row) * self.num_slots + self.slot_nb
        inp_w = LookupTableGate.wire_ith_looked_inp(self.slot_nb)
        out_w = LookupTableGate.wire_ith_looked_out(self.slot_nb)
        if slot < len(self.lut):
            i, o = self.lut[slot]
        else:
            i, o = self.lut[0]  # pad with the first entry
        out.set_wire(self.row, inp_w, i)
        out.set_wire(self.row, out_w, o)

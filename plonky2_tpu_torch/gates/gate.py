"""Gate framework: base class, selector filters, selector polynomial
computation (reference: plonky2/src/gates/gate.rs:53-352,
gates/selectors.rs:80-167)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..field.goldilocks import P
from .algebra import EvalVars

UNUSED_SELECTOR = 0xFFFF_FFFF  # u32::MAX (core/src/selectors.rs:10)


class Gate:
    """Gates express constraints once via eval_unfiltered(vars, A) over an
    abstract algebra; see gates/algebra.py."""

    def id(self) -> str:
        raise NotImplementedError

    def num_wires(self) -> int:
        raise NotImplementedError

    def num_constants(self) -> int:
        raise NotImplementedError

    def degree(self) -> int:
        raise NotImplementedError

    def num_constraints(self) -> int:
        raise NotImplementedError

    def eval_unfiltered(self, vars: EvalVars, A) -> List:
        raise NotImplementedError

    def eval_unfiltered_device(self, vars: EvalVars, A) -> List:
        """Device-batch constraint eval. Default: the generic single-source
        path; a gate may override it with a stacked implementation as long
        as it returns the same constraints in the same order."""
        return self.eval_unfiltered(vars, A)

    def generators(self, row: int, local_constants: Sequence[int]) -> List:
        raise NotImplementedError

    def extra_constant_wires(self) -> List[Tuple[int, int]]:
        return []

    # hashing/equality by id for the builder's gate set
    def __hash__(self):
        return hash(self.id())

    def __eq__(self, other):
        return isinstance(other, Gate) and self.id() == other.id()


@dataclass
class GateInstance:
    gate: Gate
    constants: List[int]


@dataclass
class SelectorsInfo:
    selector_indices: List[int]
    groups: List[Tuple[int, int]]  # (start, end) ranges

    @property
    def num_selectors(self) -> int:
        return len(self.groups)


def compute_filter(A, row: int, group: Tuple[int, int], s, many_selectors: bool):
    """prod_{i in group, i != row} (i - s), times (UNUSED - s) if several
    selector polynomials exist (gate.rs:326-333)."""
    start, end = group
    terms = [i for i in range(start, end) if i != row]
    if many_selectors:
        terms.append(UNUSED_SELECTOR)
    acc = None
    for i in terms:
        t = A.sub_from_const(i, s)
        acc = t if acc is None else A.mul(acc, t)
    return acc if acc is not None else A.one()


def selector_polynomials(
    gates: List[Gate], instances: List[GateInstance], max_degree: int
) -> Tuple[List[np.ndarray], SelectorsInfo]:
    """Greedy grouping by degree; selector value = global gate index, or
    UNUSED (selectors.rs:80-167)."""
    n = len(instances)
    num_gates = len(gates)
    max_gate_degree = gates[-1].degree()
    index = {g.id(): i for i, g in enumerate(gates)}

    if max_gate_degree + num_gates - 1 <= max_degree:
        poly = np.array(
            [index[inst.gate.id()] for inst in instances], dtype=np.uint64
        )
        return [poly], SelectorsInfo([0] * num_gates, [(0, num_gates)])

    assert max_gate_degree < max_degree, (
        f"{gates[-1].id()} has too high degree; increase quotient_degree_factor"
    )

    groups: List[Tuple[int, int]] = []
    start = 0
    while start < num_gates:
        size = 0
        while start + size < num_gates and size + gates[start + size].degree() < max_degree:
            size += 1
        groups.append((start, start + size))
        start += size

    def group_of(i: int) -> int:
        for gi, (s, e) in enumerate(groups):
            if s <= i < e:
                return gi
        raise AssertionError

    selector_indices = [group_of(i) for i in range(num_gates)]
    polys = [np.zeros(n, dtype=np.uint64) for _ in groups]
    for j, inst in enumerate(instances):
        i = index[inst.gate.id()]
        gr = group_of(i)
        for g in range(len(groups)):
            polys[g][j] = i if g == gr else UNUSED_SELECTOR
    return polys, SelectorsInfo(selector_indices, groups)

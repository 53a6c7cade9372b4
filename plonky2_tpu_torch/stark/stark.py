"""The Stark protocol base class + evaluation frame + constraint consumer
(reference: starky/src/{stark.rs,evaluation_frame.rs,constraint_consumer.rs};
plonky2_tpu/stark/stark.py, whose opening spec is cut here to what a
single table without lookups or zero knowledge opens).

Single-source constraints: a Stark implements ``eval`` once over an
abstract algebra A; the same code runs as
  * the device quotient kernel (DeviceBatchAlgebra over the LDE coset),
  * the host single-point evaluation at zeta (HostExtAlgebra),
  * (later) the in-circuit recursive verifier (CircuitAlgebra),
replacing the reference's eval_packed_generic / eval_ext_circuit pair.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from ..fri.structure import (
    FriBatchInfo,
    FriInstanceInfo,
    FriOpeningExpression,
    FriOracleInfo,
    FriPolynomialInfo,
)
from ..field import extension as ge


@dataclass
class StarkFrame:
    """Two consecutive trace rows + public inputs, as algebra elements."""

    local_values: Sequence
    next_values: Sequence
    public_inputs: Sequence


class ConstraintConsumer:
    """Accumulates constraints against alpha powers with first/last-row
    and transition selectors (constraint_consumer.rs:20-120)."""

    def __init__(self, A, alphas, z_last, lagrange_basis_first, lagrange_basis_last):
        self.A = A
        self.alphas = alphas
        self.accs = [A.zero() for _ in alphas]
        self.z_last = z_last
        self.l_first = lagrange_basis_first
        self.l_last = lagrange_basis_last

    def constraint(self, c) -> None:
        A = self.A
        self.accs = [
            A.add(A.mul(acc, alpha), c) for acc, alpha in zip(self.accs, self.alphas)
        ]

    def constraint_transition(self, c) -> None:
        self.constraint(self.A.mul(c, self.z_last))

    def constraint_first_row(self, c) -> None:
        self.constraint(self.A.mul(c, self.l_first))

    def constraint_last_row(self, c) -> None:
        self.constraint(self.A.mul(c, self.l_last))

    def accumulators(self) -> List:
        return list(self.accs)


class Stark:
    """Subclass and implement num_columns/num_public_inputs/constraint_degree
    and eval(frame, consumer, A)."""

    def num_columns(self) -> int:
        raise NotImplementedError

    def num_public_inputs(self) -> int:
        return 0

    def constraint_degree(self) -> int:
        raise NotImplementedError

    def eval(self, frame: StarkFrame, consumer: ConstraintConsumer, A) -> None:
        raise NotImplementedError

    # -- lookups / CTLs (overridable; defaults: none) ------------------------

    def uses_lookups(self) -> bool:
        return bool(self.lookups())

    def lookups(self) -> List:
        return []

    def requires_ctls(self) -> bool:
        return False

    # -- derived parameters (stark.rs:84-112) --------------------------------

    def quotient_degree_factor(self) -> int:
        eff = max(self.constraint_degree(), 2) if self.uses_lookups() else self.constraint_degree()
        return max(1, eff - 1)

    def num_quotient_polys(self, config) -> int:
        return self.quotient_degree_factor() * config.num_challenges

    def fri_instance(self, zeta, g: int, config) -> FriInstanceInfo:
        """Opening spec: the trace and quotient polynomials at zeta, the
        trace at g*zeta (stark.rs:115-197 without auxiliary polynomials,
        CTL openings or zero knowledge, which are not ported: ROADMAP A14)."""
        C = self.num_columns()
        nq = self.num_quotient_polys(config)
        trace = [
            FriOpeningExpression.single(p) for p in FriPolynomialInfo.from_range(0, 0, C)
        ]
        quotient = [
            FriOpeningExpression.single(p) for p in FriPolynomialInfo.from_range(1, 0, nq)
        ]
        return FriInstanceInfo(
            oracles=[FriOracleInfo(C, False), FriOracleInfo(nq, False)],
            batches=[
                FriBatchInfo(tuple(zeta), trace + quotient),
                FriBatchInfo(tuple(ge.ext_scalar_mul(zeta, g)), trace),
            ],
        )

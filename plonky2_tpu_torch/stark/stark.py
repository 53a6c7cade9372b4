"""The Stark protocol base class + evaluation frame + constraint consumer
(reference: starky/src/{stark.rs,evaluation_frame.rs,constraint_consumer.rs};
plonky2_tpu/stark/stark.py).

Single-source constraints: a Stark implements ``eval`` once over an
abstract algebra A; the same code runs as
  * the device quotient kernel (DeviceBatchAlgebra over the LDE coset),
  * the host single-point evaluation at zeta (HostExtAlgebra),
  * the in-circuit recursive verifier (CircuitAlgebra),
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

    def num_lookup_helper_columns(self, config) -> int:
        """Total lookup helper columns across challenges (stark.rs:292-300)."""
        return (
            sum(
                lookup.num_helper_columns(self.constraint_degree())
                for lookup in self.lookups()
            )
            * config.num_challenges
        )

    # -- derived parameters (stark.rs:84-112) --------------------------------

    def quotient_degree_factor(self) -> int:
        eff = max(self.constraint_degree(), 2) if self.uses_lookups() else self.constraint_degree()
        return max(1, eff - 1)

    def num_quotient_polys(self, config) -> int:
        return self.quotient_degree_factor() * config.num_challenges

    def fri_instance(
        self,
        zeta,
        g: int,
        config,
        num_ctl_helpers: int = 0,
        num_ctl_zs: int = 0,
        zk_degree: int = 0,
    ) -> FriInstanceInfo:
        """Opening spec: everything at zeta; trace+aux at g*zeta; CTL Z
        polys additionally at 1 (stark.rs:115-197).

        The aux oracle holds the lookup columns (per lookup, per challenge,
        the helpers then Z), then every CTL helper, then every CTL Z; the
        CTL Zs open at 1 from row num_lookup + num_ctl_helpers on.

        zk_degree (nonzero => zero-knowledge): each trace column i is
        committed as a (low, high) pair split at X^zk_degree — the
        Z_H-masked column T'(X) = T(X) - R(X) + X^n R(X) — and every
        logical trace opening is the split-mask expression
        low_i + point^n * high_i (core/src/fri_structure.rs:76-89
        FriOpeningExpression::split_mask). The trace and quotient oracles
        are salted (blinding=true, fri/oracle.rs:243-264)."""
        oracles = []
        C = self.num_columns()
        if zk_degree:
            # committed polys: lows 0..C, highs C..2C
            lows = FriPolynomialInfo.from_range(0, 0, C)
            highs = FriPolynomialInfo.from_range(0, C, 2 * C)
            trace_open = [
                FriOpeningExpression.split_mask(lo, hi, zk_degree)
                for lo, hi in zip(lows, highs)
            ]
            oracles.append(FriOracleInfo(2 * C, True))
        else:
            trace_open = _singles(FriPolynomialInfo.from_range(0, 0, C))
            oracles.append(FriOracleInfo(C, False))

        num_lookup_columns = self.num_lookup_helper_columns(config)
        num_aux = num_lookup_columns + num_ctl_helpers + num_ctl_zs
        aux_info: List[FriPolynomialInfo] = []
        if self.uses_lookups() or self.requires_ctls():
            aux_info = FriPolynomialInfo.from_range(len(oracles), 0, num_aux)
            oracles.append(FriOracleInfo(num_aux, False))

        nq = self.num_quotient_polys(config)
        if zk_degree:
            nq += config.num_challenges  # one extra chunk absorbs the mask degree
        quotient_info = (
            FriPolynomialInfo.from_range(len(oracles), 0, nq) if nq else []
        )
        if nq:
            oracles.append(FriOracleInfo(nq, zk_degree != 0))

        zeta_batch = FriBatchInfo(
            tuple(zeta), trace_open + _singles(aux_info) + _singles(quotient_info)
        )
        zeta_next = ge.ext_scalar_mul(zeta, g)
        zeta_next_batch = FriBatchInfo(tuple(zeta_next), trace_open + _singles(aux_info))
        batches = [zeta_batch, zeta_next_batch]
        if self.requires_ctls():
            ctl_zs_info = FriPolynomialInfo.from_range(
                1, num_lookup_columns + num_ctl_helpers, num_aux
            )
            batches.append(FriBatchInfo.from_polys(ge.ext_one(2), ctl_zs_info))
        return FriInstanceInfo(oracles=oracles, batches=batches)


def _singles(infos) -> List[FriOpeningExpression]:
    return [FriOpeningExpression.single(p) for p in infos]

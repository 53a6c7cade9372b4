"""logUp lookup argument for STARKs, via logarithmic derivatives
(eprint 2022/1530; reference: starky/src/lookup.rs; plonky2_tpu/stark/lookup.py).

Given looking columns f_i, a table column t and a frequencies column m
with multiset(∪ f_i) ⊆ multiset(t), and a random challenge x, the prover
commits helper columns
    h_k = Σ_{i in chunk k} filter_i / (x + f_i)          (lookup.rs:746-790)
    g   = 1 / (x + t)                                    (folded into Z below)
and a running-sum column Z with Z(1)=0 and
    Z(gω) = Z(ω) + Σ_k h_k(ω) − m(ω)·g(ω)               (lookup.rs:636-648)
so that Z wraps to 0 over the subgroup iff Σ 1/(x+f_i) = Σ m/(x+t).

The helper and Z columns are computed on the trace's device from the
trace tensor [columns, n] (int64 bit containers, ``ops/gf``): the
denominators of every chunk and the table in ONE ``gf.batch_inverse``, the
running sum by a log-doubling modular scan. On a CPU tensor the same code
is the plain form that the tests hold to the JAX package's host numpy.

Constraint evaluation is single-source over the abstract algebra A, so the
same code serves the device quotient, the host verifier and the in-circuit
recursive verifier (replacing the reference's packed/circuit eval pair at
lookup.rs:655-941).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import List, Sequence, Tuple

import torch

from ..field import goldilocks as gl
from ..ops import gf


# ---------------------------------------------------------------------------
# Column / Filter (lookup.rs:131-404)
# ---------------------------------------------------------------------------


@dataclass
class Column:
    """Linear combination of trace columns (current + next row) plus a
    constant (lookup.rs:140-146)."""

    linear_combination: List[Tuple[int, int]] = dc_field(default_factory=list)
    next_row_linear_combination: List[Tuple[int, int]] = dc_field(default_factory=list)
    constant: int = 0

    @staticmethod
    def single(c: int) -> "Column":
        return Column(linear_combination=[(c, 1)])

    @staticmethod
    def singles(cs: Sequence[int]) -> List["Column"]:
        return [Column.single(c) for c in cs]

    @staticmethod
    def single_next_row(c: int) -> "Column":
        return Column(next_row_linear_combination=[(c, 1)])

    @staticmethod
    def constant_col(c: int) -> "Column":
        return Column(constant=c % gl.P)

    @staticmethod
    def linear_combination_with_constant(
        pairs: Sequence[Tuple[int, int]], constant: int
    ) -> "Column":
        return Column(
            linear_combination=[(c, k % gl.P) for c, k in pairs],
            constant=constant % gl.P,
        )

    def eval(self, local, A):
        """Current-row evaluation over algebra elements."""
        acc = A.const(self.constant)
        for c, k in self.linear_combination:
            acc = A.add(acc, A.mul_const(local[c], k))
        return acc

    def eval_with_next(self, local, nxt, A):
        acc = self.eval(local, A)
        for c, k in self.next_row_linear_combination:
            acc = A.add(acc, A.mul_const(nxt[c], k))
        return acc

    def eval_all_rows(self, trace: torch.Tensor) -> torch.Tensor:
        """Evaluation over every row of a [columns, n] trace tensor, on its
        device; next-row terms wrap around (lookup.rs:345-368)."""
        n = trace.shape[1]
        acc = gf.full((n,), self.constant, trace.device)
        for c, k in self.linear_combination:
            acc = gf.add(acc, _scaled(trace[c], k))
        for c, k in self.next_row_linear_combination:
            acc = gf.add(acc, _scaled(torch.roll(trace[c], -1), k))
        return acc


def _scaled(col: torch.Tensor, k: int) -> torch.Tensor:
    """k * col; a unit coefficient (a single column, the common case)
    costs no product."""
    return col if k % gl.P == 1 else gf.mul_const(col, k)


@dataclass
class Filter:
    """Degree-≤2 combination of columns selecting rows (lookup.rs:37-130):
    Σ products + Σ constants, where products are column pairs."""

    products: List[Tuple[Column, Column]] = dc_field(default_factory=list)
    constants: List[Column] = dc_field(default_factory=list)

    @staticmethod
    def default() -> "Filter":
        return Filter(constants=[Column.constant_col(1)])

    @staticmethod
    def new_simple(col: Column) -> "Filter":
        return Filter(constants=[col])

    def eval_filter(self, local, nxt, A):
        acc = A.zero()
        for c1, c2 in self.products:
            acc = A.add(
                acc,
                A.mul(c1.eval_with_next(local, nxt, A), c2.eval_with_next(local, nxt, A)),
            )
        for c in self.constants:
            acc = A.add(acc, c.eval_with_next(local, nxt, A))
        return acc

    def eval_all_rows(self, trace: torch.Tensor) -> torch.Tensor:
        n = trace.shape[1]
        acc = gf.zeros((n,), trace.device)
        for c1, c2 in self.products:
            acc = gf.add(acc, gf.mul(c1.eval_all_rows(trace), c2.eval_all_rows(trace)))
        for c in self.constants:
            acc = gf.add(acc, c.eval_all_rows(trace))
        return acc


# ---------------------------------------------------------------------------
# Lookup (lookup.rs:415-443)
# ---------------------------------------------------------------------------


def _chunk_size(constraint_degree: int) -> int:
    # lookup.rs num_helper_columns: constraint_degree.checked_sub(1).unwrap_or(1);
    # a STARK of constraint degree 0 (PermutationStark) batches one a chunk
    size = 1 if constraint_degree == 0 else constraint_degree - 1
    assert size >= 1, "lookup batching undefined for constraint degree 1"
    return size


@dataclass
class Lookup:
    columns: List[Column]
    table_column: Column
    frequencies_column: Column
    filter_columns: List[Filter]

    def num_helper_columns(self, constraint_degree: int) -> int:
        size = _chunk_size(constraint_degree)
        return -(-len(self.columns) // size) + 1


# ---------------------------------------------------------------------------
# Grand-product challenges (lookup.rs:445-567)
# ---------------------------------------------------------------------------


@dataclass
class GrandProductChallenge:
    """(β, γ): combine(t) = Σ t_i·β^i + γ  (lookup.rs:454-476)."""

    beta: object
    gamma: object

    def combine(self, terms, A):
        acc = A.zero()
        for t in reversed(list(terms)):
            acc = A.add(A.mul(acc, self.beta), t)
        return A.add(acc, self.gamma)


@dataclass
class GrandProductChallengeSet:
    challenges: List[GrandProductChallenge]


def get_grand_product_challenge_set(challenger, num_challenges: int) -> GrandProductChallengeSet:
    """Host transcript: each challenge is (β, γ) = two squeezes
    (lookup.rs:525-543)."""
    out = []
    for _ in range(num_challenges):
        beta = challenger.get_challenge()
        gamma = challenger.get_challenge()
        out.append(GrandProductChallenge(beta, gamma))
    return GrandProductChallengeSet(out)


def get_grand_product_challenge_set_target(
    builder, ch, num_challenges: int
) -> GrandProductChallengeSet:
    """In-circuit dual (lookup.rs:545-567); β/γ are Targets."""
    out = []
    for _ in range(num_challenges):
        beta = ch.get_challenge()
        gamma = ch.get_challenge()
        out.append(GrandProductChallenge(beta, gamma))
    return GrandProductChallengeSet(out)


# ---------------------------------------------------------------------------
# Prover-side helper columns, on the trace's device (lookup.rs:579-790)
# ---------------------------------------------------------------------------


def _combined(trace: torch.Tensor, cols: List[Column], challenge: GrandProductChallenge):
    """γ + Σ_i β^i · cols_i over every row."""
    beta = int(challenge.beta) % gl.P
    acc = gf.full((trace.shape[1],), int(challenge.gamma), trace.device)
    power = 1
    for col in cols:
        acc = gf.add(acc, _scaled(col.eval_all_rows(trace), power))
        power = gl.gmul(power, beta)
    return acc


def get_helper_cols(
    trace: torch.Tensor,
    columns_filters: List[Tuple[List[Column], Filter]],
    challenge: GrandProductChallenge,
    constraint_degree: int,
    extra_denominators: Sequence[torch.Tensor] = (),
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """For each chunk of ``_chunk_size(constraint_degree)`` (column set,
    filter) pairs, Σ filter / combine(columns) over all rows
    (lookup.rs:746-790). Every denominator, and the caller's
    ``extra_denominators``, is inverted in one batch inversion. Returns
    (helper columns, inverses of the extra denominators)."""
    size = _chunk_size(constraint_degree)
    dens = [_combined(trace, cols, challenge) for cols, _ in columns_filters]
    inverses = gf.batch_inverse(torch.stack(dens + list(extra_denominators)))
    helpers: List[torch.Tensor] = []
    for start in range(0, len(columns_filters), size):
        acc = None
        for j in range(start, min(start + size, len(columns_filters))):
            term = gf.mul(inverses[j], columns_filters[j][1].eval_all_rows(trace))
            acc = term if acc is None else gf.add(acc, term)
        helpers.append(acc)
    return helpers, list(inverses[len(dens):])


def prefix_sum_exclusive(x: torch.Tensor) -> torch.Tensor:
    """out[..., i] = Σ_{j<i} x[..., j] mod p along the last axis, by a
    log-doubling scan of modular adds (a cumsum over the int64 container
    would wrap)."""
    x = x.clone()
    n = x.shape[-1]
    shift = 1
    while shift < n:
        x[..., shift:] = gf.add(x[..., shift:], x[..., :-shift])
        shift <<= 1
    return torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=-1)


def suffix_sum_inclusive(x: torch.Tensor) -> torch.Tensor:
    """out[..., i] = Σ_{j>=i} x[..., j] mod p along the last axis, by the
    same log-doubling scan."""
    x = x.clone()
    n = x.shape[-1]
    shift = 1
    while shift < n:
        x[..., :-shift] = gf.add(x[..., :-shift], x[..., shift:])
        shift <<= 1
    return x


def lookup_helper_columns(
    lookup: Lookup,
    trace: torch.Tensor,
    challenge: int,
    constraint_degree: int,
) -> List[torch.Tensor]:
    """All helper columns + the running-sum Z column for one (lookup,
    challenge) pair (lookup.rs:579-648). The lookup Z is an EXCLUSIVE
    prefix sum with Z[0] = 0 (the CTL Z of cross_table_lookup.py is an
    inclusive suffix sum)."""
    assert len(lookup.columns) == len(lookup.filter_columns)
    n = trace.shape[1]
    assert n * len(lookup.columns) < gl.P

    # a lookup uses only the beta of its challenge, as (1, beta)
    grand = GrandProductChallenge(1, challenge % gl.P)
    columns_filters = [
        ([col], filt) for col, filt in zip(lookup.columns, lookup.filter_columns)
    ]
    table = gf.add(
        lookup.table_column.eval_all_rows(trace), gf.full((1,), challenge, trace.device)
    )
    helpers, (table_inv,) = get_helper_cols(
        trace, columns_filters, grand, constraint_degree, extra_denominators=[table]
    )
    freqs = lookup.frequencies_column.eval_all_rows(trace)
    x = gf.sum_mod_p(torch.stack(helpers), axis=0)
    x = gf.sub(x, gf.mul(freqs, table_inv))
    return helpers + [prefix_sum_exclusive(x)]


def all_lookup_helper_columns(
    stark, trace: torch.Tensor, lookup_challenges: List[int]
) -> List[torch.Tensor]:
    """Concatenated helper columns for every (lookup, challenge) pair, in
    the reference's order (prover.rs:177-194): per lookup, per challenge,
    its helpers then its Z."""
    cols: List[torch.Tensor] = []
    degree = stark.constraint_degree()
    for lookup in stark.lookups():
        for challenge in lookup_challenges:
            cols.extend(lookup_helper_columns(lookup, trace, challenge, degree))
    return cols


# ---------------------------------------------------------------------------
# Constraint evaluation (single-source over A; lookup.rs:655-941)
# ---------------------------------------------------------------------------


@dataclass
class LookupCheckVars:
    """Openings/LDE values of the lookup helper columns + the base-field
    challenges (lookup.rs:792-801), as algebra elements."""

    local_values: List
    next_values: List
    challenges: List


def eval_helper_columns(
    filters: List[Filter],
    columns: List[List],
    local,
    nxt,
    helper_columns: List,
    constraint_degree: int,
    challenge: GrandProductChallenge,
    consumer,
    A,
) -> None:
    """Check h·Π(x+f_i) = Σ_j filter_j·Π_{i≠j}(x+f_i) per chunk
    (lookup.rs:655-694)."""
    if not helper_columns:
        return
    size = _chunk_size(constraint_degree)
    for k, h in enumerate(helper_columns):
        chunk = columns[k * size : (k + 1) * size]
        fs = filters[k * size : (k + 1) * size]
        if len(chunk) == 2:
            combin0 = challenge.combine(chunk[0], A)
            combin1 = challenge.combine(chunk[1], A)
            f0 = fs[0].eval_filter(local, nxt, A)
            f1 = fs[1].eval_filter(local, nxt, A)
            c = A.sub(
                A.mul(A.mul(combin1, combin0), h),
                A.add(A.mul(f0, combin1), A.mul(f1, combin0)),
            )
            consumer.constraint(c)
        elif len(chunk) == 1:
            combin = challenge.combine(chunk[0], A)
            f0 = fs[0].eval_filter(local, nxt, A)
            consumer.constraint(A.sub(A.mul(combin, h), f0))
        else:
            # general m-term chunk (degree > 3 configs):
            #   h·Π_i combin_i = Σ_j f_j·Π_{i≠j} combin_i
            # via prefix/suffix products, m-1 muls per side. The m ≤ 2
            # branches above keep their historical op shapes; the reference
            # only ships m = 2 (starky/src/lookup.rs:614) — this generalizes it.
            combins = [challenge.combine(c, A) for c in chunk]
            fvals = [f.eval_filter(local, nxt, A) for f in fs]
            m = len(combins)
            prefix = [None] * (m + 1)  # prefix[j] = Π_{i<j}
            prefix[0] = A.one()
            for j in range(m):
                prefix[j + 1] = A.mul(prefix[j], combins[j])
            suffix = [None] * (m + 1)  # suffix[j] = Π_{i>=j}
            suffix[m] = A.one()
            for j in range(m - 1, -1, -1):
                suffix[j] = A.mul(combins[j], suffix[j + 1])
            lhs = A.mul(prefix[m], h)
            rhs = None
            for j in range(m):
                term = A.mul(fvals[j], A.mul(prefix[j], suffix[j + 1]))
                rhs = term if rhs is None else A.add(rhs, term)
            consumer.constraint(A.sub(lhs, rhs))


def eval_lookups(stark, lookups, frame, lookup_vars: LookupCheckVars, consumer, A) -> None:
    """logUp constraints for every (lookup, challenge) pair
    (lookup.rs:808-863)."""
    local = frame.local_values
    nxt = frame.next_values
    degree = stark.constraint_degree()
    start = 0
    for lookup in lookups:
        num_helper_columns = lookup.num_helper_columns(degree)
        for challenge in lookup_vars.challenges:
            grand = GrandProductChallenge(A.one(), challenge)
            lookup_columns = [
                [col.eval_with_next(local, nxt, A)] for col in lookup.columns
            ]
            helpers = lookup_vars.local_values[start : start + num_helper_columns - 1]
            eval_helper_columns(
                lookup.filter_columns,
                lookup_columns,
                local,
                nxt,
                helpers,
                degree,
                grand,
                consumer,
                A,
            )
            z = lookup_vars.local_values[start + num_helper_columns - 1]
            next_z = lookup_vars.next_values[start + num_helper_columns - 1]
            table_with_challenge = A.add(
                lookup.table_column.eval(local, A), challenge
            )
            y = A.zero()
            for h in helpers:
                y = A.add(y, h)
            y = A.sub(
                A.mul(y, table_with_challenge),
                lookup.frequencies_column.eval(local, A),
            )
            consumer.constraint_first_row(z)
            consumer.constraint(
                A.sub(A.mul(A.sub(next_z, z), table_with_challenge), y)
            )
            start += num_helper_columns

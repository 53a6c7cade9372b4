"""Cross-table lookups (CTLs) for multi-STARK systems (reference:
starky/src/cross_table_lookup.rs; plonky2_tpu/stark/cross_table_lookup.py).

A CrossTableLookup asserts that the multiset of filtered, β-combined rows
of the looking tables equals that of the looked table. Each table commits
partial-sum Z polynomials (reversed running sums of filter/(γ+combine(row)),
so Z(1) holds the total); the cross-table check is
Σ looking Z(1) == looked Z(1) (cross_table_lookup.rs:852-940).

The helper and Z columns are computed on the trace's device from the
trace tensor (stark/lookup.py get_helper_cols and the suffix scan). The
CTL Z is an INCLUSIVE suffix sum with the total on row 0 (the lookup Z is
an exclusive prefix sum), and a CTL over a single column set has no
helper column.

Constraint evaluation is single-source over the abstract algebra A (device
quotient / host verifier)."""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..field import goldilocks as gl
from ..ops import gf
from .lookup import (
    Column,
    Filter,
    GrandProductChallenge,
    GrandProductChallengeSet,
    eval_helper_columns,
    get_grand_product_challenge_set,
    get_helper_cols,
    suffix_sum_inclusive,
)


@dataclass
class TableWithColumns:
    """One side of a CTL: a table index, the column linear combinations to
    extract and a row filter (cross_table_lookup.rs:46-79)."""

    table: int
    columns: List[Column]
    filter: Filter


@dataclass
class CrossTableLookup:
    looking_tables: List[TableWithColumns]
    looked_table: TableWithColumns

    def __post_init__(self):
        assert all(
            len(t.columns) == len(self.looked_table.columns)
            for t in self.looking_tables
        )

    @staticmethod
    def num_ctl_helpers_zs_all(
        ctls: Sequence["CrossTableLookup"],
        table: int,
        num_challenges: int,
        constraint_degree: int,
    ) -> Tuple[int, int, List[int]]:
        """(total helpers, total z polys, helpers per ctl) for one table
        (cross_table_lookup.rs:113-140)."""
        num_helpers = 0
        num_ctls = 0
        num_helpers_by_ctl = [0] * len(ctls)
        for i, ctl in enumerate(ctls):
            all_tables = [ctl.looked_table] + list(ctl.looking_tables)
            appearances = sum(1 for t in all_tables if t.table == table)
            if appearances > 1:
                num_helpers_by_ctl[i] = -(-appearances // (constraint_degree - 1))
                num_helpers += num_helpers_by_ctl[i]
            if appearances > 0:
                num_ctls += 1
        return num_helpers * num_challenges, num_ctls * num_challenges, num_helpers_by_ctl


@dataclass
class CtlZData:
    """Data for one CTL Z polynomial on one table
    (cross_table_lookup.rs:150-186); columns as device tensors [n]."""

    helper_columns: List[torch.Tensor]
    z: torch.Tensor
    challenge: GrandProductChallenge
    columns: List[List[Column]]
    filter: List[Filter]


@dataclass
class CtlData:
    zs_columns: List[CtlZData] = dc_field(default_factory=list)

    def ctl_helper_polys(self) -> List[torch.Tensor]:
        out: List[torch.Tensor] = []
        for z in self.zs_columns:
            out.extend(z.helper_columns)
        return out

    def ctl_z_polys(self) -> List[torch.Tensor]:
        return [z.z for z in self.zs_columns]

    def num_ctl_helper_polys(self) -> List[int]:
        return [len(z.helper_columns) for z in self.zs_columns]


def partial_sums(
    trace: torch.Tensor,
    columns_filters: List[Tuple[List[Column], Filter]],
    challenge: GrandProductChallenge,
    constraint_degree: int,
) -> List[torch.Tensor]:
    """Helper columns + reversed running sum Z with the total on row 0
    (cross_table_lookup.rs:380-418), on the trace's device."""
    helper_columns, _ = get_helper_cols(trace, columns_filters, challenge, constraint_degree)
    x = gf.sum_mod_p(torch.stack(helper_columns), axis=0)
    z = suffix_sum_inclusive(x)
    if len(columns_filters) > 1:
        return helper_columns + [z]
    return [z]


def cross_table_lookup_data(
    traces: Sequence[torch.Tensor],
    cross_table_lookups: Sequence[CrossTableLookup],
    ctl_challenges: GrandProductChallengeSet,
    constraint_degree: int,
) -> List[CtlData]:
    """Per-table CTL Z data (cross_table_lookup.rs:264-341); ``traces`` are
    [columns, n] tensors, each table's on its device."""
    ctl_data_per_table = [CtlData() for _ in range(len(traces))]
    for ctl in cross_table_lookups:
        for challenge in ctl_challenges.challenges:
            # group looking tables by table index, preserving order
            groups: List[Tuple[int, List[TableWithColumns]]] = []
            for twc in ctl.looking_tables:
                if groups and groups[-1][0] == twc.table:
                    groups[-1][1].append(twc)
                else:
                    groups.append((twc.table, [twc]))
            for table, group in groups:
                cols_filts = [(t.columns, t.filter) for t in group]
                helpers_zs = partial_sums(
                    traces[table], cols_filts, challenge, constraint_degree
                )
                ctl_data_per_table[table].zs_columns.append(
                    CtlZData(
                        helper_columns=helpers_zs[:-1],
                        z=helpers_zs[-1],
                        challenge=challenge,
                        columns=[t.columns for t in group],
                        filter=[t.filter for t in group],
                    )
                )
            z_looked = partial_sums(
                traces[ctl.looked_table.table],
                [(ctl.looked_table.columns, ctl.looked_table.filter)],
                challenge,
                constraint_degree,
            )
            ctl_data_per_table[ctl.looked_table.table].zs_columns.append(
                CtlZData(
                    helper_columns=[],
                    z=z_looked[0],
                    challenge=challenge,
                    columns=[ctl.looked_table.columns],
                    filter=[ctl.looked_table.filter],
                )
            )
    return ctl_data_per_table


def get_ctl_data(
    config,
    traces: Sequence[torch.Tensor],
    all_cross_table_lookups: Sequence[CrossTableLookup],
    challenger,
    max_constraint_degree: int,
) -> Tuple[GrandProductChallengeSet, List[CtlData]]:
    """(challenges, per-table data); samples the grand-product challenge
    set from the shared challenger (cross_table_lookup.rs:226-251)."""
    ctl_challenges = get_grand_product_challenge_set(challenger, config.num_challenges)
    ctl_data = cross_table_lookup_data(
        traces, all_cross_table_lookups, ctl_challenges, max_constraint_degree
    )
    return ctl_challenges, ctl_data


def get_ctl_auxiliary_polys(ctl_data: Optional[CtlData]) -> Optional[List[torch.Tensor]]:
    """Every CTL helper, then every CTL Z: their order in the aux oracle."""
    if ctl_data is None:
        return None
    return ctl_data.ctl_helper_polys() + ctl_data.ctl_z_polys()


# ---------------------------------------------------------------------------
# Constraint-side check vars (cross_table_lookup.rs:418-630)
# ---------------------------------------------------------------------------


@dataclass
class CtlCheckVars:
    """Algebra elements for one CTL Z polynomial check."""

    helper_columns: List
    local_z: object
    next_z: object
    challenges: GrandProductChallenge  # beta/gamma as algebra elements
    columns: List[List[Column]]
    filter: List[Filter]


def ctl_vars_from_openings(
    table: int,
    aux_local: List,
    aux_next: List,
    cross_table_lookups: Sequence[CrossTableLookup],
    ctl_challenges_elems: List[GrandProductChallenge],
    num_lookup_columns: int,
    total_num_helper_columns: int,
    num_helper_ctl_columns: List[int],
) -> List[CtlCheckVars]:
    """Extract per-table CtlCheckVars from aux-oracle values (algebra
    elements), mirroring CtlCheckVars::from_proof
    (cross_table_lookup.rs:443-546). aux_local/aux_next span the whole aux
    oracle; CTL entries start at num_lookup_columns."""
    ctl_zs = list(
        zip(aux_local[num_lookup_columns:], aux_next[num_lookup_columns:])
    )
    z_index = 0
    start_index = 0
    ctl_vars: List[CtlCheckVars] = []
    for i, ctl in enumerate(cross_table_lookups):
        for challenges in ctl_challenges_elems:
            matching = [t for t in ctl.looking_tables if t.table == table]
            if matching:
                looking_z, looking_z_next = ctl_zs[total_num_helper_columns + z_index]
                helpers = [
                    h
                    for h, _ in ctl_zs[
                        start_index : start_index + num_helper_ctl_columns[i]
                    ]
                ]
                start_index += num_helper_ctl_columns[i]
                z_index += 1
                ctl_vars.append(
                    CtlCheckVars(
                        helper_columns=helpers,
                        local_z=looking_z,
                        next_z=looking_z_next,
                        challenges=challenges,
                        columns=[t.columns for t in matching],
                        filter=[t.filter for t in matching],
                    )
                )
            if ctl.looked_table.table == table:
                looked_z, looked_z_next = ctl_zs[total_num_helper_columns + z_index]
                z_index += 1
                ctl_vars.append(
                    CtlCheckVars(
                        helper_columns=[],
                        local_z=looked_z,
                        next_z=looked_z_next,
                        challenges=challenges,
                        columns=[ctl.looked_table.columns],
                        filter=[ctl.looked_table.filter],
                    )
                )
    return ctl_vars


def ctl_zs_entries(
    table: int,
    ctls: Sequence[CrossTableLookup],
    num_challenges: int,
    constraint_degree: int,
) -> List[Tuple[int, List[List[Column]], List[Filter], int]]:
    """Static per-table CTL entry layout: (helper_count, columns, filters,
    challenge_index) in zs_columns order. Mirrors both
    cross_table_lookup_data's per-table output ordering and
    CtlCheckVars::from_proof (each table is assumed to appear as one
    contiguous looking group per CTL)."""
    entries = []
    for ctl in ctls:
        looking = [t for t in ctl.looking_tables if t.table == table]
        for ci in range(num_challenges):
            if looking:
                k = len(looking)
                hc = -(-k // (constraint_degree - 1)) if k > 1 else 0
                entries.append(
                    (hc, [t.columns for t in looking], [t.filter for t in looking], ci)
                )
            if ctl.looked_table.table == table:
                entries.append(
                    (0, [ctl.looked_table.columns], [ctl.looked_table.filter], ci)
                )
    return entries


def build_ctl_check_vars(
    entries: Sequence[Tuple[int, List[List[Column]], List[Filter], int]],
    aux_local: List,
    aux_next: List,
    num_lookup_columns: int,
    challenge_elems: List[GrandProductChallenge],
) -> List[CtlCheckVars]:
    """Construct CtlCheckVars over any algebra from aux-oracle values laid
    out as [lookups | ctl helpers | ctl zs]. challenge_elems[i] is the
    grand-product challenge for challenge index i, as algebra elements."""
    total_helpers = sum(e[0] for e in entries)
    out: List[CtlCheckVars] = []
    start = 0
    for i, (hc, columns, filters, ci) in enumerate(entries):
        helpers = aux_local[
            num_lookup_columns + start : num_lookup_columns + start + hc
        ]
        z_idx = num_lookup_columns + total_helpers + i
        out.append(
            CtlCheckVars(
                helper_columns=list(helpers),
                local_z=aux_local[z_idx],
                next_z=aux_next[z_idx],
                challenges=challenge_elems[ci],
                columns=columns,
                filter=filters,
            )
        )
        start += hc
    return out


def eval_cross_table_lookup_checks(
    frame, ctl_vars: List[CtlCheckVars], consumer, A, constraint_degree: int
) -> None:
    """CTL Z constraints: reversed partial sums, so
    `combine(row)·(Z(x) − Z(gx)) = filter` with the total in Z(1)
    (cross_table_lookup.rs:548-630)."""
    local = frame.local_values
    nxt = frame.next_values
    for vars in ctl_vars:
        evals = [
            [c.eval_with_next(local, nxt, A) for c in cols] for cols in vars.columns
        ]
        eval_helper_columns(
            vars.filter,
            evals,
            local,
            nxt,
            vars.helper_columns,
            constraint_degree,
            vars.challenges,
            consumer,
            A,
        )
        z_diff = A.sub(vars.local_z, vars.next_z)
        if vars.helper_columns:
            h_sum = A.zero()
            for h in vars.helper_columns:
                h_sum = A.add(h_sum, h)
            consumer.constraint_last_row(A.sub(vars.local_z, h_sum))
            consumer.constraint_transition(A.sub(z_diff, h_sum))
        elif len(vars.columns) > 1:
            combin0 = vars.challenges.combine(evals[0], A)
            combin1 = vars.challenges.combine(evals[1], A)
            f0 = vars.filter[0].eval_filter(local, nxt, A)
            f1 = vars.filter[1].eval_filter(local, nxt, A)
            rhs = A.add(A.mul(f0, combin1), A.mul(f1, combin0))
            c01 = A.mul(combin0, combin1)
            consumer.constraint_last_row(A.sub(A.mul(c01, vars.local_z), rhs))
            consumer.constraint_transition(A.sub(A.mul(c01, z_diff), rhs))
        else:
            combin0 = vars.challenges.combine(evals[0], A)
            f0 = vars.filter[0].eval_filter(local, nxt, A)
            consumer.constraint_last_row(A.sub(A.mul(combin0, vars.local_z), f0))
            consumer.constraint_transition(A.sub(A.mul(combin0, z_diff), f0))


# ---------------------------------------------------------------------------
# Cross-proof verification (cross_table_lookup.rs:852-940)
# ---------------------------------------------------------------------------


class CtlVerificationError(Exception):
    pass


def verify_cross_table_lookups(
    cross_table_lookups: Sequence[CrossTableLookup],
    ctl_zs_first: List[List[int]],
    ctl_extra_looking_sums: Optional[Dict[int, List[int]]],
    config,
) -> None:
    """Check Σ looking Z(1) == looked Z(1) across every CTL and challenge."""
    extra = ctl_extra_looking_sums or {}
    iters = [iter(v) for v in ctl_zs_first]
    for index, ctl in enumerate(cross_table_lookups):
        extra_sum = extra.get(index)
        filtered_looking = []
        for t in ctl.looking_tables:
            if t.table not in filtered_looking:
                filtered_looking.append(t.table)
        for c in range(config.num_challenges):
            looking_sum = 0
            for table in filtered_looking:
                try:
                    looking_sum = gl.gadd(looking_sum, next(iters[table]))
                except StopIteration:
                    raise CtlVerificationError(
                        f"insufficient CTL openings for looking table {table}"
                    )
            if extra_sum is not None:
                looking_sum = gl.gadd(looking_sum, extra_sum[c])
            try:
                looked_z = next(iters[ctl.looked_table.table])
            except StopIteration:
                raise CtlVerificationError(
                    f"insufficient CTL openings for looked table {ctl.looked_table.table}"
                )
            if looking_sum != looked_z:
                raise CtlVerificationError(
                    f"cross-table lookup {index} failed (challenge {c})"
                )
    for it in iters:
        if next(it, None) is not None:
            raise CtlVerificationError("unexpected extra CTL openings")


def _rows_of(trace, twc: TableWithColumns):
    """(filter values, [columns, n] column values) of one CTL side, as u64
    arrays; ``trace`` a numpy u64 array or a tensor."""
    if not isinstance(trace, torch.Tensor):
        trace = gf.from_u64(np.asarray(trace, dtype=np.uint64), "cpu")
    filt = gf.to_u64(twc.filter.eval_all_rows(trace))
    rows = gf.to_u64(torch.stack([c.eval_all_rows(trace) for c in twc.columns]))
    return filt, rows


def check_ctls(
    traces: Sequence,
    cross_table_lookups: Sequence[CrossTableLookup],
    extra_looking_values: Optional[Dict[int, List[List[int]]]] = None,
) -> None:
    """Debug multiset check over raw traces (debug_utils::check_ctls,
    cross_table_lookup.rs:1009-1085)."""
    for i, ctl in enumerate(cross_table_lookups):
        looking: Dict[Tuple[int, ...], int] = {}
        for twc in ctl.looking_tables:
            filt, rows = _rows_of(traces[twc.table], twc)
            if np.any((filt != 0) & (filt != 1)):
                raise CtlVerificationError("non-binary CTL filter")
            for key in map(tuple, rows[:, filt == 1].T.tolist()):
                looking[key] = looking.get(key, 0) + 1
        for key in (extra_looking_values or {}).get(i, []):
            k = tuple(int(v) % gl.P for v in key)
            looking[k] = looking.get(k, 0) + 1
        filt, rows = _rows_of(traces[ctl.looked_table.table], ctl.looked_table)
        looked: Dict[Tuple[int, ...], int] = {}
        for key in map(tuple, rows[:, filt == 1].T.tolist()):
            looked[key] = looked.get(key, 0) + 1
        if looking != looked:
            raise CtlVerificationError(f"check_ctls failed for CTL {i}")

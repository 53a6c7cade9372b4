"""Multi-STARK system orchestration: prove N tables that share rows via
cross-table lookups, then verify each proof plus the cross-table Z(1)
equalities (plonky2_tpu/stark/multi.py).

The reference exports the CTL machinery (starky/src/cross_table_lookup.rs)
and leaves orchestration to the embedding system (e.g. zk-evm style): one
shared challenger observes the config and every table's trace cap, the
grand-product CTL challenge set is drawn once, and each per-table proof
continues from a copy of that common transcript state. Every table's
trace is uploaded once; its commitment and its CTL helper and Z columns
are built from that tensor on the device.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..field import goldilocks as gl
from ..fri import oracle as fo
from ..hash.challenger import Challenger
from ..ops import gf
from .config import StarkConfig
from .cross_table_lookup import (
    CrossTableLookup,
    ctl_zs_entries,
    get_ctl_data,
    verify_cross_table_lookups,
)
from .lookup import get_grand_product_challenge_set
from .proof import StarkProofWithPublicInputs
from .prover import prove_with_commitment
from .stark import Stark
from .verifier import (
    StarkVerificationError,
    get_challenges,
    verify_stark_proof_with_challenges,
)


def _seed_challenger(
    config: StarkConfig,
    all_public_inputs: Sequence[Sequence[int]],
    trace_caps: Sequence[np.ndarray],
) -> Challenger:
    ch = Challenger()
    config.observe(ch)
    for pis in all_public_inputs:
        ch.observe_elements([p % gl.P for p in pis])
    for cap in trace_caps:
        ch.observe_cap(cap)
    return ch


def prove_all_tables(
    starks: Sequence[Stark],
    config: StarkConfig,
    traces: Sequence[np.ndarray],
    all_public_inputs: Sequence[Sequence[int]],
    cross_table_lookups: Sequence[CrossTableLookup],
    max_constraint_degree: int = 3,
    device=None,
) -> List[StarkProofWithPublicInputs]:
    """One proof a table (u64 traces [C, n_i]); device=None means the GPU
    (raises without one), the CPU only when asked for by name."""
    device = gf.resolve_device(device)
    rate_bits = config.fri_config.rate_bits
    cap_height = config.fri_config.cap_height
    traces = [gf.from_u64(np.asarray(t, dtype=np.uint64), device) for t in traces]
    trace_commitments = [
        fo.PolynomialBatch.from_values(t, rate_bits, False, cap_height, device=device)
        for t in traces
    ]
    ch = _seed_challenger(
        config, all_public_inputs, [tc.cap_u64() for tc in trace_commitments]
    )
    ctl_challenges, ctl_data = get_ctl_data(
        config, traces, cross_table_lookups, ch, max_constraint_degree
    )
    proofs = []
    for stark, trace, tc, data, pis in zip(
        starks, traces, trace_commitments, ctl_data, all_public_inputs
    ):
        proofs.append(
            prove_with_commitment(
                stark, config, trace, tc, data, ctl_challenges, copy.deepcopy(ch), pis
            )
        )
    return proofs


def verify_all_tables(
    starks: Sequence[Stark],
    config: StarkConfig,
    proofs: Sequence[StarkProofWithPublicInputs],
    cross_table_lookups: Sequence[CrossTableLookup],
    degree_bits: Sequence[int],
    max_constraint_degree: int = 3,
    ctl_extra_looking_sums: Optional[Dict[int, List[int]]] = None,
) -> None:
    """Each table's proof against the shared transcript, then the
    cross-table sums of the CTL Zs at 1. Host code."""
    ch = _seed_challenger(
        config,
        [p.public_inputs for p in proofs],
        [p.proof.trace_cap for p in proofs],
    )
    ctl_challenges = get_grand_product_challenge_set(ch, config.num_challenges)
    for i, (stark, pwp, db) in enumerate(zip(starks, proofs, degree_bits)):
        entries = ctl_zs_entries(
            i, cross_table_lookups, config.num_challenges, max_constraint_degree
        )
        num_ctl_helpers = sum(e[0] for e in entries)
        num_ctl_zs = len(entries)
        challenges = get_challenges(
            stark,
            config,
            pwp,
            db,
            challenger=copy.deepcopy(ch),
            ctl_challenges=ctl_challenges,
            ctl_entries=entries,
        )
        verify_stark_proof_with_challenges(
            stark,
            pwp,
            challenges,
            config,
            db,
            ctl_challenges=ctl_challenges,
            ctl_entries=entries,
            num_ctl_helpers=num_ctl_helpers,
            num_ctl_zs=num_ctl_zs,
        )
        # bind the in-proof Z(1) openings: FRI already proves
        # aux(1) == ctl_zs_first via the point-1 batch
        if pwp.proof.openings.ctl_zs_first is None:
            raise StarkVerificationError(f"table {i}: missing ctl_zs_first openings")
    verify_cross_table_lookups(
        cross_table_lookups,
        [p.proof.openings.ctl_zs_first for p in proofs],
        ctl_extra_looking_sums,
        config,
    )

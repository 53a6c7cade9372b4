"""Batch-STARK proving: several tables of strictly decreasing degrees,
committed in TWO shared BatchMerkleTrees (one across all traces, one
across all quotients) and opened with a single batched FRI argument
(plonky2_tpu/stark/batch_prover.py; the batch-FRI primitive is
plonky2/src/batch_fri/*). A multi-table system then pays one Merkle cap
and one FRI proof instead of one a table. Tables without lookups,
cross-table lookups or zero knowledge, as in the JAX package (tables
joined by cross-table lookups are proven by stark/multi.py).

Transcript (one host Challenger):
  observe(config); per table: observe(public_inputs);
  observe(trace batch cap);
  per table: alphas' = n challenges, alphas = binding step (stark/vanishing.py
  run_binding_step);
  observe(quotient batch cap); zeta; per table: observe(openings);
  then the batch-FRI subprotocol (alpha, per-fold caps and betas, PoW,
  query indices).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from ..field import extension as ge
from ..field import goldilocks as gl
from ..fri import oracle as fo
from ..fri.batch_oracle import BatchFriOracle, prove_batch_openings, verify_batch_fri_proof
from ..fri.proof import FriProof
from ..fri.verifier import fri_challenges
from ..hash.challenger import Challenger
from ..ops import gf
from ..ops.bitrev import bitrev_axis
from .config import StarkConfig
from .proof import StarkOpeningSet
from .prover import compute_quotient_chunks
from .stark import Stark
from .vanishing import eval_vanishing_at_point, run_binding_step
from .verifier import StarkVerificationError


@dataclass
class BatchStarkProof:
    degree_bits: List[int]
    trace_cap: np.ndarray  # [2^cap_height, 4]
    quotient_cap: np.ndarray
    openings: List[StarkOpeningSet]  # per table
    opening_proof: FriProof
    public_inputs: List[List[int]]


def _check_tables(starks, traces) -> List[int]:
    degree_bits = []
    for stark, trace in zip(starks, traces):
        if stark.uses_lookups() or stark.requires_ctls():
            raise NotImplementedError(
                "batch STARKs with lookups or cross-table lookups are refused: the "
                "JAX package's batch prover refuses lookups too and has no CTL path"
            )
        num_cols, degree = trace.shape
        assert num_cols == stark.num_columns()
        db = degree.bit_length() - 1
        assert 1 << db == degree
        degree_bits.append(db)
    assert degree_bits == sorted(degree_bits, reverse=True) and len(set(degree_bits)) == len(
        degree_bits
    ), "tables must have strictly decreasing degrees"
    return degree_bits


def _observe_head(ch: Challenger, config: StarkConfig, public_inputs_list, trace_cap) -> None:
    config.observe(ch)
    for pis in public_inputs_list:
        ch.observe_elements([p % gl.P for p in pis])
    ch.observe_cap(trace_cap)


def batch_prove(
    starks: Sequence[Stark],
    config: StarkConfig,
    traces: Sequence[np.ndarray],  # per table u64 [num_columns, degree]
    public_inputs_list: Sequence[List[int]],
    device=None,
) -> BatchStarkProof:
    """device=None means the GPU (raises without one); the CPU only when
    asked for by name."""
    device = gf.resolve_device(device)
    degree_bits = _check_tables(starks, traces)
    fri_config = config.fri_config
    rate_bits, cap_height, nc = fri_config.rate_bits, fri_config.cap_height, config.num_challenges
    fri_params = config.fri_params(degree_bits[0])

    # 1. one batch commitment across every table's trace
    trace_oracle = BatchFriOracle.from_values(
        [np.asarray(t, dtype=np.uint64) for t in traces], rate_bits, False, cap_height, device
    )
    ch = Challenger()
    _observe_head(ch, config, public_inputs_list, trace_oracle.batch_merkle_tree.cap_u64())

    # 2. per-table constraint challenges and quotient chunks, over the
    # committed LDE (the batch tree's bit-reversed point-major leaves)
    quotient_groups = []
    for g, stark in enumerate(starks):
        alphas_prime = ch.get_n_challenges(nc)
        alphas = run_binding_step(stark, ch, public_inputs_list[g], alphas_prime, degree_bits[g])
        qdf = stark.quotient_degree_factor()
        assert (qdf - 1).bit_length() <= rate_bits, "quotient degree exceeds rate"
        trace_nat = bitrev_axis(trace_oracle.batch_merkle_tree.leaves[g], axis=0).T.contiguous()
        quotient_groups.append(compute_quotient_chunks(
            stark, nc, rate_bits, degree_bits[g], trace_nat, alphas, public_inputs_list[g], qdf
        ))
        del trace_nat

    # 3. one batch commitment across every table's quotient chunks
    quotient_oracle = BatchFriOracle.from_coeffs(quotient_groups, rate_bits, False, cap_height, device)
    ch.observe_cap(quotient_oracle.batch_merkle_tree.cap_u64())

    # 4. one zeta; per table the openings at (zeta, g_table * zeta), from
    # power tables built on the device, one read a table
    zeta = ch.get_extension_challenge(2)
    assert ge.ext_exp(zeta, 1 << degree_bits[0]) != ge.ext_one(2), "zeta in subgroup"
    openings = []
    instances = []
    for g, stark in enumerate(starks):
        g_base = gl.primitive_root_of_unity(degree_bits[g])
        trace_zeta, quotient_zeta, trace_next, _ = fo.eval_commitments_at(
            [trace_oracle.group_view(g), quotient_oracle.group_view(g)],
            zeta, ge.ext_scalar_mul(zeta, g_base),
        )
        o = StarkOpeningSet(
            local_values=trace_zeta,
            next_values=trace_next,
            auxiliary_polys=None,
            auxiliary_polys_next=None,
            ctl_zs_first=None,
            quotient_polys=quotient_zeta,
        )
        openings.append(o)
        for batch in o.to_fri_openings().batches:
            ch.observe_extension_elements(batch.values)
        instances.append(stark.fri_instance(zeta, g_base, config))

    # 5. one batched FRI argument over both batch oracles
    opening_proof = prove_batch_openings(
        degree_bits, instances, [trace_oracle, quotient_oracle], ch, fri_params
    )
    return BatchStarkProof(
        degree_bits=degree_bits,
        trace_cap=trace_oracle.batch_merkle_tree.cap_u64(),
        quotient_cap=quotient_oracle.batch_merkle_tree.cap_u64(),
        openings=openings,
        opening_proof=opening_proof,
        public_inputs=[list(p) for p in public_inputs_list],
    )


def batch_verify(starks: Sequence[Stark], config: StarkConfig, proof: BatchStarkProof) -> None:
    """Replay the transcript, check each table's vanishing identity at
    zeta, then verify the batched FRI argument against both caps."""
    degree_bits = proof.degree_bits
    nc = config.num_challenges
    fri_params = config.fri_params(degree_bits[0])

    ch = Challenger()
    _observe_head(ch, config, proof.public_inputs, proof.trace_cap)
    all_alphas = []
    for g, stark in enumerate(starks):
        alphas_prime = ch.get_n_challenges(nc)
        all_alphas.append(
            run_binding_step(stark, ch, proof.public_inputs[g], alphas_prime, degree_bits[g])
        )
    ch.observe_cap(proof.quotient_cap)
    zeta = ch.get_extension_challenge(2)

    instances = []
    openings_list = []
    for g, stark in enumerate(starks):
        o = proof.openings[g]
        if len(o.local_values) != stark.num_columns() or len(
            o.quotient_polys
        ) != nc * stark.quotient_degree_factor():
            raise StarkVerificationError("malformed opening set shape")
        eval_vanishing_and_check(
            stark, config, o, zeta, all_alphas[g], degree_bits[g], proof.public_inputs[g]
        )
        for batch in o.to_fri_openings().batches:
            ch.observe_extension_elements(batch.values)
        instances.append(stark.fri_instance(zeta, gl.primitive_root_of_unity(degree_bits[g]), config))
        openings_list.append(o.to_fri_openings())

    challenges = fri_challenges(
        ch,
        proof.opening_proof.commit_phase_merkle_caps,
        proof.opening_proof.final_poly,
        proof.opening_proof.pow_witness,
        degree_bits[0],
        fri_params.config,
    )
    lde_heights = [d + fri_params.config.rate_bits for d in degree_bits]
    verify_batch_fri_proof(
        degree_bits,
        instances,
        openings_list,
        challenges,
        [proof.trace_cap, proof.quotient_cap],
        [lde_heights, lde_heights],
        proof.opening_proof,
        fri_params,
    )


def eval_vanishing_and_check(
    stark, config, openings, zeta, alphas, degree_bits, public_inputs
) -> None:
    """sum_i alpha_i * C_i(zeta) must equal Z_H(zeta) * Q(zeta) with Q
    recombined from its degree-n chunks (verifier.rs:150-205)."""
    zeta_pow_n = ge.ext_exp(zeta, 1 << degree_bits)
    zh_zeta = ge.ext_sub(zeta_pow_n, ge.ext_one(2))
    vanishing = eval_vanishing_at_point(stark, openings, public_inputs, alphas, zeta, degree_bits)
    qdf = stark.quotient_degree_factor()
    for i in range(config.num_challenges):
        chunks = openings.quotient_polys[i * qdf : (i + 1) * qdf]
        acc = ge.ext_zero(2)
        for c in reversed(chunks):
            acc = ge.ext_add(ge.ext_mul(acc, zeta_pow_n), c)
        if ge.ext_mul(zh_zeta, acc) != tuple(vanishing[i]):
            raise StarkVerificationError(f"vanishing identity failed for challenge {i}")

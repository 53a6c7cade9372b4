"""In-circuit verification of batch-STARK proofs: the full
stark/batch_prover.py transcript replayed inside a plonky2 circuit —
per-table constraint binding, vanishing identities at zeta, and one
batched FRI argument against the two shared BatchMerkleTree caps
(reference capability: plonky2/src/batch_fri/recursive_verifier.rs,
here wired to whole STARK tables rather than raw oracles;
plonky2_tpu/stark/batch_recursive_verifier.py). Gadget code only: it
builds a circuit and launches nothing on a device."""

from __future__ import annotations

from typing import List, Sequence

from ..field import goldilocks as gl
from ..fri.batch_recursive_verifier import verify_batch_fri_proof_circuit
from ..fri.recursive_verifier import FriInstanceInfoTarget, fri_challenges_circuit
from ..hash.recursive_challenger import RecursiveChallenger
from ..plonk.proof_target import _set_cap, _set_exts, add_virtual_cap, add_virtual_fri_proof
from .config import StarkConfig
from .recursive_verifier import (
    _eval_vanishing_circuit,
    _observe_config,
    binding_step_circuit,
)
from .stark import Stark


class BatchStarkProofTarget:
    """Targets mirroring BatchStarkProof: two caps, per-table openings
    (local/next/quotient extension targets), one FRI proof target."""

    def __init__(self, trace_cap, quotient_cap, openings, opening_proof, public_inputs):
        self.trace_cap = trace_cap
        self.quotient_cap = quotient_cap
        self.openings = openings  # list of (local, next, quotient) ext target lists
        self.opening_proof = opening_proof
        self.public_inputs = public_inputs  # per table list of targets


def _refuse_lookups(stark: Stark) -> None:
    if stark.uses_lookups() or stark.requires_ctls():
        raise NotImplementedError(
            "batch STARKs with lookups or cross-table lookups are refused: the JAX "
            "package's batch prover refuses lookups too and has no CTL path"
        )


def add_virtual_batch_stark_proof(
    builder, starks: Sequence[Stark], config: StarkConfig, degree_bits: List[int]
) -> BatchStarkProofTarget:
    for s in starks:
        _refuse_lookups(s)
    nc = config.num_challenges
    fri_params = config.fri_params(degree_bits[0])
    trace_cap = add_virtual_cap(builder, config.fri_config.cap_height)
    quotient_cap = add_virtual_cap(builder, config.fri_config.cap_height)

    class _Shim:
        pass

    shim = _Shim()
    shim.fri_params = fri_params
    widths = [
        sum(s.num_columns() for s in starks),
        sum(nc * s.quotient_degree_factor() for s in starks),
    ]
    opening_proof = add_virtual_fri_proof(builder, shim, widths=widths)

    openings = []
    pis = []
    for s in starks:
        openings.append(
            (
                builder.add_virtual_extension_targets(s.num_columns()),
                builder.add_virtual_extension_targets(s.num_columns()),
                builder.add_virtual_extension_targets(nc * s.quotient_degree_factor()),
            )
        )
        pis.append(builder.add_virtual_targets(s.num_public_inputs()))
    return BatchStarkProofTarget(trace_cap, quotient_cap, openings, opening_proof, pis)


def verify_batch_stark_proof_circuit(
    builder,
    starks: Sequence[Stark],
    proof_t: BatchStarkProofTarget,
    config: StarkConfig,
    degree_bits: List[int],
) -> None:
    nc = config.num_challenges
    fri_params = config.fri_params(degree_bits[0])

    ch = RecursiveChallenger(builder)
    _observe_config(builder, ch, config)
    for pis_t in proof_t.public_inputs:
        ch.observe_elements(pis_t)
    ch.observe_cap(proof_t.trace_cap)

    all_alphas = []
    for g, stark in enumerate(starks):
        all_alphas.append(
            binding_step_circuit(
                builder, ch, stark, config, degree_bits[g], proof_t.public_inputs[g]
            )
        )
    ch.observe_cap(proof_t.quotient_cap)
    zeta = ch.get_extension_challenge()

    instances_t = []
    opening_batches_list = []
    one = builder.one_extension()
    for g, stark in enumerate(starks):
        local_t, next_t, quotient_t = proof_t.openings[g]
        # vanishing identity at zeta for this table
        vanishing = _eval_vanishing_circuit(
            builder, stark, config, degree_bits[g],
            list(local_t), list(next_t), proof_t.public_inputs[g],
            [builder.convert_to_ext(a) for a in all_alphas[g]], zeta,
        )
        zeta_pow_deg = builder.exp_power_of_2_extension(zeta, degree_bits[g])
        z_h_zeta = builder.sub_extension(zeta_pow_deg, one)
        qdf = stark.quotient_degree_factor()
        for i in range(nc):
            chunk = quotient_t[i * qdf : (i + 1) * qdf]
            acc = builder.eval_ext_poly_at(list(chunk), zeta_pow_deg)
            builder.connect_extension(
                vanishing[i], builder.mul_extension(z_h_zeta, acc)
            )

        zeta_batch = list(local_t) + list(quotient_t)
        next_batch = list(next_t)
        ch.observe_extension_elements(zeta_batch)
        ch.observe_extension_elements(next_batch)

        g_base = gl.primitive_root_of_unity(degree_bits[g])
        static_instance = stark.fri_instance((0, 0), g_base, config)
        zeta_next = builder.constant_scalar_mul_ext(g_base, zeta)
        instances_t.append(
            FriInstanceInfoTarget(
                static_info=static_instance, batch_points=[zeta, zeta_next]
            )
        )
        opening_batches_list.append([zeta_batch, next_batch])

    fri_ch = fri_challenges_circuit(
        builder, ch,
        proof_t.opening_proof.commit_phase_merkle_caps,
        proof_t.opening_proof.final_poly,
        proof_t.opening_proof.pow_witness,
        fri_params.config,
    )
    verify_batch_fri_proof_circuit(
        builder,
        degree_bits,
        instances_t,
        opening_batches_list,
        fri_ch,
        [proof_t.trace_cap, proof_t.quotient_cap],
        proof_t.opening_proof,
        fri_params,
    )


def set_batch_stark_proof_target(pw, proof_t: BatchStarkProofTarget, proof) -> None:
    """Fill a BatchStarkProofTarget from a concrete BatchStarkProof."""
    _set_cap(pw, proof_t.trace_cap, proof.trace_cap)
    _set_cap(pw, proof_t.quotient_cap, proof.quotient_cap)
    for (local_t, next_t, quotient_t), o in zip(proof_t.openings, proof.openings):
        _set_exts(pw, local_t, o.local_values)
        _set_exts(pw, next_t, o.next_values)
        _set_exts(pw, quotient_t, o.quotient_polys)
    for pis_t, pis in zip(proof_t.public_inputs, proof.public_inputs):
        for t, v in zip(pis_t, pis):
            pw.set_target(t, int(v) % gl.P)
    fp_t = proof_t.opening_proof
    fp = proof.opening_proof
    for cap_t, cap in zip(fp_t.commit_phase_merkle_caps, fp.commit_phase_merkle_caps):
        _set_cap(pw, cap_t, cap)
    for round_t, rnd in zip(fp_t.query_round_proofs, fp.query_round_proofs):
        for (et, mt), (ev, mp) in zip(
            round_t.initial_trees_proof.evals_proofs,
            rnd.initial_trees_proof.evals_proofs,
        ):
            for t, v in zip(et, ev):
                pw.set_target(t, int(v))
            for sib_t, sib in zip(mt.siblings, mp.siblings):
                for t, v in zip(sib_t, sib):
                    pw.set_target(t, int(v))
        for step_t, step in zip(round_t.steps, rnd.steps):
            _set_exts(pw, step_t.evals, step.evals)
            for sib_t, sib in zip(
                step_t.merkle_proof.siblings, step.merkle_proof.siblings
            ):
                for t, v in zip(sib_t, sib):
                    pw.set_target(t, int(v))
    _set_exts(pw, fp_t.final_poly, fp.final_poly)
    pw.set_target(fp_t.pow_witness, int(fp.pow_witness))

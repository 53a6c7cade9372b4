"""Device-transcript prover: everything of prove() after the witness, with
the Fiat-Shamir transcript on the device and no host read until the proof
is assembled (reference: plonky2_tpu/plonk/device_transcript.py).

The host transcript (plonk/prover.py) reads every commitment's cap back
to draw the next challenges, and the openings to observe them. Here the
challenger is a DeviceChallenger whose sponge state never leaves the
device: the permutation argument and the quotient take their challenges
as device tensors, the openings are evaluated at a device zeta with power
tables built on the device (gf.ext2_powers_scan), the reduction to the
final polynomial takes a device alpha, and the FRI proof runs in its fused
form (fri/prover._fused_fri_proof), whose one transfer also carries the
three caps and the openings. The host reads that transfer and one flag a
PoW chunk, nothing else. The proofs are the host path's, byte for byte.

Each step is a plain eager function (the reference compiles each
Fiat-Shamir boundary into one XLA program); observations are vectors, so
a duplex is a slice write and one [1, 12] permutation, never a launch a
scalar.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import extension as ge
from ..field import goldilocks as gl
from ..fri import oracle as fo
from ..fri import prover as fri_prover
from ..hash.challenger import Challenger
from ..hash.device_challenger import DeviceChallenger
from ..ops import fri_kernels as fk
from ..ops import gf
from ..utils import profiling as prof
from .circuit_data import (
    ORACLE_BLINDING,
    ORACLE_QUOTIENT,
    ORACLE_WIRES,
    ORACLE_ZS_PARTIAL_PRODUCTS,
)
from .proof import Proof, ProofWithPublicInputs
from .vanishing import NUM_COINS_LOOKUP


def eligible(common, gc) -> bool:
    """Whether prove() may run the transcript on the device: a Poseidon
    hasher (the device challenger's permutation), with or without lookups
    and zero knowledge, with or without a prover mesh — under a mesh the
    commitments and the quotient this prover calls shard themselves, and
    the transcript and the fused FRI run on the proof's device, as the
    reference composes them (plonky2_tpu/plonk/device_transcript.py:66-78,
    its fused SPMD FRI on by default)."""
    return gc.hasher.name == "poseidon"


def _observe_cap_and_draw(dc: DeviceChallenger, cap: torch.Tensor, n: int) -> torch.Tensor:
    """One Fiat-Shamir boundary: observe a commitment's cap [m, 4], draw n
    challenges [n]."""
    dc.observe_cap_rows(cap)
    return dc.get_n_challenges(n)


def _ext2_pow_static(x: torch.Tensor, e: int) -> torch.Tensor:
    """x^e for a shape-(2,) extension tensor and a host exponent."""
    result = gf.ext2_const((1, 0), x.device)
    base = x
    while e:
        if e & 1:
            result = gf.ext2_mul(result, base)
        e >>= 1
        if e:
            base = gf.ext2_mul(base, base)
    return result


def _reduce_openings_device(instance, oracles, alpha: torch.Tensor, points) -> torch.Tensor:
    """fri/oracle.reduce_openings_to_final_poly with alpha and the batch
    points as device tensors [2]. Every opening expression of a PLONK
    proof is a single polynomial, so a batch's weights are the powers of
    alpha."""
    final = None
    for batch, point in zip(instance.batches, points):
        openings = batch.openings
        apows = gf.ext2_powers_scan(alpha, len(openings))  # [m, 2]
        by_oracle = {}
        for k, expr in enumerate(openings):
            if not expr.is_single:
                raise ValueError("the device reduction takes single-polynomial openings")
            t = expr.terms[0].polynomial
            by_oracle.setdefault(t.oracle_index, []).append((t.polynomial_index, k))
        comp = None
        for oi, items in sorted(by_oracle.items()):
            items.sort()
            part = fo.compose_polys(oracles[oi], [pi for pi, _ in items],
                                    fo.take_rows(apows, [k for _, k in items]))
            comp = part if comp is None else gf.add(comp, part)
        quotient = fk.divide_by_linear_ext(comp, point)
        if final is None:
            final = quotient
        else:
            final = fo._shift_accumulate(final, quotient, _ext2_pow_static(alpha, len(openings)))
    return final


def _open_reduce(dc: DeviceChallenger, common, oracles):
    """The openings phase: observe the quotient cap, draw zeta, evaluate
    every oracle at zeta and g*zeta, observe the opening set, draw the FRI
    alpha, reduce the openings to the final polynomial and LDE it. Returns
    (evals [2 * sum M, 2] as eval_commitments_at_device lays them out,
    LDE coefficients, LDE values)."""
    dc.observe_cap_rows(oracles[ORACLE_QUOTIENT].merkle_tree.cap)
    zeta = dc.get_extension_challenge()
    # no "zeta in subgroup" check: it would read zeta back (probability
    # n / p^2 that it fails)
    zeta_next = gf.mul(zeta, gl.primitive_root_of_unity(common.degree_bits))
    evals = fo.eval_commitments_at_device(oracles, zeta, zeta_next)

    # the FRI instance lists the openings in OpeningSet.to_fri_openings
    # order: the rows of evals to observe, zeta block then g*zeta block
    instance = common.get_fri_instance(ge.ext_one(2))  # structure only
    offsets = [int(x) for x in np.cumsum([0] + [o.num_polys for o in oracles])]
    rows = [
        b * offsets[-1] + offsets[t.oracle_index] + t.polynomial_index
        for b, batch in enumerate(instance.batches)
        for t in (expr.terms[0].polynomial for expr in batch.openings)
    ]
    dc.observe_elements(fo.take_rows(evals, rows))
    alpha = dc.get_extension_challenge()
    final = _reduce_openings_device(instance, oracles, alpha, [zeta, zeta_next])
    lde_coeffs, lde_values = fo.final_poly_lde(final, common.fri_params.lde_size)
    return evals, lde_coeffs, lde_values


def prove_device_transcript(
    prover_data, common, witness, public_inputs, public_inputs_hash, gc, device
) -> ProofWithPublicInputs:
    """Steps 2-7 of prove() with the transcript on the device; the same
    proof as the host path, byte for byte."""
    # the steps shared with the host path are looked up at call time, so a
    # profiler can wrap them in their modules
    from . import prover as pr

    config = common.config
    nc = config.num_challenges
    fri_config = config.fri_config
    hasher = gc.hasher
    zk = config.zero_knowledge

    def commit(make, values, oracle):
        return make(
            values, fri_config.rate_bits, zk and ORACLE_BLINDING[oracle],
            fri_config.cap_height, hasher=hasher, device=device,
        )

    wires_dev = gf.from_u64(witness.wire_values, device)  # [num_wires, n]
    with prof.annotate("prove/commit-wires"):
        wires_commitment = commit(fo.PolynomialBatch.from_values, wires_dev, ORACLE_WIRES)

    # the preamble is config and circuit values only: hashed on the host
    host_ch = Challenger(permutation=hasher.permutation)
    common.fri_params.observe(host_ch)
    host_ch.observe_hash(prover_data.circuit_digest)
    host_ch.observe_hash(public_inputs_hash)
    dc = DeviceChallenger.from_host(host_ch, device)

    # boundary 1: betas ++ gammas (++ the extra lookup coins: deltas =
    # betas ++ gammas ++ additional, prover.rs:232-245 order)
    has_lookup = common.num_lookup_polys != 0
    bg = _observe_cap_and_draw(
        dc, wires_commitment.merkle_tree.cap, (NUM_COINS_LOOKUP if has_lookup else 2) * nc
    )
    betas, gammas = bg[:nc], bg[nc : 2 * nc]
    deltas = bg if has_lookup else None
    with prof.annotate("prove/zs-partial-products"):
        zs_pp = pr._zs_and_partial_products(wires_dev, betas, gammas, prover_data, common)
    if has_lookup:
        zs_pp = torch.cat([zs_pp, pr._lookup_polys_device(wires_dev, deltas, prover_data, common)])
    zs_pp_commitment = commit(
        fo.PolynomialBatch.from_values, zs_pp, ORACLE_ZS_PARTIAL_PRODUCTS
    )
    alphas = _observe_cap_and_draw(dc, zs_pp_commitment.merkle_tree.cap, nc)
    with prof.annotate("prove/quotient"):
        quotient_chunks = pr._compute_quotient_polys(
            common, prover_data, public_inputs_hash, wires_commitment, zs_pp_commitment,
            betas, gammas, alphas, deltas,
        )
    quotient_commitment = commit(
        fo.PolynomialBatch.from_coeffs, quotient_chunks, ORACLE_QUOTIENT
    )

    oracles = [
        prover_data.constants_sigmas_commitment,
        wires_commitment,
        zs_pp_commitment,
        quotient_commitment,
    ]
    evals, lde_coeffs, lde_values = _open_reduce(dc, common, oracles)

    # the caps and the openings ride on the FRI proof's one transfer
    caps = [o.merkle_tree.cap for o in oracles[1:]]
    extra = torch.cat([c.reshape(-1) for c in caps] + [evals.reshape(-1)])
    with prof.annotate("prove/fri"):
        opening_proof, words = fri_prover._fused_fri_proof(
            [o.merkle_tree for o in oracles], lde_coeffs, lde_values, dc.export(),
            common.fri_params, extra_flat=extra,
        )
    cap_words = caps[0].numel()
    caps_np = [words[i * cap_words : (i + 1) * cap_words].reshape(-1, 4) for i in range(3)]
    openings = pr._opening_set(
        common, fo.split_evals(words[3 * cap_words :].reshape(-1, 2), oracles)
    )
    proof = Proof(
        wires_cap=caps_np[0],
        plonk_zs_partial_products_cap=caps_np[1],
        quotient_polys_cap=caps_np[2],
        openings=openings,
        opening_proof=opening_proof,
    )
    return ProofWithPublicInputs(proof, public_inputs)

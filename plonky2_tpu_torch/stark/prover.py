"""STARK prover, single table (reference: starky/src/prover.rs:39-480;
plonky2_tpu/stark/prover.py).

Trace commit -> constraint binding -> quotient over the LDE coset on the
device -> quotient commit -> openings at zeta and g*zeta -> FRI. Reuses
the PLONK machinery: PolynomialBatch oracles and fri prove_openings.
Lookups, cross-table lookups and zero knowledge are not ported yet
(ROADMAP A14) and are refused.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..field import extension as ge
from ..field import goldilocks as gl
from ..fri import oracle as fo
from ..gates.algebra import DeviceBatchAlgebra
from ..hash.challenger import Challenger
from ..ops import gf, ntt
from ..plonk.prover import _natural_order_values
from .config import StarkConfig
from .proof import StarkOpeningSet, StarkProof, StarkProofWithPublicInputs
from .stark import ConstraintConsumer, Stark, StarkFrame
from .vanishing import eval_vanishing_generic, run_binding_step

_COSET_CONSTANTS = {}


def _coset_points(lde_log: int, device) -> torch.Tensor:
    """shift * w^i for i < 2^lde_log (w the primitive 2^lde_log-th root),
    natural order, built on the device from two short power tables:
    w^i = (w^N1)^(i2) * w^(i1) over the row-major [N2, N1] view."""
    n1_log, n2_log = ntt._split_logs(lde_log)
    w = gl.primitive_root_of_unity(lde_log)
    shift = np.uint64(gl.MULTIPLICATIVE_GROUP_GENERATOR)
    row = gf.from_u64(gl.np_mul(shift, gl.np_powers(w, 1 << n1_log)), device)
    col = gf.from_u64(gl.np_powers(gl.gexp(w, 1 << n1_log), 1 << n2_log), device)
    return gf.mul(col[:, None], row[None, :]).reshape(-1)


def _stark_coset_constants(degree_bits: int, rate_bits: int, device):
    """(xs, zh_inv, l_first, l_last, z_last) over the full-rate coset, as
    tensors of 2^(degree_bits + rate_bits) values on ``device``;
    witness-independent, so cached per (degree_bits, rate_bits, device).

    Z_H(x) = x^n - 1 takes 2^rate_bits distinct values on the coset, which
    are inverted on the host and tiled; the two Lagrange denominators
    n (x - 1) and n (g x - 1) are inverted by one device batch inversion
    each (the reference does all three as host numpy batch inverses)."""
    key = (degree_bits, rate_bits, str(device))
    if key in _COSET_CONSTANTS:
        return _COSET_CONSTANTS[key]
    n = 1 << degree_bits
    lde_n = n << rate_bits
    xs = _coset_points(degree_bits + rate_bits, device)
    g_pow_n = gl.gexp(gl.MULTIPLICATIVE_GROUP_GENERATOR, n)
    zh_period = gl.np_sub(
        gl.np_mul(np.uint64(g_pow_n), gl.two_adic_subgroup(rate_bits)), np.uint64(1)
    )
    reps = lde_n >> rate_bits
    zh = gf.from_u64(zh_period, device).repeat(reps)
    zh_inv = gf.from_u64(gl.np_batch_inverse(zh_period), device).repeat(reps)
    one = gf.full((1,), 1, device)
    g = gl.primitive_root_of_unity(degree_bits)
    l_first = gf.mul(zh, gf.batch_inverse(gf.mul_const(gf.sub(xs, one), n)))
    l_last = gf.mul(
        zh, gf.batch_inverse(gf.mul_const(gf.sub(gf.mul_const(xs, g), one), n))
    )
    z_last = gf.sub(xs, gf.full((1,), gl.gexp(g, n - 1), device))
    out = (xs, zh_inv, l_first, l_last, z_last)
    _COSET_CONSTANTS[key] = out
    return out


def _quotient_values(
    stark: Stark,
    rate_bits: int,
    trace_nat: torch.Tensor,
    z_last: torch.Tensor,
    l_first: torch.Tensor,
    l_last: torch.Tensor,
    zh_inv: torch.Tensor,
    alphas: List[int],
    public_inputs: List[int],
) -> torch.Tensor:
    """The combined constraints divided by Z_H at every coset point:
    [nc, lde_n]. trace_nat: natural-order coset LDE values [C, lde_n]; the
    next row of point i is point i + 2^rate_bits."""
    b = trace_nat.shape[1]
    device = trace_nat.device
    A = DeviceBatchAlgebra(b, device)
    next_step = 1 << rate_bits
    local = [trace_nat[i] for i in range(trace_nat.shape[0])]
    nxt = [torch.roll(trace_nat[i], -next_step, dims=-1) for i in range(trace_nat.shape[0])]

    def broadcast(values):
        return [gf.full((1,), v, device).expand(b) for v in values]

    frame = StarkFrame(local, nxt, broadcast([p % gl.P for p in public_inputs]))
    consumer = ConstraintConsumer(A, broadcast(alphas), z_last, l_first, l_last)
    eval_vanishing_generic(stark, frame, consumer, A)
    return torch.stack([gf.mul(acc, zh_inv) for acc in consumer.accumulators()])


def compute_quotient_chunks(
    stark: Stark,
    nc: int,
    rate_bits: int,
    degree_bits: int,
    trace_nat: torch.Tensor,
    alphas: List[int],
    public_inputs: List[int],
    qdf: int,
) -> torch.Tensor:
    """Evaluate the combined constraint quotient over the full-rate coset
    and split it into qdf degree-n coefficient chunks per challenge
    (prover.rs:290-350): [nc * qdf, n]."""
    n = 1 << degree_bits
    _, zh_inv, l_first, l_last, z_last = _stark_coset_constants(
        degree_bits, rate_bits, trace_nat.device
    )
    q = _quotient_values(
        stark, rate_bits, trace_nat, z_last, l_first, l_last, zh_inv, alphas, public_inputs
    )
    coeffs = ntt.coset_ifft(q)  # [nc, lde_n]
    return coeffs.reshape(nc, 1 << rate_bits, n)[:, :qdf].reshape(nc * qdf, n)


def verifier_circuit_padding(verifier_circuit_fri_params):
    """(final_poly_coeff_len, max_num_query_steps) so the FRI transcript
    is padded to the shape a unified multi-degree recursive verifier was
    built for (starky/src/prover.rs:61-76; plonky2/src/fri/prover.rs:78)."""
    if verifier_circuit_fri_params is None:
        return None, None
    db = verifier_circuit_fri_params.degree_bits
    for ab in verifier_circuit_fri_params.reduction_arity_bits:
        db -= ab
    return 1 << db, len(verifier_circuit_fri_params.reduction_arity_bits)


def prove(
    stark: Stark,
    config: StarkConfig,
    trace: np.ndarray,  # u64 [num_columns, degree]
    public_inputs: List[int],
    verifier_circuit_fri_params=None,
    zero_knowledge: bool = False,
    device=None,
) -> StarkProofWithPublicInputs:
    """Single-table proof (prover.rs:39-113): commit the trace, start the
    transcript, delegate to prove_with_commitment. device=None means the
    GPU (raises without one); the CPU only when asked for by name.

    verifier_circuit_fri_params: the (max-degree) FriParams of a unified
    recursive verifier circuit that will consume this proof; pads the FRI
    transcript with zero caps and zero final-poly coefficients so that one
    circuit verifies proofs of any supported degree."""
    if zero_knowledge:
        raise NotImplementedError(
            "zero-knowledge STARK proofs (Z_H-masked trace, salted leaves) "
            "are not ported yet: ROADMAP A14"
        )
    if stark.uses_lookups() or stark.requires_ctls():
        raise NotImplementedError(
            "STARK lookups and cross-table lookups are not ported yet: ROADMAP A14"
        )
    device = gf.resolve_device(device)
    trace = np.asarray(trace, dtype=np.uint64)
    trace_commitment = fo.PolynomialBatch.from_values(
        trace, config.fri_config.rate_bits, False, config.fri_config.cap_height,
        device=device,
    )
    challenger = Challenger()
    challenger.observe_elements([p % gl.P for p in public_inputs])
    config.observe(challenger)
    challenger.observe_cap(trace_commitment.cap_u64())
    return prove_with_commitment(
        stark, config, trace, trace_commitment, challenger, public_inputs,
        verifier_circuit_fri_params=verifier_circuit_fri_params,
    )


def prove_with_commitment(
    stark: Stark,
    config: StarkConfig,
    trace: np.ndarray,
    trace_commitment: fo.PolynomialBatch,
    challenger: Challenger,
    public_inputs: List[int],
    verifier_circuit_fri_params=None,
) -> StarkProofWithPublicInputs:
    """Proof body after the trace cap has been observed (prover.rs:124-460)
    for a STARK without lookups or cross-table lookups. The config must
    already have been observed by the caller."""
    fri_config = config.fri_config
    rate_bits = fri_config.rate_bits
    cap_height = fri_config.cap_height
    nc = config.num_challenges

    num_cols, degree = trace.shape
    assert num_cols == stark.num_columns()
    degree_bits = degree.bit_length() - 1
    assert 1 << degree_bits == degree
    fri_params = fri_config.fri_params(degree_bits, leaf_hiding=False)
    qdf = stark.quotient_degree_factor()
    assert (qdf - 1).bit_length() <= rate_bits, "quotient degree exceeds rate"

    alphas_prime = challenger.get_n_challenges(nc)
    alphas = run_binding_step(stark, challenger, public_inputs, alphas_prime, degree_bits)

    # quotient over the full-rate coset
    trace_nat = _natural_order_values(trace_commitment)
    chunks = compute_quotient_chunks(
        stark, nc, rate_bits, degree_bits, trace_nat, alphas, public_inputs, qdf
    )
    del trace_nat
    quotient_commitment = fo.PolynomialBatch.from_coeffs(
        chunks, rate_bits, False, cap_height
    )
    challenger.observe_cap(quotient_commitment.cap_u64())

    # openings
    zeta = challenger.get_extension_challenge(2)
    assert ge.ext_exp(zeta, 1 << degree_bits) != ge.ext_one(2), "zeta in subgroup"
    g_base = gl.primitive_root_of_unity(degree_bits)
    zeta_next = ge.ext_scalar_mul(zeta, g_base)
    # [trace, quotient] at zeta, then at g*zeta, in one pass
    trace_zeta, quotient_zeta, trace_next, _ = fo.eval_commitments_at(
        [trace_commitment, quotient_commitment], zeta, zeta_next
    )
    openings = StarkOpeningSet(
        local_values=trace_zeta,
        next_values=trace_next,
        auxiliary_polys=None,
        auxiliary_polys_next=None,
        ctl_zs_first=None,
        quotient_polys=quotient_zeta,
    )
    for batch in openings.to_fri_openings().batches:
        challenger.observe_extension_elements(batch.values)

    instance = stark.fri_instance(zeta, g_base, config)
    if verifier_circuit_fri_params is not None:
        assert verifier_circuit_fri_params.config == fri_params.config, (
            "unified verifier circuit must share the FriConfig"
        )
    fpcl, mnqs = verifier_circuit_padding(verifier_circuit_fri_params)
    opening_proof = fo.prove_openings(
        instance, [trace_commitment, quotient_commitment], challenger, fri_params,
        final_poly_coeff_len=fpcl, max_num_query_steps=mnqs,
    )
    proof = StarkProof(
        trace_cap=trace_commitment.cap_u64(),
        auxiliary_polys_cap=None,
        quotient_polys_cap=quotient_commitment.cap_u64(),
        openings=openings,
        opening_proof=opening_proof,
    )
    return StarkProofWithPublicInputs(proof, [p % gl.P for p in public_inputs])

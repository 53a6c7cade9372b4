"""STARK prover, single table (reference: starky/src/prover.rs:39-480;
plonky2_tpu/stark/prover.py).

Trace commit -> (logUp / CTL helper and Z columns, committed as one
auxiliary oracle) -> constraint binding -> quotient over the LDE coset on
the device -> quotient commit -> openings at zeta and g*zeta (and the CTL
Zs at 1) -> FRI. Reuses the PLONK machinery: PolynomialBatch oracles and
fri prove_openings. Zero knowledge masks the trace as
T' = T - R + X^n R and salts the trace and quotient oracles.

The auxiliary columns are built on the trace's device from the trace
tensor (stark/lookup.py, stark/cross_table_lookup.py); none of their
2^n-row columns comes back to the host.
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
from .cross_table_lookup import build_ctl_check_vars
from .lookup import (
    GrandProductChallenge,
    LookupCheckVars,
    all_lookup_helper_columns,
    get_grand_product_challenge_set,
)
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
    aux_nat: torch.Tensor = None,
    lookup_challenges: List[int] = None,
    ctl_entries=None,
    ctl_challenges=None,
    num_lookup_columns: int = 0,
) -> torch.Tensor:
    """The combined constraints divided by Z_H at every coset point:
    [nc, lde_n]. trace_nat (and aux_nat, the auxiliary oracle's): natural-
    order coset LDE values [C, lde_n]; the next row of point i is point
    i + 2^rate_bits."""
    b = trace_nat.shape[1]
    device = trace_nat.device
    A = DeviceBatchAlgebra(b, device)
    next_step = 1 << rate_bits

    def rows(nat):
        local = [nat[i] for i in range(nat.shape[0])]
        nxt = [torch.roll(nat[i], -next_step, dims=-1) for i in range(nat.shape[0])]
        return local, nxt

    def broadcast(values):
        return [gf.full((1,), v, device).expand(b) for v in values]

    local, nxt = rows(trace_nat)
    frame = StarkFrame(local, nxt, broadcast([p % gl.P for p in public_inputs]))
    consumer = ConstraintConsumer(A, broadcast(alphas), z_last, l_first, l_last)
    lookup_vars = ctl_vars = None
    if aux_nat is not None:
        aux_local, aux_next = rows(aux_nat)
        if lookup_challenges is not None:
            lookup_vars = LookupCheckVars(aux_local, aux_next, broadcast(lookup_challenges))
        if ctl_entries:
            challenge_elems = [
                GrandProductChallenge(*broadcast([c.beta, c.gamma]))
                for c in ctl_challenges.challenges
            ]
            ctl_vars = build_ctl_check_vars(
                ctl_entries, aux_local, aux_next, num_lookup_columns, challenge_elems
            )
    eval_vanishing_generic(stark, frame, consumer, A, lookup_vars, ctl_vars)
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
    **aux,
) -> torch.Tensor:
    """Evaluate the combined constraint quotient over the full-rate coset
    and split it into qdf degree-n coefficient chunks per challenge
    (prover.rs:290-350): [nc * qdf, n]. ``aux``: the auxiliary oracle's
    values and the lookup / CTL challenges (_quotient_values); zero
    knowledge passes one chunk more a challenge (qdf + 1), which absorbs
    the mask's degree."""
    n = 1 << degree_bits
    _, zh_inv, l_first, l_last, z_last = _stark_coset_constants(
        degree_bits, rate_bits, trace_nat.device
    )
    q = _quotient_values(
        stark, rate_bits, trace_nat, z_last, l_first, l_last, zh_inv, alphas, public_inputs,
        **aux,
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


def zk_mask_degree(config: StarkConfig) -> int:
    """Degree bound for the Z_H-multiplied random mask R: every revealed
    evaluation of T' = T + Z_H*R off the subgroup (zeta, g*zeta, and one
    coset point per FRI query round) must stay simulatable, so
    deg(R) >= #revealed - 1 with slack."""
    return config.fri_config.num_query_rounds + 4


def _ctl_entries_with_challenge_idx(ctl_data, ctl_challenges):
    """Static (helper_count, columns, filters, challenge_index) per
    zs_column, matching cross_table_lookup.ctl_zs_entries ordering."""
    entries = []
    for z in ctl_data.zs_columns:
        ci = next(
            i
            for i, c in enumerate(ctl_challenges.challenges)
            if c.beta == z.challenge.beta and c.gamma == z.challenge.gamma
        )
        entries.append((len(z.helper_columns), z.columns, z.filter, ci))
    return entries


def prove(
    stark: Stark,
    config: StarkConfig,
    trace: np.ndarray,  # u64 [num_columns, degree]
    public_inputs: List[int],
    verifier_circuit_fri_params=None,
    zero_knowledge: bool = False,
    device=None,
    mask_rng: np.random.Generator = None,
) -> StarkProofWithPublicInputs:
    """Single-table proof (prover.rs:39-113): commit the trace, start the
    transcript, delegate to prove_with_commitment. device=None means the
    GPU (raises without one); the CPU only when asked for by name.

    verifier_circuit_fri_params: the (max-degree) FriParams of a unified
    recursive verifier circuit that will consume this proof; pads the FRI
    transcript with zero caps and zero final-poly coefficients so that one
    circuit verifies proofs of any supported degree.

    zero_knowledge: mask every trace column with Z_H*R (R random, degree
    zk_mask_degree(config)) committed as split low/high halves with salted
    leaves, and open via split-mask expressions
    (core/src/fri_structure.rs:76-89). R is drawn from ``mask_rng``
    (default: a fresh unseeded numpy generator, as the JAX package's); the
    salts from the PLONKY2_TPU_SALT_SEED stream (fri/oracle.py)."""
    if zero_knowledge and stark.uses_lookups():
        # the JAX package refuses this case in the same words
        raise NotImplementedError("zk starky with lookups lands later")
    device = gf.resolve_device(device)
    trace = np.asarray(trace, dtype=np.uint64)
    num_cols, degree = trace.shape
    rate_bits = config.fri_config.rate_bits
    cap_height = config.fri_config.cap_height
    trace_t = gf.from_u64(trace, device)
    zk_split = None
    if zero_knowledge:
        m = zk_mask_degree(config)
        assert m + 1 < degree, "trace too short to hide the query pattern"
        rng = mask_rng if mask_rng is not None else np.random.default_rng()
        r = rng.integers(0, gl.P, size=(num_cols, m + 1), dtype=np.uint64)
        r_pad = gf.zeros((num_cols, degree), device)
        r_pad[:, : m + 1] = gf.from_u64(r, device)
        # T' = T - R + X^n R: lows = t - R, highs = R
        lows = gf.sub(ntt.ifft(trace_t), r_pad)
        trace_commitment = fo.PolynomialBatch.from_coeffs(
            torch.cat([lows, r_pad]), rate_bits, True, cap_height, device=device
        )
        del lows, r_pad
        zk_split = degree
    else:
        trace_commitment = fo.PolynomialBatch.from_values(
            trace_t, rate_bits, False, cap_height, device=device
        )
    challenger = Challenger()
    challenger.observe_elements([p % gl.P for p in public_inputs])
    config.observe(challenger)
    challenger.observe_cap(trace_commitment.cap_u64())
    return prove_with_commitment(
        stark, config, trace_t, trace_commitment, None, None, challenger, public_inputs,
        verifier_circuit_fri_params=verifier_circuit_fri_params,
        zk_split=zk_split,
    )


def prove_with_commitment(
    stark: Stark,
    config: StarkConfig,
    trace: torch.Tensor,
    trace_commitment: fo.PolynomialBatch,
    ctl_data,  # Optional[CtlData]
    ctl_challenges,  # Optional[GrandProductChallengeSet]
    challenger: Challenger,
    public_inputs: List[int],
    verifier_circuit_fri_params=None,
    zk_split=None,
) -> StarkProofWithPublicInputs:
    """Proof body after the trace cap has been observed; supports lookups
    and cross-table lookups (prover.rs:124-460). The config must already
    have been observed by the caller. trace: [C, n] on the commitment's
    device (a numpy u64 array is uploaded there).

    zk_split: when set (= degree n), the trace commitment holds split
    low/high halves of Z_H-masked columns and the proof opens them via
    split-mask expressions; the trace and quotient oracles are salted."""
    fri_config = config.fri_config
    rate_bits = fri_config.rate_bits
    cap_height = fri_config.cap_height
    nc = config.num_challenges
    device = trace_commitment.device
    if not isinstance(trace, torch.Tensor):
        trace = gf.from_u64(np.asarray(trace, dtype=np.uint64), device)

    num_cols, degree = trace.shape
    assert num_cols == stark.num_columns()
    degree_bits = degree.bit_length() - 1
    assert 1 << degree_bits == degree
    zk = zk_split is not None
    fri_params = fri_config.fri_params(degree_bits, leaf_hiding=zk)
    qdf = stark.quotient_degree_factor() + (1 if zk else 0)
    assert (qdf - 1).bit_length() <= rate_bits, "quotient degree exceeds rate"

    # the auxiliary oracle: the lookup columns (per lookup, per challenge,
    # the helpers then Z), then every CTL helper, then every CTL Z
    # (prover.rs:163-240). A table in a CTL system takes the CTL challenge
    # set for its lookups; a lookup uses only the betas.
    lookup_challenges = None
    aux_cols: List[torch.Tensor] = []
    if stark.uses_lookups():
        if ctl_challenges is not None:
            challenge_set = ctl_challenges
        else:
            challenge_set = get_grand_product_challenge_set(challenger, nc)
        lookup_challenges = [c.beta for c in challenge_set.challenges]
        aux_cols = all_lookup_helper_columns(stark, trace, lookup_challenges)
    num_lookup_columns = len(aux_cols)
    ctl_entries = None
    num_ctl_helpers = num_ctl_zs = 0
    if ctl_data is not None and ctl_data.zs_columns:
        helpers = ctl_data.ctl_helper_polys()
        zs = ctl_data.ctl_z_polys()
        num_ctl_helpers, num_ctl_zs = len(helpers), len(zs)
        aux_cols = aux_cols + helpers + zs
        ctl_entries = _ctl_entries_with_challenge_idx(ctl_data, ctl_challenges)

    aux_commitment = None
    if aux_cols:
        aux_commitment = fo.PolynomialBatch.from_values(
            torch.stack(aux_cols), rate_bits, False, cap_height, device=device
        )
        del aux_cols
        challenger.observe_cap(aux_commitment.cap_u64())

    alphas_prime = challenger.get_n_challenges(nc)
    alphas = run_binding_step(
        stark,
        challenger,
        public_inputs,
        alphas_prime,
        degree_bits,
        num_aux=0 if aux_commitment is None else aux_commitment.num_polys,
        lookup_challenges=lookup_challenges,
        num_lookup_columns=num_lookup_columns,
        ctl_entries=ctl_entries,
        ctl_challenges=ctl_challenges,
    )

    # quotient over the full-rate coset
    trace_nat = _natural_order_values(trace_commitment)
    if zk:
        # the committed halves as masked values on the coset:
        # T'(x) = low(x) + x^n * high(x); x^n = shift^n * v^i is periodic
        # with period 2^rate_bits over the natural-order LDE domain
        xn_period = gl.np_mul(
            np.uint64(gl.gexp(gl.MULTIPLICATIVE_GROUP_GENERATOR, degree)),
            gl.two_adic_subgroup(rate_bits),
        )
        xn = gf.from_u64(xn_period, device).repeat(degree)
        trace_nat = gf.add(trace_nat[:num_cols], gf.mul(trace_nat[num_cols:], xn))
    aux_nat = None if aux_commitment is None else _natural_order_values(aux_commitment)
    chunks = compute_quotient_chunks(
        stark, nc, rate_bits, degree_bits, trace_nat, alphas, public_inputs, qdf,
        aux_nat=aux_nat,
        lookup_challenges=lookup_challenges,
        ctl_entries=ctl_entries,
        ctl_challenges=ctl_challenges,
        num_lookup_columns=num_lookup_columns,
    )
    del trace_nat, aux_nat
    quotient_commitment = fo.PolynomialBatch.from_coeffs(
        chunks, rate_bits, zk, cap_height
    )
    challenger.observe_cap(quotient_commitment.cap_u64())

    # openings
    zeta = challenger.get_extension_challenge(2)
    assert ge.ext_exp(zeta, 1 << degree_bits) != ge.ext_one(2), "zeta in subgroup"
    g_base = gl.primitive_root_of_unity(degree_bits)
    zeta_next = ge.ext_scalar_mul(zeta, g_base)
    oracles = [trace_commitment]
    if aux_commitment is not None:
        oracles.append(aux_commitment)
    oracles.append(quotient_commitment)
    # every oracle at zeta, then at g*zeta, in one pass
    evals = fo.eval_commitments_at(oracles, zeta, zeta_next)
    at_zeta, at_next = evals[: len(oracles)], evals[len(oracles) :]

    def trace_values(values, point):
        if not zk:
            return values
        zn = ge.ext_exp(tuple(point), degree)
        return [
            ge.ext_add(lo, ge.ext_mul(zn, hi))
            for lo, hi in zip(values[:num_cols], values[num_cols:])
        ]

    ctl_zs_first = None
    if ctl_entries:
        aux_at_one = aux_commitment.eval_all_at_ext((1, 0))
        ctl_zs_first = [v[0] for v in aux_at_one[num_lookup_columns + num_ctl_helpers :]]
    openings = StarkOpeningSet(
        local_values=trace_values(at_zeta[0], zeta),
        next_values=trace_values(at_next[0], zeta_next),
        auxiliary_polys=at_zeta[1] if aux_commitment is not None else None,
        auxiliary_polys_next=at_next[1] if aux_commitment is not None else None,
        ctl_zs_first=ctl_zs_first,
        quotient_polys=at_zeta[-1],
    )
    for batch in openings.to_fri_openings().batches:
        challenger.observe_extension_elements(batch.values)

    instance = stark.fri_instance(
        zeta, g_base, config, num_ctl_helpers=num_ctl_helpers, num_ctl_zs=num_ctl_zs,
        zk_degree=degree if zk else 0,
    )
    if verifier_circuit_fri_params is not None:
        assert verifier_circuit_fri_params.config == fri_params.config, (
            "unified verifier circuit must share the FriConfig"
        )
    fpcl, mnqs = verifier_circuit_padding(verifier_circuit_fri_params)
    opening_proof = fo.prove_openings(
        instance, oracles, challenger, fri_params,
        final_poly_coeff_len=fpcl, max_num_query_steps=mnqs,
    )
    proof = StarkProof(
        trace_cap=trace_commitment.cap_u64(),
        auxiliary_polys_cap=None if aux_commitment is None else aux_commitment.cap_u64(),
        quotient_polys_cap=quotient_commitment.cap_u64(),
        openings=openings,
        opening_proof=opening_proof,
    )
    return StarkProofWithPublicInputs(proof, [p % gl.P for p in public_inputs])

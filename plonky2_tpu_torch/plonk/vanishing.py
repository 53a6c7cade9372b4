"""Vanishing-polynomial evaluation.

Two instantiations of the same constraint algebra (single-source gates):
  * eval_vanishing_poly_host — exact extension arithmetic at one point
    (the verifier's check at zeta; reference plonk/vanishing_poly.rs:57).
  * quotient_values_fn — the batched device evaluation of ALL
    constraints over the whole 2^(n+rate) coset at once
    (reference plonk/prover.rs:640-864 + vanishing_poly.rs:166-340,
    re-designed from a 32-point rayon batch loop into whole-domain
    tensor ops; see plonk/quotient_kernel.py).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..field import extension as ge
from ..field import goldilocks as gl
from ..gates.algebra import DeviceBatchAlgebra, EvalVars, HostExtAlgebra
from ..gates.gate import compute_filter


Ext = Tuple[int, ...]


# ---------------------------------------------------------------------------
# Shared constraint-term construction, parameterized by algebra
# ---------------------------------------------------------------------------


def _gate_constraint_terms(common, A, local_constants, local_wires, pis_hash):
    """Filtered, combined gate constraints (vanishing_poly.rs
    evaluate_gate_constraints*)."""
    si = common.selectors_info
    num_sel = si.num_selectors
    many = num_sel > 1
    gate_consts = local_constants[num_sel + common.num_lookup_selectors :]
    vars = EvalVars(gate_consts, local_wires, pis_hash)
    combined = [A.zero() for _ in range(common.num_gate_constraints)]
    device = isinstance(A, DeviceBatchAlgebra)
    for gate_idx, gate in enumerate(common.gates):
        sel = si.selector_indices[gate_idx]
        filt = compute_filter(A, gate_idx, si.groups[sel], local_constants[sel], many)
        evals = (
            gate.eval_unfiltered_device(vars, A)
            if device
            else gate.eval_unfiltered(vars, A)
        )
        for k, c in enumerate(evals):
            combined[k] = A.add(combined[k], A.mul(filt, c))
    return combined


def _chunked_products(A, values: List, chunk: int) -> List:
    out = []
    for start in range(0, len(values), chunk):
        acc = None
        for v in values[start : start + chunk]:
            acc = v if acc is None else A.mul(acc, v)
        out.append(acc)
    return out


def _partial_product_checks(A, numerators, denominators, partials, z_x, z_gx, max_degree):
    """prev_acc * prod(num chunk) - next_acc * prod(den chunk)
    (util/partial_products.rs:52-93)."""
    accs = [z_x] + list(partials) + [z_gx]
    nums = _chunked_products(A, numerators, max_degree)
    dens = _chunked_products(A, denominators, max_degree)
    assert len(nums) == len(dens) == len(accs) - 1
    return [
        A.sub(A.mul(accs[i], nums[i]), A.mul(accs[i + 1], dens[i]))
        for i in range(len(nums))
    ]


def _vanishing_terms(
    common,
    A,
    x,  # evaluation point (algebra element)
    l_0_x,
    local_constants,
    local_wires,
    pis_hash,
    local_zs,
    next_zs,
    partial_products,
    s_sigmas,
    betas,  # algebra elements (per challenge)
    gammas,
    one_const,
    local_lookup_zs=None,  # [nc * num_lookup_polys] algebra elements
    next_lookup_zs=None,
    deltas=None,  # [nc * NUM_COINS_LOOKUP] algebra elements
    lut_evals=None,  # per challenge: per lut algebra elements
):
    """Ordered term list: z1 | partial-product | lookup | gate terms
    (vanishing_poly.rs:80-160 ordering)."""
    nc = common.config.num_challenges
    num_prods = common.num_partial_products
    nr = common.config.num_routed_wires
    has_lookup = common.num_lookup_polys != 0

    constraint_terms = _gate_constraint_terms(
        common, A, local_constants, local_wires, pis_hash
    )
    si = common.selectors_info
    lookup_selectors = local_constants[
        si.num_selectors : si.num_selectors + common.num_lookup_selectors
    ]

    z1_terms = []
    pp_terms = []
    lookup_terms = []
    for i in range(nc):
        z_x = local_zs[i]
        z_gx = next_zs[i]
        z1_terms.append(A.mul(l_0_x, A.sub(z_x, one_const)))
        if has_lookup:
            nlp = common.num_lookup_polys
            lookup_terms.extend(
                _lookup_terms(
                    common,
                    A,
                    local_wires,
                    local_lookup_zs[nlp * i : nlp * (i + 1)],
                    next_lookup_zs[nlp * i : nlp * (i + 1)],
                    lookup_selectors,
                    deltas[NUM_COINS_LOOKUP * i : NUM_COINS_LOOKUP * (i + 1)],
                    lut_evals[i],
                )
            )
        numerators = []
        denominators = []
        for j in range(nr):
            wire = local_wires[j]
            s_id = A.mul_const(x, common.k_is[j])
            numerators.append(A.add(wire, A.add(A.mul(betas[i], s_id), gammas[i])))
            denominators.append(
                A.add(wire, A.add(A.mul(betas[i], s_sigmas[j]), gammas[i]))
            )
        cur_pps = partial_products[i * num_prods : (i + 1) * num_prods]
        pp_terms.extend(
            _partial_product_checks(
                A, numerators, denominators, cur_pps, z_x, z_gx,
                common.permutation_partial_product_degree(),
            )
        )
    return z1_terms + pp_terms + lookup_terms + constraint_terms



NUM_COINS_LOOKUP = 4  # ChallengeA, ChallengeB, ChallengeAlpha, ChallengeDelta


def get_lut_poly_eval(common, lut_index: int, challenge_b: int, challenge_delta: int, degree: int) -> int:
    """Host evaluation of the LUT polynomial at ChallengeDelta
    (vanishing_poly.rs:30-52): coeffs are (inp + B*out) for padded entries,
    zero-extended to `degree` and reversed."""
    from ..field import goldilocks as _gl

    lut = common.luts[lut_index]
    nb_slots = common.config.num_routed_wires // 3
    n = len(lut)
    nb_padded = (nb_slots - n % nb_slots) % nb_slots
    coeffs = [ _gl.gadd(i, _gl.gmul(challenge_b, o)) for i, o in lut ]
    coeffs += [ _gl.gadd(lut[0][0], _gl.gmul(challenge_b, lut[0][1])) ] * nb_padded
    coeffs += [0] * (degree - len(coeffs))
    # reference reverses then evaluates sum coeffs[i] * x^i; equivalently,
    # Horner over the pushed order (first entry gets the highest power)
    acc = 0
    for c in coeffs:
        acc = _gl.gadd(_gl.gmul(acc, challenge_delta), c)
    return acc


def get_lut_poly_eval_circuit(builder, common, lut_index: int, deltas4, degree: int):
    """In-circuit LUT polynomial evaluation at ChallengeDelta
    (vanishing_poly.rs:754-792): coeff_i = inp_i + B*out_i as circuit ops,
    Horner over the padded list with the first entry at the highest power.
    deltas4: the 4 per-challenge delta Targets."""
    b = deltas4[1]  # ChallengeB
    delta = deltas4[3]  # ChallengeDelta
    lut = common.luts[lut_index]
    nb_slots = common.config.num_routed_wires // 3
    n = len(lut)
    nb_padded = (nb_slots - n % nb_slots) % nb_slots
    coeffs = [
        builder.add_const(builder.mul_const(int(o), b), int(i)) for i, o in lut
    ]
    pi, po = lut[0]
    for _ in range(nb_padded):
        coeffs.append(builder.add_const(builder.mul_const(int(po), b), int(pi)))
    zero = builder.constant(0)
    coeffs += [zero] * (degree - len(coeffs))
    acc = zero
    for c in coeffs:
        acc = builder.add(builder.mul(acc, delta), c)
    return acc


def _lookup_terms(
    common,
    A,
    local_wires,
    local_lookup_zs_i,
    next_lookup_zs_i,
    lookup_selectors,
    deltas4,
    lut_evals_i,
):
    """Per-challenge lookup constraint terms, single-source over the
    algebra (vanishing_poly.rs:341-512 check_lookup_constraints)."""
    from ..gates.lookup import LookupGate, LookupTableGate

    config = common.config
    num_lu_slots = config.num_routed_wires // 2
    num_lut_slots = config.num_routed_wires // 3
    lu_degree = common.lookup_accumulator_degree()
    num_sldc = len(local_lookup_zs_i) - 1
    lut_degree = -(-num_lut_slots // num_sldc)
    dA, dB, dAlpha, dDelta = deltas4

    z_re = local_lookup_zs_i[0]
    next_z_re = next_lookup_zs_i[0]
    sldc = local_lookup_zs_i[1:]
    next_sldc = next_lookup_zs_i[1:]

    looked = [
        A.add(
            local_wires[LookupTableGate.wire_ith_looked_inp(s)],
            A.mul(dA, local_wires[LookupTableGate.wire_ith_looked_out(s)]),
        )
        for s in range(num_lut_slots)
    ]
    looking = [
        A.add(
            local_wires[LookupGate.wire_ith_looking_inp(s)],
            A.mul(dA, local_wires[LookupGate.wire_ith_looking_out(s)]),
        )
        for s in range(num_lu_slots)
    ]
    lookup_combos = [
        A.add(
            local_wires[LookupTableGate.wire_ith_looked_inp(s)],
            A.mul(dB, local_wires[LookupTableGate.wire_ith_looked_out(s)]),
        )
        for s in range(num_lut_slots)
    ]
    minus_looked = [A.sub(dAlpha, c) for c in looked]
    minus_looking = [A.sub(dAlpha, c) for c in looking]

    TRANS_SRE, TRANS_LDC, INIT_SRE, LAST_LDC = 0, 1, 2, 3
    constraints = []
    constraints.append(A.mul(lookup_selectors[LAST_LDC], sldc[num_sldc - 1]))
    constraints.append(A.mul(lookup_selectors[INIT_SRE], sldc[0]))
    constraints.append(A.mul(lookup_selectors[INIT_SRE], z_re))

    for r, lut_eval in enumerate(lut_evals_i):
        ends_sel = lookup_selectors[4 + r]
        constraints.append(A.mul(ends_sel, A.sub(z_re, lut_eval)))

    cur_sum = next_z_re
    for elt in lookup_combos:
        cur_sum = A.add(A.mul(cur_sum, dDelta), elt)
    constraints.append(
        A.mul(lookup_selectors[TRANS_SRE], A.sub(z_re, cur_sum))
    )

    for poly in range(num_sldc):
        lut_rng = range(poly * lut_degree, min((poly + 1) * lut_degree, num_lut_slots))
        lu_rng = range(poly * lu_degree, min((poly + 1) * lu_degree, num_lu_slots))

        lut_prod = None
        for i in lut_rng:
            lut_prod = minus_looked[i] if lut_prod is None else A.mul(lut_prod, minus_looked[i])
        lu_prod = None
        for i in lu_rng:
            lu_prod = minus_looking[i] if lu_prod is None else A.mul(lu_prod, minus_looking[i])
        if lut_prod is None:
            lut_prod = A.one()
        if lu_prod is None:
            lu_prod = A.one()

        def prod_except(rng, elems, skip):
            acc = None
            for j in rng:
                if j == skip:
                    continue
                acc = elems[j] if acc is None else A.mul(acc, elems[j])
            return acc if acc is not None else A.one()

        lu_sum_prods = None
        for i in lu_rng:
            t = prod_except(lu_rng, minus_looking, i)
            lu_sum_prods = t if lu_sum_prods is None else A.add(lu_sum_prods, t)
        if lu_sum_prods is None:
            lu_sum_prods = A.zero()

        lut_sum_prods_mul = None
        for i in lut_rng:
            t = A.mul(
                local_wires[LookupTableGate.wire_ith_multiplicity(i)],
                prod_except(lut_rng, minus_looked, i),
            )
            lut_sum_prods_mul = t if lut_sum_prods_mul is None else A.add(lut_sum_prods_mul, t)
        if lut_sum_prods_mul is None:
            lut_sum_prods_mul = A.zero()

        prev = next_sldc[num_sldc - 1] if poly == 0 else sldc[poly - 1]
        sum_trans = A.sub(A.mul(lut_prod, A.sub(sldc[poly], prev)), lut_sum_prods_mul)
        constraints.append(A.mul(lookup_selectors[TRANS_SRE], sum_trans))
        ldc_trans = A.add(A.mul(lu_prod, A.sub(sldc[poly], prev)), lu_sum_prods)
        constraints.append(A.mul(lookup_selectors[TRANS_LDC], ldc_trans))

    return constraints


# ---------------------------------------------------------------------------
# Host (verifier) instantiation
# ---------------------------------------------------------------------------


def eval_vanishing_poly_host(
    common,
    zeta: Ext,
    local_constants: Sequence[Ext],
    local_wires: Sequence[Ext],
    pis_hash: Sequence[int],
    local_zs: Sequence[Ext],
    next_zs: Sequence[Ext],
    partial_products: Sequence[Ext],
    s_sigmas: Sequence[Ext],
    betas: Sequence[int],
    gammas: Sequence[int],
    alphas: Sequence[int],
    local_lookup_zs: Sequence[Ext] = (),
    next_lookup_zs: Sequence[Ext] = (),
    deltas: Sequence[int] = (),
) -> List[Ext]:
    A = HostExtAlgebra()
    lut_evals = None
    if common.num_lookup_polys:
        lut_evals = []
        num_lut_slots = common.config.num_routed_wires // 3
        for i in range(common.config.num_challenges):
            d4 = deltas[NUM_COINS_LOOKUP * i : NUM_COINS_LOOKUP * (i + 1)]
            evals_i = []
            for li in range(len(common.luts)):
                rows = -(-len(common.luts[li]) // num_lut_slots)
                evals_i.append(
                    A.const(
                        get_lut_poly_eval(
                            common, li, d4[1], d4[3], num_lut_slots * rows
                        )
                    )
                )
            lut_evals.append(evals_i)
    n = common.degree
    # L_0(zeta) = (zeta^n - 1) / (n * (zeta - 1))
    zeta_pow_n = ge.ext_exp(zeta, n)
    z_h = ge.ext_sub(zeta_pow_n, ge.ext_one(2))
    l_0 = ge.ext_mul(
        z_h,
        ge.ext_inv(
            ge.ext_scalar_mul(ge.ext_sub(zeta, ge.ext_one(2)), n % gl.P)
        ),
    )
    terms = _vanishing_terms(
        common,
        A,
        zeta,
        l_0,
        list(local_constants),
        list(local_wires),
        [A.const(h) for h in pis_hash],
        list(local_zs),
        list(next_zs),
        list(partial_products),
        list(s_sigmas),
        [A.const(b) for b in betas],
        [A.const(g) for g in gammas],
        A.one(),
        local_lookup_zs=[tuple(v) for v in local_lookup_zs],
        next_lookup_zs=[tuple(v) for v in next_lookup_zs],
        deltas=[A.const(d) for d in deltas],
        lut_evals=lut_evals,
    )
    out = []
    for a in alphas:
        acc = ge.ext_zero(2)
        alpha = ge.from_base(a, 2)
        for t in reversed(terms):
            acc = ge.ext_add(ge.ext_mul(acc, alpha), t)
        out.append(acc)
    return out


# ---------------------------------------------------------------------------
# Device (prover quotient) instantiation
# ---------------------------------------------------------------------------


def quotient_values_fn(common):
    """Device quotient evaluator — see plonk/quotient_kernel.py (lazy
    import keeps this module, and with it the verifier, torch-free)."""
    from .quotient_kernel import quotient_values_fn as _qfn

    return _qfn(common)

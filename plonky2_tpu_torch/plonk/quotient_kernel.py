"""Device quotient evaluation (split from plonk/vanishing.py so that the
host verifier path stays torch-free; reference hot loop:
plonky2/src/plonk/prover.rs:640-864 compute_quotient_polys +
vanishing_poly.rs:166 eval_vanishing_poly_base_batch).

Gates are evaluated directly through the single-source constraint
algebra (gates/algebra.DeviceBatchAlgebra) over the whole quotient coset
at once; the permutation-argument terms are stacked tensor ops."""

from __future__ import annotations

import numpy as np
import torch

from ..gates.algebra import DeviceBatchAlgebra, EvalVars
from ..gates.gate import compute_filter
from ..ops import gf
from .vanishing import NUM_COINS_LOOKUP, _lookup_terms


def _gate_terms(common, cs_nat, wires_nat, pis_hash) -> torch.Tensor:
    """Filtered constraints of every gate type, padded to
    num_gate_constraints rows and summed: [num_gate_constraints, B]."""
    si = common.selectors_info
    many = si.num_selectors > 1
    consts_offset = si.num_selectors + common.num_lookup_selectors
    b = cs_nat.shape[1]
    device = cs_nat.device
    A = DeviceBatchAlgebra(b, device)
    consts_all = list(cs_nat.unbind(0))
    vars = EvalVars(
        consts_all[consts_offset:],
        list(wires_nat.unbind(0)),
        [pis_hash[i].expand(b) for i in range(4)],
    )
    total = gf.zeros((common.num_gate_constraints, b), device)
    for gate_idx, gate in enumerate(common.gates):
        if gate.num_constraints() == 0:
            continue  # NoopGate
        sel = si.selector_indices[gate_idx]
        filt = compute_filter(A, gate_idx, si.groups[sel], consts_all[sel], many)
        evals = gate.eval_unfiltered_device(vars, A)
        block = gf.mul(torch.stack(evals), filt[None])
        total[: block.shape[0]] = gf.add(total[: block.shape[0]], block)
    return total


def quotient_values_fn(common):
    """The full-domain quotient evaluator for a circuit shape. Returns
    fn(constants_sigmas_nat, wires_nat, zs_pp_nat, shifted_xs, l0, zh_inv,
    betas, gammas, alphas, pis_hash, deltas=None, lut_evals=None,
    zs_next=None) -> [nc, B]; every *_nat is
    [num_polys, B] in natural point order, the challenges are [nc]
    tensors, pis_hash is [4]. zs_next: zs_pp_nat at the next point of each
    column (the roll by the quotient degree factor); None rolls zs_pp_nat
    itself, which is right when the columns hold the whole domain. A
    point-sharded caller passes each shard's rows with the next shard's
    first columns appended (plonk/prover.py)."""
    nc = common.config.num_challenges
    next_step = common.quotient_degree_factor
    assert next_step & (next_step - 1) == 0  # a power of two in practice

    nr = common.config.num_routed_wires
    num_prods = common.num_partial_products
    chunk = common.permutation_partial_product_degree()
    k_arr = np.array(common.k_is, dtype=np.uint64)

    si = common.selectors_info
    nzs = common.num_zs_partial_products_polys()
    nlp = common.num_lookup_polys

    def _next(zs_pp_nat, zs_next, rows):
        """Rows of zs_pp_nat at the next point: zs_next's rows, or the
        rows rolled when there is no zs_next."""
        if zs_next is None:
            return torch.roll(zs_pp_nat[rows], -next_step, dims=-1)
        return zs_next[rows]

    def lookup_terms_fn(cs_nat, wires_nat, zs_pp_nat, zs_next, deltas, lut_evals):
        """The lookup argument's terms (vanishing._lookup_terms over the
        device algebra): [nc * terms a challenge, B]."""
        b = cs_nat.shape[1]
        A = DeviceBatchAlgebra(b, cs_nat.device)
        local_wires = list(wires_nat.unbind(0))
        lookup_selectors = list(
            cs_nat[si.num_selectors : si.num_selectors + common.num_lookup_selectors].unbind(0)
        )
        lzs = zs_pp_nat[nzs : nzs + nc * nlp]
        nxt = _next(zs_pp_nat, zs_next, slice(nzs, nzs + nc * nlp))
        terms = []
        for i in range(nc):
            d4 = [deltas[NUM_COINS_LOOKUP * i + k].expand(b) for k in range(NUM_COINS_LOOKUP)]
            evals_i = [lut_evals[i, li].expand(b) for li in range(len(common.luts))]
            terms.extend(
                _lookup_terms(
                    common, A, local_wires,
                    list(lzs[nlp * i : nlp * (i + 1)].unbind(0)),
                    list(nxt[nlp * i : nlp * (i + 1)].unbind(0)),
                    lookup_selectors, d4, evals_i,
                )
            )
        return torch.stack(terms)

    def qfn(cs_nat, wires_nat, zs_pp_nat, shifted_xs, l0, zh_inv, betas, gammas,
            alphas, pis_hash, deltas=None, lut_evals=None, zs_next=None):
        b = cs_nat.shape[1]
        device = cs_nat.device
        gate_terms = _gate_terms(common, cs_nat, wires_nat, pis_hash)
        if common.num_lookup_polys:
            lookup_terms = lookup_terms_fn(cs_nat, wires_nat, zs_pp_nat, zs_next, deltas, lut_evals)
        else:
            lookup_terms = gf.zeros((0, b), device)

        # --- permutation-argument terms, stacked ---------------------------
        wires_r = wires_nat[:nr]  # [nr, B]
        sigmas_r = cs_nat[common.num_constants :]
        s_id = gf.mul(gf.from_u64(k_arr, device)[:, None], shifted_xs[None])  # [nr, B]

        z1_terms = []
        pp_term_blocks = []
        for i in range(nc):
            beta, gamma = betas[i], gammas[i]
            nums = gf.add(wires_r, gf.add(gf.mul(s_id, beta), gamma))
            dens = gf.add(wires_r, gf.add(gf.mul(sigmas_r, beta), gamma))
            nums_c = gf.prod_mod_p(nums.reshape(nr // chunk, chunk, b), axis=1)
            dens_c = gf.prod_mod_p(dens.reshape(nr // chunk, chunk, b), axis=1)
            z_x = zs_pp_nat[i]
            z_gx = _next(zs_pp_nat, zs_next, i)
            pstart = nc + i * num_prods
            accs = torch.cat(
                [z_x[None], zs_pp_nat[pstart : pstart + num_prods], z_gx[None]]
            )  # [num_prods+2, B]
            pp_term_blocks.append(
                gf.sub(gf.mul(accs[:-1], nums_c), gf.mul(accs[1:], dens_c))
            )  # [nr/chunk, B]
            z1_terms.append(gf.mul(l0, gf.sub(z_x, gf.ones((b,), device))))

        terms = torch.cat(
            [torch.stack(z1_terms)] + pp_term_blocks + [lookup_terms, gate_terms]
        )  # [T, B]
        num_terms = terms.shape[0]

        out = []
        for i in range(nc):
            w = gf.powers_scan(alphas[i], num_terms)
            out.append(gf.mul(gf.weighted_sum(terms, w), zh_inv))
        return torch.stack(out)

    return qfn

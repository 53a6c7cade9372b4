"""PolynomialBatch — the FRI oracle: a batch of polynomials committed via
coset-LDE + Merkle tree, plus batch opening-proof production.

Redesign of plonky2/src/fri/oracle.rs:33-360 for a GPU: the polynomial
batch is a device-resident [num_polys, N] tensor; IFFT/LDE/transpose/
bit-reverse/Merkle are device work (ops.fri_kernels); the opening
reduction (final-poly construction) runs as extension-weighted sums and
a log-depth synthetic-division scan on device. Host code only drives the
transcript and the query-phase gathers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..field import extension as ge
from ..field import goldilocks as gl
from ..hash.challenger import Challenger
from ..ops import fri_kernels as fk
from ..ops import gf, merkle, ntt
from ..utils.bits import log2_strict, reverse_bits
from .config import FriParams
from .proof import FriProof
from .structure import FriInstanceInfo

SALT_SIZE = 4


def _on_device(x, device) -> torch.Tensor:
    """numpy u64 arrays go to ``device`` (None = the GPU); a tensor is
    taken where it lives, and must live there if a device is named."""
    if isinstance(x, torch.Tensor):
        if device is not None and x.device.type != torch.device(device).type:
            raise ValueError(f"tensor on {x.device}, but device={device!r} was asked for")
        return x
    return gf.from_u64(x, device)


@dataclass
class PolynomialBatch:
    """polynomials: device coeffs [num_polys, N]; merkle_tree leaves are
    point-major bit-reversed LDE rows [lde_n, num_polys]."""

    polynomials: torch.Tensor
    merkle_tree: merkle.DeviceMerkleTree
    degree_log: int
    rate_bits: int
    blinding: bool

    @property
    def num_polys(self) -> int:
        return self.polynomials.shape[0]

    @staticmethod
    def from_values(
        values, rate_bits: int, blinding: bool, cap_height: int, hasher=None,
        device=None,
    ) -> "PolynomialBatch":
        """values: [num_polys, N] evaluations on the subgroup, as a tensor
        or a numpy u64 array. device=None means the GPU."""
        coeffs = ntt.ifft(_on_device(values, device))
        return PolynomialBatch.from_coeffs(
            coeffs, rate_bits, blinding, cap_height, hasher=hasher, device=device
        )

    @staticmethod
    def from_coeffs(
        coeffs, rate_bits: int, blinding: bool, cap_height: int, hasher=None,
        device=None,
    ) -> "PolynomialBatch":
        coeffs = _on_device(coeffs, device)
        degree = coeffs.shape[-1]
        if blinding:
            # zk salts (oracle.rs:243-264) are not part of this slice
            raise NotImplementedError("blinded (zero-knowledge) commitments")
        tree = fk.commit(coeffs, rate_bits, cap_height, hasher=hasher)
        return PolynomialBatch(
            polynomials=coeffs,
            merkle_tree=tree,
            degree_log=log2_strict(degree),
            rate_bits=rate_bits,
            blinding=blinding,
        )

    @property
    def salt_size(self) -> int:
        return SALT_SIZE if self.blinding else 0

    def get_lde_values(self, index: int, step: int = 1) -> List[int]:
        """LDE row at point index*step (leaf order is bit-reversed,
        oracle.rs:286-292)."""
        idx = reverse_bits(index * step, self.degree_log + self.rate_bits)
        row = self.merkle_tree.leaf_u64(idx)
        return [int(x) for x in row]

    def cap_u64(self) -> np.ndarray:
        return self.merkle_tree.cap_u64()

    def eval_all_at_ext(self, zeta: Tuple[int, ...]) -> List[Tuple[int, ...]]:
        """Evaluate every polynomial at an extension point (for OpeningSet):
        p(z) = sum_i c_i z^i as two weighted sums of the coefficient
        columns with host-precomputed z-powers."""
        return eval_commitments_at([self], zeta, zeta)[0]


def ext_powers_np(zeta: Tuple[int, ...], n: int) -> np.ndarray:
    """[n, 2] u64 powers 1, z, ..., z^(n-1) by vectorized doubling:
    log2(n) numpy steps instead of n Python extension multiplies."""
    a = np.array([1], dtype=np.uint64)
    b = np.array([0], dtype=np.uint64)
    za, zb = int(zeta[0]), int(zeta[1])  # current z^len
    W = 7  # quadratic extension x^2 - 7
    while a.shape[0] < n:
        # (a + b x) * (za + zb x) = (a*za + 7 b*zb) + (a*zb + b*za) x
        na = gl.np_add(
            gl.np_mul(a, np.uint64(za)),
            gl.np_mul(np.uint64(W), gl.np_mul(b, np.uint64(zb))),
        )
        nb = gl.np_add(gl.np_mul(a, np.uint64(zb)), gl.np_mul(b, np.uint64(za)))
        a = np.concatenate([a, na])
        b = np.concatenate([b, nb])
        za, zb = ge.ext_mul((za, zb), (za, zb))
    out = np.stack([a[:n], b[:n]], axis=1)
    return out


def eval_commitments_at(
    oracles: Sequence["PolynomialBatch"], zeta, zeta_next
) -> List[List[Tuple[int, ...]]]:
    """All oracles at zeta, then all oracles at g*zeta: one list of
    extension values per (point, oracle), brought to the host in ONE
    transfer."""
    n = oracles[0].polynomials.shape[-1]
    device = oracles[0].polynomials.device
    for o in oracles:
        assert o.polynomials.shape[-1] == n
    # weights [n, 4]: columns (zeta c0, zeta c1, zeta_next c0, zeta_next c1)
    w = gf.from_u64(
        np.concatenate([ext_powers_np(zeta, n), ext_powers_np(zeta_next, n)], axis=1),
        device,
    )
    per_oracle = []
    for o in oracles:
        ct = o.polynomials.T  # [n, M]
        per_oracle.append(
            torch.stack([gf.weighted_sum(ct, w[:, k]) for k in range(4)], dim=-1)
        )  # [M, 4]
    flat = gf.to_u64(torch.cat(per_oracle, dim=0))  # [sum M, 4]
    out: List[List[Tuple[int, ...]]] = []
    for cols in ((0, 1), (2, 3)):  # zeta block, then g*zeta block
        pos = 0
        for o in oracles:
            rows = flat[pos : pos + o.num_polys]
            out.append([(int(r[cols[0]]), int(r[cols[1]])) for r in rows])
            pos += o.num_polys
    return out


def _expression_weights(
    instance: FriInstanceInfo,
    alpha: Tuple[int, ...],
) -> Tuple[List[Dict[Tuple[int, int], Tuple[int, ...]]], List[int]]:
    """Per batch: accumulated extension weight for each (oracle, poly),
    mirroring ReducingFactor bookkeeping (alpha^k per opening expression,
    expression coefficients folded in). Returns (per-batch weight maps,
    per-batch opening counts)."""
    weight_maps = []
    counts = []
    for batch in instance.batches:
        wmap: Dict[Tuple[int, int], Tuple[int, ...]] = {}
        apow = ge.ext_one(2)
        for k, expr in enumerate(batch.openings):
            for term in expr.terms:
                c = term.coefficient
                if c.kind == "one":
                    coeff = apow
                elif c.kind == "point_power":
                    coeff = ge.ext_mul(apow, ge.ext_exp(batch.point, c.power))
                else:
                    coeff = ge.ext_mul(apow, c.constant)
                key = (term.polynomial.oracle_index, term.polynomial.polynomial_index)
                wmap[key] = ge.ext_add(wmap.get(key, ge.ext_zero(2)), coeff)
            apow = ge.ext_mul(apow, alpha)
        weight_maps.append(wmap)
        counts.append(len(batch.openings))
    return weight_maps, counts


def reduce_openings_to_final_poly(
    instance: FriInstanceInfo,
    oracles: Sequence[PolynomialBatch],
    alpha: Tuple[int, ...],
) -> torch.Tensor:
    """final_poly = sum over batches of alpha-shifted linear-combination
    quotients (oracle.rs:129-165 reduce_openings_to_unmasked_final_poly).
    Returns extension coeffs [N, 2] on device."""
    n = oracles[0].polynomials.shape[-1]
    for o in oracles:
        assert o.polynomials.shape[-1] == n
    weight_maps, counts = _expression_weights(instance, alpha)

    final: Optional[torch.Tensor] = None
    for b, (wmap, cnt) in enumerate(zip(weight_maps, counts)):
        point = instance.batches[b].point
        # composition poly = sum of weighted base polys, per oracle
        comp: Optional[torch.Tensor] = None
        by_oracle: Dict[int, List[Tuple[int, Tuple[int, ...]]]] = {}
        for (oi, pi), w in wmap.items():
            by_oracle.setdefault(oi, []).append((pi, w))
        for oi, items in sorted(by_oracle.items()):
            items.sort()
            polys_all = oracles[oi].polynomials
            sel = np.array([pi for pi, _ in items], dtype=np.int64)
            weights = np.array([w for _, w in items], dtype=np.uint64)  # [k, 2]
            if np.array_equal(sel, np.arange(polys_all.shape[0])):
                polys = polys_all
            else:
                polys = polys_all[torch.from_numpy(sel).to(polys_all.device)]
            part = fk.composition_poly(polys, weights)  # [N, 2]
            comp = part if comp is None else gf.add(comp, part)
        quotient = fk.divide_by_linear_ext(comp, point)  # [N, 2]
        if final is None:
            final = quotient
        else:
            shift = ge.ext_exp(alpha, cnt)
            final = gf.add(fk.ext_poly_mul_const(final, shift), quotient)
    return final


def prove_openings(
    instance: FriInstanceInfo,
    oracles: Sequence[PolynomialBatch],
    challenger: Challenger,
    fri_params: FriParams,
    final_poly_coeff_len: Optional[int] = None,
    max_num_query_steps: Optional[int] = None,
    hasher=None,
) -> FriProof:
    """Batch opening proof (oracle.rs:320-358 prove_openings)."""
    from .prover import fri_proof  # local import to avoid cycle

    alpha = challenger.get_extension_challenge(2)
    final_poly = reduce_openings_to_final_poly(instance, oracles, alpha)

    # pad to LDE size and evaluate on the shifted coset
    lde_size = fri_params.lde_size
    n = final_poly.shape[0]
    assert n <= lde_size
    lde_coeffs = torch.cat([final_poly, gf.zeros((lde_size - n, 2), final_poly.device)])
    lde_values = fk.ext_coset_fft(lde_coeffs)

    return fri_proof(
        [o.merkle_tree for o in oracles],
        lde_coeffs,
        lde_values,
        challenger,
        fri_params,
        final_poly_coeff_len,
        max_num_query_steps,
        hasher=hasher,
    )

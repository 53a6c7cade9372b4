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

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..field import extension as ge
from ..field import goldilocks as gl
from ..hash.challenger import Challenger
from ..ops import fri_kernels as fk
from ..ops import gf, merkle, ntt
from ..parallel import context as pctx
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
    point-major bit-reversed LDE rows [lde_n, num_polys]. Under a prover
    mesh (with a device-tree hasher) the batch stays sharded as the
    reference's does (ref fri/oracle.py:34-94): ``polynomials`` is
    fk.PolyShards, poly-sharded and zero-padded to a multiple of the shard
    count, and the tree a merkle.ShardedMerkleTree, its leaves and levels
    row-sharded; the same polynomials, leaves and tree as on one device."""

    polynomials: Union[torch.Tensor, fk.PolyShards]
    merkle_tree: merkle.DeviceMerkleTree
    degree_log: int
    rate_bits: int
    blinding: bool

    @property
    def num_polys(self) -> int:
        if self.sharded:
            return self.polynomials.num_polys
        return self.polynomials.shape[0]

    @property
    def device(self) -> torch.device:
        """The proof's device: where openings and reductions land."""
        return self.polynomials.device

    @property
    def sharded(self) -> bool:
        return isinstance(self.polynomials, fk.PolyShards)

    def coeffs_u64(self) -> np.ndarray:
        """The [num_polys, N] coefficients on the host (a sharded batch
        reads its parts one by one, padding dropped)."""
        if self.sharded:
            return self.polynomials.to_u64()
        return gf.to_u64(self.polynomials)

    @staticmethod
    def from_values(
        values, rate_bits: int, blinding: bool, cap_height: int, hasher=None,
        device=None,
    ) -> "PolynomialBatch":
        """values: [num_polys, N] evaluations on the subgroup, as a tensor
        or a numpy u64 array. device=None means the GPU."""
        values = _on_device(values, device)
        mesh = fk.sharding_mesh(hasher)
        if mesh is None:
            coeffs = ntt.ifft(values)
        else:
            # per-poly transforms: one block of polys a shard, no copies
            # between shards (oracle.rs:168's per-poly par_iter)
            coeffs = fk.shard_polys(values, mesh).map(ntt.ifft)
        return PolynomialBatch.from_coeffs(
            coeffs, rate_bits, blinding, cap_height, hasher=hasher, device=device
        )

    @staticmethod
    def from_coeffs(
        coeffs, rate_bits: int, blinding: bool, cap_height: int, hasher=None,
        device=None,
    ) -> "PolynomialBatch":
        """coeffs: [num_polys, N] as a tensor, a numpy u64 array or
        fk.PolyShards. Under a prover mesh that keeps the batch sharded
        (fk.sharding_mesh) a whole tensor is sharded; where none does
        (a host-tree hasher), parts are gathered whole."""
        mesh = fk.sharding_mesh(hasher)
        if not isinstance(coeffs, fk.PolyShards):
            coeffs = _on_device(coeffs, device)
            if mesh is not None:
                coeffs = fk.shard_polys(coeffs, mesh)
        elif mesh is None:
            coeffs = pctx.all_gather(coeffs.parts, coeffs.device)[: coeffs.num_polys]
        degree = coeffs.shape[-1]
        salt = None
        if blinding:
            # SALT_SIZE random leaf columns hide the committed rows
            # (oracle.rs:243-264); salts never join the algebraic openings.
            # They are drawn on the host, a fresh stream a commitment;
            # PLONKY2_TPU_SALT_SEED pins the stream (the same numpy
            # generator and seed variable as the JAX package, so the two
            # give the same salts) — unset in production.
            seed = os.environ.get("PLONKY2_TPU_SALT_SEED")
            rng = np.random.default_rng(int(seed) if seed else None)
            salt = rng.integers(0, gl.P, size=(degree << rate_bits, SALT_SIZE), dtype=np.uint64)
        tree = fk.commit(coeffs, rate_bits, cap_height, salt=salt, hasher=hasher)
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
    """[n, 2] u64 powers 1, z, ..., z^(n-1) by vectorized doubling on the
    host. The prover builds these tables on the device
    (gf.ext2_powers_scan); this stays as their host oracle."""
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


def eval_commitments_at_device(
    oracles: Sequence["PolynomialBatch"], zeta: torch.Tensor, zeta_next: torch.Tensor
) -> torch.Tensor:
    """All oracles at zeta, then all oracles at zeta_next (each a shape-(2,)
    tensor on the oracles' device): [2 * sum M, 2] extension values, the
    zeta block first, oracles in order within each block. The power
    tables [n, 2] of both points are built on the device
    (gf.ext2_powers_scan) and nothing is read back. A sharded oracle is
    evaluated shard by shard where its rows lie, the power tables copied
    there; the [M, 4] results are gathered in oracle order."""
    n = oracles[0].polynomials.shape[-1]
    for o in oracles:
        assert o.polynomials.shape[-1] == n
    # weights [n, 4]: columns (zeta c0, zeta c1, zeta_next c0, zeta_next c1)
    w = torch.cat([gf.ext2_powers_scan(zeta, n), gf.ext2_powers_scan(zeta_next, n)], dim=1)
    tables = {w.device: w}

    def evals(coeffs):  # [M, n] -> [M, 4], on the coefficients' device
        if coeffs.device not in tables:
            tables[coeffs.device] = w.to(coeffs.device)
        wd, ct = tables[coeffs.device], coeffs.T  # ct: [n, M]
        with pctx.on_shard(coeffs.device):
            return torch.stack([gf.weighted_sum(ct, wd[:, k]) for k in range(4)], dim=-1)

    per_oracle = []
    for o in oracles:
        if isinstance(o.polynomials, fk.PolyShards):
            parts = [evals(p) for p in o.polynomials.parts]
            per_oracle.append(pctx.all_gather(parts, w.device, 0)[: o.num_polys])
        else:
            per_oracle.append(evals(o.polynomials))
    e = torch.cat(per_oracle, dim=0)  # [sum M, 4]
    return torch.cat([e[:, :2], e[:, 2:]])


def eval_commitments_at(
    oracles: Sequence["PolynomialBatch"], zeta, zeta_next
) -> List[List[Tuple[int, ...]]]:
    """eval_commitments_at_device at host points: one list of extension
    values per (point, oracle), zeta block first, brought to the host in
    ONE transfer."""
    device = oracles[0].polynomials.device
    pts = gf.from_u64(
        np.array([[int(zeta[0]), int(zeta[1])], [int(zeta_next[0]), int(zeta_next[1])]],
                 dtype=np.uint64),
        device,
    )
    return split_evals(gf.to_u64(eval_commitments_at_device(oracles, pts[0], pts[1])), oracles)


def split_evals(flat: np.ndarray, oracles: Sequence["PolynomialBatch"]) -> List[List[Tuple[int, ...]]]:
    """eval_commitments_at_device's [2 * sum M, 2] values, read back as u64,
    as one list of extension tuples per (point, oracle)."""
    out: List[List[Tuple[int, ...]]] = []
    pos = 0
    for _ in range(2):  # zeta block, then g*zeta block
        for o in oracles:
            rows = flat[pos : pos + o.num_polys]
            out.append([(int(r[0]), int(r[1])) for r in rows])
            pos += o.num_polys
    return out


def take_rows(x: torch.Tensor, idx: List[int]) -> torch.Tensor:
    """x[idx] along axis 0 for host indices, as one slice per run of
    consecutive indices (the opening layouts are a few runs), so no index
    tensor is uploaded."""
    runs = []
    for i in idx:
        if runs and runs[-1][1] == i:
            runs[-1][1] = i + 1
        else:
            runs.append([i, i + 1])
    parts = [x[a:b] for a, b in runs]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def compose_polys(oracle: "PolynomialBatch", poly_indices: List[int], weights) -> torch.Tensor:
    """sum_k weights[k] · poly poly_indices[k] of the oracle: an extension
    poly [N, 2] on the oracle's device. poly_indices ascending; weights
    [k, 2] as host u64 values or a tensor on that device. A sharded
    oracle composes the rows each shard holds, on that shard, and the
    parts are added on the oracle's device (pctx.shard_sum): exact, so
    equal to the single-device composition."""
    polys = oracle.polynomials
    if not isinstance(polys, fk.PolyShards):
        return fk.composition_poly(take_rows(polys, poly_indices), weights)
    partials = []
    for s, part in enumerate(polys.parts):
        lo, hi = s * polys.rows, (s + 1) * polys.rows
        pos = [k for k, pi in enumerate(poly_indices) if lo <= pi < hi]
        if not pos:
            continue
        if isinstance(weights, torch.Tensor):
            w = take_rows(weights, pos).to(part.device)
        else:
            w = np.asarray(weights, dtype=np.uint64)[pos]
        with pctx.on_shard(part.device):
            partials.append(
                fk.composition_poly(take_rows(part, [poly_indices[k] - lo for k in pos]), w)
            )
    return pctx.shard_sum(partials, polys.device)


def _shift_accumulate(final: torch.Tensor, quotient: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """final * shift + quotient over extension polys [N, 2]; shift is a
    shape-(2,) tensor, alpha to the number of openings of the quotient's
    batch (ReducingFactor::shift_poly, oracle.rs:160-163)."""
    return gf.add(gf.ext2_mul(final, shift[None]), quotient)


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
            weights = np.array([w for _, w in items], dtype=np.uint64)  # [k, 2]
            part = compose_polys(oracles[oi], [pi for pi, _ in items], weights)  # [N, 2]
            comp = part if comp is None else gf.add(comp, part)
        quotient = fk.divide_by_linear_ext(comp, point)  # [N, 2]
        if final is None:
            final = quotient
        else:
            shift = ge.ext_exp(alpha, cnt)
            final = _shift_accumulate(final, quotient, gf.ext2_const(shift, quotient.device))
    return final


def final_poly_lde(final_poly: torch.Tensor, lde_size: int):
    """The reduced polynomial [N, 2] zero-padded to the LDE size, and its
    values on the shifted coset: (coeffs, values), each [lde_size, 2]."""
    n = final_poly.shape[0]
    assert n <= lde_size
    lde_coeffs = torch.cat([final_poly, gf.zeros((lde_size - n, 2), final_poly.device)])
    return lde_coeffs, fk.ext_coset_fft(lde_coeffs)


def prove_openings(
    instance: FriInstanceInfo,
    oracles: Sequence[PolynomialBatch],
    challenger: Challenger,
    fri_params: FriParams,
    final_poly_coeff_len: Optional[int] = None,
    max_num_query_steps: Optional[int] = None,
    hasher=None,
    fused: Optional[bool] = None,
) -> FriProof:
    """Batch opening proof (oracle.rs:320-358 prove_openings); ``fused``
    as for fri_prover.fri_proof."""
    from .prover import fri_proof  # local import to avoid cycle

    alpha = challenger.get_extension_challenge(2)
    final_poly = reduce_openings_to_final_poly(instance, oracles, alpha)
    lde_coeffs, lde_values = final_poly_lde(final_poly, fri_params.lde_size)
    return fri_proof(
        [o.merkle_tree for o in oracles],
        lde_coeffs,
        lde_values,
        challenger,
        fri_params,
        final_poly_coeff_len,
        max_num_query_steps,
        hasher=hasher,
        fused=fused,
    )

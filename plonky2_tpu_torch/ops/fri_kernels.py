"""Device operations for the FRI protocol: commitment LDE+Merkle, opening
reduction, coefficient folds, extension-poly coset FFT, PoW grinding.

These replace the rayon hot loops in plonky2/src/fri/{oracle.rs,prover.rs}.
All polynomial math stays device-resident; the host only sees caps, query
gathers and tiny final polynomials.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..field import goldilocks as gl
from ..parallel import context as pctx
from ..utils.bits import log2_strict, reverse_bits
from . import gf, merkle, ntt
from . import poseidon as dp
from .bitrev import bitrev_axis
from .poseidon import SPONGE_RATE, SPONGE_WIDTH

# ---------------------------------------------------------------------------
# Oracle commitment: coeffs [M, N] -> LDE leaves [lde_n, M] + Merkle levels
# ---------------------------------------------------------------------------


@dataclass
class PolyShards:
    """Coefficients [num_polys, N] poly-sharded over a prover mesh (the
    reference's polys_sharding): parts[s], on mesh.devices[s], is rows
    [s·m, (s+1)·m) of the matrix zero-padded to d·m rows, m =
    ceil(num_polys / d). ``device`` is the proof's."""

    parts: List[torch.Tensor]
    num_polys: int
    device: torch.device

    @property
    def rows(self) -> int:
        """Rows a shard holds, m."""
        return self.parts[0].shape[0]

    @property
    def shape(self):
        """The shape of the matrix the parts stand for, [num_polys, N]."""
        return (self.num_polys, self.parts[0].shape[-1])

    def map(self, fn) -> "PolyShards":
        """fn applied to each shard's rows on its device (rows are
        independent: per-poly transforms)."""
        out = []
        for p in self.parts:
            with pctx.on_shard(p.device):
                out.append(fn(p))
        return PolyShards(out, self.num_polys, self.device)

    def to_u64(self) -> np.ndarray:
        """The [num_polys, N] matrix on the host, a part at a time."""
        return np.concatenate([gf.to_u64(p) for p in self.parts])[: self.num_polys]


def sharding_mesh(hasher=None):
    """The active prover mesh if a batch committed under ``hasher`` is
    kept sharded (a device-tree hasher, Poseidon or Poseidon2), else
    None."""
    mesh = pctx.get_mesh()
    if mesh is not None and (hasher is None or hasher.name in ("poseidon", "poseidon2")):
        return mesh
    return None


def shard_polys(x: torch.Tensor, mesh) -> PolyShards:
    """[M, N] rows zero-padded to a multiple of the shard count and split,
    block s to shard s (ref fri/oracle.py:34-49)."""
    return PolyShards(pctx.shard(pad_rows(x, mesh.size), mesh, 0), x.shape[0], x.device)


def lde_leaves(coeffs: torch.Tensor, rate_bits: int) -> torch.Tensor:
    """Coset-LDE all polynomials and lay out point-major Merkle leaves:
    row i = all polys evaluated at domain index rev(i)
    (reference: fri/oracle.rs:193-223 from_coeffs)."""
    vals = ntt.lde_onto_coset(coeffs, rate_bits)  # [M, lde_n]
    # gathering the bit-reversed columns of the transposed view writes the
    # contiguous [lde_n, M] leaf matrix in one pass
    return bitrev_axis(vals.T, axis=0).contiguous()


def lde_leaf_shards(coeffs: PolyShards, rate_bits: int, mesh) -> list:
    """lde_leaves over a prover mesh, row-sharded: each shard LDEs its
    block of polys (no copies), and one all-to-all gives shard s the row
    block s of the leaves, on its device. The padding polys are sliced
    off before the leaves, so commitments do not change.

    Leaf row i = s·(L/d) + j of shard s is the natural point
    rev_L(i) = rev(j)·d + rev_b(s) (b = log2 d): shard s takes the points
    rev_b(s) + d·m of every poly — a strided slice of each LDE — and puts
    them in bit-reversed order of m."""
    d = mesh.size
    b = log2_strict(d)
    vals = pctx.map_shards(
        lambda c: ntt.lde_onto_coset(c, rate_bits), mesh, coeffs.parts
    )  # [Mp/d, L] a shard, poly-sharded
    # block s of the all-to-all: the points = rev_b(s) (mod d) of each poly
    strided = [
        torch.stack([v[:, reverse_bits(s, b)::d] for s in range(d)], dim=1) for v in vals
    ]  # [Mp/d, d, L/d]: axis 1 is the destination shard
    del vals
    rows = pctx.all_to_all(strided, mesh, split_dim=1, concat_dim=0)  # [Mp, 1, L/d]
    return pctx.map_shards(
        lambda r: bitrev_axis(r[: coeffs.num_polys, 0].T, axis=0).contiguous(), mesh, rows
    )  # [L/d, M] a shard, row-sharded


def pad_rows(x: torch.Tensor, d: int) -> torch.Tensor:
    """x with zero rows appended to a multiple of d rows (x itself if it
    has one)."""
    pad = (-x.shape[0]) % d
    return torch.nn.functional.pad(x, (0, 0, 0, pad)) if pad else x


def commit(coeffs, rate_bits: int, cap_height: int, salt: np.ndarray = None, hasher=None):
    """coeffs: a [M, N] tensor, or PolyShards under the mesh they were
    sharded over (sharding_mesh). salt: optional [lde_n, SALT_SIZE] host u64 random
    columns appended to every leaf for zk hiding (oracle.rs:243-264
    lde_blinded_values). Under a prover mesh with a device-tree hasher
    the leaves stay row-sharded from the LDE through the subtrees and in
    the tree (merkle.ShardedMerkleTree), each shard's salt rows uploaded
    to it; a whole tensor is sharded first."""
    mesh = sharding_mesh(hasher)
    if mesh is not None:
        if not isinstance(coeffs, PolyShards):
            coeffs = shard_polys(coeffs, mesh)
        parts = lde_leaf_shards(coeffs, rate_bits, mesh)
        if salt is not None:
            parts = [torch.cat([p, gf.from_u64(s, p.device)], dim=1)
                     for p, s in zip(parts, np.split(salt, mesh.size))]
        return merkle.build_sharded_merkle_tree(parts, mesh, cap_height, coeffs.device, hasher)
    leaves = lde_leaves(coeffs, rate_bits)
    if salt is not None:
        leaves = torch.cat([leaves, gf.from_u64(salt, coeffs.device)], dim=1)
    return merkle.build_merkle_tree(leaves, cap_height, hasher=hasher)


# ---------------------------------------------------------------------------
# Opening reduction -> final polynomial (oracle.rs:129-165)
# ---------------------------------------------------------------------------


def composition_poly(polys: torch.Tensor, weights_ext) -> torch.Tensor:
    """sum_i w_i * p_i with extension weights [M, 2] (a tensor on the
    polys' device, or host u64 values) over base polys [M, N] -> extension
    poly [N, 2]."""
    if isinstance(weights_ext, torch.Tensor):
        w = weights_ext
    else:
        w = gf.from_u64(np.asarray(weights_ext, dtype=np.uint64), polys.device)
    c0 = gf.weighted_sum(polys, w[:, 0])
    c1 = gf.weighted_sum(polys, w[:, 1])
    return torch.stack([c0, c1], dim=-1)


def divide_by_linear_ext(coeffs: torch.Tensor, z) -> torch.Tensor:
    """(p(X) - p(z)) / (X - z) as an [N, 2] extension poly (the top
    coefficient is zero-padded, matching oracle.rs:157-158). z: a shape-(2,)
    tensor on the coefficients' device, or a host extension tuple."""
    if not isinstance(z, torch.Tensor):
        z = gf.ext2_const(z, coeffs.device)
    s = gf.ext2_affine_suffix_scan_z(coeffs, z)  # [N, 2]
    q = torch.flip(s, dims=(0,))[1:]
    return torch.cat([q, gf.zeros((1, 2), coeffs.device)])


def ext_poly_mul_const(p: torch.Tensor, c) -> torch.Tensor:
    return gf.ext2_mul(p, gf.ext2_const(c, p.device))


def ext_poly_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return gf.add(a, b)


# ---------------------------------------------------------------------------
# Extension-poly coset FFT: [N, 2] -> values [N, 2]
# (FFT twiddles/shift are base-field, so components transform independently)
# ---------------------------------------------------------------------------


def ext_coset_fft(coeffs: torch.Tensor,
                  shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR) -> torch.Tensor:
    return ntt.coset_fft(coeffs.T.contiguous(), shift).T.contiguous()


# ---------------------------------------------------------------------------
# Commit-phase fold (fri/prover.rs:110-121)
# ---------------------------------------------------------------------------


def fold_coeffs(coeffs: torch.Tensor, beta_powers: torch.Tensor, arity_bits: int) -> torch.Tensor:
    """new_coeffs[i] = sum_j beta^j * coeffs[arity*i + j] (extension).

    beta_powers: [arity, 2] tensor of (1, beta, ..., beta^(arity-1)).
    One broadcast ext-mul over the contiguous [n/arity, arity, 2] view,
    then a log2(arity)-step tree reduction over halves of the arity axis
    (field addition is associative and commutative, so this is exact)."""
    arity = 1 << arity_bits
    n = coeffs.shape[0]
    x = gf.ext2_mul(coeffs.reshape(n // arity, arity, 2), beta_powers[None])
    k = arity
    while k > 1:
        k //= 2
        x = gf.add(x[:, :k, :], x[:, k:, :])
    return x[:, 0, :].contiguous()


def commit_phase_leaves(values: torch.Tensor, arity_bits: int) -> torch.Tensor:
    """Bit-reverse extension values [n, 2] and chunk them into arity-cosets:
    leaves [n/arity, arity*2]."""
    n = values.shape[0]
    arity = 1 << arity_bits
    return bitrev_axis(values, axis=0).reshape(n // arity, arity * 2)


def commit_phase_tree(values: torch.Tensor, arity_bits: int, cap_height: int, hasher=None):
    """Commit to one FRI round's values (fri/prover.rs:95-105)."""
    leaves = commit_phase_leaves(values, arity_bits)
    return merkle.build_merkle_tree(leaves, cap_height, hasher=hasher)


# ---------------------------------------------------------------------------
# Proof-of-work grind (fri/prover.rs:159-208) — deterministic smallest witness
# ---------------------------------------------------------------------------


def _pow_chunk_size(pow_bits: int) -> int:
    """Candidates tried per batch: about e^-4 miss probability per chunk,
    capped for memory."""
    return max(1 << 10, min(1 << 17, 1 << (pow_bits + 2)))


def pow_grind_device(state: torch.Tensor, witness_pos: int, pow_bits: int, permute=None):
    """The smallest witness w such that the state [12] with w at lane
    witness_pos permutes to a response (lane RATE - 1) with >= pow_bits
    leading zeros. Chunks of consecutive candidates are permuted in one
    batch each, in order; the first hit of the first chunk that has one is
    the smallest witness. ``permute`` maps [B, 12] states to [B, 12]: the
    challenger's permutation, Poseidon's (ops/poseidon.permute) if None.
    Returns (w as a 0-dim tensor on the state's device, chunks tried): the
    host reads one flag a chunk and nothing else."""
    assert 0 <= pow_bits < 64
    permute = permute or dp.permute
    chunk = _pow_chunk_size(pow_bits)
    offsets = torch.arange(chunk, dtype=gf.I64, device=state.device)
    head = state[:witness_pos].expand(chunk, witness_pos)
    tail = state[witness_pos + 1 :].expand(chunk, SPONGE_WIDTH - 1 - witness_pos)
    start, chunks = 0, 0
    while True:
        states = torch.cat([head, (offsets + start)[:, None], tail], dim=1)
        resp = permute(states)[:, SPONGE_RATE - 1]
        # leading zeros >= pow_bits  <=>  the top pow_bits bits are clear
        # (the arithmetic shift of a word with its top bit set is nonzero)
        ok = (resp >> (64 - pow_bits)) == 0 if pow_bits else torch.ones_like(resp, dtype=torch.bool)
        chunks += 1
        if bool(ok.any()):  # the grind's one read a chunk
            # argmax returns the first of equal maxima
            return torch.argmax(ok.to(torch.int32)) + start, chunks
        start += chunk
        assert start < (1 << 40), "PoW grind failed (astronomically unlikely)"


def pow_grind(state12, witness_pos: int, pow_bits: int, device, permute=None) -> int:
    """pow_grind_device from a host state (u64 words), the witness read
    back as an int."""
    w, _ = pow_grind_device(
        gf.from_u64(np.asarray(state12, dtype=np.uint64), device), witness_pos, pow_bits,
        permute,
    )
    return int(w)

"""Batched Poseidon permutation, two-to-one compression and sponge hashing
on device.

Layout: state-major. A batch of states is an int64 bit-container tensor
``[B, 12]`` (see ops/gf.py); a batch of sponge inputs is ``[B, w]`` rows;
a Merkle level is ``[2B, 4]`` digests, compressed in pairs of rows.
These are the layouts the callers already have — the Merkle leaf matrix
is point-major ``[B, w]`` — and the ones the CUDA kernels read.

Dispatch is ``tensor.is_cuda`` and nothing else: a CUDA tensor always
goes to the hand-written kernel (ops/poseidon_cuda.py, whatever the batch
size; a failing build or launch raises), a CPU tensor to the plain
PyTorch version beside it (``permute_plain`` / ``compress_pairs_plain`` /
``sponge_plain``). The plain versions are what the CPU tests exercise and
what the kernels are held against on the card. They run the kernels'
round structure — the 22 partial rounds in the fast form of
hash/poseidon_fast.py, from the same tables — on canonical values and
the plain field product ``gf.mul_plain``.

The output is bit-identical to the reference permutation (tested against
the core/src/poseidon_goldilocks.rs test vectors).

Under a prover mesh (parallel/context.py) a batch of permutations of at
least ``_MESH_MIN_ROWS`` states a shard (the PoW grind's candidates) is
split by rows: each shard's block goes through the kernel on that shard's
device and the states are gathered back (rows are independent, so this is
exact). Trees under a mesh hash their own row blocks shard by shard
(ops/merkle.build_sharded_merkle_tree).
"""

from __future__ import annotations

import numpy as np
import torch

from ..field.goldilocks import P
from ..hash import poseidon_fast as pf
from ..hash.poseidon import NUM_HASH_OUT_ELTS
from ..hash.poseidon_constants import (
    ALL_ROUND_CONSTANTS,
    HALF_N_FULL_ROUNDS,
    MDS_MATRIX_CIRC,
    MDS_MATRIX_DIAG,
    N_PARTIAL_ROUNDS,
    N_ROUNDS,
    SPONGE_RATE,
    SPONGE_WIDTH,
)
from ..parallel import context as pctx
from . import gf, poseidon_cuda

# smallest per-shard batch that a mesh splits (the reference's
# _PALLAS_MIN_B): below it, one launch on the batch's device
_MESH_MIN_ROWS = 2048


def _mesh_for(rows: int):
    """The active mesh if a batch of ``rows`` splits evenly over it into
    blocks of at least _MESH_MIN_ROWS; else None."""
    mesh = pctx.get_mesh()
    if mesh is None or rows % mesh.size or rows // mesh.size < _MESH_MIN_ROWS:
        return None
    return mesh


def _u64(values) -> np.ndarray:
    return (np.array(values, dtype=object) % P).astype(np.uint64)


# Round constants as a canonical [30, 12] u64 table; the tables of the fast
# partial rounds (hash/poseidon_fast.py), the same ones the kernels compile
# in (csrc/poseidon_constants.cuh)
_TABLES_NP = {
    "rc": _u64(ALL_ROUND_CONSTANTS).reshape(N_ROUNDS, SPONGE_WIDTH),
    "first_rc": _u64(pf.FAST_PARTIAL_FIRST_ROUND_CONSTANT),  # [12]
    "fast_rc": _u64(pf.FAST_PARTIAL_ROUND_CONSTANTS),  # [22]
    "init": _u64(pf.FAST_PARTIAL_ROUND_INITIAL_MATRIX),  # [11, 11]
    # row r: MDS[0][0], then W_HATS[r] — the weights of lane 0's new value
    "dot": _u64([[pf.MDS_0_0] + list(w) for w in pf.FAST_PARTIAL_ROUND_W_HATS]),  # [22, 12]
    "vs": _u64(pf.FAST_PARTIAL_ROUND_VS),  # [22, 11]
}
_DEVICE_CONSTANTS = {}  # per-device constant tensors


def _tables(device) -> dict:
    key = str(device)
    if key not in _DEVICE_CONSTANTS:
        _DEVICE_CONSTANTS[key] = {k: gf.from_u64(v, device) for k, v in _TABLES_NP.items()}
    return _DEVICE_CONSTANTS[key]


def _sbox7(x: torch.Tensor) -> torch.Tensor:
    x2 = gf.mul_plain(x, x)
    x4 = gf.mul_plain(x2, x2)
    x3 = gf.mul_plain(x, x2)
    return gf.mul_plain(x3, x4)


def _mds_matrix_t(device) -> torch.Tensor:
    """MDS^T as float64 [12(in), 12(out)], MDS[r, j] = CIRC[(j - r) mod 12]
    + (j == r) * DIAG[r]."""
    key = ("mds", str(device))
    if key not in _DEVICE_CONSTANTS:
        m = np.array(
            [
                [
                    MDS_MATRIX_CIRC[(j - r) % SPONGE_WIDTH] + (MDS_MATRIX_DIAG[r] if j == r else 0)
                    for j in range(SPONGE_WIDTH)
                ]
                for r in range(SPONGE_WIDTH)
            ],
            dtype=np.float64,
        )
        _DEVICE_CONSTANTS[key] = torch.from_numpy(m.T.copy()).to(device)
    return _DEVICE_CONSTANTS[key]


def _mds_plain(state: torch.Tensor) -> torch.Tensor:
    """out[:, r] = sum_j MDS[r, j] * state[:, j] exactly mod p: the 32-bit
    halves of the state go through the 12x12 matrix separately (entries
    < 2^6, so each half-sum stays < 2^42 and a float64 product is exact),
    then are recombined into one 75-bit value and reduced once — the same
    steps as the kernel."""
    mt = _mds_matrix_t(state.device)
    acc_lo = ((state & 0xFFFF_FFFF).to(torch.float64) @ mt).to(gf.I64)
    acc_hi = (((state >> 32) & 0xFFFF_FFFF).to(torch.float64) @ mt).to(gf.I64)
    shifted = acc_hi << 32
    low = acc_lo + shifted
    carry = gf._ult(low, shifted).to(gf.I64)
    return gf.reduce128(low, (acc_hi >> 32) + carry)


def _full_round(s: torch.Tensor, rc: torch.Tensor) -> torch.Tensor:
    return _mds_plain(_sbox7(gf.add(s, rc)))


def _partial_rounds_plain(s: torch.Tensor, t: dict) -> torch.Tensor:
    """The 22 partial rounds in the fast form (hash/poseidon_fast.py
    permute_fast): partial_first_constant_layer, mds_partial_layer_init,
    then per round the S-box and constant on lane 0 and the sparse product
    s0' = MDS[0][0] s0 + sum_i W_HATS[r][i-1] s[i], s[i] += s0 VS[r][i-1]."""
    s = gf.add(s, t["first_rc"])
    rest = s[:, 1:]
    cols = [
        gf.sum_mod_p(gf.mul_plain(rest, t["init"][:, c]), axis=1)
        for c in range(SPONGE_WIDTH - 1)
    ]
    s = torch.stack([s[:, 0]] + cols, dim=1)
    for r in range(N_PARTIAL_ROUNDS):
        s0 = gf.add(_sbox7(s[:, :1]), t["fast_rc"][r])  # [B, 1]
        lane0 = gf.sum_mod_p(gf.mul_plain(torch.cat([s0, s[:, 1:]], dim=1), t["dot"][r]), axis=1)
        rest = gf.add(s[:, 1:], gf.mul_plain(s0, t["vs"][r]))
        s = torch.cat([lane0[:, None], rest], dim=1)
    return s


def permute_plain(state: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Poseidon permutation of [B, 12] canonical states, in
    the kernels' round structure: 4 full rounds (constant add, x^7 on every
    lane, dense MDS), the 22 partial rounds in the fast form, 4 full
    rounds."""
    assert state.ndim == 2 and state.shape[1] == SPONGE_WIDTH
    t = _tables(state.device)
    s = state
    for r in range(HALF_N_FULL_ROUNDS):
        s = _full_round(s, t["rc"][r])
    s = _partial_rounds_plain(s, t)
    for r in range(HALF_N_FULL_ROUNDS + N_PARTIAL_ROUNDS, N_ROUNDS):
        s = _full_round(s, t["rc"][r])
    return s


def compress_pairs_plain(level: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch two-to-one compression of a [2B, 4] digest level ->
    [B, 4]: rows 2i and 2i+1 are the left and right inputs of digest i."""
    pairs = level.reshape(-1, 2 * NUM_HASH_OUT_ELTS)
    zeros = gf.zeros((pairs.shape[0], SPONGE_WIDTH - pairs.shape[1]), level.device)
    return permute_plain(torch.cat([pairs, zeros], dim=1))[:, :NUM_HASH_OUT_ELTS].contiguous()


def sponge_plain(rows: torch.Tensor, cap_val: int) -> torch.Tensor:
    """Plain PyTorch overwrite-mode sponge over [B, w] rows (w >= 1):
    state zero except capacity lane RATE = cap_val; each chunk of up to
    RATE inputs overwrites the leading lanes (a short last chunk only its
    k lanes) and is followed by a permutation. Returns [B, 4] digests."""
    b, w = rows.shape
    assert w >= 1
    state = gf.zeros((b, SPONGE_WIDTH), rows.device)
    state[:, SPONGE_RATE] = gf._s64(int(cap_val) % P)
    for c in range(0, w, SPONGE_RATE):
        k = min(SPONGE_RATE, w - c)
        state = torch.cat([rows[:, c : c + k], state[:, k:]], dim=1)
        state = permute_plain(state)
    return state[:, :NUM_HASH_OUT_ELTS].contiguous()


# ---------------------------------------------------------------------------
# Dispatching entry points
# ---------------------------------------------------------------------------


def permute(state: torch.Tensor) -> torch.Tensor:
    """Batched Poseidon permutation; state is [..., 12]."""
    assert state.shape[-1] == SPONGE_WIDTH
    flat = state.reshape(-1, SPONGE_WIDTH)
    mesh = _mesh_for(flat.shape[0])
    if mesh is not None:
        return pctx.map_rows(permute, mesh, flat).reshape(state.shape)
    if flat.is_cuda:
        out = poseidon_cuda.permute(flat.contiguous())
    else:
        out = permute_plain(flat)
    return out.reshape(state.shape)


def permute_t(state: torch.Tensor) -> torch.Tensor:
    """Lane-major variant: [12, B] in, [12, B] out (one transpose on each
    side of ``permute``; kept so callers holding lane-major data can be
    compared like with like)."""
    assert state.shape[0] == SPONGE_WIDTH
    return permute(state.T).T


def sponge(rows: torch.Tensor, cap_val: int) -> torch.Tensor:
    """Overwrite-mode sponge over [B, w] rows -> [B, 4] digests, capacity
    lane RATE preset to cap_val."""
    assert rows.ndim == 2
    if rows.is_cuda:
        rows = rows.contiguous()
        if rows.data_ptr() % 16:  # a view into its storage: the kernel copies 16-byte pieces
            rows = rows.clone()
        return poseidon_cuda.sponge(rows, cap_val)
    return sponge_plain(rows, cap_val)


def _sponge_t(t: torch.Tensor, cap_val: int) -> torch.Tensor:
    """Lane-major inputs [w, B] -> [B, 4] digests."""
    return sponge(t.T, cap_val)


def hash_leaf(leaves: torch.Tensor) -> torch.Tensor:
    """Domain-separated Merkle leaf hash of a [B, w] batch -> [B, 4]
    digests. Capacity lane RATE is set to w+1 (this fork's hashing.rs
    hash_leaf)."""
    return sponge(leaves, leaves.shape[1] + 1)


def compress_pairs(level: torch.Tensor) -> torch.Tensor:
    """Two-to-one compression of a [2B, 4] digest level -> the [B, 4] level
    above it (digest i = two_to_one(level[2i], level[2i+1])). A contiguous
    level is read as a [B, 8] view, without a copy."""
    assert level.ndim == 2 and level.shape[1] == NUM_HASH_OUT_ELTS and level.shape[0] % 2 == 0
    if level.is_cuda:
        return poseidon_cuda.compress(level.contiguous().view(-1, 2 * NUM_HASH_OUT_ELTS))
    return compress_pairs_plain(level)


def two_to_one(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Compress [B, 4] + [B, 4] -> [B, 4] with zero capacity."""
    return compress_pairs(torch.cat([left, right], dim=1).view(-1, NUM_HASH_OUT_ELTS))


def hash_no_pad_batch(inputs: torch.Tensor) -> torch.Tensor:
    """Overwrite-mode sponge over [B, w] rows, zero capacity -> [B, 4]."""
    return sponge(inputs, 0)

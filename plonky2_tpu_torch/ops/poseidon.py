"""Batched Poseidon permutation and sponge hashing on device.

Layout: state-major. A batch of states is an int64 bit-container tensor
``[B, 12]`` (see ops/gf.py); a batch of sponge inputs is ``[B, w]`` rows.
These are the layouts the callers already have — the Merkle leaf matrix
is point-major ``[B, w]`` — and the ones the CUDA kernels read.

Dispatch is ``tensor.is_cuda`` and nothing else: a CUDA tensor always
goes to the hand-written kernel (ops/poseidon_cuda.py, whatever the batch
size; a failing build or launch raises), a CPU tensor to the plain
PyTorch version beside it (``permute_plain`` / ``sponge_plain``). The
plain versions are what the CPU tests exercise and what the kernels are
held against on the card.

The output is bit-identical to the reference permutation (tested against
the core/src/poseidon_goldilocks.rs test vectors).
"""

from __future__ import annotations

import numpy as np
import torch

from ..field.goldilocks import P
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
from . import gf, poseidon_cuda

# Round constants as a canonical [30, 12] u64 table
_RC_NP = (
    np.array(ALL_ROUND_CONSTANTS, dtype=object) % P
).astype(np.uint64).reshape(N_ROUNDS, SPONGE_WIDTH)
_DEVICE_CONSTANTS = {}  # per-device constant tensors


def _round_constants(device) -> torch.Tensor:
    key = str(device)
    if key not in _DEVICE_CONSTANTS:
        _DEVICE_CONSTANTS[key] = gf.from_u64(_RC_NP, device)
    return _DEVICE_CONSTANTS[key]


def _is_full(r: int) -> bool:
    return r < HALF_N_FULL_ROUNDS or r >= HALF_N_FULL_ROUNDS + N_PARTIAL_ROUNDS


def _sbox7(x: torch.Tensor) -> torch.Tensor:
    x2 = gf.mul(x, x)
    x4 = gf.mul(x2, x2)
    x3 = gf.mul(x, x2)
    return gf.mul(x3, x4)


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


def permute_plain(state: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Poseidon permutation of [B, 12] canonical states:
    30 rounds of constant add, x^7 S-box (all lanes in the full rounds,
    lane 0 in the partial ones) and the dense MDS product."""
    assert state.ndim == 2 and state.shape[1] == SPONGE_WIDTH
    rc = _round_constants(state.device)
    s = state
    for r in range(N_ROUNDS):
        s = gf.add(s, rc[r])
        if _is_full(r):
            s = _sbox7(s)
        else:
            s = torch.cat([_sbox7(s[:, :1]), s[:, 1:]], dim=1)
        s = _mds_plain(s)
    return s


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
        return poseidon_cuda.sponge(rows.contiguous(), cap_val)
    return sponge_plain(rows, cap_val)


def _sponge_t(t: torch.Tensor, cap_val: int) -> torch.Tensor:
    """Lane-major inputs [w, B] -> [B, 4] digests."""
    return sponge(t.T, cap_val)


def hash_leaf(leaves: torch.Tensor) -> torch.Tensor:
    """Domain-separated Merkle leaf hash of a [B, w] batch -> [B, 4]
    digests. Capacity lane RATE is set to w+1 (this fork's hashing.rs
    hash_leaf)."""
    return sponge(leaves, leaves.shape[1] + 1)


def two_to_one(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Compress [B, 4] + [B, 4] -> [B, 4] with zero capacity."""
    b = left.shape[0]
    state = torch.cat(
        [left, right, gf.zeros((b, SPONGE_WIDTH - 2 * NUM_HASH_OUT_ELTS), left.device)],
        dim=1,
    )
    return permute(state)[:, :NUM_HASH_OUT_ELTS].contiguous()


def hash_no_pad_batch(inputs: torch.Tensor) -> torch.Tensor:
    """Overwrite-mode sponge over [B, w] rows, zero capacity -> [B, 4]."""
    return sponge(inputs, 0)

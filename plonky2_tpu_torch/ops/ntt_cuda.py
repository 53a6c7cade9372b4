"""Binding of the hand-written NTT butterfly kernels (csrc/ntt.cu), built
at first use by ops/cuda_build.py.

``col_fft`` runs DIT stages ``first_stage..k_log-1`` along axis -2 of a
``[..., 2^k_log, L]`` tensor (the four-step NTT's passes, ops/ntt.py
``_fft_rows``); ``row_fft`` runs stages ``first_stage..n_log-1`` along the
last axis of ``[..., 2^n_log]`` rows (the flat transforms). Inputs are
bit-reversed along the transform axis (or seeded past ``first_stage``);
no 1/N scaling. The kernels read the flat per-stage twiddle table of
ops/ntt.py ``stage_table`` (stage s at [2^s - 1, 2^(s+1) - 1)) for the
direction asked for.

Each kernel runs its first stages on tiles in shared memory (col_fft_kernel,
row_fft_kernel) and the stages past the tile (ntt_stage_kernel) one launch
a stage, in place on the output. Every launch adds one to the wrapper's
entry of ``LAUNCHES``, there and nowhere else; each call's form is noted in
``LAUNCH_SHAPES`` so a caller can replay it against the plain version.

Nothing here runs at import: the module imports on a machine without a
GPU or ``nvcc``; only a call needs them.
"""

from __future__ import annotations

import torch

from .cuda_build import INT, LL, VP, Library, raise_on

I64 = torch.int64

LIB = Library(
    "ntt", "ntt.cu", ("goldilocks.cuh",),
    {
        "plonky2_col_fft_head": [VP, VP, LL, INT, INT, INT, INT, INT, VP, VP],
        "plonky2_row_fft_head": [VP, VP, LL, INT, INT, INT, VP, VP],
        "plonky2_ntt_stage": [VP, LL, INT, INT, INT, VP, VP],
    },
)

# Shared-memory tiles hold at most 2^TILE_WORDS_LOG words (128 KB;
# NTT_TILE_WORDS_LOG in csrc/ntt.cu). A column tile is at least
# 2^MIN_LANES_LOG lanes wide (32 bytes, one sector a run), which caps its
# fused stages at TILE_WORDS_LOG - MIN_LANES_LOG = 12; at most
# 2^MAX_LANES_LOG lanes.
TILE_WORDS_LOG = 14
MIN_LANES_LOG = 2
MAX_LANES_LOG = 5
COL_FUSED_LOG = TILE_WORDS_LOG - MIN_LANES_LOG
# rows of up to 2^ROW_FUSED_LOG words run all stages in one tile; short
# rows share tiles of 2^ROW_MIN_TILE_LOG words
ROW_FUSED_LOG = TILE_WORDS_LOG
ROW_MIN_TILE_LOG = 11

# launches of each wrapper's kernels since the process started (or since
# reset_launches): head and tail-stage launches alike
LAUNCHES = {"col_fft": 0, "row_fft": 0}
# distinct call forms: col_fft (batch, k_log, L, first_stage, inverse);
# row_fft (rows, n_log, first_stage, inverse)
LAUNCH_SHAPES = {"col_fft": set(), "row_fft": set()}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LAUNCH_SHAPES[k].clear()


def _log2(n: int, what: str) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"{what}: {n} is not a power of two")
    return n.bit_length() - 1


def _check(x: torch.Tensor, what: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {x.device}")
    if x.dtype != I64:
        raise ValueError(f"{what}: expected int64 (u64 bit container), got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")


def _table(n_log: int, inverse: bool, device) -> torch.Tensor:
    from .ntt import stage_table  # ops/ntt.py imports this module

    return stage_table(n_log, inverse, device)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _tail(lib, y: torch.Tensor, batch: int, k_log: int, l_log: int, first: int,
          table: torch.Tensor, key: str, stream: int) -> None:
    for s in range(first, k_log):
        err = lib.plonky2_ntt_stage(y.data_ptr(), batch, k_log, l_log, s,
                                    table.data_ptr(), stream)
        raise_on(err, f"{key} stage {s}")
        LAUNCHES[key] += 1


def col_fft(x: torch.Tensor, k_log: int, first_stage: int, inverse: bool) -> torch.Tensor:
    """DIT stages first_stage..k_log-1 along axis -2 of x: [..., 2^k_log, L]
    (L a power of two), with the inverse roots if ``inverse``."""
    if x.ndim < 2 or x.shape[-2] != 1 << k_log:
        raise ValueError(f"col fft: shape {tuple(x.shape)} for k_log={k_log}")
    _check(x, "col fft")
    l_log = _log2(x.shape[-1], "col fft lanes")
    batch = x.numel() >> (k_log + l_log)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    if k_log == 0:
        return y.copy_(x)
    lib = LIB.load()
    table = _table(k_log, inverse, x.device)
    b_log = min(k_log, COL_FUSED_LOG)
    nl_log = min(l_log, TILE_WORDS_LOG - b_log, MAX_LANES_LOG)
    stream = _stream(x)
    err = lib.plonky2_col_fft_head(
        x.data_ptr(), y.data_ptr(), batch, k_log, l_log, b_log, nl_log,
        first_stage, table.data_ptr(), stream,
    )
    raise_on(err, "col fft head")
    LAUNCHES["col_fft"] += 1
    _tail(lib, y, batch, k_log, l_log, max(first_stage, b_log), table, "col_fft", stream)
    LAUNCH_SHAPES["col_fft"].add((batch, k_log, 1 << l_log, first_stage, bool(inverse)))
    return y


def row_fft(x: torch.Tensor, n_log: int, first_stage: int, inverse: bool) -> torch.Tensor:
    """DIT stages first_stage..n_log-1 along the last axis of x:
    [..., 2^n_log], with the inverse roots if ``inverse``. Rows longer than
    2^ROW_FUSED_LOG run the fused stages on each contiguous
    2^ROW_FUSED_LOG block, then the tail stages."""
    if x.ndim < 1 or x.shape[-1] != 1 << n_log:
        raise ValueError(f"row fft: shape {tuple(x.shape)} for n_log={n_log}")
    _check(x, "row fft")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    if n_log == 0:
        return y.copy_(x)
    lib = LIB.load()
    table = _table(n_log, inverse, x.device)
    rows = x.numel() >> n_log
    head_log = min(n_log, ROW_FUSED_LOG)
    head_rows = rows << (n_log - head_log)
    tile_log = max(head_log, ROW_MIN_TILE_LOG)
    r_log = min(tile_log - head_log, (head_rows - 1).bit_length())
    stream = _stream(x)
    err = lib.plonky2_row_fft_head(
        x.data_ptr(), y.data_ptr(), head_rows, head_log, r_log, first_stage,
        table.data_ptr(), stream,
    )
    raise_on(err, "row fft head")
    LAUNCHES["row_fft"] += 1
    _tail(lib, y, rows, n_log, 0, max(first_stage, head_log), table, "row_fft", stream)
    LAUNCH_SHAPES["row_fft"].add((rows, n_log, first_stage, bool(inverse)))
    return y

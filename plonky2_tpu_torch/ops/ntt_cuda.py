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

``col_fft`` runs its stages in the passes of ``col_plan`` (col_fft_kernel:
stages in registers, tiles in shared memory between stage groups) and the
stages past them (ntt_stage_kernel) one launch a stage, in place on the
output; ``row_fft`` runs its first stages on tiles in shared memory
(row_fft_kernel) and the rest the same way. Every launch adds one to the
wrapper's entry of ``LAUNCHES``, there and nowhere else; each call's form
is noted in ``LAUNCH_SHAPES`` so a caller can replay it against the plain
version.

Nothing here runs at import: the module imports on a machine without a
GPU or ``nvcc``; only a call needs them.
"""

from __future__ import annotations

import torch

from dataclasses import dataclass
from functools import lru_cache

from .cuda_build import INT, LL, VP, Library, raise_on

I64 = torch.int64

LIB = Library(
    "ntt", "ntt.cu", ("goldilocks.cuh",),
    {
        "plonky2_col_fft_pass": [VP, VP, LL] + [INT] * 7 + [VP, VP],
        "plonky2_row_fft_head": [VP, VP, LL, INT, INT, INT, VP, VP],
        "plonky2_ntt_stage": [VP, LL, INT, INT, INT, VP, VP],
    },
)

# Shared-memory tiles hold at most 2^TILE_WORDS_LOG words (128 KB;
# NTT_TILE_WORDS_LOG in csrc/ntt.cu).
TILE_WORDS_LOG = 14
# Column passes (col_plan): a pass covers at most COL_FUSED_LOG stages of
# one aligned group of 2^COL_FUSED_LOG positions (stages past it run as
# tail stages); tiles of at most 2^COL_TILE_WORDS_LOG words (64 KB: three
# blocks an SM) and 2^COL_MAX_LANES_LOG lanes, and no narrower than
# 2^COL_MIN_LANES_LOG lanes (a 32-byte sector a run) where L allows: a pass
# whose tile would be narrower runs as two; stage groups of at most
# COL_RADIX_LOG stages a thread holds in registers; at most COL_THREADS
# threads a block (NTT_COL_RADIX_LOG and NTT_COL_THREADS in csrc/ntt.cu).
COL_FUSED_LOG = 12
COL_TILE_WORDS_LOG = 13
COL_MIN_LANES_LOG = 2
COL_MAX_LANES_LOG = 6
COL_RADIX_LOG = 4
COL_THREADS = 256
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


@dataclass(frozen=True)
class ColPass:
    """One launch of col_fft_kernel: stages [first, last) in tiles of
    2^(last-first) positions x 2^lanes_log lanes, the stages run in
    ``groups`` (sizes, in order) of at most COL_RADIX_LOG stages (as many
    words a thread as 2^size)."""

    first: int
    last: int
    lanes_log: int
    groups: tuple
    threads: int

    def packed_groups(self) -> int:
        """The group sizes four bits each, the first group lowest."""
        return sum(g << (4 * i) for i, g in enumerate(self.groups))

    def smem_bytes(self) -> int:
        """Dynamic shared memory a block asks for: the tile, unless one
        group runs the whole pass in registers."""
        return 8 << (self.last - self.first + self.lanes_log) if len(self.groups) > 1 else 0


def _groups(n: int, radix_log: int) -> tuple:
    """n stages in as few groups of at most radix_log as will do, as even
    as possible, the larger first."""
    count = -(-n // radix_log)
    return tuple(n // count + (i < n % count) for i in range(count))


@lru_cache(maxsize=None)
def col_plan(k_log: int, l_log: int, first_stage: int, *,
             tile_words_log: int = COL_TILE_WORDS_LOG, radix_log: int = COL_RADIX_LOG,
             split_at: int = None, threads: int = COL_THREADS):
    """How col_fft runs stages first_stage..k_log-1 along axis -2 of
    [B, 2^k_log, 2^l_log]: (the col_fft_kernel passes, in order; the first
    stage of the tail, which runs one stage a launch up to k_log - 1).

    The stages up to COL_FUSED_LOG run in one pass, or in two with the
    second from ``split_at`` on (by default where one tile of all of them
    would be narrower than 2^COL_MIN_LANES_LOG lanes and L is not: from the
    middle stage on); a pass's tile is as wide along L as tile_words_log
    and COL_MAX_LANES_LOG allow, and its block has ``threads`` threads or
    as many as the tile has sets of its largest group, at least 32. The
    keyword arguments are the variants tools/torch_ntt_variants.py times
    (radix_log other than COL_RADIX_LOG only with a kernel built for it);
    col_fft takes the defaults."""
    head = min(k_log, COL_FUSED_LOG)
    n = head - first_stage
    if split_at is None and tile_words_log - n < min(l_log, COL_MIN_LANES_LOG):
        split_at = first_stage + (n + 1) // 2
    bounds = [first_stage]
    if split_at is not None and first_stage < split_at < head:
        bounds.append(split_at)
    bounds.append(head)
    passes = []
    for a, b in zip(bounds, bounds[1:]):
        if a >= b:
            continue
        n = b - a
        lanes_log = max(0, min(l_log, tile_words_log - n, COL_MAX_LANES_LOG))
        groups = _groups(n, radix_log)
        sets = 1 << (n + lanes_log - max(groups))
        passes.append(ColPass(a, b, lanes_log, groups, min(threads, max(32, sets))))
    return tuple(passes), max(first_stage, head)


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
    passes, tail = col_plan(k_log, l_log, first_stage)
    if not passes:
        y.copy_(x)
        if tail >= k_log:
            return y
    lib = LIB.load()
    table = _table(k_log, inverse, x.device)
    stream = _stream(x)
    src = x
    for p in passes:
        err = lib.plonky2_col_fft_pass(
            src.data_ptr(), y.data_ptr(), batch, k_log, l_log, p.first, p.last, p.lanes_log,
            p.packed_groups(), p.threads, table.data_ptr(), stream,
        )
        raise_on(err, "col fft pass")
        LAUNCHES["col_fft"] += 1
        src = y
    _tail(lib, y, batch, k_log, l_log, tail, table, "col_fft", stream)
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

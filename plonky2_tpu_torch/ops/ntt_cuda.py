"""Binding of the hand-written NTT butterfly kernels (csrc/ntt.cu), built
at first use by ops/cuda_build.py.

``col_fft`` runs DIT stages ``first_stage..k_log-1`` along axis -2 of a
``[..., 2^k_log, L]`` tensor (the four-step NTT's passes, ops/ntt.py
``_fft_rows``); ``row_fft`` runs stages ``first_stage..n_log-1`` along the
last axis of ``[..., 2^n_log]`` rows (the flat transforms: every transform
under 2^16 points). Inputs are bit-reversed along the transform axis (or
seeded past ``first_stage``); no 1/N scaling. The kernels read the flat
per-stage twiddle table of ops/ntt.py ``stage_table`` (stage s at
[2^s - 1, 2^(s+1) - 1)) for the direction asked for.

Both run their stages in passes (stages in registers, tiles in shared
memory between stage groups): ``col_fft`` in the passes of ``col_plan``
(col_fft_kernel) and the stages past them (ntt_stage_kernel) one launch a
stage, in place on the output; ``row_fft`` in the one or two passes of
``row_plan`` (row_fft_kernel), which cover rows of up to 2^24 words. Every
launch adds one to the wrapper's entry of ``LAUNCHES``, there and nowhere
else; each call's form is noted in ``LAUNCH_SHAPES`` so a caller can
replay it against the plain version, and each launch's in cuda_build's
ring of recent launches. ``out`` places the result in a tensor of the
caller's. Every launch runs with the tensor's card current and on that
card's current stream, as the other bindings' do: csrc/ntt.cu raises the
passes' shared-memory limit in the current card's context.

Nothing here runs at import: the module imports on a machine without a
GPU or ``nvcc``; only a call needs them.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import torch

from . import cuda_build
from .cuda_build import INT, LL, VP, Library, raise_on

I64 = torch.int64

LIB = Library(
    "ntt", "ntt.cu", ("goldilocks.cuh",),
    {
        "plonky2_col_fft_pass": [VP, VP, LL] + [INT] * 7 + [VP, VP],
        "plonky2_row_fft_pass": [VP, VP, LL] + [INT] * 7 + [VP, VP],
        "plonky2_ntt_stage": [VP, LL, INT, INT, INT, VP, VP],
        "plonky2_ntt_current_device": [VP],
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
# Row passes (row_plan): tiles of at most 2^ROW_TILE_WORDS_LOG words, as the
# column passes' (rows of up to that many words run in one pass, longer
# ones in two, up to 2^ROW_TWO_PASS_LOG words; stages past that run as tail
# stages), residue tiles of at least 2^COL_MIN_LANES_LOG lanes, and as
# large as leaves at least ROW_TARGET_BLOCKS blocks a pass where the tensor
# allows: three waves of the 132 SMs x 3 blocks the 64 KB tiles let run at
# once, so the last wave's idle SMs cost little (on the H100 5-30 % less
# time than one block an SM at the forms of 2^15 words from stage 3,
# perf_logs/pr06_ntt_variants_run3.log, row_target_blocks1188).
ROW_TILE_WORDS_LOG = COL_TILE_WORDS_LOG
ROW_TWO_PASS_LOG = 2 * ROW_TILE_WORDS_LOG - COL_MIN_LANES_LOG
ROW_TARGET_BLOCKS = 9 * 132
# threads a block at most (NTT_ROW_THREADS in csrc/ntt.cu); stage groups of
# at most ROW_RADIX_LOG stages (8 words a thread): on the H100 they beat
# 4-stage groups at every main-path row form but (20, 2^15) from stage 3
# (+3 %), by up to 2.2x at (2, 2^15), where twice the sets keep twice the
# warps busy (perf_logs/pr06_ntt_variants_run2.log, row_radix3; run3,
# row_radix4)
ROW_THREADS = 256
ROW_RADIX_LOG = 3

# launches of each wrapper's kernels since the process started (or since
# reset_launches): pass and tail-stage launches alike
LAUNCHES = {"col_fft": 0, "row_fft": 0}
# distinct call forms: col_fft (batch, k_log, L, first_stage, inverse);
# row_fft (rows, n_log, first_stage, inverse)
LAUNCH_SHAPES = {"col_fft": set(), "row_fft": set()}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LAUNCH_SHAPES[k].clear()
    cuda_build.reset_launches()


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


def _twiddles(n_log: int, inverse: bool, x: torch.Tensor) -> torch.Tensor:
    table = _table(n_log, inverse, x.device)
    if table.device != x.device:
        raise ValueError(f"ntt: twiddle table on {table.device}, tensor on {x.device}")
    return table


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def library_device() -> int:
    """The device the library's CUDA runtime sees as current (no launch):
    the card that torch.cuda.device(...) made current."""
    device = ctypes.c_int(-1)
    raise_on(LIB.load().plonky2_ntt_current_device(ctypes.byref(device)), "ntt device")
    return device.value


def _tail(lib, y: torch.Tensor, batch: int, k_log: int, l_log: int, first: int,
          table: torch.Tensor, key: str, stream: int) -> None:
    for s in range(first, k_log):
        err = lib.plonky2_ntt_stage(y.data_ptr(), batch, k_log, l_log, s,
                                    table.data_ptr(), stream)
        cuda_build.note_launch("ntt_stage_kernel", (batch, k_log, l_log, s))
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


@dataclass(frozen=True)
class RowPass:
    """One launch of row_fft_kernel on the rows viewed as [rows *
    2^(n_log - k_log), 2^k_log]: stages [first, last) in tiles of
    2^rows_log aligned groups of 2^last words x 2^(last-first) positions x
    2^lanes_log neighbouring residues mod 2^first, the stages run in
    ``groups`` as for ColPass."""

    k_log: int
    first: int
    last: int
    lanes_log: int
    rows_log: int
    groups: tuple
    threads: int

    packed_groups = ColPass.packed_groups

    def tile_words_log(self) -> int:
        return self.rows_log + self.last - self.first + self.lanes_log

    def smem_bytes(self) -> int:
        return 8 << self.tile_words_log() if len(self.groups) > 1 else 0

    def batch(self, rows: int, n_log: int) -> int:
        """Rows of the pass's [batch, 2^k_log] view of [rows, 2^n_log]."""
        return rows << (n_log - self.k_log)

    def blocks(self, rows: int, n_log: int) -> int:
        """Blocks of the launch (plonky2_row_fft_pass's count)."""
        tiles = self.batch(rows, n_log) << (self.k_log - self.last)
        return -(-tiles >> self.rows_log) << (self.first - self.lanes_log)


def _largest(lo: int, hi: int, blocks, target: int) -> int:
    """The largest v in [lo, hi] whose blocks(v) (falling in v) reach
    ``target``; lo if none does."""
    return next((v for v in range(hi, lo, -1) if blocks(v) >= target), lo)


def _row_pass(rows, n_log, k_log, first, last, lanes_log, tile_words_log, radix_log, threads,
              target) -> RowPass:
    """The pass's tile takes as many rows (or chunks, or groups of 2^last
    words) as keep ``target`` blocks, within tile_words_log."""
    n = last - first
    groups = _groups(n, radix_log)

    def make(rows_log):
        sets = 1 << (rows_log + n + lanes_log - max(groups))
        return RowPass(k_log, first, last, lanes_log, rows_log, groups,
                       min(threads, max(32, sets)))

    rows_log = _largest(0, tile_words_log - n - lanes_log,
                        lambda r: make(r).blocks(rows, n_log), target)
    return make(rows_log)


@lru_cache(maxsize=None)
def row_plan(rows: int, n_log: int, first_stage: int, *,
             tile_words_log: int = ROW_TILE_WORDS_LOG, radix_log: int = ROW_RADIX_LOG,
             split_at: int = None, threads: int = ROW_THREADS,
             target_blocks: int = ROW_TARGET_BLOCKS):
    """How row_fft runs stages first_stage..n_log-1 along the rows of
    [rows, 2^n_log]: (the row_fft_kernel passes, in order; the first stage
    of the tail, which runs one stage a launch up to n_log - 1).

    Rows of up to 2^tile_words_log words run in one pass on whole rows
    (the lanes are the 2^first_stage residues, so a tile is whole
    contiguous rows). Longer rows run in two: stages [first_stage, a) on
    each contiguous 2^a-word chunk, then stages [a, n_log) (at most up to
    2^ROW_TWO_PASS_LOG) on tiles of 2^(n_log-a) positions x 2^lt
    neighbouring residues mod 2^a, lt >= COL_MIN_LANES_LOG (runs of 32
    bytes). The split a (or ``split_at``) is the one that keeps the most
    blocks in the pass with fewer, up to target_blocks; then fewer passes,
    then fewer stage groups, then the larger a. Each pass's tile is as
    large as keeps target_blocks blocks (the lanes of the second, the rows
    or chunks of the first). The keyword arguments are the variants
    tools/torch_ntt_variants.py times; row_fft takes the defaults."""
    def args(k_log, first, last, lanes_log):
        return (rows, n_log, k_log, first, last, lanes_log, tile_words_log, radix_log,
                threads, target_blocks)

    if first_stage >= n_log:
        return (), n_log
    if n_log <= tile_words_log:
        return (_row_pass(*args(n_log, first_stage, n_log, first_stage)),), n_log
    head = min(n_log, 2 * tile_words_log - COL_MIN_LANES_LOG)
    if first_stage >= head:
        return (), first_stage
    min_lanes = COL_MIN_LANES_LOG
    best = None
    for a in range(first_stage, min(head - 1, tile_words_log) + 1):
        if split_at is not None and a != split_at:
            continue
        if head - a + min(a, min_lanes) > tile_words_log:
            continue
        passes = []
        if a > first_stage:
            passes.append(_row_pass(*args(a, first_stage, a, first_stage)))
        most = min(a, tile_words_log - (head - a))
        lanes_log = _largest(
            min(a, min_lanes), most,
            lambda lt: RowPass(n_log, a, head, lt, 0, (), 0).blocks(rows, n_log),
            target_blocks)
        passes.append(_row_pass(*args(n_log, a, head, lanes_log)))
        score = (min(min(p.blocks(rows, n_log) for p in passes), target_blocks),
                 -len(passes), -sum(len(p.groups) for p in passes), a)
        if best is None or score > best[0]:
            best = (score, tuple(passes))
    if best is None:
        raise ValueError(f"row plan: no split for n_log={n_log}, first={first_stage}, "
                         f"split_at={split_at}")
    return best[1], head


def col_fft(x: torch.Tensor, k_log: int, first_stage: int, inverse: bool,
            out: torch.Tensor = None) -> torch.Tensor:
    """DIT stages first_stage..k_log-1 along axis -2 of x: [..., 2^k_log, L]
    (L a power of two), with the inverse roots if ``inverse``."""
    if x.ndim < 2 or x.shape[-2] != 1 << k_log:
        raise ValueError(f"col fft: shape {tuple(x.shape)} for k_log={k_log}")
    _check(x, "col fft")
    l_log = _log2(x.shape[-1], "col fft lanes")
    batch = x.numel() >> (k_log + l_log)
    if out is None:
        y = torch.empty_like(x)
    else:
        y = cuda_build.check_out(out, x.shape, x, "col fft")
    if x.numel() == 0:
        return y
    passes, tail = col_plan(k_log, l_log, first_stage)
    if not passes:
        y.copy_(x)
        if tail >= k_log:
            return y
    lib = LIB.load()
    table = _twiddles(k_log, inverse, x)
    with torch.cuda.device(x.device):
        stream = _stream(x)
        src = x
        for p in passes:
            err = lib.plonky2_col_fft_pass(
                src.data_ptr(), y.data_ptr(), batch, k_log, l_log, p.first, p.last,
                p.lanes_log, p.packed_groups(), p.threads, table.data_ptr(), stream,
            )
            cuda_build.note_launch("col_fft_kernel", (batch, k_log, l_log, p))
            raise_on(err, "col fft pass")
            LAUNCHES["col_fft"] += 1
            src = y
        _tail(lib, y, batch, k_log, l_log, tail, table, "col_fft", stream)
    LAUNCH_SHAPES["col_fft"].add((batch, k_log, 1 << l_log, first_stage, bool(inverse)))
    return y


def row_fft(x: torch.Tensor, n_log: int, first_stage: int, inverse: bool,
            out: torch.Tensor = None) -> torch.Tensor:
    """DIT stages first_stage..n_log-1 along the last axis of x:
    [..., 2^n_log], with the inverse roots if ``inverse``, in the passes of
    ``row_plan``."""
    if x.ndim < 1 or x.shape[-1] != 1 << n_log:
        raise ValueError(f"row fft: shape {tuple(x.shape)} for n_log={n_log}")
    _check(x, "row fft")
    if out is None:
        y = torch.empty_like(x)
    else:
        y = cuda_build.check_out(out, x.shape, x, "row fft")
    if x.numel() == 0:
        return y
    rows = x.numel() >> n_log
    passes, tail = row_plan(rows, n_log, first_stage)
    if not passes:
        y.copy_(x)
        if tail >= n_log:
            return y
    lib = LIB.load()
    table = _twiddles(n_log, inverse, x)
    with torch.cuda.device(x.device):
        stream = _stream(x)
        src = x
        for p in passes:
            err = lib.plonky2_row_fft_pass(
                src.data_ptr(), y.data_ptr(), p.batch(rows, n_log), p.k_log, p.first, p.last,
                p.lanes_log, p.rows_log, p.packed_groups(), p.threads, table.data_ptr(), stream,
            )
            cuda_build.note_launch("row_fft_kernel", (rows, n_log, p))
            raise_on(err, "row fft pass")
            LAUNCHES["row_fft"] += 1
            src = y
        _tail(lib, y, rows, n_log, 0, tail, table, "row_fft", stream)
    LAUNCH_SHAPES["row_fft"].add((rows, n_log, first_stage, bool(inverse)))
    return y

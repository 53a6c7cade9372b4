"""Binding of the hand-written Poseidon kernels (csrc/poseidon.cu), built
at first use by ops/cuda_build.py.

Each wrapper checks its tensors, allocates the output, launches on
PyTorch's current stream without synchronising, raises if the launch was
refused, and adds one to its entry of ``LAUNCHES`` — there and nowhere
else, so a caller can show that a run went through the kernels. The
shape of each launch is noted in ``LAUNCH_SHAPES`` at the same place, so
a caller can hold the kernel against its plain version at exactly the
shapes a run gave it, and in cuda_build's ring of recent launches.
``out`` places a result in a tensor of the caller's.

Nothing here runs at import: the module imports on a machine without a
GPU or ``nvcc``; only a call needs them.
"""

from __future__ import annotations

import torch

from . import cuda_build
from .cuda_build import INT, LL, ULL, VP, Library, raise_on
from .gf import I64

LIB = Library(
    "poseidon", "poseidon.cu", ("goldilocks.cuh", "poseidon_constants.cuh"),
    {
        "plonky2_poseidon_permute": [VP, VP, LL, VP],
        "plonky2_poseidon_compress": [VP, VP, LL, VP],
        "plonky2_poseidon_sponge": [VP, VP, LL, INT, ULL, VP],
    },
)

# launches of each kernel since the process started (or since reset_launches)
LAUNCHES = {"permute": 0, "compress": 0, "sponge": 0}
# distinct shapes launched since then: permute B; compress B; sponge (B, w, cap_val)
LAUNCH_SHAPES = {"permute": set(), "compress": set(), "sponge": set()}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LAUNCH_SHAPES[k].clear()
    cuda_build.reset_launches()


def _check(x: torch.Tensor, width, what: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {x.device}")
    if x.dtype != I64:
        raise ValueError(f"{what}: expected int64 (u64 bit container), got {x.dtype}")
    if x.ndim != 2 or (width is not None and x.shape[1] != width) or x.shape[1] < 1:
        raise ValueError(f"{what}: bad shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")


def permute(state: torch.Tensor, out: torch.Tensor = None) -> torch.Tensor:
    """[B, 12] canonical states on the GPU -> their Poseidon permutations."""
    _check(state, 12, "poseidon permute")
    lib = LIB.load()
    if out is None:
        out = torch.empty_like(state)
    else:
        cuda_build.check_out(out, state.shape, state, "poseidon permute")
    b = state.shape[0]
    if b == 0:
        return out
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.plonky2_poseidon_permute(state.data_ptr(), out.data_ptr(), b, stream)
    cuda_build.note_launch("poseidon_permute_kernel", b)
    raise_on(err, "poseidon permute")
    LAUNCHES["permute"] += 1
    LAUNCH_SHAPES["permute"].add(b)
    return out


def compress(pairs: torch.Tensor, out: torch.Tensor = None) -> torch.Tensor:
    """[B, 8] canonical words on the GPU (left digest, right digest) ->
    [B, 4]: lanes 0..3 of the permutation of (pairs, 0, 0, 0, 0)."""
    _check(pairs, 8, "poseidon compress")
    lib = LIB.load()
    b = pairs.shape[0]
    if out is None:
        out = torch.empty((b, 4), dtype=I64, device=pairs.device)
    else:
        cuda_build.check_out(out, (b, 4), pairs, "poseidon compress")
    if b == 0:
        return out
    with torch.cuda.device(pairs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.plonky2_poseidon_compress(pairs.data_ptr(), out.data_ptr(), b, stream)
    cuda_build.note_launch("poseidon_compress_kernel", b)
    raise_on(err, "poseidon compress")
    LAUNCHES["compress"] += 1
    LAUNCH_SHAPES["compress"].add(b)
    return out


def sponge(rows: torch.Tensor, cap_val: int, out: torch.Tensor = None) -> torch.Tensor:
    """[B, w] canonical rows on the GPU, 16-byte aligned -> [B, 4]
    overwrite-mode sponge digests with capacity lane 8 preset to cap_val."""
    _check(rows, None, "poseidon sponge")
    if rows.data_ptr() % 16:
        raise ValueError("poseidon sponge: rows must start on a 16-byte boundary (cp.async)")
    lib = LIB.load()
    b, w = rows.shape
    if out is None:
        out = torch.empty((b, 4), dtype=I64, device=rows.device)
    else:
        cuda_build.check_out(out, (b, 4), rows, "poseidon sponge")
    if b == 0:
        return out
    cap = int(cap_val) & ((1 << 64) - 1)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.plonky2_poseidon_sponge(
            rows.data_ptr(), out.data_ptr(), b, w, cap, stream,
        )
    form = (b, w, cap)
    cuda_build.note_launch("poseidon_sponge_kernel", form)
    raise_on(err, "poseidon sponge")
    LAUNCHES["sponge"] += 1
    LAUNCH_SHAPES["sponge"].add(form)
    return out

"""Binding of the hand-written Goldilocks product kernel (csrc/field.cu),
built at first use by ops/cuda_build.py.

``mul`` takes the three call forms of ops/gf.py::mul — two tensors of one
shape, two tensors that broadcast against each other, a tensor and a
Python int — and hands the kernel the broadcast shape with each operand's
element strides (0 along broadcast axes), so neither operand is expanded
into a copy. Axes that are contiguous for both operands are merged first.

The wrapper checks its tensors, allocates the output, launches on
PyTorch's current stream without synchronising, raises if the launch was
refused, and adds one to ``LAUNCHES["mul"]`` — there and nowhere else.
The form of each launch (merged sizes and both operands' strides, the
int operand as None) is noted in ``LAUNCH_SHAPES``, so a caller can hold
the kernel against its plain version at exactly the forms a run used,
and in cuda_build's ring of recent launches. ``out`` places the result
in a tensor of the caller's.

Nothing here runs at import: the module imports on a machine without a
GPU or ``nvcc``; only a call needs them.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import cuda_build
from .cuda_build import INT, LL, ULL, VP, Library, raise_on

I64 = torch.int64
P = 0xFFFF_FFFF_0000_0001
MAX_DIMS = 6  # GL_MUL_MAX_DIMS in csrc/field.cu

LIB = Library(
    "field", "field.cu", ("goldilocks.cuh",),
    {"plonky2_gl_mul": [VP, VP, ULL, VP, LL, INT, VP, VP, VP, INT, VP]},
)

LAUNCHES = {"mul": 0}
# distinct launch forms: (sizes, a_strides, b_strides or None for an int)
LAUNCH_SHAPES = {"mul": set()}


def reset_launches() -> None:
    LAUNCHES["mul"] = 0
    LAUNCH_SHAPES["mul"].clear()
    cuda_build.reset_launches()


def merge_axes(shape: Sequence[int], *strides: Sequence[int]) -> Tuple[List[int], List[List[int]]]:
    """Drop unit axes and merge each axis into the next inner one where
    that is a plain reshape for every stride list. Returns (sizes, one
    stride list per input); at least one axis."""
    dims = [(size, [st[d] for st in strides]) for d, size in enumerate(shape) if size != 1]
    if not dims:
        return [1], [[0] for _ in strides]
    merged = [dims[-1]]
    for size, st in reversed(dims[:-1]):
        inner_size, inner_st = merged[-1]
        if all(o == i * inner_size for o, i in zip(st, inner_st)):
            merged[-1] = (size * inner_size, inner_st)
        else:
            merged.append((size, st))
    merged.reverse()
    sizes = [size for size, _ in merged]
    return sizes, [[st[k] for _, st in merged] for k in range(len(strides))]


def wide_index(sizes: Sequence[int], *strides: Sequence[int]) -> bool:
    """Whether a launch over the merged ``sizes`` with these operand strides
    takes the kernel's 64-bit-index instantiation: some offset of the
    output or of an operand reaches 2^31 (32-bit offsets otherwise)."""
    span = max([int(np.prod(sizes, dtype=np.int64))] +
               [1 + sum((n - 1) * st for n, st in zip(sizes, sts)) for sts in strides])
    return span >= 1 << 31


def _check(x: torch.Tensor, what: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {x.device}")
    if x.dtype != I64:
        raise ValueError(f"{what}: expected int64 (u64 bit container), got {x.dtype}")


def mul(a: torch.Tensor, b, out: torch.Tensor = None) -> torch.Tensor:
    """a * b mod p for canonical CUDA tensors (broadcasting), or a tensor
    and a Python int; the output is a new contiguous tensor, or ``out``."""
    _check(a, "gl mul")
    if isinstance(b, int):
        shape = a.shape
        c = b % P
        sizes, (sa,) = merge_axes(shape, a.stride())
        sb = [0] * len(sizes)
        b_ptr = None
    else:
        _check(b, "gl mul")
        if b.device != a.device:
            raise ValueError(f"gl mul: operands on {a.device} and {b.device}")
        shape = torch.broadcast_shapes(a.shape, b.shape)
        ae, be = a.expand(shape), b.expand(shape)
        sizes, (sa, sb) = merge_axes(shape, ae.stride(), be.stride())
        c = 0
        b_ptr = b.data_ptr()
    if len(sizes) > MAX_DIMS:
        raise ValueError(f"gl mul: {len(sizes)} axes after merging, at most {MAX_DIMS}")
    if out is None:
        out = torch.empty(shape, dtype=I64, device=a.device)
    else:
        cuda_build.check_out(out, shape, a, "gl mul")
    n = out.numel()
    if n == 0:
        return out
    lib = LIB.load()
    arr = ctypes.c_longlong * len(sizes)
    form = (tuple(sizes), tuple(sa), None if b_ptr is None else tuple(sb))
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.plonky2_gl_mul(
            a.data_ptr(), b_ptr, c, out.data_ptr(), n, len(sizes),
            arr(*sizes), arr(*sa), arr(*sb), int(wide_index(sizes, sa, sb)), stream,
        )
    cuda_build.note_launch("gl_mul_kernel", form)
    raise_on(err, "gl mul")
    LAUNCHES["mul"] += 1
    LAUNCH_SHAPES["mul"].add(form)
    return out

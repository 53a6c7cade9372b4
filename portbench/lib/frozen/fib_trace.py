"""The Fibonacci STARK's trace, made on the device and handed over as a
host array.

A transcription of plonky2_tpu_torch/stark/fixtures.py:60-92 (_std_fib,
_fib_seq) and of FibonacciStark.generate_trace (fixtures.py:38-43) from
numpy to plain PyTorch over reference/field.py's arithmetic: the standard
Fibonacci numbers by vectorised doubling, F(m+j) = F(m)F(j+1) + F(m-1)F(j)
turning F[0..m] into F[0..2m-1] in one pass, then
f(i) = F(i-1) x0 + F(i) x1. The standard numbers are kept per length and
device, so each further trace of that length costs two products and a
sum."""

from __future__ import annotations

import numpy as np
import torch

from ...reference import field as F

_STD = {}


def _std_fib(n: int, device) -> torch.Tensor:
    """F[0..n] mod p (F(0)=0, F(1)=1)."""
    out = torch.zeros(n + 1, dtype=torch.int64, device=device)
    out[1:3] = 1
    m = 2
    while m < n:
        k = min(m - 1, n - m)
        j = torch.arange(1, k + 1, device=device)
        out[m + 1:m + k + 1] = F.add(F.mul(out[m], out[j + 1]), F.mul(out[m - 1], out[j]))
        m += k
    return out


def fibonacci_trace(num_rows: int, x0: int, x1: int, device="cpu"):
    """(trace [2, num_rows] as a host uint64 array, public inputs
    [x0, x1, f(num_rows)]); f(0) = x0, f(1) = x1, f(i) = f(i-1) + f(i-2)."""
    n = num_rows + 1
    key = (n, str(device))
    if key not in _STD:
        std = _std_fib(n, device)
        _STD[key] = (torch.cat([torch.ones(1, dtype=torch.int64, device=device), std[:n - 1]]),
                     std[:n])
    fm1, fs = _STD[key]
    f = F.add(F.mul(fm1, F.const(x0, device)), F.mul(fs, F.const(x1, device)))
    f = f.cpu().numpy().view(np.uint64)
    return np.stack([f[:-1], f[1:]]), [x0 % F.P, x1 % F.P, int(f[num_rows])]

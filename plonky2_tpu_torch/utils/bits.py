"""Bit utilities (reference: util/src/lib.rs:14-255)."""

from __future__ import annotations

from functools import lru_cache

import numpy as np


def log2_strict(n: int) -> int:
    assert n > 0 and (n & (n - 1)) == 0, f"{n} is not a power of two"
    return n.bit_length() - 1


def log2_ceil(n: int) -> int:
    return 0 if n <= 1 else (n - 1).bit_length()


def reverse_bits(x: int, n_bits: int) -> int:
    r = 0
    for _ in range(n_bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


@lru_cache(maxsize=None)
def reverse_index_bits_perm(n: int) -> np.ndarray:
    """Permutation p with p[i] = reverse_bits(i, log2(n)), as int32."""
    bits = log2_strict(n)
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev.astype(np.int32)


def reverse_index_bits(arr: np.ndarray) -> np.ndarray:
    """Permute the last axis by bit-reversed index."""
    n = arr.shape[-1]
    return arr[..., reverse_index_bits_perm(n)]

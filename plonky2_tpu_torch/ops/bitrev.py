"""Bit-reversal permutation along one axis of a tensor.

``out[i] = x[rev(i)]`` with rev the log2(n)-bit reversal (an involution).
One gather through an index tensor, cached per (length, device).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.bits import reverse_index_bits_perm

_PERM_CACHE = {}


def bitrev_perm(n: int, device) -> torch.Tensor:
    """The bit-reversal permutation of range(n) as an int64 index tensor."""
    key = (n, str(device))
    if key not in _PERM_CACHE:
        perm = np.asarray(reverse_index_bits_perm(n), dtype=np.int64)
        _PERM_CACHE[key] = torch.from_numpy(perm).to(device)
    return _PERM_CACHE[key]


def bitrev_axis(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    n = x.shape[axis]
    if n <= 2:
        return x
    return torch.index_select(x, axis % x.ndim, bitrev_perm(n, x.device))

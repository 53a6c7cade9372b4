"""The traces of the two-table cross-table-lookup system, made on the host.

Frozen copy of the trace half of chip_smoke.ctl_system
(chip_smoke.py:2857-2869) with CtlLookingStark.generate_trace and
CtlLookedStark.generate_trace (plonky2_tpu_torch/stark/fixtures.py:
_offsets, 188-190, 213-226): the looking table's columns are x0 + i and
x0 + n + i (mod p) for i < n; the looked table holds those 2n values in an
order shuffled by numpy's default_rng(shuffle_seed), every row flagged."""

from __future__ import annotations

import numpy as np

P = 0xFFFF_FFFF_0000_0001


def ctl_traces(log_rows, x0: int, shuffle_seed: int):
    """[looking trace [2, 2^log_rows[0]], looked trace [2, 2^log_rows[1]]],
    uint64."""
    n = 1 << log_rows[0]
    values = np.uint64(x0 % P) + np.arange(2 * n, dtype=np.uint64)  # < 2^64: no wrap
    values = np.where(values >= np.uint64(P), values - np.uint64(P), values)
    looking = np.stack([values[:n], values[n:]])
    m = 1 << log_rows[1]
    assert 2 * n <= m
    col = np.zeros(m, dtype=np.uint64)
    flag = np.zeros(m, dtype=np.uint64)
    col[: 2 * n] = values[np.random.default_rng(shuffle_seed).permutation(2 * n)]
    flag[: 2 * n] = 1
    return [looking, np.stack([col, flag])]

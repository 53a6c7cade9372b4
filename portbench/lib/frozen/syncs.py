"""Counting the synchronising CUDA operations a stretch of host code makes.

Frozen copy of chip_smoke.count_syncs (chip_smoke.py:1624-1640), split
into a start and a stop so that it can stay on across a window: CUDA's
sync debug mode set to "warn" makes PyTorch warn at every synchronising
operation, and the warnings are counted."""

from __future__ import annotations

import warnings

import torch


class SyncCounter:
    def __enter__(self):
        self._catch = warnings.catch_warnings(record=True)
        self.caught = self._catch.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)
        self._catch.__exit__(*exc)
        return False

    @property
    def count(self) -> int:
        return sum(1 for w in self.caught if "synchroniz" in str(w.message))

"""Hierarchical scoped timing (reference: plonky2/src/util/timing.rs:8-154
TimingTree / timed! macro). Enabled explicitly or via PLONKY2_TPU_TIMING=1."""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import List, Optional


class _Scope:
    __slots__ = ("name", "start", "duration", "children")

    def __init__(self, name: str):
        self.name = name
        self.start = time.perf_counter()
        self.duration: Optional[float] = None
        self.children: List["_Scope"] = []


class TimingTree:
    def __init__(self, name: str = "root", enabled: Optional[bool] = None):
        if enabled is None:
            enabled = os.environ.get("PLONKY2_TPU_TIMING", "") not in ("", "0")
        self.enabled = enabled
        self.root = _Scope(name)
        self._stack = [self.root]

    @contextmanager
    def scope(self, name: str):
        if not self.enabled:
            yield
            return
        s = _Scope(name)
        self._stack[-1].children.append(s)
        self._stack.append(s)
        try:
            yield
        finally:
            s.duration = time.perf_counter() - s.start
            self._stack.pop()

    def timed(self, name: str, fn, *args, **kwargs):
        with self.scope(name):
            return fn(*args, **kwargs)

    def print(self, min_delta: float = 0.0) -> str:
        self.root.duration = time.perf_counter() - self.root.start
        lines: List[str] = []

        def walk(s: _Scope, depth: int):
            if s.duration is not None and s.duration >= min_delta:
                lines.append(f"{'  ' * depth}{s.duration:.4f}s {s.name}")
            for c in s.children:
                walk(c, depth + 1)

        walk(self.root, 0)
        out = "\n".join(lines)
        if self.enabled:
            print(out)
        return out

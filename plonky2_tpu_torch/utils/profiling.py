"""Tracing/profiling: the counterpart of the reference's TimingTree + PGO
pipeline (reference plonky2/src/util/timing.rs:8-154) on a CUDA card.

Three layers:

* ``trace(dir)`` — capture a torch.profiler trace (CPU and, where there
  is one, CUDA activity) around any region and write it to
  ``dir/trace.json`` in Chrome's trace format (chrome://tracing,
  Perfetto): every kernel with its device time, every annotated span.
* ``annotate(label)`` — a named host span that shows up inside traces
  (torch.profiler.record_function, and an NVTX range where CUDA is
  present), used to mark the prover's steps so that kernel time is
  attributed to wires commit / quotient / FRI and so on. It never
  waits for the device.
* ``roofline(...)`` — speed-of-light accounting: given the bytes a kernel
  must move and the integer operations it must execute, report achieved
  GB/s and operations a second against the card's peaks. The peaks live
  here, and chip_smoke.py's bounds read them.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from dataclasses import dataclass

import torch

# NVIDIA H100 SXM (data sheet): device memory 3.35 TB/s; float32 outside the
# tensor cores 67 TFLOP/s. An SM issues 64 int32 lanes a clock against 128
# float32 lanes, so the integer multiply-add peak is taken as half of that:
# 33.5e12 integer operations a second, a multiply-add counted as two.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed region and write ``log_dir/trace.json``;
    yields the torch.profiler session (its ``key_averages()`` and
    ``events()`` are readable after the block)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def kernel_rows(prof) -> list:
    """The rows of a profiler session's ``key_averages()`` that are device
    kernels: CUDA rows, without the device-side copies of ``annotate``
    spans (user annotations, which would otherwise count as kernels and
    add their whole duration to device time). Raises if a prover span
    still shows among them (a torch whose events do not mark annotations)."""
    from torch.autograd import DeviceType

    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    spans = [e.key for e in rows if e.key.startswith("prove/")]
    if spans:
        raise RuntimeError(f"profiler rows of annotate spans counted as kernels: {spans}")
    return rows


@contextlib.contextmanager
def annotate(label: str):
    """Named span visible in profiler traces (and NVTX timelines); nests
    like TimingTree. Costs a host-side record and no device wait."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(label):
        if nvtx:
            torch.cuda.nvtx.range_push(label)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


@dataclass
class Roofline:
    name: str
    seconds: float
    bytes_moved: int
    int_ops: int

    @property
    def achieved_gbs(self) -> float:
        return self.bytes_moved / self.seconds / 1e9

    @property
    def achieved_gops(self) -> float:
        return self.int_ops / self.seconds / 1e9

    @property
    def bytes_seconds(self) -> float:
        return self.bytes_moved / HBM_BYTES_PER_S

    @property
    def ops_seconds(self) -> float:
        return self.int_ops / INT32_OPS_PER_S

    @property
    def sol_seconds(self) -> float:
        """Max of the bandwidth and compute lower bounds."""
        return max(self.bytes_seconds, self.ops_seconds)

    @property
    def pct_sol(self) -> float:
        return 100.0 * self.sol_seconds / self.seconds

    @property
    def bound(self) -> str:
        return "bytes" if self.bytes_seconds > self.ops_seconds else "operations"

    def as_dict(self) -> dict:
        return {
            "kernel": self.name,
            "time_ms": self.seconds * 1e3,
            "achieved_gbs": self.achieved_gbs,
            "achieved_gops_int": self.achieved_gops,
            "sol_ms": self.sol_seconds * 1e3,
            "pct_sol": self.pct_sol,
            "bound": self.bound,
        }


def roofline(name: str, seconds: float, bytes_moved: int, int_ops: int = 0) -> Roofline:
    return Roofline(name, seconds, bytes_moved, int_ops)


def _wait(out) -> None:
    """Wait for the device work behind ``out`` (a tensor, or a tuple or
    list of them); nothing to wait for on the CPU."""
    items = out if isinstance(out, (tuple, list)) else (out,)
    for t in items:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)


def timed_device(fn, *args, warmup: int = 2, iters: int = 5) -> float:
    """Median wall seconds of fn(*args), each call waited for on the
    device it ran on (torch.cuda.synchronize) — the measurement half of a
    roofline entry."""
    for _ in range(warmup):
        _wait(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _wait(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)

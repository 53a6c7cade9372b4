"""The port's tracing/profiling layer (plonky2_tpu_torch/utils/profiling.py;
the JAX package's tests/test_profiling.py): roofline accounting against the
H100 constants it states, a torch.profiler trace file with an annotated
span, and timed_device. On the CPU: the trace holds host activity only."""

import json

import pytest

from _torch_port import lazy_module

prof = lazy_module("plonky2_tpu_torch.utils.profiling")


def test_constants_are_the_h100s():
    assert prof.HBM_BYTES_PER_S == 3.35e12
    assert prof.INT32_OPS_PER_S == 33.5e12


def test_roofline_accounting():
    # 1 GiB moved in 2 ms: 536.9 GB/s; the bound is bytes / 3.35 TB/s
    r = prof.roofline("x", seconds=2e-3, bytes_moved=1 << 30, int_ops=1000)
    assert r.achieved_gbs == pytest.approx((1 << 30) / 2e-3 / 1e9, rel=1e-12)
    assert r.sol_seconds == pytest.approx((1 << 30) / 3.35e12, rel=1e-12)
    assert r.bound == "bytes"
    assert r.pct_sol == pytest.approx(100 * (1 << 30) / 3.35e12 / 2e-3, rel=1e-12)
    d = r.as_dict()
    assert d["kernel"] == "x" and d["bound"] == "bytes" and "pct_sol" in d
    r2 = prof.roofline("y", seconds=1e-3, bytes_moved=8, int_ops=10**12)
    assert r2.bound == "operations"
    assert r2.sol_seconds == pytest.approx(10**12 / 33.5e12, rel=1e-12)


def test_annotate_and_trace(tmp_path):
    import torch

    log_dir = tmp_path / "trace"
    with prof.trace(str(log_dir)) as session:
        with prof.annotate("test/phase"):
            (torch.arange(8) * 2).sum()
    path = log_dir / prof.TRACE_FILE
    assert path.exists()
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "test/phase" in names
    assert any(e.key == "test/phase" for e in session.key_averages())


def test_kernel_rows_leave_out_spans_and_host_ops(tmp_path):
    """On the CPU a session has no CUDA rows: kernel_rows is empty, the
    annotated span and the host ops are not counted as kernels."""
    import torch

    with prof.trace(str(tmp_path)) as session:
        with prof.annotate("prove/quotient"):
            (torch.arange(8) + 1).sum()
    assert prof.kernel_rows(session) == []


def test_annotate_outside_a_trace_is_transparent():
    with prof.annotate("idle"):
        x = 1 + 1
    assert x == 2


def test_timed_device_returns_seconds():
    import torch

    t = prof.timed_device(lambda x: x + 1, torch.arange(128), warmup=1, iters=2)
    assert 0 < t < 60

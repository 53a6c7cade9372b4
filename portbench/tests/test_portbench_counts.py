"""The rooflines' yardstick: each op group's least work against shapes
worked by hand, the frozen bounds, and the reduction of profiler events to
device time a call, busy time and idle gaps."""

from __future__ import annotations

import pytest

from portbench.counts import _bounds, gl_mul, ntt, poseidon
from portbench.lib.trace import GroupTracer, reduce_events


class OnCard:
    """Shape and size of a tensor on the card, without one."""

    is_cuda = True

    def __init__(self, *shape):
        self.shape = shape

    def numel(self):
        n = 1
        for s in self.shape:
            n *= s
        return n


def test_ntt_counts():
    # [2, 2^10] inverse transform: 2 x 1024 words in and out, 2 x 512 x 10 products
    assert ntt.work("ifft", (OnCard(2, 1024),), {}, OnCard(2, 1024)) == (4096, 2 * 512 * 10 * 8)
    # LDE of [3, 2^8] onto 2^11 points: 2^3 transforms of 2^8 points a poly
    assert ntt.work("lde_onto_coset", (OnCard(3, 256), 3), {}, OnCard(3, 2048)) == (
        768 + 6144, 3 * 8 * 128 * 8 * 8)
    assert ntt.work("fft", (type("Host", (), {"is_cuda": False})(),), {}, None) is None


def test_poseidon_counts():
    P = _bounds.OPS_PER_PERMUTATION
    # a tree over 2^10 leaves of 20 words, cap height 4: 3 absorptions a leaf,
    # 1008 compressions; the leaves read, 1024 + 1008 digests written
    assert poseidon.work("build_merkle_tree", (OnCard(1024, 20), 4), {}, None) == (
        20480 + 4 * 2032, (3072 + 1008) * P)
    assert poseidon.work("compress_pairs", (OnCard(64, 4),), {}, None) == (12 * 32, 32 * P)
    assert poseidon.work("permute", (OnCard(5, 12),), {}, None) == (120, 5 * P)
    assert poseidon.work("hash_leaf", (OnCard(7, 9),), {}, None) == (63 + 28, 14 * P)
    assert P == 2 * (8 * (12 * 14 + 288) + 11 * 11 * 4 + 22 * (14 + 23 * 4)) == 12928


def test_gl_mul_counts():
    assert gl_mul.work("mul", (OnCard(4, 8), 5), {}, OnCard(4, 8)) == (65, 32 * 8)
    assert gl_mul.work("mul", (OnCard(4, 8), OnCard(1, 8)), {}, OnCard(4, 8)) == (72, 256)


def test_bounds_take_the_larger_of_bytes_and_operations():
    r = _bounds.bound_record(335_000_000, 0)  # 2.68 GB over 3.35 TB/s
    assert r["bound_by"] == "bytes" and r["bound_s"] == pytest.approx(0.0008)
    r = _bounds.bound_record(1, 33_500_000_000)
    assert r["bound_by"] == "operations" and r["bound_s"] == pytest.approx(1e-3)
    b = _bounds.butterfly_bound(2, 10, 10)
    assert b["bytes_s"] == pytest.approx(2 * 2048 * 8 / 3.35e12)


class Ev:
    def __init__(self, name, dev, start, dur, corr=0, linked=0, ua=False):
        self._v = (name, dev, start, dur, corr, linked, ua)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def test_reduce_events_attributes_device_time_to_calls():
    from torch.autograd import DeviceType

    C, G = DeviceType.CPU, DeviceType.CUDA
    tracer = GroupTracer({})
    tracer.calls = {0: ("ntt", 2 * 1024 * 1024, 0), 1: ("gl_mul", 3, 8)}
    events = [
        Ev("portbench-window", C, 0, 1000, 1, ua=True),
        Ev("portbench.ntt#0", C, 100, 200, 2, ua=True),
        Ev("cudaLaunchKernel", C, 150, 5, 11),
        Ev("col_fft_kernel", G, 300, 100, 11),
        Ev("portbench.ntt#0", G, 300, 100, 2, ua=True),  # the range's device copy
        Ev("phase:fri", C, 400, 400, 3, ua=True),
        Ev("portbench.gl_mul#1", C, 450, 50, 4, ua=True),
        Ev("cudaLaunchKernel", C, 460, 5, 12),
        Ev("gl_mul_kernel", G, 600, 50, 12),
        Ev("aten::add", C, 700, 10, 5),
        Ev("cudaLaunchKernel", C, 702, 5, 13, linked=5),
        Ev("add_kernel", G, 720, 30, 13, linked=5),
        Ev("Memcpy DtoH", G, 760, 20, 14),
    ]
    data = reduce_events(events, tracer)
    assert data.call_device_ns == {0: 100, 1: 50}
    assert data.kernel_count() == 3
    assert data.busy_s() == pytest.approx(200e-9)
    assert data.window_s == pytest.approx(1000e-9)
    # 16 MiB over 3.35 TB/s in 100 ns of device time
    assert data.group_roofline("ntt") == pytest.approx(100 * 16 * 2**20 / 3.35e12 / 100e-9)
    assert data.group_roofline("poseidon") is None
    gaps = dict(data.breakdown()["idle_gaps"])
    # a gap goes to the range open at its middle: [0,300) to the ntt call (150),
    # [400,600), [650,720) and [750,760) to fri, [780,1000) to the host
    assert gaps == pytest.approx({"op:ntt": 300e-9, "host": 220e-9, "phase:fri": 280e-9})
    assert (data.diagnostics["by_runtime"], data.diagnostics["unresolved"]) == (3, 1)

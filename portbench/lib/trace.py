"""The traced run: op-group wrappers, phase labels, the profiler, and the
reduction of its events to what the per-layer readers take.

Everything is kept in memory; no trace file is written.

Op groups (portbench/counts/<group>.py) name the program functions they
cover (TARGETS, reached by callers as module attributes) and the least
work of one call (``work``). In the traced run each target is replaced by
a wrapper that opens a profiler range ``portbench.<group>#<call>`` around
the outermost group call; a call made inside another group call runs
unwrapped and counts in the outer one. A device activity belongs to the
call during which the host launched it: its launch time is read from the
CUDA runtime event of the same correlation id, or else from the host op
it is linked to.
"""

from __future__ import annotations

import bisect
import importlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from ..counts._bounds import bound_record

GROUP_PREFIX = "portbench."
PHASE_PREFIX = "phase:"
WINDOW_LABEL = "portbench-window"
NAME_CHARS = 120  # a kernel's name in the breakdown, cut (templates run to 500)


class GroupTracer:
    """Wraps every op group's targets while installed; records, per
    outermost call, its group and its least work."""

    def __init__(self, groups: Dict[str, object]):
        self.groups = groups
        self.depth = 0
        self.calls: Dict[int, Tuple[str, int, int]] = {}
        self._next = 0
        self._saved = []

    def _wrap(self, group: str, gmod, name: str, orig):
        def wrapped(*args, **kwargs):
            if self.depth:
                return orig(*args, **kwargs)
            self.depth += 1
            i = self._next
            self._next += 1
            try:
                with torch.profiler.record_function(f"{GROUP_PREFIX}{group}#{i}"):
                    out = orig(*args, **kwargs)
            finally:
                self.depth -= 1
            w = gmod.work(name, args, kwargs, out)
            if w is not None:
                self.calls[i] = (group, int(w[0]), int(w[1]))
            return out

        return wrapped

    def install(self, phases=()):
        for group, gmod in self.groups.items():
            for modname, attr in gmod.TARGETS:
                mod = importlib.import_module(modname)
                orig = getattr(mod, attr)
                self._saved.append((mod, attr, orig))
                setattr(mod, attr, self._wrap(group, gmod, attr, orig))
        for modname, attr in phases:
            mod = importlib.import_module(modname)
            orig = getattr(mod, attr)
            self._saved.append((mod, attr, orig))
            setattr(mod, attr, _phase(attr, orig))

    def uninstall(self):
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved = []


def _phase(label: str, orig):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(PHASE_PREFIX + label):
            return orig(*args, **kwargs)

    return wrapped


@dataclass
class Activity:
    name: str
    start: int
    end: int
    kernel: bool
    launch: Optional[int]


@dataclass
class TraceData:
    """What the readers of per-layer metrics take from one traced window."""

    window_ns: Tuple[int, int]
    activities: List[Activity]
    host_ranges: List[Tuple[int, int, str]]  # (start, end, label), annotations only
    group_calls: Dict[int, Tuple[str, int, int]]
    call_device_ns: Dict[int, int] = field(default_factory=dict)
    diagnostics: Dict[str, int] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def busy_s(self) -> float:
        """Union of the device activities' intervals inside the window."""
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        lo, hi = self.window_ns
        spans = sorted((max(a.start, lo), min(a.end, hi)) for a in self.activities)
        merged: List[List[int]] = []
        for a, b in spans:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def kernel_count(self) -> int:
        return sum(1 for a in self.activities if a.kernel)

    def group_roofline(self, group: str) -> Optional[float]:
        """100 x (least time of the group's calls) / (device time of every
        activity they launched), over the calls that launched any."""
        bound_s = device_ns = 0
        for i, (g, words, ops) in self.group_calls.items():
            ns = self.call_device_ns.get(i, 0)
            if g != group or ns <= 0:
                continue
            bound_s += bound_record(words, ops)["bound_s"]
            device_ns += ns
        if device_ns == 0:
            return None
        return 100.0 * bound_s / (device_ns / 1e9)

    def span_seconds(self, label: str) -> List[float]:
        return [(b - a) / 1e9 for a, b, name in self.host_ranges if name == label]

    def labels_at(self, times: List[int]) -> List[str]:
        """For each of the ascending times, the innermost annotated host
        range open then (an op-group call as "op:<group>"), or "host"."""
        out, stack, k = [], [], 0
        for t in times:
            while k < len(self.host_ranges) and self.host_ranges[k][0] <= t:
                a, b, name = self.host_ranges[k]
                while stack and stack[-1][1] <= a:
                    stack.pop()
                stack.append((a, b, name))
                k += 1
            while stack and stack[-1][1] <= t:
                stack.pop()
            if not stack:
                out.append("host")
                continue
            name = stack[-1][2]
            if name.startswith(GROUP_PREFIX):
                name = "op:" + name[len(GROUP_PREFIX):].split("#")[0]
            out.append(name)
        return out

    def breakdown(self) -> dict:
        by_name: Dict[str, int] = {}
        for a in self.activities:
            by_name[a.name] = by_name.get(a.name, 0) + (a.end - a.start)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps: Dict[str, int] = {}
        busy = self.busy_intervals()
        lo, hi = self.window_ns
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        holes = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        for (a, b), label in zip(holes, self.labels_at([(a + b) // 2 for a, b in holes])):
            gaps[label] = gaps.get(label, 0) + (b - a)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
        return {
            "device_ops": [[name[:NAME_CHARS], ns / 1e9] for name, ns in ops],
            "idle_gaps": [[name, ns / 1e9] for name, ns in idle],
        }


def _is_annotation(e) -> bool:
    name = e.name()
    return (getattr(e, "is_user_annotation", lambda: False)()
            or name.startswith((GROUP_PREFIX, PHASE_PREFIX, WINDOW_LABEL, "prove/")))


def reduce_events(events, tracer: GroupTracer) -> TraceData:
    """Profiler events (the kineto results' ``events()``) -> TraceData."""
    from torch.autograd import DeviceType

    host, device = [], []
    for e in events:
        if e.device_type() == DeviceType.CPU:
            host.append(e)
        elif e.device_type() == DeviceType.CUDA and not _is_annotation(e):
            device.append(e)
    window = [e for e in host if e.name() == WINDOW_LABEL]
    if not window:
        raise RuntimeError("the profiler recorded no window range")
    w = window[-1]
    lo, hi = w.start_ns(), w.start_ns() + w.duration_ns()
    runtime = {e.correlation_id(): e.start_ns() for e in host
               if e.name().startswith("cu") and e.correlation_id()}
    linked_ops = {e.correlation_id(): e.start_ns() for e in host
                  if not e.name().startswith("cu") and e.correlation_id()}
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                    for e in host if _is_annotation(e) and e.name() != WINDOW_LABEL)
    diag = {"device_events": 0, "by_runtime": 0, "by_linked_op": 0, "unresolved": 0}
    acts = []
    for e in device:
        start = e.start_ns()
        if start < lo or start > hi:
            continue
        launch = runtime.get(e.correlation_id())
        if launch is not None:
            diag["by_runtime"] += 1
        else:
            launch = linked_ops.get(e.linked_correlation_id())
            diag["by_linked_op" if launch is not None else "unresolved"] += 1
        name = e.name()
        acts.append(Activity(name, start, start + e.duration_ns(),
                             not name.startswith(("Memcpy", "Memset")), launch))
    diag["device_events"] = len(acts)
    data = TraceData((lo, hi), acts, ranges, dict(tracer.calls), diagnostics=diag)
    calls = sorted((a, b, int(name.split("#")[1])) for a, b, name in ranges
                   if name.startswith(GROUP_PREFIX))
    starts = [c[0] for c in calls]
    for act in acts:
        if act.launch is None:
            continue
        k = bisect.bisect_right(starts, act.launch) - 1
        if k >= 0 and act.launch <= calls[k][1]:
            i = calls[k][2]
            data.call_device_ns[i] = data.call_device_ns.get(i, 0) + (act.end - act.start)
    return data


class Profiler:
    """torch.profiler over CPU and CUDA activity, its events read raw."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        return False

    def events(self):
        return self.prof.profiler.kineto_results.events()

"""One run of one cell: set-up, the measured window, the per-layer
reading in a traced run, the check against the reference, the result.

Everything that belongs to one cell, configuration, traffic mix, metric
or op group is found by name under portbench/ (see README.md):
  cells/<cell>.json       config, traffic, chips, why
  configs/<config>.json   the configuration's numbers, as run
  configs/<config>.py     its Case: inputs, the program's entry, the check
  traffic/<mix>.json      the statement and its parameters
  metrics/<metric>.py     read(run) -> number or None
  counts/<group>.py       an op group's targets and least work
BENCHMARK.json, beside portbench/, says which metrics a cell reports.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import statistics
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np

from . import guard

HERE = Path(__file__).resolve().parent.parent  # portbench/


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def op_groups(root: Path) -> dict:
    """Every op group under counts/, by file name."""
    groups = {}
    for path in sorted((root / "counts").glob("*.py")):
        if not path.stem.startswith("_"):
            groups[path.stem] = importlib.import_module(f"{root.name}.counts.{path.stem}")
    return groups


def cell_metrics(bench: dict, kind: str, cell: str) -> List[dict]:
    return [m for m in bench[kind] if "workloads" not in m or cell in m["workloads"]]


def input_seeds(seed: int, count: int) -> List[int]:
    """The seeds of the window's distinct inputs, from the run's seed."""
    rng = np.random.default_rng(np.random.SeedSequence(seed % (1 << 128)))
    return [int(s) for s in rng.integers(0, 1 << 63, size=count, dtype=np.int64)]


def sample_indices(seed: int, latencies: List[float], k: int) -> List[int]:
    """k proofs of the window to check: the slowest, and the rest drawn
    from the seed."""
    n = len(latencies)
    if n == 0:
        return []
    slowest = max(range(n), key=lambda i: latencies[i])
    rest = [i for i in range(n) if i != slowest]
    rng = np.random.default_rng(np.random.SeedSequence([seed % (1 << 128), 1]))
    picked = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) if rest else []
    return sorted([slowest] + [rest[int(i)] for i in picked])


@dataclass
class RunRecord:
    """What the metric readers take."""

    setup_s: float = 0.0
    window_s: float = 0.0
    latencies: List[float] = field(default_factory=list)
    peak_window_bytes: int = 0
    trace: object = None
    syncs: Optional[int] = None
    on_card: bool = True


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(args, t_start: float, device=None, root: Path = HERE, out=None, err=None) -> int:
    """One run; returns the process's exit code. ``device`` None means the
    card, and the run refuses without enough of them; tests pass "cpu"."""
    out = out or sys.stdout
    err = err or sys.stderr
    import torch

    bench = load_json(root.parent / "BENCHMARK.json")
    cell_path = root / "cells" / f"{args.workload}.json"
    if not cell_path.exists():
        print(f"no cell {args.workload!r} ({cell_path})", file=err)
        return 2
    cell = load_json(cell_path)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"cell {args.workload} needs {cell['chips']} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=err)
            return 3
        device = "cuda"
    on_card = torch.device(device).type == "cuda"
    config = load_json(root / "configs" / f"{cell['config']}.json")
    traffic = load_json(root / "traffic" / f"{cell['traffic']}.json")
    cmod = load_module(root / "configs" / f"{cell['config']}.py", f"portbench_config_{len(sys.modules)}")

    # ---- set-up
    case = cmod.Case(config, traffic, device)
    inputs = [case.make_input(s) for s in input_seeds(args.seed, traffic["distinct_inputs"])]
    case.prove(inputs[0])  # the warm proof: every shape of the window
    _sync(device)
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    record = RunRecord(setup_s=time.perf_counter() - t_start, on_card=on_card)

    tracer = profiler = syncs = None
    if args.trace:
        from . import trace as tr
        from .frozen.syncs import SyncCounter

        tracer = tr.GroupTracer(op_groups(root))
        tracer.install(getattr(cmod, "PHASES", ()))
        profiler = tr.Profiler().__enter__() if on_card else None
        syncs = SyncCounter().__enter__() if on_card else None

    # ---- the window: one client proving back to back
    gc.collect()
    gc.freeze()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    proofs, failures = [], []
    window_range = None
    if profiler is not None:
        window_range = torch.profiler.record_function(tr.WINDOW_LABEL)
        window_range.__enter__()
    w0 = time.perf_counter()
    k = 0
    while True:
        t0 = time.perf_counter()
        try:
            proof = case.prove(inputs[k % len(inputs)])
        except Exception:  # a proof that fails counts against the attempts
            proof = None
            failures.append(traceback.format_exc())
        if syncs is not None:
            torch.cuda.set_sync_debug_mode(0)
        _sync(device)
        if syncs is not None:
            torch.cuda.set_sync_debug_mode("warn")
        t1 = time.perf_counter()
        record.latencies.append(t1 - t0)
        proofs.append(proof)
        k += 1
        if t1 - w0 >= args.seconds:
            break
    record.window_s = t1 - w0
    q = statistics.quantiles(record.latencies, n=4) if len(record.latencies) > 1 else record.latencies * 3
    print(f"window: {len(record.latencies)} proofs in {record.window_s:.3f} s, latency quartiles "
          f"{q[0]:.4f} {q[1]:.4f} {q[2]:.4f} s, max {max(record.latencies):.4f} s", file=err)
    if window_range is not None:
        window_range.__exit__(None, None, None)
    gc.unfreeze()
    if on_card:
        record.peak_window_bytes = torch.cuda.max_memory_allocated()

    if args.trace:
        if syncs is not None:
            syncs.__exit__(None, None, None)
            record.syncs = syncs.count
        if profiler is not None:
            profiler.__exit__(None, None, None)
            t_red = time.perf_counter()
            record.trace = tr.reduce_events(profiler.events(), tracer)
            print(f"trace: {record.trace.diagnostics}, reduced in "
                  f"{time.perf_counter() - t_red:.1f} s", file=err)
        tracer.uninstall()
        del profiler

    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, kind, args.workload):
        reader = load_module(root / "metrics" / f"{m['name']}.py", f"portbench_metric_{m['name']}")
        value = reader.read(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    found = guard.forbidden_modules()
    if found:
        print(f"modules that a run may not load: {found}", file=err)
        return 4

    # ---- the check, after the window, with the program's state released
    if on_card:
        torch.cuda.empty_cache()
    checked = sample_indices(args.seed, record.latencies, traffic["sample"])
    mismatched = 0
    for i in checked:
        if proofs[i] is None:  # counted among the failures
            continue
        t_one = time.perf_counter()
        parts = case.check(inputs[i % len(inputs)], proofs[i], device)
        print(f"check: proof {i} against the reference in {time.perf_counter() - t_one:.1f} s",
              file=err)
        if parts:
            mismatched += 1
            print(f"proof {i} differs from the reference in {parts}", file=err)
    for f in failures[:1]:
        print(f"a proof raised:\n{f}", file=err)
    checks = {
        "proofs_failed": {"value": len(failures), "limit": 0},
        "proofs_mismatched": {"value": mismatched, "limit": 0},
    }
    correct = (len(failures) == 0 and mismatched == 0
               and len(checked) == min(traffic["sample"], len(proofs)))

    found = guard.forbidden_modules()
    if found:
        print(f"modules that a run may not load: {found}", file=err)
        return 4

    dev = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": cell["chips"],
        "memory_peak_bytes": int(max(setup_peak, record.peak_window_bytes)),
    }
    result = {
        "correct": bool(correct),
        "attempted": len(proofs),
        "failed": len(failures) + mismatched,
        "metrics": metrics,
        "device": dev,
    }
    if args.trace and record.trace is not None:
        dev["busy_s"] = record.trace.busy_s()
        dev["window_s"] = record.trace.window_s
        result["breakdown"] = record.trace.breakdown()
    result["checks"] = checks
    for name, c in checks.items():
        print(f"{name} {c['value']} limit {c['limit']}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0

"""A copy of the benchmark (portbench/ and BENCHMARK.json) in a temporary
directory, with the tiny CPU cell of tests/data added as files, and one
run of the harness in it."""

from __future__ import annotations

import argparse
import io
import json
import shutil
import time
from pathlib import Path

from portbench.lib import harness

PORTBENCH = Path(__file__).resolve().parent.parent
DATA = PORTBENCH / "tests" / "data"
TINY = "test-fib-r6"
TINY_CTL = "test-ctl-r5-r6"


def make_tree(tmp: Path) -> Path:
    """tmp/portbench and tmp/BENCHMARK.json; returns the portbench copy."""
    root = tmp / "portbench"
    shutil.copytree(PORTBENCH, root, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(PORTBENCH.parent / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for name in (TINY, TINY_CTL):
        shutil.copy(DATA / f"{name}.cell.json", root / "cells" / f"{name}.json")
        shutil.copy(DATA / f"{name}.traffic.json", root / "traffic" / f"{name}.json")
        cell = json.loads((DATA / f"{name}.cell.json").read_text())
        add_workload(tmp, {"name": name, **cell})
    return root


def add_workload(tmp: Path, entry: dict, metric: dict = None) -> None:
    path = tmp / "BENCHMARK.json"
    bench = json.loads(path.read_text())
    bench["workloads"].append(entry)
    if metric is not None:
        bench["end_to_end" if metric["source"] in ("host_clock",) else "per_layer"].append(metric)
    path.write_text(json.dumps(bench, indent=1))


def run_cell(root: Path, workload: str = TINY, seed: int = 2**31 + 11, seconds: float = 0.5,
             trace: int = 0):
    """(exit code, the last line of standard output parsed or None, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=trace)
    rc = harness.run(args, time.perf_counter(), device="cpu", root=root, out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()

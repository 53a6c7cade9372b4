"""The control of a cell's check: the reference in the program's place,
with one guarantee of the configuration broken (the configuration's Case
says which), judged exactly as the program's proofs are. Each seed's input
is the first input a run with that seed makes. The check holds only if
every control proof comes out mismatched."""

from __future__ import annotations

import json
import time
from pathlib import Path

from .harness import HERE, input_seeds, load_json, load_module


def control_readings(workload: str, seeds, device, root: Path = HERE):
    cell = load_json(root / "cells" / f"{workload}.json")
    config = load_json(root / "configs" / f"{cell['config']}.json")
    traffic = load_json(root / "traffic" / f"{cell['traffic']}.json")
    cmod = load_module(root / "configs" / f"{cell['config']}.py", "portbench_control_config")
    case = cmod.Case(config, traffic, device)
    for seed in seeds:
        t0 = time.perf_counter()
        inp = case.make_input(input_seeds(seed, traffic["distinct_inputs"])[0])
        parts = case.control(inp, device)
        yield {
            "workload": workload,
            "seed": seed,
            "proofs_mismatched": int(bool(parts)),
            "limit": 0,
            "differing_parts": parts[:8],
            "seconds": time.perf_counter() - t0,
        }


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="Readings of a cell's control, one line a seed")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    failed_to_fail = 0
    for r in control_readings(args.workload, args.seeds, device):
        r["device"] = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
        print(json.dumps(r), flush=True)
        failed_to_fail += r["proofs_mismatched"] == 0
    return 1 if failed_to_fail else 0

"""The prover mesh of this checkout against another tree's, on one GPU.

Each tree's package proves chip_smoke.py's NoopGate circuit (degree
2^log2_gates, standard_recursion_config) in a process of its own, the
trees in turns (other, this, this, other): one device, a first and a
second proof; then under a mesh of virtual shards on the card a first, a
second and a third device-transcript proof. Each second proof runs with
the CUDA caching allocator's history recorded (its largest single
allocation) and its own peak (max_memory_allocated); each third one
alone, for its seconds (host clock, ending in a synchronise). Every
proof's bytes must agree within a tree and across the trees.

    python3 tools/torch_mesh_compare.py [--against <other tree>] [--shards 8]
        [--log2-gates 16]

Prints one JSON line a process, then a summary line with the medians of
each tree's runs.
"""

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def recorded(fn):
    """(fn(), {largest single allocation, allocations, peak bytes}) with the
    allocator's history recorded (no tracebacks) and the peak reset."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history("all", context=None, clear_history=True)
    try:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(None)
    allocs = [e["size"] for e in snap["device_traces"][torch.cuda.current_device()]
              if e["action"] == "alloc"]
    return out, {"s": seconds, "largest_allocation_bytes": max(allocs),
                 "allocations": len(allocs),
                 "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}


def timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def child(tree: str, shards: int, log2_gates: int) -> dict:
    """The measurements of ``tree``'s package, in this process."""
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs
    from plonky2_tpu_torch.iop.witness import PartialWitness
    from plonky2_tpu_torch.parallel import context as pctx
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    from plonky2_tpu_torch.plonk.prover import prove
    from plonky2_tpu_torch.utils import serialization as ser

    data = cs.noop_circuit(CircuitConfig.standard_recursion_config(), log2_gates)
    mesh = pctx.make_prover_mesh(shards, virtual_on=torch.device("cuda", 0))

    def one():
        return prove(data.prover_only, data.common, PartialWitness())

    def meshed():
        with pctx.prover_mesh(mesh):
            return one()

    proofs, out = [], {"tree": tree, "card": cs.card_line(), "shards": shards}
    for name, fn in (("one_device", one), ("mesh", meshed)):
        p1, first_s = timed(fn)
        p2, second = recorded(fn)
        p3, third_s = timed(fn)
        proofs += [p1, p2, p3]
        out[name] = {"first_s": first_s, "second_call": second, "third_s": third_s}
    digests = {hashlib.sha256(ser.proof_to_bytes(p, data.common)).hexdigest() for p in proofs}
    if len(digests) != 1:
        raise SystemExit(f"{tree}: the proofs differ: {sorted(digests)}")
    out["proof_sha256"] = digests.pop()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", help="the other tree (a checkout's root)")
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--log2-gates", type=int, default=16)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.shards, args.log2_gates)), flush=True)
        return 0
    trees = [REPO] if not args.against else [
        os.path.abspath(args.against), REPO, REPO, os.path.abspath(args.against)]
    runs = []
    for tree in trees:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", tree,
             "--shards", str(args.shards), "--log2-gates", str(args.log2_gates)],
            cwd=tree, capture_output=True, text=True, timeout=900,
        )
        if res.returncode != 0:
            sys.stderr.write(res.stdout + res.stderr)
            return res.returncode
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    if len({r["proof_sha256"] for r in runs}) != 1:
        raise SystemExit("the trees' proofs differ")
    summary = {}
    for tree in dict.fromkeys(r["tree"] for r in runs):
        mine = [r for r in runs if r["tree"] == tree]
        summary[tree] = {
            f"{name}_{key}": statistics.median(
                r[name]["second_call"][key] if key != "third_s" else r[name][key] for r in mine)
            for name in ("one_device", "mesh")
            for key in ("third_s", "s", "largest_allocation_bytes", "max_memory_allocated_bytes")
        }
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

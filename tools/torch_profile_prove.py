#!/usr/bin/env python3
"""Where one proof of the PyTorch/CUDA port spends its time, on one NVIDIA GPU.

    python3 tools/torch_profile_prove.py [--log2-gates 16] [--host-transcript]
    python3 tools/torch_profile_prove.py --hasher poseidon2 [--log2-gates 16]
    python3 tools/torch_profile_prove.py --circuit gate_mix [--log2-gates 16]
    python3 tools/torch_profile_prove.py --circuit recursion
    python3 tools/torch_profile_prove.py --stark-log-rows 22

Builds the full-width circuit of chip_smoke.py (2^(n-1) + 1 NoopGates under
the unchanged standard_recursion_config -> degree 2^n), or with --circuit
gate_mix the gate-mix circuit of chip_smoke.py (every gate, lookups;
plonky2_tpu_torch/models/gate_mix.py) at degree 2^n, or with --circuit
recursion the recursion benchmark's outer circuit of chip_smoke.py's
recursion phase ("shrink 1", degree 2^13, over the inner proof of
tests/golden/bench_inner_2^12.bin; --log2-gates is not used) — or, with
--stark-log-rows, the FibonacciStark of chip_smoke.py's STARK phase under
StarkConfig.standard_fast_config() — proves it once to warm up, and then
prints three JSON lines. --hasher poseidon2 or keccak builds and proves the
NoopGate circuit under that hasher bundle (plonk/generic_config.py), which
proves on the host transcript:

  card      nvidia-smi's name and power limit, and the torch version;
  phases    host-clock seconds of one proof split by the prover's steps.
            The steps are timed from outside: the functions ``prove`` calls
            are wrapped for this one proof, each wrapper waiting for the
            device before it reads the clock, so this proof is slower than
            an undisturbed one (its whole time is printed beside the
            undisturbed one, and the synchronising CUDA operations of an
            undisturbed proof under torch.cuda.set_sync_debug_mode). A
            PLONK proof runs by the device-resident transcript (the
            default): commit, Z, quotient, open_reduce (zeta, the openings,
            alpha, the final polynomial) and the fused FRI proof;
            --host-transcript profiles the host transcript instead (its
            openings and fri steps);
  profile   one undisturbed proof under utils/profiling.trace
            (torch.profiler; the Chrome trace is written to --trace-dir,
            torch_traces/profile_prove/ by default): device-busy
            milliseconds, kernel launches, the time and launches of each
            hand-written kernel (the Poseidon group: permutation,
            two-to-one compression and sponge), the eager torch.cat
            launches, the largest kernels by device time, and the host
            milliseconds of the prover's annotated steps (``prove/*``
            spans; the STARK prover has none).

The prover carries no measurement code beyond its ``annotate`` spans,
which wait for nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def say(obj) -> None:
    print(json.dumps(obj), flush=True)


# kernel names (substrings) of the hand-written kernels; "poseidon" is the
# whole Poseidon group: permutation, two-to-one compression and sponge
HAND_WRITTEN = (
    "poseidon", "poseidon_permute_kernel", "poseidon_compress_kernel", "poseidon_sponge_kernel",
    "gl_mul_kernel", "col_fft_kernel", "row_fft_kernel", "ntt_stage_kernel",
)


def device_rows(prof):
    from plonky2_tpu_torch.utils.profiling import kernel_rows

    rows = []
    # CUDA rows only: an operator's row repeats the time of the kernels
    # under it, and the prover's spans are no kernels
    for e in kernel_rows(prof):
        own = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
        if own > 0:
            rows.append((own, e.count, e.key))
    rows.sort(reverse=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2-gates", type=int, default=16, help="degree bits of the circuit")
    ap.add_argument("--stark-log-rows", type=int, default=None,
                    help="profile a FibonacciStark of 2^n rows instead of the circuit")
    ap.add_argument("--circuit", choices=["noop", "gate_mix", "recursion"], default="noop",
                    help="the PLONK circuit: NoopGates (default), the gate mix or the "
                         "recursion benchmark's outer circuit")
    ap.add_argument("--host-transcript", action="store_true",
                    help="prove the circuit by the host transcript (device_transcript=False)")
    ap.add_argument("--hasher", choices=["poseidon", "poseidon2", "keccak"], default="poseidon",
                    help="the NoopGate circuit's hasher bundle (the others prove on the "
                         "host transcript)")
    ap.add_argument("--trace-dir", default=os.path.join("torch_traces", "profile_prove"),
                    help="where the profiled proof's Chrome trace is written")
    args = ap.parse_args()
    if args.hasher != "poseidon":
        if args.circuit != "noop" or args.stark_log_rows:
            ap.error("--hasher takes the NoopGate circuit")
        args.host_transcript = True
    if not torch.cuda.is_available():
        print("torch_profile_prove: no CUDA device", file=sys.stderr)
        return 1

    from torch.autograd import DeviceType

    from chip_smoke import count_syncs, timed_calls
    from plonky2_tpu_torch.fri import oracle as fo
    from plonky2_tpu_torch.fri import prover as fri_prover
    from plonky2_tpu_torch.gates.basic import NoopGate
    from plonky2_tpu_torch.iop.witness import PartialWitness, PartitionWitness
    from plonky2_tpu_torch.plonk import device_transcript as dt
    from plonky2_tpu_torch.plonk import generic_config as gcm
    from plonky2_tpu_torch.plonk import prover
    from plonky2_tpu_torch.plonk.circuit_builder import CircuitBuilder
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    from plonky2_tpu_torch.utils import profiling

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say({
        "card": card, "torch": torch.__version__,
        **({"stark_log_rows": args.stark_log_rows} if args.stark_log_rows
           else {"log2_gates": None if args.circuit == "recursion" else args.log2_gates,
                 "circuit": args.circuit, "hasher": args.hasher,
                 "transcript": "host" if args.host_transcript else "device"}),
    })

    gc = getattr(gcm, f"{args.hasher}_goldilocks_config")()
    if args.stark_log_rows:
        from plonky2_tpu_torch.stark import prover as stark_prover
        from plonky2_tpu_torch.stark.config import StarkConfig
        from plonky2_tpu_torch.stark.fixtures import FibonacciStark, fibonacci_res

        n = 1 << args.stark_log_rows
        stark = FibonacciStark(n)
        trace = stark.generate_trace(0, 1)
        pis = [0, 1, fibonacci_res(n, 0, 1)]
        config = StarkConfig.standard_fast_config()

        def prove_call():
            stark_prover.prove(stark, config, trace, pis)

        targets = [
            (fo.PolynomialBatch, "from_values", "commit_trace"),
            (stark_prover, "run_binding_step", "binding_step"),
            (stark_prover, "compute_quotient_chunks", "quotient"),
            (fo.PolynomialBatch, "from_coeffs", "commit_quotient"),
            (fo, "eval_commitments_at", "openings"),
            (fo, "prove_openings", "fri"),
        ]
    else:
        if args.circuit == "gate_mix":
            from plonky2_tpu_torch.models.gate_mix import build_gate_mix

            data, pw = build_gate_mix(args.log2_gates)
        elif args.circuit == "recursion":
            from plonky2_tpu_torch.models import bench_recursion as br
            from plonky2_tpu_torch.utils import serialization as ser

            golden = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                  "tests", "golden", "bench_inner_2^12.bin")
            with open(golden, "rb") as f:
                inner = ser.proof_tuple_from_bytes(f.read())
            data, pt, vd_t = br.recursive_circuit(inner[2], CircuitConfig.standard_recursion_config())
            pw = br.recursive_witness(pt, vd_t, inner)
        else:
            builder = CircuitBuilder(CircuitConfig.standard_recursion_config())
            for _ in range((1 << (args.log2_gates - 1)) + 1):
                builder.add_gate(NoopGate(), [])
            data, pw = builder.build(gc=gc), PartialWitness()

        def prove_call():
            prover.prove(data.prover_only, data.common, pw, gc=gc,
                         device_transcript=not args.host_transcript)

        targets = [
            (prover, "generate_partial_witness", "witness_generation"),
            (PartitionWitness, "full_witness", "witness_to_matrix"),
            (fo.PolynomialBatch, "from_values", "commit_wires_and_zs_partial_products"),
            (prover, "_zs_and_partial_products", "zs_partial_products"),
            (prover, "set_lookup_wires", "set_lookup_wires"),
            (prover, "_lookup_polys_device", "lookup_polys"),
            (prover, "_compute_quotient_polys", "quotient"),
            (fo.PolynomialBatch, "from_coeffs", "commit_quotient"),
        ]
        if args.host_transcript:
            targets += [(fo, "eval_commitments_at", "openings"), (fo, "prove_openings", "fri")]
        else:
            targets += [(dt, "_open_reduce", "open_reduce"),
                        (fri_prover, "_fused_fri_proof", "fused_fri")]

    def prove_once() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prove_call()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    prove_once()  # warm-up: table uploads, allocator
    undisturbed_s = prove_once()
    _, syncs, _ = count_syncs(prove_call)
    torch.cuda.synchronize()

    seconds = {}
    with timed_calls(seconds, targets):
        whole_s = prove_once()
    seconds["other_host"] = whole_s - sum(seconds.values())
    say({
        "phases": seconds,
        "prove_s_with_phase_clock": whole_s,
        "prove_s_undisturbed": undisturbed_s,
        "syncs_one_proof": syncs,
    })

    with profiling.trace(args.trace_dir) as prof:
        profiled_s = prove_once()
    rows = device_rows(prof)
    spans = {e.key: e.cpu_time_total / 1e3 for e in prof.key_averages()
             if e.key.startswith("prove/") and e.device_type == DeviceType.CPU}
    total_us = sum(r[0] for r in rows)
    say({
        "profile": {
            "prove_s_under_profiler": profiled_s,
            "trace_file": os.path.join(args.trace_dir, profiling.TRACE_FILE),
            "span_host_ms": spans,
            "device_busy_ms": total_us / 1e3,
            "kernels_launched": sum(r[1] for r in rows),
            "poseidon_ms": sum(us for us, _, k in rows if "poseidon" in k) / 1e3,
            "hand_written_ms": {
                name: sum(us for us, _, k in rows if name in k) / 1e3 for name in HAND_WRITTEN
            },
            "hand_written_launches": {
                name: sum(c for _, c, k in rows if name in k) for name in HAND_WRITTEN
            },
            # eager torch.cat (one CatArrayBatchedCopy launch each)
            "cat_launches": sum(c for _, c, k in rows if "CatArrayBatchedCopy" in k),
            "cat_ms": sum(us for us, _, k in rows if "CatArrayBatchedCopy" in k) / 1e3,
            "top": [
                {"name": k[:80], "calls": c, "device_ms": us / 1e3} for us, c, k in rows[:16]
            ],
        }
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())

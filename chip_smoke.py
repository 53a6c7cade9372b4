#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (plonky2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA device

Phases, each printing JSON lines:

  1. device     the card (nvidia-smi name and power limit), the toolchain,
                and the build of the CUDA kernels from the sources in
                plonky2_tpu_torch/ops/csrc/ (nvcc, sm_90a);
  2. kernels    every hand-written kernel held bit-exact against its plain
                PyTorch version on the card at a fixed list of shapes
                (edge widths, edge values, the reference vectors);
  3. fibonacci  build -> prove -> verify of the fibonacci circuit; the
                proof and common data must equal the pinned bytes in
                tests/golden/, and a tampered proof must be rejected;
  4. full_width the main path at a real size: 2^15 + 1 NoopGates under the
                unchanged standard_recursion_config (143 wires, rate 1/8,
                28 queries, 16 PoW bits) -> degree 2^16, LDE 2^19; build,
                prove, verify, tamper; the kernels' launch counters are
                zeroed just before and read just after, together with
                every distinct shape the path launched;
  5. main_path_kernels
                each kernel held bit-exact against its plain version at
                every shape that phases 3 and 4 launched it at (read from
                the binding's record, not from a list written here), then
                timed (CUDA events) at the largest of them next to the
                plain version and to the least time the card could take
                for the same work.

Then the card line, one ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``. Any failure exits non-zero; nothing is
caught and carried on from. Without a CUDA device the script exits
non-zero at once: it never falls back to the CPU.

Integer kernels: the tolerance is none — outputs must be equal word for
word, so ``max_abs_err`` is 0 or the run fails.
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks used for the bounds (NVIDIA data sheet): device memory
# 3.35 TB/s; float32 outside the tensor cores 67 TFLOP/s. An SM issues 64
# int32 lanes a clock against 128 float32 lanes, so the integer
# multiply-add peak is taken as half of that: 33.5e12 integer operations a
# second with a multiply-add counted as two.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12

# 32x32->64 multiply-adds of one Poseidon permutation, counted for the
# cheapest algorithm known to this repo (hash/poseidon_fast.py), not for the
# one the kernels run. A field product is 4 partial products, a square 3,
# so an S-box x^7 = (x^2, x^3, (x^3)^2, x * x^6) is 14. A dense MDS layer is
# 12 x 12 entries (< 2^6) x 2 half-words = 288.
#   8 full rounds:        8 x (12 S-boxes + dense MDS)
#   pre-partial matrix:   11 x 11 products by 64-bit constants
#   22 partial rounds:    1 S-box + 23 products (1 by MDS[0][0], 11 by the
#                         round's w_hat, 11 by its v), each taken as 4
# Constant adds, carries and modular reductions are left out of both counts.
MADS_PER_PERMUTATION = 8 * (12 * 14 + 288) + 11 * 11 * 4 + 22 * (14 + 23 * 4)
OPS_PER_PERMUTATION = 2 * MADS_PER_PERMUTATION
# The kernels run the dense form: 118 S-boxes of 4 x 4 partial products and
# a dense MDS in each of the 30 rounds. Reported beside the bound.
MADS_PER_PERMUTATION_DENSE = 118 * 4 * 4 + 30 * 288

POSEIDON_SOURCE = "plonky2_tpu_torch/ops/csrc/poseidon.cu"

# degree bits of the full-width circuit: 2^15 + 1 NoopGates pad to 2^16 rows
LOG2_GATES = 16

# (input, expected) permutation vectors of the reference implementation's
# test suite (core/src/poseidon_goldilocks.rs)
P = 0xFFFFFFFF00000001
VECTORS = [
    (
        [0] * 12,
        [
            0x3C18A9786CB0B359, 0xC4055E3364A246C3, 0x7953DB0AB48808F4, 0xC71603F33A1144CA,
            0xD7709673896996DC, 0x46A84E87642F44ED, 0xD032648251EE0B3C, 0x1C687363B207DF62,
            0xDF8565563E8045FE, 0x40F5B37FF4254DAE, 0xD070F637B431067C, 0x1792B1C4342109D7,
        ],
    ),
    (
        list(range(12)),
        [
            0xD64E1E3EFC5B8E9E, 0x53666633020AAA47, 0xD40285597C6A8825, 0x613A4F81E81231D2,
            0x414754BFEBD051F0, 0xCB1F8980294A023F, 0x6EB2A9E4D54A9D0F, 0x1902BC3AF467E056,
            0xF045D5EAFDC6021F, 0xE4150F77CAAA3BE5, 0xC9BFD01D39B50CCE, 0x5C0A27FCB0E1459B,
        ],
    ),
    (
        [P - 1] * 12,
        [
            0xBE0085CFC57A8357, 0xD95AF71847D05C09, 0xCF55A13D33C1C953, 0x95803A74F4530E82,
            0xFCD99EB30A135DF1, 0xE095905E913A3029, 0xDE0392461B42919B, 0x7D3260E24E81D031,
            0x10D3D0465D9DEAA0, 0xA87571083DFC2A47, 0xE18263681E9958F8, 0xE28E96F1AE5E60D3,
        ],
    ),
]


def say(obj) -> None:
    print(json.dumps(obj), flush=True)


def run_text(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def card_line() -> str:
    return run_text(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    ).splitlines()[0]


def time_ms(fn, runs: int, warmup: int = 1) -> float:
    """Median over ``runs`` of one call's device time, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| over unsigned 64-bit words (0.0 iff equal)."""
    if torch.equal(a, b):
        return 0.0
    au = a.cpu().numpy().view(np.uint64).astype(object)
    bu = b.cpu().numpy().view(np.uint64).astype(object)
    return float(np.max(np.abs(au - bu)))


# ---------------------------------------------------------------------------
# Phase 1: device and build
# ---------------------------------------------------------------------------


def phase_device() -> str:
    from plonky2_tpu_torch.ops import poseidon_cuda

    card = card_line()
    t0 = time.perf_counter()
    lib = poseidon_cuda.build(verbose=True)
    build_s = time.perf_counter() - t0
    nvcc = run_text([poseidon_cuda._nvcc(), "--version"]).splitlines()[-2:]
    say({
        "phase": "device",
        "card": card,
        "device_name": torch.cuda.get_device_name(0),
        "device_count": torch.cuda.device_count(),
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": nvcc,
        "kernel_library": os.path.relpath(lib),
        "kernel_build_s": round(build_s, 3),
    })
    return card


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def random_field(rng, shape, device) -> torch.Tensor:
    from plonky2_tpu_torch.ops import gf

    return gf.from_u64(rng.integers(0, P, size=shape, dtype=np.uint64), device)


def check_permute(rng, device, batches) -> float:
    from plonky2_tpu_torch.ops import gf, poseidon as dp

    worst = 0.0
    # reference vectors
    inp = gf.from_u64(np.array([v[0] for v in VECTORS], dtype=np.uint64), device)
    want = gf.from_u64(np.array([v[1] for v in VECTORS], dtype=np.uint64), device)
    got = dp.permute(inp)
    torch.cuda.synchronize()
    worst = max(worst, max_abs_err(got, want), max_abs_err(dp.permute_plain(inp), want))
    for b in batches:
        x = random_field(rng, (b, 12), device)
        # states with lanes at 0 and p-1
        x[0, :] = 0
        x[-1, :] = gf._s64(P - 1)
        if b > 2:
            x[1, ::2] = gf._s64(P - 1)
            x[1, 1::2] = 0
        got = dp.permute(x)
        torch.cuda.synchronize()
        worst = max(worst, max_abs_err(got, dp.permute_plain(x)))
    return worst


def check_sponge(rng, device, shapes) -> float:
    from plonky2_tpu_torch.ops import poseidon as dp

    worst = 0.0
    for b, w, cap in shapes:
        x = random_field(rng, (b, w), device)
        x[0, :] = 0
        got = dp.sponge(x, cap)
        torch.cuda.synchronize()
        worst = max(worst, max_abs_err(got, dp.sponge_plain(x, cap)))
    return worst


def require_exact(errs: dict) -> None:
    if any(e != 0.0 for e in errs.values()):
        raise SystemExit(f"a kernel disagrees with its plain version: {errs}")


def phase_kernels() -> None:
    """Both kernels against their plain versions at a fixed list of shapes."""
    device = torch.device("cuda")
    rng = np.random.default_rng(2026)
    permute_batches = [1, 5, 2048, 1 << 18]
    sponge_shapes = [
        (b, w, cap)
        for w in (1, 7, 8, 13, 16, 32, 143)
        for cap in (0, w + 1)
        for b in (3, 1 << 15)
    ]
    errs = {
        "permute": check_permute(rng, device, permute_batches),
        "sponge": check_sponge(rng, device, sponge_shapes),
    }
    say({
        "phase": "kernels",
        "check": "bit-exact against the plain PyTorch versions on the card",
        "permute_batches": permute_batches,
        "sponge_shapes_checked": len(sponge_shapes),
        "max_abs_err": errs,
    })
    require_exact(errs)


def bound_record(permutations: int, words_moved: int) -> dict:
    """The least time the card could take: bytes over the memory rate
    against counted integer operations over the integer peak."""
    bytes_ms = words_moved * 8 / HBM_BYTES_PER_S * 1e3
    ops_ms = permutations * OPS_PER_PERMUTATION / INT32_OPS_PER_S * 1e3
    dense_ms = permutations * 2 * MADS_PER_PERMUTATION_DENSE / INT32_OPS_PER_S * 1e3
    return {
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        "bound_bytes_ms": bytes_ms,
        "bound_operations_ms": ops_ms,
        "bound_operations_dense_form_ms": dense_ms,
    }


def phase_main_path_kernels(shapes: dict) -> list:
    """Holds each kernel against its plain version at every shape the
    fibonacci and full-width phases launched it at, and times it at the
    largest. Returns the kernel records (without the launch counts)."""
    from plonky2_tpu_torch.ops import poseidon as dp, poseidon_cuda

    device = torch.device("cuda")
    rng = np.random.default_rng(2027)
    permute_batches = sorted(shapes["permute"])
    sponge_shapes = sorted(shapes["sponge"])
    errs = {
        "permute": check_permute(rng, device, permute_batches),
        "sponge": check_sponge(rng, device, sponge_shapes),
    }
    say({
        "phase": "main_path_kernels",
        "check": "bit-exact against the plain PyTorch versions on the card, "
                 "at every shape the fibonacci and full-width phases launched",
        "permute_batches": permute_batches,
        "sponge_shapes": sponge_shapes,
        "max_abs_err": errs,
    })
    require_exact(errs)

    records = []
    # permute at the widest Merkle level of the main path
    b = permute_batches[-1]
    x = random_field(rng, (b, 12), device)
    ms = time_ms(lambda: poseidon_cuda.permute(x), runs=20, warmup=3)
    plain_ms = time_ms(lambda: dp.permute_plain(x), runs=3)
    records.append({
        "name": "poseidon_permute",
        "route": "cuda",
        "source": POSEIDON_SOURCE,
        "replaces": "plonky2_tpu/ops/poseidon_pallas.py:171",
        "shape": [b, 12],
        "max_abs_err": errs["permute"],
        "ms": ms,
        "plain_ms": plain_ms,
        **bound_record(b, 2 * b * 12),
        "library_ms": None,
    })
    del x

    # sponge at the largest leaf matrix of the main path
    b, w, cap = max(sponge_shapes, key=lambda s: s[0] * s[1])
    x = random_field(rng, (b, w), device)
    ms = time_ms(lambda: poseidon_cuda.sponge(x, cap), runs=10, warmup=2)
    plain_ms = time_ms(lambda: dp.sponge_plain(x, cap), runs=2)
    records.append({
        "name": "poseidon_sponge",
        "route": "cuda",
        "source": POSEIDON_SOURCE,
        "replaces": "plonky2_tpu/ops/poseidon_pallas.py:213",
        "shape": [b, w],
        "max_abs_err": errs["sponge"],
        "ms": ms,
        "plain_ms": plain_ms,
        **bound_record(b * -(-w // 8), b * (w + 4)),
        "library_ms": None,
    })
    del x
    torch.cuda.empty_cache()
    say({"phase": "main_path_kernels", "timings": records})
    return records


# ---------------------------------------------------------------------------
# Phase 3: fibonacci against the pinned bytes
# ---------------------------------------------------------------------------


def expect_rejected(verify, proof, data, what: str) -> str:
    try:
        verify(proof, data.verifier_only, data.common)
    except Exception as e:  # the verifier's rejection is the expected outcome
        return type(e).__name__
    raise SystemExit(f"BUG: {what} was accepted")


def phase_fibonacci(golden_dir: str) -> dict:
    """Returns the distinct kernel shapes the phase launched."""
    from plonky2_tpu_torch.models.fibonacci import build_fibonacci, fib_value
    from plonky2_tpu_torch.ops import poseidon_cuda
    from plonky2_tpu_torch.plonk.prover import prove
    from plonky2_tpu_torch.plonk.verifier import verify
    from plonky2_tpu_torch.utils import serialization as ser

    poseidon_cuda.reset_launches()
    t0 = time.perf_counter()
    data, pw = build_fibonacci(public_io=True)
    t1 = time.perf_counter()
    pwp = prove(data.prover_only, data.common, pw)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    verify(pwp, data.verifier_only, data.common)
    t3 = time.perf_counter()
    shapes = {k: set(v) for k, v in poseidon_cuda.LAUNCH_SHAPES.items()}
    assert pwp.public_inputs[2] == fib_value()
    with open(os.path.join(golden_dir, "fibonacci_proof.bin"), "rb") as f:
        proof_equal = ser.proof_to_bytes(pwp, data.common) == f.read()
    with open(os.path.join(golden_dir, "fibonacci_common.bin"), "rb") as f:
        common_equal = ser.common_data_to_bytes(data.common) == f.read()
    bad = copy.deepcopy(pwp)
    bad.public_inputs[2] ^= 1
    rejected = expect_rejected(verify, bad, data, "a proof with a flipped public input")
    say({
        "phase": "fibonacci",
        "degree_bits": data.common.degree_bits,
        "build_s": t1 - t0,
        "prove_s": t2 - t1,
        "verify_s": t3 - t2,
        "proof_bytes_equal_golden": proof_equal,
        "common_bytes_equal_golden": common_equal,
        "tamper_rejected_with": rejected,
    })
    if not (proof_equal and common_equal):
        raise SystemExit("fibonacci bytes differ from tests/golden")
    return shapes


# ---------------------------------------------------------------------------
# Phase 4: the main path at full width
# ---------------------------------------------------------------------------


def phase_full_width(log2_gates: int):
    from plonky2_tpu_torch.gates.basic import NoopGate
    from plonky2_tpu_torch.iop.witness import PartialWitness
    from plonky2_tpu_torch.ops import poseidon_cuda
    from plonky2_tpu_torch.plonk.circuit_builder import CircuitBuilder
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    from plonky2_tpu_torch.plonk.prover import prove
    from plonky2_tpu_torch.plonk.verifier import verify

    config = CircuitConfig.standard_recursion_config()
    torch.cuda.reset_peak_memory_stats()
    poseidon_cuda.reset_launches()  # counts of the main path start here

    t0 = time.perf_counter()
    builder = CircuitBuilder(config)
    for _ in range((1 << (log2_gates - 1)) + 1):
        builder.add_gate(NoopGate(), [])
    data = builder.build()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pwp = prove(data.prover_only, data.common, PartialWitness())
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    verify(pwp, data.verifier_only, data.common)
    t3 = time.perf_counter()
    launches = dict(poseidon_cuda.LAUNCHES)  # ... and end here
    shapes = {k: set(v) for k, v in poseidon_cuda.LAUNCH_SHAPES.items()}

    assert data.common.degree_bits == log2_gates, data.common.degree_bits
    for name, n in launches.items():
        if n == 0:
            raise SystemExit(f"kernel {name} was never launched by the main path")

    # second proof: same bytes, steady-state time
    t4 = time.perf_counter()
    pwp2 = prove(data.prover_only, data.common, PartialWitness())
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    from plonky2_tpu_torch.utils import serialization as ser

    proof_bytes = ser.proof_to_bytes(pwp, data.common)
    assert proof_bytes == ser.proof_to_bytes(pwp2, data.common), "proofs differ between runs"
    reread = ser.proof_from_bytes(proof_bytes, data.common)
    verify(reread, data.verifier_only, data.common)

    bad = copy.deepcopy(pwp)
    c0, c1 = bad.proof.openings.wires[0]
    bad.proof.openings.wires[0] = ((c0 + 1) % P, c1)
    rejected_opening = expect_rejected(verify, bad, data, "a proof with a changed opening")
    bad = copy.deepcopy(pwp)
    bad.proof.opening_proof.pow_witness += 1
    rejected_pow = expect_rejected(verify, bad, data, "a proof with a changed PoW witness")

    say({
        "phase": "full_width",
        "config": "standard_recursion_config",
        "num_wires": config.num_wires,
        "num_routed_wires": config.num_routed_wires,
        "rate_bits": config.fri_config.rate_bits,
        "cap_height": config.fri_config.cap_height,
        "num_query_rounds": config.fri_config.num_query_rounds,
        "proof_of_work_bits": config.fri_config.proof_of_work_bits,
        "degree_bits": data.common.degree_bits,
        "lde_bits": data.common.degree_bits + config.fri_config.rate_bits,
        "build_s": t1 - t0,
        "prove_first_s": t2 - t1,
        "prove_second_s": t5 - t4,
        "verify_s": t3 - t2,
        "proof_bytes": len(proof_bytes),
        "launches_build_prove_verify": launches,
        "launch_shapes": {k: sorted(v) for k, v in shapes.items()},
        "tamper_rejected_with": [rejected_opening, rejected_pow],
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    })
    return launches, shapes


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script does not run on the CPU",
              file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)

    card = phase_device()
    phase_kernels()
    shapes = phase_fibonacci(os.path.join(here, "tests", "golden"))
    launches, main_shapes = phase_full_width(LOG2_GATES)
    for k in shapes:
        shapes[k] |= main_shapes[k]
    torch.cuda.empty_cache()
    records = phase_main_path_kernels(shapes)

    print(card, flush=True)
    by_name = {"poseidon_permute": "permute", "poseidon_sponge": "sponge"}
    for r in records:
        r["launches"] = launches[by_name[r["name"]]]
    say({"kernels": records})
    say({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())

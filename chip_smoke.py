#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (plonky2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA device

Phases, each printing JSON lines:

  1. device     the card (nvidia-smi name and power limit), the toolchain,
                and the build of the CUDA kernels from the sources in
                plonky2_tpu_torch/ops/csrc/ (one nvcc a source, all started
                together, sm_90a); for each Poseidon kernel its registers,
                spills and shared memory (ptxas -v) and the SASS
                instructions a thread issues a permutation (cuobjdump -sass
                of the built library, loop bodies times their trip counts);
                for the column and row FFT kernels their registers, spills,
                blocks an SM and SASS instructions a butterfly (a stage
                group's set loop over its butterflies);
  1b. kernel_guards
                the process's first launches of every kernel: first the
                first transform of a NoopGate 2^16 build (the [83, 2^16]
                inverse four-step through ntt.ifft) against the plain flat
                transform; then each kernel (the column FFT with its tail
                stages) at every form of its fixed list and at its largest
                main-path form, every input and the output inside a buffer
                of random words, 2^14 words on each side: the output must
                equal the plain version, and the output's margins, the
                inputs and their margins must be unchanged bit for bit;
                the sponge's rows off the 16-byte grid must be refused by
                its wrapper and hashed right by ops/poseidon.sponge; then
                each card's launches on that card: under torch.cuda.device
                of each card the NTT library's CUDA runtime must see that
                card current, and with more than one card the inverse
                four-step and the column and row FFTs at their largest
                main-path forms on each other card's tensors, card 0
                current, must equal the plain versions (on one card the
                line says that part did not run);
  2. kernels    every hand-written kernel held bit-exact against its plain
                PyTorch version on the card at a fixed list of shapes
                (edge widths, edge values, the reference vectors, states at
                the edges of the lazy reduction through all three Poseidon
                entry points; every call form of the field product, and its
                64-bit-index form on views over a 16 GiB buffer; seeded
                first stages, column widths 2^8, 2^11, 2^12, and the edges
                of the column and row plans);
  3. fibonacci  build -> prove -> verify of the fibonacci circuit, proven by
                the device-resident transcript (the default); the proof and
                common data must equal the pinned bytes in tests/golden/,
                and a tampered proof must be rejected. Then a second
                device-transcript proof and two host-transcript proofs
                (device_transcript=False) of the same witness must give the
                same bytes; each of the three is timed and run under CUDA's
                sync debug mode, and the second device-transcript proof may
                make at most the PoW grind's chunks plus one synchronising
                operations (one found flag a chunk, the one transfer);
  4. full_width the PLONK path at a real size: 2^15 + 1 NoopGates under the
                unchanged standard_recursion_config (143 wires, rate 1/8,
                28 queries, 16 PoW bits) -> degree 2^16, LDE 2^19; build,
                prove, verify, tamper; the proof's SHA-256 must equal the
                pinned digest of the same circuit's proof; both transcripts
                as in phase 3;
  5. plonk_inner_2^12
                the same circuit at degree 2^12 (2^11 + 1 NoopGates): the
                inner proof of the JAX package's recursion benchmark, whose
                every transform is a flat one (the row FFT; no four-step,
                so no column FFT); build, prove, verify, tamper, both
                transcripts as in phase 3; the proof, common data and
                verifier data must equal the three parts of
                tests/golden/bench_inner_2^12.bin;
  6. examples   range_check and square_root (models/examples.py) on both
                transcripts, each proof equal to its tests/golden/ bytes;
                factorial(100); fibonacci_serialization; a tampered proof of
                each rejected; the native host engines must have built;
  7. gate_mix_2^16
                the gate-mix circuit (models/gate_mix.py: every gate but the
                Poseidon2 family, four TIP5 lookups, a range check and two
                32-term reductions a block) at degree 2^16 under the
                unchanged standard_recursion_config: build, witness (native,
                no generator left to Python), prove, verify (native and
                pure-Python Poseidon), both transcripts as in phase 3,
                tampered proofs (an opening, a public input, a lookup
                opening) rejected;
  8. gate_mix_2^13
                the same at degree 2^13, whose proof's SHA-256 must equal
                the digest the JAX package gives (tools/gen_gate_mix_pins.py);
  9. zk_2^12    the gate mix at degree 2^12 with zero knowledge: with the
                salt seed and the blinding stream fixed, the card's proofs
                (both transcripts) equal the port's CPU proof byte for byte;
                unseeded, two proofs differ in every cap and both verify;
 10. recursion  the JAX package's recursion benchmark under the unchanged
                standard_recursion_config: the outer proof ("shrink 1",
                degree 2^13) over the degree-2^12 inner proof loaded from
                tests/golden/bench_inner_2^12.bin — build, witness (native,
                no generator left to Python), prove, verify, both
                transcripts as in phase 3, one proof under torch.profiler;
                its common data, verifier data and proof must equal
                tests/golden/torch_recursion_outer_2^12.bin (the JAX
                package's, tools/gen_recursion_pins.py); a tampered inner
                proof must fail the outer witness and a tampered outer proof
                be rejected —, a second shrink over it (both transcripts),
                compression of both (round trips, verify_compressed_proof,
                shrink 1's compressed bytes equal to their pin), conditional
                recursion over shrink 1's circuit with condition 1 and 0,
                and the three-step cyclic hash chain (models/hash_chain.py:
                counter 3, the initial hash hashed three times);
 11. stark_small a 2^10-row FibonacciStark proven on the card and on the
                CPU (plain versions), and on the card with the FRI proof in
                its unfused form: the three proofs must be equal;
 12. stark      the STARK path at its real size: a 2^22-row FibonacciStark
                under StarkConfig.standard_fast_config() (rate 1/2, cap
                height 4, 84 queries, 16 PoW bits) -> LDE 2^23; trace
                generation, two proves (equal; the second under the sync
                debug mode), verify, a wrong public result rejected, peak
                device memory;
 13. batch_stark the small system of tests/test_batch_stark.py (tables of
                2^7 and 2^5 rows) proven on the card and on the CPU, both
                equal to the JAX package's pinned proof
                (tests/golden/torch_batch_stark_7_5.json); then three
                FibonacciStark tables of 2^22, 2^18 and 2^14 rows under
                StarkConfig.standard_fast_config() in one trace batch tree
                and one quotient batch tree (LDE 2^23 / 2^19 / 2^15), one
                batch FRI proof: trace generation, two proves (equal; the
                second under the sync debug mode), verify, a tampered
                opening, public input and query leaf rejected;
 14. stark_lookup_small
                the logUp PermutationStark of tests/test_stark_lookup.py
                (2^5 rows) proven on the card and on the CPU: both proofs
                equal the JAX package's pinned one
                (tests/golden/torch_starky_lookup_2^5.json), which verifies
                under the port's verifier;
 15. stark_lookup
                PermutationStark at 2^22 rows under
                StarkConfig.standard_fast_config() (LDE 2^23; the logUp
                helper and Z columns built on the card and committed as
                the auxiliary oracle): trace generation, two proves (equal;
                the second under the sync debug mode), verify, a broken
                permutation (one entry of column 1 changed) rejected;
 16. stark_ctl  the two-table system of tests/test_stark_ctl.py: first at
                2^5 / 2^7 rows on the card and on the CPU, both equal to the
                JAX package's pinned proofs
                (tests/golden/torch_starky_ctl_5_7.json); then a
                CtlLookingStark of 2^21 rows whose two columns look into a
                CtlLookedStark of 2^22 rows holding all 2^22 values, flagged
                and shuffled: prove_all_tables (two proves, equal),
                verify_all_tables, a corrupted looked table rejected;
 17. stark_zk   zero knowledge: the 2^5-row FibonacciStark of
                tests/test_stark_zk.py with pinned salts and mask equal to
                tests/golden/torch_starky_zk_2^5.json; then a 2^22-row
                FibonacciStark with zero_knowledge=True under
                standard_fast_config: two unseeded proofs that verify and
                open to different values, a wrong public result rejected;
 18. stark_recursion
                the PLONK proofs that wrap a STARK, under the unchanged
                standard_recursion_config: the circuits that verify phase
                12's 2^22-row STARK proof, phase 13's batch STARK proof and
                phase 15's 2^22-row lookup STARK proof (degree 2^14 each):
                build, witness (native), prove, verify, a second proof;
                each circuit's shape equal to the JAX package's
                (tests/golden/torch_*_outer_*_shape.json); a tampered STARK
                proof failing the outer witness;
 19. hashers_small
                the circuit of the JAX package's
                tests/test_generic_config.py::_build (fib(11) under its
                _small_config, models/hasher_fib.py) proven under
                keccak_goldilocks_config and poseidon2_goldilocks_config:
                proof and common data equal to
                tests/golden/torch_{keccak,poseidon2}_fib_{proof,common}.bin
                (tools/gen_hasher_pins.py), each verified and rejected under
                the Poseidon config; the batched Poseidon2 permutation on the
                card against the host one on edge and random states; the
                three Poseidon2 gates' device eval against their host eval;
 20. poseidon2_2^16
                phase 4's NoopGate circuit (degree 2^16, LDE 2^19, 143
                wires) under the unchanged standard_recursion_config and
                poseidon2_goldilocks_config: every Merkle tree and the PoW
                grind by the batched Poseidon2 permutation on the card (the
                field product kernel under it), the public-input hash a
                Poseidon2Gate row; build, prove, verify, a second proof
                (equal bytes; syncs and launches), a proof with the tree
                builds timed (no sync allowed inside them), a tampered
                opening and the Poseidon config rejected;
 21. poseidon2_chain_2^13
                2^12 + 1 Poseidon2 permutations in a chain of Poseidon2Gate
                rows (models/poseidon2_chain.py) under the same configs,
                degree 2^13: build, prove, verify, the last output against
                the host permutation applied as many times, witness seconds
                and the generators left to Python, a second proof, tampers;
 22. keccak_2^12
                phase 5's circuit (degree 2^12) under
                keccak_goldilocks_config: trees and the 16-bit PoW grind on
                the host (native Keccak), as in the JAX package; build,
                prove, verify, a second proof (equal bytes) with the host
                trees' and the host grind's seconds apart, tampers;
 23. checkpoint_aux
                phase 4's circuit (degree 2^16) through a checkpoint
                (utils/serialization.circuit_data_to_bytes): its size and
                the seconds to write and to load it; loaded on the card, the
                commit kernels rebuild its constants/sigmas commitment (the
                field product, an FFT kernel, the sponge and the two-to-one
                compression must launch); the reloaded circuit writes the
                same bytes and proves to the pinned digest; that proof is
                verified in a ``python -I`` subprocess that blocks torch and
                imports plonky2_tpu_torch.verifier only (the compressed
                round trip, a tampered public input rejected); one
                fibonacci proof on the card under utils/profiling.trace, the
                trace file (torch_traces/chip_smoke_fibonacci/) naming the
                six prover-step spans and hand-written kernels;
 24. mesh_2^16  the same circuit under a prover mesh of 8 virtual shards on
                card 0 (parallel/context.make_prover_mesh(8, virtual_on=
                cuda:0)), whose trees, leaves and coefficients stay on their
                shards: a device-transcript proof (first call), a second
                one under the sync debug mode (at most PoW chunks + 1
                syncs) with the caching allocator's history recorded (its
                largest single allocation) and a host-transcript one, each
                equal to phase 23's proof byte for byte; then phase 23's
                checkpoint loaded again under the mesh (its constants/sigmas
                oracle sharded too; written again, the same bytes) and the
                same three proofs from it; the largest single allocation of
                a one-device proof of the circuit beside them (each mesh
                proof's at most a quarter of it); the same
                proofs over every card when the machine has a power of two
                of them (more than one); make_prover_mesh refuses more cards
                than there are; the six-step FFT and IFFT at 2^24 points
                against ntt.fft/ifft, the six-step coset IFFT over the
                quotient's shape against ntt.coset_ifft, the sharded Merkle
                cap of [2^19, 143] leaves against the single-device tree at
                cap heights 0-4; peak memory; the field product, the
                permutation, the two-to-one compression, the sponge and the
                row FFT must launch in each of the virtual-shard proofs,
                counted from the first proof's start to the sixth's end
                (the load between them included; the checks after them
                not);
 25. main_path_kernels
                each kernel held bit-exact against its plain version at
                every shape that phases 3-24 launched it at (read from the
                bindings' records, not from a list written here), then
                timed (CUDA events) at the largest of them (the permutation
                also at the device transcript's [1, 12] duplex, the column
                FFT also at the STARK path's two largest, the row FFT also
                at the FRI fold's (2, 2^15)) next to the plain version and
                to the least time the card could take for the same work.

Phases 4, 5, 7, 8, 9, 10 (its shrink-1 build, proof and verify), 12, 13
(the full-width batch STARK's first proof and verify), 15-17 (the
full-width first proof and verify), 18 (the three circuits' build, proof
and verify), 20-22 (build, first proof, verify) and 24 (the whole
phase) are the main paths:
every kernel's launch counter is zeroed just before each and read just
after; each of the six kernels must have launched on phases 4, 7, 8, 10,
12, 13, 15-18, and each but the column FFT on phases 5 and 9; the field
product, the column FFT and the row FFT on phase 20, the field product and
the row FFT on phases 21 and 22 (the other hashers run no Poseidon kernel:
their trees, transcripts and grinds are Poseidon2's on the card or
Keccak's on the host); each but the column FFT on phase 24.

Then the card line, one ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``. Any failure exits non-zero; nothing is
caught and carried on from. Without a CUDA device the script exits
non-zero at once: it never falls back to the CPU.

Integer kernels: the tolerance is none — outputs must be equal word for
word, so ``max_abs_err`` is 0 or the run fails.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import time
import warnings
from contextlib import contextmanager

import numpy as np
import torch

# The H100 SXM peaks used for the bounds (device memory 3.35e12 bytes a
# second, 33.5e12 integer operations a second with a multiply-add counted
# as two) are plonky2_tpu_torch/utils/profiling.py's HBM_BYTES_PER_S and
# INT32_OPS_PER_S, where they are derived; bound_record computes through
# its Roofline.

# 32x32->64 multiply-adds of one Poseidon permutation, counted for the
# cheapest algorithm known to this repo (hash/poseidon_fast.py), the one the
# kernels run. A field product is 4 partial products, a square 3,
# so an S-box x^7 = (x^2, x^3, (x^3)^2, x * x^6) is 14. A dense MDS layer is
# 12 x 12 entries (< 2^6) x 2 half-words = 288.
#   8 full rounds:        8 x (12 S-boxes + dense MDS)
#   pre-partial matrix:   11 x 11 products by 64-bit constants
#   22 partial rounds:    1 S-box + 23 products (1 by MDS[0][0], 11 by the
#                         round's w_hat, 11 by its v), each taken as 4
# Constant adds, carries and modular reductions are left out of both counts.
MADS_PER_PERMUTATION = 8 * (12 * 14 + 288) + 11 * 11 * 4 + 22 * (14 + 23 * 4)
OPS_PER_PERMUTATION = 2 * MADS_PER_PERMUTATION

# A Goldilocks product is 4 32x32->64 partial products (the count above):
# 8 integer operations.
OPS_PER_FIELD_PRODUCT = 8

POSEIDON_SOURCE = "plonky2_tpu_torch/ops/csrc/poseidon.cu"
FIELD_SOURCE = "plonky2_tpu_torch/ops/csrc/field.cu"
NTT_SOURCE = "plonky2_tpu_torch/ops/csrc/ntt.cu"

# degree bits of the full-width circuit: 2^15 + 1 NoopGates pad to 2^16 rows
LOG2_GATES = 16
# degree bits of the inner proof of the JAX package's recursion benchmark
# (benches/driver_workloads.py `recursive`, models/bench_recursion.py
# dummy_proof): 2^11 + 1 NoopGates; its common data, verifier data and
# proof, as that package writes them, are the three length-prefixed parts
# of tests/golden/bench_inner_2^12.bin
INNER_LOG2_GATES = 12
# SHA-256 of that circuit's serialized proof as commit 68c8277 (the first
# slice of the port, before the field-product and NTT kernels) produces it:
# `python3 tools/torch_plonk_digest.py` run from a checkout of 68c8277 on an
# NVIDIA H100 80GB HBM3. The prover is deterministic, so this pins that the
# new kernels leave the PLONK proof unchanged.
PLONK_PROOF_SHA256 = "792b6ed774add302bc0817463c3bc8497fee8d87fb9474e0e14a0de0ecd2c584"

# degree bits of the gate-mix circuit (plonky2_tpu_torch/models/gate_mix.py)
# at full width, and of the one whose proof is pinned from the JAX package:
# GATE_MIX_PIN_SHA256 is what `JAX_PLATFORMS=cpu python3
# tools/gen_gate_mix_pins.py --digest 13` prints (the JAX package proving
# the same circuit on the CPU, op by op: 1,421 s on a shared 8-core host,
# so its degree-2^16 proof was not pinned)
GATE_MIX_LOG2 = 16
GATE_MIX_PIN_LOG2 = 13
GATE_MIX_PIN_SHA256 = "dba90deb7ea8fdc8a18b4917a0bcb8a36dc30bdefe13bacd8d312e889aa649ca"
# the zero-knowledge gate mix, and its fixed salt and blinding streams
ZK_LOG2 = 12
ZK_SALT_SEED = 1234
ZK_BLINDING_SEED = 5678

# rows of the STARK path (benches/driver_workloads.py `stark`) and of the
# STARK proven on both the card and the CPU
STARK_LOG_ROWS = 22
STARK_SMALL_LOG_ROWS = 10
# rows of the batch STARK's three tables (log2), and of the small batch
# system of tests/test_batch_stark.py held to the JAX package's pinned proof
# (tests/golden/torch_batch_stark_7_5.json, tools/gen_batch_pins.py)
BATCH_LOG_ROWS = [22, 18, 14]
BATCH_SMALL_LOG_ROWS = [7, 5]
# the rest of Starky: the logUp PermutationStark, the two-table system
# joined by a cross-table lookup (the looking table's two columns hold
# every value of the looked table), the zero-knowledge FibonacciStark; and
# their small forms held to the JAX package's pins (tools/gen_starky_pins.py)
LOOKUP_LOG_ROWS = 22
CTL_LOG_ROWS = [21, 22]
ZK_STARK_LOG_ROWS = 22
STARKY_SMALL_LOG_ROWS = 5
STARKY_X0 = 3
CTL_SMALL_LOG_ROWS = [5, 7]
CTL_X0 = 100
CTL_SHUFFLE_SEED = 0
# permutations of the Poseidon2 chain (models/poseidon2_chain.py): 2^12 + 1
# Poseidon2Gate rows and the public-input hash's pad to degree 2^13
CHAIN_PERMUTATIONS = (1 << 12) + 1

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


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call of fn: CUDA events around ``reps`` calls
    enqueued back to back, after a warm-up call, so that the host's launch
    overhead hides behind the device's work (time_ms's one-call events
    include it)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, reps: int = 20, attempts: int = 3):
    """Device time of the kernels of one call of fn: torch.profiler (CUPTI)
    around ``reps`` calls after a warm-up call, every kernel's own duration
    summed and divided by reps. Gaps between launches do not count, so at
    small shapes this reads the card's work where device_ms reads the
    host's launch rate. A session whose kernel launches are no multiple of
    ``reps`` (the profiler loses a session's kernels, or some of them, now
    and then) is run again; None if every attempt lost kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        us = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
                 for e in kernels)
        launches = sum(e.count for e in kernels)
        if us > 0 and launches % reps == 0:
            return us / reps / 1e3
    return None


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


def kernel_modules():
    from plonky2_tpu_torch.ops import field_cuda, ntt_cuda, poseidon_cuda

    return poseidon_cuda, field_cuda, ntt_cuda


def reset_counts() -> None:
    for m in kernel_modules():
        m.reset_launches()


def read_counts() -> dict:
    """Launches of each kernel since the last reset_counts."""
    out = {}
    for m in kernel_modules():
        out.update(m.LAUNCHES)
    return out


def read_shapes() -> dict:
    """Distinct launch shapes of each kernel since the last reset_counts."""
    out = {}
    for m in kernel_modules():
        out.update({k: set(v) for k, v in m.LAUNCH_SHAPES.items()})
    return out


POSEIDON_KERNELS = ("poseidon_permute_kernel", "poseidon_compress_kernel", "poseidon_sponge_kernel")
# Loops of each Poseidon kernel in the order of their code, as (trip count,
# inner loops): the permutation's first four full rounds, its 22 partial
# rounds and its last four full rounds; the sponge runs them once a chunk.
# The sponge is counted at 18 chunks (w = 143, the PLONK wire leaves).
SPONGE_COUNT_CHUNKS = 18
PERMUTATION_LOOPS = [(4, []), (22, []), (4, [])]
POSEIDON_LOOPS = {
    "poseidon_permute_kernel": (PERMUTATION_LOOPS, 1),
    "poseidon_compress_kernel": (PERMUTATION_LOOPS, 1),
    "poseidon_sponge_kernel": ([(SPONGE_COUNT_CHUNKS, PERMUTATION_LOOPS)], SPONGE_COUNT_CHUNKS),
}
SM_REGISTERS, SM_SHARED_BYTES, SM_MAX_WARPS = 65536, 233472, 64


def source_define(path: str, name: str) -> int:
    """An integer #define of a kernel source."""
    with open(path) as f:
        return int(re.search(rf"#define {name} (\d+)", f.read()).group(1))


def poseidon_threads() -> int:
    """Threads a block of the Poseidon kernels (POSEIDON_THREADS)."""
    return source_define(POSEIDON_SOURCE, "POSEIDON_THREADS")


def ptxas_report(text: str, kernels=POSEIDON_KERNELS, threads=None) -> dict:
    """Registers, spills, stack and shared memory of each kernel whose
    (mangled) name holds one of ``kernels`` (a tuple of names, or {label:
    name}), read from ptxas -v's report, and the warps an SM can hold at
    that many registers and that much static shared memory with blocks of
    ``threads`` threads (default: the Poseidon kernels')."""
    if not isinstance(kernels, dict):
        kernels = {k: k for k in kernels}
    out, cur = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            cur = next((label for label, k in kernels.items() if k in line), None)
        elif cur and "stack frame" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            out.setdefault(cur, {}).update(
                stack_bytes=nums[0], spill_store_bytes=nums[1], spill_load_bytes=nums[2])
        elif cur and "Used" in line and "registers" in line:
            rec = out.setdefault(cur, {})
            rec["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            rec["smem_bytes"] = int(smem.group(1)) if smem else 0
    warps = (threads or poseidon_threads()) // 32
    for rec in out.values():
        per_warp = -(-rec["registers"] * 32 // 256) * 256  # allocated 256 at a time
        blocks = min(SM_REGISTERS // (per_warp * warps), SM_MAX_WARPS // warps,
                     SM_SHARED_BYTES // rec["smem_bytes"] if rec["smem_bytes"] else 32)
        rec["warps_per_sm_from_ptxas"] = blocks * warps
    return out


def sass_functions(text: str) -> dict:
    """cuobjdump -sass text -> {function name: [(address, instruction)]}
    (branch targets are printed as addresses)."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def sass_dynamic_count(code, loops):
    """Instructions one thread issues running ``code`` once, with each
    loop's body counted trip-count times. A loop is a backward branch;
    ``loops`` gives the trip counts of the loops found, as (trips, inner)
    in the order of their code. Returns (total, integer multiplies,
    [(trip count, instructions in the body)] of the loops) or (None, None,
    the loop spans found) when they differ from ``loops``. Both sides of a
    forward branch count (an upper bound)."""
    spans = []
    for addr, ins in code:
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)\s*$", ins)
        # a branch to itself is the padding after EXIT, not a loop
        if m and int(m.group(1), 16) < addr:
            spans.append((int(m.group(1), 16), addr))
    spans.sort(key=lambda sp: (sp[0], -sp[1]))

    def assign(spans, loops):
        """[(span, trips)] or None, matching nested spans to nested loops."""
        out, i = [], 0
        for trips, inner in loops:
            if i >= len(spans):
                return None
            span = spans[i]
            nested = [sp for sp in spans[i + 1:] if span[0] <= sp[0] and sp[1] <= span[1]]
            sub = assign(nested, inner)
            if sub is None:
                return None
            out += [(span, trips)] + [(sp, t) for sp, t in sub]
            i += 1 + len(nested)
        return out if i == len(spans) else None

    matched = assign(spans, loops)
    if matched is None:
        return None, None, spans
    total = imad = 0
    for addr, ins in code:
        mult = 1
        for (lo, hi), trips in matched:
            if lo <= addr <= hi:
                mult *= trips
        total += mult
        if re.search(r"\bIMAD", ins):
            imad += mult
    bodies = [(trips, sum(lo <= a <= hi for a, _ in code)) for (lo, hi), trips in matched]
    return total, imad, bodies


def poseidon_sass(lib_path) -> dict:
    """SASS instructions a thread issues a permutation, per Poseidon kernel."""
    from plonky2_tpu_torch.ops import cuda_build

    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    funcs = sass_functions(run_text([cuobjdump, "-sass", str(lib_path)]))
    out = {}
    for kernel, (loops, perms) in POSEIDON_LOOPS.items():
        name = next(n for n in funcs if kernel in n)
        total, imad, bodies = sass_dynamic_count(funcs[name], loops)
        out[kernel] = {
            "static_instructions": len(funcs[name]),
            "sass_per_permutation": None if total is None else total / perms,
            "imad_per_permutation": None if imad is None else imad / perms,
            # (trip count, instructions) of each loop; the permutation's are
            # its first full rounds, its partial rounds, its last full rounds
            "loop_bodies" if total is not None else "loop_spans_found": bodies,
        }
    return out


# the NTT pass kernels, by their names in ptxas' and cuobjdump's reports
NTT_PASS_KERNELS = {"col_fft_kernel": "_Z14col_fft_kernel", "row_fft_kernel": "_Z14row_fft_kernel"}


def butterfly_loops(code) -> list:
    """The loops of an NTT kernel that each run one set of butterflies: a
    loop (backward branch) whose body loads 2^G words (LDS.64 or LDG.E.64)
    and stores 2^G, and holds no smaller such loop. Returns (G, products,
    instructions) for each: one IMAD.WIDE.U32.X a field product, every
    instruction of the body (nested loops once)."""
    spans = set()
    for addr, ins in code:
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)\s*$", ins)
        if m and int(m.group(1), 16) < addr:
            spans.add((int(m.group(1), 16), addr))
    found = {}
    for lo, hi in spans:
        body = [ins for a, ins in code if lo <= a <= hi]
        loads = sum(bool(re.search(r"\b(LDS\.64|LDG\.E\.64)(\s|$)", i)) for i in body)
        stores = sum(bool(re.search(r"\b(STS\.64|STG\.E\.64)\s", i)) for i in body)
        if loads >= 2 and loads == stores and loads & (loads - 1) == 0:
            products = sum("IMAD.WIDE.U32.X" in i for i in body)
            found[(lo, hi)] = (loads.bit_length() - 1, products, len(body))
    return [v for sp, v in found.items()
            if not any(o != sp and sp[0] <= o[0] and o[1] <= sp[1] for o in found)]


def ntt_pass_sass(funcs: dict, kernels=NTT_PASS_KERNELS) -> dict:
    """SASS instructions a thread issues a butterfly in each NTT pass kernel, by
    the form of a stage group's set loop: G stages on 2^G words, G * 2^(G-1)
    butterflies, each loop's instructions over its butterflies; "first"
    for the first group's form with J = 0, whose products by the twiddle 1
    are left out (fewer products than butterflies). The mean of a form's
    loops (device or shared memory in and out)."""
    out = {}
    for label, key in kernels.items():
        name = next(n for n in funcs if key in n)
        by_form = {}
        for g, products, count in butterfly_loops(funcs[name]):
            butterflies = g << (g - 1)
            form = f"G{g}" + ("_first" if products < butterflies else "")
            by_form.setdefault(form, []).append(count / butterflies)
        out[label] = {
            "static_instructions": len(funcs[name]),
            "sass_per_butterfly": {f: statistics.mean(v) for f, v in sorted(by_form.items())},
        }
    return out


def phase_device() -> str:
    from plonky2_tpu_torch.ops import cuda_build

    card = card_line()
    t0 = time.perf_counter()
    built = cuda_build.build_all([m.LIB for m in kernel_modules()], verbose=True)
    build_s = time.perf_counter() - t0
    for name, (_, text) in built.items():
        print(f"ptxas report of {name}:\n{text}", flush=True)
    poseidon = ptxas_report(built["poseidon"][1])
    for kernel, rec in poseidon_sass(built["poseidon"][0]).items():
        poseidon.setdefault(kernel, {}).update(rec)
    col_threads = source_define(NTT_SOURCE, "NTT_COL_THREADS")
    col = ptxas_report(built["ntt"][1], NTT_PASS_KERNELS, col_threads)
    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    funcs = sass_functions(run_text([cuobjdump, "-sass", str(built["ntt"][0])]))
    for kernel, rec in ntt_pass_sass(funcs).items():
        col.setdefault(kernel, {}).update(rec)
    from plonky2_tpu_torch.ops import ntt_cuda

    tile = (8 << ntt_cuda.COL_TILE_WORDS_LOG) + 1024  # a block's tile and reserve
    for rec in col.values():
        if "warps_per_sm_from_ptxas" not in rec:  # the libraries were built before this run
            continue
        rec["blocks_per_sm_with_plan_tile"] = min(
            rec["warps_per_sm_from_ptxas"] // (col_threads // 32), SM_SHARED_BYTES // tile)
    nvcc = run_text([cuda_build.nvcc(), "--version"]).splitlines()[-2:]
    say({
        "phase": "device",
        "card": card,
        "device_name": torch.cuda.get_device_name(0),
        "device_count": torch.cuda.device_count(),
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": nvcc,
        "kernel_libraries": {k: os.path.relpath(v[0]) for k, v in built.items()},
        "kernel_build_s": round(build_s, 3),
        "poseidon_kernels": poseidon,
        "poseidon_threads_per_block": poseidon_threads(),
        "ntt_pass_kernels": col,
        "ntt_pass_threads_per_block": col_threads,
    })
    return card


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def random_field(rng, shape, device) -> torch.Tensor:
    from plonky2_tpu_torch.ops import gf

    return gf.from_u64(rng.integers(0, P, size=shape, dtype=np.uint64), device)


# states at the edges of the kernels' lazy reduction: every lane p - 1
# (which is 2^64 - 2^32), every lane 2^32 - 1, 0 and p - 1 alternating,
# and further words near the 32- and 64-bit borders
EDGE_STATES = [
    [P - 1] * 12, [(1 << 64) - (1 << 32)] * 12, [(1 << 32) - 1] * 12, [0, P - 1] * 6,
    [P - 1, 0] * 6, [1 << 32] * 12, [1 << 63] * 12, [P - 2, (1 << 32) - 1] * 6, [1] * 12,
]


def edge_rows(rng, b, w, device) -> torch.Tensor:
    """b random rows of width w whose first rows are the edge states (cut
    or repeated to width w) and the reference vectors' inputs."""
    from plonky2_tpu_torch.ops import gf

    x = random_field(rng, (b, w), device)
    special = EDGE_STATES + [v[0] for v in VECTORS]
    for i, row in enumerate(special[:b]):
        x[i] = gf.from_u64(np.resize(np.array(row, dtype=np.uint64), w), device)
    return x


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
        x = edge_rows(rng, b, 12, device)
        got = dp.permute(x)
        torch.cuda.synchronize()
        worst = max(worst, max_abs_err(got, dp.permute_plain(x)))
    return worst


def check_compress(rng, device, batches) -> float:
    """compress_pairs on [2B, 4] levels (read as [B, 8]) against the plain
    version."""
    from plonky2_tpu_torch.ops import poseidon as dp

    worst = 0.0
    for b in batches:
        level = edge_rows(rng, b, 8, device).view(2 * b, 4)
        got = dp.compress_pairs(level)
        torch.cuda.synchronize()
        worst = max(worst, max_abs_err(got, dp.compress_pairs_plain(level)))
    return worst


def check_sponge(rng, device, shapes) -> float:
    from plonky2_tpu_torch.ops import poseidon as dp

    worst = 0.0
    for b, w, cap in shapes:
        x = edge_rows(rng, b, w, device)
        got = dp.sponge(x, cap)
        torch.cuda.synchronize()
        worst = max(worst, max_abs_err(got, dp.sponge_plain(x, cap)))
    return worst


def check_sponge_views(rng, device) -> float:
    """The sponge of rows that start inside their storage (odd widths put
    them off the 16-byte grid the kernel's copies need)."""
    from plonky2_tpu_torch.ops import poseidon as dp

    worst = 0.0
    for b, w in ((5, 7), (130, 13), (300, 143)):
        view = edge_rows(rng, b + 1, w, device)[1:]
        got = dp.sponge(view, w + 1)
        torch.cuda.synchronize()
        worst = max(worst, max_abs_err(got, dp.sponge_plain(view, w + 1)))
    return worst


def require_exact(errs: dict) -> None:
    if any(e != 0.0 for e in errs.values()):
        raise SystemExit(f"a kernel disagrees with its plain version: {errs}")


def with_edges(x: torch.Tensor) -> torch.Tensor:
    """The first entries 0, 1, p - 1 (boundary values of the field)."""
    from plonky2_tpu_torch.ops import gf

    flat = x.view(-1)
    edges = [0, 1, gf._s64(P - 1)][: flat.numel()]
    flat[: len(edges)] = torch.tensor(edges, dtype=flat.dtype, device=flat.device)
    return x


def mul_forms(rng, device) -> list:
    """(a, b) pairs in every call form of gf.mul: one shape, b broadcast
    along leading axes, along inner axes, both broadcast, strided views,
    a 0-dim operand, and a Python int (boundary values included)."""
    a = with_edges(random_field(rng, (64, 3, 40), device))
    return [
        (a, with_edges(random_field(rng, (64, 3, 40), device))),
        (a, random_field(rng, (40,), device)),
        (a, random_field(rng, (3, 1), device)),
        (a, random_field(rng, (64, 1, 1), device)),
        (random_field(rng, (64, 1, 40), device), random_field(rng, (1, 3, 1), device)),
        (a[:, 1:, ::2], random_field(rng, (2, 20), device)),
        (a.transpose(0, 2), random_field(rng, (3, 64), device)),
        (random_field(rng, (), device), a),
        (a, 0), (a, 1), (a, P - 1), (a, 0x1234_5678_9ABC_DEF0),
        (with_edges(random_field(rng, (1 << 23,), device)), random_field(rng, (1 << 23,), device)),
    ]


def check_mul(pairs) -> float:
    from plonky2_tpu_torch.ops import gf

    worst = 0.0
    for a, b in pairs:
        got = gf.mul(a, b)
        torch.cuda.synchronize()
        worst = max(worst, max_abs_err(got, gf.mul_plain(a, b)))
    return worst


# words of the buffer under the 64-bit-index forms of the product: 2^31 (16
# GiB) and a margin, so that offsets of the views reach past 2^31
WIDE_BUFFER_WORDS = (1 << 31) + (1 << 20)


def check_mul_wide_index(rng, device) -> tuple:
    """The product kernel's 64-bit-index instantiation (gl_mul_kernel<unsigned
    long long>), which the wrapper takes when an offset reaches 2^31: views
    over a zeroed buffer of WIDE_BUFFER_WORDS words, written at the words
    they touch, with small outputs, against the plain version. Returns (the
    largest error, the launch forms, every one of them asserted wide)."""
    from plonky2_tpu_torch.ops import field_cuda

    buf = torch.zeros(WIDE_BUFFER_WORDS, dtype=torch.int64, device=device)

    def view(sizes, strides):
        v = torch.as_strided(buf, sizes, strides)
        v.copy_(with_edges(random_field(rng, sizes, device)))
        return v

    cols = 1 << 10
    pairs = [
        # two rows 2^31 words apart, the other operand broadcast along them
        (view((2, cols), (1 << 31, 1)), random_field(rng, (cols,), device)),
        # three rows at an odd stride past 2^30, an operand of the same shape
        (view((3, 1000), ((1 << 30) + 7, 1)), random_field(rng, (3, 1000), device)),
        # one strided axis (the kernel's one-axis branch) by a Python int
        (view((cols,), (2_099_203,)), 0x1234_5678_9ABC_DEF0),
    ]
    field_cuda.reset_launches()
    worst = check_mul(pairs)
    forms = sorted(field_cuda.LAUNCH_SHAPES["mul"], key=repr)
    for sizes, sa, sb in forms:
        if not field_cuda.wide_index(sizes, sa, *([sb] if sb else [])):
            raise SystemExit(f"mul form {(sizes, sa, sb)} did not take the 64-bit index")
    if len(forms) != len(pairs):
        raise SystemExit(f"expected {len(pairs)} 64-bit-index mul launches, got {forms}")
    field_cuda.reset_launches()
    del buf, pairs
    torch.cuda.empty_cache()
    return worst, [[list(sz), list(sa), sb and list(sb)] for sz, sa, sb in forms]


def with_noncanonical(x: torch.Tensor) -> torch.Tensor:
    """The last entries p, p + 1, 2^64 - 1: words past the field, which the
    kernels take as gl_mul does (the column kernel's products by the
    twiddle 1 rest on gl_mul(v, 1) = gl_canon(v) for every word)."""
    from plonky2_tpu_torch.ops import gf

    flat = x.view(-1)
    words = [gf._s64(P), gf._s64(P + 1), -1][: flat.numel()]
    flat[flat.numel() - len(words):] = torch.tensor(words, dtype=flat.dtype, device=flat.device)
    return x


def check_col_fft(rng, device, forms) -> float:
    """forms: (batch, k_log, L, first_stage, inverse) -> ntt._fft_rows (the
    col_fft kernel) against ntt._butterflies_rows."""
    from plonky2_tpu_torch.ops import ntt

    worst = 0.0
    for batch, k_log, lanes, first, inverse in forms:
        x = with_noncanonical(with_edges(random_field(rng, (batch, 1 << k_log, lanes), device)))
        got = ntt._fft_rows(x, k_log, inverse, first)
        torch.cuda.synchronize()
        want = ntt._butterflies_rows(x, ntt.stage_roots(k_log, inverse, device), first)
        worst = max(worst, max_abs_err(got, want))
    return worst


def check_row_fft(rng, device, forms) -> float:
    """forms: (rows, n_log, first_stage, inverse) -> ntt._fft_flat (the
    row_fft kernel) against ntt._butterflies."""
    from plonky2_tpu_torch.ops import ntt

    worst = 0.0
    for rows, n_log, first, inverse in forms:
        x = with_edges(random_field(rng, (rows, 1 << n_log), device))
        got = ntt._fft_flat(x, n_log, inverse, first)
        torch.cuda.synchronize()
        want = ntt._butterflies(x, ntt.stage_roots(n_log, inverse, device), first)
        worst = max(worst, max_abs_err(got, want))
    return worst


# fixed lists of the NTT kernels' forms: seeded first stages (1 = the
# STARK's rate_bits, 3 = the PLONK config's), transforms past the fused
# tiles (col: 2^13 rows > the 2^12-row cap), and
# column widths 2^8 (n1 of a 2^16 transform), 2^11 and 2^12 (the STARK's);
# then the edges of the column plan (ops/ntt_cuda.col_plan): stage counts
# that are no multiple of the register group (9 = 3+3+3, 7 = 4+3, 5 = 3+2,
# 10 = 4+3+3), passes that start at stage 1, 2 or 3, one stage, no stage
# (a copy), L = 1, 2 and 4096, 2^12 rows at 2 lanes, 2^12 rows from stage 0
# split into two passes, 2^13 rows at L = 4096
COL_FFT_FIXED = [
    (2, 12, 1 << 11, 1, False), (2, 11, 1 << 12, 0, False), (2, 12, 1 << 11, 0, True),
    (2, 8, 1 << 8, 0, True), (3, 10, 1 << 8, 3, False), (1, 13, 4, 0, False),
    (3, 13, 16, 1, True), (2, 5, 2, 2, False), (1, 1, 1 << 12, 0, False),
    (3, 9, 1 << 10, 0, True), (2, 7, 8, 0, False), (5, 6, 1, 1, True), (2, 12, 64, 2, False),
    (1, 10, 1 << 12, 3, True), (1, 12, 2, 0, True), (2, 11, 16, 10, False),
    (2, 4, 8, 4, False), (1, 13, 1 << 12, 2, False), (4, 3, 1, 0, False),
    (3, 12, 16, 0, False),
]
# the row plan's edges (ops/ntt_cuda.row_plan): 2^13, 2^14 and 2^15 words
# around the one-pass limit, one row and two rows, row counts that are no
# multiple of a tile's rows (4999 in tiles of 4, 2501 in tiles of 2), seeded
# first stages 1, 3 and 4, no stage (a copy), n = 1, and 2^25 words (one
# tail stage past the two passes' 2^24)
ROW_FFT_FIXED = [
    (4, 3, 0, False), (143, 3, 3, False), (1000, 5, 1, True), (16, 11, 4, False),
    (2, 14, 0, True), (2, 15, 1, False), (3, 15, 0, True), (1, 1, 0, False),
    (3, 13, 0, True), (1, 13, 2, False), (1, 14, 3, False), (1, 15, 0, False),
    (5, 15, 3, False), (4999, 5, 1, True), (2501, 7, 2, False), (7, 1, 0, True),
    (1, 25, 0, False),
]


# the fixed lists of the Poseidon kernels' forms: permute and compress
# batches, sponge (B, w, cap) over every width class of the chunked
# absorption (w <= 8, <= 16, odd and even, 83 and 143 of the PLONK leaves)
PERMUTE_FIXED = [1, 5, 12, 129, 2048, 1 << 18]
SPONGE_FIXED = [
    (b, w, cap)
    for w in (1, 2, 7, 8, 9, 13, 16, 17, 32, 83, 143)
    for cap in (0, w + 1)
    for b in (3, 12, 129, 1 << 15)
]


def phase_kernels() -> None:
    """Every kernel against its plain version at a fixed list of shapes."""
    device = torch.device("cuda")
    rng = np.random.default_rng(2026)
    permute_batches = PERMUTE_FIXED
    sponge_shapes = SPONGE_FIXED
    pairs = mul_forms(rng, device)
    wide_err, wide_forms = check_mul_wide_index(rng, device)
    errs = {
        "permute": check_permute(rng, device, permute_batches),
        "compress": check_compress(rng, device, permute_batches),
        "sponge": max(check_sponge(rng, device, sponge_shapes), check_sponge_views(rng, device)),
        "mul": check_mul(pairs),
        "col_fft": check_col_fft(rng, device, COL_FFT_FIXED),
        "row_fft": check_row_fft(rng, device, ROW_FFT_FIXED),
        "mul_64bit_index": wide_err,
    }
    # the twiddle tables cached for the fixed forms (512 MB for the
    # 2^25-word row form: the kernel's and the plain version's) would stay
    # allocated and count in the main paths' peak device memory
    from plonky2_tpu_torch.ops import ntt

    ntt._DEVICE_TABLES.clear()
    torch.cuda.empty_cache()
    say({
        "phase": "kernels",
        "check": "bit-exact against the plain PyTorch versions on the card",
        "permute_batches": permute_batches,
        "compress_batches": permute_batches,
        "edge_states": len(EDGE_STATES),
        "sponge_shapes_checked": len(sponge_shapes),
        "mul_forms_checked": len(pairs),
        "mul_64bit_index_forms": wide_forms,
        "mul_64bit_index_buffer_words": WIDE_BUFFER_WORDS,
        "col_fft_forms": COL_FFT_FIXED,
        "row_fft_forms": ROW_FFT_FIXED,
        "max_abs_err": errs,
    })
    require_exact(errs)


# ---------------------------------------------------------------------------
# Phase 1b: the kernels' first launches, in guarded buffers
# ---------------------------------------------------------------------------

# random words on each side of every guarded tensor: two of the column and
# row passes' 64 KiB tiles (their whole 128 KiB shared-memory limit)
GUARD_WORDS = 1 << 14
# the first transform of a process that builds the NoopGate 2^16 circuit:
# the inverse four-step over its 83 constants and sigmas polynomials
FIRST_IFFT = (83, 1 << 16)
# each kernel's largest form on the main paths (the forms phase
# main_path_kernels times): permute and compress batches; sponge (B, w,
# cap), the PLONK wire leaves; the product's merged sizes with a's and b's
# strides, the gate mix's filtered constraints; col_fft (batch, k_log, L,
# first, inverse); row_fft (rows, n_log, first, inverse)
GUARD_LARGEST = {
    "permute": 1 << 17,
    "compress": 1 << 22,
    "sponge": (1 << 19, 143, 144),
    "mul": ((179, 1 << 19), (1 << 19, 1), (1, 0)),
    "col_fft": (143, 9, 1 << 10, 0, False),
    "row_fft": (143, 15, 3, False),
}
# the sponge's rows that start inside their storage (check_sponge_views):
# odd widths put them off the 16-byte grid of the kernel's copies
SPONGE_VIEWS = [(5, 7), (130, 13), (300, 143)]


class Guarded:
    """A tensor's words inside a buffer of random words: GUARD_WORDS (plus
    ``shift``) before them, GUARD_WORDS after. ``seal`` keeps a copy of the
    buffer to compare with after a kernel ran."""

    def __init__(self, gen, device, span: int, shift: int = 0):
        self.lo = GUARD_WORDS + shift
        self.hi = self.lo + span
        self.buf = torch.randint(-(1 << 63), (1 << 63) - 1, (self.hi + GUARD_WORDS,),
                                 dtype=torch.int64, device=device, generator=gen)
        self.snapshot = None

    def seal(self) -> None:
        self.snapshot = self.buf.clone()

    def margins_intact(self) -> bool:
        return (torch.equal(self.buf[:self.lo], self.snapshot[:self.lo])
                and torch.equal(self.buf[self.hi:], self.snapshot[self.hi:]))

    def intact(self) -> bool:
        return torch.equal(self.buf, self.snapshot)


def guarded_input(gen, t: torch.Tensor, shift: int = 0):
    """t (any view) at its sizes and strides inside a Guarded buffer, the
    words between its elements copied along: (the view, its guard)."""
    span = 1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride())) if t.numel() else 0
    g = Guarded(gen, t.device, span, shift)
    g.buf[g.lo:g.hi] = t.as_strided((span,), (1,), t.storage_offset())
    g.seal()
    return g.buf.as_strided(t.shape, t.stride(), g.lo), g


def guarded_output(gen, shape, device):
    g = Guarded(gen, device, int(np.prod(shape, dtype=np.int64)))
    g.seal()
    return g.buf[g.lo:g.hi].view(shape), g


def run_guarded(gen, report: dict, kernel: str, form, call, inputs, want) -> None:
    """call(*inputs, out=...) with every tensor input and the output in a
    Guarded buffer: the output must equal ``want`` (the plain version's),
    its margins and every input's buffer must be unchanged, bit for bit."""
    placed, guards = [], []
    for x in inputs:
        if isinstance(x, torch.Tensor):
            v, g = guarded_input(gen, x)
            placed.append(v)
            guards.append(g)
        else:
            placed.append(x)
    out, og = guarded_output(gen, tuple(want.shape), want.device)
    got = call(*placed, out=out)
    problems = []
    if got.data_ptr() != out.data_ptr():
        problems.append("the result is not in out")
    if not torch.equal(out, want):
        problems.append("the output differs from the plain version")
    if not og.margins_intact():
        problems.append("the output's margins changed")
    if not all(g.intact() for g in guards):
        problems.append("an input or its margins changed")
    report["forms"][kernel] = report["forms"].get(kernel, 0) + 1
    if problems:
        report["failures"].append({"kernel": kernel, "form": repr(form), "problems": problems})


def guard_poseidon(rng, gen, device, report: dict) -> None:
    """The three Poseidon kernels at their fixed forms (the plain version
    once on the largest batch of a list, its rows the smaller batches'
    answers) and their largest main-path forms; the sponge's rows that
    start off the 16-byte grid refused by the kernel's wrapper and taken by
    ops/poseidon.sponge."""
    from plonky2_tpu_torch.ops import poseidon as dp, poseidon_cuda

    def permute(x, out):
        return poseidon_cuda.permute(x, out=out)

    def compress(x, out):
        return poseidon_cuda.compress(x, out=out)

    def sponge(x, cap, out):
        return poseidon_cuda.sponge(x, cap, out=out)

    b = max(PERMUTE_FIXED + [GUARD_LARGEST["permute"]])
    x = edge_rows(rng, b, 12, device)
    want = dp.permute_plain(x)
    for b in PERMUTE_FIXED + [GUARD_LARGEST["permute"]]:
        run_guarded(gen, report, "permute", b, permute, [x[:b]], want[:b])
    b = max(PERMUTE_FIXED + [GUARD_LARGEST["compress"]])
    x = edge_rows(rng, b, 8, device)
    want = dp.compress_pairs_plain(x.view(-1, 4))
    for b in PERMUTE_FIXED + [GUARD_LARGEST["compress"]]:
        run_guarded(gen, report, "compress", b, compress, [x[:b]], want[:b])
    # the sponge's largest form joins the fixed forms of its (w, cap); the
    # off-grid views are rows 1..b of theirs
    views = {(w, w + 1): b for b, w in SPONGE_VIEWS}
    for (w, cap), forms in itertools.groupby(SPONGE_FIXED + [GUARD_LARGEST["sponge"]],
                                             key=lambda f: f[1:]):
        bs = [f[0] for f in forms]
        x = edge_rows(rng, max(bs + [views.get((w, cap), 0) + 1]), w, device)
        want = dp.sponge_plain(x, cap)
        for b in bs:
            run_guarded(gen, report, "sponge", (b, w, cap), sponge, [x[:b], cap], want[:b])
        if (w, cap) in views:
            b = views[w, cap]
            guard_sponge_view(gen, report, x[1:b + 1], cap, want[1:b + 1])
    del x, want


def guard_sponge_view(gen, report: dict, rows, cap: int, want) -> None:
    """Rows that start inside their storage, placed as they lie: off the
    16-byte grid for odd widths. Aligned, the kernel must hash them; off
    the grid, its wrapper must refuse them without a launch and
    ops/poseidon.sponge must hash a copy."""
    from plonky2_tpu_torch.ops import poseidon as dp, poseidon_cuda

    b, w = rows.shape
    run_guarded(gen, report, "sponge", (b, w, cap),
                lambda x, c, out: poseidon_cuda.sponge(x, c, out=out), [rows, cap], want)
    view, g = guarded_input(gen, rows, shift=rows.storage_offset() % 2)
    before = poseidon_cuda.LAUNCHES["sponge"]
    try:
        poseidon_cuda.sponge(view, cap)
        refused = False
    except ValueError:
        refused = poseidon_cuda.LAUNCHES["sponge"] == before
    got = dp.sponge(view, cap)
    report["sponge_off_grid"].append({
        "form": [b, w], "start_mod_16_bytes": view.data_ptr() % 16,
        "kernel_refused": refused, "ops_poseidon_sponge_equal": torch.equal(got, want),
        "input_intact": g.intact(),
    })
    if not (refused and torch.equal(got, want) and g.intact()):
        report["failures"].append({"kernel": "sponge", "form": f"off-grid view {(b, w)}",
                                   "problems": [report["sponge_off_grid"][-1]]})


def guard_mul(rng, gen, device, report: dict) -> None:
    """The field product at every call form of mul_forms and its largest
    main-path form."""
    from plonky2_tpu_torch.ops import field_cuda, gf

    def mul(a, b, out):
        return field_cuda.mul(a, b, out=out)

    pairs = mul_forms(rng, device) + [mul_operands(rng, device, GUARD_LARGEST["mul"])]
    for a, b in pairs:
        form = (tuple(a.shape), a.stride(), b if isinstance(b, int) else (tuple(b.shape), b.stride()))
        run_guarded(gen, report, "mul", form, mul, [a, b], gf.mul_plain(a, b))


def guard_ntt(rng, gen, device, report: dict) -> None:
    """The column FFT (its passes and ntt_stage_kernel's tail stages) and
    the row FFT at every form of their fixed lists and their largest
    main-path forms."""
    from plonky2_tpu_torch.ops import ntt, ntt_cuda

    for batch, k_log, lanes, first, inverse in COL_FFT_FIXED + [GUARD_LARGEST["col_fft"]]:
        x = with_noncanonical(with_edges(random_field(rng, (batch, 1 << k_log, lanes), device)))
        want = ntt._butterflies_rows(x, ntt.stage_roots(k_log, inverse, device), first)
        run_guarded(gen, report, "col_fft", (batch, k_log, lanes, first, inverse),
                    lambda v, out: ntt_cuda.col_fft(v, k_log, first, inverse, out=out), [x], want)
    for rows, n_log, first, inverse in ROW_FFT_FIXED + [GUARD_LARGEST["row_fft"]]:
        x = with_edges(random_field(rng, (rows, 1 << n_log), device))
        want = ntt._butterflies(x, ntt.stage_roots(n_log, inverse, device), first)
        run_guarded(gen, report, "row_fft", (rows, n_log, first, inverse),
                    lambda v, out: ntt_cuda.row_fft(v, n_log, first, inverse, out=out), [x], want)


def check_devices(rng) -> dict:
    """Each card's NTT launches go to that card: the NTT library's CUDA
    runtime (linked statically, apart from PyTorch's) sees as current the
    card torch.cuda.device made current; and, with more than one card, the
    [83, 2^16] inverse four-step and the column and row FFTs at their
    largest main-path forms on each other card's tensors, card 0 current,
    equal the plain versions (the passes' shared-memory limit raised in
    that card's context, the launches on its stream)."""
    from plonky2_tpu_torch.ops import gf, ntt, ntt_cuda

    count = torch.cuda.device_count()
    seen = {}
    for d in range(count):
        with torch.cuda.device(d):
            seen[d] = ntt_cuda.library_device()
    cross = {}
    for d in range(1, count):
        dev = torch.device("cuda", d)
        with torch.cuda.device(0):
            x = random_field(rng, FIRST_IFFT, dev)
            n_log = FIRST_IFFT[1].bit_length() - 1
            plain = gf.mul_plain(
                ntt._butterflies(ntt.bit_reverse(x), ntt.stage_roots(n_log, True, dev)),
                pow(FIRST_IFFT[1], P - 2, P))
            equal = {"ifft": torch.equal(ntt.ifft(x), plain)}
            batch, k_log, lanes, first, inverse = GUARD_LARGEST["col_fft"]
            x = with_noncanonical(with_edges(random_field(rng, (batch, 1 << k_log, lanes), dev)))
            want = ntt._butterflies_rows(x, ntt.stage_roots(k_log, inverse, dev), first)
            equal["col_fft"] = torch.equal(ntt_cuda.col_fft(x, k_log, first, inverse), want)
            rows, n_log, first, inverse = GUARD_LARGEST["row_fft"]
            x = with_edges(random_field(rng, (rows, 1 << n_log), dev))
            want = ntt._butterflies(x, ntt.stage_roots(n_log, inverse, dev), first)
            equal["row_fft"] = torch.equal(ntt_cuda.row_fft(x, n_log, first, inverse), want)
            torch.cuda.synchronize(dev)
        cross[d] = equal
        del x, want, plain
    ok = (all(seen[d] == d for d in seen)
          and all(all(equal.values()) for equal in cross.values()))
    return {
        "ok": ok,
        "library_current_device_by_torch_device": seen,
        "card_0_current_tensors_on_card": cross if cross else
        "not run: this machine has one card, so no launch can go to another card's tensors",
    }


def phase_kernel_guards() -> None:
    """The process's first launches of every kernel. First the first
    transform of a NoopGate 2^16 build, the [83, 2^16] inverse four-step
    through ntt.ifft, against the plain flat transform; then each kernel at
    every form of its fixed list and at its largest main-path form with
    every input and output inside a buffer of random words (run_guarded)."""
    from plonky2_tpu_torch.ops import ntt, ntt_cuda

    device = torch.device("cuda")
    rng = np.random.default_rng(2028)
    gen = torch.Generator(device=device)
    gen.manual_seed(2028)
    t0 = time.perf_counter()

    reset_counts()
    x = random_field(rng, FIRST_IFFT, device)
    got = ntt.ifft(x)
    torch.cuda.synchronize()
    first_launches = read_counts()
    from plonky2_tpu_torch.ops import gf

    n_log = FIRST_IFFT[1].bit_length() - 1
    plain = gf.mul_plain(ntt._butterflies(ntt.bit_reverse(x), ntt.stage_roots(n_log, True, device)),
                         pow(FIRST_IFFT[1], P - 2, P))
    first = {
        "shape": list(FIRST_IFFT), "launches": first_launches,
        "equal_plain_flat_transform": torch.equal(got, plain),
    }
    del x, got, plain

    report = {"forms": {}, "failures": [], "sponge_off_grid": []}
    seconds = {"first_ifft": time.perf_counter() - t0}
    reset_counts()
    for part in (guard_poseidon, guard_mul, guard_ntt):
        t1 = time.perf_counter()
        part(rng, gen, device, report)
        seconds[part.__name__] = time.perf_counter() - t1
    launches = read_counts()
    t1 = time.perf_counter()
    devices = check_devices(rng)
    seconds["check_devices"] = time.perf_counter() - t1
    tails = {
        "col_fft": [f for f in COL_FFT_FIXED
                    if ntt_cuda.col_plan(f[1], f[2].bit_length() - 1, f[3])[1] < f[1]],
        "row_fft": [f for f in ROW_FFT_FIXED if ntt_cuda.row_plan(f[0], f[1], f[2])[1] < f[1]],
    }
    ntt._DEVICE_TABLES.clear()
    torch.cuda.empty_cache()
    say({
        "phase": "kernel_guards",
        "check": "the process's first launches: the [83, 2^16] inverse four-step (ntt.ifft) "
                 "against the plain flat transform; then every kernel at every form of its "
                 "fixed list and its largest main-path form, inputs and output inside buffers "
                 "of random words: output equal to the plain version, output margins, inputs "
                 "and their margins unchanged bit for bit",
        "first_ifft": first,
        "guard_words_each_side": GUARD_WORDS,
        "largest_forms": {k: v for k, v in GUARD_LARGEST.items()},
        "forms_checked": report["forms"],
        "launches": launches,
        "tail_stage_forms": tails,
        "sponge_off_grid": report["sponge_off_grid"],
        "failures": report["failures"],
        "devices": devices,
        "seconds": time.perf_counter() - t0,
        "seconds_by_part": seconds,
    })
    if not (first["equal_plain_flat_transform"] and first_launches["col_fft"]
            and first_launches["mul"]):
        raise SystemExit(f"the first [83, 2^16] inverse transform failed its check: {first}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing or not all(tails.values()):
        raise SystemExit(f"kernel_guards launched no {missing} or ran no tail stage: {tails}")
    if report["failures"]:
        raise SystemExit(f"kernel_guards: {len(report['failures'])} forms failed: "
                         f"{report['failures'][:5]}")
    if not devices["ok"]:
        raise SystemExit(f"kernel_guards: a card's launches did not go to it: {devices}")


def bound_record(words_moved: int, operations: int) -> dict:
    """The least time the card could take: bytes over the memory rate
    against counted integer operations over the integer peak
    (utils/profiling.Roofline)."""
    from plonky2_tpu_torch.utils.profiling import roofline

    r = roofline("bound", 1.0, words_moved * 8, operations)
    return {
        "bound_ms": r.sol_seconds * 1e3,
        "bound_by": r.bound,
        "bound_bytes_ms": r.bytes_seconds * 1e3,
        "bound_operations_ms": r.ops_seconds * 1e3,
    }


def poseidon_bound(permutations: int, words_moved: int) -> dict:
    return bound_record(words_moved, permutations * OPS_PER_PERMUTATION)


def butterfly_bound(transforms: int, n_log: int, stages: int) -> dict:
    """A DIT over ``transforms`` transforms of 2^n_log points running
    ``stages`` stages: each word read and written once (plus the stage
    table), and (N/2) field products a stage."""
    words = 2 * (transforms << n_log) + (1 << n_log) - 1
    products = transforms * (1 << (n_log - 1)) * stages
    return bound_record(words, products * OPS_PER_FIELD_PRODUCT)


def strided_field(rng, sizes, strides, device) -> torch.Tensor:
    """A random view of the given sizes and element strides (0 along a
    broadcast axis) over a buffer just large enough for it."""
    span = 1 + sum((n - 1) * st for n, st in zip(sizes, strides))
    return torch.as_strided(random_field(rng, (span,), device), sizes, strides)


def mul_operands(rng, device, form):
    """A recorded launch form of the product kernel (merged sizes, the
    strides of both operands, None for an int) as fresh operands."""
    sizes, sa, sb = form
    a = strided_field(rng, sizes, sa, device)
    b = int(rng.integers(0, P, dtype=np.uint64)) if sb is None else strided_field(rng, sizes, sb, device)
    return a, b


def replay_mul(rng, device, forms) -> float:
    worst = 0.0
    for form in forms:
        worst = max(worst, check_mul([mul_operands(rng, device, form)]))
    return worst


def distinct_words(sizes, strides) -> int:
    """Elements of an operand a kernel must read once: its broadcast axes
    (stride 0) do not count."""
    return int(np.prod([n for n, st in zip(sizes, strides) if st != 0], dtype=np.int64))


def kernel_record(name, source, replaces, shape, err, ms, plain_ms, bound) -> dict:
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "shape": shape,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        **bound,
        "library_ms": None,
    }


# the STARK path's two largest column FFT launches: the seeded first pass
# (2^12 rows of 2^11 lanes from stage 1) and the second pass (2^11 x 2^12)
COL_FFT_TIMED_STARK = [(2, 12, 1 << 11, 1, False), (2, 11, 1 << 12, 0, False)]


def time_col_fft(rng, device, form, err) -> dict:
    """col_fft at one launch form (batch, k_log, L, first_stage, inverse)
    beside its plain version and its bound; ``ms`` as for every kernel,
    ``ms_back_to_back`` by device_ms, ``kernel_ms`` by kernel_ms."""
    from plonky2_tpu_torch.ops import ntt

    batch, k_log, lanes, first, inverse = form
    x = random_field(rng, (batch, 1 << k_log, lanes), device)
    table = ntt.stage_roots(k_log, inverse, device)
    ms = time_ms(lambda: ntt._fft_rows(x, k_log, inverse, first), runs=20, warmup=3)
    plain_ms = time_ms(lambda: ntt._butterflies_rows(x, table, first), runs=5)
    rec = kernel_record(
        "col_fft", NTT_SOURCE, "plonky2_tpu/ops/pallas_kernels.py:397",
        {"shape": [batch, 1 << k_log, lanes], "first_stage": first, "inverse": inverse},
        err, ms, plain_ms, butterfly_bound(batch * lanes, k_log, k_log - first),
    )
    rec["form"] = list(form)
    rec["ms_back_to_back"] = device_ms(lambda: ntt._fft_rows(x, k_log, inverse, first))
    rec["kernel_ms"] = kernel_ms(lambda: ntt._fft_rows(x, k_log, inverse, first))
    return rec


# the FRI fold's form, on every PLONK path (2^15 points, two rows)
ROW_FFT_TIMED_FOLD = [(2, 15, 0, False)]


def time_row_fft(rng, device, form, err) -> dict:
    """row_fft at one launch form (rows, n_log, first_stage, inverse) beside
    its plain version and its bound, as time_col_fft."""
    from plonky2_tpu_torch.ops import ntt

    rows, n_log, first, inverse = form
    x = random_field(rng, (rows, 1 << n_log), device)
    table = ntt.stage_roots(n_log, inverse, device)
    ms = time_ms(lambda: ntt._fft_flat(x, n_log, inverse, first), runs=20, warmup=3)
    plain_ms = time_ms(lambda: ntt._butterflies(x, table, first), runs=5)
    rec = kernel_record(
        "row_fft", NTT_SOURCE, "plonky2_tpu/ops/pallas_kernels.py:188",
        {"shape": [rows, 1 << n_log], "first_stage": first, "inverse": inverse},
        err, ms, plain_ms, butterfly_bound(rows, n_log, n_log - first),
    )
    rec["form"] = list(form)
    rec["ms_back_to_back"] = device_ms(lambda: ntt._fft_flat(x, n_log, inverse, first))
    rec["kernel_ms"] = kernel_ms(lambda: ntt._fft_flat(x, n_log, inverse, first))
    return rec


def phase_main_path_kernels(shapes: dict) -> list:
    """Holds each kernel against its plain version at every shape the
    fibonacci, PLONK and STARK phases launched it at, and times it at the
    largest. Returns the kernel records (without the launch counts)."""
    from plonky2_tpu_torch.ops import gf, poseidon as dp, poseidon_cuda

    device = torch.device("cuda")
    rng = np.random.default_rng(2027)
    permute_batches = sorted(shapes["permute"])
    compress_batches = sorted(shapes["compress"])
    sponge_shapes = sorted(shapes["sponge"])
    mul_shapes = sorted(shapes["mul"], key=repr)
    col_shapes = sorted(shapes["col_fft"])
    row_shapes = sorted(shapes["row_fft"])
    errs = {
        "permute": check_permute(rng, device, permute_batches),
        "compress": check_compress(rng, device, compress_batches),
        "sponge": check_sponge(rng, device, sponge_shapes),
        "mul": replay_mul(rng, device, mul_shapes),
        "col_fft": check_col_fft(rng, device, col_shapes),
        "row_fft": check_row_fft(rng, device, row_shapes),
    }
    say({
        "phase": "main_path_kernels",
        "check": "bit-exact against the plain PyTorch versions on the card, "
                 "at every shape the fibonacci, PLONK and STARK phases launched",
        "permute_batches": permute_batches,
        "compress_batches": compress_batches,
        "sponge_shapes": sponge_shapes,
        "mul_forms": len(mul_shapes),
        "col_fft_forms": col_shapes,
        "row_fft_forms": row_shapes,
        "max_abs_err": errs,
    })
    require_exact(errs)

    records = []
    # permute at its largest launch on the main paths (the PoW grind's batch)
    b = permute_batches[-1]
    x = random_field(rng, (b, 12), device)
    ms = time_ms(lambda: poseidon_cuda.permute(x), runs=20, warmup=3)
    plain_ms = time_ms(lambda: dp.permute_plain(x), runs=3)
    records.append(kernel_record(
        "poseidon_permute", POSEIDON_SOURCE, "plonky2_tpu/ops/poseidon_pallas.py:171",
        [b, 12], errs["permute"], ms, plain_ms, poseidon_bound(b, 2 * b * 12),
    ))
    del x
    # ... and at the device transcript's duplex, one state a launch
    if 1 not in permute_batches:
        raise SystemExit("the device transcript's [1, 12] duplex was never launched")
    x = random_field(rng, (1, 12), device)
    one = kernel_record(
        "poseidon_permute", POSEIDON_SOURCE, "plonky2_tpu/ops/poseidon_pallas.py:171",
        [1, 12], errs["permute"],
        time_ms(lambda: poseidon_cuda.permute(x), runs=50, warmup=5),
        time_ms(lambda: dp.permute_plain(x), runs=10, warmup=2), poseidon_bound(1, 24),
    )
    one["ms_back_to_back"] = device_ms(lambda: poseidon_cuda.permute(x), reps=200)
    one["kernel_ms"] = kernel_ms(lambda: poseidon_cuda.permute(x))
    records[-1]["more_shapes"] = [one]

    # the two-to-one form at the widest Merkle level of the main paths
    b = compress_batches[-1]
    x = random_field(rng, (b, 8), device)
    level = x.view(2 * b, 4)
    ms = time_ms(lambda: poseidon_cuda.compress(x), runs=20, warmup=3)
    plain_ms = time_ms(lambda: dp.compress_pairs_plain(level), runs=3)
    records.append(kernel_record(
        "poseidon_compress", POSEIDON_SOURCE, "plonky2_tpu/ops/poseidon_pallas.py:171",
        [b, 8], errs["compress"], ms, plain_ms, poseidon_bound(b, b * 12),
    ))
    del x, level

    # sponge at the largest leaf matrix of the main paths
    b, w, cap = max(sponge_shapes, key=lambda s: s[0] * s[1])
    x = random_field(rng, (b, w), device)
    ms = time_ms(lambda: poseidon_cuda.sponge(x, cap), runs=10, warmup=2)
    plain_ms = time_ms(lambda: dp.sponge_plain(x, cap), runs=2)
    records.append(kernel_record(
        "poseidon_sponge", POSEIDON_SOURCE, "plonky2_tpu/ops/poseidon_pallas.py:213",
        [b, w], errs["sponge"], ms, plain_ms, poseidon_bound(b * -(-w // 8), b * (w + 4)),
    ))
    del x

    # the field product at its largest launch form
    form = max(mul_shapes, key=lambda f: int(np.prod(f[0], dtype=np.int64)))
    sizes, sa, sb = form
    a, bb = mul_operands(rng, device, form)
    n = int(np.prod(sizes, dtype=np.int64))
    ms = time_ms(lambda: gf.mul(a, bb), runs=20, warmup=3)
    plain_ms = time_ms(lambda: gf.mul_plain(a, bb), runs=5)
    words = n + distinct_words(sizes, sa) + (0 if sb is None else distinct_words(sizes, sb))
    records.append(kernel_record(
        "gl_mul", FIELD_SOURCE, "plonky2_tpu/ops/pallas_kernels.py:84",
        {"sizes": list(sizes), "a_strides": list(sa), "b_strides": sb and list(sb)},
        errs["mul"], ms, plain_ms, bound_record(words, n * OPS_PER_FIELD_PRODUCT),
    ))
    del a, bb

    # the column FFT at its largest launch (the PLONK path's), and at the
    # STARK path's two largest
    records.append(time_col_fft(rng, device, max(col_shapes, key=lambda f: f[0] * f[2] << f[1]),
                                errs["col_fft"]))
    records[-1]["more_shapes"] = [time_col_fft(rng, device, f, errs["col_fft"])
                                  for f in COL_FFT_TIMED_STARK]
    for r in records[-1]["more_shapes"]:
        r["launched_on_main_path"] = tuple(r["form"]) in shapes["col_fft"]

    # the row FFT at its largest launch (the degree-2^12 path's), and at
    # the FRI fold's form
    records.append(time_row_fft(rng, device, max(row_shapes, key=lambda f: f[0] << f[1]),
                                errs["row_fft"]))
    records[-1]["more_shapes"] = [time_row_fft(rng, device, f, errs["row_fft"])
                                  for f in ROW_FFT_TIMED_FOLD]
    for r in records[-1]["more_shapes"]:
        r["launched_on_main_path"] = tuple(r["form"]) in shapes["row_fft"]
    torch.cuda.empty_cache()
    say({"phase": "main_path_kernels", "timings": records})
    return records


# ---------------------------------------------------------------------------
# Both transcripts of one witness, and their synchronising operations
# ---------------------------------------------------------------------------


def count_syncs(fn):
    """fn() under CUDA's sync debug mode ("warn"): (its result, the number
    of synchronising CUDA operations it made, {python call site: count})."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    sites = {}
    for w in syncs:
        site = f"{os.path.relpath(w.filename)}:{w.lineno}"
        sites[site] = sites.get(site, 0) + 1
    return out, len(syncs), sites


def timed_proof(prove_with, device_transcript: bool):
    """One proof by the given transcript: (proof, {prove seconds, its
    synchronising operations and their call sites, permutation launches})."""
    before = read_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pwp, syncs, sites = count_syncs(lambda: prove_with(device_transcript))
    torch.cuda.synchronize()
    after = read_counts()
    return pwp, {
        "prove_s": time.perf_counter() - t0,
        "syncs": syncs,
        "sync_sites": sites,
        "permute_launches": after["permute"] - before["permute"],
        "kernel_launches": {k: after[k] - before[k] for k in after},
    }


def both_transcripts(prove_with, common, first_device_proof) -> tuple:
    """After a first device-transcript proof: a second one, and two
    host-transcript proofs of the same witness. All four must give the same
    bytes, and the second device proof at most the PoW grind's chunks plus
    one synchronising operations (one found flag a chunk, one transfer).
    Returns the record."""
    from plonky2_tpu_torch.ops import fri_kernels as fk
    from plonky2_tpu_torch.utils import serialization as ser

    device2, dev_rec = timed_proof(prove_with, True)
    host1, host_first = timed_proof(prove_with, False)
    host2, host_second = timed_proof(prove_with, False)
    want = ser.proof_to_bytes(first_device_proof, common)
    equal = all(ser.proof_to_bytes(p, common) == want for p in (device2, host1, host2))
    bits = common.config.fri_config.proof_of_work_bits
    chunks = first_device_proof.proof.opening_proof.pow_witness // fk._pow_chunk_size(bits) + 1
    record = {
        "device_transcript_second_call": dev_rec,
        "host_transcript_first_call": host_first,
        "host_transcript_second_call": host_second,
        "pow_chunks": chunks,
        "device_sync_bound": chunks + 1,
        "device_transcript_duplexes": dev_rec["permute_launches"] - chunks,
        "bytes_equal_across_transcripts": equal,
    }
    if not equal:
        raise SystemExit("the device- and host-transcript proofs differ")
    if dev_rec["syncs"] > chunks + 1:
        raise SystemExit(
            f"the device-transcript proof synchronised {dev_rec['syncs']} times "
            f"(bound {chunks + 1}): {dev_rec['sync_sites']}"
        )
    return record


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
    from plonky2_tpu_torch.plonk.prover import prove
    from plonky2_tpu_torch.plonk.verifier import verify
    from plonky2_tpu_torch.utils import serialization as ser

    reset_counts()
    t0 = time.perf_counter()
    data, pw = build_fibonacci(public_io=True)
    t1 = time.perf_counter()
    pwp = prove(data.prover_only, data.common, pw)  # the device transcript
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    verify(pwp, data.verifier_only, data.common)
    t3 = time.perf_counter()
    assert pwp.public_inputs[2] == fib_value()
    with open(os.path.join(golden_dir, "fibonacci_proof.bin"), "rb") as f:
        proof_equal = ser.proof_to_bytes(pwp, data.common) == f.read()
    with open(os.path.join(golden_dir, "fibonacci_common.bin"), "rb") as f:
        common_equal = ser.common_data_to_bytes(data.common) == f.read()
    if not (proof_equal and common_equal):
        raise SystemExit("fibonacci bytes differ from tests/golden")
    transcripts = both_transcripts(
        lambda dt: prove(data.prover_only, data.common, pw, device_transcript=dt),
        data.common, pwp,
    )
    shapes = read_shapes()
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
        "transcripts": transcripts,
        "tamper_rejected_with": rejected,
    })
    return shapes


# ---------------------------------------------------------------------------
# Phase 4: the main path at full width
# ---------------------------------------------------------------------------


def noop_circuit(config, log2_gates: int, gc=None):
    """2^(log2_gates - 1) + 1 NoopGates under ``config``, built under the
    hasher bundle ``gc`` (Poseidon if None): degree 2^log2_gates (the JAX
    package's models/bench_recursion.py dummy_proof circuit)."""
    from plonky2_tpu_torch.gates.basic import NoopGate
    from plonky2_tpu_torch.plonk.circuit_builder import CircuitBuilder

    builder = CircuitBuilder(config)
    for _ in range((1 << (log2_gates - 1)) + 1):
        builder.add_gate(NoopGate(), [])
    return builder.build(gc=gc)


def phase_full_width(log2_gates: int):
    from plonky2_tpu_torch.iop.witness import PartialWitness
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    from plonky2_tpu_torch.plonk.prover import prove
    from plonky2_tpu_torch.plonk.verifier import verify

    config = CircuitConfig.standard_recursion_config()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # counts of the PLONK path start here

    t0 = time.perf_counter()
    data = noop_circuit(config, log2_gates)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pwp = prove(data.prover_only, data.common, PartialWitness())
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    verify(pwp, data.verifier_only, data.common)
    t3 = time.perf_counter()
    launches = read_counts()  # ... and end here
    shapes = read_shapes()

    assert data.common.degree_bits == log2_gates, data.common.degree_bits
    for name, n in launches.items():
        if n == 0:
            raise SystemExit(f"kernel {name} was never launched by the PLONK path")

    # a second device-transcript proof (steady-state time) and the host
    # transcript's: the same bytes, so the pinned digest holds for all
    from plonky2_tpu_torch.utils import serialization as ser

    transcripts = both_transcripts(
        lambda dt: prove(data.prover_only, data.common, PartialWitness(), device_transcript=dt),
        data.common, pwp,
    )
    proof_bytes = ser.proof_to_bytes(pwp, data.common)
    digest = hashlib.sha256(proof_bytes).hexdigest()
    if digest != PLONK_PROOF_SHA256:
        raise SystemExit(f"degree-2^16 proof digest {digest} != pinned {PLONK_PROOF_SHA256}")
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
        "prove_second_s": transcripts["device_transcript_second_call"]["prove_s"],
        "verify_s": t3 - t2,
        "proof_bytes": len(proof_bytes),
        "proof_sha256": digest,
        "proof_sha256_equal_pinned": digest == PLONK_PROOF_SHA256,
        "transcripts": transcripts,
        "launches_build_prove_verify": launches,
        "launch_shapes": {k: sorted(v) for k, v in shapes.items() if k != "mul"},
        "mul_launch_forms": len(shapes["mul"]),
        "tamper_rejected_with": [rejected_opening, rejected_pow],
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    })
    return launches, shapes


# ---------------------------------------------------------------------------
# Phase 5: the degree-2^12 inner proof against the pinned bytes
# ---------------------------------------------------------------------------


def golden_parts(path: str) -> list:
    """The length-prefixed parts of a golden file
    (utils/serialization.parts_from_bytes): for bench_inner_2^12.bin the
    common data, the verifier data and the proof."""
    from plonky2_tpu_torch.utils import serialization as ser

    with open(path, "rb") as f:
        return ser.parts_from_bytes(f.read())


def phase_plonk_inner(log2_gates: int, golden_dir: str):
    """The degree-2^log2_gates circuit of phase 4: build, prove, verify (the
    path's launch counts), a second prove (equal bytes), the bytes against
    tests/golden/bench_inner_2^log2_gates.bin, a tampered proof rejected.
    Every transform of this path is under 2^16 points, so it runs on the
    row FFT alone: the column FFT is not required to launch."""
    from plonky2_tpu_torch.iop.witness import PartialWitness
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    from plonky2_tpu_torch.plonk.prover import prove
    from plonky2_tpu_torch.plonk.verifier import verify
    from plonky2_tpu_torch.utils import serialization as ser

    config = CircuitConfig.standard_recursion_config()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # counts of the degree-2^12 path start here
    t0 = time.perf_counter()
    data = noop_circuit(config, log2_gates)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pwp = prove(data.prover_only, data.common, PartialWitness())
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    verify(pwp, data.verifier_only, data.common)
    t3 = time.perf_counter()
    launches = read_counts()  # ... and end here
    shapes = read_shapes()
    assert data.common.degree_bits == log2_gates, data.common.degree_bits
    for name, n in launches.items():
        if n == 0 and name != "col_fft":
            raise SystemExit(f"kernel {name} was never launched by the degree-2^{log2_gates} path")

    # a second device-transcript proof and the host transcript's: the same
    # bytes (both_transcripts fails otherwise), so the golden proof holds
    # for all
    transcripts = both_transcripts(
        lambda dt: prove(data.prover_only, data.common, PartialWitness(), device_transcript=dt),
        data.common, pwp,
    )
    proof_bytes = ser.proof_to_bytes(pwp, data.common)
    golden = golden_parts(os.path.join(golden_dir, f"bench_inner_2^{log2_gates}.bin"))
    equal = {
        "common_data": ser.common_data_to_bytes(data.common) == golden[0],
        "verifier_data": ser.verifier_data_to_bytes(data.verifier_only, data.common) == golden[1],
        "proof": proof_bytes == golden[2],
    }
    bad = copy.deepcopy(pwp)
    c0, c1 = bad.proof.openings.wires[0]
    bad.proof.openings.wires[0] = ((c0 + 1) % P, c1)
    rejected = expect_rejected(verify, bad, data, "a proof with a changed opening")
    say({
        "phase": f"plonk_inner_2^{log2_gates}",
        "config": "standard_recursion_config",
        "degree_bits": data.common.degree_bits,
        "build_s": t1 - t0,
        "prove_first_s": t2 - t1,
        "prove_second_s": transcripts["device_transcript_second_call"]["prove_s"],
        "verify_s": t3 - t2,
        "proof_bytes": len(proof_bytes),
        "bytes_equal_golden": equal,
        "transcripts": transcripts,
        "launches_build_prove_verify": launches,
        "col_fft_note": "no four-step transform on this path (every transform is under "
                        "2^16 points): the column FFT is not required",
        "launch_shapes": {k: sorted(v) for k, v in shapes.items() if k != "mul"},
        "mul_launch_forms": len(shapes["mul"]),
        "tamper_rejected_with": rejected,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    })
    if not all(equal.values()):
        raise SystemExit(f"degree-2^12 bytes differ from tests/golden: {equal}")
    return launches, shapes


# ---------------------------------------------------------------------------
# The rest of the PLONK circuit surface: the examples, the gate mix (every
# gate, lookups) at full width, zero knowledge
# ---------------------------------------------------------------------------


def require_native_engines(data=None) -> dict:
    """The native host engines must have built (the card's machine has a
    C compiler, so a fall-back to Python is a failure here), and a
    circuit's witness must have left no generator to Python."""
    from plonky2_tpu_torch import native
    from plonky2_tpu_torch.iop import witgen_native

    if not (native.available() and witgen_native.available()):
        raise SystemExit("the native host engines (native/host_hash.c, native/witgen.c) did not build")
    if data is None:
        return {}
    stats = dict(data.prover_only._witgen_enc.stats)
    if stats["python_gens"] != 0:
        raise SystemExit(f"witness generators left to Python: {stats['fallback_types']}")
    return stats


def prove_both_to(data, pw, want: bytes, what: str) -> dict:
    """Proves by both transcripts; each proof must serialize to ``want``
    and verify. Returns seconds by transcript."""
    from plonky2_tpu_torch.plonk.prover import prove
    from plonky2_tpu_torch.plonk.verifier import verify
    from plonky2_tpu_torch.utils import serialization as ser

    out = {}
    for dt in (True, False):
        t0 = time.perf_counter()
        pwp = prove(data.prover_only, data.common, pw, device_transcript=dt)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        verify(pwp, data.verifier_only, data.common)
        name = "device" if dt else "host"
        out[f"{name}_prove_s"] = t1 - t0
        out[f"{name}_verify_s"] = time.perf_counter() - t1
        if ser.proof_to_bytes(pwp, data.common) != want:
            raise SystemExit(f"{what}: the {name}-transcript proof differs from the pinned bytes")
    return out


def phase_examples(golden_dir: str) -> dict:
    """range_check and square_root against their pinned bytes on both
    transcripts, factorial(100), fibonacci_serialization, a tampered proof
    of each rejected. Returns the distinct kernel shapes the phase
    launched."""
    import tempfile

    from plonky2_tpu_torch.field import goldilocks as gl
    from plonky2_tpu_torch.models import examples as ex
    from plonky2_tpu_torch.plonk.prover import prove
    from plonky2_tpu_torch.plonk.verifier import verify
    from plonky2_tpu_torch.utils import serialization as ser

    require_native_engines()
    reset_counts()
    record = {"phase": "examples"}
    for name, build in (("range_check", ex.build_range_check),
                        ("square_root", lambda: ex.build_square_root()[:2])):
        t0 = time.perf_counter()
        data, pw = build()
        build_s = time.perf_counter() - t0
        with open(os.path.join(golden_dir, f"{name}_proof.bin"), "rb") as f:
            want = f.read()
        with open(os.path.join(golden_dir, f"{name}_common.bin"), "rb") as f:
            if ser.common_data_to_bytes(data.common) != f.read():
                raise SystemExit(f"{name}: common data differs from tests/golden")
        times = prove_both_to(data, pw, want, name)
        bad = ser.proof_from_bytes(want, data.common)
        bad.public_inputs[0] = (bad.public_inputs[0] + 1) % P
        record[name] = {
            "degree_bits": data.common.degree_bits,
            "build_s": build_s,
            **times,
            "proof_and_common_bytes_equal_golden": True,
            "witgen": dict(data.prover_only._witgen_enc.stats),
            "tamper_rejected_with": expect_rejected(verify, bad, data, f"a tampered {name} proof"),
        }
    t0 = time.perf_counter()
    data, pw = ex.build_factorial(100)
    t1 = time.perf_counter()
    pwp = prove(data.prover_only, data.common, pw)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    verify(pwp, data.verifier_only, data.common)
    t3 = time.perf_counter()
    want = 1
    for i in range(2, 101):
        want = gl.gmul(want, i)
    if pwp.public_inputs != [1, want]:
        raise SystemExit(f"factorial: public inputs {pwp.public_inputs}")
    bad = copy.deepcopy(pwp)
    bad.public_inputs[1] ^= 1
    record["factorial_100"] = {
        "degree_bits": data.common.degree_bits,
        "build_s": t1 - t0, "prove_s": t2 - t1, "verify_s": t3 - t2,
        "witgen": require_native_engines(data),
        "tamper_rejected_with": expect_rejected(verify, bad, data, "a tampered factorial proof"),
    }
    with tempfile.TemporaryDirectory() as tmp:
        paths = ex.fibonacci_serialization(tmp)
        record["fibonacci_serialization_bytes"] = {k: os.path.getsize(v) for k, v in paths.items()}
    say(record)
    return read_shapes()


def phase_gate_mix(log2: int, pinned_sha256):
    """The gate-mix circuit (every gate but the Poseidon2 family, four
    lookups a block, models/gate_mix.py) at degree 2^log2 under the
    unchanged standard_recursion_config: build, witness, prove (device
    transcript), verify — the path's launch counts —, a second proof and
    two host-transcript proofs (equal bytes), the proof's SHA-256 against
    the digest pinned from the JAX package when there is one, verify again
    with the pure-Python Poseidon, tampered proofs rejected."""
    from plonky2_tpu_torch.iop.generator import generate_partial_witness
    from plonky2_tpu_torch.models.gate_mix import build_gate_mix, gate_counts
    from plonky2_tpu_torch.plonk.prover import prove
    from plonky2_tpu_torch.plonk.verifier import verify
    from plonky2_tpu_torch.utils import serialization as ser

    require_native_engines()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # counts of the gate-mix path start here
    t0 = time.perf_counter()
    data, pw = build_gate_mix(log2)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pwp = prove(data.prover_only, data.common, pw)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    verify(pwp, data.verifier_only, data.common)
    t3 = time.perf_counter()
    launches = read_counts()  # ... and end here
    shapes = read_shapes()
    for name, n in launches.items():
        if n == 0:
            raise SystemExit(f"kernel {name} was never launched by the gate-mix path (2^{log2})")
    witgen = require_native_engines(data)

    t = time.perf_counter()
    witness = generate_partial_witness(pw, data.prover_only, data.common)
    witness.full_witness()
    witness_s = time.perf_counter() - t
    transcripts = both_transcripts(
        lambda dt: prove(data.prover_only, data.common, pw, device_transcript=dt),
        data.common, pwp,
    )
    proof_bytes = ser.proof_to_bytes(pwp, data.common)
    digest = hashlib.sha256(proof_bytes).hexdigest()
    if pinned_sha256 is not None and digest != pinned_sha256:
        raise SystemExit(f"gate-mix 2^{log2} proof digest {digest} != pinned {pinned_sha256}")
    os.environ["PLONKY2_TPU_NATIVE"] = "0"
    try:
        t = time.perf_counter()
        verify(ser.proof_from_bytes(proof_bytes, data.common), data.verifier_only, data.common)
        verify_python_s = time.perf_counter() - t
    finally:
        del os.environ["PLONKY2_TPU_NATIVE"]
    bad = copy.deepcopy(pwp)
    c0, c1 = bad.proof.openings.wires[0]
    bad.proof.openings.wires[0] = ((c0 + 1) % P, c1)
    rejected_opening = expect_rejected(verify, bad, data, "a gate-mix proof with a changed opening")
    bad = copy.deepcopy(pwp)
    bad.public_inputs[0] = (bad.public_inputs[0] + 1) % P
    rejected_pi = expect_rejected(verify, bad, data, "a gate-mix proof with a changed public input")
    bad = copy.deepcopy(pwp)
    z0, z1 = bad.proof.openings.lookup_zs[0]
    bad.proof.openings.lookup_zs[0] = ((z0 + 1) % P, z1)
    rejected_lookup = expect_rejected(verify, bad, data, "a gate-mix proof with a changed lookup opening")
    say({
        "phase": f"gate_mix_2^{log2}",
        "config": "standard_recursion_config",
        "degree_bits": data.common.degree_bits,
        "gate_rows": gate_counts(data),
        "num_lookup_polys": data.common.num_lookup_polys,
        "build_s": t1 - t0,
        "witness_s": witness_s,
        "prove_first_s": t2 - t1,
        "prove_second_s": transcripts["device_transcript_second_call"]["prove_s"],
        "verify_s": t3 - t2,
        "verify_python_poseidon_s": verify_python_s,
        "proof_bytes": len(proof_bytes),
        "proof_sha256": digest,
        "proof_sha256_pinned": pinned_sha256,
        "witgen": witgen,
        "transcripts": transcripts,
        "launches_build_prove_verify": launches,
        "mul_launch_forms": len(shapes["mul"]),
        "sponge_shapes": sorted(shapes["sponge"]),
        "tamper_rejected_with": [rejected_opening, rejected_pi, rejected_lookup],
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    })
    return launches, shapes


def phase_zk(log2: int):
    """The gate mix at degree 2^log2 with zero knowledge (models/gate_mix
    zk_config): with PLONKY2_TPU_SALT_SEED fixed and the blinding rows fed
    from iop.generator.fixed_random_values, the card's proof by both
    transcripts equals the port's own CPU proof byte for byte; without
    them two proofs of the same witness differ in every cap and both
    verify; a tampered proof is rejected."""
    from plonky2_tpu_torch.iop.generator import fixed_random_values
    from plonky2_tpu_torch.models.gate_mix import build_gate_mix
    from plonky2_tpu_torch.plonk.prover import prove
    from plonky2_tpu_torch.plonk.verifier import verify
    from plonky2_tpu_torch.utils import serialization as ser

    torch.cuda.empty_cache()
    reset_counts()
    os.environ["PLONKY2_TPU_SALT_SEED"] = str(ZK_SALT_SEED)
    try:
        with fixed_random_values(ZK_BLINDING_SEED):
            t0 = time.perf_counter()
            data, pw = build_gate_mix(log2, zero_knowledge=True)
            t1 = time.perf_counter()
            pwp = prove(data.prover_only, data.common, pw)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            verify(pwp, data.verifier_only, data.common)
            want = ser.proof_to_bytes(pwp, data.common)
            times = prove_both_to(data, pw, want, f"zk 2^{log2}")
            launches = read_counts()
            shapes = read_shapes()
            for name, n in launches.items():
                # transforms of 2^15 points: the flat NTT, no column FFT
                if n == 0 and name != "col_fft":
                    raise SystemExit(f"kernel {name} was never launched by the zk path")
            t3 = time.perf_counter()
            cpu_data, cpu_pw = build_gate_mix(log2, zero_knowledge=True, device="cpu")
            cpu_pwp = prove(cpu_data.prover_only, cpu_data.common, cpu_pw, device="cpu")
            cpu_s = time.perf_counter() - t3
    finally:
        del os.environ["PLONKY2_TPU_SALT_SEED"]
    cpu_equal = ser.proof_to_bytes(cpu_pwp, cpu_data.common) == want
    if not cpu_equal:
        raise SystemExit(f"zk 2^{log2}: the card's proof differs from the CPU's under fixed streams")
    p1 = prove(data.prover_only, data.common, pw)
    p2 = prove(data.prover_only, data.common, pw)
    verify(p1, data.verifier_only, data.common)
    verify(p2, data.verifier_only, data.common)
    caps = ("wires_cap", "plonk_zs_partial_products_cap", "quotient_polys_cap")
    differ = {c: not np.array_equal(getattr(p1.proof, c), getattr(p2.proof, c)) for c in caps}
    if not all(differ.values()):
        raise SystemExit(f"zk 2^{log2}: two proofs share a cap: {differ}")
    bad = copy.deepcopy(p1)
    c0, c1 = bad.proof.openings.wires[0]
    bad.proof.openings.wires[0] = ((c0 + 1) % P, c1)
    say({
        "phase": f"zk_2^{log2}",
        "config": "gate_mix.zk_config (8 queries, 1 PoW bit, cap height 2, rate 1/8)",
        "degree_bits": data.common.degree_bits,
        "leaf_hiding": data.common.fri_params.leaf_hiding,
        "build_s": t1 - t0,
        "prove_first_s": t2 - t1,
        **times,
        "cpu_build_and_prove_s": cpu_s,
        "card_equals_cpu_under_fixed_streams": cpu_equal,
        "unseeded_caps_differ": differ,
        "launches_build_prove_verify": launches,
        "tamper_rejected_with": expect_rejected(verify, bad, data, "a tampered zk proof"),
    })
    return launches, shapes


# ---------------------------------------------------------------------------
# Recursion: the benchmark's outer proof over the degree-2^12 inner golden,
# a second shrink, compression, conditional and cyclic recursion
# ---------------------------------------------------------------------------


def profiled_launches(fn) -> dict:
    """Kernels the card ran during fn() as torch.profiler (CUPTI) records
    them: launches and device-busy milliseconds (the prover's annotate
    spans left out: utils/profiling.kernel_rows)."""
    from torch.profiler import ProfilerActivity, profile

    from plonky2_tpu_torch.utils.profiling import kernel_rows

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launches, busy_us = 0, 0.0
    for e in kernel_rows(prof):
        own = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
        if own > 0:
            launches += e.count
            busy_us += own
    return {"kernels_launched": launches, "device_busy_ms": busy_us / 1e3}


def outer_witness_fails(data, pw) -> str:
    """The outer witness over a tampered inner proof: generating it or
    checking it (plonk/witness_check.py) must raise."""
    from plonky2_tpu_torch.hash import poseidon as hp
    from plonky2_tpu_torch.iop.generator import generate_partial_witness
    from plonky2_tpu_torch.plonk.witness_check import check_witness

    try:
        w = generate_partial_witness(pw, data.prover_only, data.common)
        check_witness(data, w.full_witness(), hp.hash_no_pad([]))
    except Exception as e:  # the failure is the expected outcome
        return type(e).__name__
    raise SystemExit("BUG: the outer witness over a tampered inner proof passed check_witness")


def python_generator_types(data) -> dict:
    """Generators a circuit's witness left to Python, by type."""
    enc = data.prover_only._witgen_enc
    out: dict = {}
    for gi in enc.python_gens:
        name = type(data.prover_only.generators[gi]).__name__
        out[name] = out.get(name, 0) + 1
    return out


def phase_recursion(golden_dir: str):
    """The JAX package's recursion benchmark (models/bench_recursion.py) at
    full width under the unchanged standard_recursion_config. Shrink 1:
    the outer circuit over the degree-2^12 inner proof of
    tests/golden/bench_inner_2^12.bin (loaded and verified): build, witness,
    prove, verify — the path's launch counts —, a second proof and two
    host-transcript proofs (equal bytes, the sync bound), its common data,
    verifier data and proof equal to tests/golden/torch_recursion_outer_2^12.bin,
    a tampered inner proof failing the witness, a tampered outer proof
    rejected, one proof under torch.profiler. Shrink 2 over shrink 1 on both
    transcripts. Compression of both (round trips, verify_compressed_proof;
    shrink 1's compressed bytes equal their pin). Conditional recursion
    over shrink 1's circuit with condition 1 and 0, and the dummy proof
    verified. The three-step cyclic hash chain (models/hash_chain.py)."""
    from plonky2_tpu_torch.hash import poseidon as hp
    from plonky2_tpu_torch.iop.generator import generate_partial_witness
    from plonky2_tpu_torch.iop.witness import PartialWitness
    from plonky2_tpu_torch.models import bench_recursion as br
    from plonky2_tpu_torch.models.hash_chain import hash_chain_circuit, prove_step
    from plonky2_tpu_torch.plonk.circuit_builder import CircuitBuilder
    from plonky2_tpu_torch.plonk.compressed_proof import compress_proof, verify_compressed_proof
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    from plonky2_tpu_torch.plonk.proof_target import add_virtual_proof_with_pis, set_proof_with_pis_target
    from plonky2_tpu_torch.plonk.prover import prove
    from plonky2_tpu_torch.plonk.recursive_verifier import add_virtual_verifier_data, set_verifier_data_target
    from plonky2_tpu_torch.plonk.verifier import verify
    from plonky2_tpu_torch.recursion.conditional import (
        DummyProofGenerator,
        conditionally_verify_proof_or_dummy,
    )
    from plonky2_tpu_torch.recursion.cyclic_recursion import common_data_for_recursion, verify_cyclic
    from plonky2_tpu_torch.recursion.dummy_circuit import common_shape_eq
    from plonky2_tpu_torch.utils import serialization as ser

    require_native_engines()
    config = CircuitConfig.standard_recursion_config()
    with open(os.path.join(golden_dir, f"bench_inner_2^{INNER_LOG2_GATES}.bin"), "rb") as f:
        inner = ser.proof_tuple_from_bytes(f.read())
    _, inner_vd, inner_common = inner
    verify(*inner)

    # shrink 1: the benchmark's outer proof
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # counts of the recursion path start here
    t0 = time.perf_counter()
    data, pt, vd_t = br.recursive_circuit(inner_common, config)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pw = br.recursive_witness(pt, vd_t, inner)
    pwp = prove(data.prover_only, data.common, pw)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    verify(pwp, data.verifier_only, data.common)
    t3 = time.perf_counter()
    launches = read_counts()  # ... and end here
    shapes = read_shapes()
    if data.common.degree_bits != 13:
        raise SystemExit(f"shrink 1 came out at degree 2^{data.common.degree_bits}, not 2^13")
    for name, n in launches.items():
        if n == 0:
            raise SystemExit(f"kernel {name} was never launched by the recursion path")
    witgen = require_native_engines(data)
    t = time.perf_counter()
    generate_partial_witness(pw, data.prover_only, data.common).full_witness()
    witness_s = time.perf_counter() - t
    transcripts = both_transcripts(
        lambda dt: prove(data.prover_only, data.common, pw, device_transcript=dt),
        data.common, pwp,
    )
    profiled = profiled_launches(lambda: prove(data.prover_only, data.common, pw))
    proof_bytes = ser.proof_to_bytes(pwp, data.common)
    golden = golden_parts(os.path.join(golden_dir, f"torch_recursion_outer_2^{INNER_LOG2_GATES}.bin"))
    equal = {
        "common_data": ser.common_data_to_bytes(data.common) == golden[0],
        "verifier_data": ser.verifier_data_to_bytes(data.verifier_only, data.common) == golden[1],
        "proof": proof_bytes == golden[2],
    }
    if not all(equal.values()):
        raise SystemExit(f"shrink 1 bytes differ from tests/golden: {equal}")
    bad_inner = copy.deepcopy(inner[0])
    c0, c1 = bad_inner.proof.openings.wires[0]
    bad_inner.proof.openings.wires[0] = ((c0 + 1) % P, c1)
    inner_rejected = outer_witness_fails(
        data, br.recursive_witness(pt, vd_t, (bad_inner, inner_vd, inner_common))
    )
    bad = copy.deepcopy(pwp)
    c0, c1 = bad.proof.openings.wires[0]
    bad.proof.openings.wires[0] = ((c0 + 1) % P, c1)
    outer_rejected = expect_rejected(verify, bad, data, "a tampered shrink-1 proof")
    shrink1 = {
        "degree_bits": data.common.degree_bits,
        "gate_rows": br.circuit_shape(data)["gate_rows"],
        "build_s": t1 - t0,
        "witness_s": witness_s,
        "prove_first_s": t2 - t1,
        "prove_second_s": transcripts["device_transcript_second_call"]["prove_s"],
        "verify_s": t3 - t2,
        "witgen": witgen,
        "transcripts": transcripts,
        "launches_build_prove_verify": launches,
        "launches_one_proof": transcripts["device_transcript_second_call"]["kernel_launches"],
        "profiler_one_proof": profiled,
        "mul_launch_forms": len(shapes["mul"]),
        "launch_shapes": {k: sorted(v) for k, v in shapes.items() if k != "mul"},
        "bytes_equal_golden": equal,
        "tampered_inner_witness_failed_with": inner_rejected,
        "tampered_outer_rejected_with": outer_rejected,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    }
    del bad, bad_inner

    # shrink 2: the outer circuit over shrink 1's proof
    t0 = time.perf_counter()
    data2, pt2, vd_t2 = br.recursive_circuit(data.common, config)
    pw2 = br.recursive_witness(pt2, vd_t2, (pwp, data.verifier_only, data.common))
    t1 = time.perf_counter()
    pwp2 = prove(data2.prover_only, data2.common, pw2)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    verify(pwp2, data2.verifier_only, data2.common)
    t3 = time.perf_counter()
    times2 = prove_both_to(data2, pw2, ser.proof_to_bytes(pwp2, data2.common), "shrink 2")
    shrink2 = {
        "degree_bits": data2.common.degree_bits,
        "build_s": t1 - t0, "prove_first_s": t2 - t1, "verify_s": t3 - t2, **times2,
        "python_gens": require_native_engines(data2)["python_gens"],
    }

    # compression (bench_recursion.test_serialization) of both
    compression = {}
    for name, (p, d) in (("shrink_1", (pwp, data)), ("shrink_2", (pwp2, data2))):
        info = br.test_serialization(p, d.verifier_only, d.common)
        c = compress_proof(p, d.verifier_only, d.common)
        t = time.perf_counter()
        verify_compressed_proof(c, d.verifier_only, d.common)
        info["verify_compressed_s"] = time.perf_counter() - t
        compression[name] = info
        if name == "shrink_1":
            with open(os.path.join(golden_dir, f"torch_recursion_outer_2^{INNER_LOG2_GATES}_compressed.bin"),
                      "rb") as f:
                info["compressed_bytes_equal_golden"] = ser.compressed_proof_to_bytes(c, d.common) == f.read()
            if not info["compressed_bytes_equal_golden"]:
                raise SystemExit("shrink 1's compressed bytes differ from tests/golden")

    # conditional recursion over shrink 1's circuit
    t0 = time.perf_counter()
    b = CircuitBuilder(config)
    cond = b.add_virtual_bool_target_safe()
    pt_c = add_virtual_proof_with_pis(b, data.common)
    vd_c = add_virtual_verifier_data(b, data.common.fri_params.config.cap_height)
    conditionally_verify_proof_or_dummy(b, cond, pt_c, vd_c, data.common)
    cdata = b.build()
    conditional = {"degree_bits": cdata.common.degree_bits, "build_s": time.perf_counter() - t0}
    for c in (1, 0):
        cpw = PartialWitness()
        cpw.set_target(cond.target, c)
        set_proof_with_pis_target(cpw, pt_c, pwp)
        set_verifier_data_target(cpw, vd_c, data.verifier_only)
        t = time.perf_counter()
        cp = prove(cdata.prover_only, cdata.common, cpw)
        torch.cuda.synchronize()
        conditional[f"condition_{c}_prove_s"] = time.perf_counter() - t
        verify(cp, cdata.verifier_only, cdata.common)
    conditional["condition_1_note"] = "the first proof also builds and proves the dummy circuit"
    dummy_gen = next(g for g in cdata.prover_only.generators if isinstance(g, DummyProofGenerator))
    dummy_proof, dummy_vd, dummy_common = dummy_gen.dummy()
    if not common_shape_eq(dummy_common, data.common):
        raise SystemExit("the dummy circuit's common data has another shape than shrink 1's")
    verify(dummy_proof, dummy_vd, data.common)
    conditional["dummy_proof_verified"] = True
    conditional["python_generators"] = python_generator_types(cdata)
    if not set(conditional["python_generators"]) <= {"DummyProofGenerator", "_ZeroGenerator"}:
        raise SystemExit(f"conditional recursion left generators to Python: {conditional['python_generators']}")

    # the three-step cyclic hash chain
    t0 = time.perf_counter()
    hdata, chain = hash_chain_circuit(config, common_data_for_recursion(config))
    cyclic = {
        "degree_bits": hdata.common.degree_bits,
        "build_s": time.perf_counter() - t0,
        "fixpoint_common_shape_eq": common_shape_eq(hdata.common, chain.common_data),
        "prove_s": [],
    }
    if not cyclic["fixpoint_common_shape_eq"]:
        raise SystemExit("the cyclic circuit's common data is not the shape it verifies")
    initial_hash = [0, 1, 2, 3]
    proof = None
    for _ in range(3):
        t = time.perf_counter()
        proof = prove_step(hdata, chain, proof, initial_hash)
        torch.cuda.synchronize()
        cyclic["prove_s"].append(time.perf_counter() - t)
        verify_cyclic(proof, hdata.verifier_only, hdata.common)
    want = initial_hash
    for _ in range(3):
        want = list(hp.hash_no_pad(want))
    cyclic["counter"] = proof.public_inputs[8]
    cyclic["latest_hash_equals_hash_no_pad_3_times"] = proof.public_inputs[4:8] == want
    if proof.public_inputs[8] != 3 or proof.public_inputs[4:8] != want:
        raise SystemExit(f"the cyclic chain's public inputs are wrong: {proof.public_inputs[:9]}")
    cyclic["python_generators"] = python_generator_types(hdata)
    if not set(cyclic["python_generators"]) <= {"DummyProofGenerator", "_ZeroGenerator"}:
        raise SystemExit(f"cyclic recursion left generators to Python: {cyclic['python_generators']}")
    cyclic["base_case_note"] = "the first proof also builds the dummy circuit and proves it twice"

    # every shape the phase launched, shrink 1 and what followed it, for
    # main_path_kernels to replay
    shapes = read_shapes()
    say({
        "phase": "recursion",
        "config": "standard_recursion_config",
        "inner": f"tests/golden/bench_inner_2^{INNER_LOG2_GATES}.bin (degree 2^{inner_common.degree_bits})",
        "shrink_1": shrink1,
        "shrink_2": shrink2,
        "compression": compression,
        "conditional": conditional,
        "cyclic": cyclic,
    })
    return launches, shapes


# ---------------------------------------------------------------------------
# Phases 6 and 7: the STARK path
# ---------------------------------------------------------------------------


def normalize(x):
    """A proof dataclass tree as nested tuples of ints, for exact equality."""
    if dataclasses.is_dataclass(x):
        return tuple(normalize(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, np.ndarray):
        return tuple(int(v) for v in x.reshape(-1))
    if isinstance(x, (list, tuple)):
        return tuple(normalize(v) for v in x)
    return x


def fibonacci_stark(log_rows: int):
    from plonky2_tpu_torch.stark.config import StarkConfig
    from plonky2_tpu_torch.stark.fixtures import FibonacciStark, fibonacci_res

    n = 1 << log_rows
    stark = FibonacciStark(n)
    trace = stark.generate_trace(0, 1)
    return stark, StarkConfig.standard_fast_config(), trace, [0, 1, fibonacci_res(n, 0, 1)]


def phase_stark_small(log_rows: int) -> dict:
    """The same STARK proven on the card and on the CPU (plain versions of
    every kernel) must give the same proof, and so must the card's proof
    with the FRI proof in its unfused form. Returns the launched shapes."""
    import functools

    from plonky2_tpu_torch.fri import prover as fri_prover
    from plonky2_tpu_torch.stark.prover import prove
    from plonky2_tpu_torch.stark.verifier import verify_stark_proof

    stark, config, trace, pis = fibonacci_stark(log_rows)
    reset_counts()
    t0 = time.perf_counter()
    on_card = prove(stark, config, trace, pis)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    on_cpu = prove(stark, config, trace, pis, device="cpu")
    t2 = time.perf_counter()
    # fri/oracle.prove_openings looks fri_proof up at each call
    fused_fri_proof = fri_prover.fri_proof
    fri_prover.fri_proof = functools.partial(fused_fri_proof, fused=False)
    try:
        unfused = prove(stark, config, trace, pis)
        torch.cuda.synchronize()
    finally:
        fri_prover.fri_proof = fused_fri_proof
    t3 = time.perf_counter()
    shapes = read_shapes()
    verify_stark_proof(stark, on_card, config, log_rows)
    equal = normalize(on_card) == normalize(on_cpu)
    fused_equal = normalize(on_card) == normalize(unfused)
    say({
        "phase": "stark_small",
        "rows": 1 << log_rows,
        "prove_card_s": t1 - t0,
        "prove_cpu_s": t2 - t1,
        "prove_card_unfused_fri_s": t3 - t2,
        "proofs_equal_card_cpu": equal,
        "proofs_equal_fused_unfused_fri": fused_equal,
    })
    if not equal:
        raise SystemExit("the STARK proof on the card differs from the one on the CPU")
    if not fused_equal:
        raise SystemExit("the fused and unfused FRI proofs of the STARK differ")
    return shapes


def phase_stark(log_rows: int):
    from plonky2_tpu_torch.stark.prover import prove
    from plonky2_tpu_torch.stark.verifier import StarkVerificationError, verify_stark_proof

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stark, config, trace, pis = fibonacci_stark(log_rows)
    t1 = time.perf_counter()
    reset_counts()  # counts of the STARK path start here
    pwp = prove(stark, config, trace, pis)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    verify_stark_proof(stark, pwp, config, log_rows)
    t3 = time.perf_counter()
    launches = read_counts()  # ... and end here
    shapes = read_shapes()
    for name, n in launches.items():
        if n == 0:
            raise SystemExit(f"kernel {name} was never launched by the STARK path")

    pwp2, second = timed_proof(lambda _: prove(stark, config, trace, pis), False)
    if normalize(pwp2) != normalize(pwp):
        raise SystemExit("STARK proofs differ between runs")

    bad = copy.deepcopy(pwp)
    bad.public_inputs[2] = (bad.public_inputs[2] + 1) % P
    try:
        verify_stark_proof(stark, bad, config, log_rows)
    except StarkVerificationError as e:
        rejected = type(e).__name__
    else:
        raise SystemExit("BUG: a STARK proof with a wrong public result was accepted")

    fri = config.fri_config
    say({
        "phase": "stark",
        "stark": "FibonacciStark",
        "config": "StarkConfig.standard_fast_config",
        "rows": 1 << log_rows,
        "columns": stark.num_columns(),
        "rate_bits": fri.rate_bits,
        "cap_height": fri.cap_height,
        "num_query_rounds": fri.num_query_rounds,
        "proof_of_work_bits": fri.proof_of_work_bits,
        "lde_bits": log_rows + fri.rate_bits,
        "fri_reduction_arity_bits": list(config.fri_params(log_rows).reduction_arity_bits),
        "trace_generation_s": t1 - t0,
        "prove_first_s": t2 - t1,
        "prove_second_s": second["prove_s"],
        "prove_second_call": second,
        "verify_s": t3 - t2,
        "public_result": pwp.public_inputs[2],
        "launches_prove_verify": launches,
        "launch_shapes": {k: sorted(v) for k, v in shapes.items() if k != "mul"},
        "mul_launch_forms": len(shapes["mul"]),
        "tamper_rejected_with": rejected,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    })
    return launches, shapes, (stark, config, pwp)


# ---------------------------------------------------------------------------
# Batch STARK and the PLONK proofs that wrap a STARK
# ---------------------------------------------------------------------------


def batch_tables(log_rows: list):
    """FibonacciStark tables of 2^d rows for each d, their traces and public
    inputs (first row 0, 1; the last row's result)."""
    from plonky2_tpu_torch.stark.fixtures import FibonacciStark, fibonacci_res

    starks = [FibonacciStark(1 << d) for d in log_rows]
    traces = [s.generate_trace(0, 1) for s in starks]
    pis = [[0, 1, fibonacci_res(1 << d, 0, 1)] for d in log_rows]
    return starks, traces, pis


def small_batch_config():
    """tests/test_batch_stark.py:21-32."""
    from plonky2_tpu_torch.fri.config import FriConfig, FriReductionStrategy
    from plonky2_tpu_torch.stark.config import StarkConfig

    return StarkConfig(
        security_bits=1,
        num_challenges=2,
        fri_config=FriConfig(
            rate_bits=1, cap_height=1, proof_of_work_bits=1,
            reduction_strategy=FriReductionStrategy.Fixed([2, 2]), num_query_rounds=8,
        ),
    )


def expect_stark_rejected(verify, what: str) -> str:
    from plonky2_tpu_torch.fri.verifier import FriVerificationError
    from plonky2_tpu_torch.stark.verifier import StarkVerificationError

    try:
        verify()
    except (StarkVerificationError, FriVerificationError) as e:
        return type(e).__name__
    raise SystemExit(f"BUG: {what} was accepted")


def phase_batch_stark(golden_dir: str):
    """The small system of tests/test_batch_stark.py (tables of 2^7 and
    2^5 rows) proven on the card and on the CPU: both proofs equal the JAX
    package's pinned one. Then the batch STARK at its real size: tables of
    2^22, 2^18 and 2^14 rows under StarkConfig.standard_fast_config() in one
    trace batch tree and one quotient batch tree (LDE 2^23 / 2^19 / 2^15),
    one batch FRI proof; two proves (equal; the second under the sync debug
    mode), verify, and the three tampers of tests/test_batch_stark.py
    rejected. Returns (launches, shapes, (starks, config, proof))."""
    from plonky2_tpu_torch.stark.batch_prover import batch_prove, batch_verify
    from plonky2_tpu_torch.stark.config import StarkConfig
    from plonky2_tpu_torch.utils.serialization import int_tree

    starks, traces, pis = batch_tables(BATCH_SMALL_LOG_ROWS)
    config = small_batch_config()
    on_card = batch_prove(starks, config, traces, pis)
    on_cpu = batch_prove(starks, config, traces, pis, device="cpu")
    batch_verify(starks, config, on_card)
    with open(os.path.join(golden_dir, "torch_batch_stark_7_5.json")) as f:
        pinned = json.load(f)["proof"]
    small = {
        "card_equals_cpu": int_tree(on_card) == int_tree(on_cpu),
        "card_equals_jax_package_pin": int_tree(on_card) == pinned,
    }
    if not all(small.values()):
        raise SystemExit(f"the small batch STARK's proofs differ: {small}")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    starks, traces, pis = batch_tables(BATCH_LOG_ROWS)
    t1 = time.perf_counter()
    config = StarkConfig.standard_fast_config()
    reset_counts()  # counts of the batch STARK path start here
    proof = batch_prove(starks, config, traces, pis)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    batch_verify(starks, config, proof)
    t3 = time.perf_counter()
    launches = read_counts()  # ... and end here
    shapes = read_shapes()
    for name, n in launches.items():
        if n == 0:
            raise SystemExit(f"kernel {name} was never launched by the batch STARK path")
    peak = torch.cuda.max_memory_allocated()

    proof2, second = timed_proof(lambda _: batch_prove(starks, config, traces, pis), False)
    if normalize(proof2) != normalize(proof):
        raise SystemExit("batch STARK proofs differ between runs")
    del proof2

    def tampered(edit):
        bad = copy.deepcopy(proof)
        edit(bad)
        return lambda: batch_verify(starks, config, bad)

    def opening(bad):
        c0, c1 = bad.openings[1].local_values[0]
        bad.openings[1].local_values[0] = (c0 ^ 1, c1)

    def public_input(bad):
        bad.public_inputs[0][2] ^= 1

    def query_leaf(bad):
        ep = bad.opening_proof.query_round_proofs[0].initial_trees_proof.evals_proofs
        vals, mp = ep[0]
        ep[0] = ([vals[0] ^ 1] + list(vals[1:]), mp)

    rejected = {
        name: expect_stark_rejected(tampered(edit), f"a batch STARK proof with a tampered {name}")
        for name, edit in (("opening", opening), ("public_input", public_input),
                           ("query_leaf", query_leaf))
    }
    fri = config.fri_config
    say({
        "phase": "batch_stark",
        "small_system": {"log_rows": BATCH_SMALL_LOG_ROWS, **small},
        "stark": "FibonacciStark",
        "config": "StarkConfig.standard_fast_config",
        "log_rows": BATCH_LOG_ROWS,
        "lde_bits": [d + fri.rate_bits for d in BATCH_LOG_ROWS],
        "num_query_rounds": fri.num_query_rounds,
        "proof_of_work_bits": fri.proof_of_work_bits,
        "fri_reduction_arity_bits": list(config.fri_params(BATCH_LOG_ROWS[0]).reduction_arity_bits),
        "trace_generation_s": t1 - t0,
        "prove_first_s": t2 - t1,
        "prove_second_s": second["prove_s"],
        "prove_second_call": second,
        "verify_s": t3 - t2,
        "launches_prove_verify": launches,
        "launch_shapes": {k: sorted(v) for k, v in shapes.items() if k != "mul"},
        "mul_launch_forms": len(shapes["mul"]),
        "tampers_rejected_with": rejected,
        "max_memory_allocated_bytes": peak,
    })
    return launches, shapes, (starks, config, proof)


# ---------------------------------------------------------------------------
# The rest of Starky: logUp lookups, cross-table lookups, zero knowledge
# ---------------------------------------------------------------------------


def pinned_starky(golden_dir: str, name: str) -> dict:
    with open(os.path.join(golden_dir, name)) as f:
        return json.load(f)


def phase_stark_lookup_small(golden_dir: str) -> dict:
    """The PermutationStark of tests/test_stark_lookup.py (2^5 rows) on the
    card and on the CPU: both proofs equal the JAX package's pinned one,
    which the port's verifier accepts. Returns the launched shapes."""
    from plonky2_tpu_torch.stark.config import StarkConfig
    from plonky2_tpu_torch.stark.fixtures import PermutationStark
    from plonky2_tpu_torch.stark.prover import prove
    from plonky2_tpu_torch.stark.verifier import verify_stark_proof
    from plonky2_tpu_torch.utils.serialization import int_tree, stark_proof_from_int_tree

    pin = pinned_starky(golden_dir, f"torch_starky_lookup_2^{STARKY_SMALL_LOG_ROWS}.json")["proof"]
    stark = PermutationStark(1 << STARKY_SMALL_LOG_ROWS)
    config = StarkConfig.standard_fast_config()
    trace = stark.generate_trace(STARKY_X0)
    reset_counts()
    on_card = prove(stark, config, trace, [STARKY_X0])
    torch.cuda.synchronize()
    shapes = read_shapes()
    on_cpu = prove(stark, config, trace, [STARKY_X0], device="cpu")
    verify_stark_proof(stark, stark_proof_from_int_tree(pin), config, STARKY_SMALL_LOG_ROWS)
    verify_stark_proof(stark, on_card, config, STARKY_SMALL_LOG_ROWS)
    out = {
        "card_equals_cpu": int_tree(on_card) == int_tree(on_cpu),
        "card_equals_jax_package_pin": int_tree(on_card) == pin,
        "pin_verified_by_port": True,
    }
    say({"phase": "stark_lookup_small", "rows": 1 << STARKY_SMALL_LOG_ROWS, **out})
    if not all(out.values()):
        raise SystemExit(f"the small lookup STARK's proofs differ: {out}")
    return shapes


def phase_stark_lookup(log_rows: int):
    """PermutationStark at its real size under standard_fast_config: the
    helper and Z columns of the logUp argument built on the card from the
    trace tensor, committed as the auxiliary oracle. Returns (launches,
    shapes, (stark, config, proof))."""
    from plonky2_tpu_torch.stark.config import StarkConfig
    from plonky2_tpu_torch.stark.fixtures import PermutationStark
    from plonky2_tpu_torch.stark.prover import prove
    from plonky2_tpu_torch.stark.verifier import verify_stark_proof

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stark = PermutationStark(1 << log_rows)
    trace = stark.generate_trace(STARKY_X0)
    t1 = time.perf_counter()
    config = StarkConfig.standard_fast_config()
    reset_counts()  # counts of the lookup STARK path start here
    pwp = prove(stark, config, trace, [STARKY_X0])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    verify_stark_proof(stark, pwp, config, log_rows)
    t3 = time.perf_counter()
    launches = read_counts()  # ... and end here
    shapes = read_shapes()
    require_launched(launches, launches, "the lookup STARK path")
    peak = torch.cuda.max_memory_allocated()

    pwp2, second = timed_proof(lambda _: prove(stark, config, trace, [STARKY_X0]), False)
    if normalize(pwp2) != normalize(pwp):
        raise SystemExit("lookup STARK proofs differ between runs")
    del pwp2
    broken = trace.copy()
    broken[1, 4] = (int(broken[1, 4]) + 1) % P  # column 1 no longer a permutation of column 0
    bad = prove(stark, config, broken, [STARKY_X0])
    rejected = expect_stark_rejected(
        lambda: verify_stark_proof(stark, bad, config, log_rows), "a broken permutation"
    )
    fri = config.fri_config
    say({
        "phase": "stark_lookup",
        "stark": "PermutationStark",
        "config": "StarkConfig.standard_fast_config",
        "rows": 1 << log_rows,
        "columns": stark.num_columns(),
        "auxiliary_columns": len(pwp.proof.openings.auxiliary_polys),
        "lde_bits": log_rows + fri.rate_bits,
        "trace_generation_s": t1 - t0,
        "prove_first_s": t2 - t1,
        "prove_second_s": second["prove_s"],
        "prove_second_call": second,
        "verify_s": t3 - t2,
        "launches_prove_verify": launches,
        "launch_shapes": {k: sorted(v) for k, v in shapes.items() if k != "mul"},
        "mul_launch_forms": len(shapes["mul"]),
        "broken_permutation_rejected_with": rejected,
        "max_memory_allocated_bytes": peak,
    })
    return launches, shapes, (stark, config, pwp)


def ctl_system(log_rows, x0=CTL_X0, seed=CTL_SHUFFLE_SEED):
    """The system of tests/test_stark_ctl.py:21-41 at 2^log_rows[0] looking
    and 2^log_rows[1] looked rows: both value columns of table 0 look into
    the flagged rows of table 1, shuffled by default_rng(seed)."""
    from plonky2_tpu_torch.stark.cross_table_lookup import CrossTableLookup, TableWithColumns
    from plonky2_tpu_torch.stark.fixtures import CtlLookedStark, CtlLookingStark
    from plonky2_tpu_torch.stark.lookup import Column, Filter

    stark_a = CtlLookingStark(1 << log_rows[0])
    stark_b = CtlLookedStark(1 << log_rows[1])
    trace_a = stark_a.generate_trace(x0)
    values = np.concatenate([trace_a[0], trace_a[1]])
    trace_b = stark_b.generate_trace(values[np.random.default_rng(seed).permutation(len(values))])
    ctls = [
        CrossTableLookup(
            looking_tables=[
                TableWithColumns(0, [Column.single(0)], Filter.default()),
                TableWithColumns(0, [Column.single(1)], Filter.default()),
            ],
            looked_table=TableWithColumns(1, [Column.single(0)], Filter.new_simple(Column.single(1))),
        )
    ]
    return [stark_a, stark_b], [trace_a, trace_b], ctls


def phase_stark_ctl(golden_dir: str, log_rows: list):
    """The two-table CTL system: at 2^5 / 2^7 rows equal to the JAX
    package's pinned proofs on the card and on the CPU; then at its real
    size, prove_all_tables twice (equal), verify_all_tables, a corrupted
    looked table rejected. Returns (launches, shapes)."""
    from plonky2_tpu_torch.stark.config import StarkConfig
    from plonky2_tpu_torch.stark.cross_table_lookup import CtlVerificationError
    from plonky2_tpu_torch.stark.multi import prove_all_tables, verify_all_tables
    from plonky2_tpu_torch.utils.serialization import int_tree

    config = StarkConfig.standard_fast_config()
    pin = pinned_starky(golden_dir, "torch_starky_ctl_{}_{}.json".format(*CTL_SMALL_LOG_ROWS))
    starks, traces, ctls = ctl_system(CTL_SMALL_LOG_ROWS)
    on_card = prove_all_tables(starks, config, traces, [[], []], ctls)
    on_cpu = prove_all_tables(starks, config, traces, [[], []], ctls, device="cpu")
    verify_all_tables(starks, config, on_card, ctls, CTL_SMALL_LOG_ROWS)
    small = {
        "card_equals_cpu": [int_tree(p) for p in on_card] == [int_tree(p) for p in on_cpu],
        "card_equals_jax_package_pin": [int_tree(p) for p in on_card] == pin["proofs"],
    }
    if not all(small.values()):
        raise SystemExit(f"the small CTL system's proofs differ: {small}")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    starks, traces, ctls = ctl_system(log_rows)
    t1 = time.perf_counter()
    reset_counts()  # counts of the CTL path start here
    proofs = prove_all_tables(starks, config, traces, [[], []], ctls)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    verify_all_tables(starks, config, proofs, ctls, log_rows)
    t3 = time.perf_counter()
    launches = read_counts()  # ... and end here
    shapes = read_shapes()
    require_launched(launches, launches, "the CTL path")
    peak = torch.cuda.max_memory_allocated()

    proofs2, second = timed_proof(
        lambda _: prove_all_tables(starks, config, traces, [[], []], ctls), False
    )
    if normalize(proofs2) != normalize(proofs):
        raise SystemExit("CTL system proofs differ between runs")
    del proofs2
    corrupted = [traces[0], traces[1].copy()]
    corrupted[1][0, 2] = (int(corrupted[1][0, 2]) + 1) % P
    bad = prove_all_tables(starks, config, corrupted, [[], []], ctls)
    try:
        verify_all_tables(starks, config, bad, ctls, log_rows)
    except CtlVerificationError as e:
        rejected = type(e).__name__
    else:
        raise SystemExit("BUG: a CTL system with a corrupted looked table was accepted")
    say({
        "phase": "stark_ctl",
        "small_system": {"log_rows": CTL_SMALL_LOG_ROWS, **small},
        "starks": ["CtlLookingStark", "CtlLookedStark"],
        "config": "StarkConfig.standard_fast_config",
        "log_rows": log_rows,
        "looked_values": int(traces[1][1].sum()),
        "auxiliary_columns": [len(p.proof.openings.auxiliary_polys) for p in proofs],
        "trace_generation_s": t1 - t0,
        "prove_first_s": t2 - t1,
        "prove_second_s": second["prove_s"],
        "prove_second_call": second,
        "verify_s": t3 - t2,
        "launches_prove_verify": launches,
        "launch_shapes": {k: sorted(v) for k, v in shapes.items() if k != "mul"},
        "mul_launch_forms": len(shapes["mul"]),
        "corrupted_looked_table_rejected_with": rejected,
        "max_memory_allocated_bytes": peak,
    })
    return launches, shapes


def zk_small_config():
    """tests/test_stark_zk.py:20-31."""
    from plonky2_tpu_torch.fri.config import FriConfig, FriReductionStrategy
    from plonky2_tpu_torch.stark.config import StarkConfig

    return StarkConfig(
        security_bits=1,
        num_challenges=2,
        fri_config=FriConfig(
            rate_bits=1, cap_height=1, proof_of_work_bits=1,
            reduction_strategy=FriReductionStrategy.ConstantArityBits(1, 2), num_query_rounds=8,
        ),
    )


def phase_stark_zk(golden_dir: str, log_rows: int):
    """Zero-knowledge STARKs: the small pinned proof (salts by
    PLONKY2_TPU_SALT_SEED, mask by a seeded generator) on the card; then
    two unseeded proofs of a 2^22-row FibonacciStark that verify and open
    to different values, and a wrong public result rejected. Returns
    (launches, shapes)."""
    from plonky2_tpu_torch.stark.prover import prove
    from plonky2_tpu_torch.stark.verifier import StarkVerificationError, verify_stark_proof
    from plonky2_tpu_torch.utils.serialization import int_tree

    pin = pinned_starky(golden_dir, f"torch_starky_zk_2^{STARKY_SMALL_LOG_ROWS}.json")
    stark, _, trace, pis = fibonacci_stark(STARKY_SMALL_LOG_ROWS)
    os.environ["PLONKY2_TPU_SALT_SEED"] = str(pin["salt_seed"])
    try:
        small = prove(stark, zk_small_config(), trace, pis, zero_knowledge=True,
                      mask_rng=np.random.default_rng(pin["mask_seed"]))
    finally:
        del os.environ["PLONKY2_TPU_SALT_SEED"]
    small_equal = int_tree(small) == pin["proof"]
    if not small_equal:
        raise SystemExit("the small zk STARK proof differs from the JAX package's pin")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stark, config, trace, pis = fibonacci_stark(log_rows)
    t1 = time.perf_counter()
    reset_counts()  # counts of the zk STARK path start here
    pwp = prove(stark, config, trace, pis, zero_knowledge=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    verify_stark_proof(stark, pwp, config, log_rows, zero_knowledge=True)
    t3 = time.perf_counter()
    launches = read_counts()  # ... and end here
    shapes = read_shapes()
    require_launched(launches, launches, "the zk STARK path")
    peak = torch.cuda.max_memory_allocated()

    pwp2, second = timed_proof(lambda _: prove(stark, config, trace, pis, zero_knowledge=True),
                               False)
    verify_stark_proof(stark, pwp2, config, log_rows, zero_knowledge=True)
    differ = pwp2.proof.openings.local_values != pwp.proof.openings.local_values
    if not differ:
        raise SystemExit("two zk STARK proofs open to the same values: no mask")
    bad = copy.deepcopy(pwp)
    bad.public_inputs[2] = (bad.public_inputs[2] + 1) % P
    try:
        verify_stark_proof(stark, bad, config, log_rows, zero_knowledge=True)
    except StarkVerificationError as e:
        rejected = type(e).__name__
    else:
        raise SystemExit("BUG: a zk STARK proof with a wrong public result was accepted")
    say({
        "phase": "stark_zk",
        "small_equals_jax_package_pin": small_equal,
        "stark": "FibonacciStark",
        "config": "StarkConfig.standard_fast_config",
        "rows": 1 << log_rows,
        "committed_trace_polys": 2 * stark.num_columns(),
        "quotient_polys": len(pwp.proof.openings.quotient_polys),
        "trace_generation_s": t1 - t0,
        "prove_first_s": t2 - t1,
        "prove_second_s": second["prove_s"],
        "prove_second_call": second,
        "verify_s": t3 - t2,
        "two_proofs_open_to_different_values": differ,
        "launches_prove_verify": launches,
        "launch_shapes": {k: sorted(v) for k, v in shapes.items() if k != "mul"},
        "mul_launch_forms": len(shapes["mul"]),
        "tamper_rejected_with": rejected,
        "max_memory_allocated_bytes": peak,
    })
    return launches, shapes


def phase_stark_recursion(stark_inner, batch_inner, lookup_inner, golden_dir: str):
    """The PLONK proofs that wrap a STARK, under the unchanged
    standard_recursion_config: (a) the circuit that verifies phase 12's
    2^22-row STARK proof, (b) the one that verifies the batch STARK's proof
    of 2^22, 2^18 and 2^14 rows, (c) the one that verifies phase 15's
    2^22-row lookup STARK proof (tools/gen_starky_pins.py pins its shape).
    Each built, witnessed, proven and verified
    (the path's launch counts); its shape equal to the JAX package's
    (tests/golden/torch_*_shape.json, tools/gen_batch_pins.py); a tampered
    STARK proof failing the outer witness."""
    from plonky2_tpu_torch.iop.generator import generate_partial_witness
    from plonky2_tpu_torch.iop.witness import PartialWitness
    from plonky2_tpu_torch.models.bench_recursion import circuit_shape
    from plonky2_tpu_torch.plonk.circuit_builder import CircuitBuilder
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    from plonky2_tpu_torch.plonk.prover import prove
    from plonky2_tpu_torch.plonk.verifier import verify
    from plonky2_tpu_torch.stark import batch_recursive_verifier as brv
    from plonky2_tpu_torch.stark import recursive_verifier as rv
    from plonky2_tpu_torch.utils import serialization as ser

    config = CircuitConfig.standard_recursion_config()
    stark, stark_config, stark_proof = stark_inner
    starks, batch_config, batch_proof = batch_inner
    lookup_stark, lookup_config, lookup_proof = lookup_inner

    def build_stark():
        b = CircuitBuilder(config)
        pt = rv.add_virtual_stark_proof_with_pis(b, stark, stark_config, STARK_LOG_ROWS)
        rv.verify_stark_proof_circuit(b, stark, pt, stark_config, STARK_LOG_ROWS)
        return b.build(), pt

    def witness_stark(pt, inner):
        pw = PartialWitness()
        rv.set_stark_proof_with_pis_target(pw, pt, inner)
        return pw

    def build_lookup():
        b = CircuitBuilder(config)
        pt = rv.add_virtual_stark_proof_with_pis(b, lookup_stark, lookup_config, LOOKUP_LOG_ROWS)
        rv.verify_stark_proof_circuit(b, lookup_stark, pt, lookup_config, LOOKUP_LOG_ROWS)
        return b.build(), pt

    def tamper_lookup(bad):
        aux = bad.proof.openings.auxiliary_polys
        aux[0] = ((aux[0][0] + 1) % P, aux[0][1])

    def build_batch():
        b = CircuitBuilder(config)
        pt = brv.add_virtual_batch_stark_proof(b, starks, batch_config, BATCH_LOG_ROWS)
        brv.verify_batch_stark_proof_circuit(b, starks, pt, batch_config, BATCH_LOG_ROWS)
        return b.build(), pt

    def witness_batch(pt, inner):
        pw = PartialWitness()
        brv.set_batch_stark_proof_target(pw, pt, inner)
        return pw

    def tamper_stark(bad):
        bad.public_inputs[2] = (bad.public_inputs[2] + 1) % P

    def tamper_batch(bad):
        ev = bad.opening_proof.query_round_proofs[0].steps[0].evals
        ev[0] = (ev[0][0] ^ 1, ev[0][1])

    name_batch = "_".join(str(d) for d in BATCH_LOG_ROWS)
    circuits = [
        (f"stark_2^{STARK_LOG_ROWS}", build_stark, witness_stark, tamper_stark, stark_proof,
         f"torch_stark_outer_2^{STARK_LOG_ROWS}_shape.json"),
        (f"batch_stark_{name_batch}", build_batch, witness_batch, tamper_batch, batch_proof,
         f"torch_batch_stark_outer_{name_batch}_shape.json"),
        (f"lookup_stark_2^{LOOKUP_LOG_ROWS}", build_lookup, witness_stark, tamper_lookup,
         lookup_proof, f"torch_starky_lookup_outer_2^{LOOKUP_LOG_ROWS}_shape.json"),
    ]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # counts of the STARK-wrap path start here
    runs = []
    for name, build, set_witness, _, inner, _ in circuits:
        t0 = time.perf_counter()
        data, pt = build()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pw = set_witness(pt, inner)
        pwp = prove(data.prover_only, data.common, pw)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        verify(pwp, data.verifier_only, data.common)
        t3 = time.perf_counter()
        runs.append((data, pt, pwp, pw, {"build_s": t1 - t0, "prove_first_s": t2 - t1,
                                          "verify_s": t3 - t2}))
    launches = read_counts()  # ... and end here
    shapes = read_shapes()
    peak = torch.cuda.max_memory_allocated()
    for k, n in launches.items():
        if n == 0:
            raise SystemExit(f"kernel {k} was never launched by the STARK-wrap path")

    out = {}
    for (name, _, set_witness, tamper, inner, shape_file), (data, pt, pwp, pw, times) in zip(
        circuits, runs
    ):
        with open(os.path.join(golden_dir, shape_file)) as f:
            want = json.load(f)
        shape = circuit_shape(data)
        t = time.perf_counter()
        generate_partial_witness(pw, data.prover_only, data.common).full_witness()
        witness_s = time.perf_counter() - t
        _, second = timed_proof(lambda dt: prove(data.prover_only, data.common, pw,
                                                 device_transcript=dt), True)
        bad = copy.deepcopy(inner)
        tamper(bad)
        out[name] = {
            **times,
            "prove_second_s": second["prove_s"],
            "prove_second_call": second,
            "witness_s": witness_s,
            "witgen": require_native_engines(data),
            "degree_bits": shape["degree_bits"],
            "gate_rows": shape["gate_rows"],
            "shape_equals_jax_package_pin": shape == want,
            "proof_bytes": len(ser.proof_to_bytes(pwp, data.common)),
            "tampered_inner_witness_failed_with": outer_witness_fails(data, set_witness(pt, bad)),
        }
        if shape != want:
            raise SystemExit(f"the outer circuit {name} has another shape than {shape_file}")
    say({
        "phase": "stark_recursion",
        "config": "standard_recursion_config",
        "inner_config": "StarkConfig.standard_fast_config",
        **out,
        "launches_build_prove_verify": launches,
        "launch_shapes": {k: sorted(v) for k, v in shapes.items() if k != "mul"},
        "mul_launch_forms": len(shapes["mul"]),
        "max_memory_allocated_bytes": peak,
    })
    return launches, shapes


# ---------------------------------------------------------------------------
# The other hashers: Poseidon2 (trees, PoW grind and the public-input hash
# on the device) and Keccak (trees and grind on the host)
# ---------------------------------------------------------------------------


@contextmanager
def timed_calls(seconds: dict, targets, syncs: dict = None):
    """For the duration of the block, replace each (owner, attribute, label)
    by a wrapper that adds the call's host-clock seconds, device waited for
    on both sides, to seconds[label], and, given ``syncs``, the
    synchronising operations made inside the call (count_syncs) to
    syncs[label]. A wrapped function called from inside another
    (from_values calls from_coeffs) counts under the outer one only."""
    saved = []
    depth = [0]

    def wrap(fn, label):
        def timed(*args, **kwargs):
            if depth[0]:
                return fn(*args, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            depth[0] += 1
            try:
                if syncs is None:
                    out = fn(*args, **kwargs)
                else:
                    out, n, _ = count_syncs(lambda: fn(*args, **kwargs))
                    syncs[label] = syncs.get(label, 0) + n
            finally:
                depth[0] -= 1
            torch.cuda.synchronize()
            seconds[label] = seconds.get(label, 0.0) + time.perf_counter() - t0
            return out

        return timed

    try:
        for owner, attr, label in targets:
            fn = getattr(owner, attr)
            saved.append((owner, attr, owner.__dict__[attr]))
            timed = wrap(fn, label)
            if isinstance(saved[-1][2], staticmethod):
                timed = staticmethod(timed)
            setattr(owner, attr, timed)
        yield
    finally:
        for owner, attr, original in saved:
            setattr(owner, attr, original)


def require_launched(launches: dict, names, what: str) -> None:
    for name in names:
        if launches[name] == 0:
            raise SystemExit(f"kernel {name} was never launched by {what}")


def phase_hashers_small(golden_dir: str) -> dict:
    """The circuit of the JAX package's tests/test_generic_config.py::_build
    (fib(11) under its _small_config; models/hasher_fib.py) proven on the
    card under keccak_goldilocks_config and poseidon2_goldilocks_config: the
    proof and the common data equal tests/golden/torch_{keccak,poseidon2}_
    fib_{proof,common}.bin (the JAX package's, tools/gen_hasher_pins.py),
    each proof verifies and is rejected under poseidon_goldilocks_config;
    the batched Poseidon2 permutation on the card equals the host one on
    edge and random states; the three Poseidon2 gates' device eval on the
    card equals their host eval. Returns the kernel shapes it launched."""
    from plonky2_tpu_torch.gates import gate_testing
    from plonky2_tpu_torch.gates import poseidon2 as p2gates
    from plonky2_tpu_torch.hash import poseidon2 as p2
    from plonky2_tpu_torch.models.hasher_fib import build_fib
    from plonky2_tpu_torch.ops import gf
    from plonky2_tpu_torch.plonk import generic_config as gcm
    from plonky2_tpu_torch.plonk.prover import prove
    from plonky2_tpu_torch.plonk.verifier import verify
    from plonky2_tpu_torch.utils import serialization as ser

    reset_counts()
    poseidon = gcm.poseidon_goldilocks_config()
    proofs = {}
    for short, gc in (("keccak", gcm.keccak_goldilocks_config()),
                      ("poseidon2", gcm.poseidon2_goldilocks_config())):
        t0 = time.perf_counter()
        data, pw = build_fib(gc)
        t1 = time.perf_counter()
        pwp = prove(data.prover_only, data.common, pw, gc=gc)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        verify(pwp, data.verifier_only, data.common, gc=gc)
        t3 = time.perf_counter()
        equal = {}
        for part, blob in (("proof", ser.proof_to_bytes(pwp, data.common)),
                           ("common", ser.common_data_to_bytes(data.common))):
            with open(os.path.join(golden_dir, f"torch_{short}_fib_{part}.bin"), "rb") as f:
                equal[part] = blob == f.read()
        rejected = expect_rejected(
            lambda p, vd, c: verify(p, vd, c, gc=poseidon), pwp, data,
            f"a {short} proof under the Poseidon config",
        )
        proofs[short] = {
            "build_s": t1 - t0, "prove_s": t2 - t1, "verify_s": t3 - t2,
            "public_inputs": pwp.public_inputs, "bytes_equal_golden": equal,
            "rejected_under_poseidon_with": rejected,
        }
        if not all(equal.values()) or pwp.public_inputs[2] != 89:
            raise SystemExit(f"the {short} fib proof differs from tests/golden: {equal}")

    rng = np.random.default_rng(2031)
    edges = [[0] * 12, [P - 1] * 12, [(i << 32) % P for i in range(12)], [(1 << 32) - 1] * 12,
             [0, P - 1, 1 << 32, (1 << 32) - 1, 1, P - 2, 1 << 63, 2, 0, P - 1, 7, 1 << 40]]
    states = np.concatenate([np.array(edges, dtype=np.uint64),
                             rng.integers(0, P, size=(59, 12), dtype=np.uint64)])
    got = gf.to_u64(p2.permute_batch(gf.from_u64(states, "cuda")))
    mismatches = sum(
        [int(x) for x in out] != p2.permute([int(x) for x in row]) for row, out in zip(states, got)
    )
    gates = [p2gates.Poseidon2Gate(), p2gates.Poseidon2MdsGate(), p2gates.Poseidon2IntMixGate()]
    for gate in gates:
        gate_testing.check_algebra_agreement(gate, batch=8, device="cuda")
    shapes = read_shapes()
    say({
        "phase": "hashers_small",
        "proofs": proofs,
        "permute_batch_states": len(states),
        "permute_batch_mismatches_against_host": mismatches,
        "gates_device_eval_equal_host": [g.id() for g in gates],
        "launches": read_counts(),
    })
    if mismatches:
        raise SystemExit(f"the Poseidon2 permutation on the card differs from the host's "
                         f"on {mismatches} states")
    return shapes


def hasher_rejections(pwp, data, gc) -> list:
    """A changed opening, and the proof under poseidon_goldilocks_config,
    must be rejected."""
    from plonky2_tpu_torch.plonk import generic_config as gcm
    from plonky2_tpu_torch.plonk.verifier import verify

    bad = copy.deepcopy(pwp)
    c0, c1 = bad.proof.openings.wires[0]
    bad.proof.openings.wires[0] = ((c0 + 1) % P, c1)
    poseidon = gcm.poseidon_goldilocks_config()
    return [
        expect_rejected(lambda p, vd, c: verify(p, vd, c, gc=gc), bad, data,
                        f"a {gc.name} proof with a changed opening"),
        expect_rejected(lambda p, vd, c: verify(p, vd, c, gc=poseidon), pwp, data,
                        f"a {gc.name} proof under the Poseidon config"),
    ]


def first_hasher_proof(build, gc):
    """Build, prove and verify under ``gc`` with the launch counters zeroed
    just before and read just after: (data, pw, proof, seconds, launches,
    shapes)."""
    from plonky2_tpu_torch.plonk.prover import prove
    from plonky2_tpu_torch.plonk.verifier import verify

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # counts of the path start here
    t0 = time.perf_counter()
    data, pw = build()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pwp = prove(data.prover_only, data.common, pw, gc=gc)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    verify(pwp, data.verifier_only, data.common, gc=gc)
    t3 = time.perf_counter()
    launches = read_counts()  # ... and end here
    seconds = {"build_s": t1 - t0, "prove_first_s": t2 - t1, "verify_s": t3 - t2}
    return data, pw, pwp, seconds, launches, read_shapes()


def phase_poseidon2_full_width(log2_gates: int):
    """The NoopGate circuit of phase 4 (2^(log2_gates - 1) + 1 NoopGates,
    degree 2^log2_gates, LDE 2^(log2_gates + 3), 143 wires) under the
    unchanged standard_recursion_config and poseidon2_goldilocks_config:
    every tree and the PoW grind by the batched Poseidon2 permutation on
    the card, the public-input hash a Poseidon2Gate row in every quotient.
    Build, prove, verify (the path's launch counts), a second proof (equal
    bytes; syncs and launches counted), a proof with the tree builds timed
    and their syncs counted (there must be none), a tampered opening and
    the Poseidon config rejected. (tools/torch_profile_prove.py --hasher
    poseidon2 profiles the same proof.)"""
    from plonky2_tpu_torch.iop.witness import PartialWitness
    from plonky2_tpu_torch.ops import merkle
    from plonky2_tpu_torch.plonk import generic_config as gcm
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    from plonky2_tpu_torch.plonk.prover import prove
    from plonky2_tpu_torch.utils import serialization as ser

    config = CircuitConfig.standard_recursion_config()
    gc = gcm.poseidon2_goldilocks_config()
    data, pw, pwp, seconds, launches, shapes = first_hasher_proof(
        lambda: (noop_circuit(config, log2_gates, gc), PartialWitness()), gc
    )
    assert data.common.degree_bits == log2_gates, data.common.degree_bits
    require_launched(launches, ("mul", "row_fft", "col_fft"), f"the Poseidon2 2^{log2_gates} path")
    second, second_rec = timed_proof(
        lambda dt: prove(data.prover_only, data.common, pw, gc=gc, device_transcript=dt), False
    )
    equal = ser.proof_to_bytes(second, data.common) == ser.proof_to_bytes(pwp, data.common)
    tree_s, tree_syncs = {}, {}
    with timed_calls(tree_s, [(merkle, "_p2_tree_levels", "trees")], tree_syncs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        third_proof = prove(data.prover_only, data.common, pw, gc=gc)
        torch.cuda.synchronize()
        third_s = time.perf_counter() - t
    rejected = hasher_rejections(pwp, data, gc)
    proof_bytes = ser.proof_to_bytes(pwp, data.common)
    say({
        "phase": f"poseidon2_2^{log2_gates}",
        "config": "standard_recursion_config",
        "generic_config": gc.name,
        "degree_bits": data.common.degree_bits,
        "lde_bits": data.common.degree_bits + config.fri_config.rate_bits,
        **seconds,
        "prove_second_s": second_rec["prove_s"],
        "syncs_second_call": second_rec["syncs"],
        "sync_sites_second_call": second_rec["sync_sites"],
        "kernel_launches_second_call": second_rec["kernel_launches"],
        "proof_bytes": len(proof_bytes),
        "proofs_equal": equal,
        "instrumented_prove_s": third_s,
        "poseidon2_trees_s": tree_s["trees"],
        "poseidon2_trees_syncs": tree_syncs["trees"],
        "poseidon2_tree_share_of_prove": tree_s["trees"] / third_s,
        "launches_build_prove_verify": launches,
        "mul_launch_forms": len(shapes["mul"]),
        "tamper_rejected_with": rejected,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    })
    if not equal or ser.proof_to_bytes(third_proof, data.common) != proof_bytes:
        raise SystemExit("two Poseidon2 proofs of the same witness differ")
    if tree_syncs["trees"]:
        raise SystemExit(f"building the Poseidon2 trees synchronised {tree_syncs['trees']} times")
    return launches, shapes


def phase_poseidon2_chain(num_permutations: int):
    """A chain of Poseidon2 permutations (models/poseidon2_chain.py, one
    Poseidon2Gate row each, the first input and the last output public)
    under the unchanged standard_recursion_config and
    poseidon2_goldilocks_config: build, prove, verify (the path's launch
    counts), the last output against the host permutation applied as many
    times, the witness timed (Poseidon2's generators run in Python, as in
    the JAX package), a second proof (equal bytes), tampers rejected."""
    from plonky2_tpu_torch.iop.generator import generate_partial_witness
    from plonky2_tpu_torch.models.gate_mix import gate_counts
    from plonky2_tpu_torch.models.poseidon2_chain import (
        CHAIN_INPUT,
        build_poseidon2_chain,
        chain_output,
    )
    from plonky2_tpu_torch.plonk import generic_config as gcm
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    from plonky2_tpu_torch.plonk.prover import prove
    from plonky2_tpu_torch.utils import serialization as ser

    config = CircuitConfig.standard_recursion_config()
    gc = gcm.poseidon2_goldilocks_config()
    data, pw, pwp, seconds, launches, shapes = first_hasher_proof(
        lambda: build_poseidon2_chain(config, num_permutations), gc
    )
    require_launched(launches, ("mul", "row_fft"), "the Poseidon2 chain")
    t = time.perf_counter()
    want = chain_output(num_permutations)
    host_s = time.perf_counter() - t
    output_equal = pwp.public_inputs == CHAIN_INPUT + want
    t = time.perf_counter()
    generate_partial_witness(pw, data.prover_only, data.common).full_witness()
    witness_s = time.perf_counter() - t
    stats = dict(data.prover_only._witgen_enc.stats)
    second, second_rec = timed_proof(
        lambda dt: prove(data.prover_only, data.common, pw, gc=gc, device_transcript=dt), False
    )
    equal = ser.proof_to_bytes(second, data.common) == ser.proof_to_bytes(pwp, data.common)
    rejected = hasher_rejections(pwp, data, gc)
    say({
        "phase": f"poseidon2_chain_2^{data.common.degree_bits}",
        "config": "standard_recursion_config",
        "generic_config": gc.name,
        "permutations": num_permutations,
        "degree_bits": data.common.degree_bits,
        "gate_rows": gate_counts(data),
        **seconds,
        "witness_s": witness_s,
        "python_gens": stats.get("python_gens"),
        "python_generator_types": python_generator_types(data),
        "prove_second_s": second_rec["prove_s"],
        "syncs_second_call": second_rec["syncs"],
        "kernel_launches_second_call": second_rec["kernel_launches"],
        "host_permutations_s": host_s,
        "last_output_equal_host": output_equal,
        "proofs_equal": equal,
        "launches_build_prove_verify": launches,
        "tamper_rejected_with": rejected,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    })
    if not output_equal:
        raise SystemExit("the chain's last output differs from the host permutations'")
    if not equal:
        raise SystemExit("two Poseidon2 chain proofs of the same witness differ")
    return launches, shapes


def phase_keccak(log2_gates: int):
    """The NoopGate circuit at degree 2^log2_gates (the shape of
    tests/golden/bench_inner_2^12.bin) under the unchanged
    standard_recursion_config and keccak_goldilocks_config: trees and the
    PoW grind on the host (native Keccak), as in the JAX package. Build,
    prove, verify (the path's launch counts), a second proof (equal bytes;
    syncs and launches counted) with the host trees and the host grind
    timed apart, tampers rejected."""
    from plonky2_tpu_torch.fri import prover as fri_prover
    from plonky2_tpu_torch.iop.witness import PartialWitness
    from plonky2_tpu_torch.ops import merkle
    from plonky2_tpu_torch.plonk import generic_config as gcm
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    from plonky2_tpu_torch.plonk.prover import prove
    from plonky2_tpu_torch.utils import serialization as ser

    config = CircuitConfig.standard_recursion_config()
    gc = gcm.keccak_goldilocks_config()
    data, pw, pwp, seconds, launches, shapes = first_hasher_proof(
        lambda: (noop_circuit(config, log2_gates, gc), PartialWitness()), gc
    )
    assert data.common.degree_bits == log2_gates, data.common.degree_bits
    require_launched(launches, ("mul", "row_fft"), f"the Keccak 2^{log2_gates} path")

    host_s = {}
    with timed_calls(host_s, [(merkle.HostMerkleTree, "build", "host_trees"),
                              (fri_prover, "_host_pow_grind", "host_pow_grind")]):
        second_proof, second_rec = timed_proof(
            lambda dt: prove(data.prover_only, data.common, pw, gc=gc, device_transcript=dt), False
        )
    equal = ser.proof_to_bytes(second_proof, data.common) == ser.proof_to_bytes(pwp, data.common)
    rejected = hasher_rejections(pwp, data, gc)
    say({
        "phase": f"keccak_2^{log2_gates}",
        "config": "standard_recursion_config",
        "generic_config": gc.name,
        "degree_bits": data.common.degree_bits,
        **seconds,
        "prove_second_s": second_rec["prove_s"],
        "syncs_second_call": second_rec["syncs"],
        "kernel_launches_second_call": second_rec["kernel_launches"],
        "host_trees_s": host_s["host_trees"],
        "host_pow_grind_s": host_s["host_pow_grind"],
        "pow_witness": pwp.proof.opening_proof.pow_witness,
        "proof_bytes": len(ser.proof_to_bytes(pwp, data.common)),
        "proofs_equal": equal,
        "launches_build_prove_verify": launches,
        "mul_launch_forms": len(shapes["mul"]),
        "tamper_rejected_with": rejected,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    })
    if not equal:
        raise SystemExit("two Keccak proofs of the same witness differ")
    return launches, shapes


# ---------------------------------------------------------------------------
# Phase 23: circuit checkpoints, the torch-free verifier, a profiler trace
# ---------------------------------------------------------------------------

# the spans the prover opens (plonk/prover.py, plonk/device_transcript.py)
PROVER_SPANS = (
    "prove/witness", "prove/device-transcript", "prove/commit-wires",
    "prove/zs-partial-products", "prove/quotient", "prove/fri",
)
# kernel names (substrings) of the hand-written kernels in a trace
KERNEL_NAMES = (
    "poseidon_permute_kernel", "poseidon_compress_kernel", "poseidon_sponge_kernel",
    "gl_mul_kernel", "col_fft_kernel", "row_fft_kernel",
)

STANDALONE_VERIFIER = r"""
import sys

class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if name in ("torch", "jax") or name.startswith(("torch.", "jax.", "jaxlib")):
            raise ImportError(f"import blocked in the standalone verifier: {name}")

sys.meta_path.insert(0, _Blocker())
sys.path.insert(0, sys.argv[1])

import time
import plonky2_tpu_torch.verifier as sv

assert "torch" not in sys.modules
with open(sys.argv[2], "rb") as f:
    proof_b, vd_b, common_b = f.read().split(b"\x00SPLIT\x00")
common = sv.common_data_from_bytes(common_b)
vd, _ = sv.verifier_data_from_bytes(vd_b)
pwp = sv.proof_from_bytes(proof_b, common)
t0 = time.perf_counter()
sv.verify(pwp, vd, common)
t1 = time.perf_counter()
cpwp = sv.compress_proof(pwp, vd, common)
sv.verify_compressed_proof(cpwp, vd, common)
assert sv.proof_to_bytes(sv.decompress_proof(cpwp, vd, common), common) == proof_b
t2 = time.perf_counter()
if pwp.public_inputs:
    pwp.public_inputs[0] ^= 1
else:  # a circuit without public inputs: one is made up
    pwp.public_inputs.append(1)
try:
    sv.verify(pwp, vd, common)
except Exception as e:
    rejected = type(e).__name__
else:
    raise SystemExit("BUG: a tampered public input was accepted")
assert "torch" not in sys.modules and "jax" not in sys.modules
print(f"STANDALONE_OK {t1 - t0} {t2 - t1} {rejected}")
"""


def standalone_verify(pwp, data) -> dict:
    """Verify ``pwp`` in a ``python -I`` subprocess that blocks torch and
    jax and imports plonky2_tpu_torch.verifier only: the proof, the
    compressed round trip, a tampered public input rejected."""
    import tempfile

    from plonky2_tpu_torch.utils import serialization as ser

    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "proof.bin")
        with open(path, "wb") as f:
            f.write(b"\x00SPLIT\x00".join([
                ser.proof_to_bytes(pwp, data.common),
                ser.verifier_data_to_bytes(data.verifier_only, data.common),
                ser.common_data_to_bytes(data.common),
            ]))
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-I", "-c", STANDALONE_VERIFIER, here, path],
            capture_output=True, text=True, timeout=600,
        )
        wall = time.perf_counter() - t0
    if out.returncode != 0 or "STANDALONE_OK" not in out.stdout:
        raise SystemExit(f"standalone verifier failed:\n{out.stdout}\n{out.stderr}")
    _, verify_s, compressed_s, rejected = out.stdout.split()
    return {"subprocess_s": wall, "verify_s": float(verify_s),
            "compress_verify_decompress_s": float(compressed_s),
            "tamper_rejected_with": rejected}


def traced_fibonacci(trace_dir: str) -> dict:
    """One fibonacci proof on the card under utils/profiling.trace: the
    trace file must name every prover-step span and hand-written kernels."""
    from plonky2_tpu_torch.models.fibonacci import build_fibonacci
    from plonky2_tpu_torch.plonk.prover import prove
    from plonky2_tpu_torch.utils import profiling

    data, pw = build_fibonacci(public_io=True)
    prove(data.prover_only, data.common, pw)  # warm-up: tables, allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profiling.trace(trace_dir):
        prove(data.prover_only, data.common, pw)
        torch.cuda.synchronize()
    traced_s = time.perf_counter() - t0
    path = os.path.join(trace_dir, profiling.TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events]
    spans = {s: names.count(s) for s in PROVER_SPANS}
    kernels = {k: sum(k in n for n in names) for k in KERNEL_NAMES}
    if not all(spans.values()):
        raise SystemExit(f"the trace lacks prover spans: {spans}")
    if not any(kernels.values()):
        raise SystemExit("the trace names no hand-written kernel")
    return {"trace_file": os.path.relpath(path), "trace_bytes": os.path.getsize(path),
            "trace_events": len(events), "traced_s": traced_s,
            "spans": spans, "kernel_events": kernels}


def phase_checkpoint_aux(log2_gates: int):
    """Phase 4's circuit through a checkpoint: written, loaded on the card
    (the commit kernels rebuild its constants/sigmas commitment), proven to
    the pinned digest; that proof verified by the torch-free verifier in a
    subprocess; then one fibonacci proof traced. Returns (the reloaded
    circuit's proof bytes, its circuit data, the checkpoint, the kernel
    shapes launched)."""
    from plonky2_tpu_torch.iop.witness import PartialWitness
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    from plonky2_tpu_torch.plonk.prover import prove
    from plonky2_tpu_torch.plonk.verifier import verify
    from plonky2_tpu_torch.utils import serialization as ser

    config = CircuitConfig.standard_recursion_config()
    data = noop_circuit(config, log2_gates)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blob = ser.circuit_data_to_bytes(data)
    t1 = time.perf_counter()
    del data
    reset_counts()
    loaded = ser.circuit_data_from_bytes(blob, device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    load_launches = read_counts()
    require_launched(load_launches, ["mul", "compress", "sponge"], "loading a checkpoint")
    if load_launches["col_fft"] + load_launches["row_fft"] == 0:
        raise SystemExit("loading a checkpoint launched no FFT kernel")
    if ser.circuit_data_to_bytes(loaded) != blob:
        raise SystemExit("the reloaded circuit writes other bytes")
    pwp = prove(loaded.prover_only, loaded.common, PartialWitness())
    torch.cuda.synchronize()
    proof_bytes = ser.proof_to_bytes(pwp, loaded.common)
    digest = hashlib.sha256(proof_bytes).hexdigest()
    if digest != PLONK_PROOF_SHA256:
        raise SystemExit(f"the reloaded circuit's proof digest {digest} != pinned {PLONK_PROOF_SHA256}")
    verify(pwp, loaded.verifier_only, loaded.common)
    standalone = standalone_verify(pwp, loaded)
    trace = traced_fibonacci(os.path.join("torch_traces", "chip_smoke_fibonacci"))
    shapes = read_shapes()
    say({
        "phase": "checkpoint_aux",
        "degree_bits": loaded.common.degree_bits,
        "checkpoint_bytes": len(blob),
        "to_bytes_s": t1 - t0,
        "from_bytes_s": t2 - t1,
        "load_launches": load_launches,
        "proof_sha256": digest,
        "proof_equal_pinned": digest == PLONK_PROOF_SHA256,
        "standalone_verifier": standalone,
        "trace": trace,
    })
    return proof_bytes, loaded, blob, shapes


# ---------------------------------------------------------------------------
# Phase 24: the prover mesh at full width, on virtual shards
# ---------------------------------------------------------------------------

MESH_SHARDS = 8
SIX_STEP_LOG = 24
MESH_CAP_LEAVES = (19, 143)  # log2 rows, width
# B1-B4: the field product, the permutation and two-to-one, the leaf
# sponge and the row FFT must each launch in every mesh proof
MESH_KERNELS = ("mul", "permute", "compress", "sponge", "row_fft")


def largest_allocations(fn, into: dict):
    """fn() with the CUDA caching allocator's history recorded (no
    tracebacks): into gets the largest single block it allocated, the
    largest segment it took by cudaMalloc and the blocks it allocated.
    Host-side bookkeeping only: no synchronising operation."""
    torch.cuda.memory._record_memory_history("all", context=None, clear_history=True)
    try:
        out = fn()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(None)
    trace = snap["device_traces"][torch.cuda.current_device()]
    allocs = [e["size"] for e in trace if e["action"] == "alloc"]
    if not allocs:
        raise SystemExit("the allocator's history recorded no allocation")
    into.update({
        "largest_allocation_bytes": max(allocs),
        "largest_segment_bytes": max((e["size"] for e in trace if e["action"] == "segment_alloc"),
                                     default=0),
        "allocations": len(allocs),
    })
    return out


def sharded_parts(data) -> dict:
    """The shapes of the constants/sigmas oracle's parts: its coefficient
    rows and its tree's leaf rows a shard (empty if it is whole)."""
    cs = data.prover_only.constants_sigmas_commitment
    if not cs.sharded:
        return {}
    return {"coefficient_parts": [list(p.shape) for p in cs.polynomials.parts],
            "leaf_parts": [list(p.shape) for p in cs.merkle_tree.leaf_parts]}


def mesh_proofs(data, mesh, want: bytes) -> dict:
    """Under ``mesh``: a device-transcript proof (first call), a second one
    counted for syncs (at most PoW chunks + 1) with its allocations
    recorded, and a host-transcript one; every proof's bytes must equal
    ``want``."""
    from plonky2_tpu_torch.iop.witness import PartialWitness
    from plonky2_tpu_torch.ops import fri_kernels as fk
    from plonky2_tpu_torch.parallel import context as pctx
    from plonky2_tpu_torch.plonk.prover import prove
    from plonky2_tpu_torch.plonk.verifier import verify
    from plonky2_tpu_torch.utils import serialization as ser

    def prove_with(dt):
        with pctx.prover_mesh(mesh):
            return prove(data.prover_only, data.common, PartialWitness(), device_transcript=dt)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = prove_with(True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    verify(first, data.verifier_only, data.common)
    memory = {}
    second, dev_rec = timed_proof(lambda dt: largest_allocations(lambda: prove_with(dt), memory),
                                  True)
    host, host_rec = timed_proof(prove_with, False)
    equal = [ser.proof_to_bytes(p, data.common) == want for p in (first, second, host)]
    if not all(equal):
        raise SystemExit(f"mesh proofs differ from the single-device proof: {equal}")
    bits = data.common.config.fri_config.proof_of_work_bits
    chunks = first.proof.opening_proof.pow_witness // fk._pow_chunk_size(bits) + 1
    if dev_rec["syncs"] > chunks + 1:
        raise SystemExit(f"a mesh proof synchronised {dev_rec['syncs']} times "
                         f"(bound {chunks + 1}): {dev_rec['sync_sites']}")
    return {
        "shards": mesh.size,
        "devices": sorted({str(d) for d in mesh.devices}),
        "constants_sigmas_sharded": sharded_parts(data),
        "prove_first_s": first_s,
        "device_transcript_second_call": dev_rec,
        "device_sync_bound": chunks + 1,
        "second_call_memory": memory,
        "host_transcript_call": host_rec,
        "bytes_equal_single_device": equal,
    }


def load_under(mesh, blob: bytes):
    """Phase 23's checkpoint loaded under ``mesh``: its constants/sigmas
    oracle sharded, and written again, the same bytes. Returns (the
    circuit data, its load seconds)."""
    from plonky2_tpu_torch.parallel import context as pctx
    from plonky2_tpu_torch.utils import serialization as ser

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with pctx.prover_mesh(mesh):
        data = ser.circuit_data_from_bytes(blob, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if not sharded_parts(data):
        raise SystemExit("a checkpoint loaded under a mesh kept its oracle whole")
    if ser.circuit_data_to_bytes(data) != blob:
        raise SystemExit("the checkpoint loaded under a mesh writes other bytes")
    return data, load_s


def phase_mesh(want: bytes, data, blob: bytes):
    """The circuit of phase 23 under 8 virtual shards on card 0 (and over
    every card where there are more than one), as built (its
    constants/sigmas oracle whole) and loaded again under the mesh (that
    oracle sharded): proofs equal to the single-device one, the largest
    single allocation of each second call beside a one-device proof's;
    the six-step transforms, the quotient's coset IFFT and the sharded
    Merkle cap against their single-device versions. Returns (the
    launches of the virtual-shard proofs and load alone, the kernel
    shapes of the whole phase)."""
    from plonky2_tpu_torch.iop.witness import PartialWitness
    from plonky2_tpu_torch.ops import merkle, ntt
    from plonky2_tpu_torch.parallel import context as pctx
    from plonky2_tpu_torch.parallel import ntt as pntt
    from plonky2_tpu_torch.plonk.prover import prove

    count = torch.cuda.device_count()
    try:
        pctx.make_prover_mesh(count + 1)
    except RuntimeError as e:
        refused = str(e)
    else:
        raise SystemExit(f"make_prover_mesh({count + 1}) did not refuse")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = pctx.make_prover_mesh(MESH_SHARDS, virtual_on=torch.device("cuda", 0))
    reset_counts()  # the mesh path's counts start here: its six proofs ...
    virtual = mesh_proofs(data, mesh, want)
    virtual["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sharded, load_s = load_under(mesh, blob)
    virtual_loaded = mesh_proofs(sharded, mesh, want)
    torch.cuda.synchronize()
    launches = read_counts()  # ... and end here
    virtual_loaded["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    del sharded
    require_launched(launches, MESH_KERNELS, "the mesh proofs")
    for run in (virtual, virtual_loaded):
        for call in ("device_transcript_second_call", "host_transcript_call"):
            require_launched(run[call]["kernel_launches"], MESH_KERNELS,
                             f"the mesh proof's {call}")
    one_device = {}
    torch.cuda.reset_peak_memory_stats()
    largest_allocations(
        lambda: prove(data.prover_only, data.common, PartialWitness()), one_device
    )
    one_device["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    limit = one_device["largest_allocation_bytes"] // 4
    for run in (virtual, virtual_loaded):
        if run["second_call_memory"]["largest_allocation_bytes"] > limit:
            raise SystemExit(
                f"a mesh proof allocated {run['second_call_memory']['largest_allocation_bytes']} "
                f"bytes at once, more than a quarter of the one-device proof's {4 * limit}"
            )
    real = None
    if count > 1 and count & (count - 1) == 0:
        cards = pctx.make_prover_mesh(count)
        real = {"built": mesh_proofs(data, cards, want),
                "loaded": mesh_proofs(load_under(cards, blob)[0], cards, want)}

    rng = np.random.default_rng(24)
    dev = torch.device("cuda", 0)
    x = random_field(rng, (1 << SIX_STEP_LOG,), dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = pntt.six_step_fft(x, mesh)
    torch.cuda.synchronize()
    fft_s = time.perf_counter() - t0
    fft_equal = torch.equal(got, ntt.fft(x[None])[0])
    t0 = time.perf_counter()
    back = pntt.six_step_ifft(got, mesh)
    torch.cuda.synchronize()
    ifft_s = time.perf_counter() - t0
    ifft_equal = torch.equal(back, ntt.ifft(got[None])[0]) and torch.equal(back, x)
    del x, got, back
    pntt.clear_tables()

    common = data.common
    q_shape = (common.config.num_challenges, common.degree * common.quotient_degree_factor)
    q = random_field(rng, q_shape, dev)
    coset_equal = torch.equal(pntt.six_step_coset_ifft_batch(q, mesh), ntt.coset_ifft(q))
    del q

    rows_log, width = MESH_CAP_LEAVES
    leaves = random_field(rng, (1 << rows_log, width), dev)
    caps = {}
    for h in range(5):
        caps[h] = torch.equal(pntt.sharded_merkle_cap(leaves, mesh, h),
                              merkle.build_merkle_tree(leaves, h).cap)
    del leaves
    torch.cuda.synchronize()
    shapes = read_shapes()  # the proofs' forms and the checks', for main_path_kernels
    if not (fft_equal and ifft_equal and coset_equal and all(caps.values())):
        raise SystemExit(
            f"mesh transforms or caps differ: fft {fft_equal} ifft {ifft_equal} "
            f"coset {coset_equal} caps {caps}"
        )
    say({
        "phase": f"mesh_2^{common.degree_bits}",
        "card": card_line(),
        "device_count": count,
        "virtual_shards": virtual,
        "virtual_shards_loaded_under_the_mesh": {"load_s": load_s, **virtual_loaded},
        "one_device_proof_memory": one_device,
        "wires_leaf_matrix_bytes": (1 << (common.degree_bits + common.config.fri_config.rate_bits))
        * common.config.num_wires * 8,
        "real_cards": real if real is not None else "not run: "
        + ("this machine has one card; the mesh over real cards needs a power of two of "
           "them, more than one" if count == 1 else f"{count} cards is no power of two"),
        "refused_without_virtual_on": refused,
        f"six_step_fft_2^{SIX_STEP_LOG}": {"equal": fft_equal, "s": fft_s},
        f"six_step_ifft_2^{SIX_STEP_LOG}": {"equal": ifft_equal, "s": ifft_s},
        "six_step_coset_ifft_batch": {"shape": list(q_shape), "equal": coset_equal},
        "sharded_merkle_cap": {"leaves": [1 << rows_log, width], "equal_by_cap_height": caps},
        "launches_of_the_virtual_shard_proofs": launches,
    })
    return launches, shapes


def merge_shapes(into: dict, more: dict) -> None:
    for k, v in more.items():
        into.setdefault(k, set()).update(v)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script does not run on the CPU",
              file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)

    golden_dir = os.path.join(here, "tests", "golden")
    card = phase_device()
    phase_kernel_guards()
    phase_kernels()
    shapes = phase_fibonacci(golden_dir)
    plonk_launches, plonk_shapes = phase_full_width(LOG2_GATES)
    merge_shapes(shapes, plonk_shapes)
    torch.cuda.empty_cache()
    inner_launches, inner_shapes = phase_plonk_inner(INNER_LOG2_GATES, golden_dir)
    merge_shapes(shapes, inner_shapes)
    merge_shapes(shapes, phase_examples(golden_dir))
    mix_launches, mix_shapes = phase_gate_mix(GATE_MIX_LOG2, None)
    merge_shapes(shapes, mix_shapes)
    pin_launches, pin_shapes = phase_gate_mix(GATE_MIX_PIN_LOG2, GATE_MIX_PIN_SHA256)
    merge_shapes(shapes, pin_shapes)
    zk_launches, zk_shapes = phase_zk(ZK_LOG2)
    merge_shapes(shapes, zk_shapes)
    rec_launches, rec_shapes = phase_recursion(golden_dir)
    merge_shapes(shapes, rec_shapes)
    merge_shapes(shapes, phase_stark_small(STARK_SMALL_LOG_ROWS))
    stark_launches, stark_shapes, stark_inner = phase_stark(STARK_LOG_ROWS)
    merge_shapes(shapes, stark_shapes)
    torch.cuda.empty_cache()
    batch_launches, batch_shapes, batch_inner = phase_batch_stark(golden_dir)
    merge_shapes(shapes, batch_shapes)
    merge_shapes(shapes, phase_stark_lookup_small(golden_dir))
    lookup_launches, lookup_shapes, lookup_inner = phase_stark_lookup(LOOKUP_LOG_ROWS)
    merge_shapes(shapes, lookup_shapes)
    ctl_launches, ctl_shapes = phase_stark_ctl(golden_dir, CTL_LOG_ROWS)
    merge_shapes(shapes, ctl_shapes)
    zk_stark_launches, zk_stark_shapes = phase_stark_zk(golden_dir, ZK_STARK_LOG_ROWS)
    merge_shapes(shapes, zk_stark_shapes)
    wrap_launches, wrap_shapes = phase_stark_recursion(
        stark_inner, batch_inner, lookup_inner, golden_dir
    )
    merge_shapes(shapes, wrap_shapes)
    del stark_inner, batch_inner, lookup_inner
    torch.cuda.empty_cache()
    merge_shapes(shapes, phase_hashers_small(golden_dir))
    p2_launches, p2_shapes = phase_poseidon2_full_width(LOG2_GATES)
    merge_shapes(shapes, p2_shapes)
    torch.cuda.empty_cache()
    chain_launches, chain_shapes = phase_poseidon2_chain(CHAIN_PERMUTATIONS)
    merge_shapes(shapes, chain_shapes)
    keccak_launches, keccak_shapes = phase_keccak(INNER_LOG2_GATES)
    merge_shapes(shapes, keccak_shapes)
    torch.cuda.empty_cache()
    ckpt_proof, ckpt_data, ckpt_blob, ckpt_shapes = phase_checkpoint_aux(LOG2_GATES)
    merge_shapes(shapes, ckpt_shapes)
    mesh_launches, mesh_shapes = phase_mesh(ckpt_proof, ckpt_data, ckpt_blob)
    merge_shapes(shapes, mesh_shapes)
    del ckpt_data
    torch.cuda.empty_cache()
    records = phase_main_path_kernels(shapes)

    print(card, flush=True)
    by_name = {
        "poseidon_permute": "permute", "poseidon_compress": "compress",
        "poseidon_sponge": "sponge", "gl_mul": "mul", "col_fft": "col_fft", "row_fft": "row_fft",
    }
    for r in records:
        k = by_name[r["name"]]
        r["launches_by_path"] = {
            f"plonk_degree_2^{LOG2_GATES}": plonk_launches[k],
            f"plonk_degree_2^{INNER_LOG2_GATES}": inner_launches[k],
            f"gate_mix_2^{GATE_MIX_LOG2}": mix_launches[k],
            f"gate_mix_2^{GATE_MIX_PIN_LOG2}": pin_launches[k],
            f"zk_gate_mix_2^{ZK_LOG2}": zk_launches[k],
            "recursion_outer_2^13": rec_launches[k],
            f"stark_2^{STARK_LOG_ROWS}_rows": stark_launches[k],
            "batch_stark_2^" + "_2^".join(str(d) for d in BATCH_LOG_ROWS): batch_launches[k],
            f"stark_lookup_2^{LOOKUP_LOG_ROWS}_rows": lookup_launches[k],
            "stark_ctl_2^{}_2^{}_rows".format(*CTL_LOG_ROWS): ctl_launches[k],
            f"stark_zk_2^{ZK_STARK_LOG_ROWS}_rows": zk_stark_launches[k],
            "stark_recursion_2^14": wrap_launches[k],
            f"poseidon2_2^{LOG2_GATES}": p2_launches[k],
            "poseidon2_chain_2^13": chain_launches[k],
            f"keccak_2^{INNER_LOG2_GATES}": keccak_launches[k],
            f"mesh_2^{LOG2_GATES}": mesh_launches[k],
        }
        r["launches"] = sum(r["launches_by_path"].values())
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

#!/usr/bin/env python3
"""Times the column-FFT kernel of this tree against variants of its plan
and source and, optionally, against another tree's, on one NVIDIA GPU.

    python3 tools/torch_ntt_variants.py
    python3 tools/torch_ntt_variants.py --against /path/to/other/plonky2_tpu_torch/ops/csrc

Builds plonky2_tpu_torch/ops/csrc/ntt.cu as it is ("this"), each source
variant of it in SOURCE_VARIANTS (launch bounds: a text substitution of
this source), and the ntt.cu of --against ("against", for example a
checkout of the parent commit, whose column kernel is the one-stage-a-
barrier design with the entry point plonky2_col_fft_head), one nvcc each,
all started together. Each library runs the plans of PLAN_VARIANTS
(ops/ntt_cuda.col_plan with other arguments). "this" with the default plan
must equal the plain version ntt._butterflies_rows at every form of
MAIN_PATH_COL_FORMS, and every other library and plan must equal "this";
then each is timed with CUDA events in two rounds, in turns, at every such
form. Prints the card line and one JSON line: per variant its registers
and spill bytes (ptxas -v), SASS instructions a butterfly (as chip_smoke.py
counts them) and its times (ms a launch, one value a round, by
chip_smoke.device_ms: CUDA events around 20 launches back to back).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (after the path insert)
from plonky2_tpu_torch.ops import cuda_build, ntt, ntt_cuda  # noqa: E402

SRC = os.path.join(ROOT, "plonky2_tpu_torch", "ops", "csrc")

# (batch, k_log, L, first_stage, inverse) of every col_fft launch of the
# degree-2^16 PLONK path and the 2^22-row STARK path (chip_smoke.py phase
# main_path_kernels, perf_logs/pr03_chip_smoke.log)
MAIN_PATH_COL_FORMS = [
    (143, 8, 256, 0, True), (143, 9, 1024, 0, False), (143, 10, 512, 3, False),
    (83, 8, 256, 0, True), (83, 9, 1024, 0, False), (83, 10, 512, 3, False),
    (20, 8, 256, 0, True), (20, 9, 1024, 0, False), (20, 10, 512, 3, False),
    (16, 9, 1024, 0, False), (16, 10, 512, 3, False),
    (2, 9, 1024, 0, False), (2, 9, 1024, 0, True), (2, 10, 512, 0, False),
    (2, 10, 512, 0, True), (2, 11, 2048, 0, True), (2, 11, 4096, 0, False),
    (2, 11, 4096, 0, True), (2, 12, 2048, 0, False), (2, 12, 2048, 0, True),
    (2, 12, 2048, 1, False),
]

BOUNDS = "#define NTT_COL_THREADS 256\n#define NTT_COL_MIN_BLOCKS 3"
RADIX = "#define NTT_COL_RADIX_LOG 4"


def bounds(threads: int, blocks: int):
    return [(BOUNDS, f"#define NTT_COL_THREADS {threads}\n#define NTT_COL_MIN_BLOCKS {blocks}")]


# name -> (substitutions of this source, col_plan arguments)
SOURCE_VARIANTS = {
    "threads512_blocks1": (bounds(512, 1), {"threads": 512}),
    "threads256_blocks2": (bounds(256, 2), {}),
    "radix3": ([(RADIX, "#define NTT_COL_RADIX_LOG 3")], {"radix_log": 3}),
}
# name -> (substitutions, col_plan arguments) of probes: sources that
# leave out part of the work, so their outputs are not the transform and
# are not checked; their times say what the rest of the work costs
PROBES = {
    "probe_no_butterflies": (
        [("radix_stages<G, ZERO_J>(v, S, ZERO_J ? 0 : jt + (jl << a), tw);", "")], {}),
}
# name -> col_plan arguments, run with this tree's library
PLAN_VARIANTS = {
    "tile128k": {"tile_words_log": 14},
    "tile32k": {"tile_words_log": 12},
    "threads128": {"threads": 128},
    "split6": {"split_at": 6},
    "one_pass": {"split_at": 0},
}


def write_source(directory: str, text: str, headers_from: str) -> None:
    os.makedirs(directory)
    shutil.copy(os.path.join(headers_from, "goldilocks.cuh"), directory)
    with open(os.path.join(directory, "ntt.cu"), "w") as f:
        f.write(text)


def build(sources: dict) -> dict:
    """{name: directory with ntt.cu} -> {name: (ctypes library, ptxas
    report text, library path)}; one nvcc each, all at once."""
    procs = {}
    for name, d in sources.items():
        cmd = [cuda_build.nvcc(), *cuda_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", d,
               "-o", os.path.join(d, "lib.so"), os.path.join(d, "ntt.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    out = {}
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name, p in procs.items():
        text, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{text}")
        lib = ctypes.CDLL(os.path.join(sources[name], "lib.so"))
        if hasattr(lib, "plonky2_col_fft_pass"):
            lib.plonky2_col_fft_pass.argtypes = [vp, vp, ll] + [i] * 7 + [vp, vp]
        else:
            lib.plonky2_col_fft_head.argtypes = [vp, vp, ll] + [i] * 5 + [vp, vp]
        lib.plonky2_ntt_stage.argtypes = [vp, ll, i, i, i, vp, vp]
        out[name] = (lib, text, os.path.join(sources[name], "lib.so"))
    return out


def run(lib, x, form, plan) -> torch.Tensor:
    """col_fft of x at ``form`` through ``lib``: this tree's passes with
    col_plan(**plan), or (a library without plonky2_col_fft_pass) the
    head-and-tail launch of the other tree's wrapper."""
    batch, k_log, lanes, first, inverse = form
    l_log = lanes.bit_length() - 1
    table = ntt.stage_table(k_log, inverse, x.device)
    stream = torch.cuda.current_stream().cuda_stream
    y = torch.empty_like(x)
    if hasattr(lib, "plonky2_col_fft_pass"):
        passes, tail = ntt_cuda.col_plan(k_log, l_log, first, **plan)
        src = x
        for p in passes:
            cuda_build.raise_on(lib.plonky2_col_fft_pass(
                src.data_ptr(), y.data_ptr(), batch, k_log, l_log, p.first, p.last,
                p.lanes_log, p.packed_groups(), p.threads,
                table.data_ptr(), stream), "col fft pass")
            src = y
    else:
        b_log = min(k_log, 12)
        nl_log = min(l_log, 14 - b_log, 5)
        cuda_build.raise_on(lib.plonky2_col_fft_head(
            x.data_ptr(), y.data_ptr(), batch, k_log, l_log, b_log, nl_log, first,
            table.data_ptr(), stream), "col fft head")
        tail = max(first, b_log)
    for s in range(tail, k_log):
        cuda_build.raise_on(lib.plonky2_ntt_stage(y.data_ptr(), batch, k_log, l_log, s,
                                                  table.data_ptr(), stream), "stage")
    return y


def sass_per_butterfly(path: str, cuobjdump: str) -> dict:
    """SASS a butterfly by set-loop form (chip_smoke.col_fft_sass); the
    other tree's kernel runs one butterfly a loop of two loads and stores."""
    funcs = cs.sass_functions(cs.run_text([cuobjdump, "-sass", path]))
    return {k: v["sass_per_butterfly"] for k, v in cs.col_fft_sass(funcs).items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", default=None,
                    help="csrc directory of another tree (ntt.cu and goldilocks.cuh)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ntt_variants: no CUDA device", file=sys.stderr)
        return 1
    base = open(os.path.join(SRC, "ntt.cu")).read()
    tmp = tempfile.mkdtemp(prefix="ntt_variants_")
    try:
        sources = {"this": os.path.join(tmp, "this")}
        write_source(sources["this"], base, SRC)
        plans = {"this": ("this", {})}
        for name, (subs, plan) in SOURCE_VARIANTS.items():
            text = base
            for old, new in subs:
                if text.count(old) != 1:
                    raise SystemExit(f"variant {name}: the source no longer holds {old!r}")
                text = text.replace(old, new)
            sources[name] = os.path.join(tmp, name)
            write_source(sources[name], text, SRC)
            plans[name] = (name, plan)
        for name, (subs, plan) in PROBES.items():
            text = base
            for old, new in subs:
                if text.count(old) != 1:
                    raise SystemExit(f"probe {name}: the source no longer holds {old!r}")
                text = text.replace(old, new)
            sources[name] = os.path.join(tmp, name)
            write_source(sources[name], text, SRC)
            plans[name] = (name, plan)
        for name, plan in PLAN_VARIANTS.items():
            plans[name] = ("this", plan)
        if args.against:
            sources["against"] = os.path.join(tmp, "against")
            write_source(sources["against"], open(os.path.join(args.against, "ntt.cu")).read(),
                         args.against)
            plans["against"] = ("against", {})
        libs = build(sources)
        cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")

        dev = torch.device("cuda")
        rng = np.random.default_rng(11)
        inputs = {f: cs.with_edges(cs.random_field(rng, (f[0], 1 << f[1], f[2]), dev))
                  for f in MAIN_PATH_COL_FORMS}
        want = {}
        for f, x in inputs.items():
            want[f] = run(libs["this"][0], x, f, {})
            plain = ntt._butterflies_rows(x, ntt.stage_roots(f[1], f[4], dev), f[3])
            if not torch.equal(want[f], plain):
                raise SystemExit(f"this tree's kernel differs from the plain version at {f}")
        res = {}
        for name, (lib_name, plan) in plans.items():
            lib, text, path = libs[lib_name]
            for f, x in inputs.items():
                if name not in PROBES and not torch.equal(run(lib, x, f, plan), want[f]):
                    raise SystemExit(f"{name} differs from this tree's kernel at {f}")
            res[name] = {
                "library": lib_name,
                "plan": plan,
                "registers_spills": {
                    k: [v.get("registers"), v.get("spill_store_bytes")]
                    for k, v in cs.ptxas_report(text, cs.COL_FFT_KERNELS, 256).items()},
                "sass_per_butterfly": sass_per_butterfly(path, cuobjdump),
                "equal_to_this": name not in PROBES,
                "ms": {str(f): [] for f in MAIN_PATH_COL_FORMS},
            }
        for _ in range(2):
            for name, (lib_name, plan) in plans.items():
                lib = libs[lib_name][0]
                for f, x in inputs.items():
                    res[name]["ms"][str(f)].append(
                        cs.device_ms(lambda: run(lib, x, f, plan)))
        # a contiguous copy of the same words: what the card's memory gives
        # this much traffic without the strided runs
        copy_ms = {str(f): cs.device_ms(lambda: torch.empty_like(x).copy_(x))
                   for f, x in inputs.items()}
        bound = {str(f): cs.butterfly_bound(f[0] * f[2], f[1], f[1] - f[3])["bound_ms"]
                 for f in MAIN_PATH_COL_FORMS}
        print(cs.card_line(), flush=True)
        print(json.dumps({"ntt_variants": res, "bound_ms": bound, "copy_ms": copy_ms}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Times the NTT pass kernels of this tree (the column FFT, B5, and the row
FFT, B4) against variants of their plans and source and, optionally,
against another tree's, on one NVIDIA GPU.

    python3 tools/torch_ntt_variants.py
    python3 tools/torch_ntt_variants.py --against /path/to/other/plonky2_tpu_torch/ops/csrc

Builds plonky2_tpu_torch/ops/csrc/ntt.cu as it is ("this"), each source
variant of it in SOURCE_VARIANTS (launch bounds, stage-group size: a text
substitution of this source, for both kernels), and the ntt.cu of
--against ("against", for example a checkout of the parent commit, whose
row kernel is the one-stage-a-barrier design with the entry point
plonky2_row_fft_head and ntt_stage_kernel tail stages), one nvcc each, all
started together. Each library runs the plans of PLAN_VARIANTS
(ops/ntt_cuda.col_plan and row_plan with other arguments). "this" with the
default plans must equal the plain versions ntt._butterflies_rows and
ntt._butterflies at every form of MAIN_PATH_COL_FORMS and
MAIN_PATH_ROW_FORMS, and every other library and plan must equal "this";
then each is timed with CUDA events in two rounds, in turns, at every such
form. Prints the card line and one JSON line: per variant its registers
and spill bytes (ptxas -v), SASS instructions a butterfly (as chip_smoke.py
counts them) and its times, one value a round: ``ms``, a call with every
launch of it, by chip_smoke.device_ms (CUDA events around 20 calls back to
back), and for the row forms ``kernel_ms``, the kernels' own device time a
call, by chip_smoke.kernel_ms (torch.profiler), which leaves out the host's
gaps between launches that ``ms`` holds at small shapes.
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

# (rows, n_log, first_stage, inverse) of every row_fft launch of the
# degree-2^12 PLONK path (build, prove, verify; chip_smoke.py phase
# plonk_inner_2^12), which holds the forms of the degree-2^16 and STARK
# paths, (2, 11, 0, F) and (2, 15, 0, F)
MAIN_PATH_ROW_FORMS = [
    (83, 12, 0, True), (83, 15, 3, False), (143, 12, 0, True), (143, 15, 3, False),
    (20, 12, 0, True), (20, 15, 3, False), (16, 15, 3, False), (2, 15, 0, True),
    (2, 15, 0, False), (2, 11, 0, False),
]

COL_BOUNDS = "#define NTT_COL_THREADS 256\n#define NTT_COL_MIN_BLOCKS 3"
ROW_BOUNDS = "#define NTT_ROW_THREADS 256\n#define NTT_ROW_MIN_BLOCKS 3"
RADIX = "#define NTT_COL_RADIX_LOG 4"


def bounds(which: str, threads: int, blocks: int):
    old = COL_BOUNDS if which == "COL" else ROW_BOUNDS
    return [(old, f"#define NTT_{which}_THREADS {threads}\n#define NTT_{which}_MIN_BLOCKS {blocks}")]


# name -> (substitutions of this source, col_plan arguments or None,
# row_plan arguments or None): the forms of the plans named run
SOURCE_VARIANTS = {
    "col_threads512_blocks1": (bounds("COL", 512, 1), {"threads": 512}, None),
    "col_threads256_blocks2": (bounds("COL", 256, 2), {}, None),
    "radix3": ([(RADIX, "#define NTT_COL_RADIX_LOG 3")], {"radix_log": 3}, {"radix_log": 3}),
    "row_threads512_blocks1": (bounds("ROW", 512, 1), None, {"threads": 512}),
    "row_threads256_blocks2": (bounds("ROW", 256, 2), None, {}),
}
# name -> (substitutions, col_plan, row_plan) of probes: sources that leave
# out part of the work, so their outputs are not the transform and are not
# checked; their times say what the rest of the work costs
PROBES = {
    "probe_no_butterflies": (
        [("radix_stages<G, ZERO_J>(v, S, ZERO_J ? 0 : jt + (ROW ? l : 0) + (jl << a), tw);",
          "")], {}, {}),
}
# name -> (col_plan arguments or None, row_plan arguments or None), run with
# this tree's library on the forms of the plans they name
PLAN_VARIANTS = {
    "col_tile128k": ({"tile_words_log": 14}, None),
    "col_tile32k": ({"tile_words_log": 12}, None),
    "col_threads128": ({"threads": 128}, None),
    "col_split6": ({"split_at": 6}, None),
    "col_one_pass": ({"split_at": 0}, None),
    "row_split6": (None, {"split_at": 6}),
    "row_split9": (None, {"split_at": 9}),
    "row_split11": (None, {"split_at": 11}),
    "row_radix4": (None, {"radix_log": 4}),
    "row_radix2": (None, {"radix_log": 2}),
    "row_tile32k": (None, {"tile_words_log": 12}),
    "row_threads128": (None, {"threads": 128}),
    "row_target_blocks132": (None, {"target_blocks": 132}),
    "row_target_blocks396": (None, {"target_blocks": 396}),
    "row_target_blocks3564": (None, {"target_blocks": 3564}),
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
        lib.plonky2_col_fft_pass.argtypes = [vp, vp, ll] + [i] * 7 + [vp, vp]
        if hasattr(lib, "plonky2_row_fft_pass"):
            lib.plonky2_row_fft_pass.argtypes = [vp, vp, ll] + [i] * 7 + [vp, vp]
        else:
            lib.plonky2_row_fft_head.argtypes = [vp, vp, ll, i, i, i, vp, vp]
        lib.plonky2_ntt_stage.argtypes = [vp, ll, i, i, i, vp, vp]
        out[name] = (lib, text, os.path.join(sources[name], "lib.so"))
    return out


def tail(lib, y, batch, k_log, l_log, first, table, stream) -> None:
    for s in range(first, k_log):
        cuda_build.raise_on(lib.plonky2_ntt_stage(y.data_ptr(), batch, k_log, l_log, s,
                                                  table.data_ptr(), stream), "stage")


def run_col(lib, x, form, plan) -> torch.Tensor:
    """col_fft of x at ``form`` through ``lib`` with col_plan(**plan)."""
    batch, k_log, lanes, first, inverse = form
    l_log = lanes.bit_length() - 1
    table = ntt.stage_table(k_log, inverse, x.device)
    stream = torch.cuda.current_stream().cuda_stream
    y = torch.empty_like(x)
    passes, first_tail = ntt_cuda.col_plan(k_log, l_log, first, **plan)
    src = x
    for p in passes:
        cuda_build.raise_on(lib.plonky2_col_fft_pass(
            src.data_ptr(), y.data_ptr(), batch, k_log, l_log, p.first, p.last,
            p.lanes_log, p.packed_groups(), p.threads,
            table.data_ptr(), stream), "col fft pass")
        src = y
    tail(lib, y, batch, k_log, l_log, first_tail, table, stream)
    return y


def run_row(lib, x, form, plan) -> torch.Tensor:
    """row_fft of x at ``form`` through ``lib``: this tree's passes with
    row_plan(**plan), or (a library without plonky2_row_fft_pass) the
    head-and-tail launches of the other tree's wrapper: whole rows of up to
    2^14 words in shared-memory tiles of at least 2^11 words, then one
    launch a stage."""
    rows, n_log, first, inverse = form
    table = ntt.stage_table(n_log, inverse, x.device)
    stream = torch.cuda.current_stream().cuda_stream
    y = torch.empty_like(x)
    if hasattr(lib, "plonky2_row_fft_pass"):
        passes, first_tail = ntt_cuda.row_plan(rows, n_log, first, **plan)
        src = x
        for p in passes:
            cuda_build.raise_on(lib.plonky2_row_fft_pass(
                src.data_ptr(), y.data_ptr(), p.batch(rows, n_log), p.k_log, p.first, p.last,
                p.lanes_log, p.rows_log, p.packed_groups(), p.threads,
                table.data_ptr(), stream), "row fft pass")
            src = y
    else:
        head_log = min(n_log, 14)
        head_rows = rows << (n_log - head_log)
        r_log = min(max(head_log, 11) - head_log, (head_rows - 1).bit_length())
        cuda_build.raise_on(lib.plonky2_row_fft_head(
            x.data_ptr(), y.data_ptr(), head_rows, head_log, r_log, first,
            table.data_ptr(), stream), "row fft head")
        first_tail = max(first, head_log)
    tail(lib, y, rows, n_log, 0, first_tail, table, stream)
    return y


def run(lib, x, form, plans) -> torch.Tensor:
    """The form's kernel (col forms have five fields, row forms four) with
    its plan's arguments from ``plans`` = (col_plan args, row_plan args)."""
    if len(form) == 5:
        return run_col(lib, x, form, plans[0])
    return run_row(lib, x, form, plans[1])


def plain(x, form) -> torch.Tensor:
    if len(form) == 5:
        _, k_log, _, first, inverse = form
        return ntt._butterflies_rows(x, ntt.stage_roots(k_log, inverse, x.device), first)
    _, n_log, first, inverse = form
    return ntt._butterflies(x, ntt.stage_roots(n_log, inverse, x.device), first)


def bound_ms(form) -> float:
    if len(form) == 5:
        batch, k_log, lanes, first, _ = form
        return cs.butterfly_bound(batch * lanes, k_log, k_log - first)["bound_ms"]
    rows, n_log, first, _ = form
    return cs.butterfly_bound(rows, n_log, n_log - first)["bound_ms"]


def sass_per_butterfly(path: str, cuobjdump: str) -> dict:
    """SASS a butterfly by set-loop form (chip_smoke.ntt_pass_sass); the
    other tree's row kernel runs one butterfly a loop of two loads and
    stores (form G1)."""
    funcs = cs.sass_functions(cs.run_text([cuobjdump, "-sass", path]))
    return {k: v["sass_per_butterfly"] for k, v in cs.ntt_pass_sass(funcs).items()}


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
        # name -> (library, (col_plan args, row_plan args), forms it runs)
        every = MAIN_PATH_COL_FORMS + MAIN_PATH_ROW_FORMS
        plans = {"this": ("this", ({}, {}), every)}

        def forms_of(col, row):
            return (MAIN_PATH_COL_FORMS if col is not None else []) + \
                   (MAIN_PATH_ROW_FORMS if row is not None else [])

        for name, (subs, col, row) in {**SOURCE_VARIANTS, **PROBES}.items():
            text = base
            for old, new in subs:
                if text.count(old) != 1:
                    raise SystemExit(f"variant {name}: the source no longer holds {old!r}")
                text = text.replace(old, new)
            sources[name] = os.path.join(tmp, name)
            write_source(sources[name], text, SRC)
            plans[name] = (name, (col or {}, row or {}), forms_of(col, row))
        for name, (col, row) in PLAN_VARIANTS.items():
            plans[name] = ("this", (col or {}, row or {}), forms_of(col, row))
        if args.against:
            sources["against"] = os.path.join(tmp, "against")
            write_source(sources["against"], open(os.path.join(args.against, "ntt.cu")).read(),
                         args.against)
            plans["against"] = ("against", ({}, {}), every)
        libs = build(sources)
        cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")

        dev = torch.device("cuda")
        rng = np.random.default_rng(11)
        inputs = {}
        for f in every:
            shape = (f[0], 1 << f[1], f[2]) if len(f) == 5 else (f[0], 1 << f[1])
            inputs[f] = cs.with_edges(cs.random_field(rng, shape, dev))
        want = {}
        for f, x in inputs.items():
            want[f] = run(libs["this"][0], x, f, ({}, {}))
            if not torch.equal(want[f], plain(x, f)):
                raise SystemExit(f"this tree's kernel differs from the plain version at {f}")
        res = {}
        for name, (lib_name, plan, forms) in plans.items():
            lib, text, path = libs[lib_name]
            for f in forms:
                if name not in PROBES and not torch.equal(run(lib, inputs[f], f, plan), want[f]):
                    raise SystemExit(f"{name} differs from this tree's kernel at {f}")
            res[name] = {
                "library": lib_name,
                "plan": {"col": plan[0], "row": plan[1]},
                "registers_spills": {
                    k: [v.get("registers"), v.get("spill_store_bytes")]
                    for k, v in cs.ptxas_report(text, cs.NTT_PASS_KERNELS, 256).items()},
                "sass_per_butterfly": sass_per_butterfly(path, cuobjdump),
                "equal_to_this": name not in PROBES,
                "ms": {str(f): [] for f in forms},
                "kernel_ms": {str(f): [] for f in forms if len(f) == 4},
            }
        for _ in range(2):
            for name, (lib_name, plan, forms) in plans.items():
                lib = libs[lib_name][0]
                for f in forms:
                    x = inputs[f]
                    res[name]["ms"][str(f)].append(cs.device_ms(lambda: run(lib, x, f, plan)))
                    if len(f) == 4:  # the row forms, most of them launch-latency class
                        res[name]["kernel_ms"][str(f)].append(
                            cs.kernel_ms(lambda: run(lib, x, f, plan)))
        # a contiguous copy of the same words: what the card's memory gives
        # this much traffic without the strided runs
        copy_ms = {str(f): cs.device_ms(lambda: torch.empty_like(x).copy_(x))
                   for f, x in inputs.items()}
        bound = {str(f): bound_ms(f) for f in every}
        print(cs.card_line(), flush=True)
        print(json.dumps({"ntt_variants": res, "bound_ms": bound, "copy_ms": copy_ms}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Times the Poseidon kernels of this tree against variants of them and,
optionally, against another tree's, on one NVIDIA GPU.

    python3 tools/torch_poseidon_variants.py
    python3 tools/torch_poseidon_variants.py --against /path/to/other/plonky2_tpu_torch/ops/csrc

Builds plonky2_tpu_torch/ops/csrc/poseidon.cu as it is ("this"), each
variant of it listed in VARIANTS (launch bounds, loop unrolling: a text
substitution of this source), and the poseidon.cu of --against ("against",
for example a checkout of the parent commit), one nvcc each, all started
together. Every library must give the same outputs as "this" (permutation
at [2^22, 12], sponge at [2^19, 143], capacity 144); then each is timed with
CUDA events in two rounds, in turns, at those shapes (and the two-to-one
form at [2^22, 8] where the library has it). Prints the card line and one
JSON line: per library its registers and spill bytes (ptxas -v), SASS
instructions a permutation (as chip_smoke.py counts them) and the times.
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
from plonky2_tpu_torch.ops import cuda_build  # noqa: E402

SRC = os.path.join(ROOT, "plonky2_tpu_torch", "ops", "csrc")
BOUNDS = "#define POSEIDON_THREADS 256\n#define POSEIDON_MIN_BLOCKS 2"
PARTIAL = "#pragma unroll 1\n    for (int r = 0; r < POSEIDON_PARTIAL_ROUNDS; ++r) {"
FULL = (
    "#pragma unroll 1\n    for (int round = 0; round < POSEIDON_HALF_FULL_ROUNDS; ++round)",
    "#pragma unroll 1\n    for (int round = POSEIDON_HALF_FULL_ROUNDS + POSEIDON_PARTIAL_ROUNDS;",
)


def bounds(threads: int, blocks: int):
    return [(BOUNDS, f"#define POSEIDON_THREADS {threads}\n#define POSEIDON_MIN_BLOCKS {blocks}")]


# name -> (substitutions of this source, loops of the permutation for the
# SASS count as in chip_smoke.POSEIDON_LOOPS)
VARIANTS = {
    "threads128_blocks4": (bounds(128, 4), cs.PERMUTATION_LOOPS),
    "threads128_blocks6": (bounds(128, 6), cs.PERMUTATION_LOOPS),
    "threads256_blocks1": (bounds(256, 1), cs.PERMUTATION_LOOPS),
    "threads192_blocks2": (bounds(192, 2), cs.PERMUTATION_LOOPS),
    "partial_unroll2": ([(PARTIAL, PARTIAL.replace("unroll 1", "unroll 2"))],
                        [(4, []), (11, []), (4, [])]),
    "partial_unroll_all": ([(PARTIAL, PARTIAL.replace("unroll 1", "unroll"))], [(4, []), (4, [])]),
    "full_unroll2": ([(f, f.replace("unroll 1", "unroll 2")) for f in FULL],
                     [(2, []), (22, []), (2, [])]),
}


def write_source(directory: str, text: str, headers_from: str) -> None:
    os.makedirs(directory)
    for h in ("goldilocks.cuh", "poseidon_constants.cuh"):
        shutil.copy(os.path.join(headers_from, h), directory)
    with open(os.path.join(directory, "poseidon.cu"), "w") as f:
        f.write(text)


def build(sources: dict) -> dict:
    """{name: directory with poseidon.cu} -> {name: (ctypes library, ptxas
    report text, library path)}; one nvcc each, all at once."""
    procs = {}
    for name, d in sources.items():
        cmd = [cuda_build.nvcc(), *cuda_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", d,
               "-o", os.path.join(d, "lib.so"), os.path.join(d, "poseidon.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    out = {}
    for name, p in procs.items():
        text, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{text}")
        lib = ctypes.CDLL(os.path.join(sources[name], "lib.so"))
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.plonky2_poseidon_permute.argtypes = [vp, vp, ll, vp]
        lib.plonky2_poseidon_sponge.argtypes = [vp, vp, ll, ctypes.c_int, ctypes.c_ulonglong, vp]
        if hasattr(lib, "plonky2_poseidon_compress"):
            lib.plonky2_poseidon_compress.argtypes = [vp, vp, ll, vp]
        out[name] = (lib, text, os.path.join(sources[name], "lib.so"))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", default=None,
                    help="csrc directory of another tree (poseidon.cu and its headers)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_poseidon_variants: no CUDA device", file=sys.stderr)
        return 1
    base = open(os.path.join(SRC, "poseidon.cu")).read()
    tmp = tempfile.mkdtemp(prefix="poseidon_variants_")
    try:
        sources = {"this": os.path.join(tmp, "this")}
        write_source(sources["this"], base, SRC)
        loops = {"this": cs.PERMUTATION_LOOPS}
        for name, (subs, var_loops) in VARIANTS.items():
            text = base
            for old, new in subs:
                if text.count(old) != 1:
                    raise SystemExit(f"variant {name}: the source no longer holds {old!r}")
                text = text.replace(old, new)
            sources[name] = os.path.join(tmp, name)
            write_source(sources[name], text, SRC)
            loops[name] = var_loops
        if args.against:
            sources["against"] = os.path.join(tmp, "against")
            write_source(sources["against"], open(os.path.join(args.against, "poseidon.cu")).read(),
                         args.against)
            loops["against"] = cs.PERMUTATION_LOOPS
        libs = build(sources)
        cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")

        dev = torch.device("cuda")
        rng = np.random.default_rng(9)
        x = cs.random_field(rng, (1 << 22, 12), dev)
        pairs = x[:, :8].contiguous()
        rows = cs.random_field(rng, (1 << 19, 143), dev)

        def stream():
            return torch.cuda.current_stream().cuda_stream

        def permute(lib):
            o = torch.empty_like(x)
            lib.plonky2_poseidon_permute(x.data_ptr(), o.data_ptr(), x.shape[0], stream())
            return o

        def compress(lib):
            o = torch.empty((pairs.shape[0], 4), dtype=x.dtype, device=dev)
            lib.plonky2_poseidon_compress(pairs.data_ptr(), o.data_ptr(), pairs.shape[0], stream())
            return o

        def sponge(lib):
            o = torch.empty((rows.shape[0], 4), dtype=x.dtype, device=dev)
            lib.plonky2_poseidon_sponge(rows.data_ptr(), o.data_ptr(), rows.shape[0], 143, 144,
                                        stream())
            return o

        this = libs["this"][0]
        want = (permute(this), sponge(this))
        res = {}
        for name, (lib, text, path) in libs.items():
            report = cs.ptxas_report(text)
            sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                                  check=True).stdout
            funcs = cs.sass_functions(sass)
            code = next(c for n, c in funcs.items() if "poseidon_permute_kernel" in n)
            res[name] = {
                "registers_spills": {k: [v.get("registers"), v.get("spill_store_bytes")]
                                     for k, v in report.items()},
                "sass_per_permutation": cs.sass_dynamic_count(code, loops[name])[0],
                "equal_to_this": bool(torch.equal(permute(lib), want[0])
                                      and torch.equal(sponge(lib), want[1])),
                "permute_2^22_ms": [], "sponge_2^19x143_ms": [], "compress_2^22_ms": [],
            }
            if not res[name]["equal_to_this"]:
                raise SystemExit(f"{name} differs from this tree's kernels")
        for _ in range(2):
            for name, (lib, _, _) in libs.items():
                r = res[name]
                r["permute_2^22_ms"].append(cs.time_ms(lambda: permute(lib), 10, 2))
                r["sponge_2^19x143_ms"].append(cs.time_ms(lambda: sponge(lib), 4, 1))
                if hasattr(lib, "plonky2_poseidon_compress"):
                    r["compress_2^22_ms"].append(cs.time_ms(lambda: compress(lib), 10, 2))
        print(cs.card_line(), flush=True)
        print(json.dumps({"poseidon_variants": res}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

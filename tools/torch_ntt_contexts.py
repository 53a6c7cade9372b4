"""The NTT passes' shared-memory limit is kept per CUDA context, shown
without PyTorch on one card (or on each card); and the host cost of
raising it.

    python3 tools/torch_ntt_contexts.py [--against <other tree>/plonky2_tpu_torch/ops/csrc]
        [--out plonky2_tpu_torch/_build/ntt_contexts]

A function's dynamic shared-memory limit (cudaFuncSetAttribute) belongs to
one context: a second card's, or this card's after cudaDeviceReset, starts
at 48 KB. A program that includes csrc/ntt.cu (and links csrc/poseidon.cu)
launches, through the C entry points the Python bindings call, a column
pass with a 128 KB tile, one with a 64 KB tile and a row pass with a 64 KB
tile, and a batch of Poseidon permutations; then resets the device (a new
primary context: the modules, their __constant__ tables and the function
attributes load anew) and launches the same again on the same inputs. Each
launch's error code is reported, and each output after the reset against
the one before, bit for bit. On a machine with more cards, before the
reset, the same launches run on each other card and their outputs are held
against card 0's. A library that raised the limit once a process refuses
the second context's passes (cudaErrorInvalidValue, 1).

Then, on the fresh context, the host time of one cudaFuncSetAttribute of
col_fft_kernel (the call csrc/ntt.cu makes before every pass; the mean of
100,000) and of one plonky2_col_fft_pass call (the enqueue alone, 64 KB
tile, the mean of 2,000). With --against, the other tree's ntt.cu is built
and run the same way, in its own process (e.g. a parent unpacked by git
archive). Prints one JSON line a tree; exits 1 if this tree's launches
failed or an output differed. Needs a GPU and nvcc, not PyTorch.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "plonky2_tpu_torch", "ops", "csrc")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")

HARNESS = r"""
#include "ntt.cu"

#include <chrono>
#include <cstdio>
#include <vector>

extern "C" int plonky2_poseidon_permute(const void* in, void* out, long long batch,
                                        void* stream);

namespace {
constexpr int kWords = 1 << 14, kTable = 1 << 13, kStates = 1 << 10;

struct Run {
    int errors[4];
    std::vector<uint64_t> outputs[4];
};

uint64_t next(uint64_t& s) {  // splitmix64
    uint64_t z = (s += 0x9E3779B97F4A7C15ULL);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return (z ^ (z >> 31)) % GL_P;
}

// the four launches on device buffers made from the same host words
Run launch_all(const std::vector<uint64_t>& words, const std::vector<uint64_t>& table,
               const std::vector<uint64_t>& states) {
    Run r;
    uint64_t *x, *y, *tw, *st, *out;
    cudaMalloc(&x, kWords * 8);
    cudaMalloc(&y, kWords * 8);
    cudaMalloc(&tw, kTable * 8);
    cudaMalloc(&st, states.size() * 8);
    cudaMalloc(&out, states.size() * 8);
    cudaMemcpy(x, words.data(), kWords * 8, cudaMemcpyHostToDevice);
    cudaMemcpy(tw, table.data(), kTable * 8, cudaMemcpyHostToDevice);
    cudaMemcpy(st, states.data(), states.size() * 8, cudaMemcpyHostToDevice);
    for (int i = 0; i < 4; ++i) {
        cudaMemset(y, 0, kWords * 8);
        size_t n = kWords;
        if (i == 0)  // [1, 2^8, 64]: stages 0-7 in one tile of 2^8 x 64 lanes (128 KB)
            r.errors[i] = plonky2_col_fft_pass(x, y, 1, 8, 6, 0, 8, 6, 0x44, 256, tw, 0);
        else if (i == 1)  // [2, 2^8, 32]: a tile of 2^8 x 32 lanes (64 KB)
            r.errors[i] = plonky2_col_fft_pass(x, y, 2, 8, 5, 0, 8, 5, 0x44, 256, tw, 0);
        else if (i == 2)  // two rows of 2^13 words, stages 0-12 (64 KB)
            r.errors[i] = plonky2_row_fft_pass(x, y, 2, 13, 0, 13, 0, 0, 0x4333, 256, tw, 0);
        else {
            r.errors[i] = plonky2_poseidon_permute(st, out, states.size() / 12, 0);
            n = states.size();
        }
        cudaDeviceSynchronize();
        r.outputs[i].resize(n);
        cudaMemcpy(r.outputs[i].data(), i == 3 ? out : y, n * 8, cudaMemcpyDeviceToHost);
    }
    cudaFree(x);
    cudaFree(y);
    cudaFree(tw);
    cudaFree(st);
    cudaFree(out);
    return r;
}

double seconds_since(std::chrono::steady_clock::time_point t0) {
    return std::chrono::duration<double>(std::chrono::steady_clock::now() - t0).count();
}
}  // namespace

int main() {
    uint64_t seed = 2031;
    std::vector<uint64_t> words(kWords), table(kTable), states(12 * kStates);
    for (auto& w : words) w = next(seed);
    for (auto& w : table) w = next(seed);
    for (auto& w : states) w = next(seed);
    int device = -1, cards = 0;
    cudaGetDeviceCount(&cards);
    cudaSetDevice(0);
    cudaGetDevice(&device);
    const Run first = launch_all(words, table, states);
    std::vector<Run> others;  // the same on each other card, after card 0
    for (int d = 1; d < cards; ++d) {
        cudaSetDevice(d);
        others.push_back(launch_all(words, table, states));
    }
    cudaSetDevice(0);
    const int reset = (int)cudaDeviceReset();
    const Run second = launch_all(words, table, states);

    const int n = 100000;
    auto t0 = std::chrono::steady_clock::now();
    for (int i = 0; i < n; ++i)
        cudaFuncSetAttribute(col_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (1 << NTT_TILE_WORDS_LOG) * (int)sizeof(uint64_t));
    const double attr_us = seconds_since(t0) / n * 1e6;
    uint64_t *x, *y, *tw;
    cudaMalloc(&x, kWords * 8);
    cudaMalloc(&y, kWords * 8);
    cudaMalloc(&tw, kTable * 8);
    cudaMemset(x, 0, kWords * 8);
    cudaMemset(tw, 0, kTable * 8);
    cudaDeviceSynchronize();
    const int m = 2000;
    int pass_err = 0;
    t0 = std::chrono::steady_clock::now();
    for (int i = 0; i < m; ++i)
        pass_err |= plonky2_col_fft_pass(x, y, 2, 8, 5, 0, 8, 5, 0x44, 256, tw, 0);
    const double pass_us = seconds_since(t0) / m * 1e6;
    cudaDeviceSynchronize();

    const char* names[4] = {"col_pass_128KB_tile", "col_pass_64KB_tile", "row_pass_64KB_tile",
                            "poseidon_permute_1024"};
    std::printf("{\"device\": %d, \"cards\": %d, \"reset\": %d, \"launches\": {", device,
                cards, reset);
    for (int i = 0; i < 4; ++i)
        std::printf("%s\"%s\": {\"error_first_context\": %d, \"error_after_reset\": %d, "
                    "\"equal_after_reset\": %s}",
                    i ? ", " : "", names[i], first.errors[i], second.errors[i],
                    first.outputs[i] == second.outputs[i] ? "true" : "false");
    std::printf("}, \"other_cards\": {");
    for (int d = 1; d < cards; ++d) {
        std::printf("%s\"%d\": {", d > 1 ? ", " : "", d);
        for (int i = 0; i < 4; ++i)
            std::printf("%s\"%s\": {\"error\": %d, \"equal_to_card_0\": %s}", i ? ", " : "",
                        names[i], others[d - 1].errors[i],
                        first.outputs[i] == others[d - 1].outputs[i] ? "true" : "false");
        std::printf("}");
    }
    std::printf("}, \"set_attribute_host_us\": %.6f, \"col_fft_pass_call_host_us\": %.6f, "
                "\"col_fft_pass_call_error\": %d}\n", attr_us, pass_us, pass_err);
    return 0;
}
"""


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise SystemExit("nvcc not found: this tool needs the CUDA toolkit")
    return found


def build(csrc: str, out_dir: str) -> subprocess.Popen:
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "harness.cu")
    with open(src, "w") as f:
        f.write(HARNESS)
    cmd = [nvcc(), *ARCH, "-std=c++17", "-O3", "-I", csrc, "-o",
           os.path.join(out_dir, "harness"), src, os.path.join(csrc, "poseidon.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="another tree's plonky2_tpu_torch/ops/csrc")
    ap.add_argument("--out", default=os.path.join(REPO, "plonky2_tpu_torch", "_build",
                                                  "ntt_contexts"))
    args = ap.parse_args()
    trees = {"this_tree": CSRC}
    if args.against:
        trees["against"] = os.path.abspath(args.against)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    builds = {name: build(csrc, os.path.join(args.out, name)) for name, csrc in trees.items()}
    results = {}
    for name, proc in builds.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {trees[name]}:\n{text}")
        done = subprocess.run([os.path.join(args.out, name, "harness")], capture_output=True,
                              text=True, timeout=300)
        try:
            results[name] = json.loads(done.stdout.strip().splitlines()[-1])
        except (IndexError, ValueError):
            results[name] = {"exit": done.returncode, "stdout": done.stdout[-2000:],
                             "stderr": done.stderr[-2000:]}
        print(json.dumps({"tree": name, "csrc": os.path.relpath(trees[name], REPO),
                          **results[name]}), flush=True)
    mine = results["this_tree"]
    ok = "launches" in mine and mine["col_fft_pass_call_error"] == 0 and all(
        r["error_first_context"] == 0 and r["error_after_reset"] == 0 and r["equal_after_reset"]
        for r in mine["launches"].values()) and all(
        r["error"] == 0 and r["equal_to_card_0"]
        for card in mine["other_cards"].values() for r in card.values())
    print(json.dumps({"ntt_contexts": {"ok": ok, "card": card.strip()}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

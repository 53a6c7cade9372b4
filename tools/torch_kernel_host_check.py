"""Run the hand-written CUDA kernels' own source on the host under a memory
checker: AddressSanitizer (every access of device memory, shared memory
and the constant tables) and ThreadSanitizer (races between a block's
threads), where the card's compute-sanitizer cannot run.

    python3 tools/torch_kernel_host_check.py [--tools asan tsan] [--quick]
        [--devices 2] [--build-dir plonky2_tpu_torch/_build/host_check]

Each of csrc/field.cu, ntt.cu and poseidon.cu is compiled by g++ as C++,
unchanged but for three rewrites, behind a stand-in cuda_runtime.h: a
launch ``kernel<<<grid, block, smem, stream>>>(...)`` runs the grid's blocks
in turn, each on ``block`` host threads with a std::barrier for
__syncthreads; ``extern __shared__`` is a heap buffer of exactly the
launch's dynamic shared-memory bytes (0 bytes when a launch asks for none,
so any access of it is caught); the Poseidon file's PTX (carry chains, the
dense MDS, cp.async) is replaced by C with the same results, the cp.async
copies held back until the cp.async.wait_group that waits for them, as on
the card. Every other line, the index math above all, is the source's.

A child process (LD_PRELOAD of the sanitizer's runtime, so that every
tensor torch allocates is a heap block of its own with redzones around
it) points the three bindings (ops/field_cuda.py, ntt_cuda.py,
poseidon_cuda.py) at these libraries and calls the wrappers on CPU
tensors, at every form of chip_smoke.py's fixed lists (phase_kernels'
lists, with the column and row plans' tail stages; the sponge's off-grid
views reach the kernel as aligned copies, so they add no form) and the
[83, 2^16] inverse four-step of a NoopGate 2^16 build;
each output is held bit-exact against the plain version (of a Poseidon
batch of more than 600 rows, its first and last 300 rows), which shows
the emulation ran the kernels' arithmetic as the card does. --quick leaves out
the forms of more than 2^22 words. A sanitizer report ends its child with
the report in the log.

The stand-in runtime has devices (libcudashim.so, one state for the three
libraries and the child's stand-ins of torch.cuda.device and
current_stream): a current device, each kernel's dynamic shared-memory
limit a device (48 KB until cudaFuncSetAttribute raises it there), and
streams that name their device. A launch is refused, as the card refuses
it, on a stream of another device than the current one (error 400) or
asking for more shared memory than its kernel's limit on the current
device (error 1). --devices 2 runs every form three times: on device 0,
on device 1, then with device 0 current and the tensors (CPU tensors
standing for a card's) on device 1. Prints one JSON line a tool, then a
summary line; exits 1 if a tool reported an error, a launch was refused
or an output differed.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "plonky2_tpu_torch", "ops", "csrc")
SOURCES = {"field": "field.cu", "ntt": "ntt.cu", "poseidon": "poseidon.cu"}
# rows at each end of a large Poseidon batch held against the plain version
SAMPLE_ROWS = 300

# The stand-in of cuda_runtime.h: what the three sources use of CUDA.
RUNTIME_H = r"""
#pragma once
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __constant__
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

// the devices' state, kept once in libcudashim.so (SHIM_CPP) for the three
// libraries and the Python stand-ins of torch.cuda
extern "C" {
int shim_set_device(int device);
int shim_get_device(int* device);
int shim_set_attribute(const void* kernel, int attribute, int value);
int shim_launch_check(const void* kernel, size_t smem, cudaStream_t stream);
int shim_last_error();
}

struct uint3_ { unsigned x = 0, y = 0, z = 0; };
struct alignas(16) ulonglong2 { unsigned long long x, y; };

namespace shim {
inline thread_local uint3_ thread_idx, block_idx;
inline uint3_ block_dim, grid_dim;
inline std::barrier<>* block_barrier = nullptr;
inline unsigned char* dyn_smem = nullptr;
inline std::vector<void (*)()> block_start_hooks;

struct Launch {
    unsigned grid, block;
    size_t smem;
    cudaStream_t stream;
    Launch(unsigned g, unsigned b, size_t s, cudaStream_t st)
        : grid(g), block(b), smem(s), stream(st) {}

    // Refused (the error for cudaGetLastError) as the card refuses it: on
    // a stream of another device than the current one, or asking for more
    // dynamic shared memory than the kernel's limit on the current device.
    // Else blocks one after another, each on `block` threads; thread 0
    // makes the block's dynamic shared memory (exactly `smem` bytes)
    // between two barriers and frees it after the block.
    template <class F, class... A>
    void run(F kernel, A... args) {
        if (shim_launch_check(reinterpret_cast<const void*>(kernel), smem, stream)) return;
        block_dim.x = block;
        grid_dim.x = grid;
        std::barrier<> bar((std::ptrdiff_t)block);
        block_barrier = &bar;
        std::vector<std::thread> pool;
        for (unsigned t = 0; t < block; ++t) {
            pool.emplace_back([&, t] {
                thread_idx.x = t;
                for (unsigned b = 0; b < grid; ++b) {
                    if (t == 0) dyn_smem = (unsigned char*)std::malloc(smem);
                    for (auto hook : block_start_hooks) hook();
                    bar.arrive_and_wait();
                    block_idx.x = b;
                    kernel(args...);
                    bar.arrive_and_wait();
                    if (t == 0) std::free(dyn_smem);
                }
            });
        }
        for (auto& th : pool) th.join();
        block_barrier = nullptr;
    }
};
}  // namespace shim

#define threadIdx shim::thread_idx
#define blockIdx shim::block_idx
#define blockDim shim::block_dim
#define gridDim shim::grid_dim

inline void __syncthreads() { shim::block_barrier->arrive_and_wait(); }
template <class T> inline T __ldg(const T* p) { return *p; }
inline uint64_t __umul64hi(uint64_t a, uint64_t b) {
    return (uint64_t)(((unsigned __int128)a * b) >> 64);
}
template <class F>
inline cudaError_t cudaFuncSetAttribute(F kernel, cudaFuncAttribute attribute, int value) {
    return shim_set_attribute(reinterpret_cast<const void*>(kernel), attribute, value);
}
inline cudaError_t cudaGetLastError() { return shim_last_error(); }
inline cudaError_t cudaGetDevice(int* device) { return shim_get_device(device); }
inline cudaError_t cudaSetDevice(int device) { return shim_set_device(device); }
"""

# libcudashim.so: SHIM_DEVICES devices, one current (one host thread drives
# them); each kernel's dynamic shared-memory limit a device (48 KB until
# cudaFuncSetAttribute raises it there, at most 227 KB); streams that name
# their device (shim_stream; 0 is the current device's default stream);
# the launches run on each device; the last launch error.
SHIM_DEVICES = 2
SHIM_CPP = r"""
#include <map>
#include <utility>
#include "cuda_runtime.h"

namespace {
constexpr int kDevices = %d;
constexpr long kDefaultSmem = 48 << 10, kMostSmem = 227 << 10;
constexpr int kInvalidDevice = 101, kInvalidResourceHandle = 400;
int current = 0, last_error = 0;
long launches[kDevices];
std::map<std::pair<int, const void*>, long> smem_limit;
}

extern "C" {
int shim_set_device(int device) {
    if (device < 0 || device >= kDevices) return kInvalidDevice;
    current = device;
    return 0;
}
int shim_get_device(int* device) { *device = current; return 0; }
void* shim_stream(int device) { return (void*)(long)((device + 1) << 8); }
int shim_stream_device(void* stream) {
    return stream ? (int)(((long)stream >> 8) - 1) : current;
}
int shim_set_attribute(const void* kernel, int attribute, int value) {
    if (attribute != cudaFuncAttributeMaxDynamicSharedMemorySize || value < 0 ||
        value > kMostSmem)
        return last_error = cudaErrorInvalidValue;
    smem_limit[{current, kernel}] = value;
    return 0;
}
int shim_launch_check(const void* kernel, size_t smem, cudaStream_t stream) {
    auto it = smem_limit.find({current, kernel});
    const long limit = it == smem_limit.end() ? kDefaultSmem : it->second;
    if (shim_stream_device(stream) != current) return last_error = kInvalidResourceHandle;
    if ((long)smem > limit) return last_error = cudaErrorInvalidValue;
    ++launches[current];
    return 0;
}
int shim_last_error() {
    const int e = last_error;
    last_error = 0;
    return e;
}
long shim_launches(int device) { return launches[device]; }
}
""" % SHIM_DEVICES

# poseidon.cu's functions written in PTX, as C with the same results
POSEIDON_C = {
    "gl_reduce_lazy": r"""
inline uint64_t gl_reduce_lazy(uint64_t lo, uint32_t hl, uint64_t H) {
    uint64_t t0 = lo - H;
    t0 -= lo < H ? 0xffffffffu : 0u;
    uint64_t t1 = ((uint64_t)hl << 32) - hl;
    uint64_t r = t0 + t1;
    return r + (uint64_t)(r < t0) * GL_EPS;
}""",
    "gl_mul_add_lazy": r"""
inline uint64_t gl_mul_add_lazy(uint64_t a, uint64_t b, uint64_t c) {
    unsigned __int128 v = (unsigned __int128)a * b + c;
    return gl_reduce128_lazy((uint64_t)v, (uint64_t)(v >> 64));
}""",
    "gl_add_const_lazy": r"""
inline uint64_t gl_add_const_lazy(uint64_t x, uint64_t c) {
    uint64_t r = x + c;
    return r + (uint64_t)(r < x) * GL_EPS;
}""",
    "acc_mad": r"""
inline void acc_mad(Acc192& acc, uint64_t a, uint64_t b) {
    unsigned __int128 p = (unsigned __int128)a * b;
    unsigned __int128 s = (((unsigned __int128)acc.hi << 64) | acc.lo) + p;
    acc.top += s < p;
    acc.lo = (uint64_t)s;
    acc.hi = (uint64_t)(s >> 64);
}""",
    "poseidon_mds_full": r"""
inline void poseidon_mds_full(uint64_t (&s)[POSEIDON_WIDTH]) {
    constexpr uint32_t circ[POSEIDON_WIDTH] = POSEIDON_MDS_CIRC;
    constexpr uint32_t diag[POSEIDON_WIDTH] = POSEIDON_MDS_DIAG;
    uint32_t lo[POSEIDON_WIDTH], hi[POSEIDON_WIDTH];
    for (int j = 0; j < POSEIDON_WIDTH; ++j) {
        lo[j] = (uint32_t)s[j];
        hi[j] = (uint32_t)(s[j] >> 32);
    }
    for (int r = 0; r < POSEIDON_WIDTH; ++r) {
        uint64_t acc_lo = (uint64_t)lo[r] * (circ[0] + diag[r]);
        uint64_t acc_hi = (uint64_t)hi[r] * (circ[0] + diag[r]);
        for (int j = 0; j < POSEIDON_WIDTH; ++j) {
            if (j == r) continue;
            uint32_t c = circ[(j - r + POSEIDON_WIDTH) % POSEIDON_WIDTH];
            acc_lo += (uint64_t)lo[j] * c;
            acc_hi += (uint64_t)hi[j] * c;
        }
        unsigned __int128 v = (unsigned __int128)acc_lo + ((unsigned __int128)acc_hi << 32);
        unsigned __int128 w = (unsigned __int128)(uint64_t)v + (unsigned __int128)(uint64_t)(v >> 64) * GL_EPS;
        s[r] = (uint64_t)w + (uint64_t)(w >> 64) * GL_EPS;
    }
}""",
    # cp.async: the copy is queued in the thread's open group and made at
    # the cp.async.wait_group that waits for its group (then it reads
    # global memory and writes shared memory), the rest of the 16 bytes
    # zero-filled
    "cp_async16": r"""
struct PendingCopy { void* dst; const void* src; int bytes; };
inline thread_local std::vector<PendingCopy> cp_open;
inline thread_local std::vector<std::vector<PendingCopy>> cp_groups;
inline void cp_async_reset() { cp_open.clear(); cp_groups.clear(); }
inline const bool cp_async_hooked = (shim::block_start_hooks.push_back(cp_async_reset), true);
inline void cp_async16(void* smem, const void* gmem, int bytes) {
    cp_open.push_back({smem, gmem, bytes});
}""",
    "cp_async_commit": r"""
inline void cp_async_commit() {
    cp_groups.push_back(std::move(cp_open));
    cp_open.clear();
}""",
    "cp_async_wait_one": r"""
inline void cp_async_wait_one() {
    while (cp_groups.size() > 1) {
        for (const PendingCopy& c : cp_groups.front()) {
            std::memcpy(c.dst, c.src, c.bytes);
            std::memset((unsigned char*)c.dst + c.bytes, 0, 16 - c.bytes);
        }
        cp_groups.erase(cp_groups.begin());
    }
}""",
}


def replace_function(text: str, name: str, body: str) -> str:
    """The definition of ``name`` (from its __device__ line to its closing
    brace) replaced by ``body``."""
    m = re.search(r"__device__ __forceinline__ [^;{]*?\b" + name + r"\(", text)
    if m is None:
        raise LookupError(f"no definition of {name}")
    depth, i = 0, text.index("{", m.end())
    while True:
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        i += 1
        if depth == 0:
            return text[:m.start()] + body.strip() + text[i:]


def host_source(name: str) -> str:
    """csrc/<name>'s text with the launches, the dynamic shared memory and
    (poseidon.cu) the PTX rewritten for the host."""
    with open(os.path.join(CSRC, name)) as f:
        text = f.read()
    text, launches = re.subn(r"([A-Za-z_]\w*(?:<[^;<>]*>)?)<<<([^;]*?)>>>\(",
                             r"shim::Launch(\2).run(\1, ", text)
    text = re.sub(r"extern __shared__ uint64_t (\w+)\[\];",
                  r"uint64_t* \1 = (uint64_t*)shim::dyn_smem;", text)
    if name == "poseidon.cu":
        for fn, body in POSEIDON_C.items():
            text = replace_function(text, fn, body)
    if launches == 0 or "asm(" in text or "asm volatile" in text:
        raise RuntimeError(f"{name}: the host rewrite left a launch or PTX behind")
    return text


def build(tool: str, build_dir: str) -> dict:
    """g++ of the device state (libcudashim.so) and of each source with the
    sanitizer; {name: library path}, the shim's under "shim"."""
    flag = {"asan": "-fsanitize=address", "tsan": "-fsanitize=thread"}[tool]
    out_dir = os.path.join(build_dir, tool)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "cuda_runtime.h"), "w") as f:
        f.write(RUNTIME_H)
    common = ["g++", "-std=c++20", "-O1", "-g", flag, "-fno-omit-frame-pointer", "-shared",
              "-fPIC", "-pthread", "-Wno-unknown-pragmas", "-I", out_dir]
    shim_src, shim = os.path.join(out_dir, "shim.cpp"), os.path.join(out_dir, "libcudashim.so")
    with open(shim_src, "w") as f:
        f.write(SHIM_CPP)
    done = subprocess.run(common + ["-Wl,-soname,libcudashim.so", "-o", shim, shim_src],
                          capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"g++ failed on the device shim:\n{done.stdout}{done.stderr}")
    procs = {}
    for key, name in SOURCES.items():
        src = os.path.join(out_dir, name.replace(".cu", ".cpp"))
        with open(src, "w") as f:
            f.write(host_source(name))
        lib = os.path.join(out_dir, f"lib{key}.so")
        cmd = common + ["-I", CSRC, "-o", lib, src, "-L", out_dir, "-lcudashim",
                        f"-Wl,-rpath,{out_dir}"]
        procs[key] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {"shim": shim}
    for key, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCES[key]}:\n{text}")
        libs[key] = lib
    return libs


# ---------------------------------------------------------------------------
# The child: the wrappers on CPU tensors, the libraries the host builds
# ---------------------------------------------------------------------------


# the two-device run's phases: (name, current device, the tensors' device)
DEVICE_PHASES = [
    ("device 0", 0, 0),
    ("device 1", 1, 1),
    ("device 0 current, tensors on device 1", 0, 1),
]


def child(libs: dict, quick: bool, devices: int) -> dict:
    import contextlib
    import ctypes
    import types

    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from plonky2_tpu_torch.ops import field_cuda, gf, ntt, ntt_cuda, poseidon as dp
    from plonky2_tpu_torch.ops import poseidon_cuda

    torch.set_num_threads(1)  # no OpenMP threads beside the kernels' (ThreadSanitizer)
    shim = ctypes.CDLL(libs["shim"], mode=ctypes.RTLD_GLOBAL)
    shim.shim_stream.restype = ctypes.c_void_p
    shim.shim_launches.restype = ctypes.c_long
    # the device the CPU tensors stand for: torch.device("cpu") means it
    tensors = {"device": 0}

    def current() -> int:
        d = ctypes.c_int(-1)
        shim.shim_get_device(ctypes.byref(d))
        return d.value

    def index(d) -> int:
        if d is None:
            return current()
        if isinstance(d, int):
            return d
        d = torch.device(d)
        if d.type == "cpu":
            return tensors["device"]
        return current() if d.index is None else d.index

    @contextlib.contextmanager
    def device(d):
        before = current()
        if shim.shim_set_device(index(d)):
            raise RuntimeError(f"no stand-in device {d}")
        try:
            yield
        finally:
            shim.shim_set_device(before)

    torch.cuda.device = device
    torch.cuda.current_stream = lambda d=None: types.SimpleNamespace(
        cuda_stream=shim.shim_stream(index(d)) or 0)

    class HostLibrary:
        def __init__(self, path, functions):
            self.lib = ctypes.CDLL(path)
            for fn, argtypes in functions.items():
                getattr(self.lib, fn).argtypes = argtypes
                getattr(self.lib, fn).restype = ctypes.c_int

        def load(self):
            return self.lib

    for key, m in (("field", field_cuda), ("ntt", ntt_cuda), ("poseidon", poseidon_cuda)):
        m.LIB = HostLibrary(libs[key], m.LIB.functions)
    field_cuda._check = lambda x, what: None
    ntt_cuda._check = lambda x, what: None
    poseidon_cuda._check = lambda x, width, what: None

    cpu = torch.device("cpu")
    rng = np.random.default_rng(2030)
    field = cs.random_field
    cs.random_field = lambda *a: field(*a).clone()  # a torch allocation of its own
    small = (lambda words: not quick or words <= 1 << 22)
    counts, differ, refused = {}, [], []

    def check(kernel, form, run, want):
        """The wrapper's output (``run()``) against the plain version's; a
        launch the stand-in runtime refused is noted with its error."""
        print(f"{kernel} {form}", file=sys.stderr, flush=True)
        counts[kernel] = counts.get(kernel, 0) + 1
        try:
            got = run()
        except RuntimeError as e:
            refused.append({"kernel": kernel, "form": repr(form), "error": str(e)[:160]})
            return
        if not torch.equal(got, want):
            differ.append({"kernel": kernel, "form": repr(form)})

    def sample(x):
        """The rows of x the plain version is run on: all of them, or the
        first and last SAMPLE_ROWS (the first blocks and the last, partial
        one) of a large batch, whose plain hash costs minutes on the CPU."""
        n = x.shape[0]
        if n <= 2 * SAMPLE_ROWS:
            return slice(None)
        return torch.cat([torch.arange(SAMPLE_ROWS), torch.arange(n - SAMPLE_ROWS, n)])

    def other_forms():
        for b in cs.PERMUTE_FIXED:
            if small(12 * b):
                x = cs.edge_rows(rng, b, 12, cpu)
                rows = sample(x)
                check("permute", b, lambda: poseidon_cuda.permute(x)[rows],
                      dp.permute_plain(x[rows]))
                x = cs.edge_rows(rng, b, 8, cpu)
                rows = sample(x)
                check("compress", b, lambda: poseidon_cuda.compress(x)[rows],
                      dp.compress_pairs_plain(x[rows].reshape(-1, 4)))
        for b, w, cap in cs.SPONGE_FIXED:
            x = cs.edge_rows(rng, b, w, cpu)
            rows = sample(x)
            check("sponge", (b, w, cap), lambda: poseidon_cuda.sponge(x, cap)[rows],
                  dp.sponge_plain(x[rows], cap))
        for a, b in cs.mul_forms(rng, cpu):
            check("mul", (tuple(a.shape), a.stride()), lambda: field_cuda.mul(a, b),
                  gf.mul_plain(a, b))

    def ntt_forms():
        for batch, k_log, lanes, first, inverse in cs.COL_FFT_FIXED:
            if small(batch * lanes << k_log):
                x = cs.with_noncanonical(cs.with_edges(
                    cs.random_field(rng, (batch, 1 << k_log, lanes), cpu)))
                want = ntt._butterflies_rows(x, ntt.stage_roots(k_log, inverse, cpu), first)
                check("col_fft", (batch, k_log, lanes, first, inverse),
                      lambda: ntt_cuda.col_fft(x, k_log, first, inverse), want)
        for rows, n_log, first, inverse in cs.ROW_FFT_FIXED:
            if small(rows << n_log):
                x = cs.with_edges(cs.random_field(rng, (rows, 1 << n_log), cpu))
                want = ntt._butterflies(x, ntt.stage_roots(n_log, inverse, cpu), first)
                check("row_fft", (rows, n_log, first, inverse),
                      lambda: ntt_cuda.row_fft(x, n_log, first, inverse), want)
        # the [83, 2^16] inverse four-step: col_fft passes and twiddle
        # products through the emulated kernels (ntt.ifft takes the plain
        # path on a CPU tensor, so its steps are called here as on the card)
        x = cs.random_field(rng, cs.FIRST_IFFT, cpu)
        n_log = cs.FIRST_IFFT[1].bit_length() - 1
        n1_log, n2_log = ntt._split_logs(n_log)

        def four_step():
            y = ntt_cuda.col_fft(ntt._bitrev_rows(x.reshape(-1, 1 << n2_log, 1 << n1_log)),
                                 n2_log, 0, True)
            at, bt, ha, hb = ntt._twiddle_factors_rows(n_log, True, cpu)
            v = y.reshape(-1, 1 << hb, 1 << ha, 1 << n1_log)
            y = field_cuda.mul(field_cuda.mul(v, at[None, :, :]), bt[:, None, :]).reshape(y.shape)
            z = ntt_cuda.col_fft(ntt._bitrev_rows(y.transpose(-1, -2).contiguous()), n1_log, 0,
                                 True)
            return field_cuda.mul(z.reshape(x.shape), pow(cs.FIRST_IFFT[1], cs.P - 2, cs.P))

        check("ifft_83x2^16", cs.FIRST_IFFT, four_step, ntt.ifft(x))

    phases = DEVICE_PHASES[:1] if devices == 1 else DEVICE_PHASES
    done = []
    for name, current_device, tensor_device in phases:
        print(f"phase: {name}", file=sys.stderr, flush=True)
        shim.shim_set_device(current_device)
        tensors["device"] = tensor_device
        counts, differ, refused = {}, [], []
        before = [shim.shim_launches(d) for d in range(SHIM_DEVICES)]
        ntt_forms()
        other_forms()
        done.append({
            "phase": name, "current_device": current_device, "tensor_device": tensor_device,
            "forms_checked": counts, "outputs_differ": differ, "launches_refused": refused,
            "launches_run_by_device": [shim.shim_launches(d) - before[d]
                                       for d in range(SHIM_DEVICES)],
        })
    launches = {m: dict(mod.LAUNCHES) for m, mod in
                (("field", field_cuda), ("ntt", ntt_cuda), ("poseidon", poseidon_cuda))}
    return {"forms_checked": done[0]["forms_checked"],
            "outputs_differ": [d for p in done for d in p["outputs_differ"]],
            "launches_refused": [dict(r, phase=p["phase"]) for p in done
                                 for r in p["launches_refused"]],
            "phases": done, "launches": launches}


def run_tool(tool: str, args) -> dict:
    t0 = time.perf_counter()
    libs = build(tool, args.build_dir)
    runtime = subprocess.run(["g++", f"-print-file-name=lib{tool}.so"], capture_output=True,
                             text=True).stdout.strip()
    env = dict(os.environ)
    env["LD_PRELOAD"] = runtime
    env["ASAN_OPTIONS"] = "detect_leaks=0:halt_on_error=1:abort_on_error=0"
    env["TSAN_OPTIONS"] = "halt_on_error=1:report_signal_unsafe=0"
    env["OMP_NUM_THREADS"] = "1"
    log = os.path.join(args.build_dir, f"{tool}.log")
    cmd = [sys.executable, os.path.abspath(__file__), "--child", json.dumps(libs),
           "--devices", str(args.devices)]
    if args.quick:
        cmd.append("--quick")
    with open(log, "w") as f:
        proc = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT, env=env, cwd=REPO,
                              timeout=args.timeout)
    with open(log, errors="replace") as f:
        text = f.read()
    reports = re.findall(r"(?:ERROR: AddressSanitizer|WARNING: ThreadSanitizer|"
                         r"ERROR: ThreadSanitizer|FATAL: ThreadSanitizer)[^\n]*", text)
    result = None
    for line in text.splitlines():
        if line.startswith('{"forms_checked"'):
            result = json.loads(line)
    return {
        "tool": tool, "exit": proc.returncode, "sanitizer_reports": reports[:10],
        "result": result, "seconds": time.perf_counter() - t0,
        "log": os.path.relpath(log, REPO),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tools", nargs="+", default=["asan", "tsan"], choices=["asan", "tsan"])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--build-dir", default=os.path.join(REPO, "plonky2_tpu_torch", "_build",
                                                        "host_check"))
    ap.add_argument("--devices", type=int, default=1, choices=[1, 2])
    ap.add_argument("--timeout", type=float, default=3600)
    ap.add_argument("--child")
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(json.loads(args.child), args.quick, args.devices)), flush=True)
        return 0
    os.makedirs(args.build_dir, exist_ok=True)
    runs = [run_tool(tool, args) for tool in args.tools]
    for r in runs:
        print(json.dumps(r), flush=True)
    bad = [r["tool"] for r in runs
           if r["exit"] != 0 or r["sanitizer_reports"] or not r["result"]
           or r["result"]["outputs_differ"] or r["result"]["launches_refused"]]
    print(json.dumps({"host_check": {r["tool"]: not (r["tool"] in bad) for r in runs},
                      "quick": args.quick, "devices": args.devices}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

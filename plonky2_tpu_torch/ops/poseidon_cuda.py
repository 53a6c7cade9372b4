"""Build and binding of the hand-written Poseidon kernels (csrc/poseidon.cu).

The sources have a plain C interface and include no PyTorch header, so
``nvcc`` compiles them for ``sm_90a`` in seconds into a shared library
that is loaded with ``ctypes``. The build happens at first use, from the
``.cu``/``.cuh`` files beside this module and nothing else, into
``plonky2_tpu_torch/_build/`` (ignored by git); the library's name
carries a hash of the sources, so an edited source is rebuilt.

Each wrapper checks its tensors, allocates the output, launches on
PyTorch's current stream without synchronising, raises if the launch was
refused, and adds one to its entry of ``LAUNCHES`` — there and nowhere
else, so a caller can show that a run went through the kernels. The
shape of each launch is noted in ``LAUNCH_SHAPES`` at the same place, so
a caller can hold the kernel against its plain version at exactly the
shapes a run gave it.

Nothing here runs at import: the module imports on a machine without a
GPU or ``nvcc``; only a call needs them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from .gf import I64

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = ("poseidon.cu",)
_HEADERS = ("goldilocks.cuh", "poseidon_constants.cuh")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

# launches of each kernel since the process started (or since reset_launches)
LAUNCHES = {"permute": 0, "sponge": 0}
# distinct shapes launched since then: permute B; sponge (B, w, cap_val)
LAUNCH_SHAPES = {"permute": set(), "sponge": set()}

_lib = None
_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LAUNCH_SHAPES[k].clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the Poseidon kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libplonky2_poseidon_{_source_hash()}.so"


def build(verbose: bool = False) -> Path:
    """Compile csrc/poseidon.cu unless an up-to-date library exists.
    Returns the library's path; raises with the compiler's output on
    failure. verbose adds ptxas' register/spill report to the output."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [
        _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-I", str(_CSRC),
    ]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp)] + [str(_CSRC / s) for s in _SOURCES]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            "nvcc failed (%d):\n%s\n%s" % (proc.returncode, proc.stdout, proc.stderr)
        )
    if verbose:
        print(proc.stdout + proc.stderr, flush=True)
    os.replace(tmp, out)  # atomic: concurrent builders agree on the result
    return out


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ll, ull = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_ulonglong
            lib.plonky2_poseidon_permute.argtypes = [vp, vp, ll, vp]
            lib.plonky2_poseidon_permute.restype = ctypes.c_int
            lib.plonky2_poseidon_sponge.argtypes = [vp, vp, ll, ctypes.c_int, ull, vp]
            lib.plonky2_poseidon_sponge.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check(x: torch.Tensor, width, what: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {x.device}")
    if x.dtype != I64:
        raise ValueError(f"{what}: expected int64 (u64 bit container), got {x.dtype}")
    if x.ndim != 2 or (width is not None and x.shape[1] != width) or x.shape[1] < 1:
        raise ValueError(f"{what}: bad shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed, cudaError {err}")


def permute(state: torch.Tensor) -> torch.Tensor:
    """[B, 12] canonical states on the GPU -> their Poseidon permutations."""
    _check(state, 12, "poseidon permute")
    lib = _load()
    out = torch.empty_like(state)
    if state.shape[0] == 0:
        return out
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.plonky2_poseidon_permute(
            state.data_ptr(), out.data_ptr(), state.shape[0], stream
        )
    _raise_on(err, "poseidon permute")
    LAUNCHES["permute"] += 1
    LAUNCH_SHAPES["permute"].add(state.shape[0])
    return out


def sponge(rows: torch.Tensor, cap_val: int) -> torch.Tensor:
    """[B, w] canonical rows on the GPU -> [B, 4] overwrite-mode sponge
    digests with capacity lane 8 preset to cap_val."""
    _check(rows, None, "poseidon sponge")
    lib = _load()
    b, w = rows.shape
    out = torch.empty((b, 4), dtype=I64, device=rows.device)
    if b == 0:
        return out
    cap = int(cap_val) & ((1 << 64) - 1)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.plonky2_poseidon_sponge(
            rows.data_ptr(), out.data_ptr(), b, w, cap, stream,
        )
    _raise_on(err, "poseidon sponge")
    LAUNCHES["sponge"] += 1
    LAUNCH_SHAPES["sponge"].add((b, w, cap))
    return out

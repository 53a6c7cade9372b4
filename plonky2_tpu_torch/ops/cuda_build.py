"""Build and loading of the hand-written CUDA kernels (csrc/*.cu).

Each source has a plain C interface and includes no PyTorch header, so
``nvcc`` compiles it for ``sm_90a`` in seconds into a shared library of
its own, loaded with ``ctypes``. The build happens at first use, from the
``.cu``/``.cuh`` files in csrc/ and nothing else, into
``plonky2_tpu_torch/_build/`` (ignored by git); a library's name carries a
hash of its sources, so an edited source is rebuilt. ``build_all`` starts
one ``nvcc`` a source, all at once, and waits for them together.

The bindings note every launch in ``RECENT_LAUNCHES``, a ring of the last
RING_SIZE launches with each one's kernel and form. An error such as 700
(an illegal address) is sticky and reported asynchronously, at whatever
launch comes after the fault, so ``raise_on`` lists the ring: the launch
that faulted is among them, or is a PyTorch kernel queued between them.

Nothing here runs at import: the module imports on a machine without a
GPU or ``nvcc``; only a call needs them.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

VP = ctypes.c_void_p
LL = ctypes.c_longlong
ULL = ctypes.c_ulonglong
INT = ctypes.c_int


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


class Library:
    """One ``csrc/<source>`` built into one shared library. ``functions``
    maps each C entry point to its argument types; every entry point
    returns an ``int`` (a cudaError_t)."""

    def __init__(self, name: str, source: str, headers: Sequence[str],
                 functions: Dict[str, list]):
        self.name = name
        self.source = source
        self.headers = tuple(headers)
        self.functions = functions
        self._lib = None
        self._lock = threading.Lock()

    def path(self) -> Path:
        h = hashlib.sha256()
        for name in (self.source,) + self.headers:
            h.update(name.encode())
            h.update((CSRC / name).read_bytes())
        h.update(" ".join(ARCH_FLAGS).encode())
        return BUILD_DIR / f"libplonky2_{self.name}_{h.hexdigest()[:16]}.so"

    def _command(self, tmp: Path, verbose: bool) -> list:
        cmd = [
            nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-I", str(CSRC),
        ]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        return cmd + ["-o", str(tmp), str(CSRC / self.source)]

    def build(self, verbose: bool = False) -> Path:
        return build_all([self], verbose=verbose)[self.name][0]

    def load(self) -> ctypes.CDLL:
        if self._lib is not None:
            return self._lib
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                for fn, argtypes in self.functions.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = INT
                self._lib = lib
        return self._lib


def build_all(libraries: Sequence[Library], verbose: bool = False) -> Dict[str, tuple]:
    """Compile every library that has no up-to-date build, one ``nvcc``
    process a source, all started together. Returns {name: (path,
    compiler output)}; raises with the compiler's output on a failure.
    verbose adds ptxas' register/spill report to the output."""
    results = {}
    running = []
    for lib in libraries:
        out = lib.path()
        if out.exists():
            results[lib.name] = (out, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        proc = subprocess.Popen(
            lib._command(tmp, verbose), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        running.append((lib, out, tmp, proc))
    failures = []
    for lib, out, tmp, proc in running:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {lib.source} ({proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)  # atomic: concurrent builders agree on the result
        results[lib.name] = (out, text)
    if failures:
        raise RuntimeError("\n".join(failures))
    return results


# the port's last RING_SIZE kernel launches, oldest first: (kernel, form)
RING_SIZE = 16
RECENT_LAUNCHES = collections.deque(maxlen=RING_SIZE)

# names of the errors a launch of these kernels has been seen to report
CUDA_ERROR_NAMES = {
    1: "cudaErrorInvalidValue", 2: "cudaErrorMemoryAllocation",
    209: "cudaErrorNoKernelImageForDevice", 400: "cudaErrorInvalidResourceHandle",
    700: "cudaErrorIllegalAddress",
    710: "cudaErrorAssert", 719: "cudaErrorLaunchFailure",
}


def check_out(out: torch.Tensor, shape, like: torch.Tensor, what: str) -> torch.Tensor:
    """``out``, a tensor of the caller's that a wrapper writes its result
    into, once it is contiguous, int64, of ``shape`` and on ``like``'s
    device."""
    if (tuple(out.shape) != tuple(shape) or out.dtype != torch.int64
            or out.device != like.device or not out.is_contiguous()):
        raise ValueError(f"{what}: out must be a contiguous int64 tensor of shape "
                         f"{tuple(shape)} on {like.device}, got {tuple(out.shape)} "
                         f"{out.dtype} on {out.device}")
    return out


def note_launch(kernel: str, form) -> None:
    """Adds a launch of ``kernel`` at ``form`` to the ring (before its
    error is checked, so a failed launch is the ring's last entry)."""
    RECENT_LAUNCHES.append((kernel, form))


def reset_launches() -> None:
    RECENT_LAUNCHES.clear()


def raise_on(err: int, what: str) -> None:
    if err != 0:
        name = CUDA_ERROR_NAMES.get(err)
        recent = "; ".join(f"{kernel} {form}" for kernel, form in RECENT_LAUNCHES)
        raise RuntimeError(
            f"{what}: kernel launch failed, cudaError {err}"
            + (f" ({name})" if name else "")
            + f"; the port's last {len(RECENT_LAUNCHES)} launches, oldest first: "
            + (recent or "none")
        )

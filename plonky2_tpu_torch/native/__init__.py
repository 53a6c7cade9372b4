"""Native host runtime: ctypes bindings over host_hash.c (Keccak-f[1600]
+ the width-12 Goldilocks Poseidon permutation).

Compiled on demand with the system C compiler (``cc -O3 -shared -fPIC``)
into ``plonky2_tpu_torch/_build/`` and loaded via ctypes. A library's name
carries a hash of its source, so a stale or foreign build is never loaded;
it is written under a temporary name and renamed into place, so processes
that build at once never load a half-written file. Callers use
``available()`` and fall back to the pure-Python paths when the compiler
or the library is missing — the native layer is an accelerator, never a
requirement. ``PLONKY2_TPU_NATIVE=0`` turns it off.

This is host code, not a device kernel: the verifier's permutation and
the witness fixpoint (iop/witgen_native.py, native/witgen.c) run on the
CPU in every configuration.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parent / "_build"
_SRC = HERE / "host_hash.c"

_lib = None
_lock = threading.Lock()
_failed = False


def build_shared(src: Path, stem: str, opt: str) -> Optional[Path]:
    """Compile ``src`` into ``_build/<stem>-<hash>.so`` unless that file
    exists; the path, or None when the compiler fails."""
    h = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"{stem}-{h}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = os.environ.get("CC", "cc")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            [cc, opt, "-shared", "-fPIC", "-o", tmp, str(src)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, so)
    except Exception:
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def _load():
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        so = build_shared(_SRC, "host_hash", "-O3")
        if so is None:
            _failed = True
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            _failed = True
            return None
        lib.poseidon_init.argtypes = [ctypes.c_void_p] * 3
        lib.poseidon_permute.argtypes = [ctypes.c_void_p]
        lib.poseidon_permute_batch.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.keccak256.argtypes = [
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.c_void_p,
        ]
        from ..hash.poseidon_constants import (
            ALL_ROUND_CONSTANTS,
            MDS_MATRIX_CIRC,
            MDS_MATRIX_DIAG,
        )

        rc = np.array(ALL_ROUND_CONSTANTS, dtype=np.uint64)
        circ = np.array(MDS_MATRIX_CIRC, dtype=np.uint64)
        diag = np.array(MDS_MATRIX_DIAG, dtype=np.uint64)
        # the library copies the tables; the arrays need only outlive the call
        lib.poseidon_init(rc.ctypes.data, circ.ctypes.data, diag.ctypes.data)
        _lib = lib
        return _lib


def available() -> bool:
    if os.environ.get("PLONKY2_TPU_NATIVE", "") == "0":
        return False
    return _load() is not None


def poseidon_permute(state: Sequence[int]) -> List[int]:
    lib = _load()
    arr = np.array([int(x) for x in state], dtype=np.uint64)
    lib.poseidon_permute(arr.ctypes.data)
    return [int(x) for x in arr]


def poseidon_permute_batch(states: np.ndarray) -> np.ndarray:
    """[n, 12] u64 in, permuted out."""
    lib = _load()
    arr = np.ascontiguousarray(states, dtype=np.uint64)
    lib.poseidon_permute_batch(arr.ctypes.data, arr.shape[0])
    return arr


def keccak256(data: bytes) -> bytes:
    lib = _load()
    out = np.zeros(32, dtype=np.uint8)
    lib.keccak256(data, len(data), out.ctypes.data)
    return bytes(out)

"""Device-side Goldilocks field arithmetic on one 64-bit plane.

A field element batch is a ``torch.int64`` tensor used as a *bit
container* for canonical unsigned values < p = 2^64 - 2^32 + 1 (the
CUDA kernels read the same memory as ``uint64_t``). int64 is chosen over
``torch.uint64`` because the latter lacks add / shift / compare on some
builds; with int64

  * wrapping ``+`` and ``*`` give the right low 64 bits,
  * unsigned compare is ``(a ^ MIN) < (b ^ MIN)``,
  * ``>>`` is arithmetic, so a logical shift masks after shifting.

The 64x64 -> 128 product is four 32x32 partial products; the reduction
uses 2^64 = 2^32 - 1 and 2^96 = -1 (mod p) (reference:
field/src/goldilocks_field.rs:380-400 reduce128). All functions take
and return canonical values; bit-exactness against the host numpy
implementation (field/goldilocks.py) is enforced by the tests.

Every function is plain eager torch and runs wherever its inputs live,
except ``mul`` (and what is built on it): on a CUDA tensor it launches the
hand-written product kernel (ops/field_cuda.py, csrc/field.cu); its plain
version ``mul_plain`` serves CPU tensors and the kernel's checks.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field.goldilocks import P
from . import field_cuda

I64 = torch.int64
_M32 = 0xFFFF_FFFF
_MIN = -(1 << 63)


def _s64(v: int) -> int:
    """Python int in [0, 2^64) -> the int64 with the same bits."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= (1 << 63) else v


_P_S = _s64(P)  # p as int64 bits
_P_FLIP = _s64(P) ^ _MIN  # p with the sign bit flipped, for unsigned compares


# ---------------------------------------------------------------------------
# Devices and conversions
# ---------------------------------------------------------------------------


def resolve_device(device=None) -> torch.device:
    """None means the GPU; without one it raises rather than fall back.
    The CPU is used only when asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' explicitly to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def from_u64(x, device) -> torch.Tensor:
    """numpy u64 array (or python ints < 2^64) -> int64 bit-container tensor
    on ``device`` (None = the GPU). Values are not reduced. An upload to a
    GPU goes through a pinned staging copy and does not wait for the
    device, so the host never blocks on work it queued before."""
    a = np.ascontiguousarray(np.asarray(x, dtype=np.uint64))
    t = torch.from_numpy(a.view(np.int64))
    device = resolve_device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def to_u64(a: torch.Tensor) -> np.ndarray:
    return a.detach().cpu().contiguous().numpy().view(np.uint64)


def zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=I64, device=device)


def ones(shape, device) -> torch.Tensor:
    return torch.ones(shape, dtype=I64, device=device)


def full(shape, value: int, device) -> torch.Tensor:
    return torch.full(shape, _s64(value % P), dtype=I64, device=device)


# ---------------------------------------------------------------------------
# Unsigned helpers on the bit container
# ---------------------------------------------------------------------------


def _ult(a, b):
    """a < b as unsigned 64-bit."""
    return (a ^ _MIN) < (b ^ _MIN)


def _uge_p(a):
    """a >= p as unsigned 64-bit."""
    return (a ^ _MIN) >= _P_FLIP


def _hi32(a):
    return (a >> 32) & _M32


def _halves(b):
    """(low 32 bits, high 32 bits) of a tensor or of a python int."""
    if isinstance(b, int):
        return b & _M32, (b >> 32) & _M32
    return b & _M32, _hi32(b)


def canonicalize(a: torch.Tensor) -> torch.Tensor:
    return torch.where(_uge_p(a), a - _P_S, a)


# ---------------------------------------------------------------------------
# Field ops
# ---------------------------------------------------------------------------


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = a + b
    # a carry-out is worth 2^64 = 2^32 - 1 (mod p)
    s = torch.where(_ult(s, a), s + _M32, s)
    return canonicalize(s)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    d = torch.where(_ult(a, b), d - _M32, d)
    return canonicalize(d)


def neg(a: torch.Tensor) -> torch.Tensor:
    return torch.where(a == 0, a, _P_S - a)


def _mul_wide(a, b):
    """64x64 -> 128 as (lo64, hi64) bit containers. b may be a python int
    in [0, 2^64)."""
    a0, a1 = _halves(a)
    b0, b1 = _halves(b)
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    t = _hi32(p00) + (p01 & _M32) + (p10 & _M32)  # < 3 * 2^32
    lo = (p00 & _M32) | (t << 32)
    hi = p11 + _hi32(p01) + _hi32(p10) + (t >> 32)
    return lo, hi


def reduce128(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(lo + 2^64 * hi) mod p, canonical."""
    hi_hi = _hi32(hi)
    hi_lo = hi & _M32
    t0 = lo - hi_hi
    t0 = torch.where(_ult(lo, hi_hi), t0 - _M32, t0)
    t1 = (hi_lo << 32) - hi_lo  # hi_lo * (2^32 - 1), < 2^64
    r = t0 + t1
    r = torch.where(_ult(r, t0), r + _M32, r)
    return canonicalize(r)


def mul(a: torch.Tensor, b) -> torch.Tensor:
    """Product of two canonical batches (broadcasting); ``b`` may also be
    a python int constant. CUDA tensors go to the kernel, CPU tensors to
    ``mul_plain``."""
    if a.is_cuda:
        return field_cuda.mul(a, b)
    return mul_plain(a, b)


def mul_plain(a: torch.Tensor, b) -> torch.Tensor:
    """The plain PyTorch version of ``mul``: the same steps as the
    kernel's gl_mul on the int64 bit container."""
    if isinstance(b, int):
        b %= P
    return reduce128(*_mul_wide(a, b))


def sqr(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def mul_const(a: torch.Tensor, c: int) -> torch.Tensor:
    return mul(a, int(c) % P)


def exp_const(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a static exponent e >= 0 (square and multiply)."""
    result = None
    base = a
    while e:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e:
            base = mul(base, base)
    return torch.ones_like(a) if result is None else result


def inv(a: torch.Tensor) -> torch.Tensor:
    """Elementwise Fermat inverse a^(p-2); 0 maps to 0."""
    return exp_const(a, P - 2)


def batch_inverse(a: torch.Tensor) -> torch.Tensor:
    """Montgomery-trick batch inversion over the flattened tensor, as a
    product tree: pairwise products up, ONE Fermat inverse of the root,
    then inverses pushed back down (inv(x) = inv(x*y) * y). About 3n
    multiplies in 2*log2(n) vector steps. All entries must be nonzero."""
    shape = a.shape
    flat = a.reshape(-1)
    n = flat.shape[0]
    if n == 0:
        return a
    size = 1 << (n - 1).bit_length()
    if size != n:
        flat = torch.cat([flat, torch.ones(size - n, dtype=I64, device=a.device)])
    levels = [flat]
    while levels[-1].shape[0] > 1:
        cur = levels[-1]
        levels.append(mul(cur[0::2], cur[1::2]))
    inv_cur = inv(levels[-1])
    for cur in reversed(levels[:-1]):
        nxt = torch.empty_like(cur)
        nxt[0::2] = mul(inv_cur, cur[1::2])
        nxt[1::2] = mul(inv_cur, cur[0::2])
        inv_cur = nxt
    return inv_cur[:n].reshape(shape)


# ---------------------------------------------------------------------------
# Quadratic extension (D=2, x^2 = 7) — trailing-dim-2 layout
# ---------------------------------------------------------------------------
# An extension batch is a tensor with a trailing dimension 2:
# [..., 0] = c0, [..., 1] = c1. (reference: field/src/extension/quadratic.rs)

_W2 = 7


def ext2_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1 = a[..., 0], a[..., 1]
    b0, b1 = b[..., 0], b[..., 1]
    c0 = add(mul(a0, b0), mul(mul(a1, b1), _W2))
    c1 = add(mul(a0, b1), mul(a1, b0))
    return torch.stack([c0, c1], dim=-1)


def ext2_add(a, b):
    return add(a, b)  # componentwise


def ext2_sub(a, b):
    return sub(a, b)


def ext2_scalar_mul(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Multiply extension batch by base-field batch (broadcast over last dim)."""
    return mul(a, s[..., None])


def ext2_const(c, device) -> torch.Tensor:
    """Host extension tuple -> shape-(2,) tensor."""
    return from_u64(np.asarray([int(c[0]), int(c[1])], dtype=np.uint64), device)


# ---------------------------------------------------------------------------
# Reductions and scans
# ---------------------------------------------------------------------------


def sum_mod_p(a: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Sum canonical field elements along an axis, exactly mod p.

    The 32-bit halves are summed separately in int64 (exact for axis
    lengths < 2^31), recombined into a 128-bit value and reduced once."""
    assert a.shape[axis] < (1 << 31)
    s_lo = torch.sum(a & _M32, dim=axis)  # < 2^63
    s_hi = torch.sum(_hi32(a), dim=axis)  # < 2^63
    return reduce_halves(s_lo, s_hi)


def reduce_halves(s_lo: torch.Tensor, s_hi: torch.Tensor) -> torch.Tensor:
    """(s_lo + 2^32 * s_hi) mod p, canonical, for s_lo, s_hi in [0, 2^63):
    sums of the 32-bit halves of field elements, or small-integer
    combinations of them."""
    shifted = s_hi << 32
    lo = s_lo + shifted
    carry = _ult(lo, shifted).to(I64)
    hi = _hi32(s_hi) + carry
    return reduce128(lo, hi)


def weighted_sum(polys: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """sum_i weights[i] * polys[i] over the leading axis, exactly mod p.
    polys: [M, ...]; weights: [M]."""
    w = weights.reshape((-1,) + (1,) * (polys.ndim - 1))
    return sum_mod_p(mul(polys, w), axis=0)


def prod_mod_p(a: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Product along an axis via log-depth pairwise folding (exact)."""
    a = torch.movedim(a, axis, 0)
    n = a.shape[0]
    while n > 1:
        half = n // 2
        folded = mul(a[:half], a[half : 2 * half])
        a = torch.cat([folded, a[2 * half :]]) if n % 2 else folded
        n = a.shape[0]
    return a[0]


def powers_scan(x: torch.Tensor, n: int) -> torch.Tensor:
    """[1, x, x^2, ..., x^{n-1}] by doubling; x: 0-dim tensor."""
    out = torch.ones(1, dtype=I64, device=x.device)
    step = x.reshape(())  # x^len(out)
    while out.shape[0] < n:
        out = torch.cat([out, mul(out, step)])
        step = mul(step, step)
    return out[:n]


def ext2_powers_scan(z: torch.Tensor, n: int) -> torch.Tensor:
    """[1, z, ..., z^{n-1}] over the D=2 extension as [n, 2]; z: shape (2,)."""
    out = ext2_const((1, 0), z.device)[None, :]
    step = z.reshape(1, 2)
    while out.shape[0] < n:
        out = torch.cat([out, ext2_mul(out, step)])
        step = ext2_mul(step, step)
    return out[:n]


def ext2_affine_suffix_scan_z(coeffs: torch.Tensor, zc: torch.Tensor) -> torch.Tensor:
    """Synthetic-division helper: for extension coefficients [N, 2] and an
    extension point z (shape (2,)), the Horner prefix values over the
    reversed coefficients, s_k = z*s_{k-1} + c_{N-1-k}, as [N, 2].

    s_k = sum_{j<=k} z^(k-j) r_j with r the reversed coefficients, so a
    doubling scan does it in log2(N) steps: s[d:] += z^d * s[:-d]
    (reference: field/src/polynomial/division.rs:75-88 divide_by_linear)."""
    s = torch.flip(coeffs, dims=(0,))
    n = s.shape[0]
    zd = zc.reshape(1, 2)
    d = 1
    while d < n:
        s = torch.cat([s[:d], add(s[d:], ext2_mul(s[:-d], zd))])
        zd = ext2_mul(zd, zd)
        d <<= 1
    return s


def ext2_affine_suffix_scan(coeffs: torch.Tensor, z) -> torch.Tensor:
    """Same, with the point as a host extension tuple."""
    return ext2_affine_suffix_scan_z(coeffs, ext2_const(z, coeffs.device))

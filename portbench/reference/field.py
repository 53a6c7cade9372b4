"""Goldilocks arithmetic for the plain reference: p = 2^64 - 2^32 + 1, its
quadratic extension F[X]/(X^2 - 7), and radix-2 transforms.

Host values are Python ints. Device values are torch.int64 tensors used as
64-bit containers of canonical values < p: int64 addition and
multiplication wrap, so they give the right low 64 bits, and unsigned
order is read by flipping the sign bit. A 64 x 64 product is four
32 x 32 partial products, reduced with 2^64 = 2^32 - 1 and 2^96 = -1
(mod p). Extension values on the device are pairs (c0, c1) of tensors.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

P = 0xFFFF_FFFF_0000_0001
W = 7  # X^2 = 7 in the extension
MULTIPLICATIVE_GENERATOR = 14293326489335486720
TWO_ADIC_GENERATOR = 7277203076849721926  # of the 2^32-element subgroup
TWO_ADICITY = 32
M32 = 0xFFFF_FFFF
EPS = 0xFFFF_FFFF  # 2^64 mod p
_MIN = -(1 << 63)

Ext = Tuple[int, int]


def s64(v: int) -> int:
    """An int in [0, 2^64) as the int64 with the same bits."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= (1 << 63) else v


_P_S = s64(P)
_P_FLIP = _P_S ^ _MIN


# ---------------------------------------------------------------------------
# host scalars
# ---------------------------------------------------------------------------


def inv(a: int) -> int:
    assert a % P, "inverse of zero"
    return pow(a, P - 2, P)


def root_of_unity(n_log: int) -> int:
    return pow(TWO_ADIC_GENERATOR, 1 << (TWO_ADICITY - n_log), P)


def ext_add(a: Ext, b: Ext) -> Ext:
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def ext_sub(a: Ext, b: Ext) -> Ext:
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def ext_mul(a: Ext, b: Ext) -> Ext:
    return ((a[0] * b[0] + W * a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def ext_scale(a: Ext, s: int) -> Ext:
    return (a[0] * s % P, a[1] * s % P)


def ext_pow(a: Ext, e: int) -> Ext:
    out, base = (1, 0), a
    while e:
        if e & 1:
            out = ext_mul(out, base)
        base = ext_mul(base, base)
        e >>= 1
    return out


def ext_inv(a: Ext) -> Ext:
    norm = (a[0] * a[0] - W * a[1] * a[1]) % P
    n_inv = inv(norm)
    return (a[0] * n_inv % P, (-a[1]) * n_inv % P)


# ---------------------------------------------------------------------------
# device base field
# ---------------------------------------------------------------------------


def to_tensor(values, device) -> torch.Tensor:
    """numpy uint64 array or list of ints -> int64 container tensor."""
    import numpy as np

    a = np.ascontiguousarray(np.asarray(values, dtype=np.uint64)).view(np.int64)
    return torch.from_numpy(a.copy()).to(device)


def to_ints(t: torch.Tensor) -> List[int]:
    return [v & ((1 << 64) - 1) for v in t.reshape(-1).tolist()]


def const(v: int, device) -> torch.Tensor:
    return torch.tensor(s64(v % P), dtype=torch.int64, device=device)


def ult(a, b):
    return (a ^ _MIN) < (b ^ _MIN)


def canon(a: torch.Tensor) -> torch.Tensor:
    return torch.where((a ^ _MIN) >= _P_FLIP, a - _P_S, a)


def add_raw(a, b):
    """a + b, congruent mod p and below 2^64 but maybe not below p (a may
    be any 64-bit value, b canonical)."""
    s = a + b
    return torch.where(ult(s, a), s + EPS, s)


def add(a, b):
    return canon(add_raw(a, b))


def sub(a, b):
    d = a - b
    return torch.where(ult(a, b), d - EPS, d)


def reduce128_raw(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(hi * 2^64 + lo) mod p, below 2^64 but maybe not below p."""
    hi_hi = (hi >> 32) & M32
    hi_lo = hi & M32
    t0 = lo - hi_hi
    t0 = torch.where(ult(lo, hi_hi), t0 - EPS, t0)
    t1 = hi_lo * EPS
    t2 = t0 + t1
    return torch.where(ult(t2, t1), t2 + EPS, t2)


def reduce128(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    return canon(reduce128_raw(lo, hi))


def mul_raw(a, b):
    """a * b for any 64-bit a, b: congruent mod p, below 2^64."""
    a0, a1 = a & M32, (a >> 32) & M32
    b0, b1 = b & M32, (b >> 32) & M32
    ll, lh, hl, hh = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = lh + hl
    mid_carry = ult(mid, lh).to(torch.int64)
    lo = ll + (mid << 32)
    lo_carry = ult(lo, ll).to(torch.int64)
    hi = hh + ((mid >> 32) & M32) + (mid_carry << 32) + lo_carry
    return reduce128_raw(lo, hi)


def sqr_raw(a):
    """a * a as mul_raw, with one cross product."""
    a0, a1 = a & M32, (a >> 32) & M32
    ll, lh, hh = a0 * a0, a0 * a1, a1 * a1
    mid = lh << 1
    mid_carry = (lh >> 63) & 1
    lo = ll + (mid << 32)
    lo_carry = ult(lo, ll).to(torch.int64)
    hi = hh + ((mid >> 32) & M32) + (mid_carry << 32) + lo_carry
    return reduce128_raw(lo, hi)


def mul(a, b):
    return canon(mul_raw(a, b))


def pow_const(a: torch.Tensor, e: int) -> torch.Tensor:
    out = torch.ones_like(a)
    base = a
    while e:
        if e & 1:
            out = mul(out, base)
        base = mul(base, base)
        e >>= 1
    return out


def inverse(a: torch.Tensor) -> torch.Tensor:
    """Elementwise a^(p - 2); a holds no zero."""
    return pow_const(a, P - 2)


def powers(x: int, n: int, device) -> torch.Tensor:
    """[1, x, ..., x^(n-1)] by doubling."""
    t = torch.ones(1, dtype=torch.int64, device=device)
    step = x % P
    while t.shape[0] < n:
        t = torch.cat([t, mul(t, const(step, device))])
        step = step * step % P
    return t[:n]


def field_sum(a: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum mod p along ``dim``: the 32-bit halves are summed in int64
    (exact below 2^31 terms) and recombined."""
    lo = (a & M32).sum(dim)
    hi = ((a >> 32) & M32).sum(dim)  # value = lo + hi * 2^32
    low64 = lo + ((hi & M32) << 32)
    carry = ult(low64, lo).to(torch.int64)
    return reduce128(low64, (hi >> 32) + carry)


def field_cumsum(a: torch.Tensor) -> torch.Tensor:
    """Prefix sums mod p along the last axis, as field_sum."""
    lo = (a & M32).cumsum(-1)
    hi = ((a >> 32) & M32).cumsum(-1)
    low64 = lo + ((hi & M32) << 32)
    carry = ult(low64, lo).to(torch.int64)
    return reduce128(low64, (hi >> 32) + carry)


# ---------------------------------------------------------------------------
# device extension field: pairs (c0, c1)
# ---------------------------------------------------------------------------


def e_add(a, b):
    return add(a[0], b[0]), add(a[1], b[1])


def e_sub(a, b):
    return sub(a[0], b[0]), sub(a[1], b[1])


def e_mul(a, b):
    c0 = add(mul(a[0], b[0]), mul(const(W, a[0].device), mul(a[1], b[1])))
    c1 = add(mul(a[0], b[1]), mul(a[1], b[0]))
    return c0, c1


def e_scale(a, s):
    """Extension tensor pair times a base tensor."""
    return mul(a[0], s), mul(a[1], s)


def e_const(v: Ext, device):
    return const(v[0], device), const(v[1], device)


def e_powers(x: Ext, n: int, device):
    """Pair of [n] tensors: the extension powers 1, x, ..., x^(n-1)."""
    t = (torch.ones(1, dtype=torch.int64, device=device),
         torch.zeros(1, dtype=torch.int64, device=device))
    step = x
    while t[0].shape[0] < n:
        nxt = e_mul(t, e_const(step, device))
        t = (torch.cat([t[0], nxt[0]]), torch.cat([t[1], nxt[1]]))
        step = ext_mul(step, step)
    return t[0][:n], t[1][:n]


# ---------------------------------------------------------------------------
# transforms over [..., N], natural order in and out
# ---------------------------------------------------------------------------


def bit_reverse_indices(n_log: int, device) -> torch.Tensor:
    i = torch.arange(1 << n_log, dtype=torch.int64, device=device)
    r = torch.zeros_like(i)
    for b in range(n_log):
        r |= ((i >> b) & 1) << (n_log - 1 - b)
    return r


def _fft(x: torch.Tensor, root: int) -> torch.Tensor:
    """Iterative radix-2 DIT: values at root^i of the polynomial with
    coefficients x (last axis), root a primitive N-th root."""
    n = x.shape[-1]
    n_log = n.bit_length() - 1
    assert 1 << n_log == n
    lead = x.shape[:-1]
    x = x[..., bit_reverse_indices(n_log, x.device)]
    table = powers(root, max(n // 2, 1), x.device)
    m = 1
    while m < n:
        tw = table[:: n // (2 * m)][:m]  # root^(N/2m * j): the 2m-th roots
        y = x.reshape(*lead, n // (2 * m), 2, m)
        u, v = y[..., 0, :], mul(y[..., 1, :], tw)
        x = torch.stack([add(u, v), sub(u, v)], dim=-2).reshape(*lead, n)
        m *= 2
    return x


def fft(coeffs: torch.Tensor) -> torch.Tensor:
    n_log = coeffs.shape[-1].bit_length() - 1
    return _fft(coeffs, root_of_unity(n_log))


def ifft(values: torch.Tensor) -> torch.Tensor:
    n = values.shape[-1]
    n_log = n.bit_length() - 1
    out = _fft(values, inv(root_of_unity(n_log)))
    return mul(out, const(inv(n), values.device))


def coset_fft(coeffs: torch.Tensor, shift: int) -> torch.Tensor:
    """Values at shift * w^i of the polynomial (w the N-th root)."""
    return fft(mul(coeffs, powers(shift, coeffs.shape[-1], coeffs.device)))


def coset_ifft(values: torch.Tensor, shift: int) -> torch.Tensor:
    return mul(ifft(values), powers(inv(shift), values.shape[-1], values.device))


def eval_base_at_ext(coeffs: torch.Tensor, z_powers) -> List[Ext]:
    """Every polynomial of coeffs [M, n] at an extension point, given the
    pair of [n] power tables of the point."""
    c0 = field_sum(mul(coeffs, z_powers[0]), -1)
    c1 = field_sum(mul(coeffs, z_powers[1]), -1)
    return list(zip(to_ints(c0), to_ints(c1)))

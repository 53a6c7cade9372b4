"""Host-side Goldilocks field arithmetic: exact Python-int scalars and
vectorized numpy-u64 routines.

The Goldilocks prime is p = 2^64 - 2^32 + 1. All host values are kept
*canonical* (in [0, p)), unlike the reference which allows transient
non-canonical representations (reference: field/src/goldilocks_field.rs:13-310).
The device kernels in ``ops.gf`` implement the same algorithms on
u32 limb planes and are tested for bit-exact agreement with this module.

Capability parity notes (reference file:line):
  - constants: field/src/goldilocks_field.rs:80-91,202
  - reduce128 two-step reduction: field/src/goldilocks_field.rs:340-438
  - batch inverse (Montgomery trick): field/src/types.rs:186-220
  - roots of unity / subgroups: field/src/types.rs:400-460
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Constants
# ---------------------------------------------------------------------------

P = 0xFFFF_FFFF_0000_0001  # 2^64 - 2^32 + 1
EPSILON = 0xFFFF_FFFF  # 2^32 - 1 == 2^64 mod P
MASK64 = 0xFFFF_FFFF_FFFF_FFFF
TWO_ADICITY = 32
CHARACTERISTIC_TWO_ADICITY = TWO_ADICITY
MULTIPLICATIVE_GROUP_GENERATOR = 14293326489335486720
POWER_OF_TWO_GENERATOR = 7277203076849721926

# ---------------------------------------------------------------------------
# Scalar ops (exact Python ints; used by builder/transcript/verifier)
# ---------------------------------------------------------------------------


def gadd(a: int, b: int) -> int:
    s = a + b
    return s - P if s >= P else s


def gsub(a: int, b: int) -> int:
    d = a - b
    return d + P if d < 0 else d


def gneg(a: int) -> int:
    # gsub form keeps this traceable by the witgen tracer (symbolic a);
    # numpy integer scalars are concrete — coerce so 0 - np.uint64 never
    # wraps mod 2^64
    if isinstance(a, (int, np.integer)):
        a = int(a)
        return 0 if a == 0 else P - a
    return gsub(0, a)


def gmul(a: int, b: int) -> int:
    return (a * b) % P


def gexp(base: int, e: int) -> int:
    return pow(base, e, P)


def ginv(a: int) -> int:
    # isinstance guard: under the witgen tracer a is symbolic and the
    # zero check is data-dependent (the engine's INV0 maps 0 -> 0);
    # numpy integer scalars are concrete and must hit the zero check
    if isinstance(a, (int, np.integer)):
        a = int(a)
        if a == 0:
            raise ZeroDivisionError("inverse of zero in Goldilocks field")
    return pow(a, P - 2, P)


def gdiv(a: int, b: int) -> int:
    return gmul(a, ginv(b))


def from_noncanonical_u64(x: int) -> int:
    x &= MASK64
    return x - P if x >= P else x


def primitive_root_of_unity(n_log: int) -> int:
    """2^n_log-th root of unity (reference: field/src/types.rs:414)."""
    assert 0 <= n_log <= TWO_ADICITY
    return gexp(POWER_OF_TWO_GENERATOR, 1 << (TWO_ADICITY - n_log))


def two_adic_subgroup(n_log: int) -> np.ndarray:
    """All 2^n_log-th roots of unity, in power order, as numpy u64."""
    g = primitive_root_of_unity(n_log)
    return np_powers(g, 1 << n_log)


def coset_shift() -> int:
    """Shift for the degree-8 LDE coset: the multiplicative group generator."""
    return MULTIPLICATIVE_GROUP_GENERATOR


def exp_power_of_2(base: int, power_log: int) -> int:
    r = base
    for _ in range(power_log):
        r = gmul(r, r)
    return r


# ---------------------------------------------------------------------------
# Vectorized numpy-u64 ops
#
# numpy uint64 arithmetic wraps mod 2^64, which we exploit: 64x64->128
# multiplication splits operands into 32-bit halves whose partial products fit
# in u64 exactly; the 2-step Goldilocks reduction then mirrors
# goldilocks_field.rs:340-438 with wrapping semantics, followed by an explicit
# canonicalization.
# ---------------------------------------------------------------------------

_U64 = np.uint64
_M32 = _U64(0xFFFF_FFFF)
_NP_P = _U64(P)
_NP_EPS = _U64(EPSILON)


def _as_u64(x) -> np.ndarray:
    return np.asarray(x, dtype=_U64)


def np_canonicalize(x) -> np.ndarray:
    x = _as_u64(x)
    with np.errstate(over="ignore"):
        return np.where(x >= _NP_P, x - _NP_P, x)


def np_add(a, b) -> np.ndarray:
    a, b = _as_u64(a), _as_u64(b)
    with np.errstate(over="ignore"):
        s = a + b
        carry = s < a
        s = s + carry.astype(_U64) * _NP_EPS
        return np.where(s >= _NP_P, s - _NP_P, s)


def np_sub(a, b) -> np.ndarray:
    a, b = _as_u64(a), _as_u64(b)
    with np.errstate(over="ignore"):
        d = a - b
        borrow = a < b
        d = d - borrow.astype(_U64) * _NP_EPS
        return np.where(d >= _NP_P, d - _NP_P, d)


def np_neg(a) -> np.ndarray:
    a = _as_u64(a)
    with np.errstate(over="ignore"):
        return np.where(a == 0, a, _NP_P - a)


def _np_mul_wide(a, b):
    """64x64 -> 128-bit product as (lo64, hi64), u64 arrays."""
    with np.errstate(over="ignore"):
        a_lo = a & _M32
        a_hi = a >> _U64(32)
        b_lo = b & _M32
        b_hi = b >> _U64(32)
        ll = a_lo * b_lo
        lh = a_lo * b_hi
        hl = a_hi * b_lo
        hh = a_hi * b_hi
        # bits 32..63 plus carries; each term < 2^32 so the sum fits in u64
        t = (ll >> _U64(32)) + (lh & _M32) + (hl & _M32)
        lo = (ll & _M32) | ((t & _M32) << _U64(32))
        hi = (t >> _U64(32)) + (lh >> _U64(32)) + (hl >> _U64(32)) + hh
        return lo, hi


def _np_reduce128(lo, hi):
    """Goldilocks reduction of a 128-bit value (goldilocks_field.rs:380-400)."""
    with np.errstate(over="ignore"):
        x_hi_hi = hi >> _U64(32)
        x_hi_lo = hi & _M32
        t0 = lo - x_hi_hi
        borrow = lo < x_hi_hi
        t0 = t0 - borrow.astype(_U64) * _NP_EPS
        t1 = x_hi_lo * _NP_EPS
        res = t0 + t1
        carry = res < t1
        res = res + carry.astype(_U64) * _NP_EPS
        return np.where(res >= _NP_P, res - _NP_P, res)


def np_mul(a, b) -> np.ndarray:
    a, b = _as_u64(a), _as_u64(b)
    lo, hi = _np_mul_wide(a, b)
    return _np_reduce128(lo, hi)


def np_sqr(a) -> np.ndarray:
    return np_mul(a, a)


def np_powers(base: int, n: int) -> np.ndarray:
    """[1, base, base^2, ..., base^(n-1)] via log-doubling."""
    if n == 0:
        return np.empty(0, dtype=_U64)
    out = np.empty(n, dtype=_U64)
    out[0] = 1
    filled = 1
    cur = _U64(base % P)
    while filled < n:
        take = min(filled, n - filled)
        out[filled : filled + take] = np_mul(out[:take], cur)
        filled += take
        if filled < n:
            cur = np_mul(cur, cur)
    return out


def np_exp(base, e: int) -> np.ndarray:
    """Elementwise base^e for a fixed integer exponent e >= 0."""
    base = _as_u64(base)
    result = np.ones_like(base)
    while e:
        if e & 1:
            result = np_mul(result, base)
        base = np_mul(base, base)
        e >>= 1
    return result


def np_inv(a) -> np.ndarray:
    """Elementwise inverse via Fermat: a^(p-2). Zero maps to zero."""
    return np_exp(_as_u64(a), P - 2)


def np_batch_inverse(a) -> np.ndarray:
    """Montgomery batch inversion; requires all entries nonzero.

    Reference: field/src/types.rs `batch_multiplicative_inverse`.
    Uses sequential prefix products computed by log-doubling passes.
    """
    a = _as_u64(a)
    flat = a.reshape(-1)
    n = flat.shape[0]
    if n == 0:
        return a
    # prefix[i] = a[0]*...*a[i], suffix[i] = a[i]*...*a[n-1], both via
    # Hillis-Steele scans (log n passes of np_mul)
    prefix = flat.copy()
    suffix = flat.copy()
    shift = 1
    while shift < n:
        prefix[shift:] = np_mul(prefix[shift:], prefix[:-shift])
        suffix[:-shift] = np_mul(suffix[:-shift], suffix[shift:])
        shift <<= 1
    total_inv = np_inv(prefix[-1:])[0]
    # inv[i] = prefix[i-1] * suffix[i+1] * total_inv
    inv = np.full_like(flat, total_inv)
    inv[1:] = np_mul(inv[1:], prefix[:-1])
    inv[:-1] = np_mul(inv[:-1], suffix[1:])
    return inv.reshape(a.shape)


def gsqrt(a: int):
    """Square root via Tonelli-Shanks (None if a is a non-residue);
    reference: field/src/types.rs sqrt via exp/two-adicity."""
    a %= P
    if a == 0:
        return 0
    if pow(a, (P - 1) // 2, P) != 1:
        return None
    # p - 1 = q * 2^s with s = 32
    s = TWO_ADICITY
    q = (P - 1) >> s
    z = POWER_OF_TWO_GENERATOR  # generator of the 2-Sylow subgroup
    m = s
    c = pow(z, 1, P)
    c = z % P
    t = pow(a, q, P)
    r = pow(a, (q + 1) // 2, P)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2 = t2 * t2 % P
            i += 1
        b = pow(c, 1 << (m - i - 1), P)
        m = i
        c = b * b % P
        t = t * c % P
        r = r * b % P
    return r

"""Batched NTT / LDE over Goldilocks on device.

Layout: a polynomial batch is an int64 bit-container tensor
``[num_polys, N]`` (ops/gf.py). One transform serves every size: an
iterative radix-2 DIT (bit-reverse, then log2(N) butterfly passes over
reshaped views), batched over the leading dimensions, in plain torch ops.

Reference capability: field/src/fft.rs (fft/ifft, per-stage root tables,
coset fft, LDE). The reference's ``zero_factor`` trick (skipping the
first ``rate_bits`` stages of a zero-padded LDE input) is implemented by
*seeding* the DIT at a coarser stage: the first r stages of a DIT on
input whose nonzero coefficients all sit in the low N slots only copy,
so the bit-reversed base array is replicated across the 2^r sub-lattices
instead of running those stages (see lde_onto_coset).

Fiat–Shamir contract: ``fft(coeffs)[i] = poly(g^i)`` with g the
canonical 2^k-th root (POWER_OF_TWO_GENERATOR lineage), natural order.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..field import goldilocks as gl
from ..utils.bits import log2_strict
from . import gf
from .bitrev import bitrev_axis

# ---------------------------------------------------------------------------
# Twiddle tables (host-computed once per size, cached per device)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _stage_roots_np(n_log: int, inverse: bool) -> tuple:
    """Per-stage twiddle tables for DIT butterflies. Stage s pairs lanes
    j and j+2^s within blocks of 2^(s+1); the twiddle for offset j is
    w_s^j with w_s the primitive 2^(s+1)-th root (or its inverse)."""
    tables = []
    for s in range(n_log):
        w = gl.primitive_root_of_unity(s + 1)
        if inverse:
            w = gl.ginv(w)
        tables.append(gl.np_powers(w, 1 << s))
    return tuple(tables)


_DEVICE_TABLES = {}


def stage_roots(n_log: int, inverse: bool, device) -> tuple:
    key = ("roots", n_log, inverse, str(device))
    if key not in _DEVICE_TABLES:
        _DEVICE_TABLES[key] = tuple(
            gf.from_u64(t, device) for t in _stage_roots_np(n_log, inverse)
        )
    return _DEVICE_TABLES[key]


def _shift_powers(shift: int, n: int, device) -> torch.Tensor:
    key = ("shift", shift, n, str(device))
    if key not in _DEVICE_TABLES:
        _DEVICE_TABLES[key] = gf.from_u64(gl.np_powers(shift, n), device)
    return _DEVICE_TABLES[key]


# ---------------------------------------------------------------------------
# Core transforms
# ---------------------------------------------------------------------------


def bit_reverse(x: torch.Tensor) -> torch.Tensor:
    return bitrev_axis(x, axis=-1)


def _butterflies(x: torch.Tensor, tables, first_stage: int = 0) -> torch.Tensor:
    """DIT stages first_stage..log2(N), input already bit-reversed (or
    seeded past the first ``first_stage`` stages — see lde_onto_coset).
    x: [..., N]; tables is indexed by absolute stage number."""
    lead = x.shape[:-1]
    n = x.shape[-1]
    n_log = log2_strict(n)
    for s in range(first_stage, n_log):
        half = 1 << s
        r = x.reshape(lead + (n >> (s + 1), 2, half))
        u = r[..., 0, :]
        t = gf.mul(r[..., 1, :], tables[s])
        x = torch.stack([gf.add(u, t), gf.sub(u, t)], dim=-2).reshape(lead + (n,))
    return x


def fft(coeffs: torch.Tensor) -> torch.Tensor:
    """Coefficients -> values on the 2^k subgroup, natural (power) order."""
    n_log = log2_strict(coeffs.shape[-1])
    return _butterflies(bit_reverse(coeffs), stage_roots(n_log, False, coeffs.device))


def ifft(values: torch.Tensor) -> torch.Tensor:
    """Values on subgroup -> coefficients."""
    n = values.shape[-1]
    n_log = log2_strict(n)
    out = _butterflies(bit_reverse(values), stage_roots(n_log, True, values.device))
    return gf.mul_const(out, gl.ginv(n % gl.P))


def coset_fft(coeffs: torch.Tensor, shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR) -> torch.Tensor:
    """Values of the polynomial on the coset shift*H."""
    n = coeffs.shape[-1]
    return fft(gf.mul(coeffs, _shift_powers(shift, n, coeffs.device)))


def coset_ifft(values: torch.Tensor, shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR) -> torch.Tensor:
    """Inverse of coset_fft."""
    n = values.shape[-1]
    return gf.mul(ifft(values), _shift_powers(gl.ginv(shift), n, values.device))


def lde(coeffs: torch.Tensor, rate_bits: int) -> torch.Tensor:
    """Zero-pad coefficients by 2^rate_bits (reference: PolynomialCoeffs::lde)."""
    n = coeffs.shape[-1]
    return torch.nn.functional.pad(coeffs, (0, n * ((1 << rate_bits) - 1)))


def lde_onto_coset(coeffs: torch.Tensor, rate_bits: int,
                   shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR) -> torch.Tensor:
    """LDE evaluated on the shifted coset — the FRI oracle's commitment
    values (reference: fri/oracle.rs:193-223 from_coeffs).

    Implements the reference's ``zero_factor`` optimization
    (field/src/fft.rs:159-192): the first ``rate_bits`` DIT stages of a
    zero-padded input only copy — after bit-reversal the nonzero entries
    sit at stride 2^rate_bits and every butterfly partner is zero — so
    the transform is *seeded* at stage ``rate_bits`` by replicating the
    bit-reversed n-point array across each 2^rate_bits block
    (state[i] = scaled_coeffs[rev_n(i >> rate_bits)])."""
    if rate_bits == 0:
        return coset_fft(coeffs, shift)
    n = coeffs.shape[-1]
    n_log = log2_strict(n)
    # coset scaling acts on the unpadded coefficients (zeros stay zero)
    scaled = gf.mul(coeffs, _shift_powers(shift, n, coeffs.device))
    seed = torch.repeat_interleave(bit_reverse(scaled), 1 << rate_bits, dim=-1)
    return _butterflies(
        seed, stage_roots(n_log + rate_bits, False, coeffs.device), first_stage=rate_bits
    )


# ---------------------------------------------------------------------------
# Host-side naive evaluation (test oracle)
# ---------------------------------------------------------------------------


def naive_eval_np(coeffs_u64: np.ndarray, points_u64: np.ndarray) -> np.ndarray:
    """Horner evaluation of each row of coeffs at each point. O(N^2); tests only."""
    out = np.zeros(coeffs_u64.shape[:-1] + points_u64.shape, dtype=np.uint64)
    for j, x in enumerate(points_u64):
        acc = np.zeros(coeffs_u64.shape[:-1], dtype=np.uint64)
        for c in coeffs_u64[..., ::-1].transpose(-1, *range(coeffs_u64.ndim - 1)):
            acc = gl.np_add(gl.np_mul(acc, x), c)
        out[..., j] = acc
    return out

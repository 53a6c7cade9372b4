"""Batched NTT / LDE over Goldilocks on device.

Layout: a polynomial batch is an int64 bit-container tensor
``[num_polys, N]`` (ops/gf.py). Transforms under 2^_FOUR_STEP_LOG points
are one radix-2 DIT over the last axis (bit-reverse, then log2(N)
butterfly stages); from 2^_FOUR_STEP_LOG points on they run as the
four-step (Bailey) transform of the reference package
(plonky2_tpu/ops/ntt.py:150-360): two passes of column butterflies over
the [N2, N1] matrix view with a twiddle multiply and one transpose
between them.

The butterflies themselves are hand-written CUDA kernels on a CUDA tensor
(ops/ntt_cuda.py): ``row_fft`` for the flat transforms, ``col_fft`` for
both four-step passes. ``_butterflies`` and ``_butterflies_rows`` are
their plain PyTorch versions, which a CPU tensor takes.

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
from . import gf, ntt_cuda
from .bitrev import bitrev_axis

# transforms of at least 2^_FOUR_STEP_LOG points take the four-step path
# (the reference package's default of PLONKY2_TPU_FOUR_STEP_LOG)
_FOUR_STEP_LOG = 16

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


def _cached(key, make):
    if key not in _DEVICE_TABLES:
        _DEVICE_TABLES[key] = make()
    return _DEVICE_TABLES[key]


def stage_roots(n_log: int, inverse: bool, device) -> tuple:
    return _cached(
        ("roots", n_log, inverse, str(device)),
        lambda: tuple(gf.from_u64(t, device) for t in _stage_roots_np(n_log, inverse)),
    )


def stage_table(n_log: int, inverse: bool, device) -> torch.Tensor:
    """The stage tables back to back, stage s at [2^s - 1, 2^(s+1) - 1):
    the kernels' form (ops/ntt_cuda.py)."""
    def make():
        tables = _stage_roots_np(n_log, inverse)
        flat = np.concatenate(tables) if tables else np.zeros(0, dtype=np.uint64)
        return gf.from_u64(flat, device)

    return _cached(("table", n_log, inverse, str(device)), make)


def _shift_powers(shift: int, n: int, device) -> torch.Tensor:
    return _cached(
        ("shift", shift, n, str(device)),
        lambda: gf.from_u64(gl.np_powers(shift, n), device),
    )


# ---------------------------------------------------------------------------
# Flat transform (< 2^_FOUR_STEP_LOG points)
# ---------------------------------------------------------------------------


def bit_reverse(x: torch.Tensor) -> torch.Tensor:
    return bitrev_axis(x, axis=-1)


def _butterflies(x: torch.Tensor, tables, first_stage: int = 0) -> torch.Tensor:
    """DIT stages first_stage..log2(N), input already bit-reversed (or
    seeded past the first ``first_stage`` stages — see lde_onto_coset).
    x: [..., N]; tables is indexed by absolute stage number. The plain
    version of the row_fft kernel."""
    lead = x.shape[:-1]
    n = x.shape[-1]
    n_log = log2_strict(n)
    for s in range(first_stage, n_log):
        half = 1 << s
        r = x.reshape(lead + (n >> (s + 1), 2, half))
        u = r[..., 0, :]
        t = gf.mul_plain(r[..., 1, :], tables[s])
        x = torch.stack([gf.add(u, t), gf.sub(u, t)], dim=-2).reshape(lead + (n,))
    return x


def _fft_flat(x: torch.Tensor, n_log: int, inverse: bool, first_stage: int = 0) -> torch.Tensor:
    """Butterflies over the last axis of bit-reversed (or seeded) input:
    the row_fft kernel on a CUDA tensor, its plain version on the CPU."""
    if x.is_cuda:
        return ntt_cuda.row_fft(x.contiguous(), n_log, first_stage, inverse)
    return _butterflies(x, stage_roots(n_log, inverse, x.device), first_stage)


# ---------------------------------------------------------------------------
# Four-step (Bailey) transform for large N (reference: ops/ntt.py:150-385)
#
# Past _FOUR_STEP_LOG the transform runs as DFT_N = transpose . DFT_N1 .
# twiddle . DFT_N2 over the [N2, N1] row-major matrix view: the column
# transform (over i2) runs along axis -2 with i1 riding along, the twiddle
# T[k2, i1] = w^(i1*k2) is applied in factored form (two broadcast
# multiplies against O(N1*sqrt(N2)) tables), one transpose, and a second
# column transform; the output [k1, k2] flattens to k = k1*N2 + k2.
# ---------------------------------------------------------------------------


def _build_twiddles_np(a: np.ndarray, n2_log: int) -> np.ndarray:
    """T[i, j] = a[i]^j for j in [2^n2_log], by column-doubling: log2(N2)
    vectorized numpy passes (exact u64 Goldilocks mul)."""
    n1 = a.shape[0]
    n2 = 1 << n2_log
    t = np.zeros((n1, n2), dtype=np.uint64)
    t[:, 0] = 1
    step = a.copy()  # a^filled
    filled = 1
    while filled < n2:
        k = min(filled, n2 - filled)
        t[:, filled : filled + k] = gl.np_mul(t[:, :k], step[:, None])
        step = gl.np_mul(step, step)
        filled += k
    return t


def _split_logs(n_log: int):
    n1_log = n_log // 2
    return n1_log, n_log - n1_log


@lru_cache(maxsize=None)
def _twiddle_factors(n_log: int, inverse: bool):
    """The four-step twiddle T[n1, k2] = w^(n1*k2) in factored form: with
    k2 = k2b*2^ha + k2a, T = A[n1, k2a] * B[n1, k2b] where A[n1, j] =
    w^(n1*j) and B[n1, j] = (w^(2^ha))^(n1*j); numpy u64."""
    n1_log, n2_log = _split_logs(n_log)
    ha = n2_log // 2
    hb = n2_log - ha
    w = gl.primitive_root_of_unity(n_log)
    if inverse:
        w = gl.ginv(w)
    base = gl.np_powers(w, 1 << n1_log)  # w^(n1)
    a = _build_twiddles_np(base, ha)  # [N1, 2^ha]
    base_b = gl.np_powers(gl.gexp(w, 1 << ha), 1 << n1_log)  # (w^(2^ha))^(n1)
    b = _build_twiddles_np(base_b, hb)  # [N1, 2^hb]
    return a, b, ha, hb


def _twiddle_factors_rows(n_log: int, inverse: bool, device):
    """The factored twiddles transposed for the row-oriented layout
    [k2, i1]: A_T[k2a, i1] = w^(i1*k2a), B_T[k2b, i1] = (w^(2^ha))^(i1*k2b),
    on ``device``."""
    def make():
        a, b, ha, hb = _twiddle_factors(n_log, inverse)
        return gf.from_u64(a.T, device), gf.from_u64(b.T, device), ha, hb

    return _cached(("twiddle_rows", n_log, inverse, str(device)), make)


def _apply_twiddle_rows(y: torch.Tensor, n_log: int, inverse: bool) -> torch.Tensor:
    """y[..., k2, i1] *= w^(i1*k2) via the factored tables; rows split as
    k2 = k2b*2^ha + k2a, both factors broadcast (not expanded) against y."""
    at, bt, ha, hb = _twiddle_factors_rows(n_log, inverse, y.device)
    lead = y.shape[:-2]
    n1 = y.shape[-1]
    v = y.reshape(lead + (1 << hb, 1 << ha, n1))
    out = gf.mul(gf.mul(v, at[None, :, :]), bt[:, None, :])
    return out.reshape(y.shape)


def _bitrev_rows(x: torch.Tensor) -> torch.Tensor:
    return bitrev_axis(x, axis=-2)


def _butterflies_rows(x: torch.Tensor, tables, first_stage: int = 0) -> torch.Tensor:
    """DIT butterflies along axis -2; the last axis rides along. x: [..., N, L],
    input bit-reversed along axis -2 (or seeded past first_stage); tables
    indexed by absolute stage. The plain version of the col_fft kernel."""
    lead = x.shape[:-2]
    n, lanes = x.shape[-2], x.shape[-1]
    n_log = log2_strict(n)
    for s in range(first_stage, n_log):
        half = 1 << s
        r = x.reshape(lead + (n >> (s + 1), 2, half, lanes))
        u = r[..., 0, :, :]
        t = gf.mul_plain(r[..., 1, :, :], tables[s][:, None])
        x = torch.stack([gf.add(u, t), gf.sub(u, t)], dim=-3).reshape(lead + (n, lanes))
    return x


def _fft_rows(x: torch.Tensor, k_log: int, inverse: bool, first_stage: int = 0) -> torch.Tensor:
    """DFT along axis -2 (input bit-reversed along that axis, or seeded
    past ``first_stage``): the col_fft kernel on a CUDA tensor — every
    stage, whatever the shape — and its plain version on the CPU."""
    if x.is_cuda:
        return ntt_cuda.col_fft(x.contiguous(), k_log, first_stage, inverse)
    return _butterflies_rows(x, stage_roots(k_log, inverse, x.device), first_stage)


def _fft_four_step(x: torch.Tensor, n_log: int, inverse: bool,
                   seeded_rate_bits: int = 0) -> torch.Tensor:
    """DFT over the last axis via the [N2, N1] matrix decomposition.

    With seeded_rate_bits = r > 0 (forward only), the input is the
    UNPADDED coefficient array of length N >> r: its row-major reshape
    occupies the first N2 >> r rows of the [N2, N1] view, so the column
    transform applies the zero_factor seeding (bit-reverse + replicate +
    skip the first r stages) instead of transforming explicit zeros."""
    n1_log, n2_log = _split_logs(n_log)
    n1, n2 = 1 << n1_log, 1 << n2_log
    lead = x.shape[:-1]
    if seeded_rate_bits:
        assert not inverse
        m = n2 >> seeded_rate_bits
        assert x.shape[-1] == m * n1
        z = _bitrev_rows(x.reshape(lead + (m, n1)))  # m-point reversal along rows
        seed = torch.repeat_interleave(z, 1 << seeded_rate_bits, dim=-2)
        y = _fft_rows(seed, n2_log, False, first_stage=seeded_rate_bits)
    else:
        y = _fft_rows(_bitrev_rows(x.reshape(lead + (n2, n1))), n2_log, inverse)
    y = _apply_twiddle_rows(y, n_log, inverse)  # [k2, i1]
    z2 = y.transpose(-1, -2).contiguous()  # [i1, k2]
    w = _fft_rows(_bitrev_rows(z2), n1_log, inverse)  # [k1, k2]
    return w.reshape(lead + (n1 * n2,))


def _scale_rank1(x: torch.Tensor, shift: int) -> torch.Tensor:
    """x[..., i] * shift^i without an O(N) table: shift^i factors as
    (shift^N1)^(i2) * shift^(i1) over the row-major [N2, N1] view."""
    n = x.shape[-1]
    n1_log, n2_log = _split_logs(log2_strict(n))
    n1, n2 = 1 << n1_log, 1 << n2_log
    row = _shift_powers(shift, n1, x.device)
    col = _shift_powers(gl.gexp(shift, n1), n2, x.device)
    y = gf.mul(x.reshape(x.shape[:-1] + (n2, n1)), row)
    return gf.mul(y, col[:, None]).reshape(x.shape)


# ---------------------------------------------------------------------------
# Public transforms (routing as in the reference, ops/ntt.py:392-475)
# ---------------------------------------------------------------------------


def fft(coeffs: torch.Tensor) -> torch.Tensor:
    """Coefficients -> values on the 2^k subgroup, natural (power) order."""
    n_log = log2_strict(coeffs.shape[-1])
    if n_log >= _FOUR_STEP_LOG:
        return _fft_four_step(coeffs, n_log, False)
    return _fft_flat(bit_reverse(coeffs), n_log, False)


def ifft(values: torch.Tensor) -> torch.Tensor:
    """Values on subgroup -> coefficients."""
    n = values.shape[-1]
    n_log = log2_strict(n)
    if n_log >= _FOUR_STEP_LOG:
        out = _fft_four_step(values, n_log, True)
    else:
        out = _fft_flat(bit_reverse(values), n_log, True)
    return gf.mul_const(out, gl.ginv(n % gl.P))


def coset_fft(coeffs: torch.Tensor, shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR) -> torch.Tensor:
    """Values of the polynomial on the coset shift*H."""
    n = coeffs.shape[-1]
    if log2_strict(n) >= _FOUR_STEP_LOG:
        return fft(_scale_rank1(coeffs, shift))
    return fft(gf.mul(coeffs, _shift_powers(shift, n, coeffs.device)))


def coset_ifft(values: torch.Tensor, shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR) -> torch.Tensor:
    """Inverse of coset_fft."""
    coeffs = ifft(values)
    n = values.shape[-1]
    if log2_strict(n) >= _FOUR_STEP_LOG:
        return _scale_rank1(coeffs, gl.ginv(shift))
    return gf.mul(coeffs, _shift_powers(gl.ginv(shift), n, values.device))


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
    lde_log = n_log + rate_bits
    if lde_log >= _FOUR_STEP_LOG:
        # four-step with the seeding folded into the first column pass;
        # the nonzero prefix must cover whole rows of the [N2, N1] view
        n1_log, _ = _split_logs(lde_log)
        scaled = _scale_rank1(coeffs, shift)
        if n_log >= n1_log:
            return _fft_four_step(scaled, lde_log, False, seeded_rate_bits=rate_bits)
        return fft(lde(scaled, rate_bits))
    # coset scaling acts on the unpadded coefficients (zeros stay zero)
    scaled = gf.mul(coeffs, _shift_powers(shift, n, coeffs.device))
    seed = torch.repeat_interleave(bit_reverse(scaled), 1 << rate_bits, dim=-1)
    return _fft_flat(seed, lde_log, False, first_stage=rate_bits)


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

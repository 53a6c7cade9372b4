"""plonky2_tpu_torch.ops.ntt / bitrev against plonky2_tpu.ops.ntt and the
naive evaluation, same numpy inputs. Tolerance: none (u64 equality)."""

import jax
import numpy as np
import pytest

from plonky2_tpu.ops import gf as jgf
from plonky2_tpu.ops import ntt as jntt
from _torch_port import lazy_module
from plonky2_tpu.field.goldilocks import P

gl = lazy_module("plonky2_tpu_torch.field.goldilocks")
tbr = lazy_module("plonky2_tpu_torch.ops.bitrev")
tgf = lazy_module("plonky2_tpu_torch.ops.gf")
tntt = lazy_module("plonky2_tpu_torch.ops.ntt")
tbits = lazy_module("plonky2_tpu_torch.utils.bits")

SIZES = [3, 6, 9]
# Each distinct shape costs the JAX side an XLA compile of seconds, so every
# transform is held against the JAX package at the sizes named here and, at
# the other sizes, against the naive evaluation or its own inverse.
VS_REFERENCE = {
    "fft": {3, 9},
    "ifft": {6},
    "coset_fft": {9},
    "coset_ifft": {6},
    "lde": {(3, 1), (6, 3), (9, 3)},
}


def _t(x):
    return tgf.from_u64(x, "cpu")


def _batch(n_log, seed=0):
    rng = np.random.default_rng(seed + n_log)
    return rng.integers(0, P, size=(3, 1 << n_log), dtype=np.uint64)


@pytest.mark.parametrize("n_log", SIZES)
def test_fft_ifft(n_log):
    c = _batch(n_log)
    got = tgf.to_u64(tntt.fft(_t(c)))
    if n_log in VS_REFERENCE["fft"]:
        np.testing.assert_array_equal(got, jgf.to_u64(jntt.fft_jit(jgf.from_u64(c))))
    if n_log <= 6:  # fft[i] = poly(g^i), natural order
        np.testing.assert_array_equal(
            got, tntt.naive_eval_np(c, gl.two_adic_subgroup(n_log))
        )
    if n_log in VS_REFERENCE["ifft"]:
        want_i = jgf.to_u64(jntt.ifft_jit(jgf.from_u64(c)))
        np.testing.assert_array_equal(tgf.to_u64(tntt.ifft(_t(c))), want_i)
    np.testing.assert_array_equal(tgf.to_u64(tntt.ifft(tntt.fft(_t(c)))), c)


@pytest.mark.parametrize("n_log", SIZES)
def test_coset_fft_ifft(n_log):
    c = _batch(n_log, seed=10)
    shift = gl.MULTIPLICATIVE_GROUP_GENERATOR
    got = tgf.to_u64(tntt.coset_fft(_t(c)))
    if n_log in VS_REFERENCE["coset_fft"]:
        want = jgf.to_u64(jntt.coset_fft_jit(jgf.from_u64(c), shift))
        np.testing.assert_array_equal(got, want)
    if n_log <= 6:
        pts = gl.np_mul(np.uint64(shift), gl.two_adic_subgroup(n_log))
        np.testing.assert_array_equal(got, tntt.naive_eval_np(c, pts))
    if n_log in VS_REFERENCE["coset_ifft"]:
        want_i = jgf.to_u64(jntt.coset_ifft_jit(jgf.from_u64(c), shift))
        np.testing.assert_array_equal(tgf.to_u64(tntt.coset_ifft(_t(c))), want_i)
    np.testing.assert_array_equal(tgf.to_u64(tntt.coset_ifft(tntt.coset_fft(_t(c)))), c)
    # another shift (the FRI re-evaluation cosets)
    s2 = gl.gexp(shift, 16)
    np.testing.assert_array_equal(
        tgf.to_u64(tntt.coset_fft(_t(c), s2)),
        tgf.to_u64(tntt.fft(_t(gl.np_mul(c, gl.np_powers(s2, c.shape[1]))))),
    )


@pytest.mark.parametrize("n_log", SIZES)
@pytest.mark.parametrize("rate_bits", [1, 3])
def test_lde_onto_coset(n_log, rate_bits):
    c = _batch(n_log, seed=20)
    got = tgf.to_u64(tntt.lde_onto_coset(_t(c), rate_bits))
    if (n_log, rate_bits) in VS_REFERENCE["lde"]:
        want = jgf.to_u64(
            jax.jit(jntt.lde_onto_coset, static_argnums=1)(jgf.from_u64(c), rate_bits)
        )
        np.testing.assert_array_equal(got, want)
    # the seeded transform equals the zero-padded coset FFT
    np.testing.assert_array_equal(
        got, tgf.to_u64(tntt.coset_fft(tntt.lde(_t(c), rate_bits)))
    )
    if n_log == 3:
        pts = gl.np_mul(
            np.uint64(gl.MULTIPLICATIVE_GROUP_GENERATOR),
            gl.two_adic_subgroup(n_log + rate_bits),
        )
        np.testing.assert_array_equal(got, tntt.naive_eval_np(c, pts))


def test_lde_rate_zero_is_coset_fft():
    c = _batch(4)
    np.testing.assert_array_equal(
        tgf.to_u64(tntt.lde_onto_coset(_t(c), 0)), tgf.to_u64(tntt.coset_fft(_t(c)))
    )


@pytest.mark.parametrize("n", [1, 2, 8, 64])
def test_bitrev_axis(n):
    rng = np.random.default_rng(n)
    x = rng.integers(0, P, size=(n, 5), dtype=np.uint64)
    perm = np.asarray(tbits.reverse_index_bits_perm(n))
    np.testing.assert_array_equal(tgf.to_u64(tbr.bitrev_axis(_t(x), axis=0)), x[perm])
    np.testing.assert_array_equal(
        tgf.to_u64(tbr.bitrev_axis(_t(np.ascontiguousarray(x.T)), axis=-1)), x[perm].T
    )


# ---------------------------------------------------------------------------
# Every size from one point up, against the naive evaluation or the inverse
# transform (no XLA compile).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("n_log", range(0, 8))
def test_fft_size_vs_naive(n_log, batch):
    rng = np.random.default_rng(500 + n_log)
    c = rng.integers(0, P, size=(batch, 1 << n_log), dtype=np.uint64)
    c[0, -1] = P - 1
    got = tgf.to_u64(tntt.fft(_t(c)))
    np.testing.assert_array_equal(got, tntt.naive_eval_np(c, gl.two_adic_subgroup(n_log)))
    np.testing.assert_array_equal(tgf.to_u64(tntt.ifft(_t(got))), c)


@pytest.mark.parametrize("n_log", range(8, 14))
def test_fft_size_inverts(n_log):
    c = _batch(n_log, seed=30)
    v = tntt.fft(_t(c))
    np.testing.assert_array_equal(tgf.to_u64(tntt.ifft(v)), c)
    # fft[0] = poly(1) = the sum of the coefficients
    np.testing.assert_array_equal(tgf.to_u64(v[:, 0]), tgf.to_u64(tgf.sum_mod_p(_t(c), 1)))
    # fft[n/2] = poly(-1) = the alternating sum
    signed = c.copy()
    signed[:, 1::2] = tgf.to_u64(tgf.neg(_t(c[:, 1::2])))
    np.testing.assert_array_equal(
        tgf.to_u64(v[:, c.shape[1] // 2]), tgf.to_u64(tgf.sum_mod_p(_t(signed), 1))
    )


@pytest.mark.parametrize("shift_log", [0, 1, 5, 31])
@pytest.mark.parametrize("n_log", range(1, 7))
def test_coset_fft_shift_vs_naive(n_log, shift_log):
    shift = gl.gexp(gl.MULTIPLICATIVE_GROUP_GENERATOR, 1 << shift_log)
    c = _batch(n_log, seed=40)
    got = tgf.to_u64(tntt.coset_fft(_t(c), shift))
    pts = gl.np_mul(np.uint64(shift), gl.two_adic_subgroup(n_log))
    np.testing.assert_array_equal(got, tntt.naive_eval_np(c, pts))
    np.testing.assert_array_equal(tgf.to_u64(tntt.coset_ifft(_t(got), shift)), c)


@pytest.mark.parametrize("rate_bits", [0, 1, 2, 3])
@pytest.mark.parametrize("n_log", range(0, 6))
def test_lde_size_vs_naive(n_log, rate_bits):
    c = _batch(n_log, seed=50)
    got = tgf.to_u64(tntt.lde_onto_coset(_t(c), rate_bits))
    pts = gl.np_mul(
        np.uint64(gl.MULTIPLICATIVE_GROUP_GENERATOR), gl.two_adic_subgroup(n_log + rate_bits)
    )
    np.testing.assert_array_equal(got, tntt.naive_eval_np(c, pts))
    padded = tgf.to_u64(tntt.lde(_t(c), rate_bits))
    assert padded.shape == (3, 1 << (n_log + rate_bits))
    np.testing.assert_array_equal(padded[:, : 1 << n_log], c)
    assert not padded[:, 1 << n_log :].any()


@pytest.mark.parametrize("n_log", range(0, 13))
def test_bitrev_size_is_an_involution(n_log):
    n = 1 << n_log
    x = np.arange(n, dtype=np.uint64)
    once = tbr.bitrev_axis(_t(x), axis=0)
    want = [int(format(i, "b").zfill(n_log)[::-1], 2) if n_log else 0 for i in range(n)]
    assert [int(v) for v in tgf.to_u64(once)] == want
    np.testing.assert_array_equal(tgf.to_u64(tbr.bitrev_axis(once, axis=0)), x)

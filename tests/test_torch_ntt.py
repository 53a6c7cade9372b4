"""plonky2_tpu_torch.ops.ntt / bitrev against plonky2_tpu.ops.ntt and the
naive evaluation, same numpy inputs. Tolerance: none (u64 equality)."""

import ast
import os
import re

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


# ---------------------------------------------------------------------------
# The four-step transform and the plain versions of the butterfly kernels,
# called directly at small sizes, against the JAX package's functions of the
# same names (its XLA path on the CPU) and its public transforms.
# ---------------------------------------------------------------------------

ntt_cuda = lazy_module("plonky2_tpu_torch.ops.ntt_cuda")


def _jit(fn, *static):
    """The JAX function compiled once for the call (op-by-op dispatch of
    the same function costs several times the compile on the CPU)."""
    return jax.jit(fn, static_argnums=static)


@pytest.mark.parametrize("n_log, first_stage, inverse", [(5, 1, False), (7, 3, True), (8, 2, False)])
def test_butterflies_first_stage_vs_reference(n_log, first_stage, inverse):
    x = _batch(n_log, seed=60)
    got = tntt.load()._butterflies(_t(x), tntt.stage_roots(n_log, inverse, "cpu"), first_stage)
    want = _jit(lambda v: jntt._butterflies(v, jntt.stage_roots(n_log, inverse), first_stage))(jgf.from_u64(x))
    np.testing.assert_array_equal(tgf.to_u64(got), jgf.to_u64(want))


@pytest.mark.parametrize(
    "k_log, lanes, first_stage, inverse",
    [(4, 8, 0, False), (6, 4, 1, True), (5, 16, 3, False), (7, 2, 0, True)],
)
def test_butterflies_rows_and_fft_rows_vs_reference(k_log, lanes, first_stage, inverse):
    rng = np.random.default_rng(70 + k_log)
    x = rng.integers(0, P, size=(2, 1 << k_log, lanes), dtype=np.uint64)
    want = jgf.to_u64(_jit(lambda v: jntt._butterflies_rows(v, jntt.stage_roots(k_log, inverse), first_stage))(jgf.from_u64(x)))
    got = tntt.load()._butterflies_rows(_t(x), tntt.stage_roots(k_log, inverse, "cpu"), first_stage)
    np.testing.assert_array_equal(tgf.to_u64(got), want)
    np.testing.assert_array_equal(
        tgf.to_u64(tntt.load()._fft_rows(_t(x), k_log, inverse, first_stage)),
        jgf.to_u64(_jit(jntt._fft_rows, 1, 2, 3)(jgf.from_u64(x), k_log, inverse, first_stage)),
    )


@pytest.mark.parametrize("n_log", [6, 7, 8, 9, 10])
@pytest.mark.parametrize("inverse", [False, True])
def test_four_step_vs_reference(n_log, inverse):
    x = _batch(n_log, seed=80)
    got = tgf.to_u64(tntt.load()._fft_four_step(_t(x), n_log, inverse))
    np.testing.assert_array_equal(
        got, jgf.to_u64(_jit(jntt._fft_four_step, 1, 2)(jgf.from_u64(x), n_log, inverse))
    )
    # the flat transform gives the same values (ifft scales by 1/N on top)
    if inverse:
        want = jgf.to_u64(jntt.ifft_jit(jgf.from_u64(x)))
        np.testing.assert_array_equal(
            tgf.to_u64(tgf.mul_const(_t(got), gl.ginv(1 << n_log))), want
        )
    else:
        np.testing.assert_array_equal(got, jgf.to_u64(jntt.fft_jit(jgf.from_u64(x))))


@pytest.mark.parametrize("n_log, rate_bits", [(6, 1), (7, 3), (9, 1), (8, 2)])
def test_four_step_seeded_vs_reference(n_log, rate_bits):
    """The seeded four-step (unpadded coefficients, zero_factor stages
    skipped) against the JAX LDE on the coset."""
    c = _batch(n_log, seed=90)
    lde_log = n_log + rate_bits
    scaled = tntt.load()._scale_rank1(_t(c), gl.MULTIPLICATIVE_GROUP_GENERATOR)
    got = tgf.to_u64(tntt.load()._fft_four_step(scaled, lde_log, False, seeded_rate_bits=rate_bits))
    want = jgf.to_u64(
        _jit(jntt.lde_onto_coset, 1)(jgf.from_u64(c), rate_bits)
    )
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tgf.to_u64(scaled),
        jgf.to_u64(_jit(jntt._scale_rank1, 1)(jgf.from_u64(c), gl.MULTIPLICATIVE_GROUP_GENERATOR)),
    )


PUBLIC = {
    "fft": lambda t, j: (tntt.fft(t), jntt.fft_jit(j)),
    "ifft": lambda t, j: (tntt.ifft(t), jntt.ifft_jit(j)),
    "coset_fft": lambda t, j: (
        tntt.coset_fft(t), jntt.coset_fft_jit(j, gl.MULTIPLICATIVE_GROUP_GENERATOR)
    ),
    "coset_ifft": lambda t, j: (
        tntt.coset_ifft(t), jntt.coset_ifft_jit(j, gl.MULTIPLICATIVE_GROUP_GENERATOR)
    ),
    # 2^(n_log-1) coefficients at rate 1: the LDE crosses the switch from below
    "lde_onto_coset": lambda t, j: (
        tntt.lde_onto_coset(t[:, : t.shape[1] // 2], 1),
        _jit(jntt.lde_onto_coset, 1)((j[0][:, : t.shape[1] // 2], j[1][:, : t.shape[1] // 2]), 1),
    ),
}


@pytest.mark.parametrize("n_log", [16, 17])
@pytest.mark.parametrize("transform", sorted(PUBLIC))
def test_public_transform_at_the_four_step_switch(transform, n_log):
    """Both packages take the four-step path from 2^16 points on."""
    assert tntt.load()._FOUR_STEP_LOG == jntt._FOUR_STEP_LOG == 16
    rng = np.random.default_rng(100 + n_log)
    c = rng.integers(0, P, size=(1, 1 << n_log), dtype=np.uint64)
    got, want = PUBLIC[transform](_t(c), jgf.from_u64(c))
    np.testing.assert_array_equal(tgf.to_u64(got), jgf.to_u64(want))


def test_lde_falls_back_when_rows_are_not_covered():
    """lde_onto_coset with rate_bits past n_log/2 at the four-step size
    takes fft(lde(...)), as the reference does."""
    c = _batch(6, seed=110)[:1]
    got = tntt.lde_onto_coset(_t(c), 10)  # 2^16 points; n_log 6 < n1_log 8
    want = tntt.coset_fft(tntt.lde(_t(c), 10))
    np.testing.assert_array_equal(tgf.to_u64(got), tgf.to_u64(want))


@pytest.mark.parametrize("n_log", [1, 4, 9, 16])
def test_stage_table_is_the_stage_roots_back_to_back(n_log):
    flat = tgf.to_u64(tntt.stage_table(n_log, n_log % 2 == 1, "cpu"))
    tables = tntt.load()._stage_roots_np(n_log, n_log % 2 == 1)
    assert flat.shape == ((1 << n_log) - 1,)
    for s, t in enumerate(tables):
        np.testing.assert_array_equal(flat[(1 << s) - 1 : (1 << (s + 1)) - 1], t)


def test_ntt_kernels_refuse_cpu_tensors():
    import torch

    x = torch.zeros((2, 8, 4), dtype=torch.int64)
    before = dict(ntt_cuda.LAUNCHES)
    with pytest.raises(ValueError):
        ntt_cuda.col_fft(x, 3, 0, False)
    with pytest.raises(ValueError):
        ntt_cuda.row_fft(x[:, :, 0].contiguous(), 3, 0, False)
    tntt.fft(x[:, :, 0].contiguous())
    tntt.load()._fft_rows(x, 3, False)
    assert ntt_cuda.LAUNCHES == before


# ---------------------------------------------------------------------------
# The column kernel's launch plan (ops/ntt_cuda.col_plan), pure Python, held
# to what csrc/ntt.cu plonky2_col_fft_pass accepts: at every fixed form of
# chip_smoke.py, every form the main paths launch (the list of
# tools/torch_ntt_variants.py) and a sweep of k, L and the first stage.
# ---------------------------------------------------------------------------

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assigned_list(path, name):
    """The list assigned to ``name`` at the top of a script, evaluated
    without importing the script (both import torch)."""
    with open(os.path.join(_ROOT, path)) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == name:
            return eval(compile(ast.Expression(node.value), path, "eval"), {})
    raise LookupError(f"{path} assigns no {name}")


_PLAN_FORMS = sorted(
    {(k, lanes, first) for _, k, lanes, first, _ in _assigned_list("chip_smoke.py", "COL_FFT_FIXED")}
    | {(k, lanes, first) for _, k, lanes, first, _ in
       _assigned_list("tools/torch_ntt_variants.py", "MAIN_PATH_COL_FORMS")}
    | {(k, 1 << l, first) for k in range(1, 14) for l in range(13) for first in range(4)}
)


def _ntt_cu_define(name):
    with open(os.path.join(_ROOT, "plonky2_tpu_torch", "ops", "csrc", "ntt.cu")) as f:
        return int(re.search(rf"#define {name} (\d+)", f.read()).group(1))


def test_col_plan_constants_match_the_kernel_source():
    assert ntt_cuda.TILE_WORDS_LOG == _ntt_cu_define("NTT_TILE_WORDS_LOG")
    assert ntt_cuda.COL_THREADS == _ntt_cu_define("NTT_COL_THREADS")
    assert ntt_cuda.COL_RADIX_LOG == _ntt_cu_define("NTT_COL_RADIX_LOG")
    assert ntt_cuda.COL_TILE_WORDS_LOG <= ntt_cuda.TILE_WORDS_LOG


@pytest.mark.parametrize("k_log, lanes, first", _PLAN_FORMS, ids=lambda v: str(v))
def test_col_plan_covers_each_stage_once_in_tiles_the_kernel_takes(k_log, lanes, first):
    l_log = lanes.bit_length() - 1
    passes, tail = ntt_cuda.col_plan(k_log, l_log, first)
    stages = [s for p in passes for s in range(p.first, p.last)] + list(range(tail, k_log))
    assert stages == list(range(first, k_log))
    for p in passes:
        n = p.last - p.first
        assert p.last <= min(k_log, ntt_cuda.COL_FUSED_LOG)
        assert sum(p.groups) == n and all(1 <= g <= ntt_cuda.COL_RADIX_LOG for g in p.groups)
        assert 0 <= p.packed_groups() < 1 << 31
        # the tile fits the shared memory the kernel asks for
        assert n + p.lanes_log <= ntt_cuda.TILE_WORDS_LOG
        tile_bytes = 8 << (n + p.lanes_log)
        assert p.smem_bytes() == (tile_bytes if len(p.groups) > 1 else 0)
        assert p.smem_bytes() <= 8 << ntt_cuda.TILE_WORDS_LOG
        # the tile's lanes divide L, and make runs of a sector where L allows
        assert 0 <= p.lanes_log <= l_log and lanes % (1 << p.lanes_log) == 0
        assert p.lanes_log >= min(l_log, ntt_cuda.COL_MIN_LANES_LOG)
        # a legal block
        assert 32 <= p.threads <= ntt_cuda.COL_THREADS and p.threads % 32 == 0


# ---------------------------------------------------------------------------
# The row kernel's launch plan (ops/ntt_cuda.row_plan), pure Python, held to
# what csrc/ntt.cu plonky2_row_fft_pass accepts: at every fixed form of
# chip_smoke.py, every form the main paths launch (the list of
# tools/torch_ntt_variants.py) and a sweep of n, the row count and the
# first stage.
# ---------------------------------------------------------------------------

_MAIN_PATH_ROW_FORMS = sorted(
    {(rows, n, first) for rows, n, first, _ in
     _assigned_list("tools/torch_ntt_variants.py", "MAIN_PATH_ROW_FORMS")})
_ROW_PLAN_FORMS = sorted(
    {(rows, n, first) for rows, n, first, _ in _assigned_list("chip_smoke.py", "ROW_FFT_FIXED")}
    | set(_MAIN_PATH_ROW_FORMS)
    | {(rows, n, first) for n in range(1, 21) for rows in (1, 2, 3, 16, 143)
       for first in range(4)}
)


def test_row_plan_constants_match_the_kernel_source():
    assert ntt_cuda.ROW_THREADS == _ntt_cu_define("NTT_ROW_THREADS")
    assert ntt_cuda.ROW_RADIX_LOG <= _ntt_cu_define("NTT_COL_RADIX_LOG")
    assert ntt_cuda.ROW_TILE_WORDS_LOG <= ntt_cuda.TILE_WORDS_LOG
    # three blocks of the largest tile share an SM's 227 KB
    assert 3 * (8 << ntt_cuda.ROW_TILE_WORDS_LOG) <= 227 * 1024
    assert _ntt_cu_define("NTT_ROW_MIN_BLOCKS") == 3
    assert ntt_cuda.ROW_TWO_PASS_LOG == 24


@pytest.mark.parametrize("rows, n_log, first", _ROW_PLAN_FORMS, ids=lambda v: str(v))
def test_row_plan_covers_each_stage_once_in_tiles_the_kernel_takes(rows, n_log, first):
    passes, tail = ntt_cuda.row_plan(rows, n_log, first)
    stages = [s for p in passes for s in range(p.first, p.last)] + list(range(tail, n_log))
    assert stages == list(range(first, n_log))
    # one pass up to 2^13 words a row, two up to 2^24, tail stages past it
    assert len(passes) <= (1 if n_log <= ntt_cuda.ROW_TILE_WORDS_LOG else 2)
    assert tail == max(min(n_log, ntt_cuda.ROW_TWO_PASS_LOG), min(first, n_log))
    for i, p in enumerate(passes):
        n = p.last - p.first
        # the view [rows * 2^(n_log - k_log), 2^k_log] and its stages
        assert p.last <= p.k_log <= n_log and p.batch(rows, n_log) == rows << (n_log - p.k_log)
        assert sum(p.groups) == n and all(1 <= g <= ntt_cuda.ROW_RADIX_LOG for g in p.groups)
        assert 0 <= p.packed_groups() < 1 << 31
        # the tile fits the shared memory the kernel asks for (64 KB)
        assert p.rows_log >= 0 and p.tile_words_log() <= ntt_cuda.ROW_TILE_WORDS_LOG
        assert p.smem_bytes() == ((8 << p.tile_words_log()) if len(p.groups) > 1 else 0)
        # the lanes are residues mod 2^first: all of them (whole rows or
        # chunks) in the first of two passes, runs of at least 32 bytes
        assert 0 <= p.lanes_log <= p.first
        assert p.lanes_log >= min(p.first, ntt_cuda.COL_MIN_LANES_LOG)
        if i == 0 and len(passes) == 2:
            assert p.k_log == p.last and p.lanes_log == p.first
        # a legal block and grid
        assert 32 <= p.threads <= ntt_cuda.ROW_THREADS and p.threads % 32 == 0
        assert 1 <= p.blocks(rows, n_log) < 1 << 31


def test_row_plan_runs_the_fold_form_on_at_least_128_blocks_a_pass():
    """(2, 2^15): two passes of at least 128 blocks each (one pass of 4
    blocks and a tail stage before the redesign)."""
    passes, tail = ntt_cuda.row_plan(2, 15, 0)
    assert tail == 15 and len(passes) == 2
    assert all(p.blocks(2, 15) >= 128 for p in passes)


@pytest.mark.parametrize("rows, n_log, first", _MAIN_PATH_ROW_FORMS, ids=lambda v: str(v))
def test_row_plan_main_path_forms_fill_the_card(rows, n_log, first):
    """Every main-path form takes at most two launches, and each launch as
    many blocks as the SMs when the tensor has a tile an SM."""
    passes, tail = ntt_cuda.row_plan(rows, n_log, first)
    assert tail == n_log and 1 <= len(passes) <= 2
    tiles = (rows << n_log) >> ntt_cuda.ROW_TILE_WORDS_LOG
    for p in passes:
        assert p.blocks(rows, n_log) >= min(tiles, 128)


@pytest.mark.parametrize("split_at", [7, 9, 11])
def test_row_plan_split_at_names_the_second_pass(split_at):
    passes, _ = ntt_cuda.row_plan(143, 15, 3, split_at=split_at)
    assert [(p.first, p.last) for p in passes] == [(3, split_at), (split_at, 15)]


def test_row_plan_past_two_passes_leaves_tail_stages():
    passes, tail = ntt_cuda.row_plan(1, 26, 0)
    assert tail == 24 and passes[-1].last == 24 and passes[-1].k_log == 26

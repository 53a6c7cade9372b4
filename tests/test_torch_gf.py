"""plonky2_tpu_torch.ops.gf (one int64 plane, plain torch on the CPU) against
plonky2_tpu.ops.gf (u32 limb planes, XLA on the CPU) on the same numpy
inputs. Tolerance: none — integer equality of u64 values."""

import jax
import numpy as np
import pytest

from plonky2_tpu.field import goldilocks as gl
from plonky2_tpu.ops import gf as jgf
from _torch_port import lazy_module

ge = lazy_module("plonky2_tpu_torch.field.extension")
tgf = lazy_module("plonky2_tpu_torch.ops.gf")

P = gl.P
EDGE = np.array(
    [0, 1, 2, gl.EPSILON - 1, gl.EPSILON, gl.EPSILON + 1, 1 << 32, (1 << 32) + 1,
     1 << 63, P - 2, P - 1],
    dtype=np.uint64,
)
# not reduced: p itself, p+1, 2^64-1
OVER = np.array([P, P + 1, (1 << 64) - 1], dtype=np.uint64)


def _pairs(extra=()):
    vals = np.concatenate([EDGE, np.asarray(extra, dtype=np.uint64)])
    a = np.array([x for x in vals for _ in vals], dtype=np.uint64)
    b = np.array([y for _ in vals for y in vals], dtype=np.uint64)
    rng = np.random.default_rng(7)
    n = 256 - a.shape[0]  # one shape for every case: one XLA compile per op
    ra = rng.integers(0, P, size=n, dtype=np.uint64)
    rb = rng.integers(0, P, size=n, dtype=np.uint64)
    return np.concatenate([a, ra]), np.concatenate([b, rb])


def _t(x):
    return tgf.from_u64(x, "cpu")


def test_roundtrip_and_limbs():
    fr = lazy_module("plonky2_tpu_torch.utils.from_reference")
    a, _ = _pairs(OVER)
    np.testing.assert_array_equal(tgf.to_u64(_t(a)), a)
    lo, hi = jgf.from_u64(a)
    np.testing.assert_array_equal(
        tgf.to_u64(fr.gf_from_limbs(np.asarray(lo), np.asarray(hi), "cpu")), a
    )
    lo2, hi2 = fr.gf_to_limbs(_t(a))
    np.testing.assert_array_equal(lo2, np.asarray(lo))
    np.testing.assert_array_equal(hi2, np.asarray(hi))


def test_device_none_means_gpu():
    import torch

    if torch.cuda.is_available():
        assert tgf.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            tgf.resolve_device(None)
        with pytest.raises(RuntimeError):
            tgf.from_u64(EDGE, None)
    assert tgf.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
@pytest.mark.parametrize("inputs", ["canonical", "unreduced"])
def test_binary_ops(op, inputs):
    a, b = _pairs(OVER if inputs == "unreduced" else ())
    want = jgf.to_u64(jax.jit(getattr(jgf, op))(jgf.from_u64(a), jgf.from_u64(b)))
    got = tgf.to_u64(getattr(tgf, op)(_t(a), _t(b)))
    np.testing.assert_array_equal(got, want)
    if inputs == "canonical":
        np.testing.assert_array_equal(got, getattr(gl, "np_" + op)(a, b))


@pytest.mark.parametrize("op", ["neg", "sqr"])
def test_unary_ops(op):
    a, _ = _pairs()
    want = jgf.to_u64(jax.jit(getattr(jgf, op))(jgf.from_u64(a)))
    np.testing.assert_array_equal(tgf.to_u64(getattr(tgf, op)(_t(a))), want)


@pytest.mark.parametrize("c", [0, 1, 7, P - 1, 123456789123456789, P + 5])
def test_mul_const(c):
    a, _ = _pairs()
    np.testing.assert_array_equal(
        tgf.to_u64(tgf.mul_const(_t(a), c)), gl.np_mul(a, np.uint64(c % P))
    )
    # a python-int second operand of mul is the same thing
    np.testing.assert_array_equal(
        tgf.to_u64(tgf.mul(_t(a), c % P)), gl.np_mul(a, np.uint64(c % P))
    )


def test_mul_const_vs_reference():
    a, _ = _pairs()
    c = 0xDEADBEEF12345678
    want = jgf.to_u64(jax.jit(lambda x: jgf.mul_const(x, c))(jgf.from_u64(a)))
    np.testing.assert_array_equal(tgf.to_u64(tgf.mul_const(_t(a), c)), want)


def test_exp_inv():
    a, _ = _pairs()
    a = a[a != 0][:64]
    want7 = jgf.to_u64(jax.jit(lambda x: jgf.exp_const(x, 7))(jgf.from_u64(a)))
    np.testing.assert_array_equal(tgf.to_u64(tgf.exp_const(_t(a), 7)), want7)
    np.testing.assert_array_equal(tgf.to_u64(tgf.exp_const(_t(a), 0)), np.ones_like(a))
    want_inv = jgf.to_u64(jax.jit(jgf.inv)(jgf.from_u64(a)))
    np.testing.assert_array_equal(tgf.to_u64(tgf.inv(_t(a))), want_inv)


def test_batch_inverse():
    rng = np.random.default_rng(11)
    a = rng.integers(1, P, size=(4, 9), dtype=np.uint64)  # small: the scan compiles slowly
    want = jgf.to_u64(jax.jit(jgf.batch_inverse)(jgf.from_u64(a)))
    got = tgf.to_u64(tgf.batch_inverse(_t(a)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gl.np_mul(a, got), np.ones_like(a))


def test_ext2_ops():
    rng = np.random.default_rng(13)
    a = rng.integers(0, P, size=(100, 2), dtype=np.uint64)
    b = rng.integers(0, P, size=(100, 2), dtype=np.uint64)
    s = rng.integers(0, P, size=(100,), dtype=np.uint64)
    want = jgf.to_u64(jax.jit(jgf.ext2_mul)(jgf.from_u64(a), jgf.from_u64(b)))
    np.testing.assert_array_equal(tgf.to_u64(tgf.ext2_mul(_t(a), _t(b))), want)
    for name in ("ext2_add", "ext2_sub"):
        want = jgf.to_u64(jax.jit(getattr(jgf, name))(jgf.from_u64(a), jgf.from_u64(b)))
        np.testing.assert_array_equal(tgf.to_u64(getattr(tgf, name)(_t(a), _t(b))), want)
    want = jgf.to_u64(jax.jit(jgf.ext2_scalar_mul)(jgf.from_u64(a), jgf.from_u64(s)))
    np.testing.assert_array_equal(tgf.to_u64(tgf.ext2_scalar_mul(_t(a), _t(s))), want)
    np.testing.assert_array_equal(
        tgf.to_u64(tgf.ext2_const((5, P - 1), "cpu")), jgf.to_u64(jgf.ext2_const((5, P - 1)))
    )


def test_sum_mod_p_long_axis():
    rng = np.random.default_rng(11)
    n = (1 << 16) + 7
    x = rng.integers(0, P, size=n, dtype=np.uint64)
    x[:5] = P - 1
    want = int(np.asarray(jgf.to_u64(jgf.sum_mod_p(jgf.from_u64(x)))))
    assert want == int(np.sum(x.astype(object)) % P)
    assert int(tgf.to_u64(tgf.sum_mod_p(_t(x)))) == want
    # the worst case for the half-word sums: every element p-1
    y = np.full(n, P - 1, dtype=np.uint64)
    assert int(tgf.to_u64(tgf.sum_mod_p(_t(y)))) == int(np.sum(y.astype(object)) % P)


def test_sum_weighted_prod():
    rng = np.random.default_rng(17)
    x = rng.integers(0, P, size=(9, 20), dtype=np.uint64)
    w = rng.integers(0, P, size=(9,), dtype=np.uint64)
    for axis in (0, 1):
        want = jgf.to_u64(jax.jit(jgf.sum_mod_p, static_argnums=1)(jgf.from_u64(x), axis))
        np.testing.assert_array_equal(tgf.to_u64(tgf.sum_mod_p(_t(x), axis)), want)
        want = jgf.to_u64(jax.jit(jgf.prod_mod_p, static_argnums=1)(jgf.from_u64(x), axis))
        np.testing.assert_array_equal(tgf.to_u64(tgf.prod_mod_p(_t(x), axis)), want)
    want = jgf.to_u64(jax.jit(jgf.weighted_sum)(jgf.from_u64(x), jgf.from_u64(w)))
    np.testing.assert_array_equal(tgf.to_u64(tgf.weighted_sum(_t(x), _t(w))), want)


def test_scans():
    rng = np.random.default_rng(19)
    x = int(rng.integers(0, P, dtype=np.uint64))
    n = 13  # small: XLA compiles associative scans slowly
    want = jgf.to_u64(jax.jit(jgf.powers_scan, static_argnums=1)(jgf.from_u64(np.uint64(x)), n))
    np.testing.assert_array_equal(tgf.to_u64(tgf.powers_scan(_t(np.uint64(x)), n)), want)
    np.testing.assert_array_equal(want, gl.np_powers(x, n))

    z = (int(rng.integers(0, P, dtype=np.uint64)), int(rng.integers(0, P, dtype=np.uint64)))
    # held against the host extension field (the reference's own scan costs
    # a long XLA compile and computes the same powers)
    got = tgf.to_u64(tgf.ext2_powers_scan(tgf.ext2_const(z, "cpu"), n))
    cur = ge.ext_one(2)
    for k in range(n):
        assert tuple(int(v) for v in got[k]) == cur
        cur = ge.ext_mul(cur, z)

    # the affine scan is held against the host extension field here and
    # against the reference through divide_by_linear_ext in test_torch_fri.py
    c = rng.integers(0, P, size=(n, 2), dtype=np.uint64)
    got = tgf.to_u64(tgf.ext2_affine_suffix_scan(_t(c), z))
    got_z = tgf.to_u64(tgf.ext2_affine_suffix_scan_z(_t(c), tgf.ext2_const(z, "cpu")))
    np.testing.assert_array_equal(got_z, got)
    acc = ge.ext_zero(2)
    for k in range(n):
        acc = ge.ext_add(ge.ext_mul(acc, z), tuple(int(v) for v in c[n - 1 - k]))
        assert tuple(int(v) for v in got[k]) == acc


def test_zeros_ones_full():
    assert tgf.to_u64(tgf.zeros((3,), "cpu")).tolist() == [0, 0, 0]
    assert tgf.to_u64(tgf.ones((2,), "cpu")).tolist() == [1, 1]
    np.testing.assert_array_equal(
        tgf.to_u64(tgf.full((2, 2), P + 3, "cpu")), jgf.to_u64(jgf.full((2, 2), P + 3))
    )


# ---------------------------------------------------------------------------
# The port alone against python integers: every pair of boundary values, one
# case each, so that a failure names the pair. These cost no XLA compile.
# ---------------------------------------------------------------------------

BOUNDARY = [
    0, 1, 2, 7, 1 << 31, gl.EPSILON - 1, gl.EPSILON, 1 << 32, (1 << 32) + 1, 1 << 48,
    1 << 63, (1 << 63) + 1, P // 2, P - (1 << 32), P - 2, P - 1,
]
_INT_OPS = {
    "add": lambda a, b: (a + b) % P,
    "sub": lambda a, b: (a - b) % P,
    "mul": lambda a, b: (a * b) % P,
}


def _scalar(v):
    return _t(np.array([v], dtype=np.uint64))


def _value(t):
    return int(tgf.to_u64(t).reshape(-1)[0])


@pytest.mark.parametrize("b", BOUNDARY, ids=hex)
@pytest.mark.parametrize("a", BOUNDARY, ids=hex)
@pytest.mark.parametrize("op", sorted(_INT_OPS))
def test_binary_op_boundary_pair(op, a, b):
    want = _INT_OPS[op](a, b)
    got = getattr(tgf, op)(_scalar(a), _scalar(b))
    assert _value(got) == want
    # the operation undone gives the first operand back
    if op == "add":
        assert _value(tgf.sub(got, _scalar(b))) == a
    elif op == "sub":
        assert _value(tgf.add(got, _scalar(b))) == a
    elif b != 0:
        assert _value(tgf.mul(got, tgf.inv(_scalar(b)))) == a
    # broadcast of a one-element operand against a vector
    rng = np.random.default_rng(a % 1000 + 3)
    v = rng.integers(0, P, size=5, dtype=np.uint64)
    got_v = tgf.to_u64(getattr(tgf, op)(_scalar(a), _t(v)))
    assert [int(x) for x in got_v] == [_INT_OPS[op](a, int(x)) for x in v]


@pytest.mark.parametrize("a", BOUNDARY, ids=hex)
@pytest.mark.parametrize("op", ["neg", "sqr", "inv"])
def test_unary_op_boundary_value(op, a):
    want = {"neg": (-a) % P, "sqr": a * a % P, "inv": pow(a, P - 2, P)}[op]
    assert _value(getattr(tgf, op)(_scalar(a))) == want
    if op == "inv" and a:
        assert _value(tgf.mul(tgf.inv(_scalar(a)), _scalar(a))) == 1


@pytest.mark.parametrize("c", BOUNDARY, ids=hex)
def test_mul_const_boundary_constant(c):
    vals = np.array(BOUNDARY, dtype=np.uint64)
    got = tgf.to_u64(tgf.mul_const(_t(vals), c))
    assert [int(x) for x in got] == [v * c % P for v in BOUNDARY]


@pytest.mark.parametrize("e", [0, 1, 2, 3, 7, 8, 63, 64, 65, (1 << 32) - 1, 1 << 32, P - 2, P - 1])
def test_exp_const_exponent(e):
    vals = np.array(BOUNDARY, dtype=np.uint64)
    got = tgf.to_u64(tgf.exp_const(_t(vals), e))
    assert [int(x) for x in got] == [pow(v, e, P) for v in BOUNDARY]


@pytest.mark.parametrize("n", [1, 2, 3, 31, 32, 33, 255, 256, 257, 4095, 4096, 4097])
def test_sum_mod_p_length(n):
    rng = np.random.default_rng(n)
    x = rng.integers(0, P, size=(n, 3), dtype=np.uint64)
    x[:, 2] = P - 1  # the largest element in every row
    got = tgf.to_u64(tgf.sum_mod_p(_t(x), 0))
    assert [int(v) for v in got] == [int(np.sum(x[:, j].astype(object)) % P) for j in range(3)]
    got = tgf.to_u64(tgf.sum_mod_p(_t(np.ascontiguousarray(x.T)), 1))
    assert [int(v) for v in got] == [int(np.sum(x[:, j].astype(object)) % P) for j in range(3)]


@pytest.mark.parametrize("shape", [(1,), (2,), (3,), (7,), (8,), (9,), (5, 5), (2, 3, 4), (64,), (65,)],
                         ids=str)
def test_batch_inverse_shape(shape):
    rng = np.random.default_rng(len(shape) * 100 + shape[0])
    a = rng.integers(1, P, size=shape, dtype=np.uint64)
    a.reshape(-1)[0] = P - 1
    got = tgf.to_u64(tgf.batch_inverse(_t(a)))
    assert got.shape == a.shape
    assert [int(v) for v in got.reshape(-1)] == [pow(int(v), P - 2, P) for v in a.reshape(-1)]
    np.testing.assert_array_equal(got, tgf.to_u64(tgf.inv(_t(a))))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 13, 16, 17, 100])
def test_powers_scan_length(n):
    for x in (0, 1, 7, P - 1, 0x123456789ABCDEF0 % P):
        got = tgf.to_u64(tgf.powers_scan(_t(np.uint64(x)), n))
        assert [int(v) for v in got] == [pow(x, k, P) for k in range(n)]
        z = (x, (x * 3 + 1) % P)
        got = tgf.to_u64(tgf.ext2_powers_scan(tgf.ext2_const(z, "cpu"), n))
        cur = ge.ext_one(2)
        for k in range(n):
            assert tuple(int(v) for v in got[k]) == cur
            cur = ge.ext_mul(cur, z)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("op", ["ext2_add", "ext2_sub", "ext2_mul", "ext2_scalar_mul"])
def test_ext2_op_vs_host_extension(op, seed):
    rng = np.random.default_rng(1000 + seed)
    a = rng.integers(0, P, size=(6, 2), dtype=np.uint64)
    b = rng.integers(0, P, size=(6, 2), dtype=np.uint64)
    a[0] = (P - 1, P - 1)
    b[0] = (P - 1, P - 1)
    a[1] = 0
    if op == "ext2_scalar_mul":
        got = tgf.to_u64(tgf.ext2_scalar_mul(_t(a), _t(b[:, 0])))
        want = [(int(x[0]) * int(s) % P, int(x[1]) * int(s) % P) for x, s in zip(a, b[:, 0])]
    else:
        got = tgf.to_u64(getattr(tgf, op)(_t(a), _t(b)))
        host = getattr(ge, "ext_" + op[len("ext2_"):])
        want = [host(tuple(int(v) for v in x), tuple(int(v) for v in y)) for x, y in zip(a, b)]
    assert [tuple(int(v) for v in row) for row in got] == [tuple(w) for w in want]


@pytest.mark.parametrize("n", [1, 2, 3, 8, 13, 32])
def test_affine_suffix_scan_length(n):
    rng = np.random.default_rng(50 + n)
    z = (int(rng.integers(0, P, dtype=np.uint64)), int(rng.integers(0, P, dtype=np.uint64)))
    c = rng.integers(0, P, size=(n, 2), dtype=np.uint64)
    got = tgf.to_u64(tgf.ext2_affine_suffix_scan(_t(c), z))
    acc = ge.ext_zero(2)
    for k in range(n):
        acc = ge.ext_add(ge.ext_mul(acc, z), tuple(int(v) for v in c[n - 1 - k]))
        assert tuple(int(v) for v in got[k]) == acc


# ---------------------------------------------------------------------------
# gf.mul's three call forms (the product kernel of ops/field_cuda.py takes
# each without an expanded copy); on the CPU they reach mul_plain
# ---------------------------------------------------------------------------

MUL_FORMS = {
    "same_shape": ((3, 4, 8), (3, 4, 8)),
    "broadcast_leading": ((3, 4, 8), (8,)),
    "broadcast_inner": ((3, 4, 8), (4, 1)),
    "broadcast_both": ((5, 1, 8), (1, 4, 1)),
    "int": ((3, 4, 8), None),
}


@pytest.mark.parametrize("form", sorted(MUL_FORMS))
def test_mul_plain_form_vs_reference(form):
    a_shape, b_shape = MUL_FORMS[form]
    rng = np.random.default_rng(len(form))
    a = rng.integers(0, P, size=a_shape, dtype=np.uint64)
    a.reshape(-1)[: EDGE.shape[0]] = EDGE
    if b_shape is None:
        for c in (0, 1, 7, P - 1, 0x1234_5678_9ABC_DEF0):
            want = jgf.to_u64(jgf.mul_const(jgf.from_u64(a), c))
            np.testing.assert_array_equal(tgf.to_u64(tgf.mul_plain(_t(a), c)), want)
            np.testing.assert_array_equal(tgf.to_u64(tgf.mul(_t(a), c)), want)
        return
    b = rng.integers(0, P, size=b_shape, dtype=np.uint64)
    b.reshape(-1)[:2] = [P - 1, 0]
    shape = np.broadcast_shapes(a_shape, b_shape)
    want = jgf.to_u64(jgf.mul(
        jgf.from_u64(np.broadcast_to(a, shape).copy()),
        jgf.from_u64(np.broadcast_to(b, shape).copy()),
    ))
    np.testing.assert_array_equal(tgf.to_u64(tgf.mul_plain(_t(a), _t(b))), want)
    np.testing.assert_array_equal(tgf.to_u64(tgf.mul(_t(a), _t(b))), want)


field_cuda = lazy_module("plonky2_tpu_torch.ops.field_cuda")


@pytest.mark.parametrize(
    "shape, strides, want",
    [
        ((3, 4, 8), [(32, 8, 1), (32, 8, 1)], ([96], [[1], [1]])),
        ((3, 4, 8), [(32, 8, 1), (0, 0, 1)], ([12, 8], [[8, 1], [0, 1]])),
        ((3, 4, 8), [(32, 8, 1), (0, 1, 0)], ([3, 4, 8], [[32, 8, 1], [0, 1, 0]])),
        ((1, 5, 1), [(5, 1, 1), (0, 0, 0)], ([5], [[1], [0]])),
        ((1, 1), [(1, 1), (1, 1)], ([1], [[0], [0]])),
        ((4, 6), [(12, 2), (0, 0)], ([24], [[2], [0]])),
        ((4, 6), [(14, 2), (0, 1)], ([4, 6], [[14, 2], [0, 1]])),
        ((2, 3, 4), [(1, 8, 2), (12, 4, 1)], ([2, 12], [[1, 2], [12, 1]])),
    ],
)
def test_mul_kernel_merges_axes(shape, strides, want):
    """The product kernel's wrapper hands over as few axes as the two
    operands' strides allow; a merged axis is a plain reshape of both."""
    assert field_cuda.merge_axes(shape, *strides) == (want[0], want[1])


def test_mul_kernel_refuses_cpu_tensors_and_counts_no_cpu_launch():
    import torch

    before = dict(field_cuda.LAUNCHES)
    with pytest.raises(ValueError):
        field_cuda.mul(torch.zeros(4, dtype=torch.int64), 3)
    tgf.mul(torch.zeros(4, dtype=torch.int64), torch.ones(4, dtype=torch.int64))
    tgf.mul(torch.zeros(4, dtype=torch.int64), 5)
    assert field_cuda.LAUNCHES == before


@pytest.mark.parametrize(
    "sizes, strides, wide",
    [
        # the widest product of the main paths: 32-bit offsets
        ([143, 32, 32, 512], [[524288, 16384, 512, 1], [0, 512, 0, 1]], False),
        # chip_smoke.py's 64-bit-index forms over a 2^31 + 2^20-word buffer
        ([2, 1024], [[1 << 31, 1], [0, 1]], True),
        ([3, 1000], [[(1 << 30) + 7, 1], [1000, 1]], True),
        ([1024], [[2_099_203], [0]], True),
        # one word under and at 2^31: the output's offsets decide alone
        ([(1 << 31) - 1], [[1], [1]], False),
        ([1 << 31], [[1], [0]], True),
        # an operand's last offset 2^31 - 1 (span 2^31)
        ([2, 8], [[(1 << 31) - 8, 1], [8, 1]], True),
        ([2, 8], [[(1 << 31) - 9, 1], [8, 1]], False),
    ],
)
def test_mul_kernel_takes_the_wide_index_past_2_31(sizes, strides, wide):
    """The product kernel's 64-bit-index instantiation is taken exactly
    when an offset of the output or an operand reaches 2^31."""
    assert field_cuda.wide_index(sizes, *strides) is wide

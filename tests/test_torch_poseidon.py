"""plonky2_tpu_torch.ops.poseidon (plain PyTorch versions, on the CPU) against
plonky2_tpu.ops.poseidon (the XLA path, which is what the JAX package runs
on the CPU), the host Poseidon and the reference permutation vectors.
Tolerance: none — integer equality of u64 values."""

import re
from pathlib import Path

import jax
import numpy as np
import pytest

from plonky2_tpu.ops import gf as jgf
from plonky2_tpu.ops import poseidon as jdp
from plonky2_tpu.field.goldilocks import P
from _torch_port import lazy_module

hp = lazy_module("plonky2_tpu_torch.hash.poseidon")
pc = lazy_module("plonky2_tpu_torch.hash.poseidon_constants")
tgf = lazy_module("plonky2_tpu_torch.ops.gf")
tdp = lazy_module("plonky2_tpu_torch.ops.poseidon")
poseidon_cuda = lazy_module("plonky2_tpu_torch.ops.poseidon_cuda")
cuda_build = lazy_module("plonky2_tpu_torch.ops.cuda_build")

# (input, expected) pairs from the reference implementation's test suite
# (core/src/poseidon_goldilocks.rs; the same values as tests/test_poseidon.py)
VECTORS = [
    (
        [0] * 12,
        [
            0x3C18A9786CB0B359, 0xC4055E3364A246C3, 0x7953DB0AB48808F4, 0xC71603F33A1144CA,
            0xD7709673896996DC, 0x46A84E87642F44ED, 0xD032648251EE0B3C, 0x1C687363B207DF62,
            0xDF8565563E8045FE, 0x40F5B37FF4254DAE, 0xD070F637B431067C, 0x1792B1C4342109D7,
        ],
    ),
    (
        list(range(12)),
        [
            0xD64E1E3EFC5B8E9E, 0x53666633020AAA47, 0xD40285597C6A8825, 0x613A4F81E81231D2,
            0x414754BFEBD051F0, 0xCB1F8980294A023F, 0x6EB2A9E4D54A9D0F, 0x1902BC3AF467E056,
            0xF045D5EAFDC6021F, 0xE4150F77CAAA3BE5, 0xC9BFD01D39B50CCE, 0x5C0A27FCB0E1459B,
        ],
    ),
    (
        [P - 1] * 12,
        [
            0xBE0085CFC57A8357, 0xD95AF71847D05C09, 0xCF55A13D33C1C953, 0x95803A74F4530E82,
            0xFCD99EB30A135DF1, 0xE095905E913A3029, 0xDE0392461B42919B, 0x7D3260E24E81D031,
            0x10D3D0465D9DEAA0, 0xA87571083DFC2A47, 0xE18263681E9958F8, 0xE28E96F1AE5E60D3,
        ],
    ),
    (
        [
            0x8CCBBBEA4FE5D2B7, 0xC2AF59EE9EC49970, 0x90F7E1A9E658446A, 0xDCC0630A3AB8B1B8,
            0x7FF8256BCA20588C, 0x5D99A7CA0C44ECFB, 0x48452B17A70FBEE3, 0xEB09D654690B6C88,
            0x4A55D3A39C676A88, 0xC0407A38D2285139, 0xA234BAC9356386D1, 0xE1633F2BAD98A52F,
        ],
        None,  # expected output taken from the host permutation below
    ),
]


def _t(x):
    return tgf.from_u64(x, "cpu")


def _states(b=17, seed=5):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, P, size=(b, 12), dtype=np.uint64)
    s[0] = 0
    s[1] = P - 1
    s[2, ::2] = P - 1
    s[2, 1::2] = 0
    return s


def test_permutation_vectors():
    for inp, expected in VECTORS:
        if expected is None:
            expected = hp.permute(inp)
        want = [x % P for x in expected]
        assert hp.permute(inp) == want
        got = tgf.to_u64(tdp.permute(_t(np.array([inp], dtype=np.uint64))))[0]
        assert [int(x) for x in got] == want
        got_plain = tgf.to_u64(tdp.permute_plain(_t(np.array([inp], dtype=np.uint64))))[0]
        assert [int(x) for x in got_plain] == want


def test_permute_vs_reference_and_host():
    s = _states()
    want = jgf.to_u64(jax.jit(jdp.permute)(jgf.from_u64(s)))
    got = tgf.to_u64(tdp.permute(_t(s)))
    np.testing.assert_array_equal(got, want)
    for i in range(s.shape[0]):
        assert [int(x) for x in got[i]] == hp.permute([int(x) for x in s[i]])


def test_permute_t_and_leading_dims():
    s = _states(b=16)
    want = jgf.to_u64(jax.jit(jdp.permute_t)(jgf.from_u64(np.ascontiguousarray(s.T))))
    np.testing.assert_array_equal(tgf.to_u64(tdp.permute_t(_t(s).T)), want)
    # [..., 12] with leading dims
    got = tgf.to_u64(tdp.permute(_t(s).reshape(4, 4, 12)))
    np.testing.assert_array_equal(got.reshape(16, 12), want.T)


@pytest.mark.parametrize("w", [3, 8, 13, 20])
@pytest.mark.parametrize("cap", ["zero", "w+1"])
def test_sponge_t_vs_reference(w, cap):
    rng = np.random.default_rng(100 + w)
    cap_val = 0 if cap == "zero" else w + 1
    x = rng.integers(0, P, size=(w, 16), dtype=np.uint64)
    lo, hi = jgf.from_u64(x)
    want = jgf.to_u64(jax.jit(jdp._sponge_t, static_argnums=2)(lo, hi, cap_val))
    got = tgf.to_u64(tdp.load()._sponge_t(_t(x), cap_val))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tgf.to_u64(tdp.sponge(_t(x).T, cap_val)), want)
    np.testing.assert_array_equal(
        tgf.to_u64(tdp.sponge_plain(_t(np.ascontiguousarray(x.T)), cap_val)), want
    )


@pytest.mark.parametrize("w", [1, 4, 8, 9, 16, 20])
def test_hash_leaf_and_no_pad_vs_host(w):
    rng = np.random.default_rng(6 + w)
    leaves = rng.integers(0, P, size=(5, w), dtype=np.uint64)
    d = tgf.to_u64(tdp.hash_leaf(_t(leaves)))
    h = tgf.to_u64(tdp.hash_no_pad_batch(_t(leaves)))
    for i in range(5):
        row = [int(x) for x in leaves[i]]
        assert tuple(int(x) for x in d[i]) == hp.hash_leaf(row)
        assert tuple(int(x) for x in h[i]) == tuple(hp.hash_no_pad(row))


def test_hash_leaf_two_to_one_no_pad_vs_reference():
    rng = np.random.default_rng(8)
    leaves = rng.integers(0, P, size=(16, 13), dtype=np.uint64)  # shapes shared with the sponge test
    want = jgf.to_u64(jax.jit(jdp.hash_leaf)(jgf.from_u64(leaves)))
    np.testing.assert_array_equal(tgf.to_u64(tdp.hash_leaf(_t(leaves))), want)
    want = jgf.to_u64(jax.jit(jdp.hash_no_pad_batch)(jgf.from_u64(leaves)))
    np.testing.assert_array_equal(tgf.to_u64(tdp.hash_no_pad_batch(_t(leaves))), want)
    left = rng.integers(0, P, size=(16, 4), dtype=np.uint64)
    right = rng.integers(0, P, size=(16, 4), dtype=np.uint64)
    want = jgf.to_u64(jax.jit(jdp.two_to_one)(jgf.from_u64(left), jgf.from_u64(right)))
    got = tgf.to_u64(tdp.two_to_one(_t(left), _t(right)))
    np.testing.assert_array_equal(got, want)
    for i in range(16):
        assert tuple(int(x) for x in got[i]) == hp.two_to_one(
            tuple(int(x) for x in left[i]), tuple(int(x) for x in right[i])
        )


def test_leaf_domain_separation():
    x = np.zeros((1, 8), dtype=np.uint64)
    a = tgf.to_u64(tdp.hash_leaf(_t(x)))
    b = tgf.to_u64(tdp.hash_no_pad_batch(_t(x)))
    assert not np.array_equal(a, b)


def _header_u64_table(text, name):
    m = re.search(rf"__constant__ uint64_t {name}\[(\d+)\] = \{{([^}}]*)\}}", text)
    values = [int(h, 16) for h in re.findall(r"0x([0-9a-fA-F]{16})ULL", m.group(2))]
    assert len(values) == int(m.group(1))
    return values


def _flat(rows):
    return [v for row in rows for v in row]


# each table compiled into the kernels: (header name, the port's Python
# table, the JAX package's table), all as flat lists of ints
HEADER_TABLES = {
    "POSEIDON_RC": lambda pf, c: [x % P for x in c.ALL_ROUND_CONSTANTS],
    "POSEIDON_FAST_FIRST_RC": lambda pf, c: list(pf.FAST_PARTIAL_FIRST_ROUND_CONSTANT),
    "POSEIDON_FAST_RC": lambda pf, c: list(pf.FAST_PARTIAL_ROUND_CONSTANTS),
    "POSEIDON_FAST_INIT": lambda pf, c: _flat(pf.FAST_PARTIAL_ROUND_INITIAL_MATRIX),
    "POSEIDON_FAST_W_HATS": lambda pf, c: _flat(pf.FAST_PARTIAL_ROUND_W_HATS),
    "POSEIDON_FAST_VS": lambda pf, c: _flat(pf.FAST_PARTIAL_ROUND_VS),
}


@pytest.mark.parametrize("table", list(HEADER_TABLES) + ["POSEIDON_MDS"])
def test_cuda_constants_header_matches_python(table):
    """Each table compiled into the kernels equals the port's Python table,
    which equals the JAX package's (hash/poseidon_constants.py,
    hash/poseidon_fast.py)."""
    from plonky2_tpu.hash import poseidon_constants as jpc
    from plonky2_tpu.hash import poseidon_fast as jpf

    tpf = lazy_module("plonky2_tpu_torch.hash.poseidon_fast")
    text = (Path(cuda_build.CSRC) / "poseidon_constants.cuh").read_text()
    if table == "POSEIDON_MDS":
        circ = re.search(r"#define POSEIDON_MDS_CIRC \{([^}]*)\}", text).group(1)
        diag = re.search(r"#define POSEIDON_MDS_DIAG \{([^}]*)\}", text).group(1)
        assert [int(v) for v in circ.split(",")] == pc.MDS_MATRIX_CIRC == jpc.MDS_MATRIX_CIRC
        assert [int(v) for v in diag.split(",")] == pc.MDS_MATRIX_DIAG == jpc.MDS_MATRIX_DIAG
        for name, val in (("POSEIDON_HALF_FULL_ROUNDS", pc.HALF_N_FULL_ROUNDS),
                          ("POSEIDON_PARTIAL_ROUNDS", pc.N_PARTIAL_ROUNDS),
                          ("POSEIDON_ROUNDS", pc.N_ROUNDS),
                          ("POSEIDON_MDS_0_0", tpf.MDS_0_0)):
            assert re.search(rf"#define {name} {val}\b", text)
        return
    compiled = _header_u64_table(text, table)
    port = HEADER_TABLES[table](tpf, pc)
    assert compiled == port
    assert port == HEADER_TABLES[table](jpf, jpc)
    assert all(0 <= v < P for v in compiled)


def test_cuda_constants_header_is_generated():
    """The header is exactly what ops/gen_poseidon_constants.py writes."""
    gen = lazy_module("plonky2_tpu_torch.ops.gen_poseidon_constants")
    assert gen.HEADER.read_text() == gen.render()


def test_kernel_wrappers_refuse_cpu_tensors():
    """The binding raises on what the kernel does not take, before it
    builds anything; the dispatch sends CPU tensors to the plain version
    and counts no launch."""
    import torch

    before = dict(poseidon_cuda.LAUNCHES)
    with pytest.raises(ValueError):
        poseidon_cuda.permute(torch.zeros((2, 12), dtype=torch.int64))
    with pytest.raises(ValueError):
        poseidon_cuda.sponge(torch.zeros((2, 5), dtype=torch.int64), 0)
    with pytest.raises(ValueError):
        poseidon_cuda.compress(torch.zeros((2, 8), dtype=torch.int64))
    tdp.permute(torch.zeros((2, 12), dtype=torch.int64))
    tdp.sponge(torch.zeros((2, 5), dtype=torch.int64), 6)
    tdp.compress_pairs(torch.zeros((4, 4), dtype=torch.int64))
    assert poseidon_cuda.LAUNCHES == before


# ---------------------------------------------------------------------------
# The plain versions against the host Poseidon, one case per width or seed
# (no XLA compile): every sponge width up to five permutations, the widths
# of the standard config's leaf matrices, and both capacity conventions.
# ---------------------------------------------------------------------------

SPONGE_WIDTHS = list(range(1, 41)) + [64, 85, 135, 143]


@pytest.mark.parametrize("cap", ["zero", "w+1"])
@pytest.mark.parametrize("w", SPONGE_WIDTHS)
def test_sponge_width_vs_host(w, cap):
    rng = np.random.default_rng(2000 + w)
    rows = rng.integers(0, P, size=(2, w), dtype=np.uint64)
    rows[1, -1] = P - 1
    got = tgf.to_u64(tdp.sponge(_t(rows), 0 if cap == "zero" else w + 1))
    host = hp.hash_no_pad if cap == "zero" else hp.hash_leaf
    for i in range(2):
        assert tuple(int(x) for x in got[i]) == tuple(host([int(x) for x in rows[i]]))


@pytest.mark.parametrize("seed", range(24))
def test_permute_seed_vs_host(seed):
    s = _states(b=4, seed=300 + seed)
    got = tgf.to_u64(tdp.permute(_t(s)))
    got_t = tgf.to_u64(tdp.permute_t(_t(np.ascontiguousarray(s.T))))
    np.testing.assert_array_equal(got_t.T, got)
    for i in range(4):
        assert [int(x) for x in got[i]] == hp.permute([int(x) for x in s[i]])


@pytest.mark.parametrize("seed", range(12))
def test_two_to_one_seed_vs_host(seed):
    rng = np.random.default_rng(400 + seed)
    left = rng.integers(0, P, size=(3, 4), dtype=np.uint64)
    right = rng.integers(0, P, size=(3, 4), dtype=np.uint64)
    left[0] = P - 1
    right[1] = 0
    got = tgf.to_u64(tdp.two_to_one(_t(left), _t(right)))
    for i in range(3):
        assert tuple(int(x) for x in got[i]) == hp.two_to_one(
            tuple(int(x) for x in left[i]), tuple(int(x) for x in right[i])
        )


# ---------------------------------------------------------------------------
# The fast-round plain permutation and the two-to-one compression
# ---------------------------------------------------------------------------

# states at the edges of the kernels' lazy reduction: every lane p - 1 (=
# 2^64 - 2^32), 2^32 - 1, 2^32, 2^63, 1, 0 / p - 1 alternating
EDGE_STATES = {
    "p-1": [P - 1] * 12,
    "2^32-1": [(1 << 32) - 1] * 12,
    "2^32": [1 << 32] * 12,
    "2^63": [1 << 63] * 12,
    "one": [1] * 12,
    "0/p-1": [0, P - 1] * 6,
    "p-1/0": [P - 1, 0] * 6,
    "p-2/2^32-1": [P - 2, (1 << 32) - 1] * 6,
}


@pytest.mark.parametrize("name", sorted(EDGE_STATES))
def test_permute_edge_state_vs_host(name):
    state = EDGE_STATES[name]
    got = tgf.to_u64(tdp.permute_plain(_t(np.array([state], dtype=np.uint64))))[0]
    assert [int(x) for x in got] == hp.permute(state)


@pytest.mark.parametrize("seed", range(4))
def test_permute_plain_seed_vs_reference(seed):
    """The fast-round plain permutation against the JAX package's permute
    (one XLA compile a worker: the shape is the same in every case)."""
    s = _states(b=8, seed=700 + seed)
    want = jgf.to_u64(jax.jit(jdp.permute)(jgf.from_u64(s)))
    np.testing.assert_array_equal(tgf.to_u64(tdp.permute_plain(_t(s))), want)


def test_partial_rounds_plain_vs_host_fast_layers():
    """The plain partial rounds equal hash/poseidon_fast.py's layers run
    on python integers, from the state after the first four full rounds."""
    pf = lazy_module("plonky2_tpu_torch.hash.poseidon_fast").load()
    s = _states(b=3, seed=710)
    t = tdp.load()._tables("cpu")
    x = _t(s)
    for r in range(4):
        x = tdp.load()._full_round(x, t["rc"][r])
    got = tgf.to_u64(tdp.load()._partial_rounds_plain(x, t))
    A = pf._IntAlgebra()
    for i, row in enumerate(tgf.to_u64(x)):
        h = pf.partial_first_constant_layer(A, [int(v) for v in row])
        h = pf.mds_partial_layer_init(A, h)
        for r in range(pf.N_PARTIAL_ROUNDS):
            h[0] = hp.load()._sbox(h[0])
            if r < pf.N_PARTIAL_ROUNDS - 1:
                h[0] = (h[0] + pf.FAST_PARTIAL_ROUND_CONSTANTS[r]) % P
            h = pf.mds_partial_layer_fast(A, h, r)
        assert [int(v) for v in got[i]] == h


@pytest.mark.parametrize("seed", range(12))
def test_compress_pairs_seed_vs_host(seed):
    rng = np.random.default_rng(800 + seed)
    level = rng.integers(0, P, size=(6, 4), dtype=np.uint64)
    level[0] = P - 1
    level[3] = 0
    got = tgf.to_u64(tdp.compress_pairs(_t(level)))
    np.testing.assert_array_equal(tgf.to_u64(tdp.compress_pairs_plain(_t(level))), got)
    assert got.shape == (3, 4)
    for i in range(3):
        assert tuple(int(x) for x in got[i]) == hp.two_to_one(
            tuple(int(x) for x in level[2 * i]), tuple(int(x) for x in level[2 * i + 1])
        )


def test_compress_pairs_vs_reference():
    rng = np.random.default_rng(820)
    level = rng.integers(0, P, size=(32, 4), dtype=np.uint64)
    # shapes shared with test_hash_leaf_two_to_one_no_pad_vs_reference
    want = jgf.to_u64(jax.jit(jdp.two_to_one)(jgf.from_u64(level[0::2]), jgf.from_u64(level[1::2])))
    np.testing.assert_array_equal(tgf.to_u64(tdp.compress_pairs(_t(level))), want)
    np.testing.assert_array_equal(tgf.to_u64(tdp.compress_pairs_plain(_t(level))), want)

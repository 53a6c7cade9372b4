"""Commitment path of the port against the JAX package on one small batch:
LDE leaves, every Merkle level and the cap, PolynomialBatch.from_values,
batched Merkle paths; proofs verify on both sides. Tolerance: none."""

import numpy as np
import pytest

from plonky2_tpu.fri import oracle as jfo
from plonky2_tpu.ops import fri_kernels as jfk
from plonky2_tpu.ops import gf as jgf
from plonky2_tpu.ops import merkle as jmk
from plonky2_tpu.field.goldilocks import P
from _torch_port import lazy_module

tfo = lazy_module("plonky2_tpu_torch.fri.oracle")
tfk = lazy_module("plonky2_tpu_torch.ops.fri_kernels")
tgf = lazy_module("plonky2_tpu_torch.ops.gf")
tmk = lazy_module("plonky2_tpu_torch.ops.merkle")
fr = lazy_module("plonky2_tpu_torch.utils.from_reference")

M, N_LOG, RATE_BITS, CAP_HEIGHT = 5, 6, 3, 2
QUERIES = np.array([0, 1, 77, 300, 511, 77])


@pytest.fixture(scope="module")
def both():
    rng = np.random.default_rng(3)
    values = rng.integers(0, P, size=(M, 1 << N_LOG), dtype=np.uint64)
    jb = jfo.PolynomialBatch.from_values(jgf.from_u64(values), RATE_BITS, False, CAP_HEIGHT)
    tb = tfo.PolynomialBatch.from_values(values, RATE_BITS, False, CAP_HEIGHT, device="cpu")
    return values, jb, tb


def _t(x):
    return tgf.from_u64(x, "cpu")


def test_coefficients_and_lde_leaves(both):
    _, jb, tb = both
    coeffs = jgf.to_u64(jb.polynomials)
    np.testing.assert_array_equal(tgf.to_u64(tb.polynomials), coeffs)
    want = jgf.to_u64(jfk.lde_leaves(jb.polynomials, RATE_BITS))
    got = tfk.lde_leaves(_t(coeffs), RATE_BITS)
    assert got.is_contiguous() and tuple(got.shape) == (1 << (N_LOG + RATE_BITS), M)
    np.testing.assert_array_equal(tgf.to_u64(got), want)
    np.testing.assert_array_equal(tgf.to_u64(tb.merkle_tree.leaves), want)


def test_merkle_levels_and_cap(both):
    _, jb, tb = both
    jl, tl = jb.merkle_tree.levels, tb.merkle_tree.levels
    assert len(jl) == len(tl) == N_LOG + RATE_BITS - CAP_HEIGHT + 1
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(tgf.to_u64(b), jgf.to_u64(a))
    np.testing.assert_array_equal(tb.cap_u64(), jb.cap_u64())
    assert tb.cap_u64().shape == (1 << CAP_HEIGHT, 4)
    # build_merkle_tree on the leaves alone gives the same tree
    tree = tmk.build_merkle_tree(tb.merkle_tree.leaves, CAP_HEIGHT)
    np.testing.assert_array_equal(tree.cap_u64(), jb.cap_u64())
    assert tree.num_leaves == 1 << (N_LOG + RATE_BITS)


def test_from_coeffs_matches_from_values(both):
    _, jb, tb = both
    again = tfo.PolynomialBatch.from_coeffs(
        jgf.to_u64(jb.polynomials), RATE_BITS, False, CAP_HEIGHT, device="cpu"
    )
    np.testing.assert_array_equal(again.cap_u64(), tb.cap_u64())
    assert again.num_polys == M and again.degree_log == N_LOG


def test_prove_batch_and_leaf_gathers(both):
    _, jb, tb = both
    jp = jb.merkle_tree.prove_batch(QUERIES)
    tp = tb.merkle_tree.prove_batch(QUERIES)
    assert tp.shape == (len(QUERIES), N_LOG + RATE_BITS - CAP_HEIGHT, 4)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(
        tb.merkle_tree.leaf_u64_batch(QUERIES), jb.merkle_tree.leaf_u64_batch(QUERIES)
    )
    np.testing.assert_array_equal(tb.merkle_tree.leaf_u64(77), jb.merkle_tree.leaf_u64(77))
    assert tb.merkle_tree.prove(300) == jb.merkle_tree.prove(300)
    assert tb.get_lde_values(5) == jb.get_lde_values(5)


def test_merkle_proofs_verify_on_both_sides(both):
    _, jb, tb = both
    cap = tb.cap_u64()
    for q in (0, 77, 511):
        leaf = [int(x) for x in tb.merkle_tree.leaf_u64(q)]
        path = tb.merkle_tree.prove(q)
        assert tmk.verify_merkle_proof(leaf, q, cap, path)
        assert jmk.verify_merkle_proof(leaf, q, jb.cap_u64(), path)
        assert not tmk.verify_merkle_proof(leaf, q ^ 1, cap, path)
        bad = [leaf[0] ^ 1] + leaf[1:]
        assert not tmk.verify_merkle_proof(bad, q, cap, path)


def test_cap_height_equal_to_tree_height():
    rng = np.random.default_rng(4)
    leaves = rng.integers(0, P, size=(4, 3), dtype=np.uint64)
    tree = tmk.build_merkle_tree(leaves, 2, device="cpu")  # numpy in
    assert len(tree.levels) == 1
    assert tree.prove_batch(np.array([1, 2])).shape == (2, 0, 4)
    jt = jmk.build_merkle_tree(jgf.from_u64(leaves), 2)
    np.testing.assert_array_equal(tree.cap_u64(), jt.cap_u64())


def test_eval_all_at_ext(both):
    _, jb, tb = both
    zeta = (1234567, 7654321)
    assert tb.eval_all_at_ext(zeta) == jb.eval_all_at_ext(zeta)
    np.testing.assert_array_equal(tfo.ext_powers_np(zeta, 37), jfo.ext_powers_np(zeta, 37))


def test_polynomial_batch_from_reference(both):
    """The JAX package's committed batch, handed over as arrays."""
    _, jb, tb = both
    t = jb.merkle_tree
    carried = fr.polynomial_batch_from_reference(
        jgf.to_u64(jb.polynomials),
        jgf.to_u64(t.leaves),
        [jgf.to_u64(l) for l in t.levels],
        jb.degree_log, jb.rate_bits, t.cap_height, jb.n_polys, "cpu",
    )
    np.testing.assert_array_equal(carried.cap_u64(), tb.cap_u64())
    np.testing.assert_array_equal(carried.merkle_tree.prove_batch(QUERIES),
                                  tb.merkle_tree.prove_batch(QUERIES))
    assert carried.eval_all_at_ext((5, 6)) == tb.eval_all_at_ext((5, 6))


def test_blinded_commitment_equals_reference(both, monkeypatch):
    """A blinded (zero-knowledge) commitment: SALT_SIZE salt columns after
    the LDE columns of every leaf, drawn from PLONKY2_TPU_SALT_SEED as the
    JAX package draws them; the leaves, the cap and the blinded flag equal
    the reference's, and the quotient's natural-order values drop the
    salts."""
    values, jb, _ = both
    monkeypatch.setenv("PLONKY2_TPU_SALT_SEED", "77")
    jz = jfo.PolynomialBatch.from_values(jgf.from_u64(values), RATE_BITS, True, CAP_HEIGHT)
    tz = tfo.PolynomialBatch.from_values(values, RATE_BITS, True, CAP_HEIGHT, device="cpu")
    assert tz.blinding and tz.salt_size == 4 and tz.num_polys == M
    leaves = tgf.to_u64(tz.merkle_tree.leaves)
    assert leaves.shape == (1 << (N_LOG + RATE_BITS), M + 4)
    np.testing.assert_array_equal(leaves, jgf.to_u64(jz.merkle_tree.leaves))
    np.testing.assert_array_equal(tz.cap_u64(), jz.cap_u64())
    np.testing.assert_array_equal(leaves[:, :M], jgf.to_u64(jb.merkle_tree.leaves))
    from plonky2_tpu_torch.plonk.prover import _natural_order_values

    nat = tgf.to_u64(_natural_order_values(tz))
    assert nat.shape == (M, 1 << (N_LOG + RATE_BITS))
    monkeypatch.delenv("PLONKY2_TPU_SALT_SEED")
    again = tfo.PolynomialBatch.from_values(values, RATE_BITS, True, CAP_HEIGHT, device="cpu")
    assert not np.array_equal(again.cap_u64(), tz.cap_u64())


def _host_root(hp, rows):
    digests = [hp.hash_leaf(r) for r in rows]
    levels = [digests]
    while len(digests) > 1:
        digests = [hp.two_to_one(digests[i], digests[i + 1]) for i in range(0, len(digests), 2)]
        levels.append(digests)
    return levels


@pytest.mark.parametrize(
    "n_log,cap_height", [(n, c) for n in range(0, 7) for c in range(0, n + 1)]
)
def test_merkle_tree_size_vs_host_hashing(n_log, cap_height):
    """Every tree height and cap height: the cap equals the host hashing of
    the leaves, and every leaf's path verifies against it."""
    hp = lazy_module("plonky2_tpu_torch.hash.poseidon")
    rng = np.random.default_rng(600 + n_log)
    leaves = rng.integers(0, P, size=(1 << n_log, 5), dtype=np.uint64)
    tree = tmk.build_merkle_tree(leaves, cap_height, device="cpu")
    rows = [[int(x) for x in r] for r in leaves]
    host_levels = _host_root(hp, rows)
    cap = tree.cap_u64()
    assert [tuple(int(x) for x in d) for d in cap] == [
        tuple(d) for d in host_levels[n_log - cap_height]
    ]
    paths = tree.prove_batch(np.arange(1 << n_log))
    assert paths.shape == (1 << n_log, n_log - cap_height, 4)
    for q in {0, (1 << n_log) // 3, (1 << n_log) - 1}:
        path = tree.prove(q)
        assert [tuple(int(x) for x in s) for s in paths[q]] == [tuple(s) for s in path]
        assert tmk.verify_merkle_proof(rows[q], q, cap, path)
        if n_log > cap_height:
            assert not tmk.verify_merkle_proof(rows[q], q ^ 1, cap, path)


@pytest.mark.parametrize("n_log", range(1, 8))
def test_tree_levels_are_compressed_pairs(n_log):
    """Each level of the tree is compress_pairs of the level below (rows
    2i, 2i+1 -> row i, no copy of the pairs), equal to the host two_to_one."""
    hp = lazy_module("plonky2_tpu_torch.hash.poseidon")
    tdp = lazy_module("plonky2_tpu_torch.ops.poseidon")
    rng = np.random.default_rng(650 + n_log)
    leaves = rng.integers(0, P, size=(1 << n_log, 3), dtype=np.uint64)
    levels = tmk.load()._tree_levels(_t(leaves), n_log)
    assert [tuple(l.shape) for l in levels] == [(1 << (n_log - k), 4) for k in range(n_log + 1)]
    for below, above in zip(levels, levels[1:]):
        want = tdp.compress_pairs_plain(below)
        np.testing.assert_array_equal(tgf.to_u64(above), tgf.to_u64(want))
        rows = [tuple(int(x) for x in r) for r in tgf.to_u64(below)]
        host = [hp.two_to_one(rows[2 * i], rows[2 * i + 1]) for i in range(len(rows) // 2)]
        assert [tuple(int(x) for x in r) for r in tgf.to_u64(above)] == host

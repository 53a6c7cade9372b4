"""The port's prover mesh and six-step NTT (plonky2_tpu_torch/parallel/;
the JAX package's tests/test_parallel_ntt.py) on an 8-shard mesh of
virtual shards on the CPU: the six-step forward, inverse and batched coset
inverse transforms equal the port's single-device NTT and the JAX
package's host evaluation (plonky2_tpu/ops/ntt.naive_eval_np); the sharded
Merkle tree's levels and cap equal the single-device tree's at cap
heights 0-3 (below and at log2 of the shard count), for Poseidon and
Poseidon2; the LDE leaves, commitments and permutation batches split over
shards equal the unsplit ones; make_prover_mesh refuses devices the
machine does not have. Exact equality throughout."""

import numpy as np
import pytest

from plonky2_tpu.field import goldilocks as rgl
from plonky2_tpu.ops.ntt import naive_eval_np as ref_naive_eval
from _torch_port import lazy_module

pctx = lazy_module("plonky2_tpu_torch.parallel.context")
pntt = lazy_module("plonky2_tpu_torch.parallel.ntt")
gf = lazy_module("plonky2_tpu_torch.ops.gf")
ntt = lazy_module("plonky2_tpu_torch.ops.ntt")
merkle = lazy_module("plonky2_tpu_torch.ops.merkle")
fk = lazy_module("plonky2_tpu_torch.ops.fri_kernels")
dp = lazy_module("plonky2_tpu_torch.ops.poseidon")

P = rgl.P


def _mesh(d=8):
    return pctx.make_prover_mesh(d, virtual_on="cpu")


def _field(seed, shape):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


@pytest.mark.parametrize("n_log", [6, 8])
def test_six_step_matches_single_device_and_reference(n_log):
    x = _field(n_log, 1 << n_log)
    got = gf.to_u64(pntt.six_step_fft(gf.from_u64(x, "cpu"), _mesh()))
    assert np.array_equal(got, gf.to_u64(ntt.fft(gf.from_u64(x, "cpu")[None])[0]))
    if n_log == 6:  # the host oracle is quadratic
        want = ref_naive_eval(x[None], rgl.two_adic_subgroup(n_log))[0]
        assert np.array_equal(got, want)


@pytest.mark.parametrize("n_log", [6, 9])
def test_six_step_ifft_roundtrip(n_log):
    x = _field(100 + n_log, 1 << n_log)
    mesh = _mesh()
    vals = pntt.six_step_fft(gf.from_u64(x, "cpu"), mesh)
    assert np.array_equal(gf.to_u64(pntt.six_step_ifft(vals, mesh)), x)
    assert np.array_equal(gf.to_u64(pntt.six_step_ifft(vals, mesh)),
                          gf.to_u64(ntt.ifft(vals[None])[0]))


@pytest.mark.parametrize("m,n_log", [(2, 6), (3, 8)])
def test_six_step_coset_ifft_batch(m, n_log):
    """The quotient's point-sharded coset IFFT, 1/N and shift^-k folded
    into the separable s1·s2 scale: equal to the single-device coset_ifft,
    and its coefficients evaluate back to the values on the coset."""
    q = _field(7 + n_log, (m, 1 << n_log))
    got = gf.to_u64(pntt.six_step_coset_ifft_batch(gf.from_u64(q, "cpu"), _mesh()))
    assert np.array_equal(got, gf.to_u64(ntt.coset_ifft(gf.from_u64(q, "cpu"))))
    if n_log == 6:
        pts = rgl.np_mul(rgl.two_adic_subgroup(n_log), np.uint64(rgl.MULTIPLICATIVE_GROUP_GENERATOR))
        assert np.array_equal(ref_naive_eval(got, pts), q)


@pytest.mark.parametrize("hasher", ["poseidon", "poseidon2"])
@pytest.mark.parametrize("cap_height", [0, 1, 2, 3])
def test_sharded_merkle_cap_matches_device_tree(cap_height, hasher):
    """cap_height < log2(8) crosses shards and hashes the gathered shard
    roots; cap_height 3 leaves each shard one cap entry. Every level of
    the row-sharded tree equals the single-device tree's, for both device
    hashers."""
    from plonky2_tpu_torch.plonk import generic_config as tgc

    h = None if hasher == "poseidon" else tgc.poseidon2_goldilocks_config().hasher
    leaves = gf.from_u64(_field(2, (1 << 5, 7)), "cpu")
    want = merkle.build_merkle_tree(leaves, cap_height, hasher=h)
    got = pntt.sharded_merkle_cap(leaves, _mesh(), cap_height, hasher=h)
    assert np.array_equal(gf.to_u64(got), gf.to_u64(want.cap))
    sub, top = pntt.sharded_tree_levels(pctx.shard(leaves, _mesh(), 0), _mesh(), cap_height,
                                        leaves.device, hasher=h)
    assert len(sub[0]) + len(top) == len(want.levels)
    for k, b in enumerate(want.levels[: len(sub[0])]):  # below the shard roots: parts
        assert all(s[k].shape == ((1 << 5) // 8 >> k, 4) for s in sub)
        assert np.array_equal(gf.to_u64(pctx.all_gather([s[k] for s in sub], "cpu")),
                              gf.to_u64(b))
    for a, b in zip(top, want.levels[len(sub[0]):]):
        assert np.array_equal(gf.to_u64(a), gf.to_u64(b))


def _tree_levels(t):
    """A tree's levels as whole tensors: a sharded tree's gathered."""
    if isinstance(t, merkle.ShardedMerkleTree):
        return [pctx.all_gather(t.level_parts(k), "cpu") for k in range(t.shard_levels)] + t.top
    return t.levels


@pytest.mark.parametrize("salted", [False, True], ids=["plain", "salted"])
def test_lde_leaves_and_hashing_split_over_shards(monkeypatch, salted):
    """Under an active mesh: the poly-sharded LDE and its all-to-all give
    the single-device leaves, row-sharded, with zero-row padding (5 polys
    over 8 shards) kept out of them; a commitment keeps its leaves
    row-sharded through the subtrees and in the tree, and gives the
    single-device tree, salt columns included; a tree of leaves given
    whole is built row-sharded to the same levels; the permutation batch
    split by rows gives the same states."""
    monkeypatch.setattr(dp.load(), "_MESH_MIN_ROWS", 1)
    coeffs = gf.from_u64(_field(3, (5, 1 << 4)), "cpu")
    salt = _field(6, (1 << 6, 4)) if salted else None
    want_leaves = fk.lde_leaves(coeffs, 2)
    want_tree = fk.commit(coeffs, 2, 1, salt=salt)
    states = gf.from_u64(_field(4, (16, 12)), "cpu")
    want_perm = dp.permute(states)
    mesh = _mesh()
    with pctx.prover_mesh(mesh):
        leaves = fk.lde_leaf_shards(fk.shard_polys(coeffs, mesh), 2, mesh)
        tree = fk.commit(coeffs, 2, 1, salt=salt)
        whole = merkle.build_merkle_tree(want_tree.leaves, 1)
        perm = dp.permute(states)
    assert [p.shape for p in leaves] == [((1 << 6) // 8, 5)] * 8
    assert np.array_equal(gf.to_u64(pctx.all_gather(leaves, "cpu")), gf.to_u64(want_leaves))
    for t in (tree, whole):
        assert isinstance(t, merkle.ShardedMerkleTree)
        assert np.array_equal(gf.to_u64(pctx.all_gather(t.leaf_parts, "cpu")),
                              gf.to_u64(want_tree.leaves))
        got = _tree_levels(t)
        assert len(got) == len(want_tree.levels)
        for a, b in zip(got, want_tree.levels):
            assert np.array_equal(gf.to_u64(a), gf.to_u64(b))
    assert np.array_equal(gf.to_u64(perm), gf.to_u64(want_perm))


def test_mesh_refuses_devices_it_does_not_have():
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError):
        pctx.make_prover_mesh(have + 1)
    mesh = pctx.make_prover_mesh(8, virtual_on="cpu")
    assert mesh.size == 8 and set(mesh.devices) == {torch.device("cpu")} and mesh.shape == (8,)
    mesh2 = pctx.make_prover_mesh(8, virtual_on="cpu", shape=(2, 4))
    assert mesh2.shape == (2, 4) and pctx.axis_size((mesh2.devices, mesh2.shape)) == 8
    with pytest.raises(ValueError):
        pctx.make_prover_mesh(8, virtual_on="cpu", shape=(3, 4))


def test_mesh_context_nests_and_hides_inside_a_shard():
    mesh = _mesh(2)
    assert pctx.get_mesh() is None
    with pctx.prover_mesh(mesh):
        assert pctx.get_mesh() is mesh and pctx.mesh_key() is not None
        with pctx.on_shard(mesh.devices[1]):
            assert pctx.get_mesh() is None
        assert pctx.get_mesh() is mesh
    assert pctx.get_mesh() is None


def test_all_to_all_is_the_tiled_transpose():
    import torch

    mesh = _mesh(4)
    x = torch.arange(8 * 12).reshape(1, 8, 12)
    parts = pctx.shard(x, mesh, dim=1)  # [1, 2, 12] a shard: rows
    out = pctx.all_to_all(parts, mesh, split_dim=2, concat_dim=1)  # [1, 8, 3]
    assert torch.equal(pctx.all_gather(out, "cpu", dim=2), x)


def test_six_step_needs_the_mesh_to_divide_both_factors():
    with pytest.raises(ValueError):
        pntt.six_step_fft(gf.from_u64(_field(5, 1 << 4), "cpu"), _mesh(8))

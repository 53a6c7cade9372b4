"""What the port's prover mesh keeps where (plonky2_tpu_torch/parallel/;
the JAX package's row- and poly-sharded arrays, plonky2_tpu/ops/merkle.py:
1-14, plonky2_tpu/fri/oracle.py:35-94), on virtual shards on the CPU with
d = 2 and 8 shards: a tree built under the mesh keeps its leaf rows and
its subtree levels in parts of [L/d >> k, ·] rows, and only the levels
from the shard roots up on the proof's device; its cap equals the
single-device tree's and the JAX package's host tree's, and its leaf rows
and sibling paths, routed by index, equal the single-device tree's (and
pass the JAX package's verify_merkle_proof) without a host read; a
PolynomialBatch keeps its coefficients in parts of ceil(M/d) rows, and its
openings and FRI compositions equal the single-device ones; the
quotient's natural-order shards built from leaf parts by one all-to-all
equal those cut from the whole leaves, and the six-step's column blocks
turned into the quotient's rows equal the whole reshape; a checkpoint
loaded under the mesh keeps its bytes. Exact equality throughout; no
proof here (tests/test_torch_mesh_prove.py proves through these paths)."""

from pathlib import Path

import numpy as np
import pytest

from plonky2_tpu.field import goldilocks as rgl
from _torch_port import lazy_module

pctx = lazy_module("plonky2_tpu_torch.parallel.context")
gf = lazy_module("plonky2_tpu_torch.ops.gf")
merkle = lazy_module("plonky2_tpu_torch.ops.merkle")
fk = lazy_module("plonky2_tpu_torch.ops.fri_kernels")
fo = lazy_module("plonky2_tpu_torch.fri.oracle")
tprover = lazy_module("plonky2_tpu_torch.plonk.prover")
ser = lazy_module("plonky2_tpu_torch.utils.serialization")
ref_merkle = lazy_module("plonky2_tpu.ops.merkle")
ref_poseidon = lazy_module("plonky2_tpu.hash.poseidon")

GOLDEN = Path(__file__).resolve().parent / "golden"
P = rgl.P


def _mesh(d):
    return pctx.make_prover_mesh(d, virtual_on="cpu")


def _field(seed, shape):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


def _sharded(d, fn, *args, **kwargs):
    with pctx.prover_mesh(_mesh(d)):
        return fn(*args, **kwargs)


@pytest.fixture
def no_host_reads(monkeypatch):
    """Makes every way of reading a tensor's values to the host raise."""
    import torch

    def refuse(*_args, **_kwargs):
        raise AssertionError("a host read")

    for name in ("item", "tolist", "numpy", "__bool__", "__int__", "nonzero"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


@pytest.mark.parametrize("d,cap_height", [(2, h) for h in range(3)] + [(8, h) for h in range(5)])
def test_sharded_tree_holds_parts_and_the_single_device_cap(d, cap_height):
    """No whole leaf matrix and no whole level below the shard roots: every
    part is [L/d >> k, ·] on its shard; the levels on the proof's device
    are the shard roots' and above (at most max(d, cap) rows each)."""
    rows_log = 4
    leaves = gf.from_u64(_field(cap_height, (1 << rows_log, 7)), "cpu")
    tree = _sharded(d, merkle.build_merkle_tree, leaves, cap_height)
    want = merkle.build_merkle_tree(leaves, cap_height)
    rows = (1 << rows_log) // d
    assert isinstance(tree, merkle.ShardedMerkleTree) and tree.num_leaves == 1 << rows_log
    assert [tuple(p.shape) for p in tree.leaf_parts] == [(rows, 7)] * d
    for k in range(tree.shard_levels):
        assert [tuple(p.shape) for p in tree.level_parts(k)] == [(rows >> k, 4)] * d
    assert tree.shard_levels + len(tree.top) == len(want.levels)
    assert all(t.shape[0] <= max(d, 1 << cap_height) for t in tree.top)
    assert np.array_equal(tree.cap_u64(), want.cap_u64())


@pytest.mark.parametrize("cap_height", range(5))
def test_sharded_tree_equals_reference_host_tree(cap_height):
    """The JAX package's HostMerkleTree over its pure-Python Poseidon (no
    XLA compile: numpy limbs) at 2^4 rows: the same cap under 8 shards,
    and the port's routed paths verify against it."""
    leaves = _field(10 + cap_height, (1 << 4, 5))
    limbs = ((leaves & np.uint64(0xFFFFFFFF)).astype(np.uint32),
             (leaves >> np.uint64(32)).astype(np.uint32))
    ref = ref_merkle.HostMerkleTree.build(limbs, cap_height, ref_poseidon)
    tree = _sharded(8, merkle.build_merkle_tree, gf.from_u64(leaves, "cpu"), cap_height)
    assert np.array_equal(tree.cap_u64(), ref.cap_u64())
    for i in (0, 5, 11, 15):
        assert np.array_equal(tree.leaf_u64(i), leaves[i])
        assert ref_merkle.verify_merkle_proof(
            [int(x) for x in leaves[i]], i, ref.cap_u64(), tree.prove(i), ref_poseidon)


@pytest.mark.parametrize("salted", [False, True], ids=["plain", "salted"])
@pytest.mark.parametrize("d", [2, 8])
def test_sharded_tree_reads_equal_single_device(d, salted, no_host_reads):
    """A commitment's tree under the mesh (salt columns uploaded a shard at
    a time): leaf_rows_device and sibling_paths_device at random indices,
    as numpy and as an int64 tensor, equal the single-device tree's; with
    a tensor no value is read to the host."""
    import torch

    coeffs = gf.from_u64(_field(d, (5, 1 << 2)), "cpu")
    salt = _field(20 + d, (1 << 4, 4)) if salted else None
    tree = _sharded(d, fk.commit, coeffs, 2, 1, salt=salt)
    want = fk.commit(coeffs, 2, 1, salt=salt)
    assert isinstance(tree, merkle.ShardedMerkleTree)
    assert tree.leaf_parts[0].shape == ((1 << 4) // d, 9 if salted else 5)
    idx = np.random.default_rng(d).integers(0, 1 << 4, size=24)
    for given in (idx, torch.from_numpy(idx)):
        assert torch.equal(tree.leaf_rows_device(given), want.leaf_rows_device(given))
        assert torch.equal(tree.sibling_paths_device(given), want.sibling_paths_device(given))


@pytest.mark.parametrize("d", [2, 8])
def test_sharded_batch_openings_and_compositions(d):
    """M = 5 polys (not a multiple of d): parts of ceil(5/d) rows, zero
    padded; the coefficients read back, the openings at zeta and g·zeta,
    the FRI compositions (host and device weights, rows of several
    shards) and an LDE row equal the single-device batch's."""
    import torch

    values = _field(30 + d, (5, 1 << 2))
    batch = _sharded(d, fo.PolynomialBatch.from_values, values, 2, False, 1, device="cpu")
    want = fo.PolynomialBatch.from_values(values, 2, False, 1, device="cpu")
    m = -(-5 // d)
    assert batch.sharded and batch.num_polys == 5
    assert [tuple(p.shape) for p in batch.polynomials.parts] == [(m, 1 << 2)] * d
    assert not pctx.all_gather(batch.polynomials.parts, "cpu")[5:].any()  # the padding
    assert np.array_equal(batch.coeffs_u64(), gf.to_u64(want.polynomials))
    zeta, zeta_next = (gf.from_u64(_field(40 + i, 2), "cpu") for i in range(2))
    assert torch.equal(fo.eval_commitments_at_device([want, batch], zeta, zeta_next),
                       fo.eval_commitments_at_device([want, want], zeta, zeta_next))
    idx = [0, 2, 3, 4]
    host_w = _field(50, (4, 2))
    dev_w = gf.from_u64(host_w, "cpu")
    for w in (host_w, dev_w):
        assert torch.equal(fo.compose_polys(batch, idx, w), fo.compose_polys(want, idx, w))
    assert batch.get_lde_values(7, 2) == want.get_lde_values(7, 2)


@pytest.mark.parametrize("step", [1, 2])
@pytest.mark.parametrize("d", [2, 8])
def test_natural_order_shards_from_leaf_parts(d, step, monkeypatch):
    """The quotient's inputs: the natural-order shards sent from the
    leaf parts (salted at step 2, the salt columns dropped) equal those
    cut from the whole leaf matrix of the same commitment."""
    monkeypatch.setenv("PLONKY2_TPU_SALT_SEED", "7")
    values = _field(60 + d + step, (6, 1 << 3))
    salted = step == 2
    mesh = _mesh(d)
    batch = _sharded(d, fo.PolynomialBatch.from_values, values, 2, salted, 0, device="cpu")
    whole = fo.PolynomialBatch.from_values(values, 2, salted, 0, device="cpu")
    got = tprover.load()._natural_order_shards(batch, step, mesh)
    want = tprover.load()._natural_order_shards(whole, step, mesh)
    assert len(got) == d
    for a, b in zip(got, want):
        assert a.shape == (6, (1 << 5) // step // d)
        assert np.array_equal(gf.to_u64(a), gf.to_u64(b))


@pytest.mark.parametrize("d,n_log", [(2, 5), (8, 3), (8, 5)])
def test_quotient_rows_from_six_step_columns(d, n_log):
    """The six-step's column blocks of C = 2 polys of 2^6 coefficients as
    the quotient oracle's rows of n = 2^n_log: equal to the whole
    coefficients reshaped to [C·2^6/n, n], zero rows padding them to a
    multiple of d, block s on shard s."""
    import torch

    mesh = _mesh(d)
    whole = gf.from_u64(_field(70 + d + n_log, (2, 1 << 6)), "cpu")
    parts = pctx.shard(whole, mesh, 1)
    got = tprover.load()._quotient_rows(parts, mesh, 1 << n_log, whole.device)
    chunks = whole.reshape(-1, 1 << n_log)
    assert got.num_polys == chunks.shape[0]
    assert torch.equal(pctx.all_gather(got.parts, "cpu")[: got.num_polys], chunks)
    assert not pctx.all_gather(got.parts, "cpu")[got.num_polys:].any()
    assert [p.shape[0] for p in got.parts] == [-(-chunks.shape[0] // d)] * d


def test_checkpoint_loaded_under_the_mesh_keeps_its_bytes():
    """The fibonacci checkpoint (the JAX package's bytes) loaded under 2
    shards: its constants/sigmas oracle is sharded, and written again it
    gives the same bytes, its coefficients read a part at a time."""
    blob = (GOLDEN / "torch_fibonacci_circuit.bin").read_bytes()
    data = _sharded(2, ser.circuit_data_from_bytes, blob, device="cpu")
    cs = data.prover_only.constants_sigmas_commitment
    assert cs.sharded and isinstance(cs.merkle_tree, merkle.ShardedMerkleTree)
    assert ser.circuit_data_to_bytes(data) == blob

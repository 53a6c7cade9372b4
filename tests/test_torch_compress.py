"""Compressed proofs in the port (hash/path_compression.py, fri/compress.py,
plonk/compressed_proof.py and the compressed wire format of
utils/serialization.py) on the CPU, held against the JAX package, with no
prove: the proofs are the pinned tests/golden/fibonacci_proof.bin (mirror
of tests/test_compressed_proof.py) and the recursion benchmark's outer
proof tests/golden/torch_recursion_outer_2^12.bin, whose compressed bytes
the JAX package pinned in torch_recursion_outer_2^12_compressed.bin
(tools/gen_recursion_pins.py). Tolerance: none."""

from pathlib import Path

import numpy as np
import pytest

from plonky2_tpu.field.goldilocks import P
from _torch_port import lazy_module

tfib = lazy_module("plonky2_tpu_torch.models.fibonacci")
tverifier = lazy_module("plonky2_tpu_torch.plonk.verifier")
tcomp = lazy_module("plonky2_tpu_torch.plonk.compressed_proof")
tpc = lazy_module("plonky2_tpu_torch.hash.path_compression")
thp = lazy_module("plonky2_tpu_torch.hash.poseidon")
ser = lazy_module("plonky2_tpu_torch.utils.serialization")

GOLDEN = Path(__file__).resolve().parent / "golden"


@pytest.fixture(scope="module")
def fibonacci():
    """(proof, verifier data, common data): the golden proof, and the
    circuit's data built by the port."""
    data, _ = tfib.build_fibonacci(public_io=True, device="cpu")
    raw = (GOLDEN / "fibonacci_proof.bin").read_bytes()
    assert ser.common_data_to_bytes(data.common) == (GOLDEN / "fibonacci_common.bin").read_bytes()
    return ser.proof_from_bytes(raw, data.common), data.verifier_only, data.common


@pytest.fixture(scope="module")
def outer():
    return ser.proof_tuple_from_bytes((GOLDEN / "torch_recursion_outer_2^12.bin").read_bytes())


def _sibling_counts(pwp, c):
    full = sum(
        len(mp.siblings)
        for r in pwp.proof.opening_proof.query_round_proofs
        for _, mp in r.initial_trees_proof.evals_proofs
    )
    comp = sum(
        len(mp.siblings)
        for p in c.proof.opening_proof.query_round_proofs.initial_trees_proofs.values()
        for _, mp in p.evals_proofs
    )
    return full, comp


def test_compression_drops_siblings(fibonacci):
    pwp, vd, common = fibonacci
    full, comp = _sibling_counts(pwp, tcomp.compress_proof(pwp, vd, common))
    assert comp < full


def test_decompress_reproduces_query_rounds(fibonacci):
    pwp, vd, common = fibonacci
    full = tcomp.decompress_proof(tcomp.compress_proof(pwp, vd, common), vd, common)
    for a, b in zip(
        pwp.proof.opening_proof.query_round_proofs, full.proof.opening_proof.query_round_proofs
    ):
        assert a.initial_trees_proof.evals_proofs[0][0] == b.initial_trees_proof.evals_proofs[0][0]
        for sa, sb in zip(a.steps, b.steps):
            assert [tuple(e) for e in sa.evals] == [tuple(e) for e in sb.evals]
            assert [tuple(s) for s in sa.merkle_proof.siblings] == [
                tuple(s) for s in sb.merkle_proof.siblings
            ]
    assert ser.proof_to_bytes(full, common) == (GOLDEN / "fibonacci_proof.bin").read_bytes()


def test_decompressed_and_compressed_proofs_verify(fibonacci):
    pwp, vd, common = fibonacci
    c = tcomp.compress_proof(pwp, vd, common)
    tverifier.verify(tcomp.decompress_proof(c, vd, common), vd, common)
    tcomp.verify_compressed_proof(c, vd, common)


def test_compressed_bytes_equal_reference(fibonacci):
    """The JAX package's host code compresses the same golden proof."""
    from plonky2_tpu.plonk.compressed_proof import compress_proof
    from plonky2_tpu.utils import serialization as jser

    pwp, vd, common = fibonacci
    j_vd, j_common = jser.verifier_data_from_bytes(ser.verifier_data_to_bytes(vd, common))
    j_pwp = jser.proof_from_bytes((GOLDEN / "fibonacci_proof.bin").read_bytes(), j_common)
    want = jser.compressed_proof_to_bytes(compress_proof(j_pwp, j_vd, j_common), j_common)
    got = ser.compressed_proof_to_bytes(tcomp.compress_proof(pwp, vd, common), common)
    assert got == want


def test_compressed_bytes_round_trip(fibonacci):
    pwp, vd, common = fibonacci
    raw = ser.compressed_proof_to_bytes(tcomp.compress_proof(pwp, vd, common), common)
    back = ser.compressed_proof_from_bytes(raw, common)
    assert ser.compressed_proof_to_bytes(back, common) == raw
    tcomp.verify_compressed_proof(back, vd, common)
    with pytest.raises(Exception):
        ser.compressed_proof_from_bytes(raw + b"\0", common)


def test_compressed_proof_rejects_tampered_leaf(fibonacci):
    pwp, vd, common = fibonacci
    c = tcomp.compress_proof(pwp, vd, common)
    initial = c.proof.opening_proof.query_round_proofs.initial_trees_proofs
    leaf = initial[min(initial)].evals_proofs[1][0]
    leaf[0] = (int(leaf[0]) + 1) % P
    with pytest.raises(Exception):
        tcomp.verify_compressed_proof(c, vd, common)


# ---------------------------------------------------------------------------
# The recursion benchmark's outer proof: two queries meet one coset at
# different positions in its second folding step
# ---------------------------------------------------------------------------


def test_outer_golden_verifies(outer):
    tverifier.verify(*outer)


def test_outer_compressed_bytes_equal_reference(outer):
    pwp, vd, common = outer
    raw = ser.compressed_proof_to_bytes(tcomp.compress_proof(pwp, vd, common), common)
    assert raw == (GOLDEN / "torch_recursion_outer_2^12_compressed.bin").read_bytes()


def test_outer_decompress_completes_shared_cosets(outer):
    """Where two queries meet one coset at different positions, the coset
    is completed from the first query's element: the decompressed proof
    is the pinned proof byte for byte, and both forms verify."""
    from plonky2_tpu_torch.plonk.verifier import get_challenges

    pwp, vd, common = outer
    ch = get_challenges(pwp, pwp.get_public_inputs_hash(), vd.circuit_digest, common)
    rab = common.fri_params.reduction_arity_bits
    first, shared = {}, 0
    for x in ch.fri_challenges.fri_query_indices:
        x >>= rab[0]
        within, coset = x & ((1 << rab[1]) - 1), x >> rab[1]
        shared += coset in first and first[coset] != within
        first.setdefault(coset, within)
    assert shared > 0
    raw = (GOLDEN / "torch_recursion_outer_2^12_compressed.bin").read_bytes()
    c = ser.compressed_proof_from_bytes(raw, common)
    back = tcomp.decompress_proof(c, vd, common)
    assert ser.proof_to_bytes(back, common) == ser.proof_to_bytes(pwp, common)
    tcomp.verify_compressed_proof(c, vd, common)


def test_outer_compressed_proof_rejects_tampered_step_eval(outer):
    pwp, vd, common = outer
    c = tcomp.compress_proof(pwp, vd, common)
    steps = c.proof.opening_proof.query_round_proofs.steps[1]
    step = steps[min(steps)]
    e0, e1 = step.evals[0]
    step.evals[0] = ((e0 + 1) % P, e1)
    with pytest.raises(Exception):
        tcomp.verify_compressed_proof(c, vd, common)


# ---------------------------------------------------------------------------
# Merkle path compression against the JAX package's
# ---------------------------------------------------------------------------

PATH_CASES = {
    "distinct": (6, 1, [5, 40, 17, 63]),
    "repeated": (6, 1, [9, 9, 30, 9]),
    "adjacent": (6, 2, [12, 13, 14, 15, 2]),
    "one_leaf_all": (5, 0, [7, 7, 7]),
    "cap_height_equals_height_less_one": (4, 3, [0, 1, 2, 15]),
    "random_many": (8, 2, [int(v) for v in np.random.default_rng(3).integers(0, 256, 40)]),
}


def _tree(height: int, cap_height: int, seed: int):
    """Leaves [2^height, 3] and each leaf's sibling path to the cap."""
    rng = np.random.default_rng(seed)
    leaves = [[int(v) for v in row] for row in rng.integers(0, P, (1 << height, 3), dtype=np.uint64)]
    level = [thp.hash_leaf(v) for v in leaves]
    levels = [level]
    for _ in range(height - cap_height):
        level = [thp.two_to_one(level[i], level[i + 1]) for i in range(0, len(level), 2)]
        levels.append(level)

    def path(i):
        out = []
        for lvl in levels[:-1]:
            out.append(lvl[i ^ 1])
            i >>= 1
        return out

    return leaves, path


@pytest.mark.parametrize("case", sorted(PATH_CASES))
def test_path_compression_equals_reference(case):
    from plonky2_tpu.hash import path_compression as jpc

    height, cap_height, indices = PATH_CASES[case]
    leaves, path = _tree(height, cap_height, seed=height * 7 + cap_height)
    proofs = [path(i) for i in indices]
    got = tpc.compress_merkle_proofs(cap_height, indices, proofs)
    assert got == jpc.compress_merkle_proofs(cap_height, indices, proofs)
    assert sum(map(len, got)) <= sum(map(len, proofs))
    back = tpc.decompress_merkle_proofs(
        [leaves[i] for i in indices], indices, got, height, cap_height
    )
    assert [[tuple(s) for s in p] for p in back] == [[tuple(s) for s in p] for p in proofs]

"""The port's Poseidon2 (hash/poseidon2{,_constants}.py, gates/poseidon2.py,
the Poseidon2 and Keccak trees of ops/merkle.py, the Poseidon2 PoW grind,
the circuit builder's Poseidon2 gadgets) held against the JAX package's
host functions (mirror of tests/test_poseidon2.py and
tests/test_hash_field_extras.py's Keccak cases).

Inputs come from ``numpy.random.default_rng(seed)`` (or ``random.Random``
where the reference's harness takes one); the reference side is its pure
Python host path (``plonky2_tpu.hash.poseidon2.permute``, ``HostMerkleTree``,
``_host_pow_grind``, the gates' host algebras), so nothing compiles XLA
but a few tiny conversions. Tolerance: none — bit equality.
"""

import functools
import random

import numpy as np
import pytest

from plonky2_tpu.field.goldilocks import P
from plonky2_tpu.gates import gate_testing as jgt
from plonky2_tpu.gates.algebra import EvalVars as JEvalVars
from plonky2_tpu.gates.algebra import HostExtAlgebra as JHostExtAlgebra
from plonky2_tpu.hash import poseidon2 as jp2
from plonky2_tpu.hash import poseidon2_constants as jconst
from _torch_port import lazy_module

tp2 = lazy_module("plonky2_tpu_torch.hash.poseidon2")
tconst = lazy_module("plonky2_tpu_torch.hash.poseidon2_constants")
tgates = lazy_module("plonky2_tpu_torch.gates.poseidon2")
tgt = lazy_module("plonky2_tpu_torch.gates.gate_testing")
talg = lazy_module("plonky2_tpu_torch.gates.algebra")
tmerkle = lazy_module("plonky2_tpu_torch.ops.merkle")
tfk = lazy_module("plonky2_tpu_torch.ops.fri_kernels")
tgc = lazy_module("plonky2_tpu_torch.plonk.generic_config")
tbuilder = lazy_module("plonky2_tpu_torch.plonk.circuit_builder")
tconfig = lazy_module("plonky2_tpu_torch.plonk.config")
tgen = lazy_module("plonky2_tpu_torch.iop.generator")
twitness = lazy_module("plonky2_tpu_torch.iop.witness")
twc = lazy_module("plonky2_tpu_torch.plonk.witness_check")
thp = lazy_module("plonky2_tpu_torch.hash.poseidon")
tkk = lazy_module("plonky2_tpu_torch.hash.keccak")
ser = lazy_module("plonky2_tpu_torch.utils.serialization")
gf = lazy_module("plonky2_tpu_torch.ops.gf")

TABLES = [
    "SPONGE_WIDTH", "SPONGE_RATE", "SPONGE_CAPACITY", "EXTERNAL_ROUNDS",
    "INTERNAL_ROUNDS", "ALPHA", "INITIAL_EXTERNAL_CONSTANTS",
    "TERMINAL_EXTERNAL_CONSTANTS", "INTERNAL_CONSTANTS", "MATRIX_DIAG",
]
GATES = ["Poseidon2Gate", "Poseidon2MdsGate", "Poseidon2IntMixGate"]


def _states(seed: int, b: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, P, size=(b, 12), dtype=np.uint64)


# edge states: zero, p - 1, multiples of 2^32 (the halves the light MDS
# sums), and one of each in the lanes
EDGES = {
    "zero": [0] * 12,
    "p_minus_1": [P - 1] * 12,
    "2^32_multiples": [(i << 32) % P for i in range(12)],
    "2^32_minus_1": [(1 << 32) - 1] * 12,
    "mixed": [0, P - 1, 1 << 32, (1 << 32) - 1, 1, P - 2, 1 << 63, 2, 0, P - 1, 7, 1 << 40],
}


@pytest.mark.parametrize("name", TABLES)
def test_constants_equal_reference(name):
    assert getattr(tconst, name) == getattr(jconst, name)


@pytest.mark.parametrize("edge", sorted(EDGES))
def test_permute_edge_state_vs_reference(edge):
    state = EDGES[edge]
    want = jp2.permute(state)
    assert tp2.permute(state) == want
    got = gf.to_u64(tp2.permute_batch(gf.from_u64(np.array([state], dtype=np.uint64), "cpu")))
    assert [int(x) for x in got[0]] == want


@pytest.mark.parametrize("seed", range(4))
def test_permute_batch_seed_vs_reference(seed):
    states = _states(seed, 5)
    got = gf.to_u64(tp2.permute_batch(gf.from_u64(states, "cpu")))
    for row, out in zip(states, got):
        want = jp2.permute([int(x) for x in row])
        assert tp2.permute([int(x) for x in row]) == want
        assert [int(x) for x in out] == want


@pytest.mark.parametrize("length", range(21))
def test_sponges_vs_reference(length):
    """Every pad10 boundary: lengths 7 and 15 (the pad fills the chunk),
    0, 8 and 16 (the pad takes a chunk of its own)."""
    rng = np.random.default_rng(100 + length)
    xs = [int(x) for x in rng.integers(0, P, size=length, dtype=np.uint64)]
    assert tp2.hash_no_pad(xs) == jp2.hash_no_pad(xs)
    assert tp2.hash_leaf(xs) == jp2.hash_leaf(xs)
    left, right = xs[:4] + [0] * (4 - len(xs[:4])), xs[-4:] + [0] * (4 - len(xs[-4:]))
    assert tp2.two_to_one(left, right) == jp2.two_to_one(left, right)


def test_sponge_properties():
    """tests/test_poseidon2.py::test_sponge_properties."""
    assert tp2.hash_no_pad([1, 2, 3]) != tp2.hash_no_pad([1, 2, 3, 0])
    assert tp2.hash_leaf([5]) != tp2.hash_no_pad([5])
    h1, h2 = tp2.hash_no_pad([1]), tp2.hash_no_pad([2])
    assert tp2.two_to_one(h1, h2) == tp2.hash_no_pad(list(h1) + list(h2))


# ---------------------------------------------------------------------------
# Trees: the Poseidon2 device tree and the Keccak host tree against the JAX
# package's HostMerkleTree
# ---------------------------------------------------------------------------

TREE_CASES = [(h, c) for h in range(7) for c in range(h + 1)]
TREE_WIDTH = {"poseidon2": 5, "keccak": 9}


def _leaves(height: int, width: int) -> np.ndarray:
    rng = np.random.default_rng(10 * height + width)
    return rng.integers(0, P, size=(1 << height, width), dtype=np.uint64)


@functools.lru_cache(maxsize=None)
def _reference_tree(hasher: str, height: int, cap_height: int):
    from plonky2_tpu.ops import gf as jgf
    from plonky2_tpu.ops import merkle as jmerkle
    from plonky2_tpu.plonk import generic_config as jgc

    spec = {"poseidon2": jgc.poseidon2_goldilocks_config,
            "keccak": jgc.keccak_goldilocks_config}[hasher]().hasher
    leaves = _leaves(height, TREE_WIDTH[hasher])
    return spec, jmerkle.HostMerkleTree.build(jgf.from_u64(leaves), cap_height, spec)


@pytest.mark.parametrize("hasher", ["poseidon2", "keccak"])
@pytest.mark.parametrize("height,cap_height", TREE_CASES, ids=[f"h{h}-cap{c}" for h, c in TREE_CASES])
def test_tree_equals_reference(hasher, height, cap_height):
    from plonky2_tpu.ops.merkle import verify_merkle_proof

    spec, ref = _reference_tree(hasher, height, cap_height)
    gc = {"poseidon2": tgc.poseidon2_goldilocks_config,
          "keccak": tgc.keccak_goldilocks_config}[hasher]()
    leaves = _leaves(height, TREE_WIDTH[hasher])
    tree = tmerkle.build_merkle_tree(leaves, cap_height, hasher=gc.hasher, device="cpu")
    want_kind = tmerkle.DeviceMerkleTree if hasher == "poseidon2" else tmerkle.HostMerkleTree
    assert isinstance(tree, want_kind)
    assert len(tree.levels) == len(ref.levels) == height - cap_height + 1
    for level, want in zip(tree.levels, ref.levels):
        got = gf.to_u64(level) if hasher == "poseidon2" else level
        assert np.array_equal(got, want)
    np.testing.assert_array_equal(tree.cap_u64(), ref.cap_u64())
    indices = sorted({0, (1 << height) - 1, (1 << height) // 3})
    np.testing.assert_array_equal(tree.prove_batch(indices), ref.prove_batch(np.array(indices)))
    np.testing.assert_array_equal(tree.leaf_u64_batch(indices), leaves[indices])
    np.testing.assert_array_equal(gf.to_u64(tree.leaf_rows_device(indices)), leaves[indices])
    np.testing.assert_array_equal(gf.to_u64(tree.sibling_paths_device(indices)),
                                  tree.prove_batch(indices))
    for i in indices:
        assert verify_merkle_proof([int(x) for x in leaves[i]], i, tree.cap_u64(), tree.prove(i),
                                   hasher=spec)
        assert tmerkle.verify_merkle_proof(
            [int(x) for x in leaves[i]], i, tree.cap_u64(), tree.prove(i), hasher=gc.hasher
        )


@pytest.mark.parametrize("width", [0, 7, 8, 16])
def test_poseidon2_leaf_widths_vs_host(width):
    """The device leaf sponge at the pad10 boundaries of the row width."""
    leaves = np.random.default_rng(width).integers(0, P, size=(4, width), dtype=np.uint64)
    got = gf.to_u64(tmerkle.load()._p2_hash_leaf(gf.from_u64(leaves, "cpu")))
    assert [tuple(int(x) for x in r) for r in got] == [
        jp2.hash_leaf([int(x) for x in row]) for row in leaves
    ]


@pytest.mark.parametrize("bits", [0, 3, 6, 8])
def test_pow_grind_poseidon2_vs_reference(bits):
    from plonky2_tpu.fri.prover import _host_pow_grind

    state = [int(x) for x in _states(50 + bits, 1)[0]]
    pos = bits % 8
    want = _host_pow_grind(state, pos, bits, jp2.permute)
    assert tfk.pow_grind(state, pos, bits, "cpu", tp2.permute_batch) == want


# ---------------------------------------------------------------------------
# The three gates
# ---------------------------------------------------------------------------


def _gates(name):
    from plonky2_tpu.gates import poseidon2 as jgates

    return getattr(tgates, name)(), getattr(jgates, name)()


@pytest.mark.parametrize("name", GATES)
def test_gate_shape_equals_reference(name):
    gate, jgate = _gates(name)
    assert gate.id() == jgate.id()
    assert (gate.num_wires(), gate.num_constants(), gate.degree(), gate.num_constraints()) == (
        jgate.num_wires(), jgate.num_constants(), jgate.degree(), jgate.num_constraints()
    )


@pytest.mark.parametrize("name", GATES)
def test_gate_host_eval_equals_reference(name):
    """The verifier's instantiation (HostExtAlgebra, extension tuples)."""
    gate, jgate = _gates(name)
    rnd = random.Random(11)
    wires = [(rnd.randrange(P), rnd.randrange(P)) for _ in range(gate.num_wires())]
    pis = [(rnd.randrange(P), rnd.randrange(P)) for _ in range(4)]
    got = gate.eval_unfiltered(talg.EvalVars([], wires, pis), talg.HostExtAlgebra())
    want = jgate.eval_unfiltered(JEvalVars([], wires, pis), JHostExtAlgebra())
    assert [tuple(g) for g in got] == [tuple(w) for w in want]


@pytest.mark.parametrize("name", GATES)
def test_gate_device_eval_equals_reference_host(name):
    """eval_unfiltered_device on CPU tensors (the stacked form for
    Poseidon2Gate) against the reference's NumpyBatchAlgebra, on random
    rows and a generated (satisfying) one."""
    gate, jgate = _gates(name)
    b = 6
    rng = np.random.default_rng(GATES.index(name))
    wires = rng.integers(0, P, size=(gate.num_wires(), b), dtype=np.uint64)
    pis = rng.integers(0, P, size=(4, b), dtype=np.uint64)
    row, _ = tgt.generate_gate_row(gate, seed=0)
    wires[:, 0] = np.array(row, dtype=np.uint64)
    want = jgate.eval_unfiltered(JEvalVars([], list(wires), list(pis)), jgt.NumpyBatchAlgebra(b))
    got = gate.eval_unfiltered_device(
        talg.EvalVars([], list(gf.from_u64(wires, "cpu").unbind(0)),
                      list(gf.from_u64(pis, "cpu").unbind(0))),
        talg.DeviceBatchAlgebra(b, "cpu"),
    )
    assert len(got) == len(want) == gate.num_constraints()
    assert np.array_equal(np.stack([gf.to_u64(g) for g in got]),
                          np.stack([np.asarray(w, dtype=np.uint64) for w in want]))
    assert all(int(x) == 0 for x in np.stack([gf.to_u64(g) for g in got])[:, 0])


@pytest.mark.parametrize("name", GATES)
def test_gate_algebra_agreement(name):
    tgt.check_algebra_agreement(_gates(name)[0], device="cpu")


@pytest.mark.parametrize("name", GATES)
def test_gate_generators_equal_reference(name):
    gate, jgate = _gates(name)
    for seed in range(2):
        row, _ = tgt.generate_gate_row(gate, seed=seed)
        jrow, _ = jgt.generate_gate_row(jgate, seed=seed)
        assert row == jrow
    tgt.check_generated_witness(gate)


def test_gate_output_is_permutation():
    gate = tgates.Poseidon2Gate()
    row, _ = tgt.generate_gate_row(gate, seed=3)
    inputs = [row[gate.wire_input(i)] for i in range(12)]
    assert [row[gate.wire_output(i)] for i in range(12)] == jp2.permute(inputs)


def _gates_circuit(builder_module, config_module, gates_module):
    """One row of each Poseidon2 gate, built by either package's modules."""
    b = builder_module.CircuitBuilder(config_module.CircuitConfig.standard_recursion_config())
    for name in GATES:
        b.add_gate(getattr(gates_module, name)(), [])
    return b.build(commit=False)


def test_common_data_bytes_with_the_gates_equal_reference():
    """A common data that holds the three gates: the same bytes as the JAX
    package's serializer, and read back to the same gates (tags 12-14)."""
    from plonky2_tpu.gates import poseidon2 as jgates
    from plonky2_tpu.plonk import circuit_builder as jbuilder
    from plonky2_tpu.plonk import config as jconfig
    from plonky2_tpu.utils import serialization as jser

    data = _gates_circuit(tbuilder.load(), tconfig.load(), tgates.load())
    jdata = _gates_circuit(jbuilder, jconfig, jgates)
    blob = ser.common_data_to_bytes(data.common)
    assert blob == jser.common_data_to_bytes(jdata.common)
    back = ser.common_data_from_bytes(blob)
    assert [g.id() for g in back.gates] == [g.id() for g in data.common.gates]
    assert {type(g).__name__ for g in back.gates} >= set(GATES)


# ---------------------------------------------------------------------------
# Circuit gadgets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("length", [0, 1, 7, 8, 9, 16])
def test_hash_n_to_hash_no_pad_p2_witness(length):
    """The in-circuit pad10 sponge's outputs equal the host hash, and the
    witness satisfies every constraint (check_witness, no proof)."""
    values = [int(x) for x in np.random.default_rng(length).integers(0, P, size=length, dtype=np.uint64)]
    b = tbuilder.CircuitBuilder(tconfig.CircuitConfig.standard_recursion_config())
    inputs = [b.add_virtual_target() for _ in range(length)]
    outs = b.hash_n_to_hash_no_pad_p2(inputs)
    data = b.build(commit=False)
    pw = twitness.PartialWitness()
    for t, v in zip(inputs, values):
        pw.set_target(t, v)
    witness = tgen.generate_partial_witness(pw, data.prover_only, data.common)
    assert tuple(witness.get_target(t) for t in outs) == jp2.hash_no_pad(values)
    twc.check_witness(data, witness.full_witness(), thp.hash_no_pad([]))


def test_permute_poseidon2_chain_shape_equals_reference():
    """The chain of tools/gen_hasher_pins.py (8 permutations, built without
    a commitment under poseidon2_goldilocks_config) has the JAX package's
    shape, pinned in tests/golden/torch_poseidon2_chain_shape.json; its
    witness gives the host permutations' output."""
    import json
    from pathlib import Path

    from plonky2_tpu_torch.models import bench_recursion as br
    from plonky2_tpu_torch.models import poseidon2_chain as pc

    pinned = json.loads(
        (Path(__file__).parent / "golden" / "torch_poseidon2_chain_shape.json").read_text()
    )
    b = tbuilder.CircuitBuilder(tconfig.CircuitConfig.standard_recursion_config())
    inputs, outputs = pc.add_chain(b, 8)
    data = b.build(commit=False, gc=tgc.poseidon2_goldilocks_config())
    assert br.circuit_shape(data) == pinned
    pw = twitness.PartialWitness()
    for t, v in zip(inputs, pc.CHAIN_INPUT):
        pw.set_target(t, v)
    witness = tgen.generate_partial_witness(pw, data.prover_only, data.common)
    want = pc.chain_output(8)
    state = list(pc.CHAIN_INPUT)
    for _ in range(8):
        state = jp2.permute(state)
    assert want == state
    assert [witness.get_target(t) for t in outputs] == want
    public = witness.get_targets(data.prover_only.public_inputs)
    twc.check_witness(data, witness.full_witness(), jp2.hash_no_pad(public))


# ---------------------------------------------------------------------------
# Keccak (tests/test_hash_field_extras.py: its Keccak cases)
# ---------------------------------------------------------------------------


def test_keccak256_vectors():
    assert (
        tkk.keccak256(b"").hex()
        == "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
    )
    assert (
        tkk.keccak256(b"The quick brown fox jumps over the lazy dog").hex()
        == "4d741b6f1eb29cb2a9b9911c82f56fa8d73b04959d3d9d222895df6c0b28aa15"
    )


def test_keccak_permutation_vs_reference():
    from plonky2_tpu.hash import keccak as jkk

    for seed in range(3):
        s = [int(x) for x in _states(seed, 1)[0]]
        out = tkk.keccak_permutation(s)
        assert out == jkk.keccak_permutation(s)
        assert all(0 <= x < P for x in out) and out != s

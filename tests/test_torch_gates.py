"""Every gate of the port but the Poseidon2 family (gates/poseidon2.py,
held in tests/test_torch_poseidon2.py), held against the JAX package's host
algebra (gates/{basic,extension,misc,interpolation,poseidon}.py; mirror of
tests/test_gates.py and tests/test_circuit_algebra.py).

The reference side is its exact host algebra: ``HostExtAlgebra`` and
``gate_testing.NumpyBatchAlgebra`` over numpy u64, no XLA compile. The port
side is its batched device eval (``eval_unfiltered_device``: the stacked
Poseidon rounds, BaseSumGate's and ReducingExtensionGate's batched forms,
the generic single-source path for the rest) on ``device="cpu"``
tensors. Tolerance: none — ``np.array_equal``."""

import random

import numpy as np
import pytest

from plonky2_tpu.field.goldilocks import P
from plonky2_tpu.gates import gate_testing as jgt
from plonky2_tpu.gates.algebra import EvalVars as JEvalVars
from plonky2_tpu.gates.algebra import HostExtAlgebra as JHostExtAlgebra
from _torch_port import lazy_module

tgt = lazy_module("plonky2_tpu_torch.gates.gate_testing")
talg = lazy_module("plonky2_tpu_torch.gates.algebra")
tbasic = lazy_module("plonky2_tpu_torch.gates.basic")
text = lazy_module("plonky2_tpu_torch.gates.extension")
tinterp = lazy_module("plonky2_tpu_torch.gates.interpolation")
tmisc = lazy_module("plonky2_tpu_torch.gates.misc")
tposeidon = lazy_module("plonky2_tpu_torch.gates.poseidon")
tbuilder = lazy_module("plonky2_tpu_torch.plonk.circuit_builder")
tconfig = lazy_module("plonky2_tpu_torch.plonk.config")
tgen = lazy_module("plonky2_tpu_torch.iop.generator")
twitness = lazy_module("plonky2_tpu_torch.iop.witness")
gf = lazy_module("plonky2_tpu_torch.ops.gf")

# (module, class name, keyword arguments): the port's and the reference's
# gate are built from the same entry
GATES = [
    ("basic", "ArithmeticGate", dict(num_ops=20)),
    ("basic", "ConstantGate", dict(num_consts=2)),
    ("basic", "PublicInputGate", dict()),
    ("poseidon", "PoseidonGate", dict()),
    ("extension", "ArithmeticExtensionGate", dict(num_ops=10)),
    ("extension", "MulExtensionGate", dict(num_ops=13)),
    ("extension", "ReducingGate", dict(num_coeffs=33)),
    ("extension", "ReducingExtensionGate", dict(num_coeffs=32)),
    ("misc", "BaseSumGate", dict(num_limbs=63, base=2)),
    ("misc", "BaseSumGate", dict(num_limbs=16, base=4)),
    ("misc", "ExponentiationGate", dict(num_power_bits=17)),
    ("misc", "RandomAccessGate", dict(bits=4, num_copies=4, num_extra_constants=2)),
    ("interpolation", "CosetInterpolationGate", dict(subgroup_bits=4, max_degree=8)),
    ("interpolation", "CosetInterpolationGate", dict(subgroup_bits=2, max_degree=8)),
    ("interpolation", "PoseidonMdsGate", dict()),
]
IDS = [f"{name}-{'-'.join(str(v) for v in kw.values())}" for _, name, kw in GATES]

# the gates of tests/test_circuit_algebra.py
CIRCUIT_GATES = [
    ("basic", "ArithmeticGate", dict(num_ops=20)),
    ("misc", "BaseSumGate", dict(num_limbs=11, base=2)),
    ("misc", "RandomAccessGate", dict(bits=2, num_copies=2, num_extra_constants=1)),
    ("extension", "ReducingExtensionGate", dict(num_coeffs=8)),
    ("misc", "ExponentiationGate", dict(num_power_bits=5)),
    ("interpolation", "CosetInterpolationGate", dict(subgroup_bits=2, max_degree=8)),
]
CIRCUIT_IDS = [f"{name}-{'-'.join(str(v) for v in kw.values())}" for _, name, kw in CIRCUIT_GATES]


def _port_gate(entry):
    module, name, kw = entry
    mod = {"basic": tbasic, "extension": text, "interpolation": tinterp,
           "misc": tmisc, "poseidon": tposeidon}[module]
    return getattr(mod, name)(**kw)


def _ref_gate(entry):
    import importlib

    module, name, kw = entry
    return getattr(importlib.import_module(f"plonky2_tpu.gates.{module}"), name)(**kw)


def _preset_for(gate, seed=0):
    """Generator inputs that make the witness valid (tests/test_gates.py)."""
    rnd = random.Random(1000 + seed)
    name = type(gate).__name__
    if name == "PoseidonGate":
        return None, {gate.WIRE_SWAP: 1}
    if name == "ExponentiationGate":
        return None, {gate.wire_power_bit(i): rnd.randrange(2) for i in range(gate.num_power_bits)}
    if name == "BaseSumGate":
        return None, {gate.WIRE_SUM: rnd.randrange(min(gate.base**gate.num_limbs, 2**63))}
    if name == "RandomAccessGate":
        preset = {
            gate.wire_access_index(c): rnd.randrange(gate.vec_size())
            for c in range(gate.num_copies)
        }
        consts = [rnd.randrange(P) for _ in range(gate.num_extra_constants)]
        for i, c in enumerate(consts):
            preset[gate.wire_extra_constant(i)] = c
        return consts, preset
    return None, None


def test_gate_ids_match_reference():
    for entry in GATES:
        assert _port_gate(entry).id() == _ref_gate(entry).id()


@pytest.mark.parametrize("entry", GATES, ids=IDS)
def test_low_degree(entry):
    tgt.check_low_degree(_port_gate(entry))


@pytest.mark.parametrize("entry", GATES, ids=IDS)
def test_generated_witness_satisfies_constraints(entry):
    gate = _port_gate(entry)
    if not gate.generators(0, [0] * gate.num_constants()):
        # ConstantGate and PublicInputGate: their wires are set by the
        # builder's generators; hold the row generator to the reference's
        row, _ = tgt.generate_gate_row(gate, seed=0)
        jrow, _ = jgt.generate_gate_row(_ref_gate(entry), seed=0)
        assert row == jrow
        return
    constants, preset = _preset_for(gate)
    tgt.check_generated_witness(gate, constants=constants, preset=preset)
    # the generated row is the reference's, wire for wire
    row, consts = tgt.generate_gate_row(gate, constants, 0, preset)
    jrow, jconsts = jgt.generate_gate_row(_ref_gate(entry), constants, 0, preset)
    assert row == jrow and consts == jconsts


@pytest.mark.parametrize("entry", GATES, ids=IDS)
def test_device_eval_equals_reference_host(entry):
    """The port's device eval on CPU tensors against the reference's
    NumpyBatchAlgebra, on random rows and on a generated (satisfying)
    row: every constraint equal."""
    gate = _port_gate(entry)
    jgate = _ref_gate(entry)
    b = 6
    rng = np.random.default_rng(GATES.index(entry))
    wires = rng.integers(0, P, size=(gate.num_wires(), b), dtype=np.uint64)
    consts = rng.integers(0, P, size=(gate.num_constants(), b), dtype=np.uint64)
    pis = rng.integers(0, P, size=(4, b), dtype=np.uint64)
    constants, preset = _preset_for(gate)
    row, row_consts = tgt.generate_gate_row(gate, constants, 0, preset)
    wires[:, 0] = np.array(row, dtype=np.uint64)
    if gate.num_constants():
        consts[:, 0] = np.array(row_consts, dtype=np.uint64)

    want = jgate.eval_unfiltered(
        JEvalVars(list(consts), list(wires), list(pis)), jgt.NumpyBatchAlgebra(b)
    )
    A = talg.DeviceBatchAlgebra(b, "cpu")
    got = gate.eval_unfiltered_device(
        talg.EvalVars(
            list(gf.from_u64(consts.reshape(-1, b), "cpu").unbind(0)),
            list(gf.from_u64(wires, "cpu").unbind(0)),
            list(gf.from_u64(pis, "cpu").unbind(0)),
        ),
        A,
    )
    assert len(got) == len(want) == gate.num_constraints()
    got_np = np.stack([gf.to_u64(g) for g in got])
    want_np = np.stack([np.asarray(w, dtype=np.uint64) for w in want])
    assert np.array_equal(got_np, want_np)


@pytest.mark.parametrize("entry", GATES, ids=IDS)
def test_algebra_agreement(entry):
    """The port's own harness check (gate_testing.check_algebra_agreement
    on an explicit device)."""
    tgt.check_algebra_agreement(_port_gate(entry), device="cpu")


@pytest.mark.parametrize("entry", GATES, ids=IDS)
def test_host_eval_equals_reference(entry):
    """The verifier's instantiation (HostExtAlgebra, extension tuples)."""
    gate = _port_gate(entry)
    rnd = random.Random(11)
    wires = [(rnd.randrange(P), rnd.randrange(P)) for _ in range(gate.num_wires())]
    consts = [(rnd.randrange(P), rnd.randrange(P)) for _ in range(gate.num_constants())]
    pis = [(rnd.randrange(P), rnd.randrange(P)) for _ in range(4)]
    got = gate.eval_unfiltered(talg.EvalVars(consts, wires, pis), talg.HostExtAlgebra())
    want = _ref_gate(entry).eval_unfiltered(JEvalVars(consts, wires, pis), JHostExtAlgebra())
    assert [tuple(g) for g in got] == [tuple(w) for w in want]


@pytest.mark.parametrize("entry", CIRCUIT_GATES, ids=CIRCUIT_IDS)
def test_circuit_eval_matches_host(entry):
    """In-circuit constraint eval (CircuitAlgebra) agrees with the host
    algebra, through witness generation (tests/test_circuit_algebra.py)."""
    gate = _port_gate(entry)
    rnd = random.Random(5)
    name = type(gate).__name__
    preset = None
    if name == "BaseSumGate":
        preset = {gate.WIRE_SUM: rnd.randrange(2**gate.num_limbs)}
    elif name == "ExponentiationGate":
        preset = {gate.wire_power_bit(i): rnd.randrange(2) for i in range(gate.num_power_bits)}
    elif name == "RandomAccessGate":
        preset = {gate.wire_access_index(c): rnd.randrange(gate.vec_size())
                  for c in range(gate.num_copies)}
    row, constants = tgt.generate_gate_row(gate, seed=3, preset=preset)
    pis_hash = [rnd.randrange(P) for _ in range(4)]

    Ah = talg.HostExtAlgebra()
    host_vals = gate.eval_unfiltered(
        talg.EvalVars([Ah.const(c) for c in constants], [Ah.const(w) for w in row],
                      [Ah.const(h) for h in pis_hash]),
        Ah,
    )
    builder = tbuilder.CircuitBuilder(tconfig.CircuitConfig.standard_recursion_config())
    A = talg.CircuitAlgebra(builder)
    wire_inputs = builder.add_virtual_targets(len(row))
    outs = gate.eval_unfiltered(
        talg.EvalVars(
            [A.const(c) for c in constants],
            [builder.convert_to_ext(t) for t in wire_inputs],
            [A.const(h) for h in pis_hash],
        ),
        A,
    )
    data = builder.build(commit=False)
    pw = twitness.PartialWitness()
    for t, v in zip(wire_inputs, row):
        pw.set_target(t, v)
    witness = tgen.generate_partial_witness(pw, data.prover_only, data.common)
    got = [tuple(witness.get_target(t) for t in o.parts) for o in outs]
    assert got == [tuple(h) for h in host_vals]


def test_poseidon_gate_output_is_permutation():
    from plonky2_tpu.hash import poseidon as jhp

    gate = tposeidon.PoseidonGate()
    for swap in (0, 1):
        row, _ = tgt.generate_gate_row(gate, seed=swap, preset={gate.WIRE_SWAP: swap})
        inputs = [row[gate.wire_input(i)] for i in range(12)]
        if swap:
            inputs = inputs[4:8] + inputs[:4] + inputs[8:]
        assert [row[gate.wire_output(i)] for i in range(12)] == jhp.permute(inputs)


def test_stacked_poseidon_eval_runs_one_plane_per_round():
    """The stacked eval's launches scale with rounds, not wires: count the
    field products it issues on CPU tensors (the generic path issues
    thousands)."""
    gate = tposeidon.PoseidonGate()
    calls = {"n": 0}
    real_mul = gf.load().mul

    def counting_mul(a, b):
        calls["n"] += 1
        return real_mul(a, b)

    b = 4
    wires = list(gf.zeros((gate.num_wires(), b), "cpu").unbind(0))
    vars = talg.EvalVars([], wires, list(gf.zeros((4, b), "cpu").unbind(0)))
    gfm = gf.load()
    gfm.mul = counting_mul
    try:
        gate.eval_unfiltered_device(vars, talg.DeviceBatchAlgebra(b, "cpu"))
        stacked = calls["n"]
        calls["n"] = 0
        gate.eval_unfiltered(vars, talg.DeviceBatchAlgebra(b, "cpu"))
        generic = calls["n"]
    finally:
        gfm.mul = real_mul
    assert stacked < 400 < 4 * 400 < generic

"""Recursion in the port (plonk/recursive_verifier.py, fri/recursive_verifier.py,
hash/recursive_challenger.py, plonk/proof_target.py, recursion/*,
models/bench_recursion.py) on the CPU, held against the JAX package.

* The recursion benchmark's outer circuit over the degree-2^12 inner proof
  pinned in tests/golden/bench_inner_2^12.bin, built without its
  commitment (mirror of tests/test_recursion.py:54-81): its shape (gates,
  the gate of every row, selectors, constants, sigmas) equals the JAX
  package's, pinned in tests/golden/torch_recursion_outer_2^12_shape.json;
  its witness passes check_witness; a tampered inner proof fails. The
  same over the JAX package's pinned gate-mix proof (every gate, lookups).
* The chain under models/bench_recursion.small_recursion_config: the port's
  degree-2^8 inner proof and the degree-2^10 outer proof over it, on both
  transcripts, and the outer's compressed bytes equal the JAX package's
  (tests/golden/torch_recursion_small_*.bin). Proven once a run, in one test.
* Conditional recursion over the pinned small inner proof (mirror of
  tests/test_conditional_recursion.py:52-75), the cyclic plumbing and the
  recursion-shape fixpoint (tests/test_cyclic_plumbing.py:15-105), and the
  in-circuit challenger against the JAX package's host challenger.

The goldens are made by tools/gen_recursion_pins.py. Tolerance: none."""

import copy
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from plonky2_tpu.field.goldilocks import P
from _torch_port import lazy_module

br = lazy_module("plonky2_tpu_torch.models.bench_recursion")
tbuilder = lazy_module("plonky2_tpu_torch.plonk.circuit_builder")
tconfig = lazy_module("plonky2_tpu_torch.plonk.config")
tgen = lazy_module("plonky2_tpu_torch.iop.generator")
twitness = lazy_module("plonky2_tpu_torch.iop.witness")
tprover = lazy_module("plonky2_tpu_torch.plonk.prover")
tverifier = lazy_module("plonky2_tpu_torch.plonk.verifier")
thp = lazy_module("plonky2_tpu_torch.hash.poseidon")
tch = lazy_module("plonky2_tpu_torch.hash.challenger")
jch = lazy_module("plonky2_tpu.hash.challenger")
trc = lazy_module("plonky2_tpu_torch.hash.recursive_challenger")
tpt = lazy_module("plonky2_tpu_torch.plonk.proof_target")
trv = lazy_module("plonky2_tpu_torch.plonk.recursive_verifier")
tcomp = lazy_module("plonky2_tpu_torch.plonk.compressed_proof")
tcond = lazy_module("plonky2_tpu_torch.recursion.conditional")
tdummy = lazy_module("plonky2_tpu_torch.recursion.dummy_circuit")
tcyc = lazy_module("plonky2_tpu_torch.recursion.cyclic_recursion")
thc = lazy_module("plonky2_tpu_torch.models.hash_chain")
wc = lazy_module("plonky2_tpu_torch.plonk.witness_check")
ser = lazy_module("plonky2_tpu_torch.utils.serialization")

GOLDEN = Path(__file__).resolve().parent / "golden"
INNER_LOG2 = 12
SMALL_INNER_LOG2 = 8  # tools/gen_recursion_pins.py SMALL_INNER_LOG2


def _witness(data, pt, vd_t, inner):
    pw = br.recursive_witness(pt, vd_t, inner)
    return tgen.generate_partial_witness(pw, data.prover_only, data.common)


@pytest.mark.parametrize("name", [f"bench_inner_2^{INNER_LOG2}.bin", f"torch_recursion_outer_2^{INNER_LOG2}.bin"])
def test_proof_tuple_round_trip(name):
    """The three-part golden format (common data, verifier data, proof)."""
    raw = (GOLDEN / name).read_bytes()
    assert ser.proof_tuple_to_bytes(*ser.proof_tuple_from_bytes(raw)) == raw
    with pytest.raises(ser.SerializationError):
        ser.parts_from_bytes(raw[:-1])


# ---------------------------------------------------------------------------
# The benchmark's outer circuit over the degree-2^12 inner golden
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def outer():
    inner = ser.proof_tuple_from_bytes((GOLDEN / f"bench_inner_2^{INNER_LOG2}.bin").read_bytes())
    tverifier.verify(*inner)
    config = tconfig.CircuitConfig.standard_recursion_config()
    data, pt, vd_t = br.recursive_circuit(inner[2], config, commit=False, device="cpu")
    return inner, data, pt, vd_t


@pytest.fixture(scope="module")
def reference_shape():
    return json.loads((GOLDEN / f"torch_recursion_outer_2^{INNER_LOG2}_shape.json").read_text())


SHAPE_KEYS = [
    "degree_bits", "gates", "row_gates", "gate_rows", "num_constants", "selector_indices",
    "selector_groups", "num_partial_products", "num_public_inputs", "gate_constants_sha256",
    "sigmas_sha256",
]


@pytest.mark.parametrize("key", SHAPE_KEYS)
def test_outer_shape_equals_reference(outer, reference_shape, key):
    """Gate packing decides every byte of the outer proof: the gates in
    order, the gate of each of the 2^13 rows, the selector groups, the
    constants and the sigmas equal the JAX package's."""
    assert set(reference_shape) == set(SHAPE_KEYS)
    assert br.circuit_shape(outer[1])[key] == reference_shape[key]


def test_outer_degree_is_2_13(outer):
    assert outer[1].common.degree_bits == 13


def test_outer_witness_passes_check_witness(outer):
    inner, data, pt, vd_t = outer
    witness = _witness(data, pt, vd_t, inner)
    assert data.prover_only._witgen_enc.stats["python_gens"] == 0
    wc.check_witness(data, witness.full_witness(), thp.hash_no_pad([]))


@pytest.mark.parametrize("part", ["wire_opening", "pow_witness", "circuit_digest"])
def test_outer_witness_rejects_tampered_inner(outer, part):
    """The inner proof has no public inputs, so the tampering changes an
    opening, the PoW witness or the verifier data's digest."""
    (proof, vd, common), data, pt, vd_t = outer
    proof, vd = copy.deepcopy(proof), copy.deepcopy(vd)
    if part == "wire_opening":
        c0, c1 = proof.proof.openings.wires[0]
        proof.proof.openings.wires[0] = ((c0 + 1) % P, c1)
    elif part == "pow_witness":
        proof.proof.opening_proof.pow_witness += 1
    else:
        d = list(vd.circuit_digest)
        d[0] = (d[0] + 1) % P
        vd = dataclasses.replace(vd, circuit_digest=tuple(d))
    with pytest.raises(Exception):
        witness = _witness(data, pt, vd_t, (proof, vd, common))
        wc.check_witness(data, witness.full_witness(), thp.hash_no_pad([]))


@pytest.fixture(scope="module")
def gate_mix_outer():
    """The outer circuit over the gate mix at degree 2^8
    (models/gate_mix.py: every gate but the Poseidon2 family, four lookups
    a block), built without its commitment, and the JAX package's pinned
    proof of the gate mix."""
    from plonky2_tpu_torch.models.gate_mix import build_gate_mix

    inner_data, _ = build_gate_mix(8, device="cpu")
    proof = ser.proof_from_bytes(
        (GOLDEN / "torch_gate_mix_2^8_proof.bin").read_bytes(), inner_data.common
    )
    config = tconfig.CircuitConfig.standard_recursion_config()
    data, pt, vd_t = br.recursive_circuit(inner_data.common, config, commit=False, device="cpu")
    return (proof, inner_data.verifier_only, inner_data.common), data, pt, vd_t


def test_recursive_verifier_over_gate_mix_golden(gate_mix_outer):
    """Every gate and the lookup argument in the in-circuit verifier."""
    inner, data, pt, vd_t = gate_mix_outer
    assert inner[2].num_lookup_polys > 0 and inner[2].num_public_inputs > 0
    witness = _witness(data, pt, vd_t, inner)
    assert data.prover_only._witgen_enc.stats["python_gens"] == 0
    wc.check_witness(data, witness.full_witness(), thp.hash_no_pad([]))


@pytest.mark.parametrize("part", ["public_input", "lookup_opening"])
def test_recursive_verifier_over_gate_mix_rejects_tampered(gate_mix_outer, part):
    (proof, vd, common), data, pt, vd_t = gate_mix_outer
    bad = copy.deepcopy(proof)
    if part == "public_input":
        bad.public_inputs[0] = (bad.public_inputs[0] + 1) % P
    else:
        z0, z1 = bad.proof.openings.lookup_zs[0]
        bad.proof.openings.lookup_zs[0] = ((z0 + 1) % P, z1)
    with pytest.raises(Exception):
        witness = _witness(data, pt, vd_t, (bad, vd, common))
        wc.check_witness(data, witness.full_witness(), thp.hash_no_pad([]))


# ---------------------------------------------------------------------------
# The chain under the small config, against the JAX package's bytes
# ---------------------------------------------------------------------------


def _small_inner_circuit():
    b = tbuilder.CircuitBuilder(br.small_recursion_config())
    for _ in range((1 << (SMALL_INNER_LOG2 - 1)) + 1):
        b.add_gate(br.NoopGate(), [])
    return b.build(device="cpu")


def test_small_chain_equals_reference():
    """The inner proof and the outer proof over it, each by the device
    transcript (on CPU tensors) and by the host one, equal the JAX package's
    bytes; so do their common data and the outer's compressed proof, which
    round-trips through bytes and decompresses to the proof. The outer
    witness is native; a tampered outer proof is rejected. One test, so
    that the chain is proven once a run."""
    config = br.small_recursion_config()
    inner_data = _small_inner_circuit()
    proofs = {}
    for which in ("inner", "outer"):
        if which == "inner":
            data, pw = inner_data, twitness.PartialWitness()
        else:
            inner = (proofs["inner"], inner_data.verifier_only, inner_data.common)
            data, pt, vd_t = br.recursive_circuit(inner_data.common, config, device="cpu")
            pw = br.recursive_witness(pt, vd_t, inner)
        want = (GOLDEN / f"torch_recursion_small_{which}_proof.bin").read_bytes()
        assert ser.common_data_to_bytes(data.common) == (
            GOLDEN / f"torch_recursion_small_{which}_common.bin"
        ).read_bytes(), which
        for dt in (True, False):
            pwp = tprover.prove(data.prover_only, data.common, pw, device="cpu", device_transcript=dt)
            tverifier.verify(pwp, data.verifier_only, data.common)
            assert ser.proof_to_bytes(pwp, data.common) == want, (which, dt)
        proofs[which] = pwp
    assert (inner_data.common.degree_bits, data.common.degree_bits) == (8, 10)
    assert data.prover_only._witgen_enc.stats["python_gens"] == 0

    c = tcomp.compress_proof(pwp, data.verifier_only, data.common)
    tcomp.verify_compressed_proof(c, data.verifier_only, data.common)
    raw = ser.compressed_proof_to_bytes(c, data.common)
    assert raw == (GOLDEN / "torch_recursion_small_outer_compressed.bin").read_bytes()
    info = br.test_serialization(pwp, data.verifier_only, data.common)
    assert info["compressed_proof_bytes"] == len(raw)
    assert info["proof_bytes"] == len(want)

    bad = copy.deepcopy(pwp)
    c0, c1 = bad.proof.openings.wires[3]
    bad.proof.openings.wires[3] = (c0, (c1 + 1) % P)
    with pytest.raises(Exception):
        tverifier.verify(bad, data.verifier_only, data.common)


# ---------------------------------------------------------------------------
# Conditional recursion over the small inner
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def conditional():
    """The circuit of tests/test_conditional_recursion.py:61-75 over the
    small inner circuit, built without its commitment, and the inner
    proof pinned from the JAX package."""
    inner_data = _small_inner_circuit()
    proof = ser.proof_from_bytes(
        (GOLDEN / "torch_recursion_small_inner_proof.bin").read_bytes(), inner_data.common
    )
    b = tbuilder.CircuitBuilder(br.small_recursion_config())
    cond = b.add_virtual_bool_target_safe()
    pt = tpt.add_virtual_proof_with_pis(b, inner_data.common)
    vd_t = trv.add_virtual_verifier_data(b, inner_data.common.fri_params.config.cap_height)
    tcond.conditionally_verify_proof_or_dummy(b, cond, pt, vd_t, inner_data.common, device="cpu")
    return b.build(commit=False), cond, pt, vd_t, (proof, inner_data.verifier_only, inner_data.common)


def _conditional_witness(conditional, condition, proof):
    outer, cond, pt, vd_t, (_, vd, _) = conditional
    pw = twitness.PartialWitness()
    pw.set_target(cond.target, condition)
    tpt.set_proof_with_pis_target(pw, pt, proof)
    trv.set_verifier_data_target(pw, vd_t, vd)
    witness = tgen.generate_partial_witness(pw, outer.prover_only, outer.common)
    wc.check_witness(outer, witness.full_witness(), thp.hash_no_pad([]))


def test_dummy_circuit_matches_common(conditional):
    """The conditional circuit's dummy: the proof of dummy_circuit(common),
    made by its generator, verifies, and its common data has the inner's
    shape."""
    outer, *_, (_, _, common) = conditional
    gen = next(g for g in outer.prover_only.generators if isinstance(g, tcond.DummyProofGenerator))
    proof, vd, dummy_common = gen.dummy()
    assert tdummy.common_shape_eq(dummy_common, common)
    tverifier.verify(proof, vd, common)


@pytest.mark.parametrize("condition", [1, 0])
def test_conditional_recursion_witness(conditional, condition):
    outer = conditional[0]
    _conditional_witness(conditional, condition, conditional[-1][0])
    gens = outer.prover_only.generators
    left = {type(gens[i]).__name__ for i in outer.prover_only._witgen_enc.python_gens}
    assert left <= {"DummyProofGenerator", "_ZeroGenerator"}


def test_conditional_recursion_rejects_tampered_selected_proof(conditional):
    """With condition 1 the real proof is verified: a tampered one fails."""
    bad = copy.deepcopy(conditional[-1][0])
    bad.proof.opening_proof.pow_witness += 1
    with pytest.raises(Exception):
        _conditional_witness(conditional, 1, bad)


# ---------------------------------------------------------------------------
# Cyclic plumbing and the recursion-shape fixpoint
# ---------------------------------------------------------------------------


def test_register_verifier_data_public_inputs():
    b = tbuilder.CircuitBuilder(tconfig.CircuitConfig.standard_recursion_config())
    cap_height = b.config.fri_config.cap_height
    vd = tcyc.register_verifier_data_public_inputs(b, cap_height)
    assert len(vd.constants_sigmas_cap.hashes) == 1 << cap_height
    assert len(b.public_inputs) == (1 << cap_height) * 4 + 4


def test_check_cyclic_proof_verifier_data():
    class FakeCommon:
        class fri_params:
            class config:
                cap_height = 1

    class FakeVD:
        constants_sigmas_cap = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=np.uint64)
        circuit_digest = (9, 10, 11, 12)

    class FakeProof:
        public_inputs = [99, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12]

    tcyc.check_cyclic_proof_verifier_data(FakeProof, FakeVD, FakeCommon)

    class BadProof:
        public_inputs = [99, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13]

    with pytest.raises(ValueError):
        tcyc.check_cyclic_proof_verifier_data(BadProof, FakeVD, FakeCommon)


@pytest.fixture(scope="module")
def recursion_common():
    return tcyc.common_data_for_recursion()


def test_common_data_for_recursion_equals_reference(recursion_common):
    """The fixpoint's common data, built without commitments, serializes to
    the JAX package's bytes."""
    from plonky2_tpu.recursion.cyclic_recursion import common_data_for_recursion
    from plonky2_tpu.utils import serialization as jser

    want = jser.common_data_to_bytes(common_data_for_recursion())
    assert ser.common_data_to_bytes(recursion_common) == want


def test_cyclic_chain_reaches_its_fixpoint(recursion_common):
    """The hash-chain circuit of tests/test_cyclic_plumbing.py:64-105
    (models/hash_chain.py), built without its commitment: its common data
    has the shape of the common data it verifies (common_shape_eq), so a
    proof of it can be verified by itself. No dummy proof is made: its
    generator runs only when a witness is generated."""
    data, chain = thc.hash_chain_circuit(common_data=recursion_common, commit=False, device="cpu")
    assert tdummy.common_shape_eq(data.common, chain.common_data), (
        data.common.trace_degree_bits, chain.common_data.trace_degree_bits,
        [g.id() for g in data.common.gates], [g.id() for g in chain.common_data.gates],
    )


# ---------------------------------------------------------------------------
# The in-circuit challenger against the host challengers
# ---------------------------------------------------------------------------

# ("obs", k): observe k elements; ("sq", n): draw n challenges; ("ext",):
# an extension challenge; ("hash",): a hash of 4
CHALLENGER_SEQUENCES = {
    "squeeze_fresh": [("sq", 1), ("sq", 9), ("ext",)],
    "observe_8_then_squeeze": [("obs", 8), ("sq", 1), ("sq", 8), ("sq", 3)],
    "observe_9": [("obs", 9), ("sq", 2), ("obs", 7), ("hash",)],
    "pending_outputs_cleared_by_observe": [("obs", 3), ("sq", 2), ("obs", 1), ("sq", 7)],
    "pending_outputs_drained": [("obs", 16), ("sq", 8), ("sq", 1), ("ext",), ("obs", 12), ("sq", 4)],
}


@pytest.mark.parametrize("name", sorted(CHALLENGER_SEQUENCES))
def test_recursive_challenger_equals_host(name):
    """The in-circuit challenger's outputs, read from a generated witness,
    equal the JAX package's host challenger's on the same observed elements,
    and so do the port's host challenger's."""
    rng = np.random.default_rng(len(name))
    b = tbuilder.CircuitBuilder(tconfig.CircuitConfig.standard_recursion_config())
    rc = trc.RecursiveChallenger(b)
    ref, host = jch.Challenger(), tch.Challenger()
    pw = twitness.PartialWitness()
    outs, want, got_host = [], [], []
    for op in CHALLENGER_SEQUENCES[name]:
        if op[0] == "obs":
            vals = [int(v) for v in rng.integers(0, P, size=op[1], dtype=np.uint64)]
            ts = b.add_virtual_targets(op[1])
            for t, v in zip(ts, vals):
                pw.set_target(t, v)
            rc.observe_elements(ts)
            ref.observe_elements(vals)
            host.observe_elements(vals)
        elif op[0] == "sq":
            outs += rc.get_n_challenges(op[1])
            want += ref.get_n_challenges(op[1])
            got_host += host.get_n_challenges(op[1])
        elif op[0] == "ext":
            outs += list(rc.get_extension_challenge().parts)
            want += list(ref.get_extension_challenge())
            got_host += list(host.get_extension_challenge())
        else:
            outs += rc.get_hash()
            want += list(ref.get_hash())
            got_host += list(host.get_hash())
    data = b.build(commit=False)
    witness = tgen.generate_partial_witness(pw, data.prover_only, data.common)
    assert [int(witness.try_get_target(t)) for t in outs] == [int(v) for v in want]
    assert [int(v) for v in got_host] == [int(v) for v in want]

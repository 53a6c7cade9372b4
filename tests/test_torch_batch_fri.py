"""Batch FRI in the port (plonky2_tpu_torch: ops/merkle.BatchDeviceMerkleTree,
fri/batch_oracle.py, fri/batch_recursive_verifier.py) on the CPU, with the
kernels' plain versions, held against the JAX package's values pinned by
tools/gen_batch_pins.py (tests/golden/torch_batch_{tree,fri_roundtrip,
fri_recursion}.json). Mirrors tests/test_batch_fri.py and
tests/test_batch_fri_recursion.py case by case; the reference's proves do
not end inside the tier-1 clock, so none is run here. Tolerance: none —
integer equality."""

import copy
import json
import os

import numpy as np
import pytest

from plonky2_tpu.ops import merkle as jmerkle
from _torch_port import lazy_module

ge = lazy_module("plonky2_tpu_torch.field.extension")
tmerkle = lazy_module("plonky2_tpu_torch.ops.merkle")
tgf = lazy_module("plonky2_tpu_torch.ops.gf")
tposeidon = lazy_module("plonky2_tpu_torch.ops.poseidon")
bo = lazy_module("plonky2_tpu_torch.fri.batch_oracle")
brv = lazy_module("plonky2_tpu_torch.fri.batch_recursive_verifier")
frv = lazy_module("plonky2_tpu_torch.fri.recursive_verifier")
fconfig = lazy_module("plonky2_tpu_torch.fri.config")
fst = lazy_module("plonky2_tpu_torch.fri.structure")
fverifier = lazy_module("plonky2_tpu_torch.fri.verifier")
challenger = lazy_module("plonky2_tpu_torch.hash.challenger")
rch = lazy_module("plonky2_tpu_torch.hash.recursive_challenger")
hp = lazy_module("plonky2_tpu_torch.hash.poseidon")
gen = lazy_module("plonky2_tpu_torch.iop.generator")
witness = lazy_module("plonky2_tpu_torch.iop.witness")
cb = lazy_module("plonky2_tpu_torch.plonk.circuit_builder")
cconfig = lazy_module("plonky2_tpu_torch.plonk.config")
pt = lazy_module("plonky2_tpu_torch.plonk.proof_target")
wc = lazy_module("plonky2_tpu_torch.plonk.witness_check")
ser = lazy_module("plonky2_tpu_torch.utils.serialization")

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
P = 0xFFFF_FFFF_0000_0001
TREE_SHAPES = [(64, 3), (16, 2), (4, 5)]
TREE_HEIGHTS = [6, 4, 2]


def _golden(name):
    with open(os.path.join(GOLDEN, name)) as f:
        return json.load(f)


def _tree_matrices():
    rng = np.random.default_rng(0)
    return [rng.integers(0, P, size=s, dtype=np.uint64) for s in TREE_SHAPES]


@pytest.fixture(scope="module")
def tree():
    return tmerkle.BatchDeviceMerkleTree.build(_tree_matrices(), cap_height=1, device="cpu")


def test_batch_tree_equals_reference(tree):
    pin = _golden("torch_batch_tree.json")
    idx = np.arange(TREE_SHAPES[0][0])
    assert [int(v) for v in tree.cap_u64().reshape(-1)] == pin["cap"]
    assert [[int(v) for v in r.reshape(-1)] for r in tree.values_batch(idx)] == pin["rows"]
    assert [int(v) for v in tree.prove_batch(idx).reshape(-1)] == pin["paths"]


def test_batch_tree_levels_join_at_each_height(tree):
    """levels[k] is the row at height 6 - k after the join of the matrix of
    that height: the 16- and 4-row matrices re-hash levels 2 and 4 as
    leaves of width 4 + w."""
    import torch

    assert [lvl.shape[0] for lvl in tree.levels] == [64, 32, 16, 8, 4, 2]
    for k, m in ((2, tree.leaves[1]), (4, tree.leaves[2])):
        below = tposeidon.compress_pairs(tree.levels[k - 1])
        joined = tposeidon.hash_leaf(torch.cat([below, m], dim=1))
        assert tgf.to_u64(joined).tolist() == tgf.to_u64(tree.levels[k]).tolist()


@pytest.mark.parametrize("idx", [0, 5, 37, 63])
def test_batch_merkle_tree_prove_verify(tree, idx):
    """tests/test_batch_fri.py::test_batch_merkle_tree_prove_verify: the
    port's path is accepted by both packages' host verifiers, and a
    tampered row of the middle matrix by neither."""
    cap = tree.cap_u64()
    rows = tree.values_batch(np.array([idx]))
    sibs = [tuple(int(x) for x in s) for s in tree.prove_batch(np.array([idx]))[0]]
    leaf_data = [[int(v) for v in r[0]] for r in rows]
    bad = [list(r) for r in leaf_data]
    bad[1][0] ^= 1
    for verify in (tmerkle.verify_batch_merkle_proof_to_cap, jmerkle.verify_batch_merkle_proof_to_cap):
        assert verify(leaf_data, TREE_HEIGHTS, idx, cap, sibs)
        assert not verify(bad, TREE_HEIGHTS, idx, cap, sibs)


def _fri_params(degree_bits, arities, queries, cap_height, pow_bits):
    return fconfig.FriParams(
        config=fconfig.FriConfig(
            rate_bits=1,
            cap_height=cap_height,
            proof_of_work_bits=pow_bits,
            reduction_strategy=fconfig.FriReductionStrategy.Fixed(list(arities)),
            num_query_rounds=queries,
        ),
        leaf_hiding=False,
        degree_bits=degree_bits,
        reduction_arity_bits=tuple(arities),
    )


def _poly_eval_ext(coeffs_u64, zeta):
    acc = ge.ext_zero(2)
    for c in reversed([int(x) for x in coeffs_u64]):
        acc = ge.ext_add(ge.ext_mul(acc, zeta), ge.from_base(c, 2))
    return acc


def _instance(m, zeta):
    return fst.FriInstanceInfo(
        oracles=[fst.FriOracleInfo(m, False)],
        batches=[fst.FriBatchInfo.from_polys(tuple(zeta), fst.FriPolynomialInfo.from_range(0, 0, m))],
    )


DEGREE_BITS = [8, 6, 4]
GROUP_SIZES = [2, 2, 1]


@pytest.fixture(scope="module")
def roundtrip():
    """tests/test_batch_fri.py::test_batch_fri_roundtrip on the port: three
    groups of degrees 2^8, 2^6, 2^4 from seed 1 in one batch tree, opened at
    one zeta; the verifier's challenges from its own transcript."""
    params = _fri_params(DEGREE_BITS[0], [2, 2, 2], 10, 2, 2)
    rng = np.random.default_rng(1)
    value_groups = [
        rng.integers(0, P, size=(m, 1 << d), dtype=np.uint64)
        for m, d in zip(GROUP_SIZES, DEGREE_BITS)
    ]
    oracle = bo.BatchFriOracle.from_values(value_groups, 1, False, 2, device="cpu")
    cap = oracle.batch_merkle_tree.cap_u64()
    ch = challenger.Challenger()
    ch.observe_cap(cap)
    zeta = ch.get_extension_challenge(2)
    instances, openings = [], []
    for g, m in enumerate(GROUP_SIZES):
        coeffs = tgf.to_u64(oracle.polynomials[g])
        evals = [_poly_eval_ext(coeffs[j], zeta) for j in range(m)]
        for e in evals:
            ch.observe_extension_element(e)
        instances.append(_instance(m, zeta))
        openings.append(fst.FriOpenings(batches=[fst.FriOpeningBatch(values=evals)]))
    vch = challenger.Challenger()
    vch.observe_cap(cap)
    assert vch.get_extension_challenge(2) == zeta
    for o in openings:
        for e in o.batches[0].values:
            vch.observe_extension_element(e)
    proof = bo.prove_batch_openings(DEGREE_BITS, instances, oracle, ch, params)
    challenges = fverifier.fri_challenges(
        vch, proof.commit_phase_merkle_caps, proof.final_poly, proof.pow_witness,
        DEGREE_BITS[0], params.config,
    )
    return params, cap, zeta, instances, openings, proof, challenges


def _verify_roundtrip(params, cap, instances, openings, proof, challenges):
    bo.verify_batch_fri_proof(
        DEGREE_BITS, instances, openings, challenges, cap, [d + 1 for d in DEGREE_BITS],
        proof, params,
    )


def test_batch_fri_roundtrip_equals_reference(roundtrip):
    _, cap, zeta, _, openings, proof, _ = roundtrip
    pin = _golden("torch_batch_fri_roundtrip.json")
    assert ser.int_tree(cap) == pin["cap"]
    assert list(zeta) == pin["zeta"]
    assert ser.int_tree([o.batches[0].values for o in openings]) == pin["openings"]
    assert ser.int_tree(proof) == pin["proof"]


def test_batch_fri_roundtrip(roundtrip):
    params, cap, _, instances, openings, proof, challenges = roundtrip
    _verify_roundtrip(params, cap, instances, openings, proof, challenges)


def test_batch_fri_roundtrip_rejects_tampered_step_eval(roundtrip):
    params, cap, _, instances, openings, proof, challenges = roundtrip
    bad = copy.deepcopy(proof)
    ev = bad.query_round_proofs[0].steps[0].evals
    ev[0] = (ev[0][0] ^ 1, ev[0][1])
    with pytest.raises(fverifier.FriVerificationError):
        _verify_roundtrip(params, cap, instances, openings, bad, challenges)


def test_batch_fri_schedule_must_reach_every_group():
    """A group whose size no fold reaches is refused before any commit."""
    params = _fri_params(8, [2, 2, 2], 10, 2, 2)
    coeffs = tgf.zeros((1 << 9, 2), "cpu")
    values = [coeffs, tgf.zeros((1 << 4, 2), "cpu")]
    with pytest.raises(AssertionError, match="never reach"):
        bo.batch_fri_proof([], coeffs, values, challenger.Challenger(), params)


# ---------------------------------------------------------------------------
# In-circuit batch FRI (tests/test_batch_fri_recursion.py), over the JAX
# package's pinned proof
# ---------------------------------------------------------------------------

REC_DEGREE_BITS = [6, 4]
REC_GROUP_SIZES = [2, 1]


def _run_circuit(circuit, cap, openings, proof):
    data, params, cap_t, evals_t, proof_t = circuit
    setters = pt.load()  # _set_cap, _set_exts
    pw = witness.PartialWitness()
    setters._set_cap(pw, cap_t, cap)
    for ets, evals in zip(evals_t, openings):
        setters._set_exts(pw, ets, evals)
    for cap_tt, c in zip(proof_t.commit_phase_merkle_caps, proof.commit_phase_merkle_caps):
        setters._set_cap(pw, cap_tt, c)
    for round_t, rnd in zip(proof_t.query_round_proofs, proof.query_round_proofs):
        (et, mt), (ev, mp) = round_t.initial_trees_proof.evals_proofs[0], rnd.initial_trees_proof.evals_proofs[0]
        for t, v in zip(et, ev):
            pw.set_target(t, int(v))
        for sib_t, sib in zip(mt.siblings, mp.siblings):
            for t, v in zip(sib_t, sib):
                pw.set_target(t, int(v))
        for step_t, step in zip(round_t.steps, rnd.steps):
            setters._set_exts(pw, step_t.evals, step.evals)
            for sib_t, sib in zip(step_t.merkle_proof.siblings, step.merkle_proof.siblings):
                for t, v in zip(sib_t, sib):
                    pw.set_target(t, int(v))
    setters._set_exts(pw, proof_t.final_poly, proof.final_poly)
    pw.set_target(proof_t.pow_witness, int(proof.pow_witness))
    w = gen.generate_partial_witness(pw, data.prover_only, data.common)
    wc.check_witness(data, w.full_witness(), hp.hash_no_pad([]))


@pytest.fixture(scope="module")
def pinned_recursion():
    """The pinned proof of tests/test_batch_fri_recursion.py and the port's
    circuit that verifies it: the cap, zeta, openings and FRI challenges
    drawn in-circuit, then verify_batch_fri_proof_circuit."""
    pin = _golden("torch_batch_fri_recursion.json")
    params = _fri_params(REC_DEGREE_BITS[0], [2, 2], 4, 1, 1)
    zeta = tuple(pin["zeta"])
    instances = [_instance(m, zeta) for m in REC_GROUP_SIZES]
    b = cb.CircuitBuilder(cconfig.CircuitConfig.standard_recursion_config())

    class _Shim:
        fri_params = params

    cap_t = pt.add_virtual_cap(b, params.config.cap_height)
    proof_t = pt.add_virtual_fri_proof(b, _Shim(), widths=[sum(REC_GROUP_SIZES)])
    evals_t = [b.add_virtual_extension_targets(m) for m in REC_GROUP_SIZES]
    ch = rch.RecursiveChallenger(b)
    ch.observe_cap(cap_t)
    zeta_t = ch.get_extension_challenge()
    for ets in evals_t:
        ch.observe_extension_elements(ets)
    fri_ch = frv.fri_challenges_circuit(
        b, ch, proof_t.commit_phase_merkle_caps, proof_t.final_poly, proof_t.pow_witness,
        params.config,
    )
    instances_t = [frv.FriInstanceInfoTarget(static_info=i, batch_points=[zeta_t]) for i in instances]
    brv.verify_batch_fri_proof_circuit(
        b, REC_DEGREE_BITS, instances_t, [[list(ets)] for ets in evals_t], fri_ch, [cap_t],
        proof_t, params,
    )
    circuit = (b.build(commit=False), params, cap_t, evals_t, proof_t)
    cap = np.array(pin["cap"], dtype=np.uint64).reshape(-1, 4)
    openings = [[tuple(e) for e in o] for o in pin["openings"]]
    return circuit, cap, openings, ser.fri_proof_from_int_tree(pin["proof"])


def test_pinned_proof_decodes_to_its_tree(pinned_recursion):
    _, _, _, proof = pinned_recursion
    assert ser.int_tree(proof) == _golden("torch_batch_fri_recursion.json")["proof"]


def test_batch_fri_in_circuit(pinned_recursion):
    _run_circuit(*pinned_recursion)


def test_batch_fri_in_circuit_rejects_tamper(pinned_recursion):
    circuit, cap, openings, proof = pinned_recursion
    bad = copy.deepcopy(proof)
    ev = bad.query_round_proofs[0].steps[0].evals
    ev[0] = (ev[0][0] ^ 1, ev[0][1])
    with pytest.raises(Exception):
        _run_circuit(circuit, cap, openings, bad)


# ---------------------------------------------------------------------------
# Entry points: the GPU unless the CPU is named
# ---------------------------------------------------------------------------


def test_batch_entry_points_need_a_device():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means it")
    mats = _tree_matrices()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmerkle.BatchDeviceMerkleTree.build(mats, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bo.BatchFriOracle.from_values(mats[:1], 1, False, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bo.BatchFriOracle.from_coeffs(mats[:1], 1, False, 1)
    cpu = tgf.from_u64(mats[0], "cpu")
    with pytest.raises(ValueError):
        tmerkle.BatchDeviceMerkleTree.build([cpu], 1, device="meta")


def test_batch_oracle_refuses_blinding():
    with pytest.raises(NotImplementedError, match="blinding"):
        bo.BatchFriOracle.from_coeffs([np.zeros((1, 4), dtype=np.uint64)], 1, True, 0, device="cpu")

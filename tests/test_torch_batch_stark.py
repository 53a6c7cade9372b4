"""The batch STARK in the port (plonky2_tpu_torch.stark.batch_prover and
stark/batch_recursive_verifier.py) on the CPU, with the kernels' plain
versions: two FibonacciStark tables of 2^7 and 2^5 rows in shared batch
trees under tests/test_batch_stark.py's config. Mirrors that file case by
case against the JAX package's proof pinned by tools/gen_batch_pins.py
(tests/golden/torch_batch_stark_7_5.json; the reference's prove does not
end inside the tier-1 clock). Tolerance: none — integer equality."""

import copy
import json
import os

import pytest

from plonky2_tpu.fri.config import FriConfig as JFriConfig
from plonky2_tpu.fri.config import FriReductionStrategy as JFriReductionStrategy
from plonky2_tpu.fri.verifier import FriVerificationError as JFriVerificationError
from plonky2_tpu.plonk.circuit_builder import CircuitBuilder as JCircuitBuilder
from plonky2_tpu.plonk.config import CircuitConfig as JCircuitConfig
from plonky2_tpu.stark import batch_recursive_verifier as jbrv
from plonky2_tpu.stark.batch_prover import batch_verify as jbatch_verify
from plonky2_tpu.stark.config import StarkConfig as JStarkConfig
from plonky2_tpu.stark.fixtures import FibonacciStark as JFibonacciStark
from plonky2_tpu.stark.verifier import StarkVerificationError as JStarkVerificationError
from _torch_port import lazy_module

bp = lazy_module("plonky2_tpu_torch.stark.batch_prover")
brv = lazy_module("plonky2_tpu_torch.stark.batch_recursive_verifier")
tconfig = lazy_module("plonky2_tpu_torch.stark.config")
tfix = lazy_module("plonky2_tpu_torch.stark.fixtures")
tverifier = lazy_module("plonky2_tpu_torch.stark.verifier")
fconfig = lazy_module("plonky2_tpu_torch.fri.config")
fverifier = lazy_module("plonky2_tpu_torch.fri.verifier")
hp = lazy_module("plonky2_tpu_torch.hash.poseidon")
gen = lazy_module("plonky2_tpu_torch.iop.generator")
witness = lazy_module("plonky2_tpu_torch.iop.witness")
cb = lazy_module("plonky2_tpu_torch.plonk.circuit_builder")
cconfig = lazy_module("plonky2_tpu_torch.plonk.config")
wc = lazy_module("plonky2_tpu_torch.plonk.witness_check")
br = lazy_module("plonky2_tpu_torch.models.bench_recursion")
ser = lazy_module("plonky2_tpu_torch.utils.serialization")

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
DEGREES = [7, 5]


def _golden(name):
    with open(os.path.join(GOLDEN, name)) as f:
        return json.load(f)


def _config(stark_config, fri_config, strategy):
    """tests/test_batch_stark.py:21-32, from either package's classes."""
    return stark_config(
        security_bits=1,
        num_challenges=2,
        fri_config=fri_config(
            rate_bits=1,
            cap_height=1,
            proof_of_work_bits=1,
            reduction_strategy=strategy.Fixed([2, 2]),
            num_query_rounds=8,
        ),
    )


def _jconfig():
    return _config(JStarkConfig, JFriConfig, JFriReductionStrategy)


@pytest.fixture(scope="module")
def system():
    starks = [tfix.FibonacciStark(1 << d) for d in DEGREES]
    traces = [s.generate_trace(0, 1) for s in starks]
    pis = [[0, 1, tfix.fibonacci_res(1 << d, 0, 1)] for d in DEGREES]
    config = _config(tconfig.StarkConfig, fconfig.FriConfig, fconfig.FriReductionStrategy)
    proof = bp.batch_prove(starks, config, traces, pis, device="cpu")
    return starks, config, proof


def _verify_errors():
    return (tverifier.StarkVerificationError, fverifier.FriVerificationError)


def test_batch_stark_proof_equals_reference(system):
    _, _, proof = system
    assert ser.int_tree(proof) == _golden("torch_batch_stark_7_5.json")["proof"]


def test_batch_stark_proves_and_verifies(system):
    starks, config, proof = system
    bp.batch_verify(starks, config, proof)


def test_batch_stark_reference_verifier_accepts(system):
    """The JAX package's host batch_verify on the port's proof."""
    _, _, proof = system
    jconfig = _jconfig()
    jbatch_verify([JFibonacciStark(1 << d) for d in DEGREES], jconfig, proof)


def _tamper_opening(bad):
    lv = bad.openings[1].local_values[0]
    bad.openings[1].local_values[0] = (lv[0] ^ 1, lv[1])


def _tamper_public_input(bad):
    bad.public_inputs[0][2] ^= 1


def _tamper_query_leaf(bad):
    ep = bad.opening_proof.query_round_proofs[0].initial_trees_proof.evals_proofs
    vals, mp = ep[0]
    vals = list(vals)
    vals[0] ^= 1
    ep[0] = (vals, mp)


@pytest.mark.parametrize(
    "tamper", [_tamper_opening, _tamper_public_input, _tamper_query_leaf],
    ids=["opening", "public_input", "query_leaf"],
)
def test_batch_stark_rejects_tampered(system, tamper):
    """tests/test_batch_stark.py::test_batch_stark_rejects_tampered_*: both
    packages' verifiers reject."""
    starks, config, proof = system
    bad = copy.deepcopy(proof)
    tamper(bad)
    with pytest.raises(_verify_errors()):
        bp.batch_verify(starks, config, bad)
    jconfig = _jconfig()
    with pytest.raises((JStarkVerificationError, JFriVerificationError)):
        jbatch_verify([JFibonacciStark(1 << d) for d in DEGREES], jconfig, bad)


@pytest.fixture(scope="module")
def circuit(system):
    starks, config, proof = system
    b = cb.CircuitBuilder(cconfig.CircuitConfig.standard_recursion_config())
    proof_t = brv.add_virtual_batch_stark_proof(b, starks, config, proof.degree_bits)
    brv.verify_batch_stark_proof_circuit(b, starks, proof_t, config, proof.degree_bits)
    return b.build(commit=False), proof_t


def _run_recursive(circuit, proof):
    data, proof_t = circuit
    pw = witness.PartialWitness()
    brv.set_batch_stark_proof_target(pw, proof_t, proof)
    w = gen.generate_partial_witness(pw, data.prover_only, data.common)
    wc.check_witness(data, w.full_witness(), hp.hash_no_pad([]))


def test_batch_stark_recursive_verifier(system, circuit):
    _run_recursive(circuit, system[2])


def test_batch_stark_recursive_verifier_rejects_tamper(system, circuit):
    bad = copy.deepcopy(system[2])
    ev = bad.opening_proof.query_round_proofs[0].steps[0].evals
    ev[0] = (ev[0][0] ^ 1, ev[0][1])
    with pytest.raises(Exception):
        _run_recursive(circuit, bad)


def test_batch_stark_recursive_circuit_equals_reference(circuit):
    """The JAX package's circuit of the same verifier (built without its
    commitment: no prove) has the port's shape."""
    jconfig = _jconfig()
    starks = [JFibonacciStark(1 << d) for d in DEGREES]
    b = JCircuitBuilder(JCircuitConfig.standard_recursion_config())
    proof_t = jbrv.add_virtual_batch_stark_proof(b, starks, jconfig, DEGREES)
    jbrv.verify_batch_stark_proof_circuit(b, starks, proof_t, jconfig, DEGREES)
    assert br.circuit_shape(circuit[0]) == br.circuit_shape(b.build(commit=False))


class _LookupStark:
    """A table that claims lookups: the batch prover and the batch
    recursive verifier refuse it, as the JAX package's batch prover does."""

    def uses_lookups(self):
        return True

    def requires_ctls(self):
        return False


def test_batch_stark_refuses_lookups(system):
    _, config, _ = system
    import numpy as np

    with pytest.raises(NotImplementedError, match="refuses lookups too"):
        bp.batch_prove([_LookupStark()], config, [np.zeros((2, 4), dtype=np.uint64)], [[]], device="cpu")
    b = cb.CircuitBuilder(cconfig.CircuitConfig.standard_recursion_config())
    with pytest.raises(NotImplementedError, match="refuses lookups too"):
        brv.add_virtual_batch_stark_proof(b, [_LookupStark()], config, [2])


def test_batch_prove_needs_a_device(system):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means it")
    starks, config, proof = system
    traces = [s.generate_trace(0, 1) for s in starks]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bp.batch_prove(starks, config, traces, proof.public_inputs)

"""Recursive STARK verification in the port (plonky2_tpu_torch:
stark/recursive_verifier.py, the unified multi-degree FRI verifier of
fri/recursive_verifier.py, stark/prover.py's verifier_circuit_fri_params) on
the CPU, with the kernels' plain versions. Mirrors the lookup-free case of
tests/test_stark_recursion.py and tests/test_multi_degree_recursion.py case
by case: circuits held to the JAX package's by their shape (built without
their commitment: no prove), the JAX package's proofs pinned by
tools/gen_batch_pins.py (tests/golden/torch_stark_2^5.json, verified in
the port's circuit; torch_stark_multi_degree.json, equal to the port's
padded proofs).
Tolerance: none — integer equality."""

import copy
import json
import os

import pytest

from plonky2_tpu.fri.config import FriConfig as JFriConfig
from plonky2_tpu.fri.config import FriReductionStrategy as JFriReductionStrategy
from plonky2_tpu.plonk.circuit_builder import CircuitBuilder as JCircuitBuilder
from plonky2_tpu.plonk.config import CircuitConfig as JCircuitConfig
from plonky2_tpu.stark import recursive_verifier as jrv
from plonky2_tpu.stark.config import StarkConfig as JStarkConfig
from plonky2_tpu.stark.fixtures import FibonacciStark as JFibonacciStark
from plonky2_tpu.stark.verifier import verify_stark_proof as jverify
from _torch_port import lazy_module

rv = lazy_module("plonky2_tpu_torch.stark.recursive_verifier")
tprover = lazy_module("plonky2_tpu_torch.stark.prover")
tverifier = lazy_module("plonky2_tpu_torch.stark.verifier")
tconfig = lazy_module("plonky2_tpu_torch.stark.config")
tfix = lazy_module("plonky2_tpu_torch.stark.fixtures")
fconfig = lazy_module("plonky2_tpu_torch.fri.config")
hp = lazy_module("plonky2_tpu_torch.hash.poseidon")
gen = lazy_module("plonky2_tpu_torch.iop.generator")
witness = lazy_module("plonky2_tpu_torch.iop.witness")
cb = lazy_module("plonky2_tpu_torch.plonk.circuit_builder")
cconfig = lazy_module("plonky2_tpu_torch.plonk.config")
wc = lazy_module("plonky2_tpu_torch.plonk.witness_check")
br = lazy_module("plonky2_tpu_torch.models.bench_recursion")
ser = lazy_module("plonky2_tpu_torch.utils.serialization")

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
P = 0xFFFF_FFFF_0000_0001
DEGREE_BITS = 5
MAX_DEGREE_BITS = 5
MIN_DEGREE_BITS = 3


def _golden(name):
    with open(os.path.join(GOLDEN, name)) as f:
        return json.load(f)


def _check(circuit, pwp, degree_bits=None):
    data, pt = circuit
    pw = witness.PartialWitness()
    rv.set_stark_proof_with_pis_target(pw, pt, pwp, degree_bits=degree_bits)
    w = gen.generate_partial_witness(pw, data.prover_only, data.common)
    wc.check_witness(data, w.full_witness(), hp.hash_no_pad([]))


def _circuit(stark, config, degree_bits, **multi):
    b = cb.CircuitBuilder(cconfig.CircuitConfig.standard_recursion_config())
    pt = rv.add_virtual_stark_proof_with_pis(
        b, stark, config, degree_bits, multi_degree=bool(multi)
    )
    rv.verify_stark_proof_circuit(b, stark, pt, config, degree_bits, **multi)
    return b.build(commit=False), pt


def _jcircuit(stark, config, degree_bits, **multi):
    b = JCircuitBuilder(JCircuitConfig.standard_recursion_config())
    pt = jrv.add_virtual_stark_proof_with_pis(
        b, stark, config, degree_bits, multi_degree=bool(multi)
    )
    jrv.verify_stark_proof_circuit(b, stark, pt, config, degree_bits, **multi)
    return b.build(commit=False)


# ---------------------------------------------------------------------------
# tests/test_stark_recursion.py::test_recursive_stark_verifier_constraints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def single():
    """The JAX package's 2^5-row FibonacciStark proof under
    standard_fast_config (pinned; tests/test_torch_stark.py holds the port's
    proof of the same trace to the JAX package's) and the port's circuit
    that verifies it."""
    stark = tfix.FibonacciStark(1 << DEGREE_BITS)
    config = tconfig.StarkConfig.standard_fast_config()
    pin = _golden(f"torch_stark_2^{DEGREE_BITS}.json")
    pwp = ser.stark_proof_from_int_tree(pin)
    assert ser.int_tree(pwp) == pin
    tverifier.verify_stark_proof(stark, pwp, config, DEGREE_BITS)
    return stark, config, pwp, _circuit(stark, config, DEGREE_BITS)


def test_recursive_stark_verifier_constraints(single):
    _, _, pwp, circuit = single
    _check(circuit, pwp)


def test_recursive_stark_verifier_rejects_tampered_proof(single):
    _, _, pwp, circuit = single
    bad = copy.deepcopy(pwp)
    bad.public_inputs[2] = (bad.public_inputs[2] + 1) % P
    with pytest.raises(Exception):
        _check(circuit, bad)


@pytest.fixture(scope="module")
def reference_single_shape():
    """The JAX package's circuit of the same verifier, without its
    commitment (no prove)."""
    stark = JFibonacciStark(1 << DEGREE_BITS)
    return br.circuit_shape(_jcircuit(stark, JStarkConfig.standard_fast_config(), DEGREE_BITS))


def test_recursive_stark_circuit_equals_reference(single, reference_single_shape):
    assert br.circuit_shape(single[3][0]) == reference_single_shape


@pytest.fixture(scope="module")
def lookup_single():
    """The JAX package's 2^5-row PermutationStark proof (pinned by
    tools/gen_starky_pins.py; tests/test_torch_stark_lookup.py holds the
    port's proof of the same trace to it) and the port's circuit that
    verifies it."""
    stark = tfix.PermutationStark(1 << DEGREE_BITS)
    config = tconfig.StarkConfig.standard_fast_config()
    pin = _golden(f"torch_starky_lookup_2^{DEGREE_BITS}.json")["proof"]
    pwp = ser.stark_proof_from_int_tree(pin)
    tverifier.verify_stark_proof(stark, pwp, config, DEGREE_BITS)
    return pwp, _circuit(stark, config, DEGREE_BITS)


def test_recursive_stark_verifier_refuses_lookups(lookup_single):
    """The name is historic: this is now the lookup case of
    tests/test_stark_recursion.py:45-65 (logUp lookups are ported). The
    witness of the pinned PermutationStark proof satisfies the port's
    circuit, whose shape equals the JAX package's
    (tests/golden/torch_starky_lookup_outer_2^5_shape.json); a tampered
    auxiliary opening fails it. Cross-table lookups stay outside the
    circuit, as in the JAX package, and are refused by name."""
    pwp, circuit = lookup_single
    assert br.circuit_shape(circuit[0]) == _golden(
        f"torch_starky_lookup_outer_2^{DEGREE_BITS}_shape.json"
    )
    _check(circuit, pwp)
    bad = copy.deepcopy(pwp)
    c0, c1 = bad.proof.openings.auxiliary_polys[0]
    bad.proof.openings.auxiliary_polys[0] = ((c0 + 1) % P, c1)
    with pytest.raises(Exception):
        _check(circuit, bad)
    b = cb.CircuitBuilder(cconfig.CircuitConfig.standard_recursion_config())
    with pytest.raises(NotImplementedError, match="cross-table lookups"):
        rv.add_virtual_stark_proof_with_pis(
            b, tfix.CtlLookedStark(1 << DEGREE_BITS), tconfig.StarkConfig.standard_fast_config(),
            DEGREE_BITS,
        )


# ---------------------------------------------------------------------------
# tests/test_multi_degree_recursion.py: one circuit for proofs of 2^3..2^5
# rows
# ---------------------------------------------------------------------------


def _multi_config(stark_config, fri_config, strategy):
    """tests/test_multi_degree_recursion.py:29-43: arity-2 folds with a
    small final polynomial, so degrees 3..5 need 1..3 fold steps."""
    return stark_config(
        security_bits=1,
        num_challenges=2,
        fri_config=fri_config(
            rate_bits=1,
            cap_height=1,
            proof_of_work_bits=1,
            reduction_strategy=strategy.ConstantArityBits(1, 2),
            num_query_rounds=8,
        ),
    )


@pytest.fixture(scope="module")
def unified():
    """The unified circuit built for 2^5 rows down to 2^3, and the padded
    proofs at 2^5, 2^4 and 2^3 rows (each checked by the host verifier,
    which replays the padded transcript)."""
    config = _multi_config(tconfig.StarkConfig, fconfig.FriConfig, fconfig.FriReductionStrategy)
    circuit = _circuit(
        tfix.FibonacciStark(1 << MAX_DEGREE_BITS), config, MAX_DEGREE_BITS,
        min_degree_bits_to_support=MIN_DEGREE_BITS,
    )
    params = config.fri_params(MAX_DEGREE_BITS)
    proofs = {}
    for d in range(MIN_DEGREE_BITS, MAX_DEGREE_BITS + 1):
        stark = tfix.FibonacciStark(1 << d)
        pwp = tprover.prove(
            stark, config, stark.generate_trace(0, 1), [0, 1, tfix.fibonacci_res(1 << d, 0, 1)],
            verifier_circuit_fri_params=params, device="cpu",
        )
        tverifier.verify_stark_proof(stark, pwp, config, d, verifier_circuit_fri_params=params)
        proofs[d] = pwp
    return config, circuit, proofs


@pytest.mark.parametrize("degree_bits", [5, 4, 3])
def test_padded_proof_equals_reference(unified, degree_bits):
    _, _, proofs = unified
    pin = _golden("torch_stark_multi_degree.json")[str(degree_bits)]
    assert ser.int_tree(proofs[degree_bits]) == pin


def test_padded_proof_passes_reference_verifier(unified):
    """The JAX package's host verifier replays the same padded transcript
    on the port's 2^4-row proof."""
    _, _, proofs = unified
    jconfig = _multi_config(JStarkConfig, JFriConfig, JFriReductionStrategy)
    jverify(
        JFibonacciStark(1 << 4), proofs[4], jconfig, 4,
        verifier_circuit_fri_params=jconfig.fri_params(MAX_DEGREE_BITS),
    )


def test_max_degree_proof_verifies(unified):
    _, circuit, proofs = unified
    _check(circuit, proofs[MAX_DEGREE_BITS], MAX_DEGREE_BITS)


def test_smaller_degree_proof_same_circuit(unified):
    _, circuit, proofs = unified
    _check(circuit, proofs[MAX_DEGREE_BITS - 1], MAX_DEGREE_BITS - 1)


def test_min_degree_proof_same_circuit(unified):
    _, circuit, proofs = unified
    _check(circuit, proofs[MIN_DEGREE_BITS], MIN_DEGREE_BITS)


def test_tampered_proof_fails(unified):
    _, circuit, proofs = unified
    bad = copy.deepcopy(proofs[MAX_DEGREE_BITS - 1])
    bad.public_inputs[2] = (bad.public_inputs[2] + 1) % P
    with pytest.raises(Exception):
        _check(circuit, bad, MAX_DEGREE_BITS - 1)


def test_unified_circuit_equals_reference(unified):
    jconfig = _multi_config(JStarkConfig, JFriConfig, JFriReductionStrategy)
    shape = br.circuit_shape(_jcircuit(
        JFibonacciStark(1 << MAX_DEGREE_BITS), jconfig, MAX_DEGREE_BITS,
        min_degree_bits_to_support=MIN_DEGREE_BITS,
    ))
    assert br.circuit_shape(unified[1][0]) == shape

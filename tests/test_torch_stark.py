"""The second slice of the port as a whole: the single-table STARK
(plonky2_tpu_torch.stark) on the CPU, with the kernels' plain versions,
held against the JAX package (plonky2_tpu.stark) on the same inputs: the
coset constants, the proofs field for field, and each package's verifier
on the other's proof. Tolerance: none — integer equality."""

import copy
import dataclasses

import numpy as np
import pytest

from plonky2_tpu.fri import config as jfri_config
from plonky2_tpu.fri import proof as jfri_proof
from plonky2_tpu.stark import config as jstark_config
from plonky2_tpu.stark import proof as jstark_proof
from plonky2_tpu.stark.fixtures import FibonacciStark as JFibonacciStark
from plonky2_tpu.stark.fixtures import fibonacci_res as jfibonacci_res
from plonky2_tpu.stark.prover import _stark_coset_constants as j_coset_constants
from plonky2_tpu.stark.prover import prove as jprove
from plonky2_tpu.stark.verifier import StarkVerificationError as JStarkVerificationError
from plonky2_tpu.stark.verifier import verify_stark_proof as jverify
from _torch_port import lazy_module

tconfig = lazy_module("plonky2_tpu_torch.stark.config")
tfix = lazy_module("plonky2_tpu_torch.stark.fixtures")
tprover = lazy_module("plonky2_tpu_torch.stark.prover")
tverifier = lazy_module("plonky2_tpu_torch.stark.verifier")
tgf = lazy_module("plonky2_tpu_torch.ops.gf")
fr = lazy_module("plonky2_tpu_torch.utils.from_reference")

DEGREE_BITS = 5
P = 0xFFFF_FFFF_0000_0001


def _normalize(x):
    """A proof dataclass tree as nested plain tuples (numpy arrays -> int
    tuples), so that two proofs compare exactly (tests/test_stark.py)."""
    if dataclasses.is_dataclass(x):
        return tuple(_normalize(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, np.ndarray):
        return tuple(int(v) for v in x.reshape(-1))
    if isinstance(x, (list, tuple)):
        return tuple(_normalize(v) for v in x)
    return x


def _jax_classes():
    classes = {}
    for module in (jstark_proof, jfri_proof, jstark_config, jfri_config):
        for name, obj in vars(module).items():
            if dataclasses.is_dataclass(obj) and isinstance(obj, type):
                classes[name] = obj
    return classes


def _inputs(num_rows):
    pis = [0, 1, jfibonacci_res(num_rows, 0, 1)]
    return pis, JFibonacciStark(num_rows).generate_trace(0, 1)


@pytest.fixture(scope="module")
def proofs():
    """One 2^5-row FibonacciStark proof from each package, same inputs."""
    n = 1 << DEGREE_BITS
    pis, trace = _inputs(n)
    jproof = jprove(JFibonacciStark(n), jstark_config.StarkConfig.standard_fast_config(), trace, pis)
    stark = tfix.FibonacciStark(n)
    tproof = tprover.prove(
        stark, tconfig.StarkConfig.standard_fast_config(), trace, pis, device="cpu"
    )
    return stark, tproof, jproof


def test_fixtures_equal_the_reference():
    n = 1 << 9
    np.testing.assert_array_equal(
        tfix.FibonacciStark(n).generate_trace(3, 5), JFibonacciStark(n).generate_trace(3, 5)
    )
    assert tfix.fibonacci_res(n, 3, 5) == jfibonacci_res(n, 3, 5)


def test_config_crosses_both_ways():
    tc = tconfig.StarkConfig.standard_fast_config()
    jc = jstark_config.StarkConfig.standard_fast_config()
    assert fr.from_plain(fr.to_plain(jc)) == tc
    assert fr.from_plain(fr.to_plain(tc), _jax_classes()) == jc
    assert _normalize(tc.fri_params(22)) == _normalize(jc.fri_params(22))


@pytest.mark.parametrize("degree_bits", [5, 8])
def test_coset_constants_vs_reference(degree_bits):
    """The device-computed coset tables equal the reference's host numpy
    ones: points, 1/Z_H, the two Lagrange selectors and x - g^(n-1)."""
    got = tprover.load()._stark_coset_constants(degree_bits, 1, "cpu")
    want = j_coset_constants(degree_bits, 1)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(tgf.to_u64(g), np.asarray(w, dtype=np.uint64))


def test_proofs_equal_field_for_field(proofs):
    _, tproof, jproof = proofs
    assert _normalize(tproof) == _normalize(jproof)
    # and through the plain-data form
    assert _normalize(fr.from_plain(fr.to_plain(jproof))) == _normalize(tproof)


def test_port_verifies_its_proof_and_the_reference_proof(proofs):
    stark, tproof, jproof = proofs
    config = tconfig.StarkConfig.standard_fast_config()
    tverifier.verify_stark_proof(stark, tproof, config, DEGREE_BITS)
    tverifier.verify_stark_proof(stark, fr.from_plain(fr.to_plain(jproof)), config, DEGREE_BITS)


def test_reference_verifies_the_port_proof(proofs):
    _, tproof, _ = proofs
    jproof = fr.from_plain(fr.to_plain(tproof), _jax_classes())
    jverify(JFibonacciStark(1 << DEGREE_BITS), jproof,
            jstark_config.StarkConfig.standard_fast_config(), degree_bits=DEGREE_BITS)


def test_wrong_result_rejected_by_both_verifiers(proofs):
    stark, tproof, _ = proofs
    bad = copy.deepcopy(tproof)
    bad.public_inputs[2] = (bad.public_inputs[2] + 1) % P
    with pytest.raises(tverifier.StarkVerificationError):
        tverifier.verify_stark_proof(
            stark, bad, tconfig.StarkConfig.standard_fast_config(), DEGREE_BITS
        )
    with pytest.raises(JStarkVerificationError):
        jverify(JFibonacciStark(1 << DEGREE_BITS), fr.from_plain(fr.to_plain(bad), _jax_classes()),
                jstark_config.StarkConfig.standard_fast_config(), degree_bits=DEGREE_BITS)


def test_tampered_opening_and_pow_rejected(proofs):
    stark, tproof, _ = proofs
    config = tconfig.StarkConfig.standard_fast_config()
    bad = copy.deepcopy(tproof)
    c0, c1 = bad.proof.openings.local_values[0]
    bad.proof.openings.local_values[0] = ((c0 + 1) % P, c1)
    with pytest.raises(Exception):
        tverifier.verify_stark_proof(stark, bad, config, DEGREE_BITS)
    bad = copy.deepcopy(tproof)
    bad.proof.opening_proof.pow_witness += 1
    with pytest.raises(Exception):
        tverifier.verify_stark_proof(stark, bad, config, DEGREE_BITS)


@pytest.mark.parametrize("num_rows_log", [3, 6])
def test_port_proves_and_verifies_other_sizes(num_rows_log):
    n = 1 << num_rows_log
    pis, trace = _inputs(n)
    stark = tfix.FibonacciStark(n)
    config = tconfig.StarkConfig.standard_fast_config()
    proof = tprover.prove(stark, config, trace, pis, device="cpu")
    tverifier.verify_stark_proof(stark, proof, config, num_rows_log)


def test_prove_refuses_what_is_not_ported():
    """The name is historic: lookups, cross-table lookups and zero
    knowledge are ported. What the port still refuses is what the JAX
    package refuses too: a batch STARK with lookups
    (plonky2_tpu/stark/batch_prover.py:71), zero knowledge with lookups
    (plonky2_tpu/stark/prover.py:225, in its words) — and, the port's own
    rule, device=None without a GPU."""
    import torch

    batch_prover = lazy_module("plonky2_tpu_torch.stark.batch_prover")
    n = 1 << 4
    pis, trace = _inputs(n)
    stark = tfix.FibonacciStark(n)
    config = tconfig.StarkConfig.standard_fast_config()
    perm = tfix.PermutationStark(n)
    with pytest.raises(NotImplementedError, match="lookups"):
        batch_prover.batch_prove([perm], config, [perm.generate_trace(3)], [[3]], device="cpu")
    with pytest.raises(NotImplementedError, match="zk starky with lookups lands later"):
        tprover.prove(perm, config, perm.generate_trace(3), [3], zero_knowledge=True,
                      device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tprover.prove(stark, config, trace, pis)  # device=None means the GPU

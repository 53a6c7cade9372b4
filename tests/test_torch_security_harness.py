"""Adversarial cases at the port's API (the JAX package's
tests/test_security_harness.py; reference plonky2/tests/security_harness.rs):
eight tampers of the golden fibonacci proof, each rejected by the port's
verifier, and a witness that sets one wire twice to different values,
refused. The untampered proof verifies, so each rejection is the tamper's."""

import copy
from pathlib import Path

import pytest

from _torch_port import lazy_module

tfib = lazy_module("plonky2_tpu_torch.models.fibonacci")
tverifier = lazy_module("plonky2_tpu_torch.plonk.verifier")
ser = lazy_module("plonky2_tpu_torch.utils.serialization")

GOLDEN = Path(__file__).resolve().parent / "golden"
P = (1 << 64) - (1 << 32) + 1


@pytest.fixture(scope="module")
def fib():
    data, _ = tfib.build_fibonacci(public_io=True, device="cpu")
    pwp = ser.proof_from_bytes((GOLDEN / "fibonacci_proof.bin").read_bytes(), data.common)
    tverifier.verify(pwp, data.verifier_only, data.common)
    return data, pwp


def _public_input(p):
    p.public_inputs[0] = (p.public_inputs[0] + 1) % P


def _wires_cap(p):
    p.proof.wires_cap = p.proof.wires_cap.copy()
    p.proof.wires_cap[0, 0] ^= 1


def _opening(p):
    w = list(p.proof.openings.wires)
    w[0] = ((w[0][0] + 1) % P, w[0][1])
    p.proof.openings.wires = w


def _quotient(p):
    q = list(p.proof.openings.quotient_polys)
    q[0] = ((q[0][0] + 1) % P, q[0][1])
    p.proof.openings.quotient_polys = q


def _pow_witness(p):
    p.proof.opening_proof.pow_witness = (p.proof.opening_proof.pow_witness + 1) % P


def _final_poly(p):
    fp = list(p.proof.opening_proof.final_poly)
    fp[0] = ((fp[0][0] + 1) % P, fp[0][1])
    p.proof.opening_proof.final_poly = fp


def _merkle_sibling(p):
    sibs = p.proof.opening_proof.query_round_proofs[0].initial_trees_proof.evals_proofs[1][1].siblings
    sibs[0] = tuple((x + 1) % P for x in sibs[0])


def _truncated_query_rounds(p):
    p.proof.opening_proof.query_round_proofs = p.proof.opening_proof.query_round_proofs[:-1]


TAMPERS = [_public_input, _wires_cap, _opening, _quotient, _pow_witness, _final_poly,
           _merkle_sibling, _truncated_query_rounds]


@pytest.mark.parametrize("tamper", TAMPERS, ids=lambda f: f.__name__.strip("_"))
def test_tampered_proof_rejected(fib, tamper):
    data, pwp = fib
    bad = copy.deepcopy(pwp)
    tamper(bad)
    with pytest.raises(Exception):
        tverifier.verify(bad, data.verifier_only, data.common)


def test_wire_set_twice_conflicting_raises():
    """Conflicting witness values error, never silently win
    (security_harness.rs wire-set-twice)."""
    from plonky2_tpu_torch.iop.witness import PartialWitness
    from plonky2_tpu_torch.plonk.circuit_builder import CircuitBuilder
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    from plonky2_tpu_torch.plonk.prover import prove

    b = CircuitBuilder(CircuitConfig.standard_recursion_config())
    x = b.add_virtual_target()
    y = b.add_virtual_target()
    b.connect(x, y)
    b.register_public_input(x)
    data = b.build(device="cpu")
    pw = PartialWitness()
    pw.set_target(x, 1)
    with pytest.raises(Exception):
        pw.set_target(y, 2)
        prove(data.prover_only, data.common, pw, device="cpu")

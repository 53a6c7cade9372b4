"""The example circuits of the port (models/examples.py: factorial,
range_check, square_root with its SquareRootGenerator) and its witness
checker (plonk/witness_check.py), held against the JAX package by the
bytes pinned in tests/golden/{range_check,square_root}_{proof,common}.bin
(which the JAX package re-proves, tests/test_golden_corpus.py) — no
reference prove at run time. Tolerance: none."""

import copy
from pathlib import Path

import numpy as np
import pytest

from plonky2_tpu.field.goldilocks import P
from _torch_port import lazy_module

ex = lazy_module("plonky2_tpu_torch.models.examples")
tgen = lazy_module("plonky2_tpu_torch.iop.generator")
tprover = lazy_module("plonky2_tpu_torch.plonk.prover")
tverifier = lazy_module("plonky2_tpu_torch.plonk.verifier")
wc = lazy_module("plonky2_tpu_torch.plonk.witness_check")
ser = lazy_module("plonky2_tpu_torch.utils.serialization")
thp = lazy_module("plonky2_tpu_torch.hash.poseidon")

GOLDEN = Path(__file__).resolve().parent / "golden"


def _build(name):
    if name == "range_check":
        return ex.build_range_check(device="cpu")
    return ex.build_square_root(device="cpu")[:2]


@pytest.mark.parametrize("name", ["range_check", "square_root"])
def test_example_bytes_equal_golden(name):
    data, pw = _build(name)
    assert ser.common_data_to_bytes(data.common) == (GOLDEN / f"{name}_common.bin").read_bytes()
    pwp = tprover.prove(data.prover_only, data.common, pw, device="cpu")
    tverifier.verify(pwp, data.verifier_only, data.common)
    assert ser.proof_to_bytes(pwp, data.common) == (GOLDEN / f"{name}_proof.bin").read_bytes()
    bad = copy.deepcopy(pwp)
    bad.public_inputs[0] = (bad.public_inputs[0] + 1) % P
    with pytest.raises(Exception):
        tverifier.verify(bad, data.verifier_only, data.common)


def test_factorial_verifies():
    from plonky2_tpu.field import goldilocks as jgl

    data, pw = ex.build_factorial(100, device="cpu")
    pwp = tprover.prove(data.prover_only, data.common, pw, device="cpu")
    want = 1
    for i in range(2, 101):
        want = jgl.gmul(want, i)
    assert pwp.public_inputs == [1, want]
    tverifier.verify(pwp, data.verifier_only, data.common)
    bad = copy.deepcopy(pwp)
    bad.public_inputs[1] ^= 1
    with pytest.raises(Exception):
        tverifier.verify(bad, data.verifier_only, data.common)


def test_square_root_generator_runs_in_python():
    """A user generator whose run_once branches on a value (the square
    root) stays in Python; the rest of the witness is native."""
    data, pw = _build("square_root")
    w = tgen.generate_partial_witness(pw, data.prover_only, data.common)
    stats = data.prover_only._witgen_enc.stats
    assert stats["python_gens"] == 1 and "SquareRootGenerator" in stats["fallback_types"]
    wc.check_witness(data, w.full_witness(), _pis_hash(data, w))


def _pis_hash(data, partition_witness):
    return thp.hash_no_pad(partition_witness.get_targets(data.prover_only.public_inputs))


@pytest.mark.parametrize("name", ["range_check", "square_root"])
def test_witness_check_accepts_and_rejects(name):
    """plonk/witness_check.py on the example witnesses: accepted as
    generated; a changed wire fails a gate or copy constraint."""
    data, pw = _build(name)
    pwit = tgen.generate_partial_witness(pw, data.prover_only, data.common)
    h = _pis_hash(data, pwit)
    w = pwit.full_witness()
    wc.check_witness(data, w, h)
    with pytest.raises(wc.WitnessCheckError):
        wc.check_witness(data, w, tuple((x + 1) % P for x in h))
    bad = copy.deepcopy(w)
    bad.wire_values = np.array(w.wire_values, copy=True)
    bad.wire_values[0, 0] = (int(bad.wire_values[0, 0]) + 1) % P
    with pytest.raises(wc.WitnessCheckError):
        wc.check_witness(data, bad, h)

"""Zero-knowledge STARKs in the port (stark/prover.py prove(...,
zero_knowledge=True), stark/verifier.py) on the CPU, with the kernels'
plain versions, held against the JAX package: the 2^5-row FibonacciStark
proof of tests/test_stark_zk.py under pinned salts (PLONKY2_TPU_SALT_SEED)
and a seeded mask generator equals its pin (tools/gen_starky_pins.py; the
reference's prove is not run here), and each package's verifier accepts
the other's proof. Unseeded proofs open to masked values that differ from
proof to proof; tampered proofs are rejected. Tolerance: none — integer
equality."""

import copy
import dataclasses
import json
import os

import numpy as np
import pytest

from plonky2_tpu.fri import config as jfri_config
from plonky2_tpu.fri import proof as jfri_proof
from plonky2_tpu.stark import config as jstark_config
from plonky2_tpu.stark import fixtures as jfix
from plonky2_tpu.stark import proof as jstark_proof
from plonky2_tpu.stark.verifier import verify_stark_proof as jverify
from _torch_port import lazy_module

tfix = lazy_module("plonky2_tpu_torch.stark.fixtures")
tconfig = lazy_module("plonky2_tpu_torch.stark.config")
tfri_config = lazy_module("plonky2_tpu_torch.fri.config")
tprover = lazy_module("plonky2_tpu_torch.stark.prover")
tverifier = lazy_module("plonky2_tpu_torch.stark.verifier")
fr = lazy_module("plonky2_tpu_torch.utils.from_reference")
ser = lazy_module("plonky2_tpu_torch.utils.serialization")

P = 0xFFFF_FFFF_0000_0001
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
DEGREE_BITS = 5


def _config(stark_config, fri_config):
    """tests/test_stark_zk.py:20-31."""
    return stark_config.StarkConfig(
        security_bits=1,
        num_challenges=2,
        fri_config=fri_config.FriConfig(
            rate_bits=1,
            cap_height=1,
            proof_of_work_bits=1,
            reduction_strategy=fri_config.FriReductionStrategy.ConstantArityBits(1, 2),
            num_query_rounds=8,
        ),
    )


def _jax_classes():
    classes = {}
    for module in (jstark_proof, jfri_proof, jstark_config, jfri_config):
        for name, obj in vars(module).items():
            if dataclasses.is_dataclass(obj) and isinstance(obj, type):
                classes[name] = obj
    return classes


def _prove(mask_rng=None):
    n = 1 << DEGREE_BITS
    stark = tfix.FibonacciStark(n)
    pis = [0, 1, tfix.fibonacci_res(n, 0, 1)]
    config = _config(tconfig, tfri_config)
    pwp = tprover.prove(stark, config, stark.generate_trace(0, 1), pis, zero_knowledge=True,
                        device="cpu", mask_rng=mask_rng)
    return stark, config, pwp


@pytest.fixture(scope="module")
def pinned():
    """The port's proof under the pin's salt stream and mask seed, and the
    JAX package's pinned proof."""
    with open(os.path.join(GOLDEN, f"torch_starky_zk_2^{DEGREE_BITS}.json")) as f:
        pin = json.load(f)
    saved = os.environ.get("PLONKY2_TPU_SALT_SEED")
    os.environ["PLONKY2_TPU_SALT_SEED"] = str(pin["salt_seed"])
    try:
        stark, config, pwp = _prove(np.random.default_rng(pin["mask_seed"]))
    finally:
        if saved is None:
            del os.environ["PLONKY2_TPU_SALT_SEED"]
        else:
            os.environ["PLONKY2_TPU_SALT_SEED"] = saved
    return stark, config, pwp, pin["proof"]


@pytest.fixture(scope="module")
def unseeded():
    """Two proofs of the same statement with fresh masks and salts."""
    return _prove(), _prove()


def test_zk_proof_equals_pin(pinned):
    *_, pwp, pin = pinned
    assert ser.int_tree(pwp) == pin


def test_port_verifies_pinned_reference_proof(pinned):
    stark, config, _, pin = pinned
    pwp = ser.stark_proof_from_int_tree(pin)
    tverifier.verify_stark_proof(stark, pwp, config, DEGREE_BITS, zero_knowledge=True)


def test_reference_verifies_port_proofs(pinned, unseeded):
    proofs = [pinned[2], unseeded[0][2]]
    for pwp in proofs:
        jverify(jfix.FibonacciStark(1 << DEGREE_BITS), fr.from_plain(fr.to_plain(pwp), _jax_classes()),
                _config(jstark_config, jfri_config), DEGREE_BITS, zero_knowledge=True)


def test_zk_proof_verifies_only_as_zk(unseeded):
    stark, config, pwp = unseeded[0]
    tverifier.verify_stark_proof(stark, pwp, config, DEGREE_BITS, zero_knowledge=True)
    with pytest.raises(Exception):
        tverifier.verify_stark_proof(stark, pwp, config, DEGREE_BITS)


@pytest.mark.parametrize("what", ["public_result", "opening", "quotient"])
def test_zk_tampered_rejected(unseeded, what):
    stark, config, pwp = unseeded[0]
    bad = copy.deepcopy(pwp)
    if what == "public_result":
        bad.public_inputs[2] = (bad.public_inputs[2] + 1) % P
    elif what == "opening":
        c0, c1 = bad.proof.openings.local_values[0]
        bad.proof.openings.local_values[0] = ((c0 + 1) % P, c1)
    else:
        c0, c1 = bad.proof.openings.quotient_polys[-1]
        bad.proof.openings.quotient_polys[-1] = (c0, (c1 + 1) % P)
    with pytest.raises(Exception):
        tverifier.verify_stark_proof(stark, bad, config, DEGREE_BITS, zero_knowledge=True)


def test_zk_openings_are_masked(unseeded):
    """Two proofs of the same statement open to different values, and
    their query leaves differ (masked and salted), as
    tests/test_stark_zk.py::test_zk_openings_are_masked."""
    (_, _, p1), (_, _, p2) = unseeded
    assert p1.proof.openings.local_values != p2.proof.openings.local_values
    l1 = p1.proof.opening_proof.query_round_proofs[0].initial_trees_proof.evals_proofs[0][0]
    l2 = p2.proof.opening_proof.query_round_proofs[0].initial_trees_proof.evals_proofs[0][0]
    assert l1 != l2


def test_zk_leaf_holds_split_halves_and_salt(unseeded):
    """The trace oracle's leaf: 2C split halves + 4 salt words."""
    stark, config, pwp = unseeded[0]
    leaf = pwp.proof.opening_proof.query_round_proofs[0].initial_trees_proof.evals_proofs[0][0]
    assert len(leaf) == 2 * stark.num_columns() + 4
    nq = stark.num_quotient_polys(config) + config.num_challenges
    assert len(pwp.proof.openings.quotient_polys) == nq


def test_zk_with_lookups_refused():
    """Refused in the JAX package's words."""
    stark = tfix.PermutationStark(1 << DEGREE_BITS)
    with pytest.raises(NotImplementedError, match="zk starky with lookups lands later"):
        tprover.prove(stark, _config(tconfig, tfri_config), stark.generate_trace(3), [3],
                      zero_knowledge=True, device="cpu")

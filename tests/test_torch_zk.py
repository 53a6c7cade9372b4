"""Zero knowledge in the port: blinding rows (circuit_builder.blind) and
salted oracles (fri/oracle.py: SALT_SIZE random leaf columns drawn on the
host from PLONKY2_TPU_SALT_SEED's numpy stream, as the JAX package draws
them), held against the JAX package (mirror of tests/test_zk.py:16-47).

Blinding rows draw fresh secrets, so only a run with both streams fixed
can be compared: PLONKY2_TPU_SALT_SEED set and the RandomValueGenerators of
both packages fed from iop.generator.fixed_random_values (a value a target,
whatever the generators' order). The reference's bytes for that run are
pinned in tests/golden/torch_zk_{proof,common}.bin
(tools/gen_gate_mix_pins.py). Tolerance: none."""

from pathlib import Path

import numpy as np
import pytest

from _torch_port import lazy_module

tbuilder = lazy_module("plonky2_tpu_torch.plonk.circuit_builder")
tconfig = lazy_module("plonky2_tpu_torch.plonk.config")
tfri = lazy_module("plonky2_tpu_torch.fri.config")
twitness = lazy_module("plonky2_tpu_torch.iop.witness")
tgen = lazy_module("plonky2_tpu_torch.iop.generator")
tprover = lazy_module("plonky2_tpu_torch.plonk.prover")
tverifier = lazy_module("plonky2_tpu_torch.plonk.verifier")
ser = lazy_module("plonky2_tpu_torch.utils.serialization")

GOLDEN = Path(__file__).resolve().parent / "golden"
SALT_SEED = 1234  # tools/gen_gate_mix_pins.py SALT_SEED
BLINDING_SEED = 5678  # tools/gen_gate_mix_pins.py BLINDING_SEED


def _build():
    """tests/test_zk.py's circuit (20 additions) and config, cut to one
    query round: its blinding rows then fit degree 2^8 (8 rounds need 2^12,
    minutes a proof on the CPU)."""
    config = tconfig.CircuitConfig(
        zero_knowledge=True,
        security_bits=4,
        fri_config=tfri.FriConfig(
            rate_bits=3,
            cap_height=2,
            proof_of_work_bits=1,
            reduction_strategy=tfri.FriReductionStrategy.ConstantArityBits(4, 5),
            num_query_rounds=1,
        ),
    )
    b = tbuilder.CircuitBuilder(config)
    x0 = b.add_virtual_target()
    x1 = b.add_virtual_target()
    b.register_public_input(x0)
    b.register_public_input(x1)
    cur, nxt = x0, x1
    for _ in range(20):
        cur, nxt = nxt, b.add(cur, nxt)
    b.register_public_input(nxt)
    data = b.build(device="cpu")
    pw = twitness.PartialWitness()
    pw.set_target(x0, 0)
    pw.set_target(x1, 1)
    return data, pw


@pytest.fixture(scope="module")
def circuit():
    return _build()


def test_zk_fixed_streams_equal_reference_golden(circuit, monkeypatch):
    data, pw = circuit
    assert data.common.fri_params.leaf_hiding
    assert ser.common_data_to_bytes(data.common) == (GOLDEN / "torch_zk_common.bin").read_bytes()
    monkeypatch.setenv("PLONKY2_TPU_SALT_SEED", str(SALT_SEED))
    with tgen.fixed_random_values(BLINDING_SEED):
        pwp = tprover.prove(data.prover_only, data.common, pw, device="cpu")
    tverifier.verify(pwp, data.verifier_only, data.common)
    assert ser.proof_to_bytes(pwp, data.common) == (GOLDEN / "torch_zk_proof.bin").read_bytes()


def test_zk_proof_verifies_and_hides(circuit, monkeypatch):
    """Without the fixed streams two proofs of the same witness verify and
    differ in every cap (tests/test_zk.py::test_zk_proof_verifies_and_hides),
    and differ from the pinned proof too."""
    data, pw = circuit
    monkeypatch.delenv("PLONKY2_TPU_SALT_SEED", raising=False)
    p1 = tprover.prove(data.prover_only, data.common, pw, device="cpu")
    p2 = tprover.prove(data.prover_only, data.common, pw, device="cpu", device_transcript=False)
    pinned = ser.proof_from_bytes((GOLDEN / "torch_zk_proof.bin").read_bytes(), data.common)
    for p in (p1, p2, pinned):
        tverifier.verify(p, data.verifier_only, data.common)
        assert p.public_inputs == p1.public_inputs
    for cap in ("wires_cap", "plonk_zs_partial_products_cap", "quotient_polys_cap"):
        assert not np.array_equal(getattr(p1.proof, cap), getattr(p2.proof, cap)), cap
        assert not np.array_equal(getattr(p1.proof, cap), getattr(pinned.proof, cap)), cap


def test_zk_golden_rejects_tampered_salt(circuit):
    """A changed salt word of an opened leaf breaks its Merkle path."""
    import copy

    data, _ = circuit
    pinned = ser.proof_from_bytes((GOLDEN / "torch_zk_proof.bin").read_bytes(), data.common)
    bad = copy.deepcopy(pinned)
    leaf = bad.proof.opening_proof.query_round_proofs[0].initial_trees_proof.evals_proofs[1][0]
    leaf[-1] = (int(leaf[-1]) + 1) % ((1 << 64) - (1 << 32) + 1)
    with pytest.raises(Exception):
        tverifier.verify(bad, data.verifier_only, data.common)

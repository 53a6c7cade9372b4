"""The slice as a whole: the gate-mix circuit (models/gate_mix.py — every
gate of the port but the Poseidon2 family, which tests/test_torch_poseidon2.py
and test_torch_generic_config.py hold; four lookups a block, a range
check, ReducingGate and ReducingExtensionGate) at degree 2^8, built by the
same function for both packages, proven by the port on the CPU (plain
versions of the kernels, native witness engine) and held to the JAX
package's bytes pinned in tests/golden/torch_gate_mix_2^8_{proof,common}.bin
by tools/gen_gate_mix_pins.py. Tolerance: none."""

import copy
from pathlib import Path

import pytest

from plonky2_tpu.field.goldilocks import P
from _torch_port import lazy_module

gm = lazy_module("plonky2_tpu_torch.models.gate_mix")
tgen = lazy_module("plonky2_tpu_torch.iop.generator")
tprover = lazy_module("plonky2_tpu_torch.plonk.prover")
tverifier = lazy_module("plonky2_tpu_torch.plonk.verifier")
thp = lazy_module("plonky2_tpu_torch.hash.poseidon")
wc = lazy_module("plonky2_tpu_torch.plonk.witness_check")
ser = lazy_module("plonky2_tpu_torch.utils.serialization")

GOLDEN = Path(__file__).resolve().parent / "golden"
LOG2 = 8
GATES = {
    "ArithmeticGate", "ArithmeticExtensionGate", "BaseSumGate", "ConstantGate",
    "CosetInterpolationGate", "ExponentiationGate", "LookupGate", "LookupTableGate",
    "NoopGate", "PoseidonGate", "PublicInputGate", "RandomAccessGate",
    "ReducingExtensionGate", "ReducingGate",
}


@pytest.fixture(scope="module")
def built():
    return gm.build_gate_mix(LOG2, device="cpu")


def test_gate_mix_places_every_gate(built):
    data, _ = built
    assert data.common.degree_bits == LOG2
    assert set(gm.gate_counts(data)) == GATES
    assert data.common.num_lookup_polys > 0


def test_gate_mix_common_data_equals_reference_golden(built):
    data, _ = built
    want = (GOLDEN / f"torch_gate_mix_2^{LOG2}_common.bin").read_bytes()
    assert ser.common_data_to_bytes(data.common) == want


def test_gate_mix_proof_equals_reference_golden(built):
    """The device transcript (the default) on CPU tensors, the witness in
    the native engine with no generator left to Python: the proof equals
    the reference's bytes, the reference's verifier accepts it, and the
    port's rejects it tampered (a public input, a wire opening, a lookup
    opening). One test, so that the proof is made once a run."""
    from plonky2_tpu.plonk import verifier as jverifier
    from plonky2_tpu.utils import serialization as jser

    data, pw = built
    pwp = tprover.prove(data.prover_only, data.common, pw, device="cpu")
    assert data.prover_only._witgen_enc.stats["python_gens"] == 0
    tverifier.verify(pwp, data.verifier_only, data.common)
    want = (GOLDEN / f"torch_gate_mix_2^{LOG2}_proof.bin").read_bytes()
    assert ser.proof_to_bytes(pwp, data.common) == want

    j_verifier_only, j_common = jser.verifier_data_from_bytes(
        ser.verifier_data_to_bytes(data.verifier_only, data.common)
    )
    jverifier.verify(jser.proof_from_bytes(want, j_common), j_verifier_only, j_common)

    for part in ("public_input", "wire_opening", "lookup_opening"):
        bad = copy.deepcopy(pwp)
        if part == "public_input":
            bad.public_inputs[0] = (bad.public_inputs[0] + 1) % P
        elif part == "wire_opening":
            c0, c1 = bad.proof.openings.wires[5]
            bad.proof.openings.wires[5] = (c0, (c1 + 1) % P)
        else:
            z0, z1 = bad.proof.openings.lookup_zs[1]
            bad.proof.openings.lookup_zs[1] = ((z0 + 1) % P, z1)
        with pytest.raises(Exception):
            tverifier.verify(bad, data.verifier_only, data.common)


def test_gate_mix_witness_satisfies_every_constraint(built):
    """plonk/witness_check.py over every row of every gate type."""
    data, pw = built
    pwit = tgen.generate_partial_witness(pw, data.prover_only, data.common)
    tprover.set_lookup_wires(data.prover_only, data.common, pwit)
    pis = thp.hash_no_pad(pwit.get_targets(data.prover_only.public_inputs))
    wc.check_witness(data, pwit.full_witness(), pis)

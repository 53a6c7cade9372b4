"""Lookup arguments in the port (plonk/prover.py set_lookup_wires, the
lookup polynomials and their suffix sum, plonk/quotient_kernel.py's lookup
terms, the device transcript's lookup challenges), held against the JAX
package.

The circuit is that of tests/test_lookups.py:16-31 (inputs [0, 3, 3, 7,
1]). The reference's own prove of it does not end inside the tier-1 clock,
so its bytes are pinned once in tests/golden/torch_lookup_{proof,common}.bin
(tools/gen_gate_mix_pins.py) and the port's proofs, by both transcripts, are
held to them. The lookup polynomials are held to the reference's host
compute_all_lookup_polys on the same witness. Tolerance: none."""

import copy
from pathlib import Path

import numpy as np
import pytest

from plonky2_tpu.field.goldilocks import P
from _torch_port import lazy_module

tbuilder = lazy_module("plonky2_tpu_torch.plonk.circuit_builder")
tconfig = lazy_module("plonky2_tpu_torch.plonk.config")
twitness = lazy_module("plonky2_tpu_torch.iop.witness")
tgen = lazy_module("plonky2_tpu_torch.iop.generator")
tprover = lazy_module("plonky2_tpu_torch.plonk.prover")
tverifier = lazy_module("plonky2_tpu_torch.plonk.verifier")
tvan = lazy_module("plonky2_tpu_torch.plonk.vanishing")
ser = lazy_module("plonky2_tpu_torch.utils.serialization")
gf = lazy_module("plonky2_tpu_torch.ops.gf")

GOLDEN = Path(__file__).resolve().parent / "golden"
TABLE = [2, 24, 56, 100, 128, 16, 20, 49]
INPUTS = [0, 3, 3, 7, 1]


def _build(builder_cls, config_cls, pw_cls, **build_kw):
    b = builder_cls(config_cls.standard_recursion_config())
    lut_index = b.add_lookup_table_from_table(list(range(len(TABLE))), TABLE)
    in_ts, out_ts = [], []
    for _ in INPUTS:
        t = b.add_virtual_target()
        in_ts.append(t)
        out_ts.append(b.add_lookup_from_index(t, lut_index))
    b.register_public_inputs(in_ts)
    b.register_public_inputs(out_ts)
    data = b.build(**build_kw)
    pw = pw_cls()
    for t, v in zip(in_ts, INPUTS):
        pw.set_target(t, v)
    return data, pw


@pytest.fixture(scope="module")
def circuit():
    return _build(tbuilder.CircuitBuilder, tconfig.CircuitConfig, twitness.PartialWitness,
                  device="cpu")


@pytest.fixture(scope="module")
def witness(circuit):
    """The port's full witness after set_lookup_wires."""
    data, pw = circuit
    pwit = tgen.generate_partial_witness(pw, data.prover_only, data.common)
    tprover.set_lookup_wires(data.prover_only, data.common, pwit)
    return pwit.full_witness()


@pytest.mark.parametrize("device_transcript", [True, False], ids=["device", "host"])
def test_lookup_proof_equals_reference_golden(circuit, device_transcript):
    data, pw = circuit
    pwp = tprover.prove(data.prover_only, data.common, pw, device="cpu",
                        device_transcript=device_transcript)
    assert pwp.public_inputs == INPUTS + [TABLE[i] for i in INPUTS]
    assert ser.proof_to_bytes(pwp, data.common) == (GOLDEN / "torch_lookup_proof.bin").read_bytes()


def test_lookup_common_data_equals_reference_golden(circuit):
    data, _ = circuit
    assert data.common.num_lookup_polys > 0
    assert ser.common_data_to_bytes(data.common) == (GOLDEN / "torch_lookup_common.bin").read_bytes()


def test_golden_verifies_and_rejects_tampered_output(circuit):
    """tests/test_lookups.py::test_lookup_rejects_tampered_output on the
    pinned proof: the port's verifier (its lookup terms at zeta) accepts it
    and rejects a changed output and a changed lookup opening."""
    data, _ = circuit
    pwp = ser.proof_from_bytes((GOLDEN / "torch_lookup_proof.bin").read_bytes(), data.common)
    tverifier.verify(pwp, data.verifier_only, data.common)
    bad = copy.deepcopy(pwp)
    bad.public_inputs[-1] = (bad.public_inputs[-1] + 1) % P
    with pytest.raises(Exception):
        tverifier.verify(bad, data.verifier_only, data.common)
    bad = copy.deepcopy(pwp)
    z0, z1 = bad.proof.openings.lookup_zs_next[0]
    bad.proof.openings.lookup_zs_next[0] = ((z0 + 1) % P, z1)
    with pytest.raises(Exception):
        tverifier.verify(bad, data.verifier_only, data.common)


def test_set_lookup_wires_equals_reference(witness):
    """Multiplicities, the padded last LookupGate and the table rows: the
    port's full witness equals the reference's on the same circuit."""
    from plonky2_tpu.iop.generator import generate_partial_witness as jgen
    from plonky2_tpu.iop.witness import PartialWitness as JPW
    from plonky2_tpu.plonk import prover as jprover
    from plonky2_tpu.plonk.circuit_builder import CircuitBuilder as JCB
    from plonky2_tpu.plonk.config import CircuitConfig as JCC

    jdata, jpw = _build(JCB, JCC, JPW, commit=False)
    jw = jgen(jpw, jdata.prover_only, jdata.common)
    jprover.set_lookup_wires(jdata.prover_only, jdata.common, jw)
    assert np.array_equal(witness.wire_values, jw.full_witness().wire_values)


def _deltas(common, seed=9):
    rng = np.random.default_rng(seed)
    return rng.integers(0, P, size=4 * common.config.num_challenges, dtype=np.uint64)


def test_lookup_polys_equal_reference_host(circuit, witness):
    """The device lookup polynomials (RE and partial-SLDC columns) on CPU
    tensors against the reference's host compute_all_lookup_polys on the
    same witness and challenges."""
    from plonky2_tpu.plonk import prover as jprover

    data, _ = circuit
    deltas = _deltas(data.common)
    want = jprover.compute_all_lookup_polys(
        witness, [int(d) for d in deltas], data.prover_only, data.common
    )
    assert want.shape == (data.common.config.num_challenges * data.common.num_lookup_polys,
                          data.common.degree)
    got = tprover.load()._lookup_polys_device(
        gf.from_u64(witness.wire_values, "cpu"), gf.from_u64(deltas, "cpu"),
        data.prover_only, data.common,
    )
    assert np.array_equal(gf.to_u64(got), want)


def test_lut_evals_device_equal_host(circuit):
    """The LUT polynomial at ChallengeDelta: the device weighted sum against
    the host Horner of both packages."""
    from plonky2_tpu.plonk import vanishing as jvan

    data, _ = circuit
    common = data.common
    deltas = _deltas(common, seed=4)
    got = gf.to_u64(tprover.load()._lut_evals_device(gf.from_u64(deltas, "cpu"), common))
    slots = common.config.num_routed_wires // 3
    for i in range(common.config.num_challenges):
        d4 = [int(d) for d in deltas[4 * i : 4 * i + 4]]
        for li, lut in enumerate(common.luts):
            deg = slots * (-(-len(lut) // slots))
            want = tvan.get_lut_poly_eval(common, li, d4[1], d4[3], deg)
            assert int(got[i, li]) == want == jvan.get_lut_poly_eval(common, li, d4[1], d4[3], deg)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 17, 65])
def test_suffix_sum_mod_p(n):
    """The log-doubling suffix sum mod p (no int64 cumsum, which wraps)
    against a Python suffix sum, at lengths 1, 2, 3 and powers of two
    plus one, on values near p."""
    rng = np.random.default_rng(n)
    x = rng.integers(P - 1000, P, size=n, dtype=np.uint64)
    x[::2] = rng.integers(0, P, size=len(x[::2]), dtype=np.uint64)
    want = [sum(int(v) for v in x[i:]) % P for i in range(n)]
    got = gf.to_u64(tprover.load()._suffix_sum(gf.from_u64(x, "cpu")))
    assert [int(v) for v in got] == want

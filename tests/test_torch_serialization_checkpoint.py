"""Circuit checkpoints of the port (utils/serialization.circuit_data_to_bytes
and _from_bytes, utils/generator_serialization.py): the bytes of the
fibonacci circuit and of the gate mix at degree 2^8 equal the JAX package's
(tests/golden/torch_{fibonacci,gate_mix_2^8}_circuit.bin, written by
tools/gen_aux_pins.py); a checkpoint loads back to the same bytes with its
generators in order; the reloaded fibonacci circuit proves to
tests/golden/fibonacci_proof.bin; a Poseidon2 circuit round-trips under
its hasher and is refused under Poseidon's; truncated or padded input is
refused. Exact byte equality throughout."""

from pathlib import Path

import pytest

from _torch_port import lazy_module

tfib = lazy_module("plonky2_tpu_torch.models.fibonacci")
tgm = lazy_module("plonky2_tpu_torch.models.gate_mix")
tprover = lazy_module("plonky2_tpu_torch.plonk.prover")
ser = lazy_module("plonky2_tpu_torch.utils.serialization")
gser = lazy_module("plonky2_tpu_torch.utils.generator_serialization")

GOLDEN = Path(__file__).resolve().parent / "golden"


@pytest.fixture(scope="module")
def fib():
    data, pw = tfib.build_fibonacci(public_io=True, device="cpu")
    return data, pw, ser.circuit_data_to_bytes(data)


@pytest.fixture(scope="module")
def gate_mix():
    data, _ = tgm.build_gate_mix(8, device="cpu")
    return data


def test_fibonacci_checkpoint_equals_reference(fib):
    assert fib[2] == (GOLDEN / "torch_fibonacci_circuit.bin").read_bytes()


def test_gate_mix_checkpoint_equals_reference(gate_mix):
    assert ser.circuit_data_to_bytes(gate_mix) == (
        GOLDEN / "torch_gate_mix_2^8_circuit.bin").read_bytes()


def test_round_trip_keeps_bytes_and_generators(fib):
    data, _, blob = fib
    back = ser.circuit_data_from_bytes(blob, device="cpu")
    assert ser.circuit_data_to_bytes(back) == blob
    names = [type(g).__name__ for g in data.prover_only.generators]
    assert [type(g).__name__ for g in back.prover_only.generators] == names
    assert (back.prover_only.constants_sigmas_commitment.cap_u64()
            == data.prover_only.constants_sigmas_commitment.cap_u64()).all()


def test_gate_mix_generators_round_trip(gate_mix):
    """Every generator of the gate mix (15 types) through the generator
    serializer: the same tag, the same payload bytes, the same fields."""
    gs = gser.DefaultGeneratorSerializer()
    common = gate_mix.common
    for gen in gate_mix.prover_only.generators:
        buf = ser.Buffer()
        gs.write_generator(buf, gen, common)
        back = gs.read_generator(ser.Buffer(buf.bytes()), common)
        assert type(back) is type(gen) and back == gen
        again = ser.Buffer()
        gs.write_generator(again, back, common)
        assert again.bytes() == buf.bytes()


def test_generator_tags_are_the_reference_order():
    from plonky2_tpu.utils import generator_serialization as ref

    assert [c.__name__ for c in gser.load()._registry()] == [c.__name__ for c in ref._registry()]


def test_reloaded_circuit_proves_golden_bytes(fib):
    _, pw, blob = fib
    data = ser.circuit_data_from_bytes(blob, device="cpu")
    pwp = tprover.prove(data.prover_only, data.common, pw, device="cpu",
                        device_transcript=False)
    assert ser.proof_to_bytes(pwp, data.common) == (GOLDEN / "fibonacci_proof.bin").read_bytes()


@pytest.mark.parametrize("cut", [1, 8, 1000, "pad"])
def test_malformed_checkpoint_refused(fib, cut):
    blob = fib[2]
    bad = blob + b"\x00" if cut == "pad" else blob[:-cut]
    with pytest.raises(ser.SerializationError):
        ser.circuit_data_from_bytes(bad, device="cpu")


def test_poseidon2_circuit_round_trips_under_its_hasher():
    """The bytes do not name the hasher: loaded with its own, a Poseidon2
    circuit gives the same bytes, cap and proof; loaded with Poseidon's,
    its rebuilt constants/sigmas cap differs from the verifier data's and
    the load is refused."""
    from plonky2_tpu_torch.models.hasher_fib import build_fib
    from plonky2_tpu_torch.plonk import generic_config as tgc

    gc = tgc.poseidon2_goldilocks_config()
    data, pw = build_fib(gc, device="cpu")
    blob = ser.circuit_data_to_bytes(data)
    back = ser.circuit_data_from_bytes(blob, device="cpu", hasher=gc.hasher)
    assert ser.circuit_data_to_bytes(back) == blob
    assert (back.prover_only.constants_sigmas_commitment.cap_u64()
            == data.verifier_only.constants_sigmas_cap).all()
    want = tprover.prove(data.prover_only, data.common, pw, gc=gc, device="cpu")
    got = tprover.prove(back.prover_only, back.common, pw, gc=gc, device="cpu")
    assert ser.proof_to_bytes(got, back.common) == ser.proof_to_bytes(want, data.common)
    with pytest.raises(ser.SerializationError, match="constants/sigmas cap"):
        ser.circuit_data_from_bytes(blob, device="cpu")

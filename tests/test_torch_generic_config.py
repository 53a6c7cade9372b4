"""The port's hasher bundles (plonk/generic_config.py) held against the JAX
package (mirror of tests/test_generic_config.py).

The circuit of tests/test_generic_config.py::_build (fib(11) under its
_small_config; models/hasher_fib.py), built and proven by the port on the CPU under
``keccak_goldilocks_config`` and ``poseidon2_goldilocks_config``: the proof
and the common data equal the JAX package's bytes, pinned in
tests/golden/torch_{keccak,poseidon2}_fib_{proof,common}.bin by
tools/gen_hasher_pins.py (the reference's own prove of that circuit does
not end inside the test suite's clock under the Poseidon2 config). Each
proof verifies, by the port and by the JAX package, and is rejected under
``poseidon_goldilocks_config``. Tolerance: none.
"""

import copy
from pathlib import Path

import numpy as np
import pytest

from plonky2_tpu.field.goldilocks import P
from plonky2_tpu.plonk import generic_config as jgc
from _torch_port import lazy_module

tgc = lazy_module("plonky2_tpu_torch.plonk.generic_config")
tprover = lazy_module("plonky2_tpu_torch.plonk.prover")
tverifier = lazy_module("plonky2_tpu_torch.plonk.verifier")
ser = lazy_module("plonky2_tpu_torch.utils.serialization")
fr = lazy_module("plonky2_tpu_torch.utils.from_reference")

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden"
CONFIGS = {"keccak": "keccak_goldilocks_config", "poseidon2": "poseidon2_goldilocks_config"}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def fib(request):
    from plonky2_tpu_torch.models.hasher_fib import build_fib

    gc = getattr(tgc, CONFIGS[request.param])()
    data, pw = build_fib(gc, device="cpu")
    pwp = tprover.prove(data.prover_only, data.common, pw, gc=gc, device="cpu")
    return request.param, gc, data, pwp


def _golden(name: str, part: str) -> bytes:
    return (GOLDEN / f"torch_{name}_fib_{part}.bin").read_bytes()


def test_proof_equals_golden(fib):
    name, _, data, pwp = fib
    assert pwp.public_inputs == [0, 1, 89]  # fib(11)
    assert ser.proof_to_bytes(pwp, data.common) == _golden(name, "proof")


def test_common_data_equals_golden(fib):
    name, _, data, _ = fib
    assert ser.common_data_to_bytes(data.common) == _golden(name, "common")


def test_port_verifies(fib):
    _, gc, data, pwp = fib
    tverifier.verify(pwp, data.verifier_only, data.common, gc=gc)


def test_reference_verifies_port_proof(fib):
    from plonky2_tpu.plonk.verifier import verify
    from plonky2_tpu.utils import serialization as jser

    name, _, data, pwp = fib
    jcommon = jser.common_data_from_bytes(ser.common_data_to_bytes(data.common))
    jpwp = jser.proof_from_bytes(ser.proof_to_bytes(pwp, data.common), jcommon)
    jvd = copy.copy(data.verifier_only)
    verify(jpwp, jvd, jcommon, gc=getattr(jgc, CONFIGS[name])())


def test_rejected_under_poseidon_config(fib):
    """The wrong config: the transcript diverges."""
    _, _, data, pwp = fib
    with pytest.raises(Exception):
        tverifier.verify(pwp, data.verifier_only, data.common, gc=tgc.poseidon_goldilocks_config())


def test_tampered_opening_rejected(fib):
    _, gc, data, pwp = fib
    bad = copy.deepcopy(pwp)
    c0, c1 = bad.proof.openings.wires[0]
    bad.proof.openings.wires[0] = ((c0 + 1) % P, c1)
    with pytest.raises(Exception):
        tverifier.verify(bad, data.verifier_only, data.common, gc=gc)


def test_proof_round_trips_bytes(fib):
    _, gc, data, pwp = fib
    blob = ser.proof_to_bytes(pwp, data.common)
    back = ser.proof_from_bytes(blob, data.common)
    assert ser.proof_to_bytes(back, data.common) == blob
    tverifier.verify(back, data.verifier_only, data.common, gc=gc)


def test_device_transcript_refused(fib):
    """Both bundles prove on the host transcript, as in the JAX package
    (plonk/device_transcript.eligible takes Poseidon only)."""
    from plonky2_tpu_torch.plonk import device_transcript as dt

    _, gc, data, _ = fib
    assert not dt.eligible(data.common, gc)
    assert dt.eligible(data.common, tgc.poseidon_goldilocks_config())


@pytest.mark.parametrize("seed", range(3))
def test_keccak_digest_felts_bijection(seed):
    b = bytes(np.random.default_rng(seed).integers(0, 256, size=25, dtype=np.uint8))
    felts = tgc.keccak_digest_to_felts(b)
    assert felts == jgc.keccak_digest_to_felts(b)
    assert all(0 <= x < P for x in felts)
    assert tgc.keccak_felts_to_digest(felts) == b == jgc.keccak_felts_to_digest(felts)


def test_keccak_digest_felts_bijection_reference_vector():
    """tests/test_generic_config.py::test_keccak_digest_felts_bijection."""
    b = bytes(range(25))
    assert tgc.keccak_felts_to_digest(tgc.keccak_digest_to_felts(b)) == b


@pytest.mark.parametrize("name", ["poseidon_goldilocks_config", "poseidon2_goldilocks_config",
                                  "keccak_goldilocks_config"])
def test_bundles_equal_reference(name):
    """Names, hasher names and the host hashes of each bundle."""
    ours, theirs = getattr(tgc, name)(), getattr(jgc, name)()
    assert ours.name == theirs.name
    xs = [int(x) for x in np.random.default_rng(7).integers(0, P, size=11, dtype=np.uint64)]
    for side in ("hasher", "inner_hasher"):
        a, b = getattr(ours, side), getattr(theirs, side)
        assert (a.name, a.algebraic, a.device_merkle) == (b.name, b.algebraic, b.device_merkle)
        assert a.hash_no_pad(xs) == b.hash_no_pad(xs)
        assert a.hash_pad(xs) == b.hash_pad(xs)
        assert a.hash_leaf(xs) == b.hash_leaf(xs)
        left, right = b.hash_no_pad(xs), b.hash_leaf(xs)  # digests (Keccak's limbs < 2^56)
        assert a.two_to_one(left, right) == b.two_to_one(left, right)
        assert a.permutation(xs[:12] + [5]) == b.permutation(xs[:12] + [5])


@pytest.mark.parametrize("name", ["poseidon_goldilocks_config", "poseidon2_goldilocks_config",
                                  "keccak_goldilocks_config"])
def test_from_plain_maps_bundle_by_name(name):
    assert fr.from_plain(fr.to_plain(getattr(jgc, name)())) is getattr(tgc, name)()


def test_from_plain_carries_poseidon2_gates_and_generators():
    from plonky2_tpu.gates import poseidon2 as jgates
    from plonky2_tpu_torch.gates import poseidon2 as tgates

    objs = [jgates.Poseidon2Gate(), jgates.Poseidon2MdsGate(), jgates.Poseidon2IntMixGate(),
            jgates.Poseidon2Generator(3), jgates.Poseidon2MdsGenerator(jgates.Poseidon2IntMixGate, 5)]
    got = fr.from_plain(fr.to_plain(objs))
    assert [type(o) for o in got] == [tgates.Poseidon2Gate, tgates.Poseidon2MdsGate,
                                      tgates.Poseidon2IntMixGate, tgates.Poseidon2Generator,
                                      tgates.Poseidon2MdsGenerator]
    assert got[3].row == 3 and got[4].row == 5
    assert got[4].gate_cls is tgates.Poseidon2IntMixGate


def test_fused_fri_refused_for_poseidon2():
    """The fused FRI proof is Poseidon's alone: a Poseidon2 proof over
    device trees takes the unfused form."""
    import torch

    from plonky2_tpu_torch.fri import prover as fp

    x = torch.zeros((8, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="Poseidon hasher"):
        fp.fri_proof([], x, x, None, None, hasher=tgc.poseidon2_goldilocks_config().hasher,
                     fused=True)

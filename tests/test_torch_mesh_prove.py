"""Proving under the port's prover mesh (plonky2_tpu_torch/parallel/; the
JAX package's tests/test_mesh_prove.py) with 8 virtual shards on the CPU:
every arithmetic step is exact and the transcript of a circuit without
blinding is fixed, so a proof under any mesh is the single-device proof
byte for byte. Every proof here goes through the poly-sharded IFFT and
LDE with their all-to-all, the row-sharded Merkle subtrees of every
commitment and FRI round, the row-split PoW permutations (a chunk of 2^17
candidates is 2^14 a shard), the point-sharded quotient with its border
columns and the six-step coset IFFT; the host-transcript fibonacci proof
also splits every permutation batch whatever its size
(_MESH_MIN_ROWS = 1). The JAX
package's mesh tests are not run here (their XLA:CPU compiles do not end
inside the tier-1 clock): the fibonacci and lookup proofs are held to
tests/golden/, the JAX package's bytes."""

from pathlib import Path

import pytest

from _torch_port import lazy_module

pctx = lazy_module("plonky2_tpu_torch.parallel.context")
dp = lazy_module("plonky2_tpu_torch.ops.poseidon")
tfib = lazy_module("plonky2_tpu_torch.models.fibonacci")
texamples = lazy_module("plonky2_tpu_torch.models.examples")
tprover = lazy_module("plonky2_tpu_torch.plonk.prover")
tverifier = lazy_module("plonky2_tpu_torch.plonk.verifier")
ser = lazy_module("plonky2_tpu_torch.utils.serialization")
tbuilder = lazy_module("plonky2_tpu_torch.plonk.circuit_builder")
tconfig = lazy_module("plonky2_tpu_torch.plonk.config")
twitness = lazy_module("plonky2_tpu_torch.iop.witness")

GOLDEN = Path(__file__).resolve().parent / "golden"


@pytest.fixture(scope="module")
def fib():
    return tfib.build_fibonacci(public_io=True, device="cpu")


def _prove_bytes(data, pw, mesh=None, device_transcript=False):
    if mesh is None:
        pwp = tprover.prove(data.prover_only, data.common, pw, device="cpu",
                            device_transcript=device_transcript)
    else:
        with pctx.prover_mesh(mesh):
            pwp = tprover.prove(data.prover_only, data.common, pw, device="cpu",
                                device_transcript=device_transcript)
    tverifier.verify(pwp, data.verifier_only, data.common)
    return ser.proof_to_bytes(pwp, data.common)


@pytest.mark.parametrize("device_transcript", [False, True], ids=["host", "device"])
def test_fibonacci_mesh_prove_equals_golden(fib, monkeypatch, device_transcript):
    """The mirror of test_mesh_prove.py's fibonacci case and of
    test_mesh_device_transcript_fused_fri_bit_identical: both transcripts
    (the device one with the fused FRI) under the mesh."""
    if not device_transcript:
        monkeypatch.setattr(dp.load(), "_MESH_MIN_ROWS", 1)
    data, pw = fib
    mesh = pctx.make_prover_mesh(8, virtual_on="cpu")
    got = _prove_bytes(data, pw, mesh, device_transcript)
    assert got == (GOLDEN / "fibonacci_proof.bin").read_bytes()


def test_mesh_prove_arithmetic_circuit():
    """A circuit with arithmetic content, so that the point-sharded
    quotient evaluates live constraints: the mesh proof equals the
    single-device port's."""
    data, pw = texamples.build_factorial(20, device="cpu")
    want = _prove_bytes(data, pw)
    got = _prove_bytes(data, pw, pctx.make_prover_mesh(8, virtual_on="cpu"))
    assert got == want


def test_mesh_prove_2d_mesh_lookup_equals_golden():
    """A (2 hosts x 4 chips) mesh, every sharded dimension flattened over
    both axes, proving the lookup circuit of tests/test_torch_lookups.py:
    its lookup columns cross the quotient's shard borders too. Equal to
    the JAX package's bytes (tests/golden/torch_lookup_proof.bin)."""
    from test_torch_lookups import _build

    data, pw = _build(tbuilder.CircuitBuilder, tconfig.CircuitConfig, twitness.PartialWitness,
                      device="cpu")
    assert data.common.num_lookup_polys > 0
    mesh = pctx.make_prover_mesh(8, virtual_on="cpu", shape=(2, 4))
    got = _prove_bytes(data, pw, mesh)
    assert got == (GOLDEN / "torch_lookup_proof.bin").read_bytes()

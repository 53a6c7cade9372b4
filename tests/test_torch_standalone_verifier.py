"""The port's standalone verifier surface (plonky2_tpu_torch.verifier; the
JAX package's tests/test_standalone_verifier.py): a subprocess started with
``python -I`` and a meta-path blocker on ``torch`` imports it, reads the
golden fibonacci proof, the port's verifier data and common data, verifies,
takes the compressed path (compress -> verify -> decompress = the same
bytes) and rejects a tampered public input; neither importing nor verifying
pulls torch (or jax)."""

import subprocess
import sys
from pathlib import Path

import pytest

from _torch_port import lazy_module

tfib = lazy_module("plonky2_tpu_torch.models.fibonacci")
ser = lazy_module("plonky2_tpu_torch.utils.serialization")

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"

_SUBPROCESS = r"""
import sys

class _TorchBlocker:
    def find_spec(self, name, path=None, target=None):
        if name in ("torch", "jax") or name.startswith(("torch.", "jax.", "jaxlib")):
            raise ImportError(f"import blocked in the standalone verifier: {name}")

sys.meta_path.insert(0, _TorchBlocker())
sys.path.insert(0, __REPO__)

import plonky2_tpu_torch.verifier as sv

assert "torch" not in sys.modules, "importing plonky2_tpu_torch.verifier pulled torch"

with open(__PATH__, "rb") as f:
    proof_b, vd_b, common_b = f.read().split(b"\x00SPLIT\x00")

common = sv.common_data_from_bytes(common_b)
vd, common_embedded = sv.verifier_data_from_bytes(vd_b)
assert common_embedded.degree_bits == common.degree_bits
pwp = sv.proof_from_bytes(proof_b, common)

sv.verify(pwp, vd, common)

cpwp = sv.compress_proof(pwp, vd, common)
sv.verify_compressed_proof(cpwp, vd, common)
pwp2 = sv.decompress_proof(cpwp, vd, common)
assert sv.proof_to_bytes(pwp2, common) == proof_b, "decompress drift"

pwp.public_inputs[0] ^= 1
try:
    sv.verify(pwp, vd, common)
except sv.VerificationError:
    pass
else:
    raise AssertionError("tampered proof accepted by the standalone verifier")

assert "torch" not in sys.modules and "jax" not in sys.modules, "verification pulled torch"
print("STANDALONE_OK")
"""


@pytest.fixture(scope="module")
def proof_blobs(tmp_path_factory):
    data, _ = tfib.build_fibonacci(public_io=True, device="cpu")
    path = tmp_path_factory.mktemp("sv") / "proof.bin"
    path.write_bytes(b"\x00SPLIT\x00".join([
        (GOLDEN / "fibonacci_proof.bin").read_bytes(),
        ser.verifier_data_to_bytes(data.verifier_only, data.common),
        ser.common_data_to_bytes(data.common),
    ]))
    return str(path)


def test_verify_without_torch(proof_blobs):
    code = _SUBPROCESS.replace("__REPO__", repr(str(REPO))).replace("__PATH__", repr(proof_blobs))
    out = subprocess.run(
        [sys.executable, "-I", "-c", code], capture_output=True, text=True, timeout=600
    )
    assert out.returncode == 0, f"stdout={out.stdout}\nstderr={out.stderr}"
    assert "STANDALONE_OK" in out.stdout


def test_surface_lists_the_reference_names():
    import plonky2_tpu.verifier as ref

    import plonky2_tpu_torch.verifier as sv

    assert sv.__all__ == ref.__all__

"""Pin the JAX package's circuit checkpoints that the PyTorch port is held to.

Builds each circuit with ``plonky2_tpu`` (the reference) on the CPU and
writes its ``utils/serialization.circuit_data_to_bytes`` (common data,
prover data with its generators, verifier data) to ``tests/golden/``:

* ``torch_fibonacci_circuit.bin``: ``models/fibonacci.build_fibonacci``
  with public inputs (the circuit of ``tests/golden/fibonacci_proof.bin``);
* ``torch_gate_mix_2^8_circuit.bin``: the gate-mix circuit
  (``plonky2_tpu_torch/models/gate_mix.build_gate_mix``, the one function
  that builds it for both packages) at degree 2^8: every generator type
  of the registry but the Poseidon2 family and RandomValueGenerator.

No proof is made, so each part takes the reference's build only (seconds
to a minute). Run from the repo root:

    JAX_PLATFORMS=cpu python3 tools/gen_aux_pins.py [--only fibonacci gate_mix]
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# XLA:CPU's fusion pass miscompiles some fused kernels into infinite loops
# on some hosts (tests/conftest.py); always disable it here.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_disable_hlo_passes" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_disable_hlo_passes=fusion").strip()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))
GOLDEN = os.path.join(REPO, "tests", "golden")


def _write(name: str, blob: bytes) -> None:
    path = os.path.join(GOLDEN, name)
    with open(path, "wb") as f:
        f.write(blob)
    print(f"  wrote {os.path.relpath(path, REPO)} ({len(blob)} B, sha256 "
          f"{hashlib.sha256(blob).hexdigest()})", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=["fibonacci", "gate_mix"], nargs="*",
                    default=["fibonacci", "gate_mix"], help="pins to write (default: all)")
    args = ap.parse_args()

    from gen_gate_mix_pins import _modules
    from plonky2_tpu.models.fibonacci import build_fibonacci
    from plonky2_tpu.utils.serialization import circuit_data_to_bytes

    if "fibonacci" in args.only:
        print("fibonacci", flush=True)
        t = time.time()
        data, _ = build_fibonacci(public_io=True)
        print(f"  built in {time.time() - t:.1f} s", flush=True)
        _write("torch_fibonacci_circuit.bin", circuit_data_to_bytes(data))
    if "gate_mix" in args.only:
        from plonky2_tpu_torch.models.gate_mix import build_gate_mix

        print("gate_mix 2^8", flush=True)
        t = time.time()
        data, _ = build_gate_mix(8, modules=_modules("plonky2_tpu"))
        print(f"  built in {time.time() - t:.1f} s", flush=True)
        _write("torch_gate_mix_2^8_circuit.bin", circuit_data_to_bytes(data))


if __name__ == "__main__":
    main()

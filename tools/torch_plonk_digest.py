#!/usr/bin/env python3
"""SHA-256 of the PyTorch/CUDA port's degree-2^n PLONK proof, on one GPU.

    python3 tools/torch_plonk_digest.py [--log2-gates 16]

Builds the full-width circuit of chip_smoke.py (2^(n-1) + 1 NoopGates under
the unchanged standard_recursion_config -> degree 2^n), proves it, and
prints one JSON line with the SHA-256 of the serialized proof, the prove
seconds and the card. The proof is deterministic (no blinding; the PoW
witness is the smallest), so the digest pins the prover's output: run the
script from the root of another checkout (it imports ``plonky2_tpu_torch``
from the current directory) to get that tree's digest for the same circuit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log2-gates", type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_plonk_digest: no CUDA device", file=sys.stderr)
        return 1

    import plonky2_tpu_torch
    from plonky2_tpu_torch.gates.basic import NoopGate
    from plonky2_tpu_torch.iop.witness import PartialWitness
    from plonky2_tpu_torch.plonk.circuit_builder import CircuitBuilder
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    from plonky2_tpu_torch.plonk.prover import prove
    from plonky2_tpu_torch.utils import serialization as ser

    builder = CircuitBuilder(CircuitConfig.standard_recursion_config())
    for _ in range((1 << (args.log2_gates - 1)) + 1):
        builder.add_gate(NoopGate(), [])
    data = builder.build()
    t0 = time.perf_counter()
    pwp = prove(data.prover_only, data.common, PartialWitness())
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    proof = ser.proof_to_bytes(pwp, data.common)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({
        "package": os.path.relpath(os.path.dirname(plonky2_tpu_torch.__file__)),
        "degree_bits": data.common.degree_bits,
        "proof_bytes": len(proof),
        "proof_sha256": hashlib.sha256(proof).hexdigest(),
        "prove_s": prove_s,
        "card": card,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Example circuits, mirroring the reference examples crate:
factorial (plonky2/examples/factorial.rs), range_check
(examples/range_check.rs), square_root (examples/square_root.rs —
exercises user-defined witness generators). Every builder takes the
``device`` of CircuitBuilder.build (None means the GPU)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..field import goldilocks as gl
from ..iop.generator import SimpleGenerator
from ..iop.target import Target
from ..iop.witness import PartialWitness
from ..plonk.circuit_builder import CircuitBuilder
from ..plonk.config import CircuitConfig


def build_factorial(n: int = 100, device=None):
    """Proves knowledge of the factorial of `initial` (factorial.rs)."""
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config())
    initial = builder.add_virtual_target()
    cur = initial
    for i in range(2, n + 1):
        cur = builder.mul_const(i, cur)
    builder.register_public_input(initial)
    builder.register_public_input(cur)
    data = builder.build(device=device)
    pw = PartialWitness()
    pw.set_target(initial, 1)
    return data, pw


def build_range_check(value: int = 42, log_max: int = 6, device=None):
    """Proves the secret value is < 2^log_max (range_check.rs)."""
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config())
    t = builder.add_virtual_target()
    builder.register_public_input(t)
    builder.range_check(t, log_max)
    data = builder.build(device=device)
    pw = PartialWitness()
    pw.set_target(t, value)
    return data, pw


@dataclass
class SquareRootGenerator(SimpleGenerator):
    """Computes x = sqrt(x_squared) outside the circuit
    (square_root.rs:27-74)."""

    x: Target
    x_squared: Target

    def id(self) -> str:
        return "SquareRootGenerator"

    def dependencies(self) -> List[Target]:
        return [self.x_squared]

    def run_once(self, witness, out) -> None:
        x_squared = witness.get_target(self.x_squared)
        x = gl.gsqrt(x_squared)
        assert x is not None, "public input is not a quadratic residue"
        out.set_target(self.x, x)


def fibonacci_serialization(out_dir: str, device=None) -> dict:
    """Build + prove the fibonacci circuit and persist the three circuit
    artifacts to files, then reload and verify them from disk
    (examples/fibonacci_serialization.rs:44-67 — the reference writes
    common_circuit_data / verifier_only_circuit_data / proof files; it
    uses serde JSON, this build uses its binary wire format, the
    capability being persist-and-reload of every verification artifact).
    Returns the written paths."""
    import os

    from .fibonacci import build_fibonacci
    from ..plonk.verifier import verify
    from ..utils.serialization import (
        common_data_from_bytes,
        common_data_to_bytes,
        proof_from_bytes,
        proof_to_bytes,
        verifier_data_from_bytes,
        verifier_data_to_bytes,
    )

    data, pw = build_fibonacci(public_io=True, device=device)
    pwp = data.prove(pw, device=device)

    paths = {
        "common_circuit_data": os.path.join(out_dir, "common_circuit_data.bin"),
        "verifier_only_circuit_data": os.path.join(
            out_dir, "verifier_only_circuit_data.bin"
        ),
        "proof_with_public_inputs": os.path.join(
            out_dir, "proof_with_public_inputs.bin"
        ),
    }
    with open(paths["common_circuit_data"], "wb") as f:
        f.write(common_data_to_bytes(data.common))
    with open(paths["verifier_only_circuit_data"], "wb") as f:
        f.write(verifier_data_to_bytes(data.verifier_only, data.common))
    with open(paths["proof_with_public_inputs"], "wb") as f:
        f.write(proof_to_bytes(pwp, data.common))

    with open(paths["common_circuit_data"], "rb") as f:
        common = common_data_from_bytes(f.read())
    with open(paths["verifier_only_circuit_data"], "rb") as f:
        verifier_only, _ = verifier_data_from_bytes(f.read())
    with open(paths["proof_with_public_inputs"], "rb") as f:
        loaded = proof_from_bytes(f.read(), common)
    verify(loaded, verifier_only, common)
    return paths


def build_square_root(x: int = 8589934592, device=None):
    """Proves knowledge of a square root of the public input
    (square_root.rs:76-131)."""
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config())
    x_t = builder.add_virtual_target()
    x_squared_t = builder.square(x_t)
    builder.register_public_input(x_squared_t)
    builder.add_simple_generator(SquareRootGenerator(x_t, x_squared_t))
    data = builder.build(device=device)
    pw = PartialWitness()
    x_squared = gl.gmul(x, x)
    pw.set_target(x_squared_t, x_squared)
    return data, pw, x_squared

"""Fibonacci example circuit (reference: plonky2/examples/fibonacci.rs:11-49).

Proves knowledge of the 100th term of a Fibonacci sequence with given
initial values. The public-input variant requires the Poseidon gate for
in-circuit PI hashing; `build_fibonacci(public_io=False)` asserts the
result against a constant instead.
"""

from __future__ import annotations

from ..field import goldilocks as gl
from ..iop.witness import PartialWitness
from ..plonk.circuit_builder import CircuitBuilder
from ..plonk.config import CircuitConfig


def fib_value(n_steps: int = 99, x0: int = 0, x1: int = 1) -> int:
    a, b = x0, x1
    for _ in range(n_steps):
        a, b = b, gl.gadd(a, b)
    return b


def build_fibonacci(config: CircuitConfig | None = None, public_io: bool = True,
                    device=None):
    """Returns (circuit_data, partial_witness). device: see
    CircuitBuilder.build (None means the GPU)."""
    builder = CircuitBuilder(config or CircuitConfig.standard_recursion_config())
    initial_a = builder.add_virtual_target()
    initial_b = builder.add_virtual_target()
    prev, cur = initial_a, initial_b
    for _ in range(99):
        prev, cur = cur, builder.add(prev, cur)

    if public_io:
        builder.register_public_input(initial_a)
        builder.register_public_input(initial_b)
        builder.register_public_input(cur)
    else:
        builder.connect(cur, builder.constant(fib_value()))

    data = builder.build(device=device)
    pw = PartialWitness()
    pw.set_target(initial_a, 0)
    pw.set_target(initial_b, 1)
    return data, pw

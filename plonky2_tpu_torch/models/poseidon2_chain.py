"""A chain of Poseidon2 permutations in a circuit: one Poseidon2Gate row a
permutation, each gate's output wired to the next one's input, the first
input and the last output public. Under ``poseidon2_goldilocks_config``
the public inputs (24 words) are hashed by four more Poseidon2Gate rows.
"""

from __future__ import annotations

from typing import List, Tuple

from ..hash import poseidon2 as p2
from ..iop.target import Target
from ..iop.witness import PartialWitness
from ..plonk.circuit_builder import CircuitBuilder
from ..plonk.generic_config import poseidon2_goldilocks_config

# the input state (tests/test_poseidon2.py::test_poseidon2_gate_in_circuit_proves)
CHAIN_INPUT = [3 * i + 1 for i in range(p2.SPONGE_WIDTH)]


def add_chain(b, num_permutations: int) -> Tuple[List[Target], List[Target]]:
    """Adds the chain to ``b`` (a CircuitBuilder of this package or of the
    JAX package: only methods both define are called). Returns (input
    targets, output targets)."""
    inputs = [b.add_virtual_target() for _ in range(p2.SPONGE_WIDTH)]
    state = inputs
    for _ in range(num_permutations):
        state = b.permute_poseidon2(state)
    for t in inputs + state:
        b.register_public_input(t)
    return inputs, state


def build_poseidon2_chain(config, num_permutations: int, device=None):
    """The chain, built under ``poseidon2_goldilocks_config``, with its
    witness (CHAIN_INPUT): (data, pw). device: where the constants/sigmas
    commitment lives; None means the GPU."""
    b = CircuitBuilder(config)
    inputs, _ = add_chain(b, num_permutations)
    data = b.build(gc=poseidon2_goldilocks_config(), device=device)
    pw = PartialWitness()
    for t, v in zip(inputs, CHAIN_INPUT):
        pw.set_target(t, v)
    return data, pw


def chain_output(num_permutations: int) -> List[int]:
    """The chain's last output, by the host permutation."""
    state = list(CHAIN_INPUT)
    for _ in range(num_permutations):
        state = p2.permute(state)
    return state

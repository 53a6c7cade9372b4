"""Witness generators and the generation fixpoint
(reference: plonky2/src/iop/generator.rs:26-404).

Witness generation is sequential, data-dependent host work. Where a C
compiler is present it runs in the native engine (iop/witgen_native.py
over native/witgen.c); the Python fixpoint below is the reference
semantics and the fallback."""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..field.goldilocks import P
from .target import Target
from .witness import PartialWitness, PartitionWitness


class SimpleGenerator:
    """A generator that runs once, when all its dependencies are set."""

    def id(self) -> str:
        return type(self).__name__

    def dependencies(self) -> List[Target]:
        raise NotImplementedError

    def run_once(self, witness: PartitionWitness, out: "GeneratedValues") -> None:
        raise NotImplementedError

    # WitnessGenerator interface
    def watch_list(self) -> List[Target]:
        return self.dependencies()

    def run(self, witness: PartitionWitness, out: "GeneratedValues") -> bool:
        if all(witness.contains(t) for t in self.dependencies()):
            self.run_once(witness, out)
            return True
        return False


class GeneratedValues:
    def __init__(self):
        self.target_values: List[Tuple[Target, int]] = []

    def set_target(self, t: Target, value: int) -> None:
        self.target_values.append((t, value % P))

    def set_wire(self, row: int, column: int, value: int) -> None:
        self.set_target(Target.wire(row, column), value)


@dataclass
class ConstantGenerator(SimpleGenerator):
    row: int
    constant_index: int
    wire_index: int
    constant: int = 0

    def id(self) -> str:
        return "ConstantGenerator"

    def dependencies(self) -> List[Target]:
        return []

    def run_once(self, witness, out) -> None:
        out.set_wire(self.row, self.wire_index, self.constant)


@dataclass
class CopyGenerator(SimpleGenerator):
    src: Target
    dst: Target

    def dependencies(self) -> List[Target]:
        return [self.src]

    def run_once(self, witness, out) -> None:
        out.set_target(self.dst, witness.get_target(self.src))


@dataclass
class RandomValueGenerator(SimpleGenerator):
    target: Target

    def dependencies(self) -> List[Target]:
        return []

    def run_once(self, witness, out) -> None:
        import secrets

        out.set_target(self.target, secrets.randbelow(P))


@dataclass
class NonzeroTestGenerator(SimpleGenerator):
    to_test: Target
    dummy: Target

    def dependencies(self) -> List[Target]:
        return [self.to_test]

    def run_once(self, witness, out) -> None:
        from ..field.goldilocks import ginv

        v = witness.get_target(self.to_test)
        out.set_target(self.dummy, 1 if v == 0 else ginv(v))


def generate_partial_witness(
    inputs: PartialWitness,
    prover_data,
    common_data,
) -> PartitionWitness:
    """Worklist fixpoint: run pending generators, merge their outputs, wake
    watchers keyed by union-find representative (generator.rs:26-104).

    When the native engine is available (iop/witgen_native.py compiles
    generators to field-op bytecode and runs the fixpoint in C), it is
    used instead; the pure-Python fixpoint below is the reference
    semantics and the fallback."""
    from . import witgen_native

    if witgen_native.available():
        w = witgen_native.generate_partial_witness_native(
            inputs, prover_data, common_data
        )
        if w is not None:
            return w

    generators: Sequence = prover_data.generators
    by_watches: Dict[int, List[int]] = prover_data.generator_indices_by_watches
    witness = PartitionWitness(
        prover_data.representative_map,
        common_data.config.num_wires,
        common_data.degree,
    )

    for t, v in inputs.items():
        witness.set_target(t, v)

    remaining = set(range(len(generators)))
    # pending: all generators initially
    pending = list(range(len(generators)))
    buffer = GeneratedValues()

    while pending:
        next_pending: List[int] = []
        for gi in pending:
            if gi not in remaining:
                continue
            gen = generators[gi]
            if gen.run(witness, buffer):
                remaining.discard(gi)
        # merge buffered values; wake only watchers of newly-set
        # representatives (an unfinished generator is re-queued exactly when
        # one of its watched targets becomes set)
        seen = set()
        for t, v in buffer.target_values:
            if witness.set_target(t, v):
                rep = witness.rep_index(t)
                for gi in by_watches.get(rep, ()):
                    if gi in remaining and gi not in seen:
                        next_pending.append(gi)
                        seen.add(gi)
        buffer.target_values.clear()
        pending = next_pending

    if remaining:
        raise RuntimeError(f"{len(remaining)} generators never ran (missing inputs?)")
    return witness


def fixed_random_value(seed: int, target: Target) -> int:
    """A blinding value fixed by ``seed`` and the target it is drawn for,
    whatever the order generators run in."""
    import hashlib

    key = f"{seed}:{target.kind}:{target.row}:{target.column}:{target.index}"
    return int.from_bytes(hashlib.sha256(key.encode()).digest()[:8], "little") % P


@contextmanager
def fixed_random_values(seed: int, generator_cls=None):
    """Within the block, ``generator_cls`` (RandomValueGenerator by
    default, or any class with its ``target`` field) sets
    ``fixed_random_value(seed, target)`` instead of a fresh secret value:
    the blinding rows of a zero-knowledge proof become reproducible, for
    tests and for comparing two provers byte for byte."""
    cls = generator_cls or RandomValueGenerator
    original = cls.run_once

    def run_once(self, witness, out) -> None:
        out.set_target(self.target, fixed_random_value(seed, self.target))

    cls.run_once = run_once
    try:
        yield
    finally:
        cls.run_once = original

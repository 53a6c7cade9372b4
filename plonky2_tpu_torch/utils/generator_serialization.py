"""Witness-generator (de)serialization (reference:
plonky2/src/util/serialization/generator_serialization.rs:100-220).

The default serializer covers every generator this framework emits, in a
fixed tag order mirroring the reference's DefaultGeneratorSerializer
registry. Payloads are the generator's dataclass fields encoded with the
same primitive formats as the rest of the wire layer (usize, Target,
field elements); LUT-bearing generators store an index into
common.luts like the lookup gates do.

The tag order is the JAX package's (plonky2_tpu/utils/generator_serialization.py
registry), so that a checkpoint written by either package loads in the other;
tests/test_torch_serialization_checkpoint.py holds the bytes to its pins.
"""

from __future__ import annotations

from dataclasses import fields as dc_fields
from typing import List

from ..iop.target import Target
from .serialization import Buffer, SerializationError


def _registry():
    from ..gates.basic import ArithmeticBaseGenerator
    from ..gates.extension import (
        ArithmeticExtensionGenerator,
        MulExtensionGenerator,
        ReducingExtensionGenerator,
        ReducingGenerator,
    )
    from ..gates.interpolation import InterpolationGenerator, PoseidonMdsGenerator
    from ..gates.lookup import LookupGenerator, LookupTableGenerator
    from ..gates.misc import (
        BaseSplitGenerator,
        ExponentiationGenerator,
        RandomAccessGenerator,
    )
    from ..gates.poseidon import PoseidonGenerator
    from ..gates.poseidon2 import Poseidon2Generator, Poseidon2MdsGenerator
    from ..iop.generator import (
        ConstantGenerator,
        CopyGenerator,
        NonzeroTestGenerator,
        RandomValueGenerator,
    )
    from ..plonk.gadgets import (
        ExtInverseGenerator,
        InvOrZeroGenerator,
        LowHighGenerator,
        WireSplitGenerator,
    )

    # tag order mirrors generator_serialization.rs:160-215 where a
    # counterpart exists; framework-specific generators (ExtInverse,
    # InvOrZero) take the trailing tags
    return [
        ArithmeticBaseGenerator,
        ArithmeticExtensionGenerator,
        BaseSplitGenerator,
        ConstantGenerator,
        CopyGenerator,
        ExponentiationGenerator,
        InterpolationGenerator,
        LookupGenerator,
        LookupTableGenerator,
        LowHighGenerator,
        MulExtensionGenerator,
        NonzeroTestGenerator,
        PoseidonGenerator,
        PoseidonMdsGenerator,
        Poseidon2Generator,
        Poseidon2MdsGenerator,
        RandomAccessGenerator,
        RandomValueGenerator,
        ReducingGenerator,
        ReducingExtensionGenerator,
        WireSplitGenerator,
        ExtInverseGenerator,
        InvOrZeroGenerator,
    ]


def _write_target(buf: Buffer, t: Target) -> None:
    if t.kind == "wire":
        buf.write_bool(True)
        buf.write_usize(t.row)
        buf.write_usize(t.column)
    else:
        buf.write_bool(False)
        buf.write_usize(t.index)


def _read_target(buf: Buffer) -> Target:
    if buf.read_bool():
        return Target.wire(buf.read_usize(), buf.read_usize())
    return Target.virtual(buf.read_usize())


class DefaultGeneratorSerializer:
    def write_generator(self, buf: Buffer, gen, common) -> None:
        registry = _registry()
        for tag, cls in enumerate(registry):
            if type(gen).__name__ == cls.__name__:
                buf.write_u32(tag)
                self._write_payload(buf, gen, common)
                return
        raise SerializationError(f"unsupported generator {type(gen).__name__}")

    def read_generator(self, buf: Buffer, common):
        registry = _registry()
        tag = buf.read_u32()
        if tag >= len(registry):
            raise SerializationError(f"bad generator tag {tag}")
        return self._read_payload(buf, registry[tag], common)

    # -- field-driven payloads ----------------------------------------------

    def _write_payload(self, buf: Buffer, gen, common) -> None:
        from ..gates.poseidon2 import Poseidon2MdsGenerator

        if isinstance(gen, Poseidon2MdsGenerator):
            # gate_cls field: 0 = Mds, 1 = IntMix
            from ..gates.poseidon2 import Poseidon2MdsGate

            buf.write_u8(0 if gen.gate_cls is Poseidon2MdsGate else 1)
            buf.write_usize(gen.row)
            return
        from ..iop.target import ExtensionTarget

        for f in dc_fields(gen):
            v = getattr(gen, f.name)
            if isinstance(v, ExtensionTarget):
                for part in v.parts:
                    _write_target(buf, part)
            elif isinstance(v, Target):
                _write_target(buf, v)
            elif isinstance(v, bool):
                buf.write_bool(v)
            elif isinstance(v, int):
                buf.write_usize(v)
            elif isinstance(v, list) and all(isinstance(x, int) for x in v):
                buf.write_usize_vec(v)
            elif isinstance(v, tuple) and f.name == "lut":
                for i, lut in enumerate(common.luts):
                    if tuple(lut) == tuple(v):
                        buf.write_usize(i)
                        break
                else:
                    raise SerializationError("generator's lut not in common.luts")
            else:
                raise SerializationError(
                    f"unserializable field {f.name} on {type(gen).__name__}"
                )

    def _read_payload(self, buf: Buffer, cls, common):
        from ..gates.poseidon2 import (
            Poseidon2IntMixGate,
            Poseidon2MdsGate,
            Poseidon2MdsGenerator,
        )

        if cls is Poseidon2MdsGenerator:
            which = buf.read_u8()
            gate_cls = Poseidon2MdsGate if which == 0 else Poseidon2IntMixGate
            return cls(gate_cls, buf.read_usize())
        from ..iop.target import ExtensionTarget

        args = []
        for f in dc_fields(cls):
            ann = str(f.type)
            if "ExtensionTarget" in ann:
                args.append(ExtensionTarget((_read_target(buf), _read_target(buf))))
            elif "Target" in ann:
                args.append(_read_target(buf))
            elif "LookupTable" in ann or f.name == "lut":
                args.append(tuple(common.luts[buf.read_usize()]))
            elif "List[int]" in ann:
                args.append(buf.read_usize_vec())
            elif "bool" in ann:
                args.append(buf.read_bool())
            else:
                args.append(buf.read_usize())
        return cls(*args)

"""Byte-compatible (de)serialization of proofs and circuit data, following
the reference wire format (plonky2/src/util/serialization/mod.rs:90-2231,
gate_serialization.rs:31-153).

Encodings: little-endian integers (usize as u64), field elements as
canonical u64 LE, extensions as D consecutive fields, HashOut as 4 u64
LE (32 bytes), MerkleProof as u8 length + sibling hashes, gates as a u32
tag into the DefaultGateSerializer order followed by a per-gate payload.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..field import goldilocks as gl
from ..fri.config import FriConfig, FriParams, FriReductionStrategy
from ..fri.proof import (
    FriInitialTreeProof,
    FriProof,
    FriQueryRound,
    FriQueryStep,
    MerkleProof,
)

D = 2
SALT_SIZE = 4


class SerializationError(Exception):
    pass


class Buffer:
    """Sequential byte reader/writer (util/serialization/mod.rs Buffer)."""

    def __init__(self, data: bytes = b""):
        self.data = bytearray(data)
        self.pos = 0

    def bytes(self) -> bytes:
        return bytes(self.data)

    def remaining(self) -> int:
        return len(self.data) - self.pos

    # -- primitives ----------------------------------------------------------

    def _read(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise SerializationError("buffer exhausted")
        out = bytes(self.data[self.pos : self.pos + n])
        self.pos += n
        return out

    def write_all(self, b: bytes) -> None:
        self.data.extend(b)

    def read_exact(self, n: int) -> bytes:
        return self._read(n)

    def read_u8(self) -> int:
        return self._read(1)[0]

    def write_u8(self, x: int) -> None:
        self.data.append(x & 0xFF)

    def read_u16(self) -> int:
        return struct.unpack("<H", self._read(2))[0]

    def write_u16(self, x: int) -> None:
        self.data.extend(struct.pack("<H", x))

    def read_u32(self) -> int:
        return struct.unpack("<I", self._read(4))[0]

    def write_u32(self, x: int) -> None:
        self.data.extend(struct.pack("<I", x))

    def read_usize(self) -> int:
        return struct.unpack("<Q", self._read(8))[0]

    def write_usize(self, x: int) -> None:
        self.data.extend(struct.pack("<Q", x))

    def read_usize_vec(self) -> List[int]:
        return self.read_usize_array(self.read_usize()).tolist()

    def write_usize_vec(self, v: Sequence[int]) -> None:
        self.write_usize(len(v))
        self.write_usize_array(v)

    def read_usize_array(self, length: int) -> np.ndarray:
        """``length`` usizes as a u64 array (one read, no per-word loop)."""
        return np.frombuffer(self._read(8 * length), dtype="<u8").astype(np.uint64)

    def write_usize_array(self, v) -> None:
        self.data.extend(np.asarray(v, dtype="<u8").tobytes())

    def read_bool(self) -> bool:
        b = self.read_u8()
        if b > 1:
            raise SerializationError("invalid bool")
        return bool(b)

    def write_bool(self, x: bool) -> None:
        self.write_u8(1 if x else 0)

    # -- field elements ------------------------------------------------------

    def read_field(self) -> int:
        return struct.unpack("<Q", self._read(8))[0] % gl.P

    def write_field(self, x: int) -> None:
        self.data.extend(struct.pack("<Q", x % gl.P))

    def read_field_vec(self, length: int) -> List[int]:
        return [self.read_field() for _ in range(length)]

    def write_field_vec(self, v: Sequence[int]) -> None:
        for x in v:
            self.write_field(x)

    def read_field_array(self, length: int) -> np.ndarray:
        """``length`` field elements as a canonical u64 array: the bytes of
        read_field_vec, read in one piece."""
        a = np.frombuffer(self._read(8 * length), dtype="<u8").astype(np.uint64)
        return np.where(a >= np.uint64(gl.P), a - np.uint64(gl.P), a)

    def write_field_array(self, a) -> None:
        """The bytes of write_field_vec for a u64 array, written in one piece
        (values reduced as write_field reduces them)."""
        a = np.asarray(a, dtype=np.uint64)
        a = np.where(a >= np.uint64(gl.P), a - np.uint64(gl.P), a)
        self.data.extend(a.astype("<u8").tobytes())

    def read_field_ext(self) -> Tuple[int, ...]:
        return tuple(self.read_field() for _ in range(D))

    def write_field_ext(self, x: Sequence[int]) -> None:
        for c in x:
            self.write_field(c)

    def read_field_ext_vec(self, length: int) -> List[Tuple[int, ...]]:
        return [self.read_field_ext() for _ in range(length)]

    def write_field_ext_vec(self, v) -> None:
        for x in v:
            self.write_field_ext(x)

    # -- hashes / Merkle -----------------------------------------------------

    def read_hash(self) -> Tuple[int, int, int, int]:
        return tuple(struct.unpack("<4Q", self._read(32)))

    def write_hash(self, h: Sequence[int]) -> None:
        self.data.extend(struct.pack("<4Q", *[int(x) % gl.P for x in h]))

    def read_merkle_cap(self, cap_height: int) -> np.ndarray:
        if cap_height > 20:
            raise SerializationError("cap_height too large")
        return np.array(
            [self.read_hash() for _ in range(1 << cap_height)], dtype=np.uint64
        ).reshape(1 << cap_height, 4)

    def write_merkle_cap(self, cap: np.ndarray) -> None:
        for row in cap:
            self.write_hash([int(x) for x in row])

    def read_merkle_proof(self) -> MerkleProof:
        length = self.read_u8()
        return MerkleProof(siblings=[self.read_hash() for _ in range(length)])

    def write_merkle_proof(self, proof: MerkleProof) -> None:
        self.write_u8(len(proof.siblings))
        for sib in proof.siblings:
            self.write_hash(sib)

    # -- configs (mod.rs:643-784) -------------------------------------------

    def read_fri_reduction_strategy(self) -> FriReductionStrategy:
        variant = self.read_u8()
        if variant == 0:
            return FriReductionStrategy.Fixed(self.read_usize_vec())
        if variant == 1:
            return FriReductionStrategy.ConstantArityBits(
                self.read_usize(), self.read_usize()
            )
        if variant == 2:
            is_some = self.read_u8()
            if is_some == 0:
                return FriReductionStrategy.MinSize(None)
            if is_some == 1:
                return FriReductionStrategy.MinSize(self.read_usize())
        raise SerializationError("bad reduction strategy")

    def write_fri_reduction_strategy(self, s: FriReductionStrategy) -> None:
        if s.kind == "fixed":
            self.write_u8(0)
            self.write_usize_vec(list(s.fixed))
        elif s.kind == "constant_arity":
            self.write_u8(1)
            self.write_usize(s.arity_bits)
            self.write_usize(s.final_poly_bits)
        else:
            self.write_u8(2)
            if s.max_arity_bits is None:
                self.write_u8(0)
            else:
                self.write_u8(1)
                self.write_usize(s.max_arity_bits)

    def read_fri_config(self) -> FriConfig:
        rate_bits = self.read_usize()
        cap_height = self.read_usize()
        num_query_rounds = self.read_usize()
        proof_of_work_bits = self.read_u32()
        reduction_strategy = self.read_fri_reduction_strategy()
        return FriConfig(
            rate_bits=rate_bits,
            cap_height=cap_height,
            proof_of_work_bits=proof_of_work_bits,
            reduction_strategy=reduction_strategy,
            num_query_rounds=num_query_rounds,
        )

    def write_fri_config(self, c: FriConfig) -> None:
        self.write_usize(c.rate_bits)
        self.write_usize(c.cap_height)
        self.write_usize(c.num_query_rounds)
        self.write_u32(c.proof_of_work_bits)
        self.write_fri_reduction_strategy(c.reduction_strategy)

    def read_fri_params(self) -> FriParams:
        config = self.read_fri_config()
        reduction_arity_bits = self.read_usize_vec()
        degree_bits = self.read_usize()
        leaf_hiding = self.read_bool()
        return FriParams(
            config=config,
            leaf_hiding=leaf_hiding,
            degree_bits=degree_bits,
            reduction_arity_bits=tuple(reduction_arity_bits),
        )

    def write_fri_params(self, p: FriParams) -> None:
        self.write_fri_config(p.config)
        self.write_usize_vec(list(p.reduction_arity_bits))
        self.write_usize(p.degree_bits)
        self.write_bool(p.leaf_hiding)

    def read_circuit_config(self):
        from ..plonk.config import CircuitConfig

        num_wires = self.read_usize()
        num_routed_wires = self.read_usize()
        num_constants = self.read_usize()
        security_bits = self.read_usize()
        num_challenges = self.read_usize()
        max_quotient_degree_factor = self.read_usize()
        use_base_arithmetic_gate = self.read_bool()
        zero_knowledge = self.read_bool()
        fri_config = self.read_fri_config()
        return CircuitConfig(
            num_wires=num_wires,
            num_routed_wires=num_routed_wires,
            num_constants=num_constants,
            use_base_arithmetic_gate=use_base_arithmetic_gate,
            security_bits=security_bits,
            num_challenges=num_challenges,
            zero_knowledge=zero_knowledge,
            max_quotient_degree_factor=max_quotient_degree_factor,
            fri_config=fri_config,
        )

    def write_circuit_config(self, c) -> None:
        self.write_usize(c.num_wires)
        self.write_usize(c.num_routed_wires)
        self.write_usize(c.num_constants)
        self.write_usize(c.security_bits)
        self.write_usize(c.num_challenges)
        self.write_usize(c.max_quotient_degree_factor)
        self.write_bool(c.use_base_arithmetic_gate)
        self.write_bool(c.zero_knowledge)
        self.write_fri_config(c.fri_config)

    # -- proofs (mod.rs:374-1100) -------------------------------------------

    def read_opening_set(self, common):
        from ..plonk.proof import OpeningSet

        config = common.config
        return OpeningSet(
            constants=self.read_field_ext_vec(common.num_constants),
            plonk_sigmas=self.read_field_ext_vec(config.num_routed_wires),
            wires=self.read_field_ext_vec(config.num_wires),
            plonk_zs=self.read_field_ext_vec(config.num_challenges),
            plonk_zs_next=self.read_field_ext_vec(config.num_challenges),
            lookup_zs=self.read_field_ext_vec(common.num_all_lookup_polys()),
            lookup_zs_next=self.read_field_ext_vec(common.num_all_lookup_polys()),
            partial_products=self.read_field_ext_vec(
                common.num_partial_products * config.num_challenges
            ),
            quotient_polys=self.read_field_ext_vec(
                common.quotient_degree_factor * config.num_challenges
            ),
        )

    def write_opening_set(self, o, common) -> None:
        self.write_field_ext_vec(o.constants)
        self.write_field_ext_vec(o.plonk_sigmas)
        self.write_field_ext_vec(o.wires)
        self.write_field_ext_vec(o.plonk_zs)
        self.write_field_ext_vec(o.plonk_zs_next)
        self.write_field_ext_vec(o.lookup_zs)
        self.write_field_ext_vec(o.lookup_zs_next)
        self.write_field_ext_vec(o.partial_products)
        self.write_field_ext_vec(o.quotient_polys)

    def _initial_leaf_widths(self, common) -> List[int]:
        config = common.config
        salt = SALT_SIZE if common.fri_params.leaf_hiding else 0
        return [
            common.num_constants + config.num_routed_wires,
            config.num_wires + salt,
            config.num_challenges * (1 + common.num_partial_products)
            + common.num_all_lookup_polys()
            + salt,
            common.quotient_degree_factor * config.num_challenges + salt,
        ]

    def read_fri_initial_proof(self, common) -> FriInitialTreeProof:
        evals_proofs = []
        for width in self._initial_leaf_widths(common):
            vals = self.read_field_vec(width)
            proof = self.read_merkle_proof()
            evals_proofs.append((vals, proof))
        return FriInitialTreeProof(evals_proofs=evals_proofs)

    def write_fri_initial_proof(self, p: FriInitialTreeProof) -> None:
        for vals, proof in p.evals_proofs:
            self.write_field_vec(vals)
            self.write_merkle_proof(proof)

    def read_fri_query_step(self, arity: int, compressed: bool) -> FriQueryStep:
        evals = self.read_field_ext_vec(arity - (1 if compressed else 0))
        return FriQueryStep(evals=evals, merkle_proof=self.read_merkle_proof())

    def write_fri_query_step(self, s: FriQueryStep) -> None:
        self.write_field_ext_vec(s.evals)
        self.write_merkle_proof(s.merkle_proof)

    def read_fri_proof(self, common) -> FriProof:
        config = common.config
        caps = [
            self.read_merkle_cap(config.fri_config.cap_height)
            for _ in common.fri_params.reduction_arity_bits
        ]
        rounds = []
        for _ in range(config.fri_config.num_query_rounds):
            initial = self.read_fri_initial_proof(common)
            steps = [
                self.read_fri_query_step(1 << ar, False)
                for ar in common.fri_params.reduction_arity_bits
            ]
            rounds.append(FriQueryRound(initial_trees_proof=initial, steps=steps))
        final_poly = self.read_field_ext_vec(common.fri_params.final_poly_len())
        pow_witness = self.read_field()
        return FriProof(
            commit_phase_merkle_caps=caps,
            query_round_proofs=rounds,
            final_poly=final_poly,
            pow_witness=pow_witness,
        )

    def write_fri_proof(self, p: FriProof) -> None:
        for cap in p.commit_phase_merkle_caps:
            self.write_merkle_cap(cap)
        for rnd in p.query_round_proofs:
            self.write_fri_initial_proof(rnd.initial_trees_proof)
            for step in rnd.steps:
                self.write_fri_query_step(step)
        self.write_field_ext_vec(p.final_poly)
        self.write_field(p.pow_witness)

    def read_proof(self, common):
        from ..plonk.proof import Proof

        h = common.config.fri_config.cap_height
        return Proof(
            wires_cap=self.read_merkle_cap(h),
            plonk_zs_partial_products_cap=self.read_merkle_cap(h),
            quotient_polys_cap=self.read_merkle_cap(h),
            openings=self.read_opening_set(common),
            opening_proof=self.read_fri_proof(common),
        )

    def write_proof(self, proof, common) -> None:
        self.write_merkle_cap(proof.wires_cap)
        self.write_merkle_cap(proof.plonk_zs_partial_products_cap)
        self.write_merkle_cap(proof.quotient_polys_cap)
        self.write_opening_set(proof.openings, common)
        self.write_fri_proof(proof.opening_proof)

    def read_proof_with_public_inputs(self, common):
        from ..plonk.proof import ProofWithPublicInputs

        proof = self.read_proof(common)
        pi_len = self.read_usize()
        return ProofWithPublicInputs(proof, self.read_field_vec(pi_len))

    def write_proof_with_public_inputs(self, pwp, common) -> None:
        self.write_proof(pwp.proof, common)
        self.write_usize(len(pwp.public_inputs))
        self.write_field_vec(pwp.public_inputs)

    # -- circuit data (mod.rs:786-1010) -------------------------------------

    def read_selectors_info(self):
        from ..gates.gate import SelectorsInfo

        selector_indices = self.read_usize_vec()
        groups = []
        for _ in range(self.read_usize()):
            start = self.read_usize()
            end = self.read_usize()
            groups.append((start, end))
        return SelectorsInfo(selector_indices=selector_indices, groups=groups)

    def write_selectors_info(self, si) -> None:
        self.write_usize_vec(si.selector_indices)
        self.write_usize(len(si.groups))
        for start, end in si.groups:
            self.write_usize(start)
            self.write_usize(end)

    def read_lut(self) -> Tuple[Tuple[int, int], ...]:
        length = self.read_usize()
        if length == 0:
            raise SerializationError("empty lut")
        return tuple((self.read_u16(), self.read_u16()) for _ in range(length))

    def write_lut(self, lut) -> None:
        self.write_usize(len(lut))
        for inp, out in lut:
            self.write_u16(inp)
            self.write_u16(out)

    def read_common_circuit_data(self, gate_serializer=None):
        from ..plonk.circuit_data import CommonCircuitData

        gate_serializer = gate_serializer or DefaultGateSerializer()
        config = self.read_circuit_config()
        trace_degree_bits = self.read_usize()
        fri_params = self.read_fri_params()
        public_initial_degree_bits = self.read_usize()
        selectors_info = self.read_selectors_info()
        quotient_degree_factor = self.read_usize()
        num_gate_constraints = self.read_usize()
        num_constants = self.read_usize()
        num_public_inputs = self.read_usize()
        k_is = self.read_field_vec(self.read_usize())
        num_partial_products = self.read_usize()
        num_lookup_polys = self.read_usize()
        num_lookup_selectors = self.read_usize()
        luts = [self.read_lut() for _ in range(self.read_usize())]
        common = CommonCircuitData(
            config=config,
            trace_degree_bits=trace_degree_bits,
            fri_params=fri_params,
            public_initial_degree_bits=public_initial_degree_bits,
            gates=[],
            selectors_info=selectors_info,
            quotient_degree_factor=quotient_degree_factor,
            num_gate_constraints=num_gate_constraints,
            num_constants=num_constants,
            num_public_inputs=num_public_inputs,
            k_is=k_is,
            num_partial_products=num_partial_products,
            num_lookup_polys=num_lookup_polys,
            num_lookup_selectors=num_lookup_selectors,
            luts=luts,
        )
        gates_len = self.read_usize()
        common.gates = [
            gate_serializer.read_gate(self, common) for _ in range(gates_len)
        ]
        return common

    def write_common_circuit_data(self, common, gate_serializer=None) -> None:
        gate_serializer = gate_serializer or DefaultGateSerializer()
        self.write_circuit_config(common.config)
        self.write_usize(common.trace_degree_bits)
        self.write_fri_params(common.fri_params)
        self.write_usize(common.public_initial_degree_bits)
        self.write_selectors_info(common.selectors_info)
        self.write_usize(common.quotient_degree_factor)
        self.write_usize(common.num_gate_constraints)
        self.write_usize(common.num_constants)
        self.write_usize(common.num_public_inputs)
        self.write_usize(len(common.k_is))
        self.write_field_vec(common.k_is)
        self.write_usize(common.num_partial_products)
        self.write_usize(common.num_lookup_polys)
        self.write_usize(common.num_lookup_selectors)
        self.write_usize(len(common.luts))
        for lut in common.luts:
            self.write_lut(lut)
        self.write_usize(len(common.gates))
        for gate in common.gates:
            gate_serializer.write_gate(self, gate, common)

    def read_verifier_only_circuit_data(self):
        from ..plonk.circuit_data import VerifierOnlyCircuitData

        height = self.read_usize()
        cap = self.read_merkle_cap(height)
        digest = self.read_hash()
        return VerifierOnlyCircuitData(
            constants_sigmas_cap=cap, circuit_digest=digest
        )

    def write_verifier_only_circuit_data(self, v) -> None:
        import math

        height = int(np.log2(v.constants_sigmas_cap.shape[0]))
        self.write_usize(height)
        self.write_merkle_cap(v.constants_sigmas_cap)
        self.write_hash(v.circuit_digest)

    def read_verifier_circuit_data(self, gate_serializer=None):
        verifier_only = self.read_verifier_only_circuit_data()
        common = self.read_common_circuit_data(gate_serializer)
        return verifier_only, common

    def write_verifier_circuit_data(self, verifier_only, common, gate_serializer=None) -> None:
        self.write_verifier_only_circuit_data(verifier_only)
        self.write_common_circuit_data(common, gate_serializer)


# ---------------------------------------------------------------------------
# Gate serialization (gate_serialization.rs:31-153): u32 tag in the
# DefaultGateSerializer order, then the gate's own payload.
# ---------------------------------------------------------------------------


def _coset_gate_weights(subgroup_bits: int) -> List[int]:
    from ..gates.interpolation import barycentric_weights

    pts = [int(x) for x in gl.two_adic_subgroup(subgroup_bits)]
    return list(barycentric_weights(pts))


def _lut_bytes(lut) -> bytes:
    out = bytearray()
    for inp, outp in lut:
        out.extend(struct.pack("<H", inp))
        out.extend(struct.pack("<H", outp))
    return bytes(out)


def _lut_keccak(lut) -> bytes:
    from ..hash.keccak import keccak256

    return keccak256(_lut_bytes(lut))


class DefaultGateSerializer:
    """Tags 0-18 match gate_serialization.rs:130-153."""

    def _registry(self):
        """Gate classes by tag."""
        from ..gates.basic import (
            ArithmeticGate,
            ConstantGate,
            NoopGate,
            PublicInputGate,
        )
        from ..gates.extension import (
            ArithmeticExtensionGate,
            MulExtensionGate,
            ReducingExtensionGate,
            ReducingGate,
        )
        from ..gates.interpolation import CosetInterpolationGate, PoseidonMdsGate
        from ..gates.lookup import LookupGate, LookupTableGate
        from ..gates.misc import BaseSumGate, ExponentiationGate, RandomAccessGate
        from ..gates.poseidon import PoseidonGate
        from ..gates.poseidon2 import Poseidon2Gate, Poseidon2IntMixGate, Poseidon2MdsGate

        return [
            ArithmeticGate,
            ArithmeticExtensionGate,
            BaseSumGate,
            ConstantGate,
            CosetInterpolationGate,
            ExponentiationGate,
            LookupGate,
            LookupTableGate,
            MulExtensionGate,
            NoopGate,
            PoseidonMdsGate,
            PoseidonGate,
            Poseidon2MdsGate,
            Poseidon2IntMixGate,
            Poseidon2Gate,
            PublicInputGate,
            RandomAccessGate,
            ReducingExtensionGate,
            ReducingGate,
        ]

    def write_gate(self, buf: Buffer, gate, common) -> None:
        registry = self._registry()
        for tag, cls in enumerate(registry):
            if type(gate).__name__ == cls.__name__:
                buf.write_u32(tag)
                self._write_payload(buf, gate, common)
                return
        raise SerializationError(f"unsupported gate {gate.id()}")

    def read_gate(self, buf: Buffer, common):
        registry = self._registry()
        tag = buf.read_u32()
        if tag >= len(registry):
            raise SerializationError(f"bad gate tag {tag}")
        return self._read_payload(buf, registry[tag], common)

    def _write_payload(self, buf: Buffer, gate, common) -> None:
        name = type(gate).__name__
        if name in ("ArithmeticGate", "ArithmeticExtensionGate", "MulExtensionGate"):
            buf.write_usize(gate.num_ops)
        elif name == "BaseSumGate":
            # reference serializes BaseSumGate<2>: base fixed by the type
            if gate.base != 2:
                raise SerializationError("only BaseSumGate<2> is serializable")
            buf.write_usize(gate.num_limbs)
        elif name == "ConstantGate":
            buf.write_usize(gate.num_consts)
        elif name == "CosetInterpolationGate":
            weights = _coset_gate_weights(gate.subgroup_bits)
            buf.write_usize(gate.subgroup_bits)
            buf.write_usize(gate.max_degree)
            buf.write_usize(len(weights))
            buf.write_field_vec(weights)
        elif name == "ExponentiationGate":
            buf.write_usize(gate.num_power_bits)
        elif name == "LookupGate":
            buf.write_usize(gate.num_slots)
            for i, lut in enumerate(common.luts):
                if tuple(lut) == tuple(gate.lut):
                    buf.write_usize(i)
                    buf.write_all(_lut_keccak(gate.lut))
                    return
            raise SerializationError("lookup gate's table is not in common.luts")
        elif name == "LookupTableGate":
            buf.write_usize(gate.num_slots)
            buf.write_usize(gate.last_lut_row)
            for i, lut in enumerate(common.luts):
                if tuple(lut) == tuple(gate.lut):
                    buf.write_usize(i)
                    buf.write_all(_lut_keccak(gate.lut))
                    return
            raise SerializationError("lookup table gate's table is not in common.luts")
        elif name in (
            "NoopGate",
            "PoseidonMdsGate",
            "PoseidonGate",
            "Poseidon2MdsGate",
            "Poseidon2IntMixGate",
            "Poseidon2Gate",
            "PublicInputGate",
        ):
            pass
        elif name == "RandomAccessGate":
            buf.write_usize(gate.bits)
            buf.write_usize(gate.num_copies)
            buf.write_usize(gate.num_extra_constants)
        elif name in ("ReducingExtensionGate", "ReducingGate"):
            buf.write_usize(gate.num_coeffs)
        else:
            raise SerializationError(f"no payload writer for {name}")

    def _read_payload(self, buf: Buffer, cls, common):
        name = cls.__name__
        if name in ("ArithmeticGate", "ArithmeticExtensionGate", "MulExtensionGate"):
            return cls(buf.read_usize())
        if name == "BaseSumGate":
            return cls(num_limbs=buf.read_usize(), base=2)
        if name == "ConstantGate":
            return cls(buf.read_usize())
        if name == "CosetInterpolationGate":
            subgroup_bits = buf.read_usize()
            degree = buf.read_usize()
            wlen = buf.read_usize()
            weights = buf.read_field_vec(wlen)
            gate = cls(subgroup_bits, degree)
            if _coset_gate_weights(subgroup_bits) != list(weights):
                raise SerializationError("barycentric weight mismatch")
            return gate
        if name == "ExponentiationGate":
            return cls(buf.read_usize())
        if name == "LookupGate":
            num_slots = buf.read_usize()
            lut_index = buf.read_usize()
            lut_hash = buf.read_exact(32)
            lut = common.luts[lut_index]
            if _lut_keccak(lut) != lut_hash:
                raise SerializationError("lut hash mismatch")
            return cls(num_slots, tuple(lut))
        if name == "LookupTableGate":
            num_slots = buf.read_usize()
            last_lut_row = buf.read_usize()
            lut_index = buf.read_usize()
            lut_hash = buf.read_exact(32)
            lut = common.luts[lut_index]
            if _lut_keccak(lut) != lut_hash:
                raise SerializationError("lut hash mismatch")
            return cls(num_slots, tuple(lut), last_lut_row)
        if name in (
            "NoopGate",
            "PoseidonMdsGate",
            "PoseidonGate",
            "Poseidon2MdsGate",
            "Poseidon2IntMixGate",
            "Poseidon2Gate",
            "PublicInputGate",
        ):
            return cls()
        if name == "RandomAccessGate":
            bits = buf.read_usize()
            num_copies = buf.read_usize()
            num_extra_constants = buf.read_usize()
            return cls(bits, num_copies, num_extra_constants)
        if name in ("ReducingExtensionGate", "ReducingGate"):
            return cls(buf.read_usize())
        raise SerializationError(f"no payload reader for {name}")


# ---------------------------------------------------------------------------
# Top-level helpers (circuit_data.rs:85-120, proof.rs to_bytes/from_bytes)
# ---------------------------------------------------------------------------


def proof_to_bytes(pwp, common) -> bytes:
    buf = Buffer()
    buf.write_proof_with_public_inputs(pwp, common)
    return buf.bytes()


def proof_from_bytes(data: bytes, common):
    buf = Buffer(data)
    pwp = buf.read_proof_with_public_inputs(common)
    if buf.remaining():
        raise SerializationError("trailing bytes")
    return pwp


def common_data_to_bytes(common, gate_serializer=None) -> bytes:
    buf = Buffer()
    buf.write_common_circuit_data(common, gate_serializer)
    return buf.bytes()


def common_data_from_bytes(data: bytes, gate_serializer=None):
    buf = Buffer(data)
    common = buf.read_common_circuit_data(gate_serializer)
    if buf.remaining():
        raise SerializationError("trailing bytes")
    return common


def verifier_data_to_bytes(verifier_only, common, gate_serializer=None) -> bytes:
    buf = Buffer()
    buf.write_verifier_circuit_data(verifier_only, common, gate_serializer)
    return buf.bytes()


def verifier_data_from_bytes(data: bytes, gate_serializer=None):
    buf = Buffer(data)
    out = buf.read_verifier_circuit_data(gate_serializer)
    if buf.remaining():
        raise SerializationError("trailing bytes")
    return out


# ---------------------------------------------------------------------------
# Prover-only and full circuit data (mod.rs:877-1010, 1897-1990): a circuit
# checkpoint. The constants/sigmas PolynomialBatch is written as its
# coefficient matrix; its LDE and Merkle tree are rebuilt on load, on the
# device asked for. The matrices go in and out as whole arrays, in the
# bytes the per-element writers give.
# ---------------------------------------------------------------------------


def prover_data_to_bytes(prover_only, common, generator_serializer=None) -> bytes:
    from .generator_serialization import DefaultGeneratorSerializer, _write_target

    gs = generator_serializer or DefaultGeneratorSerializer()
    buf = Buffer()
    buf.write_usize(len(prover_only.generators))
    for g in prover_only.generators:
        gs.write_generator(buf, g, common)
    buf.write_usize(len(prover_only.generator_indices_by_watches))
    for k in sorted(prover_only.generator_indices_by_watches):
        buf.write_usize(k)
        buf.write_usize_vec(prover_only.generator_indices_by_watches[k])
    commitment = prover_only.constants_sigmas_commitment
    # the wire format carries the true polynomial count: a mesh's zero
    # padding is not written; sharded coefficients come a part at a time
    coeffs = commitment.coeffs_u64()
    buf.write_usize(coeffs.shape[0])
    buf.write_usize(coeffs.shape[1])
    buf.write_field_array(coeffs)
    sig = np.asarray(prover_only.sigmas, dtype=np.uint64)
    buf.write_usize(sig.shape[0])
    buf.write_usize(sig.shape[1])
    buf.write_field_array(sig)
    buf.write_usize(len(prover_only.subgroup))
    buf.write_field_array(prover_only.subgroup)
    buf.write_usize(len(prover_only.public_inputs))
    for t in prover_only.public_inputs:
        _write_target(buf, t)
    buf.write_usize_vec(prover_only.representative_map)
    buf.write_hash(prover_only.circuit_digest)
    buf.write_usize(len(prover_only.lookup_rows))
    for a, b, c in prover_only.lookup_rows:
        buf.write_usize(a)
        buf.write_usize(b)
        buf.write_usize(c)
    buf.write_usize(len(prover_only.lut_to_lookups))
    for pairs in prover_only.lut_to_lookups:
        buf.write_usize(len(pairs))
        for ti, to in pairs:
            _write_target(buf, ti)
            _write_target(buf, to)
    return buf.bytes()


def prover_data_from_bytes(data: bytes, common, generator_serializer=None,
                           device=None, hasher=None):
    """The prover data of ``data``, its constants/sigmas commitment rebuilt
    on ``device`` (None = the GPU, as for prove) by the commit kernels.
    The bytes do not name the circuit's Merkle hasher: ``hasher`` is it
    (None = Poseidon; ``gc.hasher`` of the config the circuit was built
    and is proven under). circuit_data_from_bytes checks the rebuilt cap
    against the verifier data's."""
    from ..fri.oracle import PolynomialBatch
    from ..plonk.circuit_data import ProverOnlyCircuitData
    from .generator_serialization import DefaultGeneratorSerializer, _read_target

    gs = generator_serializer or DefaultGeneratorSerializer()
    buf = Buffer(data)
    generators = [gs.read_generator(buf, common) for _ in range(buf.read_usize())]
    watches = {}
    for _ in range(buf.read_usize()):
        k = buf.read_usize()
        watches[k] = buf.read_usize_vec()
    m = buf.read_usize()
    n = buf.read_usize()
    coeffs = buf.read_field_array(m * n).reshape(m, n)
    sr = buf.read_usize()
    sc = buf.read_usize()
    sigmas = buf.read_field_array(sr * sc).reshape(sr, sc)
    subgroup = buf.read_field_array(buf.read_usize())
    public_inputs = [_read_target(buf) for _ in range(buf.read_usize())]
    representative_map = buf.read_usize_array(buf.read_usize()).astype(np.int64)
    circuit_digest = buf.read_hash()
    lookup_rows = [
        (buf.read_usize(), buf.read_usize(), buf.read_usize())
        for _ in range(buf.read_usize())
    ]
    lut_to_lookups = []
    for _ in range(buf.read_usize()):
        lut_to_lookups.append(
            [(_read_target(buf), _read_target(buf)) for _ in range(buf.read_usize())]
        )
    if buf.remaining():
        raise SerializationError("trailing bytes")
    commitment = PolynomialBatch.from_coeffs(
        coeffs,
        common.config.fri_config.rate_bits,
        False,
        common.config.fri_config.cap_height,
        hasher=hasher,
        device=device,
    )
    return ProverOnlyCircuitData(
        generators=generators,
        generator_indices_by_watches=watches,
        constants_sigmas_commitment=commitment,
        sigmas=sigmas,
        subgroup=subgroup,
        public_inputs=public_inputs,
        representative_map=representative_map,
        circuit_digest=circuit_digest,
        lookup_rows=lookup_rows,
        lut_to_lookups=lut_to_lookups,
    )


def circuit_data_to_bytes(data, gate_serializer=None, generator_serializer=None) -> bytes:
    """Full CircuitData checkpoint: common ‖ prover_only ‖ verifier_only
    (circuit_data.rs:85-120 to_bytes)."""
    buf = Buffer()
    buf.write_common_circuit_data(data.common, gate_serializer)
    pb = prover_data_to_bytes(data.prover_only, data.common, generator_serializer)
    buf.write_usize(len(pb))
    buf.write_all(pb)
    buf.write_verifier_only_circuit_data(data.verifier_only)
    return buf.bytes()


def circuit_data_from_bytes(data: bytes, gate_serializer=None, generator_serializer=None,
                            device=None, hasher=None):
    """A circuit checkpoint back as CircuitData, ready to prove on ``device``
    (None = the GPU). ``hasher`` is the circuit's Merkle hasher (None =
    Poseidon), as for prover_data_from_bytes: a constants/sigmas cap
    rebuilt under another hasher than the verifier data's is refused."""
    from ..plonk.circuit_data import CircuitData

    buf = Buffer(data)
    common = buf.read_common_circuit_data(gate_serializer)
    prover_bytes = buf.read_exact(buf.read_usize())
    verifier_only = buf.read_verifier_only_circuit_data()
    if buf.remaining():
        raise SerializationError("trailing bytes")
    prover_only = prover_data_from_bytes(
        prover_bytes, common, generator_serializer, device=device, hasher=hasher
    )
    cap = prover_only.constants_sigmas_commitment.cap_u64()
    if not np.array_equal(cap, verifier_only.constants_sigmas_cap):
        raise SerializationError(
            "the rebuilt constants/sigmas cap differs from the verifier data's: "
            f"the circuit was not committed under the {getattr(hasher, 'name', 'poseidon')} "
            "hasher (pass the circuit config's hasher)"
        )
    return CircuitData(prover_only=prover_only, verifier_only=verifier_only, common=common)


# ---------------------------------------------------------------------------
# A proof with its circuit's data in one blob: common data, verifier data
# and proof, each behind its length as 8 little-endian bytes (the format of
# tests/golden/bench_inner_2^12.bin, which the JAX package's benchmark
# writes).
# ---------------------------------------------------------------------------


def int_tree(x):
    """A proof's dataclass tree as nested lists of ints (numpy arrays
    flattened, tuples as lists, None kept): the form in which the JSON
    goldens of batch proofs (tests/golden/torch_batch_*.json) hold a proof
    of either package, field by field in declaration order."""
    if dataclasses.is_dataclass(x):
        return [int_tree(getattr(x, f.name)) for f in dataclasses.fields(x)]
    if isinstance(x, np.ndarray):
        return [int(v) for v in x.reshape(-1)]
    if isinstance(x, (list, tuple)):
        return [int_tree(v) for v in x]
    if x is None or isinstance(x, bool):
        return x
    return int(x)


def fri_proof_from_int_tree(t) -> FriProof:
    """The FriProof whose int_tree is ``t`` (caps as [2^h, 4] u64 arrays)."""
    caps, rounds, final_poly, pow_witness = t
    return FriProof(
        commit_phase_merkle_caps=[np.array(c, dtype=np.uint64).reshape(-1, 4) for c in caps],
        query_round_proofs=[
            FriQueryRound(
                initial_trees_proof=FriInitialTreeProof(
                    evals_proofs=[
                        (list(evals), MerkleProof([tuple(s) for s in mp[0]]))
                        for evals, mp in init[0]
                    ]
                ),
                steps=[
                    FriQueryStep(
                        evals=[tuple(e) for e in evals],
                        merkle_proof=MerkleProof([tuple(s) for s in mp[0]]),
                    )
                    for evals, mp in steps
                ],
            )
            for init, steps in rounds
        ],
        final_poly=[tuple(c) for c in final_poly],
        pow_witness=pow_witness,
    )


def stark_proof_from_int_tree(t):
    """The StarkProofWithPublicInputs whose int_tree is ``t``: auxiliary
    polynomials and CTL openings where the proof has them (None kept)."""
    from ..stark.proof import StarkOpeningSet, StarkProof, StarkProofWithPublicInputs

    def cap(c):
        return None if c is None else np.array(c, dtype=np.uint64).reshape(-1, 4)

    def exts(v):
        return None if v is None else [tuple(e) for e in v]

    (trace_cap, aux_cap, quotient_cap, o, fri), pis = t
    local, nxt, aux, aux_next, ctl_zs_first, quotient = o
    return StarkProofWithPublicInputs(
        StarkProof(
            trace_cap=cap(trace_cap),
            auxiliary_polys_cap=cap(aux_cap),
            quotient_polys_cap=cap(quotient_cap),
            openings=StarkOpeningSet(
                local_values=exts(local),
                next_values=exts(nxt),
                auxiliary_polys=exts(aux),
                auxiliary_polys_next=exts(aux_next),
                ctl_zs_first=None if ctl_zs_first is None else list(ctl_zs_first),
                quotient_polys=exts(quotient),
            ),
            opening_proof=fri_proof_from_int_tree(fri),
        ),
        list(pis),
    )


def parts_from_bytes(data: bytes) -> List[bytes]:
    parts, pos = [], 0
    while pos < len(data):
        if pos + 8 > len(data):
            raise SerializationError("truncated part length")
        n = int.from_bytes(data[pos:pos + 8], "little")
        if pos + 8 + n > len(data):
            raise SerializationError("truncated part")
        parts.append(data[pos + 8:pos + 8 + n])
        pos += 8 + n
    return parts


def parts_to_bytes(parts: Sequence[bytes]) -> bytes:
    return b"".join(len(p).to_bytes(8, "little") + p for p in parts)


def proof_tuple_from_bytes(data: bytes, gate_serializer=None):
    """(proof with public inputs, verifier data, common data)."""
    cd_b, vd_b, proof_b = parts_from_bytes(data)
    common = common_data_from_bytes(cd_b, gate_serializer)
    verifier_only, _ = verifier_data_from_bytes(vd_b, gate_serializer)
    return proof_from_bytes(proof_b, common), verifier_only, common


def proof_tuple_to_bytes(pwp, verifier_only, common, gate_serializer=None) -> bytes:
    return parts_to_bytes([
        common_data_to_bytes(common, gate_serializer),
        verifier_data_to_bytes(verifier_only, common, gate_serializer),
        proof_to_bytes(pwp, common),
    ])


# ---------------------------------------------------------------------------
# Compressed proofs (mod.rs read_compressed_proof / fri_proof.rs:85-290).
# Compressed structures have variable-length paths/evals (dedup +
# inferable-eval removal), so lengths are written explicitly.
# ---------------------------------------------------------------------------


def _write_var_merkle_proof(buf: Buffer, proof: MerkleProof) -> None:
    buf.write_u8(len(proof.siblings))
    for sib in proof.siblings:
        buf.write_hash(sib)


def compressed_proof_to_bytes(cpwp, common) -> bytes:
    buf = Buffer()
    p = cpwp.proof
    buf.write_merkle_cap(p.wires_cap)
    buf.write_merkle_cap(p.plonk_zs_partial_products_cap)
    buf.write_merkle_cap(p.quotient_polys_cap)
    buf.write_opening_set(p.openings, common)
    f = p.opening_proof
    for cap in f.commit_phase_merkle_caps:
        buf.write_merkle_cap(cap)
    qr = f.query_round_proofs
    buf.write_usize_vec(qr.indices)
    for idx in sorted(qr.initial_trees_proofs):
        itp = qr.initial_trees_proofs[idx]
        for vals, proof in itp.evals_proofs:
            buf.write_usize(len(vals))
            buf.write_field_vec(vals)
            _write_var_merkle_proof(buf, proof)
    for step_map in qr.steps:
        buf.write_usize(len(step_map))
        for idx in sorted(step_map):
            step = step_map[idx]
            buf.write_usize(idx)
            buf.write_usize(len(step.evals))
            buf.write_field_ext_vec(step.evals)
            _write_var_merkle_proof(buf, step.merkle_proof)
    buf.write_usize(len(f.final_poly))
    buf.write_field_ext_vec(f.final_poly)
    buf.write_field(f.pow_witness)
    buf.write_usize(len(cpwp.public_inputs))
    buf.write_field_vec(cpwp.public_inputs)
    return buf.bytes()


def compressed_proof_from_bytes(data: bytes, common):
    from ..fri.compress import CompressedFriProof, CompressedFriQueryRounds
    from ..plonk.compressed_proof import (
        CompressedProof,
        CompressedProofWithPublicInputs,
    )

    buf = Buffer(data)
    h = common.config.fri_config.cap_height
    wires_cap = buf.read_merkle_cap(h)
    zs_cap = buf.read_merkle_cap(h)
    q_cap = buf.read_merkle_cap(h)
    openings = buf.read_opening_set(common)
    caps = [
        buf.read_merkle_cap(h) for _ in common.fri_params.reduction_arity_bits
    ]
    indices = buf.read_usize_vec()
    uniq = sorted(set(indices))
    initial = {}
    for idx in uniq:
        evals_proofs = []
        for _ in range(4):
            vals = buf.read_field_vec(buf.read_usize())
            proof = buf.read_merkle_proof()
            evals_proofs.append((vals, proof))
        initial[idx] = FriInitialTreeProof(evals_proofs=evals_proofs)
    steps = []
    for _ in common.fri_params.reduction_arity_bits:
        step_map = {}
        for _ in range(buf.read_usize()):
            idx = buf.read_usize()
            evals = buf.read_field_ext_vec(buf.read_usize())
            mp = buf.read_merkle_proof()
            step_map[idx] = FriQueryStep(evals=evals, merkle_proof=mp)
        steps.append(step_map)
    final_poly = buf.read_field_ext_vec(buf.read_usize())
    pow_witness = buf.read_field()
    pis = buf.read_field_vec(buf.read_usize())
    if buf.remaining():
        raise SerializationError("trailing bytes")
    fri = CompressedFriProof(
        commit_phase_merkle_caps=caps,
        query_round_proofs=CompressedFriQueryRounds(
            indices=indices, initial_trees_proofs=initial, steps=steps
        ),
        final_poly=final_poly,
        pow_witness=pow_witness,
    )
    return CompressedProofWithPublicInputs(
        CompressedProof(
            wires_cap=wires_cap,
            plonk_zs_partial_products_cap=zs_cap,
            quotient_polys_cap=q_cap,
            openings=openings,
            opening_proof=fri,
        ),
        pis,
    )

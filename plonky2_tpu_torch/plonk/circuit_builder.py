"""Circuit construction DSL + build() pipeline
(reference: plonky2/src/plonk/circuit_builder.rs:144-1460 and
plonk/permutation_argument.rs)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..field import goldilocks as gl
from ..fri.oracle import PolynomialBatch
from ..gates.basic import ArithmeticGate, ConstantGate, NoopGate, PublicInputGate
from ..gates.lookup import LookupGate, LookupTableGate
from ..gates.gate import Gate, GateInstance, selector_polynomials
from ..hash import poseidon as hp
from ..iop.generator import ConstantGenerator, CopyGenerator, SimpleGenerator
from ..iop.target import Target
from ..ops import gf
from ..utils.bits import log2_ceil, log2_strict
from .circuit_data import (
    CircuitData,
    CommonCircuitData,
    ProverOnlyCircuitData,
    VerifierOnlyCircuitData,
)
from .config import CircuitConfig
from .gadgets import GadgetMixin


class Forest:
    """Union-find over wire + virtual targets
    (plonk/permutation_argument.rs:13-90)."""

    def __init__(self, num_wires: int, degree: int, num_virtual: int):
        self.num_wires = num_wires
        self.degree = degree
        self.parents = list(range(num_wires * degree + num_virtual))

    def target_index(self, t: Target) -> int:
        return t.flat_index(self.num_wires, self.degree)

    def find(self, x: int) -> int:
        root = x
        while self.parents[root] != root:
            root = self.parents[root]
        while self.parents[x] != x:
            self.parents[x], x = root, self.parents[x]
        return root

    def merge(self, tx: Target, ty: Target) -> None:
        x = self.find(self.target_index(tx))
        y = self.find(self.target_index(ty))
        if x != y:
            self.parents[y] = x

    def compress_paths(self) -> None:
        for i in range(len(self.parents)):
            self.find(i)

    def wire_partition(self, num_routed: int) -> Dict[int, List[Tuple[int, int]]]:
        """representative -> [(row, col)] over routed wires only."""
        part: Dict[int, List[Tuple[int, int]]] = {}
        for row in range(self.degree):
            base = row * self.num_wires
            for col in range(num_routed):
                rep = self.parents[base + col]
                part.setdefault(rep, []).append((row, col))
        return part


def sigma_polys_from_partition(
    partition: Dict[int, List[Tuple[int, int]]],
    degree: int,
    k_is: List[int],
    subgroup: np.ndarray,
) -> np.ndarray:
    """sigma polynomial values [num_routed, degree]
    (permutation_argument.rs:90-155): sigma(wire) = k_{next.col} * subgroup[next.row]
    where `next` cycles within the wire's copy class."""
    num_routed = len(k_is)
    sigma = np.zeros((num_routed, degree), dtype=np.uint64)
    k_np = np.array(k_is, dtype=np.uint64)
    for cls in partition.values():
        m = len(cls)
        for i, (row, col) in enumerate(cls):
            nrow, ncol = cls[(i + 1) % m]
            sigma[col, row] = gl.gmul(k_is[ncol], int(subgroup[nrow]))
    return sigma


class CircuitBuilder(GadgetMixin):
    def __init__(self, config: Optional[CircuitConfig] = None):
        self.config = config or CircuitConfig.standard_recursion_config()
        self.gate_instances: List[GateInstance] = []
        self.gates: Dict[str, Gate] = {}
        self.copy_constraints: List[Tuple[Target, Target]] = []
        self.constants_to_targets: Dict[int, Target] = {}
        self.targets_to_constants: Dict[Target, int] = {}
        self.public_inputs: List[Target] = []
        self.virtual_target_index = 0
        self.simple_generators: List[SimpleGenerator] = []
        self.constant_generators: List[ConstantGenerator] = []
        # (gate_id, params) -> (row, next_slot)
        self.current_slots: Dict[Tuple[str, Tuple[int, ...]], Tuple[int, int]] = {}
        self.domain_separator: List[int] = []
        # lookups (gadgets/lookup.rs, circuit_builder.rs:78-90)
        self.luts: List[Tuple[Tuple[int, int], ...]] = []
        self.lut_to_lookups: List[List[Tuple[Target, Target]]] = []
        self.lookup_rows: List[Tuple[int, int, int]] = []  # (last_lu, last_lut, first_lut)
        # context tree for labeled gate counts (util/context_tree.rs)
        self.context_stack: List[str] = []
        self.gate_counts_by_context: Dict[Tuple[str, ...], Dict[str, int]] = {}

    # -- targets ------------------------------------------------------------

    def add_virtual_target(self) -> Target:
        t = Target.virtual(self.virtual_target_index)
        self.virtual_target_index += 1
        return t

    def add_virtual_targets(self, n: int) -> List[Target]:
        return [self.add_virtual_target() for _ in range(n)]

    def register_public_input(self, t: Target) -> None:
        self.public_inputs.append(t)

    def register_public_inputs(self, ts) -> None:
        for t in ts:
            self.register_public_input(t)

    def add_virtual_public_input(self) -> Target:
        t = self.add_virtual_target()
        self.register_public_input(t)
        return t

    # -- gates ---------------------------------------------------------------

    def num_gates(self) -> int:
        return len(self.gate_instances)

    def add_gate(self, gate: Gate, constants: List[int]) -> int:
        assert gate.num_wires() <= self.config.num_wires
        assert len(constants) <= gate.num_constants()
        constants = list(constants) + [0] * (gate.num_constants() - len(constants))
        row = len(self.gate_instances)
        for constant_index, wire_index in gate.extra_constant_wires():
            self.constant_generators.append(
                ConstantGenerator(row, constant_index, wire_index, 0)
            )
        self.gates[gate.id()] = gate
        self.gate_instances.append(GateInstance(gate, constants))
        ctx = tuple(self.context_stack)
        by = self.gate_counts_by_context.setdefault(ctx, {})
        by[gate.id()] = by.get(gate.id(), 0) + 1
        return row

    def add_gate_to_gate_set(self, gate: Gate) -> None:
        """Register a gate type without instantiating a row (dummy
        circuits must match another circuit's gate set)."""
        self.gates[gate.id()] = gate

    def find_slot(
        self, gate, params: List[int], constants: List[int]
    ) -> Tuple[int, int]:
        """Gate-slot packing (circuit_builder.rs:824-851)."""
        key = (gate.id(), tuple(params))
        num_ops = getattr(gate, "num_ops", None)
        if num_ops is None:
            num_ops = gate.num_copies  # RandomAccessGate
        if key in self.current_slots:
            row, slot = self.current_slots[key]
        else:
            row, slot = self.add_gate(gate, constants), 0
        if slot == num_ops - 1:
            self.current_slots.pop(key, None)
        else:
            self.current_slots[key] = (row, slot + 1)
        return row, slot

    # -- lookups (gadgets/lookup.rs) ------------------------------------------

    def add_lookup_table_from_pairs(self, pairs) -> int:
        lut = tuple((int(i) & 0xFFFF, int(o) & 0xFFFF) for i, o in pairs)
        assert lut, "empty LUTs are not supported"
        for idx, existing in enumerate(self.luts):
            if existing == lut:
                return idx
        self.luts.append(lut)
        self.lut_to_lookups.append([])
        return len(self.luts) - 1

    def add_lookup_table_from_table(self, inps, outs) -> int:
        return self.add_lookup_table_from_pairs(list(zip(inps, outs)))

    def add_lookup_table_from_fn(self, f, inputs) -> int:
        return self.add_lookup_table_from_pairs([(i, f(i)) for i in inputs])

    def add_lookup_from_index(self, looking_in: Target, lut_index: int) -> Target:
        assert lut_index < len(self.luts)
        looking_out = self.add_virtual_target()
        self.lut_to_lookups[lut_index].append((looking_in, looking_out))
        return looking_out

    def add_all_lookups(self) -> None:
        """Places LookupGates + LookupTableGates per LUT, rows deliberately
        "upside down" (gadgets/lookup.rs:80-156)."""
        for lut_index, lut in enumerate(self.luts):
            lookups = self.lut_to_lookups[lut_index]
            assert lookups, f"LUT {lut_index} is unused"
            last_lu_gate = self.num_gates()
            gate = LookupGate.new_from_table(self.config, lut)
            num_slots = gate.num_slots
            full, rem = divmod(len(lookups), num_slots)
            for chunk_idx in range(full):
                row = self.add_gate(gate, [])
                for i, (lin, lout) in enumerate(
                    lookups[chunk_idx * num_slots : (chunk_idx + 1) * num_slots]
                ):
                    self.connect(lin, Target.wire(row, LookupGate.wire_ith_looking_inp(i)))
                    self.connect(lout, Target.wire(row, LookupGate.wire_ith_looking_out(i)))
            for (lin, lout) in lookups[full * num_slots :]:
                row, i = self.find_slot(gate, [lut_index], [])
                self.connect(lin, Target.wire(row, LookupGate.wire_ith_looking_inp(i)))
                self.connect(lout, Target.wire(row, LookupGate.wire_ith_looking_out(i)))

            last_lut_gate = self.num_gates()
            num_lut_entries = LookupTableGate.num_slots_from_config(self.config)
            num_lut_rows = (len(lut) - 1) // num_lut_entries + 1
            tgate = LookupTableGate.new_from_table(self.config, lut, last_lut_gate)
            for _ in range(num_lut_rows):
                self.add_gate(tgate, [])
            first_lut_gate = self.num_gates() - 1
            # all-zero next row: unifies first-row and transition constraints
            self.add_gate(NoopGate(), [])
            self.lookup_rows.append((last_lu_gate, last_lut_gate, first_lut_gate))

    def push_context(self, name: str) -> None:
        self.context_stack.append(name)

    def pop_context(self) -> None:
        self.context_stack.pop()

    def print_gate_counts(self) -> str:
        lines = []
        for ctx, by in sorted(self.gate_counts_by_context.items()):
            label = "/".join(ctx) or "(root)"
            total = sum(by.values())
            lines.append(f"{label}: {total} gates")
            for gid, cnt in sorted(by.items(), key=lambda kv: -kv[1]):
                lines.append(f"  {cnt:6d} x {gid[:60]}")
        return "\n".join(lines)

    # -- copy constraints / constants ----------------------------------------

    def connect(self, x: Target, y: Target) -> None:
        assert x.is_routable(self.config) and y.is_routable(self.config)
        self.copy_constraints.append((x, y))

    def generate_copy(self, src: Target, dst: Target) -> None:
        self.simple_generators.append(CopyGenerator(src, dst))

    def add_simple_generator(self, g: SimpleGenerator) -> None:
        self.simple_generators.append(g)

    def constant(self, c: int) -> Target:
        c %= gl.P
        if c in self.constants_to_targets:
            return self.constants_to_targets[c]
        t = self.add_virtual_target()
        self.constants_to_targets[c] = t
        self.targets_to_constants[t] = c
        return t

    def zero(self) -> Target:
        return self.constant(0)

    def one(self) -> Target:
        return self.constant(1)

    def two(self) -> Target:
        return self.constant(2)

    def neg_one(self) -> Target:
        return self.constant(gl.P - 1)

    def target_as_constant(self, t: Target) -> Optional[int]:
        return self.targets_to_constants.get(t)

    # -- arithmetic gadgets (gadgets/arithmetic.rs) ---------------------------

    def arithmetic(self, const_0: int, const_1: int, x: Target, y: Target, z: Target) -> Target:
        """returns const_0*x*y + const_1*z, with constant folding."""
        cx, cy, cz = (
            self.target_as_constant(x),
            self.target_as_constant(y),
            self.target_as_constant(z),
        )
        if cx is not None and cy is not None and cz is not None:
            return self.constant(
                gl.gadd(gl.gmul(gl.gmul(cx, cy), const_0 % gl.P), gl.gmul(cz, const_1 % gl.P))
            )
        gate = ArithmeticGate.new_from_config(self.config)
        row, i = self.find_slot(gate, [const_0 % gl.P, const_1 % gl.P], [const_0 % gl.P, const_1 % gl.P])
        self.connect(x, Target.wire(row, ArithmeticGate.wire_ith_multiplicand_0(i)))
        self.connect(y, Target.wire(row, ArithmeticGate.wire_ith_multiplicand_1(i)))
        self.connect(z, Target.wire(row, ArithmeticGate.wire_ith_addend(i)))
        return Target.wire(row, ArithmeticGate.wire_ith_output(i))

    def mul(self, x: Target, y: Target) -> Target:
        return self.arithmetic(1, 0, x, y, x)

    def add(self, x: Target, y: Target) -> Target:
        one = self.one()
        return self.arithmetic(1, 1, x, one, y)

    def sub(self, x: Target, y: Target) -> Target:
        one = self.one()
        return self.arithmetic(1, gl.P - 1, x, one, y)

    def mul_add(self, x: Target, y: Target, z: Target) -> Target:
        return self.arithmetic(1, 1, x, y, z)

    def mul_const(self, c: int, x: Target) -> Target:
        one = self.one()
        return self.arithmetic(c, 0, x, one, x)

    def add_const(self, x: Target, c: int) -> Target:
        one = self.one()
        return self.arithmetic(1, c, one, x, one)

    def square(self, x: Target) -> Target:
        return self.mul(x, x)

    def assert_zero(self, x: Target) -> None:
        self.connect(x, self.zero())

    def assert_one(self, x: Target) -> None:
        self.connect(x, self.one())


    # -- public-input hashing --------------------------------------------------

    def hash_n_to_hash_no_pad(self, inputs: List[Target]) -> List[Target]:
        """In-circuit overwrite-mode Poseidon sponge (gadgets/hash.rs)."""
        if not inputs:
            z = self.zero()
            return [z, z, z, z]

        state = [self.zero()] * hp.SPONGE_WIDTH
        for start in range(0, len(inputs), hp.SPONGE_RATE):
            chunk = inputs[start : start + hp.SPONGE_RATE]
            for i, inp in enumerate(chunk):
                state[i] = inp
            state = self.permute_poseidon(state)
        return state[:4]

    def permute_poseidon(self, state: List[Target]) -> List[Target]:
        from ..gates.poseidon import PoseidonGate

        gate = PoseidonGate()
        row = self.add_gate(gate, [])
        swap_wire = Target.wire(row, PoseidonGate.WIRE_SWAP)
        self.connect(swap_wire, self.zero())
        for i in range(hp.SPONGE_WIDTH):
            self.connect(state[i], Target.wire(row, PoseidonGate.wire_input(i)))
        return [
            Target.wire(row, PoseidonGate.wire_output(i))
            for i in range(hp.SPONGE_WIDTH)
        ]

    def permute_poseidon2(self, state: List[Target]) -> List[Target]:
        """One Poseidon2 permutation via a Poseidon2Gate row
        (hash/poseidon2.rs permute_swapped circuit dual)."""
        from ..gates.poseidon2 import Poseidon2Gate

        gate = Poseidon2Gate()
        row = self.add_gate(gate, [])
        for i in range(hp.SPONGE_WIDTH):
            self.connect(state[i], Target.wire(row, Poseidon2Gate.wire_input(i)))
        return [
            Target.wire(row, Poseidon2Gate.wire_output(i))
            for i in range(hp.SPONGE_WIDTH)
        ]

    def hash_n_to_hash_no_pad_p2(self, inputs: List[Target]) -> List[Target]:
        """In-circuit Poseidon2 pad10 additive sponge
        (core/src/hashing.rs:171-180 hash_n_to_hash_no_pad_p2): append 1,
        zero-fill to a rate multiple, absorb additively from the zero
        state, squeeze without a trailing permute."""
        one = self.constant(1)
        zero = self.zero()
        msg = list(inputs) + [one]
        while len(msg) % hp.SPONGE_RATE:
            msg.append(zero)
        state = [zero] * hp.SPONGE_WIDTH
        for start in range(0, len(msg), hp.SPONGE_RATE):
            chunk = msg[start : start + hp.SPONGE_RATE]
            state = [self.add(state[i], chunk[i]) for i in range(len(chunk))] + state[
                len(chunk) :
            ]
            state = self.permute_poseidon2(state)
        return state[:4]

    # -- build ------------------------------------------------------------------

    def pad_to_power_of_two(self) -> None:
        while (len(self.gate_instances) & (len(self.gate_instances) - 1)) != 0 or len(
            self.gate_instances
        ) == 0:
            self.add_gate(NoopGate(), [])

    # -- zero-knowledge blinding (circuit_builder.rs:887-987) ----------------

    def _num_blinding_gates(self, degree_estimate: int) -> Tuple[int, int]:
        """Openings revealed per regular poly / per Z poly at this degree."""
        D = 2
        degree_bits_estimate = log2_strict(degree_estimate)
        fri_queries = self.config.fri_config.num_query_rounds
        params = self.config.fri_config.fri_params(degree_bits_estimate, True)
        arities = [1 << x for x in params.reduction_arity_bits]
        total_folding = sum(a - 1 for a in arities)
        prod = 1
        for a in arities:
            prod *= a
        final_poly_coeffs = degree_estimate // prod
        fri_openings = fri_queries * (1 + D * total_folding + D * final_poly_coeffs)
        return D + fri_openings, 2 * D + fri_openings

    def _blinding_counts(self) -> Tuple[int, int]:
        num_gates = len(self.gate_instances)
        degree_estimate = 1 << log2_ceil(max(num_gates, 1))
        while True:
            regular, zs = self._num_blinding_gates(degree_estimate)
            if num_gates + regular + 2 * zs <= degree_estimate:
                return regular, zs
            degree_estimate *= 2

    def blind(self) -> None:
        """Add random-wire rows so openings don't leak witness data
        (circuit_builder.rs:940-987): one NoopGate per regular opening with
        fully random wires; two linked NoopGates per Z opening."""
        from ..iop.generator import RandomValueGenerator

        regular, zs = self._blinding_counts()
        nw = self.config.num_wires
        nr = self.config.num_routed_wires
        for _ in range(regular):
            row = self.add_gate(NoopGate(), [])
            for w in range(nw):
                self.add_simple_generator(
                    RandomValueGenerator(Target.wire(row, w))
                )
        for _ in range(zs):
            g1 = self.add_gate(NoopGate(), [])
            g2 = self.add_gate(NoopGate(), [])
            for w in range(nr):
                self.add_simple_generator(
                    RandomValueGenerator(Target.wire(g1, w))
                )
                self.generate_copy(Target.wire(g1, w), Target.wire(g2, w))

    def build(self, commit: bool = True, gc=None, device=None) -> CircuitData:
        """commit=False skips the constants/sigmas commitment and digest
        (witness-generation-only flows, tests). gc: GenericConfig hasher
        bundle (the reference's `C` type parameter); default Poseidon.
        device: where the constants/sigmas commitment lives; None means
        the GPU (raises without one), the tests pass "cpu"."""
        from .generic_config import poseidon_goldilocks_config

        gc = gc or poseidon_goldilocks_config()
        config = self.config
        rate_bits = config.fri_config.rate_bits
        cap_height = config.fri_config.cap_height

        # 1. hash public inputs in-circuit; route to PublicInputGate
        # (the sponge gadget follows gc.inner_hasher)
        num_public_inputs = len(self.public_inputs)
        if gc.inner_hasher.name == "poseidon2":
            pi_hash_parts = self.hash_n_to_hash_no_pad_p2(list(self.public_inputs))
        else:
            pi_hash_parts = self.hash_n_to_hash_no_pad(list(self.public_inputs))
        pi_gate = self.add_gate(PublicInputGate(), [])
        for hash_part, wire in zip(
            pi_hash_parts, PublicInputGate.wires_public_inputs_hash()
        ):
            self.connect(hash_part, Target.wire(pi_gate, wire))

        # 1b. place LUT-related gates (circuit_builder.rs:1138)
        self.add_all_lookups()

        # 2. constant gates for all distinct constants
        while len(self.constants_to_targets) > len(self.constant_generators):
            self.add_gate(ConstantGate(config.num_constants), [])

        # 3. assign constants to constant generators (deterministic order)
        items = sorted(self.constants_to_targets.items(), key=lambda kv: kv[0])
        for (c, t), cg in zip(items, self.constant_generators):
            self.gate_instances[cg.row].constants[cg.constant_index] = c
            self.connect(Target.wire(cg.row, cg.wire_index), t)
            cg.constant = c
            self.add_simple_generator(cg)

        # 4. blind (zk), pad, derive sizes (finalize_degree,
        # circuit_builder.rs:989-997)
        if config.zero_knowledge:
            self.blind()
        self.pad_to_power_of_two()
        degree = len(self.gate_instances)
        degree_bits = log2_strict(degree)
        fri_params = config.fri_config.fri_params(degree_bits, config.zero_knowledge)
        quotient_degree_factor = config.max_quotient_degree_factor

        # 5. selectors, constants, sigmas
        gates = sorted(self.gates.values(), key=lambda g: (g.degree(), g.id()))
        selector_vals, selectors_info = selector_polynomials(
            gates, self.gate_instances, quotient_degree_factor + 1
        )
        max_gate_constants = max(g.num_constants() for g in gates)
        constant_vals = [
            np.array(
                [
                    inst.constants[i] if i < len(inst.constants) else 0
                    for inst in self.gate_instances
                ],
                dtype=np.uint64,
            )
            for i in range(max_gate_constants)
        ]
        # lookup selectors (gates/selectors.rs:27-75)
        lookup_selector_vals = []
        if self.luts:
            NUM_BASE_LOOKUP_SELECTORS = 4  # TransSre, TransLdc, InitSre, LastLdc
            sels = [np.zeros(degree, dtype=np.uint64) for _ in range(NUM_BASE_LOOKUP_SELECTORS)]
            for (last_lu, last_lut, first_lut) in self.lookup_rows:
                sels[0][last_lut : first_lut + 1] = 1  # TransSre
                sels[1][last_lu:last_lut] = 1  # TransLdc
                sels[2][first_lut + 1] = 1  # InitSre
                sels[3][last_lu] = 1  # LastLdc
            ends = []
            for (_, last_lut, _) in self.lookup_rows:
                e = np.zeros(degree, dtype=np.uint64)
                e[last_lut] = 1
                ends.append(e)
            lookup_selector_vals = sels + ends
        num_lookup_selectors = len(lookup_selector_vals)

        constant_vecs = list(selector_vals) + lookup_selector_vals + constant_vals
        num_constants = len(constant_vecs)

        lookup_degree = quotient_degree_factor - 1
        num_lookup_polys = (
            0
            if not self.luts
            else -(-LookupGate.num_slots_from_config(config) // lookup_degree) + 1
        )

        subgroup = gl.two_adic_subgroup(degree_bits)
        k_is = [
            int(x) for x in gl.np_powers(gl.MULTIPLICATIVE_GROUP_GENERATOR, config.num_routed_wires)
        ]

        from .permutation import (
            connected_partition,
            flat_indices,
            sigma_polys_vectorized,
        )

        num_nodes = config.num_wires * degree + self.virtual_target_index
        edges_a = flat_indices(
            [x for x, _ in self.copy_constraints], config.num_wires, degree
        )
        edges_b = flat_indices(
            [y for _, y in self.copy_constraints], config.num_wires, degree
        )
        rep_parents = connected_partition(num_nodes, edges_a, edges_b)
        sigma_vecs = sigma_polys_vectorized(
            rep_parents,
            degree,
            config.num_wires,
            config.num_routed_wires,
            k_is,
            subgroup,
        )

        # 6. commit to constants + sigmas
        all_const_sigma = np.stack(
            [np.asarray(v, dtype=np.uint64) for v in constant_vecs]
            + [sigma_vecs[i] for i in range(config.num_routed_wires)]
        )
        constants_sigmas_commitment = (
            PolynomialBatch.from_values(
                gf.from_u64(all_const_sigma, gf.resolve_device(device)),
                rate_bits, False, cap_height, hasher=gc.hasher,
            )
            if commit
            else None
        )

        # 7. gate generators + watch index
        incomplete: Dict[int, int] = {}
        for (gate_id, _params), (row, next_slot) in self.current_slots.items():
            incomplete[row] = next_slot
        generators: List[SimpleGenerator] = []
        for row, inst in enumerate(self.gate_instances):
            gens = inst.gate.generators(row, inst.constants)
            if row in incomplete:
                gens = gens[: incomplete[row]]
            generators.extend(gens)
        generators.extend(self.simple_generators)

        nw = config.num_wires
        by_watches: Dict[int, List[int]] = {}
        for gi, gen in enumerate(generators):
            for watch in gen.watch_list():
                rep = int(rep_parents[watch.flat_index(nw, degree)])
                lst = by_watches.setdefault(rep, [])
                if not lst or lst[-1] != gi:
                    lst.append(gi)

        num_gate_constraints = max(g.num_constraints() for g in gates)
        num_partial_products = (
            -(-config.num_routed_wires // quotient_degree_factor) - 1
        )

        # 8. circuit digest
        cs_cap = (
            constants_sigmas_commitment.cap_u64()
            if commit
            else np.zeros((1 << cap_height, 4), dtype=np.uint64)
        )
        domain_separator_digest = gc.hasher.hash_pad(self.domain_separator)
        digest_inputs = (
            [int(x) for row in cs_cap for x in row]
            + list(domain_separator_digest)
            + [degree_bits]
        )
        circuit_digest = gc.hasher.hash_no_pad(digest_inputs)

        common = CommonCircuitData(
            config=config,
            trace_degree_bits=degree_bits,
            fri_params=fri_params,
            public_initial_degree_bits=fri_params.degree_bits,
            gates=gates,
            selectors_info=selectors_info,
            quotient_degree_factor=quotient_degree_factor,
            num_gate_constraints=num_gate_constraints,
            num_constants=num_constants,
            num_public_inputs=num_public_inputs,
            k_is=k_is,
            num_partial_products=num_partial_products,
            num_lookup_polys=num_lookup_polys,
            num_lookup_selectors=num_lookup_selectors,
            luts=list(self.luts),
        )

        # per-point sigma rows for the partial-products pass
        sigmas_rows = sigma_vecs.T.copy()  # [degree, num_routed]

        prover_only = ProverOnlyCircuitData(
            generators=generators,
            generator_indices_by_watches=by_watches,
            constants_sigmas_commitment=constants_sigmas_commitment,
            sigmas=sigmas_rows,
            subgroup=subgroup,
            public_inputs=self.public_inputs,
            representative_map=rep_parents,
            circuit_digest=circuit_digest,
            gate_instances=self.gate_instances,
            lookup_rows=list(self.lookup_rows),
            lut_to_lookups=[list(l) for l in self.lut_to_lookups],
        )
        verifier_only = VerifierOnlyCircuitData(
            constants_sigmas_cap=cs_cap,
            circuit_digest=circuit_digest,
        )
        return CircuitData(prover_only, verifier_only, common)

"""Circuit data containers and poly-index bookkeeping
(reference: plonky2/src/plonk/circuit_data.rs:337-720)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

import numpy as np

from ..field import extension as ge
from ..field import goldilocks as gl
from ..fri.config import FriParams

if TYPE_CHECKING:  # type-only: fri.oracle pulls torch; the verifier path must not
    from ..fri.oracle import PolynomialBatch
from ..fri.structure import (
    FriBatchInfo,
    FriInstanceInfo,
    FriOracleInfo,
    FriPolynomialInfo,
)
from ..gates.gate import Gate, SelectorsInfo
from .config import CircuitConfig

# PlonkOracle indices + blinding flags (core/src/plonk_common.rs)
ORACLE_CONSTANTS_SIGMAS = 0
ORACLE_WIRES = 1
ORACLE_ZS_PARTIAL_PRODUCTS = 2
ORACLE_QUOTIENT = 3
ORACLE_BLINDING = [False, True, True, True]
SALT_SIZE = 4


@dataclass
class CommonCircuitData:
    config: CircuitConfig
    trace_degree_bits: int
    fri_params: FriParams
    public_initial_degree_bits: int
    gates: List[Gate]
    selectors_info: SelectorsInfo
    quotient_degree_factor: int
    num_gate_constraints: int
    num_constants: int
    num_public_inputs: int
    k_is: List[int]
    num_partial_products: int
    num_lookup_polys: int = 0
    num_lookup_selectors: int = 0
    luts: List = field(default_factory=list)

    @property
    def degree_bits(self) -> int:
        return self.trace_degree_bits

    @property
    def degree(self) -> int:
        return 1 << self.trace_degree_bits

    @property
    def lde_size(self) -> int:
        return self.fri_params.lde_size

    def constraint_degree(self) -> int:
        return max(g.degree() for g in self.gates)

    @property
    def quotient_degree(self) -> int:
        return self.quotient_degree_factor * self.degree

    def permutation_partial_product_degree(self) -> int:
        return self.quotient_degree_factor

    # poly index ranges inside committed batches
    def constants_range(self):
        return range(0, self.num_constants)

    def sigmas_range(self):
        return range(self.num_constants, self.num_constants + self.config.num_routed_wires)

    def zs_range(self):
        return range(0, self.config.num_challenges)

    def partial_products_range(self):
        return range(
            self.config.num_challenges,
            (self.num_partial_products + 1) * self.config.num_challenges,
        )

    def num_preprocessed_polys(self) -> int:
        return self.sigmas_range().stop

    def num_zs_partial_products_polys(self) -> int:
        return self.config.num_challenges * (1 + self.num_partial_products)

    def num_all_lookup_polys(self) -> int:
        return self.config.num_challenges * self.num_lookup_polys

    def num_quotient_polys(self) -> int:
        return self.config.num_challenges * self.quotient_degree_factor

    def lookup_accumulator_degree(self) -> int:
        return self.quotient_degree_factor - 1

    def lookup_zs_all_range(self):
        start = self.num_zs_partial_products_polys()
        return range(start, start + self.num_all_lookup_polys())

    def get_fri_instance(self, zeta: Tuple[int, int]) -> FriInstanceInfo:
        """Two batches: everything at zeta; Zs (+lookups) at g*zeta
        (circuit_data.rs:592-614)."""
        zeta_polys = (
            FriPolynomialInfo.from_range(
                ORACLE_CONSTANTS_SIGMAS, 0, self.num_preprocessed_polys()
            )
            + FriPolynomialInfo.from_range(ORACLE_WIRES, 0, self.config.num_wires)
            + FriPolynomialInfo.from_range(
                ORACLE_ZS_PARTIAL_PRODUCTS, 0, self.num_zs_partial_products_polys()
            )
            + FriPolynomialInfo.from_range(
                ORACLE_QUOTIENT, 0, self.num_quotient_polys()
            )
            + (
                FriPolynomialInfo.from_range(
                    ORACLE_ZS_PARTIAL_PRODUCTS,
                    self.num_zs_partial_products_polys(),
                    self.num_zs_partial_products_polys() + self.num_all_lookup_polys(),
                )
                if self.num_lookup_polys
                else []
            )
        )
        # NOTE: reference order in to_fri_openings: constants|sigmas|wires|zs|
        # partial_products|quotient|lookup_zs — zs and pps are contiguous in
        # the ZS oracle, so the ranges above match exactly.
        g = gl.primitive_root_of_unity(self.degree_bits)
        zeta_next = ge.ext_scalar_mul(zeta, g)
        next_polys = FriPolynomialInfo.from_range(
            ORACLE_ZS_PARTIAL_PRODUCTS, 0, self.config.num_challenges
        ) + (
            FriPolynomialInfo.from_range(
                ORACLE_ZS_PARTIAL_PRODUCTS,
                self.num_zs_partial_products_polys(),
                self.num_zs_partial_products_polys() + self.num_all_lookup_polys(),
            )
            if self.num_lookup_polys
            else []
        )
        return FriInstanceInfo(
            oracles=[
                FriOracleInfo(self.num_preprocessed_polys(), ORACLE_BLINDING[0]),
                FriOracleInfo(self.config.num_wires, ORACLE_BLINDING[1]),
                FriOracleInfo(
                    self.num_zs_partial_products_polys() + self.num_all_lookup_polys(),
                    ORACLE_BLINDING[2],
                ),
                FriOracleInfo(self.num_quotient_polys(), ORACLE_BLINDING[3]),
            ],
            batches=[
                FriBatchInfo.from_polys(tuple(zeta), zeta_polys),
                FriBatchInfo.from_polys(tuple(zeta_next), next_polys),
            ],
        )


@dataclass
class ProverOnlyCircuitData:
    generators: List
    generator_indices_by_watches: Dict[int, List[int]]
    constants_sigmas_commitment: PolynomialBatch
    sigmas: np.ndarray  # u64 [degree, num_routed] (row-major per-point sigma values)
    subgroup: np.ndarray  # u64 [degree]
    public_inputs: List
    representative_map: List[int]
    circuit_digest: Tuple[int, int, int, int]
    gate_instances: List = None  # [GateInstance] per row (witness_check, debugging)
    lookup_rows: List = field(default_factory=list)  # [(last_lu, last_lut, first_lut)]
    lut_to_lookups: List = field(default_factory=list)


@dataclass
class VerifierOnlyCircuitData:
    constants_sigmas_cap: np.ndarray  # [2^cap_height, 4] u64
    circuit_digest: Tuple[int, int, int, int]


@dataclass
class CircuitData:
    prover_only: ProverOnlyCircuitData
    verifier_only: VerifierOnlyCircuitData
    common: CommonCircuitData

    def prove(self, inputs, device=None):
        from .prover import prove

        return prove(self.prover_only, self.common, inputs, device=device)

    def verify(self, proof_with_pis):
        from .verifier import verify

        return verify(proof_with_pis, self.verifier_only, self.common)

"""Circuit configuration (reference: core/src/circuit_config.rs:13-196)."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..fri.config import FriConfig, FriReductionStrategy


@dataclass(frozen=True)
class CircuitConfig:
    num_wires: int = 143
    num_routed_wires: int = 80
    num_constants: int = 2
    use_base_arithmetic_gate: bool = True
    security_bits: int = 100
    num_challenges: int = 2
    zero_knowledge: bool = False
    max_quotient_degree_factor: int = 8
    fri_config: FriConfig = field(
        default_factory=lambda: FriConfig(
            rate_bits=3,
            cap_height=4,
            proof_of_work_bits=16,
            reduction_strategy=FriReductionStrategy.ConstantArityBits(4, 5),
            num_query_rounds=28,
        )
    )

    @staticmethod
    def standard_recursion_config() -> "CircuitConfig":
        return CircuitConfig()

    @staticmethod
    def standard_ecc_config() -> "CircuitConfig":
        return CircuitConfig(num_wires=136)

    @staticmethod
    def standard_recursion_zk_config() -> "CircuitConfig":
        return CircuitConfig(zero_knowledge=True)

    @staticmethod
    def wide_ecc_config() -> "CircuitConfig":
        return CircuitConfig(num_wires=234, num_routed_wires=80)

    def check_valid(self) -> None:
        fri = self.fri_config
        assert self.num_routed_wires <= self.num_wires
        assert self.max_quotient_degree_factor >= 2
        # conjectured security: rate_bits * num_query_rounds + pow_bits
        conjectured = fri.rate_bits * fri.num_query_rounds + fri.proof_of_work_bits
        assert conjectured >= self.security_bits, (
            f"FRI gives only {conjectured} bits of security, "
            f"config requires {self.security_bits}"
        )

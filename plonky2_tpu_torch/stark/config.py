"""STARK configuration (reference: starky/src/config.rs:23-146)."""

from __future__ import annotations

from dataclasses import dataclass

from ..fri.config import FriConfig, FriReductionStrategy


@dataclass(frozen=True)
class StarkConfig:
    security_bits: int
    num_challenges: int
    fri_config: FriConfig

    @staticmethod
    def standard_fast_config() -> "StarkConfig":
        return StarkConfig(
            security_bits=100,
            num_challenges=2,
            fri_config=FriConfig(
                rate_bits=1,
                cap_height=4,
                proof_of_work_bits=16,
                reduction_strategy=FriReductionStrategy.ConstantArityBits(4, 5),
                num_query_rounds=84,
            ),
        )

    def observe(self, challenger) -> None:
        challenger.observe_element(self.security_bits)
        challenger.observe_element(self.num_challenges)
        self.fri_config.observe(challenger)

    def fri_params(self, degree_bits: int):
        return self.fri_config.fri_params(degree_bits, False)

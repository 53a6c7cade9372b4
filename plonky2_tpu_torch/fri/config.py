"""FRI configuration and parameters (reference: core/src/fri.rs:22-321).

Includes the fork-hardening transcript binding: the challenger observes
the full FriParams before anything else (FriParamsObserve)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..hash.challenger import Challenger


@dataclass(frozen=True)
class FriReductionStrategy:
    """kind: "fixed" | "constant_arity" | "min_size"."""

    kind: str
    fixed: Tuple[int, ...] = ()
    arity_bits: int = 0
    final_poly_bits: int = 0
    max_arity_bits: Optional[int] = None

    @staticmethod
    def Fixed(arities: List[int]) -> "FriReductionStrategy":
        return FriReductionStrategy("fixed", fixed=tuple(arities))

    @staticmethod
    def ConstantArityBits(arity_bits: int, final_poly_bits: int) -> "FriReductionStrategy":
        return FriReductionStrategy(
            "constant_arity", arity_bits=arity_bits, final_poly_bits=final_poly_bits
        )

    @staticmethod
    def MinSize(max_arity_bits: Optional[int] = None) -> "FriReductionStrategy":
        return FriReductionStrategy("min_size", max_arity_bits=max_arity_bits)

    def reduction_arity_bits(
        self, degree_bits: int, rate_bits: int, cap_height: int, num_queries: int
    ) -> List[int]:
        if self.kind == "fixed":
            return list(self.fixed)
        if self.kind == "constant_arity":
            result = []
            db = degree_bits
            while (
                db > self.final_poly_bits
                and db + rate_bits - self.arity_bits >= cap_height
            ):
                assert db >= self.arity_bits
                result.append(self.arity_bits)
                db -= self.arity_bits
            return result
        return _min_size_arity_bits(
            degree_bits, rate_bits, num_queries, self.max_arity_bits
        )

    def serialize(self) -> List[int]:
        """Field-element serialization for transcript binding (fri.rs:338-355)."""
        if self.kind == "fixed":
            return [0] + list(self.fixed)
        if self.kind == "constant_arity":
            return [1, self.arity_bits, self.final_poly_bits]
        return [2, self.max_arity_bits or 0]


def _relative_proof_size(
    degree_bits: int, rate_bits: int, num_queries: int, arity_bits: List[int]
) -> int:
    """Approximate FRI proof size in field elements (fri.rs:160-192)."""
    D = 4
    current_layer_bits = degree_bits + rate_bits
    total = 0
    for ab in arity_bits:
        total += ((1 << ab) - 1) * D * num_queries
        total += current_layer_bits * 4 * num_queries
        current_layer_bits -= ab
    assert current_layer_bits >= rate_bits
    total += D * (1 << (current_layer_bits - rate_bits))
    return total


def _min_size_arity_bits(
    degree_bits: int,
    rate_bits: int,
    num_queries: int,
    opt_max_arity_bits: Optional[int],
) -> List[int]:
    """Exhaustive search over monotonically non-increasing arity sequences
    minimizing estimated proof size (fri.rs:92-156)."""
    global_max = opt_max_arity_bits if opt_max_arity_bits is not None else 4

    def helper(prefix: List[int]):
        current_layer_bits = degree_bits + rate_bits - sum(prefix)
        assert current_layer_bits >= rate_bits
        best = list(prefix)
        best_size = _relative_proof_size(degree_bits, rate_bits, num_queries, prefix)
        max_ab = min(
            prefix[-1] if prefix else global_max, current_layer_bits - rate_bits
        )
        for next_ab in range(1, max_ab + 1):
            arity_bits, size = helper(prefix + [next_ab])
            if size < best_size:
                best, best_size = arity_bits, size
        return best, best_size

    return helper([])[0]


@dataclass(frozen=True)
class FriConfig:
    rate_bits: int
    cap_height: int
    proof_of_work_bits: int
    reduction_strategy: FriReductionStrategy
    num_query_rounds: int

    def fri_params(self, degree_bits: int, leaf_hiding: bool = False) -> "FriParams":
        rab = self.reduction_strategy.reduction_arity_bits(
            degree_bits, self.rate_bits, self.cap_height, self.num_query_rounds
        )
        return FriParams(self, leaf_hiding, degree_bits, tuple(rab))

    @property
    def num_cap_elements(self) -> int:
        return 1 << self.cap_height

    def observe(self, challenger: Challenger) -> None:
        challenger.observe_element(self.rate_bits)
        challenger.observe_element(self.cap_height)
        challenger.observe_element(self.proof_of_work_bits)
        challenger.observe_elements(self.reduction_strategy.serialize())
        challenger.observe_element(self.num_query_rounds)


@dataclass(frozen=True)
class FriParams:
    config: FriConfig
    leaf_hiding: bool
    degree_bits: int
    reduction_arity_bits: Tuple[int, ...]

    def total_arities(self) -> int:
        return sum(self.reduction_arity_bits)

    def max_arity_bits(self) -> Optional[int]:
        return max(self.reduction_arity_bits) if self.reduction_arity_bits else None

    @property
    def lde_bits(self) -> int:
        return self.degree_bits + self.config.rate_bits

    @property
    def lde_size(self) -> int:
        return 1 << self.lde_bits

    def final_poly_bits(self) -> int:
        return self.degree_bits - self.total_arities()

    def final_poly_len(self) -> int:
        return 1 << self.final_poly_bits()

    def observe(self, challenger: Challenger) -> None:
        """FriParamsObserve (fri.rs:302-321) — binds params to the transcript."""
        self.config.observe(challenger)
        challenger.observe_element(1 if self.leaf_hiding else 0)
        challenger.observe_element(self.degree_bits)
        challenger.observe_elements(list(self.reduction_arity_bits))

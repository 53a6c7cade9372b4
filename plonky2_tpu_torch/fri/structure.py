"""FRI instance/opening descriptors.

Mirrors reference core/src/fri_structure.rs:14-80, including the fork's
generalized opening *expressions* (linear combinations of committed
polynomials with One / PointPower / Constant coefficients, used for
split-mask zk openings in starky).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

Ext = Tuple[int, ...]  # extension field element (host form)


@dataclass(frozen=True)
class FriOracleInfo:
    num_polys: int
    blinding: bool


@dataclass(frozen=True)
class FriPolynomialInfo:
    oracle_index: int
    polynomial_index: int

    @staticmethod
    def from_range(oracle_index: int, start: int, end: int) -> List["FriPolynomialInfo"]:
        return [FriPolynomialInfo(oracle_index, i) for i in range(start, end)]


# FriCoefficient: None -> One; ("power", k) -> point^k; ("const", ext) -> constant
ONE = ("one",)


@dataclass(frozen=True)
class FriCoefficient:
    kind: str  # "one" | "point_power" | "constant"
    power: int = 0
    constant: Optional[Ext] = None

    @staticmethod
    def one() -> "FriCoefficient":
        return FriCoefficient("one")

    @staticmethod
    def point_power(k: int) -> "FriCoefficient":
        return FriCoefficient("point_power", power=k)

    @staticmethod
    def const(c: Ext) -> "FriCoefficient":
        return FriCoefficient("constant", constant=c)


@dataclass(frozen=True)
class FriOpeningTerm:
    coefficient: FriCoefficient
    polynomial: FriPolynomialInfo


@dataclass(frozen=True)
class FriOpeningExpression:
    terms: Tuple[FriOpeningTerm, ...]

    @staticmethod
    def single(poly: FriPolynomialInfo) -> "FriOpeningExpression":
        return FriOpeningExpression((FriOpeningTerm(FriCoefficient.one(), poly),))

    @staticmethod
    def split_mask(
        low: FriPolynomialInfo, high: FriPolynomialInfo, split_power: int
    ) -> "FriOpeningExpression":
        """low + point^split_power * high — a degree-(>n) masked polynomial
        committed as two degree-n halves (fri_structure.rs:76-89)."""
        return FriOpeningExpression(
            (
                FriOpeningTerm(FriCoefficient.one(), low),
                FriOpeningTerm(FriCoefficient.point_power(split_power), high),
            )
        )

    @property
    def is_single(self) -> bool:
        return len(self.terms) == 1 and self.terms[0].coefficient.kind == "one"


@dataclass
class FriBatchInfo:
    point: Ext  # extension element
    openings: List[FriOpeningExpression]

    @staticmethod
    def from_polys(point: Ext, polys: List[FriPolynomialInfo]) -> "FriBatchInfo":
        return FriBatchInfo(point, [FriOpeningExpression.single(p) for p in polys])


@dataclass
class FriInstanceInfo:
    oracles: List[FriOracleInfo]
    batches: List[FriBatchInfo]


@dataclass
class FriOpeningBatch:
    values: List[Ext]  # evaluation of each opening expression at the batch point


@dataclass
class FriOpenings:
    batches: List[FriOpeningBatch]


@dataclass
class FriChallenges:
    fri_alpha: Ext
    fri_betas: List[Ext]
    fri_pow_response: int
    fri_query_indices: List[int]

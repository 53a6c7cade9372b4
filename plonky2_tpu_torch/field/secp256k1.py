"""secp256k1 base and scalar fields (reference:
field/src/secp256k1_base.rs, secp256k1_scalar.rs). Generic big-int field
arithmetic for ECC gadget users; NOT in the proving hot path."""

from __future__ import annotations

from dataclasses import dataclass


class PrimeFieldElement:
    """Value in GF(order); subclasses define ORDER and GENERATOR."""

    ORDER: int
    MULTIPLICATIVE_GROUP_GENERATOR: int
    TWO_ADICITY: int

    def __init__(self, v: int):
        self.v = v % self.ORDER

    def __add__(self, o):
        return type(self)(self.v + o.v)

    def __sub__(self, o):
        return type(self)(self.v - o.v)

    def __mul__(self, o):
        return type(self)(self.v * o.v)

    def __neg__(self):
        return type(self)(-self.v)

    def __eq__(self, o):
        return type(self) is type(o) and self.v == o.v

    def __hash__(self):
        return hash((type(self).__name__, self.v))

    def inverse(self):
        assert self.v != 0
        return type(self)(pow(self.v, self.ORDER - 2, self.ORDER))

    def exp(self, e: int):
        return type(self)(pow(self.v, e, self.ORDER))

    def is_quadratic_residue(self) -> bool:
        return self.v == 0 or pow(self.v, (self.ORDER - 1) // 2, self.ORDER) == 1

    @classmethod
    def two_adic_subgroup_generator(cls):
        odd = (cls.ORDER - 1) >> cls.TWO_ADICITY
        return cls(pow(cls.MULTIPLICATIVE_GROUP_GENERATOR, odd, cls.ORDER))


class Secp256K1Base(PrimeFieldElement):
    ORDER = 2**256 - 2**32 - 977
    MULTIPLICATIVE_GROUP_GENERATOR = 3
    TWO_ADICITY = 1


class Secp256K1Scalar(PrimeFieldElement):
    ORDER = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
    MULTIPLICATIVE_GROUP_GENERATOR = 7
    TWO_ADICITY = 6

"""GenericConfig — the hasher bundle the reference passes as the `C` type
parameter (core/src/config.rs:31-148): an outer Hasher for Merkle
commitments + Fiat-Shamir, and an algebraic InnerHasher for public-input
hashing and in-circuit verification.

Digests are represented uniformly as 4 field elements. Only the
Poseidon bundle exists here so far.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

Digest = Tuple[int, int, int, int]


@dataclass(frozen=True)
class HasherSpec:
    name: str
    algebraic: bool  # digests live in the field; device Merkle available
    hash_no_pad: Callable
    hash_pad: Callable
    hash_leaf: Callable
    two_to_one: Callable
    permutation: Callable  # width-12 challenger permutation
    device_merkle: bool = False  # batched device tree kernels available


def _poseidon_spec() -> HasherSpec:
    from ..hash import poseidon as hp

    return HasherSpec(
        name="poseidon",
        algebraic=True,
        hash_no_pad=hp.hash_no_pad,
        hash_pad=hp.hash_pad,
        hash_leaf=hp.hash_leaf,
        two_to_one=hp.two_to_one,
        permutation=hp.permute,
        device_merkle=True,
    )


@dataclass(frozen=True)
class GenericConfig:
    name: str
    hasher: HasherSpec
    inner_hasher: HasherSpec


_POSEIDON = None


def poseidon_goldilocks_config() -> GenericConfig:
    global _POSEIDON
    if _POSEIDON is None:
        spec = _poseidon_spec()
        _POSEIDON = GenericConfig("PoseidonGoldilocksConfig", spec, spec)
    return _POSEIDON

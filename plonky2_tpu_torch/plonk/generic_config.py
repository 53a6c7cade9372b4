"""GenericConfig — the hasher bundle the reference passes as the `C` type
parameter (core/src/config.rs:31-148): an outer Hasher for Merkle
commitments + Fiat-Shamir, and an algebraic InnerHasher for public-input
hashing and in-circuit verification.

Digests are represented uniformly as 4 field elements. For Keccak
(BytesHash<25>) the mapping is the reference's `to_vec` 7-byte chunking
(core/src/config.rs:128-148): 25 bytes <-> (7,7,7,4)-byte limbs, each
< 2^56 < p, so the representation is bijective and transcript-compatible.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Sequence, Tuple

Digest = Tuple[int, int, int, int]


@dataclass(frozen=True)
class HasherSpec:
    name: str
    algebraic: bool  # digests live in the field
    hash_no_pad: Callable
    hash_pad: Callable
    hash_leaf: Callable
    two_to_one: Callable
    permutation: Callable  # width-12 challenger permutation
    # the JAX package's flag for its device tree; this package decides by
    # name where a tree is built (ops/merkle.build_merkle_tree)
    device_merkle: bool = False


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


def _poseidon2_spec() -> HasherSpec:
    from ..hash import poseidon2 as p2

    return HasherSpec(
        name="poseidon2",
        algebraic=True,
        hash_no_pad=p2.hash_no_pad,
        hash_pad=p2.hash_no_pad,  # pad10 sponge pads internally
        hash_leaf=p2.hash_leaf,
        two_to_one=p2.two_to_one,
        permutation=p2.permute,
        device_merkle=False,
    )


# -- Keccak (core/src/keccak.rs:100-142) ------------------------------------


def keccak_digest_to_felts(b: bytes) -> Digest:
    assert len(b) == 25
    return (
        int.from_bytes(b[0:7], "little"),
        int.from_bytes(b[7:14], "little"),
        int.from_bytes(b[14:21], "little"),
        int.from_bytes(b[21:25], "little"),
    )


def keccak_felts_to_digest(d: Sequence[int]) -> bytes:
    return (
        int(d[0]).to_bytes(7, "little")
        + int(d[1]).to_bytes(7, "little")
        + int(d[2]).to_bytes(7, "little")
        + int(d[3]).to_bytes(4, "little")
    )


def _keccak_spec() -> HasherSpec:
    import struct

    from ..hash.keccak import keccak256, keccak_permutation

    def _felts_bytes(inputs: Sequence[int]) -> bytes:
        return b"".join(struct.pack("<Q", int(x)) for x in inputs)

    def hash_no_pad(inputs: Sequence[int]) -> Digest:
        return keccak_digest_to_felts(keccak256(_felts_bytes(inputs))[:25])

    def hash_leaf(inputs: Sequence[int]) -> Digest:
        # 0x00 domain separator (keccak.rs:119-131)
        return keccak_digest_to_felts(keccak256(b"\x00" + _felts_bytes(inputs))[:25])

    def two_to_one(left: Sequence[int], right: Sequence[int]) -> Digest:
        raw = keccak_felts_to_digest(left) + keccak_felts_to_digest(right)
        return keccak_digest_to_felts(keccak256(raw)[:25])

    return HasherSpec(
        name="keccak",
        algebraic=False,
        hash_no_pad=hash_no_pad,
        hash_pad=hash_no_pad,
        hash_leaf=hash_leaf,
        two_to_one=two_to_one,
        permutation=keccak_permutation,
        device_merkle=False,
    )


@dataclass(frozen=True)
class GenericConfig:
    name: str
    hasher: HasherSpec
    inner_hasher: HasherSpec


_POSEIDON = None
_POSEIDON2 = None
_KECCAK = None


def poseidon_goldilocks_config() -> GenericConfig:
    global _POSEIDON
    if _POSEIDON is None:
        spec = _poseidon_spec()
        _POSEIDON = GenericConfig("PoseidonGoldilocksConfig", spec, spec)
    return _POSEIDON


def poseidon2_goldilocks_config() -> GenericConfig:
    """Poseidon2 for both the outer hasher (Merkle + Fiat-Shamir) and the
    inner hasher (public-input hashing uses the in-circuit Poseidon2
    pad10 sponge gadget). Recursive verification of proofs under this
    config (a Poseidon2-based in-circuit challenger) is future work."""
    global _POSEIDON2
    if _POSEIDON2 is None:
        spec = _poseidon2_spec()
        _POSEIDON2 = GenericConfig("Poseidon2GoldilocksConfig", spec, spec)
    return _POSEIDON2


def keccak_goldilocks_config() -> GenericConfig:
    """KeccakGoldilocksConfig: Keccak outer hasher, Poseidon inner hasher
    (core/src/config.rs KeccakGoldilocksConfig)."""
    global _KECCAK
    if _KECCAK is None:
        _KECCAK = GenericConfig(
            "KeccakGoldilocksConfig", _keccak_spec(), _poseidon_spec()
        )
    return _KECCAK

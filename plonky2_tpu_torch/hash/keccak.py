"""Keccak-256 hashing + the KeccakGoldilocksConfig pseudo-permutation
(reference: core/src/keccak.rs:12-142).

keccak-f[1600] is implemented from the spec; round constants come from
the degree-8 LFSR and rotation offsets from the t(t+1)/2 schedule, so
no opaque tables are embedded.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..field.goldilocks import P

_MASK = (1 << 64) - 1


def _rol(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _MASK


def _derive_round_constants() -> List[int]:
    """RC[i] per the Keccak LFSR (x^8 + x^6 + x^5 + x^4 + 1)."""
    rcs = []
    r = 1
    for _ in range(24):
        rc = 0
        for j in range(7):
            # after 7 steps per round; bit goes to position 2^j - 1
            if r & 1:
                rc |= 1 << ((1 << j) - 1)
            # LFSR step
            r <<= 1
            if r & 0x100:
                r ^= 0x171
        rcs.append(rc)
    return rcs


_RC = _derive_round_constants()

# rotation offsets: r[x][y] from the pi/rho schedule
_ROT = [[0] * 5 for _ in range(5)]
_x, _y = 1, 0
for _t in range(24):
    _ROT[_x][_y] = ((_t + 1) * (_t + 2) // 2) % 64
    _x, _y = _y, (2 * _x + 3 * _y) % 5


def keccak_f(state: List[int]) -> List[int]:
    """keccak-f[1600] on a 5x5 lane array (flat, index x + 5y)."""
    a = list(state)
    for rnd in range(24):
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] ^= d[x]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rol(a[x + 5 * y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] = b[x + 5 * y] ^ (
                    (~b[(x + 1) % 5 + 5 * y] & _MASK) & b[(x + 2) % 5 + 5 * y]
                )
        # iota
        a[0] ^= _RC[rnd]
    return a


def keccak256(data: bytes) -> bytes:
    """Original Keccak-256 (pad 0x01, not SHA3's 0x06). Dispatches to the
    native C engine when available (native/host_hash.c)."""
    from .. import native

    if native.available():
        return native.keccak256(data)
    rate = 136
    state = [0] * 25
    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80" if pad_len >= 2 else b"\x81"
    for block_start in range(0, len(padded), rate):
        block = padded[block_start : block_start + rate]
        for i in range(rate // 8):
            state[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        state = keccak_f(state)
    out = b"".join(state[i].to_bytes(8, "little") for i in range(4))
    return out[:32]


# ---------------------------------------------------------------------------
# KeccakHash<N> + the challenger pseudo-permutation (core/src/keccak.rs)
# ---------------------------------------------------------------------------

KECCAK_HASH_SIZE = 25  # bytes, matching KeccakGoldilocksConfig's N

SPONGE_WIDTH = 12


def _felts_to_bytes(xs: Sequence[int]) -> bytes:
    return b"".join((x % P).to_bytes(8, "little") for x in xs)


def _bytes_to_felts(b: bytes, n: int) -> List[int]:
    """Interpret bytes as field elements, u64-le chunks reduced mod p."""
    out = []
    for i in range(n):
        chunk = b[8 * i : 8 * i + 8]
        out.append(int.from_bytes(chunk, "little") % P)
    return out


def hash_no_pad(inputs: Sequence[int], size: int = KECCAK_HASH_SIZE) -> bytes:
    return keccak256(_felts_to_bytes(inputs))[:size]


def hash_pad(inputs: Sequence[int], size: int = KECCAK_HASH_SIZE) -> bytes:
    padded = list(inputs) + [1]
    while (len(padded) + 1) % 8 != 0:
        padded.append(0)
    padded.append(1)
    return hash_no_pad(padded, size)


def two_to_one(left: bytes, right: bytes, size: int = KECCAK_HASH_SIZE) -> bytes:
    return keccak256(left + right)[:size]


def keccak_permutation(state: Sequence[int]) -> List[int]:
    """Challenger pseudo-permutation: H(x) || H(H(x)) || H(H(H(x))) over the
    12-element field state (core/src/keccak.rs:20-60)."""
    assert len(state) == SPONGE_WIDTH
    h1 = keccak256(_felts_to_bytes(state))
    h2 = keccak256(h1)
    h3 = keccak256(h2)
    felts = (
        _bytes_to_felts(h1, 4) + _bytes_to_felts(h2, 4) + _bytes_to_felts(h3, 4)
    )
    return felts[:SPONGE_WIDTH]

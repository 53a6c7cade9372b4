"""Poseidon2 width-12 hash (reference: plonky2/src/hash/poseidon2.rs,
core/src/hashing.rs:97-199 for the pad10 additive sponge, permutation
structure per plonky2/src/gates/poseidon2.rs:633-749).

Permutation: light-MDS preamble, 4 initial external rounds (+RC, x^7 on
all lanes, light MDS), 22 internal rounds (+RC on lane 0, x^7 on lane 0,
internal mix y_i = d_i·x_i + Σx), 4 terminal external rounds.

The constraint-side layers are expressed once over the abstract algebra A
so they serve the gate (host/device/circuit); `permute` is the plain host
path and `permute_batch` the batched one on torch tensors, whose layers
(`sbox_lanes`, `mds_light_lanes`, `internal_mix_lanes`) also carry the
gate's stacked device eval.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..field.goldilocks import P, gadd, gmul
from .poseidon2_constants import (
    INITIAL_EXTERNAL_CONSTANTS,
    INTERNAL_CONSTANTS,
    INTERNAL_ROUNDS,
    MATRIX_DIAG,
    SPONGE_RATE,
    SPONGE_WIDTH,
    TERMINAL_EXTERNAL_CONSTANTS,
)

NUM_HASH_OUT_ELTS = 4


# ---------------------------------------------------------------------------
# Algebra-generic layers (single source for host eval + gate constraints)
# ---------------------------------------------------------------------------


def sbox7(A, x):
    x2 = A.mul(x, x)
    x4 = A.mul(x2, x2)
    x3 = A.mul(x, x2)
    return A.mul(x3, x4)


def apply_mat4(A, a, b, c, d):
    """[[2,3,1,1],[1,2,3,1],[1,1,2,3],[3,1,1,2]] (poseidon2.rs:231-240)."""
    t = A.add(A.add(a, b), A.add(c, d))
    y0 = A.add(t, A.add(a, A.add(b, b)))
    y1 = A.add(t, A.add(b, A.add(c, c)))
    y2 = A.add(t, A.add(c, A.add(d, d)))
    y3 = A.add(t, A.add(a, A.add(a, d)))
    return y0, y1, y2, y3


def mds_light(A, state: List) -> List:
    ys = []
    for k in range(0, SPONGE_WIDTH, 4):
        ys.extend(apply_mat4(A, state[k], state[k + 1], state[k + 2], state[k + 3]))
    sums = [A.add(A.add(ys[i], ys[4 + i]), ys[8 + i]) for i in range(4)]
    return [A.add(ys[i], sums[i % 4]) for i in range(SPONGE_WIDTH)]


def internal_mix(A, state: List) -> List:
    s = state[0]
    for i in range(1, SPONGE_WIDTH):
        s = A.add(s, state[i])
    return [
        A.add(A.mul_const(state[i], MATRIX_DIAG[i] % P), s)
        for i in range(SPONGE_WIDTH)
    ]


def permute_generic(A, state: List) -> List:
    """Full permutation over any algebra (used by the host path below and
    the witness generator; the gate interleaves checkpoint wires)."""
    state = mds_light(A, state)
    for r in range(4):
        state = [
            A.add_const(x, INITIAL_EXTERNAL_CONSTANTS[r][i] % P)
            for i, x in enumerate(state)
        ]
        state = [sbox7(A, x) for x in state]
        state = mds_light(A, state)
    for r in range(INTERNAL_ROUNDS):
        state = list(state)
        state[0] = sbox7(A, A.add_const(state[0], INTERNAL_CONSTANTS[r] % P))
        state = internal_mix(A, state)
    for r in range(4):
        state = [
            A.add_const(x, TERMINAL_EXTERNAL_CONSTANTS[r][i] % P)
            for i, x in enumerate(state)
        ]
        state = [sbox7(A, x) for x in state]
        state = mds_light(A, state)
    return state


class _HostAlgebra:
    def add(self, a, b):
        return gadd(a, b)

    def mul(self, a, b):
        return gmul(a, b)

    def add_const(self, a, c):
        return gadd(a, c)

    def mul_const(self, a, c):
        return gmul(a, c)


_HOST = _HostAlgebra()


def permute(state: Sequence[int]) -> List[int]:
    return permute_generic(_HOST, [x % P for x in state])


# ---------------------------------------------------------------------------
# pad10 additive sponge (hashing.rs:97-199)
# ---------------------------------------------------------------------------


def _pad10(inputs: Sequence[int]) -> List[int]:
    padded_len = ((len(inputs) + 1 + SPONGE_RATE - 1) // SPONGE_RATE) * SPONGE_RATE
    msg = [x % P for x in inputs] + [1] + [0] * (padded_len - len(inputs) - 1)
    return msg


def _absorb_squeeze(state: List[int], msg: List[int]) -> Tuple[int, int, int, int]:
    for off in range(0, len(msg), SPONGE_RATE):
        for i, x in enumerate(msg[off : off + SPONGE_RATE]):
            state[i] = gadd(state[i], x)
        state = permute(state)
    return tuple(state[:NUM_HASH_OUT_ELTS])


def hash_no_pad(inputs: Sequence[int]) -> Tuple[int, int, int, int]:
    """pad10 + additive absorption from the zero state, squeeze without a
    trailing permute (hash_n_to_hash_no_pad_p2, hashing.rs:171-180)."""
    return _absorb_squeeze([0] * SPONGE_WIDTH, _pad10(inputs))


def hash_leaf(inputs: Sequence[int]) -> Tuple[int, int, int, int]:
    """Domain separator 1 in the capacity region (hash_leaf_p2,
    hashing.rs:182-199)."""
    state = [0] * SPONGE_WIDTH
    state[SPONGE_RATE] = 1
    return _absorb_squeeze(state, _pad10(inputs))


def two_to_one(left: Sequence[int], right: Sequence[int]) -> Tuple[int, int, int, int]:
    return hash_no_pad(list(left) + list(right))


# ---------------------------------------------------------------------------
# Batched permutation on torch tensors. The layers work lane-major: lanes on
# the leading axis ([12, ...]), so lane 0 of the internal rounds is one
# contiguous row. Each product goes through ops/gf.mul (the field-product
# kernel on a CUDA tensor, its plain version on a CPU one); the light MDS
# has small integer coefficients, so it runs on the 32-bit halves in plain
# integer adds and is reduced once.
# ---------------------------------------------------------------------------

_ROUND_TABLES = {}


def round_tables(device):
    """(initial [4, 12, 1], terminal [4, 12, 1], internal [22], diagonal
    [12, 1]) round-constant tensors on ``device``, made once a device."""
    import numpy as np

    from ..ops import gf

    key = str(device)
    if key not in _ROUND_TABLES:
        def table(rows):
            return gf.from_u64(np.array(rows, dtype=np.uint64) % np.uint64(P), device)

        _ROUND_TABLES[key] = (
            table(INITIAL_EXTERNAL_CONSTANTS)[:, :, None],
            table(TERMINAL_EXTERNAL_CONSTANTS)[:, :, None],
            table(INTERNAL_CONSTANTS),
            table(MATRIX_DIAG)[:, None],
        )
    return _ROUND_TABLES[key]


def sbox_lanes(x):
    from ..ops import gf

    x2 = gf.sqr(x)
    return gf.mul(gf.mul(x, x2), gf.sqr(x2))


def mds_light_lanes(s):
    """The light MDS layer on [12, B] lanes (mds_light over field elements):
    apply_mat4 to each block of four lanes and add the block sums, on the
    32-bit halves (every combination has coefficients summing to at most
    28, so no half exceeds 2^37), then one reduction."""
    import torch

    from ..ops import gf

    halves = torch.stack([s & 0xFFFF_FFFF, (s >> 32) & 0xFFFF_FFFF])  # [2, 12, B]
    x = halves.reshape(2, 3, 4, -1)
    a, b, c, d = x.unbind(2)  # [2, 3, B]
    t = a + b + c + d
    y = torch.stack([t + a + 2 * b, t + b + 2 * c, t + c + 2 * d, t + 2 * a + d], dim=2)
    y = (y + y.sum(dim=1, keepdim=True)).reshape(2, SPONGE_WIDTH, -1)
    return gf.reduce_halves(y[0], y[1])


def external_round_lanes(s, rc):
    """+RC, x^7 on every lane, light MDS. s: [12, B]; rc: [12, 1]."""
    from ..ops import gf

    return mds_light_lanes(sbox_lanes(gf.add(s, rc)))


def internal_mix_lanes(s, diag):
    """y_i = d_i·x_i + Σx on [12, B] lanes; diag: [12, 1]."""
    from ..ops import gf

    return gf.add(gf.mul(s, diag), gf.sum_mod_p(s, axis=0)[None])


def permute_lanes(s):
    """The permutation of [12, B] lane-major states."""
    import torch

    from ..ops import gf

    initial, terminal, internal, diag = round_tables(s.device)
    s = mds_light_lanes(s)
    for r in range(4):
        s = external_round_lanes(s, initial[r])
    for r in range(INTERNAL_ROUNDS):
        lane0 = sbox_lanes(gf.add(s[0], internal[r]))
        s = internal_mix_lanes(torch.cat([lane0[None], s[1:]]), diag)
    for r in range(4):
        s = external_round_lanes(s, terminal[r])
    return s


def permute_batch(state):
    """The permutation of B states: [B, 12] int64 bit-container tensor of
    canonical values in, [B, 12] out, on the tensor's device."""
    return permute_lanes(state.T.contiguous()).T.contiguous()

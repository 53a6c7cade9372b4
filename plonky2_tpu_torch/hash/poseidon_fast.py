"""Optimized ("fast") partial-round representation of Poseidon.

The reference ships precomputed tables (core/src/poseidon_goldilocks.rs:
FAST_PARTIAL_FIRST_ROUND_CONSTANT, FAST_PARTIAL_ROUND_CONSTANTS,
FAST_PARTIAL_ROUND_INITIAL_MATRIX, FAST_PARTIAL_ROUND_W_HATS,
FAST_PARTIAL_ROUND_VS) generated offline by sage. Here the same tables
are *derived at import time* from MDS + ALL_ROUND_CONSTANTS using the
equivalent-matrix factorization of the Poseidon paper (Appendix B:
split the partial-round MDS into a sparse "cheap" factor absorbed per
round and a dense factor pushed into the first partial round), so the
data provably comes from the spec rather than being copied.

A test asserts `permute_fast == permute` (the naive host permutation),
which pins every table.
"""

from __future__ import annotations

from typing import List, Sequence

from ..field.goldilocks import P
from .poseidon_constants import (
    ALL_ROUND_CONSTANTS,
    HALF_N_FULL_ROUNDS,
    N_PARTIAL_ROUNDS,
    SPONGE_WIDTH,
)
from .poseidon import MDS_FULL, _sbox

T = SPONGE_WIDTH


def _mat_inv(m: List[List[int]]) -> List[List[int]]:
    """Exact inverse over GF(P) via Gauss-Jordan."""
    n = len(m)
    a = [row[:] + [1 if i == j else 0 for j in range(n)] for i, row in enumerate(m)]
    for col in range(n):
        piv = next(r for r in range(col, n) if a[r][col] % P != 0)
        a[col], a[piv] = a[piv], a[col]
        inv = pow(a[col][col], P - 2, P)
        a[col] = [(x * inv) % P for x in a[col]]
        for r in range(n):
            if r != col and a[r][col] % P != 0:
                f = a[r][col]
                a[r] = [(x - f * y) % P for x, y in zip(a[r], a[col])]
    return [row[n:] for row in a]


def _mat_vec(m: List[List[int]], v: Sequence[int]) -> List[int]:
    return [sum(x * y for x, y in zip(row, v)) % P for row in m]


def _derive():
    # Orientation quirk inherited from the generation scripts (row-vector
    # sage convention): constants fold through our M, matrices through M^T.
    # Both choices are pinned by the permute_fast == permute test and by
    # spot-checks against the reference's checked-in tables.
    m = [row[:] for row in MDS_FULL]
    mt = [[MDS_FULL[c][r] % P for c in range(T)] for r in range(T)]
    m_inv = _mat_inv(m)

    # --- equivalent round constants -------------------------------------
    rc = [
        [ALL_ROUND_CONSTANTS[r * T + i] % P for i in range(T)]
        for r in range(len(ALL_ROUND_CONSTANTS) // T)
    ]
    consts = [row[:] for row in rc]
    # fold constants of partial round i+1 back through M^{-1} into round i
    for i in range(HALF_N_FULL_ROUNDS + N_PARTIAL_ROUNDS - 2, HALF_N_FULL_ROUNDS - 1, -1):
        inv_c = _mat_vec(m_inv, consts[i + 1])
        consts[i] = [
            (consts[i][j] + (inv_c[j] if j > 0 else 0)) % P for j in range(T)
        ]
        consts[i + 1] = [inv_c[0]] + [0] * (T - 1)

    first_round_constant = consts[HALF_N_FULL_ROUNDS]
    # per-round lane-0 constants applied after the S-box; last round has none
    round_constants = [
        consts[HALF_N_FULL_ROUNDS + 1 + r][0] for r in range(N_PARTIAL_ROUNDS - 1)
    ] + [0]

    # --- equivalent matrices ---------------------------------------------
    w_hats: List[List[int]] = []
    vs: List[List[int]] = []
    m_mul = [row[:] for row in mt]
    m_i = None
    for _ in range(N_PARTIAL_ROUNDS):
        m_hat = [[m_mul[r][c] for c in range(1, T)] for r in range(1, T)]
        w = [m_mul[r][0] for r in range(1, T)]
        v = [m_mul[0][c] for c in range(1, T)]
        vs.append(v)
        w_hats.append(_mat_vec(_mat_inv(m_hat), w))
        # M_i = [[1,0],[0,M_hat]]; M_mul = M^T * M_i for the previous round
        m_i = [[1 if (r == 0 and c == 0) else 0 for c in range(T)] for r in range(T)]
        for r in range(1, T):
            for c in range(1, T):
                m_i[r][c] = m_hat[r - 1][c - 1]
        m_mul = [
            [sum(mt[r][k] * m_i[k][c] for k in range(T)) % P for c in range(T)]
            for r in range(T)
        ]
    # collections were built from the LAST partial round backwards
    w_hats.reverse()
    vs.reverse()
    initial_matrix = [[m_i[r][c] for c in range(1, T)] for r in range(1, T)]
    return first_round_constant, round_constants, initial_matrix, w_hats, vs


(
    FAST_PARTIAL_FIRST_ROUND_CONSTANT,
    FAST_PARTIAL_ROUND_CONSTANTS,
    FAST_PARTIAL_ROUND_INITIAL_MATRIX,
    FAST_PARTIAL_ROUND_W_HATS,
    FAST_PARTIAL_ROUND_VS,
) = _derive()

MDS_0_0 = MDS_FULL[0][0] % P


# ---------------------------------------------------------------------------
# Layer functions over an abstract algebra A (shared by the PoseidonGate's
# constraint eval, its witness generator, and the host fast permutation).
# Elements of `state` are algebra elements; constants are ints.
# ---------------------------------------------------------------------------


def constant_layer(A, state: List, round_ctr: int) -> List:
    base = round_ctr * T
    return [
        A.add_const(x, ALL_ROUND_CONSTANTS[base + i] % P)
        for i, x in enumerate(state)
    ]


def sbox_monomial(A, x):
    x2 = A.mul(x, x)
    x3 = A.mul(x, x2)
    x6 = A.mul(x3, x3)
    return A.mul(x, x6)


def mds_layer(A, state: List) -> List:
    out = []
    for r in range(T):
        acc = None
        for c in range(T):
            term = A.mul_const(state[c], MDS_FULL[r][c] % P)
            acc = term if acc is None else A.add(acc, term)
        out.append(acc)
    return out


def partial_first_constant_layer(A, state: List) -> List:
    return [
        A.add_const(x, FAST_PARTIAL_FIRST_ROUND_CONSTANT[i])
        for i, x in enumerate(state)
    ]


def mds_partial_layer_init(A, state: List) -> List:
    out = [state[0]]
    for c in range(1, T):
        acc = None
        for r in range(1, T):
            term = A.mul_const(
                state[r], FAST_PARTIAL_ROUND_INITIAL_MATRIX[r - 1][c - 1]
            )
            acc = term if acc is None else A.add(acc, term)
        out.append(acc)
    return out


def mds_partial_layer_fast(A, state: List, r: int) -> List:
    d = A.mul_const(state[0], MDS_0_0)
    for i in range(1, T):
        d = A.add(d, A.mul_const(state[i], FAST_PARTIAL_ROUND_W_HATS[r][i - 1]))
    out = [d]
    for i in range(1, T):
        out.append(A.add(state[i], A.mul_const(state[0], FAST_PARTIAL_ROUND_VS[r][i - 1])))
    return out


class _IntAlgebra:
    """Plain base-field ints, for the host fast permutation."""

    def add(self, a, b):
        return (a + b) % P

    def mul(self, a, b):
        return (a * b) % P

    def add_const(self, a, c):
        return (a + c) % P

    def mul_const(self, a, c):
        return (a * c) % P


def permute_fast(state: Sequence[int]) -> List[int]:
    """The permutation via the fast-partial-round representation.
    Must equal hash.poseidon.permute exactly (tested)."""
    A = _IntAlgebra()
    s = [x % P for x in state]
    round_ctr = 0
    for _ in range(HALF_N_FULL_ROUNDS):
        s = constant_layer(A, s, round_ctr)
        s = [_sbox(x) for x in s]
        s = mds_layer(A, s)
        round_ctr += 1
    s = partial_first_constant_layer(A, s)
    s = mds_partial_layer_init(A, s)
    for r in range(N_PARTIAL_ROUNDS):
        s[0] = _sbox(s[0])
        if r < N_PARTIAL_ROUNDS - 1:
            s[0] = (s[0] + FAST_PARTIAL_ROUND_CONSTANTS[r]) % P
        s = mds_partial_layer_fast(A, s, r)
    round_ctr += N_PARTIAL_ROUNDS
    for _ in range(HALF_N_FULL_ROUNDS):
        s = constant_layer(A, s, round_ctr)
        s = [_sbox(x) for x in s]
        s = mds_layer(A, s)
        round_ctr += 1
    return s

"""Example STARKs used as test fixtures (reference:
starky/src/{fibonacci_stark,permutation_stark,unconstrained_stark}.rs;
plonky2_tpu/stark/fixtures.py): FibonacciStark, PermutationStark (logUp),
UnconstrainedStark, and the two tables of a cross-table lookup,
CtlLookingStark and CtlLookedStark. Every generate_trace is vectorized
(the JAX package's loop over rows in Python), with the same values."""

from __future__ import annotations

from typing import List

import numpy as np

from ..field import goldilocks as gl
from .lookup import Column, Filter, Lookup
from .stark import ConstraintConsumer, Stark, StarkFrame


class FibonacciStark(Stark):
    """Trace: [x0, x1]; transition x0' = x1, x1' = x0 + x1; public inputs
    pin x0/x1 on the first row and the result on the last row."""

    PI_X0 = 0
    PI_X1 = 1
    PI_RES = 2

    def __init__(self, num_rows: int):
        self.num_rows = num_rows

    def num_columns(self) -> int:
        return 2

    def num_public_inputs(self) -> int:
        return 3

    def constraint_degree(self) -> int:
        return 2

    def generate_trace(self, x0: int, x1: int) -> np.ndarray:
        # f(i) = F(i-1)*x0 + F(i)*x1 over the standard Fibonacci numbers,
        # vectorized so a 2^22-row trace is ~22 numpy passes instead of a
        # 4M-iteration Python loop (fibonacci_stark.rs:generate_trace)
        f = _fib_seq(self.num_rows + 1, x0, x1)
        return np.stack([f[:-1], f[1:]])  # [2, num_rows]

    def eval(self, frame: StarkFrame, consumer: ConstraintConsumer, A) -> None:
        local = frame.local_values
        nxt = frame.next_values
        pis = frame.public_inputs

        consumer.constraint_first_row(A.sub(local[0], pis[self.PI_X0]))
        consumer.constraint_first_row(A.sub(local[1], pis[self.PI_X1]))
        consumer.constraint_last_row(A.sub(local[1], pis[self.PI_RES]))

        # x0' <- x1, x1' <- x0 + x1
        consumer.constraint_transition(A.sub(nxt[0], local[1]))
        consumer.constraint_transition(A.sub(nxt[1], A.add(local[0], local[1])))


def _std_fib(n: int) -> np.ndarray:
    """F[0..n] (F(0)=0, F(1)=1) mod p by vectorized doubling:
    F(m+j) = F(m)F(j+1) + F(m-1)F(j) turns F[0..m] into F[0..2m] in one
    numpy pass — log2(n) passes total."""
    out = np.zeros(n + 1, dtype=np.uint64)
    if n >= 1:
        out[1] = 1
    if n >= 2:
        out[2] = 1
    m = 2
    while m < n:
        # j <= m-1 so F(j+1) is already known: one pass takes m -> 2m-1
        k = min(m - 1, n - m)
        j = np.arange(1, k + 1)
        out[m + 1 : m + k + 1] = gl.np_add(
            gl.np_mul(out[m], out[j + 1]), gl.np_mul(out[m - 1], out[j])
        )
        m += k
    return out


def _fib_seq(n: int, x0: int, x1: int) -> np.ndarray:
    """f[0..n-1] with f(0)=x0, f(1)=x1, f(i)=f(i-1)+f(i-2) mod p."""
    F = _std_fib(n)  # F[0..n]
    Fm1 = np.concatenate([np.ones(1, dtype=np.uint64), F[: n - 1]])  # F(i-1)
    return gl.np_add(
        gl.np_mul(Fm1, np.uint64(x0 % gl.P)),
        gl.np_mul(F[:n], np.uint64(x1 % gl.P)),
    )


def fibonacci_res(num_rows: int, x0: int, x1: int) -> int:
    return int(_fib_seq(num_rows + 1, x0, x1)[num_rows])


def _offsets(x0: int, start: int, n: int) -> np.ndarray:
    """(x0 + start + i) mod p for i < n."""
    return gl.np_add(
        np.full(n, (x0 + start) % gl.P, dtype=np.uint64), np.arange(n, dtype=np.uint64)
    )


class PermutationStark(Stark):
    """Columns [c0, c1, freq=1] where c1 is a permutation of c0; no base
    constraints — only the logUp lookup binds them (reference:
    starky/src/permutation_stark.rs:24-100)."""

    def __init__(self, num_rows: int):
        self.num_rows = num_rows

    def num_columns(self) -> int:
        return 3

    def num_public_inputs(self) -> int:
        return 1

    def constraint_degree(self) -> int:
        return 0

    def lookups(self) -> List[Lookup]:
        return [
            Lookup(
                columns=[Column.single(0)],
                table_column=Column.single(1),
                frequencies_column=Column.single(2),
                filter_columns=[Filter.default()],
            )
        ]

    def generate_trace(self, x0: int) -> np.ndarray:
        """(permutation_stark.rs:39-51): rows (x0+i, x0+1+i, 1) with the
        last row's column-1 overwritten by x0 so col1 is a rotation of col0."""
        n = self.num_rows
        c0 = _offsets(x0, 0, n)
        c1 = _offsets(x0, 1, n)
        c1[n - 1] = x0
        return np.stack([c0, c1, np.ones(n, dtype=np.uint64)])

    def eval(self, frame: StarkFrame, consumer: ConstraintConsumer, A) -> None:
        pass


class UnconstrainedStark(Stark):
    """Two random columns, no constraints (reference:
    starky/src/unconstrained_stark.rs:20-100)."""

    def __init__(self, num_rows: int):
        self.num_rows = num_rows

    def num_columns(self) -> int:
        return 2

    def num_public_inputs(self) -> int:
        return 0

    def constraint_degree(self) -> int:
        return 0

    def generate_trace(self, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        return rng.integers(0, gl.P, size=(2, self.num_rows), dtype=np.uint64)

    def eval(self, frame: StarkFrame, consumer: ConstraintConsumer, A) -> None:
        pass


class CtlLookingStark(Stark):
    """Two value columns, both looking into a shared table via a CTL; no
    base constraints. Exercises the CTL helper-column path (two looking
    column-sets on one table, chunk size 2)."""

    def __init__(self, num_rows: int):
        self.num_rows = num_rows

    def num_columns(self) -> int:
        return 2

    def num_public_inputs(self) -> int:
        return 0

    def constraint_degree(self) -> int:
        return 3

    def requires_ctls(self) -> bool:
        return True

    def generate_trace(self, x0: int) -> np.ndarray:
        n = self.num_rows
        return np.stack([_offsets(x0, 0, n), _offsets(x0, n, n)])

    def eval(self, frame: StarkFrame, consumer: ConstraintConsumer, A) -> None:
        pass


class CtlLookedStark(Stark):
    """Columns [value, flag]; flagged rows form the looked table. Base
    constraint: flag is boolean."""

    def __init__(self, num_rows: int):
        self.num_rows = num_rows

    def num_columns(self) -> int:
        return 2

    def num_public_inputs(self) -> int:
        return 0

    def constraint_degree(self) -> int:
        return 3

    def requires_ctls(self) -> bool:
        return True

    def generate_trace(self, values) -> np.ndarray:
        """values: a sequence of ints or a u64 array, at most num_rows of
        them, put on the first rows with flag 1."""
        if isinstance(values, np.ndarray):
            vals = values.astype(np.uint64) % np.uint64(gl.P)
        else:
            vals = np.fromiter((v % gl.P for v in values), dtype=np.uint64, count=len(values))
        assert len(vals) <= self.num_rows
        col = np.zeros(self.num_rows, dtype=np.uint64)
        flag = np.zeros(self.num_rows, dtype=np.uint64)
        col[: len(vals)] = vals
        flag[: len(vals)] = 1
        return np.stack([col, flag])

    def eval(self, frame: StarkFrame, consumer: ConstraintConsumer, A) -> None:
        flag = frame.local_values[1]
        consumer.constraint(A.mul(flag, A.sub(flag, A.one())))

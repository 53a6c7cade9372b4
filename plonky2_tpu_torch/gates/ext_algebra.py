"""Extension-of-extension algebra over an abstract base algebra.

The reference's ExtensionAlgebra (field/src/extension/algebra.rs) is
D-tuples over F::Extension with x^D - W multiplication. Here it is
built generically over any constraint algebra A (host ints, device
batches, or circuit targets), so extension gates stay single-source.
D=2, W=7 (field/src/goldilocks_extensions.rs:13-24).
"""

from __future__ import annotations

from typing import List, Sequence

D = 2
W = 7


def ext_from_wires(wires: Sequence, rng) -> List:
    return [wires[i] for i in rng]


def ea_add(A, a, b):
    return [A.add(x, y) for x, y in zip(a, b)]


def ea_sub(A, a, b):
    return [A.sub(x, y) for x, y in zip(a, b)]


def ea_mul(A, a, b):
    """(a0 + a1 x)(b0 + b1 x) = a0b0 + W a1b1 + (a0b1 + a1b0) x."""
    assert len(a) == len(b) == D
    c0 = A.add(A.mul(a[0], b[0]), A.mul_const(A.mul(a[1], b[1]), W))
    c1 = A.add(A.mul(a[0], b[1]), A.mul(a[1], b[0]))
    return [c0, c1]


def ea_scalar_mul(A, a, s):
    """Multiply each component by a base-algebra element s."""
    return [A.mul(x, s) for x in a]


def ea_from_base(A, s):
    return [s, A.zero()]

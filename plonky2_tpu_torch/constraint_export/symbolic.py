"""Symbolic constraint extraction.

The reference's constraint-exporter instantiates each gate's
``eval_unfiltered`` with a symbolic field element that records the
arithmetic as an expression DAG (constraint-exporter/src/symbolic.rs:1-90)
— the returned vector *is* the gate's constraint polynomials, with no
hand-transcription step that could drift from the gate code.

Here the same move is even more direct: gates are already written once
against an abstract algebra (gates/algebra.py), so a ``SymbolicAlgebra``
is just another instantiation — no generic-field machinery needed, and
it covers every gate, not only the reference's hand-picked three.

DAG representation: a module-level arena of nodes with hash-consing
(shared subexpressions interned once — the analogue of the reference's
``Copy`` u32 handles into a thread-local arena). Node ids are
topologically ordered (children strictly smaller), which the
straight-line ``let``-renderer and the memoized evaluator rely on.

The reference extracts at extension degree D=1 (the constraint
polynomials are independent of D — D only changes the arithmetic used
while proving); SymbolicAlgebra is likewise a base-field algebra.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from ..field.goldilocks import P

# Node forms (op, *operands):
#   ("const", n)   canonical field constant, 0 <= n < P
#   ("wire", i)    local_wires[i]
#   ("lconst", i)  local_constants[i]
#   ("pih", i)     public_inputs_hash[i]
#   ("add"|"sub"|"mul", a, b)  a, b node ids
#   ("neg", a)
_NODES: List[Tuple] = []
_MEMO: Dict[Tuple, int] = {}


def reset() -> None:
    """Clear the arena between independent extractions (keeps ids small
    and output deterministic; old handles become invalid)."""
    _NODES.clear()
    _MEMO.clear()


def node(i: int) -> Tuple:
    return _NODES[i]


def num_nodes() -> int:
    return len(_NODES)


def _intern(n: Tuple) -> int:
    i = _MEMO.get(n)
    if i is None:
        i = len(_NODES)
        _NODES.append(n)
        _MEMO[n] = i
    return i


def const(c: int) -> int:
    return _intern(("const", c % P))


def wire(i: int) -> int:
    return _intern(("wire", i))


def lconst(i: int) -> int:
    return _intern(("lconst", i))


def pih(i: int) -> int:
    return _intern(("pih", i))


def _const_val(i: int):
    n = _NODES[i]
    return n[1] if n[0] == "const" else None


def add(a: int, b: int) -> int:
    ca, cb = _const_val(a), _const_val(b)
    if ca is not None and cb is not None:
        return const(ca + cb)
    if ca == 0:
        return b
    if cb == 0:
        return a
    return _intern(("add", a, b))


def sub(a: int, b: int) -> int:
    ca, cb = _const_val(a), _const_val(b)
    if ca is not None and cb is not None:
        return const(ca - cb)
    if cb == 0:
        return a
    if a == b:
        return const(0)
    return _intern(("sub", a, b))


def mul(a: int, b: int) -> int:
    ca, cb = _const_val(a), _const_val(b)
    if ca is not None and cb is not None:
        return const(ca * cb)
    if ca == 0 or cb == 0:
        return const(0)
    if ca == 1:
        return b
    if cb == 1:
        return a
    return _intern(("mul", a, b))


def neg(a: int) -> int:
    ca = _const_val(a)
    if ca is not None:
        return const(-ca)
    return _intern(("neg", a))


class SymbolicAlgebra:
    """gates/algebra.py algebra whose elements are arena node ids."""

    def const(self, c: int) -> int:
        return const(c)

    def zero(self) -> int:
        return const(0)

    def one(self) -> int:
        return const(1)

    def add(self, a, b):
        return add(a, b)

    def sub(self, a, b):
        return sub(a, b)

    def mul(self, a, b):
        return mul(a, b)

    def neg(self, a):
        return neg(a)

    def mul_const(self, a, c: int):
        return mul(a, const(c))

    def add_const(self, a, c: int):
        return add(a, const(c))

    def sub_from_const(self, c: int, a):
        return sub(const(c), a)

    def exp_const(self, a, e: int):
        # square-and-multiply over the DAG; hash-consing keeps it linear
        result = const(1)
        base = a
        while e:
            if e & 1:
                result = mul(result, base)
            e >>= 1
            if e:
                base = mul(base, base)
        return result


def eval_all(
    handles: Sequence[int],
    wires: Sequence[int],
    lconsts: Sequence[int],
    pih_vals: Sequence[int],
) -> List[int]:
    """Memoized linear-time concrete evaluation mod P (the differential
    test's oracle — render.rs eval_all equivalent)."""
    vals: List[int] = [0] * len(_NODES)
    for i, n in enumerate(_NODES):
        op = n[0]
        if op == "const":
            vals[i] = n[1]
        elif op == "wire":
            vals[i] = wires[n[1]] % P
        elif op == "lconst":
            vals[i] = lconsts[n[1]] % P
        elif op == "pih":
            vals[i] = pih_vals[n[1]] % P
        elif op == "add":
            vals[i] = (vals[n[1]] + vals[n[2]]) % P
        elif op == "sub":
            vals[i] = (vals[n[1]] - vals[n[2]]) % P
        elif op == "mul":
            vals[i] = (vals[n[1]] * vals[n[2]]) % P
        else:  # neg
            vals[i] = (-vals[n[1]]) % P
    return [vals[h] for h in handles]

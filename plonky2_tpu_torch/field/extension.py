"""Host-side binomial extension fields of Goldilocks: x^D - W for D in {2,4,5}.

Elements are tuples of D canonical ints. Mirrors the reference's
OEF extensions (reference: field/src/extension/mod.rs:14-89,
field/src/goldilocks_extensions.rs:13-71, field/src/extension/{quadratic,
quartic,quintic}.rs). The device D=2 kernels live in
``ops.gf`` (ext2_* functions) and agree bit-exactly.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .goldilocks import P, gadd, gexp, ginv, gmul, gneg, gsub

# W and DTH_ROOT per extension degree (goldilocks_extensions.rs:13-71)
W = {2: 7, 4: 7, 5: 3}
DTH_ROOT = {2: 18446744069414584320, 4: 281474976710656, 5: 1041288259238279555}

EXT_MULTIPLICATIVE_GROUP_GENERATOR = {
    2: (0, 11713931119993638672),
    4: (0, 8295451483910296135, 0, 0),
}
EXT_POWER_OF_TWO_GENERATOR = {
    2: (0, 7226896044987257365),
    4: (0, 0, 0, 17216955519093520442),
}

Ext = Tuple[int, ...]


def ext_zero(d: int) -> Ext:
    return (0,) * d


def ext_one(d: int) -> Ext:
    return (1,) + (0,) * (d - 1)


def from_base(x: int, d: int) -> Ext:
    return (x % P,) + (0,) * (d - 1)


def ext_add(a: Ext, b: Ext) -> Ext:
    return tuple(gadd(x, y) for x, y in zip(a, b))


def ext_sub(a: Ext, b: Ext) -> Ext:
    return tuple(gsub(x, y) for x, y in zip(a, b))


def ext_neg(a: Ext) -> Ext:
    return tuple(gneg(x) for x in a)


def ext_scalar_mul(a: Ext, s: int) -> Ext:
    return tuple(gmul(x, s) for x in a)


def ext_mul(a: Ext, b: Ext) -> Ext:
    """Schoolbook binomial multiplication: x^D = W."""
    d = len(a)
    w = W[d]
    out = [0] * d
    for i, ai in enumerate(a):
        # isinstance: zero-skip is an optimization; symbolic components
        # (witgen tracer) take the generic path
        if isinstance(ai, int) and ai == 0:
            continue
        for j, bj in enumerate(b):
            if isinstance(bj, int) and bj == 0:
                continue
            k = i + j
            prod = gmul(ai, bj)
            if k >= d:
                out[k - d] = gadd(out[k - d], gmul(prod, w))
            else:
                out[k] = gadd(out[k], prod)
    return tuple(out)


def ext_sqr(a: Ext) -> Ext:
    return ext_mul(a, a)


def ext_exp(a: Ext, e: int) -> Ext:
    d = len(a)
    result = ext_one(d)
    base = a
    while e:
        if e & 1:
            result = ext_mul(result, base)
        base = ext_mul(base, base)
        e >>= 1
    return result


def frobenius(a: Ext, count: int = 1) -> Ext:
    """a -> a^(p^count): coefficient i scales by DTH_ROOT^(i*count)
    (reference: field/src/extension/mod.rs:29-63 repeated_frobenius)."""
    d = len(a)
    count %= d
    if count == 0:
        return a
    z0 = gexp(DTH_ROOT[d], count)
    out = []
    z = 1
    for ai in a:
        out.append(gmul(ai, z))
        z = gmul(z, z0)
    return tuple(out)


def ext_inv(a: Ext) -> Ext:
    """Inverse via the norm map: a^-1 = prod_{i=1..D-1} frob^i(a) / Norm(a)."""
    d = len(a)
    # isinstance guards: under the witgen tracer (iop/witgen_native.py)
    # components are symbolic and these data checks are skipped — the
    # engine's INV0 gives 0 for 0, and the norm identity holds by algebra.
    if isinstance(a[0], (int, np.integer)) and all(x == 0 for x in a):
        raise ZeroDivisionError("inverse of zero extension element")
    conj_prod = frobenius(a, 1)
    for i in range(2, d):
        conj_prod = ext_mul(conj_prod, frobenius(a, i))
    norm = ext_mul(a, conj_prod)
    # norm lies in the base field
    assert not isinstance(norm[0], (int, np.integer)) or all(
        x == 0 for x in norm[1:]
    ), "norm not in base field"
    return ext_scalar_mul(conj_prod, ginv(norm[0]))


def ext_div(a: Ext, b: Ext) -> Ext:
    return ext_mul(a, ext_inv(b))


def flatten(elements: Sequence[Ext]) -> list[int]:
    """Flatten extension elements to base-field elements (basefield array order)."""
    out: list[int] = []
    for e in elements:
        out.extend(e)
    return out


class GLExt2:
    """Convenience wrapper for the default D=2 extension used by the prover."""

    __slots__ = ("c",)
    D = 2

    def __init__(self, c0: int, c1: int = 0):
        self.c = (c0 % P, c1 % P)

    @classmethod
    def from_tuple(cls, t: Ext) -> "GLExt2":
        e = cls(0)
        e.c = (t[0], t[1])
        return e

    def __add__(self, o):
        return GLExt2.from_tuple(ext_add(self.c, o.c))

    def __sub__(self, o):
        return GLExt2.from_tuple(ext_sub(self.c, o.c))

    def __mul__(self, o):
        return GLExt2.from_tuple(ext_mul(self.c, o.c))

    def __neg__(self):
        return GLExt2.from_tuple(ext_neg(self.c))

    def inv(self) -> "GLExt2":
        return GLExt2.from_tuple(ext_inv(self.c))

    def __truediv__(self, o):
        return self * o.inv()

    def exp(self, e: int) -> "GLExt2":
        return GLExt2.from_tuple(ext_exp(self.c, e))

    def __eq__(self, o):
        return isinstance(o, GLExt2) and self.c == o.c

    def __hash__(self):
        return hash(self.c)

    def __repr__(self):
        return f"GLExt2{self.c}"

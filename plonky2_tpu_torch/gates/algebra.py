"""Single-source constraint algebra.

The reference implements every gate's constraints three times (native
extension, packed base batch, in-circuit —
plonky2/src/gates/gate.rs:53-230). Here each gate implements its
constraints ONCE against an abstract algebra, instantiated as:

  * HostExtAlgebra — exact extension-field tuples, used by the verifier
    at zeta (and by gate unit tests);
  * DeviceBatchAlgebra — batched field tensors over all LDE points,
    used by the quotient evaluation on device;
  * (later) CircuitAlgebra — ExtensionTargets, for the recursive verifier.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from ..field import extension as ge
from ..field.goldilocks import P

# torch (via ops.gf) is imported lazily by DeviceBatchAlgebra so that the
# host-only instantiations (HostExtAlgebra — the verifier's path) never
# pull it (reference capability: the no_std verifier crate,
# verifier/src/lib.rs:1-20)
gf = None


def _load_gf():
    global gf
    if gf is None:
        from ..ops import gf as _gf

        gf = _gf


class HostExtAlgebra:
    """Elements are D=2 extension tuples of ints."""

    def const(self, c: int):
        return ge.from_base(c, 2)

    def zero(self):
        return ge.ext_zero(2)

    def one(self):
        return ge.ext_one(2)

    def add(self, a, b):
        return ge.ext_add(a, b)

    def sub(self, a, b):
        return ge.ext_sub(a, b)

    def mul(self, a, b):
        return ge.ext_mul(a, b)

    def neg(self, a):
        return ge.ext_neg(a)

    def mul_const(self, a, c: int):
        return ge.ext_scalar_mul(a, c % P)

    def add_const(self, a, c: int):
        return ge.ext_add(a, self.const(c))

    def sub_from_const(self, c: int, a):
        return ge.ext_sub(self.const(c), a)

    def exp_const(self, a, e: int):
        return ge.ext_exp(a, e)


class DeviceBatchAlgebra:
    """Elements are int64 bit-container tensors of shape [B] (base field)
    on one device."""

    def __init__(self, batch_size: int, device):
        _load_gf()
        self.b = batch_size
        self.device = device

    def const(self, c: int):
        return gf.full((self.b,), c, self.device)

    def zero(self):
        return gf.zeros((self.b,), self.device)

    def one(self):
        return gf.ones((self.b,), self.device)

    def add(self, a, b):
        return gf.add(a, b)

    def sub(self, a, b):
        return gf.sub(a, b)

    def mul(self, a, b):
        return gf.mul(a, b)

    def neg(self, a):
        return gf.neg(a)

    def mul_const(self, a, c: int):
        return gf.mul_const(a, c)

    def add_const(self, a, c: int):
        return gf.add(a, self.const(c))

    def sub_from_const(self, c: int, a):
        return gf.sub(self.const(c), a)

    def exp_const(self, a, e: int):
        return gf.exp_const(a, e)


class CircuitAlgebra:
    """Elements are ExtensionTargets; operations emit gates. Instantiating a
    gate's eval_unfiltered with this algebra IS the reference's
    eval_unfiltered_circuit (gate.rs:105-130) — used by the recursive
    verifier's vanishing-polynomial evaluation at zeta."""

    def __init__(self, builder):
        self.b = builder

    def const(self, c: int):
        return self.b.constant_extension((c % P, 0))

    def zero(self):
        return self.b.zero_extension()

    def one(self):
        return self.b.one_extension()

    def add(self, a, b):
        return self.b.add_extension(a, b)

    def sub(self, a, b):
        return self.b.sub_extension(a, b)

    def mul(self, a, b):
        return self.b.mul_extension(a, b)

    def neg(self, a):
        return self.b.sub_extension(self.zero(), a)

    def mul_const(self, a, c: int):
        return self.b.constant_scalar_mul_ext(c % P, a)

    def add_const(self, a, c: int):
        return self.b.add_const_extension(a, (c % P, 0))

    def sub_from_const(self, c: int, a):
        return self.b.sub_extension(self.const(c), a)

    def exp_const(self, a, e: int):
        return self.b.exp_u64_extension(a, e)


@dataclass
class EvalVars:
    """Gate-visible evaluation variables (selectors already stripped)."""

    local_constants: Sequence
    local_wires: Sequence
    public_inputs_hash: Sequence  # 4 algebra elements

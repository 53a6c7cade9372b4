"""The secp256k1 base and scalar fields of the port
(plonky2_tpu_torch/field/secp256k1.py), as tests/test_hash_field_extras.py
holds the JAX package's, and against it value for value. Plain integers:
exact equality."""

import pytest

from plonky2_tpu.field import secp256k1 as ref
from _torch_port import lazy_module

sec = lazy_module("plonky2_tpu_torch.field.secp256k1")

FIELDS = ["Secp256K1Base", "Secp256K1Scalar"]


@pytest.mark.parametrize("name", FIELDS)
def test_secp256k1_field(name):
    F = getattr(sec, name)
    a = F(123456789)
    b = F(987654321)
    assert (a * b).v == (123456789 * 987654321) % F.ORDER
    assert (a * a.inverse()).v == 1
    g = F.two_adic_subgroup_generator()
    assert g.exp(1 << F.TWO_ADICITY).v == 1
    assert g.exp(1 << (F.TWO_ADICITY - 1)).v != 1


@pytest.mark.parametrize("name", FIELDS)
def test_secp256k1_equals_reference(name):
    F, R = getattr(sec, name), getattr(ref, name)
    assert (F.ORDER, F.MULTIPLICATIVE_GROUP_GENERATOR, F.TWO_ADICITY) == (
        R.ORDER, R.MULTIPLICATIVE_GROUP_GENERATOR, R.TWO_ADICITY)
    x, y = 3**160 + 11, 7**90 + 5
    for op in ("__add__", "__sub__", "__mul__"):
        assert getattr(F(x), op)(F(y)).v == getattr(R(x), op)(R(y)).v
    assert (-F(x)).v == (-R(x)).v
    assert F(x).inverse().v == R(x).inverse().v
    assert F(x).exp(12345).v == R(x).exp(12345).v
    assert F(x).is_quadratic_residue() == R(x).is_quadratic_residue()
    assert F(x) == F(x + F.ORDER) and F(x) != F(y)

"""Host polynomial interpolation over extension fields
(reference: field/src/interpolation.rs:13-76)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

from .extension import Ext, ext_add, ext_div, ext_inv, ext_mul, ext_one, ext_sub, ext_zero


def barycentric_weights(points: Sequence[Tuple[Ext, Ext]]) -> List[Ext]:
    n = len(points)
    d = len(points[0][0])
    weights = []
    for i in range(n):
        prod = ext_one(d)
        for j in range(n):
            if j != i:
                prod = ext_mul(prod, ext_sub(points[i][0], points[j][0]))
        weights.append(ext_inv(prod))
    return weights


def interpolate(
    points: Sequence[Tuple[Ext, Ext]], x: Ext, weights: Sequence[Ext]
) -> Ext:
    d = len(x)
    for x_i, y_i in points:
        if x_i == x:
            return y_i
    l_x = ext_one(d)
    for x_i, _ in points:
        l_x = ext_mul(l_x, ext_sub(x, x_i))
    s = ext_zero(d)
    for (x_i, y_i), w_i in zip(points, weights):
        s = ext_add(s, ext_mul(ext_div(w_i, ext_sub(x, x_i)), y_i))
    return ext_mul(l_x, s)


def interpolate2(points: Sequence[Tuple[Ext, Ext]], x: Ext) -> Ext:
    """Linear interpolation through two points."""
    (a0, a1), (b0, b1) = points
    assert a0 != b0
    slope = ext_div(ext_sub(b1, a1), ext_sub(b0, a0))
    return ext_add(a1, ext_mul(ext_sub(x, a0), slope))


def interpolant(points: Sequence[Tuple[Ext, Ext]]) -> List[Ext]:
    """Lagrange interpolation returning coefficients (O(n^2), host/test use)."""
    n = len(points)
    d = len(points[0][0])
    coeffs = [ext_zero(d) for _ in range(n)]
    weights = barycentric_weights(points)
    for i, ((x_i, y_i), w_i) in enumerate(zip(points, weights)):
        # numerator polynomial prod_{j!=i} (X - x_j)
        num = [ext_one(d)]
        for j, (x_j, _) in enumerate(points):
            if j == i:
                continue
            new = [ext_zero(d) for _ in range(len(num) + 1)]
            for k, c in enumerate(num):
                new[k + 1] = ext_add(new[k + 1], c)
                new[k] = ext_sub(new[k], ext_mul(c, x_j))
            num = new
        scale = ext_mul(y_i, w_i)
        for k in range(len(num)):
            coeffs[k] = ext_add(coeffs[k], ext_mul(num[k], scale))
    return coeffs

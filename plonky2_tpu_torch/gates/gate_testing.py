"""Gate test harness (reference: plonky2/src/gates/gate_testing.rs:25-130).

Three checks, each exercising the single-source constraint algebra:

* ``check_low_degree(gate)`` — evaluate the gate's constraints on LDEs of
  random low-degree witness polynomials and assert the constraint
  polynomials' degree stays within witness_degree * gate.degree().
* ``check_generated_witness(gate)`` — run the gate's witness generators on
  random inputs and assert every constraint vanishes (host exact algebra).
* ``check_algebra_agreement(gate)`` — the device batch algebra (int64
  tensors on an explicit device, the gate's ``eval_unfiltered_device``)
  and the host exact algebra must produce identical constraint values on
  identical random rows.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..field import goldilocks as gl
from ..field.goldilocks import P
from .algebra import DeviceBatchAlgebra, EvalVars, HostExtAlgebra
from .gate import Gate


class NumpyBatchAlgebra:
    """Exact base-field arithmetic over numpy u64 arrays of shape [B]."""

    def __init__(self, batch_size: int):
        self.b = batch_size

    def const(self, c: int):
        return np.full(self.b, c % P, dtype=np.uint64)

    def zero(self):
        return np.zeros(self.b, dtype=np.uint64)

    def one(self):
        return np.ones(self.b, dtype=np.uint64)

    def add(self, a, b):
        return gl.np_add(a, b)

    def sub(self, a, b):
        return gl.np_sub(a, b)

    def mul(self, a, b):
        return gl.np_mul(a, b)

    def neg(self, a):
        return gl.np_neg(a)

    def mul_const(self, a, c: int):
        return gl.np_mul(a, np.uint64(c % P))

    def add_const(self, a, c: int):
        return gl.np_add(a, np.uint64(c % P))

    def sub_from_const(self, c: int, a):
        return gl.np_sub(np.uint64(c % P), a)

    def exp_const(self, a, e: int):
        return gl.np_exp(a, e)


def _rand_u64(rng, shape):
    return rng.integers(0, P, size=shape, dtype=np.uint64)


def _naive_coeffs(values: np.ndarray) -> np.ndarray:
    """O(n^2) inverse DFT over the 2-adic subgroup (exact, host)."""
    n = len(values)
    n_log = n.bit_length() - 1
    g_inv = gl.ginv(gl.primitive_root_of_unity(n_log))
    pows = gl.np_powers(g_inv, n)  # [n]
    idx = np.outer(np.arange(n), np.arange(n)) % n
    w = pows[idx]  # [n, n] w^{-ik}
    prods = gl.np_mul(w, values[None, :])
    acc = np.zeros(n, dtype=np.uint64)
    for k in range(n):
        acc = gl.np_add(acc, prods[:, k])
    return gl.np_mul(acc, np.uint64(gl.ginv(n)))


def check_low_degree(gate: Gate, witness_degree_bits: int = 3) -> None:
    rng = np.random.default_rng(0)
    d = 1 << witness_degree_bits  # number of coefficients
    rate_bits = max(1, (gate.degree() - 1).bit_length())
    n = d << rate_bits
    n_log = n.bit_length() - 1
    g = gl.primitive_root_of_unity(n_log)
    xs = gl.np_powers(g, n)

    def rand_poly_evals(count):
        # degree < d polynomials evaluated on the size-n subgroup
        coeffs = _rand_u64(rng, (count, d))
        out = np.zeros((count, n), dtype=np.uint64)
        for j in range(count):
            acc = np.zeros(n, dtype=np.uint64)
            for c in reversed(coeffs[j]):
                acc = gl.np_add(gl.np_mul(acc, xs), c)
            out[j] = acc
        return out

    wires = rand_poly_evals(gate.num_wires())
    consts = rand_poly_evals(gate.num_constants())
    pis = rand_poly_evals(4)

    A = NumpyBatchAlgebra(n)
    vars = EvalVars(list(consts), list(wires), list(pis))
    constraints = gate.eval_unfiltered(vars, A)
    max_deg_allowed = (d - 1) * max(gate.degree(), 1)
    assert max_deg_allowed < n
    for k, c in enumerate(constraints):
        coeffs = _naive_coeffs(np.asarray(c, dtype=np.uint64))
        bad = np.nonzero(coeffs[max_deg_allowed + 1 :])[0]
        assert bad.size == 0, (
            f"constraint {k} of {gate.id()} has degree > {max_deg_allowed}"
        )


class _DictWitness:
    def __init__(self, vals: Dict[Tuple[int, int], int]):
        self.vals = vals

    def get_target(self, t):
        return self.vals[(t.row, t.column)]


class _DictOut:
    def __init__(self):
        self.vals: Dict[Tuple[int, int], int] = {}

    def set_wire(self, row, col, v):
        self.vals[(row, col)] = v


def generate_gate_row(
    gate: Gate,
    constants: Optional[List[int]] = None,
    seed: int = 0,
    preset: Optional[Dict[int, int]] = None,
) -> List[int]:
    """Fill a single gate row: random values for generator dependencies
    (overridable via `preset`), generator outputs for the rest."""
    rnd = random.Random(seed)
    constants = constants or [rnd.randrange(P) for _ in range(gate.num_constants())]
    wires: Dict[Tuple[int, int], int] = {}
    if preset:
        for col, v in preset.items():
            wires[(0, col)] = v % P
    gens = gate.generators(0, constants)
    for gen in gens:
        for t in gen.dependencies():
            col = t.column
            if (0, col) not in wires:
                wires[(0, col)] = rnd.randrange(P)
    for gen in gens:
        out = _DictOut()
        gen.run_once(_DictWitness(wires), out)
        wires.update(out.vals)
    row = [0] * gate.num_wires()
    for (r, c), v in wires.items():
        if c < gate.num_wires():
            row[c] = v
    return row, constants


def check_generated_witness(
    gate: Gate,
    constants: Optional[List[int]] = None,
    seed: int = 0,
    preset: Optional[Dict[int, int]] = None,
) -> None:
    row, constants = generate_gate_row(gate, constants, seed, preset)
    A = HostExtAlgebra()
    rnd = random.Random(seed + 1)
    pis = [A.const(rnd.randrange(P)) for _ in range(4)]
    vars = EvalVars(
        [A.const(c) for c in constants], [A.const(w) for w in row], pis
    )
    zero = A.zero()
    for k, c in enumerate(gate.eval_unfiltered(vars, A)):
        if _gate_constraint_may_involve_pis(gate, k):
            continue
        assert c == zero, f"constraint {k} of {gate.id()} nonzero on generated witness"


def _gate_constraint_may_involve_pis(gate: Gate, k: int) -> bool:
    return type(gate).__name__ == "PublicInputGate"


def check_algebra_agreement(gate: Gate, batch: int = 4, seed: int = 0, device=None) -> None:
    """device: where the batch algebra runs (see gf.resolve_device: None
    means the GPU; the CPU tests pass "cpu")."""
    from ..ops import gf

    rng = np.random.default_rng(seed)
    wires = _rand_u64(rng, (gate.num_wires(), batch))
    consts = _rand_u64(rng, (gate.num_constants(), batch))
    pis = _rand_u64(rng, (4, batch))

    An = NumpyBatchAlgebra(batch)
    host_vals = gate.eval_unfiltered(
        EvalVars(list(consts), list(wires), list(pis)), An
    )

    device = gf.resolve_device(device)
    Ad = DeviceBatchAlgebra(batch, device)
    dev_vars = EvalVars(
        list(gf.from_u64(consts, device).reshape(-1, batch).unbind(0)),
        list(gf.from_u64(wires, device).unbind(0)),
        list(gf.from_u64(pis, device).unbind(0)),
    )
    dev_vals = gate.eval_unfiltered_device(dev_vars, Ad)
    assert len(host_vals) == len(dev_vals) == gate.num_constraints()
    for k, (h, dv) in enumerate(zip(host_vals, dev_vals)):
        got = gf.to_u64(gf.canonicalize(dv))
        want = gl.np_canonicalize(np.asarray(h, dtype=np.uint64))
        assert np.array_equal(got, want), f"constraint {k} of {gate.id()} device != host"

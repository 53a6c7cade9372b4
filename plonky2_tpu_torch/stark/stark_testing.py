"""STARK testing harness (reference: starky/src/stark_testing.rs;
plonky2_tpu/stark/stark_testing.py).

`test_stark_low_degree` evaluates a Stark's constraints over the LDE of a
random low-degree trace and asserts the resulting degree bound; here the
evaluation is the device quotient's own (DeviceBatchAlgebra over every
point at once, on ``device``), and the degree comes from an inverse FFT.
`test_stark_algebra_consistency` replaces the reference's
`test_stark_circuit_constraints`: with single-source constraints the
host-extension and in-circuit algebras must agree on the same inputs.

The two functions are named ``test_*`` as in the reference: a pytest
module must import them under other names, or pytest collects them.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..field import goldilocks as gl
from ..gates.algebra import DeviceBatchAlgebra, HostExtAlgebra
from ..ops import gf, ntt
from ..utils.bits import log2_ceil, log2_strict
from .stark import ConstraintConsumer, Stark, StarkFrame

WITNESS_SIZE = 1 << 5


def _lde_matrix(rng, num_columns: int, rate_bits: int, device) -> torch.Tensor:
    """[columns, WITNESS_SIZE << rate_bits] LDE of random degree-<WITNESS_SIZE
    columns, evaluated over the larger subgroup (no coset shift —
    stark_testing.rs random_low_degree_matrix); the same coefficients as
    the JAX package's harness draws from the same generator."""
    n = WITNESS_SIZE
    size = n << rate_bits
    coeffs = rng.integers(0, gl.P, size=(num_columns, n), dtype=np.uint64)
    padded = np.zeros((num_columns, size), dtype=np.uint64)
    padded[:, :n] = coeffs
    return ntt.fft(gf.from_u64(padded, device))


def _poly_degree(values: torch.Tensor) -> int:
    """Degree of the polynomial interpolating ``values`` on the subgroup
    (0 for the zero polynomial)."""
    coeffs = gf.to_u64(ntt.ifft(values))
    nonzero = np.flatnonzero(coeffs)
    return int(nonzero[-1]) if len(nonzero) else 0


def test_stark_low_degree(
    stark: Stark, public_inputs: List[int] = None, seed=0, device=None
) -> None:
    """stark_testing.rs:25-74. device=None means the GPU."""
    device = gf.resolve_device(device)
    rng = np.random.default_rng(seed)
    rate_bits = log2_ceil(stark.constraint_degree() + 1)
    trace_ldes = _lde_matrix(rng, stark.num_columns(), rate_bits, device)
    size = trace_ldes.shape[1]
    if public_inputs is None:
        public_inputs = [
            int(x)
            for x in rng.integers(
                0, gl.P, size=stark.num_public_inputs(), dtype=np.uint64,
                endpoint=False,
            )
        ]

    n = WITNESS_SIZE
    # selector polynomials' LDEs (first/last row indicators)
    g_small = gl.primitive_root_of_unity(log2_strict(n))
    g_size = gl.primitive_root_of_unity(log2_strict(size))
    xs = gf.from_u64(gl.np_powers(g_size, size), device)
    one = gf.full((1,), 1, device)
    zh = gf.sub(gf.exp_const(xs, n), one)
    l_first = gf.mul(zh, gf.batch_inverse(gf.mul_const(gf.sub(xs, one), n)))
    l_last = gf.mul(
        zh, gf.batch_inverse(gf.mul_const(gf.sub(gf.mul_const(xs, g_small), one), n))
    )
    z_last = gf.sub(xs, gf.full((1,), gl.ginv(g_small), device))

    alpha = int(rng.integers(1, 1 << 63)) % gl.P
    A = DeviceBatchAlgebra(size, device)
    step = 1 << rate_bits
    frame = StarkFrame(
        local_values=[trace_ldes[c] for c in range(trace_ldes.shape[0])],
        next_values=[torch.roll(trace_ldes[c], -step) for c in range(trace_ldes.shape[0])],
        public_inputs=[A.const(p) for p in public_inputs],
    )
    consumer = ConstraintConsumer(A, [A.const(alpha)], z_last, l_first, l_last)
    stark.eval(frame, consumer, A)

    degree = _poly_degree(consumer.accumulators()[0])
    maximum = max(WITNESS_SIZE * stark.constraint_degree() - 1, 0)
    assert degree <= maximum, (
        f"constraint degree {degree} exceeds {WITNESS_SIZE}*"
        f"{stark.constraint_degree()}-1 = {maximum}"
    )


def test_stark_algebra_consistency(stark: Stark, seed=0) -> None:
    """Host-extension vs in-circuit constraint agreement on random frames
    (the single-source analogue of test_stark_circuit_constraints,
    stark_testing.rs:77-160). Host code."""
    from ..gates.algebra import CircuitAlgebra
    from ..iop.generator import generate_partial_witness
    from ..iop.witness import PartialWitness
    from ..plonk.circuit_builder import CircuitBuilder
    from ..plonk.config import CircuitConfig

    rng = np.random.default_rng(seed)

    def rand_ext():
        return (
            int(rng.integers(0, gl.P, dtype=np.uint64)),
            int(rng.integers(0, gl.P, dtype=np.uint64)),
        )

    C = stark.num_columns()
    local = [rand_ext() for _ in range(C)]
    nxt = [rand_ext() for _ in range(C)]
    pis = [
        int(rng.integers(0, gl.P, dtype=np.uint64))
        for _ in range(stark.num_public_inputs())
    ]
    alphas = [rand_ext(), rand_ext()]
    z_last, l_first, l_last = rand_ext(), rand_ext(), rand_ext()

    # host
    HA = HostExtAlgebra()
    frame = StarkFrame(local, nxt, [HA.const(p) for p in pis])
    consumer = ConstraintConsumer(HA, alphas, z_last, l_first, l_last)
    stark.eval(frame, consumer, HA)
    host_accs = consumer.accumulators()

    # circuit
    b = CircuitBuilder(CircuitConfig.standard_recursion_config())
    CA = CircuitAlgebra(b)

    def const_ext(e):
        return b.constant_extension(tuple(e))

    frame_t = StarkFrame(
        [const_ext(e) for e in local],
        [const_ext(e) for e in nxt],
        [CA.const(p) for p in pis],
    )
    consumer_t = ConstraintConsumer(
        CA,
        [const_ext(a) for a in alphas],
        const_ext(z_last),
        const_ext(l_first),
        const_ext(l_last),
    )
    stark.eval(frame_t, consumer_t, CA)
    acc_targets = consumer_t.accumulators()
    out_targets = [b.add_virtual_extension_target() for _ in acc_targets]
    for o, a in zip(out_targets, acc_targets):
        b.connect_extension(o, a)
    data = b.build(commit=False)
    witness = generate_partial_witness(PartialWitness(), data.prover_only, data.common)
    for o, expected in zip(out_targets, host_accs):
        got = tuple(witness.get_target(t) for t in o.parts)
        assert got == tuple(expected), f"circuit {got} != host {expected}"

"""STARK vanishing-polynomial evaluation at one point, and the fork's
constraint-binding step (reference: starky/src/vanishing_poly.rs,
prover.rs:263-370; plonky2_tpu/stark/vanishing.py). Host code: the
evaluation over the whole LDE coset runs the same ``eval_vanishing_generic``
on DeviceBatchAlgebra (stark/prover.py)."""

from __future__ import annotations

from typing import List, Tuple

from ..field import extension as ge
from ..field import goldilocks as gl
from ..gates.algebra import HostExtAlgebra
from ..utils.bits import log2_ceil
from .proof import StarkOpeningSet
from .stark import ConstraintConsumer, Stark, StarkFrame

Ext = Tuple[int, ...]


def eval_vanishing_generic(stark: Stark, frame: StarkFrame, consumer, A) -> None:
    """Single-source constraint accumulation over any algebra A
    (vanishing_poly.rs:28-95): the STARK's own constraints. The logUp and
    cross-table lookup constraints join here with those arguments
    (ROADMAP A14b)."""
    stark.eval(frame, consumer, A)


def eval_l_0_and_l_last(log_n: int, x: Ext) -> Tuple[Ext, Ext]:
    """(vanishing_poly.rs:99-106)."""
    n = 1 << log_n
    g = gl.primitive_root_of_unity(log_n)
    z_x = ge.ext_sub(ge.ext_exp(x, n), ge.ext_one(2))
    one = ge.ext_one(2)
    d0 = ge.ext_scalar_mul(ge.ext_sub(x, one), n)
    dl = ge.ext_scalar_mul(ge.ext_sub(ge.ext_scalar_mul(x, g), one), n)
    return ge.ext_mul(z_x, ge.ext_inv(d0)), ge.ext_mul(z_x, ge.ext_inv(dl))


def eval_vanishing_at_point(
    stark: Stark,
    openings: StarkOpeningSet,
    public_inputs: List[int],
    alphas: List[int],
    zeta: Ext,
    degree_bits: int,
) -> List[Ext]:
    """Host exact single-point evaluation (verifier + binding step)."""
    A = HostExtAlgebra()
    l_0, l_last = eval_l_0_and_l_last(degree_bits, zeta)
    g = gl.primitive_root_of_unity(degree_bits)
    last = gl.gexp(g, (1 << degree_bits) - 1)
    z_last = ge.ext_sub(zeta, ge.from_base(last, 2))
    frame = StarkFrame(
        local_values=[tuple(v) for v in openings.local_values],
        next_values=[tuple(v) for v in openings.next_values],
        public_inputs=[A.const(p) for p in public_inputs],
    )
    consumer = ConstraintConsumer(
        A, [A.const(a) for a in alphas], z_last, l_0, l_last
    )
    eval_vanishing_generic(stark, frame, consumer, A)
    return consumer.accumulators()


# ---------------------------------------------------------------------------
# Constraint-binding helpers (fork hardening; prover.rs:263-370)
# ---------------------------------------------------------------------------


def binding_dummy_openings(stark: Stark, challenger) -> Tuple[StarkOpeningSet, List[Ext]]:
    """Sample simulated trace opening values from the challenger (no
    auxiliary polynomials without lookups)."""
    C = stark.num_columns()
    total = C * 2
    pow_degree = max(2, stark.constraint_degree() + 1)
    num_extension_powers = max(1, 50 // log2_ceil(pow_degree) - 1)
    num_zetas = -(-total // num_extension_powers)
    zetas = [challenger.get_extension_challenge(2) for _ in range(num_zetas)]
    nb_per_zeta = min(num_extension_powers + 1, total)
    dummy: List[Ext] = []
    for z in zetas:
        cur = z
        for _ in range(nb_per_zeta):
            dummy.append(cur)
            cur = ge.ext_exp(cur, pow_degree)
    openings = StarkOpeningSet(
        local_values=dummy[:C],
        next_values=dummy[C : 2 * C],
        auxiliary_polys=None,
        auxiliary_polys_next=None,
        ctl_zs_first=None,
        quotient_polys=None,
    )
    return openings, zetas


def run_binding_step(
    stark: Stark,
    challenger,
    public_inputs: List[int],
    alphas_prime: List[int],
    degree_bits: int,
) -> List[int]:
    """Binding: evaluate constraints on simulated values at a random point,
    observe, then draw the real alphas. Returns stark_alphas."""
    dummy_openings, _zetas = binding_dummy_openings(stark, challenger)
    zeta_prime = challenger.get_extension_challenge(2)
    constraints = eval_vanishing_at_point(
        stark, dummy_openings, public_inputs, alphas_prime, zeta_prime, degree_bits
    )
    challenger.observe_extension_elements(constraints)
    return challenger.get_n_challenges(len(alphas_prime))

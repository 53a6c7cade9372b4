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
from .cross_table_lookup import build_ctl_check_vars, eval_cross_table_lookup_checks
from .lookup import GrandProductChallenge, LookupCheckVars, eval_lookups
from .proof import StarkOpeningSet
from .stark import ConstraintConsumer, Stark, StarkFrame

Ext = Tuple[int, ...]


def eval_vanishing_generic(
    stark: Stark, frame: StarkFrame, consumer, A, lookup_vars=None, ctl_vars=None
) -> None:
    """Single-source constraint accumulation over any algebra A: the
    STARK's own constraints, then logUp lookups, then CTLs
    (vanishing_poly.rs:28-95)."""
    stark.eval(frame, consumer, A)
    if lookup_vars is not None:
        eval_lookups(stark, stark.lookups(), frame, lookup_vars, consumer, A)
    if ctl_vars is not None:
        eval_cross_table_lookup_checks(
            frame, ctl_vars, consumer, A, stark.constraint_degree()
        )


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
    lookup_challenges: List[int] = None,
    num_lookup_columns: int = 0,
    ctl_entries=None,
    ctl_challenges=None,
) -> List[Ext]:
    """Host exact single-point evaluation (verifier + binding step).
    ctl_entries/ctl_challenges: static CTL layout + GrandProductChallengeSet
    (int β/γ); CtlCheckVars are built from the aux openings."""
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
    lookup_vars = None
    if lookup_challenges is not None:
        lookup_vars = LookupCheckVars(
            local_values=[tuple(v) for v in openings.auxiliary_polys[:num_lookup_columns]],
            next_values=[tuple(v) for v in openings.auxiliary_polys_next[:num_lookup_columns]],
            challenges=[A.const(c) for c in lookup_challenges],
        )
    ctl_vars = None
    if ctl_entries:
        chal_elems = [
            GrandProductChallenge(A.const(c.beta), A.const(c.gamma))
            for c in ctl_challenges.challenges
        ]
        ctl_vars = build_ctl_check_vars(
            ctl_entries,
            [tuple(v) for v in openings.auxiliary_polys],
            [tuple(v) for v in openings.auxiliary_polys_next],
            num_lookup_columns,
            chal_elems,
        )
    eval_vanishing_generic(stark, frame, consumer, A, lookup_vars, ctl_vars)
    return consumer.accumulators()


# ---------------------------------------------------------------------------
# Constraint-binding helpers (fork hardening; prover.rs:263-370)
# ---------------------------------------------------------------------------


def binding_dummy_openings(
    stark: Stark, challenger, num_aux: int = 0
) -> Tuple[StarkOpeningSet, List[Ext]]:
    """Sample simulated trace/aux opening values from the challenger."""
    C = stark.num_columns()
    total = C * 2 + num_aux * 2
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
        auxiliary_polys=dummy[2 * C : 2 * C + num_aux] if num_aux else None,
        auxiliary_polys_next=dummy[2 * C + num_aux : 2 * C + 2 * num_aux] if num_aux else None,
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
    num_aux: int = 0,
    lookup_challenges: List[int] = None,
    num_lookup_columns: int = 0,
    ctl_entries=None,
    ctl_challenges=None,
) -> List[int]:
    """Binding: evaluate constraints on simulated values at a random point,
    observe, then draw the real alphas. Returns stark_alphas."""
    dummy_openings, _zetas = binding_dummy_openings(stark, challenger, num_aux)
    zeta_prime = challenger.get_extension_challenge(2)
    constraints = eval_vanishing_at_point(
        stark,
        dummy_openings,
        public_inputs,
        alphas_prime,
        zeta_prime,
        degree_bits,
        lookup_challenges=lookup_challenges,
        num_lookup_columns=num_lookup_columns,
        ctl_entries=ctl_entries,
        ctl_challenges=ctl_challenges,
    )
    challenger.observe_extension_elements(constraints)
    return challenger.get_n_challenges(len(alphas_prime))

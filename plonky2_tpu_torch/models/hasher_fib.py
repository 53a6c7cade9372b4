"""The circuit the hasher bundles are held to: fib(11) with x0 = 0, x1 = 1
and the result public, under a small FRI configuration (the JAX package's
tests/test_generic_config.py::_build and _small_config).

Both functions take the modules they build with, so the same code builds
the circuit in this package (the defaults) and in the JAX package
(tools/gen_hasher_pins.py passes that package's modules).
"""

from __future__ import annotations


def small_config(fri_config=None, circuit_config=None):
    """_small_config: 25 security bits, rate 1/8, cap height 1, 2 PoW bits,
    arity 16, 8 queries. fri_config / circuit_config: the modules
    fri.config and plonk.config (this package's if None)."""
    if fri_config is None:
        from ..fri import config as fri_config
    if circuit_config is None:
        from ..plonk import config as circuit_config
    return circuit_config.CircuitConfig(
        security_bits=25,
        fri_config=fri_config.FriConfig(
            rate_bits=3,
            cap_height=1,
            proof_of_work_bits=2,
            reduction_strategy=fri_config.FriReductionStrategy.ConstantArityBits(4, 5),
            num_query_rounds=8,
        ),
    )


def build_fib(gc, config=None, builder=None, witness=None, **build_kwargs):
    """_build under the bundle ``gc``: (data, pw). config: small_config()
    if None; builder / witness: the modules plonk.circuit_builder and
    iop.witness (this package's if None); build_kwargs go to build (this
    package's takes device=)."""
    if builder is None:
        from ..plonk import circuit_builder as builder
    if witness is None:
        from ..iop import witness
    b = builder.CircuitBuilder(config if config is not None else small_config())
    x0 = b.add_virtual_target()
    x1 = b.add_virtual_target()
    b.register_public_input(x0)
    b.register_public_input(x1)
    cur, nxt = x0, x1
    for _ in range(10):
        cur, nxt = nxt, b.add(cur, nxt)
    b.register_public_input(nxt)
    data = b.build(gc=gc, **build_kwargs)
    pw = witness.PartialWitness()
    pw.set_target(x0, 0)
    pw.set_target(x1, 1)
    return data, pw

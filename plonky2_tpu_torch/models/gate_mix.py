"""The gate-mix circuit: every gate of the package's PLONK front end at a
chosen degree, the full-width test of the quotient's gate evaluation.

A block is the gadget soup of the native witness-generation tests
(arithmetic, inverse, ``is_equal``, ``split_le`` → BaseSumGate,
``random_access`` → RandomAccessGate, ``exp``/``exp_u64`` →
ExponentiationGate, ``select``, ``hash_n_to_hash_no_pad`` → PoseidonGate,
``inverse_extension`` → Arithmetic/MulExtensionGate, ``interpolate_coset``
→ CosetInterpolationGate), plus four lookups into ``TIP5_TABLE``
(LookupGate, LookupTableGate), one ``range_check`` and a
``ReducingFactorTarget`` ``reduce_base`` and ``reduce`` over 32 terms each
(ReducingGate, ReducingExtensionGate). Blocks repeat, with witness values
drawn from a fixed seed, until the gate rows pass half the asked degree
(with zero knowledge: until they and the blinding rows fill it).

``build_gate_mix`` builds the same circuit from any set of modules with
this package's front-end layout: by default this package's own
(``port_modules``); a caller that holds another such package (a reference
implementation) imports its modules itself and passes them as ``modules``,
a dict with the keys of ``port_modules``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

SEED = 0x9A7E
REDUCE_TERMS = 32
BLOCK_ROWS = 11  # gate rows a block adds, about


def port_modules() -> dict:
    """This package's modules that the gate mix is built from, by role."""
    from ..fri import config as fri_config
    from ..gates import interpolation
    from ..iop import target, witness
    from ..plonk import circuit_builder, config, gadgets, lookup_tables

    return {
        "builder": circuit_builder,
        "config": config,
        "fri_config": fri_config,
        "gadgets": gadgets,
        "tables": lookup_tables,
        "interpolation": interpolation,
        "target": target,
        "witness": witness,
    }


def zk_config(modules: Optional[dict] = None):
    """The zero-knowledge config of the zk tests (8 queries, 1 PoW bit,
    cap height 2): under ``standard_recursion_config`` the blinding rows
    alone (2,774 regular + 2 * 2,776 Z rows) force a degree of 2^14."""
    m = modules if modules is not None else port_modules()
    fri = m["fri_config"]
    return m["config"].CircuitConfig(
        zero_knowledge=True,
        security_bits=25,
        fri_config=fri.FriConfig(
            rate_bits=3,
            cap_height=2,
            proof_of_work_bits=1,
            reduction_strategy=fri.FriReductionStrategy.ConstantArityBits(4, 5),
            num_query_rounds=8,
        ),
    )


def _block(b, lut_index: int, rng, pw, m):
    """One block of gadgets; sets its witness inputs in ``pw``."""
    ExtensionTarget = m["target"].ExtensionTarget
    x = b.add_virtual_target()
    y = b.add_virtual_target()
    lst = [b.add_virtual_target() for _ in range(8)]
    idx = b.add_virtual_target()
    lk = [b.add_virtual_target() for _ in range(4)]
    pw.set_target(x, int(rng.integers(1, 1 << 40)))
    pw.set_target(y, int(rng.integers(1, 1 << 62)))
    pw.set_target(idx, int(rng.integers(0, 8)))
    for t in lst:
        pw.set_target(t, int(rng.integers(0, 1 << 63)))
    for t in lk:
        pw.set_target(t, int(rng.integers(0, 256)))

    prod = b.mul(b.add(x, y), b.sub(x, y))
    inv = b.inverse(x)
    eq = b.is_equal(x, y)
    bits = b.split_le(x, 40)
    picked = b.random_access(idx, lst)
    e1 = b.exp(x, idx, 3)
    e2 = b.exp_u64(y, 0x12345)
    sel = b.select(eq, x, y)
    h = b.hash_n_to_hash_no_pad([x, y, sel, lst[0], lst[7], prod, inv, picked, e1, e2])
    ex = ExtensionTarget((x, y))
    einv = b.inverse_extension(ex)
    gate = m["interpolation"].CosetInterpolationGate(2, 6)
    vals = [ExtensionTarget((lst[2 * i], lst[2 * i + 1])) for i in range(4)]
    ev = b.interpolate_coset(gate, b.one(), vals, ex)
    outs = [b.add_lookup_from_index(t, lut_index) for t in lk]
    b.range_check(outs[0], 8)

    rf = m["gadgets"].ReducingFactorTarget(einv)
    base_terms = [t.target for t in bits[:REDUCE_TERMS]]
    r1 = rf.reduce_base(b, base_terms)
    ext_terms = [
        ExtensionTarget((bits[i % 40].target, h[i % 4])) for i in range(REDUCE_TERMS - 2)
    ] + [ev, ExtensionTarget((outs[1], outs[2]))]
    r2 = rf.reduce(b, ext_terms)
    return [r1.parts[0], r2.parts[1], outs[3], h[0]]


def build_gate_mix(log2_degree: int, zero_knowledge: bool = False, device=None,
                   modules: Optional[dict] = None):
    """Returns (circuit_data, partial_witness) of the gate-mix circuit of
    degree 2^log2_degree. zero_knowledge takes ``zk_config``, else the
    unchanged ``standard_recursion_config``. device: see
    CircuitBuilder.build (None means the GPU); left at None for modules
    whose build takes no device."""
    m = modules if modules is not None else port_modules()
    if zero_knowledge:
        config = zk_config(m)
    else:
        config = m["config"].CircuitConfig.standard_recursion_config()
    b = m["builder"].CircuitBuilder(config)
    pw = m["witness"].PartialWitness()
    rng = np.random.default_rng(SEED)
    table = m["tables"].TIP5_TABLE
    lut_index = b.add_lookup_table_from_table(list(range(len(table))), list(table))
    last = _block(b, lut_index, rng, pw, m)
    blocks = 1
    if zero_knowledge:
        # blinding rows join at build: fill what they leave of 2^log2_degree,
        # less the rows the build adds (public-input hash, constants, the
        # lookup and table rows)
        regular, zs = b._num_blinding_gates(1 << log2_degree)
        room = (1 << log2_degree) - regular - 2 * zs
        while b.num_gates() + 2 * BLOCK_ROWS + 48 + blocks // 8 <= room:
            last = _block(b, lut_index, rng, pw, m)
            blocks += 1
    else:
        while b.num_gates() <= 1 << (log2_degree - 1):
            last = _block(b, lut_index, rng, pw, m)
    for t in last:
        b.register_public_input(t)
    data = b.build() if device is None else b.build(device=device)
    if data.common.degree_bits != log2_degree:
        raise ValueError(
            f"gate mix came out at degree 2^{data.common.degree_bits}, "
            f"not 2^{log2_degree}"
        )
    return data, pw


def gate_counts(data) -> dict:
    """Rows of each gate type in a built circuit (gate id -> count)."""
    counts: dict = {}
    for inst in data.prover_only.gate_instances:
        key = type(inst.gate).__name__
        counts[key] = counts.get(key, 0) + 1
    return counts



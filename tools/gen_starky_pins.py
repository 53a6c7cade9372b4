"""Pin the JAX package's Starky values (logUp lookups, cross-table lookups,
zero-knowledge STARKs) that the PyTorch port is held to.

Runs ``plonky2_tpu`` (the reference) on the CPU and writes JSON goldens
under ``tests/golden/`` (proofs as ``plonky2_tpu_torch.utils.serialization.int_tree``,
field by field):

* ``lookup``: ``torch_starky_lookup_2^5.json``, the PermutationStark proof
  of ``tests/test_stark_lookup.py::test_permutation_stark_lookup_e2e``
  (2^5 rows, ``generate_trace(3)``, public input 3,
  ``StarkConfig.standard_fast_config()``);
* ``ctl``: ``torch_starky_ctl_5_7.json``, the two proofs of
  ``tests/test_stark_ctl.py::test_ctl_two_table_e2e`` (a CtlLookingStark of
  2^5 rows whose two columns look into the flagged rows of a
  CtlLookedStark of 2^7 rows, shuffled by ``default_rng(0)``);
* ``zk``: ``torch_starky_zk_2^5.json``, the zero-knowledge FibonacciStark
  proof of ``tests/test_stark_zk.py`` (2^5 rows) with the salts pinned by
  ``PLONKY2_TPU_SALT_SEED`` and the trace mask R drawn from
  ``numpy.random.default_rng(MASK_SEED)``: the reference draws R from an
  unseeded generator, so this tool substitutes the seeded one for the
  duration of the prove (the JAX package is not changed);
* ``shapes``: ``torch_starky_lookup_outer_2^5_shape.json`` and
  ``torch_starky_lookup_outer_2^22_shape.json``, the circuits that verify a
  PermutationStark proof of 2^5 and of 2^22 rows under
  ``StarkConfig.standard_fast_config()``, built under
  ``standard_recursion_config`` without their commitment
  (``plonky2_tpu_torch/models/bench_recursion.circuit_shape``).

The reference's proves run op by op (``jax.disable_jit``, as
``tools/gen_batch_pins.py`` does). Run from the repo root; parts run in
separate processes may be run side by side:

    JAX_PLATFORMS=cpu python3 tools/gen_starky_pins.py                 # all
    JAX_PLATFORMS=cpu python3 tools/gen_starky_pins.py --only lookup zk
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# XLA:CPU's fusion pass miscompiles some fused kernels into infinite loops
# on some hosts (tests/conftest.py); always disable it here.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_disable_hlo_passes" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_disable_hlo_passes=fusion").strip()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
GOLDEN = os.path.join(REPO, "tests", "golden")

LOOKUP_LOG_ROWS = 5
LOOKUP_X0 = 3
CTL_LOG_ROWS = [5, 7]
CTL_X0 = 100
CTL_SHUFFLE_SEED = 0
ZK_LOG_ROWS = 5
ZK_SALT_SEED = 1234
ZK_MASK_SEED = 4321
OUTER_LOG_ROWS = [5, 22]


def _write(name: str, obj) -> None:
    path = os.path.join(GOLDEN, name)
    blob = json.dumps(obj, sort_keys=True) + "\n"
    with open(path, "w") as f:
        f.write(blob)
    print(f"  wrote {os.path.relpath(path, REPO)} ({len(blob)} B)", flush=True)


def zk_config(stark_config, fri_config):
    """tests/test_stark_zk.py:20-31."""
    return stark_config.StarkConfig(
        security_bits=1,
        num_challenges=2,
        fri_config=fri_config.FriConfig(
            rate_bits=1,
            cap_height=1,
            proof_of_work_bits=1,
            reduction_strategy=fri_config.FriReductionStrategy.ConstantArityBits(1, 2),
            num_query_rounds=8,
        ),
    )


def ctl_system(fixtures, lookup, ctl, log_rows=CTL_LOG_ROWS, x0=CTL_X0, seed=CTL_SHUFFLE_SEED):
    """tests/test_stark_ctl.py:21-41 over either package's modules: both
    value columns of table 0 look into the flagged rows of table 1.
    Returns (starks, traces, cross-table lookups)."""
    import numpy as np

    stark_a = fixtures.CtlLookingStark(1 << log_rows[0])
    stark_b = fixtures.CtlLookedStark(1 << log_rows[1])
    trace_a = stark_a.generate_trace(x0)
    values = [int(v) for v in trace_a[0]] + [int(v) for v in trace_a[1]]
    rng = np.random.default_rng(seed)
    values = [values[i] for i in rng.permutation(len(values))]
    trace_b = stark_b.generate_trace(values)
    ctls = [
        ctl.CrossTableLookup(
            looking_tables=[
                ctl.TableWithColumns(0, [lookup.Column.single(0)], lookup.Filter.default()),
                ctl.TableWithColumns(0, [lookup.Column.single(1)], lookup.Filter.default()),
            ],
            looked_table=ctl.TableWithColumns(
                1, [lookup.Column.single(0)], lookup.Filter.new_simple(lookup.Column.single(1))
            ),
        )
    ]
    return [stark_a, stark_b], [trace_a, trace_b], ctls


class _Ref:
    """The reference's modules, imported on first use."""

    def __init__(self):
        import importlib
        import types

        def mod(path):
            return importlib.import_module(f"plonky2_tpu.{path}")

        self.stark = types.SimpleNamespace(
            config=mod("stark.config"), fixtures=mod("stark.fixtures"),
            lookup=mod("stark.lookup"), ctl=mod("stark.cross_table_lookup"),
            multi=mod("stark.multi"), prover=mod("stark.prover"),
            verifier=mod("stark.verifier"), recursive_verifier=mod("stark.recursive_verifier"),
        )
        self.fri_config = mod("fri.config")
        self.builder = mod("plonk.circuit_builder")
        self.circuit_config = mod("plonk.config")


def pin_lookup(ref) -> None:
    import jax

    from plonky2_tpu_torch.utils.serialization import int_tree

    print(f"PermutationStark of 2^{LOOKUP_LOG_ROWS} rows", flush=True)
    st = ref.stark
    stark = st.fixtures.PermutationStark(1 << LOOKUP_LOG_ROWS)
    config = st.config.StarkConfig.standard_fast_config()
    trace = stark.generate_trace(LOOKUP_X0)
    t = time.time()
    with jax.disable_jit():
        pwp = st.prover.prove(stark, config, trace, [LOOKUP_X0])
    print(f"  proved in {time.time() - t:.1f} s", flush=True)
    st.verifier.verify_stark_proof(stark, pwp, config, LOOKUP_LOG_ROWS)
    _write(f"torch_starky_lookup_2^{LOOKUP_LOG_ROWS}.json",
           {"log_rows": LOOKUP_LOG_ROWS, "x0": LOOKUP_X0, "proof": int_tree(pwp)})


def pin_ctl(ref) -> None:
    import jax

    from plonky2_tpu_torch.utils.serialization import int_tree

    print(f"CTL system of 2^{CTL_LOG_ROWS[0]} and 2^{CTL_LOG_ROWS[1]} rows", flush=True)
    st = ref.stark
    starks, traces, ctls = ctl_system(st.fixtures, st.lookup, st.ctl)
    config = st.config.StarkConfig.standard_fast_config()
    t = time.time()
    with jax.disable_jit():
        proofs = st.multi.prove_all_tables(starks, config, traces, [[], []], ctls)
    print(f"  proved in {time.time() - t:.1f} s", flush=True)
    st.multi.verify_all_tables(starks, config, proofs, ctls, CTL_LOG_ROWS)
    _write(f"torch_starky_ctl_{CTL_LOG_ROWS[0]}_{CTL_LOG_ROWS[1]}.json", {
        "log_rows": CTL_LOG_ROWS, "x0": CTL_X0, "shuffle_seed": CTL_SHUFFLE_SEED,
        "proofs": [int_tree(p) for p in proofs],
    })


def pin_zk(ref) -> None:
    import jax
    import numpy as np

    from plonky2_tpu_torch.utils.serialization import int_tree

    print(f"zero-knowledge FibonacciStark of 2^{ZK_LOG_ROWS} rows", flush=True)
    st = ref.stark
    n = 1 << ZK_LOG_ROWS
    stark = st.fixtures.FibonacciStark(n)
    config = zk_config(st.config, ref.fri_config)
    pis = [0, 1, st.fixtures.fibonacci_res(n, 0, 1)]
    os.environ["PLONKY2_TPU_SALT_SEED"] = str(ZK_SALT_SEED)
    unseeded = []
    default_rng = np.random.default_rng

    def seeded_mask_rng(seed=None):
        # the salts name their seed; the mask is the only unseeded draw
        if seed is None:
            unseeded.append(1)
            seed = ZK_MASK_SEED
        return default_rng(seed)

    np.random.default_rng = seeded_mask_rng
    t = time.time()
    try:
        with jax.disable_jit():
            pwp = st.prover.prove(stark, config, stark.generate_trace(0, 1), pis,
                                  zero_knowledge=True)
    finally:
        np.random.default_rng = default_rng
        del os.environ["PLONKY2_TPU_SALT_SEED"]
    print(f"  proved in {time.time() - t:.1f} s", flush=True)
    assert len(unseeded) == 1, f"{len(unseeded)} unseeded generators in one zk prove"
    st.verifier.verify_stark_proof(stark, pwp, config, ZK_LOG_ROWS, zero_knowledge=True)
    _write(f"torch_starky_zk_2^{ZK_LOG_ROWS}.json", {
        "log_rows": ZK_LOG_ROWS, "salt_seed": ZK_SALT_SEED, "mask_seed": ZK_MASK_SEED,
        "proof": int_tree(pwp),
    })


def pin_shapes(ref) -> None:
    from plonky2_tpu_torch.models.bench_recursion import circuit_shape

    st = ref.stark
    config = st.config.StarkConfig.standard_fast_config()
    rc = ref.circuit_config.CircuitConfig.standard_recursion_config()
    rv = st.recursive_verifier
    for log_rows in OUTER_LOG_ROWS:
        print(f"outer shape over a 2^{log_rows}-row PermutationStark", flush=True)
        t = time.time()
        stark = st.fixtures.PermutationStark(1 << log_rows)
        b = ref.builder.CircuitBuilder(rc)
        pt = rv.add_virtual_stark_proof_with_pis(b, stark, config, log_rows)
        rv.verify_stark_proof_circuit(b, stark, pt, config, log_rows)
        shape = circuit_shape(b.build(commit=False))
        print(f"  built in {time.time() - t:.1f} s: degree 2^{shape['degree_bits']}, "
              f"{shape['gate_rows']}", flush=True)
        _write(f"torch_starky_lookup_outer_2^{log_rows}_shape.json", shape)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parts = {"lookup": pin_lookup, "ctl": pin_ctl, "zk": pin_zk, "shapes": pin_shapes}
    ap.add_argument("--only", choices=sorted(parts), nargs="*", default=list(parts),
                    help="goldens to write (default: all)")
    args = ap.parse_args()
    ref = _Ref()
    for part in args.only:
        t = time.time()
        parts[part](ref)
        print(f"part {part}: {time.time() - t:.1f} s", flush=True)


if __name__ == "__main__":
    main()

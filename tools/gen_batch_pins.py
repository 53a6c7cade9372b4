"""Pin the JAX package's batch-FRI and batch-STARK values that the PyTorch
port is held to.

Runs ``plonky2_tpu`` (the reference) on the CPU and writes JSON goldens
under ``tests/golden/`` (proofs as ``plonky2_tpu_torch.utils.serialization.int_tree``,
field by field):

* ``tree``: ``torch_batch_tree.json``, the batch Merkle tree of
  ``tests/test_batch_fri.py::test_batch_merkle_tree_prove_verify`` (matrices
  of 64, 16 and 4 rows from seed 0, cap height 1): its cap, and the rows
  and sibling path of every leaf index;
* ``fri``: ``torch_batch_fri_roundtrip.json``, the proof of
  ``tests/test_batch_fri.py::test_batch_fri_roundtrip`` (degrees 8, 6, 4);
* ``fri_recursion``: ``torch_batch_fri_recursion.json``, the proof of
  ``tests/test_batch_fri_recursion.py`` (degrees 6, 4);
* ``stark``: ``torch_batch_stark_7_5.json``, the batch STARK proof of
  ``tests/test_batch_stark.py`` (FibonacciStark tables of 2^7 and 2^5 rows);
* ``single``: ``torch_stark_2^5.json``, the FibonacciStark proof of
  ``tests/test_stark_recursion.py::test_recursive_stark_verifier_constraints``
  (2^5 rows under ``StarkConfig.standard_fast_config()``);
* ``multi``: ``torch_stark_multi_degree.json``, the FibonacciStark proofs
  of ``tests/test_multi_degree_recursion.py`` at 2^5, 2^4 and 2^3 rows, their
  FRI transcripts padded for the unified verifier circuit of 2^5 rows;
* ``shapes``: ``torch_stark_outer_2^22_shape.json`` and
  ``torch_batch_stark_outer_22_18_14_shape.json``, the circuits that verify a
  2^22-row FibonacciStark proof and a batch STARK proof of 2^22, 2^18 and
  2^14 rows under ``StarkConfig.standard_fast_config()``, built under
  ``standard_recursion_config`` without their commitment
  (``plonky2_tpu_torch/models/bench_recursion.circuit_shape``).

The reference's proves run op by op (``jax.disable_jit``, as
``tools/gen_recursion_pins.py`` does). Run from the repo root; parts run in
separate processes may be run side by side:

    JAX_PLATFORMS=cpu python3 tools/gen_batch_pins.py                 # all
    JAX_PLATFORMS=cpu python3 tools/gen_batch_pins.py --only tree shapes
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

# tests/test_batch_fri.py, tests/test_batch_fri_recursion.py, tests/test_batch_stark.py
TREE_SHAPES = [(64, 3), (16, 2), (4, 5)]
TREE_CAP_HEIGHT = 1
FRI_DEGREE_BITS = [8, 6, 4]
FRI_GROUP_SIZES = [2, 2, 1]
FRI_RECURSION_DEGREE_BITS = [6, 4]
FRI_RECURSION_GROUP_SIZES = [2, 1]
STARK_DEGREE_BITS = [7, 5]
SINGLE_LOG_ROWS = 5
MULTI_DEGREE_BITS = [5, 4, 3]
OUTER_STARK_LOG_ROWS = 22
OUTER_BATCH_DEGREE_BITS = [22, 18, 14]


def _write(name: str, obj) -> None:
    path = os.path.join(GOLDEN, name)
    blob = json.dumps(obj, sort_keys=True) + "\n"
    with open(path, "w") as f:
        f.write(blob)
    print(f"  wrote {os.path.relpath(path, REPO)} ({len(blob)} B)", flush=True)


def fri_params(ref, degree_bits, arities, queries, cap_height, pow_bits):
    """The FriParams of the reference tests (a fixed arity schedule)."""
    fc = ref.fri.config
    return fc.FriParams(
        config=fc.FriConfig(
            rate_bits=1,
            cap_height=cap_height,
            proof_of_work_bits=pow_bits,
            reduction_strategy=fc.FriReductionStrategy.Fixed(list(arities)),
            num_query_rounds=queries,
        ),
        leaf_hiding=False,
        degree_bits=degree_bits,
        reduction_arity_bits=tuple(arities),
    )


def batch_stark_config(ref):
    """tests/test_batch_stark.py:21-32."""
    fc = ref.fri.config
    return ref.stark.config.StarkConfig(
        security_bits=1,
        num_challenges=2,
        fri_config=fc.FriConfig(
            rate_bits=1,
            cap_height=1,
            proof_of_work_bits=1,
            reduction_strategy=fc.FriReductionStrategy.Fixed([2, 2]),
            num_query_rounds=8,
        ),
    )


class _Ref:
    """The reference's modules, imported on first use."""

    def __init__(self):
        import importlib
        import types

        def mod(path):
            return importlib.import_module(f"plonky2_tpu.{path}")

        self.fri = types.SimpleNamespace(
            config=mod("fri.config"), structure=mod("fri.structure"),
            batch_oracle=mod("fri.batch_oracle"), verifier=mod("fri.verifier"),
        )
        self.stark = types.SimpleNamespace(
            config=mod("stark.config"), fixtures=mod("stark.fixtures"),
            batch_prover=mod("stark.batch_prover"),
            prover=mod("stark.prover"), verifier=mod("stark.verifier"),
            recursive_verifier=mod("stark.recursive_verifier"),
            batch_recursive_verifier=mod("stark.batch_recursive_verifier"),
        )
        self.gl = mod("field.goldilocks")
        self.ge = mod("field.extension")
        self.gf = mod("ops.gf")
        self.merkle = mod("ops.merkle")
        self.challenger = mod("hash.challenger")
        self.builder = mod("plonk.circuit_builder")
        self.circuit_config = mod("plonk.config")


def pin_tree(ref) -> None:
    import numpy as np

    print("batch tree", flush=True)
    rng = np.random.default_rng(0)
    mats = [rng.integers(0, ref.gl.P, size=s, dtype=np.uint64) for s in TREE_SHAPES]
    tree = ref.merkle.BatchDeviceMerkleTree.build(
        [ref.gf.from_u64(m) for m in mats], cap_height=TREE_CAP_HEIGHT
    )
    idx = np.arange(TREE_SHAPES[0][0])
    _write("torch_batch_tree.json", {
        "cap": [int(v) for v in tree.cap_u64().reshape(-1)],
        "rows": [[int(v) for v in r.reshape(-1)] for r in tree.values_batch(idx)],
        "paths": [int(v) for v in tree.prove_batch(idx).reshape(-1)],
    })


def _poly_eval_ext(ref, coeffs_u64, zeta):
    acc = ref.ge.ext_zero(2)
    for c in reversed([int(x) for x in coeffs_u64]):
        acc = ref.ge.ext_add(ref.ge.ext_mul(acc, zeta), ref.ge.from_base(c, 2))
    return acc


def batch_fri_proof(ref, degree_bits, group_sizes, params, seed):
    """The proof of the reference tests' batch-FRI roundtrip: random value
    groups from ``seed``, each opened at one zeta drawn after the cap.
    Returns (cap, zeta, openings, proof)."""
    import numpy as np

    st = ref.fri.structure
    rng = np.random.default_rng(seed)
    value_groups = [
        ref.gf.from_u64(rng.integers(0, ref.gl.P, size=(m, 1 << d), dtype=np.uint64))
        for m, d in zip(group_sizes, degree_bits)
    ]
    oracle = ref.fri.batch_oracle.BatchFriOracle.from_values(
        value_groups, params.config.rate_bits, False, params.config.cap_height
    )
    ch = ref.challenger.Challenger()
    ch.observe_cap(oracle.batch_merkle_tree.cap_u64())
    zeta = ch.get_extension_challenge(2)
    instances, openings = [], []
    for g, m in enumerate(group_sizes):
        coeffs = np.asarray(ref.gf.to_u64(oracle.polynomials[g]))
        evals = [_poly_eval_ext(ref, coeffs[j], zeta) for j in range(m)]
        for e in evals:
            ch.observe_extension_element(e)
        instances.append(st.FriInstanceInfo(
            oracles=[st.FriOracleInfo(m, False)],
            batches=[st.FriBatchInfo.from_polys(tuple(zeta), st.FriPolynomialInfo.from_range(0, 0, m))],
        ))
        openings.append(evals)
    proof = ref.fri.batch_oracle.prove_batch_openings(degree_bits, instances, oracle, ch, params)
    return oracle.batch_merkle_tree.cap_u64(), zeta, openings, proof


def _pin_fri(ref, name, degree_bits, group_sizes, params, seed) -> None:
    import jax

    from plonky2_tpu_torch.utils.serialization import int_tree

    print(f"batch FRI {degree_bits}", flush=True)
    t = time.time()
    with jax.disable_jit():
        cap, zeta, openings, proof = batch_fri_proof(ref, degree_bits, group_sizes, params, seed)
    print(f"  proved in {time.time() - t:.1f} s", flush=True)
    _write(name, {
        "degree_bits": degree_bits,
        "cap": int_tree(cap),
        "zeta": int_tree(zeta),
        "openings": int_tree(openings),
        "proof": int_tree(proof),
    })


def pin_fri(ref) -> None:
    params = fri_params(ref, FRI_DEGREE_BITS[0], [2, 2, 2], 10, 2, 2)
    _pin_fri(ref, "torch_batch_fri_roundtrip.json", FRI_DEGREE_BITS, FRI_GROUP_SIZES, params, 1)


def pin_fri_recursion(ref) -> None:
    params = fri_params(ref, FRI_RECURSION_DEGREE_BITS[0], [2, 2], 4, 1, 1)
    _pin_fri(ref, "torch_batch_fri_recursion.json", FRI_RECURSION_DEGREE_BITS,
             FRI_RECURSION_GROUP_SIZES, params, 7)


def pin_stark(ref) -> None:
    import jax

    from plonky2_tpu_torch.utils.serialization import int_tree

    print(f"batch STARK {STARK_DEGREE_BITS}", flush=True)
    fx = ref.stark.fixtures
    starks = [fx.FibonacciStark(1 << d) for d in STARK_DEGREE_BITS]
    traces = [s.generate_trace(0, 1) for s in starks]
    pis = [[0, 1, fx.fibonacci_res(1 << d, 0, 1)] for d in STARK_DEGREE_BITS]
    config = batch_stark_config(ref)
    t = time.time()
    with jax.disable_jit():
        proof = ref.stark.batch_prover.batch_prove(starks, config, traces, pis)
    print(f"  proved in {time.time() - t:.1f} s", flush=True)
    ref.stark.batch_prover.batch_verify(starks, config, proof)
    _write("torch_batch_stark_7_5.json", {"proof": int_tree(proof)})


def _prove_stark(ref, config, log_rows, params=None):
    """A FibonacciStark proof of 2^log_rows rows by the reference, op by
    op, checked by its host verifier; as an int_tree."""
    import jax

    from plonky2_tpu_torch.utils.serialization import int_tree

    fx = ref.stark.fixtures
    print(f"STARK proof of 2^{log_rows} rows", flush=True)
    stark = fx.FibonacciStark(1 << log_rows)
    pis = [0, 1, fx.fibonacci_res(1 << log_rows, 0, 1)]
    t = time.time()
    with jax.disable_jit():
        pwp = ref.stark.prover.prove(
            stark, config, stark.generate_trace(0, 1), pis, verifier_circuit_fri_params=params
        )
    print(f"  proved in {time.time() - t:.1f} s", flush=True)
    ref.stark.verifier.verify_stark_proof(
        stark, pwp, config, log_rows, verifier_circuit_fri_params=params
    )
    return int_tree(pwp)


def pin_single(ref) -> None:
    config = ref.stark.config.StarkConfig.standard_fast_config()
    _write(f"torch_stark_2^{SINGLE_LOG_ROWS}.json", _prove_stark(ref, config, SINGLE_LOG_ROWS))


def multi_degree_config(ref):
    """tests/test_multi_degree_recursion.py:29-43: arity-2 folds, so that
    degrees 3..5 take 1..3 fold steps."""
    fc = ref.fri.config
    return ref.stark.config.StarkConfig(
        security_bits=1,
        num_challenges=2,
        fri_config=fc.FriConfig(
            rate_bits=1,
            cap_height=1,
            proof_of_work_bits=1,
            reduction_strategy=fc.FriReductionStrategy.ConstantArityBits(1, 2),
            num_query_rounds=8,
        ),
    )


def pin_multi(ref) -> None:
    config = multi_degree_config(ref)
    params = config.fri_params(MULTI_DEGREE_BITS[0])
    _write("torch_stark_multi_degree.json",
           {str(d): _prove_stark(ref, config, d, params) for d in MULTI_DEGREE_BITS})


def pin_shapes(ref) -> None:
    from plonky2_tpu_torch.models.bench_recursion import circuit_shape

    fx = ref.stark.fixtures
    config = ref.stark.config.StarkConfig.standard_fast_config()
    rc = ref.circuit_config.CircuitConfig.standard_recursion_config()

    print(f"outer shape over a 2^{OUTER_STARK_LOG_ROWS}-row STARK", flush=True)
    t = time.time()
    rv = ref.stark.recursive_verifier
    stark = fx.FibonacciStark(1 << OUTER_STARK_LOG_ROWS)
    b = ref.builder.CircuitBuilder(rc)
    pt = rv.add_virtual_stark_proof_with_pis(b, stark, config, OUTER_STARK_LOG_ROWS)
    rv.verify_stark_proof_circuit(b, stark, pt, config, OUTER_STARK_LOG_ROWS)
    shape = circuit_shape(b.build(commit=False))
    print(f"  built in {time.time() - t:.1f} s: degree 2^{shape['degree_bits']}, "
          f"{shape['gate_rows']}", flush=True)
    _write(f"torch_stark_outer_2^{OUTER_STARK_LOG_ROWS}_shape.json", shape)

    name = "_".join(str(d) for d in OUTER_BATCH_DEGREE_BITS)
    print(f"outer shape over the batch STARK {OUTER_BATCH_DEGREE_BITS}", flush=True)
    t = time.time()
    brv = ref.stark.batch_recursive_verifier
    starks = [fx.FibonacciStark(1 << d) for d in OUTER_BATCH_DEGREE_BITS]
    b = ref.builder.CircuitBuilder(rc)
    pt = brv.add_virtual_batch_stark_proof(b, starks, config, OUTER_BATCH_DEGREE_BITS)
    brv.verify_batch_stark_proof_circuit(b, starks, pt, config, OUTER_BATCH_DEGREE_BITS)
    shape = circuit_shape(b.build(commit=False))
    print(f"  built in {time.time() - t:.1f} s: degree 2^{shape['degree_bits']}, "
          f"{shape['gate_rows']}", flush=True)
    _write(f"torch_batch_stark_outer_{name}_shape.json", shape)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parts = {"tree": pin_tree, "fri": pin_fri, "fri_recursion": pin_fri_recursion,
             "stark": pin_stark, "single": pin_single, "multi": pin_multi, "shapes": pin_shapes}
    ap.add_argument("--only", choices=sorted(parts), nargs="*", default=list(parts),
                    help="goldens to write (default: all)")
    args = ap.parse_args()
    ref = _Ref()
    for part in args.only:
        parts[part](ref)


if __name__ == "__main__":
    main()

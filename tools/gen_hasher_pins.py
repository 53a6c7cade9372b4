"""Pin the JAX package's values of the other hashers (Poseidon2, Keccak)
that the PyTorch port is held to.

Runs ``plonky2_tpu`` (the reference) on the CPU and writes under
``tests/golden/``:

* ``fib``: ``torch_{keccak,poseidon2}_fib_{proof,common}.bin``, the
  circuit of ``tests/test_generic_config.py::_build`` (fib(11) under its
  ``_small_config``; ``plonky2_tpu_torch/models/hasher_fib.py`` builds it
  with either package's modules) built and proven by the JAX package under
  ``keccak_goldilocks_config`` and ``poseidon2_goldilocks_config``;
* ``chain``: ``torch_poseidon2_chain_shape.json``, the shape
  (``plonky2_tpu_torch/models/bench_recursion.circuit_shape``) of a chain of
  ``CHAIN_PERMUTATIONS`` Poseidon2 permutations
  (``plonky2_tpu_torch/models/poseidon2_chain.add_chain``) under
  ``standard_recursion_config`` and ``poseidon2_goldilocks_config``, built
  without its commitment.

The reference's proves run op by op (``jax.disable_jit``, as
``tools/gen_batch_pins.py`` does): its XLA:CPU compile of the Poseidon2
gate's quotient program does not end within the test suite's clock. Run
from the repo root:

    JAX_PLATFORMS=cpu python3 tools/gen_hasher_pins.py                # all
    JAX_PLATFORMS=cpu python3 tools/gen_hasher_pins.py --only chain
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
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

# permutations of the pinned chain; chip_smoke.py proves the same chain at
# 2^12 + 1 permutations
CHAIN_PERMUTATIONS = 8
CONFIG_NAMES = {"keccak": "keccak_goldilocks_config", "poseidon2": "poseidon2_goldilocks_config"}


def _ref(path: str):
    return importlib.import_module(f"plonky2_tpu.{path}")


def pin_fib() -> None:
    import jax

    from plonky2_tpu_torch.models.hasher_fib import build_fib, small_config

    gcm = _ref("plonk.generic_config")
    ser = _ref("utils.serialization")
    config = small_config(_ref("fri.config"), _ref("plonk.config"))
    for short, name in CONFIG_NAMES.items():
        print(f"fib(11) under {name}", flush=True)
        gc = getattr(gcm, name)()
        t = time.time()
        data, pw = build_fib(gc, config, _ref("plonk.circuit_builder"), _ref("iop.witness"))
        with jax.disable_jit():
            pwp = _ref("plonk.prover").prove(data.prover_only, data.common, pw, gc=gc)
        _ref("plonk.verifier").verify(pwp, data.verifier_only, data.common, gc=gc)
        assert pwp.public_inputs[2] == 89
        print(f"  built, proved and verified in {time.time() - t:.1f} s", flush=True)
        proof = ser.proof_to_bytes(pwp, data.common)
        common = ser.common_data_to_bytes(data.common)
        for part, blob in (("proof", proof), ("common", common)):
            path = os.path.join(GOLDEN, f"torch_{short}_fib_{part}.bin")
            with open(path, "wb") as f:
                f.write(blob)
            print(f"  wrote {os.path.relpath(path, REPO)} ({len(blob)} B)", flush=True)
        print(f"  proof sha256 {hashlib.sha256(proof).hexdigest()}", flush=True)


def pin_chain() -> None:
    from plonky2_tpu_torch.models.bench_recursion import circuit_shape
    from plonky2_tpu_torch.models.poseidon2_chain import add_chain

    print(f"Poseidon2 chain of {CHAIN_PERMUTATIONS} permutations", flush=True)
    t = time.time()
    b = _ref("plonk.circuit_builder").CircuitBuilder(
        _ref("plonk.config").CircuitConfig.standard_recursion_config()
    )
    add_chain(b, CHAIN_PERMUTATIONS)
    gc = _ref("plonk.generic_config").poseidon2_goldilocks_config()
    shape = circuit_shape(b.build(commit=False, gc=gc))
    print(f"  built in {time.time() - t:.1f} s: degree 2^{shape['degree_bits']}, "
          f"{shape['gate_rows']}", flush=True)
    path = os.path.join(GOLDEN, "torch_poseidon2_chain_shape.json")
    blob = json.dumps(shape, sort_keys=True) + "\n"
    with open(path, "w") as f:
        f.write(blob)
    print(f"  wrote {os.path.relpath(path, REPO)} ({len(blob)} B)", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parts = {"fib": pin_fib, "chain": pin_chain}
    ap.add_argument("--only", choices=sorted(parts), nargs="*", default=list(parts),
                    help="goldens to write (default: all)")
    args = ap.parse_args()
    for part in args.only:
        t = time.time()
        parts[part]()
        print(f"part {part}: {time.time() - t:.1f} s", flush=True)


if __name__ == "__main__":
    main()

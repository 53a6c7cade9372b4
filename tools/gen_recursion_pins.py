"""Pin the JAX package's recursion proofs that the PyTorch port is held to.

Builds each recursive circuit with ``plonky2_tpu`` (the reference) on the
CPU, proves and verifies it there, and writes what the port's tests and
``chip_smoke.py`` compare against:

* ``outer``: the recursion benchmark's outer proof ("shrink 1",
  ``models/bench_recursion.recursive_proof``) over the degree-2^12 inner
  proof of ``tests/golden/bench_inner_2^12.bin``, under the unchanged
  ``standard_recursion_config``:
  ``tests/golden/torch_recursion_outer_2^12.bin`` (its common data,
  verifier data and proof, each behind an 8-byte little-endian length, the
  format of ``bench_inner_2^12.bin``) and
  ``tests/golden/torch_recursion_outer_2^12_compressed.bin`` (the
  compressed proof's bytes);
* ``shape``: ``tests/golden/torch_recursion_outer_2^12_shape.json``, the
  same outer circuit built without its commitment: its gates, the gate of
  every row, selectors, constants and sigmas
  (``plonky2_tpu_torch/models/bench_recursion.circuit_shape``);
* ``small``: under ``small_recursion_config`` (2 query rounds, 1 PoW bit,
  cap height 2), a NoopGate inner proof of degree 2^8 and the outer proof
  over it: ``tests/golden/torch_recursion_small_{inner,outer}_{proof,common}.bin``
  and ``torch_recursion_small_outer_compressed.bin``.

The reference proves op by op (``jax.disable_jit``, as
``tools/gen_gate_mix_pins.py`` does). Run from the repo root:

    JAX_PLATFORMS=cpu python3 tools/gen_recursion_pins.py                # all
    JAX_PLATFORMS=cpu python3 tools/gen_recursion_pins.py --only small shape
    JAX_PLATFORMS=cpu python3 tools/gen_recursion_pins.py --only outer_compressed
"""

from __future__ import annotations

import argparse
import hashlib
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

INNER_LOG2 = 12
SMALL_INNER_LOG2 = 8


def read_proof_tuple(ser, name: str):
    """(proof, verifier data, common data) of a golden in the format of
    bench_inner_2^12.bin (the port's utils/serialization.parts_from_bytes),
    read with the reference's serialization ``ser``."""
    from plonky2_tpu_torch.utils.serialization import parts_from_bytes

    with open(os.path.join(GOLDEN, name), "rb") as f:
        cd_b, vd_b, proof_b = parts_from_bytes(f.read())
    common = ser.common_data_from_bytes(cd_b)
    vd, _ = ser.verifier_data_from_bytes(vd_b)
    return ser.proof_from_bytes(proof_b, common), vd, common


def load_inner(ref):
    """The degree-2^12 inner proof, read and verified by the reference."""
    inner = read_proof_tuple(ref["ser"], f"bench_inner_2^{INNER_LOG2}.bin")
    ref["verifier"].verify(*inner)
    return inner


def _ref():
    import importlib

    return {
        name: importlib.import_module(f"plonky2_tpu.{path}")
        for name, path in [
            ("bench", "models.bench_recursion"),
            ("builder", "plonk.circuit_builder"),
            ("config", "plonk.config"),
            ("fri_config", "fri.config"),
            ("proof_target", "plonk.proof_target"),
            ("recursive_verifier", "plonk.recursive_verifier"),
            ("compressed", "plonk.compressed_proof"),
            ("verifier", "plonk.verifier"),
            ("ser", "utils.serialization"),
        ]
    }


def _write(name: str, blob: bytes) -> None:
    path = os.path.join(GOLDEN, name)
    with open(path, "wb") as f:
        f.write(blob)
    print(f"  wrote {os.path.relpath(path, REPO)} ({len(blob)} B, "
          f"sha256 {hashlib.sha256(blob).hexdigest()})", flush=True)


def _recursive_proof(ref, inner, config):
    """The reference's bench_recursion.recursive_proof, op by op: on
    XLA:CPU the compiles of some gates' quotient programs do not end within
    an hour, while the same operations run one at a time give the same
    words."""
    import jax

    t = time.time()
    with jax.disable_jit():
        out = ref["bench"].recursive_proof(inner, config)
    print(f"  built, proved and verified degree 2^{out[2].degree_bits} "
          f"in {time.time() - t:.1f} s", flush=True)
    return out


def _compressed_bytes(ref, pwp, vd, common) -> bytes:
    """The reference's compressed proof, as bytes. Its decompressor fails
    on proofs in which two queries meet in one coset of a folding step at
    different positions (it inserts the second query's inferred value into
    the first query's evaluations); the shrink-1 proof is one. Compression
    itself is not affected, so the bytes are pinned either way and the
    verdict of the reference's verify_compressed_proof is printed."""
    c = ref["compressed"].compress_proof(pwp, vd, common)
    try:
        ref["compressed"].verify_compressed_proof(c, vd, common)
        verdict = "accepts"
    except Exception as e:  # the reference's fault described above
        verdict = f"rejects ({type(e).__name__}: {e})"
    print(f"  the reference's verify_compressed_proof {verdict}", flush=True)
    return ref["ser"].compressed_proof_to_bytes(c, common)


def pin_outer(ref) -> None:
    print(f"outer over bench_inner_2^{INNER_LOG2}", flush=True)
    config = ref["config"].CircuitConfig.standard_recursion_config()
    from plonky2_tpu_torch.utils.serialization import parts_to_bytes

    pwp, vd, common = _recursive_proof(ref, load_inner(ref), config)
    ser = ref["ser"]
    _write(f"torch_recursion_outer_2^{INNER_LOG2}.bin", parts_to_bytes([
        ser.common_data_to_bytes(common),
        ser.verifier_data_to_bytes(vd, common),
        ser.proof_to_bytes(pwp, common),
    ]))
    pin_outer_compressed(ref)


def pin_outer_compressed(ref) -> None:
    """The compressed bytes of the pinned outer proof (no prove)."""
    print(f"outer over bench_inner_2^{INNER_LOG2}, compressed", flush=True)
    pwp, vd, common = read_proof_tuple(ref["ser"], f"torch_recursion_outer_2^{INNER_LOG2}.bin")
    ref["verifier"].verify(pwp, vd, common)
    _write(f"torch_recursion_outer_2^{INNER_LOG2}_compressed.bin",
           _compressed_bytes(ref, pwp, vd, common))


def pin_shape(ref) -> None:
    from plonky2_tpu_torch.models.bench_recursion import circuit_shape

    print(f"outer shape over bench_inner_2^{INNER_LOG2}", flush=True)
    t = time.time()
    _, _, inner_common = load_inner(ref)
    b = ref["builder"].CircuitBuilder(ref["config"].CircuitConfig.standard_recursion_config())
    pt = ref["proof_target"].add_virtual_proof_with_pis(b, inner_common)
    vd_t = ref["recursive_verifier"].add_virtual_verifier_data(
        b, inner_common.fri_params.config.cap_height)
    ref["recursive_verifier"].verify_proof_circuit(b, pt, vd_t, inner_common)
    shape = circuit_shape(b.build(commit=False))
    print(f"  built in {time.time() - t:.1f} s: degree 2^{shape['degree_bits']}, "
          f"{shape['gate_rows']}", flush=True)
    _write(f"torch_recursion_outer_2^{INNER_LOG2}_shape.json",
           (json.dumps(shape, sort_keys=True) + "\n").encode())


def pin_small(ref) -> None:
    import jax

    from plonky2_tpu_torch.models.bench_recursion import small_recursion_config

    print("small chain", flush=True)
    config = small_recursion_config(ref)
    ser = ref["ser"]
    t = time.time()
    with jax.disable_jit():
        inner = ref["bench"].dummy_proof(config, SMALL_INNER_LOG2)
    print(f"  inner degree 2^{inner[2].degree_bits} in {time.time() - t:.1f} s", flush=True)
    outer = _recursive_proof(ref, inner, config)
    for name, (pwp, vd, common) in (("inner", inner), ("outer", outer)):
        _write(f"torch_recursion_small_{name}_proof.bin", ser.proof_to_bytes(pwp, common))
        _write(f"torch_recursion_small_{name}_common.bin", ser.common_data_to_bytes(common))
    _write("torch_recursion_small_outer_compressed.bin", _compressed_bytes(ref, *outer))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parts = {"small": pin_small, "shape": pin_shape, "outer": pin_outer,
             "outer_compressed": pin_outer_compressed}
    ap.add_argument("--only", choices=sorted(parts), nargs="*",
                    default=["small", "shape", "outer"],
                    help="goldens to write (default: small, shape, outer; outer_compressed "
                         "compresses the pinned outer proof without proving it again)")
    args = ap.parse_args()
    ref = _ref()
    for part in args.only:
        parts[part](ref)


if __name__ == "__main__":
    main()

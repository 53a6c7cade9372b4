"""Pin the JAX package's proofs that the PyTorch port is held to.

Builds each circuit with ``plonky2_tpu`` (the reference) on the CPU, proves
and verifies it there, and writes or prints what the port's tests and
``chip_smoke.py`` compare against:

* ``tests/golden/torch_gate_mix_2^K_{proof,common}.bin``: the gate-mix
  circuit (``plonky2_tpu_torch/models/gate_mix.build_gate_mix``, the one
  function that builds it for both packages) at a small degree 2^K;
* ``tests/golden/torch_lookup_{proof,common}.bin``: the lookup circuit of
  ``tests/test_lookups.py`` with inputs [0, 3, 3, 7, 1];
* ``tests/golden/torch_zk_{proof,common}.bin``: the zero-knowledge circuit
  of ``tests/test_zk.py`` (one query round) with ``PLONKY2_TPU_SALT_SEED`` fixed and the
  blinding rows fed from ``iop.generator.fixed_random_values``;
* ``--digest K``: the SHA-256 of the gate-mix proof at degree 2^K, printed
  (``chip_smoke.py`` pins it).

The reference's CPU default is its host transcript; its prove runs op by op
(see ``_prove``), which takes minutes a circuit. Run from the repo root:

    JAX_PLATFORMS=cpu python3 tools/gen_gate_mix_pins.py             # goldens
    JAX_PLATFORMS=cpu python3 tools/gen_gate_mix_pins.py --digest 13 # a digest
"""

from __future__ import annotations

import argparse
import hashlib
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

SALT_SEED = 1234
BLINDING_SEED = 5678
LOOKUP_TABLE = [2, 24, 56, 100, 128, 16, 20, 49]
LOOKUP_INPUTS = [0, 3, 3, 7, 1]


def build_lookup(pkg, device=None):
    """The circuit of tests/test_lookups.py:16-31, built with ``pkg``'s
    modules (pkg: a dict of module objects, see ``_modules``)."""
    b = pkg["builder"].CircuitBuilder(pkg["config"].CircuitConfig.standard_recursion_config())
    lut_index = b.add_lookup_table_from_table(list(range(len(LOOKUP_TABLE))), LOOKUP_TABLE)
    in_ts, out_ts = [], []
    for _ in LOOKUP_INPUTS:
        t = b.add_virtual_target()
        in_ts.append(t)
        out_ts.append(b.add_lookup_from_index(t, lut_index))
    b.register_public_inputs(in_ts)
    b.register_public_inputs(out_ts)
    data = b.build() if device is None else b.build(device=device)
    pw = pkg["witness"].PartialWitness()
    for t, v in zip(in_ts, LOOKUP_INPUTS):
        pw.set_target(t, v)
    return data, pw


def build_zk(pkg, device=None):
    """The circuit of tests/test_zk.py:16-47 under its config cut to one
    query round (security_bits 4): its blinding rows then fit degree 2^8,
    where the 8 rounds of the original need 2^12, too slow a proof for a
    CPU test."""
    fri = pkg["fri_config"]
    config = pkg["config"].CircuitConfig(
        zero_knowledge=True,
        security_bits=4,
        fri_config=fri.FriConfig(
            rate_bits=3,
            cap_height=2,
            proof_of_work_bits=1,
            reduction_strategy=fri.FriReductionStrategy.ConstantArityBits(4, 5),
            num_query_rounds=1,
        ),
    )
    b = pkg["builder"].CircuitBuilder(config)
    x0 = b.add_virtual_target()
    x1 = b.add_virtual_target()
    b.register_public_input(x0)
    b.register_public_input(x1)
    cur, nxt = x0, x1
    for _ in range(20):
        cur, nxt = nxt, b.add(cur, nxt)
    b.register_public_input(nxt)
    data = b.build() if device is None else b.build(device=device)
    pw = pkg["witness"].PartialWitness()
    pw.set_target(x0, 0)
    pw.set_target(x1, 1)
    return data, pw


def _modules(root: str) -> dict:
    import importlib

    return {
        name: importlib.import_module(f"{root}.{path}")
        for name, path in [
            ("builder", "plonk.circuit_builder"),
            ("config", "plonk.config"),
            ("fri_config", "fri.config"),
            ("witness", "iop.witness"),
            ("gadgets", "plonk.gadgets"),
            ("tables", "plonk.lookup_tables"),
            ("interpolation", "gates.interpolation"),
            ("target", "iop.target"),
            ("generator", "iop.generator"),
            ("prover", "plonk.prover"),
            ("verifier", "plonk.verifier"),
            ("ser", "utils.serialization"),
        ]
    }


def _prove(pkg, data, pw):
    """Prove and verify; the prove runs op by op (``jax.disable_jit``): on
    XLA:CPU the compiles of the lookup terms' and some gates' quotient
    programs do not end within an hour, while the same operations run one
    at a time give the same words in minutes."""
    import jax

    t = time.time()
    with jax.disable_jit():
        pwp = pkg["prover"].prove(data.prover_only, data.common, pw)
    pkg["verifier"].verify(pwp, data.verifier_only, data.common)
    print(f"  proved and verified in {time.time() - t:.1f} s", flush=True)
    return pkg["ser"].proof_to_bytes(pwp, data.common), pkg["ser"].common_data_to_bytes(data.common)


def _write(name: str, proof: bytes, common: bytes) -> None:
    for part, blob in (("proof", proof), ("common", common)):
        path = os.path.join(GOLDEN, f"{name}_{part}.bin")
        with open(path, "wb") as f:
            f.write(blob)
        print(f"  wrote {os.path.relpath(path, REPO)} ({len(blob)} B)", flush=True)
    print(f"  {name} proof sha256 {hashlib.sha256(proof).hexdigest()}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gate-mix", type=int, nargs="*", default=None,
                    help="degrees (log2) of the gate-mix goldens (default: 8)")
    ap.add_argument("--digest", type=int, nargs="*", default=[],
                    help="degrees (log2) of gate-mix proofs to print digests of")
    ap.add_argument("--only", choices=["gate_mix", "lookup", "zk"], nargs="*",
                    default=None, help="goldens to write (default: all)")
    args = ap.parse_args()

    from plonky2_tpu_torch.iop.generator import fixed_random_values
    from plonky2_tpu_torch.models.gate_mix import build_gate_mix

    ref = _modules("plonky2_tpu")
    only = args.only if args.only is not None else (
        ["gate_mix", "lookup", "zk"] if not args.digest else []
    )
    if "gate_mix" in only:
        for k in args.gate_mix or [8]:
            print(f"gate_mix 2^{k}", flush=True)
            data, pw = build_gate_mix(k, modules=ref)
            _write(f"torch_gate_mix_2^{k}", *_prove(ref, data, pw))
    if "lookup" in only:
        print("lookup", flush=True)
        _write("torch_lookup", *_prove(ref, *build_lookup(ref)))
    if "zk" in only:
        print("zk", flush=True)
        os.environ["PLONKY2_TPU_SALT_SEED"] = str(SALT_SEED)
        with fixed_random_values(BLINDING_SEED, ref["generator"].RandomValueGenerator):
            _write("torch_zk", *_prove(ref, *build_zk(ref)))
        del os.environ["PLONKY2_TPU_SALT_SEED"]
    for k in args.digest:
        print(f"gate_mix 2^{k} digest", flush=True)
        t = time.time()
        data, pw = build_gate_mix(k, modules=ref)
        print(f"  built in {time.time() - t:.1f} s", flush=True)
        proof, _ = _prove(ref, data, pw)
        print(f"  gate_mix_2^{k} proof sha256 {hashlib.sha256(proof).hexdigest()}", flush=True)


if __name__ == "__main__":
    main()

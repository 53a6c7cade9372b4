"""bench_recursion: a dummy inner proof of 2^size gates, a chain of
shrinking recursive proofs, then serialization + compression checks
(reference: plonky2/examples/bench_recursion.rs:91-366).

Every entry point that builds or proves takes ``device=None``, which means
the GPU (it raises without one); the CPU is used only when asked for by name.

Run:  python3 -m plonky2_tpu_torch.models.bench_recursion --size 12
"""

from __future__ import annotations

import argparse
import hashlib
import time
from typing import Optional, Tuple

import numpy as np

from ..gates.basic import NoopGate
from ..iop.witness import PartialWitness
from ..plonk.circuit_builder import CircuitBuilder
from ..plonk.config import CircuitConfig
from ..plonk.proof_target import add_virtual_proof_with_pis, set_proof_with_pis_target
from ..plonk.prover import prove
from ..plonk.recursive_verifier import (
    add_virtual_verifier_data,
    set_verifier_data_target,
    verify_proof_circuit,
)
from ..plonk.verifier import verify
from ..utils.timing import TimingTree

ProofTuple = Tuple[object, object, object]  # (pwp, verifier_only, common)


def small_recursion_config(modules: Optional[dict] = None):
    """standard_recursion_config cut for proofs on the CPU: 2 query rounds,
    1 PoW bit, cap height 2 (security_bits 7 = 2 * 3 + 1). A NoopGate inner
    of 2^7 + 1 gates proves at degree 2^8 and its outer at 2^10.
    modules: a dict with the modules "config" and "fri_config" of another
    package of this layout (a reference implementation); None means this
    package's own."""
    if modules is None:
        from ..fri import config as fri
        from ..plonk import config
    else:
        fri, config = modules["fri_config"], modules["config"]
    return config.CircuitConfig(
        security_bits=7,
        fri_config=fri.FriConfig(
            rate_bits=3,
            cap_height=2,
            proof_of_work_bits=1,
            reduction_strategy=fri.FriReductionStrategy.ConstantArityBits(4, 5),
            num_query_rounds=2,
        ),
    )


def circuit_shape(data) -> dict:
    """What decides a built circuit's bytes before any commitment: its
    gates in order, the gate of every row, the selector layout, the
    constants and sigmas (as SHA-256 digests of their u64 words). Reads
    only attributes that both packages' CircuitData share, so the same
    function describes a reference circuit."""
    common, prover = data.common, data.prover_only
    gate_index = {g.id(): i for i, g in enumerate(common.gates)}
    rows = [gate_index[inst.gate.id()] for inst in prover.gate_instances]
    counts: dict = {}
    for inst in prover.gate_instances:
        key = type(inst.gate).__name__
        counts[key] = counts.get(key, 0) + 1
    consts = np.array(
        [
            [int(c) for c in inst.constants]
            + [0] * (common.num_constants - len(inst.constants))
            for inst in prover.gate_instances
        ],
        dtype=np.uint64,
    )
    sigmas = np.ascontiguousarray(np.asarray(prover.sigmas, dtype=np.uint64))
    return {
        "degree_bits": common.degree_bits,
        "gates": [g.id() for g in common.gates],
        "row_gates": rows,
        "gate_rows": counts,
        "num_constants": common.num_constants,
        "selector_indices": list(common.selectors_info.selector_indices),
        "selector_groups": [list(g) for g in common.selectors_info.groups],
        "num_partial_products": common.num_partial_products,
        "num_public_inputs": common.num_public_inputs,
        "gate_constants_sha256": hashlib.sha256(consts.tobytes()).hexdigest(),
        "sigmas_sha256": hashlib.sha256(sigmas.tobytes()).hexdigest(),
    }


def dummy_proof(config: CircuitConfig, log2_size: int, device=None) -> ProofTuple:
    """(bench_recursion.rs:91-122)."""
    assert log2_size >= 1
    num_dummy_gates = {1: 0, 2: 1}.get(log2_size, (1 << (log2_size - 1)) + 1)
    b = CircuitBuilder(config)
    for _ in range(num_dummy_gates):
        b.add_gate(NoopGate(), [])
    data = b.build(device=device)
    pwp = prove(data.prover_only, data.common, PartialWitness(), device=device)
    verify(pwp, data.verifier_only, data.common)
    return pwp, data.verifier_only, data.common


def recursive_circuit(inner_common, config: CircuitConfig, min_degree_bits=None,
                      commit: bool = True, device=None):
    """The outer circuit of ``recursive_proof``: it verifies one proof of
    ``inner_common``'s circuit. Returns (circuit data, proof target,
    verifier-data target)."""
    b = CircuitBuilder(config)
    pt = add_virtual_proof_with_pis(b, inner_common)
    vd_t = add_virtual_verifier_data(b, inner_common.fri_params.config.cap_height)
    verify_proof_circuit(b, pt, vd_t, inner_common)
    if min_degree_bits is not None:
        min_gates = (1 << (min_degree_bits - 1)) + 1
        while b.num_gates() < min_gates:
            b.add_gate(NoopGate(), [])
    return b.build(commit=commit, device=device), pt, vd_t


def recursive_witness(pt, vd_t, inner: ProofTuple) -> PartialWitness:
    inner_proof, inner_vd, _ = inner
    pw = PartialWitness()
    set_proof_with_pis_target(pw, pt, inner_proof)
    set_verifier_data_target(pw, vd_t, inner_vd)
    return pw


def recursive_proof(
    inner: ProofTuple, config: CircuitConfig, min_degree_bits=None, device=None
) -> ProofTuple:
    """(bench_recursion.rs:223-272)."""
    data, pt, vd_t = recursive_circuit(inner[2], config, min_degree_bits, device=device)
    pw = recursive_witness(pt, vd_t, inner)
    pwp = prove(data.prover_only, data.common, pw, device=device)
    verify(pwp, data.verifier_only, data.common)
    return pwp, data.verifier_only, data.common


def test_serialization(pwp, vd, common) -> dict:
    """Roundtrip the proof, compressed proof and common data through the
    wire format; returns size info (bench_recursion.rs:274-330)."""
    from ..plonk.compressed_proof import compress_proof, decompress_proof
    from ..utils.serialization import (
        common_data_from_bytes,
        common_data_to_bytes,
        compressed_proof_to_bytes,
        proof_from_bytes,
        proof_to_bytes,
    )

    raw = proof_to_bytes(pwp, common)
    back = proof_from_bytes(raw, common)
    assert back.public_inputs == pwp.public_inputs

    t0 = time.perf_counter()
    compressed = compress_proof(pwp, vd, common)
    decompressed = decompress_proof(compressed, vd, common)
    compress_s = time.perf_counter() - t0
    assert decompressed.public_inputs == pwp.public_inputs
    assert proof_to_bytes(decompressed, common) == raw

    cd_bytes = common_data_to_bytes(common)
    common2 = common_data_from_bytes(cd_bytes)
    assert common2.trace_degree_bits == common.trace_degree_bits

    return {
        "proof_bytes": len(raw),
        "compressed_proof_bytes": len(compressed_proof_to_bytes(compressed, common)),
        "compress_seconds": compress_s,
        "common_data_bytes": len(cd_bytes),
    }


def benchmark(config: CircuitConfig, log2_inner_size: int, verbose: bool = True, device=None):
    timing = TimingTree("bench_recursion", enabled=verbose)
    with timing.scope("inner dummy proof"):
        inner = dummy_proof(config, log2_inner_size, device=device)
    if verbose:
        print(f"inner degree: 2^{inner[2].degree_bits}")

    with timing.scope("recursive shrink 1"):
        middle = recursive_proof(inner, config, device=device)
    if verbose:
        print(f"single recursion degree: 2^{middle[2].degree_bits}")

    with timing.scope("recursive shrink 2"):
        outer = recursive_proof(middle, config, device=device)
    if verbose:
        print(f"double recursion degree: 2^{outer[2].degree_bits}")

    with timing.scope("serialization + compression"):
        info = test_serialization(*outer)
    if verbose:
        print(info)
        timing.print()
    return outer, info


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=12, help="log2 inner circuit size")
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args()
    benchmark(
        CircuitConfig.standard_recursion_config(), args.size, verbose=not args.quiet,
        device=args.device,
    )


if __name__ == "__main__":
    main()

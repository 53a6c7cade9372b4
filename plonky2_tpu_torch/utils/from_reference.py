"""State carried across from the JAX package, as numpy arrays.

The functions here take what the JAX package holds — field batches as
(lo, hi) u32 limb planes, a committed polynomial batch as its coefficient,
leaf and Merkle-level arrays, a built circuit as its serialized common
data plus the prover's tables — and return this package's objects. The
module imports neither the JAX package nor ``jax``: the caller extracts
the arrays (``np.asarray`` / ``gf.to_u64`` on that side) and hands them
over.

STARK proofs (their auxiliary-oracle and CTL openings included) and
``StarkConfig`` cross both ways as plain data (``to_plain`` /
``from_plain``), and so do the Poseidon2 gates and their generators, the
lookup and cross-table lookup descriptions (``Column``, ``Filter``,
``Lookup``, ``TableWithColumns``, ``CrossTableLookup``) and the STARK
fixtures (by class name and row count); a ``GenericConfig`` crosses by its
name, as the hasher bundle of that name.

Witness generation stays with whoever built the circuit: the generators
are Python objects of that package and are not carried over. A circuit
brought in here is proven from a full wire assignment
(``partial_witness_from_wire_values``), which the prover's own fixpoint
then merely checks for consistency.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..fri.oracle import PolynomialBatch
from ..iop.target import Target
from ..iop.witness import PartialWitness
from ..ops import gf
from ..ops.merkle import DeviceMerkleTree
from ..plonk.circuit_data import (
    CircuitData,
    ProverOnlyCircuitData,
    VerifierOnlyCircuitData,
)
from . import serialization


def gf_from_limbs(lo_u32, hi_u32, device) -> torch.Tensor:
    """(lo, hi) u32 limb planes -> one 64-bit plane on ``device``."""
    lo = np.asarray(lo_u32, dtype=np.uint32).astype(np.uint64)
    hi = np.asarray(hi_u32, dtype=np.uint32).astype(np.uint64)
    return gf.from_u64(lo | (hi << np.uint64(32)), device)


def gf_to_limbs(a: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """One 64-bit plane -> (lo, hi) u32 limb planes as numpy arrays."""
    x = gf.to_u64(a)
    return (
        (x & np.uint64(0xFFFF_FFFF)).astype(np.uint32),
        (x >> np.uint64(32)).astype(np.uint32),
    )


def polynomial_batch_from_reference(
    coeffs_u64,
    leaves_u64,
    levels_u64: Sequence,
    degree_log: int,
    rate_bits: int,
    cap_height: int,
    n_polys: int,
    device,
) -> PolynomialBatch:
    """A committed (unblinded) batch from its arrays: coefficients
    [>= n_polys, 2^degree_log] (rows past n_polys are mesh padding and are
    dropped), point-major bit-reversed leaves [2^(degree_log+rate_bits),
    n_polys], and the digest levels from the leaf digests up to the cap."""
    coeffs = np.asarray(coeffs_u64, dtype=np.uint64)[:n_polys]
    leaves = np.asarray(leaves_u64, dtype=np.uint64)
    lde_n = 1 << (degree_log + rate_bits)
    assert coeffs.shape == (n_polys, 1 << degree_log), coeffs.shape
    assert leaves.shape == (lde_n, n_polys), leaves.shape
    levels = [np.asarray(l, dtype=np.uint64).reshape(-1, 4) for l in levels_u64]
    assert len(levels) == degree_log + rate_bits - cap_height + 1
    for k, level in enumerate(levels):
        assert level.shape[0] == lde_n >> k, (k, level.shape)
    tree = DeviceMerkleTree(
        leaves=gf.from_u64(leaves, device),
        levels=[gf.from_u64(l, device) for l in levels],
        cap_height=cap_height,
    )
    return PolynomialBatch(
        polynomials=gf.from_u64(coeffs, device),
        merkle_tree=tree,
        degree_log=degree_log,
        rate_bits=rate_bits,
        blinding=False,
    )


def targets_from_array(rows) -> List[Target]:
    """[k, 3] ints (is_virtual, row_or_index, column) -> Targets."""
    out = []
    for is_virtual, a, b in np.asarray(rows, dtype=np.int64).reshape(-1, 3):
        out.append(Target.virtual(int(a)) if is_virtual else Target.wire(int(a), int(b)))
    return out


def circuit_data_from_reference(
    common_bytes: bytes,
    constants_sigmas: PolynomialBatch,
    sigmas_u64,
    subgroup_u64,
    representative_map,
    circuit_digest: Sequence[int],
    public_input_targets,
) -> CircuitData:
    """A built circuit from the JAX package's state: the serialized
    CommonCircuitData (gates are re-created as this package's classes by
    the reader), the constants+sigmas batch (see
    polynomial_batch_from_reference), the per-row sigma table
    [degree, num_routed], the subgroup [degree], the copy-constraint
    representative map, the circuit digest and the public-input targets as
    a [k, 3] array (is_virtual, row_or_index, column)."""
    common = serialization.common_data_from_bytes(common_bytes)
    sigmas = np.ascontiguousarray(np.asarray(sigmas_u64, dtype=np.uint64))
    subgroup = np.ascontiguousarray(np.asarray(subgroup_u64, dtype=np.uint64))
    assert sigmas.shape == (common.degree, common.config.num_routed_wires)
    assert subgroup.shape == (common.degree,)
    digest = tuple(int(x) for x in circuit_digest)
    prover_only = ProverOnlyCircuitData(
        generators=[],
        generator_indices_by_watches={},
        constants_sigmas_commitment=constants_sigmas,
        sigmas=sigmas,
        subgroup=subgroup,
        public_inputs=targets_from_array(public_input_targets),
        representative_map=np.asarray(representative_map, dtype=np.int64),
        circuit_digest=digest,
    )
    verifier_only = VerifierOnlyCircuitData(
        constants_sigmas_cap=constants_sigmas.cap_u64(),
        circuit_digest=digest,
    )
    return CircuitData(prover_only, verifier_only, common)


def partial_witness_from_wire_values(wire_values_u64) -> PartialWitness:
    """A full assignment [num_wires, degree] (the other package's
    MatrixWitness.wire_values) as inputs that set every wire."""
    wires = np.asarray(wire_values_u64, dtype=np.uint64)
    pw = PartialWitness()
    for column in range(wires.shape[0]):
        col = wires[column].tolist()
        for row, v in enumerate(col):
            pw.set_target(Target.wire(row, column), v)
    return pw


# ---------------------------------------------------------------------------
# STARK proofs and configurations as plain data, both ways
# ---------------------------------------------------------------------------


STARK_FIXTURES = (
    "FibonacciStark", "PermutationStark", "UnconstrainedStark", "CtlLookingStark",
    "CtlLookedStark",
)


def to_plain(obj):
    """A tree of dataclasses (a StarkConfig, a STARK proof with its FRI
    proof, a cross-table lookup — of either package: the two define the
    same fields) -> nested dicts tagged with the class name under
    "__class__", lists, tuples, Python ints and numpy u64 arrays (copies).
    Works by field names only, so it reads the other package's objects
    without importing it; a STARK fixture crosses as its class name and
    constructor argument."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {"__class__": type(obj).__name__}
        for f in dataclasses.fields(obj):
            out[f.name] = to_plain(getattr(obj, f.name))
        return out
    if type(obj).__name__ in STARK_FIXTURES:
        return {"__class__": type(obj).__name__, "num_rows": int(obj.num_rows)}
    if isinstance(obj, np.ndarray):
        return np.array(obj, dtype=np.uint64)
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_plain(v) for v in obj)
    if isinstance(obj, np.integer):
        return int(obj)
    return obj


def from_plain(plain, classes=None):
    """Inverse of ``to_plain``: rebuild the dataclasses from ``classes``
    ({class name: class}; this package's, ``port_classes()``, by default —
    pass the other package's classes to build its objects)."""
    if classes is None:
        classes = port_classes()
    if isinstance(plain, dict) and plain.get("__class__") == "GenericConfig":
        return classes["GenericConfig"](plain["name"])
    if isinstance(plain, type):  # a class held in a field (a generator's gate class)
        return classes.get(plain.__name__, plain)
    if isinstance(plain, dict) and "__class__" in plain:
        cls = classes[plain["__class__"]]
        return cls(**{k: from_plain(v, classes) for k, v in plain.items() if k != "__class__"})
    if isinstance(plain, np.ndarray):
        return np.array(plain, dtype=np.uint64)
    if isinstance(plain, (list, tuple)):
        return type(plain)(from_plain(v, classes) for v in plain)
    return plain


def generic_config_by_name(name: str):
    """This package's hasher bundle of the given GenericConfig name."""
    from ..plonk import generic_config as gcm

    return {
        "PoseidonGoldilocksConfig": gcm.poseidon_goldilocks_config,
        "Poseidon2GoldilocksConfig": gcm.poseidon2_goldilocks_config,
        "KeccakGoldilocksConfig": gcm.keccak_goldilocks_config,
    }[name]()


def port_classes() -> dict:
    """This package's classes of a STARK proof, a StarkConfig, the
    Poseidon2 gates and generators, the lookup and CTL descriptions and the
    STARK fixtures, by name; "GenericConfig" maps a bundle's name to this
    package's bundle."""
    from ..fri import config as fri_config, proof as fri_proof
    from ..gates import poseidon2
    from ..stark import config as stark_config, proof as stark_proof
    from ..stark import cross_table_lookup, fixtures, lookup

    classes = {}
    for module, names in (
        (stark_proof, ("StarkProofWithPublicInputs", "StarkProof", "StarkOpeningSet")),
        (fri_proof, ("FriProof", "FriQueryRound", "FriInitialTreeProof", "FriQueryStep",
                     "MerkleProof")),
        (stark_config, ("StarkConfig",)),
        (fri_config, ("FriConfig", "FriReductionStrategy")),
        (poseidon2, ("Poseidon2Gate", "Poseidon2MdsGate", "Poseidon2IntMixGate",
                     "Poseidon2Generator", "Poseidon2MdsGenerator")),
        (lookup, ("Column", "Filter", "Lookup")),
        (cross_table_lookup, ("TableWithColumns", "CrossTableLookup")),
        (fixtures, STARK_FIXTURES),
    ):
        for name in names:
            classes[name] = getattr(module, name)
    classes["GenericConfig"] = generic_config_by_name
    return classes

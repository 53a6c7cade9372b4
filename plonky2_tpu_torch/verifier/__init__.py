"""Standalone verify-only import surface.

The reference ships a separate no_std ``verifier`` crate
(verifier/src/lib.rs:1-20) so proofs can be checked where the prover's
dependencies are unavailable. This package's guarantee: importing
``plonky2_tpu_torch.verifier`` NEVER imports torch — the whole PLONK
verify path (shape validation, Fiat-Shamir replay, gate-constraint
evaluation by HostExtAlgebra, FRI query checks, compressed proofs,
serialization) is numpy and Python ints. Held by
tests/test_torch_standalone_verifier.py, which verifies a proof in a
subprocess with torch imports blocked.

The surface is PLONK only, as the reference's: STARK verification
(stark/verifier.py) takes torch tensors and is not part of it.
"""

from ..fri.validate_shape import FriShapeError, validate_fri_proof_shape
from ..fri.verifier import FriVerificationError, verify_fri_proof
from ..plonk.compressed_proof import (
    compress_proof,
    decompress_proof,
    verify_compressed_proof,
)
from ..plonk.validate_shape import ProofShapeError, validate_proof_with_pis_shape
from ..plonk.verifier import VerificationError, get_challenges, verify
from ..utils.serialization import (
    SerializationError,
    common_data_from_bytes,
    proof_from_bytes,
    proof_to_bytes,
    verifier_data_from_bytes,
)

__all__ = [
    "FriShapeError",
    "FriVerificationError",
    "ProofShapeError",
    "SerializationError",
    "VerificationError",
    "common_data_from_bytes",
    "compress_proof",
    "decompress_proof",
    "get_challenges",
    "proof_from_bytes",
    "proof_to_bytes",
    "validate_fri_proof_shape",
    "validate_proof_with_pis_shape",
    "verifier_data_from_bytes",
    "verify",
    "verify_compressed_proof",
    "verify_fri_proof",
]

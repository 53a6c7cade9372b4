"""Op group "poseidon": Poseidon permutations, sponges and Merkle trees
(plonky2_tpu_torch/ops/poseidon.py, ops/merkle.py -> csrc/poseidon.cu).

Least work of a call from its shapes: the permutations it must make
(a sponge over w words makes ceil(w / 8) a row, a compression one, a tree
over n leaves n - 2^cap compressions above its leaf hashes) at
OPS_PER_PERMUTATION each, and every word in and out once (a tree writes
its leaf digests and every level up to its cap)."""

from __future__ import annotations

from ._bounds import OPS_PER_PERMUTATION

TARGETS = [
    ("plonky2_tpu_torch.ops.poseidon", "permute"),
    ("plonky2_tpu_torch.ops.poseidon", "sponge"),
    ("plonky2_tpu_torch.ops.poseidon", "hash_leaf"),
    ("plonky2_tpu_torch.ops.poseidon", "compress_pairs"),
    ("plonky2_tpu_torch.ops.poseidon", "two_to_one"),
    ("plonky2_tpu_torch.ops.poseidon", "hash_no_pad_batch"),
    ("plonky2_tpu_torch.ops.merkle", "build_merkle_tree"),
]


def _absorbs(width: int) -> int:
    return -(-width // 8)


def work(name, args, kwargs, out):
    x = args[0]
    if not getattr(x, "is_cuda", False):
        return None
    if name == "permute":
        b = x.numel() // 12
        return 24 * b, b * OPS_PER_PERMUTATION
    if name in ("sponge", "hash_leaf", "hash_no_pad_batch"):
        b, w = x.shape
        return b * w + 4 * b, b * _absorbs(w) * OPS_PER_PERMUTATION
    if name == "compress_pairs":
        b = x.shape[0] // 2
        return 12 * b, b * OPS_PER_PERMUTATION
    if name == "two_to_one":
        b = x.shape[0]
        return 12 * b, b * OPS_PER_PERMUTATION
    # build_merkle_tree(leaves, cap_height)
    n, w = x.shape
    cap_height = args[1] if len(args) > 1 else kwargs["cap_height"]
    compressions = n - (1 << cap_height)
    perms = n * _absorbs(w) + compressions
    return n * w + 4 * (n + compressions), perms * OPS_PER_PERMUTATION

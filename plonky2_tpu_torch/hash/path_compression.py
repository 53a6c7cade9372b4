"""Merkle proof path compression across query indices (reference:
core/src/hash/path_compression.rs:14-120): sibling digests derivable
from other queried leaves are dropped, the decompressor reconstructs
them bottom-up."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from . import poseidon as hp

Digest = Tuple[int, int, int, int]


def compress_merkle_proofs(
    cap_height: int,
    indices: Sequence[int],
    proofs: Sequence[List[Digest]],
) -> List[List[Digest]]:
    assert proofs
    height = cap_height + len(proofs[0])
    num_leaves = 1 << height
    known = [False] * (2 * num_leaves)
    for i in indices:
        for j in range(height - cap_height):
            known[(i + num_leaves) >> j] = True
    out = []
    for i, p in zip(indices, proofs):
        comp: List[Digest] = []
        index = i + num_leaves
        for sibling in p:
            sib = index ^ 1
            if not known[sib]:
                comp.append(tuple(sibling))
                known[sib] = True
            index >>= 1
            known[index] = True
        out.append(comp)
    return out


def decompress_merkle_proofs(
    leaves_data: Sequence[Sequence[int]],
    leaves_indices: Sequence[int],
    compressed_proofs: Sequence[List[Digest]],
    height: int,
    cap_height: int,
) -> List[List[Digest]]:
    num_leaves = 1 << height
    seen: Dict[int, Digest] = {}
    for i, v in zip(leaves_indices, leaves_data):
        seen[i + num_leaves] = hp.hash_leaf(list(v))

    iters = [iter(p) for p in compressed_proofs]
    decompressed: List[List[Digest]] = [[] for _ in compressed_proofs]
    for layer in range(height - cap_height):
        for qi, (i, it) in enumerate(zip(leaves_indices, iters)):
            index = (i + num_leaves) >> layer
            current = seen[index]
            sib = index ^ 1
            if sib in seen:
                sibling = seen[sib]
            else:
                sibling = tuple(next(it))
                seen[sib] = sibling
            parent = (
                hp.two_to_one(current, sibling)
                if index % 2 == 0
                else hp.two_to_one(sibling, current)
            )
            seen[index >> 1] = parent
            decompressed[qi].append(sibling)
    return decompressed

"""Device-resident Merkle trees with caps.

The reference builds 2^cap_height independent subtrees with a recursive
task-parallel fill into one flat digest buffer
(core/src/merkle_tree.rs:85-144). Here the layout is *level-major*:
``levels[k]`` is a ``[n >> k, 4]`` digest batch (``levels[0]`` the leaf
digests), built bottom-up with one leaf-sponge launch and one batched
two-to-one compression per level, which reads the level below as pairs of
rows in place; every row of a level is independent.

Proof extraction (merkle_tree_prove, core/src/merkle_tree.rs:187) is a
gather per level at host-chosen indices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..utils.bits import log2_strict
from . import gf
from . import poseidon as dp


def _tree_levels(leaves: torch.Tensor, num_levels: int) -> List[torch.Tensor]:
    """Leaf digests + ``num_levels`` level-by-level compressions."""
    levels = [dp.hash_leaf(leaves)]  # [n, 4]
    for _ in range(num_levels):
        levels.append(dp.compress_pairs(levels[-1]))  # rows 2i, 2i+1 -> row i
    return levels


def build_merkle_tree(leaves, cap_height: int, hasher=None, device=None):
    """Hash a [n, w] leaf batch into a tree. ``leaves`` is a tensor (the
    tree is built where it lives) or a numpy u64 array, which goes to
    ``device`` first (None = the GPU). Only the Poseidon hasher is built
    here."""
    if not isinstance(leaves, torch.Tensor):
        leaves = gf.from_u64(leaves, device)
    n = leaves.shape[0]
    height = log2_strict(n)
    assert cap_height <= height
    if hasher is not None and hasher.name != "poseidon":
        raise NotImplementedError(f"Merkle trees over hasher {hasher.name!r}")
    levels = _tree_levels(leaves, height - cap_height)
    return DeviceMerkleTree(leaves=leaves, levels=levels, cap_height=cap_height)


def _index_tensor(indices, device) -> torch.Tensor:
    """Leaf indices as an int64 tensor on ``device``: a tensor already
    there is taken as it is (no host round trip), host indices are
    uploaded."""
    if isinstance(indices, torch.Tensor):
        return indices
    return torch.from_numpy(np.asarray(indices, dtype=np.int64)).to(device)


@dataclass
class DeviceMerkleTree:
    """levels[0] = leaf digests [n, 4]; levels[k+1] = compress(levels[k]);
    levels[-1] = cap."""

    leaves: torch.Tensor
    levels: List[torch.Tensor]
    cap_height: int

    @property
    def num_leaves(self) -> int:
        return self.levels[0].shape[0]

    @property
    def cap(self) -> torch.Tensor:
        return self.levels[-1]

    def cap_u64(self) -> np.ndarray:
        return gf.to_u64(self.cap).reshape(-1, 4)

    def leaf_u64(self, index: int) -> np.ndarray:
        return gf.to_u64(self.leaves[index])

    def prove(self, leaf_index: int) -> List[Tuple[int, int, int, int]]:
        """Sibling digests from leaf level up to (excluding) the cap."""
        sibs = self.prove_batch(np.array([leaf_index]))[0]
        return [tuple(int(x) for x in row) for row in sibs]

    def leaf_u64_batch(self, leaf_indices: np.ndarray) -> np.ndarray:
        """[Q, w] leaf rows in one transfer."""
        return gf.to_u64(self.leaf_rows_device(leaf_indices))

    def prove_batch(self, leaf_indices: np.ndarray) -> np.ndarray:
        """[Q, num_path_levels, 4] sibling digests in one transfer."""
        return gf.to_u64(self.sibling_paths_device(leaf_indices))

    def leaf_rows_device(self, leaf_indices) -> torch.Tensor:
        """[Q, w] leaf rows at host indices or an index tensor on the tree's
        device."""
        return self.leaves[_index_tensor(leaf_indices, self.leaves.device)]

    def sibling_paths_device(self, leaf_indices) -> torch.Tensor:
        """[Q, num_path_levels, 4] sibling digests, indices as for
        leaf_rows_device."""
        device = self.leaves.device
        if len(self.levels) == 1:
            return gf.zeros((len(leaf_indices), 0, 4), device)
        cur = _index_tensor(leaf_indices, device)
        rows = []
        for level in self.levels[:-1]:
            rows.append(level[cur ^ 1])
            cur = cur >> 1
        return torch.stack(rows, dim=1)


# ---------------------------------------------------------------------------
# Host-side verification (reference: core/src/merkle_proofs.rs)
# ---------------------------------------------------------------------------


def verify_merkle_proof(
    leaf_data: Sequence[int],
    leaf_index: int,
    cap: np.ndarray,
    siblings: Sequence[Tuple[int, int, int, int]],
    hasher=None,
) -> bool:
    if hasher is None:
        from ..hash import poseidon as hp

        hasher = hp
    digest = hasher.hash_leaf(list(leaf_data))
    idx = leaf_index
    for sib in siblings:
        if idx & 1:
            digest = hasher.two_to_one(sib, digest)
        else:
            digest = hasher.two_to_one(digest, sib)
        idx >>= 1
    return tuple(int(x) for x in cap[idx]) == digest

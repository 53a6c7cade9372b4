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

The hasher decides where a tree is built: Poseidon by its hand-written
kernels (the leaf sponge, then one two-to-one launch a level), Poseidon2 on
the leaves' device by the batched permutation of hash/poseidon2.py (same
level-major layout, no host read), Keccak on the host (HostMerkleTree).
Under a prover mesh a Poseidon or Poseidon2 tree is built row-sharded and
stays so: each shard hashes its own subtree on its device and keeps its
leaf rows and subtree levels there (ShardedMerkleTree); openings are
routed to the shard that holds them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..utils.bits import log2_strict
from . import gf
from . import poseidon as dp
from .poseidon import NUM_HASH_OUT_ELTS, SPONGE_RATE, SPONGE_WIDTH


def _tree_levels(leaves: torch.Tensor, num_levels: int) -> List[torch.Tensor]:
    """Leaf digests + ``num_levels`` level-by-level compressions."""
    levels = [dp.hash_leaf(leaves)]  # [n, 4]
    for _ in range(num_levels):
        levels.append(dp.compress_pairs(levels[-1]))  # rows 2i, 2i+1 -> row i
    return levels


# ---------------------------------------------------------------------------
# Poseidon2 trees on the leaves' device (hashing.rs:182-199 hash_leaf_p2 and
# the pad10 two-to-one): lane-major [12, n] sponge states, one batched
# permutation an absorption
# ---------------------------------------------------------------------------


def _p2_absorb(state: torch.Tensor, chunk: torch.Tensor) -> torch.Tensor:
    """Additive absorption of ``chunk`` ([8, n], canonical) into the rate
    lanes of ``state`` ([12, n]), then one permutation."""
    from ..hash import poseidon2 as p2

    return p2.permute_lanes(torch.cat([gf.add(state[:SPONGE_RATE], chunk), state[SPONGE_RATE:]]))


def _p2_hash_leaf(leaves: torch.Tensor) -> torch.Tensor:
    """[n, w] rows -> [n, 4] digests of Poseidon2's hash_leaf: capacity
    lane SPONGE_RATE set to 1, the row pad10-padded (a 1, then zeros to a
    multiple of 8; a row of a multiple of 8 words gets a chunk of its own),
    absorbed additively, no permutation after the last absorption."""
    n, w = leaves.shape
    device = leaves.device
    state = gf.zeros((SPONGE_WIDTH, n), device)
    state[SPONGE_RATE] = 1
    cols = leaves.T  # [w, n] view
    for off in range(0, w + 1, SPONGE_RATE):
        chunk = gf.canonicalize(cols[off : off + SPONGE_RATE])
        k = chunk.shape[0]
        if k < SPONGE_RATE:  # the last chunk: the pad's 1, then zeros
            pad = gf.zeros((SPONGE_RATE - k, n), device)
            pad[0] = 1
            chunk = torch.cat([chunk, pad])
        state = _p2_absorb(state, chunk)
    return state[:NUM_HASH_OUT_ELTS].T.contiguous()


def _p2_compress_pairs(level: torch.Tensor) -> torch.Tensor:
    """[2m, 4] digests -> [m, 4]: rows 2i, 2i+1 through Poseidon2's
    two_to_one, the pad10 sponge over 8 words: two permutations, the
    second after the pad's 1 is added to lane 0."""
    from ..hash import poseidon2 as p2

    m = level.shape[0] // 2
    state = torch.cat([level.reshape(m, 2 * NUM_HASH_OUT_ELTS).T,
                       gf.zeros((SPONGE_WIDTH - SPONGE_RATE, m), level.device)])
    state = p2.permute_lanes(state)
    state = torch.cat([gf.add(state[:1], gf.ones((1, m), level.device)), state[1:]])
    return p2.permute_lanes(state)[:NUM_HASH_OUT_ELTS].T.contiguous()


def _p2_tree_levels(leaves: torch.Tensor, num_levels: int) -> List[torch.Tensor]:
    levels = [_p2_hash_leaf(leaves)]
    for _ in range(num_levels):
        levels.append(_p2_compress_pairs(levels[-1]))
    return levels


def build_merkle_tree(leaves, cap_height: int, hasher=None, device=None):
    """Hash a [n, w] leaf batch into a tree. ``leaves`` is a tensor (the
    tree is built where it lives) or a numpy u64 array, which goes to
    ``device`` first (None = the GPU). ``hasher`` None is Poseidon.
    Poseidon and Poseidon2 give a DeviceMerkleTree, any other hasher
    (Keccak) a HostMerkleTree."""
    if not isinstance(leaves, torch.Tensor):
        leaves = gf.from_u64(leaves, device)
    n = leaves.shape[0]
    height = log2_strict(n)
    assert cap_height <= height
    name = "poseidon" if hasher is None else hasher.name
    if name in ("poseidon", "poseidon2"):
        from ..parallel import context as pctx

        mesh = pctx.get_mesh()
        if mesh is not None and n >= mesh.size:
            return build_sharded_merkle_tree(pctx.shard(leaves, mesh, 0), mesh, cap_height,
                                             leaves.device, hasher)
    if name == "poseidon":
        levels = _tree_levels(leaves, height - cap_height)
    elif name == "poseidon2":
        levels = _p2_tree_levels(leaves, height - cap_height)
    else:
        return HostMerkleTree.build(leaves, cap_height, hasher)
    return DeviceMerkleTree(leaves=leaves, levels=levels, cap_height=cap_height)


def build_sharded_merkle_tree(leaf_parts, mesh, cap_height: int, device,
                              hasher=None) -> "ShardedMerkleTree":
    """The tree of the leaves whose row block s is leaf_parts[s] (on
    mesh.devices[s]), its subtrees hashed shard by shard
    (parallel/ntt.sharded_tree_levels). Nothing is gathered but the
    levels from the shard roots up, on ``device``."""
    from ..parallel import context as pctx
    from ..parallel import ntt as pntt

    sub, top = pntt.sharded_tree_levels(leaf_parts, mesh, cap_height, device, hasher)
    flat = pctx.map_shards(
        lambda levels, rows: torch.cat(levels) if levels else gf.zeros((0, 4), rows.device),
        mesh, sub, leaf_parts,
    )  # one buffer a shard: a path is one gather there
    return ShardedMerkleTree(leaf_parts=list(leaf_parts), flat_parts=flat,
                             shard_levels=len(sub[0]), top=top, cap_height=cap_height,
                             device=torch.device(device))


def _index_tensor(indices, device) -> torch.Tensor:
    """Leaf indices as an int64 tensor on ``device``: a tensor already
    there is taken as it is (no host round trip), host indices are
    uploaded."""
    if isinstance(indices, torch.Tensor):
        return indices
    return torch.from_numpy(np.asarray(indices, dtype=np.int64)).to(device)


def _sibling_paths(levels: List[torch.Tensor], leaf_indices, device) -> torch.Tensor:
    """[Q, len(levels) - 1, 4]: each leaf's sibling digest in every level
    below the cap, leaf level first."""
    if len(levels) == 1:
        return gf.zeros((len(leaf_indices), 0, 4), device)
    cur = _index_tensor(leaf_indices, device)
    rows = []
    for level in levels[:-1]:
        rows.append(level[cur ^ 1])
        cur = cur >> 1
    return torch.stack(rows, dim=1)


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
        return _sibling_paths(self.levels, leaf_indices, self.leaves.device)


@dataclass
class ShardedMerkleTree:
    """A tree kept on a prover mesh's shards (the reference's row-sharded
    tree arrays). Shard s holds leaf_parts[s], the leaf rows
    [s·L/d, (s+1)·L/d), and flat_parts[s], the ``shard_levels`` levels of
    its subtree below the shard roots one after another (level k: L/d >> k
    digests), on its own device. ``top`` (on ``device``, the proof's)
    holds the levels from the gathered shard roots, or the shards' blocks
    of the cap, up to the cap.

    Reads route leaf i to shard i // (L/d): its row and its path below
    the shard roots lie wholly there. Index tensors stay on ``device``
    and nothing is read to the host (parallel/context.gather_rows)."""

    leaf_parts: List[torch.Tensor]
    flat_parts: List[torch.Tensor]
    shard_levels: int
    top: List[torch.Tensor]
    cap_height: int
    device: torch.device

    @property
    def shard_rows(self) -> int:
        return self.leaf_parts[0].shape[0]

    @property
    def num_leaves(self) -> int:
        return self.shard_rows * len(self.leaf_parts)

    @property
    def cap(self) -> torch.Tensor:
        return self.top[-1]

    def level_parts(self, k: int) -> List[torch.Tensor]:
        """Level k (< shard_levels) shard by shard: views of the flat
        buffers, [L/d >> k, 4] each."""
        rows = self.shard_rows
        start = 2 * rows - ((2 * rows) >> k)
        return [f[start : start + (rows >> k)] for f in self.flat_parts]

    # DeviceMerkleTree's host reads, over the routed reads below
    cap_u64 = DeviceMerkleTree.cap_u64
    prove = DeviceMerkleTree.prove
    leaf_u64_batch = DeviceMerkleTree.leaf_u64_batch
    prove_batch = DeviceMerkleTree.prove_batch

    def leaf_u64(self, index: int) -> np.ndarray:
        return self.leaf_u64_batch(np.array([index]))[0]

    def leaf_rows_device(self, leaf_indices) -> torch.Tensor:
        """[Q, w] leaf rows on ``device``, at host indices or an index
        tensor there."""
        from ..parallel import context as pctx

        idx = _index_tensor(leaf_indices, self.device)
        return pctx.gather_rows(self.leaf_parts, idx, self.device)

    def sibling_paths_device(self, leaf_indices) -> torch.Tensor:
        """[Q, num_path_levels, 4]: the siblings below the shard roots from
        each leaf's shard (one gather of its flat buffer), then those of
        ``top``."""
        from ..parallel import context as pctx

        idx = _index_tensor(leaf_indices, self.device)
        rows, k_levels = self.shard_rows, self.shard_levels
        upper = _sibling_paths(self.top, idx >> k_levels, self.device)
        if k_levels == 0:
            return upper

        def path(flat, local):
            # level k starts at 2·rows - (2·rows >> k) in the flat buffer
            ks = torch.arange(k_levels, dtype=local.dtype, device=local.device)
            starts = 2 * rows - torch.bitwise_right_shift(torch.full_like(ks, 2 * rows), ks)
            return flat[starts + ((local[:, None] >> ks) ^ 1)]  # [Q, K, 4]

        lower = pctx.gather_rows(self.flat_parts, idx, self.device, rows=rows, take=path)
        return torch.cat([lower, upper], dim=1)


@dataclass
class HostMerkleTree:
    """The DeviceMerkleTree interface over a tree built on the host with
    any HasherSpec (Keccak): digests are rows of 4 u64 words. The leaves
    stay where they were committed (the prover reads them back for the
    quotient); their rows are read to the host once, to hash them."""

    leaves: torch.Tensor
    levels: List[np.ndarray]  # each [m, 4] u64
    cap_height: int
    _leaves_u64: np.ndarray = None

    @staticmethod
    def build(leaves: torch.Tensor, cap_height: int, hasher) -> "HostMerkleTree":
        rows = gf.to_u64(leaves)  # [n, w]
        n = rows.shape[0]
        height = log2_strict(n)
        digests = np.array(
            [hasher.hash_leaf([int(v) for v in row]) for row in rows],
            dtype=np.uint64,
        ).reshape(n, 4)
        levels = [digests]
        for _ in range(height - cap_height):
            cur = levels[-1]
            nxt = np.array(
                [
                    hasher.two_to_one(
                        tuple(int(x) for x in cur[2 * i]),
                        tuple(int(x) for x in cur[2 * i + 1]),
                    )
                    for i in range(cur.shape[0] // 2)
                ],
                dtype=np.uint64,
            ).reshape(-1, 4)
            levels.append(nxt)
        return HostMerkleTree(
            leaves=leaves, levels=levels, cap_height=cap_height, _leaves_u64=rows
        )

    @property
    def num_leaves(self) -> int:
        return self.levels[0].shape[0]

    def cap_u64(self) -> np.ndarray:
        return self.levels[-1]

    def leaf_u64(self, index: int) -> np.ndarray:
        return self._leaves_u64[index]

    def leaf_u64_batch(self, leaf_indices: np.ndarray) -> np.ndarray:
        return self._leaves_u64[np.asarray(leaf_indices, dtype=np.int64)]

    def prove(self, leaf_index: int) -> List[Tuple[int, int, int, int]]:
        sibs = self.prove_batch(np.array([leaf_index]))[0]
        return [tuple(int(x) for x in row) for row in sibs]

    def prove_batch(self, leaf_indices: np.ndarray) -> np.ndarray:
        idx = np.asarray(leaf_indices, dtype=np.int64)
        if len(self.levels) == 1:
            return np.zeros((len(idx), 0, 4), dtype=np.uint64)
        rows = []
        for level in self.levels[:-1]:
            rows.append(level[idx ^ 1])
            idx = idx >> 1
        return np.stack(rows, axis=1)

    def leaf_rows_device(self, leaf_indices) -> torch.Tensor:
        return gf.from_u64(self.leaf_u64_batch(leaf_indices), self.leaves.device)

    def sibling_paths_device(self, leaf_indices) -> torch.Tensor:
        return gf.from_u64(self.prove_batch(leaf_indices), self.leaves.device)


# ---------------------------------------------------------------------------
# Batch Merkle tree: matrices of decreasing power-of-two heights in one tree
# (reference: plonky2/src/hash/batch_merkle_tree.rs:25-165). Level-major as
# above: the tallest matrix's leaf digests, one compression a level, and at
# the height of the next matrix the digest row joined with that matrix's
# rows and hashed again as a leaf of width 4 + w.
# ---------------------------------------------------------------------------


def _batch_tree_levels(matrices: Sequence[torch.Tensor], cap_height: int) -> List[torch.Tensor]:
    """levels[k] is the digest row at height h0 - k, after the join of the
    matrix of that height if there is one (batch_merkle_tree.rs:25-60)."""
    heights = [log2_strict(m.shape[0]) for m in matrices]
    cur = dp.hash_leaf(matrices[0])
    levels = [cur]
    mi, h = 1, heights[0]
    while h > cap_height:
        cur = dp.compress_pairs(cur)
        h -= 1
        if mi < len(matrices) and h == heights[mi]:
            # the joined leaf's capacity lane is 4 + w + 1 (hash_leaf)
            cur = dp.hash_leaf(torch.cat([cur, matrices[mi]], dim=1))
            mi += 1
        levels.append(cur)
    assert mi == len(matrices), "the cap height lies above a matrix"
    return levels


@dataclass
class BatchDeviceMerkleTree:
    """leaves: per-matrix [n_i, w_i] (tallest first); levels[k] is the
    digest row at height h0 - k AFTER any matrix join at that height;
    levels[-1] = cap."""

    leaves: List[torch.Tensor]
    leaf_heights: List[int]
    levels: List[torch.Tensor]
    cap_height: int

    @staticmethod
    def build(matrices, cap_height: int, device=None) -> "BatchDeviceMerkleTree":
        """matrices: [n_i, w_i] tensors on ``device`` or numpy u64 arrays,
        which go there first (None = the GPU, which raises without one);
        heights strictly decreasing."""
        device = gf.resolve_device(device)
        for m in matrices:
            if isinstance(m, torch.Tensor) and m.device.type != device.type:
                raise ValueError(f"matrix on {m.device}, but device={device} was asked for")
        matrices = [m if isinstance(m, torch.Tensor) else gf.from_u64(m, device) for m in matrices]
        heights = [log2_strict(m.shape[0]) for m in matrices]
        assert all(heights[i] > heights[i + 1] for i in range(len(heights) - 1))
        assert cap_height <= heights[-1]
        return BatchDeviceMerkleTree(
            leaves=list(matrices),
            leaf_heights=heights,
            levels=_batch_tree_levels(matrices, cap_height),
            cap_height=cap_height,
        )

    @property
    def cap(self) -> torch.Tensor:
        return self.levels[-1]

    def cap_u64(self) -> np.ndarray:
        return gf.to_u64(self.cap).reshape(-1, 4)

    def leaf_rows_device(self, leaf_indices) -> List[torch.Tensor]:
        """Per matrix i: [Q, w_i] rows at index >> (h0 - h_i), indices as
        for DeviceMerkleTree.leaf_rows_device."""
        device = self.leaves[0].device
        idx = _index_tensor(leaf_indices, device)
        h0 = self.leaf_heights[0]
        return [m[idx >> (h0 - h)] for m, h in zip(self.leaves, self.leaf_heights)]

    def sibling_paths_device(self, leaf_indices) -> torch.Tensor:
        """[Q, h0 - cap_height, 4] sibling digests, gathered from the
        levels below the cap (each after its join)."""
        return _sibling_paths(self.levels, leaf_indices, self.leaves[0].device)

    def values_batch(self, leaf_indices) -> List[np.ndarray]:
        """Per matrix: [Q, w_i] rows as host u64, in one transfer."""
        rows = self.leaf_rows_device(leaf_indices)
        flat = gf.to_u64(torch.cat([r.reshape(-1) for r in rows]))
        out, pos = [], 0
        for r in rows:
            out.append(flat[pos : pos + r.numel()].reshape(r.shape))
            pos += r.numel()
        return out

    def prove_batch(self, leaf_indices) -> np.ndarray:
        """[Q, h0 - cap_height, 4] sibling digests as host u64."""
        return gf.to_u64(self.sibling_paths_device(leaf_indices))


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


def verify_batch_merkle_proof_to_cap(
    leaf_data: Sequence[Sequence[int]],
    leaf_heights: Sequence[int],
    leaf_index: int,
    cap: np.ndarray,
    siblings,
    hasher=None,
) -> bool:
    """A batch tree's path (core/src/merkle_proofs.rs:59-97): the digest
    climbs from the tallest matrix's row, and at each height of a smaller
    matrix is hashed again joined with that matrix's row."""
    if hasher is None:
        from ..hash import poseidon as hp

        hasher = hp
    assert len(leaf_data) == len(leaf_heights)
    digest = hasher.hash_leaf(list(leaf_data[0]))
    height = leaf_heights[0]
    data_index = 1
    idx = leaf_index
    for sib in siblings:
        if idx & 1:
            digest = hasher.two_to_one(sib, digest)
        else:
            digest = hasher.two_to_one(digest, sib)
        idx >>= 1
        height -= 1
        if data_index < len(leaf_heights) and height == leaf_heights[data_index]:
            digest = hasher.hash_leaf(list(digest) + list(leaf_data[data_index]))
            data_index += 1
    assert data_index == len(leaf_data)
    return tuple(int(x) for x in cap[idx]) == digest

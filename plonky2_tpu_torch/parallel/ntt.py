"""Multi-device NTT: the six-step (Bailey) factorization over a prover mesh
(replaces the reference's single-node rayon FFT, field/src/fft.rs, for
domains split over devices).

N = N1·N2 viewed as an [N2, N1] matrix with n = n1 + N1·n2, rows sharded
over the mesh (shard s holds the contiguous points [s·N/d, (s+1)·N/d)):

  1. transpose to rows n1                  (all_to_all)
  2. local N2-point row FFTs               (no copies: the row FFT kernel)
  3. twiddle by w_N^(n1·k2)                (the field product kernel; the
                                            twiddles sharded like the rows)
  4. transpose to rows k2                  (all_to_all)
  5. local N1-point row FFTs
  6. transpose to rows k1                  (all_to_all): X[k1·N2 + k2],
                                            contiguous blocks again

The butterflies are the single-device kernels (ops/ntt._fft_flat: the row
FFT kernel on a CUDA tensor, its plain version on the CPU) over each
shard's rows; only the transposes cross shards. Inverse = the same with
inverse stage roots, inverse twiddles and a 1/N scale.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..field import goldilocks as gl
from ..ops import gf, ntt
from ..utils.bits import log2_strict
from . import context as pctx
from .context import ProverMesh

# device copies of the twiddle and scale tables, by (what, sizes, device)
_TABLES = {}


def clear_tables() -> None:
    """Free the cached device tables (a 2^24-point transform's twiddles
    take 128 MiB a direction)."""
    _TABLES.clear()
    _twiddles_np.cache_clear()


def _split_logs(n_log: int) -> Tuple[int, int]:
    n1_log = n_log // 2
    return n1_log, n_log - n1_log


@lru_cache(maxsize=4)
def _twiddles_np(n1_log: int, n2_log: int, inverse: bool) -> np.ndarray:
    """w_N^(±n1·k2) as an [N1, N2] u64 array (host precompute)."""
    w = gl.primitive_root_of_unity(n1_log + n2_log)
    if inverse:
        w = gl.ginv(w)
    return ntt._build_twiddles_np(gl.np_powers(w, 1 << n1_log), n2_log)


def _twiddle_shards(n_log: int, inverse: bool, mesh: ProverMesh) -> List[torch.Tensor]:
    """The [N1, N2] twiddles, row block s on shard s's device."""
    n1_log, n2_log = _split_logs(n_log)
    rows = (1 << n1_log) // mesh.size
    out = []
    for s, dev in enumerate(mesh.devices):
        key = ("twiddles", n_log, inverse, s, rows, str(dev))
        if key not in _TABLES:
            tw = _twiddles_np(n1_log, n2_log, inverse)
            _TABLES[key] = gf.from_u64(tw[s * rows:(s + 1) * rows], dev)
        out.append(_TABLES[key])
    return out


def _check_divides(n_log: int, mesh: ProverMesh) -> None:
    n1_log, n2_log = _split_logs(n_log)
    d = mesh.size
    if (1 << n1_log) % d or (1 << n2_log) % d:
        raise ValueError(
            f"a mesh of {d} shards must divide both factors of a 2^{n_log}-point transform "
            f"(2^{n1_log} and 2^{n2_log})"
        )


def _transpose(parts: Sequence[torch.Tensor], mesh: ProverMesh) -> List[torch.Tensor]:
    """[M, R/d, C] a shard (rows sharded) -> [M, C/d, R] a shard."""
    z = pctx.all_to_all(parts, mesh, split_dim=2, concat_dim=1)  # [M, R, C/d]
    return pctx.map_shards(lambda a: a.transpose(1, 2).contiguous(), mesh, z)


def _row_ffts(parts, mesh: ProverMesh, n_log: int, inverse: bool) -> List[torch.Tensor]:
    """Each shard's rows through a 2^n_log-point DFT along the last axis
    (bit-reverse, then the row FFT kernel or its plain version)."""
    return pctx.map_shards(
        lambda y: ntt._fft_flat(ntt.bit_reverse(y), n_log, inverse), mesh, parts
    )


def _six_step_shards(parts, mesh: ProverMesh, n_log: int, inverse: bool) -> List[torch.Tensor]:
    """The six steps over a batch: parts are [M, N2/d, N1] (rows n2, points
    n = n1 + N1·n2), the result [M, N1/d, N2] a shard (rows k1, output
    k = k1·N2 + k2), unscaled."""
    n1_log, n2_log = _split_logs(n_log)
    tw = _twiddle_shards(n_log, inverse, mesh)
    y = _transpose(parts, mesh)  # [M, N1/d, N2] rows n1
    y = _row_ffts(y, mesh, n2_log, inverse)  # DFT over n2
    y = pctx.map_shards(lambda a, t: gf.mul(a, t[None]), mesh, y, tw)  # w_N^(n1·k2)
    y = _transpose(y, mesh)  # [M, N2/d, N1] rows k2
    y = _row_ffts(y, mesh, n1_log, inverse)  # DFT over n1
    return _transpose(y, mesh)  # [M, N1/d, N2] rows k1


def six_step_fft(x: torch.Tensor, mesh: ProverMesh, inverse: bool = False) -> torch.Tensor:
    """Distributed NTT of a length-N vector (natural order in and out);
    the result lands on x's device."""
    n = x.shape[-1]
    assert x.ndim == 1
    n_log = log2_strict(n)
    _check_divides(n_log, mesh)
    n1_log, n2_log = _split_logs(n_log)
    parts = pctx.shard(x.reshape(1, 1 << n2_log, 1 << n1_log), mesh, dim=1)
    out = _six_step_shards(parts, mesh, n_log, inverse)
    if inverse:
        n_inv = gl.ginv(n % gl.P)
        out = pctx.map_shards(lambda a: gf.mul_const(a, n_inv), mesh, out)
    return pctx.all_gather(out, x.device, dim=1).reshape(n)


def six_step_ifft(x: torch.Tensor, mesh: ProverMesh) -> torch.Tensor:
    return six_step_fft(x, mesh, inverse=True)


# ---------------------------------------------------------------------------
# Batched six-step coset IFFT, used by the quotient (plonk/prover.py): the
# quotient values arrive point-sharded from the constraint evaluation, and
# go back to coefficients without one device holding the whole domain.
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def coset_ifft_tables(n_log: int, shift: int) -> Tuple[np.ndarray, np.ndarray]:
    """The separable coset/scale factors of six_step_coset_ifft_batch at
    size 2^n_log: coefficient k = k1·N2 + k2 is scaled by shift^-k / N =
    (shift^-N2)^k1 / N · shift^-k2, an outer product s1[k1]·s2[k2] of two
    small vectors, so the full [N] scale never materializes. Returns
    (s1 [N1], s2 [N2]) as u64 arrays."""
    n = 1 << n_log
    n1_log, n2_log = _split_logs(n_log)
    n1, n2 = 1 << n1_log, 1 << n2_log
    sinv = gl.ginv(shift % gl.P)
    n_inv = gl.ginv(n % gl.P)
    s1 = gl.np_mul(gl.np_powers(gl.gexp(sinv, n2), n1), np.uint64(n_inv))
    s2 = gl.np_powers(sinv, n2)
    return s1, s2


def _scale_shards(n_log: int, shift: int, mesh: ProverMesh) -> List[torch.Tensor]:
    """Per shard the [N1/d, N2] scale s1[k1]·s2[k2], k1 offset by the
    shard's index."""
    n1_log, _ = _split_logs(n_log)
    rows = (1 << n1_log) // mesh.size
    out = []
    for s, dev in enumerate(mesh.devices):
        key = ("scale", n_log, shift, s, rows, str(dev))
        if key not in _TABLES:
            s1, s2 = coset_ifft_tables(n_log, shift)
            a = gf.from_u64(s1[s * rows:(s + 1) * rows], dev)
            b = gf.from_u64(s2, dev)
            _TABLES[key] = gf.mul(a[:, None], b[None, :])
        out.append(_TABLES[key])
    return out


def six_step_coset_ifft_shards(parts, mesh: ProverMesh,
                               shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR) -> List[torch.Tensor]:
    """Coset IFFT of a point-sharded batch: part s is [M, N/d], the values
    at the points [s·N/d, (s+1)·N/d) of shift·H; returns part s of the
    coefficients, [M, N/d] (coefficients [s·N/d, (s+1)·N/d))."""
    m, local = parts[0].shape
    n_log = log2_strict(local * mesh.size)
    _check_divides(n_log, mesh)
    n1_log, n2_log = _split_logs(n_log)
    n1, n2 = 1 << n1_log, 1 << n2_log
    y = pctx.map_shards(lambda a: a.reshape(m, n2 // mesh.size, n1), mesh, parts)
    y = _six_step_shards(y, mesh, n_log, True)  # [M, N1/d, N2] rows k1
    scale = _scale_shards(n_log, shift, mesh)
    return pctx.map_shards(
        lambda a, sc: gf.mul(a, sc[None]).reshape(m, local), mesh, y, scale
    )


def six_step_coset_ifft_batch(q: torch.Tensor, mesh: ProverMesh,
                              shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR) -> torch.Tensor:
    """Coset IFFT of a batch [M, N] (values on shift·H, natural order ->
    coefficients) over the mesh; the result lands on q's device."""
    parts = pctx.shard(q, mesh, dim=1)
    return pctx.all_gather(six_step_coset_ifft_shards(parts, mesh, shift), q.device, dim=1)


# ---------------------------------------------------------------------------
# Sharded Merkle trees: per-shard subtrees, kept on their shards, + the
# levels above the shard roots hashed once (merkle_tree.rs:112-144's
# subtree split becomes the mesh axis). Every Poseidon or Poseidon2 tree
# built under a mesh goes through here (ops/merkle.build_merkle_tree,
# ops/fri_kernels.commit).
# ---------------------------------------------------------------------------


def _tree_fns(hasher):
    """(levels of a subtree, two-to-one level) of a device-tree hasher."""
    from ..ops import merkle
    from ..ops import poseidon as dp

    if hasher is None or hasher.name == "poseidon":
        return merkle._tree_levels, dp.compress_pairs
    if hasher.name == "poseidon2":
        return merkle._p2_tree_levels, merkle._p2_compress_pairs
    raise ValueError(f"no device tree for the {hasher.name} hasher")


def sharded_tree_levels(leaf_parts, mesh: ProverMesh, cap_height: int, device,
                        hasher=None) -> Tuple[List[List[torch.Tensor]], List[torch.Tensor]]:
    """The tree of the [n, w] leaves whose row block s is leaf_parts[s], on
    mesh.devices[s]: each shard hashes its subtree on its device (the leaf
    sponge, then one two-to-one launch a level) down to its root, or to
    its share of the cap. Returns (sub, top): sub[s] the levels of shard
    s's subtree below that, left on its device; top the levels from the
    shards' last level, gathered on ``device``, up to the cap — when the
    cap is smaller than the shard count, the top log2(d) - cap_height
    levels hashed once there. sub[s][k] is rows [s·n/d >> k, (s+1)·n/d >> k)
    of the single-device tree's level k, and top its levels from
    len(sub[0]) up, for every (cap_height, d)."""
    d = mesh.size
    b = log2_strict(d)
    local = leaf_parts[0].shape[0]
    local_log = log2_strict(local)
    assert (local << b) >= 1 << cap_height, "cap taller than the tree"
    levels_fn, compress = _tree_fns(hasher)
    local_levels = local_log - max(cap_height - b, 0)
    sub = pctx.map_shards(lambda rows: levels_fn(rows, local_levels), mesh, leaf_parts)
    top = [pctx.all_gather([s.pop() for s in sub], device, 0)]
    for _ in range(b - cap_height):  # only when the cap is smaller than d
        top.append(compress(top[-1]))
    return sub, top


def sharded_merkle_cap(leaves: torch.Tensor, mesh: ProverMesh, cap_height: int,
                       hasher=None) -> torch.Tensor:
    """The cap [2^cap_height, 4] of the tree of ``leaves`` [n, w], built
    row-sharded by sharded_tree_levels, on the leaves' device."""
    return sharded_tree_levels(pctx.shard(leaves, mesh, 0), mesh, cap_height,
                               leaves.device, hasher)[1][-1]

"""Global prover mesh context — threads multi-device sharding through prove().

The reference parallelizes its prover with rayon (plonky2/src/fri/
oracle.rs:168-223, plonk/prover.rs:640-864, core/src/merkle_tree.rs:
112-144). Here the counterpart is a single-controller device mesh: one
process drives every shard, as one JAX program drives a ``Mesh``.
Polynomial batches ``[num_polys, N]`` shard over the *poly* axis for the
LDE (per-poly work, like rayon's per-poly par_iter), Merkle leaves shard
over the *row* axis from the LDE through each shard's subtree (the
reference's independent subtrees), PoW permutation batches by rows, quotient evaluation shards over domain points, and the
quotient's coset IFFT runs as the six-step transform (parallel/ntt.py)
whose only cross-shard steps are transposes.

Shards move between devices by explicit copies: ``all_to_all`` and
``all_gather`` are ``Tensor.to`` plus ``torch.cat``; there is no
``torch.distributed`` process group. Large arrays stay on their shards
(Merkle leaves and subtree levels row-sharded, oracle coefficients
poly-sharded); what the proof's device needs of them comes as small
results: rows routed by index (``gather_rows``, the reference's GSPMD
gathers from row-sharded arrays) and per-shard partial sums
(``shard_sum``). Every shard's work runs under
``on_shard(device)``, which makes that device current (so the hand-written
kernels launch there) and hides the mesh, so that the shard-local calls
take the single-device paths — the role of ``shard_map``'s local view.

Because all arithmetic is exact (integer mod p), a proof under any mesh
is the single-device proof byte for byte (tests/test_torch_mesh_prove.py).

Usage::

    with prover_mesh(make_prover_mesh(8)):            # eight cards
        proof = prove(prover_data, common, pw)
    with prover_mesh(make_prover_mesh(8, virtual_on="cuda:0")):
        proof = prove(prover_data, common, pw)         # eight shards, one card

A 2-D mesh (``shape=(hosts, chips)``) flattens its axes in order, as the
reference's ``axis=("host", "chip")`` does: shard ``h * chips + c``.
"""

from __future__ import annotations

from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from ..ops import gf

_STATE = {"mesh": None, "local": 0}


@dataclass(frozen=True)
class ProverMesh:
    """An ordered tuple of devices, one a shard; ``shape`` is the mesh's
    axes (product = number of devices). Every sharded dimension runs over
    the axes flattened in order, so the shape changes no result."""

    devices: Tuple[torch.device, ...]
    shape: Tuple[int, ...]

    def __post_init__(self):
        n = 1
        for s in self.shape:
            n *= s
        if n != len(self.devices):
            raise ValueError(f"mesh shape {self.shape} does not hold {len(self.devices)} devices")

    @property
    def size(self) -> int:
        return len(self.devices)


def make_prover_mesh(num_devices: Optional[int] = None, *, virtual_on=None,
                     shape: Optional[Sequence[int]] = None) -> ProverMesh:
    """A mesh of ``num_devices`` shards.

    Without ``virtual_on``: the first ``num_devices`` GPUs (all of them if
    None); asking for more than the machine has raises — no shard is ever
    put on a device that was not named. ``virtual_on=device`` puts every
    shard on that one device (virtual shards: the chunked algorithm, its
    copies and its kernels at the shard sizes, on one card or the CPU).
    ``shape`` makes a 2-D (or n-D) mesh of the same devices."""
    if virtual_on is not None:
        if num_devices is None:
            raise ValueError("virtual shards need their number")
        dev = torch.device(virtual_on)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        devices = (dev,) * num_devices
    else:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = have if num_devices is None else num_devices
        if n < 1 or n > have:
            raise RuntimeError(
                f"a mesh of {n} devices was asked for, and this machine has {have} "
                "CUDA devices; pass virtual_on=<device> for shards that share one"
            )
        devices = tuple(torch.device("cuda", i) for i in range(n))
    return ProverMesh(devices, tuple(shape) if shape is not None else (len(devices),))


def get_mesh() -> Optional[ProverMesh]:
    """The active mesh; None without one, and inside a shard's own work."""
    return None if _STATE["local"] else _STATE["mesh"]


def mesh_key() -> Optional[Tuple[Tuple[torch.device, ...], Tuple[int, ...]]]:
    """The active mesh as a hashable key (None = one device), as the
    reference's; no table of the port is keyed by it."""
    m = get_mesh()
    return None if m is None else (m.devices, m.shape)


def axis_size(key) -> int:
    """Total shard count of a mesh_key (every axis flattened)."""
    devices, _ = key
    return len(devices)


@contextmanager
def prover_mesh(mesh: ProverMesh):
    prev = _STATE["mesh"]
    _STATE["mesh"] = mesh
    try:
        yield mesh
    finally:
        _STATE["mesh"] = prev


@contextmanager
def on_shard(device: torch.device):
    """Run a shard's work: ``device`` is current (its kernels launch there)
    and the mesh is hidden, so nested calls take single-device paths."""
    _STATE["local"] += 1
    try:
        with torch.cuda.device(device) if device.type == "cuda" else nullcontext():
            yield
    finally:
        _STATE["local"] -= 1


# ---------------------------------------------------------------------------
# Shard / gather helpers: a sharded tensor is a list of per-device parts,
# part i on mesh.devices[i], contiguous blocks of the split dimension in
# shard order.
# ---------------------------------------------------------------------------


def shard(x: torch.Tensor, mesh: ProverMesh, dim: int = 0) -> List[torch.Tensor]:
    """Split ``x`` into mesh.size equal blocks along ``dim``, block i copied
    to device i — a copy on x's device too, so that no part keeps the
    whole of ``x`` alive."""
    n = x.shape[dim]
    if n % mesh.size:
        raise ValueError(f"dimension {dim} of size {n} does not split over {mesh.size} shards")
    return [p.to(d, copy=True) for p, d in zip(torch.chunk(x, mesh.size, dim=dim), mesh.devices)]


def all_gather(parts: Sequence[torch.Tensor], device, dim: int = 0) -> torch.Tensor:
    """The parts, copied to ``device``, concatenated along ``dim``."""
    device = torch.device(device)
    return torch.cat([p.to(device) for p in parts], dim=dim)


def all_to_all(parts: Sequence[torch.Tensor], mesh: ProverMesh, split_dim: int,
               concat_dim: int) -> List[torch.Tensor]:
    """The tiled all-to-all: part i is split into mesh.size blocks along
    ``split_dim``; shard j receives block j of every part, concatenated in
    shard order along ``concat_dim``."""
    blocks = [torch.chunk(p, mesh.size, dim=split_dim) for p in parts]
    return [
        torch.cat([b[j].to(d) for b in blocks], dim=concat_dim)
        for j, d in enumerate(mesh.devices)
    ]


def map_shards(fn, mesh: ProverMesh, *sharded_args) -> List:
    """[fn(args of shard i) under on_shard(device i)]; each argument is a
    list with one entry a shard."""
    out = []
    for i, dev in enumerate(mesh.devices):
        with on_shard(dev):
            out.append(fn(*(a[i] for a in sharded_args)))
    return out


def map_rows(fn, mesh: ProverMesh, x: torch.Tensor) -> torch.Tensor:
    """fn applied to mesh.size row blocks of ``x``, each on its shard's
    device, the results gathered back to x's device in order (rows are
    independent, so the split is exact)."""
    return all_gather(map_shards(fn, mesh, shard(x, mesh, 0)), x.device, 0)


def gather_rows(parts: Sequence[torch.Tensor], indices: torch.Tensor, device, rows: int = None,
                take=None) -> torch.Tensor:
    """Rows ``indices`` (an int64 tensor on ``device``) of the array whose
    row block s, of ``rows`` rows (parts[0]'s row count if None), lives on
    shard s, as parts[s]. Each shard gathers every index at its clamped
    local position, the results are copied to ``device`` and merged by
    ownership (index // rows) with torch.where: no host read, whatever
    the indices. ``take(part, local)`` replaces ``part[local]`` (a path
    gather from a shard's flat levels)."""
    rows = parts[0].shape[0] if rows is None else rows
    out = None
    for s, part in enumerate(parts):
        local = indices - s * rows
        with on_shard(part.device):
            got = local.clamp(0, rows - 1).to(part.device)
            got = part[got] if take is None else take(part, got)
        got = got.to(device)
        if out is None:
            out = got  # every row that another shard owns is overwritten below
        else:
            mine = (local >= 0) & (local < rows)
            out = torch.where(mine.reshape((-1,) + (1,) * (got.ndim - 1)), got, out)
    return out


def shard_sum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The field sum of same-shape per-shard parts, on ``device``; exact,
    so equal to the single-device sum in any grouping."""
    device = torch.device(device)
    out = parts[0].to(device)
    for p in parts[1:]:
        out = gf.add(out, p.to(device))
    return out

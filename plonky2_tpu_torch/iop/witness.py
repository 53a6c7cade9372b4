"""Witness containers (reference: plonky2/src/iop/witness.rs:287-473).

PartitionWitness stores one value per copy-equivalence class (indexed by
the union-find representative); MatrixWitness is the dense wires matrix.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..field.goldilocks import P
from .target import Target


class PartialWitness:
    """User-supplied input assignments."""

    def __init__(self):
        self.target_values: Dict[Target, int] = {}

    def set_target(self, t: Target, value: int) -> None:
        value %= P
        if t in self.target_values:
            assert self.target_values[t] == value, f"{t} set twice with different values"
        self.target_values[t] = value

    def set_wire(self, row: int, column: int, value: int) -> None:
        self.set_target(Target.wire(row, column), value)

    def items(self):
        return self.target_values.items()


class PartitionWitness:
    """One value slot per representative of the copy-constraint forest."""

    def __init__(self, representative_map: Sequence[int], num_wires: int, degree: int):
        self.representative_map = representative_map
        self.num_wires = num_wires
        self.degree = degree
        self.values: List[Optional[int]] = [None] * len(representative_map)

    def rep_index(self, t: Target) -> int:
        return self.representative_map[t.flat_index(self.num_wires, self.degree)]

    def try_get_target(self, t: Target) -> Optional[int]:
        return self.values[self.rep_index(t)]

    def get_target(self, t: Target) -> int:
        v = self.try_get_target(t)
        assert v is not None, f"target {t} not set"
        return v

    def get_targets(self, ts: Sequence[Target]) -> List[int]:
        return [self.get_target(t) for t in ts]

    def contains(self, t: Target) -> bool:
        return self.try_get_target(t) is not None

    def set_target(self, t: Target, value: int) -> bool:
        """Returns True if this was a fresh assignment (new representative value)."""
        value %= P
        rep = self.rep_index(t)
        old = self.values[rep]
        if old is not None:
            assert old == value, (
                f"Partition containing {t} was set twice with different values: "
                f"{old} != {value}"
            )
            return False
        self.values[rep] = value
        return True

    def rep_map_np(self) -> np.ndarray:
        """The representative map as int64 numpy (cached; the map is
        immutable after build)."""
        rep = getattr(self, "_rep_np", None)
        if rep is None:
            rep = np.asarray(self.representative_map, dtype=np.int64)
            self._rep_np = rep
        return rep

    def values_snapshot(self) -> np.ndarray:
        """One-pass u64 copy of the representative values (unset -> 0)."""
        return np.fromiter(
            (v if v is not None else 0 for v in self.values),
            dtype=np.uint64,
            count=len(self.values),
        )

    def get_wires_bulk(self, flat_indices: np.ndarray) -> np.ndarray:
        """Vectorized get_target over dense target indices; asserts all set."""
        reps = self.rep_map_np()[flat_indices]
        unset = np.fromiter(
            (v is None for v in self.values), dtype=bool, count=len(self.values)
        )
        assert not unset[reps].any(), "get_wires_bulk: unset target"
        return self.values_snapshot()[reps]

    def set_wires_bulk(self, rows: np.ndarray, cols: np.ndarray, values) -> None:
        """Vectorized set_target over wire targets (same set-twice check)."""
        flat = np.asarray(rows, dtype=np.int64) * self.num_wires + np.asarray(
            cols, dtype=np.int64
        )
        reps = self.rep_map_np()[flat].tolist()
        # Python ints only: np integer scalars stored in the witness would
        # silently overflow in downstream host big-int arithmetic.
        vals = [int(v) % P for v in values]
        store = self.values
        for r, v in zip(reps, vals):
            old = store[r]
            if old is not None:
                assert old == v, (
                    f"Partition {r} was set twice with different values: {old} != {v}"
                )
            else:
                store[r] = v

    def full_witness(self) -> "MatrixWitness":
        vals = self.values_snapshot()
        rep = self.rep_map_np()[: self.degree * self.num_wires]
        wires = vals[rep].reshape(self.degree, self.num_wires).T.copy()
        return MatrixWitness(wires)


@dataclass
class MatrixWitness:
    """wire_values[column, row] — column-major like the reference's
    per-poly layout; converts directly to the device [num_wires, N] batch."""

    wire_values: np.ndarray  # u64 [num_wires, degree]

    def get_wire(self, row: int, column: int) -> int:
        return int(self.wire_values[column, row])

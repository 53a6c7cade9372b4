"""IOP target types (reference: core/src/iop/target.rs, wire.rs).

A Target is either a concrete wire (row, column) or a virtual target
(resolved to a wire through the copy-constraint partition).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple, Union


@dataclass(frozen=True, order=True)
class Wire:
    row: int
    column: int

    def is_routable(self, num_routed_wires: int) -> bool:
        return self.column < num_routed_wires


@dataclass(frozen=True, order=True)
class Target:
    """kind: 'wire' (row, column) or 'virtual' (index)."""

    kind: str
    row: int = 0
    column: int = 0
    index: int = 0

    @staticmethod
    def wire(row: int, column: int) -> "Target":
        return Target("wire", row=row, column=column)

    @staticmethod
    def virtual(index: int) -> "Target":
        return Target("virtual", index=index)

    def is_routable(self, config) -> bool:
        if self.kind == "virtual":
            return True
        return self.column < config.num_routed_wires

    def flat_index(self, num_wires: int, degree: int) -> int:
        """Dense index used by the union-find forest / partition witness."""
        if self.kind == "wire":
            return self.row * num_wires + self.column
        return degree * num_wires + self.index


@dataclass(frozen=True)
class BoolTarget:
    target: Target


@dataclass(frozen=True)
class ExtensionTarget:
    parts: Tuple[Target, ...]  # D targets


@dataclass(frozen=True)
class HashOutTarget:
    elements: Tuple[Target, Target, Target, Target]

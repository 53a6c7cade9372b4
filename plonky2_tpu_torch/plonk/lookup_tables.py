"""Canned lookup tables from the reference's public gadget surface
(reference: plonky2/src/gadgets/lookup.rs:15-48).

TIP5_TABLE is the Tip5 hash S-box (Tip5 paper, public protocol
constant): entry i is ((i+1)^3 mod 257) - 1 — derived here from that
formula rather than transcribed. OTHER_TABLE and SMALLER_TABLE are the
reference's arbitrary test tables (a 20-value motif tiled to 256
entries, and an 8-entry list).
"""

from __future__ import annotations

TIP5_TABLE = tuple(((i + 1) ** 3 % 257) - 1 for i in range(256))

_OTHER_MOTIF = (2, 6, 25, 3, 9, 7, 0, 3, 25, 35, 10, 19, 36, 45, 216, 247,
                35, 39, 57, 126)
OTHER_TABLE = tuple(_OTHER_MOTIF[i % len(_OTHER_MOTIF)] for i in range(256))

SMALLER_TABLE = (2, 24, 56, 100, 128, 16, 20, 49)

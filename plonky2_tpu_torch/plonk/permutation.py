"""Vectorized copy-constraint partition + sigma polynomials.

The interpreted union-find in circuit_builder.Forest costs seconds per
2^14 rows (O(degree * num_wires) Python ops); this module computes the
identical partition with scipy connected-components and the sigma
polynomials with numpy grouping — milliseconds at 2^16 rows.

Semantics pinned to the reference (plonk/permutation_argument.rs:13-155
and the Forest class): copy classes are connected components of the
copy-constraint graph over wire + virtual targets; within a class,
members are ordered by the row-major (row, col<num_routed) scan, and
sigma(wire) = k_{next.col} * subgroup[next.row] where `next` cycles in
that order. Representative choice is the minimum flat node index per
component (any consistent choice is valid — reps never enter proofs or
digests, only the in-memory witness partition).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..field import goldilocks as gl


def flat_indices(targets, num_wires: int, degree: int) -> np.ndarray:
    """Vector of Target.flat_index values."""
    out = np.empty(len(targets), dtype=np.int64)
    base = degree * num_wires
    for i, t in enumerate(targets):
        if t.kind == "wire":
            out[i] = t.row * num_wires + t.column
        else:
            out[i] = base + t.index
    return out


def connected_partition(
    num_nodes: int, edges_a: np.ndarray, edges_b: np.ndarray
) -> np.ndarray:
    """parents[i] = min flat index in i's connected component."""
    if len(edges_a) == 0:
        return np.arange(num_nodes, dtype=np.int64)
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    g = coo_matrix(
        (np.ones(len(edges_a), dtype=np.int8), (edges_a, edges_b)),
        shape=(num_nodes, num_nodes),
    )
    n_comp, labels = connected_components(g, directed=False)
    rep_of_label = np.full(n_comp, num_nodes, dtype=np.int64)
    np.minimum.at(rep_of_label, labels, np.arange(num_nodes, dtype=np.int64))
    return rep_of_label[labels]


def sigma_polys_vectorized(
    parents: np.ndarray,
    degree: int,
    num_wires: int,
    num_routed: int,
    k_is: Sequence[int],
    subgroup: np.ndarray,
) -> np.ndarray:
    """sigma polynomial values [num_routed, degree] from the partition.

    Bit-identical to Forest.wire_partition + sigma_polys_from_partition:
    routed positions are scanned row-major; a stable argsort by
    representative groups each class in scan order; `next` is the
    cyclic successor within the group.
    """
    pos = np.arange(degree * num_routed, dtype=np.int64)
    rows = pos // num_routed
    cols = pos % num_routed
    reps = parents[rows * num_wires + cols]
    order = np.argsort(reps, kind="stable")  # groups, members in scan order
    sorted_reps = reps[order]
    n = len(order)
    change = np.empty(n, dtype=bool)
    change[0] = True
    np.not_equal(sorted_reps[1:], sorted_reps[:-1], out=change[1:])
    group_id = np.cumsum(change) - 1
    starts = np.flatnonzero(change)
    is_last = np.empty(n, dtype=bool)
    is_last[:-1] = change[1:]
    is_last[-1] = True
    nxt_sorted = np.where(is_last, starts[group_id], np.arange(1, n + 1))
    nxt_pos = order[nxt_sorted]
    nrow = nxt_pos // num_routed
    ncol = nxt_pos % num_routed
    k_np = np.asarray(list(k_is), dtype=np.uint64)
    vals = gl.np_mul(k_np[ncol], np.asarray(subgroup, dtype=np.uint64)[nrow])
    sigma = np.zeros((num_routed, degree), dtype=np.uint64)
    sigma[cols[order], rows[order]] = vals  # vals is in sorted-group order
    return sigma

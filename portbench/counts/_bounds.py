"""The least time the card could take for a stretch of work, and the
operation counts it rests on.

Frozen copies, so that the yardstick stays put when the program changes:
  * the peaks of plonky2_tpu_torch/utils/profiling.py:31-32. The memory
    rate, 3.35e12 bytes a second, is NVIDIA's data sheet for the H100 SXM
    at its full power limit (700 W). The integer rate, 33.5e12 operations
    a second with a multiply-add counted as two, is derived (64 int32
    lanes a clock an SM, half the float32 lanes), not published; a card
    set below 700 W runs below both;
  * the operation constants of chip_smoke.py:289-304
    (MADS_PER_PERMUTATION, OPS_PER_PERMUTATION, OPS_PER_FIELD_PRODUCT);
  * bound_record, poseidon_bound and butterfly_bound of
    chip_smoke.py:1374-1400 (and the Roofline arithmetic of
    utils/profiling.py:97-131 that bound_record computes through),
    without the butterfly's stage table: each input word is read once and
    each output word written once."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12

# 32x32->64 multiply-adds of one Poseidon permutation, for the cheapest
# algorithm known to the program: 8 full rounds of 12 S-boxes (14 each) and
# a dense MDS layer (288), the 11 x 11 pre-partial matrix (4 a product),
# and 22 partial rounds of one S-box and 23 products.
MADS_PER_PERMUTATION = 8 * (12 * 14 + 288) + 11 * 11 * 4 + 22 * (14 + 23 * 4)
OPS_PER_PERMUTATION = 2 * MADS_PER_PERMUTATION
# a Goldilocks product: 4 partial products, 8 integer operations
OPS_PER_FIELD_PRODUCT = 8


def bound_record(words_moved: int, operations: int) -> dict:
    """Bytes over the memory rate against operations over the integer
    peak; the larger bounds the time."""
    bytes_s = words_moved * 8 / HBM_BYTES_PER_S
    ops_s = operations / INT32_OPS_PER_S
    return {
        "bound_s": max(bytes_s, ops_s),
        "bound_by": "bytes" if bytes_s > ops_s else "operations",
        "bytes_s": bytes_s,
        "operations_s": ops_s,
    }


def poseidon_bound(permutations: int, words_moved: int) -> dict:
    return bound_record(words_moved, permutations * OPS_PER_PERMUTATION)


def butterfly_bound(transforms: int, n_log: int, stages: int) -> dict:
    """``transforms`` transforms of 2^n_log points running ``stages``
    stages: each word read and written once, (N/2) products a stage."""
    words = 2 * (transforms << n_log)
    products = transforms * (1 << (n_log - 1)) * stages
    return bound_record(words, products * OPS_PER_FIELD_PRODUCT)

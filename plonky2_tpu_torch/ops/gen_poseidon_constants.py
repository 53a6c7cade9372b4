"""Writes csrc/poseidon_constants.cuh from the Python tables.

    python3 -m plonky2_tpu_torch.ops.gen_poseidon_constants

The round constants and MDS rows come from hash/poseidon_constants.py, the
tables of the fast partial rounds from hash/poseidon_fast.py (derived there
from the same constants and pinned to the plain permutation by a test). No
value of the header is typed by hand; a CPU test regenerates the text and
compares it with the file.
"""

from __future__ import annotations

import sys
from pathlib import Path

from ..field.goldilocks import P
from ..hash import poseidon_constants as pc
from ..hash import poseidon_fast as pf

HEADER = Path(__file__).resolve().parent / "csrc" / "poseidon_constants.cuh"


def _u64_table(name: str, values, comment: str) -> str:
    vals = [int(v) % P for v in values]
    rows = [
        "    " + " ".join(f"0x{v:016x}ULL," for v in vals[i : i + 4])
        for i in range(0, len(vals), 4)
    ]
    return (
        f"// {comment}\n"
        f"__constant__ uint64_t {name}[{len(vals)}] = {{\n" + "\n".join(rows) + "\n};\n"
    )


def render() -> str:
    t = pc.SPONGE_WIDTH
    mds00 = pc.MDS_MATRIX_CIRC[0] + pc.MDS_MATRIX_DIAG[0]
    assert mds00 == pf.MDS_0_0
    parts = [
        "// Poseidon round constants, MDS rows and the tables of the fast partial\n"
        "// rounds for Goldilocks, width 12. Generated by\n"
        "// plonky2_tpu_torch/ops/gen_poseidon_constants.py from\n"
        "// hash/poseidon_constants.py and hash/poseidon_fast.py: do not edit, rerun it.\n"
        "// Every 64-bit entry is canonical (< p).\n"
        "#pragma once\n"
        "#include <cstdint>\n",
        f"#define POSEIDON_WIDTH {t}\n"
        f"#define POSEIDON_RATE {pc.SPONGE_RATE}\n"
        f"#define POSEIDON_HALF_FULL_ROUNDS {pc.HALF_N_FULL_ROUNDS}\n"
        f"#define POSEIDON_PARTIAL_ROUNDS {pc.N_PARTIAL_ROUNDS}\n"
        f"#define POSEIDON_ROUNDS {pc.N_ROUNDS}\n"
        f"#define POSEIDON_MDS_0_0 {mds00}  // MDS[0][0] = CIRC[0] + DIAG[0]\n",
        "// MDS[r][j] = CIRC[(j - r) mod 12] + (j == r ? DIAG[r] : 0); entries < 2^6.\n"
        "// Initialisers of constexpr arrays, so that the unrolled products by them\n"
        "// fold into immediates (and the zero diagonal entries away).\n"
        f"#define POSEIDON_MDS_CIRC {{{', '.join(str(v) for v in pc.MDS_MATRIX_CIRC)}}}\n"
        f"#define POSEIDON_MDS_DIAG {{{', '.join(str(v) for v in pc.MDS_MATRIX_DIAG)}}}\n",
        _u64_table("POSEIDON_RC", pc.ALL_ROUND_CONSTANTS,
                   "ALL_ROUND_CONSTANTS, [30][12]; the kernels read the 8 full rounds' rows"),
        _u64_table("POSEIDON_FAST_FIRST_RC", pf.FAST_PARTIAL_FIRST_ROUND_CONSTANT,
                   "FAST_PARTIAL_FIRST_ROUND_CONSTANT, [12]: added before the first partial round"),
        _u64_table("POSEIDON_FAST_RC", pf.FAST_PARTIAL_ROUND_CONSTANTS,
                   "FAST_PARTIAL_ROUND_CONSTANTS, [22]: lane 0 after each partial S-box "
                   "(the last is 0)"),
        _u64_table("POSEIDON_FAST_INIT",
                   [v for row in pf.FAST_PARTIAL_ROUND_INITIAL_MATRIX for v in row],
                   "FAST_PARTIAL_ROUND_INITIAL_MATRIX, [11][11] row-major: "
                   "out[c] = sum_r s[r] * INIT[r-1][c-1], r, c in 1..11"),
        _u64_table("POSEIDON_FAST_W_HATS",
                   [v for row in pf.FAST_PARTIAL_ROUND_W_HATS for v in row],
                   "FAST_PARTIAL_ROUND_W_HATS, [22][11]: s0' = MDS[0][0] s0 + "
                   "sum_i W_HATS[r][i-1] s[i]"),
        _u64_table("POSEIDON_FAST_VS",
                   [v for row in pf.FAST_PARTIAL_ROUND_VS for v in row],
                   "FAST_PARTIAL_ROUND_VS, [22][11]: s[i] += s0 * VS[r][i-1]"),
    ]
    return "\n".join(parts)


def main() -> int:
    HEADER.write_text(render())
    print(f"wrote {HEADER}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

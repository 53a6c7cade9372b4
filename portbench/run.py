#!/usr/bin/env python3
"""The benchmark of plonky2_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, kernels, the configuration, every input of the window
made from the seed, one warm proof), then one prover proving back to back
for --seconds, then the check of a sample of the window's proofs against
the plain reference. The last line of standard output is one JSON object:
correct, attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), device, with --trace 1 a breakdown, and the
numbers compared with their limits under "checks". Exits non-zero without
a result when the cell's CUDA devices are missing or the run loaded JAX or
the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench.lib import harness

    return harness.run(args, T_START)


if __name__ == "__main__":
    sys.exit(main())

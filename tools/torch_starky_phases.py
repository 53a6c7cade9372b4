"""Run the STARK phases of chip_smoke.py alone on one NVIDIA GPU: the card
build, the 2^22-row FibonacciStark, the batch STARK, the rest of Starky
(the logUp PermutationStark, the CTL system, the zero-knowledge STARK,
each first at the pinned small size) and the three degree-2^14 PLONK
wraps. Every check of those phases applies; the kernels' bit-exact replay
(main_path_kernels) does not run. About 70 s on an H100.

    python3 tools/torch_starky_phases.py
"""

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    t0 = time.time()
    card = cs.phase_device()
    golden = os.path.join(REPO, "tests", "golden")
    _, _, stark_inner = cs.phase_stark(cs.STARK_LOG_ROWS)
    _, _, batch_inner = cs.phase_batch_stark(golden)
    cs.phase_stark_lookup_small(golden)
    _, _, lookup_inner = cs.phase_stark_lookup(cs.LOOKUP_LOG_ROWS)
    cs.phase_stark_ctl(golden, cs.CTL_LOG_ROWS)
    cs.phase_stark_zk(golden, cs.ZK_STARK_LOG_ROWS)
    cs.phase_stark_recursion(stark_inner, batch_inner, lookup_inner, golden)
    print(card, flush=True)
    cs.say({"starky_run_s": time.time() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())

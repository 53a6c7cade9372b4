"""Run chip_smoke.py's checkpoint and mesh phases alone on the machine's
NVIDIA GPUs: the card build; kernel_guards' check that each card's NTT
launches go to that card (with more than one card, the FFTs on every other
card's tensors, card 0 current); phase 23 (checkpoint_aux: the NoopGate
2^16 circuit through a checkpoint, the torch-free verifier, a traced
fibonacci proof) and phase 24 (mesh_2^16: 8 virtual shards on card 0, the
circuit as built and loaded again under the mesh, the largest single
allocations, the same proofs over the real cards when there is a power of
two of them, more than one; the 2^24 six-step transforms, the sharded
cap); then every kernel form these two phases launched held bit-exact
against its plain version and timed (main_path_kernels over their shapes
only). Every check of those phases applies.

    python3 tools/torch_aux_mesh_phases.py
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
    devices = cs.check_devices(cs.np.random.default_rng(2028))
    cs.say({"devices": devices})
    if not devices["ok"]:
        return 1
    proof, data, blob, shapes = cs.phase_checkpoint_aux(cs.LOG2_GATES)
    _, mesh_shapes = cs.phase_mesh(proof, data, blob)
    cs.merge_shapes(shapes, mesh_shapes)
    del data
    cs.torch.cuda.empty_cache()
    records = cs.phase_main_path_kernels(shapes)
    print(card, flush=True)
    cs.say({"kernels": records})
    cs.say({"aux_mesh_run_s": time.time() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())

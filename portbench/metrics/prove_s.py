"""prove_s: the window's seconds over the proofs completed in it. The
window runs from the start of its first proof to the end of its last, each
proof ended by torch.cuda.synchronize(); the last proof may run past the
requested length and its time counts. Host clock."""

UNIT = "s"


def read(run):
    if not run.latencies:
        return None
    return run.window_s / len(run.latencies)

"""launches_per_proof: device kernels recorded by the profiler in the
traced window (copies and memsets left out) per proof."""

UNIT = "launches/proof"


def read(run):
    if run.trace is None or not run.latencies:
        return None
    return run.trace.kernel_count() / len(run.latencies)

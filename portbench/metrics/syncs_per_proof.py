"""syncs_per_proof: synchronising CUDA operations over the traced window
(lib/frozen/syncs.py, CUDA's sync debug mode) per proof. The harness's
own torch.cuda.synchronize() after each proof is outside the count."""

UNIT = "syncs/proof"


def read(run):
    if run.syncs is None or not run.latencies:
        return None
    return run.syncs / len(run.latencies)

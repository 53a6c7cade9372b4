"""prove_p90_s: the 90th percentile of the latencies of all the window's
proofs, each from its start to a torch.cuda.synchronize() after it
(statistics.quantiles, inclusive method). Host clock."""

import statistics

UNIT = "s"


def read(run):
    if len(run.latencies) < 2:
        return None
    return statistics.quantiles(run.latencies, n=10, method="inclusive")[8]

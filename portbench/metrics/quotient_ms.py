"""quotient_ms: mean host milliseconds a proof of the program's span
prove/quotient (plonk/prover.py), in the traced window. Nothing to read
where the entry has no such span (the STARK provers)."""

UNIT = "ms"


def read(run):
    if run.trace is None:
        return None
    spans = run.trace.span_seconds("prove/quotient")
    return 1e3 * sum(spans) / len(run.latencies) if spans else None

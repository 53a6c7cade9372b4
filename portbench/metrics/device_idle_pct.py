"""device_idle_pct: 100 x (1 - union of the device activities' intervals /
the traced window), from the profiler's trace."""

UNIT = "%"


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)

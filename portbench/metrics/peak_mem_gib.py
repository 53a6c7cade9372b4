"""peak_mem_gib: torch.cuda.max_memory_allocated() over the window (reset
at its start), in GiB: the configuration's resident data and every proof's
working set; the reference's work comes later and is not in it."""

UNIT = "GiB"


def read(run):
    if not run.on_card:
        return None
    return run.peak_window_bytes / 2**30

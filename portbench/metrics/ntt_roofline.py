"""ntt_roofline: the op group "ntt" (counts/ntt.py) against its
roofline, in %: 100 x the least time of its calls in the traced window
(bytes over the memory rate or integer operations over the integer peak,
whichever is larger, counts/_bounds.py) over the device time of every
activity those calls launched. Nothing to read where no call of the group
launched device work."""

UNIT = "%"


def read(run):
    if run.trace is None:
        return None
    return run.trace.group_roofline("ntt")

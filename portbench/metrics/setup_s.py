"""setup_s: seconds from the start of the run's process (before torch is
imported) until the window may begin: imports, kernel load or build, the
configuration's set-up (circuit build), making every input of the window,
and one warm proof. Host clock."""

UNIT = "s"


def read(run):
    return run.setup_s

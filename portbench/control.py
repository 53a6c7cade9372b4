#!/usr/bin/env python3
"""Readings of a cell's control (lib/control.py), one JSON line a seed:

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

Exits 1 if any control proof passed the check. On the card where there is
one, else on the CPU."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from portbench.lib.control import main

    sys.exit(main())

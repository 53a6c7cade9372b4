"""On the card (marker "card"; skipped without one): the control of each
cell at the cell's own size, and one short run of each cell that must come
out correct. Run on a machine with the GPU:

    python -m pytest portbench/tests -m card -q -p no:cacheprovider
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from portbench.lib import control
from portbench.tests.helpers import PORTBENCH

CELLS = [w["name"] for w in json.loads((PORTBENCH.parent / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(card, cell):
    seeds = [3_000_000_101, 3_000_000_102, 3_000_000_103]
    readings = list(control.control_readings(cell, seeds, card))
    assert [r["proofs_mismatched"] for r in readings] == [1, 1, 1], readings


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(card, cell):
    cmd = [sys.executable, str(PORTBENCH / "run.py"), "--workload", cell,
           "--seed", "3000000201", "--seconds", "5", "--trace", "0"]
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                          cwd=PORTBENCH.parent, env=dict(os.environ))
    assert done.returncode == 0, done.stderr[-4000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu", line

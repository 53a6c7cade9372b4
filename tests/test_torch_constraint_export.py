"""The port's constraint exporter (plonky2_tpu_torch.constraint_export) over
the port's gates: its export equals the committed formal/constraints.json
and formal/Plonky2Spec/Generated/Gates.lean byte for byte; each gate's
symbolic DAG evaluated on random inputs equals the gate's host evaluation
(tests/test_constraint_export.py's differential check); Poseidon's DAG
stays linear; the command line writes only where it is told. Exact
equality throughout."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from _torch_port import lazy_module

cexp = lazy_module("plonky2_tpu_torch.constraint_export")
cmain = lazy_module("plonky2_tpu_torch.constraint_export.__main__")
render = lazy_module("plonky2_tpu_torch.constraint_export.render")
algebra = lazy_module("plonky2_tpu_torch.gates.algebra")

REPO = Path(__file__).resolve().parent.parent
FORMAL = REPO / "formal"
P = (1 << 64) - (1 << 32) + 1
NUM_GATES = 19


def test_export_equals_formal_files():
    lean, js = cmain.render_all()
    assert js == (FORMAL / "constraints.json").read_text()
    assert lean == (FORMAL / "Plonky2Spec" / "Generated" / "Gates.lean").read_text()


@pytest.mark.parametrize("index", range(NUM_GATES))
def test_symbolic_matches_host_eval(index):
    gate = cexp.default_gate_set()[index]
    ex = cexp.extract(gate)
    rng = np.random.default_rng(hash(gate.id()) & 0xFFFF)
    wires = [int(x) for x in rng.integers(0, P, size=max(ex.num_wires, 1), dtype=np.uint64)]
    consts = [int(x) for x in rng.integers(0, P, size=max(ex.num_constants, 1), dtype=np.uint64)]
    pis = [int(x) for x in rng.integers(0, P, size=4, dtype=np.uint64)]
    got = cexp.eval_all(ex.constraints, wires, consts, pis)
    vars = algebra.EvalVars(
        local_constants=[(c, 0) for c in consts[: gate.num_constants()]],
        local_wires=[(w, 0) for w in wires[: gate.num_wires()]],
        public_inputs_hash=[(p, 0) for p in pis],
    )
    want = gate.eval_unfiltered(vars, algebra.HostExtAlgebra())
    assert len(got) == len(want) == gate.num_constraints()
    for i, (g, w) in enumerate(zip(got, want)):
        assert w[1] == 0, f"constraint {i}: base-embedded eval left the base field"
        assert g == w[0], f"constraint {i}: symbolic {g} != host {w[0]}"


def test_default_gate_set_is_the_reference_set():
    from plonky2_tpu.constraint_export import default_gate_set as ref_gates

    assert [g.id() for g in cexp.default_gate_set()] == [g.id() for g in ref_gates()]
    assert len(cexp.default_gate_set()) == NUM_GATES


def test_poseidon_dag_is_shared_not_exponential():
    """Hash-consing keeps Poseidon's DAG linear, and the let-program renders
    one binding per reachable arithmetic node."""
    from plonky2_tpu_torch.gates.poseidon import PoseidonGate

    ex = cexp.extract(PoseidonGate())
    assert len(ex.arena) < 200_000
    body = render.emit_lets(ex)
    assert 0 < body.count("let n") <= len(ex.arena)


def test_render_lean_and_json():
    from plonky2_tpu_torch.gates.basic import ArithmeticGate

    ex = cexp.extract(ArithmeticGate(num_ops=2))
    text = render.lean_def(ex)
    assert f"def {ex.name}_constraints" in text
    assert "(w 0)" in text and "let n" in text
    assert ex.gate_id in render.to_json([ex])


def test_main_writes_to_the_directory_given(tmp_path):
    before = {p: p.stat().st_mtime_ns for p in FORMAL.rglob("*") if p.is_file()}
    out = subprocess.run(
        [sys.executable, "-m", "plonky2_tpu_torch.constraint_export", str(tmp_path / "out")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert (tmp_path / "out" / "constraints.json").read_bytes() == (
        FORMAL / "constraints.json").read_bytes()
    assert (tmp_path / "out" / "Plonky2Spec" / "Generated" / "Gates.lean").read_bytes() == (
        FORMAL / "Plonky2Spec" / "Generated" / "Gates.lean").read_bytes()
    assert {p: p.stat().st_mtime_ns for p in FORMAL.rglob("*") if p.is_file()} == before

"""Constraint exporter: symbolic extraction of gate constraints from the
live gate code, rendered to Lean + JSON (reference constraint-exporter
crate + formal/ Lean bridge).

    python -m plonky2_tpu_torch.constraint_export [OUT_DIR]
        # writes OUT_DIR/Plonky2Spec/Generated/Gates.lean and
        # OUT_DIR/constraints.json (OUT_DIR: constraint_export_out/)

The gates are the port's (gates/algebra.py's single source); their export
equals the committed formal/constraints.json and
formal/Plonky2Spec/Generated/Gates.lean byte for byte
(tests/test_torch_constraint_export.py).
"""

from .extract import Extracted, default_gate_set, extract, extract_all
from .symbolic import SymbolicAlgebra, eval_all, reset

__all__ = [
    "Extracted",
    "SymbolicAlgebra",
    "default_gate_set",
    "eval_all",
    "extract",
    "extract_all",
    "reset",
]

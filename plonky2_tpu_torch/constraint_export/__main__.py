"""Write the auto-extracted constraint artifacts into a directory:

  OUT_DIR/Plonky2Spec/Generated/Gates.lean  — every gate's constraint
      list as a Lean definition over ZMod p (straight-line lets)
  OUT_DIR/constraints.json                  — the raw DAGs for other
      consumers (SMT, diff against future refactors)

OUT_DIR is the first argument, constraint_export_out/ in the current
directory without one. Nothing is written anywhere else: the files have the
layout of the repo's formal/ directory, so that the two compare with diff.

    python -m plonky2_tpu_torch.constraint_export [OUT_DIR]
"""

import pathlib
import sys

from .extract import extract_all
from .render import lean_def, to_json

# The header names the module that first wrote formal/Plonky2Spec/Generated/
# Gates.lean; the port's export keeps it, so that the two files are equal
# byte for byte.
PRELUDE = """/- Auto-generated by plonky2_tpu.constraint_export — do not edit.
   Gate constraint polynomials over the Goldilocks field, extracted by
   instantiating each gate's single-source eval_unfiltered with a
   symbolic algebra. -/
import Mathlib.Algebra.Field.Defs

namespace Plonky2Spec.Generated

variable {F : Type} [Field F]

"""

EPILOGUE = "\nend Plonky2Spec.Generated\n"

DEFAULT_OUT = "constraint_export_out"


def render_all(extractions=None):
    """(Gates.lean text, constraints.json text) of the default gate set."""
    extractions = extract_all() if extractions is None else extractions
    defs = "\n\n".join(lean_def(ex) for ex in extractions)
    return PRELUDE + defs + EPILOGUE, to_json(extractions)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    out = pathlib.Path(argv[0] if argv else DEFAULT_OUT)
    gen = out / "Plonky2Spec" / "Generated"
    gen.mkdir(parents=True, exist_ok=True)

    extractions = extract_all()
    lean, js = render_all(extractions)
    (gen / "Gates.lean").write_text(lean)
    (out / "constraints.json").write_text(js)
    total = sum(len(ex.constraints) for ex in extractions)
    print(
        f"wrote {gen / 'Gates.lean'} ({len(extractions)} gates, "
        f"{total} constraints) and {out / 'constraints.json'}"
    )


if __name__ == "__main__":
    main()

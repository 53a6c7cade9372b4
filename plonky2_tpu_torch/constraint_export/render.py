"""Render extracted constraint DAGs to Lean terms and JSON
(constraint-exporter/src/render.rs).

Two strategies, as in the reference:
* inline tree (``to_lean``) — fully parenthesized, no sharing; fine for
  small gates;
* straight-line ``let``-program (``emit_lets``) — one binding per
  arithmetic node, so shared subexpressions (Poseidon's MDS sums, used
  ~12x per round) are written once. Node ids are topologically ordered,
  so a single forward pass suffices.
"""

from __future__ import annotations

import json
from typing import List

from .extract import Extracted

_LEAF = {"const", "wire", "lconst", "pih"}


def _leaf_str(n: tuple) -> str:
    op = n[0]
    if op == "const":
        return str(n[1])
    if op == "wire":
        return f"w{n[1]}"
    if op == "lconst":
        return f"c{n[1]}"
    return f"pi{n[1]}"


def to_lean(ex: Extracted, h: int) -> str:
    """Fully-parenthesized Lean term for handle h (ZMod p context)."""
    n = ex.arena[h]
    op = n[0]
    if op in _LEAF:
        return _leaf_str(n)
    if op == "neg":
        return f"(-{to_lean(ex, n[1])})"
    sym = {"add": "+", "sub": "-", "mul": "*"}[op]
    return f"({to_lean(ex, n[1])} {sym} {to_lean(ex, n[2])})"


def emit_lets(ex: Extracted) -> str:
    """Straight-line let-program: binds every arithmetic node reachable
    from the constraints, returns the constraint list as a Lean `[...]`."""
    # mark reachable nodes
    reach = [False] * len(ex.arena)
    stack = list(ex.constraints)
    while stack:
        h = stack.pop()
        if reach[h]:
            continue
        reach[h] = True
        n = ex.arena[h]
        if n[0] not in _LEAF:
            stack.extend(n[1:] if n[0] == "neg" else n[1:3])

    def ref(h: int) -> str:
        n = ex.arena[h]
        return _leaf_str(n) if n[0] in _LEAF else f"n{h}"

    lines: List[str] = []
    for h, n in enumerate(ex.arena):
        if not reach[h] or n[0] in _LEAF:
            continue
        if n[0] == "neg":
            rhs = f"-{ref(n[1])}"
        else:
            sym = {"add": "+", "sub": "-", "mul": "*"}[n[0]]
            rhs = f"{ref(n[1])} {sym} {ref(n[2])}"
        lines.append(f"  let n{h} := {rhs}")
    ret = "[" + ", ".join(ref(h) for h in ex.constraints) + "]"
    return "\n".join(lines + [f"  {ret}"])


def lean_def(ex: Extracted, inline_threshold: int = 256) -> str:
    """A Lean definition for the gate's constraint list over ZMod p,
    taking wires/constants/public-input-hash as vectors. Its doc comment
    names the module that first wrote formal/'s files, so that the port's
    export equals them byte for byte."""
    header = (
        f"/-- Constraints of `{ex.gate_id}`, auto-extracted from the live\n"
        f"gate code (plonky2_tpu.constraint_export). Each entry must be 0. -/\n"
        f"def {ex.name}_constraints\n"
        f"    (w : Fin {max(ex.num_wires, 1)} → F)"
        f" (c : Fin {max(ex.num_constants, 1)} → F)"
        f" (pi : Fin 4 → F) : List F :=\n"
    )
    return header + _tokenize_leaves(ex, emit_lets(ex))


def _tokenize_leaves(ex: Extracted, body: str) -> str:
    import re

    def repl(m):
        kind, idx = m.group(1), m.group(2)
        fn = {"w": "w", "c": "c", "pi": "pi"}[kind]
        return f"({fn} {idx})"

    return re.sub(r"\b(w|c|pi)(\d+)\b", repl, body)


def to_json(extractions: List[Extracted]) -> str:
    out = []
    for ex in extractions:
        out.append(
            {
                "gate": ex.gate_id,
                "name": ex.name,
                "num_wires": ex.num_wires,
                "num_constants": ex.num_constants,
                "num_constraints": len(ex.constraints),
                "arena": [list(n) for n in ex.arena],
                "constraints": ex.constraints,
            }
        )
    return json.dumps(out, indent=1)

"""Reading a proof the program made into the reference's plain form, and
the comparison of two such forms, part by part.

The program's proof objects are read by their attributes only, to be
judged; nothing of the program is imported."""

from __future__ import annotations

from typing import Any, List


def _ints(xs) -> List[int]:
    return [int(x) for x in xs]


def _cap(cap) -> List[List[int]]:
    return None if cap is None else [_ints(d) for d in cap]


def _exts(es) -> List[tuple]:
    return [] if es is None else [tuple(int(c) for c in e) for e in es]


def program_stark_proof(pwp) -> dict:
    """A StarkProofWithPublicInputs of the program as the plain form that
    reference.starky.prove returns."""
    proof = pwp.proof
    op = proof.openings
    fri = proof.opening_proof
    queries = []
    for rnd in fri.query_round_proofs:
        initial = [(_ints(leaf), [tuple(_ints(s)) for s in mp.siblings])
                   for leaf, mp in rnd.initial_trees_proof.evals_proofs]
        steps = [(_exts(st.evals), [tuple(_ints(s)) for s in st.merkle_proof.siblings])
                 for st in rnd.steps]
        queries.append({"initial": initial, "steps": steps})
    return {
        "public_inputs": _ints(pwp.public_inputs),
        "trace_cap": _cap(proof.trace_cap),
        "auxiliary_cap": _cap(proof.auxiliary_polys_cap),
        "quotient_cap": _cap(proof.quotient_polys_cap),
        "openings": {
            "local": _exts(op.local_values),
            "next": _exts(op.next_values),
            "auxiliary": _exts(op.auxiliary_polys),
            "auxiliary_next": _exts(op.auxiliary_polys_next),
            "ctl_zs_first": [] if op.ctl_zs_first is None else _ints(op.ctl_zs_first),
            "quotient": _exts(op.quotient_polys),
        },
        "fri": {
            "commit_caps": [_cap(c) for c in fri.commit_phase_merkle_caps],
            "final_poly": _exts(fri.final_poly),
            "pow_witness": int(fri.pow_witness),
            "queries": queries,
        },
    }


def _norm(x: Any):
    """Lists and tuples alike, recursively, so that only values count."""
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return x


def differing_parts(program: dict, reference: dict) -> List[str]:
    """The names of the parts in which two plain proofs differ: public
    inputs, each cap, each opening batch, the final polynomial, the
    witness, and the query openings tree by tree."""
    a, b = _norm(program), _norm(reference)
    out = []
    for key in ("public_inputs", "trace_cap", "auxiliary_cap", "quotient_cap"):
        if a[key] != b[key]:
            out.append(key)
    for key in ("local", "next", "auxiliary", "auxiliary_next", "ctl_zs_first", "quotient"):
        if a["openings"][key] != b["openings"][key]:
            out.append(f"openings.{key}")
    fa, fb = a["fri"], b["fri"]
    for key in ("commit_caps", "final_poly", "pow_witness"):
        if fa[key] != fb[key]:
            out.append(f"fri.{key}")
    if len(fa["queries"]) != len(fb["queries"]):
        out.append("fri.queries.count")
        return out
    init = sorted({i for qa, qb in zip(fa["queries"], fb["queries"])
                   for i in range(max(len(qa["initial"]), len(qb["initial"])))
                   if qa["initial"][i:i + 1] != qb["initial"][i:i + 1]})
    steps = sorted({i for qa, qb in zip(fa["queries"], fb["queries"])
                    for i in range(max(len(qa["steps"]), len(qb["steps"])))
                    if qa["steps"][i:i + 1] != qb["steps"][i:i + 1]})
    out += [f"fri.queries.initial[{i}]" for i in init]
    out += [f"fri.queries.steps[{i}]" for i in steps]
    return out


def differing_tables(program: List[dict], reference: List[dict]) -> List[str]:
    """differing_parts table by table, each part named with its table."""
    if len(program) != len(reference):
        return ["tables.count"]
    return [f"table{t}.{part}" for t, (a, b) in enumerate(zip(program, reference))
            for part in differing_parts(a, b)]

"""Debug/validation utility: check that a full witness satisfies every
gate constraint row-by-row and every copy constraint. Much faster than
proving; used by tests to validate big circuits (e.g. the recursive
verifier) against real data. Analogous to the reference's debug
assertions in prove() (plonk/prover.rs validate in debug builds)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..field import goldilocks as gl
from ..gates.algebra import EvalVars
from ..gates.gate_testing import NumpyBatchAlgebra


class WitnessCheckError(Exception):
    pass


def check_witness(data, witness, public_inputs_hash=None) -> None:
    """witness: MatrixWitness-like with wire_values [num_wires, n]."""
    common = data.common
    n = common.degree
    wires = witness.wire_values  # [num_wires, n]

    if public_inputs_hash is None:
        public_inputs_hash = (0, 0, 0, 0)

    # group rows by gate type for batched evaluation
    instances = data.prover_only.gate_instances
    by_gate = {}
    for row, inst in enumerate(instances):
        by_gate.setdefault(inst.gate.id(), []).append(row)

    gate_of = {inst.gate.id(): inst.gate for inst in instances}
    for gate_id, rows in by_gate.items():
        gate = gate_of[gate_id]
        if gate.num_constraints() == 0:
            continue
        b = len(rows)
        A = NumpyBatchAlgebra(b)
        sel = np.array(rows, dtype=np.int64)
        w_cols = [wires[c][sel] for c in range(common.config.num_wires)]
        consts = [
            np.array(
                [instances[r].constants[i] if i < len(instances[r].constants) else 0 for r in rows],
                dtype=np.uint64,
            )
            for i in range(gate.num_constants())
        ]
        pis = [np.full(b, public_inputs_hash[i] % gl.P, dtype=np.uint64) for i in range(4)]
        vals = gate.eval_unfiltered(EvalVars(consts, w_cols, pis), A)
        for k, v in enumerate(vals):
            bad = np.nonzero(gl.np_canonicalize(np.asarray(v, dtype=np.uint64)))[0]
            if bad.size:
                raise WitnessCheckError(
                    f"{gate_id}: constraint {k} violated at rows "
                    f"{[rows[int(i)] for i in bad[:5]]}"
                )

    # copy constraints: all routed wires in one partition class share a value
    rep = data.prover_only.representative_map
    num_wires = common.config.num_wires
    vals_by_rep = {}
    for row in range(n):
        base = row * num_wires
        for col in range(common.config.num_routed_wires):
            r = rep[base + col]
            v = int(wires[col][row])
            prev = vals_by_rep.get(r)
            if prev is None:
                vals_by_rep[r] = v
            elif prev != v:
                raise WitnessCheckError(
                    f"copy constraint violated at (row={row}, col={col}): {v} != {prev}"
                )

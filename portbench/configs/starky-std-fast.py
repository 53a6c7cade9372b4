"""Configuration "starky-std-fast": STARKs proved by the port under the
numbers of configs/starky-std-fast.json, checked against
reference/starky.py.

Statements (the traffic's "statement"):
  fibonacci  upstream's FibonacciStark at 2^log_rows rows, proved by
             plonky2_tpu_torch.stark.prover.prove; an input is a (x0, x1)
             drawn from its seed, the trace and the public inputs
             [x0, x1, f(2^log_rows)] made by lib/frozen/fib_trace.py on the
             device, handed to the prover as a host array.
  ctl        the two-table cross-table-lookup system of the program's tests
             (CtlLookingStark at 2^log_rows[0] rows, both columns looking
             into the flagged rows of CtlLookedStark at 2^log_rows[1]),
             proved by plonky2_tpu_torch.stark.multi.prove_all_tables; an
             input is an x0 and a shuffle seed drawn from its seed, the
             traces made by lib/frozen/ctl_traces.py.
"""

from __future__ import annotations

import numpy as np

from portbench.lib.frozen.ctl_traces import ctl_traces
from portbench.lib.frozen.fib_trace import fibonacci_trace
from portbench.reference.field import P

# program functions given a profiler range each in the traced run, so that
# the device's idle gaps can be told apart by what the host was doing
PHASES = [
    ("plonky2_tpu_torch.stark.prover", "compute_quotient_chunks"),
    ("plonky2_tpu_torch.stark.prover", "run_binding_step"),
    ("plonky2_tpu_torch.stark.prover", "_natural_order_values"),
    ("plonky2_tpu_torch.fri.oracle", "eval_commitments_at"),
    ("plonky2_tpu_torch.fri.oracle", "reduce_openings_to_final_poly"),
    ("plonky2_tpu_torch.fri.oracle", "final_poly_lde"),
    ("plonky2_tpu_torch.fri.prover", "_fused_fri_proof"),
    ("plonky2_tpu_torch.stark.multi", "get_ctl_data"),
    ("plonky2_tpu_torch.stark.multi", "prove_with_commitment"),
]


class Case:
    """One configuration under one traffic mix: inputs from seeds, the
    program's proof of an input, and the reference's judgement of it."""

    def __init__(self, config: dict, traffic: dict, device):
        from plonky2_tpu_torch.fri.config import FriConfig, FriReductionStrategy
        from plonky2_tpu_torch.stark.config import StarkConfig
        from plonky2_tpu_torch.stark import cross_table_lookup as ctl
        from plonky2_tpu_torch.stark.fixtures import (
            CtlLookedStark,
            CtlLookingStark,
            FibonacciStark,
        )
        from plonky2_tpu_torch.stark.lookup import Column, Filter

        self.statement = traffic["statement"]
        self.log_rows = traffic["log_rows"]
        if self.statement == "fibonacci":
            self.stark = FibonacciStark(1 << self.log_rows)
        elif self.statement == "ctl":
            self.starks = [CtlLookingStark(1 << self.log_rows[0]),
                           CtlLookedStark(1 << self.log_rows[1])]
            # chip_smoke.py:2870-2878: both columns of table 0 look into
            # the rows of table 1 whose column 1 is set
            self.ctls = [ctl.CrossTableLookup(
                looking_tables=[
                    ctl.TableWithColumns(0, [Column.single(0)], Filter.default()),
                    ctl.TableWithColumns(0, [Column.single(1)], Filter.default()),
                ],
                looked_table=ctl.TableWithColumns(1, [Column.single(0)],
                                                  Filter.new_simple(Column.single(1))),
            )]
        else:
            raise ValueError(f"starky-std-fast has no statement {self.statement!r}")
        if config["zero_knowledge"] or config["reduction_strategy"] != "ConstantArityBits":
            raise ValueError("starky-std-fast states no zero knowledge and constant arity")
        self.config_json = config
        self.device = device
        self.config = StarkConfig(
            security_bits=config["security_bits"],
            num_challenges=config["num_challenges"],
            fri_config=FriConfig(
                rate_bits=config["rate_bits"],
                cap_height=config["cap_height"],
                proof_of_work_bits=config["proof_of_work_bits"],
                reduction_strategy=FriReductionStrategy.ConstantArityBits(
                    config["reduction_arity_bits"], config["final_poly_bits"]),
                num_query_rounds=config["num_query_rounds"],
            ),
        )

    def make_input(self, seed: int) -> dict:
        rng = np.random.default_rng(seed)
        if self.statement == "ctl":
            x0 = int(rng.integers(0, P, dtype=np.uint64))
            return {"traces": ctl_traces(self.log_rows, x0, int(rng.integers(0, 1 << 62)))}
        x0, x1 = (int(v) for v in rng.integers(0, P, size=2, dtype=np.uint64))
        trace, pis = fibonacci_trace(1 << self.log_rows, x0, x1, self.device)
        return {"trace": trace, "public_inputs": pis}

    def prove(self, inp: dict):
        if self.statement == "ctl":
            from plonky2_tpu_torch.stark import multi

            return multi.prove_all_tables(self.starks, self.config, inp["traces"], [[], []],
                                          self.ctls, device=self.device)
        from plonky2_tpu_torch.stark import prover

        return prover.prove(self.stark, self.config, inp["trace"], inp["public_inputs"],
                            device=self.device)

    def reference_proof(self, inp: dict, device, **overrides) -> list:
        """The reference's proofs of an input (one a table), as plain
        forms; overrides change numbers of the configuration (the
        control)."""
        from portbench.reference import field, starky

        params = starky.StarkParams.from_config({**self.config_json, **overrides})
        if self.statement == "ctl":
            return starky.prove_ctl_system(
                params, [field.to_tensor(t, device) for t in inp["traces"]])
        return [starky.prove("fibonacci", params, field.to_tensor(inp["trace"], device),
                             inp["public_inputs"])]

    def check(self, inp: dict, proof, device) -> list:
        """The parts in which the program's proofs differ from the
        reference's proofs of the same input."""
        from portbench.reference import compare

        proofs = proof if isinstance(proof, list) else [proof]
        return compare.differing_tables([compare.program_stark_proof(p) for p in proofs],
                                        self.reference_proof(inp, device))

    def control(self, inp: dict, device) -> list:
        """The control: the reference in the program's place with one
        guarantee of the configuration broken, one query round fewer than
        stated, judged as the program's proofs are."""
        from portbench.reference import compare

        fewer = self.config_json["num_query_rounds"] - 1
        return compare.differing_tables(self.reference_proof(inp, device, num_query_rounds=fewer),
                                        self.reference_proof(inp, device))

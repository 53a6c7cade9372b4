"""The harness end to end on a tiny cell on the CPU: the result line, a
cell and a metric added as files, the guard against JAX, the check against
planted faults, and the control."""

from __future__ import annotations

import json
import sys
import types

import pytest

from portbench.lib import control, guard, harness
from portbench.reference.field import P
from portbench.tests.helpers import PORTBENCH, TINY, TINY_CTL, add_workload, make_tree, run_cell

CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("bench"))


def test_tiny_cell_prints_the_contract_line(tree):
    rc, line, err = run_cell(tree)
    assert rc == 0, err
    assert list(line) == CONTRACT_KEYS  # "checks" last
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"prove_s", "setup_s"}  # peak memory is the card's only
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"] == "s"
    assert line["checks"] == {"proofs_failed": {"value": 0, "limit": 0},
                              "proofs_mismatched": {"value": 0, "limit": 0}}
    assert err.strip().splitlines()[-1] == "proofs_mismatched 0 limit 0"


def test_tiny_ctl_cell_is_correct(tree):
    rc, line, err = run_cell(tree, TINY_CTL)
    assert rc == 0 and line["correct"] is True, err
    assert line["checks"]["proofs_mismatched"] == {"value": 0, "limit": 0}


def test_cell_and_metric_added_as_files(tmp_path):
    root = make_tree(tmp_path)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "traffic" / "fib-r5-pairs.json").write_text(json.dumps({
        "statement": "fibonacci", "log_rows": 5, "distinct_inputs": 3, "sample": 1,
        "description": "2^5 rows"}))
    (root / "cells" / "fib-r5.json").write_text(json.dumps({
        "config": "starky-std-fast", "traffic": "fib-r5-pairs", "chips": 1, "why": "2^5 rows"}))
    (root / "metrics" / "proofs_in_window.py").write_text(
        "UNIT = 'proofs'\n\n\ndef read(run):\n    return len(run.latencies)\n")
    add_workload(tmp_path, {"name": "fib-r5", "config": "starky-std-fast",
                            "traffic": "fib-r5-pairs", "chips": 1, "why": "2^5 rows"},
                 {"name": "proofs_in_window", "unit": "proofs", "better": "higher", "bound": 0.25,
                  "source": "host_clock", "workloads": ["fib-r5"]})
    rc, line, err = run_cell(root, "fib-r5")
    assert rc == 0 and line["correct"], err
    assert line["metrics"]["proofs_in_window"]["value"] == line["attempted"]
    after = {p: p.read_bytes() for p in root.rglob("*") if p.is_file() and p in before}
    assert after == before  # nothing that was there was edited


@pytest.mark.parametrize("planted", ["jax", "jax.numpy", "jaxlib", "flax", "plonky2_tpu",
                                     "plonky2_tpu.plonk.prover"])
def test_guard_refuses_a_run_that_loaded_jax(tree, monkeypatch, planted):
    monkeypatch.setitem(sys.modules, planted, types.ModuleType(planted))
    rc, line, err = run_cell(tree)
    assert rc != 0 and line is None
    assert planted.split(".")[0] in err


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_modules(["plonky2_tpu_torch", "plonky2_tpu_torch.ops", "jaxtyping",
                                    "portbench.lib"]) == []
    assert guard.forbidden_modules(["plonky2_tpu.ops", "jax"]) == ["jax", "plonky2_tpu"]


def _fault(kind):
    """A prover that breaks as named, wrapped around the real one."""
    from plonky2_tpu_torch.stark import prover

    real = prover.prove
    state = {}

    def faulty(*args, **kwargs):
        proof = real(*args, **kwargs)
        if kind == "state_unchanged":  # each call answers with the call before's proof
            stale, state["last"] = state.get("last", proof), proof
            return stale
        fri = proof.proof.opening_proof
        if kind == "half_left_out":  # half of the query rounds dropped
            fri.query_round_proofs = fri.query_round_proofs[: len(fri.query_round_proofs) // 2]
        elif kind == "answer_altered":  # one word of the final polynomial
            c0, c1 = fri.final_poly[0]
            fri.final_poly[0] = ((c0 + 1) % P, c1)
        return proof

    return prover, faulty


@pytest.mark.parametrize("kind", ["state_unchanged", "half_left_out", "answer_altered"])
def test_check_catches_a_broken_timed_path(tree, monkeypatch, kind):
    prover, faulty = _fault(kind)
    monkeypatch.setattr(prover, "prove", faulty)
    seconds = 15 if kind == "state_unchanged" else 0.5  # a second proof, for a stale answer
    rc, line, err = run_cell(tree, seconds=seconds)
    assert rc == 0, err
    assert line["correct"] is False and line["checks"]["proofs_mismatched"]["value"] >= 1


@pytest.mark.parametrize("cell", [TINY, TINY_CTL])
def test_control_fails_the_check_on_three_seeds(tree, cell):
    readings = list(control.control_readings(cell, [1, 2**31 + 5, 2**33 + 7], "cpu", root=tree))
    assert [r["proofs_mismatched"] for r in readings] == [1, 1, 1]


def test_benchmark_json_names_files_that_exist():
    bench = json.loads((PORTBENCH.parent / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = json.loads((PORTBENCH / "cells" / f"{w['name']}.json").read_text())
        assert {k: cell[k] for k in ("config", "traffic", "chips", "why")} == \
            {k: w[k] for k in ("config", "traffic", "chips", "why")}
        assert (PORTBENCH / "traffic" / f"{w['traffic']}.json").exists()
    for c in bench["configs"]:
        assert (PORTBENCH.parent / c["file"]).exists()
        assert (PORTBENCH / "configs" / f"{c['name']}.py").exists()
    for m in bench["end_to_end"] + bench["per_layer"]:
        reader = harness.load_module(PORTBENCH / "metrics" / f"{m['name']}.py", m["name"])
        assert reader.UNIT == m["unit"]
    for path in (PORTBENCH / "metrics").glob("*.py"):  # readers waiting for their cells too
        reader = harness.load_module(path, path.stem)
        assert reader.UNIT and callable(reader.read)


def test_config_file_states_the_programs_standard_fast_config():
    from plonky2_tpu_torch.stark.config import StarkConfig

    cfg = json.loads((PORTBENCH / "configs" / "starky-std-fast.json").read_text())
    std = StarkConfig.standard_fast_config()
    fri = std.fri_config
    assert (cfg["security_bits"], cfg["num_challenges"]) == (std.security_bits, std.num_challenges)
    assert (cfg["rate_bits"], cfg["cap_height"], cfg["proof_of_work_bits"],
            cfg["num_query_rounds"]) == (fri.rate_bits, fri.cap_height, fri.proof_of_work_bits,
                                         fri.num_query_rounds)
    assert (cfg["reduction_arity_bits"], cfg["final_poly_bits"]) == (
        fri.reduction_strategy.arity_bits, fri.reduction_strategy.final_poly_bits)

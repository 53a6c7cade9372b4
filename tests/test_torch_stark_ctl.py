"""Cross-table lookups in the port (plonky2_tpu_torch.stark.cross_table_lookup
and stark/multi.py) on the CPU, with the kernels' plain versions, held
against the JAX package on the same numpy inputs: partial_sums (the CTL
helper and Z columns of the port's device code on CPU tensors),
cross_table_lookup_data of the two-table system of tests/test_stark_ctl.py,
the entry layout, check_ctls, and the system's two proofs against their pin
(tools/gen_starky_pins.py; the reference's prove is not run here), each
package's verifier on the other's proofs; a corrupted looked table and
tampered Z(1) openings rejected. Tolerance: none — integer equality."""

import copy
import dataclasses
import json
import os

import numpy as np
import pytest

from plonky2_tpu.fri import config as jfri_config
from plonky2_tpu.fri import proof as jfri_proof
from plonky2_tpu.stark import config as jstark_config
from plonky2_tpu.stark import cross_table_lookup as jctl
from plonky2_tpu.stark import fixtures as jfix
from plonky2_tpu.stark import lookup as jlookup
from plonky2_tpu.stark import proof as jstark_proof
from plonky2_tpu.stark.multi import verify_all_tables as jverify_all
from _torch_port import lazy_module

tctl = lazy_module("plonky2_tpu_torch.stark.cross_table_lookup")
tlookup = lazy_module("plonky2_tpu_torch.stark.lookup")
tfix = lazy_module("plonky2_tpu_torch.stark.fixtures")
tconfig = lazy_module("plonky2_tpu_torch.stark.config")
tfri_config = lazy_module("plonky2_tpu_torch.fri.config")
tmulti = lazy_module("plonky2_tpu_torch.stark.multi")
tgf = lazy_module("plonky2_tpu_torch.ops.gf")
fr = lazy_module("plonky2_tpu_torch.utils.from_reference")
ser = lazy_module("plonky2_tpu_torch.utils.serialization")

P = 0xFFFF_FFFF_0000_0001
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
# the system of tools/gen_starky_pins.py (tests/test_stark_ctl.py:21-41)
CTL_LOG_ROWS = [5, 7]
CTL_X0 = 100
CTL_SHUFFLE_SEED = 0


def ctl_system(fixtures, lookup, ctl, log_rows=CTL_LOG_ROWS):
    """Both value columns of table 0 look into the flagged rows of table 1,
    over either package's modules: (starks, traces, cross-table lookups)."""
    stark_a = fixtures.CtlLookingStark(1 << log_rows[0])
    stark_b = fixtures.CtlLookedStark(1 << log_rows[1])
    trace_a = stark_a.generate_trace(CTL_X0)
    values = [int(v) for v in trace_a[0]] + [int(v) for v in trace_a[1]]
    rng = np.random.default_rng(CTL_SHUFFLE_SEED)
    values = [values[i] for i in rng.permutation(len(values))]
    trace_b = stark_b.generate_trace(values)
    ctls = [
        ctl.CrossTableLookup(
            looking_tables=[
                ctl.TableWithColumns(0, [lookup.Column.single(0)], lookup.Filter.default()),
                ctl.TableWithColumns(0, [lookup.Column.single(1)], lookup.Filter.default()),
            ],
            looked_table=ctl.TableWithColumns(
                1, [lookup.Column.single(0)], lookup.Filter.new_simple(lookup.Column.single(1))
            ),
        )
    ]
    return [stark_a, stark_b], [trace_a, trace_b], ctls


def cheap_config(stark_config, fri_config):
    """tests/test_stark_zk.py:20-31: one PoW bit and 8 queries, for the
    proofs that are made only to be rejected."""
    return stark_config.StarkConfig(
        security_bits=1,
        num_challenges=2,
        fri_config=fri_config.FriConfig(
            rate_bits=1,
            cap_height=1,
            proof_of_work_bits=1,
            reduction_strategy=fri_config.FriReductionStrategy.ConstantArityBits(1, 2),
            num_query_rounds=8,
        ),
    )


def _cpu(trace):
    return tgf.from_u64(np.asarray(trace, dtype=np.uint64), "cpu")


def _jax_classes():
    classes = {}
    for module in (jstark_proof, jfri_proof, jstark_config, jfri_config):
        for name, obj in vars(module).items():
            if dataclasses.is_dataclass(obj) and isinstance(obj, type):
                classes[name] = obj
    return classes


def _port_system(log_rows=CTL_LOG_ROWS):
    return ctl_system(tfix, tlookup, tctl, log_rows)


def _ref_system(log_rows=CTL_LOG_ROWS):
    return ctl_system(jfix, jlookup, jctl, log_rows)


# ---------------------------------------------------------------------------
# partial_sums and the CTL data, on CPU tensors, against the reference
# ---------------------------------------------------------------------------


def _column_sets(mod, num_sets):
    C, F = mod.Column, mod.Filter
    sets = [
        ([C.single(0), C.single(1)], F.default()),
        ([C.single(2), C.linear_combination_with_constant([(0, 5)], 3)], F.new_simple(C.single(3))),
        ([C.single_next_row(1), C.constant_col(7)], F(products=[(C.single(3), C.single(3))])),
    ]
    return sets[:num_sets]


@pytest.mark.parametrize("log_rows", [4, 8])
@pytest.mark.parametrize("num_sets", [1, 2, 3])
@pytest.mark.parametrize("constraint_degree", [3, 4])
def test_partial_sums_vs_reference(log_rows, num_sets, constraint_degree):
    """The helper columns and the inclusive suffix-sum Z (total on row 0;
    no helper for a single column set) equal the JAX package's."""
    rng = np.random.default_rng(100 * log_rows + 10 * num_sets + constraint_degree)
    trace = rng.integers(0, P, size=(4, 1 << log_rows), dtype=np.uint64)
    trace[3] = rng.integers(0, 2, size=1 << log_rows, dtype=np.uint64)
    beta, gamma = (int(v) for v in rng.integers(0, P, size=2, dtype=np.uint64))
    want = jctl.partial_sums(trace, _column_sets(jlookup, num_sets),
                             jlookup.GrandProductChallenge(beta, gamma), constraint_degree)
    got = tctl.partial_sums(_cpu(trace), _column_sets(tlookup, num_sets),
                            tlookup.GrandProductChallenge(beta, gamma), constraint_degree)
    assert len(got) == len(want)
    assert len(got) == (1 if num_sets == 1 else -(-num_sets // (constraint_degree - 1)) + 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(tgf.to_u64(g), w)


def test_cross_table_lookup_data_vs_reference():
    """The system's CTL data, table by table and column by column."""
    _, traces, ctls = _ref_system()
    _, _, tctls = _port_system()
    challenges = [(12345, 678910), (P - 3, 5)]
    want = jctl.cross_table_lookup_data(
        traces, ctls,
        jlookup.GrandProductChallengeSet([jlookup.GrandProductChallenge(*c) for c in challenges]), 3)
    got = tctl.cross_table_lookup_data(
        [_cpu(t) for t in traces], tctls,
        tlookup.GrandProductChallengeSet([tlookup.GrandProductChallenge(*c) for c in challenges]), 3)
    assert [len(d.zs_columns) for d in got] == [len(d.zs_columns) for d in want] == [2, 2]
    for g, w in zip(got, want):
        assert g.num_ctl_helper_polys() == w.num_ctl_helper_polys()
        for gp, wp in zip(tctl.get_ctl_auxiliary_polys(g), jctl.get_ctl_auxiliary_polys(w)):
            np.testing.assert_array_equal(tgf.to_u64(gp), wp)


@pytest.mark.parametrize("table", [0, 1])
@pytest.mark.parametrize("constraint_degree", [3, 4])
def test_ctl_entries_vs_reference(table, constraint_degree):
    _, _, ctls = _ref_system()
    _, _, tctls = _port_system()
    want = jctl.ctl_zs_entries(table, ctls, 2, constraint_degree)
    got = tctl.ctl_zs_entries(table, tctls, 2, constraint_degree)
    assert fr.to_plain(got) == fr.to_plain(want)
    assert (tctl.CrossTableLookup.num_ctl_helpers_zs_all(tctls, table, 2, constraint_degree)
            == jctl.CrossTableLookup.num_ctl_helpers_zs_all(ctls, table, 2, constraint_degree))


@pytest.mark.parametrize("corrupt", [None, "looking", "looked", "filter"])
def test_check_ctls_agrees_with_reference(corrupt):
    _, traces, ctls = _ref_system()
    _, _, tctls = _port_system()
    traces = [t.copy() for t in traces]
    if corrupt == "looking":
        traces[0][0, 3] = (int(traces[0][0, 3]) + 1) % P
    elif corrupt == "looked":
        traces[1][0, 2] = (int(traces[1][0, 2]) + 1) % P
    elif corrupt == "filter":
        traces[1][1, 5] = 0
    outcomes = []
    for check, err, t in ((jctl.check_ctls, jctl.CtlVerificationError, traces),
                          (tctl.check_ctls, tctl.CtlVerificationError, [_cpu(x) for x in traces])):
        try:
            check(t, ctls if check is jctl.check_ctls else tctls)
            outcomes.append("ok")
        except err:
            outcomes.append("rejected")
    assert outcomes == ["ok", "ok"] if corrupt is None else outcomes == ["rejected", "rejected"]


def test_ctls_cross_by_name():
    _, _, ctls = _ref_system()
    _, _, tctls = _port_system()
    assert fr.from_plain(fr.to_plain(ctls)) == tctls


# ---------------------------------------------------------------------------
# The two-table system's proofs against their pin, both verifiers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def proofs():
    """The port's proofs of the system on the CPU, and the JAX package's
    pinned proofs of the same traces."""
    name = f"torch_starky_ctl_{CTL_LOG_ROWS[0]}_{CTL_LOG_ROWS[1]}.json"
    with open(os.path.join(GOLDEN, name)) as f:
        pin = json.load(f)
    starks, traces, ctls = _port_system()
    config = tconfig.StarkConfig.standard_fast_config()
    tproofs = tmulti.prove_all_tables(starks, config, traces, [[], []], ctls, device="cpu")
    return starks, config, ctls, tproofs, pin["proofs"]


def test_ctl_proofs_equal_pin(proofs):
    *_, tproofs, pin = proofs
    assert [ser.int_tree(p) for p in tproofs] == pin


def test_port_verifies_pinned_reference_proofs(proofs):
    starks, config, ctls, _, pin = proofs
    pwps = [ser.stark_proof_from_int_tree(t) for t in pin]
    assert [ser.int_tree(p) for p in pwps] == pin
    tmulti.verify_all_tables(starks, config, pwps, ctls, CTL_LOG_ROWS)


def test_reference_verifies_port_proofs(proofs):
    *_, tproofs, _ = proofs
    jstarks, _, jctls = _ref_system()
    jproofs = [fr.from_plain(fr.to_plain(p), _jax_classes()) for p in tproofs]
    jverify_all(jstarks, jstark_config.StarkConfig.standard_fast_config(), jproofs, jctls,
                CTL_LOG_ROWS)


@pytest.mark.parametrize("table", [0, 1])
def test_tampered_ctl_zs_first_rejected(proofs, table):
    starks, config, ctls, tproofs, _ = proofs
    bad = copy.deepcopy(tproofs)
    zs = bad[table].proof.openings.ctl_zs_first
    zs[0] = (zs[0] + 1) % P
    with pytest.raises(Exception):
        tmulti.verify_all_tables(starks, config, bad, ctls, CTL_LOG_ROWS)


def test_corrupted_looked_table_rejected():
    """tests/test_stark_ctl.py::test_ctl_broken_rejected, under one PoW bit:
    the looked table's row 2 changed; the system proves and fails
    verification."""
    starks, traces, ctls = _port_system()
    traces[1][0, 2] = (int(traces[1][0, 2]) + 1) % P
    config = cheap_config(tconfig, tfri_config)
    pwps = tmulti.prove_all_tables(starks, config, traces, [[], []], ctls, device="cpu")
    with pytest.raises(tctl.CtlVerificationError):
        tmulti.verify_all_tables(starks, config, pwps, ctls, CTL_LOG_ROWS)

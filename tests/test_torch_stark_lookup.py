"""logUp lookups in the port (plonky2_tpu_torch.stark.lookup, the lookup
branches of stark/prover.py and stark/verifier.py, the new fixtures) on the
CPU, with the kernels' plain versions, held against the JAX package
(plonky2_tpu.stark.lookup and its host numpy helper columns) on the same
numpy inputs: Column/Filter evaluations, the helper and Z columns at
2^4-2^10 rows with chunk sizes 1, 2 and 3, the scans, eval_helper_columns
for m = 1, 2, 3, the vectorized fixture traces, and the PermutationStark
proof of tests/test_stark_lookup.py against its pin
(tools/gen_starky_pins.py; the reference's prove is not run here), each
package's verifier on the other's proof. Tolerance: none — integer
equality."""

import copy
import dataclasses
import json
import os

import numpy as np
import pytest

from plonky2_tpu.fri import config as jfri_config
from plonky2_tpu.fri import proof as jfri_proof
from plonky2_tpu.stark import config as jstark_config
from plonky2_tpu.stark import fixtures as jfix
from plonky2_tpu.stark import lookup as jlookup
from plonky2_tpu.stark import proof as jstark_proof
from plonky2_tpu.stark.verifier import verify_stark_proof as jverify
from _torch_port import lazy_module

tlookup = lazy_module("plonky2_tpu_torch.stark.lookup")
tfix = lazy_module("plonky2_tpu_torch.stark.fixtures")
tconfig = lazy_module("plonky2_tpu_torch.stark.config")
tprover = lazy_module("plonky2_tpu_torch.stark.prover")
tverifier = lazy_module("plonky2_tpu_torch.stark.verifier")
tfri_config = lazy_module("plonky2_tpu_torch.fri.config")
tgf = lazy_module("plonky2_tpu_torch.ops.gf")
fr = lazy_module("plonky2_tpu_torch.utils.from_reference")
ser = lazy_module("plonky2_tpu_torch.utils.serialization")

P = 0xFFFF_FFFF_0000_0001
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
LOG_ROWS = 5
X0 = 3


def _cpu(trace):
    return tgf.from_u64(np.asarray(trace, dtype=np.uint64), "cpu")


def _u64(t):
    return tgf.to_u64(t)


def _jax_classes():
    classes = {}
    for module in (jstark_proof, jfri_proof, jstark_config, jfri_config):
        for name, obj in vars(module).items():
            if dataclasses.is_dataclass(obj) and isinstance(obj, type):
                classes[name] = obj
    return classes


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


# ---------------------------------------------------------------------------
# Column / Filter
# ---------------------------------------------------------------------------


def _columns(mod):
    C = mod.Column
    return [
        C.single(0),
        C.single_next_row(2),
        C.constant_col(P + 5),
        C.linear_combination_with_constant([(0, 3), (1, P - 1), (3, 1 << 40)], 17),
        C(linear_combination=[(1, 2)], next_row_linear_combination=[(0, 5), (3, 1)], constant=9),
        C(),
    ]


def _filters(mod):
    C, F = mod.Column, mod.Filter
    return [
        F.default(),
        F.new_simple(C.single(3)),
        F(products=[(C.single(0), C.single_next_row(1)), (C.single(2), C.constant_col(4))],
          constants=[C.single(1), C.constant_col(P - 1)]),
    ]


def _random_trace(rng, cols, rows):
    return rng.integers(0, P, size=(cols, rows), dtype=np.uint64)


@pytest.mark.parametrize("case", range(6))
def test_column_eval_all_rows_vs_reference(case):
    trace = _random_trace(np.random.default_rng(case), 4, 1 << 6)
    got = _u64(_columns(tlookup)[case].eval_all_rows(_cpu(trace)))
    np.testing.assert_array_equal(got, _columns(jlookup)[case].eval_all_rows(trace))


@pytest.mark.parametrize("case", range(3))
def test_filter_eval_all_rows_vs_reference(case):
    trace = _random_trace(np.random.default_rng(10 + case), 4, 1 << 6)
    got = _u64(_filters(tlookup)[case].eval_all_rows(_cpu(trace)))
    np.testing.assert_array_equal(got, _filters(jlookup)[case].eval_all_rows(trace))


# ---------------------------------------------------------------------------
# Helper and Z columns, on CPU tensors, against the reference's host numpy
# ---------------------------------------------------------------------------


def _lookup(mod, num_looking):
    C, F = mod.Column, mod.Filter
    filters = [F.default(), F.new_simple(C.single(5)), F(products=[(C.single(5), C.single(5))])]
    return mod.Lookup(
        columns=[C.single(i) if i % 2 == 0 else C.linear_combination_with_constant([(i, 3)], 1)
                 for i in range(num_looking)],
        table_column=C.single(4),
        frequencies_column=C.single(6),
        filter_columns=[filters[i % 3] for i in range(num_looking)],
    )


@pytest.mark.parametrize("log_rows", [4, 7, 10])
@pytest.mark.parametrize("constraint_degree", [0, 3, 4], ids=["chunk1", "chunk2", "chunk3"])
def test_helper_and_z_columns_vs_reference(log_rows, constraint_degree):
    """Five looking columns, mixed filters: every helper column and Z of
    the port's device code on CPU tensors equals lookup_helper_columns of
    the JAX package (chunk sizes 1, 2, 3: constraint degrees 0, 3, 4)."""
    rng = np.random.default_rng(log_rows * 10 + constraint_degree)
    trace = _random_trace(rng, 7, 1 << log_rows)
    trace[5] = rng.integers(0, 2, size=1 << log_rows, dtype=np.uint64)
    challenge = int(rng.integers(0, P, dtype=np.uint64))
    want = jlookup.lookup_helper_columns(_lookup(jlookup, 5), trace, challenge, constraint_degree)
    got = tlookup.lookup_helper_columns(_lookup(tlookup, 5), _cpu(trace), challenge,
                                        constraint_degree)
    assert len(got) == len(want) == _lookup(tlookup, 5).num_helper_columns(constraint_degree)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_u64(g), w)


def test_all_lookup_helper_columns_order_vs_reference():
    """PermutationStark, two challenges: per challenge the helper then Z,
    in the reference's order."""
    n = 1 << 6
    trace = jfix.PermutationStark(n).generate_trace(11)
    challenges = [123456789, P - 5]
    want = jlookup.all_lookup_helper_columns(jfix.PermutationStark(n), trace, challenges)
    got = tlookup.all_lookup_helper_columns(tfix.PermutationStark(n), _cpu(trace), challenges)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_u64(g), w)


def test_helper_columns_sum_to_zero():
    """Σ_rows (Σ h_k − m·g) vanishes for a true permutation, so Z wraps to
    0 (the logUp identity; lookup.rs:636-648)."""
    stark = tfix.PermutationStark(1 << 4)
    trace = stark.generate_trace(7)
    lookup = stark.lookups()[0]
    h, z = tlookup.lookup_helper_columns(lookup, _cpu(trace), 0x1234567, stark.constraint_degree())
    assert lookup.num_helper_columns(stark.constraint_degree()) == 2
    z, h = [int(v) for v in _u64(z)], [int(v) for v in _u64(h)]
    inv = [pow((int(t) + 0x1234567) % P, P - 2, P) for t in trace[1]]
    assert z[0] == 0
    assert (z[-1] + h[-1] - inv[-1]) % P == 0


@pytest.mark.parametrize("log_n", [0, 1, 5, 11])
def test_scans_vs_reference(log_n):
    """The exclusive prefix scan against the reference's object-dtype
    cumsum; the inclusive suffix scan against a plain loop."""
    x = np.random.default_rng(log_n).integers(0, P, size=(1 << log_n), dtype=np.uint64)
    np.testing.assert_array_equal(
        _u64(tlookup.prefix_sum_exclusive(_cpu(x))), jlookup._np_modular_cumsum_exclusive(x.copy())
    )
    want, acc = [], 0
    for v in x[::-1]:
        acc = (acc + int(v)) % P
        want.append(acc)
    assert [int(v) for v in _u64(tlookup.suffix_sum_inclusive(_cpu(x)))] == want[::-1]


def test_chunk_size_of_degree_zero():
    """PermutationStark has constraint degree 0: one column a chunk."""
    chunk_size = tlookup.load()._chunk_size
    assert chunk_size(0) == jlookup._chunk_size(0) == 1
    assert [chunk_size(d) for d in (2, 3, 4)] == [1, 2, 3]
    with pytest.raises(AssertionError):
        chunk_size(1)


# ---------------------------------------------------------------------------
# eval_helper_columns for m = 1, 2, 3
# ---------------------------------------------------------------------------


class IntAlgebra:
    def zero(self):
        return 0

    def one(self):
        return 1

    def add(self, a, b):
        return (a + b) % P

    def sub(self, a, b):
        return (a - b) % P

    def mul(self, a, b):
        return (a * b) % P

    def const(self, c):
        return c % P

    def mul_const(self, a, c):
        return (a * c) % P


class Consumer:
    def __init__(self):
        self.constraints = []

    def constraint(self, c):
        self.constraints.append(c)


@pytest.mark.parametrize("m", [1, 2, 3])
def test_eval_helper_columns_vs_reference(m):
    """One chunk of m looked columns (constraint degree m + 1): the true
    helper value gives constraint 0, a corrupted one not, and the port's
    constraints equal the JAX package's on both."""
    A = IntAlgebra()
    local = [5, 11, 23, 1, 1, 1]
    nxt = list(local)
    degree = m + 1

    def run(mod, h):
        chal = mod.GrandProductChallenge(beta=7, gamma=13)
        cols = [[mod.Column.single(i).eval_with_next(local, nxt, A)] for i in range(m)]
        filters = [mod.Filter.new_simple(mod.Column.single(3 + i)) for i in range(m)]
        consumer = Consumer()
        mod.eval_helper_columns(filters, cols, local, nxt, [h], degree, chal, consumer, A)
        return consumer.constraints

    h = sum(pow((local[i] + 13) % P, P - 2, P) for i in range(m)) % P
    assert run(tlookup, h) == run(jlookup, h) == [0]
    bad = run(tlookup, (h + 1) % P)
    assert bad == run(jlookup, (h + 1) % P) and bad[0] != 0


# ---------------------------------------------------------------------------
# The vectorized fixture traces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("log_rows", [1, 5, 10])
def test_permutation_trace_equals_reference(log_rows):
    n = 1 << log_rows
    for x0 in (0, 3, P - 2):
        np.testing.assert_array_equal(
            tfix.PermutationStark(n).generate_trace(x0), jfix.PermutationStark(n).generate_trace(x0)
        )


def test_other_fixture_traces_equal_reference():
    n = 1 << 7
    np.testing.assert_array_equal(
        tfix.UnconstrainedStark(n).generate_trace(7), jfix.UnconstrainedStark(n).generate_trace(7)
    )
    for x0 in (100, P - 70):
        np.testing.assert_array_equal(
            tfix.CtlLookingStark(n).generate_trace(x0), jfix.CtlLookingStark(n).generate_trace(x0)
        )
    values = [5, P + 3, P - 1, 0, (1 << 64) + 9]
    want = jfix.CtlLookedStark(n).generate_trace(values)
    np.testing.assert_array_equal(tfix.CtlLookedStark(n).generate_trace(values), want)
    arr = np.array([v % P for v in values], dtype=np.uint64)
    np.testing.assert_array_equal(tfix.CtlLookedStark(n).generate_trace(arr), want)


# ---------------------------------------------------------------------------
# The PermutationStark proof against its pin, both verifiers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def proofs():
    """The port's 2^5-row PermutationStark proof on the CPU and the JAX
    package's pinned proof of the same trace."""
    with open(os.path.join(GOLDEN, f"torch_starky_lookup_2^{LOG_ROWS}.json")) as f:
        pin = json.load(f)
    stark = tfix.PermutationStark(1 << LOG_ROWS)
    config = tconfig.StarkConfig.standard_fast_config()
    tproof = tprover.prove(stark, config, stark.generate_trace(X0), [X0], device="cpu")
    return stark, config, tproof, pin["proof"]


def test_lookup_proof_equals_pin(proofs):
    _, _, tproof, pin = proofs
    assert ser.int_tree(tproof) == pin


def test_port_verifies_pinned_reference_proof(proofs):
    stark, config, _, pin = proofs
    pwp = ser.stark_proof_from_int_tree(pin)
    assert ser.int_tree(pwp) == pin
    tverifier.verify_stark_proof(stark, pwp, config, LOG_ROWS)


def test_reference_verifies_port_proof(proofs):
    _, _, tproof, _ = proofs
    jproof = fr.from_plain(fr.to_plain(tproof), _jax_classes())
    jverify(jfix.PermutationStark(1 << LOG_ROWS), jproof,
            jstark_config.StarkConfig.standard_fast_config(), LOG_ROWS)


@pytest.mark.parametrize("where", ["aux_zeta", "aux_next", "aux_cap"])
def test_tampered_aux_rejected(proofs, where):
    stark, config, tproof, _ = proofs
    bad = copy.deepcopy(tproof)
    o = bad.proof.openings
    if where == "aux_zeta":
        o.auxiliary_polys[1] = ((o.auxiliary_polys[1][0] + 1) % P, o.auxiliary_polys[1][1])
    elif where == "aux_next":
        o.auxiliary_polys_next[0] = (o.auxiliary_polys_next[0][0] ^ 1, o.auxiliary_polys_next[0][1])
    else:
        bad.proof.auxiliary_polys_cap[0, 0] ^= np.uint64(1)
    with pytest.raises(Exception):
        tverifier.verify_stark_proof(stark, bad, config, LOG_ROWS)


def test_broken_permutation_rejected():
    """tests/test_stark_lookup.py::test_permutation_stark_broken_rejected,
    under one PoW bit: a trace whose column 1 is no permutation of column 0
    proves, and the proof fails the quotient identity."""
    stark = tfix.PermutationStark(1 << LOG_ROWS)
    config = cheap_config(tconfig, tfri_config)
    trace = stark.generate_trace(X0)
    trace[1, 4] = (int(trace[1, 4]) + 1) % P
    pwp = tprover.prove(stark, config, trace, [X0], device="cpu")
    with pytest.raises(tverifier.StarkVerificationError):
        tverifier.verify_stark_proof(stark, pwp, config, LOG_ROWS)


def test_lookup_objects_cross_by_name():
    lk = _lookup(jlookup, 3)
    assert fr.from_plain(fr.to_plain(lk)) == _lookup(tlookup, 3)
    assert fr.from_plain(fr.to_plain(_lookup(tlookup, 3)), {
        "Column": jlookup.Column, "Filter": jlookup.Filter, "Lookup": jlookup.Lookup}) == lk
    for cls in ("FibonacciStark", "PermutationStark", "UnconstrainedStark",
                "CtlLookingStark", "CtlLookedStark"):
        got = fr.from_plain(fr.to_plain(getattr(jfix, cls)(1 << 4)))
        assert type(got) is getattr(tfix, cls) and got.num_rows == 1 << 4

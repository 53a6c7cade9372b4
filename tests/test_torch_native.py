"""The port's native host engines (plonky2_tpu_torch/native, iop/
witgen_native.py) against the pure-Python paths (mirror of
tests/test_native.py and tests/test_native_witgen.py).

The C Poseidon is held to the JAX package's pure-Python permutation; the
native witness fixpoint to the port's Python fixpoint, bit for bit, on
fibonacci, the gadget soup and the lookup circuit, with no generator left
to Python. Tolerance: none."""

import os

import numpy as np
import pytest

from _torch_port import lazy_module

tnative = lazy_module("plonky2_tpu_torch.native")
wn = lazy_module("plonky2_tpu_torch.iop.witgen_native")
tgen = lazy_module("plonky2_tpu_torch.iop.generator")
thp = lazy_module("plonky2_tpu_torch.hash.poseidon")
twitness = lazy_module("plonky2_tpu_torch.iop.witness")
ttarget = lazy_module("plonky2_tpu_torch.iop.target")
tbuilder = lazy_module("plonky2_tpu_torch.plonk.circuit_builder")
tconfig = lazy_module("plonky2_tpu_torch.plonk.config")
tfib = lazy_module("plonky2_tpu_torch.models.fibonacci")


class _env:
    """Set (or clear, value None) an environment variable for a block."""

    def __init__(self, name, value):
        self.name, self.value = name, value

    def __enter__(self):
        self.old = os.environ.get(self.name)
        if self.value is None:
            os.environ.pop(self.name, None)
        else:
            os.environ[self.name] = self.value

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop(self.name, None)
        else:
            os.environ[self.name] = self.old


def test_engines_build_under_the_package_build_dir():
    assert tnative.available() and wn.available()
    build = tnative.BUILD_DIR
    assert build.name == "_build" and build.parent.name == "plonky2_tpu_torch"
    assert wn.load()._so_path().parent == build


@pytest.mark.parametrize("seed", range(4))
def test_c_poseidon_equals_reference_python(seed):
    from plonky2_tpu.hash import poseidon as jhp

    rng = np.random.default_rng(seed)
    s = [int(x) for x in rng.integers(0, 1 << 64, size=12, dtype=np.uint64)]
    got = tnative.poseidon_permute(s)
    assert thp.permute(s) == got  # the dispatch
    with _env("PLONKY2_TPU_NATIVE", "0"):
        assert jhp.permute(s) == got
        assert thp.permute(s) == got  # the port's own Python body


def test_c_poseidon_edge_states():
    from plonky2_tpu.hash import poseidon as jhp

    from plonky2_tpu.field.goldilocks import P

    for s in ([0] * 12, [P - 1] * 12, [(1 << 64) - 1] * 12, list(range(12))):
        with _env("PLONKY2_TPU_NATIVE", "0"):
            want = jhp.permute(s)
        assert tnative.poseidon_permute(s) == want


def test_c_poseidon_batch():
    from plonky2_tpu.hash import poseidon as jhp

    rng = np.random.default_rng(0)
    states = rng.integers(0, (1 << 63), size=(5, 12), dtype=np.uint64)
    out = tnative.poseidon_permute_batch(states.copy())
    with _env("PLONKY2_TPU_NATIVE", "0"):
        for row_in, row_out in zip(states, out):
            assert list(map(int, row_out)) == jhp.permute(list(map(int, row_in)))


def test_c_keccak_matches_reference_python():
    from plonky2_tpu.hash import keccak as jhk

    for data in (b"", b"a", b"x" * 135, b"y" * 136, b"z" * 999):
        with _env("PLONKY2_TPU_NATIVE", "0"):
            want = jhk.keccak256(data)
        assert tnative.keccak256(data) == want


def _both_witnesses(data, pw):
    """(python witness, native witness) for the same inputs."""
    with _env("PLONKY2_TPU_NATIVE_WITGEN", "0"):
        w_py = tgen.generate_partial_witness(pw, data.prover_only, data.common)
    with _env("PLONKY2_TPU_NATIVE_WITGEN", "1"):
        w_nat = wn.generate_partial_witness_native(pw, data.prover_only, data.common)
    assert w_nat is not None
    return w_py, w_nat


def _assert_bit_equal(w_py, w_nat):
    assert np.array_equal(w_py.values_snapshot(), w_nat.values_snapshot())
    py_set = np.fromiter((v is not None for v in w_py.values), bool, count=len(w_py.values))
    assert np.array_equal(py_set, w_nat.flags.astype(bool))
    assert np.array_equal(w_py.full_witness().wire_values, w_nat.full_witness().wire_values)


def _fully_native(data):
    stats = data.prover_only._witgen_enc.stats
    assert stats["python_gens"] == 0, stats["fallback_types"]


def test_fibonacci_bit_equal():
    data, pw = tfib.build_fibonacci(public_io=True, device="cpu")
    _assert_bit_equal(*_both_witnesses(data, pw))
    _fully_native(data)


def _gadget_soup(pkg):
    """One circuit through every hand encoder and the pooled tracer
    (tests/test_native_witgen.py:68-117), built with the front end of
    ``pkg``, a package root name."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    ExtensionTarget = mod("iop.target").ExtensionTarget
    b = mod("plonk.circuit_builder").CircuitBuilder(
        mod("plonk.config").CircuitConfig.standard_recursion_config()
    )
    x = b.add_virtual_target()
    y = b.add_virtual_target()
    b.register_public_input(b.mul(b.add(x, y), b.sub(x, y)))
    b.register_public_input(b.inverse(x))
    eq = b.is_equal(x, y)
    b.register_public_input(eq.target)
    b.split_le(x, 40)
    lst = [b.add_virtual_target() for _ in range(8)]
    idx = b.add_virtual_target()
    b.register_public_input(b.random_access(idx, lst))
    b.register_public_input(b.exp(x, idx, 3))
    b.register_public_input(b.exp_u64(y, 0x12345))
    sel = b.select(eq, x, y)
    b.register_public_input(sel)
    for t in b.hash_n_to_hash_no_pad([x, y, sel, lst[0], lst[7]]):
        b.register_public_input(t)
    ex = ExtensionTarget((x, y))
    for t in b.inverse_extension(ex).parts:
        b.register_public_input(t)
    gate = mod("gates.interpolation").CosetInterpolationGate(2, 6)
    vals = [ExtensionTarget((lst[2 * i], lst[2 * i + 1])) for i in range(4)]
    for t in b.interpolate_coset(gate, b.one(), vals, ex).parts:
        b.register_public_input(t)
    data = b.build(commit=False)
    pw = mod("iop.witness").PartialWitness()
    pw.set_target(x, 123456789)
    pw.set_target(y, 987654321)
    pw.set_target(idx, 5)
    for i, t in enumerate(lst):
        pw.set_target(t, 1000 + i)
    return data, pw


def test_gadget_soup_bit_equal():
    data, pw = _gadget_soup("plonky2_tpu_torch")
    _assert_bit_equal(*_both_witnesses(data, pw))
    _fully_native(data)


def test_gadget_soup_witness_equals_reference():
    """The port's native witness equals the JAX package's on the same
    circuit, built by both front ends."""
    from plonky2_tpu.iop.generator import generate_partial_witness as jgen

    data, pw = _gadget_soup("plonky2_tpu_torch")
    jdata, jpw = _gadget_soup("plonky2_tpu")
    with _env("PLONKY2_TPU_NATIVE_WITGEN", "0"):
        jw = jgen(jpw, jdata.prover_only, jdata.common)
    w = tgen.generate_partial_witness(pw, data.prover_only, data.common)
    assert np.array_equal(w.full_witness().wire_values, jw.full_witness().wire_values)


def test_lookup_circuit_bit_equal():
    table = [2, 24, 56, 100, 128, 16, 20, 49]
    b = tbuilder.CircuitBuilder(tconfig.CircuitConfig.standard_recursion_config())
    lut_index = b.add_lookup_table_from_table(list(range(len(table))), table)
    in_ts = [b.add_virtual_target() for _ in range(5)]
    for t in in_ts:
        b.register_public_input(b.add_lookup_from_index(t, lut_index))
    data = b.build(commit=False)
    pw = twitness.PartialWitness()
    for t, v in zip(in_ts, [0, 3, 3, 7, 1]):
        pw.set_target(t, v)
    _assert_bit_equal(*_both_witnesses(data, pw))
    _fully_native(data)


def test_conflict_detection():
    """A contradictory input assignment raises, as in the Python path."""
    b = tbuilder.CircuitBuilder(tconfig.CircuitConfig.standard_recursion_config())
    x = b.add_virtual_target()
    y = b.add_virtual_target()
    b.connect(x, y)
    b.register_public_input(x)
    data = b.build(commit=False)
    pw = twitness.PartialWitness()
    pw.set_target(x, 1)
    pw.set_target(y, 2)
    with _env("PLONKY2_TPU_NATIVE_WITGEN", "1"):
        with pytest.raises(AssertionError):
            wn.generate_partial_witness_native(pw, data.prover_only, data.common)
    with _env("PLONKY2_TPU_NATIVE_WITGEN", "0"):
        with pytest.raises(AssertionError):
            tgen.generate_partial_witness(pw, data.prover_only, data.common)


def test_dispatch_takes_the_native_engine():
    data, pw = tfib.build_fibonacci(public_io=True, device="cpu")
    w = tgen.generate_partial_witness(pw, data.prover_only, data.common)
    assert isinstance(w, wn.NumpyPartitionWitness)
    with _env("PLONKY2_TPU_NATIVE_WITGEN", "0"):
        w = tgen.generate_partial_witness(pw, data.prover_only, data.common)
    assert not isinstance(w, wn.NumpyPartitionWitness)


def test_fixed_random_values_are_order_free():
    """The blinding stream of the zk comparisons: a value a target, the
    same in whatever order the generators run, restored after the block."""
    T = ttarget.Target
    gen_a = tgen.RandomValueGenerator(T.wire(3, 7))
    gen_b = tgen.RandomValueGenerator(T.virtual(2))

    class Out:
        def __init__(self):
            self.vals = {}

        def set_target(self, t, v):
            self.vals[t] = v

    with tgen.fixed_random_values(5):
        o1, o2 = Out(), Out()
        gen_a.run_once(None, o1)
        gen_b.run_once(None, o1)
        gen_b.run_once(None, o2)
        gen_a.run_once(None, o2)
    assert o1.vals == o2.vals
    assert o1.vals[T.wire(3, 7)] == tgen.fixed_random_value(5, T.wire(3, 7))
    o3 = Out()
    gen_a.run_once(None, o3)  # fresh randomness again
    assert o3.vals[T.wire(3, 7)] != o1.vals[T.wire(3, 7)]

"""The device-resident transcript of the port (ROADMAP A9) on the CPU: the
DeviceChallenger against the JAX package's host Challenger (pure Python),
the device power tables against their host oracle, the device PoW grind
against a host grind over the JAX package's pure-Python Poseidon, the
opening reduction at device points against the host one, the fused FRI
proof against the unfused one, and the fibonacci proof by both transcripts
against the golden bytes, with the host reads each transcript makes.
Tolerance: none — equality of field words and of bytes."""

import collections
import copy
import dataclasses
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from plonky2_tpu.field.goldilocks import P
from plonky2_tpu.hash import poseidon as jhp
from plonky2_tpu.hash.challenger import Challenger as JChallenger
from _torch_port import lazy_module

ge = lazy_module("plonky2_tpu_torch.field.extension")
tfo = lazy_module("plonky2_tpu_torch.fri.oracle")
tst = lazy_module("plonky2_tpu_torch.fri.structure")
tcfg = lazy_module("plonky2_tpu_torch.fri.config")
tch = lazy_module("plonky2_tpu_torch.hash.challenger")
tdc = lazy_module("plonky2_tpu_torch.hash.device_challenger")
tfk = lazy_module("plonky2_tpu_torch.ops.fri_kernels")
tgf = lazy_module("plonky2_tpu_torch.ops.gf")
tdt = lazy_module("plonky2_tpu_torch.plonk.device_transcript")
tfib = lazy_module("plonky2_tpu_torch.models.fibonacci")
tprover = lazy_module("plonky2_tpu_torch.plonk.prover")
ser = lazy_module("plonky2_tpu_torch.utils.serialization")

GOLDEN = Path(__file__).resolve().parent / "golden"


def _t(x):
    return tgf.from_u64(np.asarray(x, dtype=np.uint64), "cpu")


def _words(t):
    return [int(v) for v in tgf.to_u64(t.reshape(-1))]


# ---------------------------------------------------------------------------
# DeviceChallenger against the host duplex
# ---------------------------------------------------------------------------

# ("obs", k): observe k words; ("cap", m): observe an [m, 4] cap;
# ("sq", n): draw n challenges; ("ext",): draw an extension challenge;
# ("handoff",): export and resume; ("from_host",): start again from the
# host challenger's state
EDGE_SEQUENCES = {
    "observe_8_then_squeeze": [("obs", 8), ("sq", 1), ("sq", 8), ("sq", 3)],
    "observe_9": [("obs", 9), ("sq", 2), ("obs", 7), ("sq", 9)],
    "squeeze_fresh": [("sq", 1), ("sq", 10), ("ext",)],
    "squeeze_after_duplex": [("obs", 16), ("sq", 8), ("sq", 1), ("obs", 1), ("ext",)],
    "caps": [("cap", 4), ("sq", 4), ("cap", 1), ("obs", 3), ("sq", 2)],
    "observe_nothing": [("sq", 3), ("obs", 0), ("sq", 6), ("obs", 0), ("obs", 5), ("sq", 1)],
    "handoff_pending": [("obs", 13), ("handoff",), ("obs", 4), ("sq", 3)],
    "from_host_pending": [("obs", 5), ("from_host",), ("sq", 2), ("obs", 11), ("from_host",), ("ext",)],
    "handoff_outputs_left": [("obs", 8), ("handoff",), ("sq", 3), ("handoff",), ("sq", 6)],
    "from_host_outputs_left": [("cap", 2), ("from_host",), ("sq", 5), ("from_host",), ("ext",), ("sq", 2)],
}


def _random_sequence(seed):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(int(rng.integers(4, 9))):
        r = rng.random()
        if r < 0.35:
            ops.append(("obs", int(rng.choice([1, 2, 7, 8, 9, 12, 17]))))
        elif r < 0.5:
            ops.append(("cap", int(rng.choice([1, 2, 4]))))
        elif r < 0.75:
            ops.append(("sq", int(rng.integers(1, 11))))
        elif r < 0.85:
            ops.append(("ext",))
        else:
            ops.append(("handoff",) if r < 0.93 else ("from_host",))
    return ops


@pytest.mark.parametrize(
    "ops",
    list(EDGE_SEQUENCES.values()) + [_random_sequence(s) for s in range(8)],
    ids=list(EDGE_SEQUENCES) + [f"seed{s}" for s in range(8)],
)
def test_device_challenger_equals_host_challenger(ops):
    rng = np.random.default_rng(len(ops) * 7919 + sum(len(o) for o in ops))
    host = JChallenger()
    dev = tdc.DeviceChallenger(tgf.zeros((12,), "cpu"))
    for op in ops:
        if op[0] in ("obs", "cap"):
            k = op[1] * (4 if op[0] == "cap" else 1)
            xs = [int(v) for v in rng.integers(0, P, size=k, dtype=np.uint64)]
            host.observe_elements(xs)
            if op[0] == "cap":
                dev.observe_cap_rows(_t(xs).reshape(-1, 4))
            else:
                dev.observe_elements(_t(xs))
        elif op[0] == "sq":
            assert _words(dev.get_n_challenges(op[1])) == host.get_n_challenges(op[1])
        elif op[0] == "ext":
            assert _words(dev.get_extension_challenge()) == list(host.get_extension_challenge(2))
        elif op[0] == "handoff":
            st = dev.export()
            assert st.in_len == len(host.input_buffer)
            assert _words(st.input_buffer)[: st.in_len] == host.input_buffer
            assert st.out_len == len(host.output_buffer)
            dev = tdc.DeviceChallenger.from_state(st)
        else:
            dev = tdc.DeviceChallenger.from_host(host, "cpu")
        assert _words(dev.state) == host.sponge_state
        assert dev.in_len == len(host.input_buffer)
        pending = _words(dev.overlaid_state())[: dev.in_len]
        assert pending == host.input_buffer


# ---------------------------------------------------------------------------
# Power tables, PoW grind, opening reduction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 255, 256, 257, 1023, 1024, 1025])
def test_ext2_powers_scan_equals_host_tables(n):
    rng = np.random.default_rng(n)
    z = tuple(int(v) for v in rng.integers(0, P, size=2, dtype=np.uint64))
    got = tgf.to_u64(tgf.ext2_powers_scan(_t(z), n))
    np.testing.assert_array_equal(got, tfo.ext_powers_np(z, n))
    acc = ge.ext_one(2)
    for i in range(min(n, 20)):
        assert tuple(int(v) for v in got[i]) == acc
        acc = ge.ext_mul(acc, z)


def _host_grind(state, pos, bits):
    """The definition: the first w whose response has bits leading zeros."""
    w = 0
    while True:
        trial = list(state)
        trial[pos] = w
        if bits == 0 or jhp.permute(trial)[7] >> (64 - bits) == 0:
            return w
        w += 1


@pytest.mark.parametrize("chunk", [16, None])
@pytest.mark.parametrize("bits,pos", [(0, 0), (1, 11), (3, 3), (5, 7), (6, 0)])
def test_device_grind_finds_the_smallest_witness(bits, pos, chunk, monkeypatch):
    rng = np.random.default_rng(bits * 16 + pos)
    state = [int(v) for v in rng.integers(0, P, size=12, dtype=np.uint64)]
    fk = tfk.load()
    if chunk:
        monkeypatch.setattr(fk, "_pow_chunk_size", lambda b: chunk)
    size = fk._pow_chunk_size(bits)
    want = _host_grind(state, pos, bits)
    w, chunks = fk.pow_grind_device(_t(state), pos, bits)
    assert int(w) == want
    assert chunks == want // size + 1
    assert fk.pow_grind(state, pos, bits, "cpu") == want


def _polys(rng, k, n):
    return rng.integers(0, P, size=(k, n), dtype=np.uint64)


def _oracles(rng, counts, degree_bits, rate_bits=2, cap_height=1):
    n = 1 << degree_bits
    return [
        tfo.PolynomialBatch.from_coeffs(_polys(rng, k, n), rate_bits, False, cap_height, device="cpu")
        for k in counts
    ]


def _ext(rng):
    return tuple(int(v) for v in rng.integers(0, P, size=2, dtype=np.uint64))


def _horner(coeffs_row, z):
    acc = ge.ext_zero(2)
    for c in reversed([int(x) for x in coeffs_row]):
        acc = ge.ext_add(ge.ext_mul(acc, z), ge.from_base(c, 2))
    return acc


@pytest.mark.parametrize("degree_bits,counts", [(3, (1,)), (4, (3, 2)), (5, (2, 5, 1))])
def test_openings_at_device_points_equal_horner(degree_bits, counts):
    rng = np.random.default_rng(degree_bits)
    oracles = _oracles(rng, counts, degree_bits)
    z, zn = _ext(rng), _ext(rng)
    got = tgf.to_u64(tfo.eval_commitments_at_device(oracles, _t(z), _t(zn)))
    assert got.shape == (2 * sum(counts), 2)
    per = tfo.split_evals(got, oracles)
    assert per == tfo.eval_commitments_at(oracles, z, zn)
    for b, point in enumerate((z, zn)):
        for o, vals in zip(oracles, per[b * len(oracles) : (b + 1) * len(oracles)]):
            coeffs = tgf.to_u64(o.polynomials)
            assert vals == [_horner(row, point) for row in coeffs]


def _instance(counts, zeta, eta, next_polys):
    st = tst.load()
    zeta_polys = [p for oi, k in enumerate(counts) for p in st.FriPolynomialInfo.from_range(oi, 0, k)]
    return st.FriInstanceInfo(
        oracles=[st.FriOracleInfo(k, False) for k in counts],
        batches=[
            st.FriBatchInfo.from_polys(zeta, zeta_polys),
            st.FriBatchInfo.from_polys(eta, next_polys),
        ],
    )


@pytest.mark.parametrize("layout", ["contiguous", "gaps"])
def test_device_reduction_equals_host_reduction(layout):
    """_reduce_openings_device (device alpha and points) against
    reduce_openings_to_final_poly (host alpha and points)."""
    rng = np.random.default_rng(len(layout))
    counts = (3, 4, 2)
    oracles = _oracles(rng, counts, 4)
    zeta, eta, alpha = _ext(rng), _ext(rng), _ext(rng)
    st = tst.load()
    if layout == "contiguous":
        next_polys = st.FriPolynomialInfo.from_range(1, 0, 2)
    else:
        next_polys = [st.FriPolynomialInfo(1, 3), st.FriPolynomialInfo(0, 0), st.FriPolynomialInfo(1, 1)]
    instance = _instance(counts, zeta, eta, next_polys)
    want = tgf.to_u64(tfo.reduce_openings_to_final_poly(instance, oracles, alpha))
    got = tdt.load()._reduce_openings_device(instance, oracles, _t(alpha), [_t(zeta), _t(eta)])
    np.testing.assert_array_equal(tgf.to_u64(got), want)


@pytest.mark.parametrize("e", [0, 1, 2, 7, 64, 143, 1000])
def test_ext2_pow_static(e):
    x = _ext(np.random.default_rng(e))
    got = tdt.load()._ext2_pow_static(_t(x), e)
    assert tuple(_words(got)) == ge.ext_exp(x, e)


def test_eligibility():
    dt = tdt.load()
    poseidon = SimpleNamespace(hasher=SimpleNamespace(name="poseidon"))
    assert dt.eligible(SimpleNamespace(num_lookup_polys=0), poseidon)
    assert dt.eligible(SimpleNamespace(num_lookup_polys=2), poseidon)
    assert not dt.eligible(
        SimpleNamespace(num_lookup_polys=0), SimpleNamespace(hasher=SimpleNamespace(name="keccak"))
    )


# ---------------------------------------------------------------------------
# Fused against unfused FRI (mirrors tests/test_fri.py:113, the port alone)
# ---------------------------------------------------------------------------


def _normalize(x):
    if dataclasses.is_dataclass(x):
        return tuple(_normalize(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, np.ndarray):
        return tuple(int(v) for v in x.reshape(-1))
    if isinstance(x, (list, tuple)):
        return tuple(_normalize(v) for v in x)
    return x


# (degree_bits, rate_bits, cap_height, arity_bits, pow_bits, queries, observed before)
FRI_CASES = [
    (3, 1, 1, 1, 0, 2, 0),
    (4, 2, 2, 2, 2, 3, 5),
    (4, 1, 1, 3, 4, 4, 8),
    (3, 2, 0, 1, 3, 3, 9),
]


@pytest.mark.parametrize("case", FRI_CASES, ids=[f"case{i}" for i in range(len(FRI_CASES))])
def test_fused_and_unfused_fri_proofs_are_equal(case):
    degree_bits, rate_bits, cap_height, arity_bits, pow_bits, queries, observed = case
    rng = np.random.default_rng(degree_bits * 100 + observed)
    cfg = tcfg.FriConfig(
        rate_bits=rate_bits,
        cap_height=cap_height,
        proof_of_work_bits=pow_bits,
        reduction_strategy=tcfg.FriReductionStrategy.ConstantArityBits(arity_bits, 2),
        num_query_rounds=queries,
    )
    params = cfg.fri_params(degree_bits)
    assert params.reduction_arity_bits, "the case must fold at least once"
    oracles = _oracles(rng, (3, 2), degree_bits, rate_bits, cap_height)
    zeta, eta = _ext(rng), _ext(rng)
    st = tst.load()
    instance = _instance((3, 2), zeta, eta, st.FriPolynomialInfo.from_range(1, 0, 2))
    ch = tch.Challenger()
    ch.observe_elements([int(v) for v in rng.integers(0, P, size=observed, dtype=np.uint64)])
    fused = tfo.prove_openings(instance, oracles, copy.deepcopy(ch), params, fused=True)
    unfused = tfo.prove_openings(instance, oracles, copy.deepcopy(ch), params, fused=False)
    assert _normalize(fused) == _normalize(unfused)


def test_fused_fri_refuses_recursion_padding():
    rng = np.random.default_rng(0)
    oracles = _oracles(rng, (1,), 3)
    coeffs = tgf.zeros((32, 2), "cpu")
    params = tcfg.FriConfig(2, 1, 0, tcfg.FriReductionStrategy.ConstantArityBits(1, 2), 2).fri_params(3)
    fri_prover = lazy_module("plonky2_tpu_torch.fri.prover")
    with pytest.raises(ValueError):
        fri_prover.fri_proof(
            [o.merkle_tree for o in oracles], coeffs, coeffs, tch.Challenger(), params,
            final_poly_coeff_len=4, fused=True,
        )


# ---------------------------------------------------------------------------
# The fibonacci proof by both transcripts, and their host reads
# ---------------------------------------------------------------------------

# Tensor methods that bring a value to the host; on a GPU each one waits
# for the device. (.numpy() is left out: on a GPU tensor it needs .cpu()
# first, which is counted.)
READS = ("cpu", "item", "tolist", "__bool__", "__int__", "__index__", "__float__", "nonzero")


@pytest.fixture(scope="module")
def fib_proofs():
    """The fibonacci proof by the device and by the host transcript, with
    the host reads each made, and the PoW chunks the grind tried."""
    import torch

    data, pw = tfib.build_fibonacci(public_io=True, device="cpu")
    out = {}
    for transcript in ("device", "host"):
        reads = collections.Counter()
        saved = {name: getattr(torch.Tensor, name) for name in READS}

        def counted(name, fn):
            def method(self, *args, **kwargs):
                reads[name] += 1
                return fn(self, *args, **kwargs)

            return method

        for name in READS:
            setattr(torch.Tensor, name, counted(name, saved[name]))
        try:
            pwp = tprover.prove(
                data.prover_only, data.common, pw, device="cpu",
                device_transcript=transcript == "device",
            )
        finally:
            for name, fn in saved.items():
                setattr(torch.Tensor, name, fn)
        out[transcript] = (pwp, reads)
    config = data.common.config.fri_config
    chunks = out["device"][0].proof.opening_proof.pow_witness // tfk.load()._pow_chunk_size(
        config.proof_of_work_bits
    ) + 1
    return data, out, chunks


@pytest.mark.parametrize("transcript", ["device", "host"])
def test_fibonacci_proof_by_each_transcript_equals_golden(fib_proofs, transcript):
    data, out, _ = fib_proofs
    pwp = out[transcript][0]
    assert pwp.public_inputs[2] == tfib.fib_value()
    assert ser.proof_to_bytes(pwp, data.common) == (GOLDEN / "fibonacci_proof.bin").read_bytes()


def test_device_and_host_transcripts_give_equal_bytes(fib_proofs):
    data, out, _ = fib_proofs
    assert ser.proof_to_bytes(out["device"][0], data.common) == ser.proof_to_bytes(
        out["host"][0], data.common
    )


def test_device_transcript_reads_the_host_once_plus_a_flag_a_pow_chunk(fib_proofs):
    """The bound chip_smoke.py holds the card to: at most the grind's
    chunks plus one synchronising reads a proof."""
    _, out, chunks = fib_proofs
    reads = out["device"][1]
    assert sum(reads.values()) <= chunks + 1, dict(reads)
    assert reads["__bool__"] == chunks  # the grind's found flags
    # the host transcript reads every cap and the openings back
    assert sum(out["host"][1].values()) > sum(reads.values()) + 3, dict(out["host"][1])

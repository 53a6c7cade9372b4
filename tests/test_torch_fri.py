"""FRI device ops and the FRI prover of the port against the JAX package;
a FRI opening proof made by the port is checked by the JAX package's host
verifier (jax-free) and by the port's own. Tolerance: none."""

import jax
import numpy as np
import pytest

from plonky2_tpu.fri import verifier as jfv
from plonky2_tpu.fri.config import FriConfig as JFriConfig
from plonky2_tpu.fri.config import FriReductionStrategy as JStrategy
from plonky2_tpu.fri import structure as jst
from plonky2_tpu.hash.challenger import Challenger as JChallenger
from plonky2_tpu.ops import fri_kernels as jfk
from plonky2_tpu.ops import gf as jgf
from _torch_port import lazy_module
from plonky2_tpu.field.goldilocks import P

ge = lazy_module("plonky2_tpu_torch.field.extension")
tfo = lazy_module("plonky2_tpu_torch.fri.oracle")
tst = lazy_module("plonky2_tpu_torch.fri.structure")
tfv = lazy_module("plonky2_tpu_torch.fri.verifier")
tcfg = lazy_module("plonky2_tpu_torch.fri.config")
tch = lazy_module("plonky2_tpu_torch.hash.challenger")
tfk = lazy_module("plonky2_tpu_torch.ops.fri_kernels")
tgf = lazy_module("plonky2_tpu_torch.ops.gf")



def _t(x):
    return tgf.from_u64(x, "cpu")


def test_fold_coeffs():
    rng = np.random.default_rng(1)
    arity_bits = 2
    coeffs = rng.integers(0, P, size=(64, 2), dtype=np.uint64)
    beta = (int(rng.integers(0, P, dtype=np.uint64)), int(rng.integers(0, P, dtype=np.uint64)))
    pows = [ge.ext_one(2)]
    for _ in range((1 << arity_bits) - 1):
        pows.append(ge.ext_mul(pows[-1], beta))
    bp = np.array(pows, dtype=np.uint64)
    want = jgf.to_u64(jfk.fold_coeffs(jgf.from_u64(coeffs), jgf.from_u64(bp), arity_bits))
    got = tgf.to_u64(tfk.fold_coeffs(_t(coeffs), _t(bp), arity_bits))
    np.testing.assert_array_equal(got, want)
    # against the definition
    for i in (0, 7, 15):
        acc = ge.ext_zero(2)
        for j in range(4):
            acc = ge.ext_add(acc, ge.ext_mul(pows[j], tuple(int(v) for v in coeffs[4 * i + j])))
        assert tuple(int(v) for v in got[i]) == acc


def test_commit_phase_tree():
    rng = np.random.default_rng(2)
    values = rng.integers(0, P, size=(64, 2), dtype=np.uint64)
    jt = jfk.commit_phase_tree(jgf.from_u64(values), 2, 1)
    tt = tfk.commit_phase_tree(_t(values), 2, 1)
    assert tuple(tt.leaves.shape) == (16, 8)
    np.testing.assert_array_equal(tgf.to_u64(tt.leaves), jgf.to_u64(jt.leaves))
    assert len(tt.levels) == len(jt.levels)
    for a, b in zip(jt.levels, tt.levels):
        np.testing.assert_array_equal(tgf.to_u64(b), jgf.to_u64(a))
    np.testing.assert_array_equal(tt.cap_u64(), jt.cap_u64())


def test_ext_poly_ops():
    rng = np.random.default_rng(3)
    coeffs = rng.integers(0, P, size=(16, 2), dtype=np.uint64)
    other = rng.integers(0, P, size=(16, 2), dtype=np.uint64)
    z = (11, 22)
    short = coeffs[:8]  # the reference's associative scan compiles slowly
    want = jgf.to_u64(jfk.divide_by_linear_ext(jgf.from_u64(short), z))
    np.testing.assert_array_equal(tgf.to_u64(tfk.divide_by_linear_ext(_t(short), z)), want)
    want = jgf.to_u64(jfk.ext_poly_mul_const(jgf.from_u64(coeffs), z))
    np.testing.assert_array_equal(tgf.to_u64(tfk.ext_poly_mul_const(_t(coeffs), z)), want)
    want = jgf.to_u64(jfk.ext_poly_add(jgf.from_u64(coeffs), jgf.from_u64(other)))
    np.testing.assert_array_equal(tgf.to_u64(tfk.ext_poly_add(_t(coeffs), _t(other))), want)
    want = jgf.to_u64(jfk.ext_coset_fft(jgf.from_u64(coeffs)))
    np.testing.assert_array_equal(tgf.to_u64(tfk.ext_coset_fft(_t(coeffs))), want)
    polys = rng.integers(0, P, size=(5, 16), dtype=np.uint64)
    w = rng.integers(0, P, size=(5, 2), dtype=np.uint64)
    want = jgf.to_u64(jfk.composition_poly(jgf.from_u64(polys), w))
    np.testing.assert_array_equal(tgf.to_u64(tfk.composition_poly(_t(polys), w)), want)


def test_pow_grind_smallest_witness():
    rng = np.random.default_rng(4)
    state = [int(x) for x in rng.integers(0, P, size=12, dtype=np.uint64)]
    pow_bits, pos = 4, 3
    want = jfk.pow_grind(state, pos, pow_bits)
    got = tfk.pow_grind(state, pos, pow_bits, "cpu")
    assert got == want
    # smallest: no earlier candidate has pow_bits leading zeros
    hp = lazy_module("plonky2_tpu_torch.hash.poseidon")
    for w in range(got + 1):
        trial = list(state)
        trial[pos] = w
        zeros = 64 - hp.permute(trial)[7].bit_length()
        assert (zeros >= pow_bits) == (w == got)
    assert tfk.pow_grind(state, pos, 0, "cpu") == 0


def _config(mod_config, mod_strategy):
    return mod_config(
        rate_bits=3,
        cap_height=2,
        proof_of_work_bits=4,
        reduction_strategy=mod_strategy.ConstantArityBits(2, 3),
        num_query_rounds=10,
    )


def _instance(st, k0, k1, zeta, eta):
    all_polys = st.FriPolynomialInfo.from_range(0, 0, k0) + st.FriPolynomialInfo.from_range(1, 0, k1)
    return st.FriInstanceInfo(
        oracles=[st.FriOracleInfo(k0, False), st.FriOracleInfo(k1, False)],
        batches=[
            st.FriBatchInfo.from_polys(zeta, all_polys),
            st.FriBatchInfo.from_polys(eta, st.FriPolynomialInfo.from_range(1, 0, k1)),
        ],
    )


def test_fri_opening_proof_accepted_by_reference_verifier():
    rng = np.random.default_rng(42)
    degree_bits, k0, k1 = 6, 5, 3
    n = 1 << degree_bits
    cfg = _config(tcfg.FriConfig, tcfg.FriReductionStrategy)
    params = cfg.fri_params(degree_bits)
    coeffs0 = rng.integers(0, P, size=(k0, n), dtype=np.uint64)
    coeffs1 = rng.integers(0, P, size=(k1, n), dtype=np.uint64)
    o0 = tfo.PolynomialBatch.from_coeffs(coeffs0, cfg.rate_bits, False, cfg.cap_height, device="cpu")
    o1 = tfo.PolynomialBatch.from_coeffs(coeffs1, cfg.rate_bits, False, cfg.cap_height, device="cpu")
    zr = rng.integers(0, P, size=4, dtype=np.uint64)
    zeta, eta = (int(zr[0]), int(zr[1])), (int(zr[2]), int(zr[3]))
    evals_zeta = o0.eval_all_at_ext(zeta) + o1.eval_all_at_ext(zeta)
    evals_eta = o1.eval_all_at_ext(eta)

    # the device evaluation is the Horner value
    acc = ge.ext_zero(2)
    for c in reversed([int(x) for x in coeffs0[0]]):
        acc = ge.ext_add(ge.ext_mul(acc, zeta), ge.from_base(c, 2))
    assert evals_zeta[0] == acc

    prover_ch = tch.Challenger()
    prover_ch.observe_element(12345)
    prover_ch.observe_extension_elements(evals_zeta)
    prover_ch.observe_extension_elements(evals_eta)
    proof = tfo.prove_openings(
        _instance(tst, k0, k1, zeta, eta), [o0, o1], prover_ch, params
    )
    caps = [o0.cap_u64(), o1.cap_u64()]

    # the port's own host verifier and the JAX package's, each on its own types
    for fv, st, ch_cls, cfg_v in (
        (tfv, tst, tch.Challenger, cfg),
        (jfv, jst, JChallenger, _config(JFriConfig, JStrategy)),
    ):
        ch = ch_cls()
        ch.observe_element(12345)
        ch.observe_extension_elements(evals_zeta)
        ch.observe_extension_elements(evals_eta)
        challenges = fv.fri_challenges(
            ch, proof.commit_phase_merkle_caps, proof.final_poly, proof.pow_witness,
            degree_bits, cfg_v,
        )
        openings = st.FriOpenings(
            batches=[st.FriOpeningBatch(evals_zeta), st.FriOpeningBatch(evals_eta)]
        )
        instance = _instance(st, k0, k1, zeta, eta)
        params_v = cfg_v.fri_params(degree_bits)
        fv.verify_fri_proof(instance, openings, challenges, caps, proof, params_v)
        bad = st.FriOpenings(
            batches=[
                st.FriOpeningBatch([(evals_zeta[0][0] ^ 1, evals_zeta[0][1])] + evals_zeta[1:]),
                st.FriOpeningBatch(evals_eta),
            ]
        )
        with pytest.raises(fv.FriVerificationError):
            fv.verify_fri_proof(instance, bad, challenges, caps, proof, params_v)

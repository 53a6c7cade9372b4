"""Conditional recursive verification: select between two proofs with a
boolean and verify the selection once (reference:
plonky2/src/recursion/conditional_recursive_verifier.rs:24-220)."""

from __future__ import annotations

from typing import List

from ..iop.target import BoolTarget, ExtensionTarget
from ..plonk.proof_target import (
    FriInitialTreeProofTarget,
    FriProofTarget,
    FriQueryRoundTarget,
    FriQueryStepTarget,
    MerkleCapTarget,
    MerkleProofTarget,
    OpeningSetTarget,
    ProofTarget,
    ProofWithPublicInputsTarget,
)
from ..plonk.recursive_verifier import VerifierCircuitTarget, verify_proof_circuit


def _sel(b, cond, x0, x1):
    return b.select(cond, x0, x1)


def _sel_list(b, cond, l0, l1):
    return [b.select(cond, x, y) for x, y in zip(l0, l1)]


def _sel_ext(b, cond, e0, e1):
    return b.select_ext(cond, e0, e1)


def _sel_ext_list(b, cond, l0, l1):
    return [b.select_ext(cond, x, y) for x, y in zip(l0, l1)]


def _sel_cap(b, cond, c0: MerkleCapTarget, c1: MerkleCapTarget) -> MerkleCapTarget:
    return MerkleCapTarget(
        [_sel_list(b, cond, h0, h1) for h0, h1 in zip(c0.hashes, c1.hashes)]
    )


def _sel_merkle_proof(b, cond, p0: MerkleProofTarget, p1: MerkleProofTarget):
    return MerkleProofTarget(
        [_sel_list(b, cond, s0, s1) for s0, s1 in zip(p0.siblings, p1.siblings)]
    )


def select_proof_with_pis(
    b, cond: BoolTarget, p0: ProofWithPublicInputsTarget, p1: ProofWithPublicInputsTarget
) -> ProofWithPublicInputsTarget:
    pr0, pr1 = p0.proof, p1.proof
    o0, o1 = pr0.openings, pr1.openings
    openings = OpeningSetTarget(
        constants=_sel_ext_list(b, cond, o0.constants, o1.constants),
        plonk_sigmas=_sel_ext_list(b, cond, o0.plonk_sigmas, o1.plonk_sigmas),
        wires=_sel_ext_list(b, cond, o0.wires, o1.wires),
        plonk_zs=_sel_ext_list(b, cond, o0.plonk_zs, o1.plonk_zs),
        plonk_zs_next=_sel_ext_list(b, cond, o0.plonk_zs_next, o1.plonk_zs_next),
        partial_products=_sel_ext_list(b, cond, o0.partial_products, o1.partial_products),
        quotient_polys=_sel_ext_list(b, cond, o0.quotient_polys, o1.quotient_polys),
        lookup_zs=_sel_ext_list(b, cond, o0.lookup_zs, o1.lookup_zs),
        lookup_zs_next=_sel_ext_list(b, cond, o0.lookup_zs_next, o1.lookup_zs_next),
    )
    f0, f1 = pr0.opening_proof, pr1.opening_proof
    rounds = []
    for r0, r1 in zip(f0.query_round_proofs, f1.query_round_proofs):
        evals_proofs = [
            (
                _sel_list(b, cond, e0, e1),
                _sel_merkle_proof(b, cond, m0, m1),
            )
            for (e0, m0), (e1, m1) in zip(
                r0.initial_trees_proof.evals_proofs, r1.initial_trees_proof.evals_proofs
            )
        ]
        steps = [
            FriQueryStepTarget(
                evals=_sel_ext_list(b, cond, s0.evals, s1.evals),
                merkle_proof=_sel_merkle_proof(b, cond, s0.merkle_proof, s1.merkle_proof),
            )
            for s0, s1 in zip(r0.steps, r1.steps)
        ]
        rounds.append(
            FriQueryRoundTarget(FriInitialTreeProofTarget(evals_proofs), steps)
        )
    fri = FriProofTarget(
        commit_phase_merkle_caps=[
            _sel_cap(b, cond, c0, c1)
            for c0, c1 in zip(f0.commit_phase_merkle_caps, f1.commit_phase_merkle_caps)
        ],
        query_round_proofs=rounds,
        final_poly=_sel_ext_list(b, cond, f0.final_poly, f1.final_poly),
        pow_witness=_sel(b, cond, f0.pow_witness, f1.pow_witness),
    )
    proof = ProofTarget(
        wires_cap=_sel_cap(b, cond, pr0.wires_cap, pr1.wires_cap),
        plonk_zs_partial_products_cap=_sel_cap(
            b, cond, pr0.plonk_zs_partial_products_cap, pr1.plonk_zs_partial_products_cap
        ),
        quotient_polys_cap=_sel_cap(b, cond, pr0.quotient_polys_cap, pr1.quotient_polys_cap),
        openings=openings,
        opening_proof=fri,
    )
    return ProofWithPublicInputsTarget(
        proof, _sel_list(b, cond, p0.public_inputs, p1.public_inputs)
    )


def select_verifier_data(
    b, cond: BoolTarget, v0: VerifierCircuitTarget, v1: VerifierCircuitTarget
) -> VerifierCircuitTarget:
    return VerifierCircuitTarget(
        constants_sigmas_cap=_sel_cap(b, cond, v0.constants_sigmas_cap, v1.constants_sigmas_cap),
        circuit_digest=_sel_list(b, cond, v0.circuit_digest, v1.circuit_digest),
    )


def conditionally_verify_proof(
    builder,
    condition: BoolTarget,
    proof0: ProofWithPublicInputsTarget,
    verifier_data0: VerifierCircuitTarget,
    proof1: ProofWithPublicInputsTarget,
    verifier_data1: VerifierCircuitTarget,
    common,
) -> None:
    """Verify proof0 if condition else proof1 (both must share `common`)."""
    selected = select_proof_with_pis(builder, condition, proof0, proof1)
    vd = select_verifier_data(builder, condition, verifier_data0, verifier_data1)
    verify_proof_circuit(builder, selected, vd, common)


def conditionally_verify_proof_or_dummy(
    builder,
    condition: BoolTarget,
    proof: ProofWithPublicInputsTarget,
    verifier_data: VerifierCircuitTarget,
    common,
    device=None,
):
    """condition ? verify(proof) : verify(dummy). Returns the dummy targets
    (a DummyProofGenerator fills them). The dummy circuit is built and
    proven on ``device`` (None means the GPU) when the witness is first
    generated, so that a circuit built only for its shape proves nothing."""
    from ..plonk.proof_target import add_virtual_proof_with_pis
    from ..plonk.recursive_verifier import add_virtual_verifier_data

    dummy_t = add_virtual_proof_with_pis(builder, common)
    dummy_vd_t = add_virtual_verifier_data(builder, common.fri_params.config.cap_height)
    builder.add_simple_generator(DummyProofGenerator(dummy_t, dummy_vd_t, common, device))
    conditionally_verify_proof(
        builder, condition, proof, verifier_data, dummy_t, dummy_vd_t, common
    )
    return dummy_t, dummy_vd_t


class DummyProofGenerator:
    """Fills the dummy proof targets unconditionally
    (dummy_circuit.rs:160-220) with the proof of ``dummy_circuit(common)``.
    The circuit and its proof are made when first asked for, and kept."""

    def __init__(self, proof_t, vd_t, common, device=None):
        self.proof_t = proof_t
        self.vd_t = vd_t
        self.common = common
        self.device = device
        self._circuit = None
        self._dummy = None

    def circuit(self):
        """The circuit data of ``dummy_circuit(common)`` on the device."""
        if self._circuit is None:
            from .dummy_circuit import dummy_circuit

            self._circuit = dummy_circuit(self.common, device=self.device)
        return self._circuit

    def dummy(self):
        """(the dummy proof, its verifier data, its common data)."""
        if self._dummy is None:
            from .dummy_circuit import dummy_proof

            data = self.circuit()
            self._dummy = (dummy_proof(data, device=self.device), data.verifier_only, data.common)
        return self._dummy

    def id(self) -> str:
        return "DummyProofGenerator"

    def dependencies(self):
        return []

    def watch_list(self):
        return []

    def run(self, witness, out) -> bool:
        self.run_once(witness, out)
        return True

    def run_once(self, witness, out) -> None:
        from ..plonk.proof_target import set_proof_with_pis_target
        from ..plonk.recursive_verifier import set_verifier_data_target

        class _PW:
            def __init__(self, out):
                self.out = out

            def set_target(self, t, v):
                self.out.set_target(t, v)

        proof, vd, _ = self.dummy()
        pw = _PW(out)
        set_proof_with_pis_target(pw, self.proof_t, proof)
        set_verifier_data_target(pw, self.vd_t, vd)

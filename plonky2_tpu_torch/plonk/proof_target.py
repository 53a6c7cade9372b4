"""In-circuit proof representation + virtual allocation + witness filling
(reference: plonky2/src/plonk/proof.rs ProofTarget,
recursion/recursive_verifier.rs:138-226 add_virtual_proof_with_pis,
and the set_proof_with_pis_target witness helpers in iop/witness.rs)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

from ..iop.target import ExtensionTarget, Target
from .circuit_data import CommonCircuitData


@dataclass
class MerkleCapTarget:
    hashes: List[List[Target]]  # [2^cap_height][4]


@dataclass
class MerkleProofTarget:
    siblings: List[List[Target]]  # [path_len][4]


@dataclass
class FriInitialTreeProofTarget:
    evals_proofs: List[Tuple[List[Target], MerkleProofTarget]]

    def unsalted_eval(self, oracle_index: int, poly_index: int, salted: bool) -> Target:
        evals = self.evals_proofs[oracle_index][0]
        if salted:
            evals = evals[:-4]
        return evals[poly_index]


@dataclass
class FriQueryStepTarget:
    evals: List[ExtensionTarget]
    merkle_proof: MerkleProofTarget


@dataclass
class FriQueryRoundTarget:
    initial_trees_proof: FriInitialTreeProofTarget
    steps: List[FriQueryStepTarget]


@dataclass
class FriProofTarget:
    commit_phase_merkle_caps: List[MerkleCapTarget]
    query_round_proofs: List[FriQueryRoundTarget]
    final_poly: List[ExtensionTarget]
    pow_witness: Target


@dataclass
class OpeningSetTarget:
    constants: List[ExtensionTarget]
    plonk_sigmas: List[ExtensionTarget]
    wires: List[ExtensionTarget]
    plonk_zs: List[ExtensionTarget]
    plonk_zs_next: List[ExtensionTarget]
    partial_products: List[ExtensionTarget]
    quotient_polys: List[ExtensionTarget]
    lookup_zs: List[ExtensionTarget] = field(default_factory=list)
    lookup_zs_next: List[ExtensionTarget] = field(default_factory=list)

    def to_fri_openings(self):
        """Target analogue of OpeningSet.to_fri_openings — batch value lists
        in the exact transcript order (plonk/proof.rs:329-369)."""
        zeta_batch = (
            self.constants
            + self.plonk_sigmas
            + self.wires
            + self.plonk_zs
            + self.partial_products
            + self.quotient_polys
            + self.lookup_zs
        )
        zeta_next_batch = self.plonk_zs_next + self.lookup_zs_next
        return [zeta_batch, zeta_next_batch]


@dataclass
class ProofTarget:
    wires_cap: MerkleCapTarget
    plonk_zs_partial_products_cap: MerkleCapTarget
    quotient_polys_cap: MerkleCapTarget
    openings: OpeningSetTarget
    opening_proof: FriProofTarget


@dataclass
class ProofWithPublicInputsTarget:
    proof: ProofTarget
    public_inputs: List[Target]


def add_virtual_cap(builder, cap_height: int) -> MerkleCapTarget:
    return MerkleCapTarget(
        [builder.add_virtual_targets(4) for _ in range(1 << cap_height)]
    )


def add_virtual_merkle_proof(builder, path_len: int) -> MerkleProofTarget:
    return MerkleProofTarget(
        [builder.add_virtual_targets(4) for _ in range(path_len)]
    )


def _oracle_leaf_widths(common: CommonCircuitData) -> List[int]:
    return [
        common.num_preprocessed_polys(),
        common.config.num_wires,
        common.num_zs_partial_products_polys() + common.num_all_lookup_polys(),
        common.num_quotient_polys(),
    ]


def add_virtual_fri_proof(builder, common, widths=None) -> FriProofTarget:
    params = common.fri_params
    cap_height = params.config.cap_height
    lde_bits = params.lde_bits

    commit_caps = [
        add_virtual_cap(builder, cap_height) for _ in params.reduction_arity_bits
    ]

    if widths is None:
        widths = _oracle_leaf_widths(common)
    rounds = []
    for _ in range(params.config.num_query_rounds):
        evals_proofs = []
        initial_path_len = lde_bits - cap_height
        for w in widths:
            evals = builder.add_virtual_targets(w)
            mp = add_virtual_merkle_proof(builder, initial_path_len)
            evals_proofs.append((evals, mp))
        steps = []
        bits_left = lde_bits
        for arity_bits in params.reduction_arity_bits:
            bits_left -= arity_bits
            steps.append(
                FriQueryStepTarget(
                    evals=builder.add_virtual_extension_targets(1 << arity_bits),
                    merkle_proof=add_virtual_merkle_proof(
                        builder, bits_left - cap_height
                    ),
                )
            )
        rounds.append(
            FriQueryRoundTarget(FriInitialTreeProofTarget(evals_proofs), steps)
        )

    return FriProofTarget(
        commit_phase_merkle_caps=commit_caps,
        query_round_proofs=rounds,
        final_poly=builder.add_virtual_extension_targets(params.final_poly_len()),
        pow_witness=builder.add_virtual_target(),
    )


def add_virtual_proof_with_pis(builder, common: CommonCircuitData) -> ProofWithPublicInputsTarget:
    cap_height = common.fri_params.config.cap_height
    nc = common.config.num_challenges
    openings = OpeningSetTarget(
        constants=builder.add_virtual_extension_targets(common.num_constants),
        plonk_sigmas=builder.add_virtual_extension_targets(common.config.num_routed_wires),
        wires=builder.add_virtual_extension_targets(common.config.num_wires),
        plonk_zs=builder.add_virtual_extension_targets(nc),
        plonk_zs_next=builder.add_virtual_extension_targets(nc),
        partial_products=builder.add_virtual_extension_targets(nc * common.num_partial_products),
        quotient_polys=builder.add_virtual_extension_targets(common.num_quotient_polys()),
        lookup_zs=builder.add_virtual_extension_targets(common.num_all_lookup_polys()),
        lookup_zs_next=builder.add_virtual_extension_targets(common.num_all_lookup_polys()),
    )
    proof = ProofTarget(
        wires_cap=add_virtual_cap(builder, cap_height),
        plonk_zs_partial_products_cap=add_virtual_cap(builder, cap_height),
        quotient_polys_cap=add_virtual_cap(builder, cap_height),
        openings=openings,
        opening_proof=add_virtual_fri_proof(builder, common),
    )
    public_inputs = builder.add_virtual_targets(common.num_public_inputs)
    return ProofWithPublicInputsTarget(proof, public_inputs)


# ---------------------------------------------------------------------------
# Witness assignment (iop/witness.rs set_proof_with_pis_target)
# ---------------------------------------------------------------------------


def _set_cap(pw, cap_t: MerkleCapTarget, cap) -> None:
    for hs, row in zip(cap_t.hashes, cap):
        for t, v in zip(hs, row):
            pw.set_target(t, int(v))


def _set_ext(pw, et: ExtensionTarget, e) -> None:
    for t, v in zip(et.parts, e):
        pw.set_target(t, int(v))


def _set_exts(pw, ets, es) -> None:
    assert len(ets) == len(es), f"{len(ets)} vs {len(es)}"
    for et, e in zip(ets, es):
        _set_ext(pw, et, e)


def set_proof_with_pis_target(pw, target: ProofWithPublicInputsTarget, proof_with_pis) -> None:
    proof = proof_with_pis.proof
    for t, v in zip(target.public_inputs, proof_with_pis.public_inputs):
        pw.set_target(t, int(v))
    _set_cap(pw, target.proof.wires_cap, proof.wires_cap)
    _set_cap(
        pw,
        target.proof.plonk_zs_partial_products_cap,
        proof.plonk_zs_partial_products_cap,
    )
    _set_cap(pw, target.proof.quotient_polys_cap, proof.quotient_polys_cap)

    o_t, o = target.proof.openings, proof.openings
    _set_exts(pw, o_t.constants, o.constants)
    _set_exts(pw, o_t.plonk_sigmas, o.plonk_sigmas)
    _set_exts(pw, o_t.wires, o.wires)
    _set_exts(pw, o_t.plonk_zs, o.plonk_zs)
    _set_exts(pw, o_t.plonk_zs_next, o.plonk_zs_next)
    _set_exts(pw, o_t.partial_products, o.partial_products)
    _set_exts(pw, o_t.quotient_polys, o.quotient_polys)
    _set_exts(pw, o_t.lookup_zs, o.lookup_zs)
    _set_exts(pw, o_t.lookup_zs_next, o.lookup_zs_next)

    f_t, f = target.proof.opening_proof, proof.opening_proof
    for cap_t, cap in zip(f_t.commit_phase_merkle_caps, f.commit_phase_merkle_caps):
        _set_cap(pw, cap_t, cap)
    for round_t, rnd in zip(f_t.query_round_proofs, f.query_round_proofs):
        for (evals_t, mp_t), (evals, mp) in zip(
            round_t.initial_trees_proof.evals_proofs,
            rnd.initial_trees_proof.evals_proofs,
        ):
            for t, v in zip(evals_t, evals):
                pw.set_target(t, int(v))
            for sib_t, sib in zip(mp_t.siblings, mp.siblings):
                for t, v in zip(sib_t, sib):
                    pw.set_target(t, int(v))
        for step_t, step in zip(round_t.steps, rnd.steps):
            _set_exts(pw, step_t.evals, step.evals)
            for sib_t, sib in zip(step_t.merkle_proof.siblings, step.merkle_proof.siblings):
                for t, v in zip(sib_t, sib):
                    pw.set_target(t, int(v))
    _set_exts(pw, f_t.final_poly, f.final_poly)
    pw.set_target(f_t.pow_witness, int(f.pow_witness))

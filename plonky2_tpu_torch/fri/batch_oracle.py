"""Batch FRI: polynomials of several degrees committed in one
BatchMerkleTree and opened with a single FRI argument that absorbs each
smaller degree group as the fold reaches its size (reference:
plonky2/src/batch_fri/{oracle.rs,prover.rs,verifier.rs};
plonky2_tpu/fri/batch_oracle.py).

Each degree group g holds coefficients [m_g, n_g] on the device; the batch
tree's matrix g is the bit-reversed point-major LDE of group g. Per
instance (one a degree) the opening reduction reuses the single-degree
reduction (fri/oracle.reduce_openings_to_final_poly); the commit phase
folds the largest final polynomial and, where the fold reaches the size of
the next group, sets v' = beta * folded + next on the values and returns
to coefficients by a coset IFFT (prover.rs:88-140). The transcript is the
host Challenger.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from ..field import extension as ge
from ..field import goldilocks as gl
from ..hash.challenger import Challenger
from ..ops import fri_kernels as fk
from ..ops import gf, merkle, ntt
from ..utils.bits import log2_strict, reverse_bits
from .config import FriParams
from .oracle import _on_device, final_poly_lde, reduce_openings_to_final_poly
from .proof import FriInitialTreeProof, FriProof, FriQueryRound
from .prover import _fri_proof_of_work, _refold_values, _rounds_from_gathers
from .structure import FriChallenges, FriInstanceInfo, FriOpenings
from .verifier import (
    PrecomputedReducedOpenings,
    _ensure,
    compute_evaluation,
    fri_combine_initial,
    fri_verify_proof_of_work,
    verify_merkle_proof_to_cap,
)


@dataclass
class _GroupView:
    """Group g of a BatchFriOracle as the opening reduction reads an
    oracle: its polynomials [m_g, n_g]."""

    polynomials: torch.Tensor

    @property
    def num_polys(self) -> int:
        return self.polynomials.shape[0]


@dataclass
class BatchFriOracle:
    """Per-group device coefficients + one batch Merkle commitment."""

    polynomials: List[torch.Tensor]  # per group [m_g, n_g]
    degree_bits: List[int]
    batch_merkle_tree: merkle.BatchDeviceMerkleTree
    rate_bits: int
    blinding: bool

    @staticmethod
    def from_values(
        value_groups: Sequence, rate_bits: int, blinding: bool, cap_height: int, device=None
    ) -> "BatchFriOracle":
        """value_groups: per group [m_g, n_g] subgroup evaluations, as
        tensors or numpy u64 arrays; degrees strictly decreasing.
        device=None means the GPU (raises without one)."""
        device = gf.resolve_device(device)
        coeff_groups = [ntt.ifft(_on_device(v, device)) for v in value_groups]
        return BatchFriOracle.from_coeffs(coeff_groups, rate_bits, blinding, cap_height, device)

    @staticmethod
    def from_coeffs(
        coeff_groups: Sequence, rate_bits: int, blinding: bool, cap_height: int, device=None
    ) -> "BatchFriOracle":
        if blinding:
            raise NotImplementedError("batch oracle blinding not supported yet")
        device = gf.resolve_device(device)
        coeff_groups = [_on_device(c, device) for c in coeff_groups]
        matrices = [fk.lde_leaves(c, rate_bits) for c in coeff_groups]
        tree = merkle.BatchDeviceMerkleTree.build(matrices, cap_height, device)
        return BatchFriOracle(
            polynomials=coeff_groups,
            degree_bits=[log2_strict(c.shape[-1]) for c in coeff_groups],
            batch_merkle_tree=tree,
            rate_bits=rate_bits,
            blinding=blinding,
        )

    def group_view(self, g: int) -> _GroupView:
        """Group g's polynomials, indexed locally by the instances."""
        return _GroupView(self.polynomials[g])


def prove_batch_openings(
    degree_bits: List[int],
    instances: List[FriInstanceInfo],
    oracle,
    challenger: Challenger,
    fri_params: FriParams,
) -> FriProof:
    """BatchFriOracle::prove_openings (oracle.rs:163-230): one reduced
    final polynomial an instance, all under one alpha, then the batch FRI
    argument.

    oracle: a BatchFriOracle, or a list of them (the reference's
    ``oracles: &[&Self]``): instance oracle index t reads group g of
    oracles[t], so a batch STARK commits its traces in one batch tree and
    its quotients in another."""
    oracles = [oracle] if isinstance(oracle, BatchFriOracle) else list(oracle)
    assert len(degree_bits) == len(instances)
    assert degree_bits == sorted(degree_bits, reverse=True)
    alpha = challenger.get_extension_challenge(2)

    final_coeffs = None
    final_values = []
    for g, instance in enumerate(instances):
        assert len(instance.oracles) == len(oracles), (
            "every instance must reference one FriOracleInfo per batch oracle"
        )
        views = [o.group_view(g) for o in oracles]
        final = reduce_openings_to_final_poly(instance, views, alpha)
        coeffs, values = final_poly_lde(final, 1 << (degree_bits[g] + fri_params.config.rate_bits))
        if final_coeffs is None:
            final_coeffs = coeffs
        final_values.append(values)

    return batch_fri_proof(
        [o.batch_merkle_tree for o in oracles], final_coeffs, final_values, challenger, fri_params
    )


def batch_fri_proof(
    batch_trees,
    lde_polynomial_coeffs: torch.Tensor,  # extension [lde_n, 2]
    lde_polynomial_values: List[torch.Tensor],  # per group extension [lde_n_g, 2]
    challenger: Challenger,
    fri_params: FriParams,
) -> FriProof:
    """prover.rs:25-151. batch_trees: one BatchDeviceMerkleTree or a list
    (the initial openings prove against each)."""
    if isinstance(batch_trees, merkle.BatchDeviceMerkleTree):
        batch_trees = [batch_trees]
    n = lde_polynomial_coeffs.shape[0]
    assert lde_polynomial_values[0].shape[0] == n
    sizes = [v.shape[0] for v in lde_polynomial_values]
    assert sizes == sorted(sizes, reverse=True) and len(set(sizes)) == len(sizes)

    # the arity schedule must reach every degree before its last fold
    cur_n = log2_strict(n)
    cur_poly = 1
    for ab in fri_params.reduction_arity_bits:
        cur_n -= ab
        if cur_poly < len(sizes) and cur_n == log2_strict(sizes[cur_poly]):
            cur_poly += 1
    assert cur_poly == len(sizes), "reduction arities never reach some degree group"

    trees, final_poly = _batch_fri_committed_trees(
        lde_polynomial_coeffs, lde_polynomial_values, challenger, fri_params
    )
    for c in final_poly:
        challenger.observe_extension_element(c)
    pow_witness = _fri_proof_of_work(challenger, fri_params.config, lde_polynomial_coeffs.device)
    query_indices = [
        c % n for c in challenger.get_n_challenges(fri_params.config.num_query_rounds)
    ]
    return FriProof(
        commit_phase_merkle_caps=[t.cap_u64() for t in trees],
        query_round_proofs=_batch_query_rounds(batch_trees, trees, query_indices, fri_params),
        final_poly=final_poly,
        pow_witness=pow_witness,
    )


def _batch_fri_committed_trees(
    coeffs: torch.Tensor,
    values_list: List[torch.Tensor],
    challenger: Challenger,
    fri_params: FriParams,
):
    trees = []
    shift = gl.MULTIPLICATIVE_GROUP_GENERATOR
    poly_index = 1
    values = values_list[0]
    arities = fri_params.reduction_arity_bits
    device = coeffs.device
    for step, arity_bits in enumerate(arities):
        arity = 1 << arity_bits
        tree = fk.commit_phase_tree(values, arity_bits, fri_params.config.cap_height)
        challenger.observe_cap(tree.cap_u64())
        trees.append(tree)

        beta = challenger.get_extension_challenge(2)
        beta_pows = [ge.ext_one(2)]
        for _ in range(arity - 1):
            beta_pows.append(ge.ext_mul(beta_pows[-1], beta))
        coeffs = fk.fold_coeffs(
            coeffs, gf.from_u64(np.array(beta_pows, dtype=np.uint64), device), arity_bits
        )
        if step + 1 == len(arities):
            continue
        shift = gl.gexp(shift, arity)
        values = _refold_values(coeffs, shift)
        if poly_index != len(values_list) and values.shape[0] == values_list[poly_index].shape[0]:
            # absorb the next degree group: v' = beta * folded + next
            # (prover.rs:127-139), then back to coefficients on the coset
            scaled = gf.ext2_mul(values, gf.ext2_const(beta, device)[None])
            values = gf.add(scaled, values_list[poly_index])
            poly_index += 1
            coeffs = _coset_ifft_ext(values, shift)
    assert poly_index == len(values_list)

    final_len = coeffs.shape[0] >> fri_params.config.rate_bits
    final_poly = [(int(a), int(b)) for a, b in gf.to_u64(coeffs[:final_len])]
    return trees, final_poly


def _coset_ifft_ext(values: torch.Tensor, shift: int) -> torch.Tensor:
    """Extension values [N, 2] on the coset shift*H -> coefficients [N, 2]
    (the two base components transform apart)."""
    return ntt.coset_ifft(values.T.contiguous(), shift).T.contiguous()


def _batch_query_rounds(
    batch_trees: List[merkle.BatchDeviceMerkleTree],
    trees: List[merkle.DeviceMerkleTree],
    query_indices: List[int],
    fri_params: FriParams,
) -> List[FriQueryRound]:
    """Every leaf row and path gathered on the device and read back in one
    transfer. A batch tree's opened row is its matrices' rows concatenated,
    tallest first."""
    qi = torch.from_numpy(np.array(query_indices, dtype=np.int64)).to(batch_trees[0].cap.device)
    gathered = [
        (torch.cat(bt.leaf_rows_device(qi), dim=1), bt.sibling_paths_device(qi))
        for bt in batch_trees
    ]
    xi = qi
    for tree, arity_bits in zip(trees, fri_params.reduction_arity_bits):
        xi = xi >> arity_bits
        gathered.append((tree.leaf_rows_device(xi), tree.sibling_paths_device(xi)))
    flat = gf.to_u64(torch.cat([x.reshape(-1) for pair in gathered for x in pair]))
    host, pos = [], 0
    for rows, paths in gathered:
        r = flat[pos : pos + rows.numel()].reshape(rows.shape)
        pos += rows.numel()
        p = flat[pos : pos + paths.numel()].reshape(paths.shape)
        pos += paths.numel()
        host.append((r, p))
    num_init = len(batch_trees)
    return _rounds_from_gathers(host[:num_init], host[num_init:], len(query_indices))


# ---------------------------------------------------------------------------
# Verifier (batch_fri/verifier.rs:24-250), on the host
# ---------------------------------------------------------------------------


def verify_batch_fri_proof(
    degree_bits: List[int],
    instances: List[FriInstanceInfo],
    openings_list: List[FriOpenings],
    challenges: FriChallenges,
    initial_merkle_cap,
    leaf_heights,
    proof: FriProof,
    params: FriParams,
    hasher=None,
) -> None:
    """initial_merkle_cap / leaf_heights: one cap (np [2^h, 4]) and one
    height list per batch oracle; a bare cap / flat height list means a
    single shared oracle."""
    if isinstance(initial_merkle_cap, np.ndarray):
        initial_merkle_caps = [initial_merkle_cap]
    else:
        initial_merkle_caps = list(initial_merkle_cap)
    if leaf_heights and not isinstance(leaf_heights[0], (list, tuple)):
        leaf_heights = [list(leaf_heights)]
    else:
        leaf_heights = [list(h) for h in leaf_heights]
    fri_verify_proof_of_work(challenges.fri_pow_response, params.config)
    _ensure(
        params.config.num_query_rounds == len(proof.query_round_proofs),
        "Number of query rounds does not match config",
    )
    precomputed = [PrecomputedReducedOpenings(o, challenges.fri_alpha) for o in openings_list]
    lde_bits = [d + params.config.rate_bits for d in degree_bits]
    for x_index, round_proof in zip(challenges.fri_query_indices, proof.query_round_proofs):
        _batch_verifier_query_round(
            lde_bits, instances, challenges, precomputed, initial_merkle_caps, leaf_heights,
            proof, x_index, round_proof, params, hasher,
        )


def _split_initial_rows(
    instances: List[FriInstanceInfo], evals_list: List[List[int]]
) -> List[List[int]]:
    """Per-oracle flat leaf values -> per-instance rows (verifier.rs:90-103):
    instance g's row is its (oracle t, group g) slices concatenated over
    the oracles, the contiguous-per-oracle layout fri_combine_initial
    reads."""
    T = len(evals_list)
    offsets = [0] * T
    out = []
    for inst in instances:
        _ensure(len(inst.oracles) == T, "instance/oracle-count mismatch")
        row: List[int] = []
        for t in range(T):
            num = inst.oracles[t].num_polys
            row.extend(evals_list[t][offsets[t] : offsets[t] + num])
            offsets[t] += num
        out.append(row)
    for t in range(T):
        _ensure(offsets[t] == len(evals_list[t]), "leaf width mismatch")
    return out


def _subgroup_x(x_index: int, n_log: int) -> int:
    """shift * w^rev(x_index), w the primitive 2^n_log-th root."""
    return gl.gmul(
        gl.MULTIPLICATIVE_GROUP_GENERATOR,
        gl.gexp(gl.primitive_root_of_unity(n_log), reverse_bits(x_index, n_log)),
    )


def _batch_verifier_query_round(
    lde_bits: List[int],
    instances: List[FriInstanceInfo],
    challenges: FriChallenges,
    precomputed: List[PrecomputedReducedOpenings],
    initial_merkle_caps: List[np.ndarray],
    leaf_heights: List[List[int]],
    proof: FriProof,
    x_index: int,
    round_proof: FriQueryRound,
    params: FriParams,
    hasher,
) -> None:
    _ensure(
        len(round_proof.initial_trees_proof.evals_proofs) == len(initial_merkle_caps),
        "initial proof count does not match batch oracle count",
    )
    for t, (evals, mproof) in enumerate(round_proof.initial_trees_proof.evals_proofs):
        # tree t's flat leaf split back into its per-group rows
        tree_rows = []
        pos = 0
        for inst in instances:
            num = inst.oracles[t].num_polys
            tree_rows.append(evals[pos : pos + num])
            pos += num
        _ensure(pos == len(evals), "leaf width mismatch")
        _ensure(
            merkle.verify_batch_merkle_proof_to_cap(
                tree_rows, leaf_heights[t], x_index, initial_merkle_caps[t],
                mproof.siblings, hasher=hasher,
            ),
            f"batch Merkle proof {t} does not match cap",
        )
    rows = _split_initial_rows(
        instances, [ep[0] for ep in round_proof.initial_trees_proof.evals_proofs]
    )

    n = lde_bits[0]
    subgroup_x = _subgroup_x(x_index, n)
    old_eval = _combine_instance(
        instances[0], rows[0], challenges.fri_alpha, subgroup_x, precomputed[0]
    )
    batch_index = 1

    for i, arity_bits in enumerate(params.reduction_arity_bits):
        arity = 1 << arity_bits
        step_evals = round_proof.steps[i].evals
        coset_index = x_index >> arity_bits
        x_in_coset = x_index & (arity - 1)
        _ensure(
            tuple(step_evals[x_in_coset]) == tuple(old_eval),
            "batch FRI fold consistency check failed",
        )
        old_eval = compute_evaluation(
            subgroup_x, x_in_coset, arity_bits, step_evals, challenges.fri_betas[i]
        )
        verify_merkle_proof_to_cap(
            [c for e in step_evals for c in e],
            coset_index,
            proof.commit_phase_merkle_caps[i],
            round_proof.steps[i].merkle_proof,
            hasher=hasher,
        )
        subgroup_x = gl.exp_power_of_2(subgroup_x, arity_bits)
        x_index = coset_index
        n -= arity_bits

        if batch_index < len(lde_bits) and n == lde_bits[batch_index]:
            eval2 = _combine_instance(
                instances[batch_index], rows[batch_index], challenges.fri_alpha,
                _subgroup_x(x_index, n), precomputed[batch_index],
            )
            old_eval = ge.ext_add(ge.ext_mul(old_eval, challenges.fri_betas[i]), eval2)
            batch_index += 1

    _ensure(batch_index == len(instances), "wrong number of folded instances")
    expected = _eval_final(proof.final_poly, ge.from_base(subgroup_x, 2))
    _ensure(
        tuple(expected) == tuple(old_eval),
        "batch FRI final polynomial evaluation is invalid",
    )


@dataclass
class _NoLeafHiding:
    leaf_hiding: bool = False


def _combine_instance(instance, row_evals, alpha, subgroup_x, precomputed):
    """fri_combine_initial over one instance's row: oracle i's evaluations
    are a contiguous slice of it."""
    pos = 0
    ep = []
    for o in instance.oracles:
        ep.append((row_evals[pos : pos + o.num_polys], None))
        pos += o.num_polys
    return fri_combine_initial(
        instance, FriInitialTreeProof(evals_proofs=ep), alpha, subgroup_x, precomputed,
        _NoLeafHiding(),
    )


def _eval_final(final_poly, x):
    acc = ge.ext_zero(2)
    for c in reversed(final_poly):
        acc = ge.ext_add(ge.ext_mul(acc, x), c)
    return acc

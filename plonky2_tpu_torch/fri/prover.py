"""FRI proof generation: commit-phase folds, PoW grind, query rounds
(reference: plonky2/src/fri/prover.rs:24-268).

Two forms give the same bytes. The fused form (the default for Poseidon
proofs over device trees) runs the whole proof on the device with the
transcript in a DeviceChallenger and reads the host once, plus one flag a
PoW chunk. The unfused form drives a host Challenger and reads every cap,
the final polynomial and the gathers back as it goes; it is the one form
of the other hashers: Poseidon2 commits and grinds on the device, Keccak
commits and grinds on the host.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..field import extension as ge
from ..field import goldilocks as gl
from ..hash.challenger import Challenger
from ..hash.device_challenger import DeviceChallenger, DeviceChallengerState
from ..hash.poseidon import NUM_HASH_OUT_ELTS, SPONGE_RATE
from ..ops import fri_kernels as fk
from ..ops import gf, merkle
from .config import FriConfig, FriParams
from .proof import (
    FriInitialTreeProof,
    FriProof,
    FriQueryRound,
    FriQueryStep,
    MerkleProof,
)

Tree = Union[merkle.DeviceMerkleTree, merkle.ShardedMerkleTree, merkle.HostMerkleTree]
DEVICE_TREES = (merkle.DeviceMerkleTree, merkle.ShardedMerkleTree)


def fri_proof(
    initial_merkle_trees: Sequence[Tree],
    lde_polynomial_coeffs: torch.Tensor,  # extension [lde_n, 2]
    lde_polynomial_values: torch.Tensor,  # extension [lde_n, 2]
    challenger: Challenger,
    fri_params: FriParams,
    final_poly_coeff_len: Optional[int] = None,
    max_num_query_steps: Optional[int] = None,
    hasher=None,
    fused: Optional[bool] = None,
) -> FriProof:
    """fused=None takes the fused form wherever it applies: a Poseidon
    hasher, device trees, and neither final_poly_coeff_len nor
    max_num_query_steps (the padding of unified recursion), under a prover
    mesh too (its trees' rows and paths are routed to the shards that hold
    them, and the fused form is the reference's default there). fused=False takes the unfused
    form; fused=True raises where the fused one does not apply."""
    n = lde_polynomial_values.shape[0]
    assert lde_polynomial_coeffs.shape[0] == n
    fusable = (
        (hasher is None or hasher.name == "poseidon")
        and final_poly_coeff_len is None
        and max_num_query_steps is None
        and all(isinstance(t, DEVICE_TREES) for t in initial_merkle_trees)
    )
    if fused and not fusable:
        raise ValueError(
            "the fused FRI proof takes a Poseidon hasher, no recursion padding and only device trees"
        )
    if fusable and fused is not False:
        return _fused_fri_proof(
            initial_merkle_trees,
            lde_polynomial_coeffs,
            lde_polynomial_values,
            challenger,
            fri_params,
        )

    # Commit phase
    trees, final_poly = _fri_committed_trees(
        lde_polynomial_coeffs,
        lde_polynomial_values,
        challenger,
        fri_params,
        max_num_query_steps,
        hasher,
    )

    # Observe final polynomial (+ zero padding for unified recursion)
    for c in final_poly:
        challenger.observe_extension_element(c)
    if final_poly_coeff_len is not None:
        for _ in range(len(final_poly), final_poly_coeff_len):
            challenger.observe_extension_element((0, 0))

    # PoW phase
    pow_witness = _fri_proof_of_work(
        challenger, fri_params.config, lde_polynomial_values.device, hasher
    )

    # Query phase
    query_indices = [
        c % n for c in challenger.get_n_challenges(fri_params.config.num_query_rounds)
    ]
    query_rounds = _query_rounds(initial_merkle_trees, trees, query_indices, fri_params)

    return FriProof(
        commit_phase_merkle_caps=[t.cap_u64() for t in trees],
        query_round_proofs=query_rounds,
        final_poly=final_poly,
        pow_witness=pow_witness,
    )


def _fused_fri_proof(
    initial_merkle_trees: Sequence[Tree],
    coeffs: torch.Tensor,
    values: torch.Tensor,
    challenger,
    fri_params: FriParams,
    extra_flat: Optional[torch.Tensor] = None,
):
    """The whole FRI proof on the device (reference fri/prover.py:170-477
    _fused_fri_fn/_fused_fri_proof): per commit round the tree, the cap
    observation and beta squeeze on a DeviceChallenger, the fold and the
    re-evaluation; the final-poly observation; the PoW grind; the query
    squeeze; every leaf and sibling-path gather. challenger: a host
    Challenger (left at its pre-FRI state: nothing reads it after the FRI
    proof) or a DeviceChallengerState whose state never left the device.

    Everything comes back in ONE transfer: caps | final poly | PoW witness
    | each tree's gathered rows and paths | extra_flat. extra_flat is a 1-D
    tensor of the caller's own device words; with it, returns (proof, its
    words as host u64) instead of the proof."""
    config = fri_params.config
    n = values.shape[0]
    if isinstance(challenger, DeviceChallengerState):
        dc = DeviceChallenger.from_state(challenger)
    else:
        dc = DeviceChallenger.from_host(challenger, values.device)

    # commit phase (fri/prover.rs:66-128)
    trees = []
    shift = gl.MULTIPLICATIVE_GROUP_GENERATOR
    arities = fri_params.reduction_arity_bits
    for step, arity_bits in enumerate(arities):
        tree = fk.commit_phase_tree(values, arity_bits, config.cap_height)
        trees.append(tree)
        dc.observe_cap_rows(tree.cap)
        beta = dc.get_extension_challenge()
        coeffs = fk.fold_coeffs(coeffs, gf.ext2_powers_scan(beta, 1 << arity_bits), arity_bits)
        if step + 1 != len(arities):
            shift = gl.gexp(shift, 1 << arity_bits)
            values = _refold_values(coeffs, shift)
    final = coeffs[: coeffs.shape[0] >> config.rate_bits]
    dc.observe_elements(final)

    # PoW grind on the duplex state with the pending inputs overlaid
    witness, _ = fk.pow_grind_device(
        dc.overlaid_state(), dc.in_len, config.proof_of_work_bits
    )
    dc.observe_elements(witness.reshape(1))
    dc.get_challenge()  # the PoW response, checked by the verifier

    # query indices: challenge mod lde_n, a power of two -> the low bits
    xi = dc.get_n_challenges(config.num_query_rounds) & (n - 1)
    gathers = [(t, xi) for t in initial_merkle_trees]
    for tree, arity_bits in zip(trees, arities):
        xi = xi >> arity_bits
        gathers.append((tree, xi))
    gathered = [(t.leaf_rows_device(i), t.sibling_paths_device(i)) for t, i in gathers]

    parts = [t.cap.reshape(-1) for t in trees] + [final.reshape(-1), witness.reshape(1)]
    for rows, paths in gathered:
        parts += [rows.reshape(-1), paths.reshape(-1)]
    if extra_flat is not None:
        parts.append(extra_flat)
    flat = gf.to_u64(torch.cat(parts))  # the one read

    pos = 0
    caps = []
    for t in trees:
        m = t.cap.numel()
        caps.append(flat[pos : pos + m].reshape(-1, 4))
        pos += m
    final_poly = [(int(a), int(b)) for a, b in flat[pos : pos + final.numel()].reshape(-1, 2)]
    pos += final.numel()
    pow_witness = int(flat[pos])
    pos += 1
    gathered_np = []
    for rows, paths in gathered:
        r = flat[pos : pos + rows.numel()].reshape(rows.shape)
        pos += rows.numel()
        p = flat[pos : pos + paths.numel()].reshape(paths.shape)
        pos += paths.numel()
        gathered_np.append((r, p))
    num_init = len(initial_merkle_trees)
    proof = FriProof(
        commit_phase_merkle_caps=caps,
        query_round_proofs=_rounds_from_gathers(
            gathered_np[:num_init], gathered_np[num_init:], config.num_query_rounds
        ),
        final_poly=final_poly,
        pow_witness=pow_witness,
    )
    if extra_flat is not None:
        return proof, flat[pos:]
    return proof


def _refold_values(coeffs: torch.Tensor, shift: int) -> torch.Tensor:
    """Re-evaluate folded extension coefficients [n, 2] on the coset
    shift*H of their own size."""
    return fk.ext_coset_fft(coeffs, shift)


def _fri_committed_trees(
    coeffs: torch.Tensor,
    values: torch.Tensor,
    challenger: Challenger,
    fri_params: FriParams,
    max_num_query_steps: Optional[int],
    hasher=None,
):
    trees: List[Tree] = []
    shift = gl.MULTIPLICATIVE_GROUP_GENERATOR
    arities = fri_params.reduction_arity_bits
    for step, arity_bits in enumerate(arities):
        arity = 1 << arity_bits
        tree = fk.commit_phase_tree(
            values, arity_bits, fri_params.config.cap_height, hasher=hasher
        )
        challenger.observe_cap(tree.cap_u64())
        trees.append(tree)

        beta = challenger.get_extension_challenge(2)
        beta_pows = [ge.ext_one(2)]
        for _ in range(arity - 1):
            beta_pows.append(ge.ext_mul(beta_pows[-1], beta))
        coeffs = fk.fold_coeffs(
            coeffs,
            gf.from_u64(np.array(beta_pows, dtype=np.uint64), coeffs.device),
            arity_bits,
        )
        if step + 1 == len(arities):
            continue
        shift = gl.gexp(shift, arity)
        values = _refold_values(coeffs, shift)

    # Zero-cap padding rounds for unified recursion
    if max_num_query_steps is not None:
        zero_cap = [[0] * NUM_HASH_OUT_ELTS] * (1 << fri_params.config.cap_height)
        for _ in range(len(arities), max_num_query_steps):
            challenger.observe_cap(zero_cap)
            challenger.get_extension_challenge(2)

    # Drop the (all-zero) LDE padding coefficients
    final_len = coeffs.shape[0] >> fri_params.config.rate_bits
    fc = gf.to_u64(coeffs[:final_len])
    final_poly = [(int(a), int(b)) for a, b in fc]
    return trees, final_poly


def _fri_proof_of_work(challenger: Challenger, config: FriConfig, device, hasher=None) -> int:
    """Deterministic grind: the smallest witness w with >= pow_bits leading
    zeros in the duplex response (prover.rs:159-208; find_any replaced by a
    batched device scan that returns the first hit). Poseidon and Poseidon2
    grind on ``device`` with their batched permutations; any other
    challenger permutation (Keccak's) grinds on the host."""
    state = list(challenger.sponge_state)
    witness_pos = len(challenger.input_buffer)
    for i, x in enumerate(challenger.input_buffer):
        state[i] = x
    bits = config.proof_of_work_bits
    name = "poseidon" if hasher is None else hasher.name
    if name == "poseidon":
        witness = fk.pow_grind(state, witness_pos, bits, device)
    elif name == "poseidon2":
        from ..hash import poseidon2 as p2

        witness = fk.pow_grind(state, witness_pos, bits, device, p2.permute_batch)
    else:
        witness = _host_pow_grind(state, witness_pos, bits, hasher.permutation)
    # Confirm via the real transcript (also advances it)
    challenger.observe_element(witness)
    response = challenger.get_challenge()
    assert _leading_zeros64(response) >= config.proof_of_work_bits
    return witness


def _leading_zeros64(x: int) -> int:
    return 64 - x.bit_length() if x else 64


def _host_pow_grind(state, witness_pos: int, pow_bits: int, permutation) -> int:
    """The smallest witness, one host permutation a candidate."""
    w = 0
    while True:
        trial = list(state)
        trial[witness_pos] = w
        out = permutation(trial)
        if _leading_zeros64(out[SPONGE_RATE - 1]) >= pow_bits:
            return w
        w += 1


def _gather_all_trees(gathers):
    """[(tree, indices)] -> [(leaf_rows [Q, w], sib_paths [Q, L, 4])] as
    host u64 arrays; one device->host copy of rows and one of paths per
    tree."""
    return [
        (tree.leaf_u64_batch(idx), tree.prove_batch(idx)) for tree, idx in gathers
    ]


def _query_rounds(
    initial_trees: Sequence[Tree],
    trees: Sequence[Tree],
    query_indices: Sequence[int],
    fri_params: FriParams,
) -> List[FriQueryRound]:
    """All query rounds extracted with batched gathers: one leaf-gather and
    one path-gather per tree (instead of per query x per sibling), keeping
    the host<->device round trips independent of the query count
    (prover.rs:210-268)."""
    qi = np.array(query_indices, dtype=np.int64)
    gathers = []
    for t in initial_trees:
        gathers.append((t, qi))
    xi = qi
    for i, arity_bits in enumerate(fri_params.reduction_arity_bits):
        coset = xi >> arity_bits
        gathers.append((trees[i], coset))
        xi = coset
    all_rows = _gather_all_trees(gathers)
    return _rounds_from_gathers(
        all_rows[: len(initial_trees)], all_rows[len(initial_trees) :], len(query_indices)
    )


def _rounds_from_gathers(init_data, step_data, num_queries: int) -> List[FriQueryRound]:
    """Query rounds from host gathers: per initial tree and per commit
    tree, (leaf rows [Q, w], sibling paths [Q, L, 4]) as u64 arrays."""
    rounds = []
    for q in range(num_queries):
        evals_proofs = [
            (
                [int(v) for v in leaves[q]],
                MerkleProof([tuple(int(x) for x in s) for s in sibs[q]]),
            )
            for leaves, sibs in init_data
        ]
        steps = []
        for (leaves, sibs) in step_data:
            flat = [int(v) for v in leaves[q]]
            evals = [tuple(flat[2 * k : 2 * k + 2]) for k in range(len(flat) // 2)]
            steps.append(
                FriQueryStep(
                    evals=evals,
                    merkle_proof=MerkleProof(
                        [tuple(int(x) for x in s) for s in sibs[q]]
                    ),
                )
            )
        rounds.append(
            FriQueryRound(
                initial_trees_proof=FriInitialTreeProof(evals_proofs=evals_proofs),
                steps=steps,
            )
        )
    return rounds

"""The PLONK prover (reference: plonky2/src/plonk/prover.rs:144-392).

The host drives witness generation; all O(N) math — wire/Z/quotient
polynomial construction, commitments, FRI — runs as tensor ops and
kernels on the device. After the witness, the Fiat-Shamir transcript runs
on the device by default (plonk/device_transcript.py: no host read until
the proof is assembled); ``device_transcript=False`` runs it on the host
(this module), reading every cap and the openings back as it goes. Both
give the same bytes.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..field import extension as ge
from ..field import goldilocks as gl
from ..fri import oracle as fo
from ..hash.challenger import Challenger
from ..iop.generator import generate_partial_witness
from ..iop.witness import PartialWitness
from ..ops import fri_kernels as fk
from ..ops import gf, merkle, ntt
from ..ops.bitrev import bitrev_axis, bitrev_perm
from ..parallel import context as pctx
from ..utils import profiling as prof
from ..utils.bits import reverse_index_bits_perm
from . import device_transcript as dt
from .circuit_data import (
    ORACLE_BLINDING,
    ORACLE_QUOTIENT,
    ORACLE_WIRES,
    ORACLE_ZS_PARTIAL_PRODUCTS,
    CommonCircuitData,
    ProverOnlyCircuitData,
)
from .proof import OpeningSet, Proof, ProofWithPublicInputs
from .vanishing import NUM_COINS_LOOKUP, quotient_values_fn

Ext = Tuple[int, int]


def prove(
    prover_data: ProverOnlyCircuitData,
    common: CommonCircuitData,
    inputs: PartialWitness,
    gc=None,
    device=None,
    device_transcript: Optional[bool] = None,
) -> ProofWithPublicInputs:
    """gc: GenericConfig hasher bundle (the reference's `C` type
    parameter); defaults to PoseidonGoldilocksConfig. device: where the
    proof is computed — None means the GPU (raises without one); it must
    be where the circuit's constants/sigmas commitment was built.
    device_transcript: None runs the transcript on the device wherever
    device_transcript.eligible allows it, True requires that, False runs
    it on the host."""
    from .generic_config import poseidon_goldilocks_config

    gc = gc or poseidon_goldilocks_config()
    hasher = gc.hasher
    config = common.config
    nc = config.num_challenges
    fri_config = config.fri_config
    device = gf.resolve_device(device)
    cs_commitment = prover_data.constants_sigmas_commitment
    if cs_commitment.device.type != device.type:
        raise ValueError(
            f"circuit was built on {cs_commitment.device}, "
            f"prove was asked for {device}"
        )
    # 1. witness generation (host fixpoint)
    with prof.annotate("prove/witness"):
        partition_witness = generate_partial_witness(inputs, prover_data, common)
    set_lookup_wires(prover_data, common, partition_witness)
    public_inputs = partition_witness.get_targets(prover_data.public_inputs)
    public_inputs_hash = gc.inner_hasher.hash_no_pad(public_inputs)
    witness = partition_witness.full_witness()

    if device_transcript is None:
        device_transcript = dt.eligible(common, gc)
    elif device_transcript and not dt.eligible(common, gc):
        raise ValueError("the device transcript takes a Poseidon hasher")
    if device_transcript:
        with prof.annotate("prove/device-transcript"):
            return dt.prove_device_transcript(
                prover_data, common, witness, public_inputs, public_inputs_hash, gc, device
            )

    # 2. oracle 1 — wires
    wires_dev = gf.from_u64(witness.wire_values, device)  # [num_wires, n]
    with prof.annotate("prove/commit-wires"):
        wires_commitment = fo.PolynomialBatch.from_values(
            wires_dev,
            fri_config.rate_bits,
            common.config.zero_knowledge and ORACLE_BLINDING[ORACLE_WIRES],
            fri_config.cap_height,
            hasher=hasher,
            device=device,
        )

    # 3. Fiat-Shamir head (Appendix A order)
    challenger = Challenger(permutation=hasher.permutation)
    common.fri_params.observe(challenger)
    challenger.observe_hash(prover_data.circuit_digest)
    challenger.observe_hash(public_inputs_hash)
    challenger.observe_cap(wires_commitment.cap_u64())
    betas = challenger.get_n_challenges(nc)
    gammas = challenger.get_n_challenges(nc)
    has_lookup = common.num_lookup_polys != 0
    deltas = None
    if has_lookup:
        # deltas = betas ++ gammas ++ the extra coins (prover.rs:232-245)
        additional = challenger.get_n_challenges(NUM_COINS_LOOKUP * nc - 2 * nc)
        deltas = _u64_tensor(betas + gammas + additional, device)
    betas = _u64_tensor(betas, device)
    gammas = _u64_tensor(gammas, device)

    # 4. permutation argument: Z + partial products, then the lookup
    # polynomials
    with prof.annotate("prove/zs-partial-products"):
        zs_pp = _zs_and_partial_products(wires_dev, betas, gammas, prover_data, common)
    if has_lookup:
        zs_pp = torch.cat([zs_pp, _lookup_polys_device(wires_dev, deltas, prover_data, common)])
    zs_pp_commitment = fo.PolynomialBatch.from_values(
        zs_pp,
        fri_config.rate_bits,
        common.config.zero_knowledge and ORACLE_BLINDING[ORACLE_ZS_PARTIAL_PRODUCTS],
        fri_config.cap_height,
        hasher=hasher,
        device=device,
    )
    challenger.observe_cap(zs_pp_commitment.cap_u64())
    alphas = _u64_tensor(challenger.get_n_challenges(nc), device)

    # 5. quotient (over the whole coset)
    with prof.annotate("prove/quotient"):
        quotient_chunks = _compute_quotient_polys(
            common,
            prover_data,
            public_inputs_hash,
            wires_commitment,
            zs_pp_commitment,
            betas,
            gammas,
            alphas,
            deltas,
        )
    quotient_commitment = fo.PolynomialBatch.from_coeffs(
        quotient_chunks,
        fri_config.rate_bits,
        common.config.zero_knowledge and ORACLE_BLINDING[ORACLE_QUOTIENT],
        fri_config.cap_height,
        hasher=hasher,
        device=device,
    )
    challenger.observe_cap(quotient_commitment.cap_u64())

    # 6. zeta + openings
    zeta = challenger.get_extension_challenge(2)
    n_bits = common.degree_bits
    assert ge.ext_exp(zeta, 1 << n_bits) != ge.ext_one(2), "zeta in subgroup"

    oracles = [
        cs_commitment,
        wires_commitment,
        zs_pp_commitment,
        quotient_commitment,
    ]
    g = gl.primitive_root_of_unity(n_bits)
    zeta_next = ge.ext_scalar_mul(zeta, g)
    openings = _opening_set(common, fo.eval_commitments_at(oracles, zeta, zeta_next))
    fri_openings = openings.to_fri_openings()
    for batch in fri_openings.batches:
        challenger.observe_extension_elements(batch.values)

    # 7. FRI opening proof
    instance = common.get_fri_instance(zeta)
    with prof.annotate("prove/fri"):
        opening_proof = fo.prove_openings(
            instance, oracles, challenger, common.fri_params, hasher=hasher
        )

    proof = Proof(
        wires_cap=wires_commitment.cap_u64(),
        plonk_zs_partial_products_cap=zs_pp_commitment.cap_u64(),
        quotient_polys_cap=quotient_commitment.cap_u64(),
        openings=openings,
        opening_proof=opening_proof,
    )
    return ProofWithPublicInputs(proof, public_inputs)


def _opening_set(common, evals) -> OpeningSet:
    """The proof's openings from the values of the four oracles
    (constants/sigmas, wires, Zs/partial products, quotient) at zeta, then
    at g*zeta: eight lists of extension tuples (fri/oracle.split_evals)."""
    cs_evals, wires_evals, zs_pp_evals, q_evals, _, _, zs_pp_next_evals, _ = evals
    nc = common.config.num_challenges
    nzs = common.num_zs_partial_products_polys()
    return OpeningSet(
        constants=cs_evals[common.constants_range().start : common.constants_range().stop],
        plonk_sigmas=cs_evals[common.sigmas_range().start : common.sigmas_range().stop],
        wires=wires_evals,
        plonk_zs=zs_pp_evals[:nc],
        plonk_zs_next=zs_pp_next_evals[:nc],
        partial_products=zs_pp_evals[nc:nzs],
        quotient_polys=q_evals,
        lookup_zs=zs_pp_evals[nzs:],
        lookup_zs_next=zs_pp_next_evals[nzs:],
    )


def _u64_tensor(values: List[int], device) -> torch.Tensor:
    """Host words (challenges, the public-inputs hash) as an [n] tensor:
    the form both transcripts hand to the permutation argument and the
    quotient."""
    return gf.from_u64(np.array(values, dtype=np.uint64), device)


# ---------------------------------------------------------------------------
# Permutation argument (prover.rs:396-480) on device. Sequential-looking
# prefix products become log-doubling scans; the row quotient computation
# is one batched inverse.
# ---------------------------------------------------------------------------


def _zs_tables(prover_data, common, device):
    """Witness-independent [n, nr] tables (sigmas, s_id = k_i * subgroup),
    memoized on the prover data per device."""
    cache = prover_data.__dict__.setdefault("_zs_tables", {})
    key = str(device)
    if key not in cache:
        sigmas = gf.from_u64(np.ascontiguousarray(prover_data.sigmas), device)
        s_id = gf.from_u64(
            gl.np_mul(
                np.array(common.k_is, dtype=np.uint64)[None, :],
                prover_data.subgroup[:, None],
            ),
            device,
        )
        cache[key] = (sigmas, s_id)
    return cache[key]


def _inclusive_prefix_products(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Running product along ``dim`` by log-doubling."""
    x = torch.movedim(x, dim, 0).clone()
    shift = 1
    while shift < x.shape[0]:
        x[shift:] = gf.mul(x[shift:], x[:-shift])
        shift <<= 1
    return torch.movedim(x, 0, dim)


def _zs_and_partial_products(wires_dev, betas, gammas, prover_data, common) -> torch.Tensor:
    """wires_dev: [num_wires, n] tensor; betas/gammas: [nc] challenge
    tensors on its device.
    Returns [(1 + num_prods) * nc, n]: all Z columns, then the partial
    products per challenge."""
    config = common.config
    nr = config.num_routed_wires
    n = common.degree
    chunk = common.permutation_partial_product_degree()
    num_prods = common.num_partial_products
    device = wires_dev.device
    wires = wires_dev[:nr].T  # [n, nr]
    sigmas, s_id = _zs_tables(prover_data, common, device)

    z_cols = []
    pp_cols = []
    for beta, gamma in zip(betas, gammas):
        numer = gf.add(gf.add(wires, gf.mul(s_id, beta)), gamma)
        denom = gf.add(gf.add(wires, gf.mul(sigmas, beta)), gamma)
        quot = gf.mul(numer, gf.batch_inverse(denom))  # [n, nr]
        # chunk products [n, nr/chunk], then inclusive prefix products
        cp = gf.prod_mod_p(quot.reshape(n, nr // chunk, chunk), axis=2)
        cum = _inclusive_prefix_products(cp, dim=1)
        row_prod = cum[:, -1]  # [n]
        # exclusive prefix product over rows -> Z values
        z = _inclusive_prefix_products(
            torch.cat([gf.ones((1,), device), row_prod[:-1]]), dim=0
        )
        # partial products: z[i] * cum[i, k] for k < num_prods
        pps = gf.mul(z[:, None], cum[:, :num_prods])  # [n, num_prods]
        z_cols.append(z)
        pp_cols.append(pps)

    return torch.cat([torch.stack(z_cols)] + [p.T for p in pp_cols]).contiguous()


# ---------------------------------------------------------------------------
# Quotient computation
# ---------------------------------------------------------------------------


def _natural_order_values(batch: fo.PolynomialBatch, step: int = 1) -> torch.Tensor:
    """Leaves are bit-reversed point-major [lde_n, M]; return poly-major
    natural order [M, lde_n // step], stripping any zk salt columns.
    step > 1 samples the committed high-rate LDE down to the lower-rate
    coset (fri/oracle.rs:286-292 get_lde_values with step). A tree kept
    on a mesh's shards (a circuit built under one) is read by index."""
    tree = batch.merkle_tree
    if isinstance(tree, merkle.ShardedMerkleTree):
        nat = tree.leaf_rows_device(bitrev_perm(tree.num_leaves, tree.device)[::step]).T
        return (nat[: -batch.salt_size] if batch.salt_size else nat).contiguous()
    leaves = tree.leaves
    if step != 1:
        perm = bitrev_perm(leaves.shape[0], leaves.device)[::step]
        nat = leaves[perm].T
    else:
        nat = bitrev_axis(leaves, axis=0).T
    if batch.salt_size:
        nat = nat[: -batch.salt_size]
    return nat.contiguous()


@lru_cache(maxsize=None)
def _quotient_coset_constants(n_bits: int, qdb: int):
    """(shifted_xs, zh_inv, l0) numpy u64 arrays over the quotient coset.

    Z_H(shift*w^i) = shift^n * (w^i)^n - 1, periodic with period 2^qdb.
    NOTE subtlety: evals indexed by i use subgroup(qdb) in *power* order
    of w^(n*i) = v^i where v = primitive 2^qdb-th root; i % 2^qdb cycles.
    """
    n = 1 << n_bits
    q_lde_n = n << qdb
    pts = gl.two_adic_subgroup(n_bits + qdb)  # [q_lde_n]
    shift = np.uint64(gl.MULTIPLICATIVE_GROUP_GENERATOR)
    shifted_xs = gl.np_mul(shift, pts)
    g_pow_n = gl.gexp(gl.MULTIPLICATIVE_GROUP_GENERATOR, n)
    zh_period = gl.np_sub(
        gl.np_mul(np.uint64(g_pow_n), gl.two_adic_subgroup(qdb)), np.uint64(1)
    )
    zh = np.tile(zh_period, q_lde_n // (1 << qdb))
    zh_inv = gl.np_batch_inverse(zh)
    l0 = gl.np_mul(
        zh,
        gl.np_batch_inverse(
            gl.np_mul(np.uint64(n % gl.P), gl.np_sub(shifted_xs, np.uint64(1)))
        ),
    )
    return shifted_xs, zh_inv, l0


def _compute_quotient_polys(
    common,
    prover_data,
    public_inputs_hash,
    wires_commitment,
    zs_pp_commitment,
    betas,
    gammas,
    alphas,
    deltas=None,
) -> torch.Tensor:
    """Quotient polynomials as [nc * quotient_degree_factor, n] coefficient
    chunks on the device of the commitments; betas, gammas, alphas: [nc]
    challenge tensors there; deltas: the [NUM_COINS_LOOKUP * nc] lookup
    challenges of a circuit with lookups."""
    config = common.config
    qdb = common.quotient_degree_factor.bit_length() - 1
    assert (1 << qdb) == common.quotient_degree_factor
    assert qdb <= config.fri_config.rate_bits
    # rate_bits > qdb: the committed LDE is higher-rate than the quotient
    # needs — sample it at a stride instead of recomputing
    step = 1 << (config.fri_config.rate_bits - qdb)
    n_bits = common.degree_bits
    n = common.degree
    device = wires_commitment.device

    # host precomputations over the coset — witness-independent, cached
    # per (degree, qdb)
    shifted_xs, zh_inv, l0 = _quotient_coset_constants(n_bits, qdb)

    mesh = pctx.get_mesh()
    if mesh is not None:
        return _quotient_chunks_mesh(
            mesh, common, prover_data, public_inputs_hash, wires_commitment,
            zs_pp_commitment, betas, gammas, alphas, deltas, step, (shifted_xs, l0, zh_inv),
        )

    cs_nat = _natural_order_values(prover_data.constants_sigmas_commitment, step)
    wires_nat = _natural_order_values(wires_commitment, step)
    zs_pp_nat = _natural_order_values(zs_pp_commitment, step)

    q = quotient_values_fn(common)(
        cs_nat,
        wires_nat,
        zs_pp_nat,
        gf.from_u64(shifted_xs, device),
        gf.from_u64(l0, device),
        gf.from_u64(zh_inv, device),
        betas,
        gammas,
        alphas,
        _u64_tensor(list(public_inputs_hash), device),
        deltas=deltas,
        lut_evals=_lut_evals_device(deltas, common) if common.num_lookup_polys else None,
    )
    # coset-IFFT back to coefficients, split into degree-n chunks
    nc = config.num_challenges
    return ntt.coset_ifft(q).reshape(nc * common.quotient_degree_factor, n)


@lru_cache(maxsize=None)
def _natural_order_plan(lde_n: int, d: int, step: int):
    """The all-to-all that turns row-sharded leaves into the quotient's
    natural-order shards, fixed for each (lde_n, d, step): target t takes
    the points p·step, p in [t·B/d, (t+1)·B/d) (B = lde_n / step), and
    point k is leaf row rev(k): row rev(k) mod lde_n/d of shard
    rev(k) // (lde_n/d) (ops/fri_kernels.lde_leaf_shards). Returns
    plan[s][t] = (the local rows shard s sends to t, the columns of t's
    block they fill), as u64 arrays."""
    rows, per = lde_n // d, lde_n // step // d
    leaf = np.asarray(reverse_index_bits_perm(lde_n), dtype=np.int64)[::step]
    owner, local = leaf // rows, leaf % rows
    plan = [[None] * d for _ in range(d)]
    for t in range(d):
        o, l = owner[t * per:(t + 1) * per], local[t * per:(t + 1) * per]
        for s in range(d):
            cols = np.flatnonzero(o == s)
            plan[s][t] = (l[cols].astype(np.uint64), cols.astype(np.uint64))
    return plan


# _natural_order_plan's index arrays on the devices, by (plan, s, t, which, device)
_PLAN_TENSORS = {}


def _plan_tensor(key, arr: np.ndarray, device) -> torch.Tensor:
    key = key + (str(device),)
    if key not in _PLAN_TENSORS:
        _PLAN_TENSORS[key] = gf.from_u64(arr, device)
    return _PLAN_TENSORS[key]


def _natural_order_shards(batch: fo.PolynomialBatch, step: int, mesh) -> List[torch.Tensor]:
    """_natural_order_values column-sharded: shard t gets the natural-order
    columns [t·B/d, (t+1)·B/d) of the [M, B] values on its device. A tree
    kept on this mesh's shards sends each target the rows it needs from
    where they lie (one all-to-all, _natural_order_plan): no device holds
    the whole leaf matrix. Any other tree (a circuit's whole tree, built
    outside the mesh) is read by index on the proof's device, a block a
    shard."""
    tree = batch.merkle_tree
    d = mesh.size
    sharded = isinstance(tree, merkle.ShardedMerkleTree)
    if not (sharded and tuple(p.device for p in tree.leaf_parts) == tuple(mesh.devices)):
        perm = bitrev_perm(tree.num_leaves, batch.device)[::step]
        width = -batch.salt_size if batch.salt_size else None
        rows = tree.leaf_rows_device if sharded else tree.leaves.__getitem__
        return [rows(idx)[:, :width].T.contiguous().to(dev)
                for idx, dev in zip(torch.chunk(perm, d), mesh.devices)]
    lde_n = tree.num_leaves
    width = tree.leaf_parts[0].shape[1] - batch.salt_size
    plan = _natural_order_plan(lde_n, d, step)
    out = []
    for t, dev in enumerate(mesh.devices):
        block = torch.empty((width, lde_n // step // d), dtype=gf.I64, device=dev)
        for s, part in enumerate(tree.leaf_parts):
            rows, cols = plan[s][t]
            if len(rows):
                key = (lde_n, d, step, s, t)
                sent = part[_plan_tensor(key + ("rows",), rows, part.device), :width]
                block.index_copy_(1, _plan_tensor(key + ("cols",), cols, dev), sent.to(dev).T)
        out.append(block)
    return out


def _quotient_rows(parts: List[torch.Tensor], mesh, n: int, device) -> fk.PolyShards:
    """The six-step's coefficient column blocks (parts[s]: [C, Nq/d], the
    coefficients [s·Nq/d, (s+1)·Nq/d) of C polys of Nq) as the quotient
    oracle's poly-sharded rows: the [C·Nq/n, n] chunks, row c·Nq/n + j
    = coefficients [j·n, (j+1)·n) of poly c, zero rows padding them to a
    multiple of d. One all-to-all: each target's rows are a flat range of
    the chunk matrix and each source's block of each poly a flat range
    too, so every message is a slice."""
    c_polys, w = parts[0].shape
    nq = w * mesh.size
    per = -(-(c_polys * nq // n) // mesh.size)  # rows a shard
    out = []
    for t, dev in enumerate(mesh.devices):
        lo, hi = t * per * n, (t + 1) * per * n
        flat = gf.zeros((per * n,), dev)
        for s, part in enumerate(parts):
            for c in range(c_polys):
                a = c * nq + s * w
                x, y = max(a, lo), min(a + w, hi)
                if x < y:
                    flat[x - lo : y - lo].copy_(part[c, x - a : y - a])
        out.append(flat.reshape(per, n))
    return fk.PolyShards(out, c_polys * nq // n, device)


def _quotient_chunks_mesh(mesh, common, prover_data, public_inputs_hash, wires_commitment,
                          zs_pp_commitment, betas, gammas, alphas, deltas, step,
                          coset_constants) -> torch.Tensor:
    """_compute_quotient_polys over a prover mesh: the constraint
    evaluation is point-sharded (prover.rs:720's par_chunks over the LDE
    points), each shard on its device, and the coset IFFT back to
    coefficients is the six-step transform over the shards
    (parallel/ntt.py), whose butterflies stay shard-local. The roll to the
    next point crosses a shard border: each shard's Z columns get the next
    shard's first quotient_degree_factor columns appended."""
    from ..parallel import ntt as pntt

    nc = common.config.num_challenges
    device = wires_commitment.device
    cs = _natural_order_shards(prover_data.constants_sigmas_commitment, step, mesh)
    wires = _natural_order_shards(wires_commitment, step, mesh)
    zs = _natural_order_shards(zs_pp_commitment, step, mesh)
    k = common.quotient_degree_factor
    if zs[0].shape[1] < k:
        raise ValueError(f"a mesh of {mesh.size} shards leaves fewer than {k} points a shard")
    d = mesh.size
    zs_next = [
        torch.cat([zs[s][:, k:], zs[(s + 1) % d][:, :k].to(zs[s].device)], dim=1)
        for s in range(d)
    ]
    points = [pctx.shard(gf.from_u64(a, device), mesh, 0) for a in coset_constants]
    challenges = [betas, gammas, alphas, _u64_tensor(list(public_inputs_hash), device)]
    lut_evals = _lut_evals_device(deltas, common) if common.num_lookup_polys else None
    qfn = quotient_values_fn(common)

    def shard_quotient(s):
        dev = mesh.devices[s]
        bg = [c.to(dev) for c in challenges]
        return qfn(
            cs[s], wires[s], zs[s], points[0][s], points[1][s], points[2][s], *bg,
            deltas=None if deltas is None else deltas.to(dev),
            lut_evals=None if lut_evals is None else lut_evals.to(dev),
            zs_next=zs_next[s],
        )

    q = pctx.map_shards(shard_quotient, mesh, list(range(d)))
    return _quotient_rows(pntt.six_step_coset_ifft_shards(q, mesh), mesh, common.degree, device)


# ---------------------------------------------------------------------------
# Lookups (prover.rs:42-140 set_lookup_wires; :489-637 compute_lookup_polys)
# ---------------------------------------------------------------------------


def set_lookup_wires(prover_data, common, pw) -> None:
    """Computes multiplicities, pads the last LookupGate and fills the
    LookupTableGate multiplicity wires.

    Vectorized (reference: plonk/prover.rs:42-140 loops per lookup under
    rayon): the multiplicity histogram is one bincount over the gathered
    lookup-input values via a 2^16 inverse table, and the multiplicity
    wires are one bulk set — the only per-item Python is extracting each
    lookup target's dense index."""
    from ..gates.lookup import LookupGate, LookupTableGate
    from ..iop.target import Target

    config = common.config
    num_entries = config.num_routed_wires // 2
    num_lut_entries = config.num_routed_wires // 3
    nw, deg = pw.num_wires, pw.degree
    for lut_index, (last_lu, last_lut, first_lut) in enumerate(prover_data.lookup_rows):
        lut = common.luts[lut_index]
        lut_inputs = np.fromiter((inp for inp, _ in lut), np.int64, count=len(lut))
        # first occurrence wins (reference setdefault semantics)
        inv = np.full(1 << 16, -1, np.int64)
        inv[lut_inputs[::-1]] = np.arange(len(lut) - 1, -1, -1)
        lookups = prover_data.lut_to_lookups[lut_index]
        flat = np.fromiter(
            (t.flat_index(nw, deg) for t, _ in lookups), np.int64, count=len(lookups)
        )
        v = pw.get_wires_bulk(flat)
        assert (v < (1 << 16)).all(), "lookup input exceeds u16"
        idx = inv[v.astype(np.int64)]
        assert (idx >= 0).all(), "lookup input not present in the LUT"
        multiplicities = np.bincount(idx, minlength=len(lut)).astype(object)
        remaining = (num_entries - (len(lookups) % num_entries)) % num_entries
        fi, fo = lut[0]
        for slot in range(num_entries - remaining, num_entries):
            pw.set_target(
                Target.wire(last_lut - 1, LookupGate.wire_ith_looking_inp(slot)), fi
            )
            pw.set_target(
                Target.wire(last_lut - 1, LookupGate.wire_ith_looking_out(slot)), fo
            )
            multiplicities[0] += 1
        entries = np.arange(len(lut))
        pw.set_wires_bulk(
            first_lut - entries // num_lut_entries,
            np.fromiter(
                (LookupTableGate.wire_ith_multiplicity(c) for c in entries % num_lut_entries),
                np.int64,
                count=len(lut),
            ),
            multiplicities,
        )


def _suffix_sum(x: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_{j >= i} x[j] mod p along the first axis, by
    log-doubling with gf.add, as the JAX package's _dev_suffix_sum (a
    cumsum over the int64 container would wrap)."""
    x = x.clone()
    n = x.shape[0]
    shift = 1
    while shift < n:
        x[:-shift] = gf.add(x[:-shift], x[shift:])
        shift <<= 1
    return x


def _lookup_polys_device(wires_dev: torch.Tensor, deltas: torch.Tensor, prover_data, common) -> torch.Tensor:
    """The lookup polynomials on the device (prover.rs:489-637): per
    challenge the running-evaluation column RE, then the partial-SLDC
    columns, as [nc * num_lookup_polys, n]; the rows of the JAX package's
    host compute_all_lookup_polys, which its tests hold it to. wires_dev:
    [num_wires, n]; deltas: [NUM_COINS_LOOKUP * nc] challenge tensor.

    A lookup block's rows and a slot's wire columns are contiguous or
    strided runs, so every gather and write is a slice: nothing is read
    back and no index is uploaded."""
    from ..gates.lookup import LookupGate, LookupTableGate

    config = common.config
    degree = common.degree
    nc = config.num_challenges
    num_lu_slots = config.num_routed_wires // 2
    lu_degree = common.lookup_accumulator_degree()
    num_partial = -(-num_lu_slots // lu_degree)
    num_lut_slots = config.num_routed_wires // 3
    lut_degree = -(-num_lut_slots // num_partial)
    device = wires_dev.device
    assert LookupTableGate.wire_ith_looked_inp(1) == 3 and LookupGate.wire_ith_looking_inp(1) == 2

    def cols(first: int, step: int, count: int, rows: slice) -> torch.Tensor:
        # wire columns first, first + step, ... at the given rows: [R, count]
        return wires_dev[first : first + step * count : step, rows].T

    def chunked_prefix(terms: torch.Tensor, slots: int, deg: int):
        # within-row sums of terms [R, slots] by chunks of deg, then the
        # running prefix over the chunks: ([R, num_partial], [R] total)
        sums = [gf.sum_mod_p(terms[:, k * deg : min((k + 1) * deg, slots)], axis=1)
                for k in range(num_partial)]
        prefix = [sums[0]]
        for k in range(1, num_partial):
            prefix.append(gf.add(prefix[-1], sums[k]))
        return torch.stack(prefix, dim=1), prefix[-1]

    out = []
    for c in range(nc):
        dA, dB, dAlpha, dDelta = deltas[NUM_COINS_LOOKUP * c : NUM_COINS_LOOKUP * (c + 1)]
        polys = gf.zeros((num_partial + 1, degree), device)
        # delta^0 .. delta^S; RE[r] = a_r + c_f * RE[r+1] with c_f = delta^S
        # and a_r = sum_j combos[r, j] * delta^(S-1-j), as the affine
        # suffix scan c_f^-i * suffix_sum(a_i * c_f^i)
        dpow = gf.powers_scan(dDelta, num_lut_slots + 1)
        w = torch.flip(dpow[:num_lut_slots], dims=(0,))
        c_f = dpow[num_lut_slots]
        c_inv = gf.batch_inverse(c_f.reshape(1))[0]
        for (last_lu, last_lut, first_lut) in prover_data.lookup_rows:
            lut_rows = slice(last_lut, first_lut + 1)
            lu_rows = slice(last_lu, last_lut)
            L = first_lut + 1 - last_lut
            M = last_lut - last_lu
            inp = cols(0, 3, num_lut_slots, lut_rows)  # [L, S]
            outv = cols(1, 3, num_lut_slots, lut_rows)
            mult = cols(2, 3, num_lut_slots, lut_rows)
            looked = gf.add(inp, gf.mul(outv, dA))
            inv = gf.batch_inverse(gf.sub(dAlpha.expand(looked.shape), looked))
            combos = gf.add(inp, gf.mul(outv, dB))
            a = gf.sum_mod_p(gf.mul(combos, w), axis=1)  # [L]
            re = gf.mul(gf.powers_scan(c_inv, L), _suffix_sum(gf.mul(a, gf.powers_scan(c_f, L))))
            polys[0, lut_rows] = re

            lut_prefix, lut_row_total = chunked_prefix(gf.mul(mult, inv), num_lut_slots, lut_degree)
            if M:
                linp = cols(0, 2, num_lu_slots, lu_rows)  # [M, S2]
                lout = cols(1, 2, num_lu_slots, lu_rows)
                looking = gf.add(linp, gf.mul(lout, dA))
                linv = gf.batch_inverse(gf.sub(dAlpha.expand(looking.shape), looking))
                lu_prefix, lu_row_total = chunked_prefix(linv, num_lu_slots, lu_degree)
                delta_m = torch.cat([gf.neg(lu_row_total), lut_row_total])
            else:
                delta_m = lut_row_total
            # carry[r]: the block-local suffix sum of +LUT row totals and
            # -LU row totals; a row's partials start from carry[r + 1]
            carry = _suffix_sum(delta_m)
            carry_next = torch.cat([carry[1:], gf.zeros((1,), device)])
            for k in range(num_partial):
                if M:
                    polys[k + 1, lu_rows] = gf.sub(carry_next[:M], lu_prefix[:, k])
                polys[k + 1, lut_rows] = gf.add(carry_next[M:], lut_prefix[:, k])
        out.append(polys)
    return torch.cat(out)


def _lut_evals_device(deltas: torch.Tensor, common) -> torch.Tensor:
    """[nc, num_luts]: each LUT polynomial at ChallengeDelta, with
    ChallengeB from the device deltas (vanishing_poly.rs:30-52; Horner
    replaced by a weighted sum with the powers of delta, the same value
    mod p; vanishing.get_lut_poly_eval is its host oracle)."""
    config = common.config
    nc = config.num_challenges
    num_lut_slots = config.num_routed_wires // 3
    device = deltas.device
    tables = []
    for lut in common.luts:
        n = len(lut)
        deg = num_lut_slots * (-(-n // num_lut_slots))
        nb_padded = (num_lut_slots - n % num_lut_slots) % num_lut_slots
        tail = [lut[0]] * nb_padded + [(0, 0)] * (deg - n - nb_padded)
        pairs = np.array(list(lut) + tail, dtype=np.uint64)  # [deg, 2]
        tables.append(gf.from_u64(pairs.T.copy(), device))
    rows = []
    for i in range(nc):
        dB = deltas[NUM_COINS_LOOKUP * i + 1]
        dDelta = deltas[NUM_COINS_LOOKUP * i + 3]
        row = []
        for t in tables:
            coeffs = gf.add(t[0], gf.mul(t[1], dB))
            # coefficient j gets delta^(deg-1-j)
            wrev = torch.flip(gf.powers_scan(dDelta, t.shape[1]), dims=(0,))
            row.append(gf.sum_mod_p(gf.mul(coeffs, wrev), axis=0))
        rows.append(torch.stack(row))
    return torch.stack(rows)

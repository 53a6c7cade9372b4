"""A plain STARK prover, written from the protocol of the repository's
plonky2 fork (starky's prover.rs with the fork's transcript binding), for
the benchmark to hold the program's proofs against: single tables, and the
two-table system of a cross-table lookup (CTL).

Deterministic (no zero knowledge, the smallest proof-of-work witness), so
a sound proof of the same statement under the same configuration is this
proof, word for word. Plain PyTorch on whatever device the inputs are put
on; nothing of the program is imported.

Protocol, in transcript order:
  1. observe the public inputs and the configuration (security bits,
     challenges, rate bits, cap height, proof-of-work bits, the reduction
     strategy as [1, arity bits, final poly bits], queries);
  2. commit to the trace: coefficients by inverse transform, values on the
     coset g * <w> of 2^rate_bits times the rows, leaves in bit-reversed
     order, a Poseidon Merkle tree; observe its cap;
  3. draw alphas'; binding: draw extension points, make simulated openings
     (powers of the point), evaluate the constraints at a further point
     under alphas', observe the results; draw the alphas;
  4. the quotient: the alpha-combined constraints over the coset divided
     by Z_H, back to coefficients, cut into chunks of n; commit; observe;
  5. draw zeta; open the trace (and the auxiliary CTL columns) at zeta and
     g zeta, the quotient at zeta, the CTL Zs at 1; observe the openings
     batch by batch;
  6. FRI: draw alpha, reduce the openings to one polynomial (per batch
     the alpha-weighted sum over (X - point), batches shifted by alpha to
     the batch's size), fold by the arities with one tree and one beta a
     round, observe the final polynomial, grind the proof of work, draw
     the query indices and open every tree along them.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, List, Sequence

import torch

from . import field as F
from . import poseidon as H
from .transcript import Challenger


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StarkParams:
    security_bits: int
    num_challenges: int
    rate_bits: int
    cap_height: int
    pow_bits: int
    arity_bits: int
    final_poly_bits: int
    num_queries: int

    @staticmethod
    def from_config(cfg: Dict) -> "StarkParams":
        return StarkParams(
            cfg["security_bits"], cfg["num_challenges"], cfg["rate_bits"], cfg["cap_height"],
            cfg["proof_of_work_bits"], cfg["reduction_arity_bits"], cfg["final_poly_bits"],
            cfg["num_query_rounds"],
        )

    def observe(self, ch: Challenger) -> None:
        ch.observe_all([self.security_bits, self.num_challenges, self.rate_bits,
                        self.cap_height, self.pow_bits, 1, self.arity_bits,
                        self.final_poly_bits, self.num_queries])

    def arities(self, degree_bits: int) -> List[int]:
        """ConstantArityBits: fold while the degree is above the final
        polynomial's and the folded layer still has a full cap."""
        out, db = [], degree_bits
        while (db > self.final_poly_bits
               and db + self.rate_bits - self.arity_bits >= self.cap_height):
            out.append(self.arity_bits)
            db -= self.arity_bits
        return out


# ---------------------------------------------------------------------------
# constraints, over host extension values or device base tensors
# ---------------------------------------------------------------------------


class HostAlg:
    def add(self, a, b):
        return F.ext_add(a, b)

    def sub(self, a, b):
        return F.ext_sub(a, b)

    def mul(self, a, b):
        return F.ext_mul(a, b)

    def const(self, v):
        return (v % F.P, 0)

    def zero(self):
        return (0, 0)


class DeviceAlg:
    def __init__(self, device):
        self.device = device

    def add(self, a, b):
        return F.add(a, b)

    def sub(self, a, b):
        return F.sub(a, b)

    def mul(self, a, b):
        return F.mul(a, b)

    def const(self, v):
        return F.const(v, self.device)

    def zero(self):
        return F.const(0, self.device)


class Consumer:
    """acc <- acc * alpha + c for every alpha; first-row constraints times
    L_first, last-row times L_last, transitions times (x - g^(n-1))."""

    def __init__(self, alg, alphas, z_last, l_first, l_last):
        self.alg, self.alphas = alg, [alg.const(a) for a in alphas]
        self.accs = [alg.zero() for _ in alphas]
        self.z_last, self.l_first, self.l_last = z_last, l_first, l_last

    def push(self, c):
        A = self.alg
        self.accs = [A.add(A.mul(acc, a), c) for acc, a in zip(self.accs, self.alphas)]

    def first_row(self, c):
        self.push(self.alg.mul(c, self.l_first))

    def last_row(self, c):
        self.push(self.alg.mul(c, self.l_last))

    def transition(self, c):
        self.push(self.alg.mul(c, self.z_last))


class Frame:
    """One row and the next, of the trace and of the auxiliary columns, the
    public inputs and the CTL challenges (beta, gamma), as algebra values."""

    def __init__(self, local, nxt, aux_local=(), aux_next=(), pis=(), challenges=()):
        self.local, self.next = local, nxt
        self.aux_local, self.aux_next = aux_local, aux_next
        self.pis, self.challenges = pis, challenges


class FibonacciAir:
    """Columns (x0, x1); x0' = x1, x1' = x0 + x1; public inputs pin x0, x1
    on the first row and x1 on the last (fibonacci_stark.rs)."""

    num_columns = 2
    constraint_degree = 2
    ctl_zs = ()  # indices of the auxiliary columns that are CTL Zs

    @staticmethod
    def aux_columns(trace, challenges):
        return []

    @staticmethod
    def eval(A, v: Frame, cons: Consumer) -> None:
        local, nxt, pis = v.local, v.next, v.pis
        cons.first_row(A.sub(local[0], pis[0]))
        cons.first_row(A.sub(local[1], pis[1]))
        cons.last_row(A.sub(local[1], pis[2]))
        cons.transition(A.sub(nxt[0], local[1]))
        cons.transition(A.sub(nxt[1], A.add(local[0], local[1])))


def _suffix_sums(x: torch.Tensor) -> torch.Tensor:
    """z_i = sum_{j >= i} x_j."""
    return torch.flip(F.field_cumsum(torch.flip(x, (0,))), (0,))


class CtlLookingAir:
    """The looking table of the two-table cross-table lookup: columns
    (a, b), no constraints of its own; both columns look into the looked
    table. Per challenge (beta, gamma), with a single column combined as
    gamma + value: the helper h = 1/(gamma + a) + 1/(gamma + b) and its
    suffix sums Z (Z(1) the total), checked by
    (gamma + a)(gamma + b) h = (gamma + b) + (gamma + a), Z = h on the last
    row and Z - Z' = h elsewhere. Auxiliary columns: the helpers, then the
    Zs."""

    num_columns = 2
    constraint_degree = 3

    def __init__(self, num_challenges: int):
        self.nc = num_challenges
        self.ctl_zs = tuple(range(num_challenges, 2 * num_challenges))

    def aux_columns(self, trace, challenges):
        helpers = []
        for _beta, gamma in challenges:
            g = F.const(gamma, trace.device)
            helpers.append(F.add(F.inverse(F.add(trace[0], g)), F.inverse(F.add(trace[1], g))))
        return helpers + [_suffix_sums(h) for h in helpers]

    def eval(self, A, v: Frame, cons: Consumer) -> None:
        a, b = v.local
        for k, (_beta, gamma) in enumerate(v.challenges):
            h, z, z_next = v.aux_local[k], v.aux_local[self.nc + k], v.aux_next[self.nc + k]
            ca, cb = A.add(a, gamma), A.add(b, gamma)
            cons.push(A.sub(A.mul(A.mul(cb, ca), h), A.add(cb, ca)))
            cons.last_row(A.sub(z, h))
            cons.transition(A.sub(A.sub(z, z_next), h))


class CtlLookedAir:
    """The looked table: columns (value, flag), flag boolean; the flagged
    values form the table. Per challenge, Z = suffix sums of
    flag / (gamma + value), checked by (gamma + value) Z = flag on the last
    row and (gamma + value)(Z - Z') = flag elsewhere. Auxiliary columns: the
    Zs."""

    num_columns = 2
    constraint_degree = 3

    def __init__(self, num_challenges: int):
        self.ctl_zs = tuple(range(num_challenges))

    def aux_columns(self, trace, challenges):
        return [_suffix_sums(F.mul(trace[1], F.inverse(F.add(trace[0], F.const(g, trace.device)))))
                for _beta, g in challenges]

    def eval(self, A, v: Frame, cons: Consumer) -> None:
        value, flag = v.local
        cons.push(A.mul(flag, A.sub(flag, A.const(1))))
        for k, (_beta, gamma) in enumerate(v.challenges):
            z, z_next = v.aux_local[k], v.aux_next[k]
            c = A.add(value, gamma)
            cons.last_row(A.sub(A.mul(c, z), flag))
            cons.transition(A.sub(A.mul(c, A.sub(z, z_next)), flag))


AIRS = {"fibonacci": FibonacciAir}


# ---------------------------------------------------------------------------
# Merkle trees
# ---------------------------------------------------------------------------


class Tree:
    def __init__(self, leaves: torch.Tensor, cap_height: int):
        self.leaves = leaves
        levels = [H.hash_leaves(leaves)]
        while levels[-1].shape[0] > (1 << cap_height):
            levels.append(H.compress(levels[-1]))
        self.levels = levels

    @property
    def cap(self) -> List[List[int]]:
        return [F.to_ints(row) for row in self.levels[-1]]

    def open(self, indices: Sequence[int]):
        """[(leaf words, [sibling digests, leaf level first])] at indices."""
        idx = torch.tensor(list(indices), dtype=torch.int64, device=self.leaves.device)
        rows = [F.to_ints(r) for r in self.leaves[idx]]
        sibs = []
        cur = idx
        for level in self.levels[:-1]:
            sibs.append(level[cur ^ 1])
            cur = cur >> 1
        if sibs:
            paths = torch.stack(sibs, dim=1)  # [Q, L, 4]
            paths = [[tuple(F.to_ints(d)) for d in p] for p in paths]
        else:
            paths = [[] for _ in indices]
        return list(zip(rows, paths))


def commit_coeffs(coeffs: torch.Tensor, rate_bits: int, cap_height: int) -> Tree:
    """Leaves: row i = every polynomial at coset point rev(i)."""
    m, n = coeffs.shape
    big = n << rate_bits
    padded = torch.cat([coeffs, torch.zeros((m, big - n), dtype=torch.int64,
                                            device=coeffs.device)], dim=1)
    values = F.coset_fft(padded, F.MULTIPLICATIVE_GENERATOR)  # [M, N]
    rev = F.bit_reverse_indices(big.bit_length() - 1, coeffs.device)
    return Tree(values.T[rev].contiguous(), cap_height)


# ---------------------------------------------------------------------------
# the prover
# ---------------------------------------------------------------------------


def _binding(air, ch: Challenger, pis, alphas_prime, degree_bits: int, num_aux: int,
             challenges):
    """The fork's binding step (vanishing.rs run_binding_step): simulated
    openings z, z^d, z^(d^2), ... (d = max(2, degree + 1)) of the trace's
    rows and the auxiliary rows, the constraints at a fresh point under
    alphas', observed."""
    c = air.num_columns
    total = 2 * c + 2 * num_aux
    pow_degree = max(2, air.constraint_degree + 1)
    log2_ceil = (pow_degree - 1).bit_length()
    per_zeta = max(1, 50 // log2_ceil - 1)
    zetas = [ch.ext_challenge() for _ in range(-(-total // per_zeta))]
    take = min(per_zeta + 1, total)
    dummy = []
    for z in zetas:
        cur = z
        for _ in range(take):
            dummy.append(cur)
            cur = F.ext_pow(cur, pow_degree)
    x = ch.ext_challenge()
    n = 1 << degree_bits
    g = F.root_of_unity(degree_bits)
    zx = F.ext_sub(F.ext_pow(x, n), (1, 0))
    l_first = F.ext_mul(zx, F.ext_inv(F.ext_scale(F.ext_sub(x, (1, 0)), n)))
    l_last = F.ext_mul(zx, F.ext_inv(F.ext_scale(F.ext_sub(F.ext_scale(x, g), (1, 0)), n)))
    z_last = F.ext_sub(x, (pow(g, n - 1, F.P), 0))
    A = HostAlg()
    cons = Consumer(A, alphas_prime, z_last, l_first, l_last)
    frame = Frame(dummy[:c], dummy[c:2 * c], dummy[2 * c:2 * c + num_aux],
                  dummy[2 * c + num_aux:2 * c + 2 * num_aux], [A.const(p) for p in pis],
                  [(A.const(b), A.const(gm)) for b, gm in challenges])
    air.eval(A, frame, cons)
    ch.observe_exts(cons.accs)


def _quotient(air, trace_values, aux_values, pis, alphas, challenges, degree_bits, rate_bits):
    """Chunks [num_challenges * qdf, n] of the quotient polynomials'
    coefficients, qdf = max(1, constraint degree - 1) chunks a challenge.
    trace_values, aux_values: natural-order coset values [C, 2^rate_bits n]."""
    dev = trace_values.device
    n = 1 << degree_bits
    big = n << rate_bits
    g = F.root_of_unity(degree_bits)
    shift = F.MULTIPLICATIVE_GENERATOR
    xs = F.mul(F.powers(F.root_of_unity(degree_bits + rate_bits), big, dev), F.const(shift, dev))
    # Z_H(x) = x^n - 1 repeats with period 2^rate_bits over the coset
    period = [(pow(shift, n, F.P) * pow(F.root_of_unity(rate_bits), i, F.P) - 1) % F.P
              for i in range(1 << rate_bits)]
    zh = F.to_tensor(period, dev).repeat(n)
    zh_inv = F.to_tensor([F.inv(v) for v in period], dev).repeat(n)
    one = F.const(1, dev)
    n_c = F.const(n, dev)
    l_first = F.mul(zh, F.inverse(F.mul(F.sub(xs, one), n_c)))
    l_last = F.mul(zh, F.inverse(F.mul(F.sub(F.mul(xs, F.const(g, dev)), one), n_c)))
    z_last = F.sub(xs, F.const(pow(g, n - 1, F.P), dev))
    step = 1 << rate_bits
    A = DeviceAlg(dev)
    frame = Frame([v for v in trace_values], [torch.roll(v, -step) for v in trace_values],
                  [v for v in aux_values], [torch.roll(v, -step) for v in aux_values],
                  [A.const(p) for p in pis], [(A.const(b), A.const(gm)) for b, gm in challenges])
    cons = Consumer(A, alphas, z_last, l_first, l_last)
    air.eval(A, frame, cons)
    chunks = []
    qdf = max(1, air.constraint_degree - 1)
    for acc in cons.accs:
        coeffs = F.coset_ifft(F.mul(acc, zh_inv), shift)
        if bool((coeffs[qdf * n:] != 0).any()):
            raise ValueError("the quotient has too high a degree: the trace breaks a constraint")
        chunks.extend(coeffs[i * n:(i + 1) * n] for i in range(qdf))
    return torch.stack(chunks)


def _divide_by_linear(comp, z: F.Ext):
    """(p(X) - p(z)) / (X - z) of an extension polynomial (pair of [n]),
    with a zero top coefficient: q_i = z^-(i+1) * sum_{j>i} c_j z^j."""
    dev = comp[0].device
    n = comp[0].shape[0]
    zp = F.e_powers(z, n, dev)
    d = F.e_mul(comp, zp)
    pre = (F.field_cumsum(d[0]), F.field_cumsum(d[1]))
    tail = F.e_sub((pre[0][-1:], pre[1][-1:]), pre)
    zinv = F.ext_inv(z)
    zi = F.e_mul(F.e_powers(zinv, n, dev), F.e_const(zinv, dev))
    return F.e_mul(tail, zi)


def _fold(coeffs, beta: F.Ext, arity_bits: int):
    """new_i = sum_j beta^j coeffs[arity * i + j]."""
    arity = 1 << arity_bits
    dev = coeffs[0].device
    bp = F.e_powers(beta, arity, dev)
    prod = F.e_mul((coeffs[0].reshape(-1, arity), coeffs[1].reshape(-1, arity)), bp)
    return F.field_sum(prod[0], -1), F.field_sum(prod[1], -1)


def _grind(ch: Challenger, bits: int, device) -> int:
    """The smallest witness whose duplex response (lane 7) has ``bits``
    leading zeros."""
    state, pos = ch.grind_state()
    chunk = 1 << max(10, min(17, bits + 2))
    base = torch.tensor([F.s64(v) for v in state], dtype=torch.int64, device=device)
    start = 0
    while True:
        states = base.repeat(chunk, 1)
        states[:, pos] = torch.arange(start, start + chunk, dtype=torch.int64, device=device)
        resp = H.permute(states)[:, H.RATE - 1]
        ok = (resp >> (64 - bits)) == 0
        hits = torch.nonzero(ok)
        if hits.numel():
            return start + int(hits[0, 0])
        start += chunk


def _natural(tree: Tree) -> torch.Tensor:
    """A committed oracle's coset values [polys, 2^rate_bits n] in natural
    order, from its bit-reversed leaves."""
    leaves = tree.leaves
    rev = F.bit_reverse_indices(leaves.shape[0].bit_length() - 1, leaves.device)
    out = torch.empty_like(leaves)
    out[rev] = leaves
    return out.T.contiguous()


def _prove_table(air, params: StarkParams, trace: torch.Tensor, trace_coeffs, trace_tree: Tree,
                 ch: Challenger, pis: List[int], challenges=()):
    """A table's proof once its trace cap has been observed (prover.rs
    prove_with_commitment): the auxiliary columns (CTL helpers, then CTL
    Zs) committed and observed, the binding step, the quotient, the
    openings (and the CTL Zs at 1), FRI."""
    dev = trace.device
    c, n = trace.shape
    degree_bits = n.bit_length() - 1
    rb = params.rate_bits
    big = n << rb

    aux = air.aux_columns(trace, challenges)
    aux_coeffs = aux_tree = None
    if aux:
        aux_coeffs = F.ifft(torch.stack(aux))
        aux_tree = commit_coeffs(aux_coeffs, rb, params.cap_height)
        ch.observe_cap(aux_tree.cap)

    alphas_prime = ch.challenges(params.num_challenges)
    _binding(air, ch, pis, alphas_prime, degree_bits, len(aux), challenges)
    alphas = ch.challenges(params.num_challenges)

    aux_values = _natural(aux_tree) if aux else trace[:0]
    quotient = _quotient(air, _natural(trace_tree), aux_values, pis, alphas, challenges,
                         degree_bits, rb)
    del aux_values
    quotient_tree = commit_coeffs(quotient, rb, params.cap_height)
    ch.observe_cap(quotient_tree.cap)

    zeta = ch.ext_challenge()
    g = F.root_of_unity(degree_bits)
    zeta_next = F.ext_scale(zeta, g)
    zp = F.e_powers(zeta, n, dev)
    zpn = F.e_powers(zeta_next, n, dev)
    local = F.eval_base_at_ext(trace_coeffs, zp)
    nxt = F.eval_base_at_ext(trace_coeffs, zpn)
    aux_local = F.eval_base_at_ext(aux_coeffs, zp) if aux else []
    aux_next = F.eval_base_at_ext(aux_coeffs, zpn) if aux else []
    quot = F.eval_base_at_ext(quotient, zp)
    # a CTL Z at 1 = g^0 is its first row: the total
    zs_first = [F.to_ints(aux[i][:1])[0] for i in air.ctl_zs]
    ch.observe_exts(local + aux_local + quot)
    ch.observe_exts(nxt + aux_next)
    if air.ctl_zs:
        ch.observe_exts([(v, 0) for v in zs_first])

    # FRI: reduce the batches to one polynomial
    alpha = ch.ext_challenge()
    opened = [trace_coeffs] + ([aux_coeffs] if aux else [])
    batches = [(zeta, torch.cat(opened + [quotient])), (zeta_next, torch.cat(opened))]
    if air.ctl_zs:
        batches.append(((1, 0), aux_coeffs[list(air.ctl_zs)]))
    final = None
    for point, polys in batches:
        comp = (torch.zeros(n, dtype=torch.int64, device=dev),) * 2
        apow = (1, 0)
        for k in range(polys.shape[0]):
            comp = F.e_add(comp, F.e_scale(F.e_const(apow, dev), polys[k]))
            apow = F.ext_mul(apow, alpha)
        q = _divide_by_linear(comp, point)
        if final is None:
            final = q
        else:
            final = F.e_add(F.e_mul(final, F.e_const(F.ext_pow(alpha, polys.shape[0]), dev)), q)
    zeros = torch.zeros(big - n, dtype=torch.int64, device=dev)
    coeffs = (torch.cat([final[0], zeros]), torch.cat([final[1], zeros]))
    shift = F.MULTIPLICATIVE_GENERATOR
    values = (F.coset_fft(coeffs[0], shift), F.coset_fft(coeffs[1], shift))

    arities = params.arities(degree_bits)
    fri_trees = []
    for step, ab in enumerate(arities):
        size = values[0].shape[0]
        rev = F.bit_reverse_indices(size.bit_length() - 1, dev)
        leaves = torch.stack([values[0][rev], values[1][rev]], dim=-1).reshape(size >> ab, 2 << ab)
        tree = Tree(leaves, params.cap_height)
        fri_trees.append(tree)
        ch.observe_cap(tree.cap)
        beta = ch.ext_challenge()
        coeffs = _fold(coeffs, beta, ab)
        if step + 1 < len(arities):
            shift = pow(shift, 1 << ab, F.P)
            values = (F.coset_fft(coeffs[0], shift), F.coset_fft(coeffs[1], shift))
    keep = coeffs[0].shape[0] >> rb
    final_poly = list(zip(F.to_ints(coeffs[0][:keep]), F.to_ints(coeffs[1][:keep])))
    ch.observe_exts(final_poly)

    witness = _grind(ch, params.pow_bits, dev)
    ch.observe(witness)
    response = ch.challenge()
    if params.pow_bits and response >> (64 - params.pow_bits):
        raise AssertionError("proof-of-work witness fails its own check")
    indices = [x % big for x in ch.challenges(params.num_queries)]

    trees = [trace_tree] + ([aux_tree] if aux else []) + [quotient_tree]
    initial = [t.open(indices) for t in trees]
    steps = []
    idx = list(indices)
    for tree, ab in zip(fri_trees, arities):
        idx = [i >> ab for i in idx]
        opened_steps = tree.open(idx)
        steps.append([([tuple(w[2 * k:2 * k + 2]) for k in range(len(w) // 2)], path)
                      for w, path in opened_steps])
    queries = [{"initial": [op[q] for op in initial], "steps": [s[q] for s in steps]}
               for q in range(params.num_queries)]
    return {
        "public_inputs": pis,
        "trace_cap": trace_tree.cap,
        "auxiliary_cap": aux_tree.cap if aux else None,
        "quotient_cap": quotient_tree.cap,
        "openings": {"local": local, "next": nxt, "auxiliary": aux_local,
                     "auxiliary_next": aux_next, "ctl_zs_first": zs_first, "quotient": quot},
        "fri": {
            "commit_caps": [t.cap for t in fri_trees],
            "final_poly": final_poly,
            "pow_witness": witness,
            "queries": queries,
        },
    }


def prove(air_name: str, params: StarkParams, trace: torch.Tensor, public_inputs: List[int]):
    """The proof of a single table, ``trace`` [columns, n] int64 containers
    on a device, as nested plain lists (see program_stark_proof in
    compare.py): public inputs then the configuration observed, the trace
    committed and its cap observed, then _prove_table."""
    air = AIRS[air_name]
    pis = [p % F.P for p in public_inputs]
    ch = Challenger()
    ch.observe_all(pis)
    params.observe(ch)
    coeffs = F.ifft(trace)
    tree = commit_coeffs(coeffs, params.rate_bits, params.cap_height)
    ch.observe_cap(tree.cap)
    return _prove_table(air, params, trace, coeffs, tree, ch, pis)


def prove_ctl_system(params: StarkParams, traces: Sequence[torch.Tensor]):
    """The proofs of the two-table CTL system (looking table, looked table;
    multi.rs prove_all_tables): one challenger observes the configuration
    and both trace caps, draws (beta, gamma) for each challenge, and each
    table's proof goes on from a copy of it."""
    airs = [CtlLookingAir(params.num_challenges), CtlLookedAir(params.num_challenges)]
    ch = Challenger()
    params.observe(ch)
    commits = []
    for trace in traces:
        coeffs = F.ifft(trace)
        commits.append((coeffs, commit_coeffs(coeffs, params.rate_bits, params.cap_height)))
    for _, tree in commits:
        ch.observe_cap(tree.cap)
    challenges = [tuple(ch.challenges(2)) for _ in range(params.num_challenges)]
    return [_prove_table(air, params, trace, coeffs, tree, copy.deepcopy(ch), [], challenges)
            for air, trace, (coeffs, tree) in zip(airs, traces, commits)]

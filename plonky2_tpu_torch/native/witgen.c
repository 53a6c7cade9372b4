/* Native witness-generation fixpoint engine.
 *
 * Runs the worklist fixpoint over generators that were compiled (by
 * plonky2_tpu/iop/witgen_native.py's tracer) into register-quad
 * programs over the Goldilocks field. Generators the tracer could not
 * compile stay in Python; the Python driver bridges values in with
 * witgen_set() and re-enters witgen_run().
 *
 * Reference dual: plonky2/src/iop/generator.rs:26-104 runs its
 * generators as native Rust closures under a worklist; this engine is
 * the same fixpoint with the generator bodies compiled to a tiny
 * field-op bytecode instead of closures.
 *
 * Instruction format: 5 x int32 per quad: (op, dst, a, b, c).
 * Registers are u64 canonical field elements (< P), except where an
 * instruction documents raw-integer semantics (UDIVC/UMODC operate on
 * the canonical representative as a plain integer, matching the host
 * Python semantics where values are canonical ints in [0, P)).
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef unsigned __int128 u128;
static const uint64_t P = 0xFFFFFFFF00000001ull;

static inline uint64_t wg_add(uint64_t a, uint64_t b) {
    uint64_t s = a + b;
    int ov = s < a;               /* wrapped past 2^64 */
    if (ov || s >= P) s -= P;     /* 2^64 - P = 2^32 - 1 fits: s-P wraps to the right residue */
    return s;
}
static inline uint64_t wg_sub(uint64_t a, uint64_t b) {
    return a >= b ? a - b : a + (P - b);
}
static inline uint64_t wg_reduce128(u128 x) {
    /* Goldilocks reduction: x = lo + 2^64 mid + 2^96 hi-ish; use the
     * standard split (same identity as ops/gf.py reduce128). */
    uint64_t lo = (uint64_t)x;
    uint64_t hi = (uint64_t)(x >> 64);
    uint64_t hi_lo = hi & 0xFFFFFFFFull;  /* 2^64 coeff low 32 */
    uint64_t hi_hi = hi >> 32;            /* 2^96 coeff */
    /* 2^64 = 2^32 - 1 (mod P), 2^96 = -1 (mod P) */
    uint64_t t = wg_sub(lo, hi_hi);
    uint64_t mid = (hi_lo << 32) - hi_lo; /* hi_lo * (2^32 - 1) < P: no overflow */
    return wg_add(t, mid);
}
static inline uint64_t wg_mul(uint64_t a, uint64_t b) {
    return wg_reduce128((u128)a * (u128)b);
}
static inline uint64_t wg_exp(uint64_t base, uint64_t e) {
    uint64_t acc = 1;
    while (e) {
        if (e & 1) acc = wg_mul(acc, base);
        base = wg_mul(base, base);
        e >>= 1;
    }
    return acc;
}
static inline uint64_t wg_inv0(uint64_t a) {
    return a == 0 ? 0 : wg_exp(a, P - 2);
}

enum {
    OP_LOADC = 1,   /* dst <- consts[a] reduced mod P */
    OP_LOADD = 2,   /* dst <- depval[a] */
    OP_ADD = 3,     /* dst <- ra + rb */
    OP_SUB = 4,     /* dst <- ra - rb */
    OP_MUL = 5,     /* dst <- ra * rb */
    OP_INV0 = 6,    /* dst <- ra^-1 (0 -> 0) */
    OP_EXPC = 7,    /* dst <- ra ^ consts[b] (raw u64 exponent) */
    OP_UDIVC = 8,   /* dst <- ra / consts[b] (integer) */
    OP_UMODC = 9,   /* dst <- ra % consts[b] (integer) */
    OP_PICK = 10,   /* dst <- depval[a + r(b)]; c = count bound */
    OP_TBL = 11,    /* dst <- scan consts[b + 2k] == ra -> consts[b+2k+1], k < c */
    OP_OUT = 12,    /* out slot a <- ra' ... encoded: a = out index, b = src reg */
};

enum {
    ERR_CONFLICT = -1,   /* set-twice with different values */
    ERR_TBL_MISS = -2,
    ERR_PICK_RANGE = -3,
    ERR_BAD_OP = -4,
    ERR_OOM = -5,
    ERR_DIV0 = -6,
};

typedef struct {
    const int64_t *rep_map;
    int64_t n_targets, n_reps;
    uint64_t *values;
    uint8_t *flags;

    int64_t n_gens;
    const int32_t *gen_prog;
    const int64_t *dep_off, *dep_flat;
    const int64_t *out_off, *out_flat;

    int64_t n_progs;
    const int64_t *quad_off;
    const int32_t *quads;
    const int64_t *const_off;
    const uint64_t *consts;
    const int32_t *nregs;

    /* watcher CSR keyed by representative */
    int64_t *watch_off;   /* n_reps + 1 */
    int64_t *watch_gen;   /* one entry per (native gen, dep) */

    uint8_t *ran;         /* per gen */
    uint8_t *inq;
    int64_t *queue;       /* ring buffer, capacity n_gens */
    int64_t qhead, qtail, qcount, qcap;

    uint64_t *regs;       /* scratch, max nregs */
    uint64_t *depvals;    /* scratch, max deps per gen */
    int64_t remaining;    /* native gens not yet ran */

    int64_t err_code, err_gen, err_a, err_b;
} wg;

static void wq_push(wg *w, int64_t g) {
    if (w->inq[g] || w->ran[g]) return;
    w->inq[g] = 1;
    w->queue[w->qtail] = g;
    w->qtail = (w->qtail + 1) % w->qcap;
    w->qcount++;
}
static int64_t wq_pop(wg *w) {
    int64_t g = w->queue[w->qhead];
    w->qhead = (w->qhead + 1) % w->qcap;
    w->qcount--;
    w->inq[g] = 0;
    return g;
}

/* set value at rep; returns 1 fresh, 0 already-equal, ERR_CONFLICT */
static int wg_set_rep(wg *w, int64_t rep, uint64_t v) {
    if (w->flags[rep]) {
        return w->values[rep] == v ? 0 : ERR_CONFLICT;
    }
    w->values[rep] = v;
    w->flags[rep] = 1;
    for (int64_t k = w->watch_off[rep]; k < w->watch_off[rep + 1]; k++)
        wq_push(w, w->watch_gen[k]);
    return 1;
}

void *witgen_new(
    const int64_t *rep_map, int64_t n_targets, int64_t n_reps,
    uint64_t *values, uint8_t *flags,
    int64_t n_gens, const int32_t *gen_prog,
    const int64_t *dep_off, const int64_t *dep_flat,
    const int64_t *out_off, const int64_t *out_flat,
    int64_t n_progs, const int64_t *quad_off, const int32_t *quads,
    const int64_t *const_off, const uint64_t *consts, const int32_t *nregs)
{
    wg *w = calloc(1, sizeof(wg));
    if (!w) return NULL;
    w->rep_map = rep_map; w->n_targets = n_targets; w->n_reps = n_reps;
    w->values = values; w->flags = flags;
    w->n_gens = n_gens; w->gen_prog = gen_prog;
    w->dep_off = dep_off; w->dep_flat = dep_flat;
    w->out_off = out_off; w->out_flat = out_flat;
    w->n_progs = n_progs; w->quad_off = quad_off; w->quads = quads;
    w->const_off = const_off; w->consts = consts; w->nregs = nregs;

    w->ran = calloc(n_gens ? n_gens : 1, 1);
    w->inq = calloc(n_gens ? n_gens : 1, 1);
    w->qcap = n_gens + 1;
    w->queue = malloc(sizeof(int64_t) * w->qcap);

    int32_t max_regs = 1;
    for (int64_t p = 0; p < n_progs; p++)
        if (nregs[p] > max_regs) max_regs = nregs[p];
    w->regs = malloc(sizeof(uint64_t) * max_regs);

    int64_t max_deps = 1;
    for (int64_t g = 0; g < n_gens; g++) {
        int64_t nd = dep_off[g + 1] - dep_off[g];
        if (nd > max_deps) max_deps = nd;
    }
    w->depvals = malloc(sizeof(uint64_t) * max_deps);

    if (!w->ran || !w->inq || !w->queue || !w->regs || !w->depvals) {
        w->err_code = ERR_OOM;
        return w;
    }

    /* watcher CSR: count, prefix, fill (native gens only) */
    w->watch_off = calloc(n_reps + 2, sizeof(int64_t));
    if (!w->watch_off) { w->err_code = ERR_OOM; return w; }
    int64_t total = 0;
    for (int64_t g = 0; g < n_gens; g++) {
        if (gen_prog[g] < 0) continue;
        for (int64_t k = dep_off[g]; k < dep_off[g + 1]; k++)
            w->watch_off[rep_map[dep_flat[k]] + 1]++;
        total += dep_off[g + 1] - dep_off[g];
    }
    for (int64_t r = 0; r < n_reps; r++) w->watch_off[r + 1] += w->watch_off[r];
    w->watch_gen = malloc(sizeof(int64_t) * (total ? total : 1));
    int64_t *cursor = calloc(n_reps + 1, sizeof(int64_t));
    if (!w->watch_gen || !cursor) {
        free(cursor);
        w->err_code = ERR_OOM;
        return w;
    }
    for (int64_t g = 0; g < n_gens; g++) {
        if (gen_prog[g] < 0) continue;
        for (int64_t k = dep_off[g]; k < dep_off[g + 1]; k++) {
            int64_t rep = rep_map[dep_flat[k]];
            w->watch_gen[w->watch_off[rep] + cursor[rep]++] = g;
        }
    }
    free(cursor);

    /* enqueue every native generator (mirrors the Python initial pending) */
    w->remaining = 0;
    for (int64_t g = 0; g < n_gens; g++) {
        if (gen_prog[g] < 0) { w->ran[g] = 1; continue; }  /* python-managed */
        w->remaining++;
        wq_push(w, g);
    }
    return w;
}

static int wg_exec(wg *w, int64_t g) {
    int64_t pid = w->gen_prog[g];
    const int32_t *q = w->quads + 5 * w->quad_off[pid];
    const int32_t *qend = w->quads + 5 * w->quad_off[pid + 1];
    const uint64_t *C = w->consts + w->const_off[pid];
    uint64_t *R = w->regs;
    const uint64_t *D = w->depvals;
    const int64_t *outs = w->out_flat + w->out_off[g];
    for (; q < qend; q += 5) {
        int32_t op = q[0], dst = q[1], a = q[2], b = q[3], c = q[4];
        switch (op) {
        case OP_LOADC: { uint64_t v = C[a]; R[dst] = v >= P ? v - P : v; break; }
        case OP_LOADD: R[dst] = D[a]; break;
        case OP_ADD: R[dst] = wg_add(R[a], R[b]); break;
        case OP_SUB: R[dst] = wg_sub(R[a], R[b]); break;
        case OP_MUL: R[dst] = wg_mul(R[a], R[b]); break;
        case OP_INV0: R[dst] = wg_inv0(R[a]); break;
        case OP_EXPC: R[dst] = wg_exp(R[a], C[b]); break;
        case OP_UDIVC:
            if (C[b] == 0) { w->err_code = ERR_DIV0; w->err_gen = g; return -1; }
            R[dst] = R[a] / C[b]; break;
        case OP_UMODC:
            if (C[b] == 0) { w->err_code = ERR_DIV0; w->err_gen = g; return -1; }
            R[dst] = R[a] % C[b]; break;
        case OP_PICK: {
            uint64_t idx = R[b];
            if (idx >= (uint64_t)c) {
                w->err_code = ERR_PICK_RANGE; w->err_gen = g; w->err_a = (int64_t)idx;
                return -1;
            }
            R[dst] = D[a + idx]; break;
        }
        case OP_TBL: {
            uint64_t key = R[a];
            int64_t k = 0;
            for (; k < c; k++)
                if (C[b + 2 * k] == key) { R[dst] = C[b + 2 * k + 1]; break; }
            if (k == c) {
                w->err_code = ERR_TBL_MISS; w->err_gen = g; w->err_a = (int64_t)key;
                return -1;
            }
            break;
        }
        case OP_OUT: {
            int64_t rep = w->rep_map[outs[a]];
            int rc = wg_set_rep(w, rep, R[b]);
            if (rc < 0) {
                w->err_code = rc; w->err_gen = g; w->err_a = outs[a];
                w->err_b = (int64_t)R[b];
                return -1;
            }
            break;
        }
        default:
            w->err_code = ERR_BAD_OP; w->err_gen = g; w->err_a = op;
            return -1;
        }
    }
    return 0;
}

/* Run the fixpoint until the queue drains. Returns 0 (inspect
 * witgen_remaining for unfinished native gens) or <0 on error. */
int64_t witgen_run(void *handle) {
    wg *w = handle;
    if (w->err_code) return w->err_code;
    while (w->qcount) {
        int64_t g = wq_pop(w);
        if (w->ran[g]) continue;
        /* readiness: every dep set */
        int64_t d0 = w->dep_off[g], d1 = w->dep_off[g + 1];
        int ready = 1;
        for (int64_t k = d0; k < d1; k++) {
            int64_t rep = w->rep_map[w->dep_flat[k]];
            if (!w->flags[rep]) { ready = 0; break; }
            w->depvals[k - d0] = w->values[rep];
        }
        if (!ready) continue;  /* will be re-woken when a dep is set */
        if (wg_exec(w, g) < 0) return w->err_code;
        w->ran[g] = 1;
        w->remaining--;
    }
    return 0;
}

/* Bridge: Python sets reps directly (from python-managed generators or
 * the initial PartialWitness); wakes native watchers. */
int64_t witgen_set(void *handle, const int64_t *reps, const uint64_t *vals,
                   int64_t n) {
    wg *w = handle;
    for (int64_t i = 0; i < n; i++) {
        int rc = wg_set_rep(w, reps[i], vals[i]);
        if (rc < 0) {
            w->err_code = rc; w->err_gen = -1; w->err_a = reps[i];
            w->err_b = (int64_t)vals[i];
            return rc;
        }
    }
    return 0;
}

int64_t witgen_remaining(void *handle) { return ((wg *)handle)->remaining; }

void witgen_err(void *handle, int64_t *out4) {
    wg *w = handle;
    out4[0] = w->err_code; out4[1] = w->err_gen;
    out4[2] = w->err_a; out4[3] = w->err_b;
}

void witgen_free(void *handle) {
    wg *w = handle;
    if (!w) return;
    free(w->watch_off); free(w->watch_gen);
    free(w->ran); free(w->inq); free(w->queue);
    free(w->regs); free(w->depvals);
    free(w);
}

// Hand-written Hopper kernels for the width-12 Poseidon permutation over
// Goldilocks, the two-to-one compression and the overwrite-mode sponge.
//
// poseidon_permute_kernel replaces the TPU kernel
//   plonky2_tpu/ops/poseidon_pallas.py :: permute_t
// and poseidon_compress_kernel is its two-to-one form (the state is the 8
// input words and four zeros; lanes 0..3 are written), the function of
// plonky2_tpu/ops/poseidon.py :: two_to_one.
// poseidon_sponge_kernel replaces
//   plonky2_tpu/ops/poseidon_pallas.py :: sponge_t
//
// What bounds them on this card: integer instruction issue. A permutation
// is about 6,500 32x32->64 multiply-adds (fast partial rounds) against 192
// bytes moved for a bare permutation, 96 for a compression or 64 absorbed a
// permutation in the sponge, so memory is never the limit; and every
// multiply comes with carries, selects and reductions that issue on the
// same integer pipe. The design therefore cuts instructions:
//
// * Fast partial rounds (hash/poseidon_fast.py, the tables generated into
//   poseidon_constants.cuh): the 22 partial rounds run the sparse form, one
//   S-box, one lane-0 constant and 23 products by 64-bit constants a round,
//   after one 11x11 product by the initial matrix; no dense MDS runs in a
//   partial round. The 8 full rounds keep the dense MDS, whose entries are
//   < 2^6, on the 32-bit halves of the state.
// * Lazy reduction: a state word is any 64-bit value standing for its
//   residue mod p ("lazy word"); products reduce 128 -> 64 bits without the
//   final compare-and-subtract, dot products accumulate whole 128-bit
//   products in three words and reduce once per sum, and words are made
//   canonical only where they are written out.
// * Carries come from PTX add.cc/addc chains, not from compares.
// * Thread mapping: one state per thread, the 12 words in registers for all
//   30 rounds (and across the sponge's permutations). The full rounds offer
//   12 independent S-boxes and the partial rounds 23 independent products,
//   so no shuffles between threads are spent on splitting a state. Chosen
//   from ptxas -v and timings on the H100 (PERF.md, section 6): the
//   kernels are bound by the integer pipe, and time follows the SASS
//   count. At 126-128 registers 16 warps fit an SM; capping registers
//   lower (more warps) spills, adds instructions and is slower, lifting the
//   cap (8 warps) is slower too; 256-thread blocks beat 128 by about 7 %.
//   __launch_bounds__(256, 2) keeps a thread at 128 registers. The round
//   loops stay rolled (unroll 1): each round's constants are one uniform
//   constant-cache load, and the code of a permutation stays about 100 KB;
//   unrolling the 22 partial rounds made it slower.
//
// The sponge stages its input through shared memory: a block of 256 rows
// loads each 8-column chunk of its rows with cp.async, 16 bytes a copy,
// neighbouring threads on neighbouring 16-byte pieces of a row; two
// buffers, the chunk after next loaded while the permutation absorbs the
// current one (so w <= 16, two chunks, is loaded whole before the first
// permutation). A row's chunk starts at word r*w + 8c, which for odd w is
// odd every other row, so each row takes the five 16-byte pairs that cover
// its eight words and reads from the second word when its start is odd.
// Slots are five pairs (80 bytes) a row: the copies write one contiguous
// run, and the 16-byte reads of eight neighbouring threads are 5 pairs
// apart, an odd stride, so they fall on eight different bank quads.
//
// Global layout: state-major, [B, 12] for the permutation, [B, 8] for the
// compression (a digest level [2B, 4] read as pairs, no copy), [B, w] for
// the sponge (the point-major Merkle leaf matrix), rows contiguous; the
// sponge's input must be 16-byte aligned (the wrapper checks).
//
// The interface is plain C (no PyTorch headers): pointers and the stream
// come from the Python wrapper, which also allocates the outputs. Each
// entry point returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "goldilocks.cuh"
#include "poseidon_constants.cuh"

#define POSEIDON_THREADS 256
#define POSEIDON_MIN_BLOCKS 2
#define SPONGE_PAIRS 5  // 16-byte pairs staged a row and chunk

// ---------------------------------------------------------------------------
// Lazy Goldilocks arithmetic. A lazy word is any uint64_t; its value is its
// residue mod p. Inputs of every function here may be lazy.
// ---------------------------------------------------------------------------

// (lo + 2^64 * (hl + 2^32 * H)) mod p as a lazy word, for hl < 2^32 and
// H < 2^64 - 2^32. Uses 2^64 = eps = 2^32 - 1 and 2^96 = -1 (mod p):
// the value is lo + hl * eps - H.
__device__ __forceinline__ uint64_t gl_reduce_lazy(uint64_t lo, uint32_t hl, uint64_t H) {
    uint64_t t0;
    uint32_t borrow_eps;
    // t0 = lo - H; a borrow wrapped t0 up by 2^64 = eps, so eps comes off
    // again. subc from 0 gives 0xffffffff = eps on a borrow, else 0. On a
    // borrow t0 = 2^64 - (H - lo) > 2^32, so t0 - eps does not wrap.
    asm("sub.cc.u64 %0, %2, %3;\n\t"
        "subc.u32 %1, 0, 0;"
        : "=l"(t0), "=r"(borrow_eps) : "l"(lo), "l"(H));
    t0 -= borrow_eps;
    // hl * eps = hl * 2^32 - hl < 2^64
    uint64_t t1 = ((uint64_t)hl << 32) - hl;
    uint64_t r;
    uint32_t carry;
    asm("add.cc.u64 %0, %2, %3;\n\t"
        "addc.u32 %1, 0, 0;"
        : "=l"(r), "=r"(carry) : "l"(t0), "l"(t1));
    // a carry is worth 2^64 = eps; then r < t1 <= (2^32 - 1)^2, so
    // r + eps < 2^64
    return r + (uint64_t)carry * GL_EPS;
}

// (lo + 2^64 * hi) mod p, lazy
__device__ __forceinline__ uint64_t gl_reduce128_lazy(uint64_t lo, uint64_t hi) {
    return gl_reduce_lazy(lo, (uint32_t)hi, hi >> 32);
}

__device__ __forceinline__ uint64_t gl_mul_lazy(uint64_t a, uint64_t b) {
    return gl_reduce128_lazy(a * b, __umul64hi(a, b));
}

// (a * b + c) mod p, lazy, for b < p: a * b + c <= (2^64 - 1)(p - 1) +
// 2^64 - 1 < 2^128, so the 128-bit sum does not overflow.
__device__ __forceinline__ uint64_t gl_mul_add_lazy(uint64_t a, uint64_t b, uint64_t c) {
    uint64_t lo, hi;
    asm("mad.lo.cc.u64 %0, %2, %3, %4;\n\t"
        "madc.hi.u64 %1, %2, %3, 0;"
        : "=l"(lo), "=l"(hi) : "l"(a), "l"(b), "l"(c));
    return gl_reduce128_lazy(lo, hi);
}

// x + c mod p, lazy, for a constant c < p: on a carry-out the sum wrapped
// by 2^64 = eps, and r = x + c - 2^64 < c, so r + eps < p + eps = 2^64.
__device__ __forceinline__ uint64_t gl_add_const_lazy(uint64_t x, uint64_t c) {
    uint64_t r;
    uint32_t carry;
    asm("add.cc.u64 %0, %2, %3;\n\t"
        "addc.u32 %1, 0, 0;"
        : "=l"(r), "=r"(carry) : "l"(x), "l"(c));
    return r + (uint64_t)carry * GL_EPS;
}

// A sum of products in three words: value = lo + 2^64 * hi + 2^128 * top.
struct Acc192 {
    uint64_t lo, hi;
    uint32_t top;
};

// acc += a * b (whole 128-bit product; the carry out of hi goes to top)
__device__ __forceinline__ void acc_mad(Acc192& acc, uint64_t a, uint64_t b) {
    asm("mad.lo.cc.u64 %0, %3, %4, %0;\n\t"
        "madc.hi.cc.u64 %1, %3, %4, %1;\n\t"
        "addc.u32 %2, %2, 0;"
        : "+l"(acc.lo), "+l"(acc.hi), "+r"(acc.top) : "l"(a), "l"(b));
}

// acc mod p, lazy, for top < 2^32 - 1: 2^128 = -2^32, so the value is
// lo + eps * (hi mod 2^32) - ((hi >> 32) + 2^32 * top).
__device__ __forceinline__ uint64_t acc_reduce(const Acc192& acc) {
    return gl_reduce_lazy(acc.lo, (uint32_t)acc.hi,
                          (acc.hi >> 32) | ((uint64_t)acc.top << 32));
}

// ---------------------------------------------------------------------------
// The permutation
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint64_t poseidon_sbox7(uint64_t x) {
    uint64_t x2 = gl_mul_lazy(x, x);
    uint64_t x3 = gl_mul_lazy(x, x2);
    uint64_t x4 = gl_mul_lazy(x2, x2);
    return gl_mul_lazy(x3, x4);
}

// s <- MDS * s (the full rounds' dense layer). Entries are < 2^6, so the
// 32-bit halves of the words go through the matrix separately: each half
// sum is < 12 * 2^6 * 2^32 < 2^42 and one 32x32->64 multiply-add
// (mad.wide.u32, one IMAD.WIDE) a term. Row r's value is lo + 2^32 * hi
// < 2^75, reduced once. Written as PTX: from plain C the compiler left
// additions of zero high words and moves in this layer, about 1,000 SASS
// instructions a permutation more.
__device__ __forceinline__ void poseidon_mds_full(uint64_t (&s)[POSEIDON_WIDTH]) {
    constexpr uint32_t circ[POSEIDON_WIDTH] = POSEIDON_MDS_CIRC;
    constexpr uint32_t diag[POSEIDON_WIDTH] = POSEIDON_MDS_DIAG;
    uint32_t lo[POSEIDON_WIDTH], hi[POSEIDON_WIDTH];
#pragma unroll
    for (int j = 0; j < POSEIDON_WIDTH; ++j) {
        lo[j] = (uint32_t)s[j];
        hi[j] = (uint32_t)(s[j] >> 32);
    }
#pragma unroll
    for (int r = 0; r < POSEIDON_WIDTH; ++r) {
        uint64_t acc_lo, acc_hi;
        asm("mul.wide.u32 %0, %1, %2;" : "=l"(acc_lo) : "r"(lo[r]), "r"(circ[0] + diag[r]));
        asm("mul.wide.u32 %0, %1, %2;" : "=l"(acc_hi) : "r"(hi[r]), "r"(circ[0] + diag[r]));
#pragma unroll
        for (int j = 0; j < POSEIDON_WIDTH; ++j) {
            if (j == r) continue;
            uint32_t c = circ[(j - r + POSEIDON_WIDTH) % POSEIDON_WIDTH];
            asm("mad.wide.u32 %0, %1, %2, %0;" : "+l"(acc_lo) : "r"(lo[j]), "r"(c));
            asm("mad.wide.u32 %0, %1, %2, %0;" : "+l"(acc_hi) : "r"(hi[j]), "r"(c));
        }
        // lo + 2^32 * hi = t + 2^64 * k with t = lo + 2^32 * (hi mod 2^32)
        // (its carry goes into k) and k = (hi >> 32) + carry < 2^11; then
        // 2^64 = eps gives t + k * eps, k * eps < 2^43, and a carry out of
        // that sum is worth eps once more (the wrapped sum is < 2^43).
        uint64_t out;
        asm("{\n\t"
            ".reg .u32 l0, l1, h0, h1, k, e0, e1;\n\t"
            ".reg .u64 e, t;\n\t"
            "mov.b64 {l0, l1}, %1;\n\t"
            "mov.b64 {h0, h1}, %2;\n\t"
            "add.cc.u32 l1, l1, h0;\n\t"
            "addc.u32 k, h1, 0;\n\t"
            "mul.wide.u32 e, k, 0xffffffff;\n\t"
            "mov.b64 {e0, e1}, e;\n\t"
            "add.cc.u32 l0, l0, e0;\n\t"
            "addc.cc.u32 l1, l1, e1;\n\t"
            "addc.u32 k, 0, 0;\n\t"
            "mov.b64 t, {l0, l1};\n\t"
            "mad.wide.u32 %0, k, 0xffffffff, t;\n\t"
            "}"
            : "=l"(out) : "l"(acc_lo), "l"(acc_hi));
        s[r] = out;
    }
}

__device__ __forceinline__ void poseidon_full_round(uint64_t (&s)[POSEIDON_WIDTH], int round) {
    const uint64_t* rc = POSEIDON_RC + round * POSEIDON_WIDTH;
#pragma unroll
    for (int i = 0; i < POSEIDON_WIDTH; ++i) s[i] = poseidon_sbox7(gl_add_const_lazy(s[i], rc[i]));
    poseidon_mds_full(s);
}

// The 22 partial rounds in the fast form (hash/poseidon_fast.py
// permute_fast): partial_first_constant_layer, mds_partial_layer_init,
// then per round the S-box and constant on lane 0 and the sparse product
//   s0' = MDS[0][0] * s0 + sum_i W_HATS[r][i-1] * s[i],
//   s[i] += s0 * VS[r][i-1]            (i = 1..11, s0 after the S-box).
__device__ __forceinline__ void poseidon_partial_rounds(uint64_t (&s)[POSEIDON_WIDTH]) {
#pragma unroll
    for (int i = 0; i < POSEIDON_WIDTH; ++i)
        s[i] = gl_add_const_lazy(s[i], POSEIDON_FAST_FIRST_RC[i]);
    // out[c] = sum_{r=1..11} s[r] * INIT[r-1][c-1]; 11 products < 2^128,
    // so the top word stays < 11
    uint64_t t[POSEIDON_WIDTH];
    t[0] = s[0];
#pragma unroll
    for (int c = 1; c < POSEIDON_WIDTH; ++c) {
        Acc192 acc = {0, 0, 0};
#pragma unroll
        for (int r = 1; r < POSEIDON_WIDTH; ++r)
            acc_mad(acc, s[r], POSEIDON_FAST_INIT[(r - 1) * (POSEIDON_WIDTH - 1) + (c - 1)]);
        t[c] = acc_reduce(acc);
    }
#pragma unroll
    for (int i = 0; i < POSEIDON_WIDTH; ++i) s[i] = t[i];

#pragma unroll 1
    for (int r = 0; r < POSEIDON_PARTIAL_ROUNDS; ++r) {
        const uint64_t* w_hat = POSEIDON_FAST_W_HATS + r * (POSEIDON_WIDTH - 1);
        const uint64_t* v = POSEIDON_FAST_VS + r * (POSEIDON_WIDTH - 1);
        // the last round's constant is 0 in the table, so no branch
        uint64_t s0 = gl_add_const_lazy(poseidon_sbox7(s[0]), POSEIDON_FAST_RC[r]);
        // 25 * s0 < 2^69 plus 11 products < 2^128: the top word stays < 12
        Acc192 acc = {s0 * POSEIDON_MDS_0_0, __umul64hi(s0, POSEIDON_MDS_0_0), 0};
#pragma unroll
        for (int i = 1; i < POSEIDON_WIDTH; ++i) {
            acc_mad(acc, s[i], w_hat[i - 1]);
            s[i] = gl_mul_add_lazy(s0, v[i - 1], s[i]);
        }
        s[0] = acc_reduce(acc);
    }
}

__device__ __forceinline__ void poseidon_permute_regs(uint64_t (&s)[POSEIDON_WIDTH]) {
#pragma unroll 1
    for (int round = 0; round < POSEIDON_HALF_FULL_ROUNDS; ++round) poseidon_full_round(s, round);
    poseidon_partial_rounds(s);
#pragma unroll 1
    for (int round = POSEIDON_HALF_FULL_ROUNDS + POSEIDON_PARTIAL_ROUNDS;
         round < POSEIDON_ROUNDS; ++round)
        poseidon_full_round(s, round);
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

// in, out: [batch, 12] canonical words.
__global__ void __launch_bounds__(POSEIDON_THREADS, POSEIDON_MIN_BLOCKS)
poseidon_permute_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                        long long batch) {
    long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= batch) return;
    const uint64_t* src = in + b * POSEIDON_WIDTH;
    uint64_t s[POSEIDON_WIDTH];
#pragma unroll
    for (int i = 0; i < POSEIDON_WIDTH; ++i) s[i] = src[i];
    poseidon_permute_regs(s);
    uint64_t* dst = out + b * POSEIDON_WIDTH;
#pragma unroll
    for (int i = 0; i < POSEIDON_WIDTH; ++i) dst[i] = gl_canon(s[i]);
}

// in: [batch, 8] canonical words (left digest, right digest); out: [batch, 4]
// = lanes 0..3 of the permutation of (in, 0, 0, 0, 0).
__global__ void __launch_bounds__(POSEIDON_THREADS, POSEIDON_MIN_BLOCKS)
poseidon_compress_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                         long long batch) {
    long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= batch) return;
    const uint64_t* src = in + b * POSEIDON_RATE;
    uint64_t s[POSEIDON_WIDTH];
#pragma unroll
    for (int i = 0; i < POSEIDON_RATE; ++i) s[i] = src[i];
#pragma unroll
    for (int i = POSEIDON_RATE; i < POSEIDON_WIDTH; ++i) s[i] = 0;
    poseidon_permute_regs(s);
    uint64_t* dst = out + b * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[i] = gl_canon(s[i]);
}

// 16-byte global -> shared copy; bytes (8 or 16) are read, the rest of the
// 16 is zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
    unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(gmem),
                 "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }

// waits until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;"); }

// Starts the copy of chunk `chunk` of the block's rows into slots[row][pair]:
// row t's chunk starts at word o = (row0 + t) * w + 8 * chunk and is covered
// by the pairs (o & ~1) / 2 + j, j = 0..3, and j = 4 when o is odd. Pairs
// past the last word of the tensor are not copied; a pair holding the last
// word alone copies 8 bytes.
__device__ __forceinline__ void sponge_stage_chunk(ulonglong2 (*slots)[SPONGE_PAIRS],
                                                   const uint64_t* in, long long row0,
                                                   long long batch, int w, int chunk) {
    const long long total = batch * (long long)w;
#pragma unroll
    for (int n = 0; n < SPONGE_PAIRS; ++n) {  // blockDim.x == POSEIDON_THREADS
        int f = n * POSEIDON_THREADS + threadIdx.x;
        int t = f / SPONGE_PAIRS, j = f - t * SPONGE_PAIRS;
        long long row = row0 + t;
        if (row >= batch) continue;
        long long o = row * w + 8LL * chunk;
        if (j == SPONGE_PAIRS - 1 && !(o & 1)) continue;
        long long word = (o & ~1LL) + 2 * j;
        if (word >= total) continue;
        cp_async16(&slots[t][j], in + word, total - word >= 2 ? 16 : 8);
    }
}

// in: [batch, w] canonical words, w >= 1, 16-byte aligned; out: [batch, 4].
// The state starts at zero except lane 8 = cap_val; each chunk of up to 8
// inputs overwrites lanes 0..k-1 (a short last chunk leaves the other rate
// lanes as they are) and is followed by one permutation.
__global__ void __launch_bounds__(POSEIDON_THREADS, POSEIDON_MIN_BLOCKS)
poseidon_sponge_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                       long long batch, int w, uint64_t cap_val) {
    __shared__ __align__(16) ulonglong2 stage[2][POSEIDON_THREADS][SPONGE_PAIRS];
    const long long row0 = (long long)blockIdx.x * POSEIDON_THREADS;
    const long long b = row0 + threadIdx.x;
    const bool live = b < batch;
    const int chunks = (w + POSEIDON_RATE - 1) / POSEIDON_RATE;

    // chunks 0 and 1 now: one commit group each (an empty one if w <= 8)
    sponge_stage_chunk(stage[0], in, row0, batch, w, 0);
    cp_async_commit();
    if (chunks > 1) sponge_stage_chunk(stage[1], in, row0, batch, w, 1);
    cp_async_commit();

    uint64_t s[POSEIDON_WIDTH];
#pragma unroll
    for (int i = 0; i < POSEIDON_WIDTH; ++i) s[i] = 0;
    s[POSEIDON_RATE] = gl_canon(cap_val);
    const int odd = live ? (int)((b * w) & 1) : 0;  // the same for every chunk

    for (int c = 0; c < chunks; ++c) {
        // groups committed: chunks 0..c+1; all but the newest are done
        cp_async_wait_one();
        __syncthreads();
        if (live) {
            const ulonglong2* slot = stage[c & 1][threadIdx.x];
            uint64_t words[2 * SPONGE_PAIRS];
#pragma unroll
            for (int j = 0; j < SPONGE_PAIRS; ++j) {
                ulonglong2 pr = slot[j];
                words[2 * j] = pr.x;
                words[2 * j + 1] = pr.y;
            }
            const int k = w - c * POSEIDON_RATE;
#pragma unroll
            for (int i = 0; i < POSEIDON_RATE; ++i)
                if (i < k) s[i] = odd ? words[i + 1] : words[i];
        }
        __syncthreads();  // every row is read out of this buffer ...
        if (c + 2 < chunks) sponge_stage_chunk(stage[c & 1], in, row0, batch, w, c + 2);
        cp_async_commit();  // ... before chunk c + 2 goes into it
        if (live) poseidon_permute_regs(s);
    }
    if (!live) return;
    uint64_t* dst = out + b * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[i] = gl_canon(s[i]);
}

static inline unsigned int poseidon_blocks(long long batch) {
    return (unsigned int)((batch + POSEIDON_THREADS - 1) / POSEIDON_THREADS);
}

extern "C" int plonky2_poseidon_permute(const void* in, void* out, long long batch,
                                        void* stream) {
    if (batch <= 0) return 0;
    poseidon_permute_kernel<<<poseidon_blocks(batch), POSEIDON_THREADS, 0,
                              (cudaStream_t)stream>>>(
        (const uint64_t*)in, (uint64_t*)out, batch);
    return (int)cudaGetLastError();
}

extern "C" int plonky2_poseidon_compress(const void* in, void* out, long long batch,
                                         void* stream) {
    if (batch <= 0) return 0;
    poseidon_compress_kernel<<<poseidon_blocks(batch), POSEIDON_THREADS, 0,
                               (cudaStream_t)stream>>>(
        (const uint64_t*)in, (uint64_t*)out, batch);
    return (int)cudaGetLastError();
}

extern "C" int plonky2_poseidon_sponge(const void* in, void* out, long long batch, int w,
                                       unsigned long long cap_val, void* stream) {
    if (batch <= 0) return 0;
    poseidon_sponge_kernel<<<poseidon_blocks(batch), POSEIDON_THREADS, 0,
                             (cudaStream_t)stream>>>(
        (const uint64_t*)in, (uint64_t*)out, batch, w, (uint64_t)cap_val);
    return (int)cudaGetLastError();
}

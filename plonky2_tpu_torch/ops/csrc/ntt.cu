// Hand-written Hopper kernels for the radix-2 DIT butterflies of the NTT
// over Goldilocks.
//
// col_fft_kernel replaces the TPU kernel
//   plonky2_tpu/ops/pallas_kernels.py :: _col_fft_call (col_fft)
// row_fft_kernel replaces
//   plonky2_tpu/ops/pallas_kernels.py :: _row_fft_core (row_fft_bitrev)
// ntt_stage_kernel runs, one launch a stage, what the passes of the two
// cannot cover: columns past 2^12 positions, rows past 2^24 words (the TPU
// code ran those stages as XLA passes).
//
// Both compute DIT stages first..k-1 of a transform whose input is already
// bit-reversed along the transform axis (or seeded past the first `first`
// stages, see ops/ntt.py lde_onto_coset), with no 1/N scaling. Stage s
// pairs positions p and p + 2^s inside aligned groups of 2^(s+1) and
// multiplies the upper partner by w_{s+1}^(p mod 2^s), w_{s+1} the
// primitive 2^(s+1)-th root (or its inverse): the twiddle depends on the
// absolute stage only, never on the transform length. `tw` holds every
// stage's table back to back, stage s at tw[2^s - 1 + j].
//
// What bounds them on this card: bytes for the tail stages (one full read
// and write of the tensor per stage); instruction issue for the passes,
// which read and write the tensor once but issue about 59 SASS
// instructions a butterfly, about 54 of them in gl_mul, gl_add and gl_sub
// (a 64x64 product, its reduction, an add and a subtract, each canonical).
//
// A pass runs stages [a, b) of [B, 2^k, 2^l_log] (axis -2 the transform
// axis): those only pair positions with the same residue mod 2^a inside
// one aligned group of 2^b, so a tile is the 2^(b-a) positions
// hi * 2^b + jt + i * 2^a (i < 2^(b-a)) of 2^lt neighbouring "lanes" that
// share a twiddle pattern, and its loads run in runs of 2^lt words.
//
// col_fft_kernel: the lanes are 2^lt neighbouring columns along L, which is
// contiguous; a lane does not enter the twiddle.
//
// row_fft_kernel: rows are contiguous (l_log = 0), and the lanes are 2^lt
// neighbouring residues jt + l: position i * 2^a + jt + l, with l in the
// twiddle index. A row of 2^n words runs in one pass up to 2^13 words
// (stages [first, n) on whole rows, 2^rb short rows sharing a tile) and in
// two past it: stages [first, a) on each contiguous 2^a-word chunk (a
// pass over [rows * 2^(n-a), 2^a]), then stages [a, n) on tiles of 2^(n-a)
// positions x 2^lt residues. The host's plan (ops/ntt_cuda.py row_plan,
// col_plan) picks the passes, the lanes, the rows a tile and the stage
// groups.
//
// Inside a tile the stages run in groups of at most NTT_COL_RADIX_LOG
// stages on 2^G words a thread held in registers: a thread loads the 2^G
// words i0 + m * 2^s (m < 2^G) of one lane, runs stages s..s+G-1 on them
// with the 2^G - 1 twiddles they need, and writes them back. The first
// group loads straight from device memory, the last stores straight to
// it, and the tile sits in shared memory only between groups: a pass of n
// stages costs ceil(n / NTT_COL_RADIX_LOG) - 1 barriers and shared-memory
// round trips, not one of each a stage. Tiles of 64 KB let three blocks
// share an SM, so one block's loads overlap another's arithmetic.
//
// ntt_stage_kernel: one thread per butterfly of one stage, in place, over
// [B, N, L]; neighbouring threads take neighbouring lanes (or, for L = 1,
// neighbouring positions), so its loads are coalesced.
//
// The TPU kernels' mask+roll form and (8, 128) tiling were Mosaic
// workarounds; here the partner is indexed directly.
//
// The interface is plain C (no PyTorch headers): pointers and the stream
// come from the Python wrapper, which also allocates the output. Each
// entry point returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "goldilocks.cuh"

#define NTT_TILE_WORDS_LOG 14
#define NTT_STAGE_THREADS 256
#define NTT_STAGE_MAX_BLOCKS (132 * 32)
// passes: threads a block at most and the blocks an SM the registers are
// sized for (64 KB tiles: three fit in shared memory), of each kernel;
// stages a group runs in registers at most (2^NTT_COL_RADIX_LOG words a
// thread), in both
#define NTT_COL_THREADS 256
#define NTT_COL_MIN_BLOCKS 3
#define NTT_ROW_THREADS 256
#define NTT_ROW_MIN_BLOCKS 3
#define NTT_COL_RADIX_LOG 4

// ---------------------------------------------------------------------------
// Passes (col_fft_kernel, row_fft_kernel)
// ---------------------------------------------------------------------------

// Shared-memory word of the row-major tile word w = i * 2^lt + l: its low
// four bits XORed with the next four (a bijection on each aligned 256
// words). A half-warp's sixteen 8-byte accesses then fall on sixteen
// different bank pairs whether its threads take sixteen lanes of one
// position or a few lanes of consecutive or 2^G-strided positions.
__device__ __forceinline__ uint32_t col_swizzle(uint32_t w) { return w ^ ((w >> 4) & 15u); }

// Stages S..S+G-1 on the words a[m] (m < 2^G) at positions p0 + m * 2^S,
// p0 mod 2^S = J: stage S + t pairs a[m] with a[m + 2^t] (bit t of m
// clear) under the twiddle tw[2^(S+t) - 1 + J + (m mod 2^t) * 2^S]. With
// ZERO_J (J = 0, known when the code is compiled) the pairs with m mod 2^t
// = 0 have the twiddle 1, and their product is gl_canon, which gl_mul(v, 1)
// equals for every 64-bit v: 1, 3, 7 and 15 of the 1, 4, 12 and 32
// products of G = 1..4. The code is one basic block, so the compiler
// interleaves the independent butterflies of a stage (a branch around a
// product would serialise them).
template <int G, bool ZERO_J>
__device__ __forceinline__ void radix_stages(uint64_t (&a)[1 << G], int S, uint32_t J,
                                             const uint64_t* __restrict__ tw) {
#pragma unroll
    for (int t = 0; t < G; ++t) {
        const int h = 1 << t;
        const uint64_t* ts = tw + ((1u << (S + t)) - 1) + J;
#pragma unroll
        for (int m = 0; m < (1 << G); ++m) {
            if (m & h) continue;
            const int u = m & (h - 1);
            const uint64_t v = ZERO_J && u == 0
                                   ? gl_canon(a[m + h])
                                   : gl_mul(a[m + h], __ldg(ts + ((uint32_t)u << S)));
            const uint64_t u0 = a[m];
            a[m] = gl_add(u0, v);
            a[m + h] = gl_sub(u0, v);
        }
    }
}

// One group of a pass: stages a+s..a+s+G-1 over the whole tile (2^n
// positions of 2^lt lanes; in a row pass, `nb` such blocks of positions,
// one a row or chunk), one set of 2^G words a thread at a time. A set is
// lane l, positions i0 + m * 2^s with i0 = hi * 2^(s+G) + jl (jl < 2^s);
// its words sit at g + i * 2^pos_log + l in device memory (g: the tile's
// first word; a row pass adds h * 2^h_log for the tile's h-th row or chunk)
// and at col_swizzle((h * 2^n + i) * 2^lt + l) in shared memory. The
// twiddle pattern's residue is jt + (jl << a), plus the lane in a row pass
// (ROW), where the lanes are neighbouring residues.
template <int G, bool FROM_GLOBAL, bool TO_GLOBAL, bool ZERO_J, bool ROW>
__device__ __forceinline__ void pass_group(const uint64_t* x, uint64_t* y, uint64_t* tile,
                                           long long g, int pos_log, int h_log, int a, int n,
                                           int lt, int s, uint32_t jt, int nb,
                                           const uint64_t* __restrict__ tw) {
    const int items = (ROW ? nb : 1) << (n - G + lt);
    const int S = a + s;
    const long long step = 1LL << (s + pos_log);
#pragma unroll 1
    for (int idx = threadIdx.x; idx < items; idx += blockDim.x) {
        const uint32_t l = idx & ((1 << lt) - 1);
        const uint32_t r = idx >> lt;
        const uint32_t q = ROW ? r & ((1u << (n - G)) - 1) : r;
        const uint32_t jl = q & ((1u << s) - 1);
        const uint32_t i0 = ((q >> s) << (s + G)) | jl;
        uint32_t w0 = (i0 << lt) | l;
        long long g0 = g + ((long long)i0 << pos_log) + l;
        if (ROW) {
            const uint32_t h = r >> (n - G);
            w0 |= h << (n + lt);
            g0 += (long long)h << h_log;
        }
        const uint32_t wstep = 1u << (s + lt);
        uint64_t v[1 << G];
#pragma unroll
        for (int m = 0; m < (1 << G); ++m) {
            v[m] = FROM_GLOBAL ? x[g0 + m * step] : tile[col_swizzle(w0 + m * wstep)];
        }
        radix_stages<G, ZERO_J>(v, S, ZERO_J ? 0 : jt + (ROW ? l : 0) + (jl << a), tw);
#pragma unroll
        for (int m = 0; m < (1 << G); ++m) {
            if (TO_GLOBAL) {
                y[g0 + m * step] = v[m];
            } else {
                tile[col_swizzle(w0 + m * wstep)] = v[m];
            }
        }
    }
}

// The group's code for where its words come from and go to; the first
// group of a tile whose sets all have J = 0 takes ZERO_J.
template <int G, bool ROW>
__device__ __forceinline__ void pass_group_at(bool from_global, bool to_global, bool zero_j,
                                              const uint64_t* x, uint64_t* y, uint64_t* tile,
                                              long long g, int pos_log, int h_log, int a, int n,
                                              int lt, int s, uint32_t jt, int nb,
                                              const uint64_t* __restrict__ tw) {
#define PASS_GROUP(F, T, Z) \
    pass_group<G, F, T, Z, ROW>(x, y, tile, g, pos_log, h_log, a, n, lt, s, jt, nb, tw)
    if (zero_j && to_global) {
        PASS_GROUP(true, true, true);
    } else if (zero_j) {
        PASS_GROUP(true, false, true);
    } else if (from_global && to_global) {
        PASS_GROUP(true, true, false);
    } else if (from_global) {
        PASS_GROUP(true, false, false);
    } else if (to_global) {
        PASS_GROUP(false, true, false);
    } else {
        PASS_GROUP(false, false, false);
    }
#undef PASS_GROUP
}

// The stage groups of one tile, `groups` holding their sizes (1..
// NTT_COL_RADIX_LOG, summing to the pass's stages) four bits each from the
// lowest; zero_j: the first group's sets all have J = 0.
template <bool ROW>
__device__ __forceinline__ void pass_groups(const uint64_t* x, uint64_t* y, uint64_t* tile,
                                            long long g, int pos_log, int h_log, int a, int n,
                                            int lt, uint32_t jt, int nb, bool zero_j,
                                            unsigned groups, const uint64_t* __restrict__ tw) {
    int s = 0;
    for (unsigned rest = groups; rest; rest >>= 4) {
        const int G = rest & 15;
        const bool from_global = s == 0;
        const bool to_global = (rest >> 4) == 0;
        const bool zj = from_global && zero_j;
        if (!from_global) __syncthreads();
#define GROUP_AT(K) \
    pass_group_at<K, ROW>(from_global, to_global, zj, x, y, tile, g, pos_log, h_log, a, n, lt, \
                          s, jt, nb, tw)
        switch (G) {
            case 1: GROUP_AT(1); break;
            case 2: GROUP_AT(2); break;
            case 3: GROUP_AT(3); break;
            default:
                if constexpr (NTT_COL_RADIX_LOG >= 4) {
                    GROUP_AT(4);
                }
                break;
        }
#undef GROUP_AT
        s += G;
    }
}

// x, y: [B, 2^k, 2^l_log] (y may be x: a tile reads all its words before it
// writes any). Stages [a, b) in tiles of 2^(b-a) positions x 2^lt lanes,
// running the stage groups packed in `groups`. Block i takes tile i: from
// i's lowest bits up, the lane tile, jt < 2^a, and hb = batch * 2^(k-b) + hi.
__global__ void __launch_bounds__(NTT_COL_THREADS, NTT_COL_MIN_BLOCKS)
col_fft_kernel(const uint64_t* x, uint64_t* y, int l_log, int a, int b, int lt,
               unsigned groups, const uint64_t* __restrict__ tw) {
    extern __shared__ uint64_t tile[];
    const int tiles_l_log = l_log - lt;
    const unsigned long long blk = blockIdx.x;
    const long long lane_tile = blk & ((1ULL << tiles_l_log) - 1);
    const uint32_t jt = (uint32_t)((blk >> tiles_l_log) & ((1ULL << a) - 1));
    const long long hb = (long long)(blk >> (tiles_l_log + a));
    const long long g = (hb << (b + l_log)) + ((long long)jt << l_log) + (lane_tile << lt);
    pass_groups<false>(x, y, tile, g, a + l_log, 0, a, b - a, lt, jt, 1, jt == 0, groups, tw);
}

// x, y: `hbs` contiguous groups of 2^b words (y may be x). Stages [a, b) in
// tiles of 2^rb groups (fewer in the last block) x 2^(b-a) positions x 2^lt
// residues. Block i: from i's lowest bits up, the residue tile (jt = its
// index * 2^lt) and the first group's index / 2^rb. With lt = 0 the one
// residue of the first group's sets is jt, so a tile with jt = 0 takes
// ZERO_J.
__global__ void __launch_bounds__(NTT_ROW_THREADS, NTT_ROW_MIN_BLOCKS)
row_fft_kernel(const uint64_t* x, uint64_t* y, long long hbs, int a, int b, int lt, int rb,
               unsigned groups, const uint64_t* __restrict__ tw) {
    extern __shared__ uint64_t tile[];
    const unsigned long long blk = blockIdx.x;
    const uint32_t jt = (uint32_t)(blk & ((1ULL << (a - lt)) - 1)) << lt;
    const long long hb = (long long)(blk >> (a - lt)) << rb;
    const int nb = hbs - hb < (1LL << rb) ? (int)(hbs - hb) : 1 << rb;
    const long long g = (hb << b) + jt;
    pass_groups<true>(x, y, tile, g, a, b, a, b - a, lt, jt, nb, jt == 0 && lt == 0, groups, tw);
}

// ---------------------------------------------------------------------------
// The tail
// ---------------------------------------------------------------------------

// One DIT stage s in place over x: [B, 2^k, 2^l_log]; total = B * 2^(k-1+l_log)
// butterflies, one a thread.
__global__ void ntt_stage_kernel(uint64_t* __restrict__ x, long long total, int k_log,
                                 int l_log, int s, const uint64_t* __restrict__ tw) {
    const long long step = (long long)gridDim.x * blockDim.x;
    const long long half = 1LL << s;
    for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
         idx += step) {
        const long long l = idx & ((1LL << l_log) - 1);
        const long long rest = idx >> l_log;
        const long long q = rest & ((1LL << (k_log - 1)) - 1);
        const long long bt = rest >> (k_log - 1);
        const long long j = q & (half - 1);
        const long long p0 = ((q >> s) << (s + 1)) | j;
        const long long i0 = (((bt << k_log) + p0) << l_log) + l;
        const long long i1 = i0 + (half << l_log);
        const uint64_t u = x[i0];
        const uint64_t v = gl_mul(x[i1], __ldg(tw + (half - 1) + j));
        x[i0] = gl_add(u, v);
        x[i1] = gl_sub(u, v);
    }
}

// A pass's tile may take more than the 48 KB of dynamic shared memory a
// launch gets by default. The limit is an attribute of the kernel in one
// context, that is on one card, and a new context (another card, or this
// one after a reset) starts at 48 KB: so it is raised, to the largest tile,
// for the kernel about to be launched before every pass, and nothing of it
// is kept. On an H100 the call takes about 0.1 us of host time, against
// about 7 us for a pass's whole call (tools/torch_ntt_contexts.py, which
// also shows the limit kept per context). An error of it is the entry
// point's result.
//
// This library links the CUDA runtime statically, apart from PyTorch's. A
// runtime's current device is the one whose primary context is current on
// the calling thread, and the Python wrappers make the tensors' card
// current (torch.cuda.device), so the attribute and the launch go to that
// card (plonky2_ntt_current_device reports what this runtime sees;
// chip_smoke.py checks it against each card).
template <class Kernel>
static int ntt_raise_smem(Kernel kernel) {
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (1 << NTT_TILE_WORDS_LOG) * (int)sizeof(uint64_t));
}

extern "C" int plonky2_ntt_current_device(int* device) {
    return (int)cudaGetDevice(device);
}

// The packed stage groups of a pass of n stages: the number of groups, or
// -1 if a size is out of 1..NTT_COL_RADIX_LOG or they do not sum to n.
static int ntt_group_count(int groups, int n) {
    if (groups < 0) return -1;
    int covered = 0, count = 0;
    for (unsigned rest = groups; rest; rest >>= 4) {
        const int G = rest & 15;
        if (G < 1 || G > NTT_COL_RADIX_LOG) return -1;
        covered += G;
        ++count;
    }
    return covered == n ? count : -1;
}

static bool ntt_threads_ok(int threads, int most) {
    return threads >= 32 && threads <= most && threads % 32 == 0;
}

// Stages [a, b) of x: [batch, 2^k, 2^l_log] into y (y may be x), in tiles of
// 2^(b-a) positions x 2^lt lanes (b - a + lt <= 14), running the stage
// groups packed in `groups` (see pass_groups) with `threads` threads a
// block (a multiple of 32, at most NTT_COL_THREADS).
extern "C" int plonky2_col_fft_pass(const void* x, void* y, long long batch, int k_log,
                                    int l_log, int a, int b, int lt, int groups, int threads,
                                    const void* tw, void* stream) {
    const int n = b - a;
    if (a < 0 || n < 1 || b > k_log || lt < 0 || lt > l_log ||
        n + lt > NTT_TILE_WORDS_LOG || !ntt_threads_ok(threads, NTT_COL_THREADS))
        return (int)cudaErrorInvalidValue;
    const int count = ntt_group_count(groups, n);
    if (count < 0) return (int)cudaErrorInvalidValue;
    const int err = ntt_raise_smem(col_fft_kernel);
    if (err) return err;
    const long long blocks = batch << (k_log - n + l_log - lt);
    const size_t smem = count > 1 ? (size_t)sizeof(uint64_t) << (n + lt) : 0;
    col_fft_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
        (const uint64_t*)x, (uint64_t*)y, l_log, a, b, lt, (unsigned)groups, (const uint64_t*)tw);
    return (int)cudaGetLastError();
}

// Stages [a, b) along the rows of x: [batch, 2^k] into y (y may be x), in
// tiles of 2^rb aligned groups of 2^b words x 2^(b-a) positions x 2^lt
// residues (lt <= a, rb + b - a + lt <= 14), running the stage groups
// packed in `groups` with `threads` threads a block (a multiple of 32, at
// most NTT_ROW_THREADS).
extern "C" int plonky2_row_fft_pass(const void* x, void* y, long long batch, int k_log, int a,
                                    int b, int lt, int rb, int groups, int threads,
                                    const void* tw, void* stream) {
    const int n = b - a;
    if (a < 0 || n < 1 || b > k_log || lt < 0 || lt > a || rb < 0 ||
        rb + n + lt > NTT_TILE_WORDS_LOG || batch < 1 ||
        !ntt_threads_ok(threads, NTT_ROW_THREADS))
        return (int)cudaErrorInvalidValue;
    const int count = ntt_group_count(groups, n);
    if (count < 0) return (int)cudaErrorInvalidValue;
    const long long hbs = batch << (k_log - b);
    const long long blocks = ((hbs + (1LL << rb) - 1) >> rb) << (a - lt);
    if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    const int err = ntt_raise_smem(row_fft_kernel);
    if (err) return err;
    const size_t smem = count > 1 ? (size_t)sizeof(uint64_t) << (rb + n + lt) : 0;
    row_fft_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
        (const uint64_t*)x, (uint64_t*)y, hbs, a, b, lt, rb, (unsigned)groups,
        (const uint64_t*)tw);
    return (int)cudaGetLastError();
}

// Stage s in place over x: [batch, 2^k, 2^l_log] (1 <= k, s < k).
extern "C" int plonky2_ntt_stage(void* x, long long batch, int k_log, int l_log, int s,
                                 const void* tw, void* stream) {
    if (k_log < 1 || s < 0 || s >= k_log || l_log < 0) return (int)cudaErrorInvalidValue;
    const long long total = batch << (k_log - 1 + l_log);
    long long blocks = (total + NTT_STAGE_THREADS - 1) / NTT_STAGE_THREADS;
    if (blocks > NTT_STAGE_MAX_BLOCKS) blocks = NTT_STAGE_MAX_BLOCKS;
    ntt_stage_kernel<<<(unsigned)blocks, NTT_STAGE_THREADS, 0, (cudaStream_t)stream>>>(
        (uint64_t*)x, total, k_log, l_log, s, (const uint64_t*)tw);
    return (int)cudaGetLastError();
}

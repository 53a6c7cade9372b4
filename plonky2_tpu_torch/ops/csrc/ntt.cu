// Hand-written Hopper kernels for the radix-2 DIT butterflies of the NTT
// over Goldilocks.
//
// col_fft_kernel replaces the TPU kernel
//   plonky2_tpu/ops/pallas_kernels.py :: _col_fft_call (col_fft)
// row_fft_kernel replaces
//   plonky2_tpu/ops/pallas_kernels.py :: _row_fft_core (row_fft_bitrev)
// ntt_stage_kernel is the cross-block tail that both hybrids need (the
// TPU code ran those stages as XLA passes).
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
// and write of the tensor per stage); instruction issue for the column
// passes, which read and write the tensor once but issue about 59 SASS
// instructions a butterfly, about 54 of them in gl_mul, gl_add and gl_sub
// (a 64x64 product, its reduction, an add and a subtract, each canonical).
//
// col_fft_kernel. The transform axis is strided (axis -2 of [B, N, L]) and
// L is contiguous. A pass runs stages [a, b): those only pair positions
// with the same residue mod 2^a inside one aligned group of 2^b, so a tile
// is the 2^(b-a) positions hi * 2^b + jt + i * 2^a (i < 2^(b-a)) of 2^lt
// neighbouring lanes, and its loads run along L in runs of 2^lt words.
// The host's plan (ops/ntt_cuda.py col_plan) picks the pass, the lanes and
// the stage groups. Inside a tile the stages run in groups of at most
// NTT_COL_RADIX_LOG stages on 2^G words a thread held in registers: a
// thread loads the 2^G words i0 + m * 2^s (m < 2^G) of one lane, runs
// stages s..s+G-1 on them with the 2^G - 1 twiddles they need, and writes
// them back. The first group loads straight from device memory, the last
// stores straight to it, and the tile sits in shared memory only between
// groups: a pass of n stages costs ceil(n / NTT_COL_RADIX_LOG) - 1
// barriers and shared-memory round trips, not one of each a stage. Tiles
// of 64 KB let three blocks share an SM, so one block's loads overlap
// another's arithmetic.
//
// row_fft_kernel: rows are contiguous; a block takes 2^r whole rows of 2^n
// words in shared memory, r chosen so that short rows share a block, and
// runs its stages with __syncthreads() between them. Rows longer than 2^14
// run the hybrid of row_fft_bitrev: the head on each contiguous 2^14 block,
// then the tail stages.
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

#define NTT_THREADS 512
#define NTT_TILE_WORDS_LOG 14
#define NTT_STAGE_THREADS 256
#define NTT_STAGE_MAX_BLOCKS (132 * 32)
// column passes: threads a block at most and the blocks an SM the
// registers are sized for (64 KB tiles: three fit in shared memory); stages
// a group runs in registers at most (2^NTT_COL_RADIX_LOG words a thread)
#define NTT_COL_THREADS 256
#define NTT_COL_MIN_BLOCKS 3
#define NTT_COL_RADIX_LOG 4

// DIT stages first..n-1 on rows held in shared memory: 2^r rows of 2^n
// words, row-major; the thread index runs over one row's butterflies first.
__device__ __forceinline__ void tile_stages(uint64_t* t, int n_log, int r_log, int first,
                                            const uint64_t* __restrict__ tw) {
    const int pairs_log = n_log - 1;
    const int total = 1 << (pairs_log + r_log);
    for (int s = first; s < n_log; ++s) {
        const int half = 1 << s;
        for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
            const int q = idx & ((1 << pairs_log) - 1);
            const int row = idx >> pairs_log;
            const int j = q & (half - 1);
            const int p0 = ((q >> s) << (s + 1)) | j;
            const int i0 = p0 + (row << n_log);
            const int i1 = i0 + half;
            const uint64_t u = t[i0];
            const uint64_t v = gl_mul(t[i1], __ldg(tw + (half - 1) + j));
            t[i0] = gl_add(u, v);
            t[i1] = gl_sub(u, v);
        }
        __syncthreads();
    }
}

// ---------------------------------------------------------------------------
// Column passes (col_fft_kernel)
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
// positions of 2^lt lanes), one set of 2^G words a thread at a time. A set
// is lane l, positions i0 + m * 2^s with i0 = hi * 2^(s+G) + jl (jl < 2^s);
// its words sit at g + i * 2^(a + l_log) in device memory (g: the tile's
// first word) and at col_swizzle(i * 2^lt + l) in shared memory.
template <int G, bool FROM_GLOBAL, bool TO_GLOBAL, bool ZERO_J>
__device__ __forceinline__ void col_group(const uint64_t* x, uint64_t* y, uint64_t* tile,
                                          long long g, int l_log, int a, int n, int lt, int s,
                                          uint32_t jt, const uint64_t* __restrict__ tw) {
    const int items = 1 << (n - G + lt);
    const int S = a + s;
    const long long step = 1LL << (S + l_log);
#pragma unroll 1
    for (int idx = threadIdx.x; idx < items; idx += blockDim.x) {
        const uint32_t l = idx & ((1 << lt) - 1);
        const uint32_t q = idx >> lt;
        const uint32_t jl = q & ((1u << s) - 1);
        const uint32_t i0 = ((q >> s) << (s + G)) | jl;
        const uint32_t w0 = (i0 << lt) | l;
        const uint32_t wstep = 1u << (s + lt);
        const long long g0 = g + ((long long)i0 << (a + l_log)) + l;
        uint64_t v[1 << G];
#pragma unroll
        for (int m = 0; m < (1 << G); ++m) {
            v[m] = FROM_GLOBAL ? x[g0 + m * step] : tile[col_swizzle(w0 + m * wstep)];
        }
        radix_stages<G, ZERO_J>(v, S, ZERO_J ? 0 : jt + (jl << a), tw);
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
// group of a tile with jt = 0 (J = 0 in all its sets) takes ZERO_J.
template <int G>
__device__ __forceinline__ void col_group_at(bool from_global, bool to_global, bool zero_j,
                                             const uint64_t* x, uint64_t* y, uint64_t* tile,
                                             long long g, int l_log, int a, int n, int lt, int s,
                                             uint32_t jt, const uint64_t* __restrict__ tw) {
    if (zero_j && to_global) {
        col_group<G, true, true, true>(x, y, tile, g, l_log, a, n, lt, s, jt, tw);
    } else if (zero_j) {
        col_group<G, true, false, true>(x, y, tile, g, l_log, a, n, lt, s, jt, tw);
    } else if (from_global && to_global) {
        col_group<G, true, true, false>(x, y, tile, g, l_log, a, n, lt, s, jt, tw);
    } else if (from_global) {
        col_group<G, true, false, false>(x, y, tile, g, l_log, a, n, lt, s, jt, tw);
    } else if (to_global) {
        col_group<G, false, true, false>(x, y, tile, g, l_log, a, n, lt, s, jt, tw);
    } else {
        col_group<G, false, false, false>(x, y, tile, g, l_log, a, n, lt, s, jt, tw);
    }
}

// x, y: [B, 2^k, 2^l_log] (y may be x: a tile reads all its words before it
// writes any). Stages [a, b) in tiles of 2^(b-a) positions x 2^lt lanes;
// `groups` holds the stage groups' sizes (1..NTT_COL_RADIX_LOG, summing to
// b - a), four
// bits each from the lowest. Block i takes tile i: from i's lowest bits up,
// the lane tile, jt < 2^a, and hb = batch * 2^(k-b) + hi.
__global__ void __launch_bounds__(NTT_COL_THREADS, NTT_COL_MIN_BLOCKS)
col_fft_kernel(const uint64_t* x, uint64_t* y, int l_log, int a, int b, int lt,
               unsigned groups, const uint64_t* __restrict__ tw) {
    extern __shared__ uint64_t tile[];
    const int n = b - a;
    const int tiles_l_log = l_log - lt;
    const unsigned long long blk = blockIdx.x;
    const long long lane_tile = blk & ((1ULL << tiles_l_log) - 1);
    const uint32_t jt = (uint32_t)((blk >> tiles_l_log) & ((1ULL << a) - 1));
    const long long hb = (long long)(blk >> (tiles_l_log + a));
    const long long g = (hb << (b + l_log)) + ((long long)jt << l_log) + (lane_tile << lt);
    int s = 0;
    for (unsigned rest = groups; rest; rest >>= 4) {
        const int G = rest & 15;
        const bool from_global = s == 0;
        const bool to_global = (rest >> 4) == 0;
        const bool zero_j = from_global && jt == 0;
        if (!from_global) __syncthreads();
        switch (G) {
            case 1: col_group_at<1>(from_global, to_global, zero_j, x, y, tile, g, l_log, a, n, lt, s, jt, tw); break;
            case 2: col_group_at<2>(from_global, to_global, zero_j, x, y, tile, g, l_log, a, n, lt, s, jt, tw); break;
            case 3: col_group_at<3>(from_global, to_global, zero_j, x, y, tile, g, l_log, a, n, lt, s, jt, tw); break;
            default:
                if constexpr (NTT_COL_RADIX_LOG >= 4) {
                    col_group_at<4>(from_global, to_global, zero_j, x, y, tile, g, l_log, a, n, lt, s, jt, tw);
                }
                break;
        }
        s += G;
    }
}

// ---------------------------------------------------------------------------
// Row passes and the tail
// ---------------------------------------------------------------------------

// x, y: [m, 2^n] contiguous rows; block i takes rows [i * 2^r, (i+1) * 2^r)
// (fewer in the last block).
__global__ void row_fft_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y,
                               long long m, int n_log, int r_log, int first,
                               const uint64_t* __restrict__ tw) {
    extern __shared__ uint64_t tile[];
    const long long row0 = (long long)blockIdx.x << r_log;
    long long rows = m - row0;
    if (rows > (1LL << r_log)) rows = 1LL << r_log;
    const int count = (int)(rows << n_log);
    const long long base = row0 << n_log;
    for (int idx = threadIdx.x; idx < count; idx += blockDim.x) tile[idx] = x[base + idx];
    __syncthreads();
    tile_stages(tile, n_log, r_log, first, tw);
    for (int idx = threadIdx.x; idx < count; idx += blockDim.x) y[base + idx] = tile[idx];
}

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

static int ntt_threads(int butterflies_log) {
    const int want = butterflies_log >= 9 ? NTT_THREADS : (1 << butterflies_log);
    return want < 32 ? 32 : want;
}

static int ntt_smem_ready = 0;

static int ntt_set_smem() {
    if (ntt_smem_ready) return 0;
    const int bytes = (1 << NTT_TILE_WORDS_LOG) * (int)sizeof(uint64_t);
    cudaError_t e = cudaFuncSetAttribute(col_fft_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(row_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return (int)e;
    ntt_smem_ready = 1;
    return 0;
}

// Stages [a, b) of x: [batch, 2^k, 2^l_log] into y (y may be x), in tiles of
// 2^(b-a) positions x 2^lt lanes (b - a + lt <= 14), running the stage
// groups packed in `groups` (see col_fft_kernel) with `threads` threads a
// block (a multiple of 32, at most NTT_COL_THREADS).
extern "C" int plonky2_col_fft_pass(const void* x, void* y, long long batch, int k_log,
                                    int l_log, int a, int b, int lt, int groups, int threads,
                                    const void* tw, void* stream) {
    const int n = b - a;
    if (a < 0 || n < 1 || b > k_log || lt < 0 || lt > l_log ||
        n + lt > NTT_TILE_WORDS_LOG || threads < 32 || threads > NTT_COL_THREADS ||
        threads % 32 || groups < 0)
        return (int)cudaErrorInvalidValue;
    int covered = 0, count = 0;
    for (unsigned rest = groups; rest; rest >>= 4) {
        const int G = rest & 15;
        if (G < 1 || G > NTT_COL_RADIX_LOG) return (int)cudaErrorInvalidValue;
        covered += G;
        ++count;
    }
    if (covered != n) return (int)cudaErrorInvalidValue;
    int err = ntt_set_smem();
    if (err) return err;
    const long long blocks = batch << (k_log - n + l_log - lt);
    const size_t smem = count > 1 ? (size_t)sizeof(uint64_t) << (n + lt) : 0;
    col_fft_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
        (const uint64_t*)x, (uint64_t*)y, l_log, a, b, lt, (unsigned)groups, (const uint64_t*)tw);
    return (int)cudaGetLastError();
}

// Stages first..n-1 of each row of x: [m, 2^n] into y, 2^r rows a block
// (n + r <= 14).
extern "C" int plonky2_row_fft_head(const void* x, void* y, long long m, int n_log,
                                    int r_log, int first, const void* tw, void* stream) {
    if (n_log < 1 || r_log < 0 || n_log + r_log > NTT_TILE_WORDS_LOG)
        return (int)cudaErrorInvalidValue;
    int err = ntt_set_smem();
    if (err) return err;
    const long long blocks = (m + (1LL << r_log) - 1) >> r_log;
    const size_t smem = (size_t)sizeof(uint64_t) << (n_log + r_log);
    row_fft_kernel<<<(unsigned)blocks, ntt_threads(n_log - 1 + r_log), smem,
                     (cudaStream_t)stream>>>((const uint64_t*)x, (uint64_t*)y, m, n_log, r_log,
                                             first, (const uint64_t*)tw);
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

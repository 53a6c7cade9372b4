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
// and write of the tensor per stage), and for the fused head the integer
// multiply rate against one read and one write for up to 12 stages.
//
// Design. A stage s < b only ever pairs positions inside one aligned group
// of 2^b, with twiddles independent of the group, so the first b stages
// run on a tile held in shared memory: one read of the tile, b stages with
// __syncthreads() between them, one write. Tiles are at most 2^14 words
// (128 KB, dynamic shared memory; a block may have 227 KB):
//  * col_fft_kernel: the transform axis is strided (axis -2 of
//    [B, N, L]) and L is contiguous, so a block takes a [2^b, lt] tile,
//    lt lanes wide, and its loads run along L in runs of lt words. With
//    lt >= 4 (32 bytes, one whole sector per run) the cap is b = 12:
//    2^12 x 4 x 8 B = 128 KB. Wider L takes wider tiles at smaller b.
//  * row_fft_kernel: rows are contiguous; a block takes 2^r whole rows of
//    2^n words, r chosen so that short rows share a block. Rows longer
//    than 2^14 run the hybrid of row_fft_bitrev: the head on each
//    contiguous 2^14 block, then the tail stages.
//  * ntt_stage_kernel: one thread per butterfly of one stage, in place,
//    over [B, N, L]; neighbouring threads take neighbouring lanes (or, for
//    L = 1, neighbouring positions), so its loads are coalesced.
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

// DIT stages first..last-1 on a tile in shared memory: positions p < 2^b,
// lanes l < 2^nl, element (p, l) at t[p * ps + l * ls]. LANE_FAST: the
// thread index runs over lanes first (the column layout, lanes adjacent in
// shared memory), else over butterflies first (the row layout).
template <bool LANE_FAST>
__device__ __forceinline__ void tile_stages(uint64_t* t, int b_log, int nl_log,
                                            int first, int last, int ps, int ls,
                                            const uint64_t* __restrict__ tw) {
    const int pairs_log = b_log - 1;
    const int total = 1 << (pairs_log + nl_log);
    for (int s = first; s < last; ++s) {
        const int half = 1 << s;
        for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
            int l, q;
            if (LANE_FAST) {
                l = idx & ((1 << nl_log) - 1);
                q = idx >> nl_log;
            } else {
                q = idx & ((1 << pairs_log) - 1);
                l = idx >> pairs_log;
            }
            const int j = q & (half - 1);
            const int p0 = ((q >> s) << (s + 1)) | j;
            const int i0 = p0 * ps + l * ls;
            const int i1 = i0 + half * ps;
            const uint64_t u = t[i0];
            const uint64_t v = gl_mul(t[i1], __ldg(tw + (half - 1) + j));
            t[i0] = gl_add(u, v);
            t[i1] = gl_sub(u, v);
        }
        __syncthreads();
    }
}

// x, y: [B, N, L], N = 2^k, L = 2^l_log. Block i takes rows
// [g * 2^b, (g + 1) * 2^b) of the flattened [B * N, L] view (g = i / tiles
// along L) and lanes [t * 2^nl, (t + 1) * 2^nl) (t = i mod tiles along L).
__global__ void col_fft_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y,
                               int b_log, int l_log, int nl_log, int first,
                               const uint64_t* __restrict__ tw) {
    extern __shared__ uint64_t tile[];
    const int tiles_l_log = l_log - nl_log;
    const long long blk = blockIdx.x;
    const long long lane_tile = blk & ((1LL << tiles_l_log) - 1);
    const long long group = blk >> tiles_l_log;
    const long long base = (group << (b_log + l_log)) + (lane_tile << nl_log);
    const int count = 1 << (b_log + nl_log);
    const int lmask = (1 << nl_log) - 1;
    for (int idx = threadIdx.x; idx < count; idx += blockDim.x) {
        tile[idx] = x[base + ((long long)(idx >> nl_log) << l_log) + (idx & lmask)];
    }
    __syncthreads();
    tile_stages<true>(tile, b_log, nl_log, first, b_log, 1 << nl_log, 1, tw);
    for (int idx = threadIdx.x; idx < count; idx += blockDim.x) {
        y[base + ((long long)(idx >> nl_log) << l_log) + (idx & lmask)] = tile[idx];
    }
}

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
    tile_stages<false>(tile, n_log, r_log, first, n_log, 1, 1 << n_log, tw);
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

// Stages first..b-1 of every aligned 2^b-row group of x: [batch, 2^k, 2^l_log]
// into y, in [2^b, 2^nl] tiles (b + nl <= 14, b <= k, nl <= l_log).
extern "C" int plonky2_col_fft_head(const void* x, void* y, long long batch, int k_log,
                                    int l_log, int b_log, int nl_log, int first,
                                    const void* tw, void* stream) {
    if (b_log < 1 || b_log > k_log || nl_log < 0 || nl_log > l_log ||
        b_log + nl_log > NTT_TILE_WORDS_LOG)
        return (int)cudaErrorInvalidValue;
    int err = ntt_set_smem();
    if (err) return err;
    const long long blocks = batch << (k_log - b_log + l_log - nl_log);
    const size_t smem = (size_t)sizeof(uint64_t) << (b_log + nl_log);
    col_fft_kernel<<<(unsigned)blocks, ntt_threads(b_log - 1 + nl_log), smem,
                     (cudaStream_t)stream>>>((const uint64_t*)x, (uint64_t*)y, b_log, l_log,
                                             nl_log, first, (const uint64_t*)tw);
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

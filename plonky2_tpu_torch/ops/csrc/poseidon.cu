// Hand-written Hopper kernels for the width-12 Poseidon permutation over
// Goldilocks and the overwrite-mode sponge built on it.
//
// poseidon_permute_kernel replaces the TPU kernel
//   plonky2_tpu/ops/poseidon_pallas.py :: permute_t
// poseidon_sponge_kernel replaces
//   plonky2_tpu/ops/poseidon_pallas.py :: sponge_t
//
// What bounds them on this card: operations. One permutation is 30 rounds
// of 12 constant adds, an x^7 S-box (4 field multiplies a lane; all 12
// lanes in the 8 full rounds, lane 0 in the 22 partial ones) and a dense
// 12x12 MDS product, about 10^4 32-bit integer multiply-adds, against 192
// bytes moved for a bare permutation or 64 bytes absorbed per permutation
// in the sponge. Integer issue rate, not memory, is the limit.
//
// Design: one thread per state. The 12 words live in registers for all 30
// rounds (and, in the sponge, across all ceil(w/8) permutations), so a
// state is read once and written once. Round constants and the MDS row sit
// in __constant__ memory; their indices are uniform across a warp, so each
// read is a broadcast. The field product uses the native 64-bit multiply
// and __umul64hi. The MDS entries are < 2^6, so each output lane is two
// sums of twelve 32x32->64 multiply-adds over the low and the high halves
// of the state words (each sum < 2^42), recombined into 75 bits and
// reduced once.
//
// Global layout: state-major, [B, 12] for the permutation and [B, w] for
// the sponge (w = leaf width), rows contiguous. A thread reads its own
// row: neighbouring threads are 96 (or 8*w) bytes apart, so a warp's loads
// are not one coalesced line, but every 32-byte sector fetched is used in
// full by exactly one thread and the rows of a warp are adjacent in
// memory, so no byte is fetched twice from device memory. The callers
// produce exactly these layouts (the Merkle leaf matrix is point-major
// [B, w]; a digest level [2B, 4] is a [B, 8] view), so no transpose is
// paid for the kernel's sake.
//
// The interface is plain C (no PyTorch headers): pointers and the stream
// come from the Python wrapper, which also allocates the outputs. Each
// entry point returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "goldilocks.cuh"
#include "poseidon_constants.cuh"

// threads a block; at 60-62 registers a thread, four such blocks fit an SM
#define POSEIDON_THREADS 256

__device__ __forceinline__ uint64_t poseidon_sbox7(uint64_t x) {
    uint64_t x2 = gl_sqr(x);
    uint64_t x4 = gl_sqr(x2);
    uint64_t x3 = gl_mul(x, x2);
    return gl_mul(x3, x4);
}

// s <- MDS * s, exactly mod p.
__device__ __forceinline__ void poseidon_mds(uint64_t (&s)[POSEIDON_WIDTH]) {
    uint32_t lo[POSEIDON_WIDTH], hi[POSEIDON_WIDTH];
#pragma unroll
    for (int j = 0; j < POSEIDON_WIDTH; ++j) {
        lo[j] = (uint32_t)s[j];
        hi[j] = (uint32_t)(s[j] >> 32);
    }
#pragma unroll
    for (int r = 0; r < POSEIDON_WIDTH; ++r) {
        uint64_t acc_lo = (uint64_t)POSEIDON_MDS_DIAG[r] * (uint64_t)lo[r];
        uint64_t acc_hi = (uint64_t)POSEIDON_MDS_DIAG[r] * (uint64_t)hi[r];
#pragma unroll
        for (int j = 0; j < POSEIDON_WIDTH; ++j) {
            uint32_t c = POSEIDON_MDS_CIRC[(j - r + POSEIDON_WIDTH) % POSEIDON_WIDTH];
            acc_lo += (uint64_t)c * (uint64_t)lo[j];
            acc_hi += (uint64_t)c * (uint64_t)hi[j];
        }
        // acc_lo + 2^32 * acc_hi as a 128-bit value (both sums < 2^42)
        uint64_t shifted = acc_hi << 32;
        uint64_t l = acc_lo + shifted;
        uint64_t h = (acc_hi >> 32) + (l < shifted ? 1ULL : 0ULL);
        s[r] = gl_reduce128(l, h);
    }
}

template <bool FULL>
__device__ __forceinline__ void poseidon_round(uint64_t (&s)[POSEIDON_WIDTH], int round) {
#pragma unroll
    for (int i = 0; i < POSEIDON_WIDTH; ++i)
        s[i] = gl_add(s[i], POSEIDON_RC[round * POSEIDON_WIDTH + i]);
    if (FULL) {
#pragma unroll
        for (int i = 0; i < POSEIDON_WIDTH; ++i) s[i] = poseidon_sbox7(s[i]);
    } else {
        s[0] = poseidon_sbox7(s[0]);
    }
    poseidon_mds(s);
}

__device__ __forceinline__ void poseidon_permute_regs(uint64_t (&s)[POSEIDON_WIDTH]) {
    int round = 0;
#pragma unroll 1
    for (int k = 0; k < POSEIDON_HALF_FULL_ROUNDS; ++k, ++round) poseidon_round<true>(s, round);
#pragma unroll 1
    for (int k = 0; k < POSEIDON_PARTIAL_ROUNDS; ++k, ++round) poseidon_round<false>(s, round);
#pragma unroll 1
    for (int k = 0; k < POSEIDON_HALF_FULL_ROUNDS; ++k, ++round) poseidon_round<true>(s, round);
}

// in, out: [batch, 12] canonical words.
__global__ void __launch_bounds__(POSEIDON_THREADS)
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
    for (int i = 0; i < POSEIDON_WIDTH; ++i) dst[i] = s[i];
}

// in: [batch, w] canonical words, w >= 1; out: [batch, 4]. The state starts
// at zero except lane 8 = cap_val; each chunk of up to 8 inputs overwrites
// lanes 0..k-1 (a short last chunk leaves the other rate lanes as they are)
// and is followed by one permutation.
__global__ void __launch_bounds__(POSEIDON_THREADS)
poseidon_sponge_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                       long long batch, int w, uint64_t cap_val) {
    long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= batch) return;
    const uint64_t* row = in + b * (long long)w;
    uint64_t s[POSEIDON_WIDTH];
#pragma unroll
    for (int i = 0; i < POSEIDON_WIDTH; ++i) s[i] = 0;
    s[POSEIDON_RATE] = gl_canon(cap_val);
    for (int c = 0; c < w; c += POSEIDON_RATE) {
        int k = w - c;
#pragma unroll
        for (int i = 0; i < POSEIDON_RATE; ++i)
            if (i < k) s[i] = row[c + i];
        poseidon_permute_regs(s);
    }
    uint64_t* dst = out + b * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[i] = s[i];
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

extern "C" int plonky2_poseidon_sponge(const void* in, void* out, long long batch, int w,
                                       unsigned long long cap_val, void* stream) {
    if (batch <= 0) return 0;
    poseidon_sponge_kernel<<<poseidon_blocks(batch), POSEIDON_THREADS, 0,
                             (cudaStream_t)stream>>>(
        (const uint64_t*)in, (uint64_t*)out, batch, w, (uint64_t)cap_val);
    return (int)cudaGetLastError();
}

// Goldilocks field arithmetic for device code: p = 2^64 - 2^32 + 1.
//
// An element is a canonical uint64_t (< p). Every function takes canonical
// inputs and returns a canonical output. The 64x64 -> 128 product uses the
// native low multiply and __umul64hi; the reduction uses 2^64 = 2^32 - 1 and
// 2^96 = -1 (mod p) (reference: field/src/goldilocks_field.rs reduce128).
// The plain PyTorch versions in ops/gf.py do the same steps on an int64 bit
// container, so the two agree bit for bit.
#pragma once
#include <cstdint>

#define GL_P 0xFFFFFFFF00000001ULL
#define GL_EPS 0x00000000FFFFFFFFULL  // 2^32 - 1 = 2^64 mod p

__device__ __forceinline__ uint64_t gl_canon(uint64_t a) {
    return a >= GL_P ? a - GL_P : a;
}

__device__ __forceinline__ uint64_t gl_add(uint64_t a, uint64_t b) {
    uint64_t s = a + b;
    // on carry-out the true sum is s + 2^64 = s + EPS = s - p (mod 2^64)
    return (s < a || s >= GL_P) ? s - GL_P : s;
}

__device__ __forceinline__ uint64_t gl_sub(uint64_t a, uint64_t b) {
    uint64_t d = a - b;
    return a < b ? d + GL_P : d;
}

// (lo + 2^64 * hi) mod p
__device__ __forceinline__ uint64_t gl_reduce128(uint64_t lo, uint64_t hi) {
    uint64_t hi_hi = hi >> 32;
    uint64_t hi_lo = hi & GL_EPS;
    uint64_t t0 = lo - hi_hi;
    if (lo < hi_hi) t0 -= GL_EPS;
    uint64_t t1 = (hi_lo << 32) - hi_lo;  // hi_lo * EPS, < 2^64
    uint64_t r = t0 + t1;
    if (r < t0) r += GL_EPS;
    return gl_canon(r);
}

__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b) {
    return gl_reduce128(a * b, __umul64hi(a, b));
}

__device__ __forceinline__ uint64_t gl_sqr(uint64_t a) { return gl_mul(a, a); }

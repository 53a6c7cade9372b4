// Hand-written Hopper kernel for the elementwise Goldilocks product.
//
// gl_mul_kernel replaces the TPU kernel
//   plonky2_tpu/ops/pallas_kernels.py :: mul (body _mul_body)
//
// What bounds it on this card: bytes. One product reads two words and
// writes one (24 bytes) and does four 32x32 partial products' worth of
// work (the native 64-bit multiply and __umul64hi) plus a short reduction,
// far below the integer issue rate per byte moved.
//
// Design: one thread per output element, a grid-stride loop, output
// contiguous. Every call form of ops/gf.py::mul reaches the same kernel
// without an expanded copy of either operand: the wrapper hands over the
// broadcast shape and both operands' element strides (0 along broadcast
// axes), after merging adjacent axes that are contiguous for both
// operands, so the common forms arrive as one or two axes. A Python int
// operand arrives as `c` with `b` null. Offsets are computed in 32-bit
// arithmetic when every offset fits, which keeps the per-axis division
// cheap.
//
// The TPU kernel worked on (lo, hi) u32 limb planes because the TPU has no
// 64-bit multiply; none of that carries over: the element is one uint64_t.
//
// The interface is plain C (no PyTorch headers): pointers and the stream
// come from the Python wrapper, which also allocates the output. The entry
// point returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "goldilocks.cuh"

#define GL_MUL_MAX_DIMS 6
#define GL_MUL_THREADS 256
#define GL_MUL_MAX_BLOCKS (132 * 32)

struct GlMulShape {
    int ndim;
    long long size[GL_MUL_MAX_DIMS];
    long long a_stride[GL_MUL_MAX_DIMS];
    long long b_stride[GL_MUL_MAX_DIMS];
};

template <typename Index>
__global__ void gl_mul_kernel(const uint64_t* __restrict__ a,
                              const uint64_t* __restrict__ b, uint64_t c,
                              uint64_t* __restrict__ out, Index n,
                              GlMulShape shape) {
    const Index step = (Index)gridDim.x * blockDim.x;
    for (Index i = (Index)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
        Index ao = 0, bo = 0;
        if (shape.ndim == 1) {
            ao = i * (Index)shape.a_stride[0];
            bo = i * (Index)shape.b_stride[0];
        } else {
            Index rem = i;
            for (int d = shape.ndim - 1; d >= 0; --d) {
                const Index size = (Index)shape.size[d];
                const Index q = rem / size;
                const Index r = rem - q * size;
                ao += r * (Index)shape.a_stride[d];
                bo += r * (Index)shape.b_stride[d];
                rem = q;
            }
        }
        const uint64_t y = b ? b[bo] : c;
        out[i] = gl_mul(a[ao], y);
    }
}

extern "C" int plonky2_gl_mul(const void* a, const void* b, unsigned long long c,
                              void* out, long long n, int ndim,
                              const long long* sizes, const long long* a_strides,
                              const long long* b_strides, int wide_index,
                              void* stream) {
    if (n <= 0) return 0;
    if (ndim < 1 || ndim > GL_MUL_MAX_DIMS) return (int)cudaErrorInvalidValue;
    GlMulShape shape;
    shape.ndim = ndim;
    for (int d = 0; d < ndim; ++d) {
        shape.size[d] = sizes[d];
        shape.a_stride[d] = a_strides[d];
        shape.b_stride[d] = b_strides[d];
    }
    long long blocks = (n + GL_MUL_THREADS - 1) / GL_MUL_THREADS;
    if (blocks > GL_MUL_MAX_BLOCKS) blocks = GL_MUL_MAX_BLOCKS;
    cudaStream_t s = (cudaStream_t)stream;
    const uint64_t* pa = (const uint64_t*)a;
    const uint64_t* pb = (const uint64_t*)b;
    uint64_t* po = (uint64_t*)out;
    if (wide_index) {
        gl_mul_kernel<unsigned long long><<<(unsigned)blocks, GL_MUL_THREADS, 0, s>>>(
            pa, pb, (uint64_t)c, po, (unsigned long long)n, shape);
    } else {
        gl_mul_kernel<unsigned int><<<(unsigned)blocks, GL_MUL_THREADS, 0, s>>>(
            pa, pb, (uint64_t)c, po, (unsigned int)n, shape);
    }
    return (int)cudaGetLastError();
}

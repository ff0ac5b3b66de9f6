// The prep pass of the fused 3x3 convolutions' bf16 paths (Kernels L and
// M of the PyTorch port): one elementwise pass that writes z = relu?(x a +
// b), rounded to bf16 (conv_fused.cuh's zval: the rounding points of the
// plain version), once to scratch, with 16-byte loads and stores where the
// channel count allows. The implicit GEMMs that follow read z as a plain
// bf16 tensor, each operand row copied 16 bytes at a time.
#pragma once

#include <algorithm>

#include "conv_fused.cuh"

namespace apex {
namespace conv {

constexpr int kPrepThreads = 256;
constexpr int kPrepMaxBlocks = 132 * 16;

// Channel of flat element e of a [rows, dim] tensor.
__device__ __forceinline__ int channel_of(long long e, int dim) {
  return e < (1LL << 32)
             ? static_cast<int>(static_cast<unsigned>(e) %
                                static_cast<unsigned>(dim))
             : static_cast<int>(e % dim);
}

// Eight elements a thread: with VEC (dim % 8 == 0, 16-byte aligned
// tensors) one 16-byte load of each input and one store, all eight in one
// row; else element by element.
template <bool VEC, class F>
__device__ __forceinline__ void prep_loop(long long total, int dim, F&& f) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g * 8 < total; g += stride) {
    const long long e0 = g * 8;
    if (VEC) {
      f.vec8(e0, channel_of(e0, dim));
    } else {
      for (int j = 0; j < 8 && e0 + j < total; ++j)
        f.one(e0 + j, channel_of(e0 + j, dim));
    }
  }
}

template <bool RELU>
struct ZOp {
  const __nv_bfloat16* x;
  const float* a;
  const float* b;
  __nv_bfloat16* out;
  __device__ void one(long long e, int k) const {
    out[e] = __float2bfloat16(zval<__nv_bfloat16, true, RELU>(
        to_float(x[e]), affine_of<true>(a, b, k)));
  }
  __device__ void vec8(long long e0, int k0) const {
    const uint4 xv = *reinterpret_cast<const uint4*>(x + e0);
    const __nv_bfloat16* x8 = reinterpret_cast<const __nv_bfloat16*>(&xv);
    uint4 ov;
    __nv_bfloat16* o8 = reinterpret_cast<__nv_bfloat16*>(&ov);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o8[j] = __float2bfloat16(zval<__nv_bfloat16, true, RELU>(
          to_float(x8[j]), affine_of<true>(a, b, k0 + j)));
    *reinterpret_cast<uint4*>(out + e0) = ov;
  }
};

// (a template, so that every source that includes this header may define it)
template <bool RELU, bool VEC>
__global__ void __launch_bounds__(kPrepThreads)
prep_z_kernel(ZOp<RELU> op, long long total, int k_dim) {
  prep_loop<VEC>(total, k_dim, op);
}

inline unsigned prep_blocks(long long total) {
  return static_cast<unsigned>(std::min(
      cdiv(cdiv(total, 8), kPrepThreads),
      static_cast<long long>(kPrepMaxBlocks)));
}

// z [m, k] of x [m, k] bf16 with the affine a, b [k] (and relu) on stream
template <bool RELU, bool VEC>
inline cudaError_t prep_z(const __nv_bfloat16* x, const float* a,
                          const float* b, __nv_bfloat16* z, long long m,
                          int k, cudaStream_t stream) {
  const long long mk = m * k;
  prep_z_kernel<RELU, VEC><<<prep_blocks(mk), kPrepThreads, 0, stream>>>(
      ZOp<RELU>{x, a, b, z}, mk, k);
  return cudaGetLastError();
}

}  // namespace conv
}  // namespace apex

// The prep passes of the fused convolutions' bf16 paths (Kernels J, K, L
// and M of the PyTorch port): one elementwise pass that writes z = relu?(x a +
// b) and one that writes dy_eff = dy + ds0 + 2 (y - c) ds1, each rounded to
// bf16 (conv_fused.cuh's zval and dyc: the rounding points of the plain
// version) once to scratch, with 16-byte loads and stores where the
// channel count allows. The implicit GEMMs that follow read z and dy_eff as
// plain bf16 tensors, each operand row copied 16 bytes at a time.
//
// Each pass is a template over the kernel that runs it (KernelJ, KernelK,
// KernelL, KernelM), so that a profile names J's, K's, L's and M's passes
// apart; the code is the same.
#pragma once

#include <algorithm>

#include "conv_fused.cuh"

namespace apex {
namespace conv {

constexpr int kPrepThreads = 256;
constexpr int kPrepMaxBlocks = 132 * 16;

// which kernel runs a prep pass (template tags: names in a profile only)
struct KernelJ;
struct KernelK;
struct KernelL;
struct KernelM;

// Channel of flat element e of a [rows, dim] tensor.
__device__ __forceinline__ int channel_of(long long e, int dim) {
  return e < (1LL << 32)
             ? static_cast<int>(static_cast<unsigned>(e) %
                                static_cast<unsigned>(dim))
             : static_cast<int>(e % dim);
}

// Eight elements a thread: with VEC (dim % 8 == 0, 16-byte aligned
// tensors and per-channel vectors) one 16-byte load of each input and one
// store, all eight in one row, and the row's eight per-channel
// coefficients in two 16-byte loads each; else element by element.
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

inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<size_t>(ptr) & 15) == 0;
}

// eight fp32 of a 16-byte aligned per-channel vector, two 16-byte loads
__device__ __forceinline__ void load8(float (&v)[8], const float* p) {
  *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(p);
  *reinterpret_cast<float4*>(v + 4) = *reinterpret_cast<const float4*>(p + 4);
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
    float a8[8], b8[8];
    load8(a8, a + k0);
    load8(b8, b + k0);
    uint4 ov;
    __nv_bfloat16* o8 = reinterpret_cast<__nv_bfloat16*>(&ov);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o8[j] = __float2bfloat16(zval<__nv_bfloat16, true, RELU>(
          to_float(x8[j]), Affine{a8[j], b8[j]}));
    *reinterpret_cast<uint4*>(out + e0) = ov;
  }
};

struct DyEffOp {
  const __nv_bfloat16* dy;
  const __nv_bfloat16* y;
  const float* c;
  const float* ds;
  __nv_bfloat16* out;
  int n_dim;
  __device__ void one(long long e, int n) const {
    out[e] = __float2bfloat16(dyc<__nv_bfloat16>(
        to_float(dy[e]), to_float(y[e]), cot_of(c, ds, n_dim, n)));
  }
  __device__ void vec8(long long e0, int n0) const {
    const uint4 dv = *reinterpret_cast<const uint4*>(dy + e0);
    const uint4 yv = *reinterpret_cast<const uint4*>(y + e0);
    const __nv_bfloat16* d8 = reinterpret_cast<const __nv_bfloat16*>(&dv);
    const __nv_bfloat16* y8 = reinterpret_cast<const __nv_bfloat16*>(&yv);
    float c8[8], s08[8], s18[8];
    load8(c8, c + n0);
    load8(s08, ds + n0);
    load8(s18, ds + n_dim + n0);
    uint4 ov;
    __nv_bfloat16* o8 = reinterpret_cast<__nv_bfloat16*>(&ov);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o8[j] = __float2bfloat16(dyc<__nv_bfloat16>(
          to_float(d8[j]), to_float(y8[j]), Cot{c8[j], s08[j], s18[j]}));
    *reinterpret_cast<uint4*>(out + e0) = ov;
  }
};

// (templates, so that every source that includes this header may define
// them)
template <class OWNER, bool RELU, bool VEC>
__global__ void __launch_bounds__(kPrepThreads)
prep_z_kernel(ZOp<RELU> op, long long total, int k_dim) {
  prep_loop<VEC>(total, k_dim, op);
}

template <class OWNER, bool VEC>
__global__ void __launch_bounds__(kPrepThreads)
prep_dy_kernel(DyEffOp op, long long total) {
  prep_loop<VEC>(total, op.n_dim, op);
}

inline unsigned prep_blocks(long long total) {
  return static_cast<unsigned>(std::min(
      cdiv(cdiv(total, 8), kPrepThreads),
      static_cast<long long>(kPrepMaxBlocks)));
}

// z [m, k] of x [m, k] bf16 with the affine a, b [k] (and relu) on stream
template <class OWNER, bool RELU, bool VEC>
inline cudaError_t prep_z(const __nv_bfloat16* x, const float* a,
                          const float* b, __nv_bfloat16* z, long long m,
                          int k, cudaStream_t stream) {
  const long long mk = m * k;
  prep_z_kernel<OWNER, RELU, VEC>
      <<<prep_blocks(mk), kPrepThreads, 0, stream>>>(ZOp<RELU>{x, a, b, z},
                                                     mk, k);
  return cudaGetLastError();
}

// dy_eff [m, n] of dy and y [m, n] bf16, the shift c [n] and the stats
// cotangent ds [2, n] on stream
template <class OWNER, bool VEC>
inline cudaError_t prep_dy(const __nv_bfloat16* dy, const __nv_bfloat16* y,
                           const float* c, const float* ds,
                           __nv_bfloat16* dy_eff, long long m, int n,
                           cudaStream_t stream) {
  const long long mn = m * n;
  prep_dy_kernel<OWNER, VEC><<<prep_blocks(mn), kPrepThreads, 0, stream>>>(
      DyEffOp{dy, y, c, ds, dy_eff, n}, mn);
  return cudaGetLastError();
}

}  // namespace conv
}  // namespace apex

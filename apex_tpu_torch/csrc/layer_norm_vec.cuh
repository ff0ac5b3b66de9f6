// The 16-byte row layout shared by the LayerNorm kernels' 16-bit paths
// (Kernels A and D, bf16 and fp16): a row of h 16-bit elements (h % 8 ==
// 0) is h / 8 pieces of 16 bytes. `lanes` lanes of a warp hold a row (a
// power of two; 32 / lanes rows share a warp), lane l holding pieces l,
// l + lanes, ... up to PPL of them, so one warp-wide load of a slot reads
// 16 * lanes contiguous bytes. ops/layer_norm.py `layer_norm_fwd_plan` /
// `layer_norm_bwd_plan` choose PPL and lanes on the host.
#pragma once

#include "common.cuh"

namespace ln {

using bf16 = __nv_bfloat16;
using f16 = __half;

// warps a block of either 16-byte kernel
constexpr int kVecWarps = 8;
constexpr int kVecThreads = 32 * kVecWarps;

// the 8 T of a piece as fp32 (exact)
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = apex::Half16<T>::unpack(w[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

// 8 values rounded once to T (round to nearest even) into one piece
template <typename T>
__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = apex::Half16<T>::pack(v[2 * k], v[2 * k + 1]);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T>
__device__ __forceinline__ uint4 load_piece(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// 8 consecutive elements of a parameter vector as loaded (16 bytes of a
// 16-bit type or 32 of fp32), kept so in registers: a kernel issues all of
// its parameter loads before it uses the first one (a 16-bit piece
// unpacked right after its load would stall the warp once a piece), and
// 16-bit parameters take half the registers
template <typename T>
struct Raw8 {
  uint4 v;  // bf16 or fp16
};
template <>
struct Raw8<float> {
  float4 lo, hi;
};

__device__ __forceinline__ Raw8<float> load_raw(const float* p) {
  return {reinterpret_cast<const float4*>(p)[0],
          reinterpret_cast<const float4*>(p)[1]};
}
template <typename T>
__device__ __forceinline__ Raw8<T> load_raw(const T* p) {
  return {load_piece(p)};
}

__device__ __forceinline__ void expand(const Raw8<float>& r, float (&v)[8]) {
  v[0] = r.lo.x; v[1] = r.lo.y; v[2] = r.lo.z; v[3] = r.lo.w;
  v[4] = r.hi.x; v[5] = r.hi.y; v[6] = r.hi.z; v[7] = r.hi.w;
}
template <typename T>
__device__ __forceinline__ void expand(const Raw8<T>& r, float (&v)[8]) {
  unpack<T>(r.v, v);
}

// 8 outputs: one 16-bit piece, or two float4 stores
template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = pack<T>(v);
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// sum over the `lanes` lanes of one row (xor offsets below `lanes` stay
// inside the row's lanes), in a fixed order; every lane takes part
__device__ __forceinline__ float row_sum(float v, int lanes) {
  for (int off = lanes / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace ln

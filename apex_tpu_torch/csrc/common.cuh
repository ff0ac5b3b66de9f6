// Shared helpers for the apex_tpu_torch kernels: dtype codes (kept in
// step with apex_tpu_torch/ops/_support.py), float conversion of f32, bf16
// and fp16 elements, the traits of the two 16-bit types (Half16), and warp
// reductions.
//
// Every conversion to a 16-bit type rounds to nearest even and keeps
// fp16's subnormals (the _rn intrinsics; the kernels are built without
// --use_fast_math or -ftz): a small unscaled gradient lives there.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace apex {

// dtype codes passed from Python (_support.dtype_code). An entry point
// returns cudaErrorInvalidValue for a code it does not instantiate, so a
// kernel never reads one type's bytes as another's.
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as XLA and torch do
}
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half_rn(v);   // overflows to inf past 65504, as torch does
}

// v rounded to the element type T and read back as fp32 (the rounding point
// of a value the JAX package casts to the input dtype before a product):
// round_to(v, static_cast<T*>(nullptr)).
__device__ __forceinline__ float round_to(float v, float*) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float round_to(float v, __half*) {
  return __half2float(__float2half_rn(v));
}

// The two 16-bit element types of the 16-byte and tensor-core paths:
// a pair of values in one 32-bit word (x in the low half), the raw bits of
// one element, and mma.sync m16n8k16 with fp32 sums. bf16 unpacks by
// shifts (a bf16 is the high half of a float); both pack with one
// round-to-nearest-even conversion of the pair.
template <typename T>
struct Half16;

template <>
struct Half16<__nv_bfloat16> {
  static constexpr int kCode = kBF16;
  __device__ static __forceinline__ unsigned pack(float x, float y) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<const unsigned*>(&p);
  }
  __device__ static __forceinline__ float2 unpack(unsigned w) {
    return make_float2(__uint_as_float(w << 16),
                       __uint_as_float(w & 0xffff0000u));
  }
  __device__ static __forceinline__ unsigned bits(__nv_bfloat16 v) {
    return __bfloat16_as_ushort(v);
  }
  // d += a b (the tensor cores carry the sum)
  __device__ static __forceinline__ void mma(float (&d)[4],
                                             const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // d = a b from a zero accumulator (the fused convs' GEMM, bf16 only)
  __device__ static __forceinline__ void mma_zero(float (&d)[4],
                                                  const unsigned (&a)[4],
                                                  unsigned b0, unsigned b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(0.f));
  }
};

template <>
struct Half16<__half> {
  static constexpr int kCode = kF16;
  __device__ static __forceinline__ unsigned pack(float x, float y) {
    const __half2 p = __floats2half2_rn(x, y);
    return *reinterpret_cast<const unsigned*>(&p);
  }
  __device__ static __forceinline__ float2 unpack(unsigned w) {
    return __half22float2(*reinterpret_cast<const __half2*>(&w));
  }
  __device__ static __forceinline__ unsigned bits(__half v) {
    return __half_as_ushort(v);
  }
  __device__ static __forceinline__ void mma(float (&d)[4],
                                             const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// The 16-bit type that kernels over x of type TX pair with it (a 16-bit
// weight, output or gradient): fp16 with fp16 x, bf16 with bf16 or f32 x.
// Mixing bf16 and fp16 is not instantiated.
template <typename TX>
struct Pair16 {
  using type = __nv_bfloat16;
};
template <>
struct Pair16<__half> {
  using type = __half;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace apex

// Tensor-core GEMM pieces for Hopper written with the pre-Hopper
// instructions: a ring of shared-memory stages filled by cp.async (16 bytes
// a copy, zero-filled where the source is out of range), fragments read by
// ldmatrix (optionally transposed), and mma.sync m16n8k16 with 16-bit
// operands and fp32 results. No TMA and no wgmma: later work. The copies
// and ldmatrix move bits whatever the 16-bit type (T: bf16 or fp16, the
// element type of the pointers); the products take it from
// apex::Half16<T> (common.cuh), the GEMM loop (mma_tile, warp_step) of the
// fused convs too.
//
// A warp owns a tile of MT m16 tiles by NT n8 tiles of the output (4 MT NT
// fp32 sums a thread). Each 16-deep product lands in a zeroed
// fragment that is then added into those sums with ordinary fp32 adds (the
// tensor cores' own accumulation does not round each add, and over the
// thousands of rows of a dW chunk it drifted to 2e-5 norm-wise).
//
// Accumulator layout (PTX ISA, mma.m16n8k16): acc[i][j][e] is row
// 16 i + g + 8 (e >> 1), column 8 j + 2 t + (e & 1) of the warp's tile,
// with g = lane / 4 and t = lane % 4.
#pragma once

#include "common.cuh"

namespace apex {
namespace ring {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes without reading
// when !valid (a source size of 0); src must be a mapped address either way.
// L1: cached in L1 as well as L2 (.ca), for rows that neighbouring copies
// of the same block read again; else L2 only (.cg).
template <bool L1>
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  if (L1)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Eight 16-bit elements of one operand row into shared memory: a 16-byte
// cp.async when VEC (the row's channel count and base are 16-byte
// multiples, so the 8 channels are all in range or all out), else element
// by element, with channels from `left` on (and everything when !valid)
// read as zero.
template <bool VEC, bool L1 = false, typename T = bf16>
__device__ __forceinline__ void copy8(T* dst, const T* src, const T* base,
                                      bool valid, int left) {
  if (VEC) {
    const bool ok = valid && left > 0;
    cp_async16<L1>(dst, ok ? src : base, ok);
  } else {
    unsigned v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const unsigned lo = (valid && 2 * e < left)
                              ? Half16<T>::bits(src[2 * e]) : 0u;
      const unsigned hi = (valid && 2 * e + 1 < left)
                              ? Half16<T>::bits(src[2 * e + 1]) : 0u;
      v[e] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d = a b for one m16n8k16 tile of T operands, from a zero accumulator
template <typename T>
__device__ __forceinline__ void mma16(float (&d)[4], const unsigned (&a)[4],
                                      unsigned b0, unsigned b1) {
  Half16<T>::mma_zero(d, a, b0, b1);
}

// Fragments of A and B over 16 of the contraction (from kk on) for a
// warp's (16 MT) x (8 NT) tile (NT even), and their products. A_T: A is
// stored contraction-major (element (row, kk) at a[kk * lda + row]), else
// row-major (a[row * lda + kk]); B_T: B is stored contraction-major
// (element (kk, col) at b[kk * ldb + col]), else column-major (b[col * ldb
// + kk]). a and b point at the warp's first row and column; every
// 8-element row that ldmatrix reads is 16-byte aligned.
template <int MT, bool A_T, typename T>
__device__ __forceinline__ void load_a(unsigned (&fa)[MT][4], const T* a,
                                       int lda, int kk) {
  const int lane = threadIdx.x & 31;
  const int r8 = lane & 7;
  const int q1 = (lane >> 3) & 1;  // which 8 of the second index
  const int q2 = lane >> 4;        // which 8 of the first index
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (A_T)
      ldsm_x4_t(fa[i], a + (kk + r8 + 8 * q2) * lda + 16 * i + 8 * q1);
    else
      ldsm_x4(fa[i], a + (16 * i + r8 + 8 * q1) * lda + kk + 8 * q2);
  }
}

template <int NT, bool B_T, typename T>
__device__ __forceinline__ void load_b(unsigned (&fb)[NT / 2][4],
                                       const T* b, int ldb, int kk) {
  const int lane = threadIdx.x & 31;
  const int r8 = lane & 7;
  const int q1 = (lane >> 3) & 1;
  const int q2 = lane >> 4;
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    if (B_T)
      ldsm_x4_t(fb[j], b + (kk + r8 + 8 * q1) * ldb + 16 * j + 8 * q2);
    else
      ldsm_x4(fb[j], b + (16 * j + r8 + 8 * q2) * ldb + kk + 8 * q1);
  }
}

// acc += A B for fragments of T operands (T: the element type, bf16 or
// fp16)
template <int MT, int NT, typename T>
__device__ __forceinline__ void mma_tile(float (&acc)[MT][NT][4],
                                         const unsigned (&fa)[MT][4],
                                         const unsigned (&fb)[NT / 2][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float d[4];
      mma16<T>(d, fa[i], fb[j >> 1][2 * (j & 1)], fb[j >> 1][2 * (j & 1) + 1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += d[e];
    }
  }
}

// acc += A B over 16 of the contraction, as above (T from the pointers)
template <int MT, int NT, bool A_T, bool B_T, typename T>
__device__ __forceinline__ void warp_step(const T* a, int lda, const T* b,
                                          int ldb, int kk,
                                          float (&acc)[MT][NT][4]) {
  unsigned fa[MT][4];
  unsigned fb[NT / 2][4];
  load_a<MT, A_T>(fa, a, lda, kk);
  load_b<NT, B_T>(fb, b, ldb, kk);
  mma_tile<MT, NT, T>(acc, fa, fb);
}

// The ring: slice s of `slices` is loaded into stage s % STAGES by load()
// (called once a slice, in order, so a loader may carry its position) and
// consumed by step() once it has landed, STAGES - 1 slices after its copy
// was issued. One barrier a slice: the stage overwritten at iteration it
// is the one every warp finished reading at iteration it - 1.
template <int STAGES, int STAGE_BYTES, class Load, class Step>
__device__ __forceinline__ void run_ring(int slices, unsigned char* smem,
                                         Load&& load, Step&& step) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < slices) load(smem + s * STAGE_BYTES);
    cp_async_commit();
  }
  for (int it = 0; it < slices; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = it + STAGES - 1;
    if (next < slices) load(smem + (next % STAGES) * STAGE_BYTES);
    cp_async_commit();
    step(smem + (it % STAGES) * STAGE_BYTES);
  }
  cp_async_wait<0>();
}

}  // namespace ring
}  // namespace apex

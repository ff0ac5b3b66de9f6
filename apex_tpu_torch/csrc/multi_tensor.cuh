// Launch records of the multi-tensor kernels (csrc/multi_tensor.cu).
//
// apex's csrc/multi_tensor_apply.cuh design: every tensor of a list is cut
// into chunks of kChunk elements, and a launch takes a table of tensor
// pointers and sizes plus a chunk -> tensor map, for up to kMaxTensors
// tensors and kMaxChunks chunks; the launcher loops until the list is
// covered. apex packs that table into the kernel's parameters and rebuilds
// it on the host at every call. Here each launch's table is a record of
// kWords 64-bit words in device memory, built once for a fixed list by
// apex_tpu_torch/ops/multi_tensor.py (`TensorTable`, which keeps these
// constants and this layout in step) and rebuilt only when a pointer
// changes; the kernel gets the record's address.
//
// Record layout (64-bit words):
//   [0] tensors in the record, [1] chunks in the record,
//   [2] global index of its first tensor, [3] global index of its first chunk;
//   kAddr:   kMaxLists x kMaxTensors addresses (list-major);
//   kCode:   kMaxLists x kMaxTensors dtype codes (apex::DType);
//   kSize:   kMaxTensors element counts;
//   kStep:   kMaxTensors addresses of int32 step counters (0: none);
//   kChunks: kMaxChunks entries, (tensor index in the record << 32) | chunk
//            index in that tensor.
// A tensor larger than a record's chunks continues in the next record
// under the same pointers; chunks are numbered globally in list order, so
// a tensor's chunks are one contiguous run of global chunk indices.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace mt {

constexpr int kChunk = 16384;  // elements a block covers
constexpr int kThreads = 256;  // a block: 64 elements a thread
constexpr int kMaxLists = 6;   // LAMB: g, p, m, v, update, master
constexpr int kMaxTensors = 128;
constexpr int kMaxChunks = 2048;

constexpr int kAddr = 4;
constexpr int kCode = kAddr + kMaxLists * kMaxTensors;
constexpr int kSize = kCode + kMaxLists * kMaxTensors;
constexpr int kStep = kSize + kMaxTensors;
constexpr int kChunks = kStep + kMaxTensors;
constexpr int kWords = kChunks + kMaxChunks;

struct Record {
  const long long* w;

  __device__ __forceinline__ int tensors() const { return static_cast<int>(w[0]); }
  __device__ __forceinline__ long long first_tensor() const { return w[2]; }
  __device__ __forceinline__ long long first_chunk() const { return w[3]; }
  __device__ __forceinline__ void* addr(int list, int j) const {
    return reinterpret_cast<void*>(w[kAddr + list * kMaxTensors + j]);
  }
  __device__ __forceinline__ int code(int list, int j) const {
    return static_cast<int>(w[kCode + list * kMaxTensors + j]);
  }
  __device__ __forceinline__ long long size(int j) const { return w[kSize + j]; }
  __device__ __forceinline__ const int* step(int j) const {
    return reinterpret_cast<const int*>(w[kStep + j]);
  }
  __device__ __forceinline__ long long chunk(int b) const { return w[kChunks + b]; }
};

// The chunk of this block: tensor j of the record, elements [lo, hi).
struct Span {
  int j;
  long long lo, hi;
};

__device__ __forceinline__ Span block_span(const Record& r) {
  const long long c = r.chunk(blockIdx.x);
  Span s;
  s.j = static_cast<int>(c >> 32);
  s.lo = (c & 0xffffffffLL) * kChunk;
  const long long n = r.size(s.j);
  s.hi = s.lo + kChunk < n ? s.lo + kChunk : n;
  return s;
}

// Element i of a tensor of dtype `code`, as fp32 (exact for bf16 and fp16).
__device__ __forceinline__ float load(const void* p, int code, long long i) {
  if (code == apex::kBF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (code == apex::kF16) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

// v rounded to nearest even into a tensor of dtype `code`, as torch's
// `.to(dtype)` rounds.
__device__ __forceinline__ void store(void* p, int code, long long i, float v) {
  if (code == apex::kBF16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else if (code == apex::kF16)
    static_cast<__half*>(p)[i] = __float2half_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

// True when the step is to be skipped: found_inf (a device bool) is set.
__device__ __forceinline__ bool skipped(const unsigned char* found_inf) {
  return found_inf != nullptr && *found_inf != 0;
}

// The sum of v over a kThreads block in a fixed order (lanes by xor
// shuffles, then the warps in order); valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* warps) {
  v = apex::warp_sum(v);
  if (threadIdx.x % 32 == 0) warps[threadIdx.x / 32] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < static_cast<int>(blockDim.x) / 32; ++w) total = __fadd_rn(total, warps[w]);
  return total;
}

// The launcher: one launch per record, in order, a block per chunk of the
// record (`chunks` is a host array of the records' chunk counts).
template <typename... Params, typename... Args>
cudaError_t launch_records(void (*kernel)(Record, Params...), const long long* records,
                           const int* chunks, int n_records, cudaStream_t stream,
                           Args... args) {
  for (int r = 0; r < n_records; ++r) {
    kernel<<<chunks[r], kThreads, 0, stream>>>(
        Record{records + static_cast<long long>(r) * kWords}, args...);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace mt

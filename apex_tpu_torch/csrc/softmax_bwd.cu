// Scaled softmax backward (Kernel H of the PyTorch port).
//
// Replaces: apex_tpu/ops/softmax.py `_bwd_pallas` (:111) and its kernel
// body, through `pl.pallas_call` (:124).
//
// Semantics kept (:118-122): per row, s = rowsum(dy * y) in fp32 and
// dx = scale * y * (dy - s), computed in fp32 and rounded once to dy's
// dtype (f32, bf16 or fp16; an fp16 dx past 65504 is inf, as the plain
// version's cast gives it). The mask is not applied again: a position the
// forward filled with -10000 gets y * (dy - s) like any other, as the JAX
// custom VJP gives it.
//
// Bound on the H100: bytes. At BERT-base pretraining (16 x 12 x 512 rows
// of 512, bf16) it reads dy and y and writes dx once: ~302 MB, ~90 us at
// 3.35 TB/s.
//
// Design: one warp per row, eight rows per 256-thread block; a row of up to
// 1024 keeps dy and y in registers and is read once, a longer row twice.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kVPL = 32;  // values a lane holds in registers: k <= 1024

template <typename T>
__global__ void __launch_bounds__(kThreads)
softmax_bwd_reg_kernel(const T* __restrict__ dy, const T* __restrict__ y,
                       T* __restrict__ dx, long long rows, int k,
                       float scale) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const long long base = row * k;
  float g[kVPL];
  float p[kVPL];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kVPL; ++i) {
    const int c = lane + 32 * i;
    g[i] = c < k ? apex::to_float(dy[base + c]) : 0.f;
    p[i] = c < k ? apex::to_float(y[base + c]) : 0.f;
    s += g[i] * p[i];
  }
  s = apex::warp_sum(s);
#pragma unroll
  for (int i = 0; i < kVPL; ++i) {
    const int c = lane + 32 * i;
    if (c < k) apex::store(&dx[base + c], scale * p[i] * (g[i] - s));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
softmax_bwd_long_kernel(const T* __restrict__ dy, const T* __restrict__ y,
                        T* __restrict__ dx, long long rows, int k,
                        float scale) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const long long base = row * k;
  float s = 0.f;
  for (int c = lane; c < k; c += 32)
    s += apex::to_float(dy[base + c]) * apex::to_float(y[base + c]);
  s = apex::warp_sum(s);
  for (int c = lane; c < k; c += 32) {
    const float p = apex::to_float(y[base + c]);
    apex::store(&dx[base + c], scale * p * (apex::to_float(dy[base + c]) - s));
  }
}

template <typename T>
cudaError_t launch(const void* dy, const void* y, void* dx, long long rows,
                   int k, float scale, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  if (k <= 32 * kVPL)
    softmax_bwd_reg_kernel<T><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(dy), static_cast<const T*>(y),
        static_cast<T*>(dx), rows, k, scale);
  else
    softmax_bwd_long_kernel<T><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(dy), static_cast<const T*>(y),
        static_cast<T*>(dx), rows, k, scale);
  return cudaGetLastError();
}

}  // namespace

// dy, y and dx [rows, k] contiguous, one dtype.
extern "C" int apex_softmax_bwd(const void* dy, const void* y, void* dx,
                                void* stream, long long rows, int k,
                                float scale, int dtype) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == apex::kBF16)
    err = launch<__nv_bfloat16>(dy, y, dx, rows, k, scale, st);
  else if (dtype == apex::kF16)
    err = launch<__half>(dy, y, dx, rows, k, scale, st);
  else if (dtype == apex::kF32)
    err = launch<float>(dy, y, dx, rows, k, scale, st);
  return static_cast<int>(err);
}

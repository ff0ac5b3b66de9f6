// LayerNorm / RMSNorm forward (Kernel A of the PyTorch port).
//
// Replaces: apex_tpu/ops/layer_norm.py `_fwd_kernel` (:50), launched by
// `_fwd_pallas` (:76) through `pl.pallas_call` (:108).
//
// Semantics kept from the TPU kernel: per-row statistics in fp32 with the
// same two-pass order (sum -> mean, then the sum of squared centred values
// -> variance, then 1/sqrt(var + eps)); RMSNorm has mean 0 and
// var = mean(x^2); y = xhat * w + b in fp32, rounded once to the output
// type; mean and invvar are written in fp32 for the backward.
//
// Bound on the H100: memory. At the serving shapes ([tokens, 768] bf16)
// the kernel reads x once and writes y once (about 3 KB a row) against
// ~8 fp32 operations per element, far below the card's 295 operations per
// byte, so the floor is (bytes read + written) / 3.35 TB/s.
//
// Design: one warp per row, four rows per 128-thread block. The warp
// stages its row in shared memory as fp32 while summing, so x is read
// from device memory once; both later passes (centred variance, output)
// read shared memory. Reductions are warp shuffles, no block barrier.
// Later work: 16-byte vector loads and several rows per warp.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;

struct LnArgs {
  const void* x;
  const void* w;
  const void* b;
  void* y;
  float* mean;
  float* invvar;
  int m;
  int h;
  float eps;
  int is_rms;
};

template <typename TX, typename TW, typename TY>
__global__ void __launch_bounds__(kWarps * 32)
layer_norm_fwd_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                      const TW* __restrict__ b, TY* __restrict__ y,
                      float* __restrict__ mean_out,
                      float* __restrict__ invvar_out, int m, int h,
                      float eps, int is_rms) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (row >= m) return;  // whole warp leaves; no block barrier below
  float* xs = smem + static_cast<size_t>(warp) * h;
  const TX* xr = x + row * h;

  // pass 1: stage the row (each lane reads back only what it wrote)
  float sum = 0.f;
  for (int i = lane; i < h; i += 32) {
    const float v = apex::to_float(xr[i]);
    xs[i] = v;
    sum += v;
  }
  float mean = 0.f;
  float sq = 0.f;
  if (is_rms) {
    for (int i = lane; i < h; i += 32) sq += xs[i] * xs[i];
  } else {
    mean = apex::warp_sum(sum) / h;
    // pass 2: centred variance, as in _fwd_kernel (not Welford)
    for (int i = lane; i < h; i += 32) {
      const float c = xs[i] - mean;
      sq += c * c;
    }
  }
  const float var = apex::warp_sum(sq) / h;
  const float invvar = 1.f / sqrtf(var + eps);

  // pass 3: normalise, affine, round once
  TY* yr = y + row * h;
  for (int i = lane; i < h; i += 32) {
    float v = (xs[i] - mean) * invvar;
    if (w != nullptr) v *= apex::to_float(w[i]);
    if (b != nullptr) v += apex::to_float(b[i]);
    apex::store(&yr[i], v);
  }
  if (lane == 0) {
    mean_out[row] = mean;
    invvar_out[row] = invvar;
  }
}

template <typename TX, typename TW, typename TY>
cudaError_t launch(const LnArgs& a, cudaStream_t stream) {
  auto kernel = layer_norm_fwd_kernel<TX, TW, TY>;
  const size_t smem = static_cast<size_t>(kWarps) * a.h * sizeof(float);
  cudaError_t err = apex::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((a.m + kWarps - 1) / kWarps);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const TX*>(a.x), static_cast<const TW*>(a.w),
      static_cast<const TW*>(a.b), static_cast<TY*>(a.y), a.mean, a.invvar,
      a.m, a.h, a.eps, a.is_rms);
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t launch_y(const LnArgs& a, int y_dtype, cudaStream_t stream) {
  return y_dtype == apex::kBF16 ? launch<TX, TW, __nv_bfloat16>(a, stream)
                                : launch<TX, TW, float>(a, stream);
}

template <typename TX>
cudaError_t launch_w(const LnArgs& a, int w_dtype, int y_dtype,
                     cudaStream_t stream) {
  return w_dtype == apex::kBF16 ? launch_y<TX, __nv_bfloat16>(a, y_dtype, stream)
                                : launch_y<TX, float>(a, y_dtype, stream);
}

}  // namespace

// w and b may be null (non-affine / bias-free); w_dtype is then ignored.
extern "C" int apex_layer_norm_fwd(const void* x, const void* w, const void* b,
                                   void* y, void* mean, void* invvar,
                                   void* stream, int m, int h, float eps,
                                   int is_rms, int x_dtype, int w_dtype,
                                   int y_dtype) {
  LnArgs a{x, w, b, y, static_cast<float*>(mean), static_cast<float*>(invvar),
           m, h, eps, is_rms};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      x_dtype == apex::kBF16
          ? launch_w<__nv_bfloat16>(a, w_dtype, y_dtype, s)
          : launch_w<float>(a, w_dtype, y_dtype, s);
  return static_cast<int>(err);
}

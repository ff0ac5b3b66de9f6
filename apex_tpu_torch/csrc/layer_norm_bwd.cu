// LayerNorm / RMSNorm backward (Kernel D of the PyTorch port).
//
// Replaces: apex_tpu/ops/layer_norm.py `_bwd_kernel` (:151), launched by
// `_bwd_pallas` (:197) through `pl.pallas_call` (:239).
//
// Semantics kept from the TPU kernel: xhat = (x - mean) * invvar from the
// forward's fp32 statistics (mean 0 for RMSNorm); dyw = dy * w (or dy);
// c1 = sum(dyw) / h, c2 = sum(dyw * xhat) / h;
// dx = invvar * (dyw - c1 - xhat * c2), RMSNorm without c1; dx is rounded
// once to x's type. dw = sum over rows of dy * xhat and db = sum of dy,
// both fp32 (the caller casts them to the weight's type).
//
// What does not carry over: the TPU kernel accumulates dw/db into one
// (8, hp) block that every grid step revisits, which relies on the grid
// running in order. Blocks on the card run in parallel, so pass 1 writes
// one fp32 partial row of dw and db per block, and pass 2 sums the
// partials column by column in a fixed order (the result does not depend
// on scheduling: repeated runs are bitwise equal).
//
// Bound on the H100: memory. At the GPT-2 training shape ([8192, 768]
// bf16) pass 1 reads dy and x once and writes dx (37.7 MB) against ~12
// fp32 operations per element; the partials (kRows = 32 rows a block:
// 256 x 2 x 768 fp32) add 1.6 MB written and read once.
//
// Design: one block of up to 8 warps per 32 rows; a warp owns a row at a
// time, lane i the columns i, i + 32, ... The row's sums are warp
// shuffles; the second sweep re-reads dy and x (L1/L2 hits) to form dx.
// Each warp adds its rows' dy * xhat and dy into its own fp32 row of
// shared memory (a lane touches only its own columns, so no atomics);
// the block then sums its warps' rows into its partial. Rows past m and
// columns past h are never read (loop bounds).
#include "common.cuh"

namespace {

constexpr int kRows = 32;        // rows per block in pass 1
constexpr int kMaxWarps = 8;
constexpr int kPass2Threads = 256;

template <typename TDY, typename TX, typename TW>
__global__ void __launch_bounds__(kMaxWarps * 32)
layer_norm_bwd_kernel(const TDY* __restrict__ dy, const TX* __restrict__ x,
                      const float* __restrict__ mean,
                      const float* __restrict__ invvar,
                      const TW* __restrict__ w, TX* __restrict__ dx,
                      float* __restrict__ partial, int m, int h, int is_rms,
                      int has_bias) {
  extern __shared__ float smem[];
  const int n_warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool affine = partial != nullptr;
  float* acc_w = smem + static_cast<size_t>(warp) * 2 * h;
  float* acc_b = acc_w + h;
  if (affine) {
    for (int i = lane; i < h; i += 32) {
      acc_w[i] = 0.f;
      acc_b[i] = 0.f;
    }
  }
  const float inv_h = 1.f / h;
  const int blk = blockIdx.x;
  const int row_end = min(m, (blk + 1) * kRows);
  for (int row = blk * kRows + warp; row < row_end; row += n_warps) {
    const TDY* dyr = dy + static_cast<long long>(row) * h;
    const TX* xr = x + static_cast<long long>(row) * h;
    const float mu = is_rms ? 0.f : mean[row];
    const float iv = invvar[row];
    float s1 = 0.f;
    float s2 = 0.f;
    for (int i = lane; i < h; i += 32) {
      const float d = apex::to_float(dyr[i]);
      const float xh = (apex::to_float(xr[i]) - mu) * iv;
      const float dw = w != nullptr ? d * apex::to_float(w[i]) : d;
      s1 += dw;
      s2 += dw * xh;
      if (affine) {
        acc_w[i] += d * xh;
        acc_b[i] += d;
      }
    }
    const float c1 = is_rms ? 0.f : apex::warp_sum(s1) * inv_h;
    const float c2 = apex::warp_sum(s2) * inv_h;
    TX* dxr = dx + static_cast<long long>(row) * h;
    for (int i = lane; i < h; i += 32) {
      const float d = apex::to_float(dyr[i]);
      const float xh = (apex::to_float(xr[i]) - mu) * iv;
      const float dw = w != nullptr ? d * apex::to_float(w[i]) : d;
      apex::store(&dxr[i], iv * (dw - c1 - xh * c2));
    }
  }
  if (!affine) return;
  __syncthreads();
  // the block's partial row: warps summed in a fixed order
  float* out = partial + static_cast<size_t>(blk) * 2 * h;
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    float sw = 0.f;
    float sb = 0.f;
    for (int k = 0; k < n_warps; ++k) {
      sw += smem[static_cast<size_t>(k) * 2 * h + i];
      sb += smem[static_cast<size_t>(k) * 2 * h + h + i];
    }
    out[i] = sw;
    if (has_bias) out[h + i] = sb;
  }
}

// dw[i] = sum over blocks of partial[blk][0][i]; db likewise from [1].
__global__ void __launch_bounds__(kPass2Threads)
layer_norm_bwd_reduce(const float* __restrict__ partial, float* __restrict__ dw,
                      float* __restrict__ db, int n_blocks, int h) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= h) return;
  float sw = 0.f;
  float sb = 0.f;
  for (int k = 0; k < n_blocks; ++k) {
    sw += partial[static_cast<size_t>(k) * 2 * h + i];
    if (db != nullptr) sb += partial[static_cast<size_t>(k) * 2 * h + h + i];
  }
  dw[i] = sw;
  if (db != nullptr) db[i] = sb;
}

struct LnBwdArgs {
  const void* dy;
  const void* x;
  const float* mean;
  const float* invvar;
  const void* w;
  void* dx;
  float* partial;  // [n_blocks, 2, h] fp32 scratch, null without affine
  float* dw;
  float* db;       // null without bias
  int m;
  int h;
  int is_rms;
};

// warps per block: as many as fit 2 fp32 rows each in shared memory
inline int warps_for(int h) {
  const int per_warp = 2 * h * static_cast<int>(sizeof(float));
  const int fit = (200 * 1024) / per_warp;
  return fit < 1 ? 1 : (fit > kMaxWarps ? kMaxWarps : fit);
}

template <typename TDY, typename TX, typename TW>
cudaError_t launch(const LnBwdArgs& a, cudaStream_t stream) {
  auto kernel = layer_norm_bwd_kernel<TDY, TX, TW>;
  const int n_blocks = (a.m + kRows - 1) / kRows;
  const int warps = warps_for(a.h);
  const bool affine = a.partial != nullptr;
  const size_t smem = affine ? static_cast<size_t>(warps) * 2 * a.h * sizeof(float) : 0;
  cudaError_t err = apex::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_blocks, warps * 32, smem, stream>>>(
      static_cast<const TDY*>(a.dy), static_cast<const TX*>(a.x), a.mean,
      a.invvar, static_cast<const TW*>(a.w), static_cast<TX*>(a.dx),
      a.partial, a.m, a.h, a.is_rms, a.db != nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess || !affine) return err;
  layer_norm_bwd_reduce<<<(a.h + kPass2Threads - 1) / kPass2Threads,
                          kPass2Threads, 0, stream>>>(a.partial, a.dw, a.db,
                                                      n_blocks, a.h);
  return cudaGetLastError();
}

template <typename TDY, typename TX>
cudaError_t launch_w(const LnBwdArgs& a, int w_dtype, cudaStream_t stream) {
  return w_dtype == apex::kBF16 ? launch<TDY, TX, __nv_bfloat16>(a, stream)
                                : launch<TDY, TX, float>(a, stream);
}

template <typename TDY>
cudaError_t launch_x(const LnBwdArgs& a, int x_dtype, int w_dtype,
                     cudaStream_t stream) {
  return x_dtype == apex::kBF16 ? launch_w<TDY, __nv_bfloat16>(a, w_dtype, stream)
                                : launch_w<TDY, float>(a, w_dtype, stream);
}

}  // namespace

// kRows (32) rows per pass-1 block: the caller sizes `partial` as
// [ceil(m / 32), 2, h] fp32 (ops/layer_norm.py _BWD_ROWS). w may be null
// (non-affine: partial, dw and db are null too); db is null without a
// bias. All tensors contiguous.
extern "C" int apex_layer_norm_bwd(const void* dy, const void* x,
                                   const void* mean, const void* invvar,
                                   const void* w, void* dx, void* partial,
                                   void* dw, void* db, void* stream, int m,
                                   int h, int is_rms, int dy_dtype,
                                   int x_dtype, int w_dtype) {
  LnBwdArgs a{dy, x, static_cast<const float*>(mean),
              static_cast<const float*>(invvar), w, dx,
              static_cast<float*>(partial), static_cast<float*>(dw),
              static_cast<float*>(db), m, h, is_rms};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dy_dtype == apex::kBF16
                        ? launch_x<__nv_bfloat16>(a, x_dtype, w_dtype, s)
                        : launch_x<float>(a, x_dtype, w_dtype, s);
  return static_cast<int>(err);
}

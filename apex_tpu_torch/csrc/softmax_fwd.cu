// Scaled masked softmax forward (Kernel G of the PyTorch port).
//
// Replaces: apex_tpu/ops/softmax.py `_fwd_body` (:47), launched by
// `_fwd_pallas` (:65) through `pl.pallas_call` (:88).
//
// Semantics kept (`_fwd_body`): per row of x, logits = float(x) * scale in
// fp32; where the boolean mask is set the logit becomes -10000 (the fill
// comes after the scale, `_MASK_FILL`); with `causal`, column c of
// flattened row r is filled when c > r % sq (:54-57); then a softmax in
// fp32, written in x's dtype. A row whose every logit is filled is uniform,
// 1/k, exactly as the JAX function gives it (no "fully masked -> 0" rule).
//
// What does not carry over: the TPU kernel pads each row to a multiple of
// 128 lanes and reads a mask expanded to [rows, k] (`softmax.py:191`). Here
// a row has any length k, and the mask is read through the broadcast
// strides of its [d0, d1, d2, k] view, so BERT's [b, 1, s, s] and the
// encoder-decoder's [b, 1, 1, s] masks stay as they are in memory.
//
// Bound on the H100: bytes. At BERT-base pretraining (16 x 12 x 512 rows of
// 512 bf16 scores, mask [16, 1, 512, 512]) the kernel reads x once and
// writes y once: ~206 MB, ~61 us at 3.35 TB/s; ~10 operations an element
// is far below the card's rate.
//
// Design: one warp per row, eight rows per 256-thread block. A row of up to
// 1024 keeps its logits in registers (32 a lane) and is read once; a longer
// row is read twice (an online max and sum, then the normalised write).
// Lanes stride the row, so a warp's loads are contiguous.
#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kVPL = 32;  // values a lane holds in registers: k <= 1024
constexpr float kFill = -10000.0f;  // softmax.py _MASK_FILL

struct Args {
  const unsigned char* mask;   // bool, or null
  long long ms0, ms1, ms2, ms3;  // the mask's strides over [d0, d1, d2, k]
  long long rows;
  int k, d1, d2;
  float scale;
  int sq;
  int causal;
};

__device__ __forceinline__ long long mask_base(const Args& a, long long row) {
  const long long i2 = row % a.d2;
  const long long t = row / a.d2;
  return (t / a.d1) * a.ms0 + (t % a.d1) * a.ms1 + i2 * a.ms2;
}

template <typename T>
__device__ __forceinline__ float logit(const T* xr, const Args& a,
                                       long long mb, int q_pos, int c) {
  float l = apex::to_float(xr[c]) * a.scale;
  if (a.mask != nullptr && a.mask[mb + c * a.ms3]) l = kFill;
  if (a.causal && c > q_pos) l = kFill;
  return l;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
softmax_fwd_reg_kernel(const T* __restrict__ x, T* __restrict__ y,
                       const Args a) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= a.rows) return;
  const T* xr = x + row * a.k;
  T* yr = y + row * a.k;
  const long long mb = a.mask != nullptr ? mask_base(a, row) : 0;
  const int q_pos = a.causal ? static_cast<int>(row % a.sq) : 0;
  float v[kVPL];
  float m = -FLT_MAX;
#pragma unroll
  for (int i = 0; i < kVPL; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < a.k ? logit(xr, a, mb, q_pos, c) : -FLT_MAX;
    m = fmaxf(m, v[i]);
  }
  m = apex::warp_max(m);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kVPL; ++i) {
    v[i] = lane + 32 * i < a.k ? expf(v[i] - m) : 0.f;
    s += v[i];
  }
  s = apex::warp_sum(s);
#pragma unroll
  for (int i = 0; i < kVPL; ++i) {
    const int c = lane + 32 * i;
    if (c < a.k) apex::store(&yr[c], v[i] / s);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
softmax_fwd_long_kernel(const T* __restrict__ x, T* __restrict__ y,
                        const Args a) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= a.rows) return;
  const T* xr = x + row * a.k;
  T* yr = y + row * a.k;
  const long long mb = a.mask != nullptr ? mask_base(a, row) : 0;
  const int q_pos = a.causal ? static_cast<int>(row % a.sq) : 0;
  // online max and sum over this lane's columns, then across the warp
  float m = -FLT_MAX;
  float s = 0.f;
  for (int c = lane; c < a.k; c += 32) {
    const float l = logit(xr, a, mb, q_pos, c);
    if (l > m) {
      s = s * expf(m - l) + 1.f;
      m = l;
    } else {
      s += expf(l - m);
    }
  }
  const float m_row = apex::warp_max(m);
  s = apex::warp_sum(s * expf(m - m_row));
  for (int c = lane; c < a.k; c += 32)
    apex::store(&yr[c], expf(logit(xr, a, mb, q_pos, c) - m_row) / s);
}

template <typename T>
cudaError_t launch(const void* x, void* y, const Args& a, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((a.rows + kWarps - 1) / kWarps);
  if (a.k <= 32 * kVPL)
    softmax_fwd_reg_kernel<T><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), a);
  else
    softmax_fwd_long_kernel<T><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), a);
  return cudaGetLastError();
}

}  // namespace

// x and y [rows, k] contiguous, rows = d0 * d1 * d2; mask bool (or null)
// addressed as mask[i0 * ms0 + i1 * ms1 + i2 * ms2 + c * ms3] for row
// (i0 * d1 + i1) * d2 + i2; sq >= 1 (read only when causal).
extern "C" int apex_softmax_fwd(const void* x, const void* mask, void* y,
                                void* stream, long long rows, int k, int d1,
                                int d2, long long ms0, long long ms1,
                                long long ms2, long long ms3, float scale,
                                int sq, int causal, int dtype) {
  const Args a{static_cast<const unsigned char*>(mask), ms0, ms1, ms2, ms3,
               rows, k, d1, d2, scale, sq, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == apex::kBF16
                              ? launch<__nv_bfloat16>(x, y, a, st)
                              : launch<float>(x, y, a, st);
  return static_cast<int>(err);
}

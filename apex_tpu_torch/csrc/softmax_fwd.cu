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
// 512 bf16 scores, mask [16, 1, 512, 512]) the kernel must read the
// visible scores and the mask and write y: ~0.05 ms at 3.35 TB/s (all of x
// and y: ~206 MB, ~61 us); ~10 operations an element is far below the
// card's rate. What bounded the element path there was issue, not bytes
// (PERF.md, measured with apex_tpu_torch/tools/softmax_timing.py on an
// H100 at 700 W: 16-byte x loads took 0.372 ms to 0.123, 8-byte mask
// loads to 0.111, exp2f and one reciprocal a row in place of expf and a
// division an element to 0.084, ~2.4 TB/s).
//
// bf16 or fp16 with k % 8 == 0 and k <= 1024, x and y 16-byte aligned, and
// no mask or one whose last stride is 1 and whose other strides and base
// are multiples of 8 bytes (ops/softmax.py `softmax_fwd_plan`), the row
// kernel on 16-byte loads: each lane reads 8 of x in one 16-byte load and
// the 8 mask bytes beside them in one 8-byte load, and holds up to four
// such pieces in registers (a row of 512: two a lane). A row takes the
// power of two of lanes that covers its pieces, at most 32, so rows
// shorter than 256 share a warp. The mask's row offset (the 64-bit / and
// % of its broadcast strides) is taken once a row. The logits are taken
// to base 2 (x * (scale log2 e), the fill -10000 log2 e), exponentiated by
// exp2f and normalised by one reciprocal a row.
//
// fp16 takes the same paths as bf16 (one template over the 16-bit type);
// its logits are the same fp32 values, and y is rounded once to fp16.
//
// Other rows, and f32: one warp per row, eight rows per 256-thread block,
// element by element. A row of up to 1024 keeps its logits in registers
// (32 a lane) and is read once; a longer row is read twice (an online max
// and sum, then the normalised write). Lanes stride the row, so a warp's
// loads are contiguous.
#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kVPL = 32;  // values a lane holds in registers: k <= 1024
constexpr float kFill = -10000.0f;  // softmax.py _MASK_FILL
constexpr float kLog2e = 1.4426950408889634f;

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

// max and sum over the LPR lanes of one row (xor offsets below LPR stay
// inside the row's lanes), in a fixed order
template <int LPR>
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <int LPR>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// bf16 or fp16 (T) on 16-byte loads: LPR lanes a row (32 / LPR rows a
// warp), piece j of lane i covering columns 8 (i + LPR j) .. + 7, CPL pieces
// a lane
template <typename T, int CPL, int LPR>
__global__ void __launch_bounds__(kThreads)
softmax_fwd_vec_kernel(const T* __restrict__ x, T* __restrict__ y,
                       const Args a) {
  constexpr int kRows = 32 / LPR;  // rows a warp
  const int lane = threadIdx.x % 32;
  const int li = lane % LPR;
  const long long row =
      (static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32) *
          kRows + lane / LPR;
  // lanes of a row past the last stay for the shuffles, reading nothing
  const bool live = row < a.rows;
  const T* xr = x + (live ? row : 0) * a.k;
  T* yr = y + (live ? row : 0) * a.k;
  const long long mb = a.mask != nullptr && live ? mask_base(a, row) : 0;
  const int q_pos = a.causal && live ? static_cast<int>(row % a.sq) : 0;
  // logits in base 2: exp2f(l - m) below is exp(l / log2 e - ...)
  const float scale = a.scale * kLog2e;
  const float fill = kFill * kLog2e;
  float v[CPL][8];
  float m = -FLT_MAX;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c0 = 8 * (li + LPR * j);
    const bool in = live && c0 < a.k;
    uint4 xv = make_uint4(0u, 0u, 0u, 0u);
    unsigned long long mv = 0ull;  // the eight mask bytes, one an element
    if (in) {
      xv = *reinterpret_cast<const uint4*>(xr + c0);
      if (a.mask != nullptr)
        mv = *reinterpret_cast<const unsigned long long*>(a.mask + mb + c0);
    }
    const T* x8 = reinterpret_cast<const T*>(&xv);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float l = apex::to_float(x8[e]) * scale;
      if ((mv >> (8 * e)) & 0xffu) l = fill;
      if (a.causal && c0 + e > q_pos) l = fill;
      v[j][e] = in ? l : -FLT_MAX;
      m = fmaxf(m, v[j][e]);
    }
  }
  m = row_max<LPR>(m);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const bool in = live && 8 * (li + LPR * j) < a.k;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[j][e] = in ? exp2f(v[j][e] - m) : 0.f;
      s += v[j][e];
    }
  }
  s = row_sum<LPR>(s);
  const float r = __frcp_rn(s);
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c0 = 8 * (li + LPR * j);
    if (!(live && c0 < a.k)) continue;
    uint4 ov;
    T* o8 = reinterpret_cast<T*>(&ov);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      apex::store(&o8[e], v[j][e] * r);
    *reinterpret_cast<uint4*>(yr + c0) = ov;
  }
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

template <typename T, int CPL, int LPR>
cudaError_t launch_vec(const void* x, void* y, const Args& a,
                       cudaStream_t stream) {
  constexpr long long kBlockRows = kWarps * (32 / LPR);
  const unsigned blocks =
      static_cast<unsigned>((a.rows + kBlockRows - 1) / kBlockRows);
  softmax_fwd_vec_kernel<T, CPL, LPR><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), a);
  return cudaGetLastError();
}

// (pieces a lane, lanes a row) as ops/softmax.py `softmax_fwd_plan` picks
// them: one piece a lane over 1-32 lanes, or two or four over 32
template <typename T>
cudaError_t launch_vec(const void* x, void* y, const Args& a, int cpl,
                       int lpr, cudaStream_t stream) {
  if (cpl == 1) {
    switch (lpr) {
      case 1: return launch_vec<T, 1, 1>(x, y, a, stream);
      case 2: return launch_vec<T, 1, 2>(x, y, a, stream);
      case 4: return launch_vec<T, 1, 4>(x, y, a, stream);
      case 8: return launch_vec<T, 1, 8>(x, y, a, stream);
      case 16: return launch_vec<T, 1, 16>(x, y, a, stream);
      case 32: return launch_vec<T, 1, 32>(x, y, a, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  if (cpl == 2 && lpr == 32) return launch_vec<T, 2, 32>(x, y, a, stream);
  if (cpl == 4 && lpr == 32) return launch_vec<T, 4, 32>(x, y, a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// x and y [rows, k] contiguous, rows = d0 * d1 * d2; mask bool (or null)
// addressed as mask[i0 * ms0 + i1 * ms1 + i2 * ms2 + c * ms3] for row
// (i0 * d1 + i1) * d2 + i2; sq >= 1 (read only when causal). cpl > 0 (bf16
// and fp16) takes the 16-byte path with cpl pieces a lane and lpr lanes a row,
// under ops/softmax.py `softmax_fwd_plan`'s conditions; cpl = 0 the
// element path.
extern "C" int apex_softmax_fwd(const void* x, const void* mask, void* y,
                                void* stream, long long rows, int k, int d1,
                                int d2, long long ms0, long long ms1,
                                long long ms2, long long ms3, float scale,
                                int sq, int causal, int dtype, int cpl,
                                int lpr) {
  const Args a{static_cast<const unsigned char*>(mask), ms0, ms1, ms2, ms3,
               rows, k, d1, d2, scale, sq, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == apex::kBF16)
    err = cpl > 0 ? launch_vec<__nv_bfloat16>(x, y, a, cpl, lpr, st)
                  : launch<__nv_bfloat16>(x, y, a, st);
  else if (dtype == apex::kF16)
    err = cpl > 0 ? launch_vec<__half>(x, y, a, cpl, lpr, st)
                  : launch<__half>(x, y, a, st);
  else if (dtype == apex::kF32 && cpl == 0)
    err = launch<float>(x, y, a, st);
  return static_cast<int>(err);
}

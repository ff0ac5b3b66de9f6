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
// bf16 or fp16 x with h % 8 == 0, h <= 1024 and 16-byte aligned x, y, w
// and b (ops/layer_norm.py `layer_norm_fwd_plan`): the 16-byte kernel. A
// lane holds its pieces of the row in registers (layer_norm_vec.cuh; no
// shared-memory stage), the sums are shuffles over the row's lanes, y is
// written as 16-byte pieces (x's 16-bit type) or two float4 (f32). w and b are read
// once a warp and kept in registers as loaded, and the warp walks several
// rows (the grid is at most the card's resident blocks; a decode step's
// few rows spread one a block), loading the next row's x before it
// reduces the current one. Measured with apex_tpu_torch/tools/
// ln_timing.py on an H100 at 700 W (PERF.md): [8, 768] in 0.0066 ms, 1.3x
// the ~0.0049 ms of one timed launch of a one-element fill; [6144, 768]
// in 0.0134 ms with a cold L2 (0.0093 of kernel time).
//
// The dtypes (x, w, y) instantiated, on both paths: w and y each f32 or
// the 16-bit type x pairs with (apex::Pair16: bf16 for f32 or bf16 x,
// fp16 for fp16 x; an absent w counts as f32). fp16 x with an fp16 w (amp
// O2), an f32 w (O1) or none, into fp16 or f32 y (`_out_dtype`), is what
// the models run; y rounds to inf past 65504, as torch's cast does.
// Another triple is cudaErrorInvalidValue (the wrapper raises first).
//
// Other cases (f32 x, other h, unaligned rows): one warp per row, four
// rows per 128-thread block. The warp stages its row in shared memory as
// fp32 while summing, so x is read from device memory once; both later
// passes (centred variance, output) read shared memory. Reductions are
// warp shuffles, no block barrier.
#include "common.cuh"
#include "layer_norm_vec.cuh"

namespace {

using ln::bf16;
using ln::f16;
using ln::kVecThreads;
using ln::kVecWarps;

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
  int n_blocks;
  int block_rows;  // the 16-byte path: consecutive rows a block takes
  int lanes;       // the 16-byte path: lanes a row
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

// a lane's pieces of row `row` of x (zeros past the block's rows or the
// row's pieces)
template <int PPL, typename TX>
__device__ __forceinline__ void load_row(uint4 (&piece)[PPL],
                                         const TX* __restrict__ x, int row,
                                         int row_end, int h, int li,
                                         int lanes) {
#pragma unroll
  for (int i = 0; i < PPL; ++i) {
    const int p = li + lanes * i;
    piece[i] = make_uint4(0u, 0u, 0u, 0u);
    if (row < row_end && p < h / 8)
      piece[i] = ln::load_piece(x + static_cast<long long>(row) * h + 8 * p);
  }
}

// 16-bit x (TX) on 16-byte pieces; PPL pieces a lane at most
template <int PPL, typename TX, typename TW, typename TY>
__global__ void __launch_bounds__(kVecThreads)
layer_norm_fwd_vec_kernel(const LnArgs a) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int lanes = a.lanes;
  const int li = lane % lanes;
  const int h = a.h;
  const int pieces = h / 8;
  const int rows_a_warp = 32 / lanes;
  const TX* x = static_cast<const TX*>(a.x);
  const TW* w = static_cast<const TW*>(a.w);
  const TW* b = static_cast<const TW*>(a.b);
  TY* y = static_cast<TY*>(a.y);
  const int row0 = blockIdx.x * a.block_rows;
  const int row_end = min(a.m, row0 + a.block_rows);
  const int step = kVecWarps * rows_a_warp;
  const int slot = lane / lanes;
  const int first = row0 + warp * rows_a_warp;  // this warp's first slot
  // w and b as loaded for this lane's columns, the same for every row (a
  // warp without rows loads neither); the first row's x is loaded before
  // any of them is used
  ln::Raw8<TW> wv[PPL] = {}, bv[PPL] = {};
#pragma unroll
  for (int i = 0; i < PPL; ++i) {
    const int p = li + lanes * i;
    if (first < row_end && p < pieces) {
      if (w != nullptr) wv[i] = ln::load_raw(w + 8 * p);
      if (b != nullptr) bv[i] = ln::load_raw(b + 8 * p);
    }
  }
  uint4 next[PPL];
  load_row<PPL>(next, x, first + slot, row_end, h, li, lanes);
  // the whole warp walks its row slots together (shuffles need every
  // lane); a slot past the block's rows reads and writes nothing
  for (int base = first; base < row_end; base += step) {
    const int row = base + slot;
    float v[PPL][8];
#pragma unroll
    for (int i = 0; i < PPL; ++i) ln::unpack<TX>(next[i], v[i]);
    load_row<PPL>(next, x, base + step + slot, row_end, h, li, lanes);
    // an empty piece holds zeros: it adds nothing to the sum
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < PPL; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += v[i][e];
    float mean = 0.f;
    float sq = 0.f;
    if (a.is_rms) {
#pragma unroll
      for (int i = 0; i < PPL; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) sq += v[i][e] * v[i][e];
    } else {
      mean = ln::row_sum(sum, lanes) / h;
      // centred variance, as in _fwd_kernel (not Welford)
#pragma unroll
      for (int i = 0; i < PPL; ++i) {
        if (li + lanes * i >= pieces) continue;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float c = v[i][e] - mean;
          sq += c * c;
        }
      }
    }
    const float var = ln::row_sum(sq, lanes) / h;
    const float invvar = 1.f / sqrtf(var + a.eps);
    if (row < row_end) {
#pragma unroll
      for (int i = 0; i < PPL; ++i) {
        const int p = li + lanes * i;
        if (p >= pieces) continue;
        float wf[8], bf[8], out[8];
        ln::expand(wv[i], wf);
        ln::expand(bv[i], bf);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          out[e] = (v[i][e] - mean) * invvar;
          if (w != nullptr) out[e] *= wf[e];
          if (b != nullptr) out[e] += bf[e];
        }
        ln::store8(y + static_cast<long long>(row) * h + 8 * p, out);
      }
      if (li == 0) {
        a.mean[row] = mean;
        a.invvar[row] = invvar;
      }
    }
  }
}

using VecKernel = void (*)(LnArgs);

template <int PPL, typename TX, typename TW>
VecKernel vec_kernel_y(int y_dtype) {
  if (y_dtype == apex::kF32) return layer_norm_fwd_vec_kernel<PPL, TX, TW, float>;
  if (y_dtype == apex::Half16<TX>::kCode)
    return layer_norm_fwd_vec_kernel<PPL, TX, TW, TX>;
  return nullptr;
}

template <int PPL, typename TX>
VecKernel vec_kernel_w(int w_dtype, int y_dtype) {
  if (w_dtype == apex::kF32) return vec_kernel_y<PPL, TX, float>(y_dtype);
  if (w_dtype == apex::Half16<TX>::kCode)
    return vec_kernel_y<PPL, TX, TX>(y_dtype);
  return nullptr;
}

template <int PPL>
VecKernel vec_kernel_of(int x_dtype, int w_dtype, int y_dtype) {
  if (x_dtype == apex::kBF16) return vec_kernel_w<PPL, bf16>(w_dtype, y_dtype);
  if (x_dtype == apex::kF16) return vec_kernel_w<PPL, f16>(w_dtype, y_dtype);
  return nullptr;
}

// null for a piece count the plan never gives or dtypes not instantiated
VecKernel vec_kernel(int pieces, int x_dtype, int w_dtype, int y_dtype) {
  switch (pieces) {
    case 1: return vec_kernel_of<1>(x_dtype, w_dtype, y_dtype);
    case 2: return vec_kernel_of<2>(x_dtype, w_dtype, y_dtype);
    case 3: return vec_kernel_of<3>(x_dtype, w_dtype, y_dtype);
    case 4: return vec_kernel_of<4>(x_dtype, w_dtype, y_dtype);
    default: return nullptr;
  }
}

template <typename TX, typename TW, typename TY>
cudaError_t launch(const LnArgs& a, cudaStream_t stream) {
  // the plan's blocks hold kWarps rows each, one a warp
  if (a.block_rows != kWarps) return cudaErrorInvalidValue;
  auto kernel = layer_norm_fwd_kernel<TX, TW, TY>;
  const size_t smem = static_cast<size_t>(kWarps) * a.h * sizeof(float);
  cudaError_t err = apex::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.n_blocks, kWarps * 32, smem, stream>>>(
      static_cast<const TX*>(a.x), static_cast<const TW*>(a.w),
      static_cast<const TW*>(a.b), static_cast<TY*>(a.y), a.mean, a.invvar,
      a.m, a.h, a.eps, a.is_rms);
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t launch_y(const LnArgs& a, int y_dtype, cudaStream_t stream) {
  using H = typename apex::Pair16<TX>::type;
  if (y_dtype == apex::kF32) return launch<TX, TW, float>(a, stream);
  if (y_dtype == apex::Half16<H>::kCode) return launch<TX, TW, H>(a, stream);
  return cudaErrorInvalidValue;
}

template <typename TX>
cudaError_t launch_w(const LnArgs& a, int w_dtype, int y_dtype,
                     cudaStream_t stream) {
  using H = typename apex::Pair16<TX>::type;
  if (w_dtype == apex::kF32) return launch_y<TX, float>(a, y_dtype, stream);
  if (w_dtype == apex::Half16<H>::kCode)
    return launch_y<TX, H>(a, y_dtype, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// The plan (ops/layer_norm.py `layer_norm_fwd_plan`) gives the path and
// the grid: `pieces` > 0 is the 16-byte kernel (16-bit x) with `pieces` a
// lane and `lanes` lanes a row, block b taking rows
// [b * block_rows, (b + 1) * block_rows); 0 is the element kernel, one
// warp a row and four rows a block. w and b may be null (non-affine /
// bias-free); w_dtype is then 0 (f32). Dtype triples off the list above
// return cudaErrorInvalidValue.
extern "C" int apex_layer_norm_fwd(const void* x, const void* w, const void* b,
                                   void* y, void* mean, void* invvar,
                                   void* stream, int m, int h, float eps,
                                   int is_rms, int x_dtype, int w_dtype,
                                   int y_dtype, int pieces, int lanes,
                                   int n_blocks, int block_rows) {
  LnArgs a{x, w, b, y, static_cast<float*>(mean), static_cast<float*>(invvar),
           m, h, eps, is_rms, n_blocks, block_rows, lanes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pieces > 0) {
    const VecKernel kernel = vec_kernel(pieces, x_dtype, w_dtype, y_dtype);
    if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    kernel<<<n_blocks, kVecThreads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = cudaErrorInvalidValue;
  if (x_dtype == apex::kBF16)
    err = launch_w<bf16>(a, w_dtype, y_dtype, s);
  else if (x_dtype == apex::kF16)
    err = launch_w<f16>(a, w_dtype, y_dtype, s);
  else if (x_dtype == apex::kF32)
    err = launch_w<float>(a, w_dtype, y_dtype, s);
  return static_cast<int>(err);
}

// Resident blocks an SM of the 16-byte kernel with `pieces` a lane,
// written to *blocks: the plan's grid is at most this times the SM count.
extern "C" int apex_layer_norm_fwd_blocks_per_sm(int pieces, int x_dtype,
                                                 int w_dtype, int y_dtype,
                                                 int* blocks) {
  const VecKernel kernel = vec_kernel(pieces, x_dtype, w_dtype, y_dtype);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, kVecThreads, 0));
}

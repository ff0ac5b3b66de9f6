// LayerNorm / RMSNorm backward (Kernel D of the PyTorch port).
//
// Replaces: apex_tpu/ops/layer_norm.py `_bwd_kernel` (:151), launched by
// `_bwd_pallas` (:197) through `pl.pallas_call` (:239).
//
// Semantics kept from the TPU kernel: xhat = (x - mean) * invvar from the
// forward's fp32 statistics (mean 0 for RMSNorm); dyw = dy * w (or dy);
// c1 = sum(dyw) / h, c2 = sum(dyw * xhat) / h;
// dx = invvar * (dyw - c1 - xhat * c2), RMSNorm without c1; dx is rounded
// once to x's type (to inf past fp16's 65504). dw = sum over rows of
// dy * xhat and db = sum of dy, both fp32 (the caller casts them to the
// weight's type once, where under a large loss scale an fp16 weight's
// gradient overflows to inf exactly where the plain version's does).
//
// What does not carry over: the TPU kernel accumulates dw/db into one
// (8, hp) block that every grid step revisits, which relies on the grid
// running in order. Blocks on the card run in parallel, so pass 1 writes
// one fp32 partial row of dw and db per block (the block takes
// `block_rows` consecutive rows), and pass 2 sums the partials column by
// column in a fixed order (the result does not depend on scheduling:
// repeated runs are bitwise equal).
//
// Bound on the H100: memory. At the GPT-2 training shape ([8192, 768]
// bf16) pass 1 reads dy and x once and writes dx (37.7 MB, 11.3 us at
// 3.35 TB/s) against ~12 fp32 operations per element.
//
// bf16 or fp16 dy and x (one type) with h % 8 == 0, h <= 1024 and
// 16-byte aligned dy, x, dx and w (ops/layer_norm.py
// `layer_norm_bwd_plan`): the 16-byte kernel.
// A lane holds its pieces of a row's dy and x in registers, still packed
// (layer_norm_vec.cuh; 3 a lane at h = 768), sums c1 and c2 by shuffles
// and forms dx from the same registers: dy and x are read once, dx
// written as 16-byte pieces. A lane's columns are the same for every row
// its warp takes, so w and the lane's fp32 dw/db sums stay in registers
// for the block's life; the rows sharing a warp are summed by shuffles
// and the warps through shared memory once, at the block's end, in a
// fixed order. The grid is the card's resident blocks (the plan asks the
// occupancy), rows split statically, so the partial rows are the grid.
// Pass 2 gives each block a strip of 8 columns, its 32 row slots
// (8 warps x 4) split the partial rows, and the slots are summed by
// shuffles and a fixed tree in shared memory. Measured with
// apex_tpu_torch/tools/ln_timing.py on an H100 at 700 W (PERF.md): 0.0246
// ms with a cold L2 at [8192, 768] (the element path 0.0843); pass 1
// moves its 37.7 MB at 2.1 TB/s, because w and the sums hold 72 of the
// 128 registers that keep two blocks an SM, leaving one row of loads in
// flight a warp (a second row prefetched cost the second block, slower).
//
// The dtypes (dy, x, w) instantiated, on both paths: dy and w each f32
// or the 16-bit type x pairs with (apex::Pair16: bf16 for f32 or bf16 x,
// fp16 for fp16 x; an absent w counts as f32); the 16-byte kernel also
// needs dy of x's type. Another triple is cudaErrorInvalidValue.
//
// Other cases (f32, mixed dy/x types, other h, unaligned rows): one block
// of up to 8 warps per 32 rows; a warp owns a row at a time, lane i the
// columns i, i + 32, ... The row's sums are warp shuffles; the second
// sweep re-reads dy and x (L1/L2 hits) to form dx. Each warp adds its
// rows' dy * xhat and dy into its own fp32 row of shared memory (a lane
// touches only its own columns, so no atomics); the block then sums its
// warps' rows into its partial. Rows past m and columns past h are never
// read (loop bounds). With affine rows the element kernel keeps 2 x h x 4
// bytes a warp in shared memory, at least one warp a block: past h = 29056
// that is more than the 227 KB a block may have.
//
// Wider rows (the wide path, `wide` = 1 in the plan): one block of 512
// threads takes `block_rows` consecutive rows, one at a time, thread t
// the columns t, t + 512, ... c1 and c2 are block sums in a fixed order
// (ln::block_sum); the second sweep re-reads dy and x from device memory
// (L2) to form dx. Each block adds its rows' dy * xhat and dy straight
// into its own fp32 row of `partial` in device memory: the block owns
// that row and each thread its columns, so no atomics, and a column's
// sum runs over the block's rows in order. Pass 2 (layer_norm_bwd_reduce)
// is the element path's. The plan gives about one block an SM, so the
// partial rows (256 KB each at h = 32768) stay a few tens of MB.
#include "common.cuh"
#include "layer_norm_vec.cuh"

namespace {

using ln::bf16;
using ln::f16;
using ln::kVecThreads;
using ln::kVecWarps;

constexpr int kMaxWarps = 8;
constexpr int kPass2Threads = 256;

template <typename TDY, typename TX, typename TW>
__global__ void __launch_bounds__(kMaxWarps * 32)
layer_norm_bwd_kernel(const TDY* __restrict__ dy, const TX* __restrict__ x,
                      const float* __restrict__ mean,
                      const float* __restrict__ invvar,
                      const TW* __restrict__ w, TX* __restrict__ dx,
                      float* __restrict__ partial, int m, int h, int is_rms,
                      int has_bias, int block_rows) {
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
  const int row_end = min(m, (blk + 1) * block_rows);
  for (int row = blk * block_rows + warp; row < row_end; row += n_warps) {
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

// the wide path: a block a row at a time, its dw/db partial row in
// device memory (see the header)
template <typename TDY, typename TX, typename TW>
__global__ void __launch_bounds__(ln::kWideThreads)
layer_norm_bwd_wide_kernel(const TDY* __restrict__ dy,
                           const TX* __restrict__ x,
                           const float* __restrict__ mean,
                           const float* __restrict__ invvar,
                           const TW* __restrict__ w, TX* __restrict__ dx,
                           float* __restrict__ partial, int m, int h,
                           int is_rms, int has_bias, int block_rows) {
  __shared__ float red[ln::kWideWarps];
  const int t = threadIdx.x;
  const bool affine = partial != nullptr;
  float* pw = affine ? partial + static_cast<size_t>(blockIdx.x) * 2 * h
                     : nullptr;
  if (affine) {
    for (int i = t; i < h; i += ln::kWideThreads) {
      pw[i] = 0.f;
      if (has_bias) pw[h + i] = 0.f;
    }
  }
  const float inv_h = 1.f / h;
  const long long row0 = static_cast<long long>(blockIdx.x) * block_rows;
  const long long row_end = min(static_cast<long long>(m), row0 + block_rows);
  for (long long row = row0; row < row_end; ++row) {
    const TDY* dyr = dy + row * h;
    const TX* xr = x + row * h;
    const float mu = is_rms ? 0.f : mean[row];
    const float iv = invvar[row];
    float s1 = 0.f;
    float s2 = 0.f;
    for (int i = t; i < h; i += ln::kWideThreads) {
      const float d = apex::to_float(dyr[i]);
      const float xh = (apex::to_float(xr[i]) - mu) * iv;
      const float g = w != nullptr ? d * apex::to_float(w[i]) : d;
      s1 += g;
      s2 += g * xh;
    }
    const float c1 = is_rms ? 0.f : ln::block_sum(s1, red) * inv_h;
    const float c2 = ln::block_sum(s2, red) * inv_h;
    TX* dxr = dx + row * h;
    for (int i = t; i < h; i += ln::kWideThreads) {
      const float d = apex::to_float(dyr[i]);
      const float xh = (apex::to_float(xr[i]) - mu) * iv;
      const float g = w != nullptr ? d * apex::to_float(w[i]) : d;
      apex::store(&dxr[i], iv * (g - c1 - xh * c2));
      if (affine) {
        pw[i] += d * xh;
        if (has_bias) pw[h + i] += d;
      }
    }
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

// The 16-byte path's arguments: one struct for every instance, so that one
// function pointer type serves the launch and the occupancy query.
struct VecArgs {
  const void* dy;    // T (bf16 or fp16), as x and dx
  const void* x;
  const float* mean;
  const float* invvar;
  const void* w;     // TW, null without affine
  void* dx;
  float* partial;    // [gridDim.x, 2, h] fp32, null without affine
  int m;
  int h;
  int is_rms;
  int lanes;         // lanes a row
  int block_rows;    // consecutive rows a block takes
};

// a lane's pieces of dy and x of `row` and the row's statistics (zeros
// past the block's rows or the row's pieces)
template <int PPL, typename T>
__device__ __forceinline__ void load_row(uint4 (&dv)[PPL], uint4 (&xv)[PPL],
                                         float& mu, float& iv,
                                         const VecArgs& a, int row,
                                         int row_end, int li) {
  const bool live = row < row_end;
  const long long off = static_cast<long long>(live ? row : 0) * a.h;
#pragma unroll
  for (int i = 0; i < PPL; ++i) {
    const int p = li + a.lanes * i;
    dv[i] = xv[i] = make_uint4(0u, 0u, 0u, 0u);
    if (live && p < a.h / 8) {
      dv[i] = ln::load_piece(static_cast<const T*>(a.dy) + off + 8 * p);
      xv[i] = ln::load_piece(static_cast<const T*>(a.x) + off + 8 * p);
    }
  }
  mu = live && !a.is_rms ? a.mean[row] : 0.f;
  iv = live ? a.invvar[row] : 0.f;
}

// 16-bit dy and x (T) on 16-byte pieces; AFF 0: no weight, 1: a weight
// (dw), 2: a weight and a bias (dw and db). PPL pieces a lane at most.
template <int PPL, typename T, typename TW, int AFF>
__global__ void __launch_bounds__(kVecThreads)
layer_norm_bwd_vec_kernel(const VecArgs a) {
  extern __shared__ float4 red4[];  // [kVecWarps][2h / 4], at the end only
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int lanes = a.lanes;
  const int li = lane % lanes;
  const int h = a.h;
  const int pieces = h / 8;
  const int rows_a_warp = 32 / lanes;
  const int row0 = blockIdx.x * a.block_rows;
  const int row_end = min(a.m, row0 + a.block_rows);
  const int first = row0 + warp * rows_a_warp;  // this warp's first slot
  // w as loaded and this lane's fp32 dw/db sums: the same columns for
  // every row (a warp without rows loads no w)
  constexpr int kW = AFF > 0 ? PPL : 1;
  constexpr int kB = AFF > 1 ? PPL : 1;
  ln::Raw8<TW> wv[kW] = {};
  float aw[kW][8], ab[kB][8];
#pragma unroll
  for (int i = 0; i < PPL; ++i) {
    const int p = li + lanes * i;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if constexpr (AFF > 0) aw[i][e] = 0.f;
      if constexpr (AFF > 1) ab[i][e] = 0.f;
    }
    if constexpr (AFF > 0) {
      if (first < row_end && p < pieces)
        wv[i] = ln::load_raw(static_cast<const TW*>(a.w) + 8 * p);
    }
  }
  const float inv_h = 1.f / h;
  // the whole warp walks its row slots together (shuffles need every
  // lane); a slot past the block's rows reads and writes nothing
  for (int base = first; base < row_end; base += kVecWarps * rows_a_warp) {
    const int row = base + lane / lanes;
    const bool live = row < row_end;
    const long long off = static_cast<long long>(live ? row : 0) * h;
    uint4 dv[PPL], xv[PPL];
    float mu, iv;
    load_row<PPL, T>(dv, xv, mu, iv, a, row, row_end, li);
    // an empty piece has d = 0: it adds nothing below
    float s1 = 0.f;
    float s2 = 0.f;
#pragma unroll
    for (int i = 0; i < PPL; ++i) {
      float d[8], xh[8], wf[8];
      ln::unpack<T>(dv[i], d);
      ln::unpack<T>(xv[i], xh);
      if constexpr (AFF > 0) ln::expand(wv[i], wf);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        xh[e] = (xh[e] - mu) * iv;
        float g = d[e];
        if constexpr (AFF > 0) g *= wf[e];
        s1 += g;
        s2 += g * xh[e];
        if constexpr (AFF > 0) aw[i][e] += d[e] * xh[e];
        if constexpr (AFF > 1) ab[i][e] += d[e];
      }
    }
    const float c1 = a.is_rms ? 0.f : ln::row_sum(s1, lanes) * inv_h;
    const float c2 = ln::row_sum(s2, lanes) * inv_h;
#pragma unroll
    for (int i = 0; i < PPL; ++i) {
      const int p = li + lanes * i;
      if (!(live && p < pieces)) continue;
      float d[8], xh[8], wf[8], out[8];
      ln::unpack<T>(dv[i], d);
      ln::unpack<T>(xv[i], xh);
      if constexpr (AFF > 0) ln::expand(wv[i], wf);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xhat = (xh[e] - mu) * iv;
        float g = d[e];
        if constexpr (AFF > 0) g *= wf[e];
        out[e] = iv * (g - c1 - xhat * c2);
      }
      ln::store8(static_cast<T*>(a.dx) + off + 8 * p, out);
    }
  }
  if constexpr (AFF > 0) {
    // the warp's row slots, summed by shuffles in a fixed order
    for (int sh = lanes; sh < 32; sh <<= 1) {
#pragma unroll
      for (int i = 0; i < PPL; ++i) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          aw[i][e] += __shfl_xor_sync(0xffffffffu, aw[i][e], sh);
          if constexpr (AFF > 1)
            ab[i][e] += __shfl_xor_sync(0xffffffffu, ab[i][e], sh);
        }
      }
    }
    float* red = reinterpret_cast<float*>(red4) + static_cast<size_t>(warp) * 2 * h;
    if (lane < lanes) {
#pragma unroll
      for (int i = 0; i < PPL; ++i) {
        const int p = li + lanes * i;
        if (p >= pieces) continue;
        ln::store8(red + 8 * p, aw[i]);
        if constexpr (AFF > 1) ln::store8(red + h + 8 * p, ab[i]);
      }
    }
    __syncthreads();
    // the block's partial row: warps summed in a fixed order
    const int quads = (AFF > 1 ? 2 * h : h) / 4;
    const int row_quads = 2 * h / 4;
    float4* out = reinterpret_cast<float4*>(a.partial) +
                  static_cast<size_t>(blockIdx.x) * row_quads;
    for (int q = threadIdx.x; q < quads; q += kVecThreads) {
      float4 s = red4[q];
#pragma unroll
      for (int k = 1; k < kVecWarps; ++k) {
        const float4 t = red4[k * row_quads + q];
        s.x += t.x;
        s.y += t.y;
        s.z += t.z;
        s.w += t.w;
      }
      out[q] = s;
    }
  }
}

// Pass 2 of the 16-byte path: dw (columns [0, h)) and db ([h, 2h)) of the
// partial rows [n_blocks, 2, h]. A block takes a strip of kStripCols
// columns; its 32 row slots (lane / 8 of each warp) sum every 32nd partial
// row in four interleaved fp32 sums, then the slots are summed by shuffles
// and the warps by a fixed tree in shared memory.
constexpr int kStripCols = 8;
constexpr int kSlots = kVecThreads / kStripCols;

__global__ void __launch_bounds__(kVecThreads)
layer_norm_bwd_strip_sum(const float* __restrict__ partial,
                         float* __restrict__ dw, float* __restrict__ db,
                         int n_blocks, int h) {
  __shared__ float red[kVecWarps][kStripCols];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col = blockIdx.x * kStripCols + lane % kStripCols;
  const int cols = db != nullptr ? 2 * h : h;
  const size_t stride = static_cast<size_t>(2) * h;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  if (col < cols) {
    const float* p = partial + col;
    int k = threadIdx.x / kStripCols;
    for (; k + 3 * kSlots < n_blocks; k += 4 * kSlots) {
      s0 += p[k * stride];
      s1 += p[(k + kSlots) * stride];
      s2 += p[(k + 2 * kSlots) * stride];
      s3 += p[(k + 3 * kSlots) * stride];
    }
    for (; k < n_blocks; k += kSlots) s0 += p[k * stride];
  }
  float s = (s0 + s1) + (s2 + s3);
  s += __shfl_xor_sync(0xffffffffu, s, 8);
  s += __shfl_xor_sync(0xffffffffu, s, 16);
  if (lane < kStripCols) red[warp][lane] = s;
  __syncthreads();
  if (threadIdx.x < kStripCols && col < cols) {
    const float t = ((red[0][lane] + red[1][lane]) +
                     (red[2][lane] + red[3][lane])) +
                    ((red[4][lane] + red[5][lane]) +
                     (red[6][lane] + red[7][lane]));
    if (col < h)
      dw[col] = t;
    else
      db[col - h] = t;
  }
}

using VecKernel = void (*)(VecArgs);

template <int PPL, typename T>
VecKernel vec_kernel_w(int w_dtype, int affine) {
  if (affine == 0) return layer_norm_bwd_vec_kernel<PPL, T, float, 0>;
  if (w_dtype == apex::Half16<T>::kCode)
    return affine == 1 ? layer_norm_bwd_vec_kernel<PPL, T, T, 1>
                       : layer_norm_bwd_vec_kernel<PPL, T, T, 2>;
  if (w_dtype == apex::kF32)
    return affine == 1 ? layer_norm_bwd_vec_kernel<PPL, T, float, 1>
                       : layer_norm_bwd_vec_kernel<PPL, T, float, 2>;
  return nullptr;
}

template <int PPL>
VecKernel vec_kernel_of(int x_dtype, int w_dtype, int affine) {
  if (x_dtype == apex::kBF16) return vec_kernel_w<PPL, bf16>(w_dtype, affine);
  if (x_dtype == apex::kF16) return vec_kernel_w<PPL, f16>(w_dtype, affine);
  return nullptr;
}

// null for a piece count the plan never gives or dtypes not instantiated
VecKernel vec_kernel(int pieces, int x_dtype, int w_dtype, int affine) {
  switch (pieces) {
    case 1: return vec_kernel_of<1>(x_dtype, w_dtype, affine);
    case 2: return vec_kernel_of<2>(x_dtype, w_dtype, affine);
    case 3: return vec_kernel_of<3>(x_dtype, w_dtype, affine);
    case 4: return vec_kernel_of<4>(x_dtype, w_dtype, affine);
    default: return nullptr;
  }
}

size_t vec_smem(int h, int affine) {
  return affine ? static_cast<size_t>(kVecWarps) * 2 * h * sizeof(float) : 0;
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
  int n_blocks;    // pass-1 blocks: the partial rows
  int block_rows;  // consecutive rows a pass-1 block takes
  int wide;        // the element path: 1 for the wide-row kernel
};

cudaError_t launch_vec(const LnBwdArgs& a, int x_dtype, int w_dtype,
                       int pieces, int lanes, cudaStream_t stream) {
  const int affine = a.partial == nullptr ? 0 : (a.db != nullptr ? 2 : 1);
  const VecKernel kernel = vec_kernel(pieces, x_dtype, w_dtype, affine);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  const size_t smem = vec_smem(a.h, affine);
  cudaError_t err = apex::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.n_blocks, kVecThreads, smem, stream>>>(VecArgs{
      a.dy, a.x, a.mean, a.invvar, a.w, a.dx, a.partial, a.m, a.h, a.is_rms,
      lanes, a.block_rows});
  err = cudaGetLastError();
  if (err != cudaSuccess || affine == 0) return err;
  const int cols = affine == 2 ? 2 * a.h : a.h;
  layer_norm_bwd_strip_sum<<<(cols + kStripCols - 1) / kStripCols,
                             kVecThreads, 0, stream>>>(a.partial, a.dw, a.db,
                                                       a.n_blocks, a.h);
  return cudaGetLastError();
}

// warps per block: as many as fit 2 fp32 rows each in shared memory
inline int warps_for(int h) {
  const int per_warp = 2 * h * static_cast<int>(sizeof(float));
  const int fit = (200 * 1024) / per_warp;
  return fit < 1 ? 1 : (fit > kMaxWarps ? kMaxWarps : fit);
}

template <typename TDY, typename TX, typename TW>
cudaError_t launch(const LnBwdArgs& a, cudaStream_t stream) {
  const bool affine = a.partial != nullptr;
  cudaError_t err;
  if (a.wide) {
    layer_norm_bwd_wide_kernel<TDY, TX, TW><<<a.n_blocks, ln::kWideThreads, 0,
                                              stream>>>(
        static_cast<const TDY*>(a.dy), static_cast<const TX*>(a.x), a.mean,
        a.invvar, static_cast<const TW*>(a.w), static_cast<TX*>(a.dx),
        a.partial, a.m, a.h, a.is_rms, a.db != nullptr, a.block_rows);
  } else {
    auto kernel = layer_norm_bwd_kernel<TDY, TX, TW>;
    const int warps = warps_for(a.h);
    const size_t smem = affine ? static_cast<size_t>(warps) * 2 * a.h * sizeof(float) : 0;
    err = apex::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<a.n_blocks, warps * 32, smem, stream>>>(
        static_cast<const TDY*>(a.dy), static_cast<const TX*>(a.x), a.mean,
        a.invvar, static_cast<const TW*>(a.w), static_cast<TX*>(a.dx),
        a.partial, a.m, a.h, a.is_rms, a.db != nullptr, a.block_rows);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || !affine) return err;
  layer_norm_bwd_reduce<<<(a.h + kPass2Threads - 1) / kPass2Threads,
                          kPass2Threads, 0, stream>>>(a.partial, a.dw, a.db,
                                                      a.n_blocks, a.h);
  return cudaGetLastError();
}

template <typename TDY, typename TX>
cudaError_t launch_w(const LnBwdArgs& a, int w_dtype, cudaStream_t stream) {
  using H = typename apex::Pair16<TX>::type;
  if (w_dtype == apex::kF32) return launch<TDY, TX, float>(a, stream);
  if (w_dtype == apex::Half16<H>::kCode) return launch<TDY, TX, H>(a, stream);
  return cudaErrorInvalidValue;
}

template <typename TX>
cudaError_t launch_dy(const LnBwdArgs& a, int dy_dtype, int w_dtype,
                      cudaStream_t stream) {
  using H = typename apex::Pair16<TX>::type;
  if (dy_dtype == apex::kF32) return launch_w<float, TX>(a, w_dtype, stream);
  if (dy_dtype == apex::Half16<H>::kCode)
    return launch_w<H, TX>(a, w_dtype, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// The plan (ops/layer_norm.py `layer_norm_bwd_plan`) gives the path and
// the grid: `pieces` > 0 is the 16-byte kernel with `pieces` a lane and
// `lanes` lanes a row (16-bit dy and x of one type), 0 the element kernel
// (with `wide`, the wide-row kernel); pass-1 block
// b takes rows [b * block_rows, (b + 1) * block_rows), and the caller
// sizes `partial` as [n_blocks, 2, h] fp32. w may be null (non-affine:
// partial, dw and db are null too; w_dtype 0); db is null without a bias.
// All tensors contiguous. Dtype triples off the list above return
// cudaErrorInvalidValue.
extern "C" int apex_layer_norm_bwd(const void* dy, const void* x,
                                   const void* mean, const void* invvar,
                                   const void* w, void* dx, void* partial,
                                   void* dw, void* db, void* stream, int m,
                                   int h, int is_rms, int dy_dtype,
                                   int x_dtype, int w_dtype, int pieces,
                                   int lanes, int n_blocks, int block_rows,
                                   int wide) {
  LnBwdArgs a{dy, x, static_cast<const float*>(mean),
              static_cast<const float*>(invvar), w, dx,
              static_cast<float*>(partial), static_cast<float*>(dw),
              static_cast<float*>(db), m, h, is_rms, n_blocks, block_rows,
              wide};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pieces > 0) {
    if (dy_dtype != x_dtype) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_vec(a, x_dtype, w_dtype, pieces, lanes, s));
  }
  cudaError_t err = cudaErrorInvalidValue;
  if (x_dtype == apex::kBF16)
    err = launch_dy<bf16>(a, dy_dtype, w_dtype, s);
  else if (x_dtype == apex::kF16)
    err = launch_dy<f16>(a, dy_dtype, w_dtype, s);
  else if (x_dtype == apex::kF32)
    err = launch_dy<float>(a, dy_dtype, w_dtype, s);
  return static_cast<int>(err);
}

// Resident blocks an SM of the 16-byte kernel with `pieces` a lane at
// width h over x_dtype rows (affine 0: none, 1: a weight, 2: a weight and
// a bias), written to *blocks: the plan's grid is this times the SM count.
extern "C" int apex_layer_norm_bwd_blocks_per_sm(int h, int pieces,
                                                 int x_dtype, int w_dtype,
                                                 int affine, int* blocks) {
  const VecKernel kernel = vec_kernel(pieces, x_dtype, w_dtype, affine);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = vec_smem(h, affine);
  cudaError_t err = apex::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, kVecThreads, smem));
}

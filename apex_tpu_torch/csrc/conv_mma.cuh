// The passes that the fused convolutions' bf16 paths share (Kernels J, K,
// L and M of the PyTorch port), on mma.sync m16n8k16 fed by the cp.async
// ring of mma_ring.cuh:
// - the forward GEMM, y = z w over the taps with the stats partials from
//   its fp32 fragments (Kernels J and L; J's y tiles staged into 16-byte
//   rows);
// - the dx pass, dz = dy_eff w^T over the taps followed by the relu mask,
//   dx = dg a and the da/db partials (Kernels K and M);
// - the fixed-order sum of per-chunk dW partials (K and M).
//
// Both GEMMs are templates over the tap count. TAPS = 9 is the 3x3
// convolution (L's y, M's transposed dx): A is z or dy_eff at the tap's
// shifted pixel, rows outside the image copied as zeros, the nine taps'
// overlapping rows through L1. TAPS = 1 is the 1x1 (J's y = z w, K's dx =
// dy_eff w^T): no shift, no halo, and the column blocks of one row block
// run next to each other (a 1D grid, columns fastest), so that its A rows
// come from memory once and then from L2.
#pragma once

#include "conv_fused.cuh"
#include "mma_ring.cuh"

namespace apex {
namespace conv {

using apex::ring::bf16;

constexpr int kStages = 4;
constexpr int kSlice = 32;           // contraction depth of one slice
constexpr int kRowH = kSlice + 8;    // stage rows: 32 channels + pad

__device__ __forceinline__ int slices_of(long long depth) {
  return static_cast<int>((depth + kSlice - 1) / kSlice);
}

// dx: 128 output pixels x 64 input channels, 8 warps (4 x 2) of 32 x 32,
// slices of (tap, 32 output channels); each stage holds dy_eff [128
// pixels][32 N] at the tap's shifted pixels and w[tap] [64 K][32 N].
constexpr int kDxMT = 2;                  // m16 tiles a warp
constexpr int kDxNT = 4;                  // n8 tiles a warp
constexpr int kDxRows = 4 * 16 * kDxMT;   // pixels a block
constexpr int kDxCols = 2 * 8 * kDxNT;    // input channels a block
constexpr int kDxThreads = 256;
constexpr int kDxStage = (kDxRows + kDxCols) * kRowH * 2;

// (templates, so that every source that includes this header may define
// them)
template <int TAPS, bool AFFINE, bool RELU, bool VEC>
__global__ void __launch_bounds__(kDxThreads)
dx_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
              const float* __restrict__ b, const bf16* __restrict__ w,
              const bf16* __restrict__ dye, bf16* __restrict__ dx,
              float* __restrict__ dab_partial, long long m, int h, int wd,
              int k, int n) {
  static_assert(TAPS == 1 || TAPS == 9, "a 1x1 or a 3x3 convolution");
  constexpr int AR = kDxRows / 64;  // A rows a thread copies
  constexpr int BR = kDxCols / 64;  // B rows a thread copies
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[4][kDxCols][2];
  long long rblk;
  int cblk;
  if (TAPS == 1) {
    const int cols = (k + kDxCols - 1) / kDxCols;
    rblk = blockIdx.x / cols;
    cblk = blockIdx.x % cols;
  } else {
    rblk = blockIdx.x;
    cblk = blockIdx.y;
  }
  const long long row0 = rblk * kDxRows;
  const int col0 = cblk * kDxCols;
  const int tid = threadIdx.x;
  const int cq = (tid & 3) * 8;
  const int r = tid >> 2;  // A rows r + 64 i; B rows r + 64 i
  long long p[AR];
  int ph[AR], pw[AR];
  bool ok[AR];
#pragma unroll
  for (int i = 0; i < AR; ++i) {
    p[i] = row0 + r + 64 * i;
    ok[i] = p[i] < m;
    int img;
    if (TAPS > 1) pixel_of(ok[i] ? p[i] : 0, h, wd, img, ph[i], pw[i]);
  }
  int tap = 0;
  int nb = 0;
  auto load = [&](unsigned char* st) {
    bf16* sa = reinterpret_cast<bf16*>(st);
    bf16* sb = sa + kDxRows * kRowH;
    const int dr = TAPS > 1 ? 1 - tap / 3 : 0;  // dy_eff at (row + dr,
    const int dc = TAPS > 1 ? 1 - tap % 3 : 0;  // col + dc)
    const long long shift = static_cast<long long>(dr) * wd + dc;
    const int n_left = n - nb - cq;
#pragma unroll
    for (int i = 0; i < AR; ++i) {
      bool in = ok[i];
      if (TAPS > 1) {
        const int hh = ph[i] + dr;
        const int ww = pw[i] + dc;
        in = in && hh >= 0 && hh < h && ww >= 0 && ww < wd;
      }
      apex::ring::copy8<VEC, (TAPS > 1)>(sa + (r + 64 * i) * kRowH + cq,
                                         dye + (p[i] + shift) * n + nb + cq,
                                         dye, in, n_left);
    }
#pragma unroll
    for (int i = 0; i < BR; ++i) {
      const int kr = col0 + r + 64 * i;
      apex::ring::copy8<VEC>(
          sb + (r + 64 * i) * kRowH + cq,
          w + (static_cast<long long>(tap) * k + kr) * n + nb + cq, w,
          kr < k, n_left);
    }
    nb += kSlice;
    if (nb >= n) {
      nb = 0;
      ++tap;
    }
  };
  const int warp = tid >> 5;
  const int wm = (warp & 3) * 16 * kDxMT;  // pixels
  const int wn = (warp >> 2) * 8 * kDxNT;  // K
  float acc[kDxMT][kDxNT][4] = {};
  auto step = [&](const unsigned char* st) {
    const bf16* sa = reinterpret_cast<const bf16*>(st);
    const bf16* sb = sa + kDxRows * kRowH;
#pragma unroll
    for (int kk = 0; kk < kSlice; kk += 16)
      apex::ring::warp_step<kDxMT, kDxNT, false, false>(
          sa + wm * kRowH, kRowH, sb + wn * kRowH, kRowH, kk, acc);
  };
  apex::ring::run_ring<kStages, kDxStage>(TAPS * slices_of(n), smem, load,
                                          step);

  // epilogue: Kernel K's (epilogue_dx) on this thread's fragment layout
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
  float s0[kDxNT][2] = {};
  float s1[kDxNT][2] = {};
  const bool pair = (k & 1) == 0 &&
                    ((reinterpret_cast<size_t>(x) |
                      reinterpret_cast<size_t>(dx)) & 3) == 0;
#pragma unroll
  for (int i = 0; i < kDxMT; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const long long row = row0 + wm + 16 * i + g + 8 * hf;
      if (row >= m) continue;
#pragma unroll
      for (int j = 0; j < kDxNT; ++j) {
        const int kc = col0 + wn + 8 * j + t2;
        if (kc >= k) continue;
        const long long idx = row * k + kc;
        const bool both = pair || kc + 1 < k;
        float xv[2] = {0.f, 0.f};
        if (AFFINE) {
          if (pair) {
            const __nv_bfloat162 x2 =
                *reinterpret_cast<const __nv_bfloat162*>(x + idx);
            xv[0] = __low2float(x2);
            xv[1] = __high2float(x2);
          } else {
            xv[0] = to_float(x[idx]);
            if (both) xv[1] = to_float(x[idx + 1]);
          }
        }
        float out[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          out[e] = acc[i][j][2 * hf + e];
          if (AFFINE && (e == 0 || both)) {
            const int kk = kc + e;
            const float pre = __fadd_rn(__fmul_rn(xv[e], a[kk]), b[kk]);
            const float dg = (RELU && !(pre > 0.f)) ? 0.f : out[e];
            out[e] = __fmul_rn(dg, a[kk]);
            s0[j][e] += dg * xv[e];
            s1[j][e] += dg;
          }
        }
        if (pair) {
          *reinterpret_cast<__nv_bfloat162*>(dx + idx) =
              __floats2bfloat162_rn(out[0], out[1]);
        } else {
          dx[idx] = __float2bfloat16(out[0]);
          if (both) dx[idx + 1] = __float2bfloat16(out[1]);
        }
      }
    }
  if (!AFFINE) return;
  // da/db partials: over the 8 row groups of the warp (lanes that share
  // lane % 4) by a fixed butterfly, then over the 4 warps of the tile's
  // rows in order: repeated runs are bitwise equal
#pragma unroll
  for (int j = 0; j < kDxNT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s0[j][e] += __shfl_xor_sync(0xffffffffu, s0[j][e], off);
        s1[j][e] += __shfl_xor_sync(0xffffffffu, s1[j][e], off);
      }
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < kDxNT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red[warp & 3][wn + 8 * j + t2 + e][0] = s0[j][e];
        red[warp & 3][wn + 8 * j + t2 + e][1] = s1[j][e];
      }
  }
  __syncthreads();
  if (tid < kDxCols && col0 + tid < k) {
    float t0 = 0.f;
    float t1 = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      t0 += red[q][tid][0];
      t1 += red[q][tid][1];
    }
    dab_partial[(rblk * 2) * k + col0 + tid] = t0;
    dab_partial[(rblk * 2 + 1) * k + col0 + tid] = t1;
  }
}

// The dx pass on stream: x and dx [m, k], w [TAPS, k, n], dy_eff [m, n]
// bf16; dab_partial [ceil(m / 128), 2, k] (affine only). A 3x3 takes the
// image's h and wd; a 1x1 ignores them.
template <int TAPS, bool AFFINE, bool RELU, bool VEC>
inline cudaError_t run_dx(const bf16* x, const float* a, const float* b,
                          const bf16* w, const bf16* dye, bf16* dx,
                          float* dab_partial, long long m, int h, int wd,
                          int k, int n, cudaStream_t stream) {
  const long long row_blocks = cdiv(m, kDxRows);
  const long long col_blocks = cdiv(k, kDxCols);
  const dim3 grid = TAPS == 1
      ? dim3(static_cast<unsigned>(row_blocks * col_blocks))
      : dim3(static_cast<unsigned>(row_blocks),
             static_cast<unsigned>(col_blocks));
  constexpr int smem = kStages * kDxStage;
  cudaError_t err =
      apex::allow_smem(dx_mma_kernel<TAPS, AFFINE, RELU, VEC>, smem);
  if (err != cudaSuccess) return err;
  dx_mma_kernel<TAPS, AFFINE, RELU, VEC><<<grid, kDxThreads, smem, stream>>>(
      x, a, b, w, dye, dx, dab_partial, m, h, wd, k, n);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the forward GEMM
// ---------------------------------------------------------------------------

constexpr int kFwdThreads = 256;
constexpr int kWarpTile = 32;  // each warp owns 32 x 32 of the tile

// A BM pixels x BN output channels block of 8 warps; a stage holds z [BM
// pixels][32 K] at the tap's shifted pixels and w[tap] [32 K][BN N'].
template <int BM, int BN>
struct FwdTile {
  static constexpr int kWarpsN = BN / kWarpTile;
  static constexpr int kWarpsM = kFwdThreads / 32 / kWarpsN;
  static_assert(kWarpsM * kWarpTile == BM, "8 warps of 32 x 32");
  static constexpr int kLdb = BN + 8;  // B stage rows: BN channels + pad
  static constexpr int kStage = (BM * kRowH + kSlice * kLdb) * 2;
  static constexpr int kLdy = BN + 8;  // staged y rows: BN channels + pad
  static_assert(BM * kLdy * 2 <= kStages * kStage, "y fits the ring");
};

// y [m, n] = z [m, k] (shifted by the tap) w [TAPS, k, n], rounded once to
// bf16, and the block's (y - c) sums as partial row rblk. STAGE_Y (J; VEC
// only, y 16-byte aligned): the block's y tile is first written to the
// ring's shared memory as bf16 pairs, then copied out as 16-byte rows, so
// that a warp stores whole 512-byte runs; else each thread stores its
// fragments' bf16 pairs (L).
template <int TAPS, int BM, int BN, bool VEC, bool STAGE_Y>
__global__ void __launch_bounds__(kFwdThreads)
fwd_mma_kernel(const bf16* __restrict__ z, const bf16* __restrict__ w,
               const float* __restrict__ c, bf16* __restrict__ y,
               float* __restrict__ partial, long long m, int h, int wd,
               int k, int n) {
  static_assert(TAPS == 1 || TAPS == 9, "a 1x1 or a 3x3 convolution");
  static_assert(VEC || !STAGE_Y, "16-byte rows need whole 8-channel groups");
  using T = FwdTile<BM, BN>;
  constexpr int AR = BM / 64;                 // A rows a thread copies
  constexpr int BCH = BN / 8;                 // 16-byte pieces of a B row
  constexpr int BSTEP = kFwdThreads / BCH;    // B rows between its copies
  constexpr int BR = kSlice / BSTEP;          // B rows a thread copies
  constexpr int MT = kWarpTile / 16;
  constexpr int NT = kWarpTile / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[T::kWarpsM][BN][2];
  long long rblk;
  int cblk;
  if (TAPS == 1) {
    const int cols = (n + BN - 1) / BN;
    rblk = blockIdx.x / cols;
    cblk = blockIdx.x % cols;
  } else {
    rblk = blockIdx.x;
    cblk = blockIdx.y;
  }
  const long long row0 = rblk * BM;
  const int col0 = cblk * BN;
  const int tid = threadIdx.x;
  // this thread copies A rows r + 64 i, channels cq..cq+7 of the slice, and
  // B rows rb + BSTEP i, output channels cb..cb+7 of the block
  const int cq = (tid & 3) * 8;
  const int r = tid >> 2;
  const int cb = (tid % BCH) * 8;
  const int rb = tid / BCH;
  long long p[AR];
  int ph[AR], pw[AR];
  bool ok[AR];
#pragma unroll
  for (int i = 0; i < AR; ++i) {
    p[i] = row0 + r + 64 * i;
    ok[i] = p[i] < m;
    int img;
    if (TAPS > 1) pixel_of(ok[i] ? p[i] : 0, h, wd, img, ph[i], pw[i]);
  }
  const int n_left = n - col0 - cb;
  int tap = 0;
  int kb = 0;
  auto load = [&](unsigned char* st) {
    bf16* sa = reinterpret_cast<bf16*>(st);
    bf16* sb = sa + BM * kRowH;
    const int dr = TAPS > 1 ? tap / 3 - 1 : 0;  // z is read at (row + dr,
    const int dc = TAPS > 1 ? tap % 3 - 1 : 0;  // column + dc)
    const long long shift = static_cast<long long>(dr) * wd + dc;
    const int k_left = k - kb - cq;
#pragma unroll
    for (int i = 0; i < AR; ++i) {
      bool in = ok[i];
      if (TAPS > 1) {
        const int hh = ph[i] + dr;
        const int ww = pw[i] + dc;
        in = in && hh >= 0 && hh < h && ww >= 0 && ww < wd;
      }
      apex::ring::copy8<VEC, (TAPS > 1)>(sa + (r + 64 * i) * kRowH + cq,
                                         z + (p[i] + shift) * k + kb + cq, z,
                                         in, k_left);
    }
#pragma unroll
    for (int i = 0; i < BR; ++i) {
      const int row = rb + BSTEP * i;
      const int kr = kb + row;
      apex::ring::copy8<VEC>(
          sb + row * T::kLdb + cb,
          w + (static_cast<long long>(tap) * k + kr) * n + col0 + cb, w,
          kr < k, n_left);
    }
    kb += kSlice;
    if (kb >= k) {
      kb = 0;
      ++tap;
    }
  };
  const int warp = tid >> 5;
  const int wm = (warp % T::kWarpsM) * kWarpTile;  // pixels
  const int wn = (warp / T::kWarpsM) * kWarpTile;  // output channels
  float acc[MT][NT][4] = {};
  auto step = [&](const unsigned char* st) {
    const bf16* sa = reinterpret_cast<const bf16*>(st);
    const bf16* sb = sa + BM * kRowH;
#pragma unroll
    for (int kk = 0; kk < kSlice; kk += 16)
      apex::ring::warp_step<MT, NT, false, true>(sa + wm * kRowH, kRowH,
                                                 sb + wn, T::kLdb, kk, acc);
  };
  apex::ring::run_ring<kStages, T::kStage>(TAPS * ((k + kSlice - 1) / kSlice),
                                           smem, load, step);
  // every warp is done with the ring before its stages take the y tile
  if (STAGE_Y) __syncthreads();

  // epilogue on this thread's fragments (mma_ring.cuh's layout): y rounded
  // once to bf16, and the (y - c) sums of its columns over its rows
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
  const bool pair = (n & 1) == 0 && (reinterpret_cast<size_t>(y) & 3) == 0;
  bf16* sy = reinterpret_cast<bf16*>(smem);
  float cv[NT][2];
  float s0[NT][2] = {};
  float s1[NT][2] = {};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int nc = col0 + wn + 8 * j + t2 + e;
      cv[j][e] = nc < n ? c[nc] : 0.f;
    }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const long long row = row0 + wm + 16 * i + g + 8 * hf;
      if (row >= m) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int nc = col0 + wn + 8 * j + t2;
        if (nc >= n) continue;
        const bool both = nc + 1 < n;
        const long long idx = row * n + nc;
        const float v0 = acc[i][j][2 * hf];
        const float v1 = acc[i][j][2 * hf + 1];
        if (STAGE_Y) {
          *reinterpret_cast<__nv_bfloat162*>(
              sy + (wm + 16 * i + g + 8 * hf) * T::kLdy + wn + 8 * j + t2) =
              __floats2bfloat162_rn(v0, v1);
        } else if (pair) {
          *reinterpret_cast<__nv_bfloat162*>(y + idx) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          y[idx] = __float2bfloat16(v0);
          if (both) y[idx + 1] = __float2bfloat16(v1);
        }
        const float d0 = v0 - cv[j][0];
        s0[j][0] += d0;
        s1[j][0] += d0 * d0;
        if (both) {
          const float d1 = v1 - cv[j][1];
          s0[j][1] += d1;
          s1[j][1] += d1 * d1;
        }
      }
    }
  // over the 8 row groups of the warp (lanes that share lane % 4) by a
  // fixed butterfly, then over the warps of the tile's rows in order:
  // repeated runs are bitwise equal
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s0[j][e] += __shfl_xor_sync(0xffffffffu, s0[j][e], off);
        s1[j][e] += __shfl_xor_sync(0xffffffffu, s1[j][e], off);
      }
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red[warp % T::kWarpsM][wn + 8 * j + t2 + e][0] = s0[j][e];
        red[warp % T::kWarpsM][wn + 8 * j + t2 + e][1] = s1[j][e];
      }
  }
  __syncthreads();
  if (tid < BN && col0 + tid < n) {
    float t0 = 0.f;
    float t1 = 0.f;
#pragma unroll
    for (int q = 0; q < T::kWarpsM; ++q) {
      t0 += red[q][tid][0];
      t1 += red[q][tid][1];
    }
    const long long slot = rblk;
    partial[(slot * 2) * n + col0 + tid] = t0;
    partial[(slot * 2 + 1) * n + col0 + tid] = t1;
  }
  if (STAGE_Y) {
    // the staged tile (written before the barrier above) as 16-byte rows:
    // consecutive threads take consecutive pieces of a row
    static_assert(BM * BCH % kFwdThreads == 0, "whole pieces a thread");
#pragma unroll
    for (int it = 0; it < BM * BCH / kFwdThreads; ++it) {
      const int e = tid + kFwdThreads * it;
      const int rr = e / BCH;
      const int q = (e % BCH) * 8;
      const long long row = row0 + rr;
      if (row < m && col0 + q < n)
        *reinterpret_cast<uint4*>(y + row * n + col0 + q) =
            *reinterpret_cast<const uint4*>(sy + rr * T::kLdy + q);
    }
  }
}

// The stats of the forward GEMM at one tap: its partial rows (one a row
// tile: 12,544 at ResNet-50's layer1 conv3) are summed in fixed-order
// chunks of kStatChunk rows, a block of 32 columns x 32 row groups each, into chunk
// rows that column_sum then adds: repeated runs are bitwise equal, and the
// first sum spreads over (chunks x columns / 32) blocks where column_sum
// alone would run columns / 32.
constexpr int kStatChunk = 512;

inline int stat_chunks(long long rows) {
  return static_cast<int>(cdiv(rows, kStatChunk));
}

// (a template, so that every source that includes this header may define
// it)
template <int CHUNK>
__global__ void __launch_bounds__(kReduceThreads)
chunk_column_sum_kernel(const float* __restrict__ part,
                        float* __restrict__ out, int rows, long long cols) {
  __shared__ float red[32][33];
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const long long col = static_cast<long long>(blockIdx.x) * 32 + tx;
  const int r0 = blockIdx.y * CHUNK;
  const int r1 = min(rows, r0 + CHUNK);
  float s = 0.f;
  if (col < cols) {
#pragma unroll 4
    for (int r = r0 + ty; r < r1; r += 32)
      s += part[static_cast<long long>(r) * cols + col];
  }
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && col < cols) {
    float t = 0.f;
    for (int g = 0; g < 32; ++g) t += red[g][tx];
    out[static_cast<long long>(blockIdx.y) * cols + col] = t;
  }
}

// out [cols] = the sum of part [rows, cols] in chunks: `chunk` [rows /
// kStatChunk rounded up, cols] holds the chunk sums
inline cudaError_t chunked_column_sum(const float* part, float* chunk,
                                      float* out, int rows, long long cols,
                                      cudaStream_t stream) {
  const int chunks = stat_chunks(rows);
  chunk_column_sum_kernel<kStatChunk>
      <<<dim3(static_cast<unsigned>(cdiv(cols, 32)),
              static_cast<unsigned>(chunks)),
         kReduceThreads, 0, stream>>>(part, chunk, rows, cols);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return column_sum(chunk, out, chunks, cols, stream);
}

// The forward GEMM on stream, then the stats' fixed-order sum: z [m, k], w
// [TAPS, k, n], y [m, n] bf16; partial [ceil(m / BM), 2, n] and stats [2,
// n] fp32. A 3x3 takes the image's h and wd; a 1x1 ignores them, and sums
// its partial rows in chunks (chunked_column_sum) into the [stat_chunks(
// ceil(m / BM)), 2, n] rows that follow them in `partial`.
template <int TAPS, int BM, int BN, bool VEC, bool STAGE_Y>
inline cudaError_t run_fwd(const bf16* z, const bf16* w, const float* c,
                           bf16* y, float* partial, float* stats, long long m,
                           int h, int wd, int k, int n, cudaStream_t stream) {
  const long long row_blocks = cdiv(m, BM);
  const long long col_blocks = cdiv(n, BN);
  const dim3 grid = TAPS == 1
      ? dim3(static_cast<unsigned>(row_blocks * col_blocks))
      : dim3(static_cast<unsigned>(row_blocks),
             static_cast<unsigned>(col_blocks));
  constexpr int smem = kStages * FwdTile<BM, BN>::kStage;
  cudaError_t err =
      apex::allow_smem(fwd_mma_kernel<TAPS, BM, BN, VEC, STAGE_Y>, smem);
  if (err != cudaSuccess) return err;
  fwd_mma_kernel<TAPS, BM, BN, VEC, STAGE_Y>
      <<<grid, kFwdThreads, smem, stream>>>(z, w, c, y, partial, m, h, wd, k,
                                            n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (TAPS == 1)
    return chunked_column_sum(partial, partial + row_blocks * 2 * n, stats,
                              static_cast<int>(row_blocks), 2LL * n, stream);
  return column_sum(partial, stats, static_cast<int>(row_blocks), 2LL * n,
                    stream);
}

// dW = the sum of its per-chunk partials [chunks, cols], each element's in
// chunk order: repeated runs are bitwise equal
constexpr int kSumThreads = 256;

template <int TAPS>
__global__ void __launch_bounds__(kSumThreads)
chunk_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                 int chunks, long long cols) {
  const long long col =
      static_cast<long long>(blockIdx.x) * kSumThreads + threadIdx.x;
  if (col >= cols) return;
  float s = 0.f;
#pragma unroll 8
  for (int r = 0; r < chunks; ++r) s += part[r * cols + col];
  out[col] = s;
}

// (TAPS names the kernel that runs it in a profile: 1 K, 9 M)
template <int TAPS>
inline cudaError_t chunk_sum(const float* part, float* out, int chunks,
                             long long cols, cudaStream_t stream) {
  chunk_sum_kernel<TAPS><<<static_cast<unsigned>(cdiv(cols, kSumThreads)),
                           kSumThreads, 0, stream>>>(part, out, chunks, cols);
  return cudaGetLastError();
}

}  // namespace conv
}  // namespace apex

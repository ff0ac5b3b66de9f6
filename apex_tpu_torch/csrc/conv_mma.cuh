// The passes that the fused convolution backwards' bf16 paths (Kernels K
// and M of the PyTorch port) share: the dx pass, dz = dy_eff w^T over the
// taps followed by the relu mask, dx = dg a and the da/db partials, on
// mma.sync m16n8k16 fed by the cp.async ring of mma_ring.cuh; and the
// fixed-order sum of per-chunk dW partials.
//
// The dx pass is a template over the tap count. TAPS = 9 is Kernel M's
// transposed 3x3 convolution: A is dy_eff at the tap's shifted pixel (rows
// outside the image copied as zeros, the nine taps' overlapping rows
// through L1) and B is w[tap] read as stored. TAPS = 1 is Kernel K's plain
// product dy_eff [m, N] w [K, N]^T: no shift, no halo, and the column
// blocks of one row block run next to each other (a 1D grid, columns
// fastest), so that its dy_eff rows come from memory once and then from L2.
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

// Fused 3x3 convolution backward (Kernel M of the PyTorch port).
//
// Replaces: apex_tpu/ops/conv_fused.py `_c3_bwd_kernel` (:446), launched by
// `_c3_bwd_pallas` (:511) through `pl.pallas_call` (:522).
//
// Semantics kept (:458-502): Kernel K's math over the nine taps. dy_eff =
// dy + ds0 + 2 (y - c) ds1 rounded to w's dtype; z recomputed and zero-padded
// in z-space; dW[dr, dc] = sum over pixels of z(pixel + (dr - 1, dc - 1))^T
// dy_eff(pixel) (fp32); dz = the transposed convolution of dy_eff, which is
// zero outside the image: dz(p) = sum over taps of dy_eff(p + (1 - dr,
// 1 - dc)) w[dr, dc]^T; then the relu mask, da, db and dx as in Kernel K.
//
// What does not carry over: the TPU kernel holds whole images, W and an fp32
// dW[3, 3] accumulator in VMEM across grid steps (its caller skips it at
// ResNet-50's layer1 and layer4 sizes). Blocks on the card run in parallel,
// so the sums over pixels become per-chunk partials reduced in a fixed
// order (no atomics: repeated runs are bitwise equal).
//
// bf16, the path ResNet-50 trains on (four passes):
// - pass 0, prep: one elementwise pass with 16-byte loads and stores writes
//   dy_eff [m, N] and, with the affine, z [m, K] to bf16 scratch, each
//   element formed once (conv_fused.cuh's dyc and zval: the rounding points
//   of the plain version; both passes are conv_prep.cuh's, which Kernels K
//   and L run too). Every operand of the two GEMMs is then a plain
//   bf16 tensor, and each operand row is copied 16 bytes at a time;
// - dW: blocks over (64 x 64 tile of [K, N], kernel row, chunk of pixels)
//   run dW[tap] = z_shifted^T dy_eff for the row's three taps over their
//   chunk in 32-pixel slices: one dy_eff tile serves the three, and the
//   three z tiles (rows one pixel apart) are copied through L1;
// - dx: blocks of 128 output pixels x 64 input channels run dz over (tap,
//   32 output channels) slices, A = dy_eff at the shifted pixel (rows
//   outside the image copied as zeros, the nine taps' overlapping rows
//   through L1) and B = w[tap] read as stored, then Kernel K's epilogue
//   (relu mask from x a + b, dx = dg a, da/db partials summed in a fixed
//   order; conv_mma.cuh's dx_mma_kernel, which Kernel K runs at one tap);
// - fixed-order sums of the dW partials (conv_mma.cuh's chunk_sum) and of
//   the da/db partials (conv_fused.cuh's column_sum).
// Both GEMMs run on mma.sync m16n8k16 fed by a 4-stage cp.async ring
// (mma_ring.cuh), one barrier a slice; shared-memory rows are padded so
// ldmatrix reads them without bank conflicts. Channel counts that are not
// multiples of 8 take the loaders' element-by-element edge in the same
// kernels. The dW chunks are sized in ops/conv_fused.py (m_dw_chunks) so
// that the blocks fill their last wave.
//
// f32 (checks only): the implicit GEMMs of conv_fused.cuh in fp32 FMAs,
// with z and dy_eff formed in their loaders.
//
// Bound on the H100 at layer1 ([256, 56, 56, 64] -> 64, bf16): bytes and
// operations about even, ~411 MB against 118 G FLOPs (~0.12 ms). The
// scratch adds ~0.5 GB of traffic by design: the prep pass runs near the
// memory rate (~0.17 ms). The two GEMMs run at ~150-220 TFLOP/s, far from
// the tensor cores' rate; inferred, not profiled (no ncu on the card's
// machine): what bounds them is operand traffic per product (L2 and L1 to
// shared memory, then ldmatrix for 32 x 32 warp tiles) and the fp32 add
// after every 16-deep mma.sync, which costs as many issue slots as the
// products. wgmma with TMA, and a longer promotion interval, are the next
// steps.
#include <algorithm>

#include "conv_fused.cuh"
#include "conv_mma.cuh"
#include "conv_prep.cuh"
#include "mma_ring.cuh"

namespace {

using namespace apex::conv;
using apex::to_float;
using apex::ring::bf16;

// ---------------------------------------------------------------------------
// f32: the fused loaders over fp32 FMAs
// ---------------------------------------------------------------------------

template <bool AFFINE, bool RELU>
__global__ void __launch_bounds__(kThreads)
conv3x3_dx_kernel(const float* __restrict__ x, const float* __restrict__ a,
                  const float* __restrict__ b, const float* __restrict__ w,
                  const float* __restrict__ c, const float* __restrict__ y,
                  const float* __restrict__ dy, const float* __restrict__ ds,
                  float* __restrict__ dx, float* __restrict__ dab_partial,
                  long long m, int h, int wd, int k, int n) {
  __shared__ Shared sm;
  const long long row0 = static_cast<long long>(blockIdx.x) * kBM;
  const int col0 = blockIdx.y * kBN;
  DyTaps<float> la(dy, y, c, ds, m, h, wd, n, row0);
  WTaps<float> lb(w, k, n, col0);
  float acc[4][4] = {};
  mainloop<true, true>(9 * n, la, lb, sm.g, acc);
  epilogue_dx<float, AFFINE, RELU>(acc, x, a, b, dx, dab_partial, m, k, row0,
                                   col0, sm);
}

template <bool AFFINE, bool RELU>
__global__ void __launch_bounds__(kThreads)
conv3x3_dw_kernel(const float* __restrict__ x, const float* __restrict__ a,
                  const float* __restrict__ b, const float* __restrict__ c,
                  const float* __restrict__ y, const float* __restrict__ dy,
                  const float* __restrict__ ds, float* __restrict__ dw_partial,
                  long long m, int h, int wd, int k, int n, int chunk_rows) {
  __shared__ Shared sm;
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  const int tap = blockIdx.z % 9;
  const int chunk = blockIdx.z / 9;
  const long long m_lo = static_cast<long long>(chunk) * chunk_rows;
  const int rows = static_cast<int>(min(static_cast<long long>(chunk_rows),
                                        m - m_lo));
  ZCols<float, AFFINE, RELU> la(x, a, b, h, wd, k, row0, m_lo, tap);
  DyCols<float> lb(dy, y, c, ds, n, col0, m_lo);
  float acc[4][4] = {};
  mainloop<false, false>(rows, la, lb, sm.g, acc);
  epilogue_dw(acc, dw_partial + static_cast<long long>(blockIdx.z) * k * n,
              k, n, row0, col0);
}

// ---------------------------------------------------------------------------
// bf16, the dW GEMM on the cp.async ring (prep, dx and the chunk sum:
// conv_prep.cuh, conv_mma.cuh)
// ---------------------------------------------------------------------------

constexpr int kTileH = 64 + 8;       // dW stage rows: 64 channels + pad

// dW: a 64 x 64 tile of dW[tap] ([K, N]) for kDwTaps taps of one kernel
// row (the same dy_eff rows), 4 warps of 32 x 32, slices of 32 pixels;
// each stage holds dy_eff [32 pixels][64 N] and, for each tap, z [32][64 K]
// at the tap's shifted pixels.
constexpr int kDwThreads = 128;
constexpr int kDwTaps = 3;
constexpr int kDwGroups = 9 / kDwTaps;
constexpr int kDwStage = (1 + kDwTaps) * kSlice * kTileH * 2;

template <bool VEC>
__global__ void __launch_bounds__(kDwThreads)
dw_mma_kernel(const bf16* __restrict__ z, const bf16* __restrict__ dye,
              float* __restrict__ dw_partial, long long m, int h, int wd,
              int k, int n, int chunk_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k0 = blockIdx.x * 64;
  const int n0 = blockIdx.y * 64;
  const int tap0 = (blockIdx.z % kDwGroups) * kDwTaps;
  const long long chunk = blockIdx.z / kDwGroups;
  const long long m_lo = chunk * chunk_rows;
  const long long m_hi = min(m, m_lo + chunk_rows);
  const int slices = slices_of(m_hi - m_lo);
  int dr[kDwTaps], dc[kDwTaps];  // z is read at (row + dr, column + dc)
  long long shift[kDwTaps];
#pragma unroll
  for (int t = 0; t < kDwTaps; ++t) {
    dr[t] = (tap0 + t) / 3 - 1;
    dc[t] = (tap0 + t) % 3 - 1;
    shift[t] = static_cast<long long>(dr[t]) * wd + dc[t];
  }
  // this thread copies rows r and r + 16 of each slice, channels cq..cq+7
  const int tid = threadIdx.x;
  const int cq = (tid & 7) * 8;
  const int r = tid >> 3;
  long long p[2];
  int ph[2], pw[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    p[i] = m_lo + r + 16 * i;
    int img;
    pixel_of(p[i] < m ? p[i] : 0, h, wd, img, ph[i], pw[i]);
  }
  const int k_left = k - k0 - cq;
  const int n_left = n - n0 - cq;
  auto load = [&](unsigned char* st) {
    bf16* sb = reinterpret_cast<bf16*>(st);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool in = p[i] < m_hi;
      const int row = r + 16 * i;
      apex::ring::copy8<VEC>(sb + row * kTileH + cq,
                             dye + p[i] * n + n0 + cq, dye, in, n_left);
#pragma unroll
      for (int t = 0; t < kDwTaps; ++t) {
        const int hh = ph[i] + dr[t];
        const int ww = pw[i] + dc[t];
        const bool zin = in && hh >= 0 && hh < h && ww >= 0 && ww < wd;
        apex::ring::copy8<VEC, true>(sb + ((1 + t) * kSlice + row) * kTileH + cq,
                               z + (p[i] + shift[t]) * k + k0 + cq, z, zin,
                               k_left);
      }
      p[i] += kSlice;
      pw[i] += kSlice;
      while (pw[i] >= wd) {
        pw[i] -= wd;
        if (++ph[i] == h) ph[i] = 0;
      }
    }
  };
  const int warp = tid >> 5;
  const int wm = (warp & 1) * 32;   // K
  const int wn = (warp >> 1) * 32;  // N
  float acc[kDwTaps][2][4][4] = {};
  auto step = [&](const unsigned char* st) {
    const bf16* sb = reinterpret_cast<const bf16*>(st);
#pragma unroll
    for (int kk = 0; kk < kSlice; kk += 16) {
      unsigned fb[2][4];
      apex::ring::load_b<4, true>(fb, sb + wn, kTileH, kk);
#pragma unroll
      for (int t = 0; t < kDwTaps; ++t) {
        unsigned fa[2][4];
        apex::ring::load_a<2, true>(fa, sb + (1 + t) * kSlice * kTileH + wm,
                                    kTileH, kk);
        apex::ring::mma_tile<2, 4>(acc[t], fa, fb);
      }
    }
  };
  apex::ring::run_ring<kStages, kDwStage>(slices, smem, load, step);

  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
#pragma unroll
  for (int t = 0; t < kDwTaps; ++t) {
    float* out = dw_partial + (chunk * 9 + tap0 + t) * k * n;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kr = k0 + wm + 16 * i + g + 8 * (e >> 1);
          const int nc = n0 + wn + 8 * j + t2 + (e & 1);
          if (kr < k && nc < n)
            out[static_cast<long long>(kr) * n + nc] = acc[t][i][j][e];
        }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void* x;
  const float* a;
  const float* b;
  const void* w;
  const float* c;
  const void* y;
  const void* dy;
  const float* ds;
  void* dx;
  float* dw_partial;   // [chunks, 9, k, n] fp32 scratch
  float* dw;           // [3, 3, k, n] fp32
  float* dab_partial;  // [row blocks, 2, k] (affine only)
  float* dab;          // [2, k]: da, db (affine only)
  void* dy_eff;        // [images h w, n] bf16 scratch (bf16 only)
  void* z;             // [images h w, k] bf16 scratch (bf16 with the affine)
  int images, h, wd, k, n, chunk_rows;
};

template <bool AFFINE, bool RELU, bool VEC>
cudaError_t run_bf16(const Args& p, long long m, cudaStream_t stream) {
  const bf16* x = static_cast<const bf16*>(p.x);
  bf16* dye = static_cast<bf16*>(p.dy_eff);
  cudaError_t err = prep_dy<KernelM, VEC>(
      static_cast<const bf16*>(p.dy), static_cast<const bf16*>(p.y), p.c,
      p.ds, dye, m, p.n, stream);
  if (err != cudaSuccess) return err;
  const bf16* z = x;
  if (AFFINE) {
    bf16* zs = static_cast<bf16*>(p.z);
    err = prep_z<KernelM, RELU, VEC>(x, p.a, p.b, zs, m, p.k, stream);
    if (err != cudaSuccess) return err;
    z = zs;
  }
  const int chunks = static_cast<int>(cdiv(m, p.chunk_rows));
  const dim3 grid_dw(static_cast<unsigned>(cdiv(p.k, 64)),
                     static_cast<unsigned>(cdiv(p.n, 64)),
                     static_cast<unsigned>(kDwGroups * chunks));
  constexpr int dw_smem = kStages * kDwStage;
  err = apex::allow_smem(dw_mma_kernel<VEC>, dw_smem);
  if (err != cudaSuccess) return err;
  dw_mma_kernel<VEC><<<grid_dw, kDwThreads, dw_smem, stream>>>(
      z, dye, p.dw_partial, m, p.h, p.wd, p.k, p.n, p.chunk_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = run_dx<9, AFFINE, RELU, VEC>(
      x, p.a, p.b, static_cast<const bf16*>(p.w), dye,
      static_cast<bf16*>(p.dx), p.dab_partial, m, p.h, p.wd, p.k, p.n,
      stream);
  if (err != cudaSuccess) return err;
  err = chunk_sum<9>(p.dw_partial, p.dw, chunks, 9LL * p.k * p.n, stream);
  if (err != cudaSuccess || !AFFINE) return err;
  const int row_blocks = static_cast<int>(cdiv(m, kDxRows));
  return column_sum(p.dab_partial, p.dab, row_blocks, 2LL * p.k, stream);
}

template <bool AFFINE, bool RELU>
cudaError_t run_f32(const Args& p, long long m, cudaStream_t stream) {
  const float* x = static_cast<const float*>(p.x);
  const float* y = static_cast<const float*>(p.y);
  const float* dy = static_cast<const float*>(p.dy);
  const int row_blocks = static_cast<int>(cdiv(m, kBM));
  const dim3 grid_dx(static_cast<unsigned>(row_blocks),
                     static_cast<unsigned>(cdiv(p.k, kBN)));
  conv3x3_dx_kernel<AFFINE, RELU><<<grid_dx, kThreads, 0, stream>>>(
      x, p.a, p.b, static_cast<const float*>(p.w), p.c, y, dy, p.ds,
      static_cast<float*>(p.dx), p.dab_partial, m, p.h, p.wd, p.k, p.n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int chunks = static_cast<int>(cdiv(m, p.chunk_rows));
  const dim3 grid_dw(static_cast<unsigned>(cdiv(p.k, kBM)),
                     static_cast<unsigned>(cdiv(p.n, kBN)),
                     static_cast<unsigned>(9 * chunks));
  conv3x3_dw_kernel<AFFINE, RELU><<<grid_dw, kThreads, 0, stream>>>(
      x, p.a, p.b, p.c, y, dy, p.ds, p.dw_partial, m, p.h, p.wd, p.k, p.n,
      p.chunk_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = column_sum(p.dw_partial, p.dw, chunks, 9LL * p.k * p.n, stream);
  if (err != cudaSuccess || !AFFINE) return err;
  return column_sum(p.dab_partial, p.dab, row_blocks, 2LL * p.k, stream);
}

template <typename T, bool AFFINE, bool RELU>
struct Launch {
  static cudaError_t run(const Args& p, cudaStream_t stream) {
    const long long m = static_cast<long long>(p.images) * p.h * p.wd;
    if constexpr (std::is_same<T, float>::value) {
      return run_f32<AFFINE, RELU>(p, m, stream);
    } else {
      // the 16-byte copies need whole 8-channel groups and aligned rows
      // and per-channel vectors
      const bool vec = p.k % 8 == 0 && p.n % 8 == 0 && aligned16(p.x) &&
                       aligned16(p.w) && aligned16(p.y) &&
                       aligned16(p.dy) && aligned16(p.dy_eff) &&
                       aligned16(p.c) && aligned16(p.ds) &&
                       (!AFFINE || (aligned16(p.z) && aligned16(p.a) &&
                                    aligned16(p.b)));
      return vec ? run_bf16<AFFINE, RELU, true>(p, m, stream)
                 : run_bf16<AFFINE, RELU, false>(p, m, stream);
    }
  }
};

}  // namespace

// x and dx [images, h, w, k], w [3, 3, k, n], y and dy [images, h, w, n] of
// one dtype; c [n] and ds [2, n] fp32; a, b, dab_partial and dab null
// without the affine. The caller sizes the scratch (ops/conv_fused.py
// `conv3x3_bwd_scratch`): dw_partial [ceil(images h w / chunk_rows), 9, k,
// n] with at most 7281 chunks; dab_partial [ceil(images h w / rows), 2, k]
// with rows 128 in bf16 and 64 in f32; in bf16 dy_eff [images h w, n] and,
// with the affine, z [images h w, k] (both null in f32). All sizes > 0,
// tensors contiguous.
extern "C" int apex_conv3x3_bwd(const void* x, const void* a, const void* b,
                                const void* w, const void* c, const void* y,
                                const void* dy, const void* ds, void* dx,
                                void* dw_partial, void* dw, void* dab_partial,
                                void* dab, void* dy_eff, void* z,
                                void* stream, int images, int h, int wd,
                                int k, int n, int chunk_rows, int affine,
                                int relu, int dtype) {
  const Args p{x, static_cast<const float*>(a), static_cast<const float*>(b),
               w, static_cast<const float*>(c), y, dy,
               static_cast<const float*>(ds), dx,
               static_cast<float*>(dw_partial), static_cast<float*>(dw),
               static_cast<float*>(dab_partial), static_cast<float*>(dab),
               dy_eff, z, images, h, wd, k, n, chunk_rows};
  return static_cast<int>(apex::conv::dispatch<Launch>(
      p, dtype, affine, relu, static_cast<cudaStream_t>(stream)));
}

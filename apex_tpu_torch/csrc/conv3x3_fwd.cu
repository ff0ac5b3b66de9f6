// Fused 3x3 convolution forward (Kernel L of the PyTorch port).
//
// Replaces: apex_tpu/ops/conv_fused.py `_c3_fwd_kernel` (:356), launched by
// `_c3_fwd_pallas` (:412) through `pl.pallas_call` (:422).
//
// Semantics kept: x [N, H, W, K] and w [3, 3, K, N'] of one dtype; z =
// relu?(x * a + b) in fp32 rounded to w's dtype (or z = x), zero-padded by
// one pixel AFTER the affine (the halo is zero in z-space: padding x and
// then applying the affine would give relu(b) there, :351-353, :375);
// y = the stride-1 SAME convolution of z, nine shifted products accumulated
// in fp32, rounded once to x's dtype; stats [2, N'] = (sum(y - c),
// sum((y - c)^2)) over N H W from the fp32 y.
//
// What does not carry over: the TPU kernel holds whole images and the
// weights in VMEM, so its caller skips it for H W > 1024 or 54 K N' > 8 MiB
// (ResNet-50's layer1 and layer4); here every shape launches the kernel.
// The stats are per-tile partials reduced in a fixed order (no atomics:
// repeated runs are bitwise equal).
//
// Bound on the H100 at layer1 (x [256, 56, 56, 64] bf16 -> 64): bytes and
// operations about even, ~206 MB against 59 G FLOPs (~0.06 ms).
//
// bf16, the path ResNet-50 trains on (three passes):
// - prep (with the affine; conv_prep.cuh, shared with Kernel M): one
//   elementwise pass with 16-byte loads and stores writes z [m, K] to bf16
//   scratch, each element formed once (conv_fused.cuh's zval: the rounding
//   points of the plain version). Without the affine z is x, and no pass
//   runs;
// - the implicit GEMM: blocks of 128 output pixels x 64 output channels
//   (64 x 128 where N' >= 128, so that one z tile feeds more columns), 8
//   warps of 32 x 32, run y over (tap, 32 input channels) slices on
//   mma.sync m16n8k16 fed by a 4-stage cp.async ring (mma_ring.cuh), one
//   barrier a slice. A is z at the tap's shifted pixel, 16 bytes a copy
//   through L1 (the nine taps re-read neighbouring rows); rows outside the
//   image are zero-filled by a source size of 0, which is exactly the
//   halo that is zero in z-space. B is w[tap] [32 K][64 or 128 N'] as stored,
//   read by ldmatrix.trans. Shared-memory rows are padded so that ldmatrix
//   reads them without bank conflicts. Each 16-deep product is added into
//   fp32 registers. The epilogue works on the fragments: y as bf16 pairs,
//   the (y - c) sums per thread, then over the lanes of a column by a fixed
//   butterfly, then over the block's row-warps in order, one partial row
//   per pixel tile;
// - column_sum (conv_fused.cuh) reduces the partial rows in a fixed order.
// Channel counts that are not multiples of 8 take the copies'
// element-by-element edge in the same kernels.
//
// What bounds it now: inferred, not profiled (no ncu on the card's
// machine). The prep pass moves ~206 MB at layer1 at about the memory
// rate; the GEMM, like Kernel M's dx pass of the same shape, is bound by
// operand traffic into shared memory and ldmatrix for 32 x 32 warp tiles,
// and by the fp32 add after every 16-deep mma.sync. wgmma with TMA, a
// halo'd pixel tile held in shared memory, and handing z to Kernel M are
// the next steps.
//
// f32 (checks only): the implicit GEMM of conv_fused.cuh in fp32 FMAs, z
// formed in its loader: each thread keeps its four output pixels as
// (image, row, column) and walks the contraction as (tap, channel).
#include "conv_fused.cuh"
#include "conv_prep.cuh"
#include "mma_ring.cuh"

namespace {

using namespace apex::conv;
using apex::ring::bf16;

// ---------------------------------------------------------------------------
// f32: the fused loader over fp32 FMAs
// ---------------------------------------------------------------------------

template <bool AFFINE, bool RELU>
__global__ void __launch_bounds__(kThreads)
conv3x3_fwd_kernel(const float* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ b, const float* __restrict__ w,
                   const float* __restrict__ c, float* __restrict__ y,
                   float* __restrict__ partial, long long m, int h, int wd,
                   int k, int n) {
  __shared__ Shared sm;
  const long long row0 = static_cast<long long>(blockIdx.x) * kBM;
  const int col0 = blockIdx.y * kBN;
  ZTaps<float, AFFINE, RELU> la(x, a, b, m, h, wd, k, row0);
  WRows<float> lb(w, n, col0);
  float acc[4][4] = {};
  mainloop<float, true, false>(9 * k, la, lb, sm, acc);
  epilogue_fwd<float>(acc, y, c, partial, m, n, row0, col0, sm);
}

// ---------------------------------------------------------------------------
// bf16: the implicit GEMM over z on the cp.async ring
// ---------------------------------------------------------------------------

constexpr int kStages = 4;
constexpr int kSlice = 32;         // contraction depth of one slice
constexpr int kRowH = kSlice + 8;  // A stage rows: 32 channels + pad
constexpr int kGemmThreads = 256;
constexpr int kWarpTile = 32;      // each warp owns 32 x 32 of the tile

// A BM pixels x BN output channels block of 8 warps; a stage holds z [BM
// pixels][32 K] at the tap's shifted pixels and w[tap] [32 K][BN N'].
template <int BM, int BN>
struct Tile {
  static constexpr int kWarpsN = BN / kWarpTile;
  static constexpr int kWarpsM = kGemmThreads / 32 / kWarpsN;
  static_assert(kWarpsM * kWarpTile == BM, "8 warps of 32 x 32");
  static constexpr int kLdb = BN + 8;  // B stage rows: BN channels + pad
  static constexpr int kStage = (BM * kRowH + kSlice * kLdb) * 2;
};

template <int BM, int BN, bool VEC>
__global__ void __launch_bounds__(kGemmThreads)
fwd_mma_kernel(const bf16* __restrict__ z, const bf16* __restrict__ w,
               const float* __restrict__ c, bf16* __restrict__ y,
               float* __restrict__ partial, long long m, int h, int wd,
               int k, int n) {
  using T = Tile<BM, BN>;
  constexpr int AR = BM / 64;                 // A rows a thread copies
  constexpr int BCH = BN / 8;                 // 16-byte pieces of a B row
  constexpr int BSTEP = kGemmThreads / BCH;   // B rows between its copies
  constexpr int BR = kSlice / BSTEP;          // B rows a thread copies
  constexpr int MT = kWarpTile / 16;
  constexpr int NT = kWarpTile / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[T::kWarpsM][BN][2];
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const int col0 = blockIdx.y * BN;
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
    pixel_of(ok[i] ? p[i] : 0, h, wd, img, ph[i], pw[i]);
  }
  const int n_left = n - col0 - cb;
  int tap = 0;
  int kb = 0;
  auto load = [&](unsigned char* st) {
    bf16* sa = reinterpret_cast<bf16*>(st);
    bf16* sb = sa + BM * kRowH;
    const int dr = tap / 3 - 1;  // z is read at (row + dr, column + dc)
    const int dc = tap % 3 - 1;
    const long long shift = static_cast<long long>(dr) * wd + dc;
    const int k_left = k - kb - cq;
#pragma unroll
    for (int i = 0; i < AR; ++i) {
      const int hh = ph[i] + dr;
      const int ww = pw[i] + dc;
      const bool in = ok[i] && hh >= 0 && hh < h && ww >= 0 && ww < wd;
      apex::ring::copy8<VEC, true>(sa + (r + 64 * i) * kRowH + cq,
                                   z + (p[i] + shift) * k + kb + cq, z, in,
                                   k_left);
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
  apex::ring::run_ring<kStages, T::kStage>(9 * ((k + kSlice - 1) / kSlice),
                                           smem, load, step);

  // epilogue on this thread's fragments (mma_ring.cuh's layout): y rounded
  // once to bf16, and the (y - c) sums of its columns over its rows
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
  const bool pair = (n & 1) == 0 && (reinterpret_cast<size_t>(y) & 3) == 0;
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
        if (pair) {
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
    const long long slot = blockIdx.x;
    partial[(slot * 2) * n + col0 + tid] = t0;
    partial[(slot * 2 + 1) * n + col0 + tid] = t1;
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
  void* y;
  float* partial;  // [ceil(images h w / rows), 2, n] fp32 scratch
  float* stats;    // [2, n]
  void* z;         // [images h w, k] bf16 scratch (bf16 with the affine)
  int images, h, wd, k, n;
};

template <int BM, int BN, bool VEC>
cudaError_t run_gemm(const Args& p, const bf16* z, long long m,
                     cudaStream_t stream) {
  const int row_blocks = static_cast<int>(cdiv(m, BM));
  const dim3 grid(static_cast<unsigned>(row_blocks),
                  static_cast<unsigned>(cdiv(p.n, BN)));
  constexpr int smem = kStages * Tile<BM, BN>::kStage;
  cudaError_t err = apex::allow_smem(fwd_mma_kernel<BM, BN, VEC>, smem);
  if (err != cudaSuccess) return err;
  fwd_mma_kernel<BM, BN, VEC><<<grid, kGemmThreads, smem, stream>>>(
      z, static_cast<const bf16*>(p.w), p.c, static_cast<bf16*>(p.y),
      p.partial, m, p.h, p.wd, p.k, p.n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return column_sum(p.partial, p.stats, row_blocks, 2LL * p.n, stream);
}

template <bool AFFINE, bool RELU, bool VEC>
cudaError_t run_bf16(const Args& p, long long m, cudaStream_t stream) {
  const bf16* z = static_cast<const bf16*>(p.x);
  if constexpr (AFFINE) {
    bf16* zs = static_cast<bf16*>(p.z);
    const cudaError_t err =
        prep_z<KernelL, RELU, VEC>(z, p.a, p.b, zs, m, p.k, stream);
    if (err != cudaSuccess) return err;
    z = zs;
  }
  // 128 pixels x 64 channels a block, or 64 x 128 where N' >= 128 (one z
  // tile then feeds twice the columns; ops/conv_fused.py `_l_rows`)
  return p.n >= 128 ? run_gemm<64, 128, VEC>(p, z, m, stream)
                    : run_gemm<128, 64, VEC>(p, z, m, stream);
}

template <bool AFFINE, bool RELU>
cudaError_t run_f32(const Args& p, long long m, cudaStream_t stream) {
  const int row_blocks = static_cast<int>(cdiv(m, kBM));
  const dim3 grid(static_cast<unsigned>(row_blocks),
                  static_cast<unsigned>(cdiv(p.n, kBN)));
  conv3x3_fwd_kernel<AFFINE, RELU><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(p.x), p.a, p.b,
      static_cast<const float*>(p.w), p.c, static_cast<float*>(p.y),
      p.partial, m, p.h, p.wd, p.k, p.n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return column_sum(p.partial, p.stats, row_blocks, 2LL * p.n, stream);
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
                       aligned16(p.w) &&
                       (!AFFINE || (aligned16(p.z) && aligned16(p.a) &&
                                    aligned16(p.b)));
      return vec ? run_bf16<AFFINE, RELU, true>(p, m, stream)
                 : run_bf16<AFFINE, RELU, false>(p, m, stream);
    }
  }
};

}  // namespace

// x [images, h, w, k], w [3, 3, k, n]; a and b null without the affine.
// The caller sizes the scratch (ops/conv_fused.py `conv3x3_fwd_scratch`):
// `partial` [ceil(images h w / rows), 2, n] fp32 with rows 64 in f32 and,
// in bf16, 128 (64 where n >= 128); in bf16 with the affine z [images h w,
// k] (else null). All
// sizes > 0, all tensors contiguous.
extern "C" int apex_conv3x3_fwd(const void* x, const void* a, const void* b,
                                const void* w, const void* c, void* y,
                                void* partial, void* stats, void* z,
                                void* stream, int images, int h, int wd,
                                int k, int n, int affine, int relu,
                                int dtype) {
  const Args p{x, static_cast<const float*>(a), static_cast<const float*>(b),
               w, static_cast<const float*>(c), y,
               static_cast<float*>(partial), static_cast<float*>(stats), z,
               images, h, wd, k, n};
  return static_cast<int>(apex::conv::dispatch<Launch>(
      p, dtype, affine, relu, static_cast<cudaStream_t>(stream)));
}

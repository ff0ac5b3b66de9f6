// Fused 1x1 convolution backward (Kernel K of the PyTorch port).
//
// Replaces: apex_tpu/ops/conv_fused.py `_bwd_kernel` (:136), launched by
// `_bwd_pallas` (:189) through `pl.pallas_call` (:204).
//
// Semantics kept (:148-180): dy_eff = dy + ds0 + 2 (y - c) ds1 in fp32 (the
// statistics cotangent folded in), rounded to w's dtype; z recomputed from x
// as the forward forms it; dW = z^T dy_eff (fp32); dz = dy_eff w^T (fp32);
// with the affine, pre = x * a + b, dg = dz where pre > 0 (relu) else 0,
// da = sum(dg x), db = sum(dg) (fp32) and dx = dg a; without it dx = dz.
// dx is rounded once to x's dtype.
//
// What does not carry over: the TPU kernel is one pass that adds each grid
// step's dW, da and db into VMEM accumulators, relying on the grid running
// in order, and keeps W and the fp32 dW resident (its caller skips it above
// ~1.5M weight elements). Blocks on the card run in parallel, so the sums
// over rows become per-chunk partials reduced in a fixed order (no atomics:
// repeated runs are bitwise equal).
//
// bf16, the path ResNet-50 trains on (Kernel M's passes at one tap):
// - prep (conv_prep.cuh, shared with L and M): one elementwise pass with
//   16-byte loads and stores writes dy_eff [m, N] to bf16 scratch and, with
//   the affine, a second one z [m, K], each element formed once with the
//   rounding points of the plain version. Without the affine z is x, and no
//   z pass runs;
// - dW: blocks over (BK x BN tile of [K, N], chunk of rows) run z^T dy_eff
//   over their chunk in 32-row slices, 64 x 32 a warp; BK and BN are 128
//   where K and N allow (one operand tile then feeds twice the products),
//   else 64. The chunks are sized in ops/conv_fused.py (k_dw_chunks) so
//   that the blocks fill their last wave of resident blocks;
// - dx: conv_mma.cuh's dx pass at one tap (128 rows x 64 input channels a
//   block, A = dy_eff rows, B = w read as stored), with the relu mask, dx =
//   dg a and the da/db partials in its epilogue;
// - fixed-order sums of the dW partials (conv_mma.cuh's chunk_sum) and of
//   the da/db partials (conv_fused.cuh's column_sum).
// Both GEMMs run on mma.sync m16n8k16 fed by a 4-stage cp.async ring
// (mma_ring.cuh), one barrier a slice, each 16-deep product added into fp32
// registers; shared-memory rows are padded so that ldmatrix reads them
// without bank conflicts. Channel counts that are not multiples of 8 take
// the copies' element-by-element edge in the same kernels.
//
// Bound on the H100 at ResNet-50's layer1 conv3 shape (x [802816, 64],
// y and dy [802816, 256] bf16, affine + relu): bytes, ~1.03 GB read and
// written against 53 G FLOPs (~0.31 ms at 3.35 TB/s). The scratch adds
// ~1.1 GB of traffic there by design (dy_eff written once and read by both
// GEMMs, z the same), so the prep and the GEMMs' operand reads, not the
// products, set the pace at layer1; at layer4 (K, N up to 2048 over 12,544
// rows) the products do.
//
// f32 (checks only): the implicit GEMMs of conv_fused.cuh in fp32 FMAs,
// with z and dy_eff formed in their loaders.
#include "conv_fused.cuh"
#include "conv_mma.cuh"
#include "conv_prep.cuh"
#include "mma_ring.cuh"

namespace {

using namespace apex::conv;

// ---------------------------------------------------------------------------
// f32: the fused loaders over fp32 FMAs
// ---------------------------------------------------------------------------

template <bool AFFINE, bool RELU>
__global__ void __launch_bounds__(kThreads)
conv1x1_dx_kernel(const float* __restrict__ x, const float* __restrict__ a,
                  const float* __restrict__ b, const float* __restrict__ w,
                  const float* __restrict__ c, const float* __restrict__ y,
                  const float* __restrict__ dy, const float* __restrict__ ds,
                  float* __restrict__ dx, float* __restrict__ dab_partial,
                  int m, int k, int n) {
  __shared__ Shared sm;
  const long long row0 = static_cast<long long>(blockIdx.x) * kBM;
  const int col0 = blockIdx.y * kBN;
  DyRows<float> la(dy, y, c, ds, m, n, row0);
  WTaps<float> lb(w, k, n, col0);
  float acc[4][4] = {};
  mainloop<true, true>(n, la, lb, sm.g, acc);
  epilogue_dx<float, AFFINE, RELU>(acc, x, a, b, dx, dab_partial, m, k, row0,
                                   col0, sm);
}

template <bool AFFINE, bool RELU>
__global__ void __launch_bounds__(kThreads)
conv1x1_dw_kernel(const float* __restrict__ x, const float* __restrict__ a,
                  const float* __restrict__ b, const float* __restrict__ c,
                  const float* __restrict__ y, const float* __restrict__ dy,
                  const float* __restrict__ ds,
                  float* __restrict__ dw_partial, int m, int k, int n,
                  int chunk_rows) {
  __shared__ Shared sm;
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  const long long m_lo = static_cast<long long>(blockIdx.z) * chunk_rows;
  const int rows = static_cast<int>(min(static_cast<long long>(chunk_rows),
                                        m - m_lo));
  // a 1x1 is the 3x3 loader's centre tap over a 1 x m "image"
  ZCols<float, AFFINE, RELU> la(x, a, b, 1, m, k, row0, m_lo, 4);
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

// A BK x BN tile of dW [K, N] over a chunk of rows: warps of 64 K x 32 N,
// BK BN / 64 threads; a stage holds z [32 rows][BK] and dy_eff [32
// rows][BN], both read contraction-major by ldmatrix.trans. The launch
// bounds ask for 2 blocks an SM of 128 x 128, 6 of 64 x 64 and 4 of the
// others (what the shared memory of 4 stages allows; registers are capped
// to match): ops/conv_fused.py `_K_DW_RESIDENT` sizes the chunks by it.
template <int BK, int BN>
struct DwTile {
  static constexpr int kWarpK = 64;
  static constexpr int kWarpN = 32;
  static constexpr int kWarpsK = BK / kWarpK;
  static constexpr int kThreads = BK * BN / 64;  // 32 a warp
  static constexpr int kLdz = BK + 8;
  static constexpr int kLdd = BN + 8;
  static constexpr int kStage = kSlice * (kLdz + kLdd) * 2;
};

template <int BK, int BN, bool VEC>
__global__ void __launch_bounds__(BK * BN / 64,
                                  BK + BN == 256 ? 2 : BK + BN == 128 ? 6 : 4)
k_dw_mma_kernel(const bf16* __restrict__ z, const bf16* __restrict__ dye,
                float* __restrict__ dw_partial, long long m, int k, int n,
                int chunk_rows) {
  using T = DwTile<BK, BN>;
  constexpr int ZG = BK / 8;                 // 16-byte pieces of a z row
  constexpr int DG = BN / 8;                 // ... of a dy_eff row
  constexpr int ZR = kSlice * ZG / T::kThreads;  // z rows a thread copies
  constexpr int DR = kSlice * DG / T::kThreads;  // dy_eff rows ...
  constexpr int MT = T::kWarpK / 16;
  constexpr int NT = T::kWarpN / 8;
  static_assert(ZR * T::kThreads == kSlice * ZG &&
                DR * T::kThreads == kSlice * DG, "whole rows a thread");
  extern __shared__ __align__(16) unsigned char smem[];
  const int k0 = blockIdx.x * BK;
  const int n0 = blockIdx.y * BN;
  const long long chunk = blockIdx.z;
  const long long m_lo = chunk * chunk_rows;
  const long long m_hi = min(m, m_lo + chunk_rows);
  const int tid = threadIdx.x;
  // this thread copies z rows rz + (32 / ZR) i, channels cz..cz+7 of the
  // tile, and dy_eff rows rd + (32 / DR) i, channels cd..cd+7
  const int cz = (tid % ZG) * 8;
  const int rz = tid / ZG;
  const int cd = (tid % DG) * 8;
  const int rd = tid / DG;
  long long pz = m_lo + rz;
  long long pd = m_lo + rd;
  const int k_left = k - k0 - cz;
  const int n_left = n - n0 - cd;
  auto load = [&](unsigned char* st) {
    bf16* sz = reinterpret_cast<bf16*>(st);
    bf16* sd = sz + kSlice * T::kLdz;
#pragma unroll
    for (int i = 0; i < ZR; ++i) {
      const int row = rz + (kSlice / ZR) * i;
      const long long p = pz + (kSlice / ZR) * i;
      apex::ring::copy8<VEC>(sz + row * T::kLdz + cz, z + p * k + k0 + cz, z,
                             p < m_hi, k_left);
    }
#pragma unroll
    for (int i = 0; i < DR; ++i) {
      const int row = rd + (kSlice / DR) * i;
      const long long p = pd + (kSlice / DR) * i;
      apex::ring::copy8<VEC>(sd + row * T::kLdd + cd, dye + p * n + n0 + cd,
                             dye, p < m_hi, n_left);
    }
    pz += kSlice;
    pd += kSlice;
  };
  const int warp = tid >> 5;
  const int wk = (warp % T::kWarpsK) * T::kWarpK;
  const int wn = (warp / T::kWarpsK) * T::kWarpN;
  float acc[MT][NT][4] = {};
  auto step = [&](const unsigned char* st) {
    const bf16* sz = reinterpret_cast<const bf16*>(st);
    const bf16* sd = sz + kSlice * T::kLdz;
#pragma unroll
    for (int kk = 0; kk < kSlice; kk += 16)
      apex::ring::warp_step<MT, NT, true, true>(sz + wk, T::kLdz, sd + wn,
                                                T::kLdd, kk, acc);
  };
  apex::ring::run_ring<kStages, T::kStage>(slices_of(m_hi - m_lo), smem,
                                           load, step);

  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
  float* out = dw_partial + chunk * k * n;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kr = k0 + wk + 16 * i + g + 8 * (e >> 1);
        const int nc = n0 + wn + 8 * j + t2 + (e & 1);
        if (kr < k && nc < n)
          out[static_cast<long long>(kr) * n + nc] = acc[i][j][e];
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
  float* dw_partial;   // [ceil(m / chunk_rows), k, n] fp32 scratch
  float* dw;           // [k, n] fp32
  float* dab_partial;  // [ceil(m / rows), 2, k] fp32 scratch (affine only)
  float* dab;          // [2, k] fp32: da, db (affine only)
  void* dy_eff;        // [m, n] bf16 scratch (bf16 only)
  void* z;             // [m, k] bf16 scratch (bf16 with the affine)
  int m, k, n, chunk_rows;
};

template <int BK, int BN, bool VEC>
cudaError_t run_dw(const bf16* z, const bf16* dye, const Args& p,
                   int chunks, cudaStream_t stream) {
  using T = DwTile<BK, BN>;
  const dim3 grid(static_cast<unsigned>(cdiv(p.k, BK)),
                  static_cast<unsigned>(cdiv(p.n, BN)),
                  static_cast<unsigned>(chunks));
  constexpr int smem = kStages * T::kStage;
  cudaError_t err = apex::allow_smem(k_dw_mma_kernel<BK, BN, VEC>, smem);
  if (err != cudaSuccess) return err;
  k_dw_mma_kernel<BK, BN, VEC><<<grid, T::kThreads, smem, stream>>>(
      z, dye, p.dw_partial, p.m, p.k, p.n, p.chunk_rows);
  return cudaGetLastError();
}

template <bool AFFINE, bool RELU, bool VEC>
cudaError_t run_bf16(const Args& p, cudaStream_t stream) {
  const bf16* x = static_cast<const bf16*>(p.x);
  bf16* dye = static_cast<bf16*>(p.dy_eff);
  cudaError_t err = prep_dy<KernelK, VEC>(
      static_cast<const bf16*>(p.dy), static_cast<const bf16*>(p.y), p.c,
      p.ds, dye, p.m, p.n, stream);
  if (err != cudaSuccess) return err;
  const bf16* z = x;
  if (AFFINE) {
    bf16* zs = static_cast<bf16*>(p.z);
    err = prep_z<KernelK, RELU, VEC>(x, p.a, p.b, zs, p.m, p.k, stream);
    if (err != cudaSuccess) return err;
    z = zs;
  }
  // the dW tile: 128 along K and N where they allow, else 64 (ops/
  // conv_fused.py `_k_dw_tile`)
  const int chunks = static_cast<int>(cdiv(p.m, p.chunk_rows));
  if (p.k > 64)
    err = p.n > 64 ? run_dw<128, 128, VEC>(z, dye, p, chunks, stream)
                   : run_dw<128, 64, VEC>(z, dye, p, chunks, stream);
  else
    err = p.n > 64 ? run_dw<64, 128, VEC>(z, dye, p, chunks, stream)
                   : run_dw<64, 64, VEC>(z, dye, p, chunks, stream);
  if (err != cudaSuccess) return err;
  err = run_dx<1, AFFINE, RELU, VEC>(
      x, p.a, p.b, static_cast<const bf16*>(p.w), dye,
      static_cast<bf16*>(p.dx), p.dab_partial, p.m, 1, 1, p.k, p.n, stream);
  if (err != cudaSuccess) return err;
  err = chunk_sum<1>(p.dw_partial, p.dw, chunks,
                     static_cast<long long>(p.k) * p.n, stream);
  if (err != cudaSuccess || !AFFINE) return err;
  return column_sum(p.dab_partial, p.dab,
                    static_cast<int>(cdiv(p.m, kDxRows)), 2LL * p.k, stream);
}

template <bool AFFINE, bool RELU>
cudaError_t run_f32(const Args& p, cudaStream_t stream) {
  const float* x = static_cast<const float*>(p.x);
  const float* y = static_cast<const float*>(p.y);
  const float* dy = static_cast<const float*>(p.dy);
  const int row_blocks = static_cast<int>(cdiv(p.m, kBM));
  const dim3 grid_dx(static_cast<unsigned>(row_blocks),
                     static_cast<unsigned>(cdiv(p.k, kBN)));
  conv1x1_dx_kernel<AFFINE, RELU><<<grid_dx, kThreads, 0, stream>>>(
      x, p.a, p.b, static_cast<const float*>(p.w), p.c, y, dy, p.ds,
      static_cast<float*>(p.dx), p.dab_partial, p.m, p.k, p.n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int chunks = static_cast<int>(cdiv(p.m, p.chunk_rows));
  const dim3 grid_dw(static_cast<unsigned>(cdiv(p.k, kBM)),
                     static_cast<unsigned>(cdiv(p.n, kBN)),
                     static_cast<unsigned>(chunks));
  conv1x1_dw_kernel<AFFINE, RELU><<<grid_dw, kThreads, 0, stream>>>(
      x, p.a, p.b, p.c, y, dy, p.ds, p.dw_partial, p.m, p.k, p.n,
      p.chunk_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = column_sum(p.dw_partial, p.dw, chunks,
                   static_cast<long long>(p.k) * p.n, stream);
  if (err != cudaSuccess || !AFFINE) return err;
  return column_sum(p.dab_partial, p.dab, row_blocks, 2LL * p.k, stream);
}

template <typename T, bool AFFINE, bool RELU>
struct Launch {
  static cudaError_t run(const Args& p, cudaStream_t stream) {
    if constexpr (std::is_same<T, float>::value) {
      return run_f32<AFFINE, RELU>(p, stream);
    } else {
      // the 16-byte copies need whole 8-channel groups and aligned rows
      // and per-channel vectors
      const bool vec = p.k % 8 == 0 && p.n % 8 == 0 && aligned16(p.x) &&
                       aligned16(p.w) && aligned16(p.y) &&
                       aligned16(p.dy) && aligned16(p.dy_eff) &&
                       aligned16(p.c) && aligned16(p.ds) &&
                       (!AFFINE || (aligned16(p.z) && aligned16(p.a) &&
                                    aligned16(p.b)));
      return vec ? run_bf16<AFFINE, RELU, true>(p, stream)
                 : run_bf16<AFFINE, RELU, false>(p, stream);
    }
  }
};

}  // namespace

// x [m, k], w [k, n], y and dy [m, n] of one dtype; ds [2, n] and c [n]
// fp32; a, b, dab_partial and dab null without the affine. The caller sizes
// the scratch (ops/conv_fused.py `conv1x1_bwd_scratch`): dw_partial
// [ceil(m / chunk_rows), k, n] with at most 65535 chunks; dab_partial
// [ceil(m / rows), 2, k] with rows 128 in bf16 and 64 in f32; in bf16
// dy_eff [m, n] and, with the affine, z [m, k] (both null in f32). All
// sizes > 0, tensors contiguous.
extern "C" int apex_conv1x1_bwd(const void* x, const void* a, const void* b,
                                const void* w, const void* c, const void* y,
                                const void* dy, const void* ds, void* dx,
                                void* dw_partial, void* dw, void* dab_partial,
                                void* dab, void* dy_eff, void* z,
                                void* stream, int m, int k, int n,
                                int chunk_rows, int affine, int relu,
                                int dtype) {
  const Args p{x, static_cast<const float*>(a), static_cast<const float*>(b),
               w, static_cast<const float*>(c), y, dy,
               static_cast<const float*>(ds), dx,
               static_cast<float*>(dw_partial), static_cast<float*>(dw),
               static_cast<float*>(dab_partial), static_cast<float*>(dab),
               dy_eff, z, m, k, n, chunk_rows};
  return static_cast<int>(apex::conv::dispatch<Launch>(
      p, dtype, affine, relu, static_cast<cudaStream_t>(stream)));
}

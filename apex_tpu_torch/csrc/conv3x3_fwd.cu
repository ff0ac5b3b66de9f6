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
// - prep (with the affine; conv_prep.cuh, shared with Kernels J, K, M): one
//   elementwise pass with 16-byte loads and stores writes z [m, K] to bf16
//   scratch, each element formed once (conv_fused.cuh's zval: the rounding
//   points of the plain version). Without the affine z is x, and no pass
//   runs;
// - the implicit GEMM (conv_mma.cuh's fwd_mma_kernel at nine taps, which
//   Kernel J runs at one): blocks of 128 output pixels x 64 output channels
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
#include "conv_mma.cuh"
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
  mainloop<true, false>(9 * k, la, lb, sm.g, acc);
  epilogue_fwd<float>(acc, y, c, partial, m, n, row0, col0, sm);
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
  const bf16* w = static_cast<const bf16*>(p.w);
  bf16* y = static_cast<bf16*>(p.y);
  return p.n >= 128
             ? run_fwd<9, 64, 128, VEC, false>(z, w, p.c, y, p.partial,
                                               p.stats, m, p.h, p.wd, p.k,
                                               p.n, stream)
             : run_fwd<9, 128, 64, VEC, false>(z, w, p.c, y, p.partial,
                                               p.stats, m, p.h, p.wd, p.k,
                                               p.n, stream);
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

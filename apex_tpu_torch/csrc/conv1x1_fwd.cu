// Fused 1x1 convolution forward (Kernel J of the PyTorch port).
//
// Replaces: apex_tpu/ops/conv_fused.py `_fwd_kernel` (:63), launched by
// `_fwd_pallas` (:94) through `pl.pallas_call` (:108).
//
// Semantics kept: x [M, K] and w [K, N] of one dtype (bf16, fp16 or f32); with
// the input affine z = relu?(x * a + b) in fp32 rounded to w's dtype, else
// z = x; y = z @ w accumulated in fp32 and rounded once to x's dtype;
// stats [2, N] = (sum(y - c), sum((y - c)^2)) over the M rows, from the
// fp32 y before its rounding.
//
// What does not carry over: the TPU kernel keeps W resident and adds each
// grid step's column sums into one VMEM accumulator, relying on the grid
// running in order (and its caller skips the kernel above ~1.5M weight
// elements for want of VMEM). Blocks on the card run in parallel: each
// row block writes its own fp32 partial row of the two sums, and a second
// pass adds the partials in a fixed order (no atomics; repeated runs are
// bitwise equal). Any M, K and N launch the kernel.
//
// Bound on the H100: bytes at ResNet-50's layers 1-3, where y is up to four
// times the bytes of x. At layer1 conv3 (x [802816, 64] bf16, w [64, 256],
// affine + relu) ~514 MB are read and written against 26 G FLOPs: ~0.15 ms
// at 3.35 TB/s, ~0.21 ms with the prep pass's z written and read again.
// Operations at layer3's downsample and all of layer4 (26-53 G FLOPs a
// launch: 0.027-0.053 ms at 989 TFLOP/s).
//
// bf16 and fp16, the paths ResNet-50 trains on (Kernel L's passes at one
// tap; one template over the 16-bit type T):
// - prep (with the affine; conv_prep.cuh, shared with K, L and M): one
//   elementwise pass with 16-byte loads and stores writes z [m, K] to T
//   scratch, each element formed once (conv_fused.cuh's zval: the rounding
//   points of the plain version). Without the affine (every conv1 and
//   downsample) z is x, and no pass runs;
// - conv_mma.cuh's forward GEMM at one tap: tiles of 128 rows x 64 output
//   channels (64 x 128 where N >= 128; ops/conv_fused.py `_l_rows`), 8
//   warps of 32 x 32, y over 32-channel slices on mma.sync m16n8k16 fed by
//   a 4-stage cp.async ring; a 1D grid with the column blocks of one row
//   block next to each other, so that z rows come from memory once and
//   then from L2. The stats come from the fp32 fragments as in L. The
//   tile's y is staged through shared memory and stored as 16-byte rows
//   (where N % 8 == 0 and the tensors are aligned; else the fragments'
//   T pairs, as L stores them);
// - the partial rows are summed in fixed-order chunks of 512 rows
//   (conv_mma.cuh's chunked_column_sum), then the chunks by column_sum.
//
// What bounds it now: measured in PERF.md (apex_tpu_torch/tools/
// conv_timing.py); the split between the memory system and the products is
// inferred, not profiled (no ncu on the card's machine).
//
// f32 (checks only): the tiled GEMM of conv_fused.cuh in fp32 FMAs, z
// formed in its loader.
#include "conv_fused.cuh"
#include "conv_mma.cuh"
#include "conv_prep.cuh"
#include "mma_ring.cuh"

namespace {

using namespace apex::conv;

// ---------------------------------------------------------------------------
// f32: the fused loader over fp32 FMAs
// ---------------------------------------------------------------------------

template <bool AFFINE, bool RELU>
__global__ void __launch_bounds__(kThreads)
conv1x1_fwd_kernel(const float* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ b, const float* __restrict__ w,
                   const float* __restrict__ c, float* __restrict__ y,
                   float* __restrict__ partial, int m, int k, int n) {
  __shared__ Shared sm;
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  ZRows<float, AFFINE, RELU> la(x, a, b, m, k, row0);
  WRows<float> lb(w, n, col0);
  float acc[4][4] = {};
  mainloop<true, false>(k, la, lb, sm.g, acc);
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
  float* partial;  // fp32 scratch (tile rows, then chunk rows; below)
  float* stats;    // [2, n]
  void* z;         // [m, k] scratch of x's type (16-bit, with the affine)
  int m, k, n;
};

template <typename T, bool AFFINE, bool RELU, bool VEC>
cudaError_t run_16(const Args& p, cudaStream_t stream) {
  const T* z = static_cast<const T*>(p.x);
  if constexpr (AFFINE) {
    T* zs = static_cast<T*>(p.z);
    const cudaError_t err =
        prep_z<KernelJ, RELU, VEC>(z, p.a, p.b, zs, p.m, p.k, stream);
    if (err != cudaSuccess) return err;
    z = zs;
  }
  const T* w = static_cast<const T*>(p.w);
  T* y = static_cast<T*>(p.y);
  // y staged into 16-byte rows wherever the copies are 16-byte ones
  return p.n >= 128
             ? run_fwd<1, 64, 128, VEC, VEC>(z, w, p.c, y, p.partial, p.stats,
                                             p.m, 1, 1, p.k, p.n, stream)
             : run_fwd<1, 128, 64, VEC, VEC>(z, w, p.c, y, p.partial, p.stats,
                                             p.m, 1, 1, p.k, p.n, stream);
}

template <bool AFFINE, bool RELU>
cudaError_t run_f32(const Args& p, cudaStream_t stream) {
  const int row_blocks = static_cast<int>(cdiv(p.m, kBM));
  const dim3 grid(static_cast<unsigned>(row_blocks),
                  static_cast<unsigned>(cdiv(p.n, kBN)));
  conv1x1_fwd_kernel<AFFINE, RELU><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(p.x), p.a, p.b,
      static_cast<const float*>(p.w), p.c, static_cast<float*>(p.y),
      p.partial, p.m, p.k, p.n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return column_sum(p.partial, p.stats, row_blocks, 2LL * p.n, stream);
}

template <typename T, bool AFFINE, bool RELU>
struct Launch {
  static cudaError_t run(const Args& p, cudaStream_t stream) {
    if constexpr (std::is_same<T, float>::value) {
      return run_f32<AFFINE, RELU>(p, stream);
    } else {
      // the 16-byte copies and y's 16-byte rows need whole 8-channel
      // groups and aligned rows and per-channel vectors
      const bool vec = p.k % 8 == 0 && p.n % 8 == 0 && aligned16(p.x) &&
                       aligned16(p.w) && aligned16(p.y) &&
                       (!AFFINE || (aligned16(p.z) && aligned16(p.a) &&
                                    aligned16(p.b)));
      return vec ? run_16<T, AFFINE, RELU, true>(p, stream)
                 : run_16<T, AFFINE, RELU, false>(p, stream);
    }
  }
};

}  // namespace

// a and b are null without the input affine (relu then 0). The caller sizes
// the scratch (ops/conv_fused.py `conv1x1_fwd_scratch`): `partial`
// [rows, 2, n] fp32 with rows = ceil(m / 64) in f32 and, in bf16 and fp16,
// ceil(m / tile rows) + ceil(that / 512) (tile rows 128, or 64 where n >=
// 128: the tiles' rows, then their chunk sums); in bf16 and fp16 with the
// affine z [m, k] of x's type (else null). m, k, n > 0; all tensors
// contiguous.
extern "C" int apex_conv1x1_fwd(const void* x, const void* a, const void* b,
                                const void* w, const void* c, void* y,
                                void* partial, void* stats, void* z,
                                void* stream, int m, int k, int n, int affine,
                                int relu, int dtype) {
  const Args p{x, static_cast<const float*>(a), static_cast<const float*>(b),
               w, static_cast<const float*>(c), y,
               static_cast<float*>(partial), static_cast<float*>(stats), z, m,
               k, n};
  return static_cast<int>(apex::conv::dispatch<Launch>(
      p, dtype, affine, relu, static_cast<cudaStream_t>(stream)));
}

// Fused 1x1 convolution forward (Kernel J of the PyTorch port).
//
// Replaces: apex_tpu/ops/conv_fused.py `_fwd_kernel` (:63), launched by
// `_fwd_pallas` (:94) through `pl.pallas_call` (:108).
//
// Semantics kept: x [M, K] and w [K, N] of one dtype (bf16 or f32); with
// the input affine z = relu?(x * a + b) in fp32 rounded to w's dtype, else
// z = x; y = z @ w accumulated in fp32 and rounded once to x's dtype;
// stats [2, N] = (sum(y - c), sum((y - c)^2)) over the M rows, from the
// fp32 y before its rounding.
//
// What does not carry over: the TPU kernel keeps W resident and adds each
// grid step's column sums into one VMEM accumulator, relying on the grid
// running in order (and its caller skips the kernel above ~1.5M weight
// elements for want of VMEM). Blocks on the card run in parallel: each
// 64-row block writes its own fp32 partial row of the two sums, and a
// second pass adds the partials in a fixed order (no atomics; repeated runs
// are bitwise equal). Any K and N launch the kernel.
//
// Bound on the H100 at ResNet-50's layer1 conv3 (x [802816, 64] bf16, w
// [64, 256], affine + relu): bytes, ~514 MB read and written against 26 G
// multiply-add FLOPs (about 0.15 ms at 3.35 TB/s). This design is a tiled
// GEMM (conv_fused.cuh; WMMA tensor-core products in bf16, fp32 FMAs in
// f32) whose loaders form z from x as they stage it: it re-reads x once per
// 64 output columns and runs far above the byte bound; its time is in
// PERF.md.
#include "conv_fused.cuh"

namespace {

using namespace apex::conv;

template <typename T, bool AFFINE, bool RELU>
__global__ void __launch_bounds__(kThreads)
conv1x1_fwd_kernel(const T* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ b, const T* __restrict__ w,
                   const float* __restrict__ c, T* __restrict__ y,
                   float* __restrict__ partial, int m, int k, int n) {
  __shared__ Shared sm;
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  ZRows<T, AFFINE, RELU> la(x, a, b, m, k, row0);
  WRows<T> lb(w, n, col0);
  float acc[4][4] = {};
  mainloop<T, true, false>(k, la, lb, sm, acc);
  epilogue_fwd<T>(acc, y, c, partial, m, n, row0, col0, sm);
}

struct Args {
  const void* x;
  const float* a;
  const float* b;
  const void* w;
  const float* c;
  void* y;
  float* partial;  // [ceil(m / 64), 2, n] fp32 scratch
  float* stats;    // [2, n]
  int m, k, n;
};

template <typename T, bool AFFINE, bool RELU>
struct Launch {
  static cudaError_t run(const Args& p, cudaStream_t stream) {
    const dim3 grid(static_cast<unsigned>(cdiv(p.m, kBM)),
                    static_cast<unsigned>(cdiv(p.n, kBN)));
    conv1x1_fwd_kernel<T, AFFINE, RELU><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(p.x), p.a, p.b, static_cast<const T*>(p.w), p.c,
        static_cast<T*>(p.y), p.partial, p.m, p.k, p.n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return column_sum(p.partial, p.stats, static_cast<int>(cdiv(p.m, kBM)),
                      2LL * p.n, stream);
  }
};

}  // namespace

// a and b are null without the input affine (relu then 0); the caller sizes
// `partial` as [ceil(m / 64), 2, n] fp32 (ops/conv_fused.py). m, k, n > 0;
// all tensors contiguous.
extern "C" int apex_conv1x1_fwd(const void* x, const void* a, const void* b,
                                const void* w, const void* c, void* y,
                                void* partial, void* stats, void* stream,
                                int m, int k, int n, int affine, int relu,
                                int dtype) {
  const Args p{x, static_cast<const float*>(a), static_cast<const float*>(b),
               w, static_cast<const float*>(c), y,
               static_cast<float*>(partial), static_cast<float*>(stats), m, k,
               n};
  return static_cast<int>(apex::conv::dispatch<Launch>(
      p, dtype, affine, relu, static_cast<cudaStream_t>(stream)));
}

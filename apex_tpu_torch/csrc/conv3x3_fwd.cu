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
// The stats are per-block partials reduced in a fixed order, as in
// Kernel J.
//
// Bound on the H100 at layer1 (x [256, 56, 56, 64] bf16 -> 64): bytes and
// operations about even, ~206 MB against 59 G FLOPs (~0.06 ms). Design: an
// implicit GEMM (conv_fused.cuh) over output pixels x (tap, channel): each
// thread keeps its four output pixels as (image, row, column) and walks
// the contraction as (tap, channel), so the halo test is two compares and
// no division.
#include "conv_fused.cuh"

namespace {

using namespace apex::conv;

template <typename T, bool AFFINE, bool RELU>
__global__ void __launch_bounds__(kThreads)
conv3x3_fwd_kernel(const T* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ b, const T* __restrict__ w,
                   const float* __restrict__ c, T* __restrict__ y,
                   float* __restrict__ partial, long long m, int h, int wd,
                   int k, int n) {
  __shared__ Shared sm;
  const long long row0 = static_cast<long long>(blockIdx.x) * kBM;
  const int col0 = blockIdx.y * kBN;
  ZTaps<T, AFFINE, RELU> la(x, a, b, m, h, wd, k, row0);
  WRows<T> lb(w, n, col0);
  float acc[4][4] = {};
  mainloop<T, true, false>(9 * k, la, lb, sm, acc);
  epilogue_fwd<T>(acc, y, c, partial, m, n, row0, col0, sm);
}

struct Args {
  const void* x;
  const float* a;
  const float* b;
  const void* w;
  const float* c;
  void* y;
  float* partial;  // [ceil(images * h * w / 64), 2, n] fp32 scratch
  float* stats;    // [2, n]
  int images, h, wd, k, n;
};

template <typename T, bool AFFINE, bool RELU>
struct Launch {
  static cudaError_t run(const Args& p, cudaStream_t stream) {
    const long long m = static_cast<long long>(p.images) * p.h * p.wd;
    const dim3 grid(static_cast<unsigned>(cdiv(m, kBM)),
                    static_cast<unsigned>(cdiv(p.n, kBN)));
    conv3x3_fwd_kernel<T, AFFINE, RELU><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(p.x), p.a, p.b, static_cast<const T*>(p.w), p.c,
        static_cast<T*>(p.y), p.partial, m, p.h, p.wd, p.k, p.n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return column_sum(p.partial, p.stats, static_cast<int>(cdiv(m, kBM)),
                      2LL * p.n, stream);
  }
};

}  // namespace

// x [images, h, w, k], w [3, 3, k, n]; a and b null without the affine;
// `partial` is [ceil(images h w / 64), 2, n] fp32 (ops/conv_fused.py). All
// sizes > 0, all tensors contiguous.
extern "C" int apex_conv3x3_fwd(const void* x, const void* a, const void* b,
                                const void* w, const void* c, void* y,
                                void* partial, void* stats, void* stream,
                                int images, int h, int wd, int k, int n,
                                int affine, int relu, int dtype) {
  const Args p{x, static_cast<const float*>(a), static_cast<const float*>(b),
               w, static_cast<const float*>(c), y,
               static_cast<float*>(partial), static_cast<float*>(stats),
               images, h, wd, k, n};
  return static_cast<int>(apex::conv::dispatch<Launch>(
      p, dtype, affine, relu, static_cast<cudaStream_t>(stream)));
}

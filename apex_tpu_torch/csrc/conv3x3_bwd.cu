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
// ResNet-50's layer1 and layer4 sizes). Here:
// - pass 1 (dx): an implicit GEMM over output pixels x (tap, out channel)
//   of dy_eff against w transposed per tap, with Kernel K's epilogue;
// - pass 2 (dW): blocks over (64 x 64 tile of [K, N'], tap, chunk of
//   pixels) write fp32 partials of dW[tap];
// - pass 3: fixed-order column sums of the dW and da/db partials. No
//   atomics: repeated runs are bitwise equal.
//
// Bound on the H100 at layer1 ([256, 56, 56, 64] -> 64, bf16): bytes and
// operations about even, ~411 MB against 118 G FLOPs (~0.12 ms).
#include "conv_fused.cuh"

namespace {

using namespace apex::conv;

template <typename T, bool AFFINE, bool RELU>
__global__ void __launch_bounds__(kThreads)
conv3x3_dx_kernel(const T* __restrict__ x, const float* __restrict__ a,
                  const float* __restrict__ b, const T* __restrict__ w,
                  const float* __restrict__ c, const T* __restrict__ y,
                  const T* __restrict__ dy, const float* __restrict__ ds,
                  T* __restrict__ dx, float* __restrict__ dab_partial,
                  long long m, int h, int wd, int k, int n) {
  __shared__ Shared sm;
  const long long row0 = static_cast<long long>(blockIdx.x) * kBM;
  const int col0 = blockIdx.y * kBN;
  DyTaps<T> la(dy, y, c, ds, m, h, wd, n, row0);
  WTaps<T> lb(w, k, n, col0);
  float acc[4][4] = {};
  mainloop<T, true, true>(9 * n, la, lb, sm, acc);
  epilogue_dx<T, AFFINE, RELU>(acc, x, a, b, dx, dab_partial, m, k, row0,
                               col0, sm);
}

template <typename T, bool AFFINE, bool RELU>
__global__ void __launch_bounds__(kThreads)
conv3x3_dw_kernel(const T* __restrict__ x, const float* __restrict__ a,
                  const float* __restrict__ b, const float* __restrict__ c,
                  const T* __restrict__ y, const T* __restrict__ dy,
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
  ZCols<T, AFFINE, RELU> la(x, a, b, h, wd, k, row0, m_lo, tap);
  DyCols<T> lb(dy, y, c, ds, n, col0, m_lo);
  float acc[4][4] = {};
  mainloop<T, false, false>(rows, la, lb, sm, acc);
  epilogue_dw(acc, dw_partial + static_cast<long long>(blockIdx.z) * k * n,
              k, n, row0, col0);
}

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
  float* dab_partial;  // [ceil(images h w / 64), 2, k] (affine only)
  float* dab;          // [2, k]: da, db (affine only)
  int images, h, wd, k, n, chunk_rows;
};

template <typename T, bool AFFINE, bool RELU>
struct Launch {
  static cudaError_t run(const Args& p, cudaStream_t stream) {
    const T* x = static_cast<const T*>(p.x);
    const T* y = static_cast<const T*>(p.y);
    const T* dy = static_cast<const T*>(p.dy);
    const long long m = static_cast<long long>(p.images) * p.h * p.wd;
    const int row_blocks = static_cast<int>(cdiv(m, kBM));
    const dim3 grid_dx(static_cast<unsigned>(row_blocks),
                       static_cast<unsigned>(cdiv(p.k, kBN)));
    conv3x3_dx_kernel<T, AFFINE, RELU><<<grid_dx, kThreads, 0, stream>>>(
        x, p.a, p.b, static_cast<const T*>(p.w), p.c, y, dy, p.ds,
        static_cast<T*>(p.dx), p.dab_partial, m, p.h, p.wd, p.k, p.n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int chunks = static_cast<int>(cdiv(m, p.chunk_rows));
    const dim3 grid_dw(static_cast<unsigned>(cdiv(p.k, kBM)),
                       static_cast<unsigned>(cdiv(p.n, kBN)),
                       static_cast<unsigned>(9 * chunks));
    conv3x3_dw_kernel<T, AFFINE, RELU><<<grid_dw, kThreads, 0, stream>>>(
        x, p.a, p.b, p.c, y, dy, p.ds, p.dw_partial, m, p.h, p.wd, p.k, p.n,
        p.chunk_rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = column_sum(p.dw_partial, p.dw, chunks,
                     9LL * p.k * p.n, stream);
    if (err != cudaSuccess || !AFFINE) return err;
    return column_sum(p.dab_partial, p.dab, row_blocks, 2LL * p.k, stream);
  }
};

}  // namespace

// x and dx [images, h, w, k], w [3, 3, k, n], y and dy [images, h, w, n] of
// one dtype; c [n] and ds [2, n] fp32; a, b, dab_partial and dab null
// without the affine. The caller sizes the partials (ops/conv_fused.py):
// dw_partial [ceil(images h w / chunk_rows), 9, k, n] with at most 7281
// chunks, dab_partial [ceil(images h w / 64), 2, k]. All sizes > 0,
// tensors contiguous.
extern "C" int apex_conv3x3_bwd(const void* x, const void* a, const void* b,
                                const void* w, const void* c, const void* y,
                                const void* dy, const void* ds, void* dx,
                                void* dw_partial, void* dw, void* dab_partial,
                                void* dab, void* stream, int images, int h,
                                int wd, int k, int n, int chunk_rows,
                                int affine, int relu, int dtype) {
  const Args p{x, static_cast<const float*>(a), static_cast<const float*>(b),
               w, static_cast<const float*>(c), y, dy,
               static_cast<const float*>(ds), dx,
               static_cast<float*>(dw_partial), static_cast<float*>(dw),
               static_cast<float*>(dab_partial), static_cast<float*>(dab),
               images, h, wd, k, n, chunk_rows};
  return static_cast<int>(apex::conv::dispatch<Launch>(
      p, dtype, affine, relu, static_cast<cudaStream_t>(stream)));
}

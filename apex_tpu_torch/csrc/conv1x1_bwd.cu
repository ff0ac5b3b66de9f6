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
// ~1.5M weight elements). Here:
// - pass 1 (dx): 64-row x 64-channel tiles of dz = dy_eff w^T, with the
//   relu mask, dx and per-row-block partials of da and db in the epilogue;
// - pass 2 (dW): the M rows are cut into chunks, each block forms a 64 x 64
//   tile of one chunk's z^T dy_eff and writes it as an fp32 partial; the
//   chunk count follows M and K N (ops/conv_fused.py `dw_chunks`: enough
//   blocks to fill the card, >= 256 rows a chunk);
// - pass 3: fixed-order column sums of the dW and da/db partials. No
//   atomics: repeated runs are bitwise equal.
//
// Bound on the H100 at ResNet-50's layer1 conv3 shape (x [802816, 64],
// y and dy [802816, 256] bf16, affine + relu): bytes, ~1.03 GB read and
// written against 53 G FLOPs (~0.31 ms at 3.35 TB/s). Both passes
// recompute z and dy_eff from what they read rather than store them.
#include "conv_fused.cuh"

namespace {

using namespace apex::conv;

template <typename T, bool AFFINE, bool RELU>
__global__ void __launch_bounds__(kThreads)
conv1x1_dx_kernel(const T* __restrict__ x, const float* __restrict__ a,
                  const float* __restrict__ b, const T* __restrict__ w,
                  const float* __restrict__ c, const T* __restrict__ y,
                  const T* __restrict__ dy, const float* __restrict__ ds,
                  T* __restrict__ dx, float* __restrict__ dab_partial, int m,
                  int k, int n) {
  __shared__ Shared sm;
  const long long row0 = static_cast<long long>(blockIdx.x) * kBM;
  const int col0 = blockIdx.y * kBN;
  DyRows<T> la(dy, y, c, ds, m, n, row0);
  WTaps<T> lb(w, k, n, col0);
  float acc[4][4] = {};
  mainloop<T, true, true>(n, la, lb, sm, acc);
  epilogue_dx<T, AFFINE, RELU>(acc, x, a, b, dx, dab_partial, m, k, row0,
                               col0, sm);
}

template <typename T, bool AFFINE, bool RELU>
__global__ void __launch_bounds__(kThreads)
conv1x1_dw_kernel(const T* __restrict__ x, const float* __restrict__ a,
                  const float* __restrict__ b, const float* __restrict__ c,
                  const T* __restrict__ y, const T* __restrict__ dy,
                  const float* __restrict__ ds, float* __restrict__ dw_partial,
                  int m, int k, int n, int chunk_rows) {
  __shared__ Shared sm;
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  const long long m_lo = static_cast<long long>(blockIdx.z) * chunk_rows;
  const int rows = static_cast<int>(min(static_cast<long long>(chunk_rows),
                                        m - m_lo));
  // a 1x1 is the 3x3 loader's centre tap over a 1 x m "image"
  ZCols<T, AFFINE, RELU> la(x, a, b, 1, m, k, row0, m_lo, 4);
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
  float* dw_partial;   // [ceil(m / chunk_rows), k, n] fp32 scratch
  float* dw;           // [k, n] fp32
  float* dab_partial;  // [ceil(m / 64), 2, k] fp32 scratch (affine only)
  float* dab;          // [2, k] fp32: da, db (affine only)
  int m, k, n, chunk_rows;
};

template <typename T, bool AFFINE, bool RELU>
struct Launch {
  static cudaError_t run(const Args& p, cudaStream_t stream) {
    const T* x = static_cast<const T*>(p.x);
    const T* y = static_cast<const T*>(p.y);
    const T* dy = static_cast<const T*>(p.dy);
    const int row_blocks = static_cast<int>(cdiv(p.m, kBM));
    const dim3 grid_dx(static_cast<unsigned>(row_blocks),
                       static_cast<unsigned>(cdiv(p.k, kBN)));
    conv1x1_dx_kernel<T, AFFINE, RELU><<<grid_dx, kThreads, 0, stream>>>(
        x, p.a, p.b, static_cast<const T*>(p.w), p.c, y, dy, p.ds,
        static_cast<T*>(p.dx), p.dab_partial, p.m, p.k, p.n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int chunks = static_cast<int>(cdiv(p.m, p.chunk_rows));
    const dim3 grid_dw(static_cast<unsigned>(cdiv(p.k, kBM)),
                       static_cast<unsigned>(cdiv(p.n, kBN)),
                       static_cast<unsigned>(chunks));
    conv1x1_dw_kernel<T, AFFINE, RELU><<<grid_dw, kThreads, 0, stream>>>(
        x, p.a, p.b, p.c, y, dy, p.ds, p.dw_partial, p.m, p.k, p.n,
        p.chunk_rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = column_sum(p.dw_partial, p.dw, chunks,
                     static_cast<long long>(p.k) * p.n, stream);
    if (err != cudaSuccess || !AFFINE) return err;
    return column_sum(p.dab_partial, p.dab, row_blocks, 2LL * p.k, stream);
  }
};

}  // namespace

// x [m, k], w [k, n], y and dy [m, n] of one dtype; ds [2, n] and c [n]
// fp32; a, b, dab_partial and dab null without the affine. The caller sizes
// the partials (ops/conv_fused.py): dw_partial [ceil(m / chunk_rows), k, n],
// dab_partial [ceil(m / 64), 2, k]. All sizes > 0, tensors contiguous.
extern "C" int apex_conv1x1_bwd(const void* x, const void* a, const void* b,
                                const void* w, const void* c, const void* y,
                                const void* dy, const void* ds, void* dx,
                                void* dw_partial, void* dw, void* dab_partial,
                                void* dab, void* stream, int m, int k, int n,
                                int chunk_rows, int affine, int relu,
                                int dtype) {
  const Args p{x, static_cast<const float*>(a), static_cast<const float*>(b),
               w, static_cast<const float*>(c), y, dy,
               static_cast<const float*>(ds), dx,
               static_cast<float*>(dw_partial), static_cast<float*>(dw),
               static_cast<float*>(dab_partial), static_cast<float*>(dab), m,
               k, n, chunk_rows};
  return static_cast<int>(apex::conv::dispatch<Launch>(
      p, dtype, affine, relu, static_cast<cudaStream_t>(stream)));
}

// Shared pieces of the fused convolution kernels (Kernels J, K, L and M of
// the PyTorch port): their f32 paths' 64 x 64 output tile GEMM over fp32
// shared-memory stages, the operand loaders that form z = relu(x * a + b)
// and the effective cotangent dy_eff on the fly, the three epilogues, the
// z and dy_eff formulas the 16-bit prep passes share (conv_prep.cuh), and
// the fixed-order column sum that reduces per-block partials (every dtype).
//
// Rounding points are those of apex_tpu/ops/conv_fused.py: z is formed in
// fp32 (x * a, then + b, then relu) and rounded to w's dtype before the
// product; dy_eff = (dy + ds0) + (2 (y - c)) ds1 in fp32, rounded to w's
// dtype; every product accumulates in fp32. The multiplies and adds of z
// and dy_eff are written with round-to-nearest intrinsics so that the
// compiler does not contract them into fused multiply-adds: the plain
// PyTorch versions compute them as separate operations, and a relu mask or
// a 16-bit rounding must not flip between the two.
//
// GEMM (f32 only: the bf16 and fp16 paths run conv_prep.cuh's prep passes
// and the mma.sync GEMMs of conv_mma.cuh and conv1x1_bwd.cu /
// conv3x3_bwd.cu): 256 threads own a 64 x 64 output tile. Each step
// stages a 64 x 16 slice of A and a 16 x 64 slice of B in shared memory as
// fp32, and each thread runs 16 rank-1 updates of its 4 x 4 outputs (rows
// ty * 4 + i, columns tx * 4 + j) from registers. The loaders decide which operand index runs fastest
// across threads, so that global reads are coalesced along the contiguous
// axis of each operand.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace apex {
namespace conv {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;
constexpr int kPad = 4;
constexpr int kReduceThreads = 1024;

struct Stage {
  float a[kBK][kBM + kPad];
  float b[kBK][kBN + kPad];
};

// the mainloop's stages and the epilogue's column reduction share the
// block's shared memory
union Shared {
  Stage g;
  float red[kThreads / 16][kBN][2];
};

// Element i (0..3) of this thread's share of a 64 x 16 operand slice: with
// KFAST the contraction index runs fastest across threads (tile row or
// column (tid >> 4) + 16 i, contraction tid & 15), else the tile index does
// (tile row or column tid & 63, contraction (tid >> 6) + 4 i).
template <bool KFAST>
__device__ __forceinline__ int tile_rc(int i) {
  return KFAST ? static_cast<int>(threadIdx.x >> 4) + 16 * i
               : static_cast<int>(threadIdx.x & 63);
}
template <bool KFAST>
__device__ __forceinline__ int tile_k(int i) {
  return KFAST ? static_cast<int>(threadIdx.x & 15)
               : static_cast<int>(threadIdx.x >> 6) + 4 * i;
}

// The input affine of one channel k (a[k], b[k]); the loaders read it
// once a slice (or once a block) for all their elements of that channel.
struct Affine {
  float a, b;
};

template <bool AFFINE>
__device__ __forceinline__ Affine affine_of(const float* __restrict__ a,
                                            const float* __restrict__ b,
                                            int k) {
  return AFFINE ? Affine{a[k], b[k]} : Affine{0.f, 0.f};
}

// z of one input element: relu(x * a + b) rounded to T, or x itself
template <typename T, bool AFFINE, bool RELU>
__device__ __forceinline__ float zval(float x, Affine f) {
  if (!AFFINE) return x;
  float p = __fadd_rn(__fmul_rn(x, f.a), f.b);
  if (RELU) p = fmaxf(p, 0.f);
  return round_to(p, static_cast<T*>(nullptr));
}

// The statistics cotangent of one output channel n: the shift c[n] and
// ds = (ds0[n], ds1[n]), read once a slice (or once a block).
struct Cot {
  float c, ds0, ds1;
};

__device__ __forceinline__ Cot cot_of(const float* __restrict__ c,
                                      const float* __restrict__ ds, int n_dim,
                                      int n) {
  return Cot{c[n], ds[n], ds[n_dim + n]};
}

// dy_eff of one output element, rounded to T: the statistics cotangent
// folded into dy
template <typename T>
__device__ __forceinline__ float dyc(float dy, float y, Cot q) {
  const float yc2 = __fmul_rn(2.f, __fsub_rn(y, q.c));
  const float d = __fadd_rn(__fadd_rn(dy, q.ds0), __fmul_rn(yc2, q.ds1));
  return round_to(d, static_cast<T*>(nullptr));
}

// acc += A[64 x kdim] B[kdim x 64] in fp32 FMAs; la / lb give element i of
// this thread's share of each slice (valid: its contraction index is below
// kdim) and step to the next slice with advance().
template <bool A_KFAST, bool B_KFAST, class LA, class LB>
__device__ __forceinline__ void mainloop(int kdim, LA& la, LB& lb, Stage& sm,
                                         float (&acc)[4][4]) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  for (int k0 = 0; k0 < kdim; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = tile_k<A_KFAST>(i);
      sm.a[kk][tile_rc<A_KFAST>(i)] = la.load(i, k0 + kk < kdim);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = tile_k<B_KFAST>(i);
      sm.b[kk][tile_rc<B_KFAST>(i)] = lb.load(i, k0 + kk < kdim);
    }
    la.advance();
    lb.advance();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4];
      float bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sm.a[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sm.b[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Decompose a flattened NHW row index into (image, row, column).
__device__ __forceinline__ void pixel_of(long long m, int h_dim, int w_dim,
                                         int& img, int& h, int& w) {
  const long long hw = static_cast<long long>(h_dim) * w_dim;
  img = static_cast<int>(m / hw);
  const int rem = static_cast<int>(m - img * hw);
  h = rem / w_dim;
  w = rem - h * w_dim;
}

__device__ __forceinline__ long long pixel_index(int img, int h, int w,
                                                 int h_dim, int w_dim) {
  return (static_cast<long long>(img) * h_dim + h) * w_dim + w;
}

// ---------------------------------------------------------------------------
// loaders
// ---------------------------------------------------------------------------

// A(m, k) = z(x[m, k]) over output rows m (Kernel J in f32; K-fast).
template <typename T, bool AFFINE, bool RELU>
struct ZRows {
  const T* x;
  const float* a;
  const float* b;
  int kdim;
  long long row[4];
  bool ok[4];
  int k;
  Affine f;
  __device__ ZRows(const T* x_, const float* a_, const float* b_, int m_dim,
                   int k_dim, int row0)
      : x(x_), a(a_), b(b_), kdim(k_dim), k(tile_k<true>(0)) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = row0 + tile_rc<true>(i);
      ok[i] = m < m_dim;
      row[i] = static_cast<long long>(m) * k_dim;
    }
    f = affine_of<AFFINE>(a, b, k < kdim ? k : 0);
  }
  __device__ float load(int i, bool valid) const {
    if (!valid || !ok[i]) return 0.f;
    return zval<T, AFFINE, RELU>(to_float(x[row[i] + k]), f);
  }
  __device__ void advance() {
    k += kBK;
    f = affine_of<AFFINE>(a, b, k < kdim ? k : 0);
  }
};

// A(m, (tap, k)) = z at the pixel of row m shifted by tap (dr - 1, dc - 1),
// zero outside the image: the halo is zero in z-space (Kernel L; K-fast).
template <typename T, bool AFFINE, bool RELU>
struct ZTaps {
  const T* x;
  const float* a;
  const float* b;
  int h_dim, w_dim, k_dim;
  int img[4], h[4], w[4];
  bool ok[4];
  int tap, k;
  Affine f;
  __device__ ZTaps(const T* x_, const float* a_, const float* b_, long long m_dim,
                   int h_, int w_, int k_, long long row0)
      : x(x_), a(a_), b(b_), h_dim(h_), w_dim(w_), k_dim(k_) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long m = row0 + tile_rc<true>(i);
      ok[i] = m < m_dim;
      pixel_of(ok[i] ? m : 0, h_dim, w_dim, img[i], h[i], w[i]);
    }
    const int t = tile_k<true>(0);
    tap = t / k_dim;
    k = t - tap * k_dim;
    f = affine_of<AFFINE>(a, b, k);
  }
  __device__ float load(int i, bool valid) const {
    if (!valid || !ok[i]) return 0.f;
    const int dr = tap / 3;
    const int dc = tap - 3 * dr;
    const int hh = h[i] + dr - 1;
    const int ww = w[i] + dc - 1;
    if (hh < 0 || hh >= h_dim || ww < 0 || ww >= w_dim) return 0.f;
    const long long p = pixel_index(img[i], hh, ww, h_dim, w_dim);
    return zval<T, AFFINE, RELU>(to_float(x[p * k_dim + k]), f);
  }
  __device__ void advance() {
    k += kBK;
    while (k >= k_dim) {
      k -= k_dim;
      ++tap;
    }
    f = affine_of<AFFINE>(a, b, k);
  }
};

// B(t, n) = w[t, n] of a [kdim, N] row-major weight (Kernels J and L;
// column-fast).
template <typename T>
struct WRows {
  const T* w;
  int n_dim;
  int n;
  long long t0;
  __device__ WRows(const T* w_, int n_, int col0)
      : w(w_), n_dim(n_), n(col0 + tile_rc<false>(0)), t0(tile_k<false>(0)) {}
  __device__ float load(int i, bool valid) const {
    if (!valid || n >= n_dim) return 0.f;
    return to_float(w[(t0 + 4 * i) * n_dim + n]);
  }
  __device__ void advance() { t0 += kBK; }
};

// A(m, n) = dy_eff(m, n) over output rows m (Kernel K's dx pass; N-fast).
template <typename T>
struct DyRows {
  const T* dy;
  const T* y;
  const float* c;
  const float* ds;
  int n_dim;
  long long row[4];
  bool ok[4];
  int n;
  Cot q;
  __device__ DyRows(const T* dy_, const T* y_, const float* c_,
                    const float* ds_, long long m_dim, int n_, long long row0)
      : dy(dy_), y(y_), c(c_), ds(ds_), n_dim(n_), n(tile_k<true>(0)) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long m = row0 + tile_rc<true>(i);
      ok[i] = m < m_dim;
      row[i] = m * n_dim;
    }
    q = cot_of(c, ds, n_dim, n < n_dim ? n : 0);
  }
  __device__ float load(int i, bool valid) const {
    if (!valid || !ok[i]) return 0.f;
    return dyc<T>(to_float(dy[row[i] + n]), to_float(y[row[i] + n]), q);
  }
  __device__ void advance() {
    n += kBK;
    q = cot_of(c, ds, n_dim, n < n_dim ? n : 0);
  }
};

// A(m, (tap, n)) = dy_eff at the pixel of row m shifted by (1 - dr, 1 - dc),
// zero outside the image: the transposed convolution (Kernel M's dx pass;
// N-fast).
template <typename T>
struct DyTaps {
  const T* dy;
  const T* y;
  const float* c;
  const float* ds;
  int h_dim, w_dim, n_dim;
  int img[4], h[4], w[4];
  bool ok[4];
  int tap, n;
  Cot q;
  __device__ DyTaps(const T* dy_, const T* y_, const float* c_,
                    const float* ds_, long long m_dim, int h_, int w_, int n_,
                    long long row0)
      : dy(dy_), y(y_), c(c_), ds(ds_), h_dim(h_), w_dim(w_), n_dim(n_) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long m = row0 + tile_rc<true>(i);
      ok[i] = m < m_dim;
      pixel_of(ok[i] ? m : 0, h_dim, w_dim, img[i], h[i], w[i]);
    }
    const int t = tile_k<true>(0);
    tap = t / n_dim;
    n = t - tap * n_dim;
    q = cot_of(c, ds, n_dim, n);
  }
  __device__ float load(int i, bool valid) const {
    if (!valid || !ok[i]) return 0.f;
    const int dr = tap / 3;
    const int dc = tap - 3 * dr;
    const int hh = h[i] + 1 - dr;
    const int ww = w[i] + 1 - dc;
    if (hh < 0 || hh >= h_dim || ww < 0 || ww >= w_dim) return 0.f;
    const long long idx = pixel_index(img[i], hh, ww, h_dim, w_dim) * n_dim + n;
    return dyc<T>(to_float(dy[idx]), to_float(y[idx]), q);
  }
  __device__ void advance() {
    n += kBK;
    while (n >= n_dim) {
      n -= n_dim;
      ++tap;
    }
    q = cot_of(c, ds, n_dim, n);
  }
};

// B((tap, n), k) = w[tap, k, n] of a [taps, K, N] weight: w transposed per
// tap (Kernels K and M's dx passes, taps 1 and 9; N-fast).
template <typename T>
struct WTaps {
  const T* w;
  int k_dim, n_dim;
  int kc[4];
  int tap, n;
  __device__ WTaps(const T* w_, int k_, int n_, int col0)
      : w(w_), k_dim(k_), n_dim(n_) {
#pragma unroll
    for (int i = 0; i < 4; ++i) kc[i] = col0 + tile_rc<true>(i);
    const int t = tile_k<true>(0);
    tap = t / n_dim;
    n = t - tap * n_dim;
  }
  __device__ float load(int i, bool valid) const {
    if (!valid || kc[i] >= k_dim) return 0.f;
    return to_float(
        w[(static_cast<long long>(tap) * k_dim + kc[i]) * n_dim + n]);
  }
  __device__ void advance() {
    n += kBK;
    while (n >= n_dim) {
      n -= n_dim;
      ++tap;
    }
  }
};

// A(k, m) = z at the pixel of row m shifted by (dr - 1, dc - 1) for one tap
// ((1, 1) is no shift: the 1x1 case), rows m of one chunk (the dW passes of
// Kernels K and M; channel-fast). Each of this thread's four rows steps 16
// rows a slice, carried as (image, row, column).
template <typename T, bool AFFINE, bool RELU>
struct ZCols {
  const T* x;
  const float* a;
  const float* b;
  int h_dim, w_dim, k_dim;
  int k;
  bool k_ok;
  int dr, dc;
  int img[4], h[4], w[4];
  Affine f;
  __device__ ZCols(const T* x_, const float* a_, const float* b_, int h_, int w_,
                   int k_, int row0, long long m_lo, int tap)
      : x(x_), a(a_), b(b_), h_dim(h_), w_dim(w_), k_dim(k_),
        k(row0 + tile_rc<false>(0)), dr(tap / 3), dc(tap % 3) {
    k_ok = k < k_dim;
    f = affine_of<AFFINE>(a, b, k_ok ? k : 0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pixel_of(m_lo + tile_k<false>(i), h_dim, w_dim, img[i], h[i], w[i]);
  }
  __device__ float load(int i, bool valid) const {
    if (!valid || !k_ok) return 0.f;
    const int hh = h[i] + dr - 1;
    const int ww = w[i] + dc - 1;
    if (hh < 0 || hh >= h_dim || ww < 0 || ww >= w_dim) return 0.f;
    const long long p = pixel_index(img[i], hh, ww, h_dim, w_dim);
    return zval<T, AFFINE, RELU>(to_float(x[p * k_dim + k]), f);
  }
  __device__ void advance() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] += kBK;
      while (w[i] >= w_dim) {
        w[i] -= w_dim;
        if (++h[i] >= h_dim) {
          h[i] = 0;
          ++img[i];
        }
      }
    }
  }
};

// B(m, n) = dy_eff(m, n), rows m of one chunk (the dW passes;
// column-fast).
template <typename T>
struct DyCols {
  const T* dy;
  const T* y;
  const float* c;
  const float* ds;
  int n_dim;
  int n;
  long long m0;
  Cot q;
  __device__ DyCols(const T* dy_, const T* y_, const float* c_,
                    const float* ds_, int n_, int col0, long long m_lo)
      : dy(dy_), y(y_), c(c_), ds(ds_), n_dim(n_),
        n(col0 + tile_rc<false>(0)), m0(m_lo + tile_k<false>(0)) {
    q = cot_of(c, ds, n_dim, n < n_dim ? n : 0);
  }
  __device__ float load(int i, bool valid) const {
    if (!valid || n >= n_dim) return 0.f;
    const long long idx = (m0 + 4 * i) * n_dim + n;
    return dyc<T>(to_float(dy[idx]), to_float(y[idx]), q);
  }
  __device__ void advance() { m0 += kBK; }
};

// ---------------------------------------------------------------------------
// epilogues
// ---------------------------------------------------------------------------

// Sum two per-thread column partials over the 16 row groups of the tile in
// a fixed order and write them as row `slot` of partial[*, 2, n_dim].
__device__ __forceinline__ void tile_column_sums(const float (&s0)[4],
                                                 const float (&s1)[4],
                                                 Shared& sm, float* partial,
                                                 long long slot, int n_dim,
                                                 int col0) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sm.red[ty][tx * 4 + j][0] = s0[j];
    sm.red[ty][tx * 4 + j][1] = s1[j];
  }
  __syncthreads();
  if (tid < kBN && col0 + tid < n_dim) {
    float t0 = 0.f;
    float t1 = 0.f;
    for (int r = 0; r < kThreads / 16; ++r) {
      t0 += sm.red[r][tid][0];
      t1 += sm.red[r][tid][1];
    }
    partial[(slot * 2) * n_dim + col0 + tid] = t0;
    partial[(slot * 2 + 1) * n_dim + col0 + tid] = t1;
  }
}

// Forward: y rounded to T, and the tile's shifted sums sum(y - c),
// sum((y - c)^2) over its valid rows, from the fp32 accumulator, as
// row block blockIdx.x of partial[*, 2, N].
template <typename T>
__device__ __forceinline__ void epilogue_fwd(const float (&acc)[4][4], T* y,
                                             const float* __restrict__ c,
                                             float* partial, long long m_dim,
                                             int n_dim, long long row0,
                                             int col0, Shared& sm) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float s0[4] = {0.f, 0.f, 0.f, 0.f};
  float s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = row0 + ty * 4 + i;
    if (m >= m_dim) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = col0 + tx * 4 + j;
      if (n >= n_dim) continue;
      store(&y[m * n_dim + n], acc[i][j]);
      const float d = acc[i][j] - c[n];
      s0[j] += d;
      s1[j] += d * d;
    }
  }
  tile_column_sums(s0, s1, sm, partial, blockIdx.x, n_dim, col0);
}

// dx pass: acc holds dz for rows m and input channels k. With the affine,
// dg = dz masked by pre = x * a + b > 0 (relu), dx = dg * a, and the tile's
// sum(dg * x), sum(dg) per channel go to row block blockIdx.x of
// partial[*, 2, K]; without it dx = dz.
template <typename T, bool AFFINE, bool RELU>
__device__ __forceinline__ void epilogue_dx(const float (&acc)[4][4],
                                            const T* __restrict__ x,
                                            const float* __restrict__ a,
                                            const float* __restrict__ b, T* dx,
                                            float* partial, long long m_dim,
                                            int k_dim, long long row0,
                                            int col0, Shared& sm) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float s0[4] = {0.f, 0.f, 0.f, 0.f};
  float s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = row0 + ty * 4 + i;
    if (m >= m_dim) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = col0 + tx * 4 + j;
      if (k >= k_dim) continue;
      const long long idx = m * k_dim + k;
      float out = acc[i][j];
      if (AFFINE) {
        const float xv = to_float(x[idx]);
        const float pre = __fadd_rn(__fmul_rn(xv, a[k]), b[k]);
        const float dg = (RELU && !(pre > 0.f)) ? 0.f : acc[i][j];
        out = __fmul_rn(dg, a[k]);
        s0[j] += dg * xv;
        s1[j] += dg;
      }
      store(&dx[idx], out);
    }
  }
  if (AFFINE) tile_column_sums(s0, s1, sm, partial, blockIdx.x, k_dim, col0);
}

// dW pass: acc is this chunk's share of dW[k, n] for one tap; written to
// out[k, n] (the chunk's and tap's slice of the partials).
__device__ __forceinline__ void epilogue_dw(const float (&acc)[4][4],
                                            float* out, int k_dim, int n_dim,
                                            int row0, int col0) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = row0 + ty * 4 + i;
    if (k >= k_dim) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = col0 + tx * 4 + j;
      if (n < n_dim) out[static_cast<long long>(k) * n_dim + n] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// the second pass: out[col] = sum over rows of part[row, col], in a fixed
// order (32 row groups, each summed in row order, then the groups in order):
// repeated runs are bitwise equal.
// ---------------------------------------------------------------------------

// (a template, so that every source that includes this header may define it)
template <typename F>
__global__ void __launch_bounds__(kReduceThreads)
column_sum_kernel(const F* __restrict__ part, F* __restrict__ out,
                  int rows, long long cols) {
  __shared__ F red[32][33];
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const long long col = static_cast<long long>(blockIdx.x) * 32 + tx;
  F s = 0.f;
  if (col < cols) {
#pragma unroll 4
    for (int r = ty; r < rows; r += 32) s += part[static_cast<long long>(r) * cols + col];
  }
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && col < cols) {
    F t = 0.f;
    for (int g = 0; g < 32; ++g) t += red[g][tx];
    out[col] = t;
  }
}

inline cudaError_t column_sum(const float* part, float* out, int rows,
                              long long cols, cudaStream_t stream) {
  const long long blocks = (cols + 31) / 32;
  column_sum_kernel<float><<<static_cast<unsigned>(blocks), kReduceThreads,
                             0, stream>>>(part, out, rows, cols);
  return cudaGetLastError();
}

inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// (affine, relu) -> one of the three instantiations of a launcher
template <template <typename, bool, bool> class L, typename T, typename Args>
inline cudaError_t dispatch_act(const Args& args, int affine, int relu,
                                cudaStream_t stream) {
  if (!affine) return L<T, false, false>::run(args, stream);
  return relu ? L<T, true, true>::run(args, stream)
              : L<T, true, false>::run(args, stream);
}

template <template <typename, bool, bool> class L, typename Args>
inline cudaError_t dispatch(const Args& args, int dtype, int affine, int relu,
                            cudaStream_t stream) {
  if (dtype == kBF16)
    return dispatch_act<L, __nv_bfloat16>(args, affine, relu, stream);
  if (dtype == kF16) return dispatch_act<L, __half>(args, affine, relu, stream);
  if (dtype == kF32) return dispatch_act<L, float>(args, affine, relu, stream);
  return cudaErrorInvalidValue;  // no other type
}

}  // namespace conv
}  // namespace apex

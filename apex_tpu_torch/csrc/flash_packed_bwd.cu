// Packed-QKV flash attention backward (Kernel F of the PyTorch port).
//
// Replaces: apex_tpu/ops/attention.py `_dqkv_packed_kernel` (:885),
// launched by `_run_bwd_packed` (:1009) through `pl.pallas_call` (:1030).
//
// Writes dqkv in the packed layout of qkv [s, b, G * (qpg + 2) * d] from
// qkv, do and o [s, b, H * d] and the forward's lse [b, H, s]. The
// algebra is `_recompute_p_ds` (:412): p = exp(scale * q k^T - lse) with
// masked scores at -1e30, so masked keys and rows with lse = 1e30 give
// p = 0 and contribute nothing; delta = rowsum(do * o); dp = do v^T,
// masked and rescaled by the dropout keep mask; ds = p * (dp - delta);
// dq = scale * ds k, dk = scale * ds^T q, dv = drop(p)^T do. q and k are
// rotated and rounded exactly as in the forward, and dq, dk are
// un-rotated in fp32 with -sin before the one rounding at the store
// (:937-953). The dropout mask is regenerated from the same hash.
//
// What does not carry over: the TPU kernel holds a whole (s, s) block of
// one cell in VMEM and accumulates dk/dv in registers across the group's
// query heads in one grid step. Here two passes split the work so no
// value is accumulated across blocks:
// - pass 1, one block per (64-row query tile, head, batch): delta for its
//   rows (written to a [b, H, s] fp32 scratch for pass 2) and dq, walking
//   the visible key tiles;
// - pass 2, one block per (64-row key tile, group, batch): dk and dv
//   accumulate in fp32 over the group's qpg query heads and their visible
//   query tiles.
// No atomics: every output element is written by one thread once, so
// repeated runs are bitwise equal.
//
// Bound on the H100: at GPT-2 124M training (b 8, 12 heads, s 1024, d 64,
// causal, bf16) the causal work is ~32 GFLOP (five products of 2 d per
// visible pair: q k^T, do v^T, ds k, ds^T q, p^T do; 33 us at the bf16
// tensor rate) against ~101 MB moved (30 us at 3.35 TB/s).
//
// Design: fp32 tiles in shared memory and fp32 FMA as in Kernel E; each
// thread owns a 4-row x (DMAX / 16)-column accumulator tile. Pass 1
// recomputes q k^T and do v^T once; pass 2 again (7 tile products in all
// against the algorithm's 5). No tensor cores yet.
#include "packed_attention.cuh"

namespace {

using namespace apex::packed;

template <int DMAX>
struct DqSmem {
  static constexpr int kRS = DMAX + 4;  // rows read by ty (broadcast)
  static constexpr int kCS = DMAX + 1;  // rows read by tx
  static constexpr int kSS = kBK + 1;
  static constexpr size_t floats = 2 * kBQ * kRS + 2 * kBK * kCS + kBQ * kSS + 2 * kBQ;
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_packed_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                       const T* __restrict__ out, const float* __restrict__ lse,
                       float* __restrict__ delta, T* __restrict__ dqkv,
                       const Opts opt) {
  using S = DqSmem<DMAX>;
  constexpr int kCols = DMAX / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                    // [kBQ][kRS], reused for dq at the end
  float* dOs = Qs + kBQ * S::kRS;      // [kBQ][kRS]
  float* Ks = dOs + kBQ * S::kRS;      // [kBK][kCS]
  float* Vs = Ks + kBK * S::kCS;       // [kBK][kCS]
  float* dSs = Vs + kBK * S::kCS;      // [kBQ][kSS]
  float* lse_s = dSs + kBQ * S::kSS;
  float* delta_s = lse_s + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q_start = blockIdx.x * kBQ;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int g = hh / opt.qpg;
  const int j = hh % opt.qpg;
  const int d = opt.d;
  const int heads = opt.groups * opt.qpg;
  const Layout lay(opt, bb);
  const bool drop = opt.seed != nullptr;
  const unsigned seed = drop ? static_cast<unsigned>(opt.seed[0]) : 0u;
  const unsigned cmb = combo(bb, hh);
  const long long stat_base = (static_cast<long long>(bb) * heads + hh) * opt.s;

  for (int idx = tid; idx < kBQ * DMAX; idx += kThreads) {
    const int r = idx / DMAX;
    const int c = idx % DMAX;
    const int row = q_start + r;
    float qv = 0.f;
    float dov = 0.f;
    if (row < opt.s && c < d) {
      qv = load_rope(qkv + lay.q(g, j, row, d), opt, row, c);
      dov = apex::to_float(dout[out_index(opt, bb, hh, row) + c]);
    }
    Qs[r * S::kRS + c] = qv;
    dOs[r * S::kRS + c] = dov;
  }
  // delta = rowsum(do * o): one warp per row
  for (int r = warp; r < kBQ; r += kThreads / 32) {
    const int row = q_start + r;
    float part = 0.f;
    if (row < opt.s) {
      const long long base = out_index(opt, bb, hh, row);
      for (int c = lane; c < d; c += 32)
        part += apex::to_float(dout[base + c]) * apex::to_float(out[base + c]);
    }
    part = apex::warp_sum(part);
    if (lane == 0) {
      delta_s[r] = part;
      lse_s[r] = row < opt.s ? lse[stat_base + row] : 0.f;
      if (row < opt.s) delta[stat_base + row] = part;
    }
  }

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  const int kvl = opt.kv_lengths != nullptr ? opt.kv_lengths[bb] : opt.s;
  int j_first, j_last;
  key_tiles(opt, kvl, q_start, &j_first, &j_last);
  __syncthreads();

  for (int jt = j_first; jt <= j_last; ++jt) {
    const int k_start = jt * kBK;
    for (int idx = tid; idx < kBK * DMAX; idx += kThreads) {
      const int r = idx / DMAX;
      const int c = idx % DMAX;
      const int row = k_start + r;
      float kval = 0.f;
      float vval = 0.f;
      if (row < opt.s && c < d) {
        kval = load_rope(qkv + lay.k(g, opt.qpg, row, d), opt, row, c);
        vval = apex::to_float(qkv[lay.v(g, opt.qpg, row, d) + c]);
      }
      Ks[r * S::kCS + c] = kval;
      Vs[r * S::kCS + c] = vval;
    }
    __syncthreads();

    float sc[4][4];
    float dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sc[i][jj] = dp[i][jj] = 0.f;
    for (int c = 0; c < DMAX; ++c) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty * 4 + i) * S::kRS + c];
        dov[i] = dOs[(ty * 4 + i) * S::kRS + c];
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        kv[jj] = Ks[(tx + 16 * jj) * S::kCS + c];
        vv[jj] = Vs[(tx + 16 * jj) * S::kCS + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          sc[i][jj] = fmaf(qv[i], kv[jj], sc[i][jj]);
          dp[i][jj] = fmaf(dov[i], vv[jj], dp[i][jj]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int row = q_start + r;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = k_start + tx + 16 * jj;
        float ds = 0.f;
        if (visible(opt, kvl, row, col)) {
          const float p = expf(sc[i][jj] * opt.scale - lse_s[r]);
          float dpv = dp[i][jj];
          if (drop)
            dpv = hash_keep(seed, cmb, row, col, opt.keep_thresh)
                      ? dpv * opt.inv_keep : 0.f;
          ds = p * (dpv - delta_s[r]);
        }
        dSs[r * S::kSS + tx + 16 * jj] = ds;
      }
    }
    __syncthreads();

    // dq += ds k
    for (int jj = 0; jj < kBK; ++jj) {
      float dsv[4];
      float kv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty * 4 + i) * S::kSS + jj];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = Ks[jj * S::kCS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
    __syncthreads();
  }

  // dq = scale * acc, un-rotated in fp32 (rows mix columns c and c +- rot/2,
  // so the tile goes through shared memory), rounded once
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      Qs[(ty * 4 + i) * S::kRS + tx + 16 * c] = acc[i][c] * opt.scale;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int row = q_start + r;
    if (row >= opt.s) continue;
    T* dst = dqkv + lay.q(g, j, row, d);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < d) apex::store(&dst[col], unrotate(Qs + r * S::kRS, opt, row, col));
    }
  }
}

template <int DMAX>
struct DkvSmem {
  static constexpr int kRS = DMAX + 4;  // K, V: rows read by ty
  static constexpr int kCS = DMAX + 1;  // Q, dO: rows read by tx
  static constexpr int kSS = kBQ + 1;
  static constexpr size_t floats = 2 * kBK * kRS + 2 * kBQ * kCS + 2 * kBK * kSS + 2 * kBQ;
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_packed_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dqkv,
                        const Opts opt) {
  using S = DkvSmem<DMAX>;
  constexpr int kCols = DMAX / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                   // [kBK][kRS], reused for dk at the end
  float* Vs = Ks + kBK * S::kRS;      // [kBK][kRS]
  float* Qs = Vs + kBK * S::kRS;      // [kBQ][kCS]
  float* dOs = Qs + kBQ * S::kCS;     // [kBQ][kCS]
  float* Ps = dOs + kBQ * S::kCS;     // dropped p^T [kBK][kSS]
  float* dSs = Ps + kBK * S::kSS;     // ds^T [kBK][kSS]
  float* lse_s = dSs + kBK * S::kSS;
  float* delta_s = lse_s + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int k_start = blockIdx.x * kBK;
  const int g = blockIdx.y;
  const int bb = blockIdx.z;
  const int d = opt.d;
  const int heads = opt.groups * opt.qpg;
  const Layout lay(opt, bb);
  const bool drop = opt.seed != nullptr;
  const unsigned seed = drop ? static_cast<unsigned>(opt.seed[0]) : 0u;

  for (int idx = tid; idx < kBK * DMAX; idx += kThreads) {
    const int r = idx / DMAX;
    const int c = idx % DMAX;
    const int row = k_start + r;
    float kval = 0.f;
    float vval = 0.f;
    if (row < opt.s && c < d) {
      kval = load_rope(qkv + lay.k(g, opt.qpg, row, d), opt, row, c);
      vval = apex::to_float(qkv[lay.v(g, opt.qpg, row, d) + c]);
    }
    Ks[r * S::kRS + c] = kval;
    Vs[r * S::kRS + c] = vval;
  }

  float dk[4][kCols];
  float dv[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int kvl = opt.kv_lengths != nullptr ? opt.kv_lengths[bb] : opt.s;
  int i_first, i_last;
  query_tiles(opt, kvl, k_start, &i_first, &i_last);

  for (int jh = 0; jh < opt.qpg; ++jh) {
    const int hh = g * opt.qpg + jh;
    const unsigned cmb = combo(bb, hh);
    const long long stat_base = (static_cast<long long>(bb) * heads + hh) * opt.s;
    for (int it = i_first; it <= i_last; ++it) {
      const int q_start = it * kBQ;
      __syncthreads();  // the previous tile's readers are done
      for (int idx = tid; idx < kBQ * DMAX; idx += kThreads) {
        const int r = idx / DMAX;
        const int c = idx % DMAX;
        const int row = q_start + r;
        float qv = 0.f;
        float dov = 0.f;
        if (row < opt.s && c < d) {
          qv = load_rope(qkv + lay.q(g, jh, row, d), opt, row, c);
          dov = apex::to_float(dout[out_index(opt, bb, hh, row) + c]);
        }
        Qs[r * S::kCS + c] = qv;
        dOs[r * S::kCS + c] = dov;
      }
      if (tid < kBQ) {
        const int row = q_start + tid;
        lse_s[tid] = row < opt.s ? lse[stat_base + row] : 0.f;
        delta_s[tid] = row < opt.s ? delta[stat_base + row] : 0.f;
      }
      __syncthreads();

      // transposed tile: key rows ty * 4 + i, query columns tx + 16 jj
      float sc[4][4];
      float dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sc[i][jj] = dp[i][jj] = 0.f;
      for (int c = 0; c < DMAX; ++c) {
        float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = Ks[(ty * 4 + i) * S::kRS + c];
          vv[i] = Vs[(ty * 4 + i) * S::kRS + c];
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          qv[jj] = Qs[(tx + 16 * jj) * S::kCS + c];
          dov[jj] = dOs[(tx + 16 * jj) * S::kCS + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            sc[i][jj] = fmaf(kv[i], qv[jj], sc[i][jj]);
            dp[i][jj] = fmaf(vv[i], dov[jj], dp[i][jj]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = ty * 4 + i;
        const int col = k_start + kr;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int qc = tx + 16 * jj;
          const int row = q_start + qc;
          float pd = 0.f;
          float ds = 0.f;
          if (visible(opt, kvl, row, col)) {
            const float p = expf(sc[i][jj] * opt.scale - lse_s[qc]);
            float dpv = dp[i][jj];
            pd = p;
            if (drop) {
              const bool keep = hash_keep(seed, cmb, row, col, opt.keep_thresh);
              pd = keep ? p * opt.inv_keep : 0.f;
              dpv = keep ? dpv * opt.inv_keep : 0.f;
            }
            ds = p * (dpv - delta_s[qc]);
          }
          Ps[kr * S::kSS + qc] = pd;
          dSs[kr * S::kSS + qc] = ds;
        }
      }
      __syncthreads();

      // dv += drop(p)^T do, dk += ds^T q
      for (int qc = 0; qc < kBQ; ++qc) {
        float pv[4], dsv[4], dov[kCols], qv[kCols];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[(ty * 4 + i) * S::kSS + qc];
          dsv[i] = dSs[(ty * 4 + i) * S::kSS + qc];
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          dov[c] = dOs[qc * S::kCS + tx + 16 * c];
          qv[c] = Qs[qc * S::kCS + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            dv[i][c] = fmaf(pv[i], dov[c], dv[i][c]);
            dk[i][c] = fmaf(dsv[i], qv[c], dk[i][c]);
          }
      }
    }
  }

  // dk = scale * acc, un-rotated in fp32 through shared memory; dv as is
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      Ks[(ty * 4 + i) * S::kRS + tx + 16 * c] = dk[i][c] * opt.scale;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int row = k_start + r;
    if (row >= opt.s) continue;
    T* dk_dst = dqkv + lay.k(g, opt.qpg, row, d);
    T* dv_dst = dqkv + lay.v(g, opt.qpg, row, d);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < d) {
        apex::store(&dk_dst[col], unrotate(Ks + r * S::kRS, opt, row, col));
        apex::store(&dv_dst[col], dv[i][c]);
      }
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* qkv, const void* dout, const void* out,
                   const float* lse, float* delta, void* dqkv, const Opts& opt,
                   cudaStream_t stream) {
  auto dq_kernel = flash_packed_dq_kernel<T, DMAX>;
  auto dkv_kernel = flash_packed_dkv_kernel<T, DMAX>;
  const size_t dq_smem = DqSmem<DMAX>::floats * sizeof(float);
  const size_t dkv_smem = DkvSmem<DMAX>::floats * sizeof(float);
  cudaError_t err = apex::allow_smem(dq_kernel, dq_smem);
  if (err != cudaSuccess) return err;
  err = apex::allow_smem(dkv_kernel, dkv_smem);
  if (err != cudaSuccess) return err;
  const dim3 dq_grid((opt.s + kBQ - 1) / kBQ, opt.groups * opt.qpg, opt.b);
  dq_kernel<<<dq_grid, kThreads, dq_smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout),
      static_cast<const T*>(out), lse, delta, static_cast<T*>(dqkv), opt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 dkv_grid((opt.s + kBK - 1) / kBK, opt.groups, opt.b);
  dkv_kernel<<<dkv_grid, kThreads, dkv_smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dqkv), opt);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* qkv, const void* dout, const void* out,
                     const float* lse, float* delta, void* dqkv,
                     const Opts& opt, cudaStream_t stream) {
  if (opt.d <= 64) return launch<T, 64>(qkv, dout, out, lse, delta, dqkv, opt, stream);
  if (opt.d <= 128) return launch<T, 128>(qkv, dout, out, lse, delta, dqkv, opt, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// qkv and dqkv [s, b, groups * (qpg + 2) * d]; dout and out
// [s, b, groups * qpg * d]; lse and the delta scratch [b, groups * qpg, s]
// fp32; all contiguous. kv_lengths, cos/sin and seed as in
// apex_flash_packed_fwd, and the same values the forward was given.
extern "C" int apex_flash_packed_bwd(const void* qkv, const void* dout,
                                     const void* out, const void* lse,
                                     void* delta, void* dqkv,
                                     const void* kv_lengths, const void* cos,
                                     const void* sin, const void* seed,
                                     void* stream, int s, int b, int groups,
                                     int qpg, int d, float scale, int causal,
                                     int window, int rot,
                                     unsigned keep_thresh, float inv_keep,
                                     int dtype) {
  const Opts opt{static_cast<const int*>(kv_lengths),
                 static_cast<const float*>(cos), static_cast<const float*>(sin),
                 static_cast<const int*>(seed), s, b, groups, qpg, d, scale,
                 causal, window, rot, keep_thresh, inv_keep};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaError_t err =
      dtype == apex::kBF16
          ? launch_d<__nv_bfloat16>(qkv, dout, out, l, dl, dqkv, opt, st)
          : launch_d<float>(qkv, dout, out, l, dl, dqkv, opt, st);
  return static_cast<int>(err);
}

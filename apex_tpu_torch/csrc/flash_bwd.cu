// Flash attention backward over [batch, heads, seq, head_dim] (Kernel I of
// the PyTorch port).
//
// Replaces the three TPU backward kernels behind apex_tpu/ops/attention.py
// `_flash_vjp_bwd` (:1486) and `_run_bwd` (:1329): the two-pass
// `_dq_kernel` (:438) + `_dkv_kernel` (:476) (`pl.pallas_call` :1391 and
// :1420), the one-pass `_dqkv_fused_kernel` (:529, :632) that accumulates dq
// through an aliased buffer, and the single-block `_dqkv_single_kernel`
// (:669, :1292). The three compute one function and differ only in how the
// TPU's sequential grid is tiled, so one design covers them.
//
// Semantics kept (`_recompute_p_ds` :412, the kernels' products :461,
// :508-513): p = exp(scale * q k^T - lse) in fp32, with masked scores at
// -1e30, so masked keys and rows whose lse is 1e30 (no visible key) give
// p = 0 and zero gradients; delta = rowsum(do * o) in fp32 from o and do as
// stored (:1494); dp = do v^T; ds = p * (dp - delta); dq = scale * ds k with
// ds rounded to k's type, dk = scale * ds^T q with ds rounded to q's type,
// dv = p^T do with p rounded to do's type; fp32 accumulation and one
// rounding at the store. Masks exactly as `_mask_block` (:77): keys below
// the batch row's kv_length, causal with the query offset sk - sq, and the
// sliding window. Query head h reads key/value head h / (H / KVH); dk and dv
// sum the group's query heads in fp32 before the one rounding.
//
// What does not carry over: the TPU kernels carry dq or dk/dv in scratch
// across sequential grid steps, or read-modify-write dq through an aliased
// output. Blocks on the card run in parallel, so two passes split the work,
// as Kernel F does, and no value is accumulated across blocks:
// - pass 1, one block per (64-row query tile, head, batch): delta for its
//   rows (kept in an fp32 [b, H, sq] scratch for pass 2) and dq, walking
//   the visible key tiles;
// - pass 2, one block per (64-row key tile, kv head, batch): dk and dv over
//   the group's query heads and their visible query tiles.
// No atomics: every output element is written once by one thread, so two
// runs are bitwise equal.
//
// Bound on the H100: at the T5-base cross-attention of training (b 16,
// 12 heads, 114 queries over 512 encoder keys, d 64, bf16) it moves
// q, o, do, dq (11.2 MB) and k, v, dk, dv (50.3 MB): ~18 us at 3.35 TB/s,
// against ~7 GFLOP (five products of 2 d per visible pair), ~7 us at the
// bf16 tensor rate. Bytes bound it.
//
// Design: fp32 tiles in shared memory and fp32 FMA, each thread owning a
// 4-row x (DMAX / 16)-column accumulator tile, as in Kernels B and F. Pass 1
// computes q k^T and do v^T once, pass 2 again (seven tile products against
// the algorithm's five). No tensor cores yet.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;   // query rows per tile
constexpr int kBK = 64;   // key rows per tile
constexpr int kThreads = 256;

struct Args {
  const int* kv_lengths;  // [b] int32, or null
  int b, h, kvh, sq, sk, d;
  float scale;
  int causal;
  int window;  // 0 = no sliding window
};

// Is key `col` visible to query `row` (`_mask_block` with q_off = sk - sq)?
__device__ __forceinline__ bool visible(const Args& a, int kvl, int row, int col) {
  const int row_g = row + a.sk - a.sq;
  bool ok = row < a.sq && col < a.sk && col < kvl;
  if (a.causal) ok = ok && col <= row_g;
  if (a.window > 0) ok = ok && col > row_g - a.window;
  return ok;
}

// Key tiles [first, last] with a visible column for query rows
// [q_start, q_start + kBQ); last < first when there is none.
__device__ __forceinline__ void key_tiles(const Args& a, int kvl, int q_start,
                                          int* first, int* last) {
  const int q_off = a.sk - a.sq;
  const int last_row = min(q_start + kBQ, a.sq) - 1;
  int k_end = min(a.sk, kvl);
  if (a.causal) k_end = min(k_end, last_row + q_off + 1);
  const int k_begin = a.window > 0 ? max(0, q_start + q_off - a.window + 1) : 0;
  *first = k_begin / kBK;
  *last = k_end > k_begin ? (k_end - 1) / kBK : *first - 1;
}

// Query tiles [first, last] with a row that sees a key of
// [k_start, k_start + kBK); last < first when there is none.
__device__ __forceinline__ void query_tiles(const Args& a, int kvl, int k_start,
                                            int* first, int* last) {
  const int q_off = a.sk - a.sq;
  const int q_begin = a.causal ? max(0, k_start - q_off) : 0;
  int q_end = a.sq;  // exclusive
  if (a.window > 0) q_end = min(q_end, k_start + kBK - 1 - q_off + a.window);
  *first = q_begin / kBQ;
  *last = (k_start < min(kvl, a.sk) && q_end > q_begin) ? (q_end - 1) / kBQ
                                                         : *first - 1;
}

template <int DMAX>
struct DqSmem {
  static constexpr int kRS = DMAX + 4;  // rows read by ty (broadcast)
  static constexpr int kCS = DMAX + 1;  // rows read by tx
  static constexpr int kSS = kBK + 1;
  static constexpr size_t floats = 2 * kBQ * kRS + 2 * kBK * kCS + kBQ * kSS + 2 * kBQ;
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ out,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq,
                    const Args a) {
  using S = DqSmem<DMAX>;
  constexpr int kCols = DMAX / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                    // [kBQ][kRS]
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
  const int d = a.d;
  const int kv_head = hh / (a.h / a.kvh);
  const long long row_base = (static_cast<long long>(bb) * a.h + hh) * a.sq;
  const long long q_base = row_base * d;
  const long long kv_base = (static_cast<long long>(bb) * a.kvh + kv_head) * a.sk * d;

  for (int idx = tid; idx < kBQ * DMAX; idx += kThreads) {
    const int r = idx / DMAX;
    const int c = idx % DMAX;
    const int row = q_start + r;
    float qv = 0.f;
    float dov = 0.f;
    if (row < a.sq && c < d) {
      const long long off = q_base + static_cast<long long>(row) * d + c;
      qv = apex::to_float(q[off]);
      dov = apex::to_float(dout[off]);
    }
    Qs[r * S::kRS + c] = qv;
    dOs[r * S::kRS + c] = dov;
  }
  // delta = rowsum(do * o): one warp per row
  for (int r = warp; r < kBQ; r += kThreads / 32) {
    const int row = q_start + r;
    float part = 0.f;
    if (row < a.sq) {
      const long long base = q_base + static_cast<long long>(row) * d;
      for (int c = lane; c < d; c += 32)
        part += apex::to_float(dout[base + c]) * apex::to_float(out[base + c]);
    }
    part = apex::warp_sum(part);
    if (lane == 0) {
      delta_s[r] = part;
      lse_s[r] = row < a.sq ? lse[row_base + row] : 0.f;
      if (row < a.sq) delta[row_base + row] = part;
    }
  }

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  const int kvl = a.kv_lengths != nullptr ? a.kv_lengths[bb] : a.sk;
  int j_first, j_last;
  key_tiles(a, kvl, q_start, &j_first, &j_last);
  __syncthreads();

  for (int jt = j_first; jt <= j_last; ++jt) {
    const int k_start = jt * kBK;
    for (int idx = tid; idx < kBK * DMAX; idx += kThreads) {
      const int r = idx / DMAX;
      const int c = idx % DMAX;
      const int row = k_start + r;
      float kval = 0.f;
      float vval = 0.f;
      if (row < a.sk && c < d) {
        const long long off = kv_base + static_cast<long long>(row) * d + c;
        kval = apex::to_float(k[off]);
        vval = apex::to_float(v[off]);
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
        if (visible(a, kvl, row, col)) {
          const float p = expf(sc[i][jj] * a.scale - lse_s[r]);
          ds = apex::round_to(p * (dp[i][jj] - delta_s[r]), static_cast<T*>(nullptr));
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_start + ty * 4 + i;
    if (row >= a.sq) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < d)
        apex::store(&dq[q_base + static_cast<long long>(row) * d + col], acc[i][c] * a.scale);
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
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, const Args a) {
  using S = DkvSmem<DMAX>;
  constexpr int kCols = DMAX / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                   // [kBK][kRS]
  float* Vs = Ks + kBK * S::kRS;      // [kBK][kRS]
  float* Qs = Vs + kBK * S::kRS;      // [kBQ][kCS]
  float* dOs = Qs + kBQ * S::kCS;     // [kBQ][kCS]
  float* Ps = dOs + kBQ * S::kCS;     // p^T [kBK][kSS]
  float* dSs = Ps + kBK * S::kSS;     // ds^T [kBK][kSS]
  float* lse_s = dSs + kBK * S::kSS;
  float* delta_s = lse_s + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int k_start = blockIdx.x * kBK;
  const int kv_head = blockIdx.y;
  const int bb = blockIdx.z;
  const int d = a.d;
  const int group = a.h / a.kvh;
  const long long kv_base = (static_cast<long long>(bb) * a.kvh + kv_head) * a.sk * d;

  for (int idx = tid; idx < kBK * DMAX; idx += kThreads) {
    const int r = idx / DMAX;
    const int c = idx % DMAX;
    const int row = k_start + r;
    float kval = 0.f;
    float vval = 0.f;
    if (row < a.sk && c < d) {
      const long long off = kv_base + static_cast<long long>(row) * d + c;
      kval = apex::to_float(k[off]);
      vval = apex::to_float(v[off]);
    }
    Ks[r * S::kRS + c] = kval;
    Vs[r * S::kRS + c] = vval;
  }

  float dka[4][kCols];
  float dva[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dka[i][c] = dva[i][c] = 0.f;

  const int kvl = a.kv_lengths != nullptr ? a.kv_lengths[bb] : a.sk;
  int i_first, i_last;
  query_tiles(a, kvl, k_start, &i_first, &i_last);

  for (int jh = 0; jh < group; ++jh) {
    const int hh = kv_head * group + jh;
    const long long row_base = (static_cast<long long>(bb) * a.h + hh) * a.sq;
    const long long q_base = row_base * d;
    for (int it = i_first; it <= i_last; ++it) {
      const int q_start = it * kBQ;
      __syncthreads();  // the previous tile's readers are done
      for (int idx = tid; idx < kBQ * DMAX; idx += kThreads) {
        const int r = idx / DMAX;
        const int c = idx % DMAX;
        const int row = q_start + r;
        float qv = 0.f;
        float dov = 0.f;
        if (row < a.sq && c < d) {
          const long long off = q_base + static_cast<long long>(row) * d + c;
          qv = apex::to_float(q[off]);
          dov = apex::to_float(dout[off]);
        }
        Qs[r * S::kCS + c] = qv;
        dOs[r * S::kCS + c] = dov;
      }
      if (tid < kBQ) {
        const int row = q_start + tid;
        lse_s[tid] = row < a.sq ? lse[row_base + row] : 0.f;
        delta_s[tid] = row < a.sq ? delta[row_base + row] : 0.f;
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
          float pr = 0.f;
          float ds = 0.f;
          if (visible(a, kvl, row, col)) {
            const float p = expf(sc[i][jj] * a.scale - lse_s[qc]);
            pr = apex::round_to(p, static_cast<T*>(nullptr));
            ds = apex::round_to(p * (dp[i][jj] - delta_s[qc]), static_cast<T*>(nullptr));
          }
          Ps[kr * S::kSS + qc] = pr;
          dSs[kr * S::kSS + qc] = ds;
        }
      }
      __syncthreads();

      // dv += p^T do, dk += ds^T q
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
            dva[i][c] = fmaf(pv[i], dov[c], dva[i][c]);
            dka[i][c] = fmaf(dsv[i], qv[c], dka[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k_start + ty * 4 + i;
    if (row >= a.sk) continue;
    const long long base = kv_base + static_cast<long long>(row) * d;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < d) {
        apex::store(&dk[base + col], dka[i][c] * a.scale);
        apex::store(&dv[base + col], dva[i][c]);
      }
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, const Args& a,
                   cudaStream_t stream) {
  auto dq_kernel = flash_bwd_dq_kernel<T, DMAX>;
  auto dkv_kernel = flash_bwd_dkv_kernel<T, DMAX>;
  const size_t dq_smem = DqSmem<DMAX>::floats * sizeof(float);
  const size_t dkv_smem = DkvSmem<DMAX>::floats * sizeof(float);
  cudaError_t err = apex::allow_smem(dq_kernel, dq_smem);
  if (err != cudaSuccess) return err;
  err = apex::allow_smem(dkv_kernel, dkv_smem);
  if (err != cudaSuccess) return err;
  const dim3 dq_grid((a.sq + kBQ - 1) / kBQ, a.h, a.b);
  dq_kernel<<<dq_grid, kThreads, dq_smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(out),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 dkv_grid((a.sk + kBK - 1) / kBK, a.kvh, a.b);
  dkv_kernel<<<dkv_grid, kThreads, dkv_smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* out, const void* dout, const float* lse,
                     float* delta, void* dq, void* dk, void* dv, const Args& a,
                     cudaStream_t stream) {
  if (a.d <= 64)
    return launch<T, 64>(q, k, v, out, dout, lse, delta, dq, dk, dv, a, stream);
  if (a.d <= 128)
    return launch<T, 128>(q, k, v, out, dout, lse, delta, dq, dk, dv, a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, o, do and dq [b, h, sq, d]; k, v, dk and dv [b, kvh, sk, d]; lse and
// the delta scratch [b, h, sq] fp32; all contiguous, one element type.
// kv_lengths [b] int32 or null; window 0 = none. lse is the forward's
// (Kernel B), 1e30 on a row that sees no key.
extern "C" int apex_flash_bwd(const void* q, const void* k, const void* v,
                              const void* out, const void* dout,
                              const void* lse, void* delta, void* dq,
                              void* dk, void* dv, const void* kv_lengths,
                              void* stream, int b, int h, int kvh, int sq,
                              int sk, int d, float scale, int causal,
                              int window, int dtype) {
  const Args a{static_cast<const int*>(kv_lengths), b, h, kvh, sq, sk, d,
               scale, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const cudaError_t err =
      dtype == apex::kBF16
          ? launch_d<__nv_bfloat16>(q, k, v, out, dout, l, dl, dq, dk, dv, a, st)
          : launch_d<float>(q, k, v, out, dout, l, dl, dq, dk, dv, a, st);
  return static_cast<int>(err);
}

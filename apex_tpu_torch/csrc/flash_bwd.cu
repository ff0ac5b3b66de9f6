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
// rounding at the store. Masks exactly as `_mask_block` (:77), at global
// positions as Kernel B's (flash_fwd.cu): keys below the batch row's
// kv_length, causal with the query offset q_start - k_start (sk - sq by
// default), and the sliding window. A chunk of a context-parallel ring
// (`flash_chunk_bwd` :1616) passes its offsets and the global lse and
// delta (delta_given: rowsum(do * o) of the ring's merged o, which the
// chunk's own o would not give), and the delta prep is skipped. Query
// head h reads key/value head h / (H / KVH); dk and dv sum the group's
// query heads in fp32 before the one rounding.
//
// What does not carry over: the TPU kernels carry dq or dk/dv in scratch
// across sequential grid steps, or read-modify-write dq through an aliased
// output. Blocks on the card run in parallel, so separate passes split the
// work, as Kernel F does, and no value is accumulated across blocks. No
// atomics: every output element is written once by one thread, so two
// runs are bitwise equal.
//
// Bound on the H100: at the T5-base cross-attention of training (b 16,
// 12 heads, 114 queries over 512 encoder keys, d 64, bf16, kv_lengths) it
// moves q, o, do, dq and the K/V rows the lengths leave (with dk and dv
// written whole) in ~56 MB, ~17 us at 3.35 TB/s, against ~3 GFLOP (five
// products of 2 d per visible pair), ~3 us at the bf16 tensor rate. Bytes
// bound it.
//
// bf16 and fp16 (the paths the models train on; one template over the
// 16-bit type T, apex::Half16<T> giving the pair packing and the mma.sync
// opcode, as in Kernel F), Kernel F's three launches
// (flash_packed_bwd.cu) over the 4D layout, on the pieces of
// flash_mma.cuh:
// - delta prep: delta = rowsum(do * o) in fp32 into the [b, H, sq]
//   scratch (flash::delta_kernel, 16-byte loads); none where the caller
//   gives delta;
// - dk/dv pass, one block of 4 warps per (kv head, batch, 64-key tile).
//   Each warp owns 16 keys: K and V come in once by cp.async and stay in
//   shared memory. The group's H / KVH query heads (their own [sq, d]
//   slices) and their visible 64-query tiles stream through a 3-stage
//   cp.async ring with their lse and delta rows. S^T = K Q^T and dP^T =
//   V dO^T on mma.sync m16n8k16 (T in, fp32 out), p = exp(scale s -
//   lse) on the SFU, masks only on tiles that cross the diagonal, a
//   length, the window's edge, sq or sk (flash::tile_cover with the
//   q_off offset), tiles a warp sees nothing of skipped. p and ds are
//   rounded to T straight into A fragments (flash::fragment16), and
//   dV += P^T dO, dK += dS^T Q take dO and Q as B fragments by
//   ldmatrix.trans from the same stage. dk and dv are summed in fp32
//   across the group's heads and tiles by the tensor cores and rounded
//   once; key tiles past kv_length or seen by no query write zeros.
// - dq pass, one block of 4 warps per (head, batch, 64-query tile), the
//   heaviest causal tiles first: Q and dO go into A fragments once, K and
//   V 64-key tiles come through the ring; S = Q K^T and dP = dO V^T on
//   mma.sync, then ds rounded to T as A fragments and dq += dS K with K
//   by ldmatrix.trans from the same tile; dq is scaled and rounded once.
// Past d 128 (DMAX 256) both passes split each strip's output columns over
// two warps, as Kernel F does (flash_mma.cuh Cols); past 256 (DMAX 512)
// over four, with Kernel F's 32-key and 32-query tiles.
// Registers are capped at 168 a thread at d <= 64 so that three blocks fit
// an SM, as in Kernel F. Seven tile products a visible pair (q k^T and
// do v^T in both passes) in place of the algorithm's five, for no atomics.
// In fp16 the roundings keep fp16's subnormals (a p below 2^-14, as the
// JAX kernel keeps it), and a ds past 65504 rounds to inf, as the JAX
// kernel's cast does, so an overflow under a large loss scale shows where
// the plain version's does.
//
// f32 (checks only; TF32 would miss their atol of 1e-4), two launches of
// fp32 tiles in shared memory and fp32 FMA, each thread owning a 4-row x
// (DMAX / 16)-column accumulator tile (2 rows in 32-row tiles at DMAX
// 256, to fit the 227 KB of shared memory; 1 row in 16-row tiles walking
// 32-row tiles at 512):
// - pass 1, one block per (64-row query tile, head, batch): delta for its
//   rows (kept in an fp32 [b, H, sq] scratch for pass 2) and dq, walking
//   the visible key tiles;
// - pass 2, one block per (64-row key tile, kv head, batch): dk and dv over
//   the group's query heads and their visible query tiles.
#include <type_traits>

#include "flash_mma.cuh"

namespace {

using namespace apex::packed;  // kBQ, kBK, kThreads, kNeg, Mask, tiles
namespace flash = apex::flash;
namespace ring = apex::ring;

struct Args {
  const int* kv_lengths;  // [b] int32, or null
  int b, h, kvh, d;
  float scale;
  Mask mask;
  int delta_given;  // pass 1 reads delta instead of forming it from o
};

// BR: the rows of the block's own tile (queries in pass 1, keys in pass
// 2): 64, 32 at DMAX 256 and 16 at 512, where larger tiles would not fit
// the 227 KB of shared memory; each thread owns BR / 16 of them. BO: the
// rows of the tiles it walks (keys in pass 1, queries in pass 2), 64, or
// 32 at DMAX 512; each thread owns BO / 16 of a score tile's columns.
template <int DMAX, int BR, int BO>
struct DqSmem {
  static constexpr int kRS = DMAX + 4;  // rows read by ty (broadcast)
  static constexpr int kCS = DMAX + 1;  // rows read by tx
  static constexpr int kSS = BO + 1;
  static constexpr size_t floats = 2 * BR * kRS + 2 * BO * kCS + BR * kSS + 2 * BR;
  static_assert(floats * 4 <= 232448, "one block fits an SM");
};

template <int DMAX, int BR, int BO>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ out,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, float* __restrict__ dq,
                    const Args a) {
  using S = DqSmem<DMAX, BR, BO>;
  constexpr int kCols = DMAX / 16;
  constexpr int kR = BR / 16;  // rows a thread
  constexpr int kSC = BO / 16;  // score columns a thread
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BR][kRS]
  float* dOs = Qs + BR * S::kRS;       // [BR][kRS]
  float* Ks = dOs + BR * S::kRS;       // [BO][kCS]
  float* Vs = Ks + BO * S::kCS;        // [BO][kCS]
  float* dSs = Vs + BO * S::kCS;       // [BR][kSS]
  float* lse_s = dSs + BR * S::kSS;
  float* delta_s = lse_s + BR;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q_start = blockIdx.x * BR;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int d = a.d;
  const int kv_head = hh / (a.h / a.kvh);
  const int sq = a.mask.sq;
  const int sk = a.mask.sk;
  const long long row_base = (static_cast<long long>(bb) * a.h + hh) * sq;
  const long long q_base = row_base * d;
  const long long kv_base = (static_cast<long long>(bb) * a.kvh + kv_head) * sk * d;

  for (int idx = tid; idx < BR * DMAX; idx += kThreads) {
    const int r = idx / DMAX;
    const int c = idx % DMAX;
    const int row = q_start + r;
    float qv = 0.f;
    float dov = 0.f;
    if (row < sq && c < d) {
      const long long off = q_base + static_cast<long long>(row) * d + c;
      qv = apex::to_float(q[off]);
      dov = apex::to_float(dout[off]);
    }
    Qs[r * S::kRS + c] = qv;
    dOs[r * S::kRS + c] = dov;
  }
  // delta = rowsum(do * o): one warp per row, or the caller's delta
  for (int r = warp; r < BR; r += kThreads / 32) {
    const int row = q_start + r;
    float part = 0.f;
    if (a.delta_given) {
      if (row < sq) part = delta[row_base + row];
    } else {
      if (row < sq) {
        const long long base = q_base + static_cast<long long>(row) * d;
        for (int c = lane; c < d; c += 32)
          part += apex::to_float(dout[base + c]) * apex::to_float(out[base + c]);
      }
      part = apex::warp_sum(part);
    }
    if (lane == 0) {
      delta_s[r] = part;
      lse_s[r] = row < sq ? lse[row_base + row] : 0.f;
      if (row < sq && !a.delta_given) delta[row_base + row] = part;
    }
  }

  float acc[kR][kCols];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  const int kvl = local_kvl(a.mask, a.kv_lengths, bb);
  int j_first, j_last;
  key_tiles(a.mask, kvl, q_start, &j_first, &j_last, BR, BO);
  __syncthreads();

  for (int jt = j_first; jt <= j_last; ++jt) {
    const int k_start = jt * BO;
    for (int idx = tid; idx < BO * DMAX; idx += kThreads) {
      const int r = idx / DMAX;
      const int c = idx % DMAX;
      const int row = k_start + r;
      float kval = 0.f;
      float vval = 0.f;
      if (row < sk && c < d) {
        const long long off = kv_base + static_cast<long long>(row) * d + c;
        kval = apex::to_float(k[off]);
        vval = apex::to_float(v[off]);
      }
      Ks[r * S::kCS + c] = kval;
      Vs[r * S::kCS + c] = vval;
    }
    __syncthreads();

    float sc[kR][kSC];
    float dp[kR][kSC];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int jj = 0; jj < kSC; ++jj) sc[i][jj] = dp[i][jj] = 0.f;
    for (int c = 0; c < DMAX; ++c) {
      float qv[kR], dov[kR], kv[kSC], vv[kSC];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        qv[i] = Qs[(ty * kR + i) * S::kRS + c];
        dov[i] = dOs[(ty * kR + i) * S::kRS + c];
      }
#pragma unroll
      for (int jj = 0; jj < kSC; ++jj) {
        kv[jj] = Ks[(tx + 16 * jj) * S::kCS + c];
        vv[jj] = Vs[(tx + 16 * jj) * S::kCS + c];
      }
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int jj = 0; jj < kSC; ++jj) {
          sc[i][jj] = fmaf(qv[i], kv[jj], sc[i][jj]);
          dp[i][jj] = fmaf(dov[i], vv[jj], dp[i][jj]);
        }
    }
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int r = ty * kR + i;
      const int row = q_start + r;
#pragma unroll
      for (int jj = 0; jj < kSC; ++jj) {
        const int col = k_start + tx + 16 * jj;
        float ds = 0.f;
        if (visible(a.mask, kvl, row, col)) {
          const float p = expf(sc[i][jj] * a.scale - lse_s[r]);
          ds = p * (dp[i][jj] - delta_s[r]);
        }
        dSs[r * S::kSS + tx + 16 * jj] = ds;
      }
    }
    __syncthreads();

    // dq += ds k
    for (int jj = 0; jj < BO; ++jj) {
      float dsv[kR];
      float kv[kCols];
#pragma unroll
      for (int i = 0; i < kR; ++i) dsv[i] = dSs[(ty * kR + i) * S::kSS + jj];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = Ks[jj * S::kCS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = q_start + ty * kR + i;
    if (row >= sq) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < d)
        apex::store(&dq[q_base + static_cast<long long>(row) * d + col], acc[i][c] * a.scale);
    }
  }
}

template <int DMAX, int BR, int BO>
struct DkvSmem {
  static constexpr int kRS = DMAX + 4;  // K, V: rows read by ty
  static constexpr int kCS = DMAX + 1;  // Q, dO: rows read by tx
  static constexpr int kSS = BO + 1;
  static constexpr size_t floats = 2 * BR * kRS + 2 * BO * kCS + 2 * BR * kSS + 2 * BO;
  static_assert(floats * 4 <= 232448, "one block fits an SM");
};

template <int DMAX, int BR, int BO>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, const Args a) {
  using S = DkvSmem<DMAX, BR, BO>;
  constexpr int kCols = DMAX / 16;
  constexpr int kR = BR / 16;  // key rows a thread
  constexpr int kSC = BO / 16;  // query columns a thread
  extern __shared__ float smem[];
  float* Ks = smem;                   // [BR][kRS]
  float* Vs = Ks + BR * S::kRS;       // [BR][kRS]
  float* Qs = Vs + BR * S::kRS;       // [BO][kCS]
  float* dOs = Qs + BO * S::kCS;      // [BO][kCS]
  float* Ps = dOs + BO * S::kCS;      // p^T [BR][kSS]
  float* dSs = Ps + BR * S::kSS;      // ds^T [BR][kSS]
  float* lse_s = dSs + BR * S::kSS;
  float* delta_s = lse_s + BO;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int k_start = blockIdx.x * BR;
  const int kv_head = blockIdx.y;
  const int bb = blockIdx.z;
  const int d = a.d;
  const int group = a.h / a.kvh;
  const int sq = a.mask.sq;
  const int sk = a.mask.sk;
  const long long kv_base = (static_cast<long long>(bb) * a.kvh + kv_head) * sk * d;

  for (int idx = tid; idx < BR * DMAX; idx += kThreads) {
    const int r = idx / DMAX;
    const int c = idx % DMAX;
    const int row = k_start + r;
    float kval = 0.f;
    float vval = 0.f;
    if (row < sk && c < d) {
      const long long off = kv_base + static_cast<long long>(row) * d + c;
      kval = apex::to_float(k[off]);
      vval = apex::to_float(v[off]);
    }
    Ks[r * S::kRS + c] = kval;
    Vs[r * S::kRS + c] = vval;
  }

  float dka[kR][kCols];
  float dva[kR][kCols];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dka[i][c] = dva[i][c] = 0.f;

  const int kvl = local_kvl(a.mask, a.kv_lengths, bb);
  int i_first, i_last;
  query_tiles(a.mask, kvl, k_start, &i_first, &i_last, BR, BO);

  for (int jh = 0; jh < group; ++jh) {
    const int hh = kv_head * group + jh;
    const long long row_base = (static_cast<long long>(bb) * a.h + hh) * sq;
    const long long q_base = row_base * d;
    for (int it = i_first; it <= i_last; ++it) {
      const int q_start = it * BO;
      __syncthreads();  // the previous tile's readers are done
      for (int idx = tid; idx < BO * DMAX; idx += kThreads) {
        const int r = idx / DMAX;
        const int c = idx % DMAX;
        const int row = q_start + r;
        float qv = 0.f;
        float dov = 0.f;
        if (row < sq && c < d) {
          const long long off = q_base + static_cast<long long>(row) * d + c;
          qv = apex::to_float(q[off]);
          dov = apex::to_float(dout[off]);
        }
        Qs[r * S::kCS + c] = qv;
        dOs[r * S::kCS + c] = dov;
      }
      if (tid < BO) {
        const int row = q_start + tid;
        lse_s[tid] = row < sq ? lse[row_base + row] : 0.f;
        delta_s[tid] = row < sq ? delta[row_base + row] : 0.f;
      }
      __syncthreads();

      // transposed tile: key rows ty * kR + i, query columns tx + 16 jj
      float sc[kR][kSC];
      float dp[kR][kSC];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int jj = 0; jj < kSC; ++jj) sc[i][jj] = dp[i][jj] = 0.f;
      for (int c = 0; c < DMAX; ++c) {
        float kv[kR], vv[kR], qv[kSC], dov[kSC];
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          kv[i] = Ks[(ty * kR + i) * S::kRS + c];
          vv[i] = Vs[(ty * kR + i) * S::kRS + c];
        }
#pragma unroll
        for (int jj = 0; jj < kSC; ++jj) {
          qv[jj] = Qs[(tx + 16 * jj) * S::kCS + c];
          dov[jj] = dOs[(tx + 16 * jj) * S::kCS + c];
        }
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int jj = 0; jj < kSC; ++jj) {
            sc[i][jj] = fmaf(kv[i], qv[jj], sc[i][jj]);
            dp[i][jj] = fmaf(vv[i], dov[jj], dp[i][jj]);
          }
      }
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int kr = ty * kR + i;
        const int col = k_start + kr;
#pragma unroll
        for (int jj = 0; jj < kSC; ++jj) {
          const int qc = tx + 16 * jj;
          const int row = q_start + qc;
          float pr = 0.f;
          float ds = 0.f;
          if (visible(a.mask, kvl, row, col)) {
            const float p = expf(sc[i][jj] * a.scale - lse_s[qc]);
            pr = p;
            ds = p * (dp[i][jj] - delta_s[qc]);
          }
          Ps[kr * S::kSS + qc] = pr;
          dSs[kr * S::kSS + qc] = ds;
        }
      }
      __syncthreads();

      // dv += p^T do, dk += ds^T q
      for (int qc = 0; qc < BO; ++qc) {
        float pv[kR], dsv[kR], dov[kCols], qv[kCols];
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          pv[i] = Ps[(ty * kR + i) * S::kSS + qc];
          dsv[i] = dSs[(ty * kR + i) * S::kSS + qc];
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          dov[c] = dOs[qc * S::kCS + tx + 16 * c];
          qv[c] = Qs[qc * S::kCS + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            dva[i][c] = fmaf(pv[i], dov[c], dva[i][c]);
            dka[i][c] = fmaf(dsv[i], qv[c], dka[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = k_start + ty * kR + i;
    if (row >= sk) continue;
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

template <int DMAX>
cudaError_t launch_f32(const float* q, const float* k, const float* v,
                       const float* out, const float* dout, const float* lse,
                       float* delta, float* dq, float* dk, float* dv,
                       const Args& a, cudaStream_t stream) {
  // the blocks' own rows, and the rows of the tiles they walk
  constexpr int kBR = DMAX <= 128 ? 64 : DMAX <= 256 ? 32 : 16;
  constexpr int kBO = DMAX <= 256 ? 64 : 32;
  auto dq_kernel = flash_bwd_dq_kernel<DMAX, kBR, kBO>;
  auto dkv_kernel = flash_bwd_dkv_kernel<DMAX, kBR, kBO>;
  const size_t dq_smem = DqSmem<DMAX, kBR, kBO>::floats * sizeof(float);
  const size_t dkv_smem = DkvSmem<DMAX, kBR, kBO>::floats * sizeof(float);
  cudaError_t err = apex::allow_smem(dq_kernel, dq_smem);
  if (err != cudaSuccess) return err;
  err = apex::allow_smem(dkv_kernel, dkv_smem);
  if (err != cudaSuccess) return err;
  const dim3 dq_grid((a.mask.sq + kBR - 1) / kBR, a.h, a.b);
  dq_kernel<<<dq_grid, kThreads, dq_smem, stream>>>(q, k, v, out, dout, lse,
                                                    delta, dq, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 dkv_grid((a.mask.sk + kBR - 1) / kBR, a.kvh, a.b);
  dkv_kernel<<<dkv_grid, kThreads, dkv_smem, stream>>>(q, k, v, dout, lse,
                                                       delta, dk, dv, a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 and fp16: delta prep, then the dk/dv and dq passes on mma.sync
// ---------------------------------------------------------------------------

// the tag that names Kernel I's delta prep pass in a profile
struct KernelI {};

// The 16-bit passes' operands (T: bf16 or fp16): q, do and o [b, H, sq,
// d], k and v [b, KVH, sk, d], lse and delta [b, H, sq] fp32, dq like q,
// dk and dv like k.
template <typename T>
struct Args16 {
  const T* q;
  const T* k;
  const T* v;
  const T* dout;
  const float* lse;
  const float* delta;
  T* dq;
  T* dk;
  T* dv;
  const int* kv_lengths;  // [b] int32, or null
  int H, KVH, d;
  float scale;
  Mask mask;
};

// The dk/dv pass: WARPS warps of 16 keys, query tiles of BQ rows through a
// ring of STAGES (Q, dO, lse, delta) stages. K and V stay in shared memory
// and their A fragments are read at each use.
template <int DMAX, int WARPS, int BQ, int STAGES>
struct DkvCfg {
  static constexpr int kThreads = WARPS * 32;
  static constexpr int kKeys = WARPS / flash::Cols<DMAX>::kParts * 16;
  static constexpr int kLd = flash::Tile<DMAX>::kLd;
  static constexpr int kKV = 2 * kKeys * kLd * 2;  // K, then V, bytes
  static constexpr int kStage = 4 * BQ * kLd + 8 * BQ;  // bytes
  static constexpr size_t bytes = kKV + STAGES * kStage;
  static constexpr int kMinBlocks = DMAX <= 64 ? 3 : DMAX <= 128 ? 2 : 1;  // dk/dv
  static_assert(2 * BQ <= kThreads, "a thread a lse or delta row");
  static_assert(bytes <= 232448, "one block fits an SM");
};

template <typename T, int DMAX, int WARPS, int BQ, int STAGES, bool VEC>
__global__ void __launch_bounds__(
    WARPS * 32, (DkvCfg<DMAX, WARPS, BQ, STAGES>::kMinBlocks))
flash_bwd_dkv_mma(const Args16<T> a) {
  using C = DkvCfg<DMAX, WARPS, BQ, STAGES>;
  using W = flash::Cols<DMAX>;
  constexpr int kKS = DMAX / 16;  // k16 steps over d
  constexpr int kNS = BQ / 8;     // n8 score tiles (queries) a warp
  constexpr int kNO = W::kWidth / 8;  // n8 output tiles (columns of d) a warp
  extern __shared__ __align__(16) unsigned char fsmem[];
  T* Ks = reinterpret_cast<T*>(fsmem);
  T* Vs = Ks + C::kKeys * C::kLd;
  unsigned char* ring_smem = fsmem + C::kKV;

  const Mask& mk = a.mask;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g4 = lane / 4;
  const int t4 = lane % 4;
  const int strip = warp / W::kParts;  // the warp's 16 keys
  const int cb = warp % W::kParts * W::kWidth;  // its first output column
  const int kvh = blockIdx.x;
  const int bb = blockIdx.y;
  const int k_start = blockIdx.z * C::kKeys;
  const int kw0 = k_start + 16 * strip;  // the warp's first key
  const int d = a.d;
  const int group = a.H / a.KVH;
  const long long kv_base =
      (static_cast<long long>(bb) * a.KVH + kvh) * mk.sk * d;
  const int kvl = local_kvl(mk, a.kv_lengths, bb);
  int first, last;
  query_tiles(mk, kvl, k_start, &first, &last, C::kKeys, BQ);
  const int nt = last - first + 1;
  const int slices = nt > 0 ? nt * group : 0;  // (head, query tile)

  float dk[kNO][4];
  float dv[kNO][4];
#pragma unroll
  for (int j = 0; j < kNO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  if (slices > 0) {
    // the [sq] rows of the group's head jh: q, do, lse and delta
    auto rows_of = [&](int jh) {
      return (static_cast<long long>(bb) * a.H + kvh * group + jh) * mk.sq;
    };
    auto load = [&](int i, unsigned char* st) {
      const long long rb = rows_of(i / nt);
      const int q0 = (first + i % nt) * BQ;
      T* Qs = reinterpret_cast<T*>(st);
      T* dOs = Qs + BQ * C::kLd;
      float* ls = reinterpret_cast<float*>(dOs + BQ * C::kLd);
      flash::copy_tile<BQ, DMAX, C::kThreads, VEC>(Qs, a.q, rb * d, d, q0,
                                                   mk.sq, d);
      flash::copy_tile<BQ, DMAX, C::kThreads, VEC>(dOs, a.dout, rb * d, d,
                                                   q0, mk.sq, d);
      const int t = threadIdx.x;
      if (t < 2 * BQ) {  // lse rows, then delta rows (0 past sq)
        const int r = t % BQ;
        const float* src = t < BQ ? a.lse : a.delta;
        const bool ok = q0 + r < mk.sq;
        flash::cp_async4(ls + t, ok ? src + rb + q0 + r : src, ok);
      }
    };

    flash::copy_tile<C::kKeys, DMAX, C::kThreads, VEC>(Ks, a.k, kv_base, d,
                                                       k_start, mk.sk, d);
    flash::copy_tile<C::kKeys, DMAX, C::kThreads, VEC>(Vs, a.v, kv_base, d,
                                                       k_start, mk.sk, d);
    ring::cp_async_commit();
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < slices) load(st, ring_smem + st * C::kStage);
      ring::cp_async_commit();
    }

    const T* kw_s = Ks + 16 * strip * C::kLd;
    const T* vw_s = Vs + 16 * strip * C::kLd;
    for (int it = 0; it < slices; ++it) {
      ring::cp_async_wait<STAGES - 2>();
      __syncthreads();
      unsigned char* st = ring_smem + (it % STAGES) * C::kStage;
      const T* Qs = reinterpret_cast<const T*>(st);
      const T* dOs = Qs + BQ * C::kLd;
      const float* ls = reinterpret_cast<const float*>(dOs + BQ * C::kLd);
      const float* dls = ls + BQ;
      const int q0 = (first + it % nt) * BQ;
      const int next = it + STAGES - 1;
      if (next < slices)
        load(next, ring_smem + (next % STAGES) * C::kStage);
      ring::cp_async_commit();

      const flash::Cover cover = flash::tile_cover(mk, kvl, q0, kw0, 16, BQ);
      if (cover == flash::kNone) continue;
      // S^T = K Q^T, then p = exp(scale s - lse) (0 where masked)
      float sc[kNS][4];
#pragma unroll
      for (int j = 0; j < kNS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll (W::kUnroll)
      for (int kk = 0; kk < kKS; ++kk) {
        unsigned fa[1][4];
        ring::load_a<1, false>(fa, kw_s, C::kLd, 16 * kk);
        unsigned fb[kNS / 2][4];
        ring::load_b<kNS, false>(fb, Qs, C::kLd, 16 * kk);
#pragma unroll
        for (int j = 0; j < kNS; ++j)
          flash::mma_sum<T, W::kAddSums>(sc[j], fa[0],
                                         fb[j >> 1][2 * (j & 1)],
                                         fb[j >> 1][2 * (j & 1) + 1]);
      }
#pragma unroll
      for (int j = 0; j < kNS; ++j) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = q0 + 8 * j + 2 * t4 + (e & 1);
          const int col = kw0 + g4 + 8 * (e >> 1);
          float x = sc[j][e] * a.scale - ((e & 1) ? l2.y : l2.x);
          if (cover == flash::kSome && !visible(mk, kvl, row, col)) x = kNeg;
          sc[j][e] = flash::fast_exp(x);
        }
      }
      // 16 queries at a time: dP^T, then p and ds rounded to T into A
      // fragments, dV += P^T dO and dK += dS^T Q
#pragma unroll
      for (int c = 0; c < kNS / 2; ++c) {
        float dp[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
#pragma unroll (W::kUnroll)
        for (int kk = 0; kk < kKS; ++kk) {
          unsigned fa[1][4];
          ring::load_a<1, false>(fa, vw_s, C::kLd, 16 * kk);
          unsigned fb[1][4];
          ring::load_b<2, false>(fb, dOs + 16 * c * C::kLd, C::kLd, 16 * kk);
          flash::mma_sum<T, W::kAddSums>(dp[0], fa[0], fb[0][0], fb[0][1]);
          flash::mma_sum<T, W::kAddSums>(dp[1], fa[0], fb[0][2], fb[0][3]);
        }
        float pc[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float2 d2 =
              *reinterpret_cast<const float2*>(dls + 16 * c + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pc[j][e] = sc[2 * c + j][e];
            dp[j][e] = pc[j][e] * (dp[j][e] - ((e & 1) ? d2.y : d2.x));  // ds
          }
        }
        unsigned pa[4], sa[4];
        flash::fragment16<2, T>(pc, 0, pa);
        flash::fragment16<2, T>(dp, 0, sa);
        {
          unsigned fb[kNO / 2][4];
          ring::load_b<kNO, true>(fb, dOs + cb, C::kLd, 16 * c);
#pragma unroll
          for (int j = 0; j < kNO; ++j)
            flash::mma_acc<T>(dv[j], pa, fb[j >> 1][2 * (j & 1)],
                           fb[j >> 1][2 * (j & 1) + 1]);
        }
        {
          unsigned fb[kNO / 2][4];
          ring::load_b<kNO, true>(fb, Qs + cb, C::kLd, 16 * c);
#pragma unroll
          for (int j = 0; j < kNO; ++j)
            flash::mma_acc<T>(dk[j], sa, fb[j >> 1][2 * (j & 1)],
                           fb[j >> 1][2 * (j & 1) + 1]);
        }
      }
    }
    ring::cp_async_wait<0>();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = kw0 + g4 + 8 * h;
    if (row >= mk.sk) continue;
    T* dk_dst = a.dk + kv_base + static_cast<long long>(row) * d;
    T* dv_dst = a.dv + kv_base + static_cast<long long>(row) * d;
#pragma unroll
    for (int j = 0; j < kNO; ++j) {
      const int col = cb + 8 * j + 2 * t4;
      flash::store_pair(dk_dst, col, d, dk[j][2 * h] * a.scale,
                        dk[j][2 * h + 1] * a.scale);
      flash::store_pair(dv_dst, col, d, dv[j][2 * h], dv[j][2 * h + 1]);
    }
  }
}

// The dq pass: WARPS warps of 16 query rows, BK-key tiles through a ring
// of STAGES (K, V) stages.
template <int DMAX, int WARPS, int STAGES, int BK>
struct DqCfg {
  static constexpr int kThreads = WARPS * 32;
  static constexpr int kRows = WARPS / flash::Cols<DMAX>::kParts * 16;
  static constexpr int kLd = flash::Tile<DMAX>::kLd;
  static constexpr int kQD = 2 * kRows * kLd * 2;  // Q, then dO, bytes
  static constexpr int kStage = 2 * BK * kLd * 2;  // K, then V, bytes
  static constexpr size_t bytes = kQD + STAGES * kStage;
  static constexpr int kMinBlocks = DMAX <= 64 ? 3 : DMAX <= 128 ? 2 : 1;  // dq
  static_assert(bytes <= 232448, "one block fits an SM");
};

template <typename T, int DMAX, int WARPS, int STAGES, int BK, bool VEC>
__global__ void __launch_bounds__(WARPS * 32,
                                  (DqCfg<DMAX, WARPS, STAGES, BK>::kMinBlocks))
flash_bwd_dq_mma(const Args16<T> a) {
  using C = DqCfg<DMAX, WARPS, STAGES, BK>;
  using W = flash::Cols<DMAX>;
  constexpr int kKS = DMAX / 16;  // k16 steps over d
  constexpr int kNS = BK / 8;     // n8 score tiles (keys) a warp
  constexpr int kNO = W::kWidth / 8;  // n8 output tiles a warp
  extern __shared__ __align__(16) unsigned char fsmem[];
  T* Qs = reinterpret_cast<T*>(fsmem);
  T* dOs = Qs + C::kRows * C::kLd;
  T* kv = reinterpret_cast<T*>(fsmem + C::kQD);  // the ring's stages

  const Mask& mk = a.mask;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g4 = lane / 4;
  const int t4 = lane % 4;
  const int strip = warp / W::kParts;  // the warp's 16 query rows
  const int cb = warp % W::kParts * W::kWidth;  // its first output column
  const int hh = blockIdx.x;
  const int bb = blockIdx.y;
  const int qt = mk.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q_start = qt * C::kRows;
  const int r0 = q_start + 16 * strip;  // the warp's first row
  const int d = a.d;
  const long long rb = (static_cast<long long>(bb) * a.H + hh) * mk.sq;
  const long long kv_base =
      (static_cast<long long>(bb) * a.KVH + hh / (a.H / a.KVH)) * mk.sk * d;
  const int kvl = local_kvl(mk, a.kv_lengths, bb);
  int first, last;
  key_tiles(mk, kvl, q_start, &first, &last, C::kRows, BK);
  const int tiles = last - first + 1;

  float dq[kNO][4];
#pragma unroll
  for (int j = 0; j < kNO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  if (tiles > 0) {
    float lse_r[2], delta_r[2];  // the thread's rows g4 and g4 + 8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + g4 + 8 * h;
      lse_r[h] = row < mk.sq ? a.lse[rb + row] : 0.f;
      delta_r[h] = row < mk.sq ? a.delta[rb + row] : 0.f;
    }
    auto load_kv = [&](int tile, T* stage) {
      flash::copy_tile<BK, DMAX, C::kThreads, VEC>(stage, a.k, kv_base, d,
                                                   tile * BK, mk.sk, d);
      flash::copy_tile<BK, DMAX, C::kThreads, VEC>(
          stage + BK * C::kLd, a.v, kv_base, d, tile * BK, mk.sk, d);
    };
    flash::copy_tile<C::kRows, DMAX, C::kThreads, VEC>(Qs, a.q, rb * d, d,
                                                       q_start, mk.sq, d);
    flash::copy_tile<C::kRows, DMAX, C::kThreads, VEC>(dOs, a.dout, rb * d,
                                                       d, q_start, mk.sq, d);
    ring::cp_async_commit();
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < tiles) load_kv(first + st, kv + st * (C::kStage / 2));
      ring::cp_async_commit();
    }

    // Q's and dO's A fragments: held from the first tile on, or (past d
    // 128) read at each k16 step
    constexpr int kA = W::kRegA ? kKS : 1;
    unsigned qf[kA][1][4];
    unsigned df[kA][1][4];
    const T* qw_s = Qs + 16 * strip * C::kLd;
    const T* dw_s = dOs + 16 * strip * C::kLd;
    for (int it = 0; it < tiles; ++it) {
      ring::cp_async_wait<STAGES - 2>();
      __syncthreads();
      const T* Ks = kv + (it % STAGES) * (C::kStage / 2);
      const T* Vs = Ks + BK * C::kLd;
      const int c0 = (first + it) * BK;
      if (W::kRegA && it == 0) {
#pragma unroll
        for (int kk = 0; kk < kA; ++kk) {
          ring::load_a<1, false>(qf[kk], qw_s, C::kLd, 16 * kk);
          ring::load_a<1, false>(df[kk], dw_s, C::kLd, 16 * kk);
        }
      }
      const int next = it + STAGES - 1;
      if (next < tiles)
        load_kv(first + next, kv + (next % STAGES) * (C::kStage / 2));
      ring::cp_async_commit();

      const flash::Cover cover = flash::tile_cover(mk, kvl, r0, c0, BK);
      if (cover == flash::kNone) continue;
      // S = Q K^T, then p = exp(scale s - lse) (0 where masked)
      float sc[kNS][4];
#pragma unroll
      for (int j = 0; j < kNS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll (W::kUnroll)
      for (int kk = 0; kk < kKS; ++kk) {
        const int ai = W::kRegA ? kk : 0;
        if (!W::kRegA) ring::load_a<1, false>(qf[ai], qw_s, C::kLd, 16 * kk);
        unsigned fb[kNS / 2][4];
        ring::load_b<kNS, false>(fb, Ks, C::kLd, 16 * kk);
#pragma unroll
        for (int j = 0; j < kNS; ++j)
          flash::mma_sum<T, W::kAddSums>(sc[j], qf[ai][0],
                                         fb[j >> 1][2 * (j & 1)],
                                         fb[j >> 1][2 * (j & 1) + 1]);
      }
#pragma unroll
      for (int j = 0; j < kNS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + g4 + 8 * (e >> 1);
          const int col = c0 + 8 * j + 2 * t4 + (e & 1);
          float x = sc[j][e] * a.scale - lse_r[e >> 1];
          if (cover == flash::kSome && !visible(mk, kvl, row, col)) x = kNeg;
          sc[j][e] = flash::fast_exp(x);
        }
      // 16 keys at a time: dP, ds rounded to T into an A fragment,
      // dq += dS K
#pragma unroll
      for (int c = 0; c < kNS / 2; ++c) {
        float dp[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
#pragma unroll (W::kUnroll)
        for (int kk = 0; kk < kKS; ++kk) {
          const int ai = W::kRegA ? kk : 0;
          if (!W::kRegA) ring::load_a<1, false>(df[ai], dw_s, C::kLd, 16 * kk);
          unsigned fb[1][4];
          ring::load_b<2, false>(fb, Vs + 16 * c * C::kLd, C::kLd, 16 * kk);
          flash::mma_sum<T, W::kAddSums>(dp[0], df[ai][0], fb[0][0], fb[0][1]);
          flash::mma_sum<T, W::kAddSums>(dp[1], df[ai][0], fb[0][2], fb[0][3]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[j][e] = sc[2 * c + j][e] * (dp[j][e] - delta_r[e >> 1]);  // ds
        unsigned sa[4];
        flash::fragment16<2, T>(dp, 0, sa);
        unsigned fb[kNO / 2][4];
        ring::load_b<kNO, true>(fb, Ks + cb, C::kLd, 16 * c);
#pragma unroll
        for (int j = 0; j < kNO; ++j)
          flash::mma_acc<T>(dq[j], sa, fb[j >> 1][2 * (j & 1)],
                         fb[j >> 1][2 * (j & 1) + 1]);
      }
    }
    ring::cp_async_wait<0>();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g4 + 8 * h;
    if (row >= mk.sq) continue;
    T* dst = a.dq + (rb + row) * d;
#pragma unroll
    for (int j = 0; j < kNO; ++j)
      flash::store_pair(dst, cb + 8 * j + 2 * t4, d, dq[j][2 * h] * a.scale,
                        dq[j][2 * h + 1] * a.scale);
  }
}

// 4 warps a block in both passes (8 at d 256, two warps a strip of 16
// keys or queries; 8 at 512, four warps a strip), as in Kernel F; at d <=
// 64 query tiles of 64 rows in the dk/dv ring, from 128 on of 32 (the
// score tiles' registers beside dk and dv), as in Kernel F; key tiles of
// 64 in the dq ring, 32 at 512. The dk/dv ring has 3 stages (F's 2 were
// 2% slower at the T5 cross-attention, where a block walks only two query
// tiles; 2 at 512, where 3 would need 267,008 bytes), the dq ring 2.
// 16-byte copies need every row start (a multiple of d past a 16-byte
// aligned base) on a 16-byte boundary.
template <typename T, int DMAX>
cudaError_t launch_16(const Args16<T>& a, int b, const T* out, float* delta,
                      bool delta_given, cudaStream_t stream) {
  constexpr int kDkvWarps = DMAX <= 128 ? 4 : 8;
  constexpr int kDkvStages = DMAX <= 256 ? 3 : 2;
  constexpr int kDqWarps = DMAX <= 128 ? 4 : 8;
  constexpr int kDqStages = 2;
  constexpr int kBQ = DMAX <= 64 ? 64 : 32;
  constexpr int kKeys = DMAX <= 256 ? kBK : 32;  // the dq ring's key tiles
  using KvC = DkvCfg<DMAX, kDkvWarps, kBQ, kDkvStages>;
  using QC = DqCfg<DMAX, kDqWarps, kDqStages, kKeys>;
  auto aligned = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  const bool vec = a.d % 8 == 0 && aligned(a.q) && aligned(a.k) &&
                   aligned(a.v) && aligned(a.dout);
  cudaError_t err = cudaSuccess;
  if (!delta_given) {
    err = flash::launch_delta<KernelI>(
        a.dout, out, delta, static_cast<long long>(b) * a.H * a.mask.sq, 1,
        a.mask.sq, a.d, vec && aligned(out), stream);
    if (err != cudaSuccess) return err;
  }
  auto dkv =
      vec ? flash_bwd_dkv_mma<T, DMAX, kDkvWarps, kBQ, kDkvStages, true>
          : flash_bwd_dkv_mma<T, DMAX, kDkvWarps, kBQ, kDkvStages, false>;
  auto dq = vec ? flash_bwd_dq_mma<T, DMAX, kDqWarps, kDqStages, kKeys, true>
                : flash_bwd_dq_mma<T, DMAX, kDqWarps, kDqStages, kKeys, false>;
  err = apex::allow_smem(dkv, KvC::bytes);
  if (err != cudaSuccess) return err;
  err = apex::allow_smem(dq, QC::bytes);
  if (err != cudaSuccess) return err;
  const dim3 dkv_grid(a.KVH, b, (a.mask.sk + KvC::kKeys - 1) / KvC::kKeys);
  dkv<<<dkv_grid, KvC::kThreads, KvC::bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 dq_grid(a.H, b, (a.mask.sq + QC::kRows - 1) / QC::kRows);
  dq<<<dq_grid, QC::kThreads, QC::bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q, o, do and dq [b, h, sq, d]; k, v, dk and dv [b, kvh, sk, d]; lse and
// delta [b, h, sq] fp32; all contiguous, one element type. kv_lengths [b]
// int32 (global lengths) or null; window 0 = none; q_start and k_start the
// global positions of the first query and key (sk - sq and 0 for plain
// attention). lse is the forward's (Kernel B), 1e30 on a row that sees no
// key. delta_given 0: delta is scratch that the kernel fills with
// rowsum(do * o); else it holds the caller's delta (a ring's, from the
// merged o) and o is not read (may be null).
extern "C" int apex_flash_bwd(const void* q, const void* k, const void* v,
                              const void* out, const void* dout,
                              const void* lse, void* delta, void* dq,
                              void* dk, void* dv, const void* kv_lengths,
                              void* stream, int b, int h, int kvh, int sq,
                              int sk, int d, float scale, int causal,
                              int window, int q_start, int k_start,
                              int delta_given, int dtype) {
  const Mask mask = mask_4d(sq, sk, causal, window, q_start, k_start);
  const int* kvl = static_cast<const int*>(kv_lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (d > 512) return static_cast<int>(cudaErrorInvalidValue);
  // the 16-bit passes over T (bf16 or fp16), each pointer read as T
  auto run16 = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    const Args16<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                      static_cast<const T*>(v), static_cast<const T*>(dout),
                      l, dl, static_cast<T*>(dq), static_cast<T*>(dk),
                      static_cast<T*>(dv), kvl, h, kvh, d, scale, mask};
    const auto* o = static_cast<const T*>(out);
    const bool given = delta_given != 0;
    return d <= 64    ? launch_16<T, 64>(a, b, o, dl, given, st)
           : d <= 128 ? launch_16<T, 128>(a, b, o, dl, given, st)
           : d <= 256 ? launch_16<T, 256>(a, b, o, dl, given, st)
                      : launch_16<T, 512>(a, b, o, dl, given, st);
  };
  cudaError_t err;
  if (dtype == apex::kBF16) {
    err = run16(static_cast<__nv_bfloat16*>(nullptr));
  } else if (dtype == apex::kF16) {
    err = run16(static_cast<__half*>(nullptr));
  } else if (dtype == apex::kF32) {
    const Args a{kvl, b, h, kvh, d, scale, mask, delta_given};
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    auto w = [](void* p) { return static_cast<float*>(p); };
    auto f32 = [&](auto dmax) {
      return launch_f32<decltype(dmax)::value>(f(q), f(k), f(v), f(out),
                                               f(dout), l, dl, w(dq), w(dk),
                                               w(dv), a, st);
    };
    err = d <= 64    ? f32(std::integral_constant<int, 64>())
          : d <= 128 ? f32(std::integral_constant<int, 128>())
          : d <= 256 ? f32(std::integral_constant<int, 256>())
                     : f32(std::integral_constant<int, 512>());
  } else {
    return static_cast<int>(cudaErrorInvalidValue);  // no other type
  }
  return static_cast<int>(err);
}

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
// The JAX kernel rounds ds to the input dtype before `ds k` (:935) and
// `ds^T q` (:948), and the dropped p before `p^T do` (:945); the plain
// version (flash_packed_bwd_plain) rounds at the same three points, and
// in f32 these roundings are the identity. In fp16 a small ds lands in
// fp16's subnormals and a large one (under a big loss scale) overflows
// to inf, in both versions alike (round to nearest even, subnormals
// kept), and dq, dk and dv past 65504 round to inf at their one store, so
// amp's unscale finds the overflow.
//
// What does not carry over: the TPU kernel holds a whole (s, s) block of
// one cell in VMEM and accumulates dk/dv in registers across the group's
// query heads in one grid step. Here separate passes split the work so no
// value is accumulated across blocks, and no atomics are used: every
// output element is written by one thread once, so repeated runs are
// bitwise equal.
//
// Bound on the H100: at GPT-2 124M training (b 8, 12 heads, s 1024, d 64,
// causal, bf16) the causal work is ~32 GFLOP (five products of 2 d per
// visible pair: q k^T, do v^T, ds k, ds^T q, p^T do; 33 us at the bf16
// tensor rate) against ~101 MB moved (30 us at 3.35 TB/s).
//
// bf16 and fp16 (the paths the models train on; one template over the
// 16-bit type T), three launches:
// - delta prep: delta = rowsum(do * o) in fp32 into the [b, H, s] scratch
//   (16-byte loads, 8 threads a row at d 64), so that the two GEMM passes
//   read it and depend on nothing but their inputs (the `di` of
//   `_recompute_p_ds`, :412);
// - dk/dv pass, one block of 4 warps per (group, batch, 64-key tile), the
//   tiles that see the most queries first under a causal mask. Each warp
//   owns 16 keys: K (rotated in shared memory) and V come in once by
//   cp.async and stay in shared memory. The group's qpg heads and their
//   visible 64-query tiles stream through a 2-stage cp.async ring
//   (flash_mma.cuh, mma_ring.cuh) with their lse and delta rows; a Q tile
//   is rotated in place. S^T = K Q^T and dP^T = V dO^T on mma.sync
//   m16n8k16 (T in, fp32 out), p = exp(scale s - lse) on the SFU, masks
//   only on tiles that cross the diagonal, a length, the window's edge or
//   s (flash::tile_cover), tiles a warp sees nothing of skipped, the
//   dropout hash at each accumulator's absolute (row, col). The dropped p
//   and ds are rounded to T straight into A fragments
//   (flash::fragment16), and dV += P^T dO, dK += dS^T Q take dO and Q
//   as B fragments by ldmatrix.trans from the same stage. dk and dv are
//   summed in fp32 across heads and tiles by the tensor cores; dk is
//   scaled, un-rotated in fp32 through shared memory and rounded once.
// - dq pass, one block of 4 warps per (head, batch, 64-query tile), the
//   heaviest causal tiles first: Q (rotated) and dO go into A fragments
//   once, K and V 64-key tiles come through the ring (K rotated in place);
//   S = Q K^T and dP = dO V^T on mma.sync, then ds rounded to T as A
//   fragments and dq += dS K with K by ldmatrix.trans from the same tile;
//   dq is scaled, un-rotated and rounded once.
// Registers are capped at 168 a thread at d <= 64 so that three blocks
// (12 warps) fit an SM: as in Kernel E, the passes wait on latency
// (ldmatrix, mma, exp) more than on one unit, and this occupancy beat
// fewer or larger blocks, a deeper ring, K and V fragments held in
// registers and 16-column steps (PERF.md, section 6).
// Past d 128 (DMAX 256, flash_mma.cuh Cols) dk and dv over all of d
// would take 256 fp32 registers a thread, and dq 128 beside Q's and dO's
// 128 of fragments: both passes run 8-warp blocks in which two warps
// share each strip of 16 keys (or queries), both computing its S^T and
// dP^T (or S and dP) over the whole of d, and each owning 128 columns of
// dk and dv (or dq); Q's and dO's fragments are read from shared memory
// at each k16 step. No atomics still: every output column has one owner.
// The tensor work becomes 22 d a visible pair; one block an SM. Past 256
// (DMAX 512) four warps share a strip, so the 8-warp blocks own 32 keys
// (or queries) at up to 255 registers a thread, the dq ring's key tiles
// are 32 rows (200,192 and 199,680 bytes of shared memory), and the
// tensor work is 38 d a visible pair; both passes spill (ptxas -v,
// PERF.md). Past 512, any d: the entry hands the call to the wide
// instance (flash_wide_bwd.cu), dq and dk un-rotated in a last pass.
// This is seven tile products a visible pair (q k^T and do v^T in both
// passes): 14 d of tensor work against the algorithm's 10 d, for no
// atomics and no cross-block sums. FlashAttention-2's single pass with an
// fp32 atomic dq is not taken: its sums would change order between runs.
// What bounds it: inferred, not profiled (no ncu on the card's machine):
// at the GPT-2 shape both passes issue ~160-180 TFLOP/s of mma.sync work,
// E's regime: the latency of mma.sync chains and the ldmatrix traffic of
// 16-row warps (two mma a B fragment). wgmma with 64-row warpgroups is the
// next step.
//
// f32 (checks only; TF32 would miss their atol of 1e-4), two launches:
// fp32 tiles in shared memory and fp32 FMA as in Kernel E's f32 path;
// each thread owns a 4-row x (DMAX / 16)-column accumulator tile (2 rows
// at DMAX 256, where the blocks' own tiles are 32 rows so that they fit
// the 227 KB of shared memory; 1 row at 512, where they are 16 rows and
// walk 32-row tiles).
// - pass 1, one block per (64-row query tile, head, batch): delta for its
//   rows (written to the [b, H, s] fp32 scratch for pass 2) and dq,
//   walking the visible key tiles;
// - pass 2, one block per (64-row key tile, group, batch): dk and dv
//   accumulate in fp32 over the group's qpg query heads and their visible
//   query tiles.
#include "flash_mma.cuh"
#include "flash_wide.cuh"
#include "packed_attention.cuh"

namespace {

using namespace apex::packed;

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

template <typename T, int DMAX, int BR, int BO>
__global__ void __launch_bounds__(kThreads)
flash_packed_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                       const T* __restrict__ out, const float* __restrict__ lse,
                       float* __restrict__ delta, T* __restrict__ dqkv,
                       const Opts opt) {
  using S = DqSmem<DMAX, BR, BO>;
  constexpr int kCols = DMAX / 16;
  constexpr int kR = BR / 16;  // rows a thread
  constexpr int kSC = BO / 16;  // score columns a thread
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BR][kRS], reused for dq at the end
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
  const int g = hh / opt.qpg;
  const int j = hh % opt.qpg;
  const int d = opt.d;
  const int heads = opt.groups * opt.qpg;
  const Layout lay(opt, bb);
  const bool drop = opt.seed != nullptr;
  const unsigned seed = drop ? static_cast<unsigned>(opt.seed[0]) : 0u;
  const unsigned cmb = combo(bb, hh);
  const long long stat_base = (static_cast<long long>(bb) * heads + hh) * opt.s;

  for (int idx = tid; idx < BR * DMAX; idx += kThreads) {
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
  for (int r = warp; r < BR; r += kThreads / 32) {
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

  float acc[kR][kCols];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  const int kvl = opt.kv_lengths != nullptr ? opt.kv_lengths[bb] : opt.s;
  int j_first, j_last;
  key_tiles(opt, kvl, q_start, &j_first, &j_last, BR, BO);
  __syncthreads();

  for (int jt = j_first; jt <= j_last; ++jt) {
    const int k_start = jt * BO;
    for (int idx = tid; idx < BO * DMAX; idx += kThreads) {
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

  // dq = scale * acc, un-rotated in fp32 (rows mix columns c and c +- rot/2,
  // so the tile goes through shared memory), rounded once
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      Qs[(ty * kR + i) * S::kRS + tx + 16 * c] = acc[i][c] * opt.scale;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = ty * kR + i;
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

template <int DMAX, int BR, int BO>
struct DkvSmem {
  static constexpr int kRS = DMAX + 4;  // K, V: rows read by ty
  static constexpr int kCS = DMAX + 1;  // Q, dO: rows read by tx
  static constexpr int kSS = BO + 1;
  static constexpr size_t floats = 2 * BR * kRS + 2 * BO * kCS + 2 * BR * kSS + 2 * BO;
  static_assert(floats * 4 <= 232448, "one block fits an SM");
};

template <typename T, int DMAX, int BR, int BO>
__global__ void __launch_bounds__(kThreads)
flash_packed_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dqkv,
                        const Opts opt) {
  using S = DkvSmem<DMAX, BR, BO>;
  constexpr int kCols = DMAX / 16;
  constexpr int kR = BR / 16;  // key rows a thread
  constexpr int kSC = BO / 16;  // query columns a thread
  extern __shared__ float smem[];
  float* Ks = smem;                   // [BR][kRS], reused for dk at the end
  float* Vs = Ks + BR * S::kRS;       // [BR][kRS]
  float* Qs = Vs + BR * S::kRS;       // [BO][kCS]
  float* dOs = Qs + BO * S::kCS;      // [BO][kCS]
  float* Ps = dOs + BO * S::kCS;      // dropped p^T [BR][kSS]
  float* dSs = Ps + BR * S::kSS;      // ds^T [BR][kSS]
  float* lse_s = dSs + BR * S::kSS;
  float* delta_s = lse_s + BO;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int k_start = blockIdx.x * BR;
  const int g = blockIdx.y;
  const int bb = blockIdx.z;
  const int d = opt.d;
  const int heads = opt.groups * opt.qpg;
  const Layout lay(opt, bb);
  const bool drop = opt.seed != nullptr;
  const unsigned seed = drop ? static_cast<unsigned>(opt.seed[0]) : 0u;

  for (int idx = tid; idx < BR * DMAX; idx += kThreads) {
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

  float dk[kR][kCols];
  float dv[kR][kCols];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int kvl = opt.kv_lengths != nullptr ? opt.kv_lengths[bb] : opt.s;
  int i_first, i_last;
  query_tiles(opt, kvl, k_start, &i_first, &i_last, BR, BO);

  for (int jh = 0; jh < opt.qpg; ++jh) {
    const int hh = g * opt.qpg + jh;
    const unsigned cmb = combo(bb, hh);
    const long long stat_base =
        (static_cast<long long>(bb) * heads + hh) * opt.s;
    for (int it = i_first; it <= i_last; ++it) {
      const int q_start = it * BO;
      __syncthreads();  // the previous tile's readers are done
      for (int idx = tid; idx < BO * DMAX; idx += kThreads) {
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
      if (tid < BO) {
        const int row = q_start + tid;
        lse_s[tid] = row < opt.s ? lse[stat_base + row] : 0.f;
        delta_s[tid] = row < opt.s ? delta[stat_base + row] : 0.f;
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
            dv[i][c] = fmaf(pv[i], dov[c], dv[i][c]);
            dk[i][c] = fmaf(dsv[i], qv[c], dk[i][c]);
          }
      }
    }
  }

  // dk = scale * acc, un-rotated in fp32 through shared memory; dv as is
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      Ks[(ty * kR + i) * S::kRS + tx + 16 * c] = dk[i][c] * opt.scale;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = ty * kR + i;
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
  // the blocks' own rows, and the rows of the tiles they walk
  constexpr int kBR = DMAX <= 128 ? 64 : DMAX <= 256 ? 32 : 16;
  constexpr int kBO = DMAX <= 256 ? 64 : 32;
  auto dq_kernel = flash_packed_dq_kernel<T, DMAX, kBR, kBO>;
  auto dkv_kernel = flash_packed_dkv_kernel<T, DMAX, kBR, kBO>;
  const size_t dq_smem = DqSmem<DMAX, kBR, kBO>::floats * sizeof(float);
  const size_t dkv_smem = DkvSmem<DMAX, kBR, kBO>::floats * sizeof(float);
  cudaError_t err = apex::allow_smem(dq_kernel, dq_smem);
  if (err != cudaSuccess) return err;
  err = apex::allow_smem(dkv_kernel, dkv_smem);
  if (err != cudaSuccess) return err;
  const dim3 dq_grid((opt.s + kBR - 1) / kBR, opt.groups * opt.qpg, opt.b);
  dq_kernel<<<dq_grid, kThreads, dq_smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout),
      static_cast<const T*>(out), lse, delta, static_cast<T*>(dqkv), opt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 dkv_grid((opt.s + kBR - 1) / kBR, opt.groups, opt.b);
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
  if (opt.d <= 256) return launch<T, 256>(qkv, dout, out, lse, delta, dqkv, opt, stream);
  if (opt.d <= 512) return launch<T, 512>(qkv, dout, out, lse, delta, dqkv, opt, stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bf16 and fp16: delta prep, then the dk/dv and dq passes on mma.sync
// ---------------------------------------------------------------------------

namespace flash = apex::flash;
namespace ring = apex::ring;

using flash::cp_async4;
using flash::store_pair;

// the tag that names Kernel F's delta prep pass in a profile
struct KernelF {};

// The dk/dv pass: WARPS warps of 16 keys, query tiles of BQ rows through a
// ring of STAGES (Q, dO, lse, delta) stages. K and V stay in shared memory
// and their A fragments are read at each use.
template <int DMAX, int WARPS, int BQ, int STAGES>
struct DkvCfg {
  static constexpr int kThreads = WARPS * 32;
  static constexpr int kKeys = WARPS / flash::Cols<DMAX>::kParts * 16;
  static constexpr int kLd = flash::Tile<DMAX>::kLd;
  static constexpr int kOutLd = DMAX + 4;  // fp32 dk rows to un-rotate
  static constexpr int kKV = 2 * kKeys * kLd * 2;
  static constexpr int kStage = 4 * BQ * kLd + 8 * BQ;  // bytes
  static constexpr size_t bytes = kKV + STAGES * kStage;
  static constexpr int kMinBlocks = DMAX <= 64 ? 3 : DMAX <= 128 ? 2 : 1;  // dk/dv
  static_assert(kKeys * kOutLd * 4 <= bytes, "dk tile fits");
  static_assert(bytes <= 232448, "one block fits an SM");
  static_assert(2 * BQ <= kThreads, "a thread a lse or delta row");
};

template <typename T, int DMAX, int WARPS, int BQ, int STAGES, bool VEC>
__global__ void __launch_bounds__(
    WARPS * 32, (DkvCfg<DMAX, WARPS, BQ, STAGES>::kMinBlocks))
flash_packed_dkv_mma(const T* __restrict__ qkv, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dqkv,
                     const Opts opt) {
  using C = DkvCfg<DMAX, WARPS, BQ, STAGES>;
  using W = flash::Cols<DMAX>;
  constexpr int kKS = DMAX / 16;  // k16 steps over d
  constexpr int kNS = BQ / 8;     // n8 score tiles (queries) a warp
  constexpr int kNO = W::kWidth / 8;  // n8 output tiles (columns of d) a warp
  extern __shared__ __align__(16) unsigned char fsmem[];
  T* Ks = reinterpret_cast<T*>(fsmem);
  T* Vs = Ks + C::kKeys * C::kLd;
  unsigned char* ring_smem = fsmem + C::kKV;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g4 = lane / 4;
  const int t4 = lane % 4;
  const int strip = warp / W::kParts;  // the warp's 16 keys
  const int cb = warp % W::kParts * W::kWidth;  // its first output column
  const int grp = blockIdx.x;
  const int bb = blockIdx.y;
  const int k_start = blockIdx.z * C::kKeys;
  const int kw0 = k_start + 16 * strip;  // the warp's first key
  const int d = opt.d;
  const int heads = opt.groups * opt.qpg;
  const Layout lay(opt, bb);
  const int kvl = opt.kv_lengths != nullptr ? opt.kv_lengths[bb] : opt.s;
  int first, last;
  query_tiles(opt, kvl, k_start, &first, &last, C::kKeys, BQ);
  const int nt = last - first + 1;
  const int slices = nt > 0 ? nt * opt.qpg : 0;  // (head, query tile)

  float dk[kNO][4];
  float dv[kNO][4];
#pragma unroll
  for (int j = 0; j < kNO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  if (slices > 0) {
    const bool drop = opt.seed != nullptr;
    const unsigned seed = drop ? static_cast<unsigned>(opt.seed[0]) : 0u;
    const long long hd = static_cast<long long>(heads) * d;
    auto load = [&](int i, unsigned char* st) {
      const int jh = i / nt;
      const int q0 = (first + i % nt) * BQ;
      const int hh = grp * opt.qpg + jh;
      T* Qs = reinterpret_cast<T*>(st);
      T* dOs = Qs + BQ * C::kLd;
      float* ls = reinterpret_cast<float*>(dOs + BQ * C::kLd);
      flash::copy_tile<BQ, DMAX, C::kThreads, VEC>(
          Qs, qkv, lay.q(grp, jh, 0, d), lay.row_stride, q0, opt.s, d);
      flash::copy_tile<BQ, DMAX, C::kThreads, VEC>(
          dOs, dout, bb * hd + static_cast<long long>(hh) * d, opt.b * hd,
          q0, opt.s, d);
      const int t = threadIdx.x;
      if (t < 2 * BQ) {  // lse rows, then delta rows (0 past s)
        const int r = t % BQ;
        const float* src = t < BQ ? lse : delta;
        const bool ok = q0 + r < opt.s;
        const long long at =
            (static_cast<long long>(bb) * heads + hh) * opt.s + q0 + r;
        cp_async4(ls + t, ok ? src + at : src, ok);
      }
    };

    flash::copy_tile<C::kKeys, DMAX, C::kThreads, VEC>(
        Ks, qkv, lay.k(grp, opt.qpg, 0, d), lay.row_stride, k_start, opt.s, d);
    flash::copy_tile<C::kKeys, DMAX, C::kThreads, VEC>(
        Vs, qkv, lay.v(grp, opt.qpg, 0, d), lay.row_stride, k_start, opt.s, d);
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
      const int jh = it / nt;
      const int q0 = (first + it % nt) * BQ;
      const unsigned cmb = combo(bb, grp * opt.qpg + jh);
      if (opt.rot > 0) {
        if (it == 0)
          flash::rope_tile<C::kKeys, C::kThreads>(Ks, C::kLd, k_start, opt);
        flash::rope_tile<BQ, C::kThreads>(reinterpret_cast<T*>(st), C::kLd,
                                          q0, opt);
        __syncthreads();
      }
      const int next = it + STAGES - 1;
      if (next < slices)
        load(next, ring_smem + (next % STAGES) * C::kStage);
      ring::cp_async_commit();

      const flash::Cover cover = flash::tile_cover(opt, kvl, q0, kw0, 16, BQ);
      if (cover == flash::kNone) continue;
      // S^T = K Q^T, then p = exp(scale s - lse) (0 where masked)
      float sc[kNS][4];
#pragma unroll
      for (int j = 0; j < kNS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll (W::kUnroll)
      for (int kk = 0; kk < kKS; ++kk) {
        unsigned a[1][4];
        ring::load_a<1, false>(a, kw_s, C::kLd, 16 * kk);
        unsigned fb[kNS / 2][4];
        ring::load_b<kNS, false>(fb, Qs, C::kLd, 16 * kk);
#pragma unroll
        for (int j = 0; j < kNS; ++j)
          flash::mma_sum<T, W::kAddSums>(sc[j], a[0],
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
          float x = sc[j][e] * opt.scale - ((e & 1) ? l2.y : l2.x);
          if (cover == flash::kSome && !visible(opt, kvl, row, col)) x = kNeg;
          sc[j][e] = flash::fast_exp(x);
        }
      }
      // 16 queries at a time: dP^T, the dropped p and ds rounded to T
      // into A fragments, dV += P^T dO and dK += dS^T Q
#pragma unroll
      for (int c = 0; c < kNS / 2; ++c) {
        float dp[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
#pragma unroll (W::kUnroll)
        for (int kk = 0; kk < kKS; ++kk) {
          unsigned a[1][4];
          ring::load_a<1, false>(a, vw_s, C::kLd, 16 * kk);
          unsigned fb[1][4];
          ring::load_b<2, false>(fb, dOs + 16 * c * C::kLd, C::kLd, 16 * kk);
          flash::mma_sum<T, W::kAddSums>(dp[0], a[0], fb[0][0], fb[0][1]);
          flash::mma_sum<T, W::kAddSums>(dp[1], a[0], fb[0][2], fb[0][3]);
        }
        float pd[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ql = 16 * c + 8 * j + 2 * t4;
          const float2 d2 = *reinterpret_cast<const float2*>(dls + ql);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = sc[2 * c + j][e];
            float dpv = dp[j][e];
            pd[j][e] = p;
            if (drop) {
              const bool keep =
                  hash_keep(seed, cmb, q0 + ql + (e & 1),
                            kw0 + g4 + 8 * (e >> 1), opt.keep_thresh);
              pd[j][e] = keep ? p * opt.inv_keep : 0.f;
              dpv = keep ? dpv * opt.inv_keep : 0.f;
            }
            dp[j][e] = p * (dpv - ((e & 1) ? d2.y : d2.x));  // ds
          }
        }
        unsigned pa[4], sa[4];
        flash::fragment16<2, T>(pd, 0, pa);
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

  // dk = scale * acc, un-rotated in fp32 through shared memory (a row mixes
  // columns c and c +- rot / 2, held by other lanes, or past d 128 by the
  // strip's other warp); dv as it is
#pragma unroll
  for (int j = 0; j < kNO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] *= opt.scale;
  float* out_s = reinterpret_cast<float*>(fsmem) + 16 * strip * C::kOutLd;
  if (opt.rot > 0) {
    __syncthreads();  // every warp is done with K, V and the ring
#pragma unroll
    for (int j = 0; j < kNO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out_s[(g4 + 8 * (e >> 1)) * C::kOutLd + cb + 8 * j + 2 * t4 +
              (e & 1)] = dk[j][e];
    if (W::kParts > 1)
      __syncthreads();
    else
      __syncwarp();
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = kw0 + g4 + 8 * h;
    if (row >= opt.s) continue;
    T* dk_dst = dqkv + lay.k(grp, opt.qpg, row, d);
    T* dv_dst = dqkv + lay.v(grp, opt.qpg, row, d);
    const float* r_s = out_s + (g4 + 8 * h) * C::kOutLd;
#pragma unroll
    for (int j = 0; j < kNO; ++j) {
      const int col = cb + 8 * j + 2 * t4;
      float x = dk[j][2 * h];
      float y = dk[j][2 * h + 1];
      if (opt.rot > 0) {
        x = col < d ? unrotate(r_s, opt, row, col) : 0.f;
        y = col + 1 < d ? unrotate(r_s, opt, row, col + 1) : 0.f;
      }
      store_pair(dk_dst, col, d, x, y);
      store_pair(dv_dst, col, d, dv[j][2 * h], dv[j][2 * h + 1]);
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
  static constexpr int kOutLd = DMAX + 4;  // fp32 dq rows to un-rotate
  static constexpr int kQD = 2 * kRows * kLd * 2;  // Q, then dO, bytes
  static constexpr int kStage = 2 * BK * kLd * 2;  // K, then V, bytes
  static constexpr size_t bytes = kQD + STAGES * kStage;
  static constexpr int kMinBlocks = DMAX <= 64 ? 3 : DMAX <= 128 ? 2 : 1;  // dq
  static_assert(kRows * kOutLd * 4 <= kQD, "dq tile fits");
  static_assert(bytes <= 232448, "one block fits an SM");
};

template <typename T, int DMAX, int WARPS, int STAGES, int BK, bool VEC>
__global__ void __launch_bounds__(WARPS * 32,
                                  (DqCfg<DMAX, WARPS, STAGES, BK>::kMinBlocks))
flash_packed_dq_mma(const T* __restrict__ qkv, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dqkv,
                    const Opts opt) {
  using C = DqCfg<DMAX, WARPS, STAGES, BK>;
  using W = flash::Cols<DMAX>;
  constexpr int kKS = DMAX / 16;  // k16 steps over d
  constexpr int kNS = BK / 8;     // n8 score tiles (keys) a warp
  constexpr int kNO = W::kWidth / 8;  // n8 output tiles a warp
  extern __shared__ __align__(16) unsigned char fsmem[];
  T* Qs = reinterpret_cast<T*>(fsmem);
  T* dOs = Qs + C::kRows * C::kLd;
  T* kv = reinterpret_cast<T*>(fsmem + C::kQD);  // the ring's stages

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g4 = lane / 4;
  const int t4 = lane % 4;
  const int strip = warp / W::kParts;  // the warp's 16 query rows
  const int cb = warp % W::kParts * W::kWidth;  // its first output column
  const int hh = blockIdx.x;
  const int bb = blockIdx.y;
  const int qt = opt.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q_start = qt * C::kRows;
  const int r0 = q_start + 16 * strip;  // the warp's first row
  const int grp = hh / opt.qpg;
  const int d = opt.d;
  const int heads = opt.groups * opt.qpg;
  const Layout lay(opt, bb);
  const int kvl = opt.kv_lengths != nullptr ? opt.kv_lengths[bb] : opt.s;
  int first, last;
  key_tiles(opt, kvl, q_start, &first, &last, C::kRows, BK);
  const int tiles = last - first + 1;

  float dq[kNO][4];
#pragma unroll
  for (int j = 0; j < kNO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  if (tiles > 0) {
    const bool drop = opt.seed != nullptr;
    const unsigned seed = drop ? static_cast<unsigned>(opt.seed[0]) : 0u;
    const unsigned cmb = combo(bb, hh);
    const long long hd = static_cast<long long>(heads) * d;
    const long long stat_base =
        (static_cast<long long>(bb) * heads + hh) * opt.s;
    float lse_r[2], delta_r[2];  // the thread's rows g4 and g4 + 8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + g4 + 8 * h;
      lse_r[h] = row < opt.s ? lse[stat_base + row] : 0.f;
      delta_r[h] = row < opt.s ? delta[stat_base + row] : 0.f;
    }
    const long long kcol = lay.k(grp, opt.qpg, 0, d);
    const long long vcol = lay.v(grp, opt.qpg, 0, d);
    auto load_kv = [&](int tile, T* stage) {
      flash::copy_tile<BK, DMAX, C::kThreads, VEC>(
          stage, qkv, kcol, lay.row_stride, tile * BK, opt.s, d);
      flash::copy_tile<BK, DMAX, C::kThreads, VEC>(
          stage + BK * C::kLd, qkv, vcol, lay.row_stride, tile * BK, opt.s,
          d);
    };
    flash::copy_tile<C::kRows, DMAX, C::kThreads, VEC>(
        Qs, qkv, lay.q(grp, hh % opt.qpg, 0, d), lay.row_stride, q_start,
        opt.s, d);
    flash::copy_tile<C::kRows, DMAX, C::kThreads, VEC>(
        dOs, dout, bb * hd + static_cast<long long>(hh) * d, opt.b * hd,
        q_start, opt.s, d);
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
      T* Ks = kv + (it % STAGES) * (C::kStage / 2);
      const T* Vs = Ks + BK * C::kLd;
      const int c0 = (first + it) * BK;
      if (opt.rot > 0) {
        if (it == 0)
          flash::rope_tile<C::kRows, C::kThreads>(Qs, C::kLd, q_start, opt);
        flash::rope_tile<BK, C::kThreads>(Ks, C::kLd, c0, opt);
        __syncthreads();
      }
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

      const flash::Cover cover = flash::tile_cover(opt, kvl, r0, c0, BK);
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
          float x = sc[j][e] * opt.scale - lse_r[e >> 1];
          if (cover == flash::kSome && !visible(opt, kvl, row, col)) x = kNeg;
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
          for (int e = 0; e < 4; ++e) {
            float dpv = dp[j][e];
            if (drop) {
              const unsigned row = r0 + g4 + 8 * (e >> 1);
              const unsigned col = c0 + 16 * c + 8 * j + 2 * t4 + (e & 1);
              dpv = hash_keep(seed, cmb, row, col, opt.keep_thresh)
                        ? dpv * opt.inv_keep : 0.f;
            }
            dp[j][e] = sc[2 * c + j][e] * (dpv - delta_r[e >> 1]);  // ds
          }
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

  // dq = scale * acc, un-rotated in fp32 through shared memory, rounded once
#pragma unroll
  for (int j = 0; j < kNO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] *= opt.scale;
  float* out_s = reinterpret_cast<float*>(fsmem) + 16 * strip * C::kOutLd;
  if (opt.rot > 0) {
    __syncthreads();  // every warp is done with Q and dO
#pragma unroll
    for (int j = 0; j < kNO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out_s[(g4 + 8 * (e >> 1)) * C::kOutLd + cb + 8 * j + 2 * t4 +
              (e & 1)] = dq[j][e];
    if (W::kParts > 1)
      __syncthreads();
    else
      __syncwarp();
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g4 + 8 * h;
    if (row >= opt.s) continue;
    T* dst = dqkv + lay.q(grp, hh % opt.qpg, row, d);
    const float* r_s = out_s + (g4 + 8 * h) * C::kOutLd;
#pragma unroll
    for (int j = 0; j < kNO; ++j) {
      const int col = cb + 8 * j + 2 * t4;
      float x = dq[j][2 * h];
      float y = dq[j][2 * h + 1];
      if (opt.rot > 0) {
        x = col < d ? unrotate(r_s, opt, row, col) : 0.f;
        y = col + 1 < d ? unrotate(r_s, opt, row, col + 1) : 0.f;
      }
      store_pair(dst, col, d, x, y);
    }
  }
}

// 4 warps a block in both passes (8 at d 256, two warps a strip of 16
// keys or queries; 8 at 512, four warps a strip, so a block owns 32 keys
// or queries with up to 255 registers a thread); at d <= 64 query tiles
// of 64 rows in the dk/dv ring, from 128 on of 32 (the score tiles'
// registers beside dk and dv); key tiles of 64 in the dq ring, 32 at 512
// (two stages of 64 would need 332,800 bytes beside Q and dO).
// 16-byte copies need every row start (a multiple of d past a 16-byte
// aligned base) on a 16-byte boundary.
template <typename T, int DMAX>
cudaError_t launch_mma(const void* qkv, const void* dout, const void* out,
                       float* delta, const float* lse, void* dqkv,
                       const Opts& opt, cudaStream_t stream) {
  constexpr int kDkvWarps = DMAX <= 128 ? 4 : 8;
  constexpr int kDkvStages = 2;
  constexpr int kDqWarps = DMAX <= 128 ? 4 : 8;
  constexpr int kDqStages = 2;
  constexpr int kBQ = DMAX <= 64 ? 64 : 32;
  constexpr int kKeys = DMAX <= 256 ? kBK : 32;  // the dq ring's key tiles
  using KvC = DkvCfg<DMAX, kDkvWarps, kBQ, kDkvStages>;
  using QC = DqCfg<DMAX, kDqWarps, kDqStages, kKeys>;
  const auto* x = static_cast<const T*>(qkv);
  const auto* dy = static_cast<const T*>(dout);
  const auto* y = static_cast<const T*>(out);
  auto* dx = static_cast<T*>(dqkv);
  const int heads = opt.groups * opt.qpg;
  const bool vec = opt.d % 8 == 0 &&
                   reinterpret_cast<unsigned long long>(qkv) % 16 == 0 &&
                   reinterpret_cast<unsigned long long>(dout) % 16 == 0;
  const bool vec_o =
      vec && reinterpret_cast<unsigned long long>(out) % 16 == 0;
  cudaError_t err = flash::launch_delta<KernelF>(
      dy, y, delta, static_cast<long long>(opt.s) * opt.b * heads,
      opt.b * heads, opt.s, opt.d, vec_o, stream);
  if (err != cudaSuccess) return err;
  auto dkv =
      vec ? flash_packed_dkv_mma<T, DMAX, kDkvWarps, kBQ, kDkvStages, true>
          : flash_packed_dkv_mma<T, DMAX, kDkvWarps, kBQ, kDkvStages, false>;
  auto dq = vec
                ? flash_packed_dq_mma<T, DMAX, kDqWarps, kDqStages, kKeys, true>
                : flash_packed_dq_mma<T, DMAX, kDqWarps, kDqStages, kKeys,
                                      false>;
  err = apex::allow_smem(dkv, KvC::bytes);
  if (err != cudaSuccess) return err;
  err = apex::allow_smem(dq, QC::bytes);
  if (err != cudaSuccess) return err;
  const dim3 dkv_grid(opt.groups, opt.b,
                      (opt.s + KvC::kKeys - 1) / KvC::kKeys);
  dkv<<<dkv_grid, KvC::kThreads, KvC::bytes, stream>>>(x, dy, lse, delta, dx,
                                                       opt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 dq_grid(heads, opt.b, (opt.s + QC::kRows - 1) / QC::kRows);
  dq<<<dq_grid, QC::kThreads, QC::bytes, stream>>>(x, dy, lse, delta, dx,
                                                   opt);
  return cudaGetLastError();
}

// the bf16 and fp16 paths
template <typename T>
cudaError_t launch_16(const void* qkv, const void* dout, const void* out,
                      const float* lse, float* delta, void* dqkv,
                      const Opts& opt, cudaStream_t stream) {
  if (opt.d <= 64)
    return launch_mma<T, 64>(qkv, dout, out, delta, lse, dqkv, opt, stream);
  if (opt.d <= 128)
    return launch_mma<T, 128>(qkv, dout, out, delta, lse, dqkv, opt, stream);
  if (opt.d <= 256)
    return launch_mma<T, 256>(qkv, dout, out, delta, lse, dqkv, opt, stream);
  if (opt.d <= 512)
    return launch_mma<T, 512>(qkv, dout, out, delta, lse, dqkv, opt, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// qkv and dqkv [s, b, groups * (qpg + 2) * d]; dout and out
// [s, b, groups * qpg * d], all four of one dtype (f32, bf16 or fp16;
// another code is cudaErrorInvalidValue); lse and the delta scratch
// [b, groups * qpg, s] fp32; all contiguous. kv_lengths, cos/sin and seed as in
// apex_flash_packed_fwd, and the same values the forward was given. Any
// d > 0: past 512 the wide instance (flash_wide_bwd.cu), which needs
// grad32, fp32 scratch [s, b, groups * (qpg + 1), d], and with RoPE rot_qkv,
// scratch like qkv (both null at d <= 512).
extern "C" int apex_flash_packed_bwd(const void* qkv, const void* dout,
                                     const void* out, const void* lse,
                                     void* delta, void* dqkv,
                                     const void* kv_lengths, const void* cos,
                                     const void* sin, const void* seed,
                                     void* grad32, void* rot_qkv,
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
  if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (d > apex::wide::kMaxTiled)
    return static_cast<int>(apex::wide::bwd_packed(
        qkv, dout, out, l, dl, dqkv, static_cast<float*>(grad32), rot_qkv,
        opt, dtype, st));
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == apex::kBF16)
    err = launch_16<__nv_bfloat16>(qkv, dout, out, l, dl, dqkv, opt, st);
  else if (dtype == apex::kF16)
    err = launch_16<__half>(qkv, dout, out, l, dl, dqkv, opt, st);
  else if (dtype == apex::kF32)
    err = launch_d<float>(qkv, dout, out, l, dl, dqkv, opt, st);
  return static_cast<int>(err);
}

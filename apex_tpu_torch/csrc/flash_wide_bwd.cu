// Flash attention backward past head_dim 512: Kernel I's and Kernel F's
// wide instance (flash_wide.cuh says what it replaces and how d is split).
//
// Semantics as the DMAX instances (flash_bwd.cu, flash_packed_bwd.cu):
// p = exp(scale s - lse) with masked scores at -1e30, delta = rowsum(do *
// o) in fp32 (or the caller's delta), dp = do v^T (masked and rescaled by
// the dropout keep mask in F), ds = p (dp - delta); dq = scale ds k and dk
// = scale ds^T q with ds rounded to the input type, dv = drop(p)^T do with
// the dropped p rounded likewise; dk and dv summed in fp32 over the group's
// query heads; one rounding at the store (F: after the un-rotation).
//
// Bound on the H100: at the d-1024 training shape (qkv [1024, 2, 6144],
// causal, bf16) the work is 10 d a visible pair, 43 GFLOP (44 us at the
// bf16 tensor rate), against ~66 MB moved (20 us): operations bound it.
// These passes do 2 x 4 x 2 d cdiv(d, 512) (S and dP in both passes, by
// each of a strip's four warps, in each part) + 6 d a visible pair: 70 d
// at d 1024.
//
// bf16 and fp16 (T), three launches (F adds the un-rotation):
// - delta prep (flash::delta_kernel, one warp a row), unless given;
// - dk/dv pass: one block of 8 warps per (kv head x part, batch, 32-key
//   tile); two strips of 16 keys, four warps a strip owning 128 of the
//   part's columns of dk and dv. For each of the group's query heads and
//   visible 32-query tiles it streams cdiv(d, 256) stages of (K, Q)
//   slices, as many of (V, dO), then the part's 512 columns of dO and of Q
//   through a 3-stage cp.async ring: S^T and dP^T on mma.sync with each
//   16-deep product added by an IEEE fp32 add (flash_mma.cuh kAddSums, as
//   past d 128), p from lse, the dropout hash, p and ds rounded to T into A
//   fragments, dV += P^T dO and dK += dS^T Q;
// - dq pass: one block per (head x part, batch, 32-query tile), the
//   heaviest causal tiles first: (Q, K) slices, (dO, V) slices, then the
//   part's columns of K: S, dP, ds rounded to T, dq += dS K.
// No atomics: every output element has one owner, so repeated runs are
// bitwise equal.
//
// f32 (checks only), two launches of fp32 tiles in shared memory and fp32
// FMA, S and dP from 64-column slices: pass 1 per (16-row query tile, head
// x part, batch) forms delta (kept for pass 2 unless given) and dq; pass 2
// per (16-key tile, kv head x part, batch) dk and dv.
//
// F's dq and dk go in fp32 to a scratch [s, b, H + G, d]; packed_finish
// un-rotates them (packed::unrotate, -sin) and rounds them once into dqkv.
#include "flash_wide.cuh"

namespace {

using namespace apex::packed;  // kNeg, Mask, visible, key_tiles, query_tiles
namespace flash = apex::flash;
namespace ring = apex::ring;
namespace wide = apex::wide;
using wide::Args;
using wide::View;

constexpr int kWarps = 8;
constexpr int kThreads16 = kWarps * 32;
constexpr int kRows = 32;    // query rows (dq pass) or keys (dk/dv) a block
constexpr int kTile = 32;    // keys (dq pass) or queries (dk/dv) a tile
constexpr int kWidth = 128;  // output columns a warp
constexpr int kSlice = 256;  // columns of a streamed slice
constexpr int kSliceLd = flash::Tile<kSlice>::kLd;
constexpr int kPartLd = flash::Tile<wide::kPart>::kLd;
constexpr int kStages = 3;
constexpr int kStageElems = (kRows + kTile) * kSliceLd > kTile * kPartLd
                                ? (kRows + kTile) * kSliceLd
                                : kTile * kPartLd;
constexpr int kStageBytes = kStageElems * 2;
constexpr size_t kSmem16 = static_cast<size_t>(kStages) * kStageBytes;
static_assert(kSmem16 <= 232448, "one block fits an SM");
constexpr int kNS = kTile / 8;    // n8 score tiles a warp
constexpr int kNO = kWidth / 8;   // n8 output tiles a warp

// the tags that name the delta prep passes in a profile
struct KernelIWide {};
struct KernelFWide {};

// acc += A B^T over one slice: A the warp's 16 rows of `as`, B the kTile
// rows of `bs` (both kSliceLd-strided), each product added in fp32
template <typename T>
__device__ __forceinline__ void slice_sum(float (&acc)[kNS][4], const T* as,
                                          const T* bs) {
#pragma unroll 4
  for (int kk = 0; kk < kSlice / 16; ++kk) {
    unsigned fa[1][4];
    ring::load_a<1, false>(fa, as, kSliceLd, 16 * kk);
    unsigned fb[kNS / 2][4];
    ring::load_b<kNS, false>(fb, bs, kSliceLd, 16 * kk);
#pragma unroll
    for (int j = 0; j < kNS; ++j)
      flash::mma_sum<T, true>(acc[j], fa[0], fb[j >> 1][2 * (j & 1)],
                              fb[j >> 1][2 * (j & 1) + 1]);
  }
}

// acc += F B over the kTile rows of a part stage: F the T fragments of
// `v` (kNS n8 tiles, rounded once), B the part's columns from the warp's cb
template <typename T>
__device__ __forceinline__ void part_sum(float (&acc)[kNO][4],
                                         const float (&v)[kNS][4],
                                         const T* part) {
#pragma unroll
  for (int c = 0; c < kTile / 16; ++c) {
    unsigned fa[4];
    flash::fragment16<kNS, T>(v, c, fa);
    unsigned fb[kNO / 2][4];
    ring::load_b<kNO, true>(fb, part, kPartLd, 16 * c);
#pragma unroll
    for (int j = 0; j < kNO; ++j)
      flash::mma_acc<T>(acc[j], fa, fb[j >> 1][2 * (j & 1)],
                        fb[j >> 1][2 * (j & 1) + 1]);
  }
}

__device__ __forceinline__ void zero(float (&x)[kNS][4]) {
#pragma unroll
  for (int j = 0; j < kNS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
}

// The dq pass. TG: dq's type (T, or F's fp32 scratch)
template <typename T, typename TG, bool VEC>
__global__ void __launch_bounds__(kThreads16, 1)
dq_mma(const Args a) {
  extern __shared__ __align__(16) unsigned char wsmem[];
  const Mask& mk = a.mask;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g4 = lane / 4;
  const int t4 = lane % 4;
  const int strip = warp / 4;
  const int cb = warp % 4 * kWidth;
  const int parts = wide::cdiv(a.d, wide::kPart);
  const int hh = blockIdx.x / parts;
  const int p0 = blockIdx.x % parts * wide::kPart;
  const int bb = blockIdx.y;
  const int qt = mk.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q_start = qt * kRows;
  const int r0 = q_start + 16 * strip;
  const int group = a.H / a.KVH;
  const long long qb = a.vq.base(bb, hh);
  const long long ob = a.vo.base(bb, hh);
  const long long kb = a.vk.base(bb, hh / group);
  const long long rb = (static_cast<long long>(bb) * a.H + hh) * mk.sq;
  const int kvl = local_kvl(mk, a.kv_lengths, bb);
  int first, last;
  key_tiles(mk, kvl, q_start, &first, &last, kRows, kTile);
  const int tiles = last - first + 1;
  const int slices = wide::cdiv(a.d, kSlice);
  const int per_tile = 2 * slices + 1;  // (Q, K), (dO, V), K's part

  float dq[kNO][4];
#pragma unroll
  for (int j = 0; j < kNO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  float sc[kNS][4];
  float dp[kNS][4];
  zero(sc);
  zero(dp);

  if (tiles > 0) {
    const bool drop = a.seed != nullptr;
    const unsigned seed = drop ? static_cast<unsigned>(a.seed[0]) : 0u;
    const unsigned cmb = combo(bb, hh);
    float lse_r[2], delta_r[2];  // the thread's rows g4 and g4 + 8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + g4 + 8 * h;
      lse_r[h] = row < mk.sq ? a.lse[rb + row] : 0.f;
      delta_r[h] = row < mk.sq ? a.delta[rb + row] : 0.f;
    }
    int loaded = 0;
    auto load = [&](unsigned char* st_) {
      T* st = reinterpret_cast<T*>(st_);
      const int u = loaded % per_tile;
      const int c0 = (first + loaded / per_tile) * kTile;
      ++loaded;
      if (u < 2 * slices) {
        const bool s_part = u < slices;
        const int col = (s_part ? u : u - slices) * kSlice;
        flash::copy_tile<kRows, kSlice, kThreads16, VEC>(
            st, s_part ? q : dout, (s_part ? qb : ob) + col,
            s_part ? a.vq.sr : a.vo.sr, q_start, mk.sq, a.d - col);
        flash::copy_tile<kTile, kSlice, kThreads16, VEC>(
            st + kRows * kSliceLd, s_part ? k : v, kb + col, a.vk.sr, c0,
            mk.sk, a.d - col);
      } else {
        flash::copy_tile<kTile, wide::kPart, kThreads16, VEC>(
            st, k, kb + p0, a.vk.sr, c0, mk.sk, a.d - p0);
      }
    };
    int done = 0;
    auto step = [&](unsigned char* st_) {
      const T* st = reinterpret_cast<const T*>(st_);
      const int u = done % per_tile;
      const int c0 = (first + done / per_tile) * kTile;
      ++done;
      const flash::Cover cover = flash::tile_cover(mk, kvl, r0, c0, kTile);
      if (cover == flash::kNone) return;  // nothing summed
      const T* as = st + 16 * strip * kSliceLd;
      const T* bs = st + kRows * kSliceLd;
      if (u < slices) {
        slice_sum<T>(sc, as, bs);  // S += Q K^T
        return;
      }
      if (u < 2 * slices) {
        slice_sum<T>(dp, as, bs);  // dP += dO V^T
        return;
      }
      // p = exp(scale s - lse) (0 where masked), ds = p (dp - delta)
#pragma unroll
      for (int j = 0; j < kNS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + g4 + 8 * (e >> 1);
          const int col = c0 + 8 * j + 2 * t4 + (e & 1);
          float x = sc[j][e] * a.scale - lse_r[e >> 1];
          if (cover == flash::kSome && !visible(mk, kvl, row, col)) x = kNeg;
          const float p = flash::fast_exp(x);
          float dpv = dp[j][e];
          if (drop)
            dpv = hash_keep(seed, cmb, row, col, a.keep_thresh)
                      ? dpv * a.inv_keep : 0.f;
          dp[j][e] = p * (dpv - delta_r[e >> 1]);
        }
      part_sum<T>(dq, dp, st + cb);  // dq += dS K
      zero(sc);
      zero(dp);
    };
    ring::run_ring<kStages, kStageBytes>(tiles * per_tile, wsmem, load,
                                         step);
  }

  TG* out = static_cast<TG*>(a.dq);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g4 + 8 * h;
    if (row >= mk.sq) continue;
    TG* dst = out + a.vdq.base(bb, hh) + static_cast<long long>(row) *
              a.vdq.sr + p0;
#pragma unroll
    for (int j = 0; j < kNO; ++j)
      wide::store_out(dst, cb + 8 * j + 2 * t4, a.d - p0,
                      dq[j][2 * h] * a.scale, dq[j][2 * h + 1] * a.scale);
  }
}

// The dk/dv pass. TG: dk's type (T, or F's fp32 scratch); dv is T
template <typename T, typename TG, bool VEC>
__global__ void __launch_bounds__(kThreads16, 1)
dkv_mma(const Args a) {
  extern __shared__ __align__(16) unsigned char wsmem[];
  const Mask& mk = a.mask;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g4 = lane / 4;
  const int t4 = lane % 4;
  const int strip = warp / 4;  // the warp's 16 keys
  const int cb = warp % 4 * kWidth;
  const int parts = wide::cdiv(a.d, wide::kPart);
  const int kvh = blockIdx.x / parts;
  const int p0 = blockIdx.x % parts * wide::kPart;
  const int bb = blockIdx.y;
  const int k_start = blockIdx.z * kRows;
  const int kw0 = k_start + 16 * strip;
  const int group = a.H / a.KVH;
  const long long kb = a.vk.base(bb, kvh);
  const int kvl = local_kvl(mk, a.kv_lengths, bb);
  int first, last;
  query_tiles(mk, kvl, k_start, &first, &last, kRows, kTile);
  const int nt = last - first + 1;
  const int n = nt > 0 ? nt * group : 0;  // (head, query tile) pairs
  const int slices = wide::cdiv(a.d, kSlice);
  const int per = 2 * slices + 2;  // (K, Q), (V, dO), dO's part, Q's part

  float dk[kNO][4];
  float dv[kNO][4];
#pragma unroll
  for (int j = 0; j < kNO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  float sc[kNS][4];
  float dp[kNS][4];
  zero(sc);
  zero(dp);

  if (n > 0) {
    const bool drop = a.seed != nullptr;
    const unsigned seed = drop ? static_cast<unsigned>(a.seed[0]) : 0u;
    int loaded = 0;
    auto load = [&](unsigned char* st_) {
      T* st = reinterpret_cast<T*>(st_);
      const int i = loaded / per;
      const int u = loaded % per;
      ++loaded;
      const int hh = kvh * group + i / nt;
      const int q0 = (first + i % nt) * kTile;
      const long long qb = a.vq.base(bb, hh);
      const long long ob = a.vo.base(bb, hh);
      if (u < 2 * slices) {
        const bool s_part = u < slices;
        const int col = (s_part ? u : u - slices) * kSlice;
        flash::copy_tile<kRows, kSlice, kThreads16, VEC>(
            st, s_part ? k : v, kb + col, a.vk.sr, k_start, mk.sk,
            a.d - col);
        flash::copy_tile<kTile, kSlice, kThreads16, VEC>(
            st + kRows * kSliceLd, s_part ? q : dout,
            (s_part ? qb : ob) + col, s_part ? a.vq.sr : a.vo.sr, q0, mk.sq,
            a.d - col);
      } else {
        const bool o_part = u == 2 * slices;
        flash::copy_tile<kTile, wide::kPart, kThreads16, VEC>(
            st, o_part ? dout : q, (o_part ? ob : qb) + p0,
            o_part ? a.vo.sr : a.vq.sr, q0, mk.sq, a.d - p0);
      }
    };
    int done = 0;
    auto step = [&](unsigned char* st_) {
      const T* st = reinterpret_cast<const T*>(st_);
      const int i = done / per;
      const int u = done % per;
      ++done;
      const int hh = kvh * group + i / nt;
      const int q0 = (first + i % nt) * kTile;
      const flash::Cover cover =
          flash::tile_cover(mk, kvl, q0, kw0, 16, kTile);
      if (cover == flash::kNone) return;
      const T* as = st + 16 * strip * kSliceLd;
      const T* bs = st + kRows * kSliceLd;
      if (u < slices) {
        slice_sum<T>(sc, as, bs);  // S^T += K Q^T
        return;
      }
      if (u < 2 * slices) {
        slice_sum<T>(dp, as, bs);  // dP^T += V dO^T
        return;
      }
      if (u == 2 * slices) {
        // p from lse (0 where masked), the dropped p and ds; dV += P^T dO
        const long long rb = (static_cast<long long>(bb) * a.H + hh) * mk.sq;
        const unsigned cmb = combo(bb, hh);
#pragma unroll
        for (int j = 0; j < kNS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = q0 + 8 * j + 2 * t4 + (e & 1);
            const int col = kw0 + g4 + 8 * (e >> 1);
            const bool in = row < mk.sq;
            float x = sc[j][e] * a.scale - (in ? a.lse[rb + row] : 0.f);
            if (cover == flash::kSome && !visible(mk, kvl, row, col))
              x = kNeg;
            const float p = flash::fast_exp(x);
            float dpv = dp[j][e];
            float pd = p;
            if (drop) {
              const bool keep =
                  hash_keep(seed, cmb, row, col, a.keep_thresh);
              pd = keep ? p * a.inv_keep : 0.f;
              dpv = keep ? dpv * a.inv_keep : 0.f;
            }
            sc[j][e] = pd;
            dp[j][e] = p * (dpv - (in ? a.delta[rb + row] : 0.f));  // ds
          }
        part_sum<T>(dv, sc, st + cb);
        return;
      }
      part_sum<T>(dk, dp, st + cb);  // dK += dS^T Q
      zero(sc);
      zero(dp);
    };
    ring::run_ring<kStages, kStageBytes>(n * per, wsmem, load, step);
  }

  TG* dk_out = static_cast<TG*>(a.dk);
  T* dv_out = static_cast<T*>(a.dv);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = kw0 + g4 + 8 * h;
    if (row >= mk.sk) continue;
    TG* dk_dst = dk_out + a.vdk.base(bb, kvh) +
                 static_cast<long long>(row) * a.vdk.sr + p0;
    T* dv_dst = dv_out + a.vdv.base(bb, kvh) +
                static_cast<long long>(row) * a.vdv.sr + p0;
#pragma unroll
    for (int j = 0; j < kNO; ++j) {
      const int col = cb + 8 * j + 2 * t4;
      wide::store_out(dk_dst, col, a.d - p0, dk[j][2 * h] * a.scale,
                      dk[j][2 * h + 1] * a.scale);
      flash::store_pair(dv_dst, col, a.d - p0, dv[j][2 * h],
                        dv[j][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: the blocks' own 16 rows (queries in pass 1, keys in pass 2), tiles
// of 32 they walk, 64-column slices for S and dP, the part's 512 columns
// ---------------------------------------------------------------------------

constexpr int kFR = 16;
constexpr int kFO = 32;
constexpr int kFS = 64;
constexpr int kFThreads = 256;
constexpr int kFSC = kFO / 16;             // score columns a thread
constexpr int kFCols = wide::kPart / 16;   // output columns a thread
constexpr int kFRS = kFS + 4;              // rows read by ty (broadcast)
constexpr int kFCS = kFS + 1;              // rows read by tx
constexpr int kFSS = kFO + 1;

struct DqSmem {
  static constexpr size_t floats = 2 * kFR * kFRS + 2 * kFO * kFCS +
                                   kFO * wide::kPart + kFR * kFSS + 2 * kFR;
  static_assert(floats * 4 <= 232448, "one block fits an SM");
};
struct DkvSmem {
  static constexpr size_t floats = 2 * kFR * kFRS + 2 * kFO * kFCS +
                                   2 * kFO * wide::kPart + 2 * kFR * kFSS +
                                   2 * kFO;
  static_assert(floats * 4 <= 232448, "one block fits an SM");
};

// rows [pos0, pos0 + ROWS) x columns [c0, c0 + kFS) of one head of an
// operand into dst (stride ld), 0 past s and d
template <int ROWS, int COLS>
__device__ __forceinline__ void load_f32(float* dst, int ld, const float* p,
                                         long long base, long long sr,
                                         int pos0, int s, int c0, int d) {
  for (int idx = threadIdx.x; idx < ROWS * COLS; idx += kFThreads) {
    const int r = idx / COLS;
    const int c = idx % COLS;
    const int pos = pos0 + r;
    dst[r * ld + c] = pos < s && c0 + c < d
        ? p[base + static_cast<long long>(pos) * sr + c0 + c] : 0.f;
  }
}

__global__ void __launch_bounds__(kFThreads)
dq_f32(const Args a) {
  extern __shared__ float fsm[];
  float* Qs = fsm;                    // [kFR][kFRS]
  float* dOs = Qs + kFR * kFRS;       // [kFR][kFRS]
  float* Ks = dOs + kFR * kFRS;       // [kFO][kFCS]
  float* Vs = Ks + kFO * kFCS;        // [kFO][kFCS]
  float* Kp = Vs + kFO * kFCS;        // [kFO][kPart]
  float* dSs = Kp + kFO * wide::kPart;  // [kFR][kFSS]
  float* lse_s = dSs + kFR * kFSS;
  float* delta_s = lse_s + kFR;
  const Mask& mk = a.mask;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  const float* out = static_cast<const float*>(a.out);

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q_start = blockIdx.x * kFR;
  const int parts = wide::cdiv(a.d, wide::kPart);
  const int hh = blockIdx.y / parts;
  const int p0 = blockIdx.y % parts * wide::kPart;
  const int bb = blockIdx.z;
  const int d = a.d;
  const int group = a.H / a.KVH;
  const long long qb = a.vq.base(bb, hh);
  const long long ob = a.vo.base(bb, hh);
  const long long kb = a.vk.base(bb, hh / group);
  const long long rb = (static_cast<long long>(bb) * a.H + hh) * mk.sq;
  const bool drop = a.seed != nullptr;
  const unsigned seed = drop ? static_cast<unsigned>(a.seed[0]) : 0u;
  const unsigned cmb = combo(bb, hh);

  // delta = rowsum(do * o): one warp a row over all of d (every part alike;
  // part 0 keeps it for pass 2), or the caller's
  for (int r = warp; r < kFR; r += kFThreads / 32) {
    const int row = q_start + r;
    float part = 0.f;
    if (a.delta_given) {
      if (row < mk.sq) part = a.delta[rb + row];
    } else {
      if (row < mk.sq) {
        const long long base = ob + static_cast<long long>(row) * a.vo.sr;
        for (int c = lane; c < d; c += 32) part += dout[base + c] * out[base + c];
      }
      part = apex::warp_sum(part);
    }
    if (lane == 0) {
      delta_s[r] = part;
      lse_s[r] = row < mk.sq ? a.lse[rb + row] : 0.f;
      if (row < mk.sq && !a.delta_given && p0 == 0) a.delta[rb + row] = part;
    }
  }
  float acc[kFCols];
#pragma unroll
  for (int c = 0; c < kFCols; ++c) acc[c] = 0.f;

  const int kvl = local_kvl(mk, a.kv_lengths, bb);
  int j_first, j_last;
  key_tiles(mk, kvl, q_start, &j_first, &j_last, kFR, kFO);
  for (int jt = j_first; jt <= j_last; ++jt) {
    const int k0 = jt * kFO;
    float sc[kFSC], dp[kFSC];
#pragma unroll
    for (int jj = 0; jj < kFSC; ++jj) sc[jj] = dp[jj] = 0.f;
    for (int c0 = 0; c0 < d; c0 += kFS) {
      __syncthreads();  // the previous readers are done
      load_f32<kFR, kFS>(Qs, kFRS, q, qb, a.vq.sr, q_start, mk.sq, c0, d);
      load_f32<kFR, kFS>(dOs, kFRS, dout, ob, a.vo.sr, q_start, mk.sq, c0,
                         d);
      load_f32<kFO, kFS>(Ks, kFCS, k, kb, a.vk.sr, k0, mk.sk, c0, d);
      load_f32<kFO, kFS>(Vs, kFCS, v, kb, a.vk.sr, k0, mk.sk, c0, d);
      __syncthreads();
      for (int c = 0; c < kFS; ++c) {
        const float qv = Qs[ty * kFRS + c];
        const float dov = dOs[ty * kFRS + c];
#pragma unroll
        for (int jj = 0; jj < kFSC; ++jj) {
          sc[jj] = fmaf(qv, Ks[(tx + 16 * jj) * kFCS + c], sc[jj]);
          dp[jj] = fmaf(dov, Vs[(tx + 16 * jj) * kFCS + c], dp[jj]);
        }
      }
    }
    load_f32<kFO, wide::kPart>(Kp, wide::kPart, k, kb, a.vk.sr, k0, mk.sk,
                               p0, d);
    const int row = q_start + ty;
#pragma unroll
    for (int jj = 0; jj < kFSC; ++jj) {
      const int col = k0 + tx + 16 * jj;
      float ds = 0.f;
      if (visible(mk, kvl, row, col)) {
        const float p = expf(sc[jj] * a.scale - lse_s[ty]);
        float dpv = dp[jj];
        if (drop)
          dpv = hash_keep(seed, cmb, row, col, a.keep_thresh)
                    ? dpv * a.inv_keep : 0.f;
        ds = p * (dpv - delta_s[ty]);
      }
      dSs[ty * kFSS + tx + 16 * jj] = ds;
    }
    __syncthreads();
    for (int jj = 0; jj < kFO; ++jj) {
      const float dsv = dSs[ty * kFSS + jj];
#pragma unroll
      for (int c = 0; c < kFCols; ++c)
        acc[c] = fmaf(dsv, Kp[jj * wide::kPart + tx + 16 * c], acc[c]);
    }
  }

  const int row = q_start + ty;
  if (row < mk.sq) {
    float* dst = static_cast<float*>(a.dq) + a.vdq.base(bb, hh) +
                 static_cast<long long>(row) * a.vdq.sr + p0;
#pragma unroll
    for (int c = 0; c < kFCols; ++c) {
      const int col = tx + 16 * c;
      if (p0 + col < d) dst[col] = acc[c] * a.scale;
    }
  }
}

__global__ void __launch_bounds__(kFThreads)
dkv_f32(const Args a) {
  extern __shared__ float fsm[];
  float* Ks = fsm;                       // [kFR][kFRS]
  float* Vs = Ks + kFR * kFRS;           // [kFR][kFRS]
  float* Qs = Vs + kFR * kFRS;           // [kFO][kFCS]
  float* dOs = Qs + kFO * kFCS;          // [kFO][kFCS]
  float* Qp = dOs + kFO * kFCS;          // [kFO][kPart]
  float* dOp = Qp + kFO * wide::kPart;   // [kFO][kPart]
  float* Ps = dOp + kFO * wide::kPart;   // dropped p^T [kFR][kFSS]
  float* dSs = Ps + kFR * kFSS;          // ds^T [kFR][kFSS]
  float* lse_s = dSs + kFR * kFSS;
  float* delta_s = lse_s + kFO;
  const Mask& mk = a.mask;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int k_start = blockIdx.x * kFR;
  const int parts = wide::cdiv(a.d, wide::kPart);
  const int kvh = blockIdx.y / parts;
  const int p0 = blockIdx.y % parts * wide::kPart;
  const int bb = blockIdx.z;
  const int d = a.d;
  const int group = a.H / a.KVH;
  const long long kb = a.vk.base(bb, kvh);
  const bool drop = a.seed != nullptr;
  const unsigned seed = drop ? static_cast<unsigned>(a.seed[0]) : 0u;

  float dka[kFCols], dva[kFCols];
#pragma unroll
  for (int c = 0; c < kFCols; ++c) dka[c] = dva[c] = 0.f;
  const int kvl = local_kvl(mk, a.kv_lengths, bb);
  int i_first, i_last;
  query_tiles(mk, kvl, k_start, &i_first, &i_last, kFR, kFO);

  for (int jh = 0; jh < group; ++jh) {
    const int hh = kvh * group + jh;
    const long long qb = a.vq.base(bb, hh);
    const long long ob = a.vo.base(bb, hh);
    const long long rb = (static_cast<long long>(bb) * a.H + hh) * mk.sq;
    const unsigned cmb = combo(bb, hh);
    for (int it = i_first; it <= i_last; ++it) {
      const int q0 = it * kFO;
      float sc[kFSC], dp[kFSC];
#pragma unroll
      for (int jj = 0; jj < kFSC; ++jj) sc[jj] = dp[jj] = 0.f;
      for (int c0 = 0; c0 < d; c0 += kFS) {
        __syncthreads();
        load_f32<kFR, kFS>(Ks, kFRS, k, kb, a.vk.sr, k_start, mk.sk, c0, d);
        load_f32<kFR, kFS>(Vs, kFRS, v, kb, a.vk.sr, k_start, mk.sk, c0, d);
        load_f32<kFO, kFS>(Qs, kFCS, q, qb, a.vq.sr, q0, mk.sq, c0, d);
        load_f32<kFO, kFS>(dOs, kFCS, dout, ob, a.vo.sr, q0, mk.sq, c0, d);
        __syncthreads();
        for (int c = 0; c < kFS; ++c) {
          const float kv = Ks[ty * kFRS + c];
          const float vv = Vs[ty * kFRS + c];
#pragma unroll
          for (int jj = 0; jj < kFSC; ++jj) {
            sc[jj] = fmaf(kv, Qs[(tx + 16 * jj) * kFCS + c], sc[jj]);
            dp[jj] = fmaf(vv, dOs[(tx + 16 * jj) * kFCS + c], dp[jj]);
          }
        }
      }
      load_f32<kFO, wide::kPart>(Qp, wide::kPart, q, qb, a.vq.sr, q0, mk.sq,
                                 p0, d);
      load_f32<kFO, wide::kPart>(dOp, wide::kPart, dout, ob, a.vo.sr, q0,
                                 mk.sq, p0, d);
      if (tid < kFO) {
        const int row = q0 + tid;
        lse_s[tid] = row < mk.sq ? a.lse[rb + row] : 0.f;
        delta_s[tid] = row < mk.sq ? a.delta[rb + row] : 0.f;
      }
      __syncthreads();
      const int col = k_start + ty;
#pragma unroll
      for (int jj = 0; jj < kFSC; ++jj) {
        const int qc = tx + 16 * jj;
        const int row = q0 + qc;
        float pd = 0.f;
        float ds = 0.f;
        if (visible(mk, kvl, row, col)) {
          const float p = expf(sc[jj] * a.scale - lse_s[qc]);
          float dpv = dp[jj];
          pd = p;
          if (drop) {
            const bool keep = hash_keep(seed, cmb, row, col, a.keep_thresh);
            pd = keep ? p * a.inv_keep : 0.f;
            dpv = keep ? dpv * a.inv_keep : 0.f;
          }
          ds = p * (dpv - delta_s[qc]);
        }
        Ps[ty * kFSS + qc] = pd;
        dSs[ty * kFSS + qc] = ds;
      }
      __syncthreads();
      for (int qc = 0; qc < kFO; ++qc) {
        const float pv = Ps[ty * kFSS + qc];
        const float dsv = dSs[ty * kFSS + qc];
#pragma unroll
        for (int c = 0; c < kFCols; ++c) {
          dva[c] = fmaf(pv, dOp[qc * wide::kPart + tx + 16 * c], dva[c]);
          dka[c] = fmaf(dsv, Qp[qc * wide::kPart + tx + 16 * c], dka[c]);
        }
      }
    }
  }

  const int row = k_start + ty;
  if (row < mk.sk) {
    float* dk_dst = static_cast<float*>(a.dk) + a.vdk.base(bb, kvh) +
                    static_cast<long long>(row) * a.vdk.sr + p0;
    float* dv_dst = static_cast<float*>(a.dv) + a.vdv.base(bb, kvh) +
                    static_cast<long long>(row) * a.vdv.sr + p0;
#pragma unroll
    for (int c = 0; c < kFCols; ++c) {
      const int col = tx + 16 * c;
      if (p0 + col < d) {
        dk_dst[col] = dka[c] * a.scale;
        dv_dst[col] = dva[c];
      }
    }
  }
}

// F's last pass: dq and dk from the fp32 scratch [s, b, H + G, d],
// un-rotated (rot > 0) and rounded once into their columns of dqkv
template <typename T>
__global__ void __launch_bounds__(256)
packed_finish(const float* __restrict__ grad32, T* __restrict__ dqkv,
              const Opts opt) {
  const int heads = opt.groups * opt.qpg;
  const int rows_h = heads + opt.groups;
  const long long n = static_cast<long long>(opt.s) * opt.b * rows_h * opt.d;
  const long long w = static_cast<long long>(opt.groups) * (opt.qpg + 2) *
                      opt.d;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * 256) {
    const int c = static_cast<int>(i % opt.d);
    const long long r = i / opt.d;  // (pos, bb, head) row of the scratch
    const int head = static_cast<int>(r % rows_h);
    const int bb = static_cast<int>(r / rows_h % opt.b);
    const int pos = static_cast<int>(r / rows_h / opt.b);
    const int slot = head < heads
        ? head / opt.qpg * (opt.qpg + 2) + head % opt.qpg   // q of head
        : (head - heads) * (opt.qpg + 2) + opt.qpg;         // k of group
    apex::store(&dqkv[static_cast<long long>(pos) * opt.b * w + bb * w +
                      static_cast<long long>(slot) * opt.d + c],
                unrotate(grad32 + r * opt.d, opt, pos, c));
  }
}

template <typename T>
cudaError_t launch_finish(const float* grad32, void* dqkv, const Opts& opt,
                          cudaStream_t stream) {
  const long long n = static_cast<long long>(opt.s) * opt.b *
                      (opt.groups * opt.qpg + opt.groups) * opt.d;
  const unsigned blocks =
      static_cast<unsigned>(n / 256 + 1 < 65536 ? n / 256 + 1 : 65536);
  packed_finish<T><<<blocks, 256, 0, stream>>>(grad32, static_cast<T*>(dqkv),
                                               opt);
  return cudaGetLastError();
}

// the 16-bit passes: delta prep (unless given), dk/dv, dq
template <typename T, typename TG, class TAG, bool VEC>
cudaError_t run_16(const Args& a, long long delta_rows, int inner,
                   cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (!a.delta_given) {
    err = flash::launch_delta<TAG>(
        static_cast<const T*>(a.dout), static_cast<const T*>(a.out),
        a.delta, delta_rows, inner, a.mask.sq, a.d, false, stream);
    if (err != cudaSuccess) return err;
  }
  auto dkv = dkv_mma<T, TG, VEC>;
  auto dq = dq_mma<T, TG, VEC>;
  err = apex::allow_smem(dkv, kSmem16);
  if (err != cudaSuccess) return err;
  err = apex::allow_smem(dq, kSmem16);
  if (err != cudaSuccess) return err;
  const int parts = wide::cdiv(a.d, wide::kPart);
  dkv<<<dim3(a.KVH * parts, a.b, wide::cdiv(a.mask.sk, kRows)), kThreads16,
        kSmem16, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq<<<dim3(a.H * parts, a.b, wide::cdiv(a.mask.sq, kRows)), kThreads16,
       kSmem16, stream>>>(a);
  return cudaGetLastError();
}

// 16-byte copies need d % 8 == 0 and every operand's base 16-byte aligned
template <typename T, typename TG, class TAG>
cudaError_t launch_16(const Args& a, long long delta_rows, int inner,
                      cudaStream_t stream) {
  auto aligned = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  const bool vec = a.d % 8 == 0 && aligned(a.q) && aligned(a.k) &&
                   aligned(a.v) && aligned(a.dout);
  return vec ? run_16<T, TG, TAG, true>(a, delta_rows, inner, stream)
             : run_16<T, TG, TAG, false>(a, delta_rows, inner, stream);
}

cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  const size_t dq_smem = DqSmem::floats * sizeof(float);
  const size_t dkv_smem = DkvSmem::floats * sizeof(float);
  cudaError_t err = apex::allow_smem(dq_f32, dq_smem);
  if (err != cudaSuccess) return err;
  err = apex::allow_smem(dkv_f32, dkv_smem);
  if (err != cudaSuccess) return err;
  const int parts = wide::cdiv(a.d, wide::kPart);
  dq_f32<<<dim3(wide::cdiv(a.mask.sq, kFR), a.H * parts, a.b), kFThreads,
           dq_smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_f32<<<dim3(wide::cdiv(a.mask.sk, kFR), a.KVH * parts, a.b), kFThreads,
            dkv_smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

namespace apex {
namespace wide {

cudaError_t bwd_4d(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv,
                   const int* kvl, int b, int h, int kvh, int d, float scale,
                   const Mask& mask, int delta_given, int dtype,
                   cudaStream_t stream) {
  Args a = args_4d(b, h, kvh, d, scale, mask, kvl);
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.delta_given = delta_given;
  const long long rows = static_cast<long long>(b) * h * mask.sq;
  if (dtype == apex::kBF16)
    return launch_16<__nv_bfloat16, __nv_bfloat16, KernelIWide>(a, rows, 1,
                                                                stream);
  if (dtype == apex::kF16)
    return launch_16<__half, __half, KernelIWide>(a, rows, 1, stream);
  if (dtype == apex::kF32) return launch_f32(a, stream);
  return cudaErrorInvalidValue;
}

cudaError_t bwd_packed(const void* qkv, const void* dout, const void* out,
                       const float* lse, float* delta, void* dqkv,
                       float* grad32, void* rot_qkv, const Opts& opt,
                       int dtype, cudaStream_t stream) {
  const bool rope = opt.rot > 0;
  if (grad32 == nullptr || (rope && rot_qkv == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (rope) {
    err = rope_prep(qkv, rot_qkv, opt, dtype, stream);
    if (err != cudaSuccess) return err;
  }
  const int esz = dtype == apex::kF32 ? 4 : 2;
  Args a = args_packed(opt, rope ? rot_qkv : qkv, qkv, esz);
  const int heads = opt.groups * opt.qpg;
  const long long rows_h = heads + opt.groups;  // the scratch's rows a pos
  const View g32{rows_h * opt.d, opt.d, opt.b * rows_h * opt.d, 1, 0,
                 opt.qpg};
  a.dout = dout;
  a.out = out;
  a.lse = lse;
  a.delta = delta;
  a.dq = grad32;
  a.vdq = g32;
  a.dk = grad32 + static_cast<long long>(heads) * opt.d;
  a.vdk = g32;
  a.dv = static_cast<char*>(dqkv) +
         static_cast<long long>(opt.qpg + 1) * opt.d * esz;
  a.vdv = a.vk;
  const long long rows = static_cast<long long>(opt.s) * opt.b * heads;
  if (dtype == apex::kBF16) {
    err = launch_16<__nv_bfloat16, float, KernelFWide>(
        a, rows, opt.b * heads, stream);
    if (err != cudaSuccess) return err;
    return launch_finish<__nv_bfloat16>(grad32, dqkv, opt, stream);
  }
  if (dtype == apex::kF16) {
    err = launch_16<__half, float, KernelFWide>(a, rows, opt.b * heads,
                                                stream);
    if (err != cudaSuccess) return err;
    return launch_finish<__half>(grad32, dqkv, opt, stream);
  }
  if (dtype == apex::kF32) {
    err = launch_f32(a, stream);
    if (err != cudaSuccess) return err;
    return launch_finish<float>(grad32, dqkv, opt, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace wide
}  // namespace apex

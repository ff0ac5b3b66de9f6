// Paged decode attention, one query row per slot (Kernel C of the port).
//
// Replaces: apex_tpu/ops/decode_attention.py `_decode_kernel` (:272),
// launched by `_pallas` (:355) through `pl.pallas_call` (:409), for
// bf16/f32 pools and a one-row window (w == 1). The append of the step's
// K/V rows stays a torch op that runs first (`_append_rows`, as in
// `_pallas` :365-375), so the pages already hold the new row.
//
// Semantics kept: slot r attends over logical rows [0, pos_r] of its
// pages; logical page j lives in pool row page_table[r, j], and the walk
// covers pages with j * page_size <= pos (as `_decode_kernel` :303);
// sentinel entries (n_pages) are clamped to n_pages - 1 (:376); an
// optional sliding window masks rows <= pos - window; masked scores hold
// -1e30 (`_NEG`) and a masked row's p is 0; scores are q.k / sqrt(head_dim)
// from fp32 products; the softmax and P V are fp32, the context rounded
// once; the `group` query heads of one kv head are done together. Output
// ctx is [b, heads * head_dim], head h reading kv head h / group; a slot
// with no row to read gets zeros (l = 0 is guarded).
//
// Bound on the H100: memory. A decode step streams every K/V row a slot
// must read once (2 * rows * kv_heads * head_dim elements per layer) for
// ~4 operations per element, so the floor is those bytes / 3.35 TB/s.
//
// Two paths, chosen on the host by ops/decode_attention.py
// `paged_decode_plan` (pure Python; `pieces` 0 is the element path):
//
// The vector path (paged_decode_vec_kernel), for bf16/f32 with head_dim a
// multiple of one 16-byte piece (8 bf16, 4 f32) up to 256 and 16-byte
// aligned q, pools and ctx:
// - Grid (kv head x head chunk, slot, split). A split is a fixed run of
//   `split_pages` logical pages; the plan sizes it from the shapes and the
//   card's occupancy (never from the positions, which stay on the device),
//   so the launch shape is a pure function of the shapes. A block whose
//   pages hold no row to read (past pos, or before the window) exits at
//   once; a block reads only the rows in [pos - window + 1, pos].
// - The position, the split's page-table entries and q are loaded
//   together at the start: one round trip before the first K/V copy.
// - 8 warps of 256 threads. `lanes` lanes hold a K/V row as 16-byte
//   pieces (8 a row at head_dim 64 in bf16, 4 rows a warp instruction);
//   each such lane group ("row slot") walks rows lo + gi, lo + gi + 32,
//   ... of the split and keeps its own online softmax. A tile of
//   kTileRows rows a row slot is copied by cp.async into the thread's own
//   slots of a kStages-deep ring in shared memory (no barrier: a thread
//   reads back only what it copied); kStages tiles are in flight before
//   the first is scored, and each scored stage is refilled with the tile
//   kStages further on, so the next pages' bytes are in flight while
//   this one is scored.
// - q's heads live in registers as fp32, pre-scaled by log2(e) /
//   sqrt(head_dim), so p = exp2(s - m). A score is a lane's partial dot
//   summed by xor shuffles inside its row slot; P V builds up in each
//   lane's registers over its columns. Row slots merge by xor shuffles,
//   then the warps once in shared memory, in warp order.
// - GQA: one block serves up to 8 query heads of its kv head, so every
//   K/V byte is read once for them; a larger group is cut into chunks of
//   `heads` heads across blocks, which read K/V again from L2.
//   Register cap: a lane holds HMAX x (PPL x piece) fp32 of q and of P V
//   plus 2 HMAX of softmax state, 144 at HMAX 8 with 8 columns a lane
//   (head_dim 64 and 128 in bf16, 256 in f32), so the plan keeps `heads`
//   <= 8 (`_MAX_HEADS`); HMAX 8 builds with up to 255 registers a thread
//   (one block an SM), the rest with at most 128 (two), every
//   instantiation with 0 spill bytes (ptxas -v in build.log).
// - Splits merge in the same launch: a split with more than one active
//   sibling writes its fp32 (m, l, acc) to a workspace, then the last
//   block of its (slot, kv head, chunk), found by an atomic counter that
//   it resets to 0, merges the partials in split order. The order is
//   fixed whatever block ends last, so ctx is bitwise equal run to run.
//   A slot whose rows lie in one split writes ctx directly.
// - Capture-safe: no host sync, no allocation here; the workspace comes
//   from torch's allocator and the counters stay zeroed between calls
//   (calls that share a counter buffer run on one stream).
// - Query rows are laid out as (head, row) pairs per block; a `w > 1`
//   verify window would fold its rows in as more "heads" with a mask limit
//   pos + t (queue 2a), not a new kernel.
//
// The element path (paged_decode_kernel, the first port's kernel, kept
// bitwise) takes everything else: head_dim off the 16-byte pieces, or
// misaligned bases. One 128-thread block per (kv head, slot) stages one
// page of K and V in shared memory as fp32 and walks the slot's pages in
// turn.
#include "common.cuh"
#include "mma_ring.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kLoadBatch = 8;
constexpr float kNeg = -1e30f;  // decode_attention.py _NEG

struct DecodeArgs {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int* page_table;
  const int* positions;
  void* ctx;
  int b, hl, kvh, dh, n_pages, page_size, pages_per_slot, window;
};

inline size_t smem_floats(const DecodeArgs& a) {
  const int g = a.hl / a.kvh;
  return static_cast<size_t>(g) * a.dh * 2        // q, acc
         + static_cast<size_t>(a.page_size) * (a.dh + 1)  // K page
         + static_cast<size_t>(a.page_size) * a.dh        // V page
         + static_cast<size_t>(g) * a.page_size           // scores / P
         + 3 * static_cast<size_t>(g);                    // m, l, alpha
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ page_table,
                    const int* __restrict__ positions, T* __restrict__ ctx,
                    int hl, int kvh, int dh, int n_pages, int ps, int pps,
                    int window) {
  extern __shared__ float smem[];
  const int G = hl / kvh;
  float* qs = smem;                // [G][dh]
  float* acc = qs + G * dh;        // [G][dh]
  float* Ks = acc + G * dh;        // [ps][dh + 1]
  float* Vs = Ks + ps * (dh + 1);  // [ps][dh]
  float* Ss = Vs + ps * dh;        // [G][ps]
  float* m_s = Ss + G * ps;
  float* l_s = m_s + G;
  float* alpha_s = l_s + G;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int kv = blockIdx.x;
  const int r = blockIdx.y;
  const int f = kvh * dh;
  const int pos = positions[r];
  const float rsq = sqrtf(static_cast<float>(dh));

  for (int idx = tid; idx < G * dh; idx += kThreads) {
    const int g = idx / dh;
    const int c = idx % dh;
    qs[idx] = apex::to_float(q[(static_cast<long long>(r) * hl + kv * G + g) * dh + c]);
    acc[idx] = 0.f;
  }
  if (tid < G) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }

  const int j_first = window > 0 ? max(0, pos - window + 1) / ps : 0;
  const int j_last = min(pps - 1, pos / ps);
  __syncthreads();

  for (int j = j_first; j <= j_last; ++j) {
    int page = page_table[static_cast<long long>(r) * pps + j];
    page = min(max(page, 0), n_pages - 1);  // sentinel: clamp, rows masked
    const long long base = static_cast<long long>(page) * ps * f + kv * dh;
    // kLoadBatch independent loads in flight per thread before any store:
    // the trip count is known only at run time, so a plain loop would wait
    // out one device-memory latency per element
    for (int first = tid; first < ps * dh; first += kThreads * kLoadBatch) {
      T kr[kLoadBatch];
      T vr[kLoadBatch];
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int idx = first + u * kThreads;
        if (idx < ps * dh) {
          const long long off =
              base + static_cast<long long>(idx / dh) * f + idx % dh;
          kr[u] = k_pages[off];
          vr[u] = v_pages[off];
        }
      }
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int idx = first + u * kThreads;
        if (idx < ps * dh) {
          const int t = idx / dh;
          const int c = idx % dh;
          Ks[t * (dh + 1) + c] = apex::to_float(kr[u]);
          Vs[t * dh + c] = apex::to_float(vr[u]);
        }
      }
    }
    __syncthreads();

    for (int idx = tid; idx < G * ps; idx += kThreads) {
      const int g = idx / ps;
      const int t = idx % ps;
      const float* qg = qs + g * dh;
      const float* kt = Ks + t * (dh + 1);
      float dot = 0.f;
      for (int c = 0; c < dh; ++c) dot = fmaf(qg[c], kt[c], dot);
      const int row = j * ps + t;
      bool invalid = row > pos;
      if (window > 0) invalid = invalid || row <= pos - window;
      Ss[idx] = invalid ? kNeg : dot / rsq;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kThreads / 32) {
      float* srow = Ss + g * ps;
      float mx = kNeg;
      for (int t = lane; t < ps; t += 32) mx = fmaxf(mx, srow[t]);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, apex::warp_max(mx));
      float l_blk = 0.f;
      for (int t = lane; t < ps; t += 32) {
        const float s = srow[t];
        const float p = s == kNeg ? 0.f : expf(s - m_new);
        srow[t] = p;
        l_blk += p;
      }
      l_blk = apex::warp_sum(l_blk);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + l_blk;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < G * dh; idx += kThreads) {
      const int g = idx / dh;
      const int c = idx % dh;
      const float* prow = Ss + g * ps;
      float a = acc[idx] * alpha_s[g];
      for (int t = 0; t < ps; ++t) a = fmaf(prow[t], Vs[t * dh + c], a);
      acc[idx] = a;
    }
    __syncthreads();
  }

  for (int idx = tid; idx < G * dh; idx += kThreads) {
    const int g = idx / dh;
    const int c = idx % dh;
    const float l = l_s[g] > 0.f ? l_s[g] : 1.f;
    apex::store(&ctx[(static_cast<long long>(r) * hl + kv * G + g) * dh + c],
                acc[idx] / l);
  }
}

template <typename T>
cudaError_t launch_element(const DecodeArgs& a, cudaStream_t stream) {
  auto kernel = paged_decode_kernel<T>;
  const size_t smem = smem_floats(a) * sizeof(float);
  cudaError_t err = apex::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.kvh, a.b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_pages),
      static_cast<const T*>(a.v_pages), a.page_table, a.positions,
      static_cast<T*>(a.ctx), a.hl, a.kvh, a.dh, a.n_pages, a.page_size,
      a.pages_per_slot, a.window);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The vector path: split page walks, 16-byte rows in registers
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kVecWarps = 8;
constexpr int kVecThreads = 32 * kVecWarps;
// pages a split may hold (their pool rows are staged in shared memory)
constexpr int kMaxSplitPages = 64;
constexpr float kLog2e = 1.4426950408889634f;

// K/V rows a row slot copies a tile, and tiles in flight: each thread
// copies its own pieces by cp.async into its own slots of a ring in
// shared memory and reads them back itself, so no barrier is needed
constexpr int kTileRows = 2;
constexpr int kStages = 4;

// a 16-byte piece of T as fp32 (exact: a bf16 is the high half of a float)
template <typename T>
struct Piece;
template <>
struct Piece<bf16> {
  static constexpr int kElems = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float* v) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
};
template <>
struct Piece<float> {
  static constexpr int kElems = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* v) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
};

struct VecArgs {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int* page_table;
  const int* positions;
  void* ctx;
  // [b, hl, splits, dh] fp32 partial P V, then [b, hl, splits, 2] (m, l)
  float* ws;
  // [b, kvh * chunks]: blocks of a (slot, kv head, chunk) done so far
  int* counters;
  int b, hl, kvh, dh, n_pages, ps, pps, window;
  int lanes, heads, chunks, split_pages, splits;
};

// the ring's uint4 slots ([kStages][K, V][kTileRows][pieces a lane]
// [threads])
__host__ __device__ constexpr int ring_slots(int pieces) {
  return kStages * 2 * kTileRows * pieces * kVecThreads;
}

// the ring, the split's pool rows, and the warps' (acc, m, l) per head
inline size_t vec_smem_bytes(int pieces, int heads, int dh) {
  return static_cast<size_t>(ring_slots(pieces)) * sizeof(uint4) +
         (kMaxSplitPages + static_cast<size_t>(kVecWarps) * heads * (dh + 2)) *
             sizeof(float);
}

// A row slot's walk over the split's rows: its next row u, at row t of
// logical page j; it steps by the block's row slots
struct Cursor {
  int u, j, t;
};

// Copies the next tile of this lane's K and V pieces into ring stage `k_st`
// / `v_st` (zero-filled past the split's rows) and advances the cursor;
// pages[i] is the pool row of logical page j0 + i.
template <typename T, int PPL>
__device__ __forceinline__ void issue_tile(uint4* k_st, uint4* v_st,
                                           Cursor& cur, const T* kbase,
                                           const T* vbase, const int* pages,
                                           int j0, int hi, int ps, long long f,
                                           int sub, int lanes, int npieces,
                                           int step) {
  constexpr int E = Piece<T>::kElems;
#pragma unroll
  for (int k = 0; k < kTileRows; ++k) {
    const bool ok = cur.u < hi;
    const long long off =
        (static_cast<long long>(ok ? pages[cur.j - j0] : 0) * ps + cur.t) * f;
#pragma unroll
    for (int p = 0; p < PPL; ++p) {
      const int piece = sub + p * lanes;
      const bool valid = ok && piece < npieces;
      const long long at = valid ? off + piece * E : 0;
      const int slot = (k * PPL + p) * kVecThreads;
      apex::ring::cp_async16<false>(k_st + slot, kbase + at, valid);
      apex::ring::cp_async16<false>(v_st + slot, vbase + at, valid);
    }
    cur.u += step;
    cur.t += step;
    while (cur.t >= ps) {
      cur.t -= ps;
      ++cur.j;
    }
  }
}

// One tile from ring stage `k_st` / `v_st` into the row slot's online
// softmax: scores (a lane's partial dots summed over the row's lanes),
// then m, l and P V in fp32. Row k of the tile is row u0 + k * step.
template <typename T, int PPL, int HMAX>
__device__ __forceinline__ void score_tile(
    const uint4* k_st, const uint4* v_st, int u0, int step, int hi,
    float (&qf)[HMAX][PPL * Piece<T>::kElems],
    float (&acc)[HMAX][PPL * Piece<T>::kElems], float (&m)[HMAX],
    float (&l)[HMAX], int nh, int lanes) {
  constexpr int E = Piece<T>::kElems;
  constexpr int C = PPL * E;
  float sc[kTileRows][HMAX];
  bool ok[kTileRows];
#pragma unroll
  for (int k = 0; k < kTileRows; ++k) {
    ok[k] = u0 + k * step < hi;
    float kf[C];
#pragma unroll
    for (int p = 0; p < PPL; ++p)
      Piece<T>::unpack(k_st[(k * PPL + p) * kVecThreads], &kf[p * E]);
#pragma unroll
    for (int h = 0; h < HMAX; ++h) {
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) d = fmaf(qf[h][c], kf[c], d);
      sc[k][h] = d;
    }
  }
#pragma unroll
  for (int k = 0; k < kTileRows; ++k) {
#pragma unroll
    for (int h = 0; h < HMAX; ++h) {
      if (h < nh) {
        for (int off = lanes / 2; off > 0; off >>= 1)
          sc[k][h] += __shfl_xor_sync(0xffffffffu, sc[k][h], off);
      }
    }
  }
  // sc becomes p
#pragma unroll
  for (int h = 0; h < HMAX; ++h) {
    if (h >= nh) continue;
    float mt = m[h];
#pragma unroll
    for (int k = 0; k < kTileRows; ++k) {
      if (ok[k]) mt = fmaxf(mt, sc[k][h]);
    }
    const float alpha = exp2f(m[h] - mt);
    float lt = 0.f;
#pragma unroll
    for (int k = 0; k < kTileRows; ++k) {
      sc[k][h] = ok[k] ? exp2f(sc[k][h] - mt) : 0.f;
      lt += sc[k][h];
    }
    l[h] = l[h] * alpha + lt;
    m[h] = mt;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[h][c] *= alpha;
  }
#pragma unroll
  for (int k = 0; k < kTileRows; ++k) {
    float vf[C];
#pragma unroll
    for (int p = 0; p < PPL; ++p)
      Piece<T>::unpack(v_st[(k * PPL + p) * kVecThreads], &vf[p * E]);
#pragma unroll
    for (int h = 0; h < HMAX; ++h) {
      if (h >= nh) continue;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[h][c] = fmaf(sc[k][h], vf[c], acc[h][c]);
    }
  }
}

// 8 heads a block hold 128 fp32 of q and P V a lane: one block an SM may
// take up to 255 registers; below that, two blocks an SM keep them <= 128
template <typename T, int PPL, int HMAX>
__global__ void __launch_bounds__(kVecThreads, HMAX >= 8 ? 1 : 2)
paged_decode_vec_kernel(const VecArgs a) {
  constexpr int E = Piece<T>::kElems;
  constexpr int C = PPL * E;  // columns a lane holds
  constexpr int kStageSlots = kTileRows * PPL * kVecThreads;
  extern __shared__ uint4 ring[];  // [kStages][K, V][kStageSlots]
  __shared__ int last_block;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int L = a.lanes;
  const int slots = 32 / L;              // row slots a warp
  const int groups = kVecWarps * slots;  // row slots a block
  const int gi = warp * slots + lane / L;
  const int sub = lane % L;
  const int npieces = a.dh / E;
  const int kv = blockIdx.x / a.chunks;
  const int chunk = blockIdx.x % a.chunks;
  const int r = blockIdx.y;
  const int s = blockIdx.z;
  const int G = a.hl / a.kvh;
  const int nh = min(a.heads, G - chunk * a.heads);
  T* ctx = static_cast<T*>(a.ctx);
  // ctx / workspace row of the block's head h
  const long long out0 =
      static_cast<long long>(r) * a.hl + kv * G + chunk * a.heads;
  int* pages = reinterpret_cast<int*>(ring + ring_slots(PPL));
  float* w_acc = reinterpret_cast<float*>(pages + kMaxSplitPages);
  float* w_m = w_acc + kVecWarps * nh * a.dh;  // [warps][heads]
  float* w_l = w_m + kVecWarps * nh;

  // The position, this split's page-table entries and q's pieces are
  // loaded together, before any of them is used: one round trip.
  const int pos = __ldg(a.positions + r);
  const int j_split = s * a.split_pages;
  int entry = 0;
  if (tid < a.split_pages && j_split + tid < a.pps)
    entry = __ldg(a.page_table + static_cast<long long>(r) * a.pps +
                  j_split + tid);
  uint4 qraw[HMAX][PPL];
  const T* qrow = static_cast<const T*>(a.q) + out0 * a.dh;
#pragma unroll
  for (int h = 0; h < HMAX; ++h) {
#pragma unroll
    for (int p = 0; p < PPL; ++p) {
      const int piece = sub + p * L;
      qraw[h][p] = make_uint4(0u, 0u, 0u, 0u);
      if (h < nh && piece < npieces)
        qraw[h][p] = __ldg(reinterpret_cast<const uint4*>(
            qrow + h * a.dh + piece * E));
    }
  }

  // rows to read: [row_lo, row_hi); the splits that hold any of them
  const int row_lo = a.window > 0 ? max(0, pos - a.window + 1) : 0;
  const int row_hi = min(pos + 1, a.pps * a.ps);
  const int split_rows = a.split_pages * a.ps;
  int s_lo = 0, n_active = 0;
  if (row_lo < row_hi) {
    s_lo = row_lo / split_rows;
    n_active = (row_hi - 1) / split_rows - s_lo + 1;
  }
  if (n_active == 0) {  // nothing to attend to: ctx 0, as l = 0 gives
    if (s == 0) {
      for (int i = tid; i < nh * a.dh; i += kVecThreads)
        apex::store(&ctx[out0 * a.dh + i], 0.f);
    }
    return;
  }
  if (s < s_lo || s >= s_lo + n_active) return;
  const int lo = max(row_lo, s * split_rows);
  const int hi = min(row_hi, (s + 1) * split_rows);
  if (tid < a.split_pages)
    pages[tid] = min(max(entry, 0), a.n_pages - 1);  // sentinel: clamp

  // q's heads in fp32, scaled so that the scores are in log2 units
  const float q_scale = kLog2e / sqrtf(static_cast<float>(a.dh));
  float qf[HMAX][C];
  float acc[HMAX][C];
  float m[HMAX], l[HMAX];
#pragma unroll
  for (int h = 0; h < HMAX; ++h) {
#pragma unroll
    for (int p = 0; p < PPL; ++p) Piece<T>::unpack(qraw[h][p], &qf[h][p * E]);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      qf[h][c] *= q_scale;
      acc[h][c] = 0.f;
    }
    m[h] = kNeg;
    l[h] = 0.f;
  }
  __syncthreads();

  const long long f = static_cast<long long>(a.kvh) * a.dh;
  const T* kbase = static_cast<const T*>(a.k_pages) + kv * a.dh;
  const T* vbase = static_cast<const T*>(a.v_pages) + kv * a.dh;
  Cursor cur{lo + gi, (lo + gi) / a.ps, 0};
  cur.t = cur.u - cur.j * a.ps;
  const int step = groups * kTileRows;  // rows a tile of the block
  const int tiles = (hi - lo + step - 1) / step;
  // kStages tiles in flight before the first is scored; each scored tile's
  // stage is refilled with the tile kStages further on
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    if (st < tiles)
      issue_tile<T, PPL>(ring + st * 2 * kStageSlots + tid,
                         ring + (st * 2 + 1) * kStageSlots + tid, cur, kbase,
                         vbase, pages, j_split, hi, a.ps, f, sub, L, npieces,
                         groups);
    apex::ring::cp_async_commit();
  }
  for (int it = 0; it < tiles; ++it) {
    const int st = it % kStages;
    uint4* k_st = ring + st * 2 * kStageSlots + tid;
    uint4* v_st = ring + (st * 2 + 1) * kStageSlots + tid;
    apex::ring::cp_async_wait<kStages - 1>();
    asm volatile("" ::: "memory");  // no ring read moves above the wait
    score_tile<T, PPL, HMAX>(k_st, v_st, lo + gi + it * step, groups, hi, qf,
                             acc, m, l, nh, L);
    asm volatile("" ::: "memory");  // nor below the stage's refill
    if (it + kStages < tiles)
      issue_tile<T, PPL>(k_st, v_st, cur, kbase, vbase, pages, j_split, hi,
                         a.ps, f, sub, L, npieces, groups);
    apex::ring::cp_async_commit();
  }
  apex::ring::cp_async_wait<0>();

  // the warp's row slots, merged by xor shuffles
  for (int off = L; off < 32; off <<= 1) {
#pragma unroll
    for (int h = 0; h < HMAX; ++h) {
      if (h >= nh) continue;
      const float mo = __shfl_xor_sync(0xffffffffu, m[h], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[h], off);
      const float mx = fmaxf(m[h], mo);
      const float a0 = exp2f(m[h] - mx);
      const float a1 = exp2f(mo - mx);
      l[h] = l[h] * a0 + lo_ * a1;
      m[h] = mx;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[h][c], off);
        acc[h][c] = acc[h][c] * a0 + ao * a1;
      }
    }
  }
  if (lane < L) {
#pragma unroll
    for (int h = 0; h < HMAX; ++h) {
      if (h >= nh) continue;
      const int pair = warp * nh + h;
      float* wa = w_acc + pair * a.dh;
#pragma unroll
      for (int p = 0; p < PPL; ++p) {
        const int piece = sub + p * L;
        if (piece < npieces) {
#pragma unroll
          for (int e = 0; e < E; ++e) wa[piece * E + e] = acc[h][p * E + e];
        }
      }
      if (sub == 0) {
        w_m[pair] = m[h];
        w_l[pair] = l[h];
      }
    }
  }
  __syncthreads();

  // the warps, merged in warp order: (m, l, acc) of head h, column c
  const bool direct = n_active == 1;
  const long long ws_rows = static_cast<long long>(a.b) * a.hl * a.splits;
  float* ml = a.ws + ws_rows * a.dh;  // [b, hl, splits] (m, l)
  for (int i = tid; i < nh * a.dh; i += kVecThreads) {
    const int h = i / a.dh;
    const int c = i - h * a.dh;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kVecWarps; ++w) mx = fmaxf(mx, w_m[w * nh + h]);
    float ls = 0.f, as = 0.f;
#pragma unroll
    for (int w = 0; w < kVecWarps; ++w) {
      const float sc = exp2f(w_m[w * nh + h] - mx);
      ls += w_l[w * nh + h] * sc;
      as += w_acc[(w * nh + h) * a.dh + c] * sc;
    }
    if (direct) {
      apex::store(&ctx[(out0 + h) * a.dh + c], as / (ls > 0.f ? ls : 1.f));
    } else {
      const long long row = (out0 + h) * a.splits + s;
      a.ws[row * a.dh + c] = as;
      if (c == 0) {
        ml[2 * row] = mx;
        ml[2 * row + 1] = ls;
      }
    }
  }
  if (direct) return;

  // The last block of this (slot, kv head, chunk) merges the splits. One
  // thread counts the block in with a release after the barrier (which
  // orders every thread's partial before it) and an acquire that, with
  // the next barrier, makes the other blocks' partials visible; the last
  // block leaves the counter at 0 for the next call. Each column then
  // folds the splits' (m, l, acc) in split order, all loads in flight.
  __syncthreads();
  if (tid == 0) {
    int* count =
        a.counters + static_cast<long long>(r) * gridDim.x + blockIdx.x;
    int prev;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
                 : "=r"(prev)
                 : "l"(count)
                 : "memory");
    last_block = prev == n_active - 1;
    if (last_block) *count = 0;
  }
  __syncthreads();
  if (!last_block) return;
  for (int i = tid; i < nh * a.dh; i += kVecThreads) {
    const int h = i / a.dh;
    const int c = i - h * a.dh;
    const long long row0 = (out0 + h) * a.splits + s_lo;
    const float2* pm = reinterpret_cast<const float2*>(ml) + row0;
    const float* pa = a.ws + row0 * a.dh + c;
    float mx = kNeg, ls = 0.f, as = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < n_active; ++sp) {
      const float2 p = __ldcg(pm + sp);
      const float v = __ldcg(pa + static_cast<long long>(sp) * a.dh);
      const float mn = fmaxf(mx, p.x);
      const float a0 = exp2f(mx - mn);
      const float a1 = exp2f(p.x - mn);
      ls = ls * a0 + p.y * a1;
      as = as * a0 + v * a1;
      mx = mn;
    }
    apex::store(&ctx[(out0 + h) * a.dh + c], as / (ls > 0.f ? ls : 1.f));
  }
}

using VecKernel = void (*)(VecArgs);

template <typename T, int PPL>
VecKernel vec_kernel_heads(int hmax) {
  switch (hmax) {
    case 1: return paged_decode_vec_kernel<T, PPL, 1>;
    case 2: return paged_decode_vec_kernel<T, PPL, 2>;
    case 4: return paged_decode_vec_kernel<T, PPL, 4>;
    case 8: return paged_decode_vec_kernel<T, PPL, 8>;
    default: return nullptr;
  }
}

// the instantiation for (dtype, pieces a lane, query heads a block): its
// registers hold the power of two of heads that covers them
VecKernel vec_kernel(int dtype, int pieces, int heads) {
  const int hmax = heads <= 1 ? 1 : heads <= 2 ? 2 : heads <= 4 ? 4 : 8;
  if (heads < 1 || heads > 8) return nullptr;
  if (dtype == apex::kBF16)
    return pieces == 1 ? vec_kernel_heads<bf16, 1>(hmax) : nullptr;
  if (pieces == 1) return vec_kernel_heads<float, 1>(hmax);
  if (pieces == 2) return vec_kernel_heads<float, 2>(hmax);
  return nullptr;
}

cudaError_t launch_vec(const VecArgs& a, int dtype, int pieces,
                       cudaStream_t stream) {
  const VecKernel kernel = vec_kernel(dtype, pieces, a.heads);
  if (kernel == nullptr || a.split_pages < 1 ||
      a.split_pages > kMaxSplitPages)
    return cudaErrorInvalidValue;
  const size_t smem = vec_smem_bytes(pieces, a.heads, a.dh);
  cudaError_t err = apex::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.kvh * a.chunks, a.b, a.splits);
  kernel<<<grid, kVecThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q [b, hl, dh]; pools [n_pages, page_size, kvh * dh]; page_table
// [b, pages_per_slot] int32; positions [b] int32; ctx [b, hl * dh]; all
// contiguous, q / pools / ctx of one dtype. window 0 = none. The plan
// (ops/decode_attention.py `paged_decode_plan`): pieces 0 takes the element
// path (ws, counters and the rest of the plan unused); else 16-byte pieces
// a lane, lanes a row, query heads a block (at most 8), pages a split and
// splits. ws: fp32 [b * hl * splits *
// (dh + 2)] (null when splits is 1); counters: int32 [b * kvh * chunks],
// zero, left zero.
extern "C" int apex_paged_decode(const void* q, const void* k_pages,
                                 const void* v_pages, const void* page_table,
                                 const void* positions, void* ctx, void* ws,
                                 void* counters, void* stream, int b, int hl,
                                 int kvh, int dh, int n_pages, int page_size,
                                 int pages_per_slot, int window, int dtype,
                                 int pieces, int lanes, int heads,
                                 int split_pages, int splits) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pieces == 0) {
    DecodeArgs a{q, k_pages, v_pages, static_cast<const int*>(page_table),
                 static_cast<const int*>(positions), ctx, b, hl, kvh, dh,
                 n_pages, page_size, pages_per_slot, window};
    cudaError_t err = dtype == apex::kBF16
                          ? launch_element<__nv_bfloat16>(a, s)
                          : launch_element<float>(a, s);
    return static_cast<int>(err);
  }
  const int g = hl / kvh;
  VecArgs a{q, k_pages, v_pages, static_cast<const int*>(page_table),
            static_cast<const int*>(positions), ctx,
            static_cast<float*>(ws), static_cast<int*>(counters), b, hl, kvh,
            dh, n_pages, page_size, pages_per_slot, window, lanes, heads,
            (g + heads - 1) / heads, split_pages, splits};
  return static_cast<int>(launch_vec(a, dtype, pieces, s));
}

// Resident blocks an SM of the vector path's kernel for (dtype, pieces a
// lane, query heads a block, head_dim).
extern "C" int apex_paged_decode_blocks_per_sm(int dtype, int pieces,
                                               int heads, int dh, int* out) {
  const VecKernel kernel = vec_kernel(dtype, pieces, heads);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = vec_smem_bytes(pieces, heads, dh);
  cudaError_t err = apex::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, kernel, kVecThreads, smem));
}

// Paged decode attention over a slot's mapped pages (Kernel C of the port).
//
// Replaces: apex_tpu/ops/decode_attention.py `_decode_kernel` (:272),
// launched by `_pallas` (:355) through `pl.pallas_call` (:409): bf16,
// fp16 and f32 pools, int8 pools with per-(page, kv head) fp32 scales
// (:289, :313-315), and w-row query windows (:309-310, :322-328). The
// append of the step's K/V rows stays torch ops that run first
// (`_append_rows` / `_quant_append`, as in `_pallas` :365-375), so the
// pages already hold the new rows.
//
// Semantics kept: window row t of slot r attends over logical rows
// [0, pos_r + t] of its pages; logical page j lives in pool row
// page_table[r, j], and the walk covers pages with j * page_size <=
// pos + w - 1 (as `_decode_kernel` :303); sentinel entries (n_pages) are
// clamped to n_pages - 1 (:376); an optional sliding window masks rows
// <= pos + t - window; masked scores hold -1e30 (`_NEG`) and a masked
// row's p is 0; an int8 element is dequantized in fp32 as int8 * scale of
// its (page, kv head), the scales read through the page table here (the
// TPU kernel pre-gathers them only because a BlockSpec needs it); scores
// are q.k / sqrt(head_dim) from fp32 products; the softmax and P V are
// fp32, the context rounded once; the w x group query rows of one kv head
// are done together, row i being window row i / group of head
// kv * group + i % group. q is [b, w, heads, head_dim] and ctx
// [b, w, heads * head_dim] (w = 1 is the single-token step); a row with
// nothing to read gets zeros (l = 0 is guarded).
//
// Bound on the H100: memory. A decode step streams every K/V row a slot
// must read once (2 * rows * kv_heads * head_dim elements per layer, one
// byte each in int8, plus the scales) for ~4 operations per element and
// query row, so the floor is those bytes / 3.35 TB/s.
//
// Two paths, chosen on the host by ops/decode_attention.py
// `paged_decode_plan` (pure Python; `pieces` 0 is the element path):
//
// The vector path (paged_decode_vec_kernel), for bf16/fp16/f32 with
// head_dim a multiple of one 16-byte piece of q (8 bf16 or fp16, 4 f32) up
// to 512 and 16-byte aligned q, pools and ctx; pools in q's dtype, or int8
// under bf16 or fp16 q, read as 8-byte pieces of 8 elements so that q's
// map of elements to lanes holds (`Pool<T, int8_t>`). fp16 is bf16's
// template over the 16-bit type: a piece converts (fp16) where it shifts
// (bf16), both exactly, and the context is rounded once to fp16:
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
//   <= 8 (`_MAX_HEADS`), and <= 4 at 16 columns a lane (two pieces at
//   head_dim 512 in bf16 and fp16, four in f32, whose ring takes 2
//   stages); 64 such values a lane build with up to 255 registers a
//   thread (one block an SM), the rest with at most 128 (two), every
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
// - A w-row window folds in as more query rows: a kv head's w x group rows
//   are cut into chunks of `heads` <= 8 (the register cap counts query
//   rows), row (t, head) masked to pos + t; a split reads the union of its
//   rows' ranges, [pos - window + 1, pos + w - 1], and masks per row.
// - int8 pools: the split's scales are staged beside its pool rows, and a
//   piece is dequantized as it is unpacked (`Pool<T, int8_t>::unpack`).
//
// The element path (paged_decode_kernel, the first port's kernel, bitwise
// at w = 1 on bf16/f32 pools; fp16 as bf16) takes everything else:
// head_dim off the 16-byte pieces, misaligned bases, int8 pools under f32
// q. One 128-thread block per (kv head x row chunk, slot) stages one page
// of K and V in shared memory as fp32 (int8 dequantized there) beside its
// query rows' q and accumulators, and walks the slot's pages in turn;
// where a page of both does not fit (head_dim 512 with pages of 64:
// 279,856 bytes), it walks each page in tiles of half (or a quarter, ...)
// a page, each a step of the online softmax. Where even one K/V row leaves
// no room beside a kv head's w x group query rows (head_dim 1024 at 32
// rows, 2048 at 16), the rows are cut into equal chunks across blocks, as
// on the vector path (the plan's `heads`: all of them wherever a tile
// fits, so those shapes keep their bits). One query row and one K/V row
// fit up to head_dim 14526.
#include <cstdint>
#include <type_traits>

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
  const float* k_scales;  // [n_pages, kvh] for int8 pools, else null
  const float* v_scales;
  const int* page_table;
  const int* positions;
  void* ctx;
  int b, w, hl, kvh, dh, n_pages, page_size, pages_per_slot, window;
  int heads;  // the element path's query rows a block (a chunk)
};

// A pool element as fp32: bf16/fp16/f32 as they are; int8 times its scale.
__device__ __forceinline__ float pool_float(float v, float) { return v; }
__device__ __forceinline__ float pool_float(__nv_bfloat16 v, float) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float pool_float(__half v, float) {
  return __half2float(v);
}
__device__ __forceinline__ float pool_float(int8_t v, float scale) {
  return static_cast<float>(v) * scale;
}

// The element path's shared memory for K/V tiles of `tile` rows of a page
// beside a chunk of `heads` query rows
inline size_t smem_floats(const DecodeArgs& a, int tile) {
  const int g = a.heads;
  return static_cast<size_t>(g) * a.dh * 2                  // q, acc
         + static_cast<size_t>(tile) * (a.dh + 1)           // K rows
         + static_cast<size_t>(tile) * a.dh                 // V rows
         + static_cast<size_t>(g) * tile                    // scores / P
         + 3 * static_cast<size_t>(g);                      // m, l, alpha
}

constexpr size_t kSmemBytes = 232448;  // an H100 block's shared memory

// The K/V rows the element path stages at once: the first of page_size,
// page_size / 2, / 4, ... (rounded down) that fits beside the block's
// `heads` query rows (a whole page at every shape up to head_dim 260 with
// pages of 64 and 4 query rows; 32 rows at 512; 16 at 1024); 0 when none
// fits (ops/decode_attention.py `element_tile` mirrors it, and its
// `paged_decode_plan` cuts the rows into chunks until one does).
inline int element_tile(const DecodeArgs& a) {
  for (int t = a.page_size; t >= 1; t /= 2)
    if (smem_floats(a, t) * sizeof(float) <= kSmemBytes) return t;
  return 0;
}

// T: q and ctx; P: the pools (T, or int8_t with scales). A block serves
// the query rows [chunk * heads, + heads) of its kv head's w x group. A
// page is walked in tiles of `tile` rows (element_tile), each taken as the
// online softmax's step: K and V rows staged side by side, the tile's
// scores, its softmax update, then P V. At tile == page_size (every shape
// whose page fits) each step is one page.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const P* __restrict__ k_pages,
                    const P* __restrict__ v_pages,
                    const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales,
                    const int* __restrict__ page_table,
                    const int* __restrict__ positions, T* __restrict__ ctx,
                    int w, int hl, int kvh, int dh, int n_pages, int ps,
                    int pps, int window, int tile, int heads) {
  extern __shared__ float smem[];
  constexpr bool kQ8 = std::is_same<P, int8_t>::value;
  const int G = hl / kvh;
  const int chunks = (w * G + heads - 1) / heads;
  const int i0 = blockIdx.x % chunks * heads;  // the block's first row
  // the block's query rows: row i0 + i is (window row, head) ((i0 + i) /
  // G, (i0 + i) % G)
  const int R = min(heads, w * G - i0);
  float* qs = smem;                      // [heads][dh]
  float* acc = qs + heads * dh;          // [heads][dh]
  float* Ks = acc + heads * dh;          // [tile][dh + 1]
  float* Vs = Ks + tile * (dh + 1);      // [tile][dh]
  float* Ss = Vs + tile * dh;            // [heads][tile]
  float* m_s = Ss + heads * tile;
  float* l_s = m_s + heads;
  float* alpha_s = l_s + heads;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int kv = blockIdx.x / chunks;
  const int r = blockIdx.y;
  const int f = kvh * dh;
  const int pos = positions[r];
  const float rsq = sqrtf(static_cast<float>(dh));
  // q / ctx row of the block's row i: window row (i0 + i) / G of head
  // kv * G + (i0 + i) % G
  auto out_row = [&](int i) {
    const int t = (i0 + i) / G;
    return (static_cast<long long>(r) * w + t) * hl + kv * G +
           (i0 + i - t * G);
  };

  for (int idx = tid; idx < R * dh; idx += kThreads) {
    const int g = idx / dh;
    const int c = idx % dh;
    qs[idx] = apex::to_float(q[out_row(g) * dh + c]);
    acc[idx] = 0.f;
  }
  if (tid < R) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }

  const int j_first = window > 0 ? max(0, pos - window + 1) / ps : 0;
  const int j_last = min(pps - 1, (pos + w - 1) / ps);
  __syncthreads();

  for (int j = j_first; j <= j_last; ++j) {
    int page = page_table[static_cast<long long>(r) * pps + j];
    page = min(max(page, 0), n_pages - 1);  // sentinel: clamp, rows masked
    float ksc = 1.f, vsc = 1.f;
    if (kQ8) {
      ksc = k_scales[static_cast<long long>(page) * kvh + kv];
      vsc = v_scales[static_cast<long long>(page) * kvh + kv];
    }
    for (int t0 = 0; t0 < ps; t0 += tile) {
      const int n = min(tile, ps - t0);  // rows of this tile
      const long long base =
          (static_cast<long long>(page) * ps + t0) * f + kv * dh;
      // kLoadBatch independent loads in flight per thread before any
      // store: the trip count is known only at run time, so a plain loop
      // would wait out one device-memory latency per element
      for (int first = tid; first < n * dh;
           first += kThreads * kLoadBatch) {
        P kr[kLoadBatch];
        P vr[kLoadBatch];
#pragma unroll
        for (int u = 0; u < kLoadBatch; ++u) {
          const int idx = first + u * kThreads;
          if (idx < n * dh) {
            const long long off =
                base + static_cast<long long>(idx / dh) * f + idx % dh;
            kr[u] = k_pages[off];
            vr[u] = v_pages[off];
          }
        }
#pragma unroll
        for (int u = 0; u < kLoadBatch; ++u) {
          const int idx = first + u * kThreads;
          if (idx < n * dh) {
            const int t = idx / dh;
            const int c = idx % dh;
            Ks[t * (dh + 1) + c] = pool_float(kr[u], ksc);
            Vs[t * dh + c] = pool_float(vr[u], vsc);
          }
        }
      }
      __syncthreads();

      for (int idx = tid; idx < R * n; idx += kThreads) {
        const int g = idx / n;
        const int t = idx % n;
        const float* qg = qs + g * dh;
        const float* kt = Ks + t * (dh + 1);
        float dot = 0.f;
        for (int c = 0; c < dh; ++c) dot = fmaf(qg[c], kt[c], dot);
        const int row = j * ps + t0 + t;
        const int lim = pos + (i0 + g) / G;  // its window row
        bool invalid = row > lim;
        if (window > 0) invalid = invalid || row <= lim - window;
        Ss[idx] = invalid ? kNeg : dot / rsq;
      }
      __syncthreads();

      for (int g = warp; g < R; g += kThreads / 32) {
        float* srow = Ss + g * n;
        float mx = kNeg;
        for (int t = lane; t < n; t += 32) mx = fmaxf(mx, srow[t]);
        const float m_prev = m_s[g];
        const float m_new = fmaxf(m_prev, apex::warp_max(mx));
        float l_blk = 0.f;
        for (int t = lane; t < n; t += 32) {
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

      for (int idx = tid; idx < R * dh; idx += kThreads) {
        const int g = idx / dh;
        const int c = idx % dh;
        const float* prow = Ss + g * n;
        float a = acc[idx] * alpha_s[g];
        for (int t = 0; t < n; ++t) a = fmaf(prow[t], Vs[t * dh + c], a);
        acc[idx] = a;
      }
      __syncthreads();
    }
  }

  for (int idx = tid; idx < R * dh; idx += kThreads) {
    const int g = idx / dh;
    const int c = idx % dh;
    const float l = l_s[g] > 0.f ? l_s[g] : 1.f;
    apex::store(&ctx[out_row(g) * dh + c], acc[idx] / l);
  }
}

template <typename T, typename P>
cudaError_t launch_element(const DecodeArgs& a, cudaStream_t stream) {
  const int rows = a.w * (a.hl / a.kvh);
  if (a.heads < 1 || a.heads > rows) return cudaErrorInvalidValue;
  const int tile = element_tile(a);
  if (tile < 1) return cudaErrorInvalidValue;
  auto kernel = paged_decode_kernel<T, P>;
  const size_t smem = smem_floats(a, tile) * sizeof(float);
  cudaError_t err = apex::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.kvh * ((rows + a.heads - 1) / a.heads), a.b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const P*>(a.k_pages),
      static_cast<const P*>(a.v_pages), a.k_scales, a.v_scales,
      a.page_table, a.positions, static_cast<T*>(a.ctx), a.w, a.hl, a.kvh,
      a.dh, a.n_pages, a.page_size, a.pages_per_slot, a.window, tile,
      a.heads);
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

// a 16-byte piece of T as fp32, exactly (a bf16 is the high half of a
// float; an fp16 pair converts through apex::Half16)
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
struct Piece<__half> {
  static constexpr int kElems = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float* v) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = apex::Half16<__half>::unpack(w[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
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

// A lane's piece of a K/V row in a pool of P under q of T: the same
// Piece<T>::kElems elements as q's piece, copied into one 16-byte ring
// slot and unpacked to fp32 (an int8 piece times its page's scale).
template <typename T, typename P>
struct Pool {
  static constexpr bool kQ8 = false;
  __device__ __forceinline__ static void copy(uint4* dst, const P* src,
                                              bool valid) {
    apex::ring::cp_async16<false>(dst, src, valid);
  }
  __device__ __forceinline__ static void unpack(const uint4& u, float,
                                                float* v) {
    Piece<T>::unpack(u, v);
  }
};
// int8 pools under a 16-bit q (bf16 or fp16): 8 elements a piece, as q's
template <typename T>
struct Pool<T, int8_t> {
  static_assert(Piece<T>::kElems == 8, "int8 pieces pair with 16-bit q");
  static constexpr bool kQ8 = true;
  // 8 bytes (8 int8, the elements of a 16-bit piece of q) or 8 zero bytes
  // without reading when !valid; cp.async of 8 bytes goes through L1 (.ca)
  __device__ __forceinline__ static void copy(uint4* dst, const int8_t* src,
                                              bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                     apex::ring::smem_addr(dst)),
                 "l"(src), "r"(valid ? 8 : 0));
  }
  __device__ __forceinline__ static void unpack(const uint4& u, float scale,
                                                float* v) {
    const unsigned w[2] = {u.x, u.y};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[4 * k + e] = static_cast<float>(
                           static_cast<int>(w[k] << (24 - 8 * e)) >> 24) *
                       scale;
    }
  }
};

struct VecArgs {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scales;  // [n_pages, kvh] for int8 pools, else null
  const float* v_scales;
  const int* page_table;
  const int* positions;
  void* ctx;
  // [b, w, hl, splits, dh] fp32 partial P V, then [b, w, hl, splits, 2]
  // (m, l)
  float* ws;
  // [b, kvh * chunks]: blocks of a (slot, kv head, chunk) done so far
  int* counters;
  int b, w, hl, kvh, dh, n_pages, ps, pps, window;
  int lanes, heads, chunks, split_pages, splits;
};

// the ring's stages at `pieces` 16-byte pieces a lane: kStages, or 2 at 4
// pieces (f32 at head_dim 512), where 4 would take 256 KB
__host__ __device__ constexpr int ring_stages(int pieces) {
  return pieces >= 4 ? 2 : kStages;
}

// the ring's uint4 slots ([stages][K, V][kTileRows][pieces a lane]
// [threads])
__host__ __device__ constexpr int ring_slots(int pieces) {
  return ring_stages(pieces) * 2 * kTileRows * pieces * kVecThreads;
}

// columns a lane holds of a query row: PPL pieces of T
template <typename T, int PPL>
constexpr int lane_cols() {
  return PPL * Piece<T>::kElems;
}

// the ring, the split's pool rows (and, for int8 pools, their K and V
// scales), and the warps' (acc, m, l) per query row
inline size_t vec_smem_bytes(int pieces, int heads, int dh, bool q8) {
  return static_cast<size_t>(ring_slots(pieces)) * sizeof(uint4) +
         (kMaxSplitPages * (q8 ? 3 : 1) +
          static_cast<size_t>(kVecWarps) * heads * (dh + 2)) *
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
template <typename T, typename P, int PPL>
__device__ __forceinline__ void issue_tile(uint4* k_st, uint4* v_st,
                                           Cursor& cur, const P* kbase,
                                           const P* vbase, const int* pages,
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
      Pool<T, P>::copy(k_st + slot, kbase + at, valid);
      Pool<T, P>::copy(v_st + slot, vbase + at, valid);
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
// then m, l and P V in fp32. Row k of the tile is row u0 + k * step; with
// a window (WIN) query row h sees the rows in (lim[h] - window, lim[h]],
// else every row below hi (the split's rows are all in range). For int8
// pools scales[i] and scales[kMaxSplitPages + i] are the K and V scales of
// the split's page i (logical page j0 + i).
template <typename T, typename P, int PPL, int HMAX, bool WIN>
__device__ __forceinline__ void score_tile(
    const uint4* k_st, const uint4* v_st, int u0, int step, int hi,
    const int (&lim)[HMAX], int window, const float* scales, int j0, int ps,
    float (&qf)[HMAX][PPL * Piece<T>::kElems],
    float (&acc)[HMAX][PPL * Piece<T>::kElems], float (&m)[HMAX],
    float (&l)[HMAX], int nh, int lanes) {
  constexpr int E = Piece<T>::kElems;
  constexpr int C = PPL * E;
  float sc[kTileRows][HMAX];
  bool ok[kTileRows][HMAX];
  float ksc[kTileRows], vsc[kTileRows];
#pragma unroll
  for (int k = 0; k < kTileRows; ++k) {
    const int u = u0 + k * step;
    ksc[k] = vsc[k] = 1.f;
    if (Pool<T, P>::kQ8) {
      const int i = u < hi ? u / ps - j0 : 0;
      ksc[k] = scales[i];
      vsc[k] = scales[kMaxSplitPages + i];
    }
#pragma unroll
    for (int h = 0; h < HMAX; ++h)
      ok[k][h] = WIN ? u < hi && u <= lim[h] &&
                           (window <= 0 || u > lim[h] - window)
                     : u < hi;
    float kf[C];
#pragma unroll
    for (int p = 0; p < PPL; ++p)
      Pool<T, P>::unpack(k_st[(k * PPL + p) * kVecThreads], ksc[k],
                         &kf[p * E]);
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
      if (ok[k][h]) mt = fmaxf(mt, sc[k][h]);
    }
    const float alpha = exp2f(m[h] - mt);
    float lt = 0.f;
#pragma unroll
    for (int k = 0; k < kTileRows; ++k) {
      sc[k][h] = ok[k][h] ? exp2f(sc[k][h] - mt) : 0.f;
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
      Pool<T, P>::unpack(v_st[(k * PPL + p) * kVecThreads], vsc[k],
                         &vf[p * E]);
#pragma unroll
    for (int h = 0; h < HMAX; ++h) {
      if (h >= nh) continue;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[h][c] = fmaf(sc[k][h], vf[c], acc[h][c]);
    }
  }
}

// 8 query rows a block hold 128 fp32 of q and P V a lane at 8 columns a
// lane (4 rows at 16): one block an SM may take up to 255 registers; below
// that, two blocks an SM keep them <= 128. WIN: a w > 1 window (per-row
// mask limits); without it w is 1 and the query rows are the group's
// heads.
template <typename T, typename P, int PPL, int HMAX, bool WIN>
__global__ void __launch_bounds__(
    kVecThreads, HMAX >= 8 || HMAX * lane_cols<T, PPL>() > 32 ? 1 : 2)
paged_decode_vec_kernel(const VecArgs a) {
  constexpr int E = Piece<T>::kElems;
  constexpr int C = PPL * E;  // columns a lane holds
  constexpr int kStages = ring_stages(PPL);
  constexpr int kStageSlots = kTileRows * PPL * kVecThreads;
  constexpr bool kQ8 = Pool<T, P>::kQ8;
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
  const int R = a.w * G;  // query rows of a kv head: row i is (i / G, i % G)
  const int nh = min(a.heads, R - chunk * a.heads);
  T* ctx = static_cast<T*>(a.ctx);
  // ctx / q / workspace row of the block's query row h: window row t of
  // head kv * G + g, for the kv head's row i = t * G + g (w = 1: head
  // kv * G + i, rows out0 + h)
  const long long out0 =
      static_cast<long long>(r) * a.hl + kv * G + chunk * a.heads;
  auto out_row = [&](int h) {
    if (!WIN) return out0 + h;
    const int i = chunk * a.heads + h;
    const int t = i / G;
    return (static_cast<long long>(r) * a.w + t) * a.hl + kv * G +
           (i - t * G);
  };
  int* pages = reinterpret_cast<int*>(ring + ring_slots(PPL));
  float* scales = reinterpret_cast<float*>(pages + kMaxSplitPages);
  float* w_acc = scales + (kQ8 ? 2 * kMaxSplitPages : 0);
  float* w_m = w_acc + kVecWarps * nh * a.dh;  // [warps][rows]
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
  int lim[HMAX];
#pragma unroll
  for (int h = 0; h < HMAX; ++h) {
    const int i = chunk * a.heads + h;
    lim[h] = pos + (WIN ? i / G : 0);
    const T* qrow = static_cast<const T*>(a.q) + out_row(h) * a.dh;
#pragma unroll
    for (int p = 0; p < PPL; ++p) {
      const int piece = sub + p * L;
      qraw[h][p] = make_uint4(0u, 0u, 0u, 0u);
      if (h < nh && piece < npieces)
        qraw[h][p] =
            __ldg(reinterpret_cast<const uint4*>(qrow + piece * E));
    }
  }

  // rows to read: [row_lo, row_hi), the union of the query rows' ranges;
  // the splits that hold any of them
  const int row_lo = a.window > 0 ? max(0, pos - a.window + 1) : 0;
  const int row_hi = min(pos + a.w, a.pps * a.ps);
  const int split_rows = a.split_pages * a.ps;
  int s_lo = 0, n_active = 0;
  if (row_lo < row_hi) {
    s_lo = row_lo / split_rows;
    n_active = (row_hi - 1) / split_rows - s_lo + 1;
  }
  if (n_active == 0) {  // nothing to attend to: ctx 0, as l = 0 gives
    if (s == 0) {
      for (int i = tid; i < nh * a.dh; i += kVecThreads) {
        if (WIN) {
          const int h = i / a.dh;
          apex::store(&ctx[out_row(h) * a.dh + (i - h * a.dh)], 0.f);
        } else {
          apex::store(&ctx[out0 * a.dh + i], 0.f);
        }
      }
    }
    return;
  }
  if (s < s_lo || s >= s_lo + n_active) return;
  const int lo = max(row_lo, s * split_rows);
  const int hi = min(row_hi, (s + 1) * split_rows);
  if (tid < a.split_pages) {
    const int page = min(max(entry, 0), a.n_pages - 1);  // sentinel: clamp
    pages[tid] = page;
    if (kQ8) {
      const long long at = static_cast<long long>(page) * a.kvh + kv;
      scales[tid] = __ldg(a.k_scales + at);
      scales[kMaxSplitPages + tid] = __ldg(a.v_scales + at);
    }
  }

  // q's rows in fp32, scaled so that the scores are in log2 units
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
  const P* kbase = static_cast<const P*>(a.k_pages) + kv * a.dh;
  const P* vbase = static_cast<const P*>(a.v_pages) + kv * a.dh;
  Cursor cur{lo + gi, (lo + gi) / a.ps, 0};
  cur.t = cur.u - cur.j * a.ps;
  const int step = groups * kTileRows;  // rows a tile of the block
  const int tiles = (hi - lo + step - 1) / step;
  // kStages tiles in flight before the first is scored; each scored tile's
  // stage is refilled with the tile kStages further on
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    if (st < tiles)
      issue_tile<T, P, PPL>(ring + st * 2 * kStageSlots + tid,
                            ring + (st * 2 + 1) * kStageSlots + tid, cur,
                            kbase, vbase, pages, j_split, hi, a.ps, f, sub, L,
                            npieces, groups);
    apex::ring::cp_async_commit();
  }
  for (int it = 0; it < tiles; ++it) {
    const int st = it % kStages;
    uint4* k_st = ring + st * 2 * kStageSlots + tid;
    uint4* v_st = ring + (st * 2 + 1) * kStageSlots + tid;
    apex::ring::cp_async_wait<kStages - 1>();
    asm volatile("" ::: "memory");  // no ring read moves above the wait
    score_tile<T, P, PPL, HMAX, WIN>(k_st, v_st, lo + gi + it * step, groups,
                                     hi, lim, a.window, scales, j_split, a.ps,
                                     qf, acc, m, l, nh, L);
    asm volatile("" ::: "memory");  // nor below the stage's refill
    if (it + kStages < tiles)
      issue_tile<T, P, PPL>(k_st, v_st, cur, kbase, vbase, pages, j_split,
                            hi, a.ps, f, sub, L, npieces, groups);
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

  // the warps, merged in warp order: (m, l, acc) of row h, column c
  const bool direct = n_active == 1;
  const long long ws_rows =
      static_cast<long long>(a.b) * a.w * a.hl * a.splits;
  float* ml = a.ws + ws_rows * a.dh;  // [b, w, hl, splits] (m, l)
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
      apex::store(&ctx[out_row(h) * a.dh + c], as / (ls > 0.f ? ls : 1.f));
    } else {
      const long long row = out_row(h) * a.splits + s;
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
    const long long row0 = out_row(h) * a.splits + s_lo;
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
    apex::store(&ctx[out_row(h) * a.dh + c], as / (ls > 0.f ? ls : 1.f));
  }
}

using VecKernel = void (*)(VecArgs);

// a window's rows are at least 2 a block (heads >= w >= 2); 8 rows only at
// 8 columns a lane or fewer (the register cap: 4 at 16, head_dim 512)
template <typename T, typename P, int PPL, bool WIN>
VecKernel vec_kernel_heads(int hmax) {
  switch (hmax) {
    case 1:
      return WIN ? nullptr : paged_decode_vec_kernel<T, P, PPL, 1, false>;
    case 2: return paged_decode_vec_kernel<T, P, PPL, 2, WIN>;
    case 4: return paged_decode_vec_kernel<T, P, PPL, 4, WIN>;
    case 8:
      if constexpr (lane_cols<T, PPL>() <= 8)
        return paged_decode_vec_kernel<T, P, PPL, 8, WIN>;
      return nullptr;
    default: return nullptr;
  }
}

template <typename T, typename P, int PPL>
VecKernel vec_kernel_win(int hmax, int win) {
  return win ? vec_kernel_heads<T, P, PPL, true>(hmax)
             : vec_kernel_heads<T, P, PPL, false>(hmax);
}

// the instantiation for (dtype, int8 pools, pieces a lane, query rows a
// block, a w > 1 window): its registers hold the power of two of rows that
// covers them
VecKernel vec_kernel(int dtype, int pool_int8, int pieces, int heads,
                     int win) {
  const int hmax = heads <= 1 ? 1 : heads <= 2 ? 2 : heads <= 4 ? 4 : 8;
  if (heads < 1 || heads > 8) return nullptr;
  if (dtype == apex::kBF16) {
    if (pieces == 1)
      return pool_int8 ? vec_kernel_win<bf16, int8_t, 1>(hmax, win)
                       : vec_kernel_win<bf16, bf16, 1>(hmax, win);
    if (pieces == 2)
      return pool_int8 ? vec_kernel_win<bf16, int8_t, 2>(hmax, win)
                       : vec_kernel_win<bf16, bf16, 2>(hmax, win);
    return nullptr;
  }
  if (dtype == apex::kF16) {
    if (pieces == 1)
      return pool_int8 ? vec_kernel_win<__half, int8_t, 1>(hmax, win)
                       : vec_kernel_win<__half, __half, 1>(hmax, win);
    if (pieces == 2)
      return pool_int8 ? vec_kernel_win<__half, int8_t, 2>(hmax, win)
                       : vec_kernel_win<__half, __half, 2>(hmax, win);
    return nullptr;
  }
  if (pool_int8 || dtype != apex::kF32) return nullptr;
  if (pieces == 1) return vec_kernel_win<float, float, 1>(hmax, win);
  if (pieces == 2) return vec_kernel_win<float, float, 2>(hmax, win);
  if (pieces == 4) return vec_kernel_win<float, float, 4>(hmax, win);
  return nullptr;
}

cudaError_t launch_vec(const VecArgs& a, int dtype, int pool_int8,
                       int pieces, cudaStream_t stream) {
  const VecKernel kernel =
      vec_kernel(dtype, pool_int8, pieces, a.heads, a.w > 1);
  if (kernel == nullptr || a.split_pages < 1 ||
      a.split_pages > kMaxSplitPages)
    return cudaErrorInvalidValue;
  const size_t smem = vec_smem_bytes(pieces, a.heads, a.dh, pool_int8);
  cudaError_t err = apex::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.kvh * a.chunks, a.b, a.splits);
  kernel<<<grid, kVecThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q [b, w, hl, dh] f32, bf16 or fp16; pools [n_pages, page_size, kvh * dh]
// of q's dtype, or int8 (pool_int8, under any q) with k_scales / v_scales
// fp32 [n_pages, kvh]; page_table [b, pages_per_slot] int32; positions [b]
// int32; ctx [b, w, hl * dh]; all contiguous. window 0 = no sliding
// window. The plan (ops/decode_attention.py `paged_decode_plan`): pieces 0
// takes the element path with `heads` query rows a block (ws, counters and
// the rest of the plan unused);
// else 16-byte pieces of q a lane, lanes a row, query rows a block (at
// most 8), pages a split and splits. ws: fp32 [b * w * hl * splits * (dh
// + 2)] (null when splits is 1); counters: int32 [b * kvh * chunks], zero,
// left zero.
extern "C" int apex_paged_decode(const void* q, const void* k_pages,
                                 const void* v_pages, const void* k_scales,
                                 const void* v_scales, const void* page_table,
                                 const void* positions, void* ctx, void* ws,
                                 void* counters, void* stream, int b, int w,
                                 int hl, int kvh, int dh, int n_pages,
                                 int page_size, int pages_per_slot,
                                 int window, int dtype, int pool_int8,
                                 int pieces, int lanes, int heads,
                                 int split_pages, int splits) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  if (pool_int8 && (ks == nullptr || vs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != apex::kBF16 && dtype != apex::kF16 && dtype != apex::kF32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (pieces == 0) {
    DecodeArgs a{q, k_pages, v_pages, ks, vs,
                 static_cast<const int*>(page_table),
                 static_cast<const int*>(positions), ctx, b, w, hl, kvh, dh,
                 n_pages, page_size, pages_per_slot, window, heads};
    cudaError_t err;
    if (dtype == apex::kBF16)
      err = pool_int8 ? launch_element<bf16, int8_t>(a, s)
                      : launch_element<bf16, bf16>(a, s);
    else if (dtype == apex::kF16)
      err = pool_int8 ? launch_element<__half, int8_t>(a, s)
                      : launch_element<__half, __half>(a, s);
    else
      err = pool_int8 ? launch_element<float, int8_t>(a, s)
                      : launch_element<float, float>(a, s);
    return static_cast<int>(err);
  }
  const int rows = w * (hl / kvh);
  VecArgs a{q, k_pages, v_pages, ks, vs, static_cast<const int*>(page_table),
            static_cast<const int*>(positions), ctx,
            static_cast<float*>(ws), static_cast<int*>(counters), b, w, hl,
            kvh, dh, n_pages, page_size, pages_per_slot, window, lanes, heads,
            (rows + heads - 1) / heads, split_pages, splits};
  return static_cast<int>(launch_vec(a, dtype, pool_int8, pieces, s));
}

// Resident blocks an SM of the vector path's kernel for (dtype, int8
// pools, a w > 1 window, pieces a lane, query rows a block, head_dim).
extern "C" int apex_paged_decode_blocks_per_sm(int dtype, int pool_int8,
                                               int win, int pieces,
                                               int heads, int dh, int* out) {
  const VecKernel kernel = vec_kernel(dtype, pool_int8, pieces, heads, win);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = vec_smem_bytes(pieces, heads, dh, pool_int8);
  cudaError_t err = apex::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, kernel, kVecThreads, smem));
}

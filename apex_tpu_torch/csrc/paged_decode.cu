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
// sentinel entries (n_pages) are clamped to n_pages - 1 and their rows
// masked (:376); an optional sliding window masks rows <= pos - window;
// masked scores hold -1e30 (`_NEG`); scores are q.k / sqrt(head_dim); the
// softmax is an fp32 online recurrence over pages; the `group` query
// heads of one kv head are done together. Output ctx is
// [b, heads * head_dim], head h reading kv head h / group.
//
// Bound on the H100: memory. A decode step streams every mapped K/V page
// of every slot once (2 * pages * page_size * kv_heads * head_dim
// elements per layer) for ~4 operations per element, so the floor is the
// mapped bytes / 3.35 TB/s (benchmarks/generation_bench.py
// `_paged_read_bytes` counts the same bytes).
//
// Design (correct and simple first): one 128-thread block per
// (kv head, slot). The block reads its own page-table row (there is no
// scalar prefetch on a GPU), stages one page of K and V for its head in
// shared memory as fp32 (each thread keeps 8 loads in flight), scores the group's query heads against it,
// updates the running max / normaliser, and accumulates P V in shared
// memory. Pages are walked one after another with no copy/compute
// overlap, and the grid is only kv_heads * slots blocks; splitting a
// slot's pages across blocks (split-K decode) is later work.
#include "common.cuh"

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
cudaError_t launch(const DecodeArgs& a, cudaStream_t stream) {
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

}  // namespace

// q [b, hl, dh]; pools [n_pages, page_size, kvh * dh]; page_table
// [b, pages_per_slot] int32; positions [b] int32; ctx [b, hl * dh]; all
// contiguous, q / pools / ctx of one dtype. window 0 = none.
extern "C" int apex_paged_decode(const void* q, const void* k_pages,
                                 const void* v_pages, const void* page_table,
                                 const void* positions, void* ctx, void* stream,
                                 int b, int hl, int kvh, int dh, int n_pages,
                                 int page_size, int pages_per_slot, int window,
                                 int dtype) {
  DecodeArgs a{q, k_pages, v_pages, static_cast<const int*>(page_table),
               static_cast<const int*>(positions), ctx, b, hl, kvh, dh,
               n_pages, page_size, pages_per_slot, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == apex::kBF16 ? launch<__nv_bfloat16>(a, s)
                                         : launch<float>(a, s);
  return static_cast<int>(err);
}

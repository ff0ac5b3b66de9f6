// Shared pieces of the flash attention kernels: the mask of
// apex_tpu/ops/attention.py `_mask_block` (:77) and the key and query
// tiles it leaves visible (Kernels B, E, F and I), and, for the
// packed-QKV kernels (E and F), the packed layout's addressing, in-kernel
// RoPE with the JAX package's rounding points and the dropout hash
// (`_rope_block` :817, `_hash_keep` :784).
#pragma once

#include "common.cuh"

namespace apex {
namespace packed {

constexpr int kBQ = 64;      // query rows per tile
constexpr int kBK = 64;      // key rows per tile
constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;    // attention.py _NEG_INF
constexpr float kLsePad = 1e30f;  // attention.py _LSE_PAD

// Options shared by the forward and backward entries. Pointers that are
// null switch a feature off: kv_lengths (no per-batch key bound),
// cos/sin (rot == 0: no RoPE), seed (no dropout).
struct Opts {
  const int* kv_lengths;  // [b] int32
  const float* cos;       // [s, d] fp32, cos 1 / sin 0 past rot
  const float* sin;
  const int* seed;        // [1] int32, read as uint32
  int s, b, groups, qpg, d;
  float scale;
  int causal;
  int window;             // 0 = no sliding window
  int rot;
  unsigned keep_thresh;   // keep when hash >= min(int(rate * 2^32), 2^32 - 1)
  float inv_keep;         // 1 / (1 - rate) in fp32
};

// Packed qkv [s, b, G * (qpg + 2) * d]: head h = g * qpg + j reads q at
// column g * (qpg + 2) * d + j * d; its group's k and v follow the group's
// qpg query slices. Row stride b * W.
struct Layout {
  long long row_stride;  // elements between consecutive positions
  long long batch_off;   // bb * W
  int group_w;           // (qpg + 2) * d
  __device__ Layout(const Opts& o, int bb)
      : row_stride(static_cast<long long>(o.b) * o.groups * (o.qpg + 2) * o.d),
        batch_off(static_cast<long long>(bb) * o.groups * (o.qpg + 2) * o.d),
        group_w((o.qpg + 2) * o.d) {}
  __device__ long long q(int g, int j, int row, int d) const {
    return batch_off + static_cast<long long>(row) * row_stride + g * group_w + j * d;
  }
  __device__ long long k(int g, int qpg, int row, int d) const {
    return q(g, qpg, row, d);
  }
  __device__ long long v(int g, int qpg, int row, int d) const {
    return q(g, qpg + 1, row, d);
  }
};

// o / do [s, b, H * d]: head h of batch bb at row r.
__device__ __forceinline__ long long out_index(const Opts& o, int bb, int h,
                                               int row) {
  const long long hd = static_cast<long long>(o.groups) * o.qpg * o.d;
  return static_cast<long long>(row) * o.b * hd + bb * hd +
         static_cast<long long>(h) * o.d;
}

// Element c of the q or k row at position `row`, rotated as `_rope_block`
// does: in fp32, t * cos + rotate_half(t) * sin with separate roundings
// (no fused multiply-add, as the plain version computes it), then rounded
// back to the input type. Past rot, cos 1 and sin 0 give t itself.
template <typename T>
__device__ __forceinline__ float load_rope(const T* row_ptr, const Opts& o,
                                           int row, int c) {
  const float t = to_float(row_ptr[c]);
  if (o.rot == 0 || c >= o.rot) return t;
  const int half = o.rot / 2;
  const float hv = c < half ? -to_float(row_ptr[c + half])
                            : to_float(row_ptr[c - half]);
  const long long i = static_cast<long long>(row) * o.d + c;
  const float r = __fadd_rn(__fmul_rn(t, o.cos[i]), __fmul_rn(hv, o.sin[i]));
  return round_to(r, static_cast<T*>(nullptr));
}

// The inverse rotation of element c of a gradient row held in fp32
// (shared memory): the same map with -sin, in fp32 (the caller rounds
// once at the store).
__device__ __forceinline__ float unrotate(const float* row_s, const Opts& o,
                                          int row, int c) {
  const float t = row_s[c];
  if (o.rot == 0 || c >= o.rot) return t;
  const int half = o.rot / 2;
  const float hv = c < half ? -row_s[c + half] : row_s[c - half];
  const long long i = static_cast<long long>(row) * o.d + c;
  return __fadd_rn(__fmul_rn(t, o.cos[i]), __fmul_rn(hv, -o.sin[i]));
}

// `_hash_keep` for one (row, col) of head `combo` = b * 4096 + head
// (`_drop_combo`): row and col are absolute positions.
__device__ __forceinline__ bool hash_keep(unsigned seed, unsigned combo,
                                          unsigned row, unsigned col,
                                          unsigned thresh) {
  const unsigned k = seed + combo * 0x27D4EB2Fu;
  unsigned x = (row * 0x9E3779B1u + k) ^ (col * 0x85EBCA77u);
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= thresh;
}

__device__ __forceinline__ unsigned combo(int bb, int h) {
  return static_cast<unsigned>(bb) * 4096u + static_cast<unsigned>(h);
}

// `_mask_block` over sq query rows and sk keys: query row r sits at
// position r + q_off relative to the first key and sees key c when c < sk,
// c < kvl (the batch row's kv_length in the chunk's own columns, local_kvl),
// r < sq, c <= r + q_off (causal) and c > r + q_off - window (window > 0).
// A plain launch has q_off = sk - sq (a query block that ends the key
// sequence) and k_off = 0; a chunk pair of a context-parallel ring places
// its queries at global positions q_start + r and its keys at k_start + c,
// so q_off = q_start - k_start (any sign: a chunk in the causal future has
// q_off <= -sq, a far-past chunk under a window q_off >= sk + window - 1,
// and every tile is skipped) and k_off = k_start. The packed kernels have
// sq == sk == s and q_off a literal 0 (mask_of), which the compiler folds
// away; with sq > sk under causal, the first sq - sk rows see no key.
struct Mask {
  int sq, sk;
  int q_off;   // q_start - k_start (sk - sq by default)
  int causal;
  int window;  // 0 = no sliding window
  int k_off;   // the first key's global position (kv_lengths are global)
};

__host__ __device__ __forceinline__ Mask mask_4d(int sq, int sk, int causal,
                                                 int window, int q_start,
                                                 int k_start) {
  return Mask{sq, sk, q_start - k_start, causal, window, k_start};
}

__device__ __forceinline__ Mask mask_of(const Opts& o) {
  return Mask{o.s, o.s, 0, o.causal, o.window, 0};
}

// The batch row's key bound in the chunk's own columns: its global
// kv_length less k_off, clamped to [0, sk] (a length that ends before the
// chunk leaves no key, one past it every key); sk without kv_lengths.
__device__ __forceinline__ int local_kvl(const Mask& m, const int* kv_lengths,
                                         int bb) {
  if (kv_lengths == nullptr) return m.sk;
  return min(max(kv_lengths[bb] - m.k_off, 0), m.sk);
}

__device__ __forceinline__ bool visible(const Mask& m, int kvl, int row,
                                        int col) {
  const int pos = row + m.q_off;
  bool ok = col < m.sk && col < kvl && row < m.sq;
  if (m.causal) ok = ok && col <= pos;
  if (m.window > 0) ok = ok && col > pos - m.window;
  return ok;
}

__device__ __forceinline__ bool visible(const Opts& o, int kvl, int row,
                                        int col) {
  return visible(mask_of(o), kvl, row, col);
}

// Key tiles [first, last] of bk keys holding a visible column for query
// rows [q_start, q_start + rows); last < first when there is none.
__device__ __forceinline__ void key_tiles(const Mask& m, int kvl,
                                          int q_start, int* first,
                                          int* last, int rows = kBQ,
                                          int bk = kBK) {
  const int q_off = m.q_off;
  const int last_row = min(q_start + rows, m.sq) - 1;
  int k_end = min(m.sk, kvl);
  if (m.causal) k_end = min(k_end, last_row + q_off + 1);
  const int k_begin =
      m.window > 0 ? max(0, q_start + q_off - m.window + 1) : 0;
  *first = k_begin / bk;
  *last = k_end > k_begin ? (k_end - 1) / bk : *first - 1;
}

__device__ __forceinline__ void key_tiles(const Opts& o, int kvl,
                                          int q_start, int* first,
                                          int* last, int rows = kBQ,
                                          int bk = kBK) {
  key_tiles(mask_of(o), kvl, q_start, first, last, rows, bk);
}

// Query tiles [first, last] of bq rows holding a row that sees a key of
// [k0, k0 + keys); last < first when there is none.
__device__ __forceinline__ void query_tiles(const Mask& m, int kvl, int k0,
                                            int* first, int* last,
                                            int keys = kBK, int bq = kBQ) {
  const int q_off = m.q_off;
  const int k1 = min(k0 + keys, min(m.sk, kvl));  // keys any row can see
  // the first row that sees key k0; clamped only where q_off > 0, so that
  // the packed kernels' literal q_off = 0 leaves k0 as it is
  const int q_begin =
      m.causal ? (q_off > 0 ? max(0, k0 - q_off) : k0 - q_off) : 0;
  int q_end = m.sq;  // exclusive
  if (m.window > 0) q_end = min(q_end, k1 - 1 - q_off + m.window);
  *first = q_begin / bq;
  *last = (k0 < k1 && q_end > q_begin) ? (q_end - 1) / bq : *first - 1;
}

__device__ __forceinline__ void query_tiles(const Opts& o, int kvl, int k0,
                                            int* first, int* last,
                                            int keys = kBK, int bq = kBQ) {
  query_tiles(mask_of(o), kvl, k0, first, last, keys, bq);
}

}  // namespace packed
}  // namespace apex

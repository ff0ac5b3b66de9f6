// Shared pieces of the packed-QKV attention kernels (Kernels E and F):
// the packed layout's addressing, in-kernel RoPE with the JAX package's
// rounding points, the dropout hash, and the visible key range of a query
// tile. Semantics follow apex_tpu/ops/attention.py `_rope_block` (:817),
// `_hash_keep` (:784) and `_mask_block` (:77) with sq == sk == s.
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

__device__ __forceinline__ bool visible(const Opts& o, int kvl, int row,
                                        int col) {
  bool ok = col < o.s && col < kvl && row < o.s;
  if (o.causal) ok = ok && col <= row;
  if (o.window > 0) ok = ok && col > row - o.window;
  return ok;
}

// Key tiles [first, last] holding a visible column for query rows
// [q_start, q_start + rows); last < first when there is none.
__device__ __forceinline__ void key_tiles(const Opts& o, int kvl, int q_start,
                                          int* first, int* last,
                                          int rows = kBQ) {
  const int last_row = min(q_start + rows, o.s) - 1;
  int k_end = min(o.s, kvl);
  if (o.causal) k_end = min(k_end, last_row + 1);
  const int k_begin = o.window > 0 ? max(0, q_start - o.window + 1) : 0;
  *first = k_begin / kBK;
  *last = k_end > k_begin ? (k_end - 1) / kBK : *first - 1;
}

// Query tiles [first, last] holding a row that sees a key of
// [k_start, k_start + kBK); last < first when there is none.
__device__ __forceinline__ void query_tiles(const Opts& o, int kvl,
                                            int k_start, int* first,
                                            int* last) {
  const int q_begin = o.causal ? k_start : 0;
  int q_end = o.s;  // exclusive
  if (o.window > 0) q_end = min(q_end, k_start + kBK - 1 + o.window);
  *first = q_begin / kBQ;
  *last = (k_start < kvl && q_end > q_begin) ? (q_end - 1) / kBQ : *first - 1;
}

}  // namespace packed
}  // namespace apex

// Flash attention past head_dim 512: the pieces Kernels B, I, E and F share
// when d outgrows their DMAX 64/128/256/512 instances (which stay as they
// are, so every d <= 512 output keeps its bits).
//
// Replaces the same TPU kernels as those instances (apex_tpu/ops/
// attention.py `_fwd_single_kernel` :158, `_fwd_kernel` :266, `_dq_kernel`
// :438, `_dkv_kernel` :476, `_dqkv_fused_kernel` :529, `_dqkv_single_kernel`
// :669, `_fwd_packed_kernel` :832, `_dqkv_packed_kernel` :885), which take
// any head dim: `_pad_qkv` (:1449) pads d to a multiple of 64, and the
// packed gate takes any 8-aligned d with a 128-lane geometry.
//
// Design (flash_wide_fwd.cu, flash_wide_bwd.cu): a block owns one part of
// at most kPart = 512 output columns, on a grid axis of cdiv(d, 512) parts,
// and the query rows (or keys) of a tile. Its scores S = Q K^T (and in the
// backward dP = dO V^T) are summed over all of d by streaming slices of Q
// and K (dO and V) through a cp.async ring of shared-memory stages, so
// shared memory stays bounded whatever d is; then it forms its own columns
// of o (or of dq, dk and dv) from a stage holding the part's columns of V
// (K, or Q and dO). Every part computes the same S in the same order, so
// every part's p, row max, row sum and lse are bitwise alike (part 0 writes
// lse). The S recomputed in each part is the price: 2 d cdiv(d, 512) of
// tensor work a visible pair for S in place of 2 d. Past 512 S and dP are
// summed in another order than the DMAX 512 instances' (which hold all of d
// in shared memory), so the checks hold these kernels to 1 ulp of the plain
// version plus the backwards' rounding slack, as at every d.
//
// The packed kernels' RoPE pairs column c with c +- rot / 2, which may lie
// in another slice or part: E and F first write q and k rotated (and
// rounded to the input type, `_rope_block` :817) into a scratch copy of qkv
// (rope_prep), and the streaming kernels read that. F writes dq and dk
// (scaled) in fp32 into a scratch [s, b, H + G, d] and one last pass
// (packed_finish) un-rotates them with -sin and rounds them once into dqkv,
// as the DMAX instances do through shared memory. The dropout hash keys on
// the absolute (row, col) of S, so it does not depend on the part.
#pragma once

#include <type_traits>

#include "flash_mma.cuh"

namespace apex {
namespace wide {

using packed::Mask;
using packed::Opts;

constexpr int kMaxTiled = 512;  // the widest head of the DMAX instances
constexpr int kPart = 512;      // output columns a block owns

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// Where element (bb, head, pos, c) of one operand sits: bb * sb + idx(head)
// * sh + pos * sr + c, with idx(head) = head * mul + pad * (head / group).
// [b, heads, s, d]: (heads s d, s d, d), mul 1, pad 0. The packed qkv [s,
// b, G (qpg + 2) d]: q heads (W, d, b W) with mul 1, pad 2 (head g qpg + j
// at slot g (qpg + 2) + j); k and v heads mul qpg + 2 from their own first
// column; o [s, b, H d]: (H d, d, b H d).
struct View {
  long long sb, sh, sr;
  int mul, pad, group;
  __host__ __device__ long long base(int bb, int head) const {
    return bb * sb +
           static_cast<long long>(head * mul + pad * (head / group)) * sh;
  }
};

// The operands of one launch of the wide kernels. q, k and v are read
// through vq and vk (v shares k's view); o, do and out through vo; dq, dk
// and dv are written through their own views (F's dq and dk go to its fp32
// scratch). lse and delta are [b, H, sq] fp32.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  View vq, vk;
  void* o;
  View vo;
  const void* dout;
  const void* out;
  const float* lse;  // written by the forward
  float* delta;
  void* dq;
  View vdq;
  void* dk;
  View vdk;
  void* dv;
  View vdv;
  const int* kv_lengths;  // [b] int32, or null
  const int* seed;        // [1] int32, or null: no dropout
  unsigned keep_thresh;
  float inv_keep;
  int b, H, KVH, d;
  float scale;
  Mask mask;
  int delta_given;  // the backward reads delta (o not read)
};

inline View view_4d(int heads, int s, int d, int group) {
  const long long sd = static_cast<long long>(s) * d;
  return View{heads * sd, sd, d, 1, 0, group};
}

// Kernels B and I at d > 512 ([b, H, sq, d] q, o; [b, KVH, sk, d] k, v)
inline Args args_4d(int b, int h, int kvh, int d, float scale,
                    const Mask& mask, const int* kvl) {
  Args a{};
  a.vq = view_4d(h, mask.sq, d, h / kvh);
  a.vk = view_4d(kvh, mask.sk, d, h / kvh);
  a.vo = a.vdq = a.vq;
  a.vdk = a.vdv = a.vk;
  a.kv_lengths = kvl;
  a.b = b;
  a.H = h;
  a.KVH = kvh;
  a.d = d;
  a.scale = scale;
  a.mask = mask;
  a.inv_keep = 1.f;
  return a;
}

// Kernels E and F at d > 512: q and k read from `qk` (qkv, or its rotated
// copy), v from qkv, o and do [s, b, H d]; esz: bytes an element
inline Args args_packed(const Opts& o, const void* qk, const void* qkv,
                        int esz) {
  const long long w = static_cast<long long>(o.groups) * (o.qpg + 2) * o.d;
  const long long hd = static_cast<long long>(o.groups) * o.qpg * o.d;
  const long long col = static_cast<long long>(o.d) * esz;  // a head's bytes
  Args a{};
  a.q = qk;
  a.k = static_cast<const char*>(qk) + o.qpg * col;
  a.v = static_cast<const char*>(qkv) + (o.qpg + 1) * col;
  a.vq = View{w, o.d, o.b * w, 1, 2, o.qpg};
  a.vk = View{w, o.d, o.b * w, o.qpg + 2, 0, o.qpg};
  a.vo = View{hd, o.d, o.b * hd, 1, 0, o.qpg};
  a.kv_lengths = o.kv_lengths;
  a.seed = o.seed;
  a.keep_thresh = o.keep_thresh;
  a.inv_keep = o.inv_keep;
  a.b = o.b;
  a.H = o.groups * o.qpg;
  a.KVH = o.groups;
  a.d = o.d;
  a.scale = o.scale;
  a.mask = Mask{o.s, o.s, 0, o.causal, o.window, 0};
  return a;
}

// (x, y) into columns col, col + 1 of an output row of d columns: T pairs
// rounded once (flash::store_pair), or fp32 as they are
template <typename TG>
__device__ __forceinline__ void store_out(TG* row, int col, int d, float x,
                                          float y) {
  if constexpr (std::is_same<TG, float>::value) {
    if (col < d) row[col] = x;
    if (col + 1 < d) row[col + 1] = y;
  } else {
    flash::store_pair(row, col, d, x, y);
  }
}

// Host entries (flash_wide_fwd.cu, flash_wide_bwd.cu), called by the C
// entries of the four flash sources for d > 512. dtype: apex::DType.
cudaError_t fwd_4d(const void* q, const void* k, const void* v, void* o,
                   float* lse, const int* kvl, int b, int h, int kvh, int d,
                   float scale, const Mask& mask, int dtype,
                   cudaStream_t stream);
// rot_qkv: scratch like qkv, null when rot == 0
cudaError_t fwd_packed(const void* qkv, void* o, float* lse, void* rot_qkv,
                       const Opts& opt, int dtype, cudaStream_t stream);
// q and k of qkv rotated into rot_qkv (v's columns untouched)
cudaError_t rope_prep(const void* qkv, void* rot_qkv, const Opts& opt,
                      int dtype, cudaStream_t stream);
cudaError_t bwd_4d(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv,
                   const int* kvl, int b, int h, int kvh, int d, float scale,
                   const Mask& mask, int delta_given, int dtype,
                   cudaStream_t stream);
// grad32: fp32 scratch [s, b, H + G, d]; rot_qkv as fwd_packed's
cudaError_t bwd_packed(const void* qkv, const void* dout, const void* out,
                       const float* lse, float* delta, void* dqkv,
                       float* grad32, void* rot_qkv, const Opts& opt,
                       int dtype, cudaStream_t stream);

}  // namespace wide
}  // namespace apex

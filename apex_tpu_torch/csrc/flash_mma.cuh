// Pieces of the tensor-core flash attention kernels, on top of
// mma_ring.cuh (cp.async, ldmatrix, mma.sync m16n8k16) and
// packed_attention.cuh (the packed layout, RoPE's rounding, the dropout
// hash, visibility): the copy of a 16-bit tile into padded shared-memory
// rows, RoPE applied to a landed tile in place, the test of which key
// tiles a warp's rows see whole, in part or not at all (under the
// packed::Mask of `_mask_block`, with its q_off offset), the online
// softmax step over the scores a warp holds in mma accumulators, p split
// into 16-bit hi + lo A fragments, a factor rounded once to the 16-bit
// type into A fragments, and the backward's delta prep pass. The bf16
// paths of Kernels B and E (flash_fwd.cu, flash_packed_fwd.cu) and of
// Kernels I and F (flash_bwd.cu, flash_packed_bwd.cu), and the fp16 paths
// of E and F, use them: each piece takes the 16-bit element type T (bf16
// or fp16) from its pointers or as a template argument that defaults to
// bf16, and apex::Half16<T> gives the pair packing and the mma opcode.
//
// Fragment layout (PTX ISA, mma.m16n8k16, as mma_ring.cuh): a warp's
// score tile is NS n8 tiles of 16 rows, acc[j][e] at row g + 8 (e >> 1),
// column 8 j + 2 t + (e & 1), g = lane / 4, t = lane % 4. So a thread
// holds two rows (g and g + 8), and the four lanes of a quad hold a row's
// columns between them.
#pragma once

#include "mma_ring.cuh"
#include "packed_attention.cuh"

namespace apex {
namespace flash {

using ring::bf16;
using packed::kNeg;
using packed::Mask;
using packed::Opts;

// How the 16-bit kernels lay a warp's work over the head dim. Up to 128
// columns a warp owns a strip of 16 rows (queries, or keys in the dk/dv
// passes) and every output column, and holds its Q (and dO) A fragments
// in registers. At DMAX 256 and 512 the fp32 accumulators over all of d
// (128 or 256 registers for o or dq, twice that for dk and dv) do not fit
// beside the score tile, so DMAX / 128 warps share each strip: each
// computes the strip's scores over the whole of d, and each owns 128 of
// the output columns; the A fragments of Q and dO are read from shared
// memory at each k16 step.
//
// The backwards' S and dP: up to 128 the tensor cores carry each 128-deep
// sum; past it each 16-deep product is added with an IEEE fp32 add instead
// (kAddSums, mma_sum below). Carried through 16 products, the tensor
// cores' sum drifted enough that ds = p (dp - delta), where dp and delta
// nearly cancel, rounded to a neighbouring fp16 value of the plain
// version's more often than its rounding slack allows (3 of 60 fp16 runs
// of Kernel I had an element past it; none with the adds, 16% slower).
template <int DMAX>
struct Cols {
  static constexpr int kParts = DMAX > 128 ? DMAX / 128 : 1;  // warps a strip
  static constexpr int kWidth = DMAX / kParts;       // columns a warp owns
  static constexpr bool kRegA = DMAX <= 128;  // Q / dO fragments in registers
  static constexpr bool kAddSums = DMAX > 128;  // S, dP summed by IEEE adds
  // k16 steps of the backwards' S and dP unrolled at once: all of them up
  // to 256; 4 at 512, where every step's fragments in flight spilled
  // hundreds of bytes a thread
  static constexpr int kUnroll = DMAX > 256 ? 4 : DMAX / 16;
};

// Shared-memory row length of a tile of DMAX columns: 8 elements of padding
// put the 8 rows an ldmatrix reads in 8 distinct groups of banks, and
// keep each row on a 16-byte boundary for cp.async.
template <int DMAX>
struct Tile {
  static constexpr int kLd = DMAX + 8;
  static constexpr int kChunks = DMAX / 8;  // 16-byte copies a row
};

// ROWS rows of one head's q, k or v slice into `dst` (padded rows):
// row r is position pos0 + r, read at base + col + pos * row_stride.
// Columns from d on and rows from s on are zero-filled. VEC: d and the
// packed row width are multiples of 8, so every copy is one 16-byte
// cp.async; else the copies go element by element (ring::copy8).
template <int ROWS, int DMAX, int THREADS, bool VEC, typename T>
__device__ __forceinline__ void copy_tile(T* dst, const T* base,
                                          long long col,
                                          long long row_stride, int pos0,
                                          int s, int d) {
  using TL = Tile<DMAX>;
  static_assert(ROWS * TL::kChunks % THREADS == 0, "whole copies a thread");
#pragma unroll
  for (int i = 0; i < ROWS * TL::kChunks / THREADS; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int r = idx / TL::kChunks;
    const int c = (idx % TL::kChunks) * 8;
    const int pos = pos0 + r;
    const bool valid = pos < s;
    const T* src =
        valid ? base + col + static_cast<long long>(pos) * row_stride + c
              : base;
    ring::copy8<VEC>(dst + r * TL::kLd + c, src, base, valid, d - c);
  }
}

// RoPE on a landed tile (ROWS rows from position pos0), in place: each
// thread owns the pairs (c, c + rot / 2), so no element is read after it
// is written. The arithmetic is packed::load_rope's: fp32 with separate
// roundings, then one round to T. Rows from s on stay zero.
template <int ROWS, int THREADS, typename T>
__device__ __forceinline__ void rope_tile(T* tile, int ld, int pos0,
                                          const Opts& o) {
  const int half = o.rot / 2;
  for (int idx = threadIdx.x; idx < ROWS * half; idx += THREADS) {
    const int r = idx / half;
    const int c = idx % half;
    const int pos = pos0 + r;
    if (pos >= o.s) continue;
    T* x = tile + r * ld;
    const float lo = to_float(x[c]);
    const float hi = to_float(x[c + half]);
    const long long i = static_cast<long long>(pos) * o.d + c;
    const long long k = i + half;
    store(&x[c],
          __fadd_rn(__fmul_rn(lo, o.cos[i]), __fmul_rn(-hi, o.sin[i])));
    store(&x[c + half],
          __fadd_rn(__fmul_rn(hi, o.cos[k]), __fmul_rn(lo, o.sin[k])));
  }
}

enum Cover : int { kNone = 0, kSome = 1, kAll = 2 };

// What query rows [r0, r0 + rows) see of keys [c0, c0 + bk) under
// packed::visible: kNone, no pair (the tile can be skipped: its scores
// would all be masked, p 0 and the running max unchanged); kAll, every
// pair of rows below sq (no mask needed; rows from sq on are never stored,
// or carry zero q and do); else kSome (mask each score).
__device__ __forceinline__ Cover tile_cover(const Mask& m, int kvl, int r0,
                                            int c0, int bk, int rows = 16) {
  const int r1 = min(r0 + rows, m.sq) - 1;
  if (r1 < r0) return kNone;
  const int q_off = m.q_off;
  const int kv_end = min(m.sk, kvl);
  // the first row sees the fewest keys at the top, the last the fewest at
  // the bottom; the union runs from the first row's bottom to the last's top
  const int hi_first = m.causal ? min(kv_end, r0 + q_off + 1) : kv_end;
  const int hi_last = m.causal ? min(kv_end, r1 + q_off + 1) : kv_end;
  const int lo_first = m.window > 0 ? max(0, r0 + q_off - m.window + 1) : 0;
  const int lo_last = m.window > 0 ? max(0, r1 + q_off - m.window + 1) : 0;
  if (c0 >= hi_last || c0 + bk <= lo_first) return kNone;
  if (c0 >= lo_last && c0 + bk <= hi_first) return kAll;
  return kSome;
}

__device__ __forceinline__ Cover tile_cover(const Opts& o, int kvl, int r0,
                                            int c0, int bk, int rows = 16) {
  return tile_cover(packed::mask_of(o), kvl, r0, c0, bk, rows);
}

// d += a b for one m16n8k16 tile of T operands, the tensor cores carrying
// the sum (mma_ring.cuh adds each product into fp32 registers instead: over
// the few thousand products of one attention row the carried sum holds the
// 1 ulp check of o, and saves an add a product)
template <typename T = bf16>
__device__ __forceinline__ void mma_acc(float (&d)[4], const unsigned (&a)[4],
                                        unsigned b0, unsigned b1) {
  Half16<T>::mma(d, a, b0, b1);
}

// d += a b as mma_acc does, or with ADD the product formed from zero and
// added to d with an IEEE fp32 add (mma_ring.cuh's way)
template <typename T, bool ADD>
__device__ __forceinline__ void mma_sum(float (&d)[4], const unsigned (&a)[4],
                                        unsigned b0, unsigned b1) {
  if (ADD) {
    float t[4];
    Half16<T>::mma_zero(t, a, b0, b1);
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] += t[e];
  } else {
    Half16<T>::mma(d, a, b0, b1);
  }
}

// e^x as 2^(x log2 e): one multiply and the SFU's exp2 (results below
// 2^-126 flushed to 0), within a few fp32 ulps of expf for the arguments
// a softmax gives (x <= 0), at a fraction of expf's instructions
__device__ __forceinline__ float fast_exp(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x * 1.4426950408889634f));
  return r;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One key tile of the online softmax for a thread's two rows: s holds the
// scaled scores (kNeg where masked) and becomes the undropped p; the
// running max m and sum l advance, and the o accumulators are rescaled by
// alpha = exp(m_old - m_new). A masked score gives p = exp(kNeg - base)
// = 0 exactly, the base being the row max, or 0 while the row has seen no
// key (which keeps m = kNeg, l = 0), so no score is tested for the mask.
template <int NS, int NO>
__device__ __forceinline__ void softmax_step(float (&s)[NS][4], float (&m)[2],
                                             float (&l)[2],
                                             float (&o)[NO][4]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
  float sum[2] = {0.f, 0.f};
  const float base[2] = {mx[0] == kNeg ? 0.f : mx[0],
                         mx[1] == kNeg ? 0.f : mx[1]};
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = fast_exp(s[j][e] - base[e >> 1]);
      s[j][e] = p;
      sum[e >> 1] += p;
    }
  float alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    alpha[h] = fast_exp(m[h] - mx[h]);
    l[h] = l[h] * alpha[h] + quad_sum(sum[h]);
    m[h] = mx[h];
  }
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
}

// (x, y) as T pairs hi = T(x, y) and lo = T((x, y) - hi), x in the low
// half: hi + lo carries p to about 2^-16 (bf16) or 2^-22 (fp16) of itself
// while lo stays a normal number (the difference is exact in fp32).
template <typename T>
__device__ __forceinline__ void split2(float x, float y, unsigned& hi,
                                       unsigned& lo) {
  hi = Half16<T>::pack(x, y);
  const float2 hf = Half16<T>::unpack(hi);
  lo = Half16<T>::pack(x - hf.x, y - hf.y);
}

// The A fragments (m16 x k16) of p over keys 16 kk .. 16 kk + 15, from the
// accumulators of score tiles 2 kk and 2 kk + 1 (FlashAttention-2's remap:
// an m16n8 accumulator pair is an m16k16 operand), split into hi and lo.
template <int NS, typename T = bf16>
__device__ __forceinline__ void p_fragments(const float (&p)[NS][4], int kk,
                                            unsigned (&hi)[4],
                                            unsigned (&lo)[4]) {
  split2<T>(p[2 * kk][0], p[2 * kk][1], hi[0], lo[0]);
  split2<T>(p[2 * kk][2], p[2 * kk][3], hi[1], lo[1]);
  split2<T>(p[2 * kk + 1][0], p[2 * kk + 1][1], hi[2], lo[2]);
  split2<T>(p[2 * kk + 1][2], p[2 * kk + 1][3], hi[3], lo[3]);
}

// The A fragment (m16 x k16) over columns 16 kk .. 16 kk + 15 of a warp's
// fp32 accumulators (n8 tiles 2 kk and 2 kk + 1), each value rounded once
// to T: the remap of p_fragments with the hi half only. Kernels F and I
// pack ds and the dropped p this way, rounded where the JAX kernels round
// them.
template <int NS, typename T = bf16>
__device__ __forceinline__ void fragment16(const float (&v)[NS][4], int kk,
                                           unsigned (&a)[4]) {
  a[0] = Half16<T>::pack(v[2 * kk][0], v[2 * kk][1]);
  a[1] = Half16<T>::pack(v[2 * kk][2], v[2 * kk][3]);
  a[2] = Half16<T>::pack(v[2 * kk + 1][0], v[2 * kk + 1][1]);
  a[3] = Half16<T>::pack(v[2 * kk + 1][2], v[2 * kk + 1][3]);
}

// 4 bytes from global to shared memory, or 4 zero bytes when !valid (src
// must be a mapped address either way)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   ring::smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// (x, y) into columns col, col + 1 of a T row of d columns, rounded
// once (to inf past fp16's range); a pair store where both fit and d is
// even (every row start even)
template <typename T>
__device__ __forceinline__ void store_pair(T* row, int col, int d, float x,
                                           float y) {
  if (col + 1 < d && (d & 1) == 0) {
    *reinterpret_cast<unsigned*>(row + col) = Half16<T>::pack(x, y);
  } else {
    if (col < d) store(&row[col], x);
    if (col + 1 < d) store(&row[col + 1], y);
  }
}

// The backward's delta prep: delta = rowsum(do * o) in fp32 over the
// `rows` rows of d columns of do and o, row i stored at delta[(i % inner)
// * s + i / inner] (the packed layout [s, b, H, d] puts its b H rows of
// one position side by side, inner = b H, and delta is [b, H, s]; the 4D
// layout [b, H, s, d] already orders its rows as delta, inner = 1). CH >
// 0: CH threads a row, 8 columns each by 16-byte loads (d == 8 CH, rows
// 16-byte aligned), summed across the CH lanes; CH == 0: one warp a row,
// element by element. OWNER tags the kernel that runs the pass (a name
// in a profile; each source instantiates its own).
constexpr int kDeltaThreads = 256;

template <class OWNER, int CH, typename T>
__global__ void __launch_bounds__(kDeltaThreads)
delta_kernel(const T* __restrict__ dout, const T* __restrict__ out,
             float* __restrict__ delta, long long rows, int inner, int s,
             int d) {
  constexpr int kLanes = CH > 0 ? CH : 32;  // threads a row
  const long long i = static_cast<long long>(blockIdx.x) *
                          (kDeltaThreads / kLanes) + threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  float part = 0.f;
  if (i < rows) {
    if (CH > 0) {
      const uint4 x = *reinterpret_cast<const uint4*>(dout + i * d + 8 * lane);
      const uint4 y = *reinterpret_cast<const uint4*>(out + i * d + 8 * lane);
      const unsigned xs[4] = {x.x, x.y, x.z, x.w};
      const unsigned ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = Half16<T>::unpack(xs[e]);
        const float2 c = Half16<T>::unpack(ys[e]);
        part += a.x * c.x;
        part += a.y * c.y;
      }
    } else {
      for (int c = lane; c < d; c += 32)
        part += to_float(dout[i * d + c]) * to_float(out[i * d + c]);
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, off);
  if (i < rows && lane == 0)
    delta[(i % inner) * s + i / inner] = part;
}

// Launches delta_kernel, 16-byte loads where d is 64, 128 or 256 and every
// row of do and o starts on a 16-byte boundary (`vec`).
template <class OWNER, typename T>
cudaError_t launch_delta(const T* dout, const T* out, float* delta,
                         long long rows, int inner, int s, int d, bool vec,
                         cudaStream_t stream) {
  auto grid = [&](int lanes) {
    const int per_block = kDeltaThreads / lanes;
    return static_cast<unsigned>((rows + per_block - 1) / per_block);
  };
  if (vec && d == 64)
    delta_kernel<OWNER, 8, T><<<grid(8), kDeltaThreads, 0, stream>>>(
        dout, out, delta, rows, inner, s, d);
  else if (vec && d == 128)
    delta_kernel<OWNER, 16, T><<<grid(16), kDeltaThreads, 0, stream>>>(
        dout, out, delta, rows, inner, s, d);
  else if (vec && d == 256)
    delta_kernel<OWNER, 32, T><<<grid(32), kDeltaThreads, 0, stream>>>(
        dout, out, delta, rows, inner, s, d);
  else
    delta_kernel<OWNER, 0, T><<<grid(32), kDeltaThreads, 0, stream>>>(
        dout, out, delta, rows, inner, s, d);
  return cudaGetLastError();
}

}  // namespace flash
}  // namespace apex

// Flash attention forward (Kernel B of the PyTorch port).
//
// Replaces both TPU forward kernels behind apex_tpu/ops/attention.py
// `flash_attention`: the multi-block `_fwd_kernel` (:266, launched by
// `_run_fwd` :337 through `pl.pallas_call` :377) and the single-block
// `_fwd_single_kernel` (:158, `_run_fwd_single` :218, :228). The
// single-block kernel only saves TPU grid steps and computes the same
// function, so one kernel with a loop over key tiles covers both.
//
// Semantics kept: online softmax in fp32; masks exactly as `_mask_block`
// (:77; packed::Mask) at global positions — query row r at q_start + r,
// key c at k_start + c (`_offsets` :326: q_start = sk - sq, k_start = 0
// unless a chunk of a context-parallel ring gives them), so causal with
// the query offset q_off = q_start - k_start (with sq > sk the first sq -
// sk rows see no key; a chunk wholly in the causal future sees none),
// per-batch global kv_lengths (0 included; less k_start in the chunk's
// columns), sliding window (keep keys with col > row + q_off - window),
// and the key-padding bound; key tiles with no unmasked column are
// skipped, as `_causal_block_skip` does (:101); query head h reads
// key/value head h / (H / KVH) (GQA); rows with no visible key give o = 0
// and lse = 1e30 (`_LSE_PAD`). Masked scores hold the finite -1e30
// (`_NEG_INF`), and their probabilities are 0, so the running max never
// meets inf - inf. p stays fp32 up to P V, as the plain version keeps it
// (the JAX kernels round p to the input type before `p v`, :188 and :302,
// which an online kernel, rounding against a running max, cannot
// reproduce; ROADMAP section 3).
//
// Bound on the H100: at the serving prefill shapes (b=1, 12 heads,
// d=64, s up to 768, bf16, causal) the work is 4 d per visible pair
// against (q + k + v + o) bytes and the fp32 lse: both floors are a few
// microseconds (0.00142 ms at s 768, bytes). At the T5-base cross-
// attention of training (q [16, 12, 114, 64], k/v [16, 12, 512, 64],
// kv_lengths) it is ~1.0 GFLOP against ~14 MB.
//
// bf16 and fp16 (the paths the models run; T below), one tensor-core
// kernel built as Kernel E's (flash_packed_fwd.cu) on the pieces of
// flash_mma.cuh: one block of
// 4 warps per (head, batch, 64-row query tile), the tiles that see the
// most keys launched first under a causal mask. Each warp owns 16 query
// rows:
// - the Q tile comes in by cp.async from its [sq, d] slice (16 bytes a
//   copy; element by element where d % 8 != 0, columns past d and rows
//   past sq zero-filled) and is read once by ldmatrix into A fragments
//   that stay in registers;
// - K and V tiles of 64 keys of the query head's kv head come through a
//   cp.async ring (3 stages at d <= 64, 2 at 128), one barrier a tile;
// - S = Q K^T on mma.sync m16n8k16 (T in, fp32 out), scaled in fp32;
//   masks only on tiles that cross the causal diagonal, kv_length, the
//   window's edge, sq or sk (flash::tile_cover with the q_off offset),
//   and tiles a warp sees nothing of are skipped, so a warp whose rows
//   all precede the first key (sq > sk) stores o = 0 and lse = 1e30;
// - the online softmax in registers (row max and sum over a quad's lanes,
//   exp on the SFU's exp2; a masked score's exp is 0 by itself);
// - P V: p is split into T hi + lo, packed straight from the S
//   accumulators into A fragments, and multiplied with the same V
//   fragments (ldmatrix.trans) twice, so that o keeps p to about 2^-16 of
//   itself and holds 1 ulp of the plain version (6 d of tensor work a
//   visible pair in place of 4 d); the tensor cores carry the sums of S
//   and o; o = acc / l is rounded once to T;
// - fp16 takes E's fp16 plan without dropout: p is scaled by 2^14 before
//   the split (lo = p - hi is about 2^-11 hi, and would fall into fp16's
//   subnormals for p below about 2^-3), which keeps hi below 2^15 and lo
//   normal down to p ~ 2^-17, and o is scaled back by 2^-14 before its one
//   rounding (both exact powers of two; l and lse from the unscaled p).
//   One fp16 p, unsplit, misses 1 fp16 ulp at s 768 as at E's s 1024
//   (tests/test_torch_fp16.py emulates both plans on the CPU).
// Past d 128 (DMAX 256) two warps share each 16-row strip and own 128
// columns of o each, Q's fragments read from shared memory at each k16
// step (Kernel E's split, flash_mma.cuh Cols): 8-warp blocks of 64 rows,
// one an SM. Past 256 (DMAX 512) four warps share a strip: 8-warp blocks
// of 32 rows over 32-key tiles (166,400 bytes of shared memory), as
// Kernel E.
// Blocks of 4 warps (64 rows), three an SM at 168 registers a thread: at
// the serving prefill (b 1, 12 heads) E's 128-row blocks would give 12-72
// blocks on 132 SMs, and they were 11-25% slower at every shape measured
// (serve s512 and s768, the T5 cross-attention; PERF.md). No
// atomics: repeated runs are bitwise equal.
//
// f32 (checks only; TF32 would miss their atol of 1e-4): one 256-thread
// block per (64-row query tile, head, batch; 32 rows at DMAX 512). The
// query tile stays in shared memory; the block walks the visible 64-row
// key/value tiles (32 at 512), computing S = Q K^T and P V with fp32 FMA
// from shared memory, each thread owning a 4 x (DMAX/16) register tile of
// the output (4 x DMAX/32 at 512).
#include <type_traits>

#include "flash_mma.cuh"

namespace {

using namespace apex::packed;  // kBQ, kBK, kThreads, kNeg, kLsePad, Mask
namespace flash = apex::flash;
namespace ring = apex::ring;
using flash::bf16;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  const int* kv_lengths;  // may be null
  int b, h, kvh, d;
  float scale;
  Mask mask;
};

// BQ query rows and BK keys a tile: 64 x 64, or 32 x 32 at DMAX 512, where
// 64-row fp32 tiles would not fit the 227 KB of shared memory. A thread
// owns 4 query rows, BK / kTX keys of a score tile and DMAX / kTX output
// columns.
template <int DMAX, int BQ, int BK>
struct Smem {
  static constexpr int kQS = DMAX + 4;  // padded strides: no bank conflicts
  static constexpr int kKS = DMAX + 1;
  static constexpr int kSS = BK + 1;
  static constexpr int kTY = BQ / 4;         // threads down the rows
  static constexpr int kTX = kThreads / kTY;  // threads across
  static constexpr size_t floats =
      BQ * kQS + BK * kKS + BK * DMAX + BQ * kSS + 3 * BQ;
  static_assert(floats * 4 <= 232448, "one block fits an SM");
};

template <int DMAX, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ kv_lengths,
                 int H, int KVH, int d, float scale, const Mask mk) {
  using S = Smem<DMAX, BQ, BK>;
  const int sq = mk.sq;
  const int sk = mk.sk;
  constexpr int kTX = S::kTX;
  constexpr int kSC = BK / kTX;     // score columns per thread
  constexpr int kCols = DMAX / kTX;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * S::kQS;
  float* Vs = Ks + BK * S::kKS;
  float* Ss = Vs + BK * DMAX;
  float* m_s = Ss + BQ * S::kSS;
  float* l_s = m_s + BQ;
  float* alpha_s = l_s + BQ;

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q_start = blockIdx.x * BQ;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int kv_head = hh / (H / KVH);

  const long long q_base = (static_cast<long long>(bb) * H + hh) * sq * d;
  const long long kv_base = (static_cast<long long>(bb) * KVH + kv_head) * sk * d;

  for (int idx = tid; idx < BQ * DMAX; idx += kThreads) {
    const int r = idx / DMAX;
    const int c = idx % DMAX;
    float val = 0.f;
    if (q_start + r < sq && c < d)
      val = apex::to_float(q[q_base + static_cast<long long>(q_start + r) * d + c]);
    Qs[r * S::kQS + c] = val;
  }
  if (tid < BQ) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  const int kvl = local_kvl(mk, kv_lengths, bb);
  int j_first, j_last;
  key_tiles(mk, kvl, q_start, &j_first, &j_last, BQ, BK);
  __syncthreads();

  for (int jt = j_first; jt <= j_last; ++jt) {
    const int k_start = jt * BK;
    for (int idx = tid; idx < BK * DMAX; idx += kThreads) {
      const int r = idx / DMAX;
      const int c = idx % DMAX;
      float kval = 0.f;
      float vval = 0.f;
      if (k_start + r < sk && c < d) {
        const long long off = kv_base + static_cast<long long>(k_start + r) * d + c;
        kval = apex::to_float(k[off]);
        vval = apex::to_float(v[off]);
      }
      Ks[r * S::kKS + c] = kval;
      Vs[r * DMAX + c] = vval;
    }
    __syncthreads();

    // S = scale * Q K^T, masked
    float s[4][kSC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kSC; ++j) s[i][j] = 0.f;
    for (int c = 0; c < DMAX; ++c) {
      float qv[4];
      float kv[kSC];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * S::kQS + c];
#pragma unroll
      for (int j = 0; j < kSC; ++j) kv[j] = Ks[(tx + kTX * j) * S::kKS + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kSC; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q_start + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < kSC; ++j) {
        const int col = k_start + tx + kTX * j;
        Ss[(ty * 4 + i) * S::kSS + tx + kTX * j] =
            visible(mk, kvl, row, col) ? s[i][j] * scale : kNeg;
      }
    }
    __syncthreads();

    // online softmax: one warp per row, BQ / 8 rows per warp, BK / 32 keys
    // a lane
    for (int r = warp * (BQ / 8); r < (warp + 1) * (BQ / 8); ++r) {
      float* srow = Ss + r * S::kSS;
      float v[BK / 32];
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) v[u] = srow[lane + 32 * u];
      float vmax = v[0];
#pragma unroll
      for (int u = 1; u < BK / 32; ++u) vmax = fmaxf(vmax, v[u]);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, apex::warp_max(vmax));
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const float p = v[u] == kNeg ? 0.f : expf(v[u] - m_new);
        srow[lane + 32 * u] = p;
        psum = u == 0 ? p : psum + p;
      }
      const float l_blk = apex::warp_sum(psum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + l_blk;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = alpha_s[ty * 4 + i];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    for (int j = 0; j < BK; ++j) {
      float pv[4];
      float vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty * 4 + i) * S::kSS + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = Vs[j * DMAX + tx + kTX * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int row = q_start + r;
    if (row >= sq) continue;
    const float l = l_s[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + kTX * c;
      if (col < d) apex::store(&o[q_base + static_cast<long long>(row) * d + col], acc[i][c] * inv);
    }
    if (tx == 0)
      lse[(static_cast<long long>(bb) * H + hh) * sq + row] =
          l > 0.f ? m_s[r] + logf(l) : kLsePad;
  }
}

template <int DMAX>
cudaError_t launch_f32(const FlashArgs& a, cudaStream_t stream) {
  constexpr int kB = DMAX <= 256 ? 64 : 32;  // BQ = BK
  auto kernel = flash_fwd_kernel<DMAX, kB, kB>;
  const size_t smem = Smem<DMAX, kB, kB>::floats * sizeof(float);
  cudaError_t err = apex::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.mask.sq + kB - 1) / kB, a.h, a.b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse,
      a.kv_lengths, a.h, a.kvh, a.d, a.scale, a.mask);
  return cudaGetLastError();
}

// The 16-bit kernel: 4 strips of 16 query rows (a warp each, two at d
// 256; 2 strips of four warps at 512, 8 warps and 255 registers a
// thread), key tiles of BK (64; 32 at 512) through a ring of STAGES
// (K, V) stages; three blocks an SM at d <= 64 (168 registers a thread;
// the ring's shared memory caps it there), two at 128, one from 256 on.
template <int DMAX, int STAGES>
struct MmaCfg {
  static constexpr int kStrips = DMAX <= 256 ? 4 : 2;
  static constexpr int kBK = DMAX <= 256 ? apex::packed::kBK : 32;
  static constexpr int kWarps = kStrips * flash::Cols<DMAX>::kParts;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kRows = kStrips * 16;  // query rows a block
  static constexpr int kLd = flash::Tile<DMAX>::kLd;
  static constexpr int kStage = 2 * kBK * kLd;  // K then V, 16-bit
  static constexpr size_t bytes = (kRows * kLd + STAGES * kStage) * 2;
  static constexpr int kMinBlocks = DMAX <= 64 ? 3 : DMAX <= 128 ? 2 : 1;
  static_assert(bytes <= 232448, "one block fits an SM");
};

template <typename T, int DMAX, int STAGES, bool VEC>
__global__ void __launch_bounds__((MmaCfg<DMAX, STAGES>::kThreads),
                                  (MmaCfg<DMAX, STAGES>::kMinBlocks))
flash_fwd_mma(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, const int* __restrict__ kv_lengths,
              int H, int KVH, int d, float scale, const Mask mk) {
  using C = MmaCfg<DMAX, STAGES>;
  constexpr int kBK = C::kBK;  // keys a tile
  constexpr bool kF16 = std::is_same<T, __half>::value;
  // fp16: p scaled by 2^14 before its split, o by 2^-14 after (above)
  constexpr float kPScale = kF16 ? 16384.f : 1.f;
  constexpr float kOScale = kF16 ? 1.f / 16384.f : 1.f;
  using W = flash::Cols<DMAX>;
  constexpr int kKS = DMAX / 16;  // k16 steps of Q K^T
  constexpr int kNS = kBK / 8;    // n8 score tiles a warp
  constexpr int kNO = W::kWidth / 8;  // n8 output tiles a warp
  extern __shared__ __align__(16) unsigned char fsmem[];
  T* Qs = reinterpret_cast<T*>(fsmem);
  T* kv = Qs + C::kRows * C::kLd;  // the ring's stages

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int strip = warp / W::kParts;  // the warp's 16 query rows
  const int cb = warp % W::kParts * W::kWidth;  // its first output column
  const int hh = blockIdx.x;
  const int bb = blockIdx.y;
  const int qt = mk.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q_start = qt * C::kRows;
  const int r0 = q_start + 16 * strip;  // the warp's first row
  const long long q_base = (static_cast<long long>(bb) * H + hh) * mk.sq * d;
  const long long kv_base =
      (static_cast<long long>(bb) * KVH + hh / (H / KVH)) * mk.sk * d;
  const int kvl = local_kvl(mk, kv_lengths, bb);
  int first, last;
  key_tiles(mk, kvl, q_start, &first, &last, C::kRows, kBK);
  const int tiles = last - first + 1;

  float acc[kNO][4];
#pragma unroll
  for (int j = 0; j < kNO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};

  if (tiles > 0) {
    auto load_kv = [&](int tile, T* stage) {
      flash::copy_tile<kBK, DMAX, C::kThreads, VEC>(stage, k, kv_base, d,
                                                    tile * kBK, mk.sk, d);
      flash::copy_tile<kBK, DMAX, C::kThreads, VEC>(
          stage + kBK * C::kLd, v, kv_base, d, tile * kBK, mk.sk, d);
    };
    flash::copy_tile<C::kRows, DMAX, C::kThreads, VEC>(Qs, q, q_base, d,
                                                       q_start, mk.sq, d);
    ring::cp_async_commit();
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < tiles) load_kv(first + st, kv + st * C::kStage);
      ring::cp_async_commit();
    }

    // Q's A fragments: all of them held from the first tile on, or (past
    // d 128) one at a time, read at each k16 step
    unsigned qf[W::kRegA ? kKS : 1][1][4];
    const T* qw_s = Qs + 16 * strip * C::kLd;
    const int g4 = lane / 4;
    const int t4 = lane % 4;
    for (int it = 0; it < tiles; ++it) {
      ring::cp_async_wait<STAGES - 2>();
      __syncthreads();
      const T* Ks = kv + (it % STAGES) * C::kStage;
      const T* Vs = Ks + kBK * C::kLd;
      const int c0 = (first + it) * kBK;
      if (W::kRegA && it == 0) {
#pragma unroll
        for (int kk = 0; kk < kKS; ++kk)
          ring::load_a<1, false>(qf[W::kRegA ? kk : 0], qw_s, C::kLd,
                                 16 * kk);
      }
      const int next = it + STAGES - 1;
      if (next < tiles)
        load_kv(first + next, kv + (next % STAGES) * C::kStage);
      ring::cp_async_commit();

      const flash::Cover cover = flash::tile_cover(mk, kvl, r0, c0, kBK);
      if (cover == flash::kNone) continue;
      // S = scale * Q K^T, masked where the tile needs it
      float sc[kNS][4];
#pragma unroll
      for (int j = 0; j < kNS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        const int qi = W::kRegA ? kk : 0;
        if (!W::kRegA) ring::load_a<1, false>(qf[qi], qw_s, C::kLd, 16 * kk);
        unsigned fb[kNS / 2][4];
        ring::load_b<kNS, false>(fb, Ks, C::kLd, 16 * kk);
#pragma unroll
        for (int j = 0; j < kNS; ++j)
          flash::mma_acc<T>(sc[j], qf[qi][0], fb[j >> 1][2 * (j & 1)],
                            fb[j >> 1][2 * (j & 1) + 1]);
      }
#pragma unroll
      for (int j = 0; j < kNS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + g4 + 8 * (e >> 1);
          const int col = c0 + 8 * j + 2 * t4 + (e & 1);
          sc[j][e] = cover == flash::kAll || visible(mk, kvl, row, col)
                         ? sc[j][e] * scale : kNeg;
        }
      flash::softmax_step<kNS, kNO>(sc, m, l, acc);
      if (kF16) {
#pragma unroll
        for (int j = 0; j < kNS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] *= kPScale;
      }
      // acc += p_hi V + p_lo V
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        unsigned hi[4], lo[4];
        flash::p_fragments<kNS, T>(sc, kk, hi, lo);
        unsigned fb[kNO / 2][4];
        ring::load_b<kNO, true>(fb, Vs + cb, C::kLd, 16 * kk);
#pragma unroll
        for (int j = 0; j < kNO; ++j) {
          flash::mma_acc<T>(acc[j], hi, fb[j >> 1][2 * (j & 1)],
                            fb[j >> 1][2 * (j & 1) + 1]);
          flash::mma_acc<T>(acc[j], lo, fb[j >> 1][2 * (j & 1)],
                            fb[j >> 1][2 * (j & 1) + 1]);
        }
      }
    }
    ring::cp_async_wait<0>();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + lane / 4 + 8 * h;
    if (row >= mk.sq) continue;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
    T* orow = o + q_base + static_cast<long long>(row) * d;
#pragma unroll
    for (int j = 0; j < kNO; ++j) {
      float x = acc[j][2 * h] * inv;
      float y = acc[j][2 * h + 1] * inv;
      if (kF16) {
        x *= kOScale;
        y *= kOScale;
      }
      flash::store_pair(orow, cb + 8 * j + 2 * (lane % 4), d, x, y);
    }
    if (lane % 4 == 0 && cb == 0)
      lse[(static_cast<long long>(bb) * H + hh) * mk.sq + row] =
          l[h] > 0.f ? m[h] + logf(l[h]) : kLsePad;
  }
}

template <typename T, int DMAX, int STAGES, bool VEC>
cudaError_t launch_mma(const FlashArgs& a, cudaStream_t stream) {
  using C = MmaCfg<DMAX, STAGES>;
  auto kernel = flash_fwd_mma<T, DMAX, STAGES, VEC>;
  cudaError_t err = apex::allow_smem(kernel, C::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.h, a.b, (a.mask.sq + C::kRows - 1) / C::kRows);
  kernel<<<grid, C::kThreads, C::bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse,
      a.kv_lengths, a.h, a.kvh, a.d, a.scale, a.mask);
  return cudaGetLastError();
}

// 3 ring stages at d <= 64, 2 from 128 on. 16-byte copies need every row start
// (a multiple of d past a 16-byte aligned base) on a 16-byte boundary.
template <typename T, int DMAX>
cudaError_t launch_16(const FlashArgs& a, cudaStream_t stream) {
  constexpr int kStages = DMAX <= 64 ? 3 : 2;
  auto aligned = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  const bool vec =
      a.d % 8 == 0 && aligned(a.q) && aligned(a.k) && aligned(a.v);
  return vec ? launch_mma<T, DMAX, kStages, true>(a, stream)
             : launch_mma<T, DMAX, kStages, false>(a, stream);
}

}  // namespace

// q [b, h, sq, d], k/v [b, kvh, sk, d] (f32, bf16 or fp16, one dtype), o
// like q, lse [b, h, sq] fp32; all contiguous. kv_lengths [b] int32
// (global lengths) or null; window 0 = none; q_start and k_start the
// global positions of the first query and key (sk - sq and 0 for plain
// attention).
extern "C" int apex_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, const void* kv_lengths,
                              void* stream, int b, int h, int kvh, int sq,
                              int sk, int d, float scale, int causal,
                              int window, int q_start, int k_start,
                              int dtype) {
  const FlashArgs a{q, k, v, o, static_cast<float*>(lse),
                    static_cast<const int*>(kv_lengths), b, h, kvh, d,
                    scale, mask_4d(sq, sk, causal, window, q_start, k_start)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > 512) return static_cast<int>(cudaErrorInvalidValue);
  // the instance of the head dim: DMAX 64, 128, 256 or 512
  auto by_d = [d](auto f64, auto f128, auto f256, auto f512) {
    return d <= 64 ? f64() : d <= 128 ? f128() : d <= 256 ? f256() : f512();
  };
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == apex::kBF16)
    err = by_d([&] { return launch_16<bf16, 64>(a, s); },
               [&] { return launch_16<bf16, 128>(a, s); },
               [&] { return launch_16<bf16, 256>(a, s); },
               [&] { return launch_16<bf16, 512>(a, s); });
  else if (dtype == apex::kF16)
    err = by_d([&] { return launch_16<__half, 64>(a, s); },
               [&] { return launch_16<__half, 128>(a, s); },
               [&] { return launch_16<__half, 256>(a, s); },
               [&] { return launch_16<__half, 512>(a, s); });
  else if (dtype == apex::kF32)
    err = by_d([&] { return launch_f32<64>(a, s); },
               [&] { return launch_f32<128>(a, s); },
               [&] { return launch_f32<256>(a, s); },
               [&] { return launch_f32<512>(a, s); });
  return static_cast<int>(err);
}

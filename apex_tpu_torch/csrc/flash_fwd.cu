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
// (:77; packed::Mask) — causal with the query offset q_off = sk - sq
// (with sq > sk the first sq - sk rows see no key), per-batch kv_lengths
// (0 included), sliding window (keep keys with col > row + q_off -
// window), and the key-padding bound; key tiles with no unmasked column
// are skipped, as `_causal_block_skip` does (:101); query head h reads
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
// bf16 (the path the models run), one tensor-core kernel built as Kernel
// E's (flash_packed_fwd.cu) on the pieces of flash_mma.cuh: one block of
// 4 warps per (head, batch, 64-row query tile), the tiles that see the
// most keys launched first under a causal mask. Each warp owns 16 query
// rows:
// - the Q tile comes in by cp.async from its [sq, d] slice (16 bytes a
//   copy; element by element where d % 8 != 0, columns past d and rows
//   past sq zero-filled) and is read once by ldmatrix into A fragments
//   that stay in registers;
// - K and V tiles of 64 keys of the query head's kv head come through a
//   cp.async ring (3 stages at d <= 64, 2 at 128), one barrier a tile;
// - S = Q K^T on mma.sync m16n8k16 (bf16 in, fp32 out), scaled in fp32;
//   masks only on tiles that cross the causal diagonal, kv_length, the
//   window's edge, sq or sk (flash::tile_cover with the sk - sq offset),
//   and tiles a warp sees nothing of are skipped, so a warp whose rows
//   all precede the first key (sq > sk) stores o = 0 and lse = 1e30;
// - the online softmax in registers (row max and sum over a quad's lanes,
//   exp on the SFU's exp2; a masked score's exp is 0 by itself);
// - P V: p is split into bf16 hi + lo, packed straight from the S
//   accumulators into A fragments, and multiplied with the same V
//   fragments (ldmatrix.trans) twice, so that o keeps p to about 2^-16 of
//   itself and holds 1 bf16 ulp of the plain version (6 d of tensor work
//   a visible pair in place of 4 d); the tensor cores carry the sums of
//   S and o; o = acc / l is rounded once to bf16.
// Blocks of 4 warps (64 rows), three an SM at 168 registers a thread: at
// the serving prefill (b 1, 12 heads) E's 128-row blocks would give 12-72
// blocks on 132 SMs, and they were 11-25% slower at every shape measured
// (serve s512 and s768, the T5 cross-attention; PERF.md). No
// atomics: repeated runs are bitwise equal.
//
// f32 (checks only; TF32 would miss their atol of 1e-4): one 256-thread
// block per (64-row query tile, head, batch). The query tile stays in
// shared memory; the block walks the visible 64-row key/value tiles,
// computing S = Q K^T and P V with fp32 FMA from shared memory, each
// thread owning a 4 x (DMAX/16) register tile of the output.
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

template <int DMAX>
struct Smem {
  static constexpr int kQS = DMAX + 4;  // padded strides: no bank conflicts
  static constexpr int kKS = DMAX + 1;
  static constexpr int kSS = kBK + 1;
  static constexpr size_t floats =
      kBQ * kQS + kBK * kKS + kBK * DMAX + kBQ * kSS + 3 * kBQ;
};

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ kv_lengths,
                 int H, int KVH, int d, float scale, const Mask mk) {
  using S = Smem<DMAX>;
  const int sq = mk.sq;
  const int sk = mk.sk;
  constexpr int kCols = DMAX / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * S::kQS;
  float* Vs = Ks + kBK * S::kKS;
  float* Ss = Vs + kBK * DMAX;
  float* m_s = Ss + kBQ * S::kSS;
  float* l_s = m_s + kBQ;
  float* alpha_s = l_s + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q_start = blockIdx.x * kBQ;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int kv_head = hh / (H / KVH);

  const long long q_base = (static_cast<long long>(bb) * H + hh) * sq * d;
  const long long kv_base = (static_cast<long long>(bb) * KVH + kv_head) * sk * d;

  for (int idx = tid; idx < kBQ * DMAX; idx += kThreads) {
    const int r = idx / DMAX;
    const int c = idx % DMAX;
    float val = 0.f;
    if (q_start + r < sq && c < d)
      val = apex::to_float(q[q_base + static_cast<long long>(q_start + r) * d + c]);
    Qs[r * S::kQS + c] = val;
  }
  if (tid < kBQ) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  const int kvl = kv_lengths != nullptr ? kv_lengths[bb] : sk;
  int j_first, j_last;
  key_tiles(mk, kvl, q_start, &j_first, &j_last);
  __syncthreads();

  for (int jt = j_first; jt <= j_last; ++jt) {
    const int k_start = jt * kBK;
    for (int idx = tid; idx < kBK * DMAX; idx += kThreads) {
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
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < DMAX; ++c) {
      float qv[4];
      float kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * S::kQS + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * S::kKS + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q_start + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k_start + tx + 16 * j;
        Ss[(ty * 4 + i) * S::kSS + tx + 16 * j] =
            visible(mk, kvl, row, col) ? s[i][j] * scale : kNeg;
      }
    }
    __syncthreads();

    // online softmax: one warp per row, 8 rows per warp
    for (int r = warp * (kBQ / 8); r < (warp + 1) * (kBQ / 8); ++r) {
      float* srow = Ss + r * S::kSS;
      const float v0 = srow[lane];
      const float v1 = srow[lane + 32];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, apex::warp_max(fmaxf(v0, v1)));
      const float p0 = v0 == kNeg ? 0.f : expf(v0 - m_new);
      const float p1 = v1 == kNeg ? 0.f : expf(v1 - m_new);
      srow[lane] = p0;
      srow[lane + 32] = p1;
      const float l_blk = apex::warp_sum(p0 + p1);
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
    for (int j = 0; j < kBK; ++j) {
      float pv[4];
      float vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty * 4 + i) * S::kSS + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = Vs[j * DMAX + tx + 16 * c];
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
      const int col = tx + 16 * c;
      if (col < d) apex::store(&o[q_base + static_cast<long long>(row) * d + col], acc[i][c] * inv);
    }
    if (tx == 0)
      lse[(static_cast<long long>(bb) * H + hh) * sq + row] =
          l > 0.f ? m_s[r] + logf(l) : kLsePad;
  }
}

template <int DMAX>
cudaError_t launch_f32(const FlashArgs& a, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<DMAX>;
  const size_t smem = Smem<DMAX>::floats * sizeof(float);
  cudaError_t err = apex::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.mask.sq + kBQ - 1) / kBQ, a.h, a.b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse,
      a.kv_lengths, a.h, a.kvh, a.d, a.scale, a.mask);
  return cudaGetLastError();
}

// The bf16 kernel: 4 warps of 16 query rows, key tiles of kBK through a
// ring of STAGES (K, V) stages; three blocks an SM at d <= 64 (168
// registers a thread; the ring's shared memory caps it there), two at 128.
template <int DMAX, int STAGES>
struct MmaCfg {
  static constexpr int kWarps = 4;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kRows = kWarps * 16;  // query rows a block
  static constexpr int kLd = flash::Tile<DMAX>::kLd;
  static constexpr int kStage = 2 * kBK * kLd;  // K then V, in bf16
  static constexpr size_t bytes = (kRows * kLd + STAGES * kStage) * 2;
  static constexpr int kMinBlocks = DMAX <= 64 ? 3 : 2;
};

template <int DMAX, int STAGES, bool VEC>
__global__ void __launch_bounds__((MmaCfg<DMAX, STAGES>::kThreads),
                                  (MmaCfg<DMAX, STAGES>::kMinBlocks))
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o,
              float* __restrict__ lse, const int* __restrict__ kv_lengths,
              int H, int KVH, int d, float scale, const Mask mk) {
  using C = MmaCfg<DMAX, STAGES>;
  constexpr int kKS = DMAX / 16;  // k16 steps of Q K^T
  constexpr int kNS = kBK / 8;    // n8 score tiles a warp
  constexpr int kNO = DMAX / 8;   // n8 output tiles a warp
  extern __shared__ __align__(16) unsigned char fsmem[];
  bf16* Qs = reinterpret_cast<bf16*>(fsmem);
  bf16* kv = Qs + C::kRows * C::kLd;  // the ring's stages

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int hh = blockIdx.x;
  const int bb = blockIdx.y;
  const int qt = mk.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q_start = qt * C::kRows;
  const int r0 = q_start + 16 * warp;  // the warp's first row
  const long long q_base = (static_cast<long long>(bb) * H + hh) * mk.sq * d;
  const long long kv_base =
      (static_cast<long long>(bb) * KVH + hh / (H / KVH)) * mk.sk * d;
  const int kvl = kv_lengths != nullptr ? kv_lengths[bb] : mk.sk;
  int first, last;
  key_tiles(mk, kvl, q_start, &first, &last, C::kRows);
  const int tiles = last - first + 1;

  float acc[kNO][4];
#pragma unroll
  for (int j = 0; j < kNO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};

  if (tiles > 0) {
    auto load_kv = [&](int tile, bf16* stage) {
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

    unsigned qf[kKS][1][4];
    const int g4 = lane / 4;
    const int t4 = lane % 4;
    for (int it = 0; it < tiles; ++it) {
      ring::cp_async_wait<STAGES - 2>();
      __syncthreads();
      const bf16* Ks = kv + (it % STAGES) * C::kStage;
      const bf16* Vs = Ks + kBK * C::kLd;
      const int c0 = (first + it) * kBK;
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < kKS; ++kk)
          ring::load_a<1, false>(qf[kk], Qs + 16 * warp * C::kLd, C::kLd,
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
        unsigned fb[kNS / 2][4];
        ring::load_b<kNS, false>(fb, Ks, C::kLd, 16 * kk);
#pragma unroll
        for (int j = 0; j < kNS; ++j)
          flash::mma_acc(sc[j], qf[kk][0], fb[j >> 1][2 * (j & 1)],
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
      // acc += p_hi V + p_lo V
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        unsigned hi[4], lo[4];
        flash::p_fragments<kNS>(sc, kk, hi, lo);
        unsigned fb[kNO / 2][4];
        ring::load_b<kNO, true>(fb, Vs, C::kLd, 16 * kk);
#pragma unroll
        for (int j = 0; j < kNO; ++j) {
          flash::mma_acc(acc[j], hi, fb[j >> 1][2 * (j & 1)],
                         fb[j >> 1][2 * (j & 1) + 1]);
          flash::mma_acc(acc[j], lo, fb[j >> 1][2 * (j & 1)],
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
    bf16* orow = o + q_base + static_cast<long long>(row) * d;
#pragma unroll
    for (int j = 0; j < kNO; ++j)
      flash::store_pair(orow, 8 * j + 2 * (lane % 4), d, acc[j][2 * h] * inv,
                        acc[j][2 * h + 1] * inv);
    if (lane % 4 == 0)
      lse[(static_cast<long long>(bb) * H + hh) * mk.sq + row] =
          l[h] > 0.f ? m[h] + logf(l[h]) : kLsePad;
  }
}

template <int DMAX, int STAGES, bool VEC>
cudaError_t launch_mma(const FlashArgs& a, cudaStream_t stream) {
  using C = MmaCfg<DMAX, STAGES>;
  auto kernel = flash_fwd_mma<DMAX, STAGES, VEC>;
  cudaError_t err = apex::allow_smem(kernel, C::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.h, a.b, (a.mask.sq + C::kRows - 1) / C::kRows);
  kernel<<<grid, C::kThreads, C::bytes, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.lse,
      a.kv_lengths, a.h, a.kvh, a.d, a.scale, a.mask);
  return cudaGetLastError();
}

// 3 ring stages at d <= 64, 2 at 128. 16-byte copies need every row start
// (a multiple of d past a 16-byte aligned base) on a 16-byte boundary.
template <int DMAX>
cudaError_t launch_bf16(const FlashArgs& a, cudaStream_t stream) {
  constexpr int kStages = DMAX <= 64 ? 3 : 2;
  auto aligned = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  const bool vec =
      a.d % 8 == 0 && aligned(a.q) && aligned(a.k) && aligned(a.v);
  return vec ? launch_mma<DMAX, kStages, true>(a, stream)
             : launch_mma<DMAX, kStages, false>(a, stream);
}

}  // namespace

// q [b, h, sq, d], k/v [b, kvh, sk, d], o like q, lse [b, h, sq] fp32;
// all contiguous. kv_lengths [b] int32 or null; window 0 = none.
extern "C" int apex_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, const void* kv_lengths,
                              void* stream, int b, int h, int kvh, int sq,
                              int sk, int d, float scale, int causal,
                              int window, int dtype) {
  const FlashArgs a{q, k, v, o, static_cast<float*>(lse),
                    static_cast<const int*>(kv_lengths), b, h, kvh, d,
                    scale, mask_4d(sq, sk, causal, window)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > 128) return static_cast<int>(cudaErrorInvalidValue);
  // f32 and bf16 only: fp16 is not yet ported here
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == apex::kBF16)
    err = d <= 64 ? launch_bf16<64>(a, s) : launch_bf16<128>(a, s);
  else if (dtype == apex::kF32)
    err = d <= 64 ? launch_f32<64>(a, s) : launch_f32<128>(a, s);
  return static_cast<int>(err);
}

// Packed-QKV flash attention forward (Kernel E of the PyTorch port).
//
// Replaces: apex_tpu/ops/attention.py `_fwd_packed_kernel` (:832),
// launched by `_run_fwd_packed` (:958) through `pl.pallas_call` (:983).
//
// Reads q/k/v tiles straight from the fused projection qkv [s, b, W]
// (packed_attention.cuh) and writes o [s, b, H * d] and lse [b, H, s]
// fp32 with no transposes on either side. Semantics kept:
// - in-kernel RoPE: q and k rotate in fp32 and round back to the input
//   type before Q K^T (`_rope_block`, :817-829);
// - masks as `_mask_block` with sq == sk == s: causal, per-batch
//   kv_lengths, sliding window; scores of masked keys hold -1e30 and
//   their probabilities are set to 0;
// - dropout: the keep mask is `_hash_keep` at absolute (row, col) for
//   combo b * 4096 + head; l and lse come from the UNDROPPED
//   probabilities and o = (drop(p) v) / l (:870-881);
// - a row with no visible key gives o = 0 and lse = 1e30 (`_LSE_PAD`).
// p stays fp32 up to P V, as the plain version keeps it (the JAX kernel
// rounds exp(s - m_final) to the input type, :877, which an online kernel
// cannot reproduce).
//
// Bound on the H100: at GPT-2 124M training (b 8, 12 heads, s 1024,
// d 64, causal, bf16) the causal work is 4 d per visible (row, col) pair,
// 12.9 GFLOP (13 us at the bf16 tensor rate), against 50.7 MB of qkv, o
// and lse (15 us at 3.35 TB/s): about even, so the kernel has to keep
// the tensor cores fed and read each K/V tile once per query tile.
//
// bf16 and fp16 (the paths the models train on; one template over the
// 16-bit type T): one block of 8 warps per (head, batch, 128-row query
// tile), the tiles that see the most keys launched
// first under a causal mask so that the last wave is short. Each warp
// owns 16 query rows:
// - the Q tile comes in by cp.async (16 bytes a copy from the packed row;
//   element by element where d % 8 != 0, columns past d and rows past s
//   zero-filled), is rotated in shared memory when rot > 0, and is read
//   once by ldmatrix into A fragments that stay in registers;
// - K and V tiles of 64 keys come through a cp.async ring (3 stages at
//   d <= 64, 2 at 128; flash_mma.cuh, mma_ring.cuh), one barrier a tile;
//   a K tile is rotated in place;
// - S = Q K^T on mma.sync m16n8k16 (T in, fp32 out), scaled in fp32;
//   masks only on tiles that cross the diagonal, kv_length, the window's
//   edge or s, and tiles a warp sees nothing of are skipped;
// - the online softmax in registers (row max and sum over a quad's lanes,
//   exp on the SFU's exp2, no per-score mask test: a masked score's exp
//   is 0 by itself), l from the undropped p, the dropout hash at each
//   accumulator's absolute (row, col);
// - P V: the dropped fp32 p is split into T hi + lo, packed straight
//   from the S accumulators into A fragments, and multiplied with the same
//   V fragments (ldmatrix.trans) twice, so that o keeps p to about 2^-16
//   of itself and holds 1 ulp of the plain version (one bf16 p would miss
//   it by tens of ulps at s 1024). The lo product adds half the
//   tensor-core work: 6 d a visible pair in place of 4 d;
// - fp16 takes the same split, chosen over one fp16 p by the CPU
//   emulations in tests/test_torch_fp16.py
//   (`test_kernel_e_fp16_rounding_plan_holds_one_ulp`,
//   `test_kernel_e_single_fp16_p_misses_one_ulp`): one fp16 p misses 1
//   fp16 ulp of the plain version by tens of ulps at s 1024, the split
//   holds it. fp16's exponent is the narrow
//   one: lo = p - hi is about 2^-11 hi, so for p below 2^-3 it would
//   fall into fp16's subnormals and lose its low bits. The dropped p is
//   therefore scaled by 2^(14 - e) before the split, e = ilogb(1 / (1 -
//   rate)) (2^14 without dropout): a power of two, exact in fp32, that
//   keeps hi below 2^15 (no overflow) and lo normal down to p ~ 2^-17;
//   o = acc / l is scaled back by its inverse before the one rounding;
// - the tensor cores carry the sums of S and o across the products (an
//   fp32 add after each product, as mma_ring.cuh does, cost 7% at the
//   GPT-2 shape); o = acc / l is rounded once to T.
// Registers are capped at 128 a thread at d <= 64 so that two blocks fit
// an SM: the kernel waits on latency (ldmatrix, mma, exp) more than on
// any one unit, and 16 resident warps beat the few bytes it spills.
// No atomics: repeated runs are bitwise equal.
//
// What bounds it now: inferred, not profiled (no ncu on the card's
// machine): at the GPT-2 shape it runs at about 115 TFLOP/s of useful
// work, 170 counting the lo product, so the instruction rate of the
// non-tensor work (scale, exp, the split, the rescale) and the latency
// of mma.sync chains set the pace; wgmma with the softmax of one tile
// overlapped with the next tile's products is the next step.
//
// f32 (checks only; TF32 would miss their atol of 1e-4): one 256-thread
// block per (64-row query tile, head, batch); the rotated query tile stays
// in shared memory as fp32; the block walks the visible 64-key tiles with
// an online softmax, S = Q K^T and P V in fp32 FMA, each thread owning a
// 4 x (DMAX / 16) output tile.
#include <type_traits>

#include "flash_mma.cuh"
#include "packed_attention.cuh"

namespace {

using namespace apex::packed;
namespace flash = apex::flash;
namespace ring = apex::ring;

template <int DMAX>
struct Smem {
  static constexpr int kQS = DMAX + 4;
  static constexpr int kKS = DMAX + 1;
  static constexpr int kSS = kBK + 1;
  static constexpr size_t floats =
      kBQ * kQS + kBK * kKS + kBK * DMAX + kBQ * kSS + 3 * kBQ;
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_packed_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ o,
                        float* __restrict__ lse, const Opts opt) {
  using S = Smem<DMAX>;
  constexpr int kCols = DMAX / 16;
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
  const int g = hh / opt.qpg;
  const int j = hh % opt.qpg;
  const int d = opt.d;
  const Layout lay(opt, bb);
  const bool drop = opt.seed != nullptr;
  const unsigned seed = drop ? static_cast<unsigned>(opt.seed[0]) : 0u;
  const unsigned cmb = combo(bb, hh);

  for (int idx = tid; idx < kBQ * DMAX; idx += kThreads) {
    const int r = idx / DMAX;
    const int c = idx % DMAX;
    const int row = q_start + r;
    float val = 0.f;
    if (row < opt.s && c < d)
      val = load_rope(qkv + lay.q(g, j, row, d), opt, row, c);
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

  const int kvl = opt.kv_lengths != nullptr ? opt.kv_lengths[bb] : opt.s;
  int j_first, j_last;
  key_tiles(opt, kvl, q_start, &j_first, &j_last);
  __syncthreads();

  for (int jt = j_first; jt <= j_last; ++jt) {
    const int k_start = jt * kBK;
    for (int idx = tid; idx < kBK * DMAX; idx += kThreads) {
      const int r = idx / DMAX;
      const int c = idx % DMAX;
      const int row = k_start + r;
      float kval = 0.f;
      float vval = 0.f;
      if (row < opt.s && c < d) {
        kval = load_rope(qkv + lay.k(g, opt.qpg, row, d), opt, row, c);
        vval = apex::to_float(qkv[lay.v(g, opt.qpg, row, d) + c]);
      }
      Ks[r * S::kKS + c] = kval;
      Vs[r * DMAX + c] = vval;
    }
    __syncthreads();

    // S = scale * Q K^T, masked
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sc[i][jj] = 0.f;
    for (int c = 0; c < DMAX; ++c) {
      float qv[4];
      float kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * S::kQS + c];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = Ks[(tx + 16 * jj) * S::kKS + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sc[i][jj] = fmaf(qv[i], kv[jj], sc[i][jj]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q_start + ty * 4 + i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = k_start + tx + 16 * jj;
        Ss[(ty * 4 + i) * S::kSS + tx + 16 * jj] =
            visible(opt, kvl, row, col) ? sc[i][jj] * opt.scale : kNeg;
      }
    }
    __syncthreads();

    // online softmax over undropped p; P V takes the dropped p
    for (int r = warp * (kBQ / 8); r < (warp + 1) * (kBQ / 8); ++r) {
      float* srow = Ss + r * S::kSS;
      const float v0 = srow[lane];
      const float v1 = srow[lane + 32];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, apex::warp_max(fmaxf(v0, v1)));
      float p0 = v0 == kNeg ? 0.f : expf(v0 - m_new);
      float p1 = v1 == kNeg ? 0.f : expf(v1 - m_new);
      const float l_blk = apex::warp_sum(p0 + p1);
      if (drop) {
        const unsigned row = q_start + r;
        p0 = hash_keep(seed, cmb, row, k_start + lane, opt.keep_thresh)
                 ? p0 * opt.inv_keep : 0.f;
        p1 = hash_keep(seed, cmb, row, k_start + lane + 32, opt.keep_thresh)
                 ? p1 * opt.inv_keep : 0.f;
      }
      srow[lane] = p0;
      srow[lane + 32] = p1;
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
    for (int jj = 0; jj < kBK; ++jj) {
      float pv[4];
      float vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty * 4 + i) * S::kSS + jj];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = Vs[jj * DMAX + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
    __syncthreads();
  }

  const int heads = opt.groups * opt.qpg;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int row = q_start + r;
    if (row >= opt.s) continue;
    const float l = l_s[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* orow = o + out_index(opt, bb, hh, row);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < d) apex::store(&orow[col], acc[i][c] * inv);
    }
    if (tx == 0)
      lse[(static_cast<long long>(bb) * heads + hh) * opt.s + row] =
          l > 0.f ? m_s[r] + logf(l) : kLsePad;
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* qkv, void* o, float* lse, const Opts& opt,
                   cudaStream_t stream) {
  auto kernel = flash_packed_fwd_kernel<T, DMAX>;
  const size_t smem = Smem<DMAX>::floats * sizeof(float);
  cudaError_t err = apex::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((opt.s + kBQ - 1) / kBQ, opt.groups * opt.qpg, opt.b);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(qkv),
                                           static_cast<T*>(o), lse, opt);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* qkv, void* o, float* lse, const Opts& opt,
                     cudaStream_t stream) {
  if (opt.d <= 64) return launch<T, 64>(qkv, o, lse, opt, stream);
  if (opt.d <= 128) return launch<T, 128>(qkv, o, lse, opt, stream);
  return cudaErrorInvalidValue;
}

// The 16-bit kernel: WARPS warps of 16 query rows, key tiles of kBK
// through a ring of STAGES (K, V) stages.
template <int DMAX, int WARPS, int STAGES>
struct MmaCfg {
  static constexpr int kThreads = WARPS * 32;
  static constexpr int kRows = WARPS * 16;  // query rows a block
  static constexpr int kLd = flash::Tile<DMAX>::kLd;
  static constexpr int kStage = 2 * kBK * kLd;  // K then V, 16-bit
  static constexpr size_t bytes = (kRows * kLd + STAGES * kStage) * 2;
  // two blocks an SM at d <= 64 (registers capped at 128 a thread): the
  // kernel waits on latency more than on any one unit, so occupancy wins
  // over the few bytes it spills
  static constexpr int kMinBlocks = DMAX <= 64 ? 2 : 1;
};

template <typename T, int DMAX, int WARPS, int STAGES, bool VEC>
__global__ void __launch_bounds__(WARPS * 32,
                                  (MmaCfg<DMAX, WARPS, STAGES>::kMinBlocks))
flash_packed_fwd_mma(const T* __restrict__ qkv, T* __restrict__ o,
                     float* __restrict__ lse, const Opts opt) {
  using C = MmaCfg<DMAX, WARPS, STAGES>;
  constexpr bool kF16 = std::is_same<T, __half>::value;
  constexpr int kKS = DMAX / 16;  // k16 steps of Q K^T
  constexpr int kNS = kBK / 8;    // n8 score tiles a warp
  constexpr int kNO = DMAX / 8;   // n8 output tiles a warp
  extern __shared__ __align__(16) unsigned char fsmem[];
  T* Qs = reinterpret_cast<T*>(fsmem);
  T* kv = Qs + C::kRows * C::kLd;  // the ring's stages

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int hh = blockIdx.x;
  const int bb = blockIdx.y;
  const int qt = opt.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q_start = qt * C::kRows;
  const int r0 = q_start + 16 * warp;  // the warp's first row
  const int g = hh / opt.qpg;
  const int d = opt.d;
  const Layout lay(opt, bb);
  const int kvl = opt.kv_lengths != nullptr ? opt.kv_lengths[bb] : opt.s;
  int first, last;
  key_tiles(opt, kvl, q_start, &first, &last, C::kRows);
  const int tiles = last - first + 1;

  float acc[kNO][4];
#pragma unroll
  for (int j = 0; j < kNO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};
  // fp16: the dropped p scaled by 2^(14 - e) before its split, o by the
  // inverse after it (above); both exact powers of two
  const int p_exp = kF16 ? 14 - ilogbf(opt.inv_keep) : 0;
  const float p_scale = ldexpf(1.f, p_exp);
  const float o_scale = ldexpf(1.f, -p_exp);

  if (tiles > 0) {
    const bool drop = opt.seed != nullptr;
    const unsigned seed = drop ? static_cast<unsigned>(opt.seed[0]) : 0u;
    const unsigned cmb = combo(bb, hh);
    const long long kcol = lay.k(g, opt.qpg, 0, d);
    const long long vcol = lay.v(g, opt.qpg, 0, d);
    auto load_kv = [&](int tile, T* stage) {
      flash::copy_tile<kBK, DMAX, C::kThreads, VEC>(
          stage, qkv, kcol, lay.row_stride, tile * kBK, opt.s, d);
      flash::copy_tile<kBK, DMAX, C::kThreads, VEC>(
          stage + kBK * C::kLd, qkv, vcol, lay.row_stride, tile * kBK, opt.s,
          d);
    };
    flash::copy_tile<C::kRows, DMAX, C::kThreads, VEC>(
        Qs, qkv, lay.q(g, hh % opt.qpg, 0, d), lay.row_stride, q_start,
        opt.s, d);
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
      T* Ks = kv + (it % STAGES) * C::kStage;
      T* Vs = Ks + kBK * C::kLd;
      const int c0 = (first + it) * kBK;
      if (opt.rot > 0) {
        if (it == 0)
          flash::rope_tile<C::kRows, C::kThreads>(Qs, C::kLd, q_start, opt);
        flash::rope_tile<kBK, C::kThreads>(Ks, C::kLd, c0, opt);
        __syncthreads();
      }
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

      const flash::Cover cover = flash::tile_cover(opt, kvl, r0, c0, kBK);
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
          flash::mma_acc<T>(sc[j], qf[kk][0], fb[j >> 1][2 * (j & 1)],
                            fb[j >> 1][2 * (j & 1) + 1]);
      }
#pragma unroll
      for (int j = 0; j < kNS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + g4 + 8 * (e >> 1);
          const int col = c0 + 8 * j + 2 * t4 + (e & 1);
          sc[j][e] = cover == flash::kAll || visible(opt, kvl, row, col)
                         ? sc[j][e] * opt.scale : kNeg;
        }
      flash::softmax_step<kNS, kNO>(sc, m, l, acc);
      if (drop) {
#pragma unroll
        for (int j = 0; j < kNS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const unsigned row = r0 + g4 + 8 * (e >> 1);
            const unsigned col = c0 + 8 * j + 2 * t4 + (e & 1);
            sc[j][e] = hash_keep(seed, cmb, row, col, opt.keep_thresh)
                           ? sc[j][e] * opt.inv_keep : 0.f;
          }
      }
      if (kF16) {
#pragma unroll
        for (int j = 0; j < kNS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] *= p_scale;
      }
      // acc += p_hi V + p_lo V
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        unsigned hi[4], lo[4];
        flash::p_fragments<kNS, T>(sc, kk, hi, lo);
        unsigned fb[kNO / 2][4];
        ring::load_b<kNO, true>(fb, Vs, C::kLd, 16 * kk);
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

  const int heads = opt.groups * opt.qpg;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + lane / 4 + 8 * h;
    if (row >= opt.s) continue;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
    T* orow = o + out_index(opt, bb, hh, row);
#pragma unroll
    for (int j = 0; j < kNO; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      float x = acc[j][2 * h] * inv;
      float y = acc[j][2 * h + 1] * inv;
      if (kF16) {
        x *= o_scale;
        y *= o_scale;
      }
      flash::store_pair(orow, col, d, x, y);
    }
    if (lane % 4 == 0)
      lse[(static_cast<long long>(bb) * heads + hh) * opt.s + row] =
          l[h] > 0.f ? m[h] + logf(l[h]) : kLsePad;
  }
}

template <typename T, int DMAX, int WARPS, int STAGES, bool VEC>
cudaError_t launch_mma(const void* qkv, void* o, float* lse, const Opts& opt,
                       cudaStream_t stream) {
  using C = MmaCfg<DMAX, WARPS, STAGES>;
  auto kernel = flash_packed_fwd_mma<T, DMAX, WARPS, STAGES, VEC>;
  cudaError_t err = apex::allow_smem(kernel, C::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(opt.groups * opt.qpg, opt.b,
                  (opt.s + C::kRows - 1) / C::kRows);
  kernel<<<grid, C::kThreads, C::bytes, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(o), lse, opt);
  return cudaGetLastError();
}

// 8 warps (128 query rows a block); 3 ring stages at d <= 64, 2 at 128.
// 16-byte copies need every row start (a multiple of d past a 16-byte
// aligned base) on a 16-byte boundary.
template <typename T, int DMAX>
cudaError_t launch_mma_vec(const void* qkv, void* o, float* lse,
                           const Opts& opt, cudaStream_t stream) {
  constexpr int kWarps = 8;
  constexpr int kStages = DMAX <= 64 ? 3 : 2;
  const bool vec = opt.d % 8 == 0 &&
                   reinterpret_cast<unsigned long long>(qkv) % 16 == 0;
  return vec ? launch_mma<T, DMAX, kWarps, kStages, true>(qkv, o, lse, opt,
                                                           stream)
             : launch_mma<T, DMAX, kWarps, kStages, false>(qkv, o, lse, opt,
                                                            stream);
}

// the bf16 and fp16 paths
template <typename T>
cudaError_t launch_16(const void* qkv, void* o, float* lse, const Opts& opt,
                      cudaStream_t stream) {
  if (opt.d <= 64) return launch_mma_vec<T, 64>(qkv, o, lse, opt, stream);
  if (opt.d <= 128) return launch_mma_vec<T, 128>(qkv, o, lse, opt, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// qkv [s, b, groups * (qpg + 2) * d], o [s, b, groups * qpg * d] of one
// dtype (f32, bf16 or fp16; another code is cudaErrorInvalidValue),
// lse [b, groups * qpg, s] fp32, all contiguous. kv_lengths [b] int32,
// cos/sin [s, d] fp32 and seed [1] int32 may each be null (feature off).
extern "C" int apex_flash_packed_fwd(const void* qkv, void* o, void* lse,
                                     const void* kv_lengths, const void* cos,
                                     const void* sin, const void* seed,
                                     void* stream, int s, int b, int groups,
                                     int qpg, int d, float scale, int causal,
                                     int window, int rot,
                                     unsigned keep_thresh, float inv_keep,
                                     int dtype) {
  const Opts opt{static_cast<const int*>(kv_lengths),
                 static_cast<const float*>(cos), static_cast<const float*>(sin),
                 static_cast<const int*>(seed), s, b, groups, qpg, d, scale,
                 causal, window, rot, keep_thresh, inv_keep};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == apex::kBF16)
    err = launch_16<__nv_bfloat16>(qkv, o, l, opt, st);
  else if (dtype == apex::kF16)
    err = launch_16<__half>(qkv, o, l, opt, st);
  else if (dtype == apex::kF32)
    err = launch_d<float>(qkv, o, l, opt, st);
  return static_cast<int>(err);
}

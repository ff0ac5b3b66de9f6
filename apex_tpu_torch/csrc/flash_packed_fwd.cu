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
// Head dims past 128 (DMAX 256, flash_mma.cuh Cols): o over all of d
// would take 128 fp32 registers a thread beside S's 32 and Q's 64, so two
// warps share each 16-row strip, both computing the strip's S and softmax
// over the whole of d (bitwise alike) and each owning 128 columns of o and
// P V; Q's fragments are read from shared memory at each k16 step. 8 warps
// make 64-row blocks, 2 ring stages, 168,960 bytes of shared memory, one
// block an SM; the tensor work is 8 d a visible pair in place of 6 d.
// Past 256 (DMAX 512) four warps share each strip, 128 columns each, so 8
// warps make 32-row blocks; 64-key tiles in two stages would need 299,520
// bytes, so the ring takes 32-key tiles (166,400 bytes); the tensor work
// is 12 d a visible pair (S four times over). Past 512, any d: the entry
// hands the call to the wide instance (flash_wide_fwd.cu), RoPE applied
// first into a scratch copy of qkv.
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
// block per (64-row query tile, head, batch; 215,296 bytes of shared
// memory at DMAX 256; 32-row tiles and 32-key tiles at 512, 201,856
// bytes); the rotated query tile stays
// in shared memory as fp32; the block walks the visible key tiles with
// an online softmax, S = Q K^T and P V in fp32 FMA, each thread owning a
// 4 x (DMAX / 16) output tile (4 x DMAX / 32 at 512).
#include <type_traits>

#include "flash_mma.cuh"
#include "flash_wide.cuh"
#include "packed_attention.cuh"

namespace {

using namespace apex::packed;
namespace flash = apex::flash;
namespace ring = apex::ring;

// BQ query rows and BK keys a tile: 64 x 64, or 32 x 32 at DMAX 512, where
// 64-row fp32 tiles would not fit the 227 KB of shared memory. A thread
// owns 4 query rows, BK / kTX keys of a score tile and DMAX / kTX output
// columns.
template <int DMAX, int BQ, int BK>
struct Smem {
  static constexpr int kQS = DMAX + 4;
  static constexpr int kKS = DMAX + 1;
  static constexpr int kSS = BK + 1;
  static constexpr int kTY = BQ / 4;         // threads down the rows
  static constexpr int kTX = kThreads / kTY;  // threads across
  static constexpr size_t floats =
      BQ * kQS + BK * kKS + BK * DMAX + BQ * kSS + 3 * BQ;
  static_assert(floats * 4 <= 232448, "one block fits an SM");
};

template <typename T, int DMAX, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_packed_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ o,
                        float* __restrict__ lse, const Opts opt) {
  using S = Smem<DMAX, BQ, BK>;
  constexpr int kTX = S::kTX;
  constexpr int kSC = BK / kTX;  // score columns a thread
  constexpr int kCols = DMAX / kTX;
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
  const int g = hh / opt.qpg;
  const int j = hh % opt.qpg;
  const int d = opt.d;
  const Layout lay(opt, bb);
  const bool drop = opt.seed != nullptr;
  const unsigned seed = drop ? static_cast<unsigned>(opt.seed[0]) : 0u;
  const unsigned cmb = combo(bb, hh);

  for (int idx = tid; idx < BQ * DMAX; idx += kThreads) {
    const int r = idx / DMAX;
    const int c = idx % DMAX;
    const int row = q_start + r;
    float val = 0.f;
    if (row < opt.s && c < d)
      val = load_rope(qkv + lay.q(g, j, row, d), opt, row, c);
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

  const int kvl = opt.kv_lengths != nullptr ? opt.kv_lengths[bb] : opt.s;
  int j_first, j_last;
  key_tiles(opt, kvl, q_start, &j_first, &j_last, BQ, BK);
  __syncthreads();

  for (int jt = j_first; jt <= j_last; ++jt) {
    const int k_start = jt * BK;
    for (int idx = tid; idx < BK * DMAX; idx += kThreads) {
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
    float sc[4][kSC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < kSC; ++jj) sc[i][jj] = 0.f;
    for (int c = 0; c < DMAX; ++c) {
      float qv[4];
      float kv[kSC];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * S::kQS + c];
#pragma unroll
      for (int jj = 0; jj < kSC; ++jj)
        kv[jj] = Ks[(tx + kTX * jj) * S::kKS + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < kSC; ++jj) sc[i][jj] = fmaf(qv[i], kv[jj], sc[i][jj]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q_start + ty * 4 + i;
#pragma unroll
      for (int jj = 0; jj < kSC; ++jj) {
        const int col = k_start + tx + kTX * jj;
        Ss[(ty * 4 + i) * S::kSS + tx + kTX * jj] =
            visible(opt, kvl, row, col) ? sc[i][jj] * opt.scale : kNeg;
      }
    }
    __syncthreads();

    // online softmax over undropped p; P V takes the dropped p (BK / 32
    // keys a lane)
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
      float p[BK / 32];
#pragma unroll
      for (int u = 0; u < BK / 32; ++u)
        p[u] = v[u] == kNeg ? 0.f : expf(v[u] - m_new);
      float psum = p[0];
#pragma unroll
      for (int u = 1; u < BK / 32; ++u) psum += p[u];
      const float l_blk = apex::warp_sum(psum);
      if (drop) {
        const unsigned row = q_start + r;
#pragma unroll
        for (int u = 0; u < BK / 32; ++u)
          p[u] = hash_keep(seed, cmb, row, k_start + lane + 32 * u,
                           opt.keep_thresh)
                     ? p[u] * opt.inv_keep : 0.f;
      }
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) srow[lane + 32 * u] = p[u];
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
    for (int jj = 0; jj < BK; ++jj) {
      float pv[4];
      float vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty * 4 + i) * S::kSS + jj];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = Vs[jj * DMAX + tx + kTX * c];
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
      const int col = tx + kTX * c;
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
  constexpr int kB = DMAX <= 256 ? 64 : 32;  // BQ = BK
  auto kernel = flash_packed_fwd_kernel<T, DMAX, kB, kB>;
  const size_t smem = Smem<DMAX, kB, kB>::floats * sizeof(float);
  cudaError_t err = apex::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((opt.s + kB - 1) / kB, opt.groups * opt.qpg, opt.b);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(qkv),
                                           static_cast<T*>(o), lse, opt);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* qkv, void* o, float* lse, const Opts& opt,
                     cudaStream_t stream) {
  if (opt.d <= 64) return launch<T, 64>(qkv, o, lse, opt, stream);
  if (opt.d <= 128) return launch<T, 128>(qkv, o, lse, opt, stream);
  if (opt.d <= 256) return launch<T, 256>(qkv, o, lse, opt, stream);
  if (opt.d <= 512) return launch<T, 512>(qkv, o, lse, opt, stream);
  return cudaErrorInvalidValue;
}

// The 16-bit kernel: WARPS warps of 16 query rows, key tiles of BK
// through a ring of STAGES (K, V) stages.
template <int DMAX, int WARPS, int STAGES, int BK>
struct MmaCfg {
  static constexpr int kThreads = WARPS * 32;
  static constexpr int kParts = flash::Cols<DMAX>::kParts;  // warps a strip
  static constexpr int kRows = WARPS / kParts * 16;  // query rows a block
  static constexpr int kLd = flash::Tile<DMAX>::kLd;
  static constexpr int kStage = 2 * BK * kLd;  // K then V, 16-bit
  static constexpr size_t bytes = (kRows * kLd + STAGES * kStage) * 2;
  // two blocks an SM at d <= 64 (registers capped at 128 a thread): the
  // kernel waits on latency more than on any one unit, so occupancy wins
  // over the few bytes it spills
  static constexpr int kMinBlocks = DMAX <= 64 ? 2 : 1;
  static_assert(bytes <= 232448, "one block fits an SM");
};

template <typename T, int DMAX, int WARPS, int STAGES, int BK, bool VEC>
__global__ void __launch_bounds__(WARPS * 32,
                                  (MmaCfg<DMAX, WARPS, STAGES, BK>::kMinBlocks))
flash_packed_fwd_mma(const T* __restrict__ qkv, T* __restrict__ o,
                     float* __restrict__ lse, const Opts opt) {
  using C = MmaCfg<DMAX, WARPS, STAGES, BK>;
  constexpr bool kF16 = std::is_same<T, __half>::value;
  using W = flash::Cols<DMAX>;
  constexpr int kKS = DMAX / 16;  // k16 steps of Q K^T
  constexpr int kNS = BK / 8;     // n8 score tiles a warp
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
  const int qt = opt.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q_start = qt * C::kRows;
  const int r0 = q_start + 16 * strip;  // the warp's first row
  const int g = hh / opt.qpg;
  const int d = opt.d;
  const Layout lay(opt, bb);
  const int kvl = opt.kv_lengths != nullptr ? opt.kv_lengths[bb] : opt.s;
  int first, last;
  key_tiles(opt, kvl, q_start, &first, &last, C::kRows, BK);
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
      flash::copy_tile<BK, DMAX, C::kThreads, VEC>(
          stage, qkv, kcol, lay.row_stride, tile * BK, opt.s, d);
      flash::copy_tile<BK, DMAX, C::kThreads, VEC>(
          stage + BK * C::kLd, qkv, vcol, lay.row_stride, tile * BK, opt.s,
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

    // Q's A fragments: all of them held from the first tile on, or (past
    // d 128) one at a time, read at each k16 step
    unsigned qf[W::kRegA ? kKS : 1][1][4];
    const T* qw_s = Qs + 16 * strip * C::kLd;
    const int g4 = lane / 4;
    const int t4 = lane % 4;
    for (int it = 0; it < tiles; ++it) {
      ring::cp_async_wait<STAGES - 2>();
      __syncthreads();
      T* Ks = kv + (it % STAGES) * C::kStage;
      T* Vs = Ks + BK * C::kLd;
      const int c0 = (first + it) * BK;
      if (opt.rot > 0) {
        if (it == 0)
          flash::rope_tile<C::kRows, C::kThreads>(Qs, C::kLd, q_start, opt);
        flash::rope_tile<BK, C::kThreads>(Ks, C::kLd, c0, opt);
        __syncthreads();
      }
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

      const flash::Cover cover = flash::tile_cover(opt, kvl, r0, c0, BK);
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
      for (int kk = 0; kk < BK / 16; ++kk) {
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

  const int heads = opt.groups * opt.qpg;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + lane / 4 + 8 * h;
    if (row >= opt.s) continue;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
    T* orow = o + out_index(opt, bb, hh, row);
#pragma unroll
    for (int j = 0; j < kNO; ++j) {
      const int col = cb + 8 * j + 2 * (lane % 4);
      float x = acc[j][2 * h] * inv;
      float y = acc[j][2 * h + 1] * inv;
      if (kF16) {
        x *= o_scale;
        y *= o_scale;
      }
      flash::store_pair(orow, col, d, x, y);
    }
    if (lane % 4 == 0 && cb == 0)
      lse[(static_cast<long long>(bb) * heads + hh) * opt.s + row] =
          l[h] > 0.f ? m[h] + logf(l[h]) : kLsePad;
  }
}

template <typename T, int DMAX, int WARPS, int STAGES, int BK, bool VEC>
cudaError_t launch_mma(const void* qkv, void* o, float* lse, const Opts& opt,
                       cudaStream_t stream) {
  using C = MmaCfg<DMAX, WARPS, STAGES, BK>;
  auto kernel = flash_packed_fwd_mma<T, DMAX, WARPS, STAGES, BK, VEC>;
  cudaError_t err = apex::allow_smem(kernel, C::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(opt.groups * opt.qpg, opt.b,
                  (opt.s + C::kRows - 1) / C::kRows);
  kernel<<<grid, C::kThreads, C::bytes, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(o), lse, opt);
  return cudaGetLastError();
}

// 8 warps (128 query rows a block; 64 at d 256, two warps a strip; 32 at
// d 512, four warps a strip); 3 ring stages at d <= 64, 2 from 128 on; key
// tiles of 64, or 32 at d 512 (two stages of 64 keys and the Q tile would
// need 299,520 bytes, of 32 keys 166,400).
// 16-byte copies need every row start (a multiple of d past a 16-byte
// aligned base) on a 16-byte boundary.
template <typename T, int DMAX>
cudaError_t launch_mma_vec(const void* qkv, void* o, float* lse,
                           const Opts& opt, cudaStream_t stream) {
  constexpr int kWarps = 8;
  constexpr int kStages = DMAX <= 64 ? 3 : 2;
  constexpr int kKeys = DMAX <= 256 ? kBK : 32;
  const bool vec = opt.d % 8 == 0 &&
                   reinterpret_cast<unsigned long long>(qkv) % 16 == 0;
  return vec ? launch_mma<T, DMAX, kWarps, kStages, kKeys, true>(
                   qkv, o, lse, opt, stream)
             : launch_mma<T, DMAX, kWarps, kStages, kKeys, false>(
                   qkv, o, lse, opt, stream);
}

// the bf16 and fp16 paths
template <typename T>
cudaError_t launch_16(const void* qkv, void* o, float* lse, const Opts& opt,
                      cudaStream_t stream) {
  if (opt.d <= 64) return launch_mma_vec<T, 64>(qkv, o, lse, opt, stream);
  if (opt.d <= 128) return launch_mma_vec<T, 128>(qkv, o, lse, opt, stream);
  if (opt.d <= 256) return launch_mma_vec<T, 256>(qkv, o, lse, opt, stream);
  if (opt.d <= 512) return launch_mma_vec<T, 512>(qkv, o, lse, opt, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// qkv [s, b, groups * (qpg + 2) * d], o [s, b, groups * qpg * d] of one
// dtype (f32, bf16 or fp16; another code is cudaErrorInvalidValue),
// lse [b, groups * qpg, s] fp32, all contiguous. kv_lengths [b] int32,
// cos/sin [s, d] fp32 and seed [1] int32 may each be null (feature off).
// Any d > 0: past 512 the wide instance (flash_wide_fwd.cu), which with
// RoPE (rot > 0) needs rot_qkv, scratch like qkv (else null).
extern "C" int apex_flash_packed_fwd(const void* qkv, void* o, void* lse,
                                     const void* kv_lengths, const void* cos,
                                     const void* sin, const void* seed,
                                     void* rot_qkv, void* stream, int s, int b, int groups,
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
  if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (d > apex::wide::kMaxTiled)
    return static_cast<int>(
        apex::wide::fwd_packed(qkv, o, l, rot_qkv, opt, dtype, st));
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == apex::kBF16)
    err = launch_16<__nv_bfloat16>(qkv, o, l, opt, st);
  else if (dtype == apex::kF16)
    err = launch_16<__half>(qkv, o, l, opt, st);
  else if (dtype == apex::kF32)
    err = launch_d<float>(qkv, o, l, opt, st);
  return static_cast<int>(err);
}

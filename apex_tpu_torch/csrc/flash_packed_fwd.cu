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
//
// Bound on the H100: at GPT-2 124M training (b 8, 12 heads, s 1024,
// d 64, causal, bf16) the causal work is 4 d per visible (row, col) pair,
// 12.9 GFLOP (13 us at the bf16 tensor rate), against 50.7 MB of qkv, o
// and lse (15 us at 3.35 TB/s).
//
// Design (correct and simple first, as Kernel B in flash_fwd.cu): one
// 256-thread block per (64-row query tile, head, batch); the rotated query
// tile stays in shared memory as fp32; the block walks the visible 64-key
// tiles with an online softmax, S = Q K^T and P V in fp32 FMA, each thread
// owning a 4 x (DMAX / 16) output tile. No tensor cores or asynchronous
// copies yet: that is the work of a later change.
#include "packed_attention.cuh"

namespace {

using namespace apex::packed;

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

}  // namespace

// qkv [s, b, groups * (qpg + 2) * d], o [s, b, groups * qpg * d],
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
  cudaError_t err = dtype == apex::kBF16
                        ? launch_d<__nv_bfloat16>(qkv, o, l, opt, st)
                        : launch_d<float>(qkv, o, l, opt, st);
  return static_cast<int>(err);
}

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
// (:77) — causal with the query offset q_off = sk - sq, per-batch
// kv_lengths, sliding window (keep keys with col > row - window), and the
// key-padding bound; key tiles with no unmasked column are skipped, as
// `_causal_block_skip` does (:101); query head h reads key/value head
// h / group (GQA); rows with no visible key give o = 0 and lse = 1e30
// (`_LSE_PAD`). Masked scores hold the finite -1e30 (`_NEG_INF`), and
// their probabilities are set to 0 explicitly, so the running max never
// meets inf - inf.
//
// Bound on the H100: at the serving prefill shapes (b=1, 12 heads,
// d=64, s up to 768, bf16) the work is 4*s*s_visible*d operations per
// head against (q+k+v+o) bytes; the operation floor at the bf16 tensor
// rate (989 TFLOP/s) and the byte floor at 3.35 TB/s are both a few
// microseconds, and the byte floor is the larger one below s ~ 1k.
//
// Design (correct and simple first): one 256-thread block per
// (64-row query tile, head, batch). The query tile stays in shared
// memory; the block walks the visible 64-row key/value tiles, computing
// S = Q K^T and P V with fp32 FMA from shared memory, each thread owning
// a 4 x (DMAX/16) register tile of the output. It does not use the
// tensor cores (wgmma / mma.sync) or asynchronous copies; that is the
// work of a later change.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;     // attention.py _NEG_INF
constexpr float kLsePad = 1e30f;   // attention.py _LSE_PAD

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  const int* kv_lengths;  // may be null
  int b, h, kvh, sq, sk, d;
  float scale;
  int causal;
  int window;  // 0 = no sliding window
};

template <int DMAX>
struct Smem {
  static constexpr int kQS = DMAX + 4;  // padded strides: no bank conflicts
  static constexpr int kKS = DMAX + 1;
  static constexpr int kSS = kBK + 1;
  static constexpr size_t floats =
      kBQ * kQS + kBK * kKS + kBK * DMAX + kBQ * kSS + 3 * kBQ;
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ kv_lengths,
                 int H, int KVH, int sq, int sk, int d, float scale,
                 int causal, int window) {
  using S = Smem<DMAX>;
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
  const int q_off = sk - sq;

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

  // visible key range of this query tile (global positions)
  const int kvl = kv_lengths != nullptr ? kv_lengths[bb] : sk;
  const int last_row = min(q_start + kBQ, sq) - 1;
  int k_end = min(sk, kvl);
  if (causal) k_end = min(k_end, last_row + q_off + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_start + q_off - window + 1);
  const int j_first = k_begin / kBK;
  const int j_last = k_end > k_begin ? (k_end - 1) / kBK : j_first - 1;
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
      const int row_g = q_start + ty * 4 + i + q_off;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k_start + tx + 16 * j;
        bool valid = col < sk && col < kvl;
        if (causal) valid = valid && col <= row_g;
        if (window > 0) valid = valid && col > row_g - window;
        Ss[(ty * 4 + i) * S::kSS + tx + 16 * j] = valid ? s[i][j] * scale : kNeg;
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

template <typename T, int DMAX>
cudaError_t launch(const FlashArgs& a, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, DMAX>;
  const size_t smem = Smem<DMAX>::floats * sizeof(float);
  cudaError_t err = apex::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + kBQ - 1) / kBQ, a.h, a.b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.kv_lengths,
      a.h, a.kvh, a.sq, a.sk, a.d, a.scale, a.causal, a.window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const FlashArgs& a, cudaStream_t stream) {
  if (a.d <= 64) return launch<T, 64>(a, stream);
  if (a.d <= 128) return launch<T, 128>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q [b, h, sq, d], k/v [b, kvh, sk, d], o like q, lse [b, h, sq] fp32;
// all contiguous. kv_lengths [b] int32 or null; window 0 = none.
extern "C" int apex_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, const void* kv_lengths,
                              void* stream, int b, int h, int kvh, int sq,
                              int sk, int d, float scale, int causal,
                              int window, int dtype) {
  FlashArgs a{q, k, v, o, static_cast<float*>(lse),
              static_cast<const int*>(kv_lengths), b, h, kvh, sq, sk, d,
              scale, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == apex::kBF16 ? launch_d<__nv_bfloat16>(a, s)
                                         : launch_d<float>(a, s);
  return static_cast<int>(err);
}

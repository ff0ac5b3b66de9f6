// Flash attention forward past head_dim 512: Kernel B's and Kernel E's
// wide instance (flash_wide.cuh says what it replaces and how d is split).
//
// Bound on the H100: at the d-1024 training shape (qkv [1024, 2, 6144]:
// 4 query heads of 1024 over one K/V head, causal, bf16) the work is 4 d
// a visible pair, 17 GFLOP (17 us at the bf16 tensor rate), against 33 MB
// of qkv, o and lse (10 us at 3.35 TB/s): operations bound it. This
// kernel does 2 d cdiv(d, 512) x 4 (each of a strip's four warps sums the
// strip's S) + 4 d (p split hi + lo) a visible pair: 20 d at d 1024.
//
// bf16 and fp16 (T): one block of 8 warps per (head x part, batch, 32-row
// query tile), the heaviest causal tiles first. Two strips of 16 query
// rows, four warps a strip, each warp owning 128 of the part's columns
// (DMAX 512's layout, flash_mma.cuh Cols). Key tiles of 32; for each, the
// block streams cdiv(d, 256) stages of (32 query rows x 256 columns of Q,
// 32 keys x 256 of K) and then one stage of the part's 512 columns of V
// through a 3-stage cp.async ring (33,792 bytes a stage): S on mma.sync
// m16n8k16 with the tensor cores carrying the sum, the masks, the online
// softmax, the dropout hash and P V with p split into T hi + lo (fp16 p
// scaled by 2^(14 - ilogb(1 / (1 - rate))) first) exactly as the DMAX
// instances do (flash_fwd.cu, flash_packed_fwd.cu). No atomics: repeated
// runs are bitwise equal.
//
// f32 (checks only): one 256-thread block per (32-row query tile, head x
// part, batch) walks 32-key tiles; S sums 64-column slices of Q and K in
// shared memory with fp32 FMA, then the online softmax and P V over the
// part's 512 columns of V (a thread owns 4 rows x 16 columns).
#include "flash_wide.cuh"

namespace {

using namespace apex::packed;  // kNeg, kLsePad, Mask, visible, key_tiles
namespace flash = apex::flash;
namespace ring = apex::ring;
namespace wide = apex::wide;
using wide::Args;

constexpr int kWarps = 8;
constexpr int kThreads16 = kWarps * 32;
constexpr int kRows = 32;    // query rows a block (2 strips of 16)
constexpr int kKeys = 32;    // keys a tile
constexpr int kWidth = 128;  // output columns a warp
constexpr int kSlice = 256;  // columns of a streamed Q / K slice
constexpr int kSliceLd = flash::Tile<kSlice>::kLd;
constexpr int kPartLd = flash::Tile<wide::kPart>::kLd;
constexpr int kStages = 3;
constexpr int kStageElems = (kRows + kKeys) * kSliceLd > kKeys * kPartLd
                                ? (kRows + kKeys) * kSliceLd
                                : kKeys * kPartLd;
constexpr int kStageBytes = kStageElems * 2;
constexpr size_t kSmem16 = static_cast<size_t>(kStages) * kStageBytes;
static_assert(kSmem16 <= 232448, "one block fits an SM");

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads16, 1)
fwd_mma(const Args a) {
  constexpr bool kF16 = std::is_same<T, __half>::value;
  constexpr int kNS = kKeys / 8;    // n8 score tiles a warp
  constexpr int kNO = kWidth / 8;   // n8 output tiles a warp
  extern __shared__ __align__(16) unsigned char wsmem[];
  const Mask& mk = a.mask;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g4 = lane / 4;
  const int t4 = lane % 4;
  const int strip = warp / 4;         // the warp's 16 query rows
  const int cb = warp % 4 * kWidth;   // its first column of the part
  const int parts = wide::cdiv(a.d, wide::kPart);
  const int hh = blockIdx.x / parts;
  const int p0 = blockIdx.x % parts * wide::kPart;  // the part's first column
  const int bb = blockIdx.y;
  const int qt = mk.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q_start = qt * kRows;
  const int r0 = q_start + 16 * strip;
  const int group = a.H / a.KVH;
  const long long qb = a.vq.base(bb, hh);
  const long long kb = a.vk.base(bb, hh / group);
  const int kvl = local_kvl(mk, a.kv_lengths, bb);
  int first, last;
  key_tiles(mk, kvl, q_start, &first, &last, kRows, kKeys);
  const int tiles = last - first + 1;
  const int slices = wide::cdiv(a.d, kSlice);
  const int per_tile = slices + 1;  // Q/K slices, then the part of V

  float acc[kNO][4];
#pragma unroll
  for (int j = 0; j < kNO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float sc[kNS][4];
#pragma unroll
  for (int j = 0; j < kNS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};
  // fp16: the dropped p scaled by 2^(14 - e) before its split, o by the
  // inverse after it (inv_keep 1 without dropout: 2^14, Kernel B's)
  const int p_exp = kF16 ? 14 - ilogbf(a.inv_keep) : 0;
  const float p_scale = ldexpf(1.f, p_exp);
  const float o_scale = ldexpf(1.f, -p_exp);

  if (tiles > 0) {
    const bool drop = a.seed != nullptr;
    const unsigned seed = drop ? static_cast<unsigned>(a.seed[0]) : 0u;
    const unsigned cmb = combo(bb, hh);
    int loaded = 0;
    auto load = [&](unsigned char* st_) {
      T* st = reinterpret_cast<T*>(st_);
      const int u = loaded % per_tile;
      const int c0 = (first + loaded / per_tile) * kKeys;
      ++loaded;
      if (u < slices) {
        const int col = u * kSlice;
        flash::copy_tile<kRows, kSlice, kThreads16, VEC>(
            st, q, qb + col, a.vq.sr, q_start, mk.sq, a.d - col);
        flash::copy_tile<kKeys, kSlice, kThreads16, VEC>(
            st + kRows * kSliceLd, k, kb + col, a.vk.sr, c0, mk.sk,
            a.d - col);
      } else {
        flash::copy_tile<kKeys, wide::kPart, kThreads16, VEC>(
            st, v, kb + p0, a.vk.sr, c0, mk.sk, a.d - p0);
      }
    };
    int done = 0;
    auto step = [&](unsigned char* st_) {
      const T* st = reinterpret_cast<const T*>(st_);
      const int u = done % per_tile;
      const int c0 = (first + done / per_tile) * kKeys;
      ++done;
      const flash::Cover cover = flash::tile_cover(mk, kvl, r0, c0, kKeys);
      if (cover == flash::kNone) return;  // nothing summed: sc stays 0
      if (u < slices) {  // S += Q K^T over this slice
        const T* qs = st + 16 * strip * kSliceLd;
        const T* ks = st + kRows * kSliceLd;
#pragma unroll 4
        for (int kk = 0; kk < kSlice / 16; ++kk) {
          unsigned qf[1][4];
          ring::load_a<1, false>(qf, qs, kSliceLd, 16 * kk);
          unsigned fb[kNS / 2][4];
          ring::load_b<kNS, false>(fb, ks, kSliceLd, 16 * kk);
#pragma unroll
          for (int j = 0; j < kNS; ++j)
            flash::mma_acc<T>(sc[j], qf[0], fb[j >> 1][2 * (j & 1)],
                              fb[j >> 1][2 * (j & 1) + 1]);
        }
        return;
      }
#pragma unroll
      for (int j = 0; j < kNS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + g4 + 8 * (e >> 1);
          const int col = c0 + 8 * j + 2 * t4 + (e & 1);
          sc[j][e] = cover == flash::kAll || visible(mk, kvl, row, col)
                         ? sc[j][e] * a.scale : kNeg;
        }
      flash::softmax_step<kNS, kNO>(sc, m, l, acc);
      if (drop) {
#pragma unroll
        for (int j = 0; j < kNS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const unsigned row = r0 + g4 + 8 * (e >> 1);
            const unsigned col = c0 + 8 * j + 2 * t4 + (e & 1);
            sc[j][e] = hash_keep(seed, cmb, row, col, a.keep_thresh)
                           ? sc[j][e] * a.inv_keep : 0.f;
          }
      }
      if (kF16) {
#pragma unroll
        for (int j = 0; j < kNS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] *= p_scale;
      }
      // acc += p_hi V + p_lo V over the part's columns
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        unsigned hi[4], lo[4];
        flash::p_fragments<kNS, T>(sc, kk, hi, lo);
        unsigned fb[kNO / 2][4];
        ring::load_b<kNO, true>(fb, st + cb, kPartLd, 16 * kk);
#pragma unroll
        for (int j = 0; j < kNO; ++j) {
          flash::mma_acc<T>(acc[j], hi, fb[j >> 1][2 * (j & 1)],
                            fb[j >> 1][2 * (j & 1) + 1]);
          flash::mma_acc<T>(acc[j], lo, fb[j >> 1][2 * (j & 1)],
                            fb[j >> 1][2 * (j & 1) + 1]);
        }
      }
#pragma unroll
      for (int j = 0; j < kNS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    };
    ring::run_ring<kStages, kStageBytes>(tiles * per_tile, wsmem, load,
                                         step);
  }

  T* o = static_cast<T*>(a.o);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g4 + 8 * h;
    if (row >= mk.sq) continue;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
    T* orow = o + a.vo.base(bb, hh) + static_cast<long long>(row) * a.vo.sr +
              p0;
#pragma unroll
    for (int j = 0; j < kNO; ++j)
      flash::store_pair(orow, cb + 8 * j + 2 * t4, a.d - p0,
                        acc[j][2 * h] * inv * o_scale,
                        acc[j][2 * h + 1] * inv * o_scale);
    if (t4 == 0 && cb == 0 && p0 == 0)
      const_cast<float*>(a.lse)[(static_cast<long long>(bb) * a.H + hh) *
                                    mk.sq + row] =
          l[h] > 0.f ? m[h] + logf(l[h]) : kLsePad;
  }
}

// f32: BQ query rows x BK keys a tile, S from 64-column slices, the part's
// 512 columns of V; a thread owns 4 rows, BK / 32 keys and 16 columns
constexpr int kFQ = 32;
constexpr int kFK = 32;
constexpr int kFS = 64;  // columns of a slice
constexpr int kFThreads = 256;
constexpr int kFTX = kFThreads / (kFQ / 4);  // 32 threads across
struct FSmem {
  static constexpr int kQS = kFS + 4;
  static constexpr int kKS = kFS + 1;
  static constexpr int kSS = kFK + 1;
  static constexpr size_t floats = kFQ * kQS + kFK * kKS + kFK * wide::kPart +
                                   kFQ * kSS + 3 * kFQ;
  static_assert(floats * 4 <= 232448, "one block fits an SM");
};

__global__ void __launch_bounds__(kFThreads)
fwd_f32(const Args a) {
  using S = FSmem;
  constexpr int kSC = kFK / kFTX;           // score columns a thread
  constexpr int kCols = wide::kPart / kFTX;  // output columns a thread
  extern __shared__ float fsm[];
  float* Qs = fsm;
  float* Ks = Qs + kFQ * S::kQS;
  float* Vs = Ks + kFK * S::kKS;
  float* Ss = Vs + kFK * wide::kPart;
  float* m_s = Ss + kFQ * S::kSS;
  float* l_s = m_s + kFQ;
  float* alpha_s = l_s + kFQ;
  const Mask& mk = a.mask;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);

  const int tid = threadIdx.x;
  const int tx = tid % kFTX;
  const int ty = tid / kFTX;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q_start = blockIdx.x * kFQ;
  const int parts = wide::cdiv(a.d, wide::kPart);
  const int hh = blockIdx.y / parts;
  const int p0 = blockIdx.y % parts * wide::kPart;
  const int bb = blockIdx.z;
  const int d = a.d;
  const int group = a.H / a.KVH;
  const long long qb = a.vq.base(bb, hh);
  const long long kb = a.vk.base(bb, hh / group);
  const bool drop = a.seed != nullptr;
  const unsigned seed = drop ? static_cast<unsigned>(a.seed[0]) : 0u;
  const unsigned cmb = combo(bb, hh);
  if (tid < kFQ) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  const int kvl = local_kvl(mk, a.kv_lengths, bb);
  int j_first, j_last;
  key_tiles(mk, kvl, q_start, &j_first, &j_last, kFQ, kFK);

  for (int jt = j_first; jt <= j_last; ++jt) {
    const int k_start = jt * kFK;
    float s[4][kSC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kSC; ++j) s[i][j] = 0.f;
    for (int c0 = 0; c0 < d; c0 += kFS) {
      __syncthreads();  // the previous slice's readers are done
      for (int idx = tid; idx < kFQ * kFS; idx += kFThreads) {
        const int r = idx / kFS;
        const int c = idx % kFS;
        const int row = q_start + r;
        Qs[r * S::kQS + c] = row < mk.sq && c0 + c < d
            ? q[qb + static_cast<long long>(row) * a.vq.sr + c0 + c] : 0.f;
        const int key = k_start + r;
        Ks[r * S::kKS + c] = key < mk.sk && c0 + c < d
            ? k[kb + static_cast<long long>(key) * a.vk.sr + c0 + c] : 0.f;
      }
      __syncthreads();
      for (int c = 0; c < kFS; ++c) {
        float qv[4];
        float kv[kSC];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * S::kQS + c];
#pragma unroll
        for (int j = 0; j < kSC; ++j) kv[j] = Ks[(tx + kFTX * j) * S::kKS + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kSC; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }
    // the part's columns of V, the masked scores
    for (int idx = tid; idx < kFK * wide::kPart; idx += kFThreads) {
      const int r = idx / wide::kPart;
      const int c = idx % wide::kPart;
      const int key = k_start + r;
      Vs[idx] = key < mk.sk && p0 + c < d
          ? v[kb + static_cast<long long>(key) * a.vk.sr + p0 + c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q_start + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < kSC; ++j) {
        const int col = k_start + tx + kFTX * j;
        Ss[(ty * 4 + i) * S::kSS + tx + kFTX * j] =
            visible(mk, kvl, row, col) ? s[i][j] * a.scale : kNeg;
      }
    }
    __syncthreads();
    // online softmax over the undropped p; P V takes the dropped p
    for (int r = warp * (kFQ / 8); r < (warp + 1) * (kFQ / 8); ++r) {
      float* srow = Ss + r * S::kSS;
      float sv[kFK / 32];
#pragma unroll
      for (int u = 0; u < kFK / 32; ++u) sv[u] = srow[lane + 32 * u];
      float vmax = sv[0];
#pragma unroll
      for (int u = 1; u < kFK / 32; ++u) vmax = fmaxf(vmax, sv[u]);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, apex::warp_max(vmax));
      float p[kFK / 32];
#pragma unroll
      for (int u = 0; u < kFK / 32; ++u)
        p[u] = sv[u] == kNeg ? 0.f : expf(sv[u] - m_new);
      float psum = p[0];
#pragma unroll
      for (int u = 1; u < kFK / 32; ++u) psum += p[u];
      const float l_blk = apex::warp_sum(psum);
      if (drop) {
        const unsigned row = q_start + r;
#pragma unroll
        for (int u = 0; u < kFK / 32; ++u)
          p[u] = hash_keep(seed, cmb, row, k_start + lane + 32 * u,
                           a.keep_thresh) ? p[u] * a.inv_keep : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kFK / 32; ++u) srow[lane + 32 * u] = p[u];
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + l_blk;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = alpha_s[ty * 4 + i];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    for (int j = 0; j < kFK; ++j) {
      float pv[4];
      float vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty * 4 + i) * S::kSS + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        vv[c] = Vs[j * wide::kPart + tx + kFTX * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }
  __syncthreads();

  float* o = static_cast<float*>(a.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int row = q_start + r;
    if (row >= mk.sq) continue;
    const float l = l_s[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    float* orow = o + a.vo.base(bb, hh) + static_cast<long long>(row) *
                  a.vo.sr + p0;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + kFTX * c;
      if (p0 + col < d) orow[col] = acc[i][c] * inv;
    }
    if (tx == 0 && p0 == 0)
      const_cast<float*>(a.lse)[(static_cast<long long>(bb) * a.H + hh) *
                                    mk.sq + row] =
          l > 0.f ? m_s[r] + logf(l) : kLsePad;
  }
}

template <typename T, bool VEC>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  auto kernel = fwd_mma<T, VEC>;
  cudaError_t err = apex::allow_smem(kernel, kSmem16);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H * wide::cdiv(a.d, wide::kPart), a.b,
                  wide::cdiv(a.mask.sq, kRows));
  kernel<<<grid, kThreads16, kSmem16, stream>>>(a);
  return cudaGetLastError();
}

// 16-byte copies need d % 8 == 0 and every operand's base 16-byte aligned
// (then every row and slice start is)
template <typename T>
cudaError_t launch_16(const Args& a, cudaStream_t stream) {
  auto aligned = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  const bool vec = a.d % 8 == 0 && aligned(a.q) && aligned(a.k) &&
                   aligned(a.v);
  return vec ? launch_mma<T, true>(a, stream) : launch_mma<T, false>(a, stream);
}

cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  const size_t smem = FSmem::floats * sizeof(float);
  cudaError_t err = apex::allow_smem(fwd_f32, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(wide::cdiv(a.mask.sq, kFQ),
                  a.H * wide::cdiv(a.d, wide::kPart), a.b);
  fwd_f32<<<grid, kFThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch(const Args& a, int dtype, cudaStream_t stream) {
  if (dtype == apex::kBF16) return launch_16<__nv_bfloat16>(a, stream);
  if (dtype == apex::kF16) return launch_16<__half>(a, stream);
  if (dtype == apex::kF32) return launch_f32(a, stream);
  return cudaErrorInvalidValue;
}

// q and k of every group rotated as `_rope_block` (packed::load_rope: fp32
// with separate roundings, then one round to T) into the same columns of
// `out`; one thread an element
template <typename T>
__global__ void __launch_bounds__(256)
rope_prep_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                 const Opts opt) {
  const long long slots = opt.qpg + 1;  // q heads and k of a group
  const long long n = static_cast<long long>(opt.s) * opt.b * opt.groups *
                      slots * opt.d;
  const long long w = static_cast<long long>(opt.groups) * (opt.qpg + 2) *
                      opt.d;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * 256) {
    const int c = static_cast<int>(i % opt.d);
    long long r = i / opt.d;
    const int j = static_cast<int>(r % slots);
    r /= slots;
    const int g = static_cast<int>(r % opt.groups);
    r /= opt.groups;
    const int bb = static_cast<int>(r % opt.b);
    const int pos = static_cast<int>(r / opt.b);
    const long long at = static_cast<long long>(pos) * opt.b * w + bb * w +
                         (static_cast<long long>(g) * (opt.qpg + 2) + j) *
                             opt.d;
    apex::store(&out[at + c], load_rope(qkv + at, opt, pos, c));
  }
}

template <typename T>
cudaError_t launch_rope(const void* qkv, void* rot, const Opts& opt,
                        cudaStream_t stream) {
  const long long n = static_cast<long long>(opt.s) * opt.b * opt.groups *
                      (opt.qpg + 1) * opt.d;
  const unsigned blocks =
      static_cast<unsigned>(n / 256 + 1 < 65536 ? n / 256 + 1 : 65536);
  rope_prep_kernel<T><<<blocks, 256, 0, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(rot), opt);
  return cudaGetLastError();
}

}  // namespace

namespace apex {
namespace wide {

cudaError_t fwd_4d(const void* q, const void* k, const void* v, void* o,
                   float* lse, const int* kvl, int b, int h, int kvh, int d,
                   float scale, const Mask& mask, int dtype,
                   cudaStream_t stream) {
  Args a = args_4d(b, h, kvh, d, scale, mask, kvl);
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = lse;
  return launch(a, dtype, stream);
}

cudaError_t rope_prep(const void* qkv, void* rot, const Opts& opt, int dtype,
                      cudaStream_t stream) {
  if (dtype == apex::kBF16)
    return launch_rope<__nv_bfloat16>(qkv, rot, opt, stream);
  if (dtype == apex::kF16) return launch_rope<__half>(qkv, rot, opt, stream);
  if (dtype == apex::kF32) return launch_rope<float>(qkv, rot, opt, stream);
  return cudaErrorInvalidValue;
}

cudaError_t fwd_packed(const void* qkv, void* o, float* lse, void* rot_qkv,
                       const Opts& opt, int dtype, cudaStream_t stream) {
  const bool rope = opt.rot > 0;
  if (rope && rot_qkv == nullptr) return cudaErrorInvalidValue;
  if (rope) {
    const cudaError_t err = rope_prep(qkv, rot_qkv, opt, dtype, stream);
    if (err != cudaSuccess) return err;
  }
  Args a = args_packed(opt, rope ? rot_qkv : qkv, qkv,
                       dtype == apex::kF32 ? 4 : 2);
  a.o = o;
  a.lse = lse;
  return launch(a, dtype, stream);
}

}  // namespace wide
}  // namespace apex

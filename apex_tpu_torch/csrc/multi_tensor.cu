// Multi-tensor kernels of the PyTorch port: amp's unscale, the L2 norms,
// and the Adam, LAMB and SGD steps, each over a whole parameter list.
//
// Replaces no Pallas kernel: the JAX package's optimizers and amp unscale
// are jnp tree math that XLA compiles into a few fused loops over the whole
// parameter set (apex_tpu/optimizers/base.py:1-9, utils/tree.py:35-41,
// amp/scaler.py:86-104). Run eagerly in PyTorch, the same math is ~26
// device operations a tensor (Adam: 3,848 a GPT-2 step on an H100). These
// kernels are the port's counterpart of XLA's fused loops, in apex's amp_C
// design (csrc/multi_tensor_{scale,l2norm,adam,lamb,sgd}_kernel.cu): a few
// launches a list, chunked as csrc/multi_tensor.cuh describes.
//
// Semantics: each is the plain version in apex_tpu_torch/ops/multi_tensor.py
// (the per-parameter torch ops the optimizers run on the CPU), element by
// element. Every fp32 operation is written with a round-to-nearest
// intrinsic in the plain version's order, so nvcc cannot contract it into
// an FMA (the build never takes --use_fast_math): scale, Adam and SGD match
// the plain version run on the card bitwise. torch divides by a host scalar
// through its reciprocal; those divisions arrive here as reciprocals
// formed on the host (`1 - beta` in double, then rounded to fp32, as
// Python forms it). The norms differ from torch's only in summation order:
// fp32 sums of squares, a block's elements by a fixed tree, the chunks of a
// tensor in order, the tensors in a fixed tree (bitwise repeatable).
//
// found_inf (a device bool) turns a whole optimizer step into no write at
// all, read on the device: no host sync, capture-safe. Each tensor keeps its
// own int32 step counter; the kernels read it (bias corrections, SGD's
// first-step rule) and one more launch bumps every counter after the step,
// unless found_inf.
//
// Bound on the H100: bytes. Adam over GPT-2 124M in fp32 moves 28 bytes an
// element (g 4, p 8, m and v 16; 3.48 GB, ~1.04 ms at 3.35 TB/s) against ~20
// fp32 operations. A block covers one 16384-element chunk with 256 threads,
// element by element (coalesced 4- or 2-byte accesses; 16-byte vectors and
// cp.async are left for later).
#include "multi_tensor.cuh"

namespace {

using mt::Record;
using mt::Span;

__global__ void __launch_bounds__(mt::kThreads)
scale_kernel(Record r, const float* scale, unsigned char* found_inf) {
  const Span s = mt::block_span(r);
  void* g = r.addr(0, s.j);
  const int code = r.code(0, s.j);
  const float inv = __fdiv_rn(1.0f, *scale);
  int bad = 0;
  for (long long i = s.lo + threadIdx.x; i < s.hi; i += mt::kThreads) {
    const float v = mt::load(g, code, i);
    const bool finite = isfinite(v);
    bad |= !finite;
    mt::store(g, code, i, finite ? __fmul_rn(v, inv) : 0.0f);
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) *found_inf = 1;
}

__global__ void __launch_bounds__(mt::kThreads)
l2norm_kernel(Record r, int list, const float* scale, float* partial) {
  __shared__ float warps[mt::kThreads / 32];
  const Span s = mt::block_span(r);
  const void* x = r.addr(list, s.j);
  const int code = r.code(list, s.j);
  const float inv = scale == nullptr ? 1.0f : __fdiv_rn(1.0f, *scale);
  float acc = 0.f;
  for (long long i = s.lo + threadIdx.x; i < s.hi; i += mt::kThreads) {
    float v = mt::load(x, code, i);
    if (scale != nullptr) v = __fmul_rn(v, inv);
    acc = __fadd_rn(acc, __fmul_rn(v, v));
  }
  acc = mt::block_sum(acc, warps);
  if (threadIdx.x == 0) partial[r.first_chunk() + blockIdx.x] = acc;
}

constexpr int kFinishThreads = 1024;

// Per tensor: its chunks' partial sums in chunk order, then the sqrt; the
// total over the tensors by a fixed tree. One block.
__global__ void __launch_bounds__(kFinishThreads)
l2norm_finish_kernel(const long long* chunk_start, const float* partial, int n,
                     float* per_tensor, float* total) {
  __shared__ float warps[kFinishThreads / 32];
  float acc = 0.f;
  for (int t = threadIdx.x; t < n; t += kFinishThreads) {
    float sum = 0.f;
    for (long long c = chunk_start[t]; c < chunk_start[t + 1]; ++c) sum = __fadd_rn(sum, partial[c]);
    if (per_tensor != nullptr) per_tensor[t] = __fsqrt_rn(sum);
    acc = __fadd_rn(acc, sum);
  }
  acc = mt::block_sum(acc, warps);
  if (threadIdx.x == 0 && total != nullptr) *total = __fsqrt_rn(acc);
}

struct Hyper {
  float lr;           // used when lr_ptr is null
  const float* lr_ptr;
  const float* scale;  // grad_scale: grads are multiplied by 1 / *scale
  const unsigned char* found_inf;
  float wd;
};

__device__ __forceinline__ float lr_of(const Hyper& h) {
  return h.lr_ptr != nullptr ? *h.lr_ptr : h.lr;
}

__device__ __forceinline__ float inv_of(const Hyper& h) {
  return h.scale != nullptr ? __fdiv_rn(1.0f, *h.scale) : 1.0f;
}

// 1 - beta ** t in fp32, t = the tensor's step + 1 (torch's pow of an fp32
// base and exponent), or 1 without bias correction.
__device__ __forceinline__ float bias_correction(int on, float beta, float t) {
  return on ? __fsub_rn(1.0f, powf(beta, t)) : 1.0f;
}

struct AdamArgs {
  float b1, b2, omb1, omb2, eps;  // omb = (float)(1.0 - beta), formed in double
  int adam_w, bias_correction;
};

// Lists: g 0, p 1, exp_avg 2, exp_avg_sq 3, master `master_list` (or -1).
__global__ void __launch_bounds__(mt::kThreads)
adam_kernel(Record r, int master_list, Hyper h, AdamArgs a) {
  if (mt::skipped(h.found_inf)) return;
  const Span s = mt::block_span(r);
  const int j = s.j;
  const void* g = r.addr(0, j);
  const int gc = r.code(0, j);
  void* p = r.addr(1, j);
  const int pc = r.code(1, j);
  float* m = static_cast<float*>(r.addr(2, j));
  float* v = static_cast<float*>(r.addr(3, j));
  float* master = master_list < 0 ? nullptr : static_cast<float*>(r.addr(master_list, j));
  const float lr = lr_of(h);
  const float inv = inv_of(h);
  const float t = static_cast<float>(*r.step(j) + 1);
  const float bc1 = bias_correction(a.bias_correction, a.b1, t);
  const float bc2 = bias_correction(a.bias_correction, a.b2, t);
  for (long long i = s.lo + threadIdx.x; i < s.hi; i += mt::kThreads) {
    float gv = mt::load(g, gc, i);
    if (h.scale != nullptr) gv = __fmul_rn(gv, inv);
    const float pv = master != nullptr ? master[i] : mt::load(p, pc, i);
    if (!a.adam_w && h.wd != 0.f) gv = __fadd_rn(gv, __fmul_rn(h.wd, pv));
    const float mv = __fadd_rn(__fmul_rn(a.b1, m[i]), __fmul_rn(a.omb1, gv));
    const float vv = __fadd_rn(__fmul_rn(a.b2, v[i]), __fmul_rn(__fmul_rn(a.omb2, gv), gv));
    float u = __fdiv_rn(__fdiv_rn(mv, bc1),
                        __fadd_rn(__fsqrt_rn(__fdiv_rn(vv, bc2)), a.eps));
    if (a.adam_w && h.wd != 0.f) u = __fadd_rn(u, __fmul_rn(h.wd, pv));
    const float np = __fsub_rn(pv, __fmul_rn(lr, u));
    m[i] = mv;
    v[i] = vv;
    if (master != nullptr) master[i] = np;
    mt::store(p, pc, i, np);
  }
}

struct LambArgs {
  float b1, b2, beta3, omb2, eps;  // beta3 = (float)(1.0 - b1) or 1
  int adam_w, bias_correction;
  const float* gnorm;  // the global grad norm, or null: no clip
  float max_norm, inv_max_norm;
};

// Stage 1, lists: g 0, p 1, exp_avg 2, exp_avg_sq 3, update 4, master
// `master_list` (or -1). The moments and the fp32 update of the clipped
// gradient (g / clip, divided as the plain version divides).
__global__ void __launch_bounds__(mt::kThreads)
lamb_stage1_kernel(Record r, int master_list, Hyper h, LambArgs a) {
  if (mt::skipped(h.found_inf)) return;
  const Span s = mt::block_span(r);
  const int j = s.j;
  const void* g = r.addr(0, j);
  const int gc = r.code(0, j);
  const void* p = r.addr(1, j);
  const int pc = r.code(1, j);
  float* m = static_cast<float*>(r.addr(2, j));
  float* v = static_cast<float*>(r.addr(3, j));
  float* upd = static_cast<float*>(r.addr(4, j));
  const float* master =
      master_list < 0 ? nullptr : static_cast<const float*>(r.addr(master_list, j));
  const float inv = inv_of(h);
  float clip = 1.0f;
  if (a.gnorm != nullptr) {
    const float gn = *a.gnorm;
    clip = gn > a.max_norm ? __fmul_rn(gn, a.inv_max_norm) : 1.0f;
  }
  const float t = static_cast<float>(*r.step(j) + 1);
  const float bc1 = bias_correction(a.bias_correction, a.b1, t);
  const float bc2 = bias_correction(a.bias_correction, a.b2, t);
  for (long long i = s.lo + threadIdx.x; i < s.hi; i += mt::kThreads) {
    float gv = mt::load(g, gc, i);
    if (h.scale != nullptr) gv = __fmul_rn(gv, inv);
    gv = __fdiv_rn(gv, clip);
    const float pv = master != nullptr ? master[i] : mt::load(p, pc, i);
    if (!a.adam_w && h.wd != 0.f) gv = __fadd_rn(gv, __fmul_rn(h.wd, pv));
    const float mv = __fadd_rn(__fmul_rn(a.b1, m[i]), __fmul_rn(a.beta3, gv));
    const float vv = __fadd_rn(__fmul_rn(a.b2, v[i]), __fmul_rn(__fmul_rn(a.omb2, gv), gv));
    float u = __fdiv_rn(__fdiv_rn(mv, bc1),
                        __fadd_rn(__fsqrt_rn(__fdiv_rn(vv, bc2)), a.eps));
    if (a.adam_w && h.wd != 0.f) u = __fadd_rn(u, __fmul_rn(h.wd, pv));
    m[i] = mv;
    v[i] = vv;
    upd[i] = u;
  }
}

// Stage 2, lists: p 1, update 4, master `master_list` (or -1). The trust
// ratio ||p|| / ||update|| of the tensor (norms by global tensor index),
// where `adapt` (wd != 0 or always_adapt); 1 where either norm is 0;
// capped at 1 with trust_clip.
__global__ void __launch_bounds__(mt::kThreads)
lamb_stage2_kernel(Record r, int master_list, Hyper h, const float* w_norm,
                   const float* u_norm, int adapt, int trust_clip) {
  if (mt::skipped(h.found_inf)) return;
  const Span s = mt::block_span(r);
  const int j = s.j;
  void* p = r.addr(1, j);
  const int pc = r.code(1, j);
  const float* upd = static_cast<const float*>(r.addr(4, j));
  float* master = master_list < 0 ? nullptr : static_cast<float*>(r.addr(master_list, j));
  float ratio = 1.0f;
  if (adapt) {
    const long long t = r.first_tensor() + j;
    const float wn = w_norm[t];
    const float un = u_norm[t];
    ratio = (wn > 0.f && un > 0.f) ? __fdiv_rn(wn, un) : 1.0f;
    if (trust_clip) ratio = fminf(ratio, 1.0f);
  }
  const float step = __fmul_rn(lr_of(h), ratio);
  for (long long i = s.lo + threadIdx.x; i < s.hi; i += mt::kThreads) {
    const float pv = master != nullptr ? master[i] : mt::load(p, pc, i);
    const float np = __fsub_rn(pv, __fmul_rn(step, upd[i]));
    if (master != nullptr) master[i] = np;
    mt::store(p, pc, i, np);
  }
}

struct SgdArgs {
  float momentum, omd;  // omd = (float)(1.0 - dampening)
  int nesterov, wd_after;
};

// Lists: g 0, p 1, momentum buffer `buf_list` (or -1: no momentum), master
// `master_list` (or -1). The buffer is set to the direction at the first
// step (the tensor's own step + 1 == 1).
__global__ void __launch_bounds__(mt::kThreads)
sgd_kernel(Record r, int buf_list, int master_list, Hyper h, SgdArgs a) {
  if (mt::skipped(h.found_inf)) return;
  const Span s = mt::block_span(r);
  const int j = s.j;
  const void* g = r.addr(0, j);
  const int gc = r.code(0, j);
  void* p = r.addr(1, j);
  const int pc = r.code(1, j);
  float* buf = buf_list < 0 ? nullptr : static_cast<float*>(r.addr(buf_list, j));
  float* master = master_list < 0 ? nullptr : static_cast<float*>(r.addr(master_list, j));
  const float lr = lr_of(h);
  const float inv = inv_of(h);
  const bool first = *r.step(j) + 1 == 1;
  for (long long i = s.lo + threadIdx.x; i < s.hi; i += mt::kThreads) {
    float gv = mt::load(g, gc, i);
    if (h.scale != nullptr) gv = __fmul_rn(gv, inv);
    const float pv = master != nullptr ? master[i] : mt::load(p, pc, i);
    float d = gv;
    if (h.wd != 0.f && !a.wd_after) d = __fadd_rn(d, __fmul_rn(h.wd, pv));
    if (buf != nullptr) {
      const float b =
          first ? d : __fadd_rn(__fmul_rn(a.momentum, buf[i]), __fmul_rn(a.omd, d));
      buf[i] = b;
      d = a.nesterov ? __fadd_rn(d, __fmul_rn(a.momentum, b)) : b;
    }
    if (h.wd != 0.f && a.wd_after) d = __fadd_rn(d, __fmul_rn(h.wd, pv));
    const float np = __fsub_rn(pv, __fmul_rn(lr, d));
    if (master != nullptr) master[i] = np;
    mt::store(p, pc, i, np);
  }
}

// Every tensor's step counter + 1, unless found_inf (`steps`: n addresses).
__global__ void bump_kernel(const long long* steps, int n, const unsigned char* found_inf) {
  if (mt::skipped(found_inf)) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) *reinterpret_cast<int*>(steps[t]) += 1;
}

}  // namespace

// Every entry: `records` is the table's device array of records, `chunks`
// a host array of their chunk counts; the kernels run on `stream`.

extern "C" int apex_mt_scale(const long long* records, const int* chunks, int n_records,
                             void* stream, const float* scale, unsigned char* found_inf) {
  return static_cast<int>(mt::launch_records(scale_kernel, records, chunks, n_records,
                                             static_cast<cudaStream_t>(stream), scale,
                                             found_inf));
}

// Pass 1: the sum of squares of list `list` (times 1 / *scale if scale is
// not null) of each chunk into partial[global chunk].
extern "C" int apex_mt_l2norm(const long long* records, const int* chunks, int n_records,
                              void* stream, int list, const float* scale, float* partial) {
  return static_cast<int>(mt::launch_records(l2norm_kernel, records, chunks, n_records,
                                             static_cast<cudaStream_t>(stream), list, scale,
                                             partial));
}

// Pass 2: per-tensor norms (per_tensor[n], or null) and the total norm
// (total, or null); chunk_start[n + 1] are the tensors' first global chunks.
extern "C" int apex_mt_l2norm_finish(const long long* chunk_start, const float* partial, int n,
                                     float* per_tensor, float* total, void* stream) {
  l2norm_finish_kernel<<<1, kFinishThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      chunk_start, partial, n, per_tensor, total);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int apex_mt_adam(const long long* records, const int* chunks, int n_records,
                            void* stream, int master_list, float lr, const float* lr_ptr,
                            const float* scale, const unsigned char* found_inf, float wd,
                            float b1, float b2, float omb1, float omb2, float eps, int adam_w,
                            int bias_correction) {
  const Hyper h{lr, lr_ptr, scale, found_inf, wd};
  const AdamArgs a{b1, b2, omb1, omb2, eps, adam_w, bias_correction};
  return static_cast<int>(mt::launch_records(adam_kernel, records, chunks, n_records,
                                             static_cast<cudaStream_t>(stream), master_list, h,
                                             a));
}

extern "C" int apex_mt_lamb_stage1(const long long* records, const int* chunks, int n_records,
                                   void* stream, int master_list, const float* scale,
                                   const unsigned char* found_inf, float wd, float b1, float b2,
                                   float beta3, float omb2, float eps, int adam_w,
                                   int bias_correction, const float* gnorm, float max_norm,
                                   float inv_max_norm) {
  const Hyper h{0.f, nullptr, scale, found_inf, wd};
  const LambArgs a{b1, b2, beta3, omb2, eps, adam_w, bias_correction, gnorm, max_norm,
                   inv_max_norm};
  return static_cast<int>(mt::launch_records(lamb_stage1_kernel, records, chunks, n_records,
                                             static_cast<cudaStream_t>(stream), master_list, h,
                                             a));
}

extern "C" int apex_mt_lamb_stage2(const long long* records, const int* chunks, int n_records,
                                   void* stream, int master_list, float lr, const float* lr_ptr,
                                   const unsigned char* found_inf, const float* w_norm,
                                   const float* u_norm, int adapt, int trust_clip) {
  const Hyper h{lr, lr_ptr, nullptr, found_inf, 0.f};
  return static_cast<int>(mt::launch_records(lamb_stage2_kernel, records, chunks, n_records,
                                             static_cast<cudaStream_t>(stream), master_list, h,
                                             w_norm, u_norm, adapt, trust_clip));
}

extern "C" int apex_mt_sgd(const long long* records, const int* chunks, int n_records,
                           void* stream, int buf_list, int master_list, float lr,
                           const float* lr_ptr, const float* scale,
                           const unsigned char* found_inf, float wd, float momentum, float omd,
                           int nesterov, int wd_after) {
  const Hyper h{lr, lr_ptr, scale, found_inf, wd};
  const SgdArgs a{momentum, omd, nesterov, wd_after};
  return static_cast<int>(mt::launch_records(sgd_kernel, records, chunks, n_records,
                                             static_cast<cudaStream_t>(stream), buf_list,
                                             master_list, h, a));
}

extern "C" int apex_mt_bump(const long long* steps, int n, void* stream,
                            const unsigned char* found_inf) {
  if (n == 0) return 0;
  bump_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(steps, n,
                                                                            found_inf);
  return static_cast<int>(cudaGetLastError());
}

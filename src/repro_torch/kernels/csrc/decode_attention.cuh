// The decode kernels' shared pieces (decode_attention.cu): launch
// arguments, the FP32-pipe split kernel and its combine, the Hopper body's
// launch, and `run_contig`, the contiguous entry point's launch for a cache
// of element type KV. Two translation units instantiate them, so nvcc
// builds them in parallel: decode_attention.cu (the paged kernel and
// caches in q's dtype) and decode_attention_fp8.cu (fp8 caches).
#pragma once

#include <algorithm>
#include <type_traits>

#include "attn_common.cuh"
#include "decode_sm90.cuh"

namespace rt_decode {

constexpr int kSplit = 256;        // keys per split, FP32-pipe body
constexpr int kCtasPerSm = 4;      // Hopper body: split CTAs per SM, at most
// the contiguous cache's element type (rt_decode_attention's `kv_fmt`)
constexpr int kKvLikeQ = 0, kKvE4M3 = 1, kKvE5M2 = 2;

inline bool sm90_body(int is_bf16, int nh, int nkv) {
  return is_bf16 && nh / nkv <= rt::dec::kMaxG;
}

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* tbl;      // paged: (B, mb) block table; contiguous: unused
  const int* pos;
  void* out;
  float* part_acc;     // (B, nh, nsplit, d) unnormalised partial outputs
  float* part_ml;      // (B, nh, nsplit, 2) partial (max, denominator)
  int B, nh, nkv, bs, mb, window, split, nsplit;
  int S;               // keys a row can hold: mb * bs paged, S contiguous
  float scale;
  // contiguous only: (B, nh) fp32 log-sum-exp of each row's visible scores
  // (natural log; -inf where the row sees no key); when set, `out` is fp32
  float* lse;
};

template <typename T, int D, bool kPaged>
struct DecodeP {
  const T* q;
  const int* tbl_row;
  float* acc_base;
  float* ml_base;
  int b, nh, g, bs, S, split_idx, nsplit;
  int rows, nkv, kvh, kv_lo, kv_hi, causal, window, pos;
  float scale;
  __device__ long long row(int r) const {
    return ((long long)b * nh + kvh * g + r) * nsplit + split_idx;
  }
  __device__ const T* q_row(int r) const {
    return q + ((long long)b * nh + kvh * g + r) * D;
  }
  __device__ float* part_acc(int r) const { return acc_base + row(r) * D; }
  __device__ float* part_ml(int r) const { return ml_base + row(r) * 2; }
  __device__ int q_pos(int) const { return pos; }
  __device__ int kv_row(int t) const {
    if constexpr (kPaged) return tbl_row[t / bs] * bs + t % bs;
    else return b * S + t;
  }
};

// Pass 1: CTA (split, KV head, row) attends keys
// [lo + split * a.split, lo + (split + 1) * a.split) of the row's visible
// range [lo, hi) and writes its partial (acc, m, l) for the g query heads.
// T: q's and the output's type; KV: the cache's.
template <typename T, typename KV, int D, bool kPaged>
__global__ void __launch_bounds__(rt::kThreads)
decode_split_kernel(DecodeArgs a) {
  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int g = a.nh / a.nkv;
  const int pos = a.pos[b];
  DecodeP<T, D, kPaged> p;
  p.q = static_cast<const T*>(a.q);
  p.tbl_row = kPaged ? a.tbl + (long long)b * a.mb : nullptr;
  p.acc_base = a.part_acc;
  p.ml_base = a.part_ml;
  p.b = b; p.nh = a.nh; p.g = g; p.bs = a.bs; p.S = a.S;
  p.split_idx = sp; p.nsplit = a.nsplit;
  p.rows = g; p.nkv = a.nkv; p.kvh = kvh;
  p.causal = 1; p.window = a.window; p.pos = pos; p.scale = a.scale;
  // visible keys [lo, hi): the window's first position through pos,
  // clamped to the row's capacity (a frozen dead row may sit one past its
  // last block, or at the end of its contiguous row); this CTA takes its
  // split of them (possibly none)
  const int lo = a.window > 0 ? max(0, pos - a.window + 1) : 0;
  const int hi = min(pos + 1, a.S);
  p.kv_lo = lo + sp * a.split;
  p.kv_hi = min(hi, lo + (sp + 1) * a.split);
  rt::attend<T, D, true>(p, static_cast<const KV*>(a.k),
                         static_cast<const KV*>(a.v));
}

// Pass 2: one CTA per (query head, row), one thread per dim, merges the
// splits' partials: out = sum_s e^{m_s - M} acc_s / sum_s e^{m_s - M} l_s.
// With `lse` it writes `out` in fp32 and lse = M + log L (-inf at L = 0),
// so partials over a cache cut by sequence merge unrounded.
template <typename T, int D>
__global__ void decode_combine_kernel(DecodeArgs a) {
  const int h = blockIdx.x, b = blockIdx.y, c = threadIdx.x;
  const long long row = (long long)b * a.nh + h;
  const float* ml = a.part_ml + row * a.nsplit * 2;
  const float* acc = a.part_acc + row * a.nsplit * D;
  float M = rt::kNegInf;
  for (int s = 0; s < a.nsplit; ++s) M = fmaxf(M, ml[2 * s]);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < a.nsplit; ++s) {
    const float w = expf(ml[2 * s] - M);
    L += w * ml[2 * s + 1];
    A += w * acc[s * D + c];
  }
  if (a.lse == nullptr) {
    static_cast<T*>(a.out)[row * D + c] = rt::from_f<T>(A / fmaxf(L, 1e-30f));
    return;
  }
  static_cast<float*>(a.out)[row * D + c] = A / fmaxf(L, 1e-30f);
  if (c == 0)   // -inf (0xff800000) where the row saw no key
    a.lse[row] = L > 0.f ? M + logf(L) : __int_as_float(0xff800000);
}

template <typename T, typename KV, int D, bool kPaged>
cudaError_t run(const DecodeArgs& a, cudaStream_t s) {
  const int g = a.nh / a.nkv;
  cudaError_t e = rt::launch<decode_split_kernel<T, KV, D, kPaged>>(
      dim3(a.nsplit, a.nkv, a.B), rt::kThreads, rt::smem_bytes(g, D), a, s);
  if (e != cudaSuccess) return e;
  return rt::launch<decode_combine_kernel<T, D>>(dim3(a.nh, a.B), D, 0, a,
                                                 s);
}

template <typename T, int D>
cudaError_t run_paged(const DecodeArgs& a, cudaStream_t s) {
  return run<T, T, D, true>(a, s);
}

template <int D, class Keys, class KV>
__global__ void __launch_bounds__(rt::dec::kThreads)
decode_sm90_kernel(rt::dec::Args a) {
  rt::dec::split_body<D, Keys, KV>(a);
}

template <int D, class Keys, class KV = __nv_bfloat16>
cudaError_t run_sm90(const DecodeArgs& d, cudaStream_t s) {
  const rt::dec::Args a{
      static_cast<const __nv_bfloat16*>(d.q), d.k, d.v, d.pos,
      static_cast<__nv_bfloat16*>(d.out), d.part_acc, d.part_ml, d.B, d.nh,
      d.nkv, d.nh / d.nkv, d.S, d.window, d.split, d.nsplit,
      d.scale * rt::dec::kLog2e, d.tbl, d.mb, d.bs, d.lse};
  cudaError_t e = rt::launch<decode_sm90_kernel<D, Keys, KV>>(
      dim3(d.nsplit, d.nkv, d.B), rt::dec::kThreads,
      rt::dec::smem_bytes<D, KV>(), a, s);
  if (e != cudaSuccess) return e;
  return rt::launch<rt::dec::combine_kernel<D>>(dim3(d.nh, d.B), D, 0, a, s);
}

template <typename T, int D>
cudaError_t run_paged_sm90(const DecodeArgs& a, cudaStream_t s) {
  return run_sm90<D, rt::dec::PagedKeys<D>>(a, s);
}

// The contiguous entry point's two bodies for a cache of element type KV
// (void: q's own type)
template <typename KV>
struct Contig {
  template <typename T>
  using Elem = std::conditional_t<std::is_void_v<KV>, T, KV>;
  template <typename T, int D>
  static cudaError_t fp32_pipe(const DecodeArgs& a, cudaStream_t s) {
    return run<T, Elem<T>, D, false>(a, s);
  }
  template <typename T, int D>
  static cudaError_t sm90(const DecodeArgs& a, cudaStream_t s) {
    return run_sm90<D, rt::dec::ContigKeys<D>, Elem<T>>(a, s);
  }
};

template <typename KV>
cudaError_t run_contig(const DecodeArgs& a, int d, int is_bf16,
                       cudaStream_t s) {
  using C = Contig<KV>;
  return !is_bf16 ? RT_DISPATCH_D(d, float, C::template fp32_pipe, a, s)
         : sm90_body(is_bf16, a.nh, a.nkv)
             ? RT_DISPATCH_D(d, __nv_bfloat16, C::template sm90, a, s)
             : RT_DISPATCH_D(d, __nv_bfloat16, C::template fp32_pipe, a, s);
}

// fp8 caches, defined in decode_attention_fp8.cu
cudaError_t run_contig_fp8(const DecodeArgs& a, int d, int is_bf16,
                           int kv_fmt, cudaStream_t s);

}  // namespace rt_decode

// GQA decode attention for Hopper (sm_90a), paged and contiguous.
//
// Replaces two Pallas TPU kernels of repro/kernels/decode_attention.py:
//  * `decode_attention_paged` (`_dec_paged_kernel`): one query token per
//    row against the block pool (n_blocks, block, nkv, d) read through the
//    row's block table (entry point rt_decode_attention_paged);
//  * `decode_attention` (`_dec_kernel`): one query token per row against a
//    contiguous cache (B, S, nkv, d), key t of row b at row b * S + t
//    (entry point rt_decode_attention).
// Both: causal by `pos`, optional sliding window, GQA, online softmax in
// fp32. The two share one body; the layout is a template flag, so each
// entry point has its own __global__ instantiation and the contiguous one
// reads no table.
//
// Bound on the card: BYTES. Each row streams its whole K/V history once
// per step and does 4*g*d flops per key (g = query heads per KV head), far
// below the ~295 flops/byte where H100 bf16 turns compute-bound.
//
// What the design does about it:
//  * one CTA per (row, KV head) owns all g query heads of that KV head, so
//    each K/V block is read once for the group (the Pallas grids (b, nh, .)
//    read it once per query head: 8x the bytes at Qwen3-32B's 64/8 heads,
//    4x at Phi-3.5-MoE's 32/8);
//  * the CTA walks only the keys the row can see: from the window's first
//    position (SWA) to `pos`, not all `mb` virtual blocks (paged: the trash
//    tail of the table is never read) nor all `S` rows (contiguous: the
//    engine's rows are max_len long, and the Pallas kernel streamed every
//    block of them, masked);
//  * paged: the CTA loads its own block-table entries (no scalar prefetch);
//  * split-KV (flash-decoding): each row's visible keys are cut into
//    splits of `split` keys, one CTA each, so a batch of 8 rows puts
//    hundreds of CTAs in flight instead of B x nkv = 64 (the card has 132
//    SMs and a decode CTA is latency-bound on its K/V loads); a second
//    kernel merges the splits' (acc, max, sum) partials.
//
// Two bodies. bf16 decode with at most 16 query heads per KV head, paged
// or contiguous, runs the Hopper body of decode_sm90.cuh (tensor cores, a
// cp.async K/V ring, splits sized from the positions; the layout is its
// key policy, PagedKeys or ContigKeys); there `split` is the least number
// of keys a split takes and `nsplit` the most splits a row is cut into.
// Every other launch (fp32, groups of more than 16) runs the FP32-pipe
// body rt::attend of attn_common.cuh in splits of `split` keys, `nsplit` of
// them covering the row's capacity. `sm90_body` alone picks the body, and
// rt_decode_plan, which the wrappers call for `split` and `nsplit`, sizes
// the splits for the body it picks.
#include <algorithm>

#include "attn_common.cuh"
#include "decode_sm90.cuh"

namespace {

constexpr int kSplit = 256;        // keys per split, FP32-pipe body
constexpr int kCtasPerSm = 4;      // Hopper body: split CTAs per SM, at most

bool sm90_body(int is_bf16, int nh, int nkv) {
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
template <typename T, int D, bool kPaged>
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
  rt::attend<T, D, true>(p, static_cast<const T*>(a.k),
                         static_cast<const T*>(a.v));
}

// Pass 2: one CTA per (query head, row), one thread per dim, merges the
// splits' partials: out = sum_s e^{m_s - M} acc_s / sum_s e^{m_s - M} l_s.
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
  static_cast<T*>(a.out)[row * D + c] = rt::from_f<T>(A / fmaxf(L, 1e-30f));
}

template <typename T, int D, bool kPaged>
cudaError_t run(const DecodeArgs& a, cudaStream_t s) {
  const int g = a.nh / a.nkv;
  cudaError_t e = rt::launch<decode_split_kernel<T, D, kPaged>>(
      dim3(a.nsplit, a.nkv, a.B), rt::kThreads, rt::smem_bytes(g, D), a, s);
  if (e != cudaSuccess) return e;
  return rt::launch<decode_combine_kernel<T, D>>(dim3(a.nh, a.B), D, 0, a,
                                                 s);
}

template <typename T, int D>
cudaError_t run_paged(const DecodeArgs& a, cudaStream_t s) {
  return run<T, D, true>(a, s);
}

template <typename T, int D>
cudaError_t run_contig(const DecodeArgs& a, cudaStream_t s) {
  return run<T, D, false>(a, s);
}

template <int D, class Keys>
__global__ void __launch_bounds__(rt::dec::kThreads)
decode_sm90_kernel(rt::dec::Args a) {
  rt::dec::split_body<D, Keys>(a);
}

template <int D, class Keys>
cudaError_t run_sm90(const DecodeArgs& d, cudaStream_t s) {
  const rt::dec::Args a{
      static_cast<const __nv_bfloat16*>(d.q),
      static_cast<const __nv_bfloat16*>(d.k),
      static_cast<const __nv_bfloat16*>(d.v), d.pos,
      static_cast<__nv_bfloat16*>(d.out), d.part_acc, d.part_ml, d.B, d.nh,
      d.nkv, d.nh / d.nkv, d.S, d.window, d.split, d.nsplit,
      d.scale * rt::dec::kLog2e, d.tbl, d.mb, d.bs};
  cudaError_t e = rt::launch<decode_sm90_kernel<D, Keys>>(
      dim3(d.nsplit, d.nkv, d.B), rt::dec::kThreads,
      rt::dec::smem_bytes<D>(), a, s);
  if (e != cudaSuccess) return e;
  return rt::launch<rt::dec::combine_kernel<D>>(dim3(d.nh, d.B), D, 0, a, s);
}

template <typename T, int D>
cudaError_t run_paged_sm90(const DecodeArgs& a, cudaStream_t s) {
  return run_sm90<D, rt::dec::PagedKeys<D>>(a, s);
}

template <typename T, int D>
cudaError_t run_contig_sm90(const DecodeArgs& a, cudaStream_t s) {
  return run_sm90<D, rt::dec::ContigKeys<D>>(a, s);
}

}  // namespace

// Split sizing for a launch of either entry point over rows of `keys`
// keys: out[0] = split, out[1] = nsplit (the partials' depth). The Hopper
// body cuts a row's visible keys into whole tiles, at most as many splits
// per (row, KV head) as put kCtasPerSm CTAs on each of `sm_count` SMs; the
// FP32-pipe body covers min(keys, window) in splits of kSplit.
extern "C" int rt_decode_plan(int B, int nh, int nkv, int keys, int window,
                              int is_bf16, int sm_count, int* out) {
  if (B <= 0 || nkv <= 0 || nh % nkv != 0 || keys <= 0 || sm_count <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int seen = window > 0 ? std::min(keys, window) : keys;
  if (sm90_body(is_bf16, nh, nkv)) {
    const int kt = rt::dec::kKT;
    const int ctas = (kCtasPerSm * sm_count + B * nkv - 1) / (B * nkv);
    out[0] = kt;
    out[1] = std::max(1, std::min(ctas, (seen + kt - 1) / kt));
  } else {
    out[0] = kSplit;
    out[1] = std::max(1, (seen + kSplit - 1) / kSplit);
  }
  return 0;
}

extern "C" int rt_decode_attention_paged(
    const void* q, const void* k, const void* v, const void* tbl,
    const void* pos, void* out, void* part_acc, void* part_ml, int B,
    int nh, int nkv, int d, int bs, int mb, int window, int split,
    int nsplit, float scale, int is_bf16, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  DecodeArgs a{q, k, v, static_cast<const int*>(tbl),
               static_cast<const int*>(pos), out,
               static_cast<float*>(part_acc), static_cast<float*>(part_ml),
               B, nh, nkv, bs, mb, window, split, nsplit, mb * bs, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      !is_bf16 ? RT_DISPATCH_D(d, float, run_paged, a, s)
      : sm90_body(is_bf16, nh, nkv)
          ? RT_DISPATCH_D(d, __nv_bfloat16, run_paged_sm90, a, s)
          : RT_DISPATCH_D(d, __nv_bfloat16, run_paged, a, s);
  return static_cast<int>(e);
}

extern "C" int rt_decode_attention(
    const void* q, const void* k, const void* v, const void* pos, void* out,
    void* part_acc, void* part_ml, int B, int nh, int nkv, int d, int S,
    int window, int split, int nsplit, float scale, int is_bf16,
    void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  DecodeArgs a{q, k, v, nullptr, static_cast<const int*>(pos), out,
               static_cast<float*>(part_acc), static_cast<float*>(part_ml),
               B, nh, nkv, 0, 0, window, split, nsplit, S, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      !is_bf16 ? RT_DISPATCH_D(d, float, run_contig, a, s)
      : sm90_body(is_bf16, nh, nkv)
          ? RT_DISPATCH_D(d, __nv_bfloat16, run_contig_sm90, a, s)
          : RT_DISPATCH_D(d, __nv_bfloat16, run_contig, a, s);
  return static_cast<int>(e);
}

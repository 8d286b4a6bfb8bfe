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
//
// fp8 caches (the reference's `kv_cache_dtype`, contiguous entry point
// only): `kv_fmt` names the cache's element type, float8_e4m3fn or
// float8_e5m2, read as it is stored (half the bytes of bf16, which bound
// decode) and upcast exactly on load, as the Pallas bodies cast their K/V
// loads to fp32 (`_dec_kernel`, decode_attention.py:43-45). The body and
// the splits are those of the same launch on the cache upcast to q's
// dtype, so the two agree bit for bit: the Hopper body converts each
// landed fp8 tile to bf16 in shared memory (decode_sm90.cuh), the
// FP32-pipe body converts each element to fp32 as it stages the tile. The
// launches' shared pieces are in decode_attention.cuh; the fp8
// instantiations build beside this file in decode_attention_fp8.cu.
#include "decode_attention.cuh"

using namespace rt_decode;

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
               B, nh, nkv, bs, mb, window, split, nsplit, mb * bs, scale,
               nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      !is_bf16 ? RT_DISPATCH_D(d, float, run_paged, a, s)
      : sm90_body(is_bf16, nh, nkv)
          ? RT_DISPATCH_D(d, __nv_bfloat16, run_paged_sm90, a, s)
          : RT_DISPATCH_D(d, __nv_bfloat16, run_paged, a, s);
  return static_cast<int>(e);
}

// kv_fmt: the cache's element type, kKvLikeQ (q's: fp32 or bf16), kKvE4M3
// (float8_e4m3fn) or kKvE5M2 (float8_e5m2). lse: null, or a (B, nh) fp32
// buffer for each row's log-sum-exp, and then `out` is an fp32 buffer
extern "C" int rt_decode_attention(
    const void* q, const void* k, const void* v, const void* pos, void* out,
    void* part_acc, void* part_ml, void* lse, int B, int nh, int nkv, int d,
    int S,
    int window, int split, int nsplit, float scale, int is_bf16, int kv_fmt,
    void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  DecodeArgs a{q, k, v, nullptr, static_cast<const int*>(pos), out,
               static_cast<float*>(part_acc), static_cast<float*>(part_ml),
               B, nh, nkv, 0, 0, window, split, nsplit, S, scale,
               static_cast<float*>(lse)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = kv_fmt == kKvLikeQ
                      ? run_contig<void>(a, d, is_bf16, s)
                      : run_contig_fp8(a, d, is_bf16, kv_fmt, s);
  return static_cast<int>(e);
}

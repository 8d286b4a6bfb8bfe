// Full-sequence (prefill) flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// `flash_attention` (`_fa_kernel`): q (B, Sq, nh, d) against k/v
// (B, Sk, nkv, d), causal and/or sliding window, GQA, online softmax in
// fp32.
//
// Bound on the card: BYTES up to ~660-token buckets at Qwen3-32B's
// geometry (q, k, v and out move S * 144 KB per row while causal work grows
// as S^2 / 2), OPERATIONS beyond; the engine's flash buckets stop at
// prefill_chunk (512 in chip_smoke.py), longer prompts go to the chunk
// kernel, except on the exact-length MoE and hybrid paths (up to 2048).
//
// What the design does about it:
//  * bf16 runs the Hopper prefill body (prefill_sm90.cuh): one CTA per
//    (row, KV head, tile of 128 / g query positions) holds the g query
//    heads of the KV head as 128 packed rows, so each K/V tile leaves L2
//    once per row tile instead of once per query head; TMA fills a ring of
//    K/V tiles while two warpgroups run wgmma on the last one; causal CTAs
//    are issued longest first;
//  * tiles wholly above the causal diagonal or below the window are never
//    visited: each CTA walks keys [first - window + 1, last + 1) only;
//  * ragged Sq / Sk are masked in the kernel (no power-of-two or
//    block-multiple requirement, unlike the Pallas wrapper's assert);
//  * fp32, and bf16 groups of more than 128 query heads per KV head, keep
//    the FP32-pipe body (attn_common.cuh) with one CTA per query head.
#include <type_traits>

#include "attn_common.cuh"
#include "prefill_sm90.cuh"

namespace {

constexpr int kTQ = 64;             // fp32 body: queries per CTA

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int B, Sq, Sk, nh, nkv, causal, window;
  float scale;
};

template <typename T, int D>
struct FlashP {
  const T* q;
  T* o;
  int b, Sq, Sk, nh, h, i0;
  int rows, nkv, kvh, kv_lo, kv_hi, causal, window;
  float scale;
  __device__ long long idx(int r) const {
    return (((long long)b * Sq + i0 + r) * nh + h) * D;
  }
  __device__ const T* q_row(int r) const { return q + idx(r); }
  __device__ T* o_row(int r) const { return o + idx(r); }
  __device__ int q_pos(int r) const { return i0 + r; }
  __device__ int kv_row(int t) const { return b * Sk + t; }
};

template <typename T, int D>
__global__ void __launch_bounds__(rt::kThreads)
flash_kernel(FlashArgs a) {
  const int it = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int i0 = it * kTQ;
  FlashP<T, D> p;
  p.q = static_cast<const T*>(a.q);
  p.o = static_cast<T*>(a.out);
  p.b = b; p.Sq = a.Sq; p.Sk = a.Sk; p.nh = a.nh; p.h = h; p.i0 = i0;
  p.rows = min(kTQ, a.Sq - i0);
  p.nkv = a.nkv; p.kvh = h / (a.nh / a.nkv);
  p.causal = a.causal; p.window = a.window; p.scale = a.scale;
  p.kv_lo = a.window > 0 ? max(0, i0 - a.window + 1) : 0;
  p.kv_hi = a.causal ? min(a.Sk, i0 + p.rows) : a.Sk;
  rt::attend<T, D>(p, static_cast<const T*>(a.k),
                   static_cast<const T*>(a.v));
}

template <int D>
__global__ void __launch_bounds__(rt::sm90::kThreads, 1)
flash_kernel_wgmma(const __grid_constant__ rt::sm90::PrefillArgs a) {
  rt::sm90::prefill<D, false>(a);
}

template <typename T, int D>
cudaError_t run(const FlashArgs& a, cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (a.nh / a.nkv <= rt::sm90::kRows) {
      rt::sm90::PrefillArgs p{};
      cudaError_t e = rt::sm90::kv_map(&p.tmK, a.k, a.B, a.Sk, a.nkv, D);
      if (e == cudaSuccess)
        e = rt::sm90::kv_map(&p.tmV, a.v, a.B, a.Sk, a.nkv, D);
      if (e != cudaSuccess) return e;
      p.q = static_cast<const T*>(a.q);
      p.out = static_cast<T*>(a.out);
      p.B = a.B; p.Sq = a.Sq; p.nh = a.nh; p.nkv = a.nkv; p.S = a.Sk;
      p.causal = a.causal; p.window = a.window;
      p.scale_log2 = a.scale * rt::sm90::kLog2e;
      return rt::sm90::launch_prefill<flash_kernel_wgmma<D>, D>(p, s);
    }
  }
  const dim3 grid((a.Sq + kTQ - 1) / kTQ, a.nh, a.B);
  return rt::launch<flash_kernel<T, D>>(grid, rt::kThreads,
                                        rt::smem_bytes(kTQ, D), a, s);
}

}  // namespace

extern "C" int rt_flash_attention(
    const void* q, const void* k, const void* v, void* out, int B, int Sq,
    int Sk, int nh, int nkv, int d, int causal, int window, float scale,
    int is_bf16, void* stream) {
  cudaGetLastError();
  FlashArgs a{q, k, v, out, B, Sq, Sk, nh, nkv, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = is_bf16 ? RT_DISPATCH_D(d, __nv_bfloat16, run, a, s)
                          : RT_DISPATCH_D(d, float, run, a, s);
  return static_cast<int>(e);
}

extern "C" const char* rt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

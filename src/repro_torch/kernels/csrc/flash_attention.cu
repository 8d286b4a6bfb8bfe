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
// kernel.
//
// What the design does about it (FA2 tiling, the simple version):
//  * one CTA per (row, query head, tile of 64 queries); K/V tiles of 32
//    keys are staged once in shared memory and reused by all 64 queries;
//  * tiles wholly above the causal diagonal or below the window are never
//    visited: each CTA walks keys [first - window + 1, last + 1) only;
//  * ragged Sq / Sk are masked in the kernel (no power-of-two or
//    block-multiple requirement, unlike the Pallas wrapper's assert).
//  * bf16 runs the products on the tensor cores (rt::attend_mma:
//    mma.sync m16n8k16 with fp32 accumulators, P kept in registers);
//    fp32 keeps the FP32-pipe body. wgmma / TMA pipelining is later work.
#include <type_traits>

#include "attn_common.cuh"

namespace {

constexpr int kTQ = 64;             // == rt::kMmaRows

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

template <typename T, int D, bool kMma>
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
  if constexpr (kMma)
    rt::attend_mma<D>(p, static_cast<const T*>(a.k),
                      static_cast<const T*>(a.v));
  else
    rt::attend<T, D>(p, static_cast<const T*>(a.k),
                     static_cast<const T*>(a.v));
}

template <typename T, int D>
cudaError_t run(const FlashArgs& a, cudaStream_t s) {
  const dim3 grid((a.Sq + kTQ - 1) / kTQ, a.nh, a.B);
  if constexpr (std::is_same<T, __nv_bfloat16>::value)   // tensor cores
    return rt::launch<flash_kernel<T, D, true>>(
        grid, 32 * rt::kMmaWarps, rt::mma_smem_bytes(D), a, s);
  return rt::launch<flash_kernel<T, D, false>>(
      grid, rt::kThreads, rt::smem_bytes(kTQ, D), a, s);
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

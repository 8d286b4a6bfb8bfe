// Flash-attention backward for Hopper (sm_90a): dq, dk and dv of the
// full-sequence attention the flash forward (flash_attention.cu) computes,
// q (B, Sq, nh, d) against k/v (B, Sk, nkv, d), causal and/or sliding
// window, GQA, ragged Sq / Sk and Sq != Sk.
//
// Replaces no Pallas kernel: the JAX package trains with use_pallas=False
// and lets XLA differentiate its jnp attention (repro/models/attention.py:61,
// prefill_attention, under jax.grad). This is the attention gradient of
// the port's training path (FlashAttentionFn in kernels/flash_attention.py).
//
// Math, in natural units with s = scale * q.k: P = softmax(s) under the
// forward's mask, D_i = sum_c dO_ic O_ic, dP = dO V^T, dS = P o (dP - D),
// dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K. P is recomputed from
// the forward's log-sum-exp, which both forward bodies store in base-2
// units: P_ij = exp2(q_i.k_j * scale * log2(e) - lse_i).
//
// Bound on the card: OPERATIONS at the training shapes (internlm2-1.8b's
// 2048-token causal rows, 16/8 heads of 128, need ~1700 FLOPs per byte
// they must move; the card's balance point is ~295). Five matmuls per
// (key, query) pair, 2.5x the forward's two.
//
// Bodies, chosen by dtype alone (every head dim and group takes its body):
//  * bf16: the Hopper body of flash_bwd_sm90.cuh, three launches.
//    (a) prep: D and the log-sum-exp into rows padded to 64-query tiles,
//        the fp32 dQ accumulator zeroed.
//    (b) main: one CTA per (128-key tile, KV head, split, batch row), 384
//        threads. A producer warpgroup loads K and V once by TMA and keeps
//        a ring of Q / dO tiles (64 queries, 3 stages at d 120 / 128, 4
//        below) with their lse / D rows in flight, each stage completing on
//        a "full" mbarrier and reused once both consumers arrive on its
//        "empty" one. Two consumer warpgroups own 64 keys each and walk
//        every query tile that can see them (tiles that the causal diagonal
//        or the window hide entirely are never loaded): S^T = K Q^T and
//        dP^T = V dO^T by wgmma from shared memory, P^T and dS^T in
//        registers, dV += P^T dO and dK += dS^T Q by wgmma with A from
//        registers (dO, Q read MN-major), then dQ = dS K from dS^T written
//        to shared memory, the two warpgroups splitting dQ's columns by
//        16-column slices (d 80: 48 + 32; d 16: warpgroup 0 alone). dQ
//        leaves by TMA reduce-add into the fp32 accumulator; dK and dV
//        stay in registers for the whole walk. One pass, five matmuls.
//    (c) post: dQ scaled to bf16, one CTA per 64-query tile.
//    Split: a key tile's steps (g query heads x its query tiles) can go to
//    `nsplit` CTAs, each a contiguous range of them, so that small grids
//    fill the card's SMs and causal grids do not wait on their longest
//    key tiles. rt::bwd::splits picks nsplit from the SM count read from
//    the device and the steps each key tile has. Each split writes fp32
//    dK / dV partials; the split that finishes last (an atomic count per
//    key tile) reads them back from L2 and sums them in split order
//    before the bf16 store. The plan entry point
//    rt_flash_attention_bwd_plan gives the wrapper the scratch size and
//    split for the same choice; the Python side holds no limits.
//    Registers (ptxas -v, sm_90a): 168 a thread at launch, `setmaxnreg`
//    moves the producer to 24 and the consumers to 240; no spill at d 16,
//    32, 64, 80, 120 or 128. Shared memory: 232,000 bytes at d 128 / 120
//    (K, V 64 KB; three Q / dO stages 96 KB; two dS buffers 32 KB; dQ
//    staging 32 KB), 179,280 at d 80, 150,608 at d 64, 64,592 at d 16.
//    Determinism: dK and dV are bitwise repeatable (registers, and split
//    partials summed in split order whichever split sums them). dQ is
//    not: the CTAs reduce-add their fp32 contributions in the order they
//    finish, so dQ can differ between calls in its last bf16 place. No
//    check depends on bitwise bf16 gradients; the fp32 body below is
//    deterministic.
//    d 120 runs as 128 in shared memory: TMA zero-fills the 8 tail columns
//    of K, V, Q and dO, so their products stay 0 and are never stored.
//  * fp32: FP32 FMA in shared memory (the card-vs-CPU training check and
//    the bit-exact resume run it): a preprocess of D, one dK / dV CTA per
//    (32-key tile, KV head, row) walking the g query heads, one dQ CTA per
//    (32-query tile, head, row); one (key, query) pair per thread
//    iteration for S and dP, accumulators in registers.
#include <stdint.h>

#include <type_traits>

#include "attn_common.cuh"
#include "flash_bwd_sm90.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;       // (B, nh, Sq), base 2
  float* dvec;            // scratch: fp32 D (B, nh, Sq); bf16 all of it
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Sk, nh, nkv, causal, window;
  int nsplit;             // bf16: CTAs per (key tile, KV head, row)
  float scale;            // softmax scale (natural units)
  float scale_log2;       // scale * log2(e)
};

__device__ __forceinline__ bool seen(int i, int j, const BwdArgs& a) {
  return i < a.Sq && j < a.Sk && (!a.causal || j <= i) &&
         (a.window <= 0 || j > i - a.window);
}

// the query rows [lo, hi) that can see some key of [k0, k0 + n)
__device__ __forceinline__ void query_range(const BwdArgs& a, int k0, int n,
                                            int* lo, int* hi) {
  *lo = a.causal ? k0 : 0;
  *hi = a.window > 0 ? min(a.Sq, k0 + n - 1 + a.window) : a.Sq;
}

// the key rows [lo, hi) that queries [i0, i0 + n) can see
__device__ __forceinline__ void key_range(const BwdArgs& a, int i0, int n,
                                          int* lo, int* hi) {
  *lo = a.window > 0 ? max(0, i0 - a.window + 1) : 0;
  *hi = a.causal ? min(a.Sk, i0 + n) : a.Sk;
}

// element offset of row t of head h in a contiguous (B, S, heads, D) tensor
template <int D>
__device__ __forceinline__ long long row_off(int b, int S, int heads, int h,
                                             int t) {
  return (((long long)b * S + t) * heads + h) * D;
}

// -- (a) D = rowsum(dO o O) ---------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(256) bwd_preprocess(BwdArgs a) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)a.B * a.Sq * a.nh) return;
  const T* o = static_cast<const T*>(a.o) + row * D;
  const T* g = static_cast<const T*>(a.dout) + row * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32)
    acc = fmaf(rt::to_f(o[c]), rt::to_f(g[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    // row = (b * Sq + i) * nh + h  ->  D[b, h, i]
    const int h = row % a.nh;
    const long long bi = row / a.nh;
    const int i = bi % a.Sq, b = bi / a.Sq;
    a.dvec[((long long)b * a.nh + h) * a.Sq + i] = acc;
  }
}

// -- fp32 body (FP32 FMA in shared memory) ------------------------------------
constexpr int kFT = 32;              // keys and queries per tile
constexpr int kFThreads = 256;

template <int D>
__host__ __device__ constexpr int fma_elems() {
  return (kFT * D + kFThreads - 1) / kFThreads;
}

// rows [t0, t0 + kFT) of head h as fp32, row stride D + 1 (zeros past S)
template <typename T, int D>
__device__ void stage_f32(float* dst, const T* src, int b, int S, int heads,
                          int h, int t0) {
  for (int i = threadIdx.x; i < kFT * D; i += kFThreads) {
    const int r = i / D, c = i % D, t = t0 + r;
    dst[r * (D + 1) + c] =
        t < S ? rt::to_f(src[row_off<D>(b, S, heads, h, t) + c]) : 0.f;
  }
}

// lse and D of queries [i0, i0 + kFT) of head h (zeros past Sq)
__device__ void stage_rows(float* sLse, float* sDv, const BwdArgs& a, int b,
                           int h, int i0) {
  for (int r = threadIdx.x; r < kFT; r += kFThreads) {
    const int i = i0 + r;
    const long long at = ((long long)b * a.nh + h) * a.Sq + i;
    sLse[r] = i < a.Sq ? a.lse[at] : 0.f;
    sDv[r] = i < a.Sq ? a.dvec[at] : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kFThreads) dkdv_fma(BwdArgs a) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1, NE = fma_elems<D>();
  float* sK = smem;
  float* sV = sK + kFT * LD;
  float* sQ = sV + kFT * LD;
  float* sO = sQ + kFT * LD;             // dO
  float* sP = sO + kFT * LD;             // P^T (key, query)
  float* sS = sP + kFT * (kFT + 1);      // dS^T
  float* sLse = sS + kFT * (kFT + 1);
  float* sDv = sLse + kFT;
  const int k0 = blockIdx.x * kFT, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, g = a.nh / a.nkv;
  stage_f32<T, D>(sK, static_cast<const T*>(a.k), b, a.Sk, a.nkv, kvh, k0);
  stage_f32<T, D>(sV, static_cast<const T*>(a.v), b, a.Sk, a.nkv, kvh, k0);
  float acc_k[NE], acc_v[NE];
#pragma unroll
  for (int m = 0; m < NE; ++m) acc_k[m] = acc_v[m] = 0.f;
  int q_lo, q_hi;
  query_range(a, k0, kFT, &q_lo, &q_hi);
  for (int hq = 0; hq < g; ++hq) {
    const int h = kvh * g + hq;
    for (int i0 = q_lo; i0 < q_hi; i0 += kFT) {
      __syncthreads();                   // the last tile's readers are done
      stage_f32<T, D>(sQ, static_cast<const T*>(a.q), b, a.Sq, a.nh, h, i0);
      stage_f32<T, D>(sO, static_cast<const T*>(a.dout), b, a.Sq, a.nh, h,
                      i0);
      stage_rows(sLse, sDv, a, b, h, i0);
      __syncthreads();
      for (int i = tid; i < kFT * kFT; i += kFThreads) {
        const int t = i / kFT, r = i % kFT;
        float p = 0.f, ds = 0.f;
        if (seen(i0 + r, k0 + t, a)) {
          const float* kr = sK + t * LD;
          const float* vr = sV + t * LD;
          const float* qr = sQ + r * LD;
          const float* gr = sO + r * LD;
          float s = 0.f, dp = 0.f;
#pragma unroll 8
          for (int c = 0; c < D; ++c) {
            s = fmaf(kr[c], qr[c], s);
            dp = fmaf(vr[c], gr[c], dp);
          }
          p = exp2f(s * a.scale_log2 - sLse[r]);
          ds = p * (dp - sDv[r]);
        }
        sP[t * (kFT + 1) + r] = p;
        sS[t * (kFT + 1) + r] = ds;
      }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < NE; ++m) {
        const int i = tid + m * kFThreads;
        if (i < kFT * D) {
          const int t = i / D, c = i % D;
          const float* pr = sP + t * (kFT + 1);
          const float* sr = sS + t * (kFT + 1);
          float dv = acc_v[m], dk = acc_k[m];
          for (int r = 0; r < kFT; ++r) {
            dv = fmaf(pr[r], sO[r * LD + c], dv);
            dk = fmaf(sr[r], sQ[r * LD + c], dk);
          }
          acc_v[m] = dv;
          acc_k[m] = dk;
        }
      }
    }
  }
  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
#pragma unroll
  for (int m = 0; m < NE; ++m) {
    const int i = tid + m * kFThreads;
    const int t = i / D, c = i % D;
    if (i < kFT * D && k0 + t < a.Sk) {
      const long long off = row_off<D>(b, a.Sk, a.nkv, kvh, k0 + t) + c;
      dk[off] = rt::from_f<T>(acc_k[m] * a.scale);
      dv[off] = rt::from_f<T>(acc_v[m]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kFThreads) dq_fma(BwdArgs a) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1, NE = fma_elems<D>();
  float* sQ = smem;
  float* sO = sQ + kFT * LD;             // dO
  float* sK = sO + kFT * LD;
  float* sV = sK + kFT * LD;
  float* sS = sV + kFT * LD;             // dS (query, key)
  float* sLse = sS + kFT * (kFT + 1);
  float* sDv = sLse + kFT;
  const int it = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int i0 = it * kFT, tid = threadIdx.x;
  const int kvh = h / (a.nh / a.nkv);
  stage_f32<T, D>(sQ, static_cast<const T*>(a.q), b, a.Sq, a.nh, h, i0);
  stage_f32<T, D>(sO, static_cast<const T*>(a.dout), b, a.Sq, a.nh, h, i0);
  stage_rows(sLse, sDv, a, b, h, i0);
  float acc[NE];
#pragma unroll
  for (int m = 0; m < NE; ++m) acc[m] = 0.f;
  int k_lo, k_hi;
  key_range(a, i0, min(kFT, a.Sq - i0), &k_lo, &k_hi);
  for (int t0 = k_lo; t0 < k_hi; t0 += kFT) {
    __syncthreads();
    stage_f32<T, D>(sK, static_cast<const T*>(a.k), b, a.Sk, a.nkv, kvh, t0);
    stage_f32<T, D>(sV, static_cast<const T*>(a.v), b, a.Sk, a.nkv, kvh, t0);
    __syncthreads();
    for (int i = tid; i < kFT * kFT; i += kFThreads) {
      const int r = i / kFT, t = i % kFT;
      float ds = 0.f;
      if (seen(i0 + r, t0 + t, a)) {
        const float* qr = sQ + r * LD;
        const float* gr = sO + r * LD;
        const float* kr = sK + t * LD;
        const float* vr = sV + t * LD;
        float s = 0.f, dp = 0.f;
#pragma unroll 8
        for (int c = 0; c < D; ++c) {
          s = fmaf(qr[c], kr[c], s);
          dp = fmaf(gr[c], vr[c], dp);
        }
        ds = exp2f(s * a.scale_log2 - sLse[r]) * (dp - sDv[r]);
      }
      sS[r * (kFT + 1) + t] = ds;
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < NE; ++m) {
      const int i = tid + m * kFThreads;
      if (i < kFT * D) {
        const int r = i / D, c = i % D;
        const float* sr = sS + r * (kFT + 1);
        float dq = acc[m];
        for (int t = 0; t < kFT; ++t) dq = fmaf(sr[t], sK[t * LD + c], dq);
        acc[m] = dq;
      }
    }
  }
  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int m = 0; m < NE; ++m) {
    const int i = tid + m * kFThreads;
    const int r = i / D, c = i % D;
    if (i < kFT * D && i0 + r < a.Sq)
      dq[row_off<D>(b, a.Sq, a.nh, h, i0 + r) + c] =
          rt::from_f<T>(acc[m] * a.scale);
  }
}

inline size_t fma_smem(int D) {
  return (4 * (size_t)kFT * (D + 1) + 2 * (size_t)kFT * (kFT + 1) + 2 * kFT)
         * sizeof(float);
}

// SMs of the current device (0 if it cannot be read)
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

bool valid(int B, int Sq, int Sk, int nh, int nkv, int d) {
  return B > 0 && Sq > 0 && Sk > 0 && nkv > 0 && nh % nkv == 0 &&
         (d == 16 || d == 32 || d == 64 || d == 80 || d == 120 || d == 128);
}

template <typename T, int D>
cudaError_t run(const BwdArgs& a, cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    rt::bwd::Args p{};
    cudaError_t e = rt::sm90::kv_map(&p.tmK, a.k, a.B, a.Sk, a.nkv, D);
    if (e == cudaSuccess)
      e = rt::sm90::kv_map(&p.tmV, a.v, a.B, a.Sk, a.nkv, D);
    if (e == cudaSuccess)
      e = rt::sm90::tile_map(&p.tmQ, a.q, a.B, a.Sq, a.nh, D, rt::bwd::kQ);
    if (e == cudaSuccess)
      e = rt::sm90::tile_map(&p.tmO, a.dout, a.B, a.Sq, a.nh, D,
                             rt::bwd::kQ);
    if (e != cudaSuccess) return e;
    p.o = static_cast<const T*>(a.o);
    p.dout = static_cast<const T*>(a.dout);
    p.lse = a.lse;
    p.dq = static_cast<T*>(a.dq);
    p.dk = static_cast<T*>(a.dk);
    p.dv = static_cast<T*>(a.dv);
    p.B = a.B; p.Sq = a.Sq; p.Sk = a.Sk; p.nh = a.nh; p.nkv = a.nkv;
    p.causal = a.causal; p.window = a.window;
    p.scale = a.scale; p.scale_log2 = a.scale_log2;
    return rt::bwd::launch<D>(p, a.dvec, a.nsplit, s);
  } else {
    const long long rows = (long long)a.B * a.Sq * a.nh;
    cudaError_t e = rt::launch<bwd_preprocess<T, D>>(
        dim3((unsigned)((rows + 7) / 8)), 256, 0, a, s);
    if (e != cudaSuccess) return e;
    e = rt::launch<dkdv_fma<T, D>>(dim3((a.Sk + kFT - 1) / kFT, a.nkv, a.B),
                                   kFThreads, fma_smem(D), a, s);
    if (e != cudaSuccess) return e;
    return rt::launch<dq_fma<T, D>>(dim3((a.Sq + kFT - 1) / kFT, a.nh, a.B),
                                    kFThreads, fma_smem(D), a, s);
  }
}

}  // namespace

// The body and its scratch for a launch of rt_flash_attention_bwd with
// these arguments: out[0] = fp32 floats of scratch (`work`), out[1] = the
// split count (CTAs per key tile, KV head and row; 1 for fp32). The launch
// makes the same choice from the same device.
extern "C" int rt_flash_attention_bwd_plan(int B, int Sq, int Sk, int nh,
                                           int nkv, int d, int causal,
                                           int window, int is_bf16,
                                           long long* out) {
  if (!valid(B, Sq, Sk, nh, nkv, d))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!is_bf16) {
    out[0] = (long long)B * nh * Sq;        // D
    out[1] = 1;
    return 0;
  }
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorNoDevice);
  out[1] = rt::bwd::splits(B, Sq, Sk, nh, nkv, causal, window, sms);
  out[0] = rt::bwd::work_floats(B, Sq, Sk, nh, nkv, d, (int)out[1]);
  return 0;
}

// `work`: fp32 scratch of the size rt_flash_attention_bwd_plan gives
extern "C" int rt_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* work, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int nh, int nkv, int d, int causal,
    int window, float scale, int is_bf16, void* stream) {
  cudaGetLastError();
  if (!valid(B, Sq, Sk, nh, nkv, d))
    return static_cast<int>(cudaErrorInvalidValue);
  int nsplit = 1;
  if (is_bf16) {
    const int sms = sm_count();
    if (sms <= 0) return static_cast<int>(cudaErrorNoDevice);
    nsplit = rt::bwd::splits(B, Sq, Sk, nh, nkv, causal, window, sms);
  }
  BwdArgs a{q, k, v, o, dout, static_cast<const float*>(lse),
            static_cast<float*>(work), dq, dk, dv, B, Sq, Sk, nh, nkv,
            causal, window, nsplit, scale, scale * kLog2e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = is_bf16 ? RT_DISPATCH_D(d, __nv_bfloat16, run, a, s)
                          : RT_DISPATCH_D(d, float, run, a, s);
  return static_cast<int>(e);
}

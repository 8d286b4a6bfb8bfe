// Flash-attention backward for Hopper (sm_90a): dq, dk and dv of the
// full-sequence attention the flash forward (flash_attention.cu) computes,
// q (B, Sq, nh, d) against k/v (B, Sk, nkv, d), causal and/or sliding
// window, GQA, ragged Sq / Sk and Sq != Sk.
//
// No Pallas counterpart: the JAX package trains with use_pallas=False and
// lets XLA differentiate its jnp attention (repro/models/attention.py).
// This is the attention gradient of the port's training path
// (FlashAttentionFn in kernels/flash_attention.py).
//
// Math, in natural units with s = scale * q.k: P = softmax(s) under the
// forward's mask, D_i = sum_c dO_ic O_ic, dP = dO V^T, dS = P o (dP - D),
// dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K. P is recomputed from
// the forward's log-sum-exp, which both forward bodies store in base-2
// units: P_ij = exp2(q_i.k_j * scale * log2(e) - lse_i).
//
// Three launches:
//  (a) preprocess: D (B, nh, Sq) fp32, one warp per query row;
//  (b) dK / dV: one CTA per (key tile, KV head, batch row). It keeps its
//      K / V tile in shared memory and fp32 dK / dV accumulators for the
//      whole walk, and loops over the g query heads of its KV head and over
//      the query tiles that can see its keys, so GQA's sum over the group
//      happens inside the CTA: no atomics, the result is deterministic.
//      Under causal masking the first key tiles see the most queries, and
//      they are issued first;
//  (c) dQ: one CTA per (query tile, query head, batch row), walking the key
//      tiles its queries reach; the last (longest) query tiles first.
// (b) and (c) each recompute S and dP, 7 matmuls where the least is 5
// (2.5x the forward's 2): the price of no atomics and no dS in memory.
//
// Bound on the card: OPERATIONS at the training shapes (internlm2-1.8b's
// 2048-token causal rows, 16/8 heads of 128, need ~1700 FLOPs per byte
// they must move; the card's balance point is ~295).
//
// Bodies:
//  * bf16: mma.sync m16n8k16 (warp_mma.cuh) with fp32 accumulators, four
//    warps of 16 rows each. Tiles are staged with 16-byte loads into shared
//    memory rows padded by 16 bytes (ldmatrix reads 8 rows without bank
//    conflicts at every head dim); P and dS are rounded to bf16 as the A
//    operand of the dV / dK / dQ products, as the forward rounds P before
//    P V. Head dim 120 runs as 128 in shared memory: the 8 tail columns
//    are zero in Q, K, V and dO, so their accumulators stay 0 and are never
//    stored. Nothing outside shared memory is padded.
//  * fp32: FP32 FMA in shared memory (the card-vs-CPU training check runs
//    it): one (key, query) pair per thread iteration for S and dP, one
//    output element per thread iteration for the products, accumulators in
//    registers.
// wgmma, TMA and warp specialisation are later work (ROADMAP.md section B).
#include <stdint.h>

#include <type_traits>

#include "attn_common.cuh"
#include "warp_mma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;       // (B, nh, Sq), base 2
  float* dvec;            // (B, nh, Sq) scratch: D
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Sk, nh, nkv, causal, window;
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

// -- bf16 body (mma.sync m16n8k16) --------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int kMThreads = 128;       // four warps of 16 rows
constexpr int kKeys = 64;            // dK / dV: keys per CTA
constexpr int kQTile = 32;           // dK / dV: queries per step
constexpr int kQueries = 64;         // dQ: queries per CTA
constexpr int kKTile = 32;           // dQ: keys per step

template <int D>
__host__ __device__ constexpr int padded() { return (D + 15) / 16 * 16; }
// shared-memory row stride in elements: 16 bytes past the padded row
template <int D>
__host__ __device__ constexpr int ld() { return padded<D>() + 8; }

// rows [t0, t0 + ROWS) of head h into a bf16 tile of stride ld<D>(): 16-byte
// pieces, zeros past S and in the pad columns
template <int D, int ROWS>
__device__ void stage_bf16(bf16* dst, const bf16* src, int b, int S,
                           int heads, int h, int t0) {
  constexpr int NPP = padded<D>() / 8, NP = D / 8;
  for (int i = threadIdx.x; i < ROWS * NPP; i += kMThreads) {
    const int r = i / NPP, piece = i % NPP, t = t0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (t < S && piece < NP)
      val = *reinterpret_cast<const uint4*>(
          src + row_off<D>(b, S, heads, h, t) + piece * 8);
    *reinterpret_cast<uint4*>(dst + r * ld<D>() + piece * 8) = val;
  }
}

template <int ROWS>
__device__ void stage_rows_n(float* sLse, float* sDv, const BwdArgs& a,
                             int b, int h, int i0) {
  for (int r = threadIdx.x; r < ROWS; r += kMThreads) {
    const int i = i0 + r;
    const long long at = ((long long)b * a.nh + h) * a.Sq + i;
    sLse[r] = i < a.Sq ? a.lse[at] : 0.f;
    sDv[r] = i < a.Sq ? a.dvec[at] : 0.f;
  }
}

// A fragment (16 rows x 16 k) at (r0, k0) of a row-major tile
__device__ __forceinline__ void frag_a(uint32_t (&f)[4], const bf16* t,
                                       int stride, int r0, int k0, int lane) {
  rt::ldsm_x4(f, rt::smem_u32(t + (r0 + lane % 16) * stride + k0 +
                              (lane / 16) * 8));
}

// B fragments of k rows k0..k0+15 for the two n-blocks n0..n0+15, from a
// tile stored (n, k): f[0], f[1] n-block 0; f[2], f[3] n-block 1
__device__ __forceinline__ void frag_b_nk(uint32_t (&f)[4], const bf16* t,
                                          int stride, int n0, int k0,
                                          int lane) {
  rt::ldsm_x4(f, rt::smem_u32(t + (n0 + lane % 8 + (lane / 16) * 8) * stride
                              + k0 + ((lane / 8) % 2) * 8));
}

// the same from a tile stored (k, n), through ldmatrix.trans
__device__ __forceinline__ void frag_b_kn(uint32_t (&f)[4], const bf16* t,
                                          int stride, int k0, int n0,
                                          int lane) {
  rt::ldsm_x4_t(f, rt::smem_u32(t + (k0 + lane % 8 + ((lane / 8) % 2) * 8)
                                * stride + n0 + (lane / 16) * 8));
}

// acc (16 x 8 NB blocks) += A (16 rows of `ta` at r0, all DP columns) times
// the transpose of tile `tb` (NB * 8 rows, stored (n, k)): S = Q K^T-style
template <int DP, int NB>
__device__ __forceinline__ void mma_abt(float (&acc)[NB][4], const bf16* ta,
                                        const bf16* tb, int stride, int r0,
                                        int lane) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t fa[4];
    frag_a(fa, ta, stride, r0, kk * 16, lane);
#pragma unroll
    for (int n2 = 0; n2 < NB / 2; ++n2) {
      uint32_t fb[4];
      frag_b_nk(fb, tb, stride, n2 * 16, kk * 16, lane);
      rt::mma16816(acc[2 * n2], fa, fb[0], fb[1]);
      rt::mma16816(acc[2 * n2 + 1], fa, fb[2], fb[3]);
    }
  }
}

// acc (16 x DP) += P (16 x KB*16, bf16 A fragments in registers) times tile
// `tb` (KB*16 rows stored (k, n), DP columns): dV = P^T dO-style
template <int DP, int KB>
__device__ __forceinline__ void mma_pb(float (&acc)[DP / 8][4],
                                       const uint32_t (&pa)[KB][4],
                                       const bf16* tb, int stride, int lane) {
#pragma unroll
  for (int kk = 0; kk < KB; ++kk) {
#pragma unroll
    for (int n2 = 0; n2 < DP / 16; ++n2) {
      uint32_t fb[4];
      frag_b_kn(fb, tb, stride, kk * 16, n2 * 16, lane);
      rt::mma16816(acc[2 * n2], pa[kk], fb[0], fb[1]);
      rt::mma16816(acc[2 * n2 + 1], pa[kk], fb[2], fb[3]);
    }
  }
}

// accumulator blocks 2kk, 2kk + 1 as the bf16 A fragment of k-step kk
template <int NB>
__device__ __forceinline__ void pack_a(uint32_t (&pa)[NB / 2][4],
                                       const float (&x)[NB][4]) {
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    pa[kk][0] = rt::pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    pa[kk][1] = rt::pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    pa[kk][2] = rt::pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    pa[kk][3] = rt::pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// store a 16 x DP fp32 accumulator, times `mul`, as bf16 rows r (of this
// warp's 16, those with row0 + r < S) of head h: pairs of columns < D
template <int D>
__device__ __forceinline__ void store_rows(
    bf16* out, const float (&acc)[padded<D>() / 8][4], float mul, int b,
    int S, int heads, int h, int row0, int lane) {
#pragma unroll
  for (int nb = 0; nb < padded<D>() / 8; ++nb) {
    const int c = nb * 8 + 2 * (lane % 4);
    if (nb * 8 >= D) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = row0 + lane / 4 + 8 * half;
      if (t < S)
        *reinterpret_cast<uint32_t*>(out + row_off<D>(b, S, heads, h, t) + c)
            = rt::pack_bf16(acc[nb][2 * half] * mul,
                            acc[nb][2 * half + 1] * mul);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMThreads) dkdv_mma(BwdArgs a) {
  constexpr int DP = padded<D>(), LD = ld<D>(), NQ = kQTile / 8;
  extern __shared__ uint4 smem_u4[];
  bf16* sK = reinterpret_cast<bf16*>(smem_u4);
  bf16* sV = sK + kKeys * LD;
  bf16* sQ = sV + kKeys * LD;
  bf16* sO = sQ + kQTile * LD;           // dO
  float* sLse = reinterpret_cast<float*>(sO + kQTile * LD);
  float* sDv = sLse + kQTile;
  const int k0 = blockIdx.x * kKeys, kvh = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, g = a.nh / a.nkv;
  const int kw = 16 * w;                 // this warp's keys in the tile
  stage_bf16<D, kKeys>(sK, static_cast<const bf16*>(a.k), b, a.Sk, a.nkv,
                       kvh, k0);
  stage_bf16<D, kKeys>(sV, static_cast<const bf16*>(a.v), b, a.Sk, a.nkv,
                       kvh, k0);
  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  int q_lo, q_hi;
  query_range(a, k0, kKeys, &q_lo, &q_hi);
  for (int hq = 0; hq < g; ++hq) {
    const int h = kvh * g + hq;
    for (int i0 = q_lo; i0 < q_hi; i0 += kQTile) {
      __syncthreads();
      stage_bf16<D, kQTile>(sQ, static_cast<const bf16*>(a.q), b, a.Sq,
                            a.nh, h, i0);
      stage_bf16<D, kQTile>(sO, static_cast<const bf16*>(a.dout), b, a.Sq,
                            a.nh, h, i0);
      stage_rows_n<kQTile>(sLse, sDv, a, b, h, i0);
      __syncthreads();
      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x kQTile queries
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      mma_abt<DP, NQ>(st, sK, sQ, LD, kw, lane);
      mma_abt<DP, NQ>(dpt, sV, sO, LD, kw, lane);
      // P^T and dS^T = P^T o (dP^T - D)
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = j * 8 + 2 * (lane % 4) + (e & 1);     // query
          const int t = k0 + kw + lane / 4 + 8 * (e >> 1);    // key
          const float p = seen(i0 + r, t, a)
                              ? rt::ex2(st[j][e] * a.scale_log2 - sLse[r])
                              : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - sDv[r]);
        }
      uint32_t pa[NQ / 2][4], sa[NQ / 2][4];
      pack_a<NQ>(pa, st);
      pack_a<NQ>(sa, dpt);
      mma_pb<DP, NQ / 2>(dv, pa, sO, LD, lane);     // dV += P^T dO
      mma_pb<DP, NQ / 2>(dk, sa, sQ, LD, lane);     // dK += dS^T Q
    }
  }
  store_rows<D>(static_cast<bf16*>(a.dk), dk, a.scale, b, a.Sk, a.nkv, kvh,
                k0 + kw, lane);
  store_rows<D>(static_cast<bf16*>(a.dv), dv, 1.f, b, a.Sk, a.nkv, kvh,
                k0 + kw, lane);
}

template <int D>
__global__ void __launch_bounds__(kMThreads) dq_mma(BwdArgs a) {
  constexpr int DP = padded<D>(), LD = ld<D>(), NK = kKTile / 8;
  extern __shared__ uint4 smem_u4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_u4);
  bf16* sO = sQ + kQueries * LD;         // dO
  bf16* sK = sO + kQueries * LD;
  bf16* sV = sK + kKTile * LD;
  float* sLse = reinterpret_cast<float*>(sV + kKTile * LD);
  float* sDv = sLse + kQueries;
  const int it = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int i0 = it * kQueries, kvh = h / (a.nh / a.nkv);
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, qw = 16 * w;
  stage_bf16<D, kQueries>(sQ, static_cast<const bf16*>(a.q), b, a.Sq, a.nh,
                          h, i0);
  stage_bf16<D, kQueries>(sO, static_cast<const bf16*>(a.dout), b, a.Sq,
                          a.nh, h, i0);
  stage_rows_n<kQueries>(sLse, sDv, a, b, h, i0);
  // this thread's two query rows (accumulator rows lane / 4 and + 8)
  const int ra = qw + lane / 4, rb = ra + 8;
  float dq[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  int k_lo, k_hi;
  key_range(a, i0, min(kQueries, a.Sq - i0), &k_lo, &k_hi);
  for (int t0 = k_lo; t0 < k_hi; t0 += kKTile) {
    __syncthreads();
    stage_bf16<D, kKTile>(sK, static_cast<const bf16*>(a.k), b, a.Sk, a.nkv,
                          kvh, t0);
    stage_bf16<D, kKTile>(sV, static_cast<const bf16*>(a.v), b, a.Sk, a.nkv,
                          kvh, t0);
    __syncthreads();
    // S = Q K^T and dP = dO V^T: this warp's 16 queries x kKTile keys
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_abt<DP, NK>(s, sQ, sK, LD, qw, lane);
    mma_abt<DP, NK>(dp, sO, sV, LD, qw, lane);
    const float la = sLse[ra], lb = sLse[rb], da = sDv[ra], db = sDv[rb];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + j * 8 + 2 * (lane % 4) + (e & 1);   // key
        const bool hi = e >> 1;
        const int r = hi ? rb : ra;
        const float p = seen(i0 + r, t, a)
                            ? rt::ex2(s[j][e] * a.scale_log2 - (hi ? lb : la))
                            : 0.f;
        dp[j][e] = p * (dp[j][e] - (hi ? db : da));
      }
    uint32_t sa[NK / 2][4];
    pack_a<NK>(sa, dp);
    mma_pb<DP, NK / 2>(dq, sa, sK, LD, lane);       // dQ += dS K
  }
  store_rows<D>(static_cast<bf16*>(a.dq), dq, a.scale, b, a.Sq, a.nh, h,
                i0 + qw, lane);
}

template <int D>
constexpr size_t mma_smem(int tile_a, int tile_b) {
  return 2 * (size_t)(tile_a + tile_b) * ld<D>() * sizeof(bf16)
         + 2 * (size_t)(tile_a > tile_b ? tile_a : tile_b) * sizeof(float);
}

template <typename T, int D>
cudaError_t run(const BwdArgs& a, cudaStream_t s) {
  const long long rows = (long long)a.B * a.Sq * a.nh;
  cudaError_t e = rt::launch<bwd_preprocess<T, D>>(
      dim3((unsigned)((rows + 7) / 8)), 256, 0, a, s);
  if (e != cudaSuccess) return e;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // dK / dV: K/V tiles of kKeys + query steps of kQTile; dQ: query tiles
    // of kQueries + key steps of kKTile (the lse / D rows of the larger)
    e = rt::launch<dkdv_mma<D>>(
        dim3((a.Sk + kKeys - 1) / kKeys, a.nkv, a.B), kMThreads,
        mma_smem<D>(kKeys, kQTile), a, s);
    if (e != cudaSuccess) return e;
    return rt::launch<dq_mma<D>>(
        dim3((a.Sq + kQueries - 1) / kQueries, a.nh, a.B), kMThreads,
        mma_smem<D>(kQueries, kKTile), a, s);
  } else {
    e = rt::launch<dkdv_fma<T, D>>(dim3((a.Sk + kFT - 1) / kFT, a.nkv, a.B),
                                   kFThreads, fma_smem(D), a, s);
    if (e != cudaSuccess) return e;
    return rt::launch<dq_fma<T, D>>(dim3((a.Sq + kFT - 1) / kFT, a.nh, a.B),
                                    kFThreads, fma_smem(D), a, s);
  }
}

}  // namespace

extern "C" int rt_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dvec, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int nh, int nkv, int d, int causal,
    int window, float scale, int is_bf16, void* stream) {
  cudaGetLastError();
  BwdArgs a{q, k, v, o, dout, static_cast<const float*>(lse),
            static_cast<float*>(dvec), dq, dk, dv, B, Sq, Sk, nh, nkv,
            causal, window, scale, scale * kLog2e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = is_bf16 ? RT_DISPATCH_D(d, __nv_bfloat16, run, a, s)
                          : RT_DISPATCH_D(d, float, run, a, s);
  return static_cast<int>(e);
}

// Shared online-softmax attention body for the port's three attention
// kernels (decode_attention.cu, chunk_attention.cu, flash_attention.cu).
//
// One CTA owns `rows` query rows that all read the SAME key/value head, and
// walks the key positions [kv_lo, kv_hi) in tiles of kTK keys. Each tile is
// staged in shared memory as fp32; scores, the running max / denominator
// and the fp32 accumulator live in shared memory for the whole walk. This
// loop inside one CTA takes the place of the Pallas kernels' sequential KV
// grid axis, whose VMEM scratch carried the same (m, l, acc) state across
// grid steps.
//
// Numerics match the Pallas kernels and the plain PyTorch oracles: scores
// in fp32 (bf16 inputs upcast on load), finite masking with -1e30, masked
// probabilities exactly 0, and the final divide guarded by max(l, 1e-30) so
// a row that sees nothing (a dead decode row pointing at the trash block)
// stays finite.
//
// The policy type P says where row r's query lives, its absolute position,
// which pool row backs key position t, and the mask rule. It provides:
//   int rows, nkv, kvh, kv_lo, kv_hi, causal, window;  float scale;
//   const T* q_row(int r);  T* o_row(int r);  int q_pos(int r);
//   int kv_row(int t);   // token row in the (rows, nkv, D) K/V layout
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace rt {

constexpr float kNegInf = -1e30f;
constexpr int kTK = 32;             // keys per shared-memory tile
constexpr int kSP = kTK + 1;        // padded score-row stride (no bank clash)
constexpr int kThreads = 256;

// Dynamic shared memory for `rows` query rows at head dim d.
inline size_t smem_bytes(int rows, int d) {
  size_t floats = 2 * (size_t)rows * d          // Q, acc
                  + (size_t)kTK * (d + 1)        // K tile (padded rows)
                  + (size_t)kTK * d              // V tile
                  + (size_t)rows * kSP           // scores / probabilities
                  + 3 * (size_t)rows;            // m, l, alpha
  size_t ints = (size_t)rows + kTK;              // query positions, kv rows
  return floats * sizeof(float) + ints * sizeof(int);
}

__device__ __forceinline__ bool visible(int qp, int t, int causal,
                                        int window) {
  return (!causal || t <= qp) && (window <= 0 || t > qp - window);
}

// kPartial: write the unnormalised accumulator and (m, l) per row through
// p.part_acc(r) / p.part_ml(r) instead of the output (split-KV decode,
// combined by a second kernel).
template <typename T, int D, bool kPartial = false, class P>
__device__ void attend(const P& p, const T* __restrict__ K,
                       const T* __restrict__ V) {
  extern __shared__ float smem[];
  const int rows = p.rows;
  float* sQ = smem;
  float* sAcc = sQ + rows * D;
  float* sK = sAcc + rows * D;
  float* sV = sK + kTK * (D + 1);
  float* sS = sV + kTK * D;
  float* sM = sS + rows * kSP;
  float* sL = sM + rows;
  float* sA = sL + rows;
  int* sQP = reinterpret_cast<int*>(sA + rows);
  int* sRow = sQP + rows;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  for (int i = tid; i < rows * D; i += nthr) {
    const int r = i / D, c = i % D;
    sQ[i] = to_f(p.q_row(r)[c]);
    sAcc[i] = 0.f;
  }
  for (int r = tid; r < rows; r += nthr) {
    sM[r] = kNegInf;
    sL[r] = 0.f;
    sQP[r] = p.q_pos(r);
  }
  __syncthreads();

  for (int t0 = p.kv_lo; t0 < p.kv_hi; t0 += kTK) {
    const int nt = min(kTK, p.kv_hi - t0);
    if (tid < nt) sRow[tid] = p.kv_row(t0 + tid);
    __syncthreads();
    // stage the K/V tile (fp32), neighbouring threads on neighbouring dims
    for (int i = tid; i < kTK * D; i += nthr) {
      const int t = i / D, c = i % D;
      float kk = 0.f, vv = 0.f;
      if (t < nt) {
        const long long off =
            ((long long)sRow[t] * p.nkv + p.kvh) * D + c;
        kk = to_f(K[off]);
        vv = to_f(V[off]);
      }
      sK[t * (D + 1) + c] = kk;
      sV[t * D + c] = vv;
    }
    __syncthreads();
    // scores: one (row, key) pair per thread iteration
    for (int i = tid; i < rows * kTK; i += nthr) {
      const int r = i / kTK, t = i % kTK;
      float s = kNegInf;
      if (t < nt && visible(sQP[r], t0 + t, p.causal, p.window)) {
        const float* qr = sQ + r * D;
        const float* kr = sK + t * (D + 1);
        float acc = 0.f;
#pragma unroll 16
        for (int c = 0; c < D; ++c) acc = fmaf(qr[c], kr[c], acc);
        s = acc * p.scale;
      }
      sS[r * kSP + t] = s;
    }
    __syncthreads();
    // online-softmax update, one thread per row
    for (int r = tid; r < rows; r += nthr) {
      float* sr = sS + r * kSP;
      const float m_prev = sM[r];
      float m_cur = m_prev;
      for (int t = 0; t < nt; ++t) m_cur = fmaxf(m_cur, sr[t]);
      const float alpha = expf(m_prev - m_cur);
      float lsum = 0.f;
      for (int t = 0; t < nt; ++t) {
        const float pr = visible(sQP[r], t0 + t, p.causal, p.window)
                             ? expf(sr[t] - m_cur) : 0.f;
        sr[t] = pr;
        lsum += pr;
      }
      sL[r] = sL[r] * alpha + lsum;
      sA[r] = alpha;
      sM[r] = m_cur;
    }
    __syncthreads();
    // acc = acc * alpha + P @ V
    for (int i = tid; i < rows * D; i += nthr) {
      const int r = i / D, c = i % D;
      const float* pr = sS + r * kSP;
      float acc = sAcc[i] * sA[r];
      for (int t = 0; t < nt; ++t) acc = fmaf(pr[t], sV[t * D + c], acc);
      sAcc[i] = acc;
    }
    __syncthreads();
  }

  if constexpr (kPartial) {
    for (int i = tid; i < rows * D; i += nthr)
      p.part_acc(i / D)[i % D] = sAcc[i];
    for (int r = tid; r < rows; r += nthr) {
      p.part_ml(r)[0] = sM[r];
      p.part_ml(r)[1] = sL[r];
    }
  } else {
    for (int i = tid; i < rows * D; i += nthr) {
      const int r = i / D, c = i % D;
      p.o_row(r)[c] = from_f<T>(sAcc[i] / fmaxf(sL[r], 1e-30f));
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core body for bf16 (chunk and flash prefill).
//
// Four warps own 16 query rows each (64 rows per CTA). Q lives in registers
// as m16n8k16 A fragments; each tile of kMmaKT keys is staged in shared
// memory as bf16 (16-byte loads); S = Q K^T and O += P V run as
// mma.sync.m16n8k16 with fp32 accumulators, P re-packed to bf16 straight
// from the S accumulators (the FA2 register reuse), V's B fragments read
// with ldmatrix.trans. Row max / sum reduce across the 4 lanes of a quad.
// Same masking and finite-softmax rules as `attend`; P is rounded to bf16
// before the PV product, as the plain version casts probabilities to
// v.dtype.
// ---------------------------------------------------------------------------
constexpr int kMmaWarps = 4;
constexpr int kMmaRows = 16 * kMmaWarps;
constexpr int kMmaKT = 64;            // keys per tile

inline size_t mma_smem_bytes(int d) {
  const size_t ld = d + 8;            // padded row stride (bf16 elements)
  return (kMmaRows * ld + 2 * kMmaKT * ld) * 2
         + (kMmaRows + kMmaKT) * sizeof(int);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (low) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1,
                                              const void* ptr) {
  const uint32_t a =
      static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(a));
}

template <int D, class P>
__device__ void attend_mma(const P& p, const __nv_bfloat16* __restrict__ K,
                           const __nv_bfloat16* __restrict__ V) {
  extern __shared__ float smem[];
  constexpr int LD = D + 8, KT = kMmaKT;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + kMmaRows * LD;
  __nv_bfloat16* sV = sK + KT * LD;
  int* sQP = reinterpret_cast<int*>(sV + KT * LD);
  int* sRow = sQP + kMmaRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nthr = blockDim.x;
  const int rows = p.rows;

  for (int i = tid; i < kMmaRows * D; i += nthr) {
    const int r = i / D, c = i % D;
    sQ[r * LD + c] = r < rows ? p.q_row(r)[c] : __float2bfloat16(0.f);
  }
  for (int r = tid; r < kMmaRows; r += nthr)
    sQP[r] = r < rows ? p.q_pos(r) : -1;     // pad rows see nothing
  __syncthreads();

  const int r0 = warp * 16 + lane / 4, c0 = (lane % 4) * 2;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* b = sQ + r0 * LD + kk * 16 + c0;
    qf[kk][0] = ld32(b);
    qf[kk][1] = ld32(b + 8 * LD);
    qf[kk][2] = ld32(b + 8);
    qf[kk][3] = ld32(b + 8 * LD + 8);
  }
  const int qp0 = sQP[r0], qp1 = sQP[r0 + 8];
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int t0 = p.kv_lo; t0 < p.kv_hi; t0 += KT) {
    const int nt = min(KT, p.kv_hi - t0);
    __syncthreads();                  // the previous tile is fully read
    if (tid < KT) sRow[tid] = tid < nt ? p.kv_row(t0 + tid) : 0;
    __syncthreads();
    for (int i = tid; i < KT * (D / 8); i += nthr) {
      const int t = i / (D / 8), c = (i % (D / 8)) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (t < nt) {
        const long long off =
            ((long long)sRow[t] * p.nkv + p.kvh) * D + c;
        kv = *reinterpret_cast<const uint4*>(K + off);
        vv = *reinterpret_cast<const uint4*>(V + off);
      }
      *reinterpret_cast<uint4*>(sK + t * LD + c) = kv;
      *reinterpret_cast<uint4*>(sV + t * LD + c) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x KT keys
    float s[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kb = sK + (j * 8 + lane / 4) * LD + kk * 16 + c0;
        mma_bf16(s[j], qf[kk], ld32(kb), ld32(kb + 8));
      }
    }
    // mask, scale, running max over the quad
    uint32_t vis = 0;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + c0 + e, key = t0 + col;
        const bool ok0 = col < nt && visible(qp0, key, p.causal, p.window);
        const bool ok1 = col < nt && visible(qp1, key, p.causal, p.window);
        s[j][e] = ok0 ? s[j][e] * p.scale : kNegInf;
        s[j][2 + e] = ok1 ? s[j][2 + e] * p.scale : kNegInf;
        vis |= (ok0 ? 1u : 0u) << (j * 4 + e);
        vis |= (ok1 ? 1u : 0u) << (j * 4 + 2 + e);
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float a0 = expf(m0 - mx0), a1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 = (vis >> (j * 4 + e)) & 1u ? expf(s[j][e] - mx0)
                                                   : 0.f;
        const float p1 = (vis >> (j * 4 + 2 + e)) & 1u
                             ? expf(s[j][2 + e] - mx1) : 0.f;
        s[j][e] = p0;
        s[j][2 + e] = p1;
        ls0 += p0;
        ls1 += p1;
      }
    }
    l0 = l0 * a0 + ls0;               // per-lane partial; reduced at the end
    l1 = l1 * a1 + ls1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }
    // O += P V: P's accumulator layout is the A fragment of m16n8k16
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, sV + (kk * 16 + (lane % 16)) * LD + n * 8);
        mma_bf16(o[n], pa, b0, b1);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + c0;
    if (r0 < rows) {
      __nv_bfloat16* out = p.o_row(r0);
      out[c] = __float2bfloat16(o[n][0] * inv0);
      out[c + 1] = __float2bfloat16(o[n][1] * inv0);
    }
    if (r0 + 8 < rows) {
      __nv_bfloat16* out = p.o_row(r0 + 8);
      out[c] = __float2bfloat16(o[n][2] * inv1);
      out[c + 1] = __float2bfloat16(o[n][3] * inv1);
    }
  }
}

}  // namespace rt

// Instantiate `fn<T, D>` for the supported head dims. 80 is zamba2's: the
// `mma.sync` body runs its 5 k-steps of 16 and 10 n-tiles of 8, and its
// padded rows of 88 bf16 (176 B) keep the 16-byte loads aligned.
#define RT_DISPATCH_D(d, T, fn, ...)                      \
  [&]() -> cudaError_t {                                  \
    switch (d) {                                          \
      case 16: return fn<T, 16>(__VA_ARGS__);             \
      case 32: return fn<T, 32>(__VA_ARGS__);             \
      case 64: return fn<T, 64>(__VA_ARGS__);             \
      case 80: return fn<T, 80>(__VA_ARGS__);             \
      case 128: return fn<T, 128>(__VA_ARGS__);           \
      default: return cudaErrorInvalidValue;              \
    }                                                     \
  }()

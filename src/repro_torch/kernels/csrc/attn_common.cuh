// FP32-pipe online-softmax attention body shared by the port's attention
// kernels: every decode launch (decode_attention.cu), every fp32 chunk and
// flash launch, and bf16 chunk / flash groups of more than 128 query heads
// per KV head. bf16 prefill otherwise runs the Hopper body in
// prefill_sm90.cuh.
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

}  // namespace rt

// Instantiate `fn<T, D>` for the supported head dims. 80 is zamba2's: the
// bf16 prefill body runs its 5 slices of 16 columns and wgmma.m64n80k16.
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

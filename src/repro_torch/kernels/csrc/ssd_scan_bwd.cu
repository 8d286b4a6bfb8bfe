// Backward of the Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// No Pallas counterpart: the JAX package trains with use_pallas=False and
// lets XLA differentiate its jnp `ssd_chunked` (repro/models/ssm.py). This
// is the gradient of ssd_scan.cu's function: from x (B, S, nh, hd), dt
// (B, S, nh) fp32, a (nh,) fp32, b / c (B, S, N) (one group shared by
// every head), the output gradient dy (B, S, nh, hd) in x's type, the
// final state's gradient dh_final (B, nh, hd, N) fp32 (or none) and the
// state each chunk starts from (B, n_chunks, nh, hd, N) fp32, which the
// forward stores for it, to dx, db, dc in x's type and ddt, da and dh0 in
// fp32. Per chunk of Q positions and head, with l = cumsum(dt a),
// E_ij = exp(l_i - l_j) [j <= i], M_ij = (C_i . B_j) E_ij,
// w_j = exp(l_last - l_j), h_in the chunk's entry state and dH the
// gradient of its exit state:
//   dxdt_j = sum_i M_ij dy_i + w_j dH B_j,  dx = dxdt dt
//   dh_in  = exp(l_last) dH + S,  S = sum_i exp(l_i) dy_i (x) C_i
//   dC_i   = sum_h [sum_j E_ij (dy_i . xdt_j) B_j + exp(l_i) h_in^T dy_i]
//   dB_j   = sum_h [sum_i E_ij (dy_i . xdt_j) C_i + w_j dH^T xdt_j]
//   dl     = row sums - column sums of T = M o (dy . xdt^T)
//            + exp(l_i) dy_i . (h_in C_i) - W_j (W_j = w_j xdt_j . dH B_j),
//            and on the last row + exp(l_last) <dH, h_in> + sum_j W_j
//   g = reverse cumsum of dl: ddt = g a + sum_d dxdt x, da = sum g dt.
// (ssd_scan.py `ssd_scan_bwd_plain` is the same walk in plain PyTorch.)
//
// Two bodies. bf16 x, B and C whose rows and strides are 16-byte aligned
// (head dim and state width multiples of 8: the forward's route rule) run
// the tensor-core body of ssd_bwd_sm90.cuh, whose note gives the bound at
// the train shapes and its design. `plan_of` alone decides the body; the
// launch and rt_ssd_scan_bwd_plan (which the wrapper and chip_smoke.py ask
// for the scratch size and the body) both call it. fp32 inputs, and bf16
// ones that fail the rule, run the body below: fp32 on the CUDA cores out
// of shared memory, bound by the FP32 pipe (67 TFLOP/s) and the shared-
// memory load rate rather than by either of the card's bounds. Its sums
// are the card == CPU training check's (fp32 losses equal bit for bit).
//
// What the CUDA-core body does:
//  * The forward carried h across the chunks in one CTA. The backward's
//    only carried quantity is dH, and it depends on the chunk's inputs
//    only through S (the chunk's own term) and l_last: so S is computed
//    for every (batch, chunk, head) in parallel (s_kernel), a short
//    elementwise pass walks the chunks backwards per state element
//    (dh_kernel: dH_{k-1} = exp(l_last,k) dH_k + S_k, written over S in
//    place), and every other term is then local to one (batch, chunk,
//    head) with h_in and dH in hand (main_kernel, 1024 CTAs at the train
//    shape).
//  * C B^T is shared by the heads: computed once per (batch, chunk) into a
//    (B, n_chunks, Q, Q) fp32 scratch (cb_kernel), as the forward's fp32
//    body does.
//  * dB and dC sum over the heads. main_kernel writes each head's share to
//    a (B, n_chunks, nh, Q, N) fp32 scratch and reduce_kernel sums it in
//    head order: no atomics, so two calls on one input agree bit for bit.
//    Likewise da: one partial per (batch, chunk, head), summed over batch
//    and chunks by the wrapper.
//  * Products run in fp32 on register tiles of a 16 x 16 thread grid
//    (rows ty + 16 r, columns tx + 16 q) over padded shared rows (no bank
//    conflicts on the column operand). dt enters as a scale of rows or
//    columns, never as x dt stored, so dx's and ddt's sums stay exact in
//    x. Every exponent is a difference <= 0.
//  * The ragged tail is masked here: positions past S read x = dy = b = c
//    = 0 and dt = 0 and write nothing; x, dt, b and c are strided views
//    read in place, as in the forward.
#include "common.cuh"
#include "ssd_bwd_sm90.cuh"

namespace {
namespace ssd_bwd {   // the kernels' names in a profile: ssd_bwd::*

constexpr int kThreads = 256;
constexpr int kMaxQ = 128;          // chunk length the kernels take
constexpr int kMaxN = 256;          // state width the kernels take
constexpr int kMaxD = 64;           // head dims the backward takes
constexpr int kLQ = kMaxQ + 1;      // padded Q x Q row (floats)
constexpr int kLD = kMaxD + 1;      // padded Q x hd row
constexpr int kNT = 32;             // state columns per main_kernel tile
constexpr int kLT = kNT + 1;
constexpr int kSN = 128;            // state columns per s_kernel tile
constexpr int kLS = kSN + 1;
constexpr int kLR = kMaxQ + 1;      // padded row of the partial sums

struct BwdArgs {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  const void* dy;           // (B, S, nh, hd) contiguous, x's type
  const float* states;      // (B, nc, nh, hd, N): each chunk's entry state
  const float* dh_final;    // (B, nh, hd, N), nullptr: zero
  void* dx;                 // (B, S, nh, hd), x's type
  float* ddt;               // (B, S, nh)
  void* db;                 // (B, S, N), x's type
  void* dc;
  float* dh0;               // (B, nh, hd, N), nullptr: not wanted
  float* cb;                // (B, nc, Q, Q) scratch: C B^T per chunk
  float* dhs;               // (B, nc, nh, hd, N) scratch: S, then dH
  float* lsum;              // (B, nc, nh) scratch: l_last per chunk
  float* pdb;               // (B, nc, nh, Q, N) scratch: per-head dB
  float* pdc;               // ... and dC
  float* pda;               // (B, nc, nh): per-chunk partials of da
  int B, S, nh, hd, N, Q, nc;
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss;
};

// Warp 0: dt of the chunk's rows (0 past nq) and l = cumsum(dt a) over all
// kMaxQ rows (constant past nq, so sL[kMaxQ - 1] is l_last).
__device__ __forceinline__ void chunk_decay(const BwdArgs& a, int b, int hh,
                                            int t0, int nq, float* sDt,
                                            float* sL) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const float ah = a.a[hh];
  float v[4], run = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = lane * 4 + e;
    const float dtj =
        j < nq ? a.dt[b * a.dt_sb + (long long)(t0 + j) * a.dt_ss + hh] : 0.f;
    sDt[j] = dtj;
    run += dtj * ah;
    v[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) sL[lane * 4 + e] = incl - run + v[e];
}

__device__ __forceinline__ long long head_base(const BwdArgs& a, int b,
                                               int k, int hh) {
  return ((long long)b * a.nc + k) * a.nh + hh;
}

// C B^T of chunk blockIdx.x of row blockIdx.y (the forward's pass 1)
template <typename T>
__global__ void __launch_bounds__(kThreads) cb_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  float* sC = smem;                     // kMaxQ x kLT
  float* sB = sC + kMaxQ * kLT;
  const int ch = blockIdx.x, b = blockIdx.y;
  const int Q = a.Q, t0 = ch * Q, nq = min(Q, a.S - t0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* Bm = static_cast<const T*>(a.b);
  const T* Cm = static_cast<const T*>(a.c);
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
  for (int n0 = 0; n0 < a.N; n0 += kNT) {
    for (int i = tid; i < kMaxQ * kNT; i += kThreads) {
      const int j = i / kNT, k = i % kNT;
      float bv = 0.f, cv = 0.f;
      if (j < nq && n0 + k < a.N) {
        const long long t = t0 + j;
        bv = rt::to_f(Bm[b * a.b_sb + t * a.b_ss + n0 + k]);
        cv = rt::to_f(Cm[b * a.c_sb + t * a.c_ss + n0 + k]);
      }
      sB[j * kLT + k] = bv;
      sC[j * kLT + k] = cv;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kNT; ++k) {
      float cr[8], br[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        cr[r] = sC[(ty + 16 * r) * kLT + k];
        br[r] = sB[(tx + 16 * r) * kLT + k];
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(cr[r], br[q], acc[r][q]);
    }
    __syncthreads();
  }
  float* G = a.cb + ((long long)b * a.nc + ch) * Q * Q;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = ty + 16 * r;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = tx + 16 * q;
      if (i < Q && j < Q) G[i * Q + j] = acc[r][q];
    }
  }
}

// Pass (a): S = sum_i exp(l_i) dy_i (x) C_i of chunk blockIdx.x, head
// blockIdx.y, row blockIdx.z, into dhs; l_last into lsum.
template <typename T>
__global__ void __launch_bounds__(kThreads) s_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  float* sL = smem;                     // kMaxQ
  float* sDt = sL + kMaxQ;              // kMaxQ
  float* sDy = sDt + kMaxQ;             // kMaxQ x kLD: exp(l_i) dy_i
  float* sC = sDy + kMaxQ * kLD;        // kMaxQ x kLS: a tile of C
  const int k = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const int Q = a.Q, t0 = k * Q, nq = min(Q, a.S - t0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long hb = head_base(a, b, k, hh);
  const T* DY = static_cast<const T*>(a.dy);
  const T* Cm = static_cast<const T*>(a.c);
  chunk_decay(a, b, hh, t0, nq, sDt, sL);
  __syncthreads();
  if (tid == 0) a.lsum[hb] = sL[kMaxQ - 1];
  for (int i = tid; i < kMaxQ * kMaxD; i += kThreads) {
    const int r = i / kMaxD, d = i % kMaxD;
    float v = 0.f;
    if (r < nq && d < a.hd)
      v = rt::to_f(DY[(((long long)b * a.S + t0 + r) * a.nh + hh) * a.hd + d])
          * expf(sL[r]);
    sDy[r * kLD + d] = v;
  }
  float* out = a.dhs + hb * a.hd * a.N;
  // output tile: head dims ty + 16 r (r < 4), state columns n0 + tx + 16 q
  for (int n0 = 0; n0 < a.N; n0 += kSN) {
    __syncthreads();                    // sDy written; the last tile read
    for (int i = tid; i < kMaxQ * kSN; i += kThreads) {
      const int r = i / kSN, n = i % kSN;
      float v = 0.f;
      if (r < nq && n0 + n < a.N)
        v = rt::to_f(Cm[b * a.c_sb + (long long)(t0 + r) * a.c_ss + n0 + n]);
      sC[r * kLS + n] = v;
    }
    __syncthreads();
    float acc[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
    for (int i = 0; i < nq; ++i) {
      float u[4], v[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) u[r] = sDy[i * kLD + ty + 16 * r];
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = sC[i * kLS + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(u[r], v[q], acc[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int d = ty + 16 * r;
      if (d >= a.hd) continue;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int n = n0 + tx + 16 * q;
        if (n < a.N) out[(long long)d * a.N + n] = acc[r][q];
      }
    }
  }
}

// Pass (b): per state element of (row, head), the chunks in reverse:
// dhs[k] holds S_k on entry and dH_k (the gradient of chunk k's exit
// state) on exit; dh0 = exp(l_last,0) dH_0 + S_0.
__global__ void __launch_bounds__(kThreads) dh_kernel(BwdArgs a) {
  const long long per = (long long)a.hd * a.N;
  const long long idx = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (idx >= (long long)a.B * a.nh * per) return;
  const long long bh = idx / per, e = idx % per;
  const int hh = static_cast<int>(bh % a.nh), b = static_cast<int>(bh / a.nh);
  float carry = a.dh_final != nullptr ? a.dh_final[idx] : 0.f;
  for (int k = a.nc - 1; k >= 0; --k) {
    const long long hb = head_base(a, b, k, hh);
    const long long o = hb * per + e;
    const float s = a.dhs[o];
    a.dhs[o] = carry;
    carry = fmaf(expf(a.lsum[hb]), carry, s);
  }
  if (a.dh0 != nullptr) a.dh0[idx] = carry;
}

inline size_t main_smem_floats() {
  return 6 * kMaxQ + kMaxQ * kLQ + 2 * kMaxQ * kLD + 2 * kMaxQ * kLT
         + 2 * kMaxD * kLT + 32 * kLR + 32 + kMaxQ;
}

// Pass (c): everything else of chunk blockIdx.x, head blockIdx.y, row
// blockIdx.z: dx, ddt, this head's dB and dC, the chunk's da partial.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) main_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  float* sL = smem;                     // kMaxQ: l
  float* sDt = sL + kMaxQ;              // kMaxQ: dt (0 past nq)
  float* sEl = sDt + kMaxQ;             // kMaxQ: exp(l)
  float* sW = sEl + kMaxQ;              // kMaxQ: w = exp(l_last - l)
  float* sWdt = sW + kMaxQ;             // kMaxQ: w dt
  float* sDl = sWdt + kMaxQ;            // kMaxQ: dl
  float* sQQ = sDl + kMaxQ;             // kMaxQ x kLQ: E o P, then M
  float* sX = sQQ + kMaxQ * kLQ;        // kMaxQ x kLD: x
  float* sDy = sX + kMaxQ * kLD;        // kMaxQ x kLD: dy
  float* sBt = sDy + kMaxQ * kLD;       // kMaxQ x kLT: a tile of B
  float* sCt = sBt + kMaxQ * kLT;       // kMaxQ x kLT: a tile of C
  float* sHi = sCt + kMaxQ * kLT;       // kMaxD x kLT: a tile of h_in
  float* sHd = sHi + kMaxD * kLT;       // kMaxD x kLT: a tile of dH
  float* sRed = sHd + kMaxD * kLT;      // 32 x kLR: partial row sums
  float* sMisc = sRed + 32 * kLR;       // 32: warp sums
  float* sWj = sMisc + 32;              // kMaxQ: W_j
  const int k = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const int Q = a.Q, t0 = k * Q, nq = min(Q, a.S - t0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const long long hb = head_base(a, b, k, hh);
  const long long st = hb * a.hd * a.N;           // this head's hd x N
  const T* X = static_cast<const T*>(a.x);
  const T* DY = static_cast<const T*>(a.dy);
  const T* Bm = static_cast<const T*>(a.b);
  const T* Cm = static_cast<const T*>(a.c);
  const float* G = a.cb + ((long long)b * a.nc + k) * Q * Q;

  chunk_decay(a, b, hh, t0, nq, sDt, sL);
  for (int i = tid; i < kMaxQ * kMaxD; i += kThreads) {
    const int r = i / kMaxD, d = i % kMaxD;
    float xv = 0.f, gv = 0.f;
    if (r < nq && d < a.hd) {
      const long long t = t0 + r;
      xv = rt::to_f(X[b * a.x_sb + t * a.x_ss + hh * a.x_sh + d]);
      gv = rt::to_f(DY[(((long long)b * a.S + t) * a.nh + hh) * a.hd + d]);
    }
    sX[r * kLD + d] = xv;
    sDy[r * kLD + d] = gv;
  }
  __syncthreads();
  const float l_last = sL[kMaxQ - 1], e_last = expf(l_last);
  if (tid < kMaxQ) {
    const float w = expf(l_last - sL[tid]);
    sEl[tid] = expf(sL[tid]);
    sW[tid] = w;
    sWdt[tid] = w * sDt[tid];
    sDl[tid] = 0.f;
  }

  // 1. P_ij = dy_i . x_j dt_j; sQQ = E o P; row and column sums of
  //    T = G o E o P into dl
  {
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
    for (int d = 0; d < a.hd; ++d) {
      float u[8], v[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) u[r] = sDy[(ty + 16 * r) * kLD + d];
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = sX[(tx + 16 * q) * kLD + d];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(u[r], v[q], acc[r][q]);
    }
    float cs[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) cs[q] = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
      float rs = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int j = tx + 16 * q;
        float tt = 0.f;
        if (j <= i && i < nq) {
          tt = acc[r][q] * sDt[j] * expf(sL[i] - sL[j]);
          const float t = tt * G[i * Q + j];
          rs += t;
          cs[q] += t;
        }
        sQQ[i * kLQ + j] = tt;
      }
      sRed[tx * kLR + i] = rs;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) sRed[(16 + ty) * kLR + tx + 16 * q] = cs[q];
  }
  __syncthreads();
  if (tid < kMaxQ) {
    float rs = 0.f, cs = 0.f;
    for (int w = 0; w < 16; ++w) {
      rs += sRed[w * kLR + tid];
      cs += sRed[(16 + w) * kLR + tid];
    }
    sDl[tid] += rs - cs;
  }

  // 2. by tiles of kNT state columns: this head's dC and dB, and (over all
  //    tiles) dhb = dH B_j and hc = h_in C_i (rows ty + 16 r, head dims
  //    tx + 16 q) and this thread's share of <dH, h_in>
  float dhb[8][4], hc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) dhb[r][q] = hc[r][q] = 0.f;
  float hdot = 0.f;
  const long long pq = hb * Q * a.N;              // this head's Q x N
  for (int n0 = 0; n0 < a.N; n0 += kNT) {
    const int nk = min(kNT, a.N - n0);
    __syncthreads();                    // the previous tile is read
    for (int i = tid; i < kMaxQ * kNT; i += kThreads) {
      const int j = i / kNT, n = i % kNT;
      float bv = 0.f, cv = 0.f;
      if (j < nq && n < nk) {
        const long long t = t0 + j;
        bv = rt::to_f(Bm[b * a.b_sb + t * a.b_ss + n0 + n]);
        cv = rt::to_f(Cm[b * a.c_sb + t * a.c_ss + n0 + n]);
      }
      sBt[j * kLT + n] = bv;
      sCt[j * kLT + n] = cv;
    }
    for (int i = tid; i < kMaxD * kNT; i += kThreads) {
      const int d = i / kNT, n = i % kNT;
      float hv = 0.f, gv = 0.f;
      if (d < a.hd && n < nk) {
        hv = a.states[st + (long long)d * a.N + n0 + n];
        gv = a.dhs[st + (long long)d * a.N + n0 + n];
      }
      sHi[d * kLT + n] = hv;
      sHd[d * kLT + n] = gv;
      hdot = fmaf(hv, gv, hdot);
    }
    __syncthreads();
    // dC_i = sum_j (E o P)_ij B_j + exp(l_i) h_in^T dy_i,
    // dB_j = sum_i (E o P)_ij C_i + w_j dt_j dH^T x_j  (columns tx + 16 q)
    float pc[8][2], pb[8][2];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 2; ++q) pc[r][q] = pb[r][q] = 0.f;
    for (int j = 0; j < nq; ++j) {
      float u[8], u2[8], v[2], v2[2];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        u[r] = sQQ[(ty + 16 * r) * kLQ + j];
        u2[r] = sQQ[j * kLQ + ty + 16 * r];
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        v[q] = sBt[j * kLT + tx + 16 * q];
        v2[q] = sCt[j * kLT + tx + 16 * q];
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          pc[r][q] = fmaf(u[r], v[q], pc[r][q]);
          pb[r][q] = fmaf(u2[r], v2[q], pb[r][q]);
        }
    }
    float el[8], wd[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      el[r] = sEl[ty + 16 * r];
      wd[r] = sWdt[ty + 16 * r];
    }
    for (int d = 0; d < a.hd; ++d) {
      float u[8], u2[8], v[2], v2[2];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        u[r] = sDy[(ty + 16 * r) * kLD + d] * el[r];
        u2[r] = sX[(ty + 16 * r) * kLD + d] * wd[r];
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        v[q] = sHi[d * kLT + tx + 16 * q];
        v2[q] = sHd[d * kLT + tx + 16 * q];
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          pc[r][q] = fmaf(u[r], v[q], pc[r][q]);
          pb[r][q] = fmaf(u2[r], v2[q], pb[r][q]);
        }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
      if (i >= nq) continue;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int n = tx + 16 * q;
        if (n < nk) {
          a.pdc[pq + (long long)i * a.N + n0 + n] = pc[r][q];
          a.pdb[pq + (long long)i * a.N + n0 + n] = pb[r][q];
        }
      }
    }
    for (int n = 0; n < nk; ++n) {
      float ub[8], uc[8], vd[4], vh[4];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        ub[r] = sBt[(ty + 16 * r) * kLT + n];
        uc[r] = sCt[(ty + 16 * r) * kLT + n];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        vd[q] = sHd[(tx + 16 * q) * kLT + n];
        vh[q] = sHi[(tx + 16 * q) * kLT + n];
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dhb[r][q] = fmaf(ub[r], vd[q], dhb[r][q]);
          hc[r][q] = fmaf(uc[r], vh[q], hc[r][q]);
        }
    }
  }
  // <dH, h_in>: warp sums, then warp order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    hdot += __shfl_xor_sync(0xffffffffu, hdot, off);
  __syncthreads();                      // every warp is done with sQQ
  if (lane == 0) sMisc[warp] = hdot;
  // 3. dl_i += exp(l_i) dy_i . hc_i and -= W_i, W_j = w_j dt_j x_j . dhb_j;
  //    sQQ = M = G o E
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = ty + 16 * r;
    float ra = 0.f, rw = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      ra = fmaf(sDy[i * kLD + tx + 16 * q], hc[r][q], ra);
      rw = fmaf(sX[i * kLD + tx + 16 * q], dhb[r][q], rw);
    }
    sRed[tx * kLR + i] = ra * sEl[i];
    sRed[(16 + tx) * kLR + i] = rw * sWdt[i];
  }
  for (int i = tid; i < kMaxQ * kMaxQ; i += kThreads) {
    const int r = i / kMaxQ, j = i % kMaxQ;
    float v = 0.f;
    if (j <= r && r < nq) v = G[r * Q + j] * expf(sL[r] - sL[j]);
    sQQ[r * kLQ + j] = v;
  }
  __syncthreads();
  if (tid < kMaxQ) {
    float ra = 0.f, rw = 0.f;
    for (int w = 0; w < 16; ++w) {
      ra += sRed[w * kLR + tid];
      rw += sRed[(16 + w) * kLR + tid];
    }
    sDl[tid] += ra - rw;
    sWj[tid] = rw;
  }
  __syncthreads();
  if (tid == 0 && nq > 0) {
    float wsum = 0.f, hsum = 0.f;
    for (int j = 0; j < nq; ++j) wsum += sWj[j];
    for (int w = 0; w < kThreads / 32; ++w) hsum += sMisc[w];
    sDl[nq - 1] += fmaf(e_last, hsum, wsum);
  }
  // 4. dxdt_j = sum_i M_ij dy_i + w_j dhb_j (rows j = ty + 16 r, head dims
  //    tx + 16 q); dx = dxdt dt; the row sums of dxdt o x
  float dxa[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) dxa[r][q] = 0.f;
  for (int i = 0; i < nq; ++i) {
    float u[8], v[4];
#pragma unroll
    for (int r = 0; r < 8; ++r) u[r] = sQQ[i * kLQ + ty + 16 * r];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = sDy[i * kLD + tx + 16 * q];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) dxa[r][q] = fmaf(u[r], v[q], dxa[r][q]);
  }
  T* DX = static_cast<T*>(a.dx);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int j = ty + 16 * r;
    const float wj = sW[j], dtj = sDt[j];
    float rs = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int d = tx + 16 * q;
      const float g = fmaf(wj, dhb[r][q], dxa[r][q]);
      rs = fmaf(g, sX[j * kLD + d], rs);
      if (j < nq && d < a.hd)
        DX[(((long long)b * a.S + t0 + j) * a.nh + hh) * a.hd + d] =
            rt::from_f<T>(g * dtj);
    }
    sRed[tx * kLR + j] = rs;
  }
  __syncthreads();
  // 5. warp 0: g = reverse cumsum of dl; ddt = g a + sum_d dxdt x;
  //    da partial = sum_j g_j dt_j
  if (warp == 0) {
    float v[4], suf[4], run = 0.f;
#pragma unroll
    for (int e = 3; e >= 0; --e) {
      v[e] = sDl[lane * 4 + e];
      run += v[e];
      suf[e] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl += o;
    }
    const float after = incl - run;     // dl of the lanes after this one
    const float ah = a.a[hh];
    float dap = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = lane * 4 + e;
      const float g = after + suf[e];
      dap = fmaf(g, sDt[j], dap);
      if (j < nq) {
        float rs = 0.f;
        for (int w = 0; w < 16; ++w) rs += sRed[w * kLR + j];
        a.ddt[((long long)b * a.S + t0 + j) * a.nh + hh] = fmaf(g, ah, rs);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dap += __shfl_xor_sync(0xffffffffu, dap, off);
    if (lane == 0) a.pda[hb] = dap;
  }
}

// Pass (d): dB and dC of position t, column n: the heads' partials summed
// in head order.
template <typename T>
__global__ void __launch_bounds__(kThreads) reduce_kernel(BwdArgs a) {
  const long long idx = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (idx >= (long long)a.B * a.S * a.N) return;
  const int n = static_cast<int>(idx % a.N);
  const long long bt = idx / a.N;
  const int t = static_cast<int>(bt % a.S), b = static_cast<int>(bt / a.S);
  const int k = t / a.Q, i = t % a.Q;
  const long long qn = (long long)a.Q * a.N;
  const long long base = head_base(a, b, k, 0) * qn + (long long)i * a.N + n;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < a.nh; ++h) {
    sb += a.pdb[base + h * qn];
    sc += a.pdc[base + h * qn];
  }
  static_cast<T*>(a.db)[idx] = rt::from_f<T>(sb);
  static_cast<T*>(a.dc)[idx] = rt::from_f<T>(sc);
}

template <typename T>
cudaError_t run(const BwdArgs& a, cudaStream_t s) {
  cudaError_t e = rt::launch<cb_kernel<T>>(
      dim3(a.nc, a.B), kThreads, 2 * kMaxQ * kLT * sizeof(float), a, s);
  if (e != cudaSuccess) return e;
  e = rt::launch<s_kernel<T>>(
      dim3(a.nc, a.nh, a.B), kThreads,
      (2 * kMaxQ + kMaxQ * kLD + kMaxQ * kLS) * sizeof(float), a, s);
  if (e != cudaSuccess) return e;
  const long long ne = (long long)a.B * a.nh * a.hd * a.N;
  e = rt::launch<dh_kernel>(dim3((ne + kThreads - 1) / kThreads), kThreads,
                            0, a, s);
  if (e != cudaSuccess) return e;
  e = rt::launch<main_kernel<T>>(dim3(a.nc, a.nh, a.B), kThreads,
                                 main_smem_floats() * sizeof(float), a, s);
  if (e != cudaSuccess) return e;
  const long long nr = (long long)a.B * a.S * a.N;
  return rt::launch<reduce_kernel<T>>(dim3((nr + kThreads - 1) / kThreads),
                                      kThreads, 0, a, s);
}

}  // namespace ssd_bwd

// SM count of the current device, read once per device
int sm_count() {
  static int cached[64] = {};
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0) return 0;
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (dev < 64) cached[dev] = n;
  return n;
}

struct Plan {
  bool sm90;            // the tensor-core body
  int group, ngroups;   // its heads per CTA, and CTAs per chunk
  long long work;       // fp32 scratch floats
};

// The body and scratch of a launch with these arguments. The route rule
// is the forward's (ssd_scan.cu): the tensor-core body copies 16-byte
// pieces of x, B and C rows, so `aligned` says whether their data starts
// on 16 bytes. Its heads per CTA come from the SM count. Returns false on
// arguments the kernels do not take or a device it cannot read.
bool plan_of(int B, int S, int nh, int hd, int N, int Q, bool aligned,
             long long x_sb, long long x_ss, long long x_sh, long long b_sb,
             long long b_ss, long long c_sb, long long c_ss, int is_bf16,
             Plan* p) {
  using namespace ssd_bwd;
  if (Q < 1 || Q > kMaxQ || N < 1 || N > kMaxN || hd < 1 || hd > kMaxD
      || B < 1 || S < 1 || nh < 1)
    return false;
  const long long nc = (S + Q - 1) / Q;
  const long long state = (long long)B * nc * nh * hd * N;
  p->sm90 = is_bf16 && hd % 8 == 0 && N % 8 == 0 && aligned
            && x_sb % 8 == 0 && x_ss % 8 == 0 && x_sh % 8 == 0
            && b_sb % 8 == 0 && b_ss % 8 == 0 && c_sb % 8 == 0
            && c_ss % 8 == 0;
  if (!p->sm90) {
    // cb, dhs, lsum, pdb and pdc
    p->group = 1;
    p->ngroups = nh;
    p->work = B * nc * Q * Q + state + B * nc * nh
              + 2LL * B * nc * nh * Q * N;
    return true;
  }
  const int sms = sm_count();
  if (sms <= 0) return false;
  p->group = rt::ssd_bwd_sm90::group_of(B, static_cast<int>(nc), nh, sms);
  p->ngroups = (nh + p->group - 1) / p->group;
  // dH per chunk, and with more than one group their dB / dC shares
  p->work = state + (p->ngroups > 1 ? 2LL * B * nc * p->ngroups * Q * N : 0);
  return true;
}

}  // namespace

// out[0] = 1 for the tensor-core body (0: the CUDA-core one), out[1] its
// heads per CTA, out[2] the fp32 floats of scratch (`work`) the launch
// with the same arguments takes. `aligned`: x, B and C start on 16 bytes.
extern "C" int rt_ssd_scan_bwd_plan(
    int aligned, int B, int S, int nh, int hd, int N, int Q, long long x_sb,
    long long x_ss, long long x_sh, long long b_sb, long long b_ss,
    long long c_sb, long long c_ss, int is_bf16, long long* out) {
  Plan p;
  if (!plan_of(B, S, nh, hd, N, Q, aligned != 0, x_sb, x_ss, x_sh, b_sb,
               b_ss, c_sb, c_ss, is_bf16, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  out[0] = p.sm90;
  out[1] = p.group;
  out[2] = p.work;
  return 0;
}

// `work`: fp32 scratch of the size rt_ssd_scan_bwd_plan gives; `pda`: the
// (B, n_chunks, nh) da partials the wrapper sums.
extern "C" int rt_ssd_scan_bwd(
    const void* x, const void* dt, const void* a, const void* b,
    const void* c, const void* dy, const void* states, const void* dh_final,
    void* dx, void* ddt, void* db, void* dc, void* dh0, void* pda,
    void* work, int B, int S, int nh, int hd, int N, int Q, long long x_sb,
    long long x_ss, long long x_sh, long long dt_sb, long long dt_ss,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    int is_bf16, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  auto al16 = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  Plan p;
  if (!plan_of(B, S, nh, hd, N, Q, al16(x) && al16(b) && al16(c), x_sb,
               x_ss, x_sh, b_sb, b_ss, c_sb, c_ss, is_bf16, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = (S + Q - 1) / Q;
  float* w = static_cast<float*>(work);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.sm90) {
    const long long state = (long long)B * nc * nh * hd * N;
    const rt::ssd_bwd_sm90::Args sa{
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(a), static_cast<const __nv_bfloat16*>(b),
        static_cast<const __nv_bfloat16*>(c),
        static_cast<const __nv_bfloat16*>(dy),
        static_cast<const float*>(states),
        static_cast<const float*>(dh_final),
        static_cast<__nv_bfloat16*>(dx), static_cast<float*>(ddt),
        static_cast<__nv_bfloat16*>(db), static_cast<__nv_bfloat16*>(dc),
        static_cast<float*>(dh0), static_cast<float*>(pda), w,
        p.ngroups > 1 ? w + state : nullptr, B, S, nh, hd, N, Q, nc,
        p.group, p.ngroups,
        x_sb, x_ss, x_sh, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss};
    return static_cast<int>(rt::ssd_bwd_sm90::run(sa, st));
  }
  // the CUDA-core body's scratch, in the order plan_of counts it
  float* cb = w;
  float* dhs = cb + (long long)B * nc * Q * Q;
  float* lsum = dhs + (long long)B * nc * nh * hd * N;
  float* pdb = lsum + (long long)B * nc * nh;
  float* pdc = pdb + (long long)B * nc * nh * Q * N;
  const ssd_bwd::BwdArgs args{
      x, static_cast<const float*>(dt), static_cast<const float*>(a), b, c,
      dy, static_cast<const float*>(states),
      static_cast<const float*>(dh_final), dx, static_cast<float*>(ddt), db,
      dc, static_cast<float*>(dh0), cb, dhs, lsum, pdb, pdc,
      static_cast<float*>(pda), B, S, nh, hd, N, Q, nc,
      x_sb, x_ss, x_sh, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss};
  const cudaError_t e = is_bf16 ? ssd_bwd::run<__nv_bfloat16>(args, st)
                                : ssd_bwd::run<float>(args, st);
  return static_cast<int>(e);
}

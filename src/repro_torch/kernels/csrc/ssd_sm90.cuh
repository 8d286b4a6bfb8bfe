// Tensor-core body of the Mamba2 SSD chunked scan for Hopper (sm_90a): the
// path ssd_scan.cu takes for bf16 x / B / C whose rows are 16-byte aligned
// (head dim and state width multiples of 8).
//
// Per chunk of Q <= 128 positions (l = cumsum(dt a), kept as L = l log2 e):
//   y = M (x dt) + 2^L o (C h^T),  M = (C B^T) o 2^{L_i - L_j} o [j <= i]
//   h <- h 2^{L_last} + (x dt 2^{L_last - L})^T B
// Bound at the serving shapes: bytes (x, y, B, C, dt and the state once
// each). The Pallas grid (B, nh, chunks) ran the chunk axis in order with
// h in VMEM; here the same order runs inside one CTA.
//
// One CTA per (64-wide head-dim slice, head, row), 8 warps, walks the
// chunks in order with the state on chip: h (64 x N) in fp32 registers as
// mma accumulators (warp w: head dims 16 (w % 4)..+16, half w / 4 of the
// state columns), and an fp32 copy in shared memory for C h^T. A chunk-
// parallel split would write (B, nc, nh, hd, N) states, 134 MB in fp32 at
// mamba2's (4, 2048, 64 heads of 64, N 128) against the 149 MB the whole
// bound moves; B nh CTAs (256 for mamba2, 320 for zamba2) already fill the
// 132 SMs. Per chunk:
//  * x, B, C and dt of chunk c + 1 land by 16-byte cp.async (4 bytes for
//    dt) in the second of two buffers while chunk c computes (one buffer at
//    N > 128, where two do not fit; its next chunk loads after the last
//    product). Rows past S are zero-filled: dt = 0 there, an exact no-op
//    for the state, and no y is written. x, B and C are read in place
//    through their strides (views of one conv output).
//  * Shared rows of x, B and C are 16-byte pieces XOR-swizzled by row % 8,
//    so every ldmatrix (eight rows, one piece each) hits eight bank groups;
//    the fp32 state rows are padded by 8 floats for the same reason.
//  * Each warp scans dt a itself into its own copy of L (no CTA barrier).
//  * y rows: warp w takes 16-row tiles p = w % 4 and 7 - p (9 blocks of the
//    causal M each) and 32 of the 64 head dims. C h^T first, rows scaled by
//    2^L_i; then block by block, G = C B^T (bf16 mma of the exact inputs,
//    fp32 sums) becomes M in registers (decay, mask) and multiplies x dt.
//  * The state update: A = (x dt w)^T, B = B, both by ldmatrix.trans.
// Precision: the products whose operands are computed (M, x dt, x dt w and
// h) run as tf32 m16n8k8 with fp32 accumulators, their operands rounded
// once from fp32; x, B and C enter exactly (bf16 is a subset of tf32). With
// all four products on bf16 operands instead (G stored as bf16 once per
// chunk and shared by the heads), y was 3.6e-2 off the fp32 plain version
// at mamba2's shape on the card (chip_smoke.py; the bf16 plain version's
// own error, the rounding of y, is 1.6e-2), past the bf16 tolerance of
// atol 5e-3 / rtol 2e-2. G is then recomputed per head in fp32 sums: kept
// once per chunk in fp32, the nine blocks a warp needs would take 72
// registers or 36 KB more shared memory than the buffers leave, and the
// recompute is about a third of the mma work.
// Latency: with one CTA an SM the body is latency-bound, so the k loops
// unroll to their compile-time bounds (loads hoisted across steps), and
// tf32 rounding is an integer add (rt::tf32) rather than a conversion.
// Sixteen warps a CTA recompute G four times over and ran slower.
#pragma once

#include "warp_mma.cuh"

namespace rt {
namespace ssd {

constexpr int kQ = 128;             // chunk rows staged (Q <= 128)
constexpr int kHD = 64;             // head dims per CTA
constexpr int kWarps = 8;           // see the note on latency
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const __nv_bfloat16* x;
  const float* dt;
  const float* a;
  const __nv_bfloat16* b;
  const __nv_bfloat16* c;
  const float* h0;          // nullptr: zero initial state
  __nv_bfloat16* y;
  float* h;
  int B, S, nh, hd, N, Q, nc;
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss;
};

// NT: the state width of an instantiation (N <= NT, columns past N zero)
template <int NT>
__host__ __device__ constexpr int nbuf() { return NT <= 128 ? 2 : 1; }
template <int NT>
__host__ __device__ constexpr int h_row() { return NT + 8; }   // floats
template <int NT>
__host__ __device__ constexpr uint32_t chunk_bytes() {
  return kQ * kHD * 2 + 2 * kQ * NT * 2 + kQ * 4;   // x, B, C, dt
}
template <int NT>
__host__ __device__ constexpr size_t smem_bytes() {
  return nbuf<NT>() * (size_t)chunk_bytes<NT>()
         + (size_t)kHD * h_row<NT>() * 4            // h, fp32
         + (size_t)kWarps * kQ * 4;                 // per-warp L
}

// byte offset of 16-byte piece `pc` of row `row` in rows of `rb` bytes
// (rb >= 128), pieces XOR-swizzled by row % 8
__device__ __forceinline__ uint32_t swz(int row, int pc, int rb) {
  return row * rb + ((pc ^ (row & 7)) << 4);
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// x (this CTA's 64 head dims), B, C and dt of positions [t0, t0 + nq) of
// batch row b into the chunk buffer at `buf`; rows past nq zero-filled
template <int NT>
__device__ __forceinline__ void load_chunk(const Args& a, uint32_t buf,
                                           int b, int hh, int d0, int t0,
                                           int nq) {
  for (int i = threadIdx.x; i < kQ * 8; i += 32 * kWarps) {
    const int j = i / 8, pc = i % 8;
    const bool ok = j < nq && d0 + 8 * pc < a.hd;
    const __nv_bfloat16* src =
        ok ? a.x + b * a.x_sb + (t0 + j) * a.x_ss + hh * a.x_sh + d0 + 8 * pc
           : a.x;
    cp_async16(buf + swz(j, pc, kHD * 2), src, ok ? 16 : 0);
  }
  constexpr int NP = NT / 8;
  const uint32_t sB = buf + kQ * kHD * 2, sC = sB + kQ * NT * 2;
  for (int i = threadIdx.x; i < kQ * NP; i += 32 * kWarps) {
    const int j = i / NP, pc = i % NP;
    const bool ok = j < nq && 8 * pc < a.N;
    const long long t = t0 + j;
    const uint32_t o = swz(j, pc, NT * 2);
    cp_async16(sB + o, ok ? a.b + b * a.b_sb + t * a.b_ss + 8 * pc : a.b,
               ok ? 16 : 0);
    cp_async16(sC + o, ok ? a.c + b * a.c_sb + t * a.c_ss + 8 * pc : a.c,
               ok ? 16 : 0);
  }
  const uint32_t sDt = sC + kQ * NT * 2;
  for (int j = threadIdx.x; j < kQ; j += 32 * kWarps) {
    const bool ok = j < nq;
    cp_async4(sDt + 4 * j,
              ok ? a.dt + b * a.dt_sb + (t0 + j) * a.dt_ss + hh : a.dt,
              ok ? 4 : 0);
  }
}

// d += (A: a bf16 k16 fragment pair, split into two tf32 k8 steps) times
// the tf32 B steps (b0, b1) and (b2, b3)
__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t (&s0)[4],
                                        const uint32_t (&s1)[4], uint32_t b0,
                                        uint32_t b1, uint32_t b2,
                                        uint32_t b3) {
  mma1688(d, s0, b0, b1);
  mma1688(d, s1, b2, b3);
}

template <int NT>
__global__ void __launch_bounds__(32 * kWarps, 1) scan_kernel(Args a) {
  constexpr int NB = nbuf<NT>();
  constexpr int QD = kWarps / 4;              // warps sharing a row tile
  constexpr int DY = kHD / QD;                // y columns per warp
  constexpr int NY = DY / 8;                  // y n-tiles per warp
  constexpr int NH = NT / QD / 8;             // state n-tiles per warp
  constexpr int HR = h_row<NT>();
  constexpr uint32_t kXB = kQ * kHD * 2, kBB = kQ * NT * 2;
  constexpr uint32_t kChunk = chunk_bytes<NT>();
  extern __shared__ __align__(128) uint8_t ssd_smem[];
  const uint32_t s0 = smem_u32(ssd_smem);
  float* hs = reinterpret_cast<float*>(ssd_smem + NB * kChunk);  // h fp32
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int r = lane / 4, c = 2 * (lane % 4), p = w % 4, hf = w / 4;
  float* L = reinterpret_cast<float*>(ssd_smem + NB * kChunk +
                                      kHD * HR * 4) + w * kQ;
  const int d0 = blockIdx.x * kHD, hh = blockIdx.y, b = blockIdx.z;
  const int Q = a.Q, qb = (Q + 15) / 16, nks = (a.N + 15) / 16;
  const float al2 = a.a[hh] * kLog2e;
  const long long hrow = ((long long)b * a.nh + hh) * a.hd + d0;
  const int n0 = hf * (NT / QD);              // this warp's state columns

  // the state: rows d = 16 p + r (+ 8), columns n0 + 8 nt + c (+ 1)
  float h[NH][4];
#pragma unroll
  for (int nt = 0; nt < NH; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 16 * p + r + 8 * (e / 2), n = n0 + 8 * nt + c + e % 2;
      h[nt][e] = a.h0 != nullptr && d0 + d < a.hd && n < a.N
                     ? a.h0[(hrow + d) * a.N + n] : 0.f;
    }
  auto store_h = [&]() {
#pragma unroll
    for (int nt = 0; nt < NH; ++nt)
#pragma unroll
      for (int e = 0; e < 4; e += 2)
        *reinterpret_cast<float2*>(
            hs + (16 * p + r + 4 * e) * HR + n0 + 8 * nt + c) =
            make_float2(h[nt][e], h[nt][e + 1]);
  };
  store_h();
  auto buf_of = [&](int ch) -> uint32_t {
    return s0 + (NB == 2 ? (ch & 1) : 0) * kChunk;
  };
  if (a.nc > 0) load_chunk<NT>(a, buf_of(0), b, hh, d0, 0, min(Q, a.S));
  cp_async_commit();

  for (int ch = 0; ch < a.nc; ++ch) {
    const int t0 = ch * Q, nq = min(Q, a.S - t0);
    if constexpr (NB == 2) {
      if (ch + 1 < a.nc)
        load_chunk<NT>(a, buf_of(ch + 1), b, hh, d0, t0 + Q,
                       min(Q, a.S - t0 - Q));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();            // chunk ch landed; hs holds the old state
    const uint32_t bx = buf_of(ch), bB = bx + kXB, bC = bB + kBB;
    const float* dtc = reinterpret_cast<const float*>(
        ssd_smem + (bx - s0) + kXB + 2 * kBB);

    // L = cumsum(dt a) log2 e, this warp's copy (rows past nq: dt = 0)
    {
      float v[4], run = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        run += dtc[4 * lane + e] * al2;
        v[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) L[4 * lane + e] = incl - run + v[e];
      __syncwarp();
    }

    // y tiles m = 0, 1: rows 16 mt + r (+ 8) for mt = p, 7 - p; columns
    // DY hf + 8 nt + c (+ 1)
    float y[2][NY][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int nt = 0; nt < NY; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) y[m][nt][e] = 0.f;
    const bool two = 7 - p < qb;          // the second row tile exists
    // C h^T: A = C (exact), B = h^T from the fp32 copy. The k loops run
    // to their compile-time bound and break early, so they unroll and the
    // scheduler can hoist loads across steps (the body is latency-bound)
#pragma unroll (NT <= 128 ? NT / 16 : 4)
    for (int ks = 0; ks < NT / 16; ++ks) {
      if (ks >= nks) break;
      uint32_t as[2][2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int mt = m == 0 ? p : 7 - p;
        uint32_t f[4];
        ldsm_x4(f, bC + swz(16 * mt + ((lane / 8) % 2) * 8 + lane % 8,
                            2 * ks + lane / 16, NT * 2));
        const uint32_t s0_[4] = {lo_bits(f[0]), lo_bits(f[1]), hi_bits(f[0]),
                                 hi_bits(f[1])};
        const uint32_t s1_[4] = {lo_bits(f[2]), lo_bits(f[3]), hi_bits(f[2]),
                                 hi_bits(f[3])};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          as[m][0][e] = s0_[e];
          as[m][1][e] = s1_[e];
        }
      }
#pragma unroll
      for (int nt = 0; nt < NY; ++nt) {
        const float* hp = hs + (DY * hf + 8 * nt + r) * HR + 16 * ks + c;
        const float2 h01 = *reinterpret_cast<const float2*>(hp);
        const float2 h89 = *reinterpret_cast<const float2*>(hp + 8);
        const uint32_t b0 = tf32(h01.x), b1 = tf32(h01.y);
        const uint32_t b2 = tf32(h89.x), b3 = tf32(h89.y);
        if (p < qb) mma_k16(y[0][nt], as[0][0], as[0][1], b0, b1, b2, b3);
        if (two) mma_k16(y[1][nt], as[1][0], as[1][1], b0, b1, b2, b3);
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int mt = m == 0 ? p : 7 - p;
      const float ea = ex2(L[16 * mt + r]), eb = ex2(L[16 * mt + r + 8]);
#pragma unroll
      for (int nt = 0; nt < NY; ++nt) {
        y[m][nt][0] *= ea;
        y[m][nt][1] *= ea;
        y[m][nt][2] *= eb;
        y[m][nt][3] *= eb;
      }
    }
    // + M (x dt), block (mt, kb) by block: (p, 0..p), then (7 - p, 0..7-p)
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      const bool first = q <= p;
      const int mt = first ? p : 7 - p, kb = first ? q : q - p - 1;
      if (mt >= qb) continue;
      // G = C B^T of the block: bf16 mma of exact inputs, fp32 sums
      float g[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll (NT <= 128 ? NT / 16 : 4)
      for (int ks = 0; ks < NT / 16; ++ks) {
        if (ks >= nks) break;
        uint32_t af[4], bf[4];
        ldsm_x4(af, bC + swz(16 * mt + ((lane / 8) % 2) * 8 + lane % 8,
                             2 * ks + lane / 16, NT * 2));
        ldsm_x4(bf, bB + swz(16 * kb + (lane / 16) * 8 + lane % 8,
                             2 * ks + (lane / 8) % 2, NT * 2));
        mma16816(g[0], af, bf[0], bf[1]);
        mma16816(g[1], af, bf[2], bf[3]);
      }
      // M = G 2^{L_i - L_j} [j <= i] as two tf32 k8 steps: step s holds
      // columns 16 kb + 8 s + c (k' = t) and + 1 (k' = t + 4)
      const int i0 = 16 * mt + r;
      const float li = L[i0], li8 = L[i0 + 8];
      uint32_t ms[2][4];
      float dts[2][2];
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        const int j = 16 * kb + 8 * st + c;
        const float lj0 = L[j], lj1 = L[j + 1];
        auto dec = [&](float l_i, int i, float l_j, int jj) {
          return jj <= i ? ex2(l_i - l_j) : 0.f;
        };
        ms[st][0] = tf32(g[st][0] * dec(li, i0, lj0, j));
        ms[st][1] = tf32(g[st][2] * dec(li8, i0 + 8, lj0, j));
        ms[st][2] = tf32(g[st][1] * dec(li, i0, lj1, j + 1));
        ms[st][3] = tf32(g[st][3] * dec(li8, i0 + 8, lj1, j + 1));
        dts[st][0] = dtc[j];
        dts[st][1] = dtc[j + 1];
      }
      // x dt: B fragments from x (ldmatrix.trans), scaled by dt in fp32
#pragma unroll
      for (int pr = 0; pr < NY / 2; ++pr) {
        uint32_t xf[4];
        ldsm_x4_t(xf, bx + swz(16 * kb + ((lane / 8) % 2) * 8 + lane % 8,
                               DY / 8 * hf + 2 * pr + lane / 16, kHD * 2));
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const uint32_t f0 = xf[2 * u], f1 = xf[2 * u + 1];
          const uint32_t b0 = tf32(lo_f(f0) * dts[0][0]);
          const uint32_t b1 = tf32(hi_f(f0) * dts[0][1]);
          const uint32_t b2 = tf32(lo_f(f1) * dts[1][0]);
          const uint32_t b3 = tf32(hi_f(f1) * dts[1][1]);
          if (first) mma_k16(y[0][2 * pr + u], ms[0], ms[1], b0, b1, b2, b3);
          else mma_k16(y[1][2 * pr + u], ms[0], ms[1], b0, b1, b2, b3);
        }
      }
    }
    // y for rows < nq and head dims < hd
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int mt = m == 0 ? p : 7 - p;
      if (mt >= qb) continue;
#pragma unroll
      for (int nt = 0; nt < NY; ++nt) {
        const int d = DY * hf + 8 * nt + c;
        if (d0 + d >= a.hd) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 16 * mt + r + 8 * half;
          if (i >= nq) continue;
          const long long yo =
              (((long long)b * a.S + t0 + i) * a.nh + hh) * a.hd + d0 + d;
          *reinterpret_cast<uint32_t*>(a.y + yo) =
              pack_bf16(y[m][nt][2 * half], y[m][nt][2 * half + 1]);
        }
      }
    }
    // h = h 2^{L_last} + (x dt 2^{L_last - L})^T B
    const float l_last = L[kQ - 1], e_last = ex2(l_last);
#pragma unroll
    for (int nt = 0; nt < NH; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) h[nt][e] *= e_last;
#pragma unroll
    for (int ks = 0; ks < kQ / 16; ++ks) {
      if (ks >= qb) break;
      uint32_t af[4];
      ldsm_x4_t(af, bx + swz(16 * ks + (lane / 16) * 8 + lane % 8,
                             2 * p + (lane / 8) % 2, kHD * 2));
      // rows d (r, r + 8) x columns j: step s holds 16 ks + 8 s + c (+ 1)
      uint32_t as[2][4];
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        const int j = 16 * ks + 8 * st + c;
        const float u0 = dtc[j] * ex2(l_last - L[j]);
        const float u1 = dtc[j + 1] * ex2(l_last - L[j + 1]);
        const uint32_t fa = af[2 * st], fb = af[2 * st + 1];
        as[st][0] = tf32(lo_f(fa) * u0);
        as[st][1] = tf32(lo_f(fb) * u0);
        as[st][2] = tf32(hi_f(fa) * u1);
        as[st][3] = tf32(hi_f(fb) * u1);
      }
#pragma unroll
      for (int pr = 0; pr < NH / 2; ++pr) {
        uint32_t bf[4];
        ldsm_x4_t(bf, bB + swz(16 * ks + ((lane / 8) % 2) * 8 + lane % 8,
                               n0 / 8 + 2 * pr + lane / 16, NT * 2));
#pragma unroll
        for (int u = 0; u < 2; ++u)
          mma_k16(h[2 * pr + u], as[0], as[1], lo_bits(bf[2 * u]),
                  hi_bits(bf[2 * u]), lo_bits(bf[2 * u + 1]),
                  hi_bits(bf[2 * u + 1]));
      }
    }
    __syncthreads();            // every warp is done with hs and chunk ch
    store_h();
    if constexpr (NB == 1) {
      if (ch + 1 < a.nc)
        load_chunk<NT>(a, buf_of(ch + 1), b, hh, d0, t0 + Q,
                       min(Q, a.S - t0 - Q));
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
  // the final state, fp32
#pragma unroll
  for (int nt = 0; nt < NH; ++nt)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int d = 16 * p + r + 4 * e, n = n0 + 8 * nt + c;
      if (d0 + d < a.hd && n < a.N)
        *reinterpret_cast<float2*>(a.h + (hrow + d) * a.N + n) =
            make_float2(h[nt][e], h[nt][e + 1]);
    }
}

template <int NT>
cudaError_t run(const Args& a, cudaStream_t s) {
  return rt::launch<scan_kernel<NT>>(
      dim3((a.hd + kHD - 1) / kHD, a.nh, a.B), 32 * kWarps,
      smem_bytes<NT>(), a, s);
}

}  // namespace ssd
}  // namespace rt

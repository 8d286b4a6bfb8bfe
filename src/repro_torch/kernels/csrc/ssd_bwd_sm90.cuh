// Tensor-core body of the Mamba2 SSD scan's backward for Hopper (sm_90a):
// the path ssd_scan_bwd.cu takes under the forward's route rule (bf16 x,
// B and C whose rows and strides are 16-byte aligned: head dim and state
// width multiples of 8).
//
// Replaces XLA's gradient of the reference's jnp `ssd_chunked`
// (src/repro/models/ssm.py:70, under jax.value_and_grad; no Pallas
// kernel): the function ssd_scan_bwd.cu's header writes out, with
// L = l log2 e so that every exponential is an exp2 of a difference <= 0.
//
// Bound on the card (chip_smoke.py `ssd_bwd_work`): BYTES at both train
// shapes. Row 9 (mamba2-1.3b: one 2048-token row, 64 heads of 64, N 128,
// Q 128) moves 87.0 MB, 26.0 us at 3.35 TB/s, against 17.2 GFLOP over the
// causal triangles (17.4 us at the bf16 peak, 34.8 us at TF32's); row 9a
// (zamba2-2.7b: 80 heads of 64, N 64) 86.2 MB, 25.7 us, against 12.1
// GFLOP (24.5 us at TF32's). The products are small (k = 16 to 128) and
// many operands are computed, so mma.sync from registers, not wgmma.
//
// What the design does about it: three kernels, no atomics.
//  * rev_kernel, per (row, head, 32 state columns), 4 warps of 16 head
//    dims: walks the chunks backwards with dH (the gradient of the chunk's
//    exit state) in mma accumulators. Per chunk it stores dH_k once, then
//    dH <- 2^L_last dH + S, S = (2^L o dy)^T C on tensor cores (A = dy^T
//    by ldmatrix.trans, scaled per position; B = C) in four partial sums.
//    dy, C and dt of the next two chunks land by cp.async (a ring of
//    three) while this one computes. No S scratch and no dependent
//    load-store chain through device memory.
//  * chunk_kernel, one CTA per (row, chunk, group of g heads), 8 warps,
//    walks its heads in order. g comes from the SM count (`group_of`:
//    the least waves x g, ties to the larger g): 8 at row 9 and 10 at
//    row 9a (128 CTAs on 132 SMs).
//    Phase 1: G^T = B C^T of the chunk once (bf16 mma of exact inputs, its
//    36 causal 16 x 16 blocks kept in shared memory in fragment order),
//    then per head: hc = C h_in^T and dhb = B dH^T streamed over 64-column
//    tiles of B, C, h_in and dH (two cp.async slots), the dl terms,
//    dxdt = M^T dy + w o dhb (M^T = G^T o E^T in registers, row tiles j
//    paired p / 7 - p so every warp takes 9 blocks), dx, ddt and the
//    chunk's da share. The next head's x, dy and dt land during this
//    head's h-tile stream.
//    Phase 2: dB and dC of the group, tile by tile of 64 state columns
//    (warps 0-3 dC, 4-7 dB, `rows_share`; 64 fp32 accumulators a thread
//    summed over the heads in order): EP = E o P (P = dy x^T recomputed by
//    bf16 mma) times B, EP^T times C, plus 2^L dy h_in and w dt x dH. Each
//    head's x, dy, h_in and dH tile lands while the previous head
//    computes.
//  * Latency. With one CTA of 8 warps an SM the kernel is latency-bound
//    (on the card, no one part, cut from a debug build, took most of a
//    call: not phase 2's h-part mma, its exp2s, either phase's per-head
//    loads, nor the hi + lo split), so instructions count: dC and dB are
//    two instantiations of `rows_share` (one runtime branch compiled
//    both, predicated), causal masks are selects on a clamped exp2 rather
//    than branches, columns past N and head dims past hd are zeros in
//    shared memory instead of loop bounds, and no loop unrolls so far
//    that registers spill (250 registers, no spill).
//  * sum_kernel adds the groups' dB / dC shares in group order; with one
//    group phase 2 writes bf16 dB / dC itself and the share is not made.
//  * Precision. Products of exact bf16 inputs (P, G) run as bf16 m16n8k16
//    with fp32 sums. Products with a computed operand run as tf32 m16n8k8;
//    where the result feeds ddt, da, dl or dh0 (held to 1e-4 of their
//    largest element) the computed operand is split hi + lo into two tf32
//    values and both multiply the exact bf16 partner (3xTF32 with a zero
//    lo * lo term): M^T dy, C h_in^T, B dH^T and rev_kernel's S. With one
//    rounding instead, ddt, da and dh0 went past their limits on the
//    card; split, they use about 1% of them (chip_smoke.py phase 3).
//    dB and dC (2^-8 of slack) take one tf32 rounding of each operand.
//  * Shared rows of bf16 tiles are 128 bytes with 16-byte pieces XOR-
//    swizzled by row % 8 (every ldmatrix hits eight bank groups); h_in /
//    dH tiles are 72-float rows with columns XOR 8 on rows with bit 2 set,
//    so both the row-pair reads (phase 1) and the column-pair reads (phase
//    2) hit 32 banks. Shared memory: 221,216 bytes at every N (phase 1:
//    G^T 36 KB, x / dy 32 KB, two 68 KB tile slots; phase 2 aliases it),
//    one CTA an SM. N 64, 128 and 256 differ only in the number of tiles
//    (1, 2, 4); B and C are streamed rather than resident because at N 256
//    they alone would take 128 KB.
//  * Ragged chunks are masked here: rows past S read zeros (dt = 0) and
//    write nothing; x, B, C and dt are strided views read in place.
#pragma once

#include "warp_mma.cuh"

namespace rt {
namespace ssd_bwd_sm90 {   // the kernels' names in a profile

constexpr int kQ = 128;          // chunk rows staged (Q <= 128)
constexpr int kD = 64;           // head dims staged (hd <= 64)
constexpr int kNT = 64;          // state columns of a staged tile
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kHP = kNT + 8;     // floats per staged h_in / dH row
constexpr int kRevCols = 32;     // state columns per rev_kernel CTA
constexpr int kRevWarps = 4;     // one per 16 head dims
constexpr int kRevPitch = 2 * kRevCols + 16;  // bytes per staged C row:
                                 // 80, so eight rows hit eight bank groups
constexpr float kLog2e = 1.4426950408889634f;

// chunk_kernel's shared memory (bytes)
constexpr uint32_t kXB = kQ * kD * 2;          // x or dy of one head
constexpr uint32_t kTB = kQ * kNT * 2;         // a tile of B or C
constexpr uint32_t kHB = kD * kHP * 4;         // a tile of h_in or dH
constexpr uint32_t kGB = 36 * 256 * 4;         // G^T's causal blocks
constexpr uint32_t kDtB = kQ * 4;
// phase 1: G^T | x, dy, dt | two slots of (B, C, h_in, dH) tiles
constexpr uint32_t kAX = kGB, kASlot = kGB + 2 * kXB + kDtB;
constexpr uint32_t kASize = 2 * kTB + 2 * kHB;
// phase 2: B, C tiles | two slots of (x, dy, dt, h_in, dH)
constexpr uint32_t kBSlot = 2 * kTB;
constexpr uint32_t kBSize = 2 * kXB + kDtB + 2 * kHB;
constexpr uint32_t kBig = kASlot + 2 * kASize > kBSlot + 2 * kBSize
                              ? kASlot + 2 * kASize : kBSlot + 2 * kBSize;
// per-warp L, partial sums (3 x [2][kQ], [kQ], [8][kQ]), per-warp sums
constexpr int kSmall = kWarps * kQ + 7 * kQ + 8 * kQ + kWarps;
constexpr size_t kSmem = kBig + kSmall * 4;
// rev_kernel's: a ring of three (dy, C columns, dt) and per-warp L
constexpr int kRevStages = 3;
constexpr uint32_t kRevBuf = kXB + kQ * kRevPitch + kDtB;
constexpr size_t kRevSmem = kRevStages * kRevBuf + kRevWarps * kQ * 4;

struct Args {
  const __nv_bfloat16* x;
  const float* dt;
  const float* a;
  const __nv_bfloat16* b;
  const __nv_bfloat16* c;
  const __nv_bfloat16* dy;       // (B, S, nh, hd) contiguous
  const float* states;           // (B, nc, nh, hd, N): each chunk's entry
  const float* dh_final;         // (B, nh, hd, N), nullptr: zero
  __nv_bfloat16* dx;
  float* ddt;
  __nv_bfloat16* db;
  __nv_bfloat16* dc;
  float* dh0;                    // nullptr: not wanted
  float* pda;                    // (B, nc, nh): da per chunk and head
  float* dhs;                    // (B, nc, nh, hd, N) scratch: dH per chunk
  float* share;                  // (B, nc, ngroups, 2, Q, N) scratch: each
                                 // group's dB and dC (ngroups > 1)
  int B, S, nh, hd, N, Q, nc, group, ngroups;
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss;
};

// Heads per chunk_kernel CTA: the fewest whose grid of B nc ceil(nh / g)
// CTAs (one an SM) takes the least time, waves x g; ties to the larger g
// (less G^T work and fewer dB / dC shares).
inline int group_of(int B, int nc, int nh, int sms) {
  int best = 1;
  long long best_cost = -1;
  for (int g = 1; g <= nh; ++g) {
    const long long ctas = (long long)B * nc * ((nh + g - 1) / g);
    const long long cost = (ctas + sms - 1) / sms * g;
    if (best_cost < 0 || cost <= best_cost) {
      best = g;
      best_cost = cost;
    }
  }
  return best;
}

// float index of (d, n) in a staged h_in / dH tile
__device__ __forceinline__ int hoff(int d, int n) {
  return d * kHP + (n ^ (((d >> 2) & 1) << 3));
}

// v as hi + lo: hi rounded to tf32, lo the remainder rounded again
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  hi = h;
  lo = tf32(v - __uint_as_float(h));
}

// a bf16 k16 A fragment as its two tf32 k8 steps (exact)
__device__ __forceinline__ void k8_steps(const uint32_t (&f)[4],
                                         uint32_t (&s)[2][4]) {
  s[0][0] = lo_bits(f[0]);
  s[0][1] = lo_bits(f[1]);
  s[0][2] = hi_bits(f[0]);
  s[0][3] = hi_bits(f[1]);
  s[1][0] = lo_bits(f[2]);
  s[1][1] = lo_bits(f[3]);
  s[1][2] = hi_bits(f[2]);
  s[1][3] = hi_bits(f[3]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// sum over the four lanes that hold one row of an mma fragment
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* base, uint32_t off) {
  return *reinterpret_cast<const uint32_t*>(base + off);
}

// this warp's copy of L = cumsum(dt a) log2 e over the kQ staged rows
// (dt = 0 past the chunk); dtv gets dt of rows 4 lane .. 4 lane + 3
__device__ __forceinline__ void scan_l(const float* dts, float al2, float* L,
                                       float (&dtv)[4]) {
  const int lane = threadIdx.x % 32;
  float v[4], run = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    dtv[e] = dts[4 * lane + e];
    run += dtv[e] * al2;
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

// kQ rows of 64 bf16 into 128-byte swizzled rows: row j from src + j ld
// for j < nq (its first `cols` columns), zeros elsewhere
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long ld, int nq, int cols) {
  for (int i = threadIdx.x; i < kQ * 8; i += blockDim.x) {
    const int j = i / 8, pc = i % 8;
    const bool ok = j < nq && 8 * pc < cols;
    cp_async16(dst + swz(j, pc, 128), ok ? src + j * ld + 8 * pc : src,
               ok ? 16 : 0);
  }
}

__device__ __forceinline__ void load_dt(uint32_t dst, const float* src,
                                        long long ld, int nq) {
  for (int j = threadIdx.x; j < kQ; j += blockDim.x) {
    const bool ok = j < nq;
    cp_async4(dst + 4 * j, ok ? src + j * ld : src, ok ? 4 : 0);
  }
}

// the kD x kNT tile at columns n0.. of one (hd, N) fp32 state; zeros past
// hd and N
__device__ __forceinline__ void load_h(uint32_t dst, const float* src, int hd,
                                       int N, int n0) {
  for (int i = threadIdx.x; i < kD * (kNT / 4); i += blockDim.x) {
    const int d = i / (kNT / 4), pc = i % (kNT / 4);
    const bool ok = d < hd && n0 + 4 * pc < N;
    cp_async16(dst + 4 * hoff(d, 4 * pc),
               ok ? src + (long long)d * N + n0 + 4 * pc : src, ok ? 16 : 0);
  }
}

// The reverse walk over the chunks of row blockIdx.z, head blockIdx.y,
// state columns 32 blockIdx.x..: dhs[k] = dH_k, dh0 = the entry's.
__global__ void __launch_bounds__(32 * kRevWarps) rev_kernel(Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t s0 = smem_u32(smem);
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int r = lane / 4, c = 2 * (lane % 4), d0 = 16 * w;
  const int n0 = blockIdx.x * kRevCols, hh = blockIdx.y, b = blockIdx.z;
  float* L = reinterpret_cast<float*>(smem + kRevStages * kRevBuf) + w * kQ;
  const float al2 = a.a[hh] * kLog2e;
  const long long hrow = ((long long)b * a.nh + hh) * a.hd;
  const long long dy_ld = (long long)a.nh * a.hd;
  // dH: rows d0 + r (+ 8), columns n0 + 8 nt + c (+ 1)
  float dh[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = d0 + r + 8 * (e / 2), n = n0 + 8 * nt + c + e % 2;
      dh[nt][e] = a.dh_final != nullptr && d < a.hd && n < a.N
                      ? a.dh_final[(hrow + d) * a.N + n] : 0.f;
    }
  auto load = [&](int k) {
    if (k < 0) return;
    const uint32_t o = s0 + (k % kRevStages) * kRevBuf;
    const int t0 = k * a.Q, nq = min(a.Q, a.S - t0);
    load_rows(o, a.dy + ((long long)b * a.S + t0) * dy_ld + hh * a.hd, dy_ld,
              nq, a.hd);
    const __nv_bfloat16* cr = a.c + b * a.c_sb + (long long)t0 * a.c_ss + n0;
    for (int i = threadIdx.x; i < kQ * (kRevCols / 8); i += blockDim.x) {
      const int j = i / (kRevCols / 8), pc = i % (kRevCols / 8);
      const bool ok = j < nq && n0 + 8 * pc < a.N;
      cp_async16(o + kXB + j * kRevPitch + 16 * pc,
                 ok ? cr + j * a.c_ss + 8 * pc : cr, ok ? 16 : 0);
    }
    load_dt(o + kXB + kQ * kRevPitch,
            a.dt + b * a.dt_sb + (long long)t0 * a.dt_ss + hh, a.dt_ss, nq);
  };
  load(a.nc - 1);
  cp_async_commit();
  load(a.nc - 2);
  cp_async_commit();
  for (int k = a.nc - 1; k >= 0; --k) {
    load(k - 2);
    cp_async_commit();
    cp_async_wait<2>();
    __syncthreads();                    // chunk k landed
    const uint32_t o = s0 + (k % kRevStages) * kRevBuf;
    const float* dts = reinterpret_cast<const float*>(
        smem + (k % kRevStages) * kRevBuf + kXB + kQ * kRevPitch);
    float dtv[4];
    scan_l(dts, al2, L, dtv);
    float* out = a.dhs + (((long long)b * a.nc + k) * a.nh + hh) * a.hd * a.N;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int d = d0 + r + 4 * e, n = n0 + 8 * nt + c;
        if (d < a.hd && n < a.N)
          *reinterpret_cast<float2*>(out + (long long)d * a.N + n) =
              make_float2(dh[nt][e], dh[nt][e + 1]);
      }
    // dH <- 2^L_last dH + S, S = sum_i 2^L_i dy_i (x) C_i in four partial
    // sums (hi / lo, even / odd k steps), so no mma waits on the previous
    const int qb = (min(a.Q, a.S - k * a.Q) + 15) / 16;
    float sk[4][4][4];
#pragma unroll
    for (int v = 0; v < 4; ++v)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sk[v][nt][e] = 0.f;
    if (d0 < a.hd) {
#pragma unroll
      for (int ks = 0; ks < kQ / 16; ++ks) {
        if (ks >= qb) break;
        // A = dy^T (rows d, k = positions), scaled by 2^L, hi + lo
        uint32_t af[4];
        ldsm_x4_t(af, o + swz(16 * ks + (lane / 16) * 8 + lane % 8,
                              2 * w + (lane / 8) % 2, 128));
        const int i0 = 16 * ks + c;
        const float u0 = ex2(L[i0]), u1 = ex2(L[i0 + 1]);
        const float u8 = ex2(L[i0 + 8]), u9 = ex2(L[i0 + 9]);
        uint32_t ah[2][4], al[2][4];
        split(lo_f(af[0]) * u0, ah[0][0], al[0][0]);
        split(lo_f(af[1]) * u0, ah[0][1], al[0][1]);
        split(hi_f(af[0]) * u1, ah[0][2], al[0][2]);
        split(hi_f(af[1]) * u1, ah[0][3], al[0][3]);
        split(lo_f(af[2]) * u8, ah[1][0], al[1][0]);
        split(lo_f(af[3]) * u8, ah[1][1], al[1][1]);
        split(hi_f(af[2]) * u9, ah[1][2], al[1][2]);
        split(hi_f(af[3]) * u9, ah[1][3], al[1][3]);
#pragma unroll
        for (int pr = 0; pr < 2; ++pr) {
          uint32_t bf[4];
          ldsm_x4_t(bf, o + kXB +
                            (16 * ks + ((lane / 8) % 2) * 8 + lane % 8) *
                                kRevPitch + (2 * pr + lane / 16) * 16);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float(&sh)[4] = sk[2 * (ks & 1)][2 * pr + u];
            float(&sl)[4] = sk[2 * (ks & 1) + 1][2 * pr + u];
            const uint32_t b0 = lo_bits(bf[2 * u]), b1 = hi_bits(bf[2 * u]);
            const uint32_t b2 = lo_bits(bf[2 * u + 1]);
            const uint32_t b3 = hi_bits(bf[2 * u + 1]);
            mma1688(sh, ah[0], b0, b1);
            mma1688(sl, al[0], b0, b1);
            mma1688(sh, ah[1], b2, b3);
            mma1688(sl, al[1], b2, b3);
          }
        }
      }
    }
    const float e_last = ex2(L[kQ - 1]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dh[nt][e] = fmaf(e_last, dh[nt][e], (sk[0][nt][e] + sk[2][nt][e]) +
                                                (sk[1][nt][e] + sk[3][nt][e]));
    __syncthreads();                    // buffer k % 3 is free again
  }
  if (a.dh0 != nullptr) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = d0 + r + 8 * (e / 2), n = n0 + 8 * nt + c + e % 2;
        if (d < a.hd && n < a.N) a.dh0[(hrow + d) * a.N + n] = dh[nt][e];
      }
  }
}

// Block v (0..8) of the nine causal 16 x 16 blocks (jt, it >= jt) of row
// tiles p and 7 - p
__device__ __forceinline__ void pair_block(int p, int v, int& jt, int& it) {
  if (v < 8 - p) {
    jt = p;
    it = p + v;
  } else {
    jt = 7 - p;
    it = v - 1;
  }
}

__device__ __forceinline__ int blk(int jt, int it) {
  return it * (it + 1) / 2 + jt;
}

// Phase 2's work on one head for a warp's row tiles p and 7 - p (16 mt +
// r (+ 8)) and a tile's 64 state columns (8 nn + c (+ 1)). kDC: rows i,
// acc += 2^L_i dy_i h_in + sum_{j <= i} EP_ij B_j; else rows j,
// acc += w_j dt_j x_j dH + sum_{i >= j} EP_ij C_i, EP_ij = E_ij dt_j
// (dy_i . x_j). `mine` / `other`: this warp's rows' operand (dy or x) and
// the other; `bc`: the B (kDC) or C tile; H: h_in (kDC) or dH. Columns and
// head dims past N and hd are zero in shared memory, so only row tiles
// past the chunk are skipped.
template <bool kDC>
__device__ __forceinline__ void rows_share(float (&acc)[2][8][4],
                                           uint32_t mine, uint32_t other,
                                           uint32_t bc, const float* dtb,
                                           const float* H, const float* L,
                                           int p, int qb) {
  const int lane = threadIdx.x % 32, r = lane / 4, c = 2 * (lane % 4);
  const float l_last = L[kQ - 1];
  float sc[2][2];                       // 2^L_i (dC) or w_j dt_j (dB)
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int i = 16 * (m == 0 ? p : 7 - p) + r + 8 * h2;
      sc[m][h2] = kDC ? ex2(L[i]) : ex2(l_last - L[i]) * dtb[i];
    }
  // the h part, k over the head dims; both row tiles share the h loads
#pragma unroll 1
  for (int ks = 0; ks < kD / 16; ++ks) {
    uint32_t av[2][2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      uint32_t f[4];
      ldsm_x4(f, mine + swz(16 * (m == 0 ? p : 7 - p) +
                                ((lane / 8) % 2) * 8 + lane % 8,
                            2 * ks + lane / 16, 128));
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        av[m][st][0] = tf32(lo_f(f[2 * st]) * sc[m][0]);
        av[m][st][1] = tf32(lo_f(f[2 * st + 1]) * sc[m][1]);
        av[m][st][2] = tf32(hi_f(f[2 * st]) * sc[m][0]);
        av[m][st][3] = tf32(hi_f(f[2 * st + 1]) * sc[m][1]);
      }
    }
    const int d = 16 * ks + c;
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) {
      const int n = 8 * nn + r;
      const uint32_t b0 = tf32(H[hoff(d, n)]), b1 = tf32(H[hoff(d + 1, n)]);
      const uint32_t b2 = tf32(H[hoff(d + 8, n)]);
      const uint32_t b3 = tf32(H[hoff(d + 9, n)]);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if ((m == 0 ? p : 7 - p) >= qb) continue;
        mma1688(acc[m][nn], av[m][0], b0, b1);
        mma1688(acc[m][nn], av[m][1], b2, b3);
      }
    }
  }
  // the Q x Q part, block by block of 16 columns (j for dC, i for dB)
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int mt = m == 0 ? p : 7 - p;
    if (mt >= qb) continue;
    uint32_t ra[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      ldsm_x4(ra[ks], mine + swz(16 * mt + ((lane / 8) % 2) * 8 + lane % 8,
                                 2 * ks + lane / 16, 128));
    const int i0 = 16 * mt + r;
    const float li[2] = {L[i0], L[i0 + 8]};
    const float dtr[2] = {dtb[i0], dtb[i0 + 8]};
    const int kb0 = kDC ? 0 : mt, kb1 = kDC ? mt + 1 : qb;
    for (int kb = kb0; kb < kb1; ++kb) {
      float pp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t bf[4];
        ldsm_x4(bf, other + swz(16 * kb + (lane / 16) * 8 + lane % 8,
                                2 * ks + (lane / 8) % 2, 128));
        mma16816(pp[0], ra[ks], bf[0], bf[1]);
        mma16816(pp[1], ra[ks], bf[2], bf[3]);
      }
      uint32_t ea[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = i0 + 8 * (e / 2);
          const int col = 16 * kb + 8 * s + c + e % 2;
          const float lc = L[col];
          const float v =
              kDC ? pp[s][e] * ex2(fminf(li[e / 2] - lc, 0.f)) * dtb[col]
                  : pp[s][e] * ex2(fminf(lc - li[e / 2], 0.f)) * dtr[e / 2];
          ea[s][(e % 2) * 2 + e / 2] =
              tf32((kDC ? col <= row : col >= row) ? v : 0.f);
        }
#pragma unroll
      for (int pr = 0; pr < 4; ++pr) {
        uint32_t bf[4];
        ldsm_x4_t(bf, bc + swz(16 * kb + ((lane / 8) % 2) * 8 + lane % 8,
                               2 * pr + lane / 16, 128));
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float(&d)[4] = acc[m][2 * pr + u];
          mma1688(d, ea[0], lo_bits(bf[2 * u]), hi_bits(bf[2 * u]));
          mma1688(d, ea[1], lo_bits(bf[2 * u + 1]), hi_bits(bf[2 * u + 1]));
        }
      }
    }
  }
}

// Everything of chunk blockIdx.x of row blockIdx.z for the heads of group
// blockIdx.y but dH: dx, ddt, the da shares, and the group's dB / dC.
__global__ void __launch_bounds__(kThreads, 1) chunk_kernel(Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t s0 = smem_u32(smem);
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int r = lane / 4, c = 2 * (lane % 4), p = w % 4, hf = w / 4;
  const int k = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int t0 = k * a.Q, nq = min(a.Q, a.S - t0), qb = (nq + 15) / 16;
  const int h0 = grp * a.group, gcnt = min(a.group, a.nh - h0);
  const int nT = (a.N + kNT - 1) / kNT;
  float* small = reinterpret_cast<float*>(smem + kBig);
  float* L = small + w * kQ;            // this warp's L
  float* sHc = small + kWarps * kQ;     // [2][kQ]: hc_i . dy_i, by halves
  float* sWr = sHc + 2 * kQ;            // [2][kQ]: dhb_j . x_j          of
  float* sDx = sWr + 2 * kQ;            // [2][kQ]: dxdt_j . x_j    the hd
  float* sTr = sDx + 2 * kQ;            // [kQ]: T's column sums
  float* sTc = sTr + kQ;                // [8][kQ]: T's row sums by tile
  float* sHd = sTc + 8 * kQ;            // [kWarps]: <dH, h_in> by warp
  const long long dy_ld = (long long)a.nh * a.hd;
  const long long hsz = (long long)a.hd * a.N;
  const long long hbase = ((long long)b * a.nc + k) * a.nh;
  auto load_xdt = [&](uint32_t o, int hh) {
    load_rows(o, a.x + b * a.x_sb + (long long)t0 * a.x_ss + hh * a.x_sh,
              a.x_ss, nq, a.hd);
    load_rows(o + kXB, a.dy + ((long long)b * a.S + t0) * dy_ld + hh * a.hd,
              dy_ld, nq, a.hd);
    load_dt(o + 2 * kXB, a.dt + b * a.dt_sb + (long long)t0 * a.dt_ss + hh,
            a.dt_ss, nq);
  };
  auto load_bc = [&](uint32_t o, int t) {
    load_rows(o, a.b + b * a.b_sb + (long long)t0 * a.b_ss + kNT * t,
              a.b_ss, nq, a.N - kNT * t);
    load_rows(o + kTB, a.c + b * a.c_sb + (long long)t0 * a.c_ss + kNT * t,
              a.c_ss, nq, a.N - kNT * t);
  };
  auto load_hh = [&](uint32_t o, int hh, int t) {
    load_h(o, a.states + (hbase + hh) * hsz, a.hd, a.N, kNT * t);
    load_h(o + kHB, a.dhs + (hbase + hh) * hsz, a.hd, a.N, kNT * t);
  };

  // ---- phase 1: G^T once, then each head's dx, ddt and da share --------
  // Item q of the tile stream: B and C tile q % nT, and for q >= nT head
  // h0 + q / nT - 1's h_in and dH tile; slot q & 1.
  const int nitems = nT * (1 + gcnt);
  auto slot_a = [&](int q) -> uint32_t { return kASlot + (q & 1) * kASize; };
  auto issue_a = [&](int q) {
    if (q >= nitems) return;
    load_bc(s0 + slot_a(q), q % nT);
    if (q >= nT) load_hh(s0 + slot_a(q) + 2 * kTB, h0 + q / nT - 1, q % nT);
  };
  const uint32_t sX = s0 + kAX, sDy = sX + kXB;
  const uint8_t* X = smem + kAX;
  const uint8_t* DY = X + kXB;
  const float* dts = reinterpret_cast<const float*>(X + 2 * kXB);
  const float* G = reinterpret_cast<const float*>(smem);
  load_xdt(sX, h0);
  cp_async_commit();
  issue_a(0);
  cp_async_commit();
  {
    // this warp's G^T blocks: 5 hf + u of its pair's nine
    float g[5][2][4];
#pragma unroll
    for (int u = 0; u < 5; ++u)
#pragma unroll
      for (int e = 0; e < 8; ++e) g[u][e / 4][e % 4] = 0.f;
    for (int q = 0; q < nT; ++q) {
      issue_a(q + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const uint32_t tb = s0 + slot_a(q), tc = tb + kTB;
#pragma unroll
      for (int u = 0; u < 5; ++u) {
        int jt, it;
        pair_block(p, 5 * hf + u, jt, it);
        if (5 * hf + u >= 9 || it >= qb) continue;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t af[4], bf[4];
          ldsm_x4(af, tb + swz(16 * jt + ((lane / 8) % 2) * 8 + lane % 8,
                               2 * ks + lane / 16, 128));
          ldsm_x4(bf, tc + swz(16 * it + (lane / 16) * 8 + lane % 8,
                               2 * ks + (lane / 8) % 2, 128));
          mma16816(g[u][0], af, bf[0], bf[1]);
          mma16816(g[u][1], af, bf[2], bf[3]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < 5; ++u) {
      int jt, it;
      pair_block(p, 5 * hf + u, jt, it);
      if (5 * hf + u >= 9 || it >= qb) continue;
      float4* dst = reinterpret_cast<float4*>(smem) + blk(jt, it) * 64 +
                    lane * 2;
      dst[0] = make_float4(g[u][0][0], g[u][0][1], g[u][0][2], g[u][0][3]);
      dst[1] = make_float4(g[u][1][0], g[u][1][1], g[u][1][2], g[u][1][3]);
    }
  }

  float hdot = 0.f;
  for (int hq = 0; hq < gcnt; ++hq) {
    const int hh = h0 + hq;
    // rows 16 mt + r (+ 8), mt = p, 7 - p; head dims 32 hf + 8 nt + c (+ 1)
    float hc[2][4][4], dx[2][4][4];     // C h_in^T; B dH^T, then dxdt
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) hc[m][nt][e] = dx[m][nt][e] = 0.f;
    for (int t = 0; t < nT; ++t) {
      const int q = nT * (hq + 1) + t;
      issue_a(q + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const uint32_t tb = s0 + slot_a(q), tc = tb + kTB;
      const float* Hi = reinterpret_cast<const float*>(smem + slot_a(q) +
                                                       2 * kTB);
      const float* Hd = Hi + kD * kHP;
      for (int i = tid; i < kD * kNT; i += kThreads) {
        const int o = hoff(i / kNT, i % kNT);
        hdot = fmaf(Hi[o], Hd[o], hdot);
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t ca[2][2][4], ba[2][2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int row = 16 * (m == 0 ? p : 7 - p) + ((lane / 8) % 2) * 8 +
                          lane % 8;
          uint32_t f[4];
          ldsm_x4(f, tc + swz(row, 2 * ks + lane / 16, 128));
          k8_steps(f, ca[m]);
          ldsm_x4(f, tb + swz(row, 2 * ks + lane / 16, 128));
          k8_steps(f, ba[m]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int d = 32 * hf + 8 * nt + r, n = 16 * ks + c;
          const float2 h01 = *reinterpret_cast<const float2*>(Hi + hoff(d, n));
          const float2 h89 =
              *reinterpret_cast<const float2*>(Hi + hoff(d, n + 8));
          const float2 g01 = *reinterpret_cast<const float2*>(Hd + hoff(d, n));
          const float2 g89 =
              *reinterpret_cast<const float2*>(Hd + hoff(d, n + 8));
          uint32_t hh_[4], hl[4], gh[4], gl[4];
          split(h01.x, hh_[0], hl[0]);
          split(h01.y, hh_[1], hl[1]);
          split(h89.x, hh_[2], hl[2]);
          split(h89.y, hh_[3], hl[3]);
          split(g01.x, gh[0], gl[0]);
          split(g01.y, gh[1], gl[1]);
          split(g89.x, gh[2], gl[2]);
          split(g89.y, gh[3], gl[3]);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            if ((m == 0 ? p : 7 - p) >= qb) continue;
            mma1688(hc[m][nt], ca[m][0], hh_[0], hh_[1]);
            mma1688(hc[m][nt], ca[m][0], hl[0], hl[1]);
            mma1688(hc[m][nt], ca[m][1], hh_[2], hh_[3]);
            mma1688(hc[m][nt], ca[m][1], hl[2], hl[3]);
            mma1688(dx[m][nt], ba[m][0], gh[0], gh[1]);
            mma1688(dx[m][nt], ba[m][0], gl[0], gl[1]);
            mma1688(dx[m][nt], ba[m][1], gh[2], gh[3]);
            mma1688(dx[m][nt], ba[m][1], gl[2], gl[3]);
          }
        }
      }
      __syncthreads();
    }
    // x, dy and dt of head hh have landed: they were committed before the
    // last tile's successor, the one group the last wait left pending
    float dtv[4];
    scan_l(dts, a.a[hh] * kLog2e, L, dtv);
    const float l_last = L[kQ - 1];

    // hc . dy and dhb . x by rows, halves of the head dims apart; then
    // dxdt starts as w_j dhb_j
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int mt = m == 0 ? p : 7 - p;
      if (mt >= qb) continue;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int i = 16 * mt + r + 8 * h2;
        float shc = 0.f, sw = 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int d = 32 * hf + 8 * nt + c;
          const uint32_t off = swz(i, d / 8, 128) + 2 * (d % 8);
          const uint32_t y2 = lds32(DY, off), x2 = lds32(X, off);
          shc = fmaf(lo_f(y2), hc[m][nt][2 * h2], shc);
          shc = fmaf(hi_f(y2), hc[m][nt][2 * h2 + 1], shc);
          sw = fmaf(lo_f(x2), dx[m][nt][2 * h2], sw);
          sw = fmaf(hi_f(x2), dx[m][nt][2 * h2 + 1], sw);
        }
        shc = quad_sum(shc);
        sw = quad_sum(sw);
        if (lane % 4 == 0) {
          sHc[hf * kQ + i] = shc;
          sWr[hf * kQ + i] = sw;
        }
        const float wj = ex2(l_last - L[i]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          dx[m][nt][2 * h2] *= wj;
          dx[m][nt][2 * h2 + 1] *= wj;
        }
      }
    }

    // The Q x Q part by row tiles j: M^T = G^T o E^T, EP^T = P^T o E^T dt_j
    // (P^T = x dy^T), T^T = M^T o P^T dt_j; dxdt += M^T dy
    float rowT[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int jt = m == 0 ? p : 7 - p;
      if (jt >= qb) continue;
      uint32_t xa[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        ldsm_x4(xa[ks], sX + swz(16 * jt + ((lane / 8) % 2) * 8 + lane % 8,
                                 2 * ks + lane / 16, 128));
      }
      const int j0 = 16 * jt + r;
      const float lj[2] = {L[j0], L[j0 + 8]};
      const float dtj[2] = {dts[j0], dts[j0 + 8]};
      for (int it = jt; it < qb; ++it) {
        const float4* gp =
            reinterpret_cast<const float4*>(G) + blk(jt, it) * 64 + lane * 2;
        const float4 g0 = gp[0], g1 = gp[1];
        const float g[2][4] = {{g0.x, g0.y, g0.z, g0.w},
                               {g1.x, g1.y, g1.z, g1.w}};
        float pt[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t bf[4];
          ldsm_x4(bf, sDy + swz(16 * it + (lane / 16) * 8 + lane % 8,
                                2 * ks + (lane / 8) % 2, 128));
          mma16816(pt[0], xa[ks], bf[0], bf[1]);
          mma16816(pt[1], xa[ks], bf[2], bf[3]);
        }
        uint32_t mh[2][4], ml[2][4];
        float cs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = j0 + 8 * (e / 2), i = 16 * it + 8 * s + c + e % 2;
            const float ev = g[s][e] * ex2(fminf(L[i] - lj[e / 2], 0.f));
            const float mv = i >= j ? ev : 0.f;
            const float tv = mv * pt[s][e] * dtj[e / 2];
            rowT[m][e / 2] += tv;
            cs[s][e % 2] += tv;
            split(mv, mh[s][(e % 2) * 2 + e / 2], ml[s][(e % 2) * 2 + e / 2]);
          }
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            float v = cs[s][e2];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (hf == 1 && lane < 4)
              sTc[jt * kQ + 16 * it + 8 * s + c + e2] = v;
          }
#pragma unroll
        for (int pr = 0; pr < 2; ++pr) {
          uint32_t bf[4];
          ldsm_x4_t(bf, sDy + swz(16 * it + ((lane / 8) % 2) * 8 + lane % 8,
                                  4 * hf + 2 * pr + lane / 16, 128));
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float(&d)[4] = dx[m][2 * pr + u];
            const uint32_t b0 = lo_bits(bf[2 * u]), b1 = hi_bits(bf[2 * u]);
            const uint32_t b2 = lo_bits(bf[2 * u + 1]);
            const uint32_t b3 = hi_bits(bf[2 * u + 1]);
            mma1688(d, mh[0], b0, b1);
            mma1688(d, ml[0], b0, b1);
            mma1688(d, mh[1], b2, b3);
            mma1688(d, ml[1], b2, b3);
          }
        }
      }
    }
    if (hf == 0) {
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int jt = m == 0 ? p : 7 - p;
        if (jt >= qb) continue;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const float v = quad_sum(rowT[m][h2]);
          if (lane % 4 == 0) sTr[16 * jt + r + 8 * h2] = v;
        }
      }
    }

    // dx = dxdt dt; dxdt . x by rows
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int jt = m == 0 ? p : 7 - p;
      if (jt >= qb) continue;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int j = 16 * jt + r + 8 * h2;
        const float dtj = dts[j];
        float sx = 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int d = 32 * hf + 8 * nt + c;
          const float g0 = dx[m][nt][2 * h2], g1 = dx[m][nt][2 * h2 + 1];
          const uint32_t x2 = lds32(X, swz(j, d / 8, 128) + 2 * (d % 8));
          sx = fmaf(g0, lo_f(x2), fmaf(g1, hi_f(x2), sx));
          if (j < nq && d < a.hd)
            *reinterpret_cast<uint32_t*>(
                a.dx + (((long long)b * a.S + t0 + j) * a.nh + hh) * a.hd +
                d) = pack_bf16(g0 * dtj, g1 * dtj);
        }
        sx = quad_sum(sx);
        if (lane % 4 == 0) sDx[hf * kQ + j] = sx;
      }
    }
    {
      const float v = warp_sum(hdot);
      if (lane == 0) sHd[w] = v;
      hdot = 0.f;
    }
    __syncthreads();                    // x, dy, dt read; partials written
    if (hq + 1 < gcnt) load_xdt(sX, hh + 1);
    cp_async_commit();

    // warp 0: dl, its reverse cumsum g, ddt = g a + dxdt . x, da share
    if (w == 0) {
      float hsum = 0.f;
      for (int ww = 0; ww < kWarps; ++ww) hsum += sHd[ww];
      float dl[4], wsum = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * lane + e;
        float v = 0.f;
        if (j < 16 * qb) {
          const float wj = ex2(l_last - L[j]) * dtv[e] * (sWr[j] + sWr[kQ + j]);
          float tc = 0.f;
          for (int jt = 0; jt <= j / 16; ++jt) tc += sTc[jt * kQ + j];
          v = ex2(L[j]) * (sHc[j] + sHc[kQ + j]) - wj + tc - sTr[j];
          wsum += wj;
        }
        dl[e] = v;
      }
      wsum = warp_sum(wsum);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * lane + e == nq - 1) dl[e] += fmaf(ex2(l_last), hsum, wsum);
      float suf[4], run = 0.f;
#pragma unroll
      for (int e = 3; e >= 0; --e) {
        run += dl[e];
        suf[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += o;
      }
      const float after = incl - run, ah = a.a[hh];
      float dap = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * lane + e;
        const float gj = after + suf[e];
        dap = fmaf(gj, dtv[e], dap);
        if (j < nq)
          a.ddt[((long long)b * a.S + t0 + j) * a.nh + hh] =
              fmaf(gj, ah, sDx[j] + sDx[kQ + j]);
      }
      dap = warp_sum(dap);
      if (lane == 0) a.pda[hbase + hh] = dap;
    }
  }

  // ---- phase 2: the group's dC (warps 0-3) and dB (4-7), by tiles ------
  // Item u: head h0 + u % gcnt's x, dy, dt and tile u / gcnt of its h_in
  // and dH, slot u & 1; tile t of B and C is loaded once for its items.
  cp_async_wait<0>();
  __syncthreads();                      // phase 1's buffers are free
  const bool is_dc = w < 4;
  const int nu = nT * gcnt;
  auto slot_b = [&](int u) -> uint32_t { return kBSlot + (u & 1) * kBSize; };
  auto issue_b = [&](int u) {
    if (u >= nu) return;
    load_xdt(s0 + slot_b(u), h0 + u % gcnt);
    load_hh(s0 + slot_b(u) + 2 * kXB + kDtB, h0 + u % gcnt, u / gcnt);
  };
  const uint32_t bB = s0, bC = s0 + kTB;
  load_bc(bB, 0);
  issue_b(0);
  cp_async_commit();
  __nv_bfloat16* out = is_dc ? a.dc : a.db;
  for (int t = 0; t < nT; ++t) {
    // rows 16 mt + r (+ 8) (i for dC, j for dB), columns 64 t + 8 nn + c
    float acc[2][8][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int nn = 0; nn < 8; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][nn][e] = 0.f;
    for (int hq = 0; hq < gcnt; ++hq) {
      const int u = t * gcnt + hq, hh = h0 + hq;
      issue_b(u + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const uint32_t bx = s0 + slot_b(u), by = bx + kXB;
      const float* dtb = reinterpret_cast<const float*>(smem + slot_b(u) +
                                                        2 * kXB);
      const float* Hi = dtb + kQ;       // h_in, then dH
      float dtv[4];
      scan_l(dtb, a.a[hh] * kLog2e, L, dtv);
      if (is_dc)
        rows_share<true>(acc, by, bx, bB, dtb, Hi, L, p, qb);
      else
        rows_share<false>(acc, bx, by, bC, dtb, Hi + kD * kHP, L, p, qb);
      __syncthreads();                  // slot u & 1 is free again
    }
    // this group's share of tile t: bf16 dB / dC with one group
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int mt = m == 0 ? p : 7 - p;
      if (mt >= qb) continue;
#pragma unroll
      for (int nn = 0; nn < 8; ++nn) {
        const int n = kNT * t + 8 * nn + c;
        if (n >= a.N) continue;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int row = 16 * mt + r + 8 * h2;
          if (row >= nq) continue;
          const float v0 = acc[m][nn][2 * h2], v1 = acc[m][nn][2 * h2 + 1];
          if (a.ngroups == 1)
            *reinterpret_cast<uint32_t*>(
                out + ((long long)b * a.S + t0 + row) * a.N + n) =
                pack_bf16(v0, v1);
          else
            *reinterpret_cast<float2*>(
                a.share +
                (((((long long)b * a.nc + k) * a.ngroups + grp) * 2 +
                  (is_dc ? 1 : 0)) * a.Q + row) * a.N + n) =
                make_float2(v0, v1);
        }
      }
    }
    if (t + 1 < nT) {                   // every warp is done with tile t
      load_bc(bB, t + 1);
      cp_async_commit();
    }
  }
}

// dB and dC of position t, column n: the groups' shares in group order
__global__ void __launch_bounds__(256) sum_kernel(Args a) {
  const long long idx = blockIdx.x * 256LL + threadIdx.x;
  if (idx >= (long long)a.B * a.S * a.N) return;
  const int n = static_cast<int>(idx % a.N);
  const long long bt = idx / a.N;
  const int t = static_cast<int>(bt % a.S), b = static_cast<int>(bt / a.S);
  const long long qn = (long long)a.Q * a.N;
  const float* s = a.share +
                   ((long long)b * a.nc + t / a.Q) * a.ngroups * 2 * qn +
                   (long long)(t % a.Q) * a.N + n;
  float sb = 0.f, sc = 0.f;
  for (int g = 0; g < a.ngroups; ++g) {
    sb += s[2 * g * qn];
    sc += s[(2 * g + 1) * qn];
  }
  a.db[idx] = __float2bfloat16(sb);
  a.dc[idx] = __float2bfloat16(sc);
}

inline cudaError_t run(const Args& a, cudaStream_t s) {
  cudaError_t e = rt::launch<rev_kernel>(
      dim3((a.N + kRevCols - 1) / kRevCols, a.nh, a.B), 32 * kRevWarps,
      kRevSmem, a, s);
  if (e != cudaSuccess) return e;
  e = rt::launch<chunk_kernel>(dim3(a.nc, a.ngroups, a.B), kThreads, kSmem,
                               a, s);
  if (e != cudaSuccess || a.ngroups == 1) return e;
  const long long n = (long long)a.B * a.S * a.N;
  return rt::launch<sum_kernel>(dim3((n + 255) / 256), 256, 0, a, s);
}

}  // namespace ssd_bwd_sm90
}  // namespace rt

// bf16 flash-attention backward body for Hopper (sm_90a): the tensor-core
// path of flash_attention_bwd.cu (design, registers and determinism in that
// file's note). Three kernels:
//  * prep: D = rowsum(dO o O) and the log-sum-exp, both copied into rows
//    padded to whole 64-query tiles (so a stage's rows arrive as one
//    256-byte bulk copy), and the fp32 dQ accumulator zeroed;
//  * main: one CTA per (128-key tile, KV head, split, batch row), five
//    wgmma products per 64-query step, dQ reduce-added into the
//    accumulator by TMA;
//  * post: dQ scaled and rounded to bf16.
// With a split, each CTA writes fp32 dK / dV partials, and the split of a
// key tile that finishes last sums them in split order and stores bf16.
//
// Shared-memory operands use the prefill body's layout (prefill_sm90.cuh):
// slices of 16 head-dim columns, each (rows x 32 B) in the 32-byte swizzle,
// written by TMA boxes of 16 columns. The same bytes serve both ways:
// K-major where the head dim is the contraction (S^T = K Q^T, dP^T = V dO^T)
// and MN-major where it is the output's columns (dV += P^T dO, dK += dS^T Q,
// dQ = dS K), as the forward reads V. dS^T goes to shared memory as (keys x
// 16-query slices), the MN-major A operand of dQ = dS K.
//
// The fp32 dQ accumulator and the split partials hold each 64-row wgmma
// accumulator tile in "fragment order": thread t's column pair jp lands at
// float2 index jp * 128 + t, so the stores from registers (and the staging
// copy the reduce-add reads) are contiguous; frag_pos decodes it.
#pragma once

#include <algorithm>

#include "prefill_sm90.cuh"

namespace rt {
namespace bwd {

using sm90::desc32;
using sm90::fence_async_smem;
using sm90::fence_regs;
using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::named_sync;
using sm90::swz32;
using sm90::tma_load_4d;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_rs;
using sm90::wgmma_wait0;

constexpr int kKeys = 128;            // keys per CTA, 64 per consumer
constexpr int kQ = 64;                // queries per step
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);

template <int D>
__host__ __device__ constexpr int padded() { return (D + 15) / 16 * 16; }

// Q / dO stages in flight: three at d 120 and 128 (what fits beside K, V, dS
// and the dQ staging), four below
template <int D>
__host__ __device__ constexpr int stages() {
  return padded<D>() >= 128 ? 3 : 4;
}

// dQ's columns are split between the consumers by whole 16-column slices:
// warpgroup 0 takes the first ceil(slices / 2)
template <int D>
__host__ __device__ constexpr int dq_cols0() {
  return (padded<D>() / 16 + 1) / 2 * 16;
}

// bytes: K and V (kKeys x DP each), NS stages of Q and dO (kQ x DP each),
// two dS buffers (kKeys x kQ), dQ staging (kQ x DP fp32), NS stages of the
// lse / D rows (2 x 64 fp32), barriers and the last-split flag
template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + (size_t)2 * kKeys * padded<D>() * 2
         + (size_t)stages<D>() * 2 * kQ * padded<D>() * 2
         + (size_t)2 * kKeys * kQ * 2 + (size_t)kQ * padded<D>() * 4
         + (size_t)stages<D>() * 512 + (size_t)(2 * stages<D>() + 2) * 8;
}

struct Args {
  CUtensorMap tmK, tmV, tmQ, tmO;     // tmO: dO
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;                   // (B, nh, Sq), base 2
  float* dvec;                        // (B, nh, Sqp): D, pad rows 0
  float* lse_pad;                     // (B, nh, Sqp): lse, pad rows 0
  float* dq_acc;                      // (B, nh, Sqp / 64) tiles of 64 x DP
  float* part;                        // (2, nsplit, B, nkv, nkt, 2) tiles
  int* arrivals;                      // (B, nkv, nkt): splits finished
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int B, Sq, Sk, nh, nkv, g, causal, window;
  int nsplit, Sqp, nkt;
  float scale, scale_log2;
};

// The 64-query tiles that see some key of [k0, k0 + kKeys): nq tiles from
// t_begin (causal: queries from k0 on; a window: up to k0 + kKeys - 1 +
// window). The kernel walks them; the split choice counts them.
__host__ __device__ __forceinline__ void query_tiles(int k0, int Sq,
                                                     int causal, int window,
                                                     int* t_begin, int* nq) {
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? (Sq < k0 + kKeys - 1 + window
                                     ? Sq : k0 + kKeys - 1 + window)
                              : Sq;
  *t_begin = q_lo / kQ * kQ;
  *nq = q_hi > *t_begin ? (q_hi - *t_begin + kQ - 1) / kQ : 0;
}

// -- PTX helpers ---------------------------------------------------------------
__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared_f2(uint32_t addr, float x,
                                             float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n"
               :: "r"(addr), "f"(x), "f"(y) : "memory");
}

// `bytes` (a multiple of 16) from global to shared memory, completing on
// `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// global[0, bytes) += shared[0, bytes), fp32, by the TMA unit
__device__ __forceinline__ void bulk_reduce_add(float* dst, uint32_t src,
                                                uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
      "[%0], [%1], %2;\n"
      :: "l"(dst), "r"(src), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's bulk groups have read their shared-memory source
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ... and have completed
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// at most N wgmma groups of this warpgroup still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// D (64 x N, fp32) (+)= A (64 x 16, shared, K-major) B (16 x N, shared,
// K-major); acc = 0 overwrites D
template <int N>
__device__ void mma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc);
// the same with A and B both MN-major (transposed)
template <int N>
__device__ void mma_ss_t(float (&d)[N / 2], uint64_t da, uint64_t db,
                         int acc);

template <>
__device__ __forceinline__ void mma_ss<64>(float (&d)[32], uint64_t da,
                                        uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void mma_ss_t<16>(float (&d)[8], uint64_t da,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void mma_ss_t<32>(float (&d)[16], uint64_t da,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void mma_ss_t<48>(float (&d)[24], uint64_t da,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void mma_ss_t<64>(float (&d)[32], uint64_t da,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// -- prep: D, the padded log-sum-exp, the zeroed dQ accumulator ----------------
template <int D>
__global__ void __launch_bounds__(256) prep_kernel(const Args a) {
  constexpr int DP = padded<D>();
  // one warp per padded row (b, h, i), i fastest
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (a.arrivals)
    for (long long j = (long long)blockIdx.x * 256 + threadIdx.x;
         j < (long long)a.B * a.nkv * a.nkt; j += (long long)gridDim.x * 256)
      a.arrivals[j] = 0;
  if (row >= (long long)a.B * a.nh * a.Sqp) return;
  const int i = row % a.Sqp;
  const long long bh = row / a.Sqp;
  const int h = bh % a.nh, b = bh / a.nh;
  float acc = 0.f;
  if (i < a.Sq && lane < D / 4) {     // four columns a lane, 8-byte loads
    const long long at = (((long long)b * a.Sq + i) * a.nh + h) * D;
    const uint2 o = reinterpret_cast<const uint2*>(a.o + at)[lane];
    const uint2 g = reinterpret_cast<const uint2*>(a.dout + at)[lane];
    acc = lo_f(o.x) * lo_f(g.x) + hi_f(o.x) * hi_f(g.x)
          + lo_f(o.y) * lo_f(g.y) + hi_f(o.y) * hi_f(g.y);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    a.dvec[row] = acc;
    a.lse_pad[row] = i < a.Sq ? a.lse[bh * a.Sq + i] : 0.f;
  }
  // the 64 rows of a query tile zero its 64 x DP accumulator floats, DP
  // each (row (b, h, i) owns floats [row * DP, row * DP + DP))
  if (lane < DP / 4)
    reinterpret_cast<float4*>(a.dq_acc + row * DP)[lane] =
        make_float4(0.f, 0.f, 0.f, 0.f);
}

// -- main ----------------------------------------------------------------------
// dQ columns [16 S0, 16 S0 + N) of this step (one warpgroup's share) =
// dS (kQ x kKeys, MN-major in shared memory) K (kKeys x DP, MN-major), then
// staged in fragment order and reduce-added into the accumulator tile
template <int N, int S0>
__device__ __forceinline__ void dq_step(uint32_t s_ds, uint32_t s_k,
                                        uint32_t stg, float* acc_tile,
                                        int t, int w) {
  float acc[N / 2];
#pragma unroll
  for (int j = 0; j < N / 2; ++j) acc[j] = 0.f;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
    mma_ss_t<N>(acc, desc32(s_ds + kk * 16 * 32, kKeys * 32, 256),
                desc32(s_k + S0 * kKeys * 32 + kk * 16 * 32, kKeys * 32, 256),
                kk > 0);
  wgmma_commit();
  wgmma_wait0();
  fence_regs(acc);
  if (t == 0) bulk_wait_read();      // the last step's reduce read `stg`
  named_sync(2 + w, 128);
#pragma unroll
  for (int jp = 0; jp < N / 4; ++jp)
    st_shared_f2(stg + (jp * 128 + t) * 8, acc[2 * jp], acc[2 * jp + 1]);
  fence_async_smem();
  named_sync(2 + w, 128);
  if (t == 0) bulk_reduce_add(acc_tile, stg, kQ * N * 4);
}

template <int D>
__device__ __forceinline__ void bwd_main(const Args& a) {
  constexpr int DP = padded<D>(), NC = DP / 16, NS = stages<D>();
  constexpr int N0 = dq_cols0<D>(), N1 = DP - N0;
  constexpr uint32_t kSliceK = kKeys * 32, kSliceQ = kQ * 32;
  constexpr uint32_t kTileK = kKeys * DP * 2, kTileQ = kQ * DP * 2;
  constexpr uint32_t kDs = kKeys * kQ * 2;    // one dS buffer, bytes
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const float* sbase = reinterpret_cast<const float*>(smem_raw + (base - raw));
  const uint32_t sK = base, sV = sK + kTileK;
  const uint32_t sStage = sV + kTileK;        // stage s: Q, then dO
  const uint32_t sDS = sStage + NS * 2 * kTileQ;
  const uint32_t sDQ = sDS + 2 * kDs;         // dQ staging, kQ x DP fp32
  const uint32_t sRows = sDQ + kQ * DP * 4;   // stage s: 64 lse, 64 D
  const uint32_t bars = sRows + NS * 512;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (NS + s); };
  const uint32_t kv_bar = bars + 16u * NS;
  volatile int* last = reinterpret_cast<volatile int*>(
      smem_raw + (kv_bar + 8 - raw));       // this split sums the partials

  // this CTA's keys and its share of their steps: step j of the key tile
  // is query tile j % nq of query head kvh * g + j / nq; split `split`
  // takes steps [j0, j0 + n_steps)
  const int split = blockIdx.x % a.nsplit, kvh = blockIdx.x / a.nsplit;
  const int kt = blockIdx.y, b = blockIdx.z, k0 = kt * kKeys;
  int t_begin, nq;
  query_tiles(k0, a.Sq, a.causal, a.window, &t_begin, &nq);
  const int all = a.g * nq, j0 = (int)((long long)all * split / a.nsplit);
  const int n_steps = (int)((long long)all * (split + 1) / a.nsplit) - j0;
  const int h0 = kvh * a.g;
  const int tid = threadIdx.x, wg = tid / 128;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128 * kConsumers);
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer warpgroup: K / V once, then the Q / dO / rows ring ----
    sm90::setmaxnreg_dec<24>();
    if (tid != 128 * kConsumers) return;
    mbar_expect_tx(kv_bar, 2 * kTileK);
#pragma unroll 1
    for (int c = 0; c < NC; ++c) {
      tma_load_4d(sK + c * kSliceK, &a.tmK, kv_bar, 16 * c, kvh, k0, b);
      tma_load_4d(sV + c * kSliceK, &a.tmV, kv_bar, 16 * c, kvh, k0, b);
    }
    for (int i = 0; i < n_steps; ++i) {
      const int s = i % NS, h = h0 + (j0 + i) / nq;
      const int i0 = t_begin + (j0 + i) % nq * kQ;
      mbar_wait(empty(s), ((i / NS) & 1) ^ 1);
      mbar_expect_tx(full(s), 2 * kTileQ + 512);
      const uint32_t dq = sStage + 2 * s * kTileQ, dov = dq + kTileQ;
#pragma unroll 1
      for (int c = 0; c < NC; ++c) {
        tma_load_4d(dq + c * kSliceQ, &a.tmQ, full(s), 16 * c, h, i0, b);
        tma_load_4d(dov + c * kSliceQ, &a.tmO, full(s), 16 * c, h, i0, b);
      }
      const long long r = ((long long)b * a.nh + h) * a.Sqp + i0;
      bulk_load(sRows + 512 * s, a.lse_pad + r, 256, full(s));
      bulk_load(sRows + 512 * s + 256, a.dvec + r, 256, full(s));
    }
    return;
  }

  // ---- consumer warpgroups 0 and 1: keys kw .. kw + 63 each ----
  sm90::setmaxnreg_inc<240>();
  const int w = wg, t = tid % 128, lane = tid % 32;
  const int kw = k0 + 64 * w;
  const int r0 = 16 * (t / 32) + lane / 4;    // accumulator rows r0, r0 + 8
  const float sc = a.scale_log2;
  float dk[DP / 2], dv[DP / 2], st[kQ / 2], dpt[kQ / 2];
#pragma unroll
  for (int j = 0; j < DP / 2; ++j) dk[j] = dv[j] = 0.f;
#pragma unroll
  for (int j = 0; j < kQ / 2; ++j) st[j] = dpt[j] = 0.f;
  mbar_wait(kv_bar, 0);

  for (int i = 0; i < n_steps; ++i) {
    const int s = i % NS, h = h0 + (j0 + i) / nq;
    const int i0 = t_begin + (j0 + i) % nq * kQ;
    const uint32_t sq = sStage + 2 * s * kTileQ, so = sq + kTileQ;
    const uint32_t ds = sDS + (i & 1) * kDs;
    mbar_wait(full(s), (i / NS) & 1);
    __syncwarp();                   // wgmma wants the warp converged

    // S^T = K Q^T and dP^T = V dO^T: this warpgroup's 64 keys x kQ queries,
    // two wgmma groups
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
      mma_ss<kQ>(st, desc32(sK + c * kSliceK + 64 * w * 32, 16, 256),
                 desc32(sq + c * kSliceQ, 16, 256), c > 0);
    wgmma_commit();
#pragma unroll
    for (int c = 0; c < NC; ++c)
      mma_ss<kQ>(dpt, desc32(sV + c * kSliceK + 64 * w * 32, 16, 256),
                 desc32(so + c * kSliceQ, 16, 256), c > 0);
    wgmma_commit();
    wgmma_wait<1>();                // S^T is in; dP^T may still run
    fence_regs(st);

    // P^T = exp2(S^T scale log2(e) - lse), masked only where a pair of the
    // 64 x 64 block is hidden
    const float* rows = sbase + (sRows - base) / 4 + 128 * s;
    const bool whole = i0 + kQ <= a.Sq && kw + 64 <= a.Sk
                       && (!a.causal || kw + 63 <= i0)
                       && (a.window <= 0 || kw > i0 + kQ - 1 - a.window);
#pragma unroll
    for (int jj = 0; jj < kQ / 8; ++jj) {
      const int c = 8 * jj + 2 * (lane % 4);              // query i0 + c
      const float2 l2 = *reinterpret_cast<const float2*>(rows + c);
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        const int j = 4 * jj + e4, e = e4 & 1;
        float p = ex2(fmaf(st[j], sc, -(e ? l2.y : l2.x)));
        if (!whole) {
          const int key = kw + r0 + 8 * (e4 >> 1), q = i0 + c + e;
          const bool vis = q < a.Sq && key < a.Sk
                           && (!a.causal || key <= q)
                           && (a.window <= 0 || key > q - a.window);
          p = vis ? p : 0.f;
        }
        st[j] = p;
      }
    }
    // dV += P^T dO (P^T as bf16 A fragments: 16 queries = accumulator
    // n-blocks 2kk, 2kk + 1; dO MN-major: LBO one 16-column slice), issued
    // before dS^T is computed
    uint32_t pf[kQ / 16][4], sf[kQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        pf[kk][q] = pack_bf16(st[8 * kk + 2 * q], st[8 * kk + 2 * q + 1]);
    fence_regs(dv);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk)
      wgmma_rs<DP>(dv, pf[kk], desc32(so + kk * 16 * 32, kSliceQ, 256), 1);
    wgmma_commit();
    wgmma_wait<1>();                // dP^T is in; dV may still run
    fence_regs(dpt);

    // dS^T = P^T o (dP^T - D), into this step's dS buffer too: (key,
    // query) at query slice kk, key row 64 w + row
#pragma unroll
    for (int jj = 0; jj < kQ / 8; ++jj) {
      const float2 d2 = *reinterpret_cast<const float2*>(
          rows + 64 + 8 * jj + 2 * (lane % 4));
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        const int j = 4 * jj + e4;
        dpt[j] = st[j] * (dpt[j] - ((e4 & 1) ? d2.y : d2.x));
      }
    }
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        sf[kk][q] = pack_bf16(dpt[8 * kk + 2 * q], dpt[8 * kk + 2 * q + 1]);
        st_shared_u32(ds + kk * kSliceK +
                          swz32(64 * w + r0 + 8 * (q & 1), q >> 1) +
                          4 * (lane % 4),
                      sf[kk][q]);
      }
    // dK += dS^T Q (Q MN-major)
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk)
      wgmma_rs<DP>(dk, sf[kk], desc32(sq + kk * 16 * 32, kSliceQ, 256), 1);
    wgmma_commit();

    // both warpgroups' dS^T are in the buffer: dQ = dS K, split by columns
    fence_async_smem();
    named_sync(1, 128 * kConsumers);
    float* tile = a.dq_acc +
                  (((long long)b * a.nh + h) * (a.Sqp / kQ) + i0 / kQ) *
                      (kQ * DP);
    if (w == 0)
      dq_step<N0, 0>(ds, sK, sDQ, tile, t, w);
    else if constexpr (N1 > 0)
      dq_step<N1, N0 / 16>(ds, sK, sDQ + kQ * N0 * 4, tile + kQ * N0, t, w);
    else
      wgmma_wait0();
    fence_regs(dv);
    fence_regs(dk);
    mbar_arrive(empty(s));          // Q, dO and the rows of stage s are read
  }
  if (t == 0) bulk_wait();

  // dK, dV: with a split, this split's fp32 partials first; the split of
  // the key tile that arrives last reads them all back, summed in split
  // order into dk / dv (so the sum is the same whichever split is last)
  if (a.nsplit > 1) {
    const long long halves = (long long)a.B * a.nkv * a.nkt * 2;
    const long long tile = (((long long)b * a.nkv + kvh) * a.nkt + kt) * 2
                           + w;
    float2* pk = reinterpret_cast<float2*>(a.part) + tile * (32 * DP);
    float2* pv = pk + a.nsplit * halves * (32 * DP);
    const long long step = halves * (32 * DP);    // one split's partials
#pragma unroll
    for (int jp = 0; jp < DP / 4; ++jp) {
      pk[split * step + jp * 128 + t] = make_float2(dk[2 * jp], dk[2 * jp + 1]);
      pv[split * step + jp * 128 + t] = make_float2(dv[2 * jp], dv[2 * jp + 1]);
    }
    __threadfence();
    named_sync(1, 128 * kConsumers);
    if (tid == 0)
      *last = atomicAdd(a.arrivals + (((long long)b * a.nkv + kvh) * a.nkt
                                      + kt), 1) == a.nsplit - 1;
    named_sync(1, 128 * kConsumers);
    if (!*last) return;
    __threadfence();
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) dk[j] = dv[j] = 0.f;
    for (int sp = 0; sp < a.nsplit; ++sp) {   // dK's, then dV's: the
#pragma unroll                                // loads in flight fit
      for (int jp = 0; jp < DP / 4; ++jp) {
        const float2 x = __ldcg(pk + sp * step + jp * 128 + t);
        dk[2 * jp] += x.x;
        dk[2 * jp + 1] += x.y;
      }
    }
    for (int sp = 0; sp < a.nsplit; ++sp) {
#pragma unroll
      for (int jp = 0; jp < DP / 4; ++jp) {
        const float2 x = __ldcg(pv + sp * step + jp * 128 + t);
        dv[2 * jp] += x.x;
        dv[2 * jp + 1] += x.y;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < DP / 2; j += 2) {
    const int key = kw + r0 + 8 * ((j >> 1) & 1);
    const int col = 8 * (j >> 2) + 2 * (lane % 4);
    if (key < a.Sk && col < D) {
      const long long o = (((long long)b * a.Sk + key) * a.nkv + kvh) * D
                          + col;
      *reinterpret_cast<uint32_t*>(a.dk + o) =
          pack_bf16(dk[j] * a.scale, dk[j + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(a.dv + o) = pack_bf16(dv[j], dv[j + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
main_kernel(const __grid_constant__ Args a) {
  bwd_main<D>(a);
}

// -- post: dQ to bf16; dK / dV summed over the splits --------------------------
// (row, col) of float2 `f` of a 64 x N tile in fragment order: float2
// jp * 128 + t holds pair jp of wgmma accumulator thread t, columns col and
// col + 1 of row `row`
__device__ __forceinline__ void frag_pos(int f, int* row, int* col) {
  const int jp = f / 128, t = f % 128, lane = t % 32;
  *row = 16 * (t / 32) + lane / 4 + 8 * (jp & 1);
  *col = 8 * (jp >> 1) + 2 * (lane % 4);
}

// one CTA per 64-query tile of the dQ accumulator: the fp32 tile read in
// fragment order (coalesced), bf16 rows staged in shared memory (row
// stride DP + 8: conflict-free), then written whole
template <int D>
__global__ void __launch_bounds__(256) post_kernel(const Args a) {
  constexpr int DP = padded<D>(), LD = DP + 8, N0 = dq_cols0<D>();
  __shared__ __align__(16) __nv_bfloat16 rows[64 * LD];
  const int tile = blockIdx.x, nqt = a.Sqp / kQ;
  const int qt = tile % nqt, h = (tile / nqt) % a.nh, b = tile / nqt / a.nh;
  const float2* src =
      reinterpret_cast<const float2*>(a.dq_acc + (long long)tile * kQ * DP);
  for (int f = threadIdx.x; f < 32 * DP; f += 256) {
    const bool hi = f >= 32 * N0;     // warpgroup 1's columns
    int row, col;
    frag_pos(hi ? f - 32 * N0 : f, &row, &col);
    const float2 x = src[f];
    *reinterpret_cast<uint32_t*>(rows + row * LD + col + (hi ? N0 : 0)) =
        pack_bf16(x.x * a.scale, x.y * a.scale);
  }
  __syncthreads();
  for (int p = threadIdx.x; p < 64 * (D / 8); p += 256) {
    const int r = p / (D / 8), piece = p % (D / 8), i = qt * kQ + r;
    if (i < a.Sq)
      *reinterpret_cast<uint4*>(
          a.dq + (((long long)b * a.Sq + i) * a.nh + h) * D + piece * 8) =
          *reinterpret_cast<const uint4*>(rows + r * LD + piece * 8);
  }
}

// -- host side -----------------------------------------------------------------
// How many CTAs share each (key tile, KV head, row): the count that gives
// the least estimated finish time, in steps of the busiest SM, over 1-16.
// The estimate is the largest of the longest CTA's steps, the mean load of
// an SM and (whole waves) x the shortest CTA's steps, plus two steps for
// each split past the first (a CTA's start, its fp32 partials written and
// read back; two fits the H100 timings of chip_smoke.py's backward shapes,
// where one split too many at g = 12 cost more than it saved).
inline int splits(int B, int Sq, int Sk, int nh, int nkv, int causal,
                  int window, int sm_count) {
  const int g = nh / nkv, nkt = (Sk + kKeys - 1) / kKeys;
  long long total = 0;
  int most = 0, least = 1 << 30;
  for (int kt = 0; kt < nkt; ++kt) {
    int t_begin, nq;
    query_tiles(kt * kKeys, Sq, causal, window, &t_begin, &nq);
    total += (long long)g * nq;
    most = std::max(most, g * nq);
    if (nq > 0) least = std::min(least, g * nq);
  }
  if (most == 0) return 1;
  const double mean = (double)total * nkv * B / sm_count;
  int best = 1;
  double best_t = 0;
  for (int ns = 1; ns <= std::min(16, most); ++ns) {
    const long long ctas = (long long)nkt * nkv * B * ns;
    const double waves = (double)((ctas + sm_count - 1) / sm_count);
    const double t = std::max({(double)((most + ns - 1) / ns), mean,
                               waves * (least / ns)}) + 2 * (ns - 1);
    if (ns == 1 || t < best_t) {
      best = ns;
      best_t = t;
    }
  }
  return best;
}

// fp32 scratch the body needs, in floats: D and the padded lse
// (B, nh, Sqp) each, the dQ accumulator (B, nh, Sqp, DP) and, with a split,
// dK / dV partials (2, nsplit, B, nkv, nkt, 128, DP) and the int arrival
// counters (B, nkv, nkt)
inline long long work_floats(int B, int Sq, int Sk, int nh, int nkv, int d,
                             int nsplit) {
  const long long dp = (d + 15) / 16 * 16;
  const long long sqp = (long long)(Sq + kQ - 1) / kQ * kQ;
  const long long nkt = (Sk + kKeys - 1) / kKeys;
  return (long long)B * nh * sqp * (2 + dp)
         + (nsplit > 1 ? (2LL * nsplit * kKeys * dp + 1) * B * nkv * nkt
                       : 0);
}

template <int D>
cudaError_t launch(Args& a, float* work, int nsplit, cudaStream_t s) {
  constexpr int DP = padded<D>();
  a.g = a.nh / a.nkv;
  a.nsplit = nsplit;
  a.Sqp = (a.Sq + kQ - 1) / kQ * kQ;
  a.nkt = (a.Sk + kKeys - 1) / kKeys;
  const long long rows = (long long)a.B * a.nh * a.Sqp;
  a.dvec = work;
  a.lse_pad = work + rows;
  a.dq_acc = work + 2 * rows;
  a.part = nsplit > 1 ? a.dq_acc + rows * DP : nullptr;
  a.arrivals = nsplit > 1 ? reinterpret_cast<int*>(
      a.part + 2LL * nsplit * a.B * a.nkv * a.nkt * kKeys * DP) : nullptr;
  cudaError_t e = rt::launch<prep_kernel<D>>(
      dim3((unsigned)((rows + 7) / 8)), 256, 0, a, s);
  if (e != cudaSuccess) return e;
  e = rt::launch<main_kernel<D>>(dim3(a.nkv * nsplit, a.nkt, a.B), kThreads,
                                 smem_bytes<D>(), a, s);
  if (e != cudaSuccess) return e;
  return rt::launch<post_kernel<D>>(dim3(a.B * a.nh * (a.Sqp / kQ)), 256, 0,
                                    a, s);
}

}  // namespace bwd
}  // namespace rt

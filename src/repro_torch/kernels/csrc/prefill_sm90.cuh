// bf16 prefill-attention body for Hopper (sm_90a): the flash and chunk
// kernels' tensor-core path (flash_attention.cu, chunk_attention.cu).
//
// One CTA owns one (batch row, KV head, tile of TQ = 128 / g query
// positions) and holds those positions x the g query heads that share the
// KV head: 128 packed query rows, so every K/V tile it stages serves all of
// them. Row r is query position j0 + r / g of head kvh * g + r % g. Flash
// and contiguous chunk prefill differ only in the position offset (0, or
// bases[b]) and in `causal`; the paged chunk kernel differs in where a key
// lives (pool row tbl[b, t / bs] * bs + t % bs).
//
// Warp specialisation, 384 threads:
//  * warpgroups 0 and 1 consume: 64 rows each, S = Q K^T as
//    wgmma.m64n128k16 from shared memory, an online softmax in registers
//    (exp2 with scale * log2(e) folded in; masks only on the tiles that
//    cross the causal diagonal, the window edge or the end of the keys),
//    then O += P V as wgmma.m64n{D}k16 with P packed to bf16 in registers
//    (the A operand) and V read MN-major from shared memory;
//  * warpgroup 2 produces: it keeps a ring of stages<D>() K/V tiles of
//    kKT = 128 keys in flight (2 at d = 120, 128, 4 below: what fits beside Q
//    in shared memory), each stage completing on a "full" mbarrier, and
//    reuses a stage once both consumers arrived on its "empty" mbarrier.
//  `setmaxnreg` gives the producer 56 registers and the consumers 224.
//  Each consumer runs S, softmax and PV of a tile in turn; the two
//  warpgroups interleave on the tensor cores. (Issuing S of the next tile
//  before PV of the last, FA3's in-warpgroup overlap, measured slower
//  here: it holds each stage one pass longer.)
//
// Copy engine per layout:
//  * contiguous K/V (flash; contig chunk): TMA. A 4-D tensor map over the
//    (B, S, nkv, D) cache, boxes of (16 columns x kKT keys) of one head:
//    D/16 boxes each for K and V per stage, issued by one thread, each box
//    landing as one slice of the swizzled layout below; keys past the row's
//    S are zero-filled by the hardware. The maps are encoded on the host in
//    the entry point: two cuTensorMapEncodeTiled calls per launch, pure
//    host work with no device round trip (chip_smoke.py phase 3 logs the
//    host time per call); cuTensorMapEncodeTiled is looked up in
//    libcuda.so.1 once with dlsym, so the library needs no link to it.
//  * paged K/V (chunk): cp.async, 16 bytes per thread, all 128 producer
//    threads. A 16-token pool block is smaller than a tile and every key's
//    row comes through the block table, so a TMA box per block would mean
//    kKT / bs x 2 boxes a stage; cp.async writes the same swizzled layout
//    at any block size and zero-fills keys outside [kv_lo, kv_hi) itself.
//    Each producer thread's copies arrive on the stage's mbarrier when they
//    land (cp.async.mbarrier.arrive), so several stages are in flight; the
//    writes are generic-proxy, and each consumer fences them to the async
//    proxy after its wait, before its wgmma reads the tile.
//
// Shared-memory layout (every operand): D/16 slices of 16 columns, each a
// (rows x 32 B) K-major block in the 32-byte swizzle (16-byte halves of a
// row swapped when bit 2 of the row is set). It is the same for every head
// dim (16, 32, 64, 80, 128: all multiples of 16), so d = 80's 160-byte rows
// need no remainder tile; each k-step of 16 columns is one slice. d = 120
// (h2o-danube-3-4b) runs as 128 in shared memory: its 240-byte rows fill
// 7.5 slices, and the last slice's 8 tail columns are zero in Q (the
// consumers' loads), K and V (TMA's fill past the tensor map's 120
// columns; cp.async with no source bytes), so Q K^T takes 8 whole k16
// steps and P V runs at N = 128, whose 8 tail columns are never stored.
// Nothing outside shared memory is padded or copied. Q, K:
// K-major descriptors (SBO 256 B: 8 rows x 32 B). V: the same bytes read
// MN-major (transposed B): LBO = one slice (16 columns of D), SBO = 8 keys.
//
// Numerics as the fp32 body and the plain version: fp32 scores and
// softmax, masked scores -1e30 and masked probabilities exactly 0, P
// rounded to bf16 before the PV product, the output divided by max(l,
// 1e-30). Keys past kv_hi inside a contiguous tile are real cache rows
// (finite) or TMA zero-fill, and get P = 0. With `lse` set (the flash
// forward of a training step), the epilogue also stores each row's
// log-sum-exp in BASE-2 units, m + log2(l) over scores scaled by
// scale * log2(e), which the backward (flash_attention_bwd.cu) reads back
// as P = exp2(s * scale * log2(e) - lse); the chunk kernels leave it null.
#pragma once

#include <cuda.h>
#include <dlfcn.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace rt {
namespace sm90 {

constexpr int kKT = 128;              // keys per tile
constexpr int kRows = 128;            // packed query rows per CTA
constexpr int kConsumers = 2;         // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
__host__ __device__ constexpr int stages() { return D <= 80 ? 4 : 2; }

// the head dim as shared memory holds it: whole 16-column slices (d = 120
// is 7.5 slices; its tail columns are zero in Q and K, so every k-step of
// the Q K^T contraction is a whole wgmma k16, and O's tail is never stored)
template <int D>
__host__ __device__ constexpr int padded() { return (D + 15) / 16 * 16; }

// bytes: Q (kRows x DP), then kStages x (K, V) tiles (kKT x DP), barriers
template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024                                        // alignment slack
         + (size_t)kRows * padded<D>() * 2
         + (size_t)stages<D>() * 2 * kKT * padded<D>() * 2
         + (size_t)stages<D>() * 2 * 8;
}

struct PrefillArgs {
  CUtensorMap tmK, tmV;     // contiguous K/V (unused when paged)
  const __nv_bfloat16* q;
  __nv_bfloat16* out;
  const __nv_bfloat16* k;   // paged pool (n_blocks, bs, nkv, D)
  const __nv_bfloat16* v;
  const int* tbl;           // paged: (B, mb) block table
  const int* bases;         // per-row position offsets; null: 0
  float* lse;               // flash with a gradient: (B, nh, Sq); null: off
  int B, Sq, nh, nkv, g, tq;
  int S;                    // keys a row holds (flash Sk; mb * bs paged)
  int bs, mb, causal, window;
  float scale_log2;         // softmax scale * log2(e)
};

// -- PTX helpers ---------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Waits for the phase with `parity` to complete. A wait that lasts ~10 s
// (a broken pipeline) traps, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > 20000000000LL) __trap();
  }
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// arrive on `bar` once every cp.async this thread issued has completed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

// byte offset of 16-byte piece `half` (0, 1) of row `row` inside one
// 32-byte-swizzled slice (the pattern TMA's SWIZZLE_32B writes)
__device__ __forceinline__ uint32_t swz32(int row, int half) {
  return row * 32 + ((half ^ ((row >> 2) & 1)) << 4);
}

// wgmma shared-memory descriptor, 32-byte swizzle
__device__ __forceinline__ uint64_t desc32(uint32_t addr, uint32_t lbo,
                                           uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | (uint64_t)((lbo >> 4) & 0x3FFF) << 16
         | (uint64_t)((sbo >> 4) & 0x3FFF) << 32
         | (uint64_t)3 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundary
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D (64 x N, fp32) (+)= A (64 x 16, shared, K-major) B (16 x N, shared,
// K-major); acc = 0 overwrites D
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                         int acc);
// D (64 x N) (+)= A (64 x 16, registers) B (16 x N, shared, MN-major)
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                         uint64_t db, int acc);

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}


// -- the body ------------------------------------------------------------------
template <int D, bool kPaged>
__device__ __forceinline__ void prefill(const PrefillArgs& a) {
  constexpr int NS = stages<D>();
  constexpr int DP = padded<D>();
  constexpr int NC = DP / 16;                 // 16-column slices
  constexpr int NP = D / 8;                   // 16-byte pieces of a row
  constexpr int NPP = DP / 8;                 // the same, padded (zero tail)
  constexpr uint32_t kSliceQ = kRows * 32, kSliceKV = kKT * 32;
  constexpr uint32_t kTile = kKT * DP * 2;    // one K or V tile, bytes
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sbase = smem_raw + (base - raw);
  const uint32_t sQ = base;
  const uint32_t sKV = base + kRows * DP * 2; // stage s: K at +2s tiles
  const uint32_t bars = sKV + NS * 2 * kTile;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (NS + s); };

  // this CTA's rows and the keys they reach; causal CTAs longest first
  const int it = gridDim.x - 1 - blockIdx.x, kvh = blockIdx.y;
  const int b = blockIdx.z, g = a.g;
  const int j0 = it * a.tq, nq = min(a.tq, a.Sq - j0), rows = nq * g;
  const int first = (a.bases ? a.bases[b] : 0) + j0, last = first + nq - 1;
  const int kv_lo = a.window > 0 ? max(0, first - a.window + 1) : 0;
  const int kv_hi = a.causal ? min(last + 1, a.S) : a.S;
  const int t_begin = kv_lo / kKT * kKT;
  const int n_tiles = kv_hi > t_begin ? (kv_hi - t_begin + kKT - 1) / kKT : 0;
  const int tid = threadIdx.x, wg = tid / 128;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), kPaged ? 128 : 1);
      mbar_init(empty(s), 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer warpgroup: the K/V ring ----
    setmaxnreg_dec<56>();
    const int pt = tid - 128 * kConsumers;
    if constexpr (!kPaged) {
      if (pt != 0) return;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % NS, t0 = t_begin + i * kKT;
        mbar_wait(empty(s), ((i / NS) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * kTile);
        const uint32_t dk = sKV + 2 * s * kTile, dv = dk + kTile;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          tma_load_4d(dk + c * kSliceKV, &a.tmK, full(s), 16 * c, kvh, t0, b);
          tma_load_4d(dv + c * kSliceKV, &a.tmV, full(s), 16 * c, kvh, t0, b);
        }
      }
    } else {
      // producer warp pw copies keys [KW pw, KW pw + KW) of each tile; its
      // lane l looks up key KW pw + l's pool row once, and the row offsets
      // are shuffled to the lanes that copy that key's 16-byte pieces
      // (consecutive lanes on consecutive pieces of a row)
      constexpr int KW = kKT / 4;
      static_assert(KW <= 32 && KW * NPP % 32 == 0, "producer warp tiling");
      const int* tbl_row = a.tbl + (long long)b * a.mb;
      const int lane = pt % 32, pw = pt / 32;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % NS, t0 = t_begin + i * kKT;
        const int t = t0 + KW * pw + lane;
        long long mine = -1;        // element offset of key t's head row
        if (lane < KW && t >= kv_lo && t < kv_hi)
          mine = ((long long)tbl_row[t / a.bs] * a.bs + t % a.bs) * a.nkv
                 * D + (long long)kvh * D;
        mbar_wait(empty(s), ((i / NS) & 1) ^ 1);
        const uint32_t dk = sKV + 2 * s * kTile, dv = dk + kTile;
#pragma unroll 4
        for (int it = 0; it < KW * NPP / 32; ++it) {
          const int idx = it * 32 + lane, kl = idx / NPP, piece = idx % NPP;
          const long long off = __shfl_sync(0xffffffffu, mine, kl);
          const uint32_t o =
              (piece >> 1) * kSliceKV + swz32(KW * pw + kl, piece & 1);
          const bool ok = off >= 0 && piece < NP;   // the pad piece: zeros
          const long long src = ok ? off + piece * 8 : 0;
          cp_async16(dk + o, a.k + src, ok ? 16 : 0);
          cp_async16(dv + o, a.v + src, ok ? 16 : 0);
        }
        cp_async_arrive(full(s));   // arrives when this thread's copies land
      }
      cp_async_wait_all();
    }
    return;
  }

  // ---- consumer warpgroups 0 and 1: 64 rows each ----
  setmaxnreg_inc<224>();
  const int w = wg, lane = tid % 32;
  // Q: 128 rows x DP, 16-byte loads, pad rows and pad columns zero
  for (int idx = tid; idx < kRows * NPP; idx += 128 * kConsumers) {
    const int r = idx / NPP, piece = idx % NPP;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < rows && piece < NP) {
      const long long qi =
          (((long long)b * a.Sq + j0 + r / g) * a.nh + kvh * g + r % g) * D;
      val = *reinterpret_cast<const uint4*>(a.q + qi + piece * 8);
    }
    *reinterpret_cast<uint4*>(sbase + (piece >> 1) * kSliceQ +
                              swz32(r, piece & 1)) = val;
  }
  fence_async_smem();
  named_sync(1, 128 * kConsumers);

  // this thread's two rows (accumulator rows lane / 4 and + 8 of its warp)
  const int ra = 64 * w + 16 * ((tid % 128) / 32) + lane / 4, rb = ra + 8;
  const int pa = first + min(ra, rows - 1) / g;     // pad rows: last row's
  const int pb = first + min(rb, rows - 1) / g;
  // the keys each row sees: [lo, hi]
  const int hia = a.causal ? min(pa, kv_hi - 1) : kv_hi - 1;
  const int hib = a.causal ? min(pb, kv_hi - 1) : kv_hi - 1;
  const int loa = a.window > 0 ? pa - a.window + 1 : 0;
  const int lob = a.window > 0 ? pb - a.window + 1 : 0;
  const float sc = a.scale_log2;
  float o[DP / 2], sacc[kKT / 2];
#pragma unroll
  for (int j = 0; j < DP / 2; ++j) o[j] = 0.f;
#pragma unroll
  for (int j = 0; j < kKT / 2; ++j) sacc[j] = 0.f;
  float ma = kNegInf, mb = kNegInf, la = 0.f, lb = 0.f;
  const uint32_t q_w = sQ + w * 64 * 32;            // this warpgroup's rows

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % NS, t0 = t_begin + i * kKT;
    const uint32_t sk = sKV + 2 * s * kTile, sv = sk + kTile;
    mbar_wait(full(s), (i / NS) & 1);
    __syncwarp();                   // wgmma wants the warp converged
    // cp.async wrote the paged tile through the generic proxy
    if constexpr (kPaged) fence_async_smem();

    // S = Q K^T (64 x kKT per warpgroup), fp32
    fence_regs(sacc);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
      wgmma_ss<kKT>(sacc, desc32(q_w + c * kSliceQ, 16, 256),
                    desc32(sk + c * kSliceKV, 16, 256), c > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sacc);

    // scale into the log2 domain; mask only tiles that cross an edge
    const bool whole = t0 + kKT <= kv_hi
                       && (!a.causal || t0 + kKT - 1 <= first)
                       && (a.window <= 0 || t0 > last - a.window);
    // bounds relative to this thread's first column of the tile
    const int c0 = t0 + 2 * (lane % 4);
    const int rla = loa - c0, rha = hia - c0, rlb = lob - c0, rhb = hib - c0;
    float mxa = ma, mxb = mb;
#pragma unroll
    for (int j = 0; j < kKT / 2; ++j) {
      float x = sacc[j] * sc;
      if (!whole) {
        const int col = 8 * (j / 4) + (j & 1);
        const bool vis = (j & 2) ? (col >= rlb && col <= rhb)
                                 : (col >= rla && col <= rha);
        x = vis ? x : kNegInf;
      }
      sacc[j] = x;
      if (j & 2) mxb = fmaxf(mxb, x);
      else mxa = fmaxf(mxa, x);
    }
    mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, 1));
    mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, 2));
    mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, 1));
    mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, 2));
    // a row that has seen no key keeps max -1e30: subtract 0 instead, so
    // its masked scores still give exactly 0
    const float ua = mxa == kNegInf ? 0.f : mxa;
    const float ub = mxb == kNegInf ? 0.f : mxb;
    const float aa = ex2(ma - ua), ab = ex2(mb - ub);
    ma = mxa;
    mb = mxb;
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int j = 0; j < kKT / 2; ++j) {
      const float p = ex2(sacc[j] - ((j & 2) ? ub : ua));
      sacc[j] = p;
      if (j & 2) sb += p;
      else sa += p;
    }
    la = la * aa + sa;              // per-lane partial; reduced at the end
    lb = lb * ab + sb;
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) o[j] *= (j & 2) ? ab : aa;
    // P as bf16 A fragments: 16 keys = accumulator n-blocks 2kk, 2kk + 1
    uint32_t pf[kKT / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKT / 16; ++kk) {
      pf[kk][0] = pack_bf16(sacc[8 * kk + 0], sacc[8 * kk + 1]);
      pf[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
      pf[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
      pf[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
    }
    // O += P V (V MN-major: LBO one 16-column slice, SBO 8 keys)
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKT / 16; ++kk)
      wgmma_rs<DP>(o, pf[kk], desc32(sv + kk * 16 * 32, kSliceKV, 256), 1);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(o);
    mbar_arrive(empty(s));
  }

  // epilogue: normalise, stage bf16 through this warpgroup's Q rows, then
  // 16-byte stores of the real rows
  la += __shfl_xor_sync(0xffffffffu, la, 1);
  la += __shfl_xor_sync(0xffffffffu, la, 2);
  lb += __shfl_xor_sync(0xffffffffu, lb, 1);
  lb += __shfl_xor_sync(0xffffffffu, lb, 2);
  const float ia = 1.f / fmaxf(la, 1e-30f), ib = 1.f / fmaxf(lb, 1e-30f);
  if (a.lse && lane % 4 == 0) {
    // each real row's log-sum-exp for the backward, in the base-2 units
    // the scores carry here: log2(sum_j exp2(s_j * scale * log2(e))), with
    // m and l final (a row that saw no key: -1e30)
    if (ra < rows)
      a.lse[((long long)b * a.nh + kvh * g + ra % g) * a.Sq + j0 + ra / g] =
          la > 0.f ? ma + log2f(la) : kNegInf;
    if (rb < rows)
      a.lse[((long long)b * a.nh + kvh * g + rb % g) * a.Sq + j0 + rb / g] =
          lb > 0.f ? mb + log2f(lb) : kNegInf;
  }
#pragma unroll
  for (int j = 0; j < DP / 2; j += 2) {
    const int col = 8 * (j / 4) + 2 * (lane % 4), row = (j & 2) ? rb : ra;
    const float inv = (j & 2) ? ib : ia;
    *reinterpret_cast<uint32_t*>(
        sbase + (col / 16) * kSliceQ + swz32(row, (col % 16) / 8) +
        (col % 8) * 2) = pack_bf16(o[j] * inv, o[j + 1] * inv);
  }
  named_sync(2 + w, 128);
  for (int idx = tid % 128; idx < 64 * NP; idx += 128) {
    const int r = 64 * w + idx / NP, piece = idx % NP;
    if (r >= rows) continue;
    const long long oi =
        (((long long)b * a.Sq + j0 + r / g) * a.nh + kvh * g + r % g) * D;
    *reinterpret_cast<uint4*>(a.out + oi + piece * 8) =
        *reinterpret_cast<const uint4*>(sbase + (piece >> 1) * kSliceQ +
                                        swz32(r, piece & 1));
  }
}

// -- host side -----------------------------------------------------------------
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return h ? reinterpret_cast<EncodeTiled>(
                   dlsym(h, "cuTensorMapEncodeTiled"))
             : nullptr;
  }();
  return fn;
}

// TMA map of a contiguous (B, S, heads, D) bf16 tensor: boxes of 16
// columns x `rows` rows of one head, 32-byte swizzle, zero fill past S (and
// past D's last 16-column slice at d = 120)
inline cudaError_t tile_map(CUtensorMap* m, const void* p, int B, int S,
                            int heads, int D, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorSharedObjectInitFailed;
  const cuuint64_t row = (cuuint64_t)heads * D * 2;     // bytes per row
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, row, row * S};
  const cuuint32_t box[4] = {16, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(p), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_32B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the map of a contiguous (B, S, nkv, D) K or V: boxes of kKT keys
inline cudaError_t kv_map(CUtensorMap* m, const void* p, int B, int S,
                          int nkv, int D) {
  return tile_map(m, p, B, S, nkv, D, kKT);
}

// Launch `Kern` (a __global__ wrapper of prefill<D, kPaged>) over
// (query tiles, nkv, B); the caller filled every field but g and tq.
template <auto Kern, int D>
cudaError_t launch_prefill(PrefillArgs& a, cudaStream_t stream) {
  a.g = a.nh / a.nkv;
  a.tq = kRows / a.g;
  const dim3 grid((a.Sq + a.tq - 1) / a.tq, a.nkv, a.B);
  return rt::launch<Kern>(grid, kThreads, smem_bytes<D>(), a, stream);
}

}  // namespace sm90
}  // namespace rt

// Warp-level building blocks shared by the port's tensor-core kernels:
// 16-byte cp.async copies, ldmatrix, mma.sync m16n8k16 (bf16 in) and
// m16n8k8 (tf32 in), both with fp32 accumulators, bf16 packing and exp2.
// The bf16 decode body (decode_sm90.cuh) and the SSD scan (ssd_sm90.cuh)
// build on these; the prefill body (prefill_sm90.cuh) takes the copy and
// packing helpers.
//
// Fragment layouts of mma.m16n8k16 (lane = threadIdx.x % 32, r = lane / 4,
// c = 2 * (lane % 4)), as the PTX ISA defines them:
//   A (16 x 16, row-major), 4 regs of 2 bf16: {(r, c..c+1), (r+8, c..c+1),
//     (r, c+8..c+9), (r+8, c+8..c+9)};
//   B (16 x 8, "col": element (k, n)), 2 regs: {(c..c+1, r), (c+8..c+9, r)};
//   C/D (16 x 8 fp32), 4 floats: (r, c), (r, c+1), (r+8, c), (r+8, c+1).
// ldmatrix.x4 loads four 8 x 8 bf16 matrices; lane i gives the row address
// of row i % 8 of matrix i / 8, and register j of every lane receives its
// two elements of matrix j: (row lane / 4, columns c, c+1), or with .trans
// (rows c, c+1, column lane / 4).
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace rt {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte cp.async; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a b, m16n8k16, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b, m16n8k8, tf32 operands (fp32 bit patterns), fp32 accumulators.
// Fragments as m16n8k16's with k halved: A {(r, t), (r+8, t), (r, t+4),
// (r+8, t+4)}, B {(t, r), (t+4, r)}, t = lane % 4. A bf16 k16 fragment pair
// (c, c+1) splits into two k8 steps: the low halves at k' = t and the high
// halves at k' = t + 4 cover k = c and c + 1, so A and B permute k alike.
__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// fp32 rounded to tf32 (nearest, ties away from zero), as the operand's
// bit pattern: the tensor cores read the top 19 bits, so adding half of
// the dropped 13 bits' unit rounds. One integer add: cvt.rna.tf32 is a
// conversion instruction, and the SSD scan converts ~400 values a lane a
// chunk
__device__ __forceinline__ uint32_t tf32(float x) {
  return __float_as_uint(x) + 0x1000u;
}

// the low / high bf16 of a packed pair as an exact tf32 bit pattern, and
// as a float
__device__ __forceinline__ uint32_t lo_bits(uint32_t v) { return v << 16; }
__device__ __forceinline__ uint32_t hi_bits(uint32_t v) {
  return v & 0xffff0000u;
}
__device__ __forceinline__ float lo_f(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_f(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (low) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace rt

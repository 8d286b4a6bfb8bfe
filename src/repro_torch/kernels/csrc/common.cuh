// Helpers shared by the port's kernels (attention and SSD scan): fp32 /
// bf16 / fp8 element conversion and a launch that opts a kernel into more
// than 48 KB of dynamic shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// fp8 KV caches (float8_e4m3fn / float8_e5m2, no scales): every code is
// exact in fp16 and so in fp32 and bf16, NaN stays NaN
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f(__nv_fp8_e5m2 x) {
  return static_cast<float>(x);
}

template <class F8> struct Fp8Format;
template <> struct Fp8Format<__nv_fp8_e4m3> {
  static constexpr __nv_fp8_interpretation_t kind = __NV_E4M3;
};
template <> struct Fp8Format<__nv_fp8_e5m2> {
  static constexpr __nv_fp8_interpretation_t kind = __NV_E5M2;
};

// two fp8 codes (the low byte first) as a packed bf16 pair (the low half
// first), exactly: one cvt to f16x2 (sm_89+), each half through fp32
template <class F8>
__device__ __forceinline__ uint32_t f8x2_to_bf16x2(uint32_t codes) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(codes & 0xffffu),
      Fp8Format<F8>::kind);
  __half_raw lo, hi;
  lo.x = h.x;
  hi.x = h.y;
  __nv_bfloat162 v = __floats2bfloat162_rn(__half2float(__half(lo)),
                                           __half2float(__half(hi)));
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Launch with the dynamic shared memory a kernel needs, raising the
// kernel's 48 KB default cap when required. The cap is raised once per
// kernel and device (and again only for a larger request), not on every
// launch: each `Kern` has its own instantiation and so its own record.
// Returns the launch's error.
template <auto Kern, typename Args>
cudaError_t launch(dim3 grid, int threads, size_t smem, const Args& a,
                   cudaStream_t stream) {
  constexpr int kMaxDevices = 64;
  static size_t granted[kMaxDevices] = {};
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= kMaxDevices || smem > granted[dev]) {
      e = cudaFuncSetAttribute(
          Kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
      if (dev >= 0 && dev < kMaxDevices) granted[dev] = smem;
    }
  }
  Kern<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace rt

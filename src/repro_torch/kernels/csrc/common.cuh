// Helpers shared by the port's kernels (attention and SSD scan): fp32 /
// bf16 element conversion and a launch that opts a kernel into more than
// 48 KB of dynamic shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rt {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

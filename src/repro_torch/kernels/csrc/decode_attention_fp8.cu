// The contiguous decode kernel's fp8 caches (float8_e4m3fn, float8_e5m2):
// the instantiations of `run_contig` for them, in a translation unit of
// their own so that nvcc builds them beside decode_attention.cu. What the
// launch does is set out in decode_attention.cu's header note.
#include "decode_attention.cuh"

namespace rt_decode {

cudaError_t run_contig_fp8(const DecodeArgs& a, int d, int is_bf16,
                           int kv_fmt, cudaStream_t s) {
  return kv_fmt == kKvE4M3 ? run_contig<__nv_fp8_e4m3>(a, d, is_bf16, s)
         : kv_fmt == kKvE5M2 ? run_contig<__nv_fp8_e5m2>(a, d, is_bf16, s)
                             : cudaErrorInvalidValue;
}

}  // namespace rt_decode

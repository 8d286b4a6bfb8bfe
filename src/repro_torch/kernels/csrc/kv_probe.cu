// KV sanitizer probe for Hopper (sm_90a): the largest |K| or |V| element
// over the key positions an attention call may read, per (row, query head).
//
// Replaces the `probe=True` output of three Pallas TPU kernels:
//  * repro/kernels/decode_attention.py `decode_attention_paged`
//    (`_dec_paged_kernel`, the probe at :146-151);
//  * repro/kernels/chunk_attention.py `chunk_attention_paged` and
//    `chunk_attention` (`_chunk_kernel`, the probe at :84-89).
// Entry point rt_kv_probe. out[b, h] = max over the positions t that row b
// may read of max(|K[t, h / g, :]|, |V[t, h / g, :]|), 0 when it may read
// none. Row b's queries sit at positions base[b] + [0, n_b) (n_b = cols[b],
// or c for every row when `cols` is null; decode is n = 1 at base = pos);
// it may read t in (base - window, base + n - 1] (no lower edge without a
// window; nothing when n = 0), within its capacity [0, cap): `cap` keys of
// a contiguous (B, cap, nkv, D) cache, or mb * bs of the (n_blocks, bs,
// nkv, D) pool through the row's block table, trash entries included, as
// the Pallas index_map reads them.
//
// Bound on the card: BYTES. Each readable K/V byte is read once and takes
// one compare; nothing else is computed.
//
// What the design does about it:
//  * one pass of its own, launched only when the sanitizer arms it: the
//    three attention bodies (and their register budgets) stay as they are,
//    and one kernel serves both layouts, fp32 and bf16, and every caller;
//  * grid (slice, KV head, row): each CTA reads kKeys keys of one KV head
//    of one row in 16-byte loads, consecutive threads on consecutive pieces
//    of a key's head row, so every readable byte is read once for the g
//    query heads that share it; slices past the row's range return at once;
//  * |x| and the maximum as integer arithmetic on the bits: a float with
//    its sign bit cleared orders as its bits do as an unsigned integer (a
//    bf16's 16 bits shifted up are its fp32 bits), so the maximum is exact,
//    needs no conversion, and a NaN stays above every number;
//  * the CTA's maximum (a warp reduction, then one across warps) goes to
//    the g outputs of its KV head by atomicMax on those bits, into an
//    output the entry point zeroes first on the same stream.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kKeys = 128;         // keys per CTA

struct ProbeArgs {
  const uint4* k;      // contiguous (B, cap, nkv, D) or pool (n_blocks, bs,
  const uint4* v;      // nkv, D), as 16-byte pieces
  const int* tbl;      // paged: (B, mb) block table; contiguous: null
  const int* bases;    // (B,) position of each row's first query
  const int* cols;     // (B,) queries each row probes (at most c), or
                       // null: c for every row
  unsigned* out;       // (B, nh) float bits, zeroed
  int nh, nkv, np, bs, mb, cap, c, window;   // np: 16-byte pieces a head row
};

// the largest |x| of a 16-byte piece, as fp32 bits
template <bool kBf16>
__device__ __forceinline__ unsigned piece_max(uint4 x) {
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
  unsigned m = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (kBf16) {
      m = max(m, w[i] & 0x7fff0000u);             // high bf16, as fp32 bits
      m = max(m, (w[i] << 16) & 0x7fff0000u);     // low bf16
    } else {
      m = max(m, w[i] & 0x7fffffffu);
    }
  }
  return m;
}

template <bool kBf16, bool kPaged>
__global__ void __launch_bounds__(kThreads) probe_kernel(ProbeArgs a) {
  const int sl = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int base = a.bases[b];
  const int n = a.cols ? min(a.cols[b], a.c) : a.c;
  const int lo = a.window > 0 ? max(0, base - a.window + 1) : 0;
  const int hi = n > 0 ? min(base + n, a.cap) : lo;   // no column: none
  const int t0 = lo + sl * kKeys, t1 = min(hi, t0 + kKeys);
  if (t0 >= t1) return;            // the whole CTA: no barrier is skipped
  const int* tbl_row = kPaged ? a.tbl + (long long)b * a.mb : nullptr;
  unsigned m = 0;
  for (int idx = threadIdx.x; idx < (t1 - t0) * a.np; idx += kThreads) {
    const int t = t0 + idx / a.np, piece = idx % a.np;
    const long long row =
        kPaged ? (long long)__ldg(tbl_row + t / a.bs) * a.bs + t % a.bs
               : (long long)b * a.cap + t;
    const long long off = (row * a.nkv + kvh) * a.np + piece;
    m = max(m, piece_max<kBf16>(__ldg(a.k + off)));
    m = max(m, piece_max<kBf16>(__ldg(a.v + off)));
  }
  __shared__ unsigned warp_max[kThreads / 32];
  m = __reduce_max_sync(0xffffffffu, m);
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  const int g = a.nh / a.nkv;
  if (threadIdx.x < g) {
    unsigned cta = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) cta = max(cta, warp_max[w]);
    if (cta) atomicMax(a.out + (long long)b * a.nh + kvh * g + threadIdx.x,
                       cta);
  }
}

template <bool kBf16, bool kPaged>
cudaError_t run(const ProbeArgs& a, int B, cudaStream_t s) {
  // the most keys a row may read: its capacity, or the window plus the
  // chunk's queries
  const int span =
      a.window > 0 ? std::min(a.cap, a.window + a.c - 1) : a.cap;
  const dim3 grid((span + kKeys - 1) / kKeys, a.nkv, B);
  return rt::launch<probe_kernel<kBf16, kPaged>>(grid, kThreads, 0, a, s);
}

}  // namespace

extern "C" int rt_kv_probe(const void* k, const void* v, const void* tbl,
                           const void* bases, const void* cols, void* out,
                           int B, int nh, int nkv, int d, int bs, int mb,
                           int cap, int c, int window, int is_bf16,
                           void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  const int esz = is_bf16 ? 2 : 4;
  if (B <= 0 || nkv <= 0 || nh % nkv != 0 || nh / nkv > kThreads || c <= 0
      || cap <= 0 || d * esz % 16 != 0 || (tbl && (bs <= 0 || mb <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(float) * B * nh, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const ProbeArgs a{static_cast<const uint4*>(k),
                    static_cast<const uint4*>(v), static_cast<const int*>(tbl),
                    static_cast<const int*>(bases),
                    static_cast<const int*>(cols),
                    static_cast<unsigned*>(out), nh, nkv, d * esz / 16, bs,
                    mb, cap, c, window};
  if (tbl)
    e = is_bf16 ? run<true, true>(a, B, s) : run<false, true>(a, B, s);
  else
    e = is_bf16 ? run<true, false>(a, B, s) : run<false, false>(a, B, s);
  return static_cast<int>(e);
}

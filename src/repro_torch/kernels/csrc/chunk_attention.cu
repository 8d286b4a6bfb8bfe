// Chunk-prefill attention for Hopper (sm_90a), paged and contiguous.
//
// Replaces two Pallas TPU kernels of repro/kernels/chunk_attention.py:
//  * `chunk_attention_paged` (`_chunk_paged_kernel` -> `_chunk_kernel`): the
//    row's prefix lives in the block pool, read through its block table
//    (entry point rt_chunk_attention_paged);
//  * `chunk_attention` (`_chunk_kernel`): the prefix lives in a contiguous
//    cache (B, S, nkv, d), key t of row b at row b * S + t (entry point
//    rt_chunk_attention; the engine's contig chunked prefill writes each
//    chunk into a transient group cache and attends it here).
// Both: a chunk of C new queries per row, at absolute positions
// bases[b] + j, against that row's prefix (already holding the chunk's own
// K/V), causal on absolute positions, optional sliding window, GQA, online
// softmax in fp32. `bases` is per row; the wrapper broadcasts a scalar. The
// layout is a template flag: one body, one __global__ instantiation per
// entry point, and the contiguous one reads no table.
//
// Bound on the card: OPERATIONS at the engine's 512-token chunks (each
// K/V byte serves 512 queries x 8 query heads at Qwen3-32B's 64/8 heads:
// at base 1024 the chunk needs ~0.09 ms of bf16 tensor-core work against
// ~0.03 ms of HBM traffic), BYTES only for short chunks (C of a few tens).
//
// What the design does about it:
//  * bf16 runs the Hopper prefill body (prefill_sm90.cuh): one CTA per
//    (row, KV head, tile of 128 / g queries) holds the g query heads of the
//    KV head as 128 packed rows, so each staged K/V tile feeds 128 query
//    rows; a producer warpgroup keeps a ring of K/V tiles in flight (TMA
//    from the contiguous cache; cp.async through the block table from the
//    pool) while two warpgroups run S = Q K^T and O += P V as wgmma;
//  * the CTA walks the row's keys (paged: pool blocks through
//    tbl[b, t / block]) only up to the tile's last query position, and from
//    the window's first position under SWA; the Pallas grids walked all
//    `mb` table entries, or all S / block_kv blocks of the contiguous row;
//  * ragged C and S need no padding: the last query tile simply has fewer
//    rows, and the last key tile is masked (the Pallas wrapper sent shapes
//    that do not tile to the jnp oracle instead);
//  * fp32, and bf16 groups of more than 128 query heads per KV head (which
//    do not fit the 128 packed rows), keep the FP32-pipe body
//    (attn_common.cuh).
// Columns past a row's real length (the prompt's last chunk) still compute;
// their K/V went to the trash block and finite masking keeps them finite.
#include <type_traits>

#include "attn_common.cuh"
#include "prefill_sm90.cuh"

namespace {

constexpr int kRows = 64;          // fp32 body: query rows per CTA

struct ChunkArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* tbl;      // paged: (B, mb) block table; contiguous: unused
  const int* bases;
  void* out;
  int B, C, nh, nkv, bs, mb, window, tq;
  int S;               // keys a row can hold: mb * bs paged, S contiguous
  float scale;
};

template <typename T, int D, bool kPaged>
struct ChunkP {
  const T* q;
  T* o;
  const int* tbl_row;
  int b, C, nh, g, bs, S, j0, base;
  int rows, nkv, kvh, kv_lo, kv_hi, causal, window;
  float scale;
  __device__ long long idx(int r) const {
    const int j = j0 + r / g, h = kvh * g + r % g;
    return (((long long)b * C + j) * nh + h) * D;
  }
  __device__ const T* q_row(int r) const { return q + idx(r); }
  __device__ T* o_row(int r) const { return o + idx(r); }
  __device__ int q_pos(int r) const { return base + j0 + r / g; }
  __device__ int kv_row(int t) const {
    if constexpr (kPaged) return tbl_row[t / bs] * bs + t % bs;
    else return b * S + t;
  }
};

template <typename T, int D, bool kPaged>
__global__ void __launch_bounds__(rt::kThreads)
chunk_kernel(ChunkArgs a) {
  const int it = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int g = a.nh / a.nkv;
  const int j0 = it * a.tq;
  const int nq = min(a.tq, a.C - j0);
  ChunkP<T, D, kPaged> p;
  p.q = static_cast<const T*>(a.q);
  p.o = static_cast<T*>(a.out);
  p.tbl_row = kPaged ? a.tbl + (long long)b * a.mb : nullptr;
  p.b = b; p.C = a.C; p.nh = a.nh; p.g = g; p.bs = a.bs; p.S = a.S;
  p.j0 = j0;
  p.base = a.bases[b];
  p.rows = nq * g; p.nkv = a.nkv; p.kvh = kvh;
  p.causal = 1; p.window = a.window; p.scale = a.scale;
  const int first = p.base + j0, last = p.base + j0 + nq - 1;
  p.kv_lo = a.window > 0 ? max(0, first - a.window + 1) : 0;
  p.kv_hi = min(last + 1, a.S);
  rt::attend<T, D>(p, static_cast<const T*>(a.k),
                   static_cast<const T*>(a.v));
}

template <int D, bool kPaged>
__global__ void __launch_bounds__(rt::sm90::kThreads, 1)
chunk_kernel_wgmma(const __grid_constant__ rt::sm90::PrefillArgs a) {
  rt::sm90::prefill<D, kPaged>(a);
}

template <typename T, int D, bool kPaged>
cudaError_t run(const ChunkArgs& a, cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (a.nh / a.nkv <= rt::sm90::kRows) {
      rt::sm90::PrefillArgs p{};
      if constexpr (!kPaged) {
        cudaError_t e = rt::sm90::kv_map(&p.tmK, a.k, a.B, a.S, a.nkv, D);
        if (e == cudaSuccess)
          e = rt::sm90::kv_map(&p.tmV, a.v, a.B, a.S, a.nkv, D);
        if (e != cudaSuccess) return e;
      }
      p.q = static_cast<const T*>(a.q);
      p.out = static_cast<T*>(a.out);
      p.k = static_cast<const T*>(a.k);
      p.v = static_cast<const T*>(a.v);
      p.tbl = a.tbl;
      p.bases = a.bases;
      p.B = a.B; p.Sq = a.C; p.nh = a.nh; p.nkv = a.nkv; p.S = a.S;
      p.bs = a.bs; p.mb = a.mb; p.causal = 1; p.window = a.window;
      p.scale_log2 = a.scale * rt::sm90::kLog2e;
      return rt::sm90::launch_prefill<chunk_kernel_wgmma<D, kPaged>, D>(p,
                                                                         s);
    }
  }
  const dim3 grid((a.C + a.tq - 1) / a.tq, a.nkv, a.B);
  const int rows = a.tq * (a.nh / a.nkv);
  return rt::launch<chunk_kernel<T, D, kPaged>>(
      grid, rt::kThreads, rt::smem_bytes(rows, D), a, s);
}

template <typename T, int D>
cudaError_t run_paged(const ChunkArgs& a, cudaStream_t s) {
  return run<T, D, true>(a, s);
}

template <typename T, int D>
cudaError_t run_contig(const ChunkArgs& a, cudaStream_t s) {
  return run<T, D, false>(a, s);
}

// fp32 body's query positions per CTA: g query heads share one KV head, so
// a tile of tq queries is tq * g rows
inline int query_tile(int nh, int nkv) {
  const int g = nh / nkv;
  return g >= kRows ? 1 : kRows / g;
}

}  // namespace

extern "C" int rt_chunk_attention_paged(
    const void* q, const void* k, const void* v, const void* tbl,
    const void* bases, void* out, int B, int C, int nh, int nkv, int d,
    int bs, int mb, int window, float scale, int is_bf16, void* stream) {
  cudaGetLastError();
  ChunkArgs a{q, k, v, static_cast<const int*>(tbl),
              static_cast<const int*>(bases), out, B, C, nh, nkv, bs, mb,
              window, query_tile(nh, nkv), mb * bs, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = is_bf16 ? RT_DISPATCH_D(d, __nv_bfloat16, run_paged, a, s)
                          : RT_DISPATCH_D(d, float, run_paged, a, s);
  return static_cast<int>(e);
}

extern "C" int rt_chunk_attention(
    const void* q, const void* k, const void* v, const void* bases,
    void* out, int B, int C, int nh, int nkv, int d, int S, int window,
    float scale, int is_bf16, void* stream) {
  cudaGetLastError();
  ChunkArgs a{q, k, v, nullptr, static_cast<const int*>(bases), out, B, C,
              nh, nkv, 0, 0, window, query_tile(nh, nkv), S, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = is_bf16 ? RT_DISPATCH_D(d, __nv_bfloat16, run_contig, a, s)
                          : RT_DISPATCH_D(d, float, run_contig, a, s);
  return static_cast<int>(e);
}

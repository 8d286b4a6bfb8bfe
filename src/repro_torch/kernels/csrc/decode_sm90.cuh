// bf16 decode-attention body for Hopper (sm_90a): one query token per row
// against its K/V history, the tensor-core path of both decode kernels
// (decode_attention.cu: `rt_decode_attention` on a contiguous cache,
// `rt_decode_attention_paged` on the block pool).
//
// Bound on the card: BYTES. A row streams its visible K/V once per step and
// does 4 g d flops per key (g query heads per KV head), two orders of
// magnitude below where H100 bf16 turns compute-bound. So the design is
// about bytes in flight and about never idling on a load:
//  * Grid (split, KV head, row); a CTA holds the g query heads of its KV
//    head (g <= 16: one m16 tile), so each K/V byte is read once per group.
//  * Splits follow the positions, not the capacity: rt_decode_plan gives
//    the number of splits per (row, KV head) that puts about four CTAs on
//    each SM; the kernel cuts each row's visible keys [lo, hi) (lo = pos -
//    window + 1 or 0, hi = min(pos + 1, S), S the row's capacity) into at
//    most that many splits of whole 64-key tiles, at least `min_keys` keys
//    each. CTAs past the last split return at once and the combine reads
//    only the splits used.
//  * K/V ring (bf16): stages() tiles of 64 keys (3 at d = 120, 128, 4
//    below), filled by all 128 threads with 16-byte cp.async (zero fill
//    past the split's end), one commit group per tile, so stages - 1 tiles
//    (68-90 KB
//    per CTA, two CTAs per SM) are in flight while a tile computes. Rows
//    are padded by 16 bytes, so ldmatrix's eight rows fall in eight bank
//    groups at every head dim (16...128).
//  * Math on tensor cores: each warp takes 16 keys of the tile. S = Q K^T
//    as mma.m16n8k16 (Q in registers as A fragments, g rows padded to 16;
//    K through ldmatrix), an online softmax per warp in registers (exp2
//    with scale * log2(e) folded in, rows reduced across the lane quad),
//    then O += P V with P packed to bf16 A fragments in registers and V
//    through ldmatrix.trans. The four warps' (m, l, O) merge in shared
//    memory at the end, and the CTA writes its split's partial.
//  * A second kernel merges the splits of each (row, query head).
//
// Where a key lives is the policy `Keys` (element offset of key t's D
// values for this CTA's row and KV head): `ContigKeys` for a (B, S, nkv, D)
// cache, `PagedKeys` for the (n_blocks, bs, nkv, D) pool read through the
// row's block table, any block size (a block may straddle a tile). The
// paged policy reads the table entry beside each 16-byte copy instead of
// staging a tile's entries in shared memory: a tile spans at most 64 / bs
// + 1 entries of one 4-byte table row, so the lookups hit L1 after the
// first, and staging them in shared memory would need a second barrier
// per tile, between the lookups and the copies.
//
// fp8 caches (contiguous only; float8_e4m3fn or float8_e5m2, no scales,
// the reference's plain cast): the ring holds fp8 rows, half the bytes a
// tile, 16-byte cp.async (8-byte at d = 120, whose 120-byte rows are
// 8-byte aligned only). Once a tile has landed, the CTA converts its K and
// V to bf16 (exact: every fp8 code is a bf16) into one more K/V tile laid
// out as the bf16 ring's, and the unchanged tensor-core math reads that.
// So a launch on an fp8 cache computes bit for bit what a launch on the
// cache upcast to bf16 computes, over the same splits. Q is never rounded
// to fp8, and the MMA stays bf16.
//
// Numerics as the fp32 body and the plain version: fp32 scores and
// softmax, masked probabilities exactly 0 (a warp that has seen no key
// subtracts 0, not its -1e30 max), P rounded to bf16 before the PV product,
// the output divided by max(l, 1e-30).
#pragma once

#include "warp_mma.cuh"

namespace rt {
namespace dec {

constexpr int kKT = 64;             // keys per tile, 16 per warp
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxG = 16;           // query heads per KV head (one m16 tile)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// the head dim in whole k16 steps: d = 120 (h2o-danube-3-4b) is 7.5; its
// last step reads the row's 16-byte pad as columns 120-127, whose K
// fragments are zeroed in registers (Q's are zero), and P V skips the
// sixteenth n8 tile
template <int D>
__host__ __device__ constexpr int padded() { return (D + 15) / 16 * 16; }
template <int D>
__host__ __device__ constexpr int row_bytes() { return padded<D>() * 2 + 16; }
// K/V ring stages: bf16 rows, or fp8 rows (half the bytes, beside one
// bf16 conversion tile), two CTAs an SM either way
template <int D, class KV>
__host__ __device__ constexpr int stages() {
  return sizeof(KV) == 1 ? (padded<D>() >= 128 ? 4 : 6)
                         : (padded<D>() >= 128 ? 3 : 4);
}
template <int D, class KV>
__host__ __device__ constexpr size_t smem_bytes() {
  const size_t tile = (size_t)2 * kKT * row_bytes<D>();   // bf16 K and V
  const size_t ring = sizeof(KV) == 1
      ? (size_t)stages<D, KV>() * 2 * kKT * D + tile
      : (size_t)stages<D, KV>() * tile;
  const size_t merge = (size_t)kWarps * kMaxG * (D + 2) * sizeof(float);
  return ring > merge ? ring : merge;
}

struct Args {
  const __nv_bfloat16* q;   // (B, 1, nh, D)
  const void* k;            // contiguous (B, S, nkv, D) or pool (n_blocks,
  const void* v;            // bs, nkv, D); bf16, or fp8 (contiguous)
  const int* pos;           // (B,)
  __nv_bfloat16* out;       // (B, 1, nh, D)
  float* part_acc;          // (B, nh, nsplit, D) unnormalised partials
  float* part_ml;           // (B, nh, nsplit, 2): max (log2 units), sum
  int B, nh, nkv, g, S, window, min_keys, nsplit;   // S: keys a row holds
  float scale_log2;         // softmax scale * log2(e)
  const int* tbl;           // paged: (B, mb) block table; contiguous: null
  int mb, bs;               // paged: table width, block size (S = mb bs)
  float* lse;               // contiguous: (B, nh) log-sum-exp or null;
};                          // when set, `out` holds fp32

// The row's visible keys start at `lo`; splits of `len` keys (whole
// tiles), `used` of them. A row that sees no key (a frozen dead row with a
// window of 1) gets one empty split, whose partial is (-1e30, 0, 0).
__device__ __forceinline__ void split_of(const Args& a, int pos, int& lo,
                                         int& hi, int& len, int& used) {
  lo = a.window > 0 ? max(0, pos - a.window + 1) : 0;
  hi = min(pos + 1, a.S);
  const int n = max(hi - lo, 0);
  const int ns = min(a.nsplit, max(1, (n + a.min_keys - 1) / a.min_keys));
  len = ((n + ns - 1) / ns + kKT - 1) / kKT * kKT;
  used = n > 0 ? (n + len - 1) / len : 1;
}

// key t of row b, KV head kvh in a contiguous (B, S, nkv, D) cache
template <int D>
struct ContigKeys {
  long long base;           // (b S) nkv + kvh, in units of D elements
  int nkv;
  __device__ ContigKeys(const Args& a, int b, int kvh)
      : base((long long)b * a.S * a.nkv + kvh), nkv(a.nkv) {}
  __device__ long long offset(int t) const {
    return (base + (long long)t * nkv) * D;
  }
};

// key t of row b, KV head kvh in the (n_blocks, bs, nkv, D) pool: pool row
// tbl[b, t / bs] * bs + t % bs (t < S = mb bs, so the entry is in the row)
template <int D>
struct PagedKeys {
  const int* tbl;           // row b's block-table entries
  int bs, nkv, kvh;
  __device__ PagedKeys(const Args& a, int b, int kvh_)
      : tbl(a.tbl + (long long)b * a.mb), bs(a.bs), nkv(a.nkv), kvh(kvh_) {}
  __device__ long long offset(int t) const {
    const long long row = (long long)__ldg(tbl + t / bs) * bs + t % bs;
    return (row * nkv + kvh) * D;
  }
};

// KV: the cache's element type, __nv_bfloat16 or (contiguous) an fp8 type
template <int D, class Keys, class KV = __nv_bfloat16>
__device__ __forceinline__ void split_body(const Args& a) {
  constexpr bool kF8 = sizeof(KV) == 1;
  constexpr int NS = stages<D, KV>(), RB = row_bytes<D>(), NP = D / 8;
  constexpr int KS = padded<D>() / 16;        // k16 steps of Q K^T
  constexpr bool kHalf = D % 16 != 0;         // the last step is half real
  constexpr uint32_t kTileB = kKT * RB;       // one bf16 K or V tile, bytes
  // fp8: ring tiles of kKT unpadded D-byte rows, copied in pieces of PB
  constexpr int PB = D % 16 == 0 ? 16 : 8;
  constexpr uint32_t kTile8 = kKT * D;
  extern __shared__ __align__(16) uint8_t dec_smem[];
  const uint32_t sbase = smem_u32(dec_smem);
  // the tile the math reads: the bf16 ring's stage, or the fp8 path's
  // conversion tile after the fp8 ring
  const uint32_t conv = sbase + NS * 2 * kTile8;
  const KV* kp = static_cast<const KV*>(a.k);
  const KV* vp = static_cast<const KV*>(a.v);
  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32, g = a.g;
  int lo, hi, len, used;
  split_of(a, a.pos[b], lo, hi, len, used);
  if (sp >= used) return;
  const int kv_lo = lo + sp * len, kv_hi = min(hi, kv_lo + len);
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + kKT - 1) / kKT : 0;
  const Keys keys(a, b, kvh);

  auto load = [&](int i) {
    const int t0 = kv_lo + i * kKT;
    if constexpr (kF8) {
      const uint32_t sk = sbase + (i % NS) * 2 * kTile8, sv = sk + kTile8;
#pragma unroll 4
      for (int idx = tid; idx < kKT * (D / PB); idx += kThreads) {
        const int kl = idx / (D / PB), piece = idx % (D / PB);
        const bool ok = t0 + kl < kv_hi;
        const long long off = ok ? keys.offset(t0 + kl) + piece * PB : 0;
        const uint32_t o = kl * D + piece * PB;
        if constexpr (PB == 16) {
          cp_async16(sk + o, kp + off, ok ? 16 : 0);
          cp_async16(sv + o, vp + off, ok ? 16 : 0);
        } else {
          cp_async8(sk + o, kp + off, ok ? 8 : 0);
          cp_async8(sv + o, vp + off, ok ? 8 : 0);
        }
      }
    } else {
      const uint32_t sk = sbase + (i % NS) * 2 * kTileB, sv = sk + kTileB;
#pragma unroll 4
      for (int idx = tid; idx < kKT * NP; idx += kThreads) {
        const int kl = idx / NP, piece = idx % NP;
        const bool ok = t0 + kl < kv_hi;
        const long long off = ok ? keys.offset(t0 + kl) + piece * 8 : 0;
        const uint32_t o = kl * RB + piece * 16;
        cp_async16(sk + o, kp + off, ok ? 16 : 0);
        cp_async16(sv + o, vp + off, ok ? 16 : 0);
      }
    }
  };
  // fp8: stage i % NS's K and V tiles to bf16 in the conversion tile, 8
  // codes a thread an iteration (rows past the split's end were zero
  // filled, so they convert to zeros, as the bf16 ring holds them)
  auto convert = [&](int i) {
    if constexpr (kF8) {
      const uint8_t* src = dec_smem + (i % NS) * 2 * kTile8;
      uint8_t* dst = dec_smem + NS * 2 * kTile8;
      constexpr int kPieces = kKT * D / 8;     // 8-code pieces a tile
#pragma unroll 4
      for (int idx = tid; idx < 2 * kPieces; idx += kThreads) {
        const int which = idx / kPieces, rem = idx % kPieces;
        const int row = rem / (D / 8), piece = rem % (D / 8);
        const uint2 c = *reinterpret_cast<const uint2*>(
            src + which * kTile8 + row * D + piece * 8);
        uint4 out;
        out.x = f8x2_to_bf16x2<KV>(c.x);
        out.y = f8x2_to_bf16x2<KV>(c.x >> 16);
        out.z = f8x2_to_bf16x2<KV>(c.y);
        out.w = f8x2_to_bf16x2<KV>(c.y >> 16);
        *reinterpret_cast<uint4*>(dst + which * kTileB + row * RB
                                  + piece * 16) = out;
      }
    }
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < n_tiles) load(i);
    cp_async_commit();
  }

  // Q as A fragments (rows g..15 zero) while the first tiles land
  const int r = lane / 4, c = 2 * (lane % 4);
  const __nv_bfloat16* qb = a.q + ((long long)b * a.nh + kvh * g) * D;
  auto q32 = [&](int row, int col) -> uint32_t {
    return row < g && col < D
               ? *reinterpret_cast<const uint32_t*>(qb + row * D + col)
               : 0u;
  };
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    qf[kk][0] = q32(r, 16 * kk + c);
    qf[kk][1] = q32(r + 8, 16 * kk + c);
    qf[kk][2] = q32(r, 16 * kk + c + 8);
    qf[kk][3] = q32(r + 8, 16 * kk + c + 8);
  }

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float ma = kNegInf, mb = kNegInf, la = 0.f, lb = 0.f;
  const float sc = a.scale_log2;
  // ldmatrix row addresses of this lane inside a tile: K (keys 0-7 / 8-15
  // by lane / 16, columns 0-7 / 8-15 by bit 3), V transposed (keys by bit
  // 3, columns by lane / 16)
  const uint32_t k_lane = (16 * w + (lane / 16) * 8 + lane % 8) * RB
                          + ((lane / 8) % 2) * 16;
  const uint32_t v_lane = (16 * w + ((lane / 8) % 2) * 8 + lane % 8) * RB
                          + (lane / 16) * 16;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<NS - 2>();
    __syncthreads();                // tile i landed; stage (i - 1) % NS free
    if (i + NS - 1 < n_tiles) load(i + NS - 1);
    cp_async_commit();
    if constexpr (kF8) {
      convert(i);                   // the previous tile's readers are done
      __syncthreads();
    }
    const int t0 = kv_lo + i * kKT + 16 * w;  // this warp's first key
    if (t0 >= kv_hi) continue;
    const uint32_t sk = kF8 ? conv : sbase + (i % NS) * 2 * kTileB;
    const uint32_t sv = sk + kTileB;

    // S = Q K^T: 16 rows x 16 keys
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t kf[4];
      ldsm_x4(kf, sk + k_lane + kk * 32);
      if (kHalf && kk == KS - 1) kf[1] = kf[3] = 0u;   // columns D..DP-1
      mma16816(s[0], qf[kk], kf[0], kf[1]);
      mma16816(s[1], qf[kk], kf[2], kf[3]);
    }
    // log2-domain scores; keys past the split's end masked
    const int valid = kv_hi - t0;
    float mxa = ma, mxb = mb;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sc;
        if (valid < 16 && 8 * j + c + (e & 1) >= valid) x = kNegInf;
        s[j][e] = x;
        if (e < 2) mxa = fmaxf(mxa, x);
        else mxb = fmaxf(mxb, x);
      }
    mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, 1));
    mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, 2));
    mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, 1));
    mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, 2));
    const float ua = mxa == kNegInf ? 0.f : mxa;
    const float ub = mxb == kNegInf ? 0.f : mxb;
    const float aa = ex2(ma - ua), ab = ex2(mb - ub);
    ma = mxa;
    mb = mxb;
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(s[j][e] - (e < 2 ? ua : ub));
        s[j][e] = p;
        if (e < 2) sa += p;
        else sb += p;
      }
    la = la * aa + sa;              // per-lane partial; reduced at the end
    lb = lb * ab + sb;
    const uint32_t pf[4] = {pack_bf16(s[0][0], s[0][1]),
                            pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]),
                            pack_bf16(s[1][2], s[1][3])};
    // O = O alpha + P V
#pragma unroll
    for (int dp = 0; dp < KS; ++dp) {
      uint32_t vf[4];
      ldsm_x4_t(vf, sv + v_lane + dp * 32);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (2 * dp + h >= D / 8) continue;       // d = 120: no 16th tile
        float* on = o[2 * dp + h];
        on[0] *= aa;
        on[1] *= aa;
        on[2] *= ab;
        on[3] *= ab;
        mma16816(o[2 * dp + h], pf, vf[2 * h], vf[2 * h + 1]);
      }
    }
  }

  // merge the four warps' (m, l, O) through shared memory (the ring is
  // drained first), then write this split's partial for the g heads
  la += __shfl_xor_sync(0xffffffffu, la, 1);
  la += __shfl_xor_sync(0xffffffffu, la, 2);
  lb += __shfl_xor_sync(0xffffffffu, lb, 1);
  lb += __shfl_xor_sync(0xffffffffu, lb, 2);
  cp_async_wait<0>();
  __syncthreads();
  float* sO = reinterpret_cast<float*>(dec_smem);   // [warp][row][D]
  float* sML = sO + kWarps * kMaxG * D;              // [warp][row][2]
  float* ow = sO + w * kMaxG * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (r < g) {
      ow[r * D + 8 * n + c] = o[n][0];
      ow[r * D + 8 * n + c + 1] = o[n][1];
    }
    if (r + 8 < g) {
      ow[(r + 8) * D + 8 * n + c] = o[n][2];
      ow[(r + 8) * D + 8 * n + c + 1] = o[n][3];
    }
  }
  if (lane % 4 == 0) {
    float* ml = sML + w * kMaxG * 2;
    if (r < g) { ml[2 * r] = ma; ml[2 * r + 1] = la; }
    if (r + 8 < g) { ml[2 * (r + 8)] = mb; ml[2 * (r + 8) + 1] = lb; }
  }
  __syncthreads();
  for (int idx = tid; idx < g * D; idx += kThreads) {
    const int row = idx / D, col = idx % D;
    float M = kNegInf;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww)
      M = fmaxf(M, sML[(ww * kMaxG + row) * 2]);
    const float u = M == kNegInf ? 0.f : M;
    float acc = 0.f, L = 0.f;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) {
      const float f = ex2(sML[(ww * kMaxG + row) * 2] - u);
      acc += f * sO[(ww * kMaxG + row) * D + col];
      L += f * sML[(ww * kMaxG + row) * 2 + 1];
    }
    const long long pr =
        ((long long)b * a.nh + kvh * g + row) * a.nsplit + sp;
    a.part_acc[pr * D + col] = acc;
    if (col == 0) {
      a.part_ml[pr * 2] = M;
      a.part_ml[pr * 2 + 1] = L;
    }
  }
}

// one CTA per (query head, row), one thread per dim: merge the splits the
// row used, out = sum_s 2^{m_s - M} acc_s / max(sum_s 2^{m_s - M} l_s, 1e-30);
// with `lse`, out in fp32 and lse = M ln 2 + ln L, natural log (M is in log2
// units), -inf where the row saw no key (L = 0)
template <int D>
__global__ void __launch_bounds__(D) combine_kernel(Args a) {
  const int h = blockIdx.x, b = blockIdx.y, col = threadIdx.x;
  int lo, hi, len, used;
  split_of(a, a.pos[b], lo, hi, len, used);
  const long long row = (long long)b * a.nh + h;
  const float* ml = a.part_ml + row * a.nsplit * 2;
  const float* acc = a.part_acc + row * a.nsplit * D;
  float M = kNegInf;
  for (int s = 0; s < used; ++s) M = fmaxf(M, ml[2 * s]);
  const float u = M == kNegInf ? 0.f : M;
  float L = 0.f, A = 0.f;
  for (int s = 0; s < used; ++s) {
    const float f = ex2(ml[2 * s] - u);
    L += f * ml[2 * s + 1];
    A += f * acc[s * D + col];
  }
  if (a.lse == nullptr) {
    a.out[row * D + col] = __float2bfloat16(A / fmaxf(L, 1e-30f));
    return;
  }
  reinterpret_cast<float*>(a.out)[row * D + col] = A / fmaxf(L, 1e-30f);
  if (col == 0)
    a.lse[row] = L > 0.f ? M * 0.6931471805599453f + logf(L)
                         : __int_as_float(0xff800000);
}

}  // namespace dec
}  // namespace rt

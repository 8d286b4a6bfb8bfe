// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py `ssd_scan`
// (`_ssd_kernel`): x (B, S, nh, hd), dt (B, S, nh) fp32 (after softplus),
// a (nh,) fp32 < 0, b / c (B, S, N) shared by every head (n_groups = 1),
// optional h0 (B, nh, hd, N) fp32 -> y (B, S, nh, hd) in x's type and the
// final state h (B, nh, hd, N) fp32. Per chunk of Q positions, with
// l = cumsum(dt * a) inside the chunk:
//   y  = ((C B^T) o tril(exp(l_i - l_j))) (x dt) + exp(l) o (C h^T)
//   h <- h exp(l_last) + ((x dt) o exp(l_last - l))^T B
//
// Bound on the card: BYTES at the serving paths' shapes (mamba2-1.3b, one
// 2048-token row: x, y, B, C, dt and h are 37 MB, 11 us at 3.35 TB/s,
// against 6.5 GFLOP, 7 us at the bf16 tensor-core peak, with C B^T shared
// by the heads). This body runs fp32 on the CUDA cores out of shared
// memory, so its shared-memory load rate, not either bound, is what it
// meets: every product reloads its operands from shared memory each step.
//
// What the design does about it (the simple version):
//  * The Pallas grid (B, nh, n_chunks) ran its chunk axis in order on one
//    core with h in VMEM scratch. Here one CTA per (batch, head, slice of
//    32 head dims) loops over the chunks itself and carries its (32 x N)
//    fp32 slice of h in shared memory. Row d of h and column d of y depend
//    only on column d of x, so a 64-dim head splits over two CTAs: 128
//    CTAs (mamba2) or 160 (zamba2) for one row, two resident per SM.
//  * C B^T is the same for every head. A first kernel computes it once per
//    (batch, chunk) into a (B, n_chunks, Q, Q) fp32 scratch; the Pallas
//    kernel recomputed it for every head (64x the work at mamba2's 64
//    heads). The scan kernel reads its chunk's Q x Q block back (from L2)
//    and applies its head's decay.
//  * Products run in fp32 on register tiles (8 x 8 for C B^T, 4 x 4 for y
//    and h) over padded shared-memory rows (no bank conflicts); the
//    N-contractions walk N in tiles of 32 columns. mma.sync / wgmma with
//    TMA loads are later work.
//  * The ragged tail is masked here: a position t >= S reads dt = 0 and
//    x = b = c = 0 (an exact no-op for the state) and writes no y. No
//    padding copy; x, b and c may be strided views (the model's x, B and
//    C are slices of one conv output), read in place.
//
// Since the bf16 redesign this body (and its C B^T scratch `cb`) serves
// fp32 inputs (the parity runs) and bf16 views whose rows are not 16-byte
// aligned; bf16 otherwise runs the tensor-core body of ssd_sm90.cuh, whose
// note gives its design.
#include "common.cuh"
#include "ssd_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 128;          // chunk length the kernels take
constexpr int kMaxN = 256;          // state width the kernels take
constexpr int kDP = 32;             // head dims per scan CTA
constexpr int kNT = 32;             // state columns per tile
constexpr int kLT = kNT + 1;        // padded tile row (floats)
constexpr int kLM = kMaxQ + 1;      // padded C B^T row (floats)

struct SsdArgs {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  const float* h0;     // nullptr: zero initial state
  void* y;
  float* h;
  float* cb;           // (B, nc, Q, Q) scratch: C B^T per chunk
  int B, S, nh, hd, N, Q, nc;
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss;
};

// Pass 1: C B^T of chunk blockIdx.x of row blockIdx.y, a 128 x 128 tile
// (rows past Q or S are zero) of which the Q x Q block is written.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_cb_kernel(SsdArgs a) {
  extern __shared__ float smem[];
  float* sC = smem;                     // kMaxQ x kLT
  float* sB = sC + kMaxQ * kLT;         // kMaxQ x kLT
  const int ch = blockIdx.x, b = blockIdx.y;
  const int Q = a.Q, t0 = ch * Q, nq = min(Q, a.S - t0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* Bm = static_cast<const T*>(a.b);
  const T* Cm = static_cast<const T*>(a.c);
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;

  for (int n0 = 0; n0 < a.N; n0 += kNT) {
    for (int i = tid; i < kMaxQ * kNT; i += kThreads) {
      const int j = i / kNT, k = i % kNT;
      float bv = 0.f, cv = 0.f;
      if (j < nq && n0 + k < a.N) {
        const long long t = t0 + j;
        bv = rt::to_f(Bm[b * a.b_sb + t * a.b_ss + n0 + k]);
        cv = rt::to_f(Cm[b * a.c_sb + t * a.c_ss + n0 + k]);
      }
      sB[j * kLT + k] = bv;
      sC[j * kLT + k] = cv;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kNT; ++k) {
      float cr[8], br[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        cr[r] = sC[(ty + 16 * r) * kLT + k];
        br[r] = sB[(tx + 16 * r) * kLT + k];
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(cr[r], br[q], acc[r][q]);
    }
    __syncthreads();
  }
  float* G = a.cb + ((long long)b * a.nc + ch) * Q * Q;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = ty + 16 * r;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = tx + 16 * q;
      if (i < Q && j < Q) G[i * Q + j] = acc[r][q];
    }
  }
}

inline size_t scan_smem_floats(int N) {
  const int u = kMaxQ * kLM > 2 * kMaxQ * kLT ? kMaxQ * kLM : 2 * kMaxQ * kLT;
  return 2 * kMaxQ + kMaxQ * kDP + kDP * (N + 1) + u;
}

// Pass 2: CTA (slice, head, row) scans the chunks in order, carrying its
// 32 x N slice of h in shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) ssd_scan_kernel(SsdArgs a) {
  extern __shared__ float smem[];
  const int N = a.N, ldh = N + 1, Q = a.Q;
  float* sL = smem;                     // kMaxQ: l = cumsum(dt * a)
  float* sDt = sL + kMaxQ;              // kMaxQ: dt (0 past S)
  float* sX = sDt + kMaxQ;              // kMaxQ x kDP: x dt, then x dt w
  float* sH = sX + kMaxQ * kDP;         // kDP x ldh: the state slice
  float* sU = sH + kDP * ldh;           // decayed C B^T (kMaxQ x kLM), or
                                        // the C and B tiles (kMaxQ x kLT)
  const int d0 = blockIdx.x * kDP, hh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ti = tid / 8, td = tid % 8;   // y tile: rows ti+32r, dims td+8q
  const T* X = static_cast<const T*>(a.x);
  const T* Bm = static_cast<const T*>(a.b);
  const T* Cm = static_cast<const T*>(a.c);
  const float ah = a.a[hh];
  const long long hrow = ((long long)b * a.nh + hh) * a.hd;

  for (int i = tid; i < kDP * N; i += kThreads) {
    const int d = i / N, n = i % N;
    float v = 0.f;
    if (a.h0 != nullptr && d0 + d < a.hd) v = a.h0[(hrow + d0 + d) * N + n];
    sH[d * ldh + n] = v;
  }

  for (int ch = 0; ch < a.nc; ++ch) {
    const int t0 = ch * Q, nq = min(Q, a.S - t0);
    __syncthreads();                    // the previous chunk is done
    // 1. l = cumsum(dt * a): warp 0, four positions a lane, then a scan of
    //    the lane sums
    if (warp == 0) {
      float v[4], run = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = lane * 4 + e;
        const float dtj =
            j < nq ? a.dt[b * a.dt_sb + (long long)(t0 + j) * a.dt_ss + hh]
                   : 0.f;
        sDt[j] = dtj;
        run += dtj * ah;
        v[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) sL[lane * 4 + e] = incl - run + v[e];
    }
    __syncthreads();
    const float l_last = sL[Q - 1];
    // 2. x dt (zero past S and past hd)
    for (int i = tid; i < kMaxQ * kDP; i += kThreads) {
      const int j = i / kDP, d = i % kDP;
      float v = 0.f;
      if (j < nq && d0 + d < a.hd)
        v = rt::to_f(X[b * a.x_sb + (long long)(t0 + j) * a.x_ss +
                       hh * a.x_sh + d0 + d]) * sDt[j];
      sX[i] = v;
    }
    // 3. this chunk's C B^T with the head's decay, lower triangle
    const float* G = a.cb + ((long long)b * a.nc + ch) * Q * Q;
    for (int i = tid; i < kMaxQ * kMaxQ; i += kThreads) {
      const int r = i / kMaxQ, j = i % kMaxQ;
      float v = 0.f;
      if (r < Q && j <= r) v = G[r * Q + j] * expf(sL[r] - sL[j]);
      sU[r * kLM + j] = v;
    }
    __syncthreads();
    // 4. intra-chunk: y = M (x dt)
    float y[4][4], yc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) y[r][q] = yc[r][q] = 0.f;
    for (int j = 0; j < Q; ++j) {
      float m[4], xv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) m[r] = sU[(ti + 32 * r) * kLM + j];
#pragma unroll
      for (int q = 0; q < 4; ++q) xv[q] = sX[j * kDP + td + 8 * q];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) y[r][q] = fmaf(m[r], xv[q], y[r][q]);
    }
    __syncthreads();
    // 5. x dt -> x dt exp(l_last - l) for the state update
    for (int i = tid; i < kMaxQ * kDP; i += kThreads)
      sX[i] *= expf(l_last - sL[i / kDP]);
    const float eL = expf(l_last);
    // 6. by tiles of state columns: yc = C h^T with the old state, then
    //    h = h exp(l_last) + (x dt w)^T B
    float* sC = sU;
    float* sB = sU + kMaxQ * kLT;
    for (int n0 = 0; n0 < N; n0 += kNT) {
      const int nk = min(kNT, N - n0);
      for (int i = tid; i < kMaxQ * kNT; i += kThreads) {
        const int j = i / kNT, k = i % kNT;
        float bv = 0.f, cv = 0.f;
        if (j < nq && k < nk) {
          const long long t = t0 + j;
          bv = rt::to_f(Bm[b * a.b_sb + t * a.b_ss + n0 + k]);
          cv = rt::to_f(Cm[b * a.c_sb + t * a.c_ss + n0 + k]);
        }
        sB[j * kLT + k] = bv;
        sC[j * kLT + k] = cv;
      }
      __syncthreads();
      for (int k = 0; k < nk; ++k) {
        float cr[4], hr[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cr[r] = sC[(ti + 32 * r) * kLT + k];
#pragma unroll
        for (int q = 0; q < 4; ++q) hr[q] = sH[(td + 8 * q) * ldh + n0 + k];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) yc[r][q] = fmaf(cr[r], hr[q], yc[r][q]);
      }
      float hn[4];
      const bool col = lane < nk;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        hn[q] = col ? sH[(warp + 8 * q) * ldh + n0 + lane] * eL : 0.f;
      for (int j = 0; j < Q; ++j) {
        const float bv = sB[j * kLT + lane];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          hn[q] = fmaf(sX[j * kDP + warp + 8 * q], bv, hn[q]);
      }
      __syncthreads();                  // the tile's old h and C / B read
      if (col) {
#pragma unroll
        for (int q = 0; q < 4; ++q) sH[(warp + 8 * q) * ldh + n0 + lane] = hn[q];
      }
    }
    // 7. y = intra + exp(l) o C h^T, for t < S and d < hd
    T* Y = static_cast<T*>(a.y);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ti + 32 * r;
      if (i >= nq) continue;
      const float el = expf(sL[i]);
      const long long row =
          (((long long)b * a.S + t0 + i) * a.nh + hh) * a.hd + d0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int d = td + 8 * q;
        if (d0 + d < a.hd) Y[row + d] = rt::from_f<T>(y[r][q] + el * yc[r][q]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kDP * N; i += kThreads) {
    const int d = i / N, n = i % N;
    if (d0 + d < a.hd) a.h[(hrow + d0 + d) * N + n] = sH[d * ldh + n];
  }
}

template <typename T>
cudaError_t run(const SsdArgs& a, cudaStream_t s) {
  if (a.nc > 0) {
    cudaError_t e = rt::launch<ssd_cb_kernel<T>>(
        dim3(a.nc, a.B), kThreads, 2 * kMaxQ * kLT * sizeof(float), a, s);
    if (e != cudaSuccess) return e;
  }
  return rt::launch<ssd_scan_kernel<T>>(
      dim3((a.hd + kDP - 1) / kDP, a.nh, a.B), kThreads,
      scan_smem_floats(a.N) * sizeof(float), a, s);
}

}  // namespace

extern "C" int rt_ssd_scan(
    const void* x, const void* dt, const void* a, const void* b,
    const void* c, const void* h0, void* y, void* h, void* cb, int B, int S,
    int nh, int hd, int N, int Q, long long x_sb, long long x_ss,
    long long x_sh, long long dt_sb, long long dt_ss, long long b_sb,
    long long b_ss, long long c_sb, long long c_ss, int is_bf16,
    void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (Q < 1 || Q > kMaxQ || N < 1 || N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  SsdArgs args{x, static_cast<const float*>(dt), static_cast<const float*>(a),
               b, c, static_cast<const float*>(h0), y,
               static_cast<float*>(h), static_cast<float*>(cb),
               B, S, nh, hd, N, Q, (S + Q - 1) / Q,
               x_sb, x_ss, x_sh, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the tensor-core body copies 16-byte pieces of x, B and C rows
  auto al16 = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  const bool sm90 = is_bf16 && hd % 8 == 0 && N % 8 == 0 && al16(x)
                    && al16(b) && al16(c) && x_sb % 8 == 0 && x_ss % 8 == 0
                    && x_sh % 8 == 0 && b_sb % 8 == 0 && b_ss % 8 == 0
                    && c_sb % 8 == 0 && c_ss % 8 == 0;
  cudaError_t e;
  if (sm90) {
    const rt::ssd::Args sa{
        static_cast<const __nv_bfloat16*>(x), args.dt, args.a,
        static_cast<const __nv_bfloat16*>(b),
        static_cast<const __nv_bfloat16*>(c), args.h0,
        static_cast<__nv_bfloat16*>(y), args.h, B, S, nh, hd, N, Q, args.nc,
        x_sb, x_ss, x_sh, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss};
    e = N <= 64 ? rt::ssd::run<64>(sa, st)
        : N <= 128 ? rt::ssd::run<128>(sa, st)
                   : rt::ssd::run<256>(sa, st);
  } else {
    e = is_bf16 ? run<__nv_bfloat16>(args, st) : run<float>(args, st);
  }
  return static_cast<int>(e);
}

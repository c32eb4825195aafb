// Flash attention for Hopper (sm_90a): the fp32 forward, backward dK/dV
// and backward dQ, and ring attention's per-pair backward, each a
// hand-written kernel behind a plain C interface.  The bf16 flash forward
// is flash_fwd_sm90.cu and the bf16 flash backward flash_bwd_sm90.cu
// (wgmma + TMA).
//
// Replaces the TPU kernels of paddle_tpu/kernels/flash_attention.py:
//   forward  <- _fwd_kernel       (the pallas_call in _flash_fwd; fp32)
//   dK/dV    <- _bwd_dkdv_kernel  (the first pallas_call in _flash_bwd)
//   dQ       <- _bwd_dq_kernel    (the second pallas_call in _flash_bwd)
// Same contract: q, k, v, o, dO [B*H, S, D]; lse and delta =
// rowsum(dO*O) [B*H, S] fp32; softmax math in fp32.  Scores are
// s = (q.k) * scale, masked to -1e30 above the causal diagonal and past
// the ragged end of S (the TPU wrapper pads S to a multiple of 128; here
// the tail is masked in-kernel).  The forward runs the online softmax
// (m, l, acc) with the l == 0 -> 1 guard of the TPU kernel and writes
// lse = m + log(l); the backward recomputes P = exp(s - lse) and
// dS = P * (dP - delta) * scale.  Head dims 32, 64, 128 and 256, and 512
// on the fp32 kernels (the wrapper zero-pads any other D <= 512 up to the
// next of them, and runs bf16 inputs with D > 256 through the fp32
// kernels).
//
// What bounds them on the H100: operations.  The forward does 4*D FLOPs
// per live (q, k) pair, dK/dV twice that and dQ 1.5 times, against a
// few hundred MB of traffic at the 1.3B training shapes.  So the design
// keeps the [S, S] scores out of device memory (one tile at a time, in
// registers), walks only the kv tiles the causal mask leaves, and puts
// the ring pairs' bf16 products on the tensor cores.
//
// Layout of the work.  The TPU grid runs in order on one core and
// carries the softmax state (or the dK/dV, dQ sums) in VMEM scratch from
// one grid step to the next; here blocks run in parallel, so the
// sequential grid axis becomes a loop inside one block, with the carried
// state in registers:
//   forward: one block per (64-query tile, b*h); loop over 64-key tiles
//            up to the causal bound (the TPU's should_run becomes the
//            loop's end); m, l and the fp32 accumulator in registers.
//   dK/dV:   one block per (64-key tile, b*h); loop over the q tiles at
//            or below the diagonal; dK, dV accumulate in fp32 registers
//            and are written once.
//   dQ:      one block per (64-query tile, b*h); loop over kv tiles up
//            to the diagonal; dQ written once.
// No atomics: each output element is written by exactly one thread, so
// results are deterministic.  Causal query tiles are scheduled heaviest
// first.  Tiles above 48 KB of shared memory need cudaFuncSetAttribute;
// every entry returns cudaGetLastError(), since a refused launch never
// runs.
//
// Two routes share that layout:
//   fp32: scalar fp32 FMAs over fp32 shared-memory tiles, 256 threads
//     (the first design, kept for fp32 inputs, whose products the
//     bf16 tensor cores cannot take without rounding them).
//   ring pairs with bf16 q/k/v: tensor cores, mma.sync m16n8k16 with
//     fp32 accumulation, 4 warps of 16 rows each; the streamed tiles are
//     double-buffered with cp.async (see the tensor-core section).
//
// Ring attention's per-pair backward (paddle_tpu/kernels/ring_attention.py
// _pair_bwd, its two pallas_calls of the dK/dV and dQ kernels) is the
// flash backward with two differences (ring_pair_bwd_*_launch): dO comes
// in fp32 while q/k/v are bf16, and dK, dV, dQ are written in fp32 (the
// ring sums them over the pairs of a rank in fp32).  lse and delta are
// the ring-global ones, computed outside.  On the tensor-core route dO is
// rounded to bf16 as it is staged into shared memory, like P and dS:
// exact where dO is the fp32 copy of a bf16 gradient (the training path),
// one more 2^-9 rounding per term otherwise.  fp32 q/k/v take the scalar
// fp32 kernels, whose dO and outputs are fp32 already.  At the sep = 4
// training shapes (B*H = 128, s = 512, D = 128, a full pair) bytes bound
// them, not operations: dK/dV moves 151.5 MB (0.045 ms at 3.35 TB/s) for
// 34.4 GFLOP (0.035 ms), dQ 118.0 MB for 25.8 GFLOP, the fp32 dO and
// outputs being half of it; each input tile is read once per block and
// each output written once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;           // query rows and key rows per tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;   // the TPU kernel's _NEG_INF
constexpr unsigned kFull = 0xffffffffu;

// Reductions over the 16 lanes that own one row (xor stays in the half).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Rows [row0, row0 + T) of a [S, D] matrix into a [T][D + 1] fp32
// tile; rows at or past S are zeros.
template <int D, int T>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int S) {
  for (int idx = threadIdx.x; idx < T * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int gr = row0 + r;
    dst[r * (D + 1) + c] = gr < S ? src[(size_t)gr * D + c] : 0.f;
  }
}

// lse / delta of rows [row0, row0 + T); 0 past S (those rows are
// masked out, so the value is never used).
template <int T>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int S) {
  for (int r = threadIdx.x; r < T; r += kThreads)
    dst[r] = row0 + r < S ? src[row0 + r] : 0.f;
}

__device__ __forceinline__ bool live(int qr, int kc, int S, int causal) {
  return qr < S && kc < S && (!causal || kc <= qr);
}

// s[i][j] += A[ty + 16i] . B[tx + 16j] over D, both tiles [T][D + 1]
// with R = T / 16 rows and columns a thread.
template <int D, int R>
__device__ __forceinline__ void tile_dot(float (&s)[R][R], const float* A,
                                         const float* B, int ty, int tx) {
  constexpr int LD = D + 1;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[R], b[R];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = A[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < R; ++j) b[j] = B[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// ------------------------------------------------ fp32: scalar kernels
//
// T is the tile (query rows and key rows): 64, or 32 where the tiles of
// 64 rows do not fit in shared memory (the backward kernels at D = 256:
// 297 and 280 KB of fp32 tiles against 227 KB a block).  Thread
// (ty, tx) = (tid / 16, tid % 16) owns tile rows ty + 16i and key
// columns tx + 16j (i, j < R = T / 16) of a score tile, and output
// columns tx + 16c of the rows it owns.  A row's 16 owners are 16
// consecutive lanes, so row max and row sum are 4 xor-shuffles.  Shared
// rows are padded to D + 1 floats, so the 16 different rows a warp reads
// at one column fall in 16 different banks.

template <int D, int T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int S, float scale,
                     int causal) {
  constexpr int LD = D + 1, NC = D / 16, R = T / 16, PS = T + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + T * LD;
  float* Vs = Ks + T * LD;
  float* Ps = Vs + T * LD;                      // [T][PS]

  const int bh = blockIdx.x;
  // heavy (late) query tiles of a causal pass are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * T;
  const size_t base = (size_t)bh * S * D;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile<D, T>(Qs, q + base, q0, S);
  float m[R], l[R], acc[R][NC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  const int kv_end = causal ? min(S, q0 + T) : S;
  for (int k0 = 0; k0 < kv_end; k0 += T) {
    __syncthreads();               // last tile's Ps / Vs reads are done
    load_tile<D, T>(Ks, k + base, k0, S);
    load_tile<D, T>(Vs, v + base, k0, S);
    __syncthreads();
    float s[R][R] = {};
    tile_dot<D, R>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qr = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] = live(qr, k0 + tx + 16 * j, S, causal) ? s[i][j] * scale
                                                        : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float p = s[i][j] > kNegInf ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * corr + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < T; ++kk) {
      float p[R], w[NC];
#pragma unroll
      for (int i = 0; i < R; ++i) p[i] = Ps[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) w[c] = Vs[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p[i], w[c], acc[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= S) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    const float inv = 1.f / l_safe;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      out[base + (size_t)qr * D + tx + 16 * c] = acc[i][c] * inv;
    if (tx == 0) lse[(size_t)bh * S + qr] = m[i] + logf(l_safe);
  }
}

// Shared by both backward kernels: P and dS of one (q tile, kv tile)
// pair, from the staged Q, dO, K, V tiles and the rows' lse and delta.
template <int D, int R>
__device__ __forceinline__ void bwd_scores(
    float (&p)[R][R], float (&ds)[R][R], const float* Qs, const float* dOs,
    const float* Ks, const float* Vs, const float* lse_s,
    const float* delta_s, int q0, int k0, int S, float scale, int causal,
    int ty, int tx) {
  float s[R][R] = {}, dp[R][R] = {};
  tile_dot<D, R>(s, Qs, Ks, ty, tx);
  tile_dot<D, R>(dp, dOs, Vs, ty, tx);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const bool ok = live(q0 + r, k0 + tx + 16 * j, S, causal);
      p[i][j] = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
      ds[i][j] = p[i][j] * (dp[i][j] - delta_s[r]) * scale;
    }
  }
}

// --------------------------------------------------------- dK and dV

template <int D, int T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int S,
                          float scale, int causal) {
  constexpr int LD = D + 1, NC = D / 16, R = T / 16, PS = T + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + T * LD;
  float* Qs = Vs + T * LD;
  float* dOs = Qs + T * LD;
  float* Ps = dOs + T * LD;                     // [T q][PS]
  float* dSs = Ps + T * PS;                     // [T q][PS]
  float* lse_s = dSs + T * PS;
  float* delta_s = lse_s + T;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * T;                // early tiles: most work
  const size_t base = (size_t)bh * S * D;
  const float* lse_bh = lse + (size_t)bh * S;
  const float* delta_bh = delta + (size_t)bh * S;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile<D, T>(Ks, k + base, k0, S);
  load_tile<D, T>(Vs, v + base, k0, S);
  // rows: kv rows ty + 16i of this tile; columns tx + 16c
  float dk_acc[R][NC], dv_acc[R][NC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // causal: only q tiles whose last row reaches k0
  for (int q0 = causal ? k0 : 0; q0 < S; q0 += T) {
    __syncthreads();               // last tile's Ps / dSs / Qs reads done
    load_tile<D, T>(Qs, q + base, q0, S);
    load_tile<D, T>(dOs, dout + base, q0, S);
    load_rows<T>(lse_s, lse_bh, q0, S);
    load_rows<T>(delta_s, delta_bh, q0, S);
    __syncthreads();
    float p[R][R], ds[R][R];
    bwd_scores<D, R>(p, ds, Qs, dOs, Ks, Vs, lse_s, delta_s, q0, k0, S,
                     scale, causal, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = p[i][j];
        dSs[(ty + 16 * i) * PS + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q over this q tile's rows
#pragma unroll 4
    for (int qq = 0; qq < T; ++qq) {
      float pc[R], dc[R], o[NC], x[NC];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pc[i] = Ps[qq * PS + ty + 16 * i];
        dc[i] = dSs[qq * PS + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        o[c] = dOs[qq * LD + tx + 16 * c];
        x[c] = Qs[qq * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dv_acc[i][c] = fmaf(pc[i], o[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(dc[i], x[c], dk_acc[i][c]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kr = k0 + ty + 16 * i;
    if (kr >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const size_t at = base + (size_t)kr * D + tx + 16 * c;
      dk[at] = dk_acc[i][c];
      dv[at] = dv_acc[i][c];
    }
  }
}

// ------------------------------------------------------------------ dQ

template <int D, int T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq,
                        int S, float scale, int causal) {
  constexpr int LD = D + 1, NC = D / 16, R = T / 16, PS = T + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + T * LD;
  float* Ks = dOs + T * LD;
  float* Vs = Ks + T * LD;
  float* dSs = Vs + T * LD;                     // [T q][PS]
  float* lse_s = dSs + T * PS;
  float* delta_s = lse_s + T;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * T;
  const size_t base = (size_t)bh * S * D;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile<D, T>(Qs, q + base, q0, S);
  load_tile<D, T>(dOs, dout + base, q0, S);
  load_rows<T>(lse_s, lse + (size_t)bh * S, q0, S);
  load_rows<T>(delta_s, delta + (size_t)bh * S, q0, S);
  float dq_acc[R][NC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq_acc[i][c] = 0.f;

  const int kv_end = causal ? min(S, q0 + T) : S;
  for (int k0 = 0; k0 < kv_end; k0 += T) {
    __syncthreads();               // last tile's dSs / Ks reads are done
    load_tile<D, T>(Ks, k + base, k0, S);
    load_tile<D, T>(Vs, v + base, k0, S);
    __syncthreads();
    float p[R][R], ds[R][R];
    bwd_scores<D, R>(p, ds, Qs, dOs, Ks, Vs, lse_s, delta_s, q0, k0, S,
                     scale, causal, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j)
        dSs[(ty + 16 * i) * PS + tx + 16 * j] = ds[i][j];
    __syncthreads();
    // dQ += dS K
#pragma unroll 4
    for (int kk = 0; kk < T; ++kk) {
      float dc[R], w[NC];
#pragma unroll
      for (int i = 0; i < R; ++i) dc[i] = dSs[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) w[c] = Ks[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) dq_acc[i][c] = fmaf(dc[i], w[c], dq_acc[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      dq[base + (size_t)qr * D + tx + 16 * c] = dq_acc[i][c];
  }
}

// ---------------------------- ring pairs, bf16 q/k/v: tensor-core kernels
//
// A ring pair's bf16 q/k/v take these.  The products run on the tensor
// cores as mma.sync m16n8k16 (bf16 in, fp32 accumulate); softmax, scaling and
// masking stay fp32 in registers.  4 warps, each owning 16 rows of the
// block's 64-row tile; Q, K, V (dO) tiles sit in shared memory as bf16
// with rows padded by 8 elements, so the 8 rows of a fragment fall in 8
// different 4-bank groups.  The fp32 accumulator of Q K^T has, per
// thread, the layout of the A operand of the next product, so P (and
// dS) go from registers to the tensor cores without touching shared
// memory (the FlashAttention-2 arrangement); B operands that need the
// transposed layout (dO and Q in the dK/dV products, K in dS K) come
// from ldmatrix .trans.  P and dS are rounded to bf16 for their
// products, where the TPU kernel keeps them fp32: one more rounding
// (2^-9 relative) per term, which the bf16 tolerances cover.
constexpr int kThreadsTC = 128;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a (16 x 16, row) * b (16 x 8, col), fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows [r0, r0 + 16), columns [16kk, 16kk + 16) of a
// row-major shared tile with row stride LDS.
template <int LDS>
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* X, int r0,
                                       int kk, int g, int t) {
  const __nv_bfloat16* p = X + (r0 + g) * LDS + kk * 16 + 2 * t;
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * LDS);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * LDS + 8);
}

// B fragments of B[k][n] = X[k][n] (row-major tile, k = rows) for the
// k-step [k0, k0 + 16) and the two n-tiles [n0, n0 + 8), [n0 + 8,
// n0 + 16): b[0], b[1] for the first, b[2], b[3] for the second.
template <int LDS>
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4],
                                             const __nv_bfloat16* X, int k0,
                                             int n0, int lane) {
  const __nv_bfloat16* p =
      X + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDS + n0 +
      (lane >> 4) * 8;
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(addr));
}

// B fragments of B[k][n] = X[n][k] (row-major tile, n = rows) for the
// k-step [k0, k0 + 16) and the two n-tiles [n0, n0 + 8), [n0 + 8,
// n0 + 16): b[0], b[1] for the first, b[2], b[3] for the second.
template <int LDS>
__device__ __forceinline__ void load_b(uint32_t (&b)[4],
                                       const __nv_bfloat16* X, int n0, int k0,
                                       int lane) {
  const __nv_bfloat16* p = X + (n0 + (lane >> 4) * 8 + (lane & 7)) * LDS +
                           k0 + ((lane >> 3) & 1) * 8;
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(addr));
}

// Asynchronous copies (cp.async): a tile's loads run while the block
// computes on the tile before it.  Rows at or past S are zero-filled
// (source size 0).
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + kTile) of a bf16 [S, D] matrix into a bf16 tile
// with row stride D + 8, 16 bytes a thread.
template <int D>
__device__ __forceinline__ void async_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           int row0, int S) {
  constexpr int CH = D / 8;
  for (int idx = threadIdx.x; idx < kTile * CH; idx += kThreadsTC) {
    const int r = idx / CH, c = idx % CH;
    const bool ok = row0 + r < S;
    cp_async(dst + r * (D + 8) + c * 8,
             src + (size_t)(ok ? row0 + r : 0) * D + c * 8, ok);
  }
}

// fp32 dO tiles into bf16 shared memory: loaded 32 bytes a thread,
// rounded to bf16 and stored, which finishes before the call returns; the
// barrier after the next wait makes it visible like the asynchronous
// copies.
template <int D>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst,
                                           const float* src, int row0,
                                           int S) {
  constexpr int CH = D / 8;
  for (int idx = threadIdx.x; idx < kTile * CH; idx += kThreadsTC) {
    const int r = idx / CH, c = idx % CH;
    uint4 packed = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) {
      const float4* p =
          reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D + c * 8);
      const float4 a = p[0], b = p[1];
      packed = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                          pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
    }
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c * 8) = packed;
  }
}

// Two neighbouring fp32 output columns.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// lse and delta of rows [row0, row0 + kTile) (0 past S: those rows are
// masked out).
__device__ __forceinline__ void async_rows(float* lse_dst, float* delta_dst,
                                           const float* lse,
                                           const float* delta, int row0,
                                           int S) {
  const int r = threadIdx.x & (kTile - 1);
  const bool ok = row0 + r < S;
  const int at = ok ? row0 + r : 0;
  if (threadIdx.x < kTile)
    cp_async4(lse_dst + r, lse + at, ok);
  else if (threadIdx.x < 2 * kTile)
    cp_async4(delta_dst + r, delta + at, ok);
}

// Accumulator element e of n-tile j (rows g / g + 8, columns 2t, 2t + 1)
// into the A fragments of the next product, whose k-steps are pairs of
// n-tiles: frag[j / 2][(j % 2) * 2 + e / 2] holds (e & ~1, e | 1).
__device__ __forceinline__ void to_a_frag(uint32_t (&frag)[4][4], int j,
                                          const float (&x)[4]) {
  frag[j >> 1][(j & 1) * 2] = pack_bf16(x[0], x[1]);
  frag[j >> 1][(j & 1) * 2 + 1] = pack_bf16(x[2], x[3]);
}

// Launch order of the two kernels: blocks go in groups of G heads
// whose streamed tiles (Q and dO, or K and V) fit the L2 cache together,
// the tiles of a group's heads side by side and the heaviest causal tile
// first, so the blocks running at once read those tiles from device
// memory about once (a b*h-major grid puts ~132 heads on the card at once
// and each block reads its head's tiles from device memory).  Block x of
// the grid is (head bh, tile index r in launch order).
__device__ __forceinline__ void grouped_block(int n_tiles, int BH, int G,
                                              int& bh, int& r) {
  const int grp = blockIdx.x / (G * n_tiles), i = blockIdx.x % (G * n_tiles);
  const int gh = min(G, BH - grp * G);              // heads in this group
  bh = grp * G + i % gh;
  r = i / gh;
}

// Pipelines of the two kernels: the streamed pair of tiles (K, V or
// Q, dO) is double-buffered.  Iteration i issues the copies of tile
// i + 1 into the other buffer, waits for tile i's own, computes on it,
// and ends in a barrier, so tile i + 2's copies (issued at iteration
// i + 1) never overwrite a buffer still being read.

// dO and dK/dV are fp32 in device memory.  DC: the dK/dV columns one
// block accumulates, from column blockIdx.y * DC.  DC = D up to D = 128; at
// D = 256 the columns are split over two blocks per key tile (DC = 128),
// since one thread would otherwise hold 256 fp32 dK/dV accumulators (the
// limit is 255 registers).  Each of the two recomputes P and dS over the
// full D (S^T and dP^T need every column), which doubles those two
// products and keeps the layout, the six staged tiles (203 KB at
// D = 256) and the register budget of D = 128.  The split was chosen
// over 32-key tiles, which would halve the work of each mma and read
// every Q and dO tile twice as often.
template <int D, int DC>
__global__ void __launch_bounds__(kThreadsTC)
    ring_bwd_dkdv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv,
                            int S,
                             float scale, int causal, int BH, int G) {
  constexpr int LDS = D + 8, KS = D / 16, TILE = kTile * LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + TILE;
  __nv_bfloat16* Qs = Vs + TILE;                // 2 buffers
  __nv_bfloat16* dOs = Qs + 2 * TILE;           // 2 buffers
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * TILE);   // 2 x kTile
  float* delta_s = lse_s + 2 * kTile;                         // 2 x kTile

  constexpr int NC = DC / 8;
  const int n_k = (S + kTile - 1) / kTile;
  int bh, kt;                          // key tile 0 (most causal work) first
  grouped_block(n_k, BH, G, bh, kt);
  const int k0 = kt * kTile, c0 = blockIdx.y * DC;
  const size_t base = (size_t)bh * S * D;
  const float* lse_bh = lse + (size_t)bh * S;
  const float* delta_bh = delta + (size_t)bh * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // this warp's key rows (the rows of S^T = K Q^T it computes)
  const int key[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};
  // causal: only q tiles whose last row reaches k0
  const int qt0 = causal ? kt : 0;
  const int n_tiles = n_k - qt0;

  async_tile<D>(Ks, k + base, k0, S);
  async_tile<D>(Vs, v + base, k0, S);
  async_tile<D>(Qs, q + base, qt0 * kTile, S);
  stage_tile<D>(dOs, dout + base, qt0 * kTile, S);
  async_rows(lse_s, delta_s, lse_bh, delta_bh, qt0 * kTile, S);
  cp_async_commit();

  float dka[NC][4] = {}, dva[NC][4] = {};
  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = (qt0 + it) * kTile;
    const int buf = (it & 1) * TILE, rbuf = (it & 1) * kTile;
    if (it + 1 < n_tiles) {
      const int nxt = ((it + 1) & 1) * TILE, rnxt = ((it + 1) & 1) * kTile;
      async_tile<D>(Qs + nxt, q + base, q0 + kTile, S);
      stage_tile<D>(dOs + nxt, dout + base, q0 + kTile, S);
      async_rows(lse_s + rnxt, delta_s + rnxt, lse_bh, delta_bh,
                 q0 + kTile, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Qb = Qs + buf;
    const __nv_bfloat16* dOb = dOs + buf;
    // S^T = K Q^T and dP^T = V dO^T over the warp's 16 keys x 64 queries
    float st[8][4] = {}, dpt[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[4], va[4];
      load_a<LDS>(ka, Ks, 16 * warp, kk, g, t);
      load_a<LDS>(va, Vs, 16 * warp, kk, g, t);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t b[4];
        load_b<LDS>(b, Qb, 8 * j, 16 * kk, lane);
        mma_bf16(st[j], ka, b[0], b[1]);
        mma_bf16(st[j + 1], ka, b[2], b[3]);
        load_b<LDS>(b, dOb, 8 * j, 16 * kk, lane);
        mma_bf16(dpt[j], va, b[0], b[1]);
        mma_bf16(dpt[j + 1], va, b[2], b[3]);
      }
    }
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * t + (e & 1);
        const bool ok = live(q0 + qc, key[e >> 1], S, causal);
        p[e] = ok ? __expf(st[j][e] * scale - lse_s[rbuf + qc]) : 0.f;
        ds[e] = p[e] * (dpt[j][e] - delta_s[rbuf + qc]) * scale;
      }
      to_a_frag(pa, j, p);
      to_a_frag(dsa, j, ds);
    }
    // dV += P^T dO, dK += dS^T Q over this block's columns
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < NC; n += 2) {
        uint32_t b[4];
        load_b_trans<LDS>(b, dOb, 16 * kk, c0 + 8 * n, lane);
        mma_bf16(dva[n], pa[kk], b[0], b[1]);
        mma_bf16(dva[n + 1], pa[kk], b[2], b[3]);
        load_b_trans<LDS>(b, Qb, 16 * kk, c0 + 8 * n, lane);
        mma_bf16(dka[n], dsa[kk], b[0], b[1]);
        mma_bf16(dka[n + 1], dsa[kk], b[2], b[3]);
      }
    __syncthreads();               // every warp is done with this buffer
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= S) continue;
    const size_t at = base + (size_t)key[h] * D + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      store2(dk + at + 8 * n, dka[n][2 * h], dka[n][2 * h + 1]);
      store2(dv + at + 8 * n, dva[n][2 * h], dva[n][2 * h + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsTC)
    ring_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dq, int S, float scale,
                           int causal, int BH, int G) {
  constexpr int LDS = D + 8, KS = D / 16, NT = D / 8, TILE = kTile * LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + TILE;
  __nv_bfloat16* Ks = dOs + TILE;               // 2 buffers
  __nv_bfloat16* Vs = Ks + 2 * TILE;            // 2 buffers

  const int n_q = (S + kTile - 1) / kTile;
  int bh, r;                           // last query tile (most work) first
  grouped_block(n_q, BH, G, bh, r);
  const int q0 = (n_q - 1 - r) * kTile;
  const size_t base = (size_t)bh * S * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  const int n_tiles = ((causal ? min(S, q0 + kTile) : S) + kTile - 1) / kTile;
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = row[h] < S;
    row_lse[h] = in ? lse[(size_t)bh * S + row[h]] : 0.f;
    row_delta[h] = in ? delta[(size_t)bh * S + row[h]] : 0.f;
  }

  async_tile<D>(Qs, q + base, q0, S);
  stage_tile<D>(dOs, dout + base, q0, S);
  async_tile<D>(Ks, k + base, 0, S);
  async_tile<D>(Vs, v + base, 0, S);
  cp_async_commit();

  float dqa[NT][4] = {};
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kTile, buf = (it & 1) * TILE;
    if (it + 1 < n_tiles) {
      const int nxt = ((it + 1) & 1) * TILE;
      async_tile<D>(Ks + nxt, k + base, k0 + kTile, S);
      async_tile<D>(Vs + nxt, v + base, k0 + kTile, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kb = Ks + buf;
    const __nv_bfloat16* Vb = Vs + buf;
    float s[8][4] = {}, dp[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], oa[4];
      load_a<LDS>(qa, Qs, 16 * warp, kk, g, t);
      load_a<LDS>(oa, dOs, 16 * warp, kk, g, t);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t b[4];
        load_b<LDS>(b, Kb, 8 * j, 16 * kk, lane);
        mma_bf16(s[j], qa, b[0], b[1]);
        mma_bf16(s[j + 1], qa, b[2], b[3]);
        load_b<LDS>(b, Vb, 8 * j, 16 * kk, lane);
        mma_bf16(dp[j], oa, b[0], b[1]);
        mma_bf16(dp[j + 1], oa, b[2], b[3]);
      }
    }
    uint32_t dsa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const float p = live(row[h], col, S, causal)
                            ? __expf(s[j][e] * scale - row_lse[h])
                            : 0.f;
        ds[e] = p * (dp[j][e] - row_delta[h]) * scale;
      }
      to_a_frag(dsa, j, ds);
    }
    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t b[4];
        load_b_trans<LDS>(b, Kb, 16 * kk, 8 * n, lane);
        mma_bf16(dqa[n], dsa[kk], b[0], b[1]);
        mma_bf16(dqa[n + 1], dsa[kk], b[2], b[3]);
      }
    __syncthreads();               // every warp is done with this buffer
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= S) continue;
    float* dst = dq + base + (size_t)row[h] * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      store2(dst + 8 * n, dqa[n][2 * h], dqa[n][2 * h + 1]);
  }
}

// ----------------------------------------------------------- launchers

// fp32 tiles of the scalar kernels: T rows each, rows padded to D + 1;
// score tiles [T][T + 1].
template <int D, int T>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * T * (D + 1) + T * (T + 1));
}
template <int D, int T>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (4 * T * (D + 1) + 2 * T * (T + 1) + 2 * T);
}
template <int D, int T>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * T * (D + 1) + T * (T + 1) + 2 * T);
}
template <int D>
constexpr size_t tc_tiles(int n) {
  return sizeof(__nv_bfloat16) * n * kTile * (D + 8);
}
// the fp32 forward's tile: 16 rows at D = 512, where 64 do not fit
// (fwd_smem<512, 64> is 410 KB)
template <int D>
constexpr int fwd_tile() {
  return D > 256 ? 16 : kTile;
}
// the fp32 backward kernels' tile: 32 rows at D = 256, where 64 do not
// fit (dkdv_smem<256, 64> is 297 KB, dq_smem<256, 64> 280 KB), 16 at
// D = 512
template <int D>
constexpr int bwd_tile() {
  return D > 256 ? 16 : D > 128 ? 32 : kTile;
}

constexpr size_t kMaxSmem = 232448;   // 227 KB: a block's limit on sm_90
static_assert(fwd_smem<256, kTile>() <= kMaxSmem, "fp32 forward tiles");
static_assert(dkdv_smem<256, bwd_tile<256>()>() <= kMaxSmem, "fp32 dK/dV");
static_assert(dq_smem<256, bwd_tile<256>()>() <= kMaxSmem, "fp32 dQ");
// D = 512 (fp32 only): 99.6, 133.6 and 132.5 KB
static_assert(fwd_smem<512, fwd_tile<512>()>() == 99584, "fp32 fwd 512");
static_assert(dkdv_smem<512, bwd_tile<512>()>() == 133632, "fp32 dK/dV 512");
static_assert(dq_smem<512, bwd_tile<512>()>() == 132544, "fp32 dQ 512");
static_assert(tc_tiles<256>(6) + 4 * kTile * sizeof(float) <= kMaxSmem,
              "bf16 dK/dV");

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

using bf16 = __nv_bfloat16;

// The fp32 forward (the bf16 one is in flash_fwd_sm90.cu).
template <int D>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse,
        int BH, int S, float scale, int causal, cudaStream_t st) {
  constexpr int T = fwd_tile<D>();
  constexpr size_t smem = fwd_smem<D, T>();
  int rc = prepare(flash_fwd_kernel<D, T>, smem);
  if (rc) return rc;
  flash_fwd_kernel<D, T><<<dim3(BH, (S + T - 1) / T), kThreads, smem,
                           st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out,
      (float*)lse, S, scale, causal);
  return (int)cudaGetLastError();
}

// Heads whose streamed tiles take about 16 MB together (a third of the
// L2), for bytes_per_head bytes of them a head.
int head_group(int BH, long long bytes_per_head) {
  return (int)max(1LL, min((long long)BH, (16LL << 20) / bytes_per_head));
}

// The backward kernels.  dtype 0: q/k/v fp32, the scalar kernels (the
// flash fp32 backward and a ring pair's); 1: q/k/v bf16, the tensor-core
// kernels (a ring pair's).  dO and the gradients are fp32 on both.
template <int D>
int dkdv(const void* q, const void* k, const void* v, const void* dout,
         const void* lse, const void* delta, void* dk, void* dv, int BH,
         int S, float scale, int causal, int dtype, cudaStream_t st) {
  if (dtype == 0 || D > 256) {
    if (dtype != 0) return (int)cudaErrorInvalidValue;   // fp32 only
    constexpr int T = bwd_tile<D>();
    constexpr size_t smem = dkdv_smem<D, T>();
    int rc = prepare(flash_bwd_dkdv_kernel<D, T>, smem);
    if (rc) return rc;
    flash_bwd_dkdv_kernel<D, T><<<dim3(BH, (S + T - 1) / T), kThreads, smem,
                                  st>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const float*)dout, (const float*)lse, (const float*)delta,
        (float*)dk, (float*)dv, S, scale, causal);
  } else if constexpr (D <= 256) {
    constexpr int DC = D > 128 ? 128 : D;
    constexpr size_t smem = tc_tiles<D>(6) + 4 * kTile * sizeof(float);
    int rc = prepare(ring_bwd_dkdv_tc_kernel<D, DC>, smem);
    if (rc) return rc;
    // streamed a head: bf16 Q and fp32 dO
    const int G = head_group(BH, 6LL * S * D);
    ring_bwd_dkdv_tc_kernel<D, DC>
        <<<dim3(BH * ((S + kTile - 1) / kTile), D / DC), kThreadsTC, smem,
           st>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                 (const float*)dout, (const float*)lse, (const float*)delta,
                 (float*)dk, (float*)dv, S, scale, causal, BH, G);
  }
  return (int)cudaGetLastError();
}

template <int D>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* dq_, int BH, int S,
       float scale, int causal, int dtype, cudaStream_t st) {
  if (dtype == 0 || D > 256) {
    if (dtype != 0) return (int)cudaErrorInvalidValue;   // fp32 only
    constexpr int T = bwd_tile<D>();
    constexpr size_t smem = dq_smem<D, T>();
    int rc = prepare(flash_bwd_dq_kernel<D, T>, smem);
    if (rc) return rc;
    flash_bwd_dq_kernel<D, T><<<dim3(BH, (S + T - 1) / T), kThreads, smem,
                                st>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const float*)dout, (const float*)lse, (const float*)delta,
        (float*)dq_, S, scale, causal);
  } else if constexpr (D <= 256) {
    constexpr size_t smem = tc_tiles<D>(6);
    int rc = prepare(ring_bwd_dq_tc_kernel<D>, smem);
    if (rc) return rc;
    // streamed a head: bf16 K and V
    const int G = head_group(BH, 4LL * S * D);
    ring_bwd_dq_tc_kernel<D>
        <<<BH * ((S + kTile - 1) / kTile), kThreadsTC, smem, st>>>(
            (const bf16*)q, (const bf16*)k, (const bf16*)v,
            (const float*)dout, (const float*)lse, (const float*)delta,
            (float*)dq_, S, scale, causal, BH, G);
  }
  return (int)cudaGetLastError();
}

// Dispatch on the head dim (32, 64, 128, 256, 512).  The scalar
// kernels' grid y extent is at most 65535 tiles of the smallest tile (16
// rows); the tensor-core grids are 1-D.
#define FLASH_DISPATCH(FN, ...)                                         \
  do {                                                                  \
    if (BH <= 0 || S <= 0 || (S + 15) / 16 > 65535 ||                   \
        (long long)BH * ((S + kTile - 1) / kTile) > 2147483647LL)       \
      return (int)cudaErrorInvalidValue;                                \
    if (D == 32) return FN<32>(__VA_ARGS__);                            \
    if (D == 64) return FN<64>(__VA_ARGS__);                            \
    if (D == 128) return FN<128>(__VA_ARGS__);                          \
    if (D == 256) return FN<256>(__VA_ARGS__);                          \
    if (D == 512) return FN<512>(__VA_ARGS__);                          \
    return (int)cudaErrorInvalidValue;                                  \
  } while (0)

#define CHECK_DTYPE \
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue

}  // namespace

// The fp32 flash kernels: q, k, v, out, dout, dk, dv, dq [BH, S, D] fp32,
// lse and delta [BH, S] fp32.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, void* lse, int BH, int S, int D,
                                float scale, int causal, void* stream) {
  FLASH_DISPATCH(fwd, q, k, v, out, lse, BH, S, scale, causal,
                 static_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_dkdv_launch(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dk, void* dv, int BH, int S,
                                     int D, float scale, int causal,
                                     void* stream) {
  FLASH_DISPATCH(dkdv, q, k, v, dout, lse, delta, dk, dv, BH, S, scale,
                 causal, 0, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq_out, int BH, int S, int D,
                                   float scale, int causal, void* stream) {
  FLASH_DISPATCH(dq, q, k, v, dout, lse, delta, dq_out, BH, S, scale,
                 causal, 0, static_cast<cudaStream_t>(stream));
}

// One ring pair's backward with the ring-global lse and delta: q, k, v
// [BH, S, D] of dtype (0 fp32, 1 bf16 with D <= 256), dout fp32, dk/dv
// (dq) fp32.
extern "C" int ring_pair_bwd_dkdv_launch(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const void* lse, const void* delta,
                                         void* dk, void* dv, int BH, int S,
                                         int D, float scale, int causal,
                                         int dtype, void* stream) {
  CHECK_DTYPE;
  FLASH_DISPATCH(dkdv, q, k, v, dout, lse, delta, dk, dv, BH, S, scale,
                 causal, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int ring_pair_bwd_dq_launch(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dq_out, int BH, int S, int D,
                                       float scale, int causal, int dtype,
                                       void* stream) {
  CHECK_DTYPE;
  FLASH_DISPATCH(dq, q, k, v, dout, lse, delta, dq_out, BH, S, scale,
                 causal, dtype, static_cast<cudaStream_t>(stream));
}

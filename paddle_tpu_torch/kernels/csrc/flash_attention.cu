// Flash attention for Hopper (sm_90a): the fp32 forward, backward dK/dV
// and backward dQ, each a hand-written kernel behind a plain C
// interface.  The bf16 flash forward is flash_fwd_sm90.cu and the bf16
// flash backward, and a bf16 ring pair's, flash_bwd_sm90.cu (wgmma +
// TMA).
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
// dS = P * (dP - delta) * scale.  Head dims 32, 64, 128 and 256, and on
// the fp32 kernels 512 and every multiple of 512, walked in 512-column
// chunks (the wrapper zero-pads any other D up to the next of them, and
// runs bf16 inputs with D > 256 through the fp32 kernels).
//
// What bounds them on the H100: operations.  The forward does 4*D FLOPs
// per live (q, k) pair, dK/dV twice that and dQ 1.5 times, against a
// few hundred MB of traffic at the 1.3B training shapes.  So the design
// keeps the [S, S] scores out of device memory (one tile at a time, in
// registers) and walks only the kv tiles the causal mask leaves.
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
// runs.  These are scalar fp32 FMAs over fp32 shared-memory tiles, 256
// threads: fp32 inputs keep them, whose products the bf16 tensor cores
// cannot take without rounding them.
//
// Ring attention's per-pair backward (paddle_tpu/kernels/ring_attention.py
// _pair_bwd) takes the two backward kernels as they are for fp32 q/k/v
// (dO and outputs fp32, the ring-global lse and delta), and the wrapper
// adds their outputs into the ring's fp32 sums; a pair with bf16 q/k/v
// runs flash_bwd_sm90.cu's ring_pair_bwd_sm90_launch, which adds into
// the sums itself.
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

// Rows [row0, row0 + T), columns [0, D) of a [S, ld] matrix into a
// [T][D + 1] fp32 tile; rows at or past S are zeros.
template <int D, int T>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int S, int ld) {
  for (int idx = threadIdx.x; idx < T * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int gr = row0 + r;
    dst[r * (D + 1) + c] = gr < S ? src[(size_t)gr * ld + c] : 0.f;
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
//
// Head dims past 512 (the D = 512 instantiation with ld > 512, a multiple
// of 512): the tensors are [S, ld] and the products that sum over the
// head dim (the scores, and dP = dO V^T) walk ld / 512 chunks of 512
// columns, each staged in the same tiles; every output then needs only
// its own columns (O = P V[:, c], dV = P^T dO[:, c], dK = dS^T Q[:, c],
// dQ = dS K[:, c]), so grid z takes one 512-column chunk c of the output
// and recomputes the scores.  All chunks share the one lse and delta.
// With ld == D the loop over chunks runs once and stages what it did
// before.

template <int D, int T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int S, float scale,
                     int causal, int ld) {
  constexpr int LD = D + 1, NC = D / 16, R = T / 16, PS = T + 1;
  const int ldg = D < 512 ? D : ld;           // row stride in device memory
  const int nch = ldg / D, c0 = blockIdx.z * D;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + T * LD;
  float* Vs = Ks + T * LD;
  float* Ps = Vs + T * LD;                      // [T][PS]

  const int bh = blockIdx.x;
  // heavy (late) query tiles of a causal pass are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * T;
  const size_t base = (size_t)bh * S * ldg;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  if (nch == 1) load_tile<D, T>(Qs, q + base, q0, S, ldg);
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
    float s[R][R] = {};
    for (int ch = 0; ch < nch; ++ch) {
      __syncthreads();             // last reads of Qs / Ks / Ps / Vs done
      if (nch > 1) load_tile<D, T>(Qs, q + base + ch * D, q0, S, ldg);
      load_tile<D, T>(Ks, k + base + ch * D, k0, S, ldg);
      if (ch == nch - 1) load_tile<D, T>(Vs, v + base + c0, k0, S, ldg);
      __syncthreads();
      tile_dot<D, R>(s, Qs, Ks, ty, tx);
    }
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
      out[base + (size_t)qr * ldg + c0 + tx + 16 * c] = acc[i][c] * inv;
    if (tx == 0 && c0 == 0) lse[(size_t)bh * S + qr] = m[i] + logf(l_safe);
  }
}

// Shared by both backward kernels: P and dS of one (q tile, kv tile)
// pair, from its scores s = Q K^T and dp = dO V^T (summed over every
// head-dim chunk) and the rows' lse and delta.
template <int R>
__device__ __forceinline__ void bwd_p_ds(
    float (&p)[R][R], float (&ds)[R][R], const float (&s)[R][R],
    const float (&dp)[R][R], const float* lse_s, const float* delta_s,
    int q0, int k0, int S, float scale, int causal, int ty, int tx) {
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
                          float scale, int causal, int ld) {
  constexpr int LD = D + 1, NC = D / 16, R = T / 16, PS = T + 1;
  const int ldg = D < 512 ? D : ld;           // row stride in device memory
  const int nch = ldg / D, c0 = blockIdx.z * D;
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
  const size_t base = (size_t)bh * S * ldg;
  const float* lse_bh = lse + (size_t)bh * S;
  const float* delta_bh = delta + (size_t)bh * S;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  if (nch == 1) {
    load_tile<D, T>(Ks, k + base, k0, S, ldg);
    load_tile<D, T>(Vs, v + base, k0, S, ldg);
  }
  // rows: kv rows ty + 16i of this tile; columns tx + 16c
  float dk_acc[R][NC], dv_acc[R][NC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // causal: only q tiles whose last row reaches k0
  for (int q0 = causal ? k0 : 0; q0 < S; q0 += T) {
    float s[R][R] = {}, dp[R][R] = {};
    for (int ch = 0; ch < nch; ++ch) {
      __syncthreads();             // last tile's Ps / dSs / Qs reads done
      if (nch > 1) {
        load_tile<D, T>(Ks, k + base + ch * D, k0, S, ldg);
        load_tile<D, T>(Vs, v + base + ch * D, k0, S, ldg);
      }
      load_tile<D, T>(Qs, q + base + ch * D, q0, S, ldg);
      load_tile<D, T>(dOs, dout + base + ch * D, q0, S, ldg);
      if (ch == 0) {
        load_rows<T>(lse_s, lse_bh, q0, S);
        load_rows<T>(delta_s, delta_bh, q0, S);
      }
      __syncthreads();
      tile_dot<D, R>(s, Qs, Ks, ty, tx);
      tile_dot<D, R>(dp, dOs, Vs, ty, tx);
    }
    if (nch > 1) {                 // this block's output columns of Q, dO
      __syncthreads();
      load_tile<D, T>(Qs, q + base + c0, q0, S, ldg);
      load_tile<D, T>(dOs, dout + base + c0, q0, S, ldg);
    }
    float p[R][R], ds[R][R];
    bwd_p_ds<R>(p, ds, s, dp, lse_s, delta_s, q0, k0, S, scale, causal, ty,
                tx);
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
      const size_t at = base + (size_t)kr * ldg + c0 + tx + 16 * c;
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
                        int S, float scale, int causal, int ld) {
  constexpr int LD = D + 1, NC = D / 16, R = T / 16, PS = T + 1;
  const int ldg = D < 512 ? D : ld;           // row stride in device memory
  const int nch = ldg / D, c0 = blockIdx.z * D;
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
  const size_t base = (size_t)bh * S * ldg;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  if (nch == 1) {
    load_tile<D, T>(Qs, q + base, q0, S, ldg);
    load_tile<D, T>(dOs, dout + base, q0, S, ldg);
  }
  load_rows<T>(lse_s, lse + (size_t)bh * S, q0, S);
  load_rows<T>(delta_s, delta + (size_t)bh * S, q0, S);
  float dq_acc[R][NC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq_acc[i][c] = 0.f;

  const int kv_end = causal ? min(S, q0 + T) : S;
  for (int k0 = 0; k0 < kv_end; k0 += T) {
    float s[R][R] = {}, dp[R][R] = {};
    for (int ch = 0; ch < nch; ++ch) {
      __syncthreads();             // last tile's dSs / Ks reads are done
      if (nch > 1) {
        load_tile<D, T>(Qs, q + base + ch * D, q0, S, ldg);
        load_tile<D, T>(dOs, dout + base + ch * D, q0, S, ldg);
      }
      load_tile<D, T>(Ks, k + base + ch * D, k0, S, ldg);
      load_tile<D, T>(Vs, v + base + ch * D, k0, S, ldg);
      __syncthreads();
      tile_dot<D, R>(s, Qs, Ks, ty, tx);
      tile_dot<D, R>(dp, dOs, Vs, ty, tx);
    }
    if (nch > 1) {                 // this block's output columns of K
      __syncthreads();
      load_tile<D, T>(Ks, k + base + c0, k0, S, ldg);
    }
    float p[R][R], ds[R][R];
    bwd_p_ds<R>(p, ds, s, dp, lse_s, delta_s, q0, k0, S, scale, causal, ty,
                tx);
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
      dq[base + (size_t)qr * ldg + c0 + tx + 16 * c] = dq_acc[i][c];
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
// D = 512: 99.6, 133.6 and 132.5 KB
static_assert(fwd_smem<512, fwd_tile<512>()>() == 99584, "fp32 fwd 512");
static_assert(dkdv_smem<512, bwd_tile<512>()>() == 133632, "fp32 dK/dV 512");
static_assert(dq_smem<512, bwd_tile<512>()>() == 132544, "fp32 dQ 512");

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// ld: the head dim of the tensors (D, or a multiple of 512 for D = 512);
// grid z takes its 512-column output chunks.
template <int D>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse,
        int BH, int S, float scale, int causal, int ld, cudaStream_t st) {
  constexpr int T = fwd_tile<D>();
  constexpr size_t smem = fwd_smem<D, T>();
  int rc = prepare(flash_fwd_kernel<D, T>, smem);
  if (rc) return rc;
  flash_fwd_kernel<D, T><<<dim3(BH, (S + T - 1) / T, ld / D), kThreads,
                           smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out,
      (float*)lse, S, scale, causal, ld);
  return (int)cudaGetLastError();
}

template <int D>
int dkdv(const void* q, const void* k, const void* v, const void* dout,
         const void* lse, const void* delta, void* dk, void* dv, int BH,
         int S, float scale, int causal, int ld, cudaStream_t st) {
  constexpr int T = bwd_tile<D>();
  constexpr size_t smem = dkdv_smem<D, T>();
  int rc = prepare(flash_bwd_dkdv_kernel<D, T>, smem);
  if (rc) return rc;
  flash_bwd_dkdv_kernel<D, T><<<dim3(BH, (S + T - 1) / T, ld / D),
                                kThreads, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dk, (float*)dv, S,
      scale, causal, ld);
  return (int)cudaGetLastError();
}

template <int D>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* dq_, int BH, int S,
       float scale, int causal, int ld, cudaStream_t st) {
  constexpr int T = bwd_tile<D>();
  constexpr size_t smem = dq_smem<D, T>();
  int rc = prepare(flash_bwd_dq_kernel<D, T>, smem);
  if (rc) return rc;
  flash_bwd_dq_kernel<D, T><<<dim3(BH, (S + T - 1) / T, ld / D), kThreads,
                              smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dq_, S, scale, causal,
      ld);
  return (int)cudaGetLastError();
}

// Dispatch on the head dim (32, 64, 128, 256, 512, and any multiple of
// 512 past it: the D = 512 kernels in 512-column chunks), passing it on
// as the tensors' row stride.  Grid y is at most 65535 tiles of the
// smallest tile (16 rows), z at most 65535 chunks.
#define FLASH_DISPATCH(FN, ...)                                         \
  do {                                                                  \
    if (BH <= 0 || S <= 0 || (S + 15) / 16 > 65535 || D / 512 > 65535)  \
      return (int)cudaErrorInvalidValue;                                \
    if (D == 32) return FN<32>(__VA_ARGS__, D, st);                     \
    if (D == 64) return FN<64>(__VA_ARGS__, D, st);                     \
    if (D == 128) return FN<128>(__VA_ARGS__, D, st);                   \
    if (D == 256) return FN<256>(__VA_ARGS__, D, st);                   \
    if (D >= 512 && D % 512 == 0) return FN<512>(__VA_ARGS__, D, st);   \
    return (int)cudaErrorInvalidValue;                                  \
  } while (0)

}  // namespace

// The fp32 flash kernels: q, k, v, out, dout, dk, dv, dq [BH, S, D] fp32,
// lse and delta [BH, S] fp32; D one of 32, 64, 128, 256 or a multiple of
// 512.  A ring pair with fp32 q/k/v (or bf16 past D = 256, cast up) runs
// the two backward entries and adds their outputs into its sums.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, void* lse, int BH, int S, int D,
                                float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(fwd, q, k, v, out, lse, BH, S, scale, causal);
}

extern "C" int flash_bwd_dkdv_launch(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dk, void* dv, int BH, int S,
                                     int D, float scale, int causal,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(dkdv, q, k, v, dout, lse, delta, dk, dv, BH, S, scale,
                 causal);
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq_out, int BH, int S, int D,
                                   float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(dq, q, k, v, dout, lse, delta, dq_out, BH, S, scale,
                 causal);
}

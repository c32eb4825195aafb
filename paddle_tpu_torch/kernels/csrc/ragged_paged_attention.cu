// Ragged paged attention for Hopper (sm_90a): fused prefill + decode
// attention over a block-paged KV pool.
//
// Replaces the TPU kernel paddle_tpu/kernels/paged_attention.py::_ragged_kernel
// (launched by _ragged_attention_kernel).  Same contract:
//   q            [B, Q, H, hd]          (fp32 or bf16)
//   k/v_pages    [P, page_size, H, hd]  (same dtype as q)
//   page_tables  [B, max_pages] int32   physical page of each logical page
//   query_lens   [B] int32              live query tokens (0 = idle row)
//   context_lens [B] int32              kv tokens including this chunk
//   out          [B, Q, H, hd]          q's dtype
// Query token t of row b sits at absolute position ctx - qlen + t and
// attends to every kv position <= that.  Padded query slots (t >= qlen)
// and idle rows are written as zeros.  Softmax is an fp32 online softmax
// (m, l, acc), with l == 0 -> 1 as in the TPU kernel.
//
// What bounds it on the H100: memory.  A layer's call must read the live
// K/V of every row, about sum_b ctx_b * H * hd * 2 (K and V) * 2 bytes at
// bf16; it does ~4 FLOPs per K/V element read per query, negligible
// against 989 TFLOP/s.  The design therefore reads only live pages: the
// TPU grid (B, max_pages) visits every page of the table and skips dead
// ones with pl.when, while here each block walks the positions
// 0 .. ctx - qlen + t_last of its row only, looking each page id up in
// the table itself, and a block whose query tile is past qlen (idle rows,
// decode rows' empty tiles) writes zeros and returns before any load.
// K/V are read once per (row, head, query tile) with 16-byte loads into
// registers one key tile ahead of the compute (so the loads of tile n+1
// are in flight while tile n is scored), then staged in shared memory
// where the tile's 16 queries reuse them.  The row's live page ids are
// read once per block into shared memory, so a tile's loads never wait
// on a dependent page-table read.
//
// Layout of the work: one block per (query tile of 16 tokens, head, row);
// 4 warps, warp w owning queries w, w + 4, w + 8, w + 12 of the tile.
// Scores: lane j computes the dot products of key j of the 32-key tile
// with the warp's queries (K rows padded by one float, so the 32 lanes
// read 32 banks; queries are broadcast reads), in independent partial
// sums.  P.V: lane i owns head-dim elements i, i + 32, ..., and p_j is
// broadcast with a shuffle.  A warp works its live queries through one
// branch-free body per tile (keys past the causal horizon get p = 0), so
// the per-warp chains of shared loads, shuffles and FMAs are unrolled and
// interleave: with few warps per SM nothing else hides their latency.
// wgmma, TMA and a split over the kv axis for long contexts are later work.
//
// Head dims: any hd from 1 to 512, in two kernels picked by the
// launcher from the shape:
//   - ragged_paged_attention_kernel takes hd = 32 * VEC up to 256 with
//     16-byte aligned rows, the serving configs' case, with the layout
//     above and compile-time strides;
//   - ragged_any_hd_kernel takes every other hd.  VEC = ceil(hd / 32)
//     elements a lane up to 8, and past that (hd > 256) VEC = 12 and 16,
//     with the loops over keys and head dim only partly unrolled (fully
//     unrolled, those kernels took minutes to build).  Its shared tiles
//     are HDP = 32 * VEC wide with zeros in the columns from hd to HDP,
//     so the dot products over HDP are exact, and the tail elements are
//     masked out of every load and store.  Rows whose bytes are a
//     multiple of 16 with 16-byte aligned pointers take 16-byte loads,
//     any other row (hd odd, or hd % 8 != 0 at bf16) one load an element
//     (the wrapper says which).  Up to VEC = 8 the next key tile is
//     fetched into registers while this one is scored; above it that
//     would take more registers than a thread has, so each tile is loaded
//     straight into shared memory.  Measured on an H100 at the serving
//     shapes (hd 128), it is slower than the first kernel, which is why
//     the first stays for the shapes it takes.
// Neither copies or re-pads the pool: it is read as it is allocated.  At
// hd = 512 the tiles take 163,968 bytes of shared memory plus the page
// ids; past 512 they would not fit in the 227 KB a block may hold, and
// the entry refuses the call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kQueriesPerWarp = 4;
constexpr int kQueryTile = kWarps * kQueriesPerWarp;   // 16
constexpr int kKeyTile = 32;                           // one key per lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16 raw bytes (4 floats or 8 bf16) widened to fp32.
template <typename T>
__device__ __forceinline__ void widen(const uint4& raw, float* dst);
template <>
__device__ __forceinline__ void widen<float>(const uint4& raw, float* dst) {
  dst[0] = __uint_as_float(raw.x);
  dst[1] = __uint_as_float(raw.y);
  dst[2] = __uint_as_float(raw.z);
  dst[3] = __uint_as_float(raw.w);
}
template <>
__device__ __forceinline__ void widen<__nv_bfloat16>(const uint4& raw,
                                                     float* dst) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// Shared-memory layout (floats): K tile [kKeyTile][HD + 1] (padded),
// V tile [kKeyTile][HD], query tile [kQueryTile][HD], HD = 32 * VEC;
// then the row's page ids (max_pages ints, sized at launch).
template <int HD>
struct Smem {
  static constexpr int kStride = HD + 1;
  static constexpr int kK = kKeyTile * kStride;
  static constexpr int kV = kKeyTile * HD;
  static constexpr int kQ = kQueryTile * HD;
  static constexpr size_t kBytes = sizeof(float) * (kK + kV + kQ);
};

// One step of score_keys: columns [d0, d0 + 4P) of this lane's key row
// against the warp's first NQ queries.
template <int HD, int NQ, int P>
__device__ __forceinline__ void score_step(const float* krow,
                                           const float* qs, int warp, int d0,
                                           float (&acc)[NQ][P]) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int d = d0 + 4 * p;
    const float k0 = krow[d], k1 = krow[d + 1], k2 = krow[d + 2],
                k3 = krow[d + 3];
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const float4 qv = *reinterpret_cast<const float4*>(
          qs + (warp + kWarps * i) * HD + d);
      acc[i][p] = fmaf(qv.x, k0, acc[i][p]);
      acc[i][p] = fmaf(qv.y, k1, acc[i][p]);
      acc[i][p] = fmaf(qv.z, k2, acc[i][p]);
      acc[i][p] = fmaf(qv.w, k3, acc[i][p]);
    }
  }
}

// Dot products of this lane's key row with the warp's first NQ queries.
// P independent partial sums per query keep the FMA chains short when
// few queries are live (decode rows).
template <int HD, int NQ>
__device__ __forceinline__ void score_keys(const float* krow,
                                           const float* qs, int warp,
                                           float* s) {
  constexpr int P = NQ == 1 ? 4 : (NQ == 2 ? 2 : 1);
  float acc[NQ][P];
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int p = 0; p < P; ++p) acc[i][p] = 0.f;
  // fully unrolled up to hd = 256; past it four steps at a time (fully
  // unrolled, those kernels took minutes to build)
  if constexpr (HD <= 256) {
#pragma unroll
    for (int d0 = 0; d0 < HD; d0 += 4 * P)
      score_step<HD, NQ, P>(krow, qs, warp, d0, acc);
  } else {
#pragma unroll 4
    for (int d0 = 0; d0 < HD; d0 += 4 * P)
      score_step<HD, NQ, P>(krow, qs, warp, d0, acc);
  }
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    float t = 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p) t += acc[i][p];
    s[i] = t;
  }
}

// acc += p_j V_j of key j of the staged tile (p_j from lane j).
template <int HD, int VEC, int NQ>
__device__ __forceinline__ void attend_key(
    const float* vs, int lane, int j, const float (&p)[NQ],
    float (&acc)[kQueriesPerWarp][VEC]) {
  float vv[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) vv[v] = vs[j * HD + lane + 32 * v];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const float pj = __shfl_sync(kFull, p[i], j);
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[i][v] = fmaf(pj, vv[v], acc[i][v]);
  }
}

// One staged key tile for the warp's first NQ live queries: scores,
// online-softmax update, P.V.  Keys past a query's causal horizon get
// p = 0 (no branch), so every loop unrolls and the NQ queries' reduction
// chains interleave.  qpos0 is the absolute position of the warp's first
// query; query i sits kWarps * i further.
template <int HD, int VEC, int NQ>
__device__ __forceinline__ void attend_tile(
    const float* ks, const float* vs, const float* qs, int warp, int lane,
    int kt0, int qpos0, float scale, float (&acc)[kQueriesPerWarp][VEC],
    float (&m)[kQueriesPerWarp], float (&l)[kQueriesPerWarp]) {
  float s[NQ], p[NQ];
  score_keys<HD, NQ>(ks + lane * Smem<HD>::kStride, qs, warp, s);
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const bool visible = kt0 + lane <= qpos0 + kWarps * i;
    const float si = visible ? s[i] * scale : -INFINITY;
    const float m_new = fmaxf(m[i], warp_max(si));
    // a query that has seen no key yet keeps m = -inf, l = acc = 0
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float corr = expf(m[i] - m_use);
    p[i] = expf(si - m_use);
    l[i] = l[i] * corr + warp_sum(p[i]);
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[i][v] *= corr;
    m[i] = m_new;
  }
  // fully unrolled up to hd = 256; past it four keys at a time
  if constexpr (VEC <= 8) {
#pragma unroll
    for (int j = 0; j < kKeyTile; ++j)
      attend_key<HD, VEC, NQ>(vs, lane, j, p, acc);
  } else {
#pragma unroll 4
    for (int j = 0; j < kKeyTile; ++j)
      attend_key<HD, VEC, NQ>(vs, lane, j, p, acc);
  }
}

// hd = 32 * VEC (VEC <= 8) elements of the head dimension, VEC a lane;
// 16-byte aligned rows.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_pages,
                              const T* __restrict__ v_pages,
                              const int* __restrict__ page_tables,
                              const int* __restrict__ query_lens,
                              const int* __restrict__ context_lens,
                              T* __restrict__ out, int Q, int H,
                              int page_size, int max_pages, int num_pages,
                              float scale) {
  constexpr int HD = 32 * VEC;
  using S = Smem<HD>;
  constexpr int EPL = 16 / sizeof(T);             // elements per 16 bytes
  constexpr int CHUNKS_PER_KEY = HD / EPL;
  constexpr int CHUNKS = kKeyTile * CHUNKS_PER_KEY;
  constexpr int CPT = (CHUNKS + kThreads - 1) / kThreads;  // per thread
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = smem + S::kK;
  float* qs = vs + S::kV;
  int* pages = reinterpret_cast<int*>(qs + S::kQ);

  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const int qlen = query_lens[b];
  const int ctx = min(context_lens[b], max_pages * page_size);
  const int t0 = tile * kQueryTile;
  // live queries [t0, t1); a qlen past the padded width Q reads no slot
  // outside the row
  const int t1 = min(min(t0 + kQueryTile, qlen), Q);
  const size_t tok_stride = (size_t)H * HD;
  const T* q_row = q + (size_t)b * Q * tok_stride + (size_t)h * HD;
  T* o_row = out + (size_t)b * Q * tok_stride + (size_t)h * HD;

  if (t0 >= t1) {
    // idle row, or a tile wholly past qlen: padded slots are zeros
#pragma unroll
    for (int i = 0; i < kQueriesPerWarp; ++i) {
      const int t = t0 + warp + kWarps * i;
      if (t >= Q) continue;
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        store(o_row + (size_t)t * tok_stride + lane + 32 * v, 0.f);
    }
    return;
  }

  // keys the tile's last live query can see: positions 0 .. kv_len - 1
  const int kv_len = ctx - qlen + t1;
  const int* table = page_tables + (size_t)b * max_pages;
  for (int i = threadIdx.x; i * page_size < kv_len; i += kThreads)
    pages[i] = table[i];

  uint4 kraw[CPT], vraw[CPT];
  auto fetch = [&](int kt0) {                     // global -> registers
#pragma unroll
    for (int r = 0; r < CPT; ++r) {
      const int c = threadIdx.x + kThreads * r;
      kraw[r] = vraw[r] = make_uint4(0u, 0u, 0u, 0u);
      if (c >= CHUNKS) continue;
      const int pos = kt0 + c / CHUNKS_PER_KEY;
      if (pos >= kv_len) continue;
      const int page = pages[pos / page_size];
      if (page < 0 || page >= num_pages) continue;
      const size_t off =
          (((size_t)page * page_size + pos % page_size) * H + h) * HD +
          (c % CHUNKS_PER_KEY) * EPL;
      kraw[r] = __ldg(reinterpret_cast<const uint4*>(k_pages + off));
      vraw[r] = __ldg(reinterpret_cast<const uint4*>(v_pages + off));
    }
  };
  // the query tile, widened to fp32 (dead slots zero)
  for (int e = threadIdx.x; e < kQueryTile * HD; e += kThreads) {
    const int tt = e / HD;
    const int t = t0 + tt;
    qs[e] = t < t1 ? to_float(q_row[(size_t)t * tok_stride + e % HD]) : 0.f;
  }
  __syncthreads();                                // page ids staged
  fetch(0);

  float acc[kQueriesPerWarp][VEC];
  float m[kQueriesPerWarp];
  float l[kQueriesPerWarp];
#pragma unroll
  for (int i = 0; i < kQueriesPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[i][v] = 0.f;
  }
  // live queries of this warp: i < nq
  const int nq = min(kQueriesPerWarp,
                     max(0, (t1 - t0 - warp + kWarps - 1) / kWarps));

  for (int kt0 = 0; kt0 < kv_len; kt0 += kKeyTile) {
    __syncthreads();                              // previous tile consumed
#pragma unroll
    for (int r = 0; r < CPT; ++r) {               // registers -> smem
      const int c = threadIdx.x + kThreads * r;
      if (c >= CHUNKS) continue;
      const int j = c / CHUNKS_PER_KEY;
      const int d = (c % CHUNKS_PER_KEY) * EPL;
      float kf[EPL], vf[EPL];
      widen<T>(kraw[r], kf);
      widen<T>(vraw[r], vf);
#pragma unroll
      for (int e = 0; e < EPL; ++e) ks[j * S::kStride + d + e] = kf[e];
#pragma unroll
      for (int e = 0; e < EPL; e += 4)
        *reinterpret_cast<float4*>(&vs[j * HD + d + e]) =
            make_float4(vf[e], vf[e + 1], vf[e + 2], vf[e + 3]);
    }
    __syncthreads();
    if (kt0 + kKeyTile < kv_len) fetch(kt0 + kKeyTile);  // next tile in flight

    const int qpos0 = ctx - qlen + t0 + warp;
    switch (nq) {                                 // warp-uniform
      case 1:
        attend_tile<HD, VEC, 1>(ks, vs, qs, warp, lane, kt0, qpos0, scale,
                                acc, m, l);
        break;
      case 2:
        attend_tile<HD, VEC, 2>(ks, vs, qs, warp, lane, kt0, qpos0, scale,
                                acc, m, l);
        break;
      case 3:
        attend_tile<HD, VEC, 3>(ks, vs, qs, warp, lane, kt0, qpos0, scale,
                                acc, m, l);
        break;
      case 4:
        attend_tile<HD, VEC, 4>(ks, vs, qs, warp, lane, kt0, qpos0, scale,
                                acc, m, l);
        break;
      default:
        break;
    }
  }

#pragma unroll
  for (int i = 0; i < kQueriesPerWarp; ++i) {
    const int t = t0 + warp + kWarps * i;
    if (t >= Q) continue;
    const bool live = i < nq;
    const float inv = live ? 1.f / (l[i] == 0.f ? 1.f : l[i]) : 0.f;
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      store(o_row + (size_t)t * tok_stride + lane + 32 * v,
            live ? acc[i][v] * inv : 0.f);
  }
}

// VEC >= ceil(hd / 32) elements of the head dimension per lane; vec16:
// rows are read 16 bytes at a time (hd * sizeof(T) % 16 == 0 and the
// pointers 16-byte aligned), else one element at a time.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
ragged_any_hd_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                     const T* __restrict__ v_pages,
                     const int* __restrict__ page_tables,
                     const int* __restrict__ query_lens,
                     const int* __restrict__ context_lens,
                     T* __restrict__ out, int Q, int H, int hd,
                     int page_size, int max_pages, int num_pages,
                     float scale, int vec16) {
  constexpr int HD = 32 * VEC;                    // padded tile width
  using S = Smem<HD>;
  constexpr int EPL = 16 / sizeof(T);             // elements a 16-byte load
  constexpr int CHUNKS_PER_KEY = HD / EPL;
  constexpr int CHUNKS = kKeyTile * CHUNKS_PER_KEY;
  constexpr int CPT = (CHUNKS + kThreads - 1) / kThreads;  // per thread
  // 16-byte rows up to hd = 256: the next tile in registers while this
  // one is scored; otherwise each tile is loaded straight into shared
  // memory
  constexpr bool kFits = VEC <= 8;
  const bool prefetch = kFits && vec16;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = smem + S::kK;
  float* qs = vs + S::kV;
  int* pages = reinterpret_cast<int*>(qs + S::kQ);

  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const int qlen = query_lens[b];
  const int ctx = min(context_lens[b], max_pages * page_size);
  const int t0 = tile * kQueryTile;
  // live queries [t0, t1); a qlen past the padded width Q reads no slot
  // outside the row
  const int t1 = min(min(t0 + kQueryTile, qlen), Q);
  const size_t tok_stride = (size_t)H * hd;
  const T* q_row = q + (size_t)b * Q * tok_stride + (size_t)h * hd;
  T* o_row = out + (size_t)b * Q * tok_stride + (size_t)h * hd;

  if (t0 >= t1) {
    // idle row, or a tile wholly past qlen: padded slots are zeros
#pragma unroll
    for (int i = 0; i < kQueriesPerWarp; ++i) {
      const int t = t0 + warp + kWarps * i;
      if (t >= Q) continue;
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        if (lane + 32 * v < hd)
          store(o_row + (size_t)t * tok_stride + lane + 32 * v, 0.f);
    }
    return;
  }

  // keys the tile's last live query can see: positions 0 .. kv_len - 1
  const int kv_len = ctx - qlen + t1;
  const int* table = page_tables + (size_t)b * max_pages;
  for (int i = threadIdx.x; i * page_size < kv_len; i += kThreads)
    pages[i] = table[i];

  // element offset of key j, column d of key tile kt0 in the pool, or -1
  // where it is dead (past kv_len, past hd, or an invalid page id)
  auto elem_at = [&](int kt0, int j, int d) -> long long {
    const int pos = kt0 + j;
    if (pos >= kv_len || d >= hd) return -1;
    const int page = pages[pos / page_size];
    if (page < 0 || page >= num_pages) return -1;
    return (((long long)page * page_size + pos % page_size) * H + h) * hd + d;
  };
  // 16 bytes of K and V widened to fp32 into the tiles at key j, column d
  auto put = [&](int j, int d, const uint4& kr, const uint4& vr) {
    float kf[EPL], vf[EPL];
    widen<T>(kr, kf);
    widen<T>(vr, vf);
#pragma unroll
    for (int e = 0; e < EPL; ++e) ks[j * S::kStride + d + e] = kf[e];
#pragma unroll
    for (int e = 0; e < EPL; e += 4)
      *reinterpret_cast<float4*>(&vs[j * HD + d + e]) =
          make_float4(vf[e], vf[e + 1], vf[e + 2], vf[e + 3]);
  };
  auto load16 = [&](int kt0, int c, uint4& kr, uint4& vr) {
    kr = vr = make_uint4(0u, 0u, 0u, 0u);
    const long long off =
        elem_at(kt0, c / CHUNKS_PER_KEY, (c % CHUNKS_PER_KEY) * EPL);
    if (off < 0) return;
    kr = __ldg(reinterpret_cast<const uint4*>(k_pages + off));
    vr = __ldg(reinterpret_cast<const uint4*>(v_pages + off));
  };
  uint4 kraw[kFits ? CPT : 1], vraw[kFits ? CPT : 1];
  auto fetch = [&](int kt0) {                     // global -> registers
    if constexpr (kFits) {
      if (!prefetch) return;
#pragma unroll
      for (int r = 0; r < CPT; ++r) {
        const int c = threadIdx.x + kThreads * r;
        if (c < CHUNKS) load16(kt0, c, kraw[r], vraw[r]);
      }
    }
  };
  // the tile at kt0 from the pool into shared memory (after a barrier)
  auto stage = [&](int kt0) {
    if (prefetch) {
      if constexpr (kFits) {
#pragma unroll
        for (int r = 0; r < CPT; ++r) {           // registers -> smem
          const int c = threadIdx.x + kThreads * r;
          if (c < CHUNKS)
            put(c / CHUNKS_PER_KEY, (c % CHUNKS_PER_KEY) * EPL, kraw[r],
                vraw[r]);
        }
      }
    } else if (vec16) {
      for (int c = threadIdx.x; c < CHUNKS; c += kThreads) {
        uint4 kr, vr;
        load16(kt0, c, kr, vr);
        put(c / CHUNKS_PER_KEY, (c % CHUNKS_PER_KEY) * EPL, kr, vr);
      }
    } else {                                      // one element a load
      for (int e = threadIdx.x; e < kKeyTile * HD; e += kThreads) {
        const int j = e / HD, d = e % HD;
        const long long off = elem_at(kt0, j, d);
        ks[j * S::kStride + d] = off >= 0 ? to_float(k_pages[off]) : 0.f;
        vs[j * HD + d] = off >= 0 ? to_float(v_pages[off]) : 0.f;
      }
    }
  };
  // the query tile, widened to fp32 (dead slots and columns past hd zero)
  for (int e = threadIdx.x; e < kQueryTile * HD; e += kThreads) {
    const int t = t0 + e / HD, d = e % HD;
    qs[e] = t < t1 && d < hd ? to_float(q_row[(size_t)t * tok_stride + d])
                             : 0.f;
  }
  __syncthreads();                                // page ids staged
  fetch(0);

  float acc[kQueriesPerWarp][VEC];
  float m[kQueriesPerWarp];
  float l[kQueriesPerWarp];
#pragma unroll
  for (int i = 0; i < kQueriesPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[i][v] = 0.f;
  }
  // live queries of this warp: i < nq
  const int nq = min(kQueriesPerWarp,
                     max(0, (t1 - t0 - warp + kWarps - 1) / kWarps));

  for (int kt0 = 0; kt0 < kv_len; kt0 += kKeyTile) {
    __syncthreads();                              // previous tile consumed
    stage(kt0);
    __syncthreads();
    if (kt0 + kKeyTile < kv_len) fetch(kt0 + kKeyTile);  // next tile in flight

    const int qpos0 = ctx - qlen + t0 + warp;
    switch (nq) {                                 // warp-uniform
      case 1:
        attend_tile<HD, VEC, 1>(ks, vs, qs, warp, lane, kt0, qpos0, scale,
                                acc, m, l);
        break;
      case 2:
        attend_tile<HD, VEC, 2>(ks, vs, qs, warp, lane, kt0, qpos0, scale,
                                acc, m, l);
        break;
      case 3:
        attend_tile<HD, VEC, 3>(ks, vs, qs, warp, lane, kt0, qpos0, scale,
                                acc, m, l);
        break;
      case 4:
        attend_tile<HD, VEC, 4>(ks, vs, qs, warp, lane, kt0, qpos0, scale,
                                acc, m, l);
        break;
      default:
        break;
    }
  }

#pragma unroll
  for (int i = 0; i < kQueriesPerWarp; ++i) {
    const int t = t0 + warp + kWarps * i;
    if (t >= Q) continue;
    const bool live = i < nq;
    const float inv = live ? 1.f / (l[i] == 0.f ? 1.f : l[i]) : 0.f;
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      if (lane + 32 * v < hd)
        store(o_row + (size_t)t * tok_stride + lane + 32 * v,
              live ? acc[i][v] * inv : 0.f);
  }
}

constexpr int kMaxHeadDim = 512;
constexpr size_t kMaxSmem = 232448;   // 227 KB: a block's limit on sm_90
static_assert(Smem<kMaxHeadDim>::kBytes == 163968, "hd = 512 tiles");
static_assert(Smem<kMaxHeadDim>::kBytes < kMaxSmem, "hd = 512 tiles fit");

template <typename T, int VEC>
int launch_one(const void* q, const void* kp, const void* vp,
               const int* tables, const int* qlens, const int* ctxs,
               void* out, int B, int Q, int H, int page_size, int max_pages,
               int num_pages, float scale, cudaStream_t stream) {
  const size_t bytes = Smem<32 * VEC>::kBytes + sizeof(int) * max_pages;
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = ragged_paged_attention_kernel<T, VEC>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Q + kQueryTile - 1) / kQueryTile, H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tables, qlens, ctxs, static_cast<T*>(out),
      Q, H, page_size, max_pages, num_pages, scale);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_any(const void* q, const void* kp, const void* vp,
               const int* tables, const int* qlens, const int* ctxs,
               void* out, int B, int Q, int H, int hd, int page_size,
               int max_pages, int num_pages, float scale, int vec16,
               cudaStream_t stream) {
  const size_t bytes = Smem<32 * VEC>::kBytes + sizeof(int) * max_pages;
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = ragged_any_hd_kernel<T, VEC>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Q + kQueryTile - 1) / kQueryTile, H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tables, qlens, ctxs, static_cast<T*>(out),
      Q, H, hd, page_size, max_pages, num_pages, scale, vec16);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dtype(const void* q, const void* kp, const void* vp,
                 const int* tables, const int* qlens, const int* ctxs,
                 void* out, int B, int Q, int H, int head_dim,
                 int page_size, int max_pages, int num_pages, float scale,
                 int vec16, cudaStream_t stream) {
#define RPA_FAST(V)                                                        \
  return launch_one<T, V>(q, kp, vp, tables, qlens, ctxs, out, B, Q, H,   \
                          page_size, max_pages, num_pages, scale, stream)
#define RPA_CASE(V)                                                        \
  return launch_any<T, V>(q, kp, vp, tables, qlens, ctxs, out, B, Q, H,   \
                          head_dim, page_size, max_pages, num_pages,      \
                          scale, vec16, stream)
  if (vec16 && head_dim % 32 == 0 && head_dim <= 256) {
    switch (head_dim / 32) {
      case 1: RPA_FAST(1);
      case 2: RPA_FAST(2);
      case 3: RPA_FAST(3);
      case 4: RPA_FAST(4);
      case 5: RPA_FAST(5);
      case 6: RPA_FAST(6);
      case 7: RPA_FAST(7);
      default: RPA_FAST(8);
    }
  }
  // VEC = ceil(hd / 32), rounded up to 12 or 16 past 8
  switch ((head_dim + 31) / 32) {
    case 1: RPA_CASE(1);
    case 2: RPA_CASE(2);
    case 3: RPA_CASE(3);
    case 4: RPA_CASE(4);
    case 5: RPA_CASE(5);
    case 6: RPA_CASE(6);
    case 7: RPA_CASE(7);
    case 8: RPA_CASE(8);
    case 9: case 10: case 11: case 12: RPA_CASE(12);
    case 13: case 14: case 15: case 16: RPA_CASE(16);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RPA_CASE
#undef RPA_FAST
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; 1 <= head_dim <= 512.  vec16: rows
// are read 16 bytes at a time, which needs head_dim * sizeof(dtype) % 16
// == 0 and 16-byte aligned q / k_pages / v_pages (the wrapper checks);
// 0 reads one element at a time.  Returns the launch's cudaGetLastError()
// (0 = ok).
extern "C" int ragged_paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_tables, const void* query_lens,
    const void* context_lens, void* out, int B, int Q, int H, int head_dim,
    int page_size, int max_pages, int num_pages, float scale, int dtype,
    int vec16, void* stream) {
  if (head_dim < 1 || head_dim > kMaxHeadDim || B <= 0 || Q <= 0 ||
      H <= 0 || page_size <= 0 || max_pages <= 0)
    return (int)cudaErrorInvalidValue;
  const int elem = dtype == 0 ? 4 : 2;
  if (vec16 && (head_dim * elem) % 16 != 0) return (int)cudaErrorInvalidValue;
  const int* tables = static_cast<const int*>(page_tables);
  const int* qlens = static_cast<const int*>(query_lens);
  const int* ctxs = static_cast<const int*>(context_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dtype<float>(q, k_pages, v_pages, tables, qlens, ctxs, out,
                               B, Q, H, head_dim, page_size, max_pages,
                               num_pages, scale, vec16, s);
  if (dtype == 1)
    return launch_dtype<__nv_bfloat16>(q, k_pages, v_pages, tables, qlens,
                                       ctxs, out, B, Q, H, head_dim,
                                       page_size, max_pages, num_pages,
                                       scale, vec16, s);
  return (int)cudaErrorInvalidValue;
}

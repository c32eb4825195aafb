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
// (m, l, acc), with l == 0 -> 1 as in the TPU kernel.  A page id outside
// the pool reads as zeros.  The pool is read as it is allocated: no copy,
// no re-pad.
//
// What bounds it on the H100: memory.  A call must read the live K/V of
// every row, sum_b ctx_b * H * hd * 2 (K and V) * 2 bytes at bf16, and
// does ~4 FLOPs per K/V element read per query, far below the ~295 a byte
// at which the tensor cores would be the limit.  The design streams each
// row's live K/V once, spread over the whole card:
//
//   - The kv axis is split.  The work is (query tile of 16 tokens, split,
//     head-dim output chunk) x head x row; a split is a fixed span of
//     keys (256, widened only where the partial results would take too
//     much scratch; the wrapper sizes it from the static shapes).  The
//     kernel is persistent: as many blocks as fit on the card walk the
//     work items in turn, so the items of idle tiles (a decode row's
//     tiles past its one query) and of splits past a tile's keys cost two
//     cached loads instead of a block.  A live item walks the keys
//     [split * span, ...) that its tile's last query can see.  A tile
//     whose keys fit one split writes its output directly; otherwise
//     every split writes fp32 partials (m, l, acc) into scratch and a
//     second small kernel, ragged_paged_attention_combine, merges them in
//     split order (a split that saw no key of a row has m = -inf and
//     weight 0).  Nothing is read on the host: the grid, the span and the
//     scratch depend only on the shapes, so a call can be captured in a
//     CUDA graph.
//   - Every warp is busy on every row.  A block's four warps split the
//     keys of each stage (64 keys, 16 a warp; 32 and 8 at fp32) for all
//     16 queries of the tile, and merge their (m, l, acc) through shared
//     memory at the end; so a decode row (one live query) runs on four
//     warps, not one.
//   - K and V are staged with cp.async, 16 bytes a thread, in a ring of
//     two stages: the copies of stage i + 1 are in flight while stage i
//     is computed, and three blocks fit an SM at bf16, two at fp32.  The
//     tile's queries are loaded once an item, with its first stage; a
//     key's page id is read from the table (cached) as its row is copied.
//     Rows that are not a multiple of 16 bytes (hd odd, or hd % 8 != 0 at
//     bf16), or pointers that are not 16-byte aligned, are loaded one
//     element at a time instead (the wrapper says which).
//   - bf16 runs on the tensor cores: S = Q K^T and P V as mma.sync
//     m16n8k16 with fp32 accumulators, P rounded to bf16 for its product
//     (the FlashAttention-2 register layout: S's accumulators are P's A
//     fragments).  fp32 stays on CUDA cores, no TF32, with the same split,
//     staging and warps: lane j of a warp scores key j of its 8 (a quarter
//     of the head dim each, four lanes a key) against the tile's live
//     queries, and owns head-dim columns lane + 32 v of P V.
//
// Head dims: any hd >= 1.  A stage holds a W-column chunk of the head dim
// (W = 64 for hd <= 64, else 128), so past W the scores are summed over
// ceil(hd / W) chunks (Q and K chunks staged together, zero-filled past
// hd), and an item writes W output columns: the work's output-chunk axis
// recomputes the scores for each further chunk of W columns.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;                  // query tokens of a block
// keys of a stage: 16 a warp at bf16 (an mma's k), 8 at fp32 (whose
// stages take twice the bytes); spans are multiples of the larger
template <typename T>
constexpr int kKeysOf = sizeof(T) == 2 ? 16 * kWarps : 8 * kWarps;
constexpr int kSpanUnit = 16 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;        // 227 KB: a block's limit on sm_90

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* tables;
  const int* qlens;
  const int* ctxs;
  void* out;
  float* part;   // splits > 1: m, l [B, H, Q, splits], acc [.., hd]
  int B, Q, H, hd, ps, max_pages, num_pages, splits, span;
  float scale;
  int vec16;
};

// What a block (or the combine) derives from its row's lengths.
struct Tile {
  int qlen, ctx, t0, t1, t_end, kv_len, nsplit;
  __device__ Tile(const Args& a, int b, int tile) {
    qlen = __ldg(a.qlens + b);
    ctx = min(__ldg(a.ctxs + b), a.max_pages * a.ps);
    t0 = tile * kRows;
    t_end = min(t0 + kRows, a.Q);
    // live queries [t0, t1); a qlen past the padded width Q reads no slot
    // outside the row
    t1 = min(min(t0 + kRows, qlen), a.Q);
    // keys the tile's last live query can see: positions 0 .. kv_len - 1
    kv_len = ctx - qlen + t1;
    nsplit = kv_len > a.span ? (kv_len + a.span - 1) / a.span : 1;
  }
};

// Shared memory: the tile's Q [kRows][LD] for the item, then a ring of
// two stages, each K and V [keys][LD] of one head-dim chunk (and its own
// Q chunk where the head dim takes several), in the input dtype.  Rows
// are padded by 16 bytes, so the 8 rows a fragment load or a quarter-warp
// reads fall in 8 different 4-bank groups.  Two stages, not more: at bf16
// three blocks then fit an SM, and more blocks hide more latency than a
// deeper ring (measured on an H100).  After an item's last stage the
// ring's bytes hold the warps' (m, l, acc) for the merge.
template <typename T, int W>
struct Smem {
  static constexpr int kStages = 2;
  static constexpr int kLd = W + 16 / (int)sizeof(T);
  static constexpr int kQ = kRows * kLd;
  static constexpr int kKV = kKeysOf<T> * kLd;
  static constexpr size_t kMerge = sizeof(float) * kWarps * kRows * (W + 2);
  __host__ __device__ static constexpr int stage(bool q_staged) {
    return 2 * kKV + (q_staged ? kQ : 0);
  }
  __host__ __device__ static constexpr size_t bytes(bool q_staged) {
    return sizeof(T) * (kQ + kStages * stage(q_staged)) > kMerge
               ? sizeof(T) * (kQ + kStages * stage(q_staged))
               : kMerge;
  }
};
static_assert(Smem<float, 128>::bytes(true) <= kMaxSmem, "fp32 tiles");
static_assert(3 * (Smem<bf16, 128>::bytes(false) + 1024) <= 233472,
              "three bf16 blocks an SM");

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes global -> shared, zero-filled where !valid (source size 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows 0..15, columns [k0, k0 + 16) of a row-major tile.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* X,
                                       int k0, int lane) {
  const bf16* p = X + (lane >> 2) * LD + k0 + 2 * (lane & 3);
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
}

// B fragments of B[k][n] = X[n][k] (X row-major, n = rows) for the k-step
// [k0, k0 + 16) and the n-tiles [n0, n0 + 8), [n0 + 8, n0 + 16): b[0],
// b[1] for the first, b[2], b[3] for the second.
template <int LD>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* X,
                                       int n0, int k0, int lane) {
  const bf16* p =
      X + (n0 + (lane >> 4) * 8 + (lane & 7)) * LD + k0 + ((lane >> 3) & 1) * 8;
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(addr));
}

// The same for B[k][n] = X[k][n] (X row-major, k = rows).
template <int LD>
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4], const bf16* X,
                                             int k0, int n0, int lane) {
  const bf16* p =
      X + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD + n0 + (lane >> 4) * 8;
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(addr));
}

// One warp's online softmax over its 16 keys of a stage and the 16 query
// rows of the tile, on the tensor cores (bf16).  Lane (g, c) = (lane / 4,
// lane % 4) holds rows g and g + 8 of the score accumulators, keys
// 2c, 2c + 1 (n-tile 0) and 8 + 2c, 9 + 2c (n-tile 1), and the same rows
// of acc, columns 8n + 2c, 8n + 2c + 1 of n-tile n.
template <int W>
struct MmaWarp {
  static constexpr int LD = Smem<bf16, W>::kLd;
  float s[2][4];
  float acc[W / 8][4];
  float m[2], l[2];

  __device__ void init() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < W / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }

  // S += Q K^T over one staged head-dim chunk (keys 16w .. 16w + 15).
  __device__ void score(const bf16* qs, const bf16* ks, bool first, int w,
                        int lane) {
    if (first)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk) {
      uint32_t a[4], b[4];
      load_a<LD>(a, qs, kk * 16, lane);
      load_b<LD>(b, ks, 16 * w, kk * 16, lane);
      mma_bf16(s[0], a, b[0], b[1]);
      mma_bf16(s[1], a, b[2], b[3]);
    }
  }

  // Mask, online-softmax update and acc += P V.  key0: position of the
  // warp's first key; qpos0: position of query row 0; rows >= nr are dead.
  __device__ void attend(const bf16* vs, int key0, int qpos0, int nr,
                         float scale, int w, int lane) {
    const int g = lane >> 2, c = lane & 3;
    float p[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = g + 8 * i;
      const int qpos = row < nr ? qpos0 + row : -1;   // dead rows see no key
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = key0 + 8 * nt + 2 * c + e;
          const float x = key <= qpos ? s[nt][2 * i + e] * scale : -INFINITY;
          p[i][2 * nt + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      // a row that has seen no key yet keeps m = -inf, l = acc = 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[i][e] = expf(p[i][e] - m_use);
        sum += p[i][e];
      }
      l[i] = l[i] * corr + sum;       // this lane's keys; summed at the end
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < W / 8; ++n) {
        acc[n][2 * i] *= corr;
        acc[n][2 * i + 1] *= corr;
      }
    }
    const uint32_t a[4] = {pack_bf16(p[0][0], p[0][1]),
                           pack_bf16(p[1][0], p[1][1]),
                           pack_bf16(p[0][2], p[0][3]),
                           pack_bf16(p[1][2], p[1][3])};
#pragma unroll
    for (int n = 0; n < W / 16; ++n) {
      uint32_t b[4];
      load_b_trans<LD>(b, vs, 16 * w, 16 * n, lane);
      mma_bf16(acc[2 * n], a, b[0], b[1]);
      mma_bf16(acc[2 * n + 1], a, b[2], b[3]);
    }
  }

  // The warp's (m, l, acc) of every row into the merge buffers.
  __device__ void save(float* Ms, float* Ls, float* As, int w, int lane) {
    const int g = lane >> 2, c = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[i];
      li += __shfl_xor_sync(kFull, li, 1);
      li += __shfl_xor_sync(kFull, li, 2);
      const int row = w * kRows + g + 8 * i;
      if (c == 0) {
        Ms[row] = m[i];
        Ls[row] = li;
      }
#pragma unroll
      for (int n = 0; n < W / 8; ++n) {
        As[row * W + 8 * n + 2 * c] = acc[n][2 * i];
        As[row * W + 8 * n + 2 * c + 1] = acc[n][2 * i + 1];
      }
    }
  }
};

// The same on CUDA cores (fp32).  Lane l scores key j = l % 8 of the
// warp's 8 over head-dim quarter l / 8 of the chunk (the quarters meet in
// two shuffles), for every live row; m, l are then the same in every
// lane, and acc[r][v] is row r, column lane + 32 v.  Only the nr live
// rows are computed (a warp-uniform bound), so a decode row costs one
// row's work.
template <int W>
struct FmaWarp {
  static constexpr int LD = Smem<float, W>::kLd;
  static constexpr int V = W / 32;
  float s[kRows];
  float acc[kRows][V];
  float m[kRows], l[kRows];

  __device__ void init() {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) acc[r][v] = 0.f;
    }
  }

  __device__ void score(const float* qs, const float* ks, bool first,
                        int nr, int w, int lane) {
    if (first)
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const int part = (lane >> 3) * (W / 4);
    const float* kr = ks + (8 * w + (lane & 7)) * LD + part;
#pragma unroll 4
    for (int d = 0; d < W / 4; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < nr) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qs + r * LD + part + d);
          s[r] = fmaf(qv.x, kv.x, s[r]);
          s[r] = fmaf(qv.y, kv.y, s[r]);
          s[r] = fmaf(qv.z, kv.z, s[r]);
          s[r] = fmaf(qv.w, kv.w, s[r]);
        }
    }
  }

  __device__ void attend(const float* vs, int key0, int qpos0, int nr,
                         float scale, int w, int lane) {
    const int key = key0 + (lane & 7);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < nr) {
        float dot = s[r] + __shfl_xor_sync(kFull, s[r], 8);
        dot += __shfl_xor_sync(kFull, dot, 16);
        const float x = key <= qpos0 + r ? dot * scale : -INFINITY;
        float mx = x;
#pragma unroll
        for (int o = 4; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
        const float m_new = fmaxf(m[r], mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float corr = expf(m[r] - m_use);
        const float p = expf(x - m_use);
        float sum = p;
#pragma unroll
        for (int o = 4; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
        l[r] = l[r] * corr + sum;
        m[r] = m_new;
        s[r] = p;                     // p of key (lane % 8), row r
#pragma unroll
        for (int v = 0; v < V; ++v) acc[r][v] *= corr;
      }
#pragma unroll 4
    for (int j = 0; j < 8; ++j) {
      float vv[V];
#pragma unroll
      for (int v = 0; v < V; ++v) vv[v] = vs[(8 * w + j) * LD + lane + 32 * v];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < nr) {
          const float pj = __shfl_sync(kFull, s[r], j);
#pragma unroll
          for (int v = 0; v < V; ++v) acc[r][v] = fmaf(pj, vv[v], acc[r][v]);
        }
    }
  }

  __device__ void save(float* Ms, float* Ls, float* As, int nr, int w,
                       int lane) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < nr) {
        const int row = w * kRows + r;
        if (lane == 0) {
          Ms[row] = m[r];
          Ls[row] = l[r];
        }
#pragma unroll
        for (int v = 0; v < V; ++v) As[row * W + lane + 32 * v] = acc[r][v];
      }
  }
};

// One work item: 16 query tokens of one row, one head, one split of the
// kv axis and one chunk of W output columns, with what its loads and its
// merge need.
struct Item {
  int b, h, split, oc, t0, t1, t_end, nsplit, qpos0, kb, ke, n_stages;
};

// The next item of this block's walk (work, work + gridDim.x, ...) from
// `work` on whose tile is live and whose split holds keys of it, into
// `it`, writing the zeros of the idle tiles it passes; false past the end.
template <typename T>
__device__ bool find(const Args& a, int n_kc, int& work, Item& it) {
  const int n_tiles = (a.Q + kRows - 1) / kRows;
  const int n_work = n_tiles * a.splits * n_kc * a.H * a.B;
  for (; work < n_work; work += gridDim.x) {
    int x = work;
    const int tile = x % n_tiles;
    x /= n_tiles;
    const int split = x % a.splits;
    x /= a.splits;
    const int oc = x % n_kc;
    x /= n_kc;
    const int h = x % a.H, b = x / a.H;
    const Tile tl(a, b, tile);
    if (tl.t0 >= tl.t1) {
      // idle row, or a tile wholly past qlen: padded slots are zeros
      // (every column, by the first split of the first chunk)
      if (split == 0 && oc == 0) {
        T* out = static_cast<T*>(a.out);
        for (int e = threadIdx.x; e < (tl.t_end - tl.t0) * a.hd;
             e += kThreads)
          out[(((size_t)b * a.Q + tl.t0 + e / a.hd) * a.H + h) * a.hd +
              e % a.hd] = from_float<T>(0.f);
      }
      continue;
    }
    if (split >= tl.nsplit) continue;           // no key of the tile here
    it.b = b;
    it.h = h;
    it.split = split;
    it.oc = oc;
    it.t0 = tl.t0;
    it.t1 = tl.t1;
    it.t_end = tl.t_end;
    it.nsplit = tl.nsplit;
    it.qpos0 = tl.ctx - tl.qlen + tl.t0;        // position of row 0
    it.kb = split * a.span;
    it.ke = min(it.kb + a.span, tl.kv_len);
    constexpr int K = kKeysOf<T>;
    it.n_stages = it.ke > it.kb ? (it.ke - it.kb + K - 1) / K * n_kc : 0;
    return true;
  }
  return false;
}

// A persistent kernel: as many blocks as fit on the card, each walking the
// work items blockIdx.x, + gridDim.x, ...; an item's stages run through
// the two-stage ring (the copies of stage s + 1 in flight while stage s
// is computed), then its four warps merge.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(const Args a) {
  using L = Smem<T, W>;
  constexpr int NS = L::kStages;
  constexpr int KEYS = kKeysOf<T>;
  constexpr bool kMma = sizeof(T) == 2;
  using Warp = typename std::conditional<kMma, MmaWarp<W>, FmaWarp<W>>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = a.hd;
  const int n_kc = (hd + W - 1) / W;            // head-dim chunks
  const bool q_staged = n_kc > 1;               // a Q chunk in every stage
  const int stage_len = L::stage(q_staged);
  T* q_res = reinterpret_cast<T*>(smem);
  T* ring = q_res + L::kQ;
  float* Ms = reinterpret_cast<float*>(smem);
  float* Ls = Ms + kWarps * kRows;
  float* As = Ls + kWarps * kRows;
  const T* q = static_cast<const T*>(a.q);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  T* out = static_cast<T*>(a.out);
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  // page_size a power of two (the serving engine's 16): shifts for the
  // page of a position
  const int ps_shift = (a.ps & (a.ps - 1)) == 0 ? __ffs(a.ps) - 1 : -1;

  Item it;
  for (int work = blockIdx.x; find<T>(a, n_kc, work, it);
       work += gridDim.x) {
    const int nr = it.t1 - it.t0;               // live query rows
    const int c0 = it.oc * W, cw = min(W, hd - c0);
    const int* table = a.tables + (size_t)it.b * a.max_pages;
    // element offset of the pool row of key pos (head h), or -1 where it
    // is dead (past ke, or an invalid page id: read as zeros)
    auto key_row = [&](int pos) -> long long {
      if (pos >= it.ke) return -1;
      const int pg = ps_shift >= 0 ? pos >> ps_shift : pos / a.ps;
      const int in_page = ps_shift >= 0 ? pos & (a.ps - 1) : pos % a.ps;
      const int page = __ldg(table + pg);
      if (page < 0 || page >= a.num_pages) return -1;
      return (((long long)page * a.ps + in_page) * a.H + it.h) * hd;
    };
    auto q_at = [&](int r) {
      return q + (((size_t)it.b * a.Q + it.t0 + r) * a.H + it.h) * hd;
    };
    auto slot = [&](int s) { return ring + (s % NS) * stage_len; };
    // stage s (key stage s / n_kc, head-dim chunk s % n_kc) into its ring
    // slot: K columns [dc, dc + W) (and Q's, where staged; else Q once,
    // with the first stage), with the last chunk V columns [c0, c0 + W);
    // zeros past hd, past ke and for dead rows
    auto issue = [&](int s) {
      T* qs = q_staged ? slot(s) : q_res;
      T* ks = slot(s) + (q_staged ? L::kQ : 0);
      T* vs = ks + L::kKV;
      const int k0 = it.kb + (s / n_kc) * KEYS;
      const int dc = (s % n_kc) * W;
      const bool with_q = q_staged || s == 0;
      const bool with_v = s % n_kc == n_kc - 1;
      if (a.vec16) {
        constexpr int E = 16 / sizeof(T), CPR = W / E;
        for (int i = tid; with_q && i < kRows * CPR; i += kThreads) {
          const int r = i / CPR, e = (i % CPR) * E;
          const bool ok = r < nr && dc + e < hd;
          cp_async16(qs + r * L::kLd + e, ok ? q_at(r) + dc + e : q, ok);
        }
        for (int i = tid; i < KEYS * CPR; i += kThreads) {
          const int j = i / CPR, e = (i % CPR) * E;
          const long long row = key_row(k0 + j);
          const bool okk = row >= 0 && dc + e < hd;
          cp_async16(ks + j * L::kLd + e, okk ? kp + row + dc + e : kp, okk);
          if (with_v) {
            const bool okv = row >= 0 && c0 + e < hd;
            cp_async16(vs + j * L::kLd + e, okv ? vp + row + c0 + e : vp,
                       okv);
          }
        }
      } else {                                  // one element a load
        for (int i = tid; with_q && i < kRows * W; i += kThreads) {
          const int r = i / W, e = i % W;
          qs[r * L::kLd + e] = r < nr && dc + e < hd ? q_at(r)[dc + e]
                                                     : from_float<T>(0.f);
        }
        for (int i = tid; i < KEYS * W; i += kThreads) {
          const int j = i / W, e = i % W;
          const long long row = key_row(k0 + j);
          ks[j * L::kLd + e] =
              row >= 0 && dc + e < hd ? kp[row + dc + e] : from_float<T>(0.f);
          if (with_v)
            vs[j * L::kLd + e] = row >= 0 && c0 + e < hd ? vp[row + c0 + e]
                                                         : from_float<T>(0.f);
        }
      }
    };

    Warp st;
    st.init();
    for (int s = 0; s < NS - 1; ++s) {
      if (s < it.n_stages) issue(s);
      cp_async_commit();
    }
    for (int s = 0; s < it.n_stages; ++s) {
      cp_async_wait<NS - 2>();
      __syncthreads();          // stage s landed; stage s - 1 consumed
      if (s + NS - 1 < it.n_stages) issue(s + NS - 1);
      cp_async_commit();
      const T* ks = slot(s) + (q_staged ? L::kQ : 0);
      const T* qs = q_staged ? slot(s) : q_res;
      const T* vs = ks + L::kKV;
      const int kc = s % n_kc;
      const int key0 = it.kb + (s / n_kc) * KEYS + KEYS / kWarps * w;
      if constexpr (kMma) {
        st.score(qs, ks, kc == 0, w, lane);
        if (kc == n_kc - 1)
          st.attend(vs, key0, it.qpos0, nr, a.scale, w, lane);
      } else {
        st.score(qs, ks, kc == 0, nr, w, lane);
        if (kc == n_kc - 1)
          st.attend(vs, key0, it.qpos0, nr, a.scale, w, lane);
      }
    }
    cp_async_wait<0>();
    __syncthreads();            // the ring is free for the merge buffers
    if constexpr (kMma)
      st.save(Ms, Ls, As, w, lane);
    else
      st.save(Ms, Ls, As, nr, w, lane);
    __syncthreads();

    // merge the four warps: thread tid takes row tid / 8, every 8th column
    const int r = tid >> 3, t = it.t0 + r;
    T* o = out + (((size_t)it.b * a.Q + t) * a.H + it.h) * hd + c0;
    if (t < it.t_end && r >= nr) {              // padded slot: zeros
      if (it.split == 0)
        for (int col = tid & 7; col < cw; col += 8) o[col] = from_float<T>(0.f);
    } else if (t < it.t_end) {
      float M = -INFINITY;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) M = fmaxf(M, Ms[i * kRows + r]);
      float wt[kWarps], lsum = 0.f;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) {
        wt[i] = M == -INFINITY ? 0.f : expf(Ms[i * kRows + r] - M);
        lsum += wt[i] * Ls[i * kRows + r];
      }
      auto acc_at = [&](int col) {
        float v = 0.f;
#pragma unroll
        for (int i = 0; i < kWarps; ++i)
          v += wt[i] * As[(i * kRows + r) * W + col];
        return v;
      };
      if (it.nsplit == 1) {
        const float inv = 1.f / (lsum == 0.f ? 1.f : lsum);
        for (int col = tid & 7; col < cw; col += 8)
          o[col] = from_float<T>(acc_at(col) * inv);
      } else {
        const size_t n_ml = (size_t)a.B * a.H * a.Q * a.splits;
        const size_t at =
            (((size_t)it.b * a.H + it.h) * a.Q + t) * a.splits + it.split;
        if (it.oc == 0 && (tid & 7) == 0) {
          a.part[at] = M;
          a.part[n_ml + at] = lsum;
        }
        float* pacc = a.part + 2 * n_ml + at * hd + c0;
        for (int col = tid & 7; col < cw; col += 8) pacc[col] = acc_at(col);
      }
    }
    __syncthreads();            // merge buffers read before the next copies
  }
}

// The merge of a tile's splits, in split order: one block per (16-query
// tile, head, row); a tile whose keys fit one split was written whole by
// the first kernel and returns at once.  Thread r < 16 computes row r's
// weights e^(m_s - M) and 1 / l; then each thread sums whole columns.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_combine(const Args a) {
  extern __shared__ float wts[];                // [kRows][splits + 1]
  const int h = blockIdx.y, b = blockIdx.z;
  const Tile tl(a, b, blockIdx.x);
  if (tl.t0 >= tl.t1 || tl.nsplit == 1) return;
  const int nr = tl.t1 - tl.t0, ns = tl.nsplit, S = a.splits, hd = a.hd;
  const size_t n_ml = (size_t)a.B * a.H * a.Q * S;
  const size_t row0 = (((size_t)b * a.H + h) * a.Q + tl.t0) * S;
  if (threadIdx.x < nr) {
    const float* m = a.part + row0 + (size_t)threadIdx.x * S;
    const float* l = m + n_ml;
    float* wr = wts + threadIdx.x * (S + 1);
    float M = -INFINITY;
    for (int s = 0; s < ns; ++s) M = fmaxf(M, m[s]);
    float lsum = 0.f;
    for (int s = 0; s < ns; ++s) {
      wr[s] = M == -INFINITY ? 0.f : expf(m[s] - M);
      lsum += wr[s] * l[s];
    }
    wr[S] = 1.f / (lsum == 0.f ? 1.f : lsum);
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out);
  for (int e = threadIdx.x; e < nr * hd; e += kThreads) {
    const int r = e / hd, col = e % hd;
    const float* wr = wts + r * (S + 1);
    const float* acc = a.part + 2 * n_ml + (row0 + (size_t)r * S) * hd + col;
    float x = 0.f;
#pragma unroll 4
    for (int s = 0; s < ns; ++s) x += wr[s] * acc[(size_t)s * hd];
    out[(((size_t)b * a.Q + tl.t0 + r) * a.H + h) * hd + col] =
        from_float<T>(x * wr[S]);
  }
}

int gcd(long long x, int y) {
  while (y) {
    const long long t = x % y;
    x = y;
    y = (int)t;
  }
  return (int)x;
}

template <typename T, int W>
int launch(const Args& a, cudaStream_t stream) {
  const int n_kc = (a.hd + W - 1) / W;
  const bool q_staged = n_kc > 1;
  const size_t bytes = Smem<T, W>::bytes(q_staged);
  auto kernel = ragged_paged_attention_kernel<T, W>;
  // blocks the card holds at once, per device and layout: asked once,
  // since the host's time per call sets a decode step's pace
  constexpr int kMaxDevices = 64;
  static int resident[kMaxDevices][2];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev >= kMaxDevices)
    return (int)(e != cudaSuccess ? e : cudaErrorInvalidDevice);
  int& blocks = resident[dev][q_staged];
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Smem<T, W>::bytes(true));
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, bytes);
    if (e != cudaSuccess) return (int)e;
    blocks = max(1, per_sm) * sms;
  }
  const int n_tiles = (a.Q + kRows - 1) / kRows;
  const long long n_work = (long long)n_tiles * a.splits * n_kc * a.H * a.B;
  // work indices are ints, stepped by the grid
  if (n_work > 2147483647LL - (1 << 20)) return (int)cudaErrorInvalidValue;
  // as many blocks as fit on the card at once, a count prime to n_tiles so
  // that each block's items cycle through the tiles (the live ones of a
  // decode row are tile 0 only)
  long long grid = min(n_work, (long long)blocks);
  while (grid > 1 && gcd(grid, n_tiles) != 1) --grid;
  kernel<<<(unsigned)grid, kThreads, bytes, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return (int)e;
  ragged_paged_attention_combine<T>
      <<<dim3(n_tiles, a.H, a.B), kThreads,
         sizeof(float) * kRows * (a.splits + 1), stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dtype(const Args& a, cudaStream_t stream) {
  return a.hd <= 64 ? launch<T, 64>(a, stream) : launch<T, 128>(a, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; any head_dim >= 1.  The kv axis is
// cut into `splits` spans of `span` keys (a multiple of 64; splits * span
// must cover max_pages * page_size; at most 767 splits).  splits > 1
// needs `partials`, fp32
// scratch of B * H * Q * splits * (head_dim + 2) floats, and launches the
// combine after the kernel.  vec16: rows are read 16 bytes at a time,
// which needs head_dim * sizeof(dtype) % 16 == 0 and 16-byte aligned q /
// k_pages / v_pages (the wrapper checks); 0 reads one element at a time.
// Returns the launches' cudaGetLastError() (0 = ok).
extern "C" int ragged_paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_tables, const void* query_lens,
    const void* context_lens, void* out, void* partials, int B, int Q, int H,
    int head_dim, int page_size, int max_pages, int num_pages, int splits,
    int span, float scale, int dtype, int vec16, void* stream) {
  if (head_dim < 1 || B <= 0 || Q <= 0 || H <= 0 || page_size <= 0 ||
      max_pages <= 0 || splits < 1 || span <= 0 || span % kSpanUnit != 0 ||
      (long long)splits * span < (long long)max_pages * page_size ||
      H > 65535 || B > 65535 ||
      (splits > 1 && (partials == nullptr ||
                      sizeof(float) * kRows * (splits + 1) > 48 * 1024)))
    return (int)cudaErrorInvalidValue;
  const int elem = dtype == 0 ? 4 : 2;
  if (vec16 && (head_dim * elem) % 16 != 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages,
               static_cast<const int*>(page_tables),
               static_cast<const int*>(query_lens),
               static_cast<const int*>(context_lens), out,
               static_cast<float*>(partials), B, Q, H, head_dim, page_size,
               max_pages, num_pages, splits, span, scale, vec16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dtype<float>(a, s);
  if (dtype == 1) return launch_dtype<bf16>(a, s);
  return (int)cudaErrorInvalidValue;
}

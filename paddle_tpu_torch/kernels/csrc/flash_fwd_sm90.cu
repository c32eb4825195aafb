// Flash attention forward for Hopper (sm_90a): wgmma + TMA, warp
// specialised.  The bf16 forward of every path (training, the remat
// "dots" recompute, and each ring pair's forward) runs this kernel; fp32
// inputs keep the scalar kernel of flash_attention.cu.
//
// Replaces the TPU kernel paddle_tpu/kernels/flash_attention.py:64
// _fwd_kernel, called by _flash_fwd (:127) through the pallas_call at
// :139.  Same function: O = softmax(Q K^T * scale) V over [B*H, S, D]
// bf16, lse = m + log(l) fp32 [B*H, S], the l == 0 -> 1 guard, the
// causal mask (keys k <= q) and the ragged end of S masked in-kernel,
// causal or not (a ring's full pairs are not).  Head dims 64, 128 and
// 256; the wrapper zero-pads D = 32 up to 64, which is exact.
//
// What bounds it on the H100: operations.  At the GPT-3 1.3B training
// shapes (B*H = 128, S = 2048, D = 128, causal) it does 4*D FLOPs per
// live (q, k) pair, 137.5 GFLOP: 0.139 ms at 989 TFLOP/s, against 269.5
// MB of traffic (0.080 ms at 3.35 TB/s).  Only wgmma reaches the tensor
// cores' full rate, and only if the tiles arrive without the math warps
// spending issue slots or registers on the copies.  So:
//
//   - one block per (128-query tile, b*h), launched so that the blocks
//     running at once share a group of heads whose K and V fit the L2
//     cache (one head's tiles side by side read its K and V from device
//     memory about once, where b*h-major blocks read them once a block),
//     and within a group the heaviest causal tiles first;
//   - three warpgroups: warpgroup 0 is the producer (one thread issues
//     every copy), warpgroups 1 and 2 are consumers of 64 query rows
//     each.  setmaxnreg moves registers from the producer (24 a thread)
//     to the consumers (240), which hold the fp32 O accumulator (D / 2
//     registers), the fp32 S tile (BN / 2) and P in bf16 (BN / 4);
//   - TMA (cp.async.bulk.tensor) loads Q once and streams K and V tiles
//     of BN keys (128, or 64 at D = 256) through a ring of 2 stages, with
//     a full and an empty barrier (mbarriers) per K tile and per V tile:
//     a K stage is freed as soon as its S = Q K^T is done, so K runs one
//     tile ahead of V and each load has about a tile's compute to land
//     in.  The tensor maps are 3-D over [B*H, S, D], so a tile
//     at the ragged end of S is zero-filled instead of reading the next
//     head's rows.  The 128-byte swizzle caps a box at 64 bf16 columns,
//     so a tile is D / 64 boxes of [rows][64], each 1024-byte aligned,
//     which is the layout the wgmma descriptors below describe;
//   - S = Q K^T is wgmma m64nBNk16 with A = Q and B = K from shared
//     memory (both K-major); O += P V is wgmma m64nDk16 with A = P from
//     registers (the fp32 S accumulator has the A-operand layout, so P
//     is packed to bf16 in place) and B = V from shared memory through
//     the transposed (MN-major) descriptor, V being stored [keys, D];
//   - the products overlap the softmax: at tile j a consumer issues
//     S_j = Q K_j^T and then O += P_{j-1} V_{j-1}, waits for S_j only,
//     runs the softmax of S_j while P_{j-1} V_{j-1} runs on the tensor
//     cores, then waits for it, rescales O and packs P_j.  The two
//     consumers take turns to issue (two named barriers), so one's
//     softmax runs while the other's products do;
//   - the softmax takes the row max on the raw scores and folds the
//     scale into the exponent (one FFMA and one ex2 a score), and skips
//     the rescale of O when no row max of a warp moved;
//   - causal: the kv loop ends at the diagonal (the TPU kernel's
//     should_run), and only the tiles that cross the diagonal or the end
//     of S are masked.
//
// P is rounded to bf16 for its product, where the TPU kernel keeps it
// fp32: one more rounding (2^-9 relative) per term, which the bf16
// tolerances cover.  Each output element is written once by one thread:
// no atomics, deterministic.  The host encodes the tensor maps with
// cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint so the
// library needs no -lcuda, once per (pointer, shape, box): the maps are
// cached (sm90.cuh), and passed as __grid_constant__ parameters.
#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int kBM = 128;            // query rows a block (2 x 64)
constexpr int kThreads = 384;       // producer + two consumer warpgroups
constexpr int kStages = 2;          // K/V tiles in flight
constexpr int kConsumers = 256;     // arrivals that free a stage
constexpr unsigned kFull = kFullMask;

template <int D>
struct Tiles {
  static constexpr int BN = D <= 128 ? 128 : 64;   // keys a tile
  static constexpr int NB = D / 64;                // 64-column boxes
  static constexpr int BOX_Q = kBM * 128;          // bytes of a Q box
  static constexpr int BOX_KV = BN * 128;          // bytes of a K/V box
  static constexpr int Q_BYTES = NB * BOX_Q;
  static constexpr int KV_BYTES = NB * BOX_KV;     // one K or V tile
  static constexpr int TILE_BYTES = Q_BYTES + 2 * kStages * KV_BYTES;
  // tiles, 1 + 4 kStages barriers, and slack to align the tiles to 1024
  // bytes
  static constexpr int SMEM = TILE_BYTES + 8 * (1 + 4 * kStages) + 1024;
};

// ------------------------------------------------------------- kernel

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// Accumulator layout of wgmma m64nN (fp32), per thread of a warpgroup:
// warp w owns rows 16w + g and 16w + g + 8 (g = lane / 4); element
// 4j + e is column 8j + 2(lane % 4) + (e & 1) of row 16w + g + 8(e >> 1).

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, int S, float scale_log2,
                          int causal, int BH, int G) {
  using T = Tiles<D>;
  constexpr int BN = T::BN, NB = T::NB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = base;
  uint8_t* Ks = Qs + T::Q_BYTES;                    // kStages tiles
  uint8_t* Vs = Ks + kStages * T::KV_BYTES;         // kStages tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + T::TILE_BYTES);
  // a full barrier per K and per V tile of a stage, and an empty one:
  // K of a stage is free once S = Q K^T is done, well before V is
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;                      // [kStages]
  uint64_t* v_full = k_full + kStages;              // [kStages]
  uint64_t* k_empty = v_full + kStages;             // [kStages]
  uint64_t* v_empty = k_empty + kStages;            // [kStages]

  // Blocks in launch order: heads in groups of G (whose K and V fit the
  // L2 cache together, so the blocks that run at once read them from
  // device memory about once); within a group, query tiles from the last
  // (the heaviest of a causal pass) to the first, the group's heads side
  // by side.
  const int n_q = (S + kBM - 1) / kBM;
  const int grp = blockIdx.x / (G * n_q), r = blockIdx.x % (G * n_q);
  const int gh = min(G, BH - grp * G);             // heads in this group
  const int bh = grp * G + r % gh;
  const int q0 = (n_q - 1 - r / gh) * kBM;
  const int kv_end = causal ? min(S, q0 + kBM) : S;
  const int n_tiles = (kv_end + BN - 1) / BN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], kConsumers);
      mbar_init(&v_empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      // tile `it` of K (or V) into its stage once the stage is free
      auto load = [&](const CUtensorMap* map, uint8_t* tiles,
                      uint64_t* full, uint64_t* empty, int it) {
        const int st = it % kStages, ph = (it / kStages) & 1;
        mbar_wait(&empty[st], ph ^ 1);
        mbar_expect_tx(&full[st], T::KV_BYTES);
        for (int c = 0; c < NB; ++c)
          tma_load(tiles + st * T::KV_BYTES + c * T::BOX_KV, map, &full[st],
                   64 * c, it * BN, bh);
      };
      mbar_expect_tx(q_full, T::Q_BYTES);
      for (int c = 0; c < NB; ++c)
        tma_load(Qs + c * T::BOX_Q, &tm_q, q_full, 64 * c, q0, bh);
      // K runs one tile ahead of V: S_{j+1} is issued before P_j V_j
      load(&tm_k, Ks, k_full, k_empty, 0);
      for (int it = 0; it < n_tiles; ++it) {
        if (it + 1 < n_tiles) load(&tm_k, Ks, k_full, k_empty, it + 1);
        load(&tm_v, Vs, v_full, v_empty, it);
      }
    }
  } else {
    // ---- consumers: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int w = wg - 1;                       // consumer index
    const int tid = threadIdx.x % 128;
    const int lane = tid & 31, t = lane & 3;
    const int r0 = q0 + 64 * w + 16 * (tid >> 5) + (lane >> 2);
    const int row[2] = {r0, r0 + 8};
    const int wg_row0 = q0 + 64 * w;            // this warpgroup's first row
    const uint8_t* Qw = Qs + 64 * w * 128;      // its rows of each Q box

    float o[D / 2];
    float s[BN / 2];
    uint32_t p[BN / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    // S = Q K^T over D / 16 k-steps: box kk / 4, 32 bytes per k-step
    auto issue_qk = [&](int st) {
      const uint8_t* kb = Ks + st * T::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / 4, off = (kk % 4) * 32;
        wgmma_ss(s, sw128_desc(Qw + c * T::BOX_Q + off, 16, 1024),
                     sw128_desc(kb + c * T::BOX_KV + off, 16, 1024), kk > 0);
      }
    };
    // O += P V over BN / 16 k-steps of 16 keys (2048 bytes each)
    auto issue_pv = [&](int st) {
      const uint8_t* vb = Vs + st * T::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs(o, p[kk], sw128_desc(vb + kk * 2048, T::BOX_KV, 1024));
    };
    // Scale, mask and exponentiate S of tile `it` in place; returns each
    // row's rescale factor of the running sums.
    auto softmax = [&](int it, float (&corr)[2]) {
      const int k0 = it * BN;
      const bool masked =
          (causal && k0 + BN - 1 > wg_row0) || k0 + BN > S;
      // the row max is taken on the raw scores, before scaling: the
      // wrapper passes scale >= 0 (a negative scale negates K instead)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        if (masked) {
          const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
          if (col >= S || (causal && col > row[(i >> 1) & 1]))
            s[i] = -INFINITY;
        }
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
      float mu[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[h], quad_max(mx[h]) * scale_log2);
        // a row with no live key yet keeps exp2(-inf - 0) = 0
        mu[h] = m_new == -INFINITY ? 0.f : m_new;
        corr[h] = exp2_approx(m[h] - mu[h]);
        m[h] = m_new;
        l[h] *= corr[h];
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        // a masked score is 0 outright (also at scale 0, where
        // -inf * 0 would not be -inf)
        const float e =
            masked && s[i] == -INFINITY
                ? 0.f
                : exp2_approx(fmaf(s[i], scale_log2, -mu[(i >> 1) & 1]));
        s[i] = e;
        l[(i >> 1) & 1] += e;             // this thread's part of the row
      }
    };
    auto rescale_and_pack = [&](const float (&corr)[2]) {
      // skip the rescale when no row max of the warp moved (corr == 1)
      if (__any_sync(kFull, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      }
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };

    // The consumers take turns to issue their products: consumer w waits
    // on named barrier 1 + w, issues, and hands the turn over on 2 - w.
    // Consumer 1 gives consumer 0 the first turn and skips the last
    // hand-over, so every arrival meets a wait.
    mbar_wait(q_full, 0);
    float corr[2];
    if (w == 1) named_arrive(1);
    // tile 0: its scores alone
    mbar_wait(&k_full[0], 0);
    named_sync(1 + w);
    wgmma_fence();
    issue_qk(0);
    wgmma_commit();
    named_arrive(2 - w);
    wgmma_wait<0>();
    reg_fence(s);
    mbar_arrive(&k_empty[0]);
    softmax(0, corr);
    rescale_and_pack(corr);
    for (int it = 1; it < n_tiles; ++it) {
      const int st = it % kStages, ph = (it / kStages) & 1;
      const int pst = (it - 1) % kStages, pph = ((it - 1) / kStages) & 1;
      mbar_wait(&k_full[st], ph);
      mbar_wait(&v_full[pst], pph);
      named_sync(1 + w);
      wgmma_fence();
      issue_qk(st);
      wgmma_commit();
      issue_pv(pst);
      wgmma_commit();
      named_arrive(2 - w);
      wgmma_wait<1>();                  // S_it is done; P V still runs
      reg_fence(s);
      mbar_arrive(&k_empty[st]);
      softmax(it, corr);
      wgmma_wait<0>();                  // P_{it-1} V_{it-1} is done
      reg_fence(o);
      reg_fence(p);
      mbar_arrive(&v_empty[pst]);
      rescale_and_pack(corr);
    }
    const int lst = (n_tiles - 1) % kStages;
    mbar_wait(&v_full[lst], ((n_tiles - 1) / kStages) & 1);
    named_sync(1 + w);
    wgmma_fence();
    issue_pv(lst);
    wgmma_commit();
    if (w == 0) named_arrive(2);
    wgmma_wait<0>();
    reg_fence(o);
    mbar_arrive(&v_empty[lst]);

    // epilogue: O / l in bf16, lse = (m + log2 l) ln 2 in natural units
    const size_t obase = (size_t)bh * S;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float lt = quad_sum(l[h]);
      if (row[h] >= S) continue;
      const float l_safe = lt == 0.f ? 1.f : lt;
      const float inv = 1.f / l_safe;
      uint32_t* dst = reinterpret_cast<uint32_t*>(
          out + (obase + row[h]) * D + 2 * t);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        dst[4 * j] = pack_bf16(o[4 * j + 2 * h] * inv,
                               o[4 * j + 2 * h + 1] * inv);
      if (t == 0) lse[obase + row[h]] = (m[h] + log2f(l_safe)) * kLn2;
    }
  }
}

// ---------------------------------------------------------------- host

template <int D>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse,
        int BH, int S, float scale, int causal, cudaStream_t st) {
  using T = Tiles<D>;
  CUtensorMap tq, tk, tv;
  int rc = cached_map(&tq, q, BH, S, D, kBM);
  if (!rc) rc = cached_map(&tk, k, BH, S, D, T::BN);
  if (!rc) rc = cached_map(&tv, v, BH, S, D, T::BN);
  if (rc) return rc;
  // heads whose K and V take about 16 MB together (a third of the L2)
  const long long kv_head = 4LL * S * D;
  const int G = (int)max(1LL, min((long long)BH, (16LL << 20) / kv_head));
  rc = (int)cudaFuncSetAttribute(flash_fwd_sm90_kernel<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 T::SMEM);
  if (rc) return rc;
  flash_fwd_sm90_kernel<D>
      <<<BH * ((S + kBM - 1) / kBM), kThreads, T::SMEM, st>>>(
          tq, tk, tv, (__nv_bfloat16*)out, (float*)lse, S, scale * kLog2e,
          causal, BH, G);
  return (int)cudaGetLastError();
}

static_assert(Tiles<256>::SMEM <= 232448, "227 KB a block");

}  // namespace

// The bf16 forward: q, k, v, out [BH, S, D] bf16 (16-byte aligned,
// contiguous), lse [BH, S] fp32; D in {64, 128, 256}.  Returns a CUDA
// error code, 0 on success.
extern "C" int flash_fwd_sm90_launch(const void* q, const void* k,
                                     const void* v, void* out, void* lse,
                                     int BH, int S, int D, float scale,
                                     int causal, void* stream) {
  if (BH <= 0 || S <= 0 ||
      (long long)BH * ((S + kBM - 1) / kBM) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return fwd<64>(q, k, v, out, lse, BH, S, scale, causal, st);
  if (D == 128) return fwd<128>(q, k, v, out, lse, BH, S, scale, causal, st);
  if (D == 256) return fwd<256>(q, k, v, out, lse, BH, S, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

// Flash attention backward for Hopper (sm_90a): dQ, dK and dV of every
// bf16 flash backward, and of every bf16 ring pair, in one kernel, wgmma
// + TMA, warp specialised (the FlashAttention-3 arrangement).  fp32
// inputs keep the scalar kernels of flash_attention.cu.
//
// Replaces the TPU kernels paddle_tpu/kernels/flash_attention.py:168
// _bwd_dkdv_kernel and :215 _bwd_dq_kernel, called by _flash_bwd (:257)
// through the pallas_calls at :270 and :298.  Same function: with lse
// and delta = rowsum(dO * O) from outside (the wrapper, as in the JAX
// package), over [B*H, S, D] bf16,
//   P = exp(s * scale - lse),  dS = P * (dO V^T - delta) * scale,
//   dV = P^T dO,  dK = dS^T Q,  dQ = dS K,
// with the causal mask (keys k <= q) and the ragged end of S masked
// in-kernel, causal or not.  Head dims 64, 128 and 256; the wrapper
// zero-pads D = 32 up to 64, which is exact.  Any scale, negative and 0
// included: nothing here takes a row max.
//
// What bounds it on the H100: operations.  At the GPT-3 1.3B training
// shapes (B*H = 128, S = 2048, D = 128, causal) the five products do
// 10*D FLOPs per live (q, k) pair, 343.8 GFLOP: 0.348 ms at 989 TFLOP/s,
// against 471.9 MB of traffic (0.141 ms at 3.35 TB/s).  The two kernels
// it replaces recomputed S and dP each (14*D a pair, 481.3 GFLOP) on
// mma.sync.  So:
//
//   - one block per (128-key tile, b*h, column half at D = 256): K and V
//     of the tile are loaded once and stay in shared memory while the
//     query tiles stream past; dK and dV accumulate in registers and are
//     written once;
//   - blocks take their work in groups of heads whose Q, dO and dQ sums
//     fit the L2 cache together, the last key tile (the least causal
//     work) first, so that each key tile's dQ adds wait on blocks that
//     started before it (below); a causal key tile visits only the query
//     tiles at or past it;
//   - three warpgroups: warpgroup 0's first warp is the producer (one
//     thread issues every TMA copy; its 32 lanes stage lse * log2(e) and
//     delta), warpgroups 1 and 2 are consumers of 64 keys each.
//     setmaxnreg moves registers from the producer (40 a thread: its lanes
//     also load rows) to the consumers (232);
//   - Q, dO, lse and delta stream in tiles of 64 queries through 2 stages
//     (1 at D = 256, where K, V and two stages of Q and dO would take 256
//     KB of the 227 a block may hold) with a full and an empty mbarrier a
//     stage.  The tensor maps are 3-D over [B*H, S, D] with 128-byte
//     swizzle and 64-column boxes (sm90.cuh), so rows past S read zeros;
//   - S^T = K Q^T and dP^T = V dO^T are wgmma SS with both operands K-major
//     from shared memory (a consumer's 64 keys are the M rows), issued
//     together; P^T is computed while dP^T still runs;
//   - dV += P^T dO and dK += dS^T Q are wgmma RS: the S^T / dP^T
//     accumulators have the A-operand layout, so P^T and dS^T are packed to
//     bf16 in registers, and B (dO or Q, stored [queries, D]) is read
//     through the MN-major descriptor;
//   - dQ = dS K needs dS with the queries as rows: each consumer stores its
//     64 rows of dS^T (bf16, in the 128-byte swizzle, double-buffered) to
//     shared memory, the two meet at a named barrier, and dQ's tile is
//     wgmma SS over the 128 keys with A = dS^T through the transposed
//     (MN-major) descriptor and B = K MN-major.  Its N (the dQ columns)
//     is split between the consumers, 64 columns each, so a consumer
//     holds dK and dV (D / 2 registers each at D <= 128), 32 registers of
//     P^T / dS^T fragments and 32 of dQ after S^T / dP^T are dead;
//   - at D = 256 a thread would hold 256 fp32 dK/dV registers: the output
//     columns split over two blocks a key tile (128 columns
//     each of dK, dV and dQ), each recomputing S^T and dP^T over the full
//     D, as flash_attention.cu's dK/dV kernel does;
//   - dQ sums over the key tiles into a zeroed fp32 [B*H, S, D] buffer,
//     which the wrapper rounds to bf16, in a fixed order: the last key
//     tile that reaches a query tile first, then the one before it, down
//     to key tile 0, so dQ is bit-reproducible from run to run (fp32
//     addition is not associative; an order that varied with the
//     scheduling would vary the last bits).  Each (b*h, query tile,
//     column block, consumer) has a turn counter in `turns` (int32,
//     zeroed by the caller with the buffer); a block waits until it
//     reads the number of key tiles after its own that reach the query
//     tile, adds its tile, and passes the turn on (sm90.cuh turn_wait /
//     turn_pass).  A waiting block must never hold the SM its
//     predecessor needs: blocks take their work from a ticket (turns[0],
//     an atomic add at the start), so a block only ever waits for work
//     that a block already running holds: key tile j + 1 of a head has
//     the smaller ticket.  A causal key tile j + 1 starts two query
//     tiles past key tile j and has two fewer to do, so it is ahead of
//     j at every query tile they share: the order costs key tile j no
//     wait, and the light tiles still finish early.
//     At D <= 128 each consumer writes its 64 x 64 tile of dQ to shared
//     memory (fp32, 128-byte swizzle, two buffers) and hands it to the
//     writer thread of that buffer in warpgroup 0 (lanes of warp 1, over
//     a full and an empty mbarrier a buffer), which waits for the turn,
//     adds the tile with two TMA reduce-adds (cp.reduce.async.bulk.tensor,
//     applied in the L2), waits for their writes and passes the turn:
//     the consumers go on with the next query tile meanwhile, and a
//     consumer's two buffers are in flight at once.  At
//     D = 256, where the tiles take the 227 KB, the consumer's thread 0
//     waits for the turn and the warpgroup adds its tile from registers
//     with float2 atomics (applied in the turn's order).  dK and dV are
//     written once by one thread each.
//
// P^T and dS^T are rounded to bf16 for their products, where the TPU
// kernels keep them fp32: one more rounding (2^-9 relative) per term,
// which the bf16 tolerances cover.
//
// A ring pair (RING = true, ring_pair_bwd_sm90_launch) is the same
// kernel.  It replaces the TPU's per-pair backward,
// paddle_tpu/kernels/ring_attention.py _pair_bwd (:89) and its two
// pallas_calls (:105 dK/dV, :133 dQ) of the flash kernels above, fed the
// ring-global lse and delta; the diagonal pair is causal, a full pair
// not.  What differs is where the outputs go: dQ, dK and dV are terms of
// the ring's running fp32 sums, and the kernel adds them in place.  dQ
// goes by the same ordered TMA reduce-adds (atomics at D = 256) into the
// caller's sum dq[i], which the ring zeroes once, not per pair (the turn
// counters are zeroed for each pair); dK and dV are read, added and
// written back in fp32 by the one thread that owns each element, so the
// pair is deterministic.  dO comes in bf16 (the
// ring rounds its fp32 dO once a call, exact on the training path,
// where it is the copy of a bf16 gradient).  At the sep = 4 training
// shapes (B*H = 128, s = 512, D = 128) bytes bound a pair: q, k, v and
// dO in bf16 (67.1 MB), lse and delta (0.5 MB), the dK/dV sums read and
// written (134.2 MB) and the dQ sums (67.1 MB), 268.9 MB or 0.080 ms at
// 3.35 TB/s, against 42.9 GFLOP (a full pair; 0.043 ms at 989 TFLOP/s).
// Fused, the pair saves the parent route's second recompute of S and dP
// and its three separate fp32 adds (302 MB a pair).  A pair has only 4
// key tiles a head, so its 512 blocks are 3.9 waves of one block an SM;
// the head-grouped, lightest-first order is the flash backward's.
#include <math.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 384;       // producer + two consumer warpgroups
constexpr int kBK = 128;            // keys a block (2 x 64)
constexpr int kBQ = 64;             // queries a streamed tile
constexpr int kConsumers = 256;     // arrivals that free a stage
constexpr int kProducerLanes = 32;  // arrivals that fill a stage

template <int D>
struct BwdTiles {
  static constexpr int NB = D / 64;                 // 64-column boxes
  static constexpr int DC = D > 128 ? 128 : D;      // output columns a block
  static constexpr int Z = D / DC;                  // blocks a key tile
  static constexpr int STAGES = D > 128 ? 1 : 2;
  static constexpr int BOX_K = kBK * 128;           // bytes of a K/V box
  static constexpr int BOX_Q = kBQ * 128;           // bytes of a Q/dO box
  static constexpr int KV_BYTES = NB * BOX_K;       // K or V
  static constexpr int QT_BYTES = NB * BOX_Q;       // a stage's Q or dO
  static constexpr int DS_BYTES = kBK * kBQ * 2;    // dS^T, bf16
  static constexpr int ROWS = 2 * kBQ;              // lse, delta of a stage
  // dQ's tile goes to the fp32 sums through shared memory and a TMA
  // reduce-add (64 queries x 64 columns a consumer, two [64][32] fp32
  // boxes, double-buffered) where it fits; at D = 256 (227 KB taken) by
  // atomic adds
  static constexpr bool DQ_TMA = D <= 128;
  static constexpr int DQ_BOX = kBQ * 128;          // [64][32] fp32
  static constexpr int DQ_BYTES = DQ_TMA ? 2 * 2 * 2 * DQ_BOX : 0;
  // a full and an empty mbarrier for each of the 2 x 2 dQ buffers
  static constexpr int DQ_BARS = DQ_TMA ? 8 : 0;
  static constexpr int TILE_BYTES = 2 * KV_BYTES + 2 * STAGES * QT_BYTES +
                                    2 * DS_BYTES + DQ_BYTES +
                                    STAGES * ROWS * 4;
  // tiles, 1 + 2 STAGES (+ the dQ buffers') barriers, and slack to align
  // the tiles to 1024
  static constexpr int SMEM =
      TILE_BYTES + 8 * (1 + 2 * STAGES + DQ_BARS) + 1024;
};

// dK and dV in device memory: bf16, written once (the flash backward),
// or fp32 running sums the kernel adds into (a ring pair).
template <bool RING>
using DkType = std::conditional_t<RING, float, __nv_bfloat16>;

// The turn of key tile kt at query tile qt (causal: key tile j reaches
// query tiles from 2 j on): the number of key tiles after kt that reach
// qt, which add first.
__device__ __forceinline__ int dq_turn(int qt, int kt, int n_k, int causal) {
  return (causal ? min(n_k - 1, qt * kBQ / kBK) : n_k - 1) - kt;
}

// Accumulator layout of wgmma m64nN (fp32), per thread of a warpgroup:
// warp w owns rows 16w + g and 16w + g + 8 (g = lane / 4); element
// 4j + e is column 8j + 2(lane % 4) + (e & 1) of row 16w + g + 8(e >> 1).
// Here the rows of S^T and dP^T are keys, their columns queries.

template <int D, bool RING>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_dq,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dq_acc,
                          DkType<RING>* __restrict__ dk,
                          DkType<RING>* __restrict__ dv,
                          int* __restrict__ turns, int S, float scale,
                          int causal, int BH, int G) {
  using T = BwdTiles<D>;
  constexpr int NB = T::NB, DC = T::DC, ST = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Ks = base;
  uint8_t* Vs = Ks + T::KV_BYTES;
  uint8_t* Qs = Vs + T::KV_BYTES;                   // ST tiles
  uint8_t* dOs = Qs + ST * T::QT_BYTES;             // ST tiles
  uint8_t* dSs = dOs + ST * T::QT_BYTES;            // 2 tiles
  uint8_t* dQs = dSs + 2 * T::DS_BYTES;             // 2 x 2 consumers x 2
  float* rows = reinterpret_cast<float*>(dQs + T::DQ_BYTES);      // ST x
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + T::TILE_BYTES);
  uint64_t* kv_full = bars;
  uint64_t* q_full = bars + 1;                      // [ST]
  uint64_t* q_empty = q_full + ST;                  // [ST]
  uint64_t* dq_full = q_empty + ST;                 // [2 buffers x 2]
  uint64_t* dq_empty = dq_full + 4;                 // (D <= 128)
  __shared__ int ticket;
  __shared__ int* dq_turns;     // this block's turn counters (below)

  if (threadIdx.x == 0) {
    ticket = atomicAdd(turns, 1);
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&q_full[s], kProducerLanes);
      mbar_init(&q_empty[s], kConsumers);
    }
    if (T::DQ_TMA)
      for (int b = 0; b < 4; ++b) {
        mbar_init(&dq_full[b], 128);                // a consumer's threads
        mbar_init(&dq_empty[b], 1);                 // its writer
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Work in ticket order: heads in groups of G; within a group, key tiles
  // from the last (the lightest of a causal pass) to the first, the
  // group's heads side by side; at D = 256 a key tile's two column blocks
  // one after the other.
  const int n_k = (S + kBK - 1) / kBK, n_q = (S + kBQ - 1) / kBQ;
  const int bx = ticket / T::Z, by = ticket % T::Z;
  const int grp = bx / (G * n_k), r = bx % (G * n_k);
  const int gh = min(G, BH - grp * G);
  const int bh = grp * G + r % gh;
  const int kt = n_k - 1 - r / gh, k0 = kt * kBK;   // key tile kt
  const int c0 = by * DC;                           // this block's columns
  // causal: only the query tiles whose last row reaches k0
  const int qt0 = causal ? k0 / kBQ : 0;
  const int n_it = n_q - qt0;
  const int wg = threadIdx.x / 128;
  // the turn counters of this block's (b*h, column block): query tile
  // qt, consumer w at dq_turns[2 Z qt + w]; read from shared memory where
  // used, so no register holds the pointer through the loop
  if (threadIdx.x == 0)
    dq_turns = turns + 1 + ((size_t)bh * n_q * T::Z + by) * 2;
  __syncthreads();

  if (wg == 0) {
    // ---- producer: warp 0; lane 0 issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * T::KV_BYTES);
        for (int c = 0; c < NB; ++c) {
          tma_load(Ks + c * T::BOX_K, &tm_k, kv_full, 64 * c, k0, bh);
          tma_load(Vs + c * T::BOX_K, &tm_v, kv_full, 64 * c, k0, bh);
        }
      }
      const float* lse_bh = lse + (size_t)bh * S;
      const float* delta_bh = delta + (size_t)bh * S;
      for (int it = 0; it < n_it; ++it) {
        const int st = it % ST, ph = (it / ST) & 1;
        const int q0 = (qt0 + it) * kBQ;
        mbar_wait(&q_empty[st], ph ^ 1);
        if (lane == 0) {
          mbar_expect_tx_only(&q_full[st], 2 * T::QT_BYTES);
          for (int c = 0; c < NB; ++c) {
            tma_load(Qs + st * T::QT_BYTES + c * T::BOX_Q, &tm_q, &q_full[st],
                     64 * c, q0, bh);
            tma_load(dOs + st * T::QT_BYTES + c * T::BOX_Q, &tm_do,
                     &q_full[st], 64 * c, q0, bh);
          }
        }
        // lse in log2 units and delta of the tile's rows (0 past S:
        // those columns are masked)
        float* lse_s = rows + st * T::ROWS;
        for (int i = lane; i < kBQ; i += 32) {
          const bool in = q0 + i < S;
          lse_s[i] = in ? lse_bh[q0 + i] * kLog2e : 0.f;
          lse_s[kBQ + i] = in ? delta_bh[q0 + i] : 0.f;
        }
        mbar_arrive(&q_full[st]);        // each lane, after its stores
      }
    } else if (T::DQ_TMA && threadIdx.x >= 32 && threadIdx.x < 36 &&
               (DC >= 128 || threadIdx.x % 2 == 0)) {
      // ---- dQ writers: lane 2 b + w of warp 1 takes consumer w's tiles
      // of buffer b (every other query tile), so two tiles of a consumer
      // are in flight at once.  Each goes into the fp32 sums in its turn
      // (key-tile order) by two TMA reduce-adds (rows past S skipped);
      // once they are written the turn and the buffer are passed on
      const int w = threadIdx.x % 2, b = (threadIdx.x - 32) / 2;
      const int qc0 = c0 + (DC >= 128 ? 64 * w : 0);
      const uint8_t* dqb = dQs + (b * 2 + w) * 2 * T::DQ_BOX;
      for (int it = b; it < n_it; it += 2) {
        const int qt = qt0 + it;
        int* turn = dq_turns + ((size_t)qt * T::Z) * 2 + w;
        mbar_wait(&dq_full[b * 2 + w], (it >> 1) & 1);
        turn_wait(turn, dq_turn(qt, kt, n_k, causal));
        tma_reduce_add(&tm_dq, dqb, qc0, qt * kBQ, bh);
        tma_reduce_add(&tm_dq, dqb + T::DQ_BOX, qc0 + 32, qt * kBQ, bh);
        bulk_commit();
        bulk_wait_read<0>();             // the buffer is read: free it
        mbar_arrive(&dq_empty[b * 2 + w]);
        bulk_wait<0>();                  // the adds are written
        turn_pass(turn);
      }
    }
  } else {
    // ---- consumers: 64 keys each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int w = wg - 1;                       // consumer index
    const int tid = threadIdx.x % 128;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int key0 = k0 + 64 * w;               // this warpgroup's keys
    const int key[2] = {key0 + 16 * warp + g, key0 + 16 * warp + g + 8};
    const uint8_t* Kw = Ks + 64 * w * 128;      // its rows of each box
    const uint8_t* Vw = Vs + 64 * w * 128;
    // dQ columns of this consumer: 64 of the block's DC (at DC = 64 the
    // first consumer takes them all)
    const bool does_dq = DC >= 128 || w == 0;
    const int qc0 = c0 + (DC >= 128 ? 64 * w : 0);
    const float scale_log2 = scale * kLog2e;

    float dka[DC / 2], dva[DC / 2];
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) dka[i] = dva[i] = 0.f;
    float s[kBQ / 2], dp[kBQ / 2], dqa[32];
    uint32_t pa[kBQ / 16][4], dsa[kBQ / 16][4];

    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_it; ++it) {
      const int st = it % ST, ph = (it / ST) & 1;
      const int q0 = (qt0 + it) * kBQ;
      const uint8_t* Qb = Qs + st * T::QT_BYTES;
      const uint8_t* dOb = dOs + st * T::QT_BYTES;
      const float* lse_s = rows + st * T::ROWS;
      const float* delta_s = lse_s + kBQ;
      uint8_t* dSb = dSs + (it & 1) * T::DS_BYTES;
      if constexpr (!T::DQ_TMA) {
        // D = 256: the consumer adds dQ itself.  The last tile's turn is
        // passed here, once its adds have had this tile's wait to
        // complete, and this tile's turn is taken, while few registers
        // are live (the next key tile reaches a causal query tile two
        // tiles after this one)
        if (does_dq) {
          if (it > 0) {
            __threadfence();
            warpgroup_sync(2 + w);
          }
          if (tid == 0) {
            int* turn = dq_turns + ((size_t)(qt0 + it) * T::Z) * 2 + w;
            if (it > 0) turn_pass(turn - T::Z * 2);
            turn_wait(turn, dq_turn(qt0 + it, kt, n_k, causal));
          }
          warpgroup_sync(2 + w);
        }
      }
      mbar_wait(&q_full[st], ph);

      // S^T = K Q^T, dP^T = V dO^T over D / 16 k-steps: box kk / 4, 32
      // bytes a k-step.  The first k-step overwrites the accumulators;
      // zeroing them first ends the last tile's values, so the compiler
      // does not keep them live around the loop (the wgmma operands are
      // read-write).
#pragma unroll
      for (int i = 0; i < kBQ / 2; ++i) s[i] = dp[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / 4, off = (kk % 4) * 32;
        wgmma_ss(s, sw128_desc(Kw + c * T::BOX_K + off, 16, 1024),
                 sw128_desc(Qb + c * T::BOX_Q + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / 4, off = (kk % 4) * 32;
        wgmma_ss(dp, sw128_desc(Vw + c * T::BOX_K + off, 16, 1024),
                 sw128_desc(dOb + c * T::BOX_Q + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();                  // S^T is done; dP^T still runs
      reg_fence(s);

      // P^T = exp2(s * scale * log2 e - lse * log2 e), masked to 0 above
      // the causal diagonal and past S, only on tiles that reach them
      const bool masked = (causal && q0 < key0 + 63) || q0 + kBQ > S ||
                          key0 + 64 > S;
#pragma unroll
      for (int i = 0; i < kBQ / 2; ++i) {
        const int col = 8 * (i / 4) + 2 * t + (i & 1);
        float p = exp2_approx(fmaf(s[i], scale_log2, -lse_s[col]));
        if (masked) {
          const int q = q0 + col, k = key[(i >> 1) & 1];
          if (q >= S || k >= S || (causal && k > q)) p = 0.f;
        }
        s[i] = p;
      }
      wgmma_wait<0>();                  // dP^T is done
      reg_fence(dp);
      // dS^T = P^T (dP^T - delta) scale; both packed to bf16 A fragments
#pragma unroll
      for (int i = 0; i < kBQ / 2; ++i) {
        const int col = 8 * (i / 4) + 2 * t + (i & 1);
        dp[i] = s[i] * (dp[i] - delta_s[col]) * scale;
      }
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
          dsa[kk][e] = pack_bf16(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1]);
        }
      // this consumer's 64 rows of dS^T [128 keys][64 queries] into shared
      // memory in the 128-byte swizzle: the 16-byte chunk j of row r sits
      // at chunk j ^ (r % 8)
#pragma unroll
      for (int j = 0; j < kBQ / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 64 * w + 16 * warp + g + 8 * h;
          *reinterpret_cast<uint32_t*>(dSb + row * 128 +
                                       ((j ^ (row & 7)) << 4) + 4 * t) =
              dsa[j / 2][(j & 1) * 2 + h];
        }
      fence_proxy_async();

      // dV += P^T dO, dK += dS^T Q over this block's columns: 4 k-steps of
      // 16 queries (2048 bytes each), B MN-major from box c0 / 64 on
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
        wgmma_rs(dva, pa[kk],
                 sw128_desc(dOb + (c0 / 64) * T::BOX_Q + kk * 2048, T::BOX_Q,
                            1024));
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
        wgmma_rs(dka, dsa[kk],
                 sw128_desc(Qb + (c0 / 64) * T::BOX_Q + kk * 2048, T::BOX_Q,
                            1024));
      wgmma_commit();
      named_sync(1);                    // both consumers' dS^T is stored
      if (does_dq) {
        // dQ (64 queries x 64 columns) = dS K over the 128 keys: A = dS^T
        // read transposed, B = K MN-major, 8 k-steps of 16 keys
#pragma unroll
        for (int i = 0; i < 32; ++i) dqa[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_ss<1, 1>(dqa, sw128_desc(dSb + kk * 2048, T::BOX_Q, 1024),
                         sw128_desc(Ks + (qc0 / 64) * T::BOX_K + kk * 2048,
                                    T::BOX_K, 1024),
                         kk > 0);
        wgmma_commit();
      }
      wgmma_wait<0>();
      reg_fence(dka);
      reg_fence(dva);
      reg_fence(pa);
      reg_fence(dsa);
      reg_fence(dqa);
      mbar_arrive(&q_empty[st]);        // Q, dO, lse, delta of the stage

      if constexpr (T::DQ_TMA) {
        if (does_dq) {
          // dQ's tile into shared memory, two [64][32] fp32 boxes in the
          // 128-byte swizzle (16-byte chunk j of row r at chunk j ^ r % 8),
          // once the writer has added the tile of two tiles ago from this
          // buffer; then handed to the writer
          const int b = (it & 1) * 2 + w;
          uint8_t* dqb = dQs + b * 2 * T::DQ_BOX;
          mbar_wait(&dq_empty[b], ((it >> 1) & 1) ^ 1);
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = 16 * warp + g + 8 * h;
              const int cc = 8 * (j % 4) + 2 * t;   // column in its box
              *reinterpret_cast<float2*>(
                  dqb + (j / 4) * T::DQ_BOX + r * 128 +
                  (((cc >> 2) ^ (r & 7)) << 4) + (cc & 3) * 4) =
                  make_float2(dqa[4 * j + 2 * h], dqa[4 * j + 2 * h + 1]);
            }
          fence_proxy_async();
          mbar_arrive(&dq_full[b]);
        }
      } else if (does_dq) {
        // dQ's tile into the fp32 sums in its turn (taken at the top of
        // the iteration), two neighbouring columns an atomic add: no
        // other block adds there until the turn passes, so the order is
        // fixed
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = q0 + 16 * warp + g + 8 * h;
          if (q >= S) continue;
          float* dst = dq_acc + ((size_t)bh * S + q) * D + qc0 + 2 * t;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            atomicAdd(reinterpret_cast<float2*>(dst + 8 * j),
                      make_float2(dqa[4 * j + 2 * h], dqa[4 * j + 2 * h + 1]));
        }
      }
    }
    if (!T::DQ_TMA && does_dq) {        // the last tile's turn
      __threadfence();
      warpgroup_sync(2 + w);
      if (tid == 0)
        turn_pass(dq_turns + ((size_t)(n_q - 1) * T::Z) * 2 + w);
    }

    // epilogue: dK and dV, each element by one thread: in bf16, written
    // once, or (a ring pair) added into the fp32 sums, all of a row's
    // loads issued before its stores
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (key[h] >= S) continue;
      const size_t at = ((size_t)bh * S + key[h]) * D + c0 + 2 * t;
      if constexpr (RING) {
        float2* kdst = reinterpret_cast<float2*>(dk + at);
        float2* vdst = reinterpret_cast<float2*>(dv + at);
        float2 ko[DC / 8], vo[DC / 8];
#pragma unroll
        for (int j = 0; j < DC / 8; ++j) {
          ko[j] = kdst[4 * j];
          vo[j] = vdst[4 * j];
        }
#pragma unroll
        for (int j = 0; j < DC / 8; ++j) {
          kdst[4 * j] = make_float2(ko[j].x + dka[4 * j + 2 * h],
                                    ko[j].y + dka[4 * j + 2 * h + 1]);
          vdst[4 * j] = make_float2(vo[j].x + dva[4 * j + 2 * h],
                                    vo[j].y + dva[4 * j + 2 * h + 1]);
        }
      } else {
        uint32_t* kdst = reinterpret_cast<uint32_t*>(dk + at);
        uint32_t* vdst = reinterpret_cast<uint32_t*>(dv + at);
#pragma unroll
        for (int j = 0; j < DC / 8; ++j) {
          kdst[4 * j] = pack_bf16(dka[4 * j + 2 * h], dka[4 * j + 2 * h + 1]);
          vdst[4 * j] = pack_bf16(dva[4 * j + 2 * h], dva[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- host

template <int D, bool RING>
int bwd(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dq_acc, void* dk, void* dv,
        void* turns, int BH, int S, float scale, int causal,
        cudaStream_t st) {
  using T = BwdTiles<D>;
  CUtensorMap tq, tk, tv, tdo, tdq{};
  int rc = cached_map(&tq, q, BH, S, D, kBQ);
  if (!rc) rc = cached_map(&tk, k, BH, S, D, kBK);
  if (!rc) rc = cached_map(&tv, v, BH, S, D, kBK);
  if (!rc) rc = cached_map(&tdo, dout, BH, S, D, kBQ);
  if (!rc && T::DQ_TMA) rc = cached_map(&tdq, dq_acc, BH, S, D, kBQ, 4);
  if (rc) return rc;
  // heads whose Q and dO (bf16) and dQ sums (fp32) take about 16 MB
  // together (a third of the L2)
  const long long per_head = 8LL * S * D;
  const int G = (int)max(1LL, min((long long)BH, (16LL << 20) / per_head));
  rc = (int)cudaFuncSetAttribute(flash_bwd_sm90_kernel<D, RING>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 T::SMEM);
  if (rc) return rc;
  flash_bwd_sm90_kernel<D, RING>
      <<<dim3(BH * ((S + kBK - 1) / kBK), T::Z), kThreads, T::SMEM, st>>>(
          tq, tk, tv, tdo, tdq, (const float*)lse, (const float*)delta,
          (float*)dq_acc, (DkType<RING>*)dk, (DkType<RING>*)dv,
          (int*)turns, S, scale, causal, BH, G);
  return (int)cudaGetLastError();
}

static_assert(BwdTiles<256>::SMEM <= 232448, "227 KB a block");
static_assert(BwdTiles<128>::SMEM <= 232448, "227 KB a block");
static_assert(BwdTiles<64>::SMEM <= 232448, "227 KB a block");

template <bool RING>
int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq_acc, void* dk,
             void* dv, void* turns, int BH, int S, int D, float scale,
             int causal, void* stream) {
  if (BH <= 0 || S <= 0 ||
      (long long)BH * ((S + kBK - 1) / kBK) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return bwd<64, RING>(q, k, v, dout, lse, delta, dq_acc, dk, dv, turns,
                         BH, S, scale, causal, st);
  if (D == 128)
    return bwd<128, RING>(q, k, v, dout, lse, delta, dq_acc, dk, dv, turns,
                          BH, S, scale, causal, st);
  if (D == 256)
    return bwd<256, RING>(q, k, v, dout, lse, delta, dq_acc, dk, dv, turns,
                          BH, S, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The bf16 backward: q, k, v, dout, dk, dv [BH, S, D] bf16 (16-byte
// aligned, contiguous), lse and delta [BH, S] fp32, dq_acc [BH, S, D]
// fp32 zeroed by the caller (dQ is added into it), turns int32 of
// flash_bwd_sm90_turns(BH, S, D) elements zeroed by the caller (the
// ticket and the turn counters that fix the order of dQ's sums);
// D in {64, 128, 256}.  Returns a CUDA error code, 0 on success.
extern "C" int flash_bwd_sm90_launch(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dq_acc, void* dk, void* dv,
                                     void* turns, int BH, int S, int D,
                                     float scale, int causal, void* stream) {
  return dispatch<false>(q, k, v, dout, lse, delta, dq_acc, dk, dv, turns,
                         BH, S, D, scale, causal, stream);
}

// One ring pair's backward with the ring-global lse and delta: q, k, v,
// dout [BH, S, D] bf16 as above; dq_sum, dk_sum, dv_sum [BH, S, D] fp32
// running sums (16-byte aligned, contiguous) that the pair's dQ, dK and
// dV are added into; turns as above, zeroed for each call; D in {64,
// 128, 256}.  Returns a CUDA error code.
extern "C" int ring_pair_bwd_sm90_launch(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const void* lse, const void* delta,
                                         void* dq_sum, void* dk_sum,
                                         void* dv_sum, void* turns, int BH,
                                         int S, int D, float scale,
                                         int causal, void* stream) {
  return dispatch<true>(q, k, v, dout, lse, delta, dq_sum, dk_sum, dv_sum,
                        turns, BH, S, D, scale, causal, stream);
}

// The int32 elements `turns` must hold for a call at (BH, S, D): the
// ticket, then one turn counter per (b*h, 64-query tile, column block,
// consumer).
extern "C" long long flash_bwd_sm90_turns(int BH, int S, int D) {
  return 1 + (long long)BH * ((S + kBQ - 1) / kBQ) * (D > 128 ? 2 : 1) * 2;
}

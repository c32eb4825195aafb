// zlib's CRC-32 of many device buffers in one call: the integrity
// sentinel's leaf digests (paddle_tpu_torch/resilience/integrity.py).
//
// Replaces no TPU kernel: the JAX package digests each leaf on the host
// (zlib over the leaf's bytes after a device-to-host copy); on the card
// that copy, and the per-leaf host work around it, cost 17x the
// sentinel's budget.  These kernels read each leaf where it lies and
// return one 32-bit word a leaf.
//
// The digest of a leaf is zlib.crc32(data, header) with header =
// zlib.crc32(f"{dtype_str}:{shape}"), bit for bit.  In the register
// (pre-inverted) form of the CRC, R(c, A || B) = M_|B|(R(c, A)) ^ R(0, B),
// where M_k multiplies by x^(8k) modulo the CRC polynomial (zlib's
// multmodp / x2nmodp), and R(0, zeros || D) = R(0, D).  So:
//   - a leaf of n bytes is cut into blocks of 256 KiB, counted from its
//     end (zeros fill the front of the first block: they do not change
//     R(0, .)); a block into 256 units of 1 KiB, one a thread;
//   - each thread takes R(0, unit) 16 bytes a step (slicing by 16, the
//     16 256-entry tables in shared memory); a warp loads its 32 units
//     64 bytes of each at a time, 4 lanes a unit (whole sectors, the
//     next slice's loads in flight), through shared memory; where a
//     leaf's rows are not 16-byte aligned (n % 16 != 0) a thread reads
//     its unit a byte at a time, 16 loads in flight;
//   - the units of a block combine in trees of shuffles (the right half
//     of a pair is 1 KiB * 2^l: M is x^(2^(13+l))), and the block writes
//     its R(0, .) (pass 1, a block per 256 KiB);
//   - a second kernel, a block per leaf, combines the leaf's blocks in a
//     tree (x^(2^(21+l))) and inverts: ~(M_n(~header) ^ R(0, data)),
//     with M_n(~header), the header's register moved past the n data
//     bytes, from the leaf table (the host computes it once a leaf size
//     and header).
// A multiply by x^k is 32 dependent shift-and-xor steps (some 200
// instructions), so each is spread over 1 KiB of data: with 64-byte
// units the trees took 3/4 of the instructions and the pass ran at
// 0.42 TB/s; 1 KiB units read with 16-byte loads 1 KiB apart across a
// warp ran at 0.94 TB/s.
// Bound: bytes (each byte read once; 3.35 TB/s on an H100 SXM).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPoly = 0xedb88320u;   // CRC-32, reflected
constexpr int kThreads = 256;
constexpr int kUnit = 1024;                // bytes a thread digests
constexpr long long kBlockBytes = 1LL * kThreads * kUnit;   // 2^18
constexpr int kUnitLog2Bits = 13;          // 1 KiB = 2^13 bits
constexpr int kWarpLog2Bits = 18;          // 32 KiB
constexpr int kBlockLog2Bits = 21;         // 256 KiB
constexpr int kLeafWords = 4;   // ptr, nbytes, first block, M_n(~header)
constexpr int kSlices = kUnit / 64;        // 64-byte slices a unit
constexpr int kRow = 5;        // a unit's staged slice: 4 uint4 + 1 pad
                               // (80-byte rows: 16-byte reads of 8 lanes
                               // fall in 8 distinct bank quads)
constexpr int kSlicing = 16;               // bytes a table step
constexpr int kTableWords = kSlicing * 256 + 32;  // tables, x^(2^j)

// a * b modulo the polynomial, both as reflected x^0..x^31 (zlib multmodp)
__device__ __forceinline__ uint32_t multmodp(uint32_t a, uint32_t b) {
  uint32_t p = 0;
#pragma unroll 8
  for (int i = 31; i >= 0; --i) {
    if (a & (1u << i)) p ^= b;
    b = (b & 1u) ? (b >> 1) ^ kPoly : b >> 1;
  }
  return p;
}

// R(0, .) of the 2^lanes_log2 lanes' spans in lane order, each 2^lb
// bits long, into lane 0 (a tree of shuffles, lower lanes first)
__device__ __forceinline__ uint32_t warp_combine(uint32_t r, int lanes_log2,
                                                 int lb, const uint32_t* x2n) {
  const int lane = threadIdx.x & 31;
  for (int l = 0; l < lanes_log2; ++l) {
    const int span = 1 << l;
    const uint32_t next = __shfl_down_sync(0xffffffffu, r, span);
    if ((lane & (2 * span - 1)) == 0) r = multmodp(x2n[lb + l], r) ^ next;
  }
  return r;
}

// R(c, 16 bytes) by slicing by 16: t + 256 k is the table of a byte
// followed by k zero bytes; the lookups of the last 12 bytes do not wait
// on c, so a step's dependent path is one round of 4 lookups
__device__ __forceinline__ uint32_t crc16(uint32_t c, uint4 w,
                                          const uint32_t* t) {
  c ^= w.x;
  return t[15 * 256 + (c & 0xffu)] ^ t[14 * 256 + ((c >> 8) & 0xffu)] ^
         t[13 * 256 + ((c >> 16) & 0xffu)] ^ t[12 * 256 + (c >> 24)] ^
         t[11 * 256 + (w.y & 0xffu)] ^ t[10 * 256 + ((w.y >> 8) & 0xffu)] ^
         t[9 * 256 + ((w.y >> 16) & 0xffu)] ^ t[8 * 256 + (w.y >> 24)] ^
         t[7 * 256 + (w.z & 0xffu)] ^ t[6 * 256 + ((w.z >> 8) & 0xffu)] ^
         t[5 * 256 + ((w.z >> 16) & 0xffu)] ^ t[4 * 256 + (w.z >> 24)] ^
         t[3 * 256 + (w.w & 0xffu)] ^ t[2 * 256 + ((w.w >> 8) & 0xffu)] ^
         t[256 + ((w.w >> 16) & 0xffu)] ^ t[w.w >> 24];
}

// slice k (64 bytes) of each of a warp's 32 units: 4 lanes a unit, 16
// bytes a lane, so a load instruction reads 8 whole 64-byte segments;
// the zero front reads as zeros
__device__ __forceinline__ void load_slice(const uint8_t* src, long long wd0,
                                           int lane, int k, uint4* w) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long d = wd0 + static_cast<long long>((lane >> 2) + 8 * j) *
                                  kUnit + 64 * k + 16 * (lane & 3);
    w[j] = d >= 0 ? __ldg(reinterpret_cast<const uint4*>(src + d))
                  : make_uint4(0u, 0u, 0u, 0u);
  }
}

// pass 1: R(0, .) of each 256 KiB block, unshifted, into block_crc
__global__ void __launch_bounds__(kThreads)
crc32_blocks_kernel(const uint32_t* __restrict__ tables,
                    const long long* __restrict__ leaves, int n_leaves,
                    uint32_t* __restrict__ block_crc) {
  __shared__ uint32_t tab[kTableWords];
  __shared__ uint4 stage[kThreads * kRow];
  __shared__ uint32_t warp_crc[kThreads / 32];
  const int t = threadIdx.x;
  for (int i = t; i < kTableWords; i += kThreads)
    tab[i] = tables[i];
  const uint32_t* x2n = tab + kSlicing * 256;

  // the leaf of this block: the last whose first block is <= blockIdx.x
  const long long b = blockIdx.x;
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (leaves[kLeafWords * mid + 2] <= b) lo = mid; else hi = mid - 1;
  }
  const long long* leaf = leaves + kLeafWords * lo;
  const uint8_t* src = reinterpret_cast<const uint8_t*>(leaf[0]);
  const long long n = leaf[1];
  const long long nblocks = n > 0 ? (n + kBlockBytes - 1) / kBlockBytes : 1;
  // data index of this thread's first byte (negative: the zero front)
  const long long d0 = (b - leaf[2]) * kBlockBytes -
                       (nblocks * kBlockBytes - n) +
                       static_cast<long long>(t) * kUnit;
  __syncthreads();

  uint32_t r = 0;
  const bool vec = ((reinterpret_cast<unsigned long long>(src) | n) & 15)
                   == 0;              // 16-byte chunks: all front or data
  if (vec) {
    const int warp = t >> 5, lane = t & 31;
    const long long wd0 = d0 - static_cast<long long>(lane) * kUnit;
    if (wd0 + 32LL * kUnit > 0) {     // the warp's 32 units hold data
      uint4* rows = stage + warp * 32 * kRow;
      uint4 cur[4], nxt[4];
      load_slice(src, wd0, lane, 0, cur);
      for (int k = 0; k < kSlices; ++k) {
        if (k + 1 < kSlices) load_slice(src, wd0, lane, k + 1, nxt);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          rows[((lane >> 2) + 8 * j) * kRow + (lane & 3)] = cur[j];
        __syncwarp();
#pragma unroll
        for (int q = 0; q < 4; ++q) r = crc16(r, rows[lane * kRow + q], tab);
        __syncwarp();
#pragma unroll
        for (int j = 0; j < 4; ++j) cur[j] = nxt[j];
      }
    }
  } else if (d0 + kUnit > 0) {        // a unit of zeros only keeps r = 0
    // a byte at a time, 16 loads in flight; front zeros (d < 0) keep
    // r = 0 (the table's entry 0 is 0), so whole batches of them are
    // skipped and the rest need no test
    const int j0 = d0 < 0 ? static_cast<int>(-d0) & ~15 : 0;
    for (int j = j0; j < kUnit; j += 16) {
      uint8_t v[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const long long d = d0 + j + k;
        v[k] = d >= 0 ? __ldg(src + d) : static_cast<uint8_t>(0);
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) r = tab[(r ^ v[k]) & 0xffu] ^ (r >> 8);
    }
  }

  r = warp_combine(r, 5, kUnitLog2Bits, x2n);
  if ((t & 31) == 0) warp_crc[t >> 5] = r;
  __syncthreads();
  if (t >= 32) return;
  r = t < kThreads / 32 ? warp_crc[t] : 0u;
  r = warp_combine(r, 3, kWarpLog2Bits, x2n);
  if (t == 0) block_crc[b] = r;
}

// pass 2, a block a leaf: the leaf's blocks combined in a tree (zero
// blocks in front fill it to a power of two: they change nothing), the
// header's moved register added, and the inversion
__global__ void __launch_bounds__(kThreads)
crc32_combine_kernel(const uint32_t* __restrict__ tables,
                     const long long* __restrict__ leaves,
                     const uint32_t* __restrict__ block_crc,
                     uint32_t* __restrict__ out) {
  __shared__ uint32_t x2n[32];
  __shared__ uint32_t part[kThreads];
  const int t = threadIdx.x;
  if (t < 32) x2n[t] = tables[kSlicing * 256 + t];
  __syncthreads();
  const long long* leaf = leaves + kLeafWords * blockIdx.x;
  const long long n = leaf[1], first = leaf[2];
  const long long nb = n > 0 ? (n + kBlockBytes - 1) / kBlockBytes : 1;
  // the first `width` threads (a power of two) each fold a run of c =
  // 2^lc blocks, then combine in log2(width) levels
  int lc = 0, width = 1;
  while (width < kThreads && width < nb) width <<= 1;
  while ((static_cast<long long>(width) << lc) < nb) ++lc;
  const long long c = 1LL << lc, front = (c * width) - nb;
  uint32_t r = 0;
  for (long long j = 0; t < width && j < c; ++j) {
    const long long k = t * c + j - front;
    if (k >= 0) r = multmodp(x2n[kBlockLog2Bits], r) ^ block_crc[first + k];
  }
  part[t] = r;
  __syncthreads();
  for (int span = 1, l = kBlockLog2Bits + lc; span < width;
       span <<= 1, ++l) {
    if ((t & (2 * span - 1)) == 0 && t + span < width)
      part[t] = multmodp(x2n[l & 31], part[t]) ^ part[t + span];
    __syncthreads();
  }
  if (t == 0) out[blockIdx.x] = ~(static_cast<uint32_t>(leaf[3]) ^ part[0]);
}

}  // namespace

// tables: uint32[16 * 256 + 32] on the device (the 16 slicing tables,
// then x^(2^j) for j < 32); leaves: int64[4 * n_leaves] on the device (pointer, byte
// count, first block, M_n(~header); first blocks ascending, each leaf
// max(1, ceil(n / 262144)) blocks, total_blocks in all); block_crc:
// uint32[total_blocks] scratch; out: uint32[n_leaves].
extern "C" int crc32_leaves_launch(const void* tables, const void* leaves,
                                   int n_leaves, long long total_blocks,
                                   void* block_crc, void* out,
                                   void* stream) {
  if (n_leaves <= 0 || total_blocks < n_leaves ||
      total_blocks > 0x7fffffffLL || tables == nullptr ||
      leaves == nullptr || block_crc == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* tab = static_cast<const uint32_t*>(tables);
  const long long* lv = static_cast<const long long*>(leaves);
  uint32_t* bc = static_cast<uint32_t*>(block_crc);
  crc32_blocks_kernel<<<static_cast<unsigned>(total_blocks), kThreads, 0,
                        s>>>(tab, lv, n_leaves, bc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  crc32_combine_kernel<<<n_leaves, kThreads, 0, s>>>(
      tab, lv, bc, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Per-block Huffman entropy encode and bit packing for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel jpezy_tpu/ops/pack_pallas.py
// (_pack_kernel / pack_words_pallas) and every form of
// jpezy_tpu/ops/entropy.py:pack_block_words (reduce, prefix, fori): it
// folds in the exclusive cumsum of the emission lengths and the 96-bit
// window alignment (entropy._window_words) that the JAX package computes
// around its kernel.  Two entry points share one pack routine:
//
//   jz_pack_words     the one-to-one counterpart of the Pallas kernel.
//     In:  hi, lo [B, 64] uint32 halves of each merged emission (the
//          emission sits MSB-first in the low bits of hi:lo), nbits [B, 64]
//          int32 emission lengths, 0 <= nbits <= 59.
//   jz_encode_blocks  emissions fused in (jpezy_tpu/ops/entropy.py:
//     block_emissions followed by pack_block_words); the encode program
//     uses this one, so emissions never reach device memory.
//     In:  q [B, 64] int32 quantized blocks in natural order, pred [B]
//          int32 DC predictors, and the component's Huffman tables as int32
//          arrays: dc_code, dc_size [12] by magnitude category, ac_code,
//          ac_size [162] in the flat layout idx = rem*10 + s + (rem == 15)
//          (EOB at 0, ZRL at 151).
//   Out of both: words [B, 64] MSB-first packed block bitstring, 32-bit
//     words stored zero-extended as uint64, which is the int64 word
//     convention of the stream concat (storing them as uint32 and widening
//     them in a second pass was measured slower, PERF.md); bits [B] int32
//     total bits.
//
// Design: a warp owns an 8x8 block.  Lane l owns emission slots l and l+32,
// so a warp reads its block's 256-byte row of each input in two 128-byte
// requests.  The fused entry reads each coefficient through the zigzag
// permutation; two ballots give the nonzero masks of the block's two
// halves, and a slot's zero run is its position minus the position of the
// highest set bit below it (__clz), which replaces the cummax of the
// tensor program.  Each lane builds its two emissions (code + extra bits
// in 32-bit arithmetic; the rare ZRLs, up to 3, go in front: <= 59 bits
// with the Annex K tables) in a 64-bit register.  The shared
// pack routine then turns lengths into exclusive bit offsets with one warp
// shuffle scan (both slots' lengths ride in the halves of one register),
// cuts each emission into its <= 3 words and ORs them with atomicOr into
// the warp's 64-word buffer in shared memory (neighbouring lanes can land
// in one word; emission bit ranges are disjoint, so OR accumulates them),
// and the 64 words leave as two coalesced stores.  Windows past word 63
// are dropped, as the masked forms of the JAX package drop them.  No
// per-thread array, so nothing lives in local memory.
//
// What bounds it: memory traffic.  Per block the function jz_pack_words
// computes must read 768 bytes and write 64 32-bit words and a count, 260:
// 1,028 bytes, 101 MB per 16x512x512 4:2:0 batch of 98,304 blocks.  That
// of jz_encode_blocks must read 260 and write 260: 520 bytes, 51 MB per
// batch.  These are the bounds.  The zero upper halves of the stored
// words are 256 more bytes per block (1,284 and 776 moved), a cost of the
// layout and no part of the bound.  The integer work, some tens of short
// operations per slot, stays below the card's rate for that many bytes.
// The design answers with coalesced
// loads and stores, with a warp per block, which keeps the card full of
// threads (64 warps resident per SM at 28-32 registers and 2 KB of shared
// memory per CTA), and with the fusion, which removes the emissions' 768
// bytes per block from device memory altogether.  The fused kernel moves
// so few bytes per block that one block per warp leaves too few loads in
// flight; each of its warps therefore takes kBlocksPerWarp consecutive
// blocks and starts all their loads before it uses any (2 measured
// fastest on an H100; 4 and 8 cost registers and were slower).  Times on
// the card are in PERF.md.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 64;
constexpr int kWords = 64;
constexpr int kWarpsPerCta = 8;
constexpr int kBlocksPerWarp = 2;  // of the fused kernel
constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kEobIndex = 0;
constexpr int kZrlIndex = 151;
constexpr int kDcEntries = 12;
constexpr int kAcEntries = 162;

// kZigzag[k] = natural (row-major) index of the k-th zigzag element.  In
// global memory, not __constant__: every lane reads another entry.
__device__ const uint8_t kZigzag[kSlots] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

__device__ __forceinline__ void or_word(uint32_t* buf, int w, uint32_t word) {
  if (w < kWords && word != 0u) atomicOr(buf + w, word);
}

// OR the n-bit emission v (1 <= n <= 64, else nothing) into the block
// buffer at bit offset `off`: v is justified to the top of 64 bits and
// moved down by off & 31 into a 96-bit window of three words that starts
// at word off >> 5; each word is one funnel shift.
__device__ __forceinline__ void place(uint32_t* buf, uint64_t v, int n,
                                      int off) {
  if (n <= 0) return;
  const uint64_t u = v << (64 - n);
  const uint32_t uhi = static_cast<uint32_t>(u >> 32);
  const uint32_t ulo = static_cast<uint32_t>(u);
  const int p = off & 31;
  const int w0 = off >> 5;
  or_word(buf, w0, uhi >> p);
  or_word(buf, w0 + 1, __funnelshift_r(ulo, uhi, p));
  or_word(buf, w0 + 2, __funnelshift_r(0u, ulo, p));
}

// The shared pack routine.  Every lane of the warp calls it with its two
// emissions (slot `lane` and slot `lane + 32`); `buf` is the warp's
// 64-word buffer in shared memory.
__device__ __forceinline__ void pack_block(uint64_t v0, int n0, uint64_t v1,
                                           int n1, uint32_t* buf, int lane,
                                           uint64_t* out_row,
                                           int32_t* out_bits) {
  // inclusive scan of both slots' lengths at once: 32 * 59 < 2**16, so
  // the two sums never meet
  int incl = n0 | (n1 << 16);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFullMask, incl, d);
    if (lane >= d) incl += t;
  }
  const int tot = __shfl_sync(kFullMask, incl, 31);
  const int total0 = tot & 0xFFFF;
  const int off0 = (incl & 0xFFFF) - n0;
  const int off1 = total0 + (incl >> 16) - n1;

  buf[lane] = 0u;
  buf[lane + 32] = 0u;
  __syncwarp();
  place(buf, v0, n0, off0);
  place(buf, v1, n1, off1);
  __syncwarp();
  out_row[lane] = buf[lane];
  out_row[lane + 32] = buf[lane + 32];
  if (lane == 0) *out_bits = total0 + (tot >> 16);
}

__global__ void __launch_bounds__(kWarpsPerCta * 32)
    pack_words_kernel(const uint32_t* __restrict__ hi,
                      const uint32_t* __restrict__ lo,
                      const int32_t* __restrict__ nbits,
                      uint64_t* __restrict__ words, int32_t* __restrict__ bits,
                      int64_t nblocks) {
  __shared__ uint32_t bufs[kWarpsPerCta][kWords];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarpsPerCta + warp;
  if (b >= nblocks) return;  // warp-uniform: whole warps leave together
  const int64_t base = b * kSlots;
  const uint64_t v0 =
      (static_cast<uint64_t>(hi[base + lane]) << 32) | lo[base + lane];
  const uint64_t v1 = (static_cast<uint64_t>(hi[base + lane + 32]) << 32) |
                      lo[base + lane + 32];
  pack_block(v0, nbits[base + lane], v1, nbits[base + lane + 32], bufs[warp],
             lane, words + base, bits + b);
}

struct HuffTables {
  const int32_t* dc_code;
  const int32_t* dc_size;
  const int32_t* ac_code;
  const int32_t* ac_size;
};

// Magnitude category: bit length of |v| (0 for v == 0).
__device__ __forceinline__ int category(int v) {
  return 32 - __clz(v < 0 ? -v : v);
}

// Code, then the s extra bits of v (v itself, or its one's complement
// when negative): at most 16 + 11 bits, so 32-bit arithmetic holds them.
__device__ __forceinline__ uint32_t code_and_extra(uint32_t code, int v,
                                                   int s) {
  const uint32_t extra =
      static_cast<uint32_t>(v < 0 ? v - 1 : v) & ((1u << s) - 1u);
  return (code << s) | extra;
}

// Slot 0: the DC code and extra bits of diff = DC - predictor.
__device__ __forceinline__ void dc_emission(int diff, const HuffTables& t,
                                            uint64_t& v, int& n) {
  const int s = min(category(diff), kDcEntries - 1);
  v = code_and_extra(static_cast<uint32_t>(__ldg(t.dc_code + s)), diff, s);
  n = __ldg(t.dc_size + s) + s;
}

// Slot j in 1..63: the coefficient c at zigzag position j, `prev` the
// position of the last nonzero coefficient before it (0 if none).  A
// nonzero c emits one ZRL per 16 zeros of its run, then the (run & 15,
// category) code and the extra bits; a zero emits nothing, except EOB at
// position 63.
__device__ __forceinline__ void ac_emission(int c, int j, int prev,
                                            const HuffTables& t, uint64_t& v,
                                            int& n) {
  v = 0ull;
  n = 0;
  if (c != 0) {
    const int run = j - prev - 1;
    const int rem = run & 15;
    const int s = category(c);
    const int idx = min(rem * 10 + s + (rem == 15 ? 1 : 0), kAcEntries - 1);
    v = code_and_extra(static_cast<uint32_t>(__ldg(t.ac_code + idx)), c, s);
    n = __ldg(t.ac_size + idx) + s;
    if (run >= 16) {  // rare: up to three ZRL codes go in front
      const uint64_t zrl_code =
          static_cast<uint32_t>(__ldg(t.ac_code + kZrlIndex));
      const int zrl_size = __ldg(t.ac_size + kZrlIndex);
      uint64_t z = 0ull;
      for (int k = 0; k < (run >> 4); ++k) z = (z << zrl_size) | zrl_code;
      v |= z << n;
      n += (run >> 4) * zrl_size;
    }
  } else if (j == kSlots - 1) {
    v = static_cast<uint32_t>(__ldg(t.ac_code + kEobIndex));
    n = __ldg(t.ac_size + kEobIndex);
  }
}

__global__ void __launch_bounds__(kWarpsPerCta * 32)
    encode_blocks_kernel(const int32_t* __restrict__ q,
                         const int32_t* __restrict__ pred, HuffTables tables,
                         uint64_t* __restrict__ words, int32_t* __restrict__ bits,
                         int64_t nblocks) {
  __shared__ uint32_t bufs[kWarpsPerCta][kWords];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // the warp's first block; every test on a block index is warp-uniform
  const int64_t b0 =
      (static_cast<int64_t>(blockIdx.x) * kWarpsPerCta + warp) * kBlocksPerWarp;
  if (b0 >= nblocks) return;
  // All loads of the warp's blocks are started before any is used: a block
  // is only 256 bytes, and one block per warp keeps too few bytes in
  // flight to cover the latency of device memory.
  const int z0 = kZigzag[lane];
  const int z1 = kZigzag[lane + 32];
  int c0[kBlocksPerWarp], c1[kBlocksPerWarp], dcp[kBlocksPerWarp];
#pragma unroll
  for (int i = 0; i < kBlocksPerWarp; ++i) {
    const int64_t b = b0 + i < nblocks ? b0 + i : b0;  // tail: load a valid row
    c0[i] = __ldg(q + b * kSlots + z0);
    c1[i] = __ldg(q + b * kSlots + z1);
    dcp[i] = lane == 0 ? __ldg(pred + b) : 0;
  }
  const uint32_t lanes_below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kBlocksPerWarp; ++i) {
    const int64_t b = b0 + i;
    if (b >= nblocks) break;
    // nonzero masks of zigzag positions 0..31 and 32..63; bit 0 (the DC)
    // is always set, so "no nonzero AC before me" reads as position 0
    const uint32_t nz_lo = __ballot_sync(kFullMask, c0[i] != 0) | 1u;
    const uint32_t nz_hi = __ballot_sync(kFullMask, c1[i] != 0);
    const uint32_t below_hi = nz_hi & lanes_below;
    uint64_t v0, v1;
    int n0, n1;
    if (lane == 0) {
      dc_emission(c0[i] - dcp[i], tables, v0, n0);
    } else {
      ac_emission(c0[i], lane, 31 - __clz(nz_lo & lanes_below), tables, v0,
                  n0);
    }
    ac_emission(c1[i], lane + 32,
                below_hi != 0u ? 63 - __clz(below_hi) : 31 - __clz(nz_lo),
                tables, v1, n1);
    pack_block(v0, n0, v1, n1, bufs[warp], lane, words + b * kSlots,
               bits + b);
  }
}

// kWarpsPerCta warps per CTA, `per_warp` blocks per warp; false when the
// grid would not fit the launch limits.
bool grid_for(long long nblocks, int per_warp, unsigned* grid) {
  const long long per_cta = static_cast<long long>(kWarpsPerCta) * per_warp;
  const long long g = (nblocks + per_cta - 1) / per_cta;
  if (g > 0x7FFFFFFFll) return false;
  *grid = static_cast<unsigned>(g);
  return true;
}

}  // namespace

extern "C" {

// Both entry points launch on `stream` (PyTorch's current stream) and
// return cudaGetLastError(): 0 on success.  Neither synchronises.

int jz_pack_words(const void* hi, const void* lo, const void* nbits,
                  void* words, void* bits, long long nblocks, void* stream) {
  if (nblocks <= 0) return 0;
  unsigned grid;
  if (!grid_for(nblocks, 1, &grid))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  pack_words_kernel<<<grid, kWarpsPerCta * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo),
      static_cast<const int32_t*>(nbits), static_cast<uint64_t*>(words),
      static_cast<int32_t*>(bits), nblocks);
  return static_cast<int>(cudaGetLastError());
}

int jz_encode_blocks(const void* q, const void* pred, const void* dc_code,
                     const void* dc_size, const void* ac_code,
                     const void* ac_size, void* words, void* bits,
                     long long nblocks, void* stream) {
  if (nblocks <= 0) return 0;
  unsigned grid;
  if (!grid_for(nblocks, kBlocksPerWarp, &grid))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const HuffTables t{
      static_cast<const int32_t*>(dc_code), static_cast<const int32_t*>(dc_size),
      static_cast<const int32_t*>(ac_code), static_cast<const int32_t*>(ac_size)};
  encode_blocks_kernel<<<grid, kWarpsPerCta * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(q), static_cast<const int32_t*>(pred), t,
      static_cast<uint64_t*>(words), static_cast<int32_t*>(bits), nblocks);
  return static_cast<int>(cudaGetLastError());
}

const char* jz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

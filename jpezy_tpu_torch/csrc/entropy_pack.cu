// Per-block Huffman entropy encode and bit packing for Hopper (sm_90a),
// and the symbol counts of the optimized encode's first pass.
//
// Replaces the Pallas TPU kernel jpezy_tpu/ops/pack_pallas.py
// (_pack_kernel / pack_words_pallas) and every form of
// jpezy_tpu/ops/entropy.py:pack_block_words (reduce, prefix, fori): it
// folds in the exclusive cumsum of the emission lengths and the 96-bit
// window alignment (entropy._window_words) that the JAX package computes
// around its kernel.  Three entry points; the first two share one pack
// routine:
//
//   jz_pack_words     the one-to-one counterpart of the Pallas kernel.
//     In:  hi, lo [B, 64] uint32 halves of each merged emission (the
//          emission sits MSB-first in the low bits of hi:lo), nbits [B, 64]
//          int32 emission lengths, 0 <= nbits <= 59.
//   jz_encode_blocks_batch  emissions fused in (jpezy_tpu/ops/entropy.py:
//     block_emissions followed by pack_block_words), with the DC
//     predictor chains of jpezy_tpu/parallel/sharded.py:_emit_local that
//     XLA fused on the TPU; the encode program uses this one, one launch
//     for the batch's three components, so neither emissions nor
//     predictors reach device memory.
//     In:  yq [N, B_Y, 64], cbq and crq [N, B_C, 64] int32 quantized
//          blocks in natural order, the restart interval ri (MCUs; a
//          segment is 4 ri blocks of Y, ri of Cb and of Cr), an optional
//          carry [N, 3] int32 (each image's first DC predictor per
//          component), and a luma and a chroma set of Huffman tables,
//          int32 [T, 348] each: each row dc_code, dc_size [12] by
//          magnitude category, then ac_code, ac_size [162] in the flat
//          layout idx = rem*10 + s + (rem == 15) (EOB at 0, ZRL at 151).
//          `custom` says the tables are the caller's (optimize): one set
//          for the batch, or one an image (image n takes set n), and an
//          emission may exceed 64 bits.  Without it the sets are the
//          fixed Annex K tables.
//   Out of both: words [B, 64] MSB-first packed block bitstring (per
//     component [N, B_c, 64]), 32-bit words stored zero-extended as
//     uint64, which is the int64 word convention of the stream concat
//     (storing them as uint32 and widening them in a second pass was
//     measured slower, PERF.md); bits [B] int32 total bits.
//   jz_symbol_histograms_batch  the counts of jpezy_tpu/codec/jax_codec.py:
//     _symbol_histograms_batch (jpezy_tpu/ops/entropy.py:symbol_histograms
//     vmapped over images, one chain per component), which XLA fused on
//     the TPU: no Pallas source.  In: the batch's three components yq [N,
//     B_Y, 64], cbq and crq [N, B_C, 64] int32 in natural order, the
//     restart interval ri (MCUs) and an optional carry [N, 3] int32, each
//     image's first DC predictor per component.  Out: hist [N, 4, 256]
//     int32, zeroed by the caller: per image the Y DC magnitude categories,
//     the Y AC symbols RRRRSSSS with ZRL (0xF0) and EOB (0x00), then the
//     same two rows for Cb and Cr together: the symbols
//     jz_encode_blocks_batch would emit.
//
// Design: a warp owns an 8x8 block.  Lane l owns emission slots l and l+32,
// so a warp reads its block's 256-byte row of each input in two 128-byte
// requests.  The fused entry reads each coefficient through the zigzag
// permutation; two ballots give the nonzero masks of the block's two
// halves, and a slot's zero run is its position minus the position of the
// highest set bit below it (__clz), which replaces the cummax of the
// tensor program.  Each lane builds its two emissions in registers: the
// code and extra bits (<= 27 bits, 32-bit arithmetic) and the rare ZRL
// prefix in front of them (up to 3 codes).  With the Annex K tables a
// whole emission has <= 59 bits, and the prefix is merged into one 64-bit
// register.  Optimal tables allow codes of 16 bits and emissions of up to
// 74, more than a 64-bit register holds, so the kernel is instantiated
// twice: the custom-table form keeps the prefix (<= 48 bits) apart as a
// count until it is placed, and takes each image's table set; the
// fixed-table form, the main path's, carries neither (28-32 registers
// against 40).  One launch takes the batch's three components, a warp's
// blocks all of one component; each block's DC predictor is found in the
// kernel (the previous block's DC, already in lane 0 for the warp's second
// block, one 4-byte load for its first; 0 at a restart segment's start;
// the carry or 0 at the image's first block), so no predictor array is
// built or read.  The shared
// pack routine then turns lengths into exclusive bit offsets with one warp
// shuffle scan (both slots' lengths ride in the halves of one register),
// cuts each part into its <= 3 words and ORs them with atomicOr into
// the warp's 64-word buffer in shared memory (neighbouring lanes can land
// in one word; emission bit ranges are disjoint, so OR accumulates them),
// and the 64 words leave as two coalesced stores.  Windows past word 63
// are dropped, as the masked forms of the JAX package drop them.  No
// per-thread array, so nothing lives in local memory.  A table set is one
// row of 1,392 bytes (one pointer a block), read through the read-only
// cache; 22 KB for 16 sets.
//
// The histogram kernel counts the same symbols another way: it needs no
// emission, only each nonzero coefficient's run and category, and a block
// holds only a few nonzero coefficients.  One thread takes one block: its
// 64 coefficients in registers, walked in zigzag order (a loop unrolled
// with the positions fixed at compile time), each symbol one atomicAdd
// into the thread block's shared-memory histogram; the nonzero bins are
// flushed into the image's rows in device memory with atomicAdd.  A warp
// per block, as in the encode, would spend its 32 lanes on the mostly zero
// coefficients and pay ballots and warp-aggregated atomics
// (__match_any_sync) per block, more than the loads cost: measured at
// under a third of the bound against over half for this form (PERF.md).
// One launch takes all three components: a
// thread block owns kHistThreads consecutive blocks of one image's
// component, so its 512 shared bins are zeroed and flushed once per that
// many blocks, and Cb and Cr flush into the same chroma rows.  Each
// block's DC predictor is found in the kernel (the previous block's DC,
// from the neighbouring thread; 0 at a restart segment's start; the carry
// or 0 at the image's first block), so no predictor array is built or
// read.
//
// What bounds them: memory traffic.  Per block the function jz_pack_words
// computes must read 768 bytes and write 64 32-bit words and a count, 260:
// 1,028 bytes, 101 MB per 16x512x512 4:2:0 batch of 98,304 blocks.  That
// of jz_encode_blocks_batch must read 256 and write 260: 516 bytes, 50.7
// MB per batch (the per-component form it replaced also read a 4-byte
// predictor a block, 520; the table sets add 1,392 bytes a set, read
// through the cache);
// jz_symbol_histograms_batch reads the 256 bytes of coefficients and
// writes 4 KB an image: 25.2 MB per batch.  These are the bounds.  The zero upper halves of the stored
// words are 256 more bytes per block (1,284 and 776 moved), a cost of the
// layout and no part of the bound.  The integer work, some tens of short
// operations per slot, stays below the card's rate for that many bytes.
// The design answers with coalesced
// loads and stores, with a warp per block, which keeps the card full of
// threads (64 warps resident per SM at <= 32 registers and 2 KB of shared
// memory per CTA), and with the fusion, which removes the emissions' 768
// bytes per block from device memory altogether.  The fused kernel moves
// so few bytes per block that one block per warp leaves too few loads in
// flight; each of its warps therefore takes kBlocksPerWarp consecutive
// blocks and starts all their loads before it uses any (2 measured
// fastest on an H100; 4 and 8 cost registers and were slower).  A
// histogram thread has its block's whole row in flight at once (16 loads
// of 16 bytes).  Times on the card are in PERF.md.
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

// One set of Huffman tables is kSetEntries int32 in a row: dc_code and
// dc_size by magnitude category, then ac_code and ac_size in the flat AC
// layout.
constexpr int kDcCode = 0;
constexpr int kDcSize = kDcEntries;
constexpr int kAcCode = 2 * kDcEntries;
constexpr int kAcSize = 2 * kDcEntries + kAcEntries;
constexpr int kSetEntries = 2 * (kDcEntries + kAcEntries);

// `count` ZRL codes of `size` bits of the set t, one after the other
// (<= 3 x 16 bits).
__device__ __forceinline__ uint64_t zrl_prefix(const int32_t* t, int count,
                                               int size) {
  const uint64_t code = static_cast<uint32_t>(__ldg(t + kAcCode + kZrlIndex));
  uint64_t z = 0ull;
  for (int k = 0; k < count; ++k) z = (z << size) | code;
  return z;
}

// The shared pack routine.  Every lane of the warp calls it with its two
// emissions (slot `lane` and slot `lane + 32`), each as zc ZRL codes of the
// table set t followed by a body (v, n) of <= 64 bits; `buf` is the warp's
// 64-word buffer in shared memory.  The prefix travels as a count and is
// built only where it is placed: no 64-bit value of it stays live across
// the scan.  Callers whose emissions are whole pass zc = 0, and the
// prefix code folds away.
template <typename V>
__device__ __forceinline__ void pack_block(int zc0, V v0, int n0, int zc1,
                                           V v1, int n1, const int32_t* t,
                                           uint32_t* buf, int lane,
                                           uint64_t* out_row,
                                           int32_t* out_bits) {
  const int zs = (zc0 | zc1) != 0 ? __ldg(t + kAcSize + kZrlIndex) : 0;
  const int zn0 = zc0 * zs;
  const int zn1 = zc1 * zs;
  // inclusive scan of both slots' lengths at once: 32 * 74 < 2**16, so
  // the two sums never meet
  const int t0 = zn0 + n0;
  const int t1 = zn1 + n1;
  int incl = t0 | (t1 << 16);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(kFullMask, incl, d);
    if (lane >= d) incl += x;
  }
  const int tot = __shfl_sync(kFullMask, incl, 31);
  const int total0 = tot & 0xFFFF;
  const int off0 = (incl & 0xFFFF) - t0;
  const int off1 = total0 + (incl >> 16) - t1;

  buf[lane] = 0u;
  buf[lane + 32] = 0u;
  __syncwarp();
  if (zc0 != 0) place(buf, zrl_prefix(t, zc0, zs), zn0, off0);
  place(buf, v0, n0, off0 + zn0);
  if (zc1 != 0) place(buf, zrl_prefix(t, zc1, zs), zn1, off1);
  place(buf, v1, n1, off1 + zn1);
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
  pack_block(0, v0, nbits[base + lane], 0, v1, nbits[base + lane + 32],
             nullptr, bufs[warp], lane, words + base, bits + b);
}

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

// The type of an emission's body: the code and extra bits alone (custom
// tables), or the whole emission with its ZRL prefix merged in (<= 59
// bits, the fixed tables).
template <bool kCustom>
struct Body {
  using type = uint64_t;
};
template <>
struct Body<true> {
  using type = uint32_t;
};

// Slot 0: the DC code and extra bits of diff = DC - predictor.
template <typename V>
__device__ __forceinline__ void dc_emission(int diff, const int32_t* t,
                                            V& v, int& n) {
  const int s = min(category(diff), kDcEntries - 1);
  v = code_and_extra(static_cast<uint32_t>(__ldg(t + kDcCode + s)), diff, s);
  n = __ldg(t + kDcSize + s) + s;
}

// Slot j in 1..63: the coefficient c at zigzag position j, `prev` the
// position of the last nonzero coefficient before it (0 if none).  A
// nonzero c emits one ZRL per 16 zeros of its run, then the (run & 15,
// category) code and the extra bits (v, n); a zero emits nothing, except
// EOB at position 63.  With custom tables the ZRLs are returned as their
// count zc; with the fixed ones they are merged into v (zc = 0).
template <bool kCustom>
__device__ __forceinline__ void ac_emission(int c, int j, int prev,
                                            const int32_t* t, int& zc,
                                            typename Body<kCustom>::type& v,
                                            int& n) {
  zc = 0;
  v = 0u;
  n = 0;
  if (c != 0) {
    const int run = j - prev - 1;
    const int rem = run & 15;
    const int s = category(c);
    const int idx = min(rem * 10 + s + (rem == 15 ? 1 : 0), kAcEntries - 1);
    v = code_and_extra(static_cast<uint32_t>(__ldg(t + kAcCode + idx)), c, s);
    n = __ldg(t + kAcSize + idx) + s;
    if constexpr (kCustom) {
      zc = run >> 4;  // rare: up to three ZRL codes go in front
    } else if (run >= 16) {  // rare, and <= 3 x 11 + 27 bits in all
      const int zs = __ldg(t + kAcSize + kZrlIndex);
      v |= zrl_prefix(t, run >> 4, zs) << n;
      n += (run >> 4) * zs;
    }
  } else if (j == kSlots - 1) {
    v = static_cast<uint32_t>(__ldg(t + kAcCode + kEobIndex));
    n = __ldg(t + kAcSize + kEobIndex);
  }
}

// One block, by the whole warp: lane l holds the coefficients at zigzag
// positions l (c0) and l + 32 (c1); dcp is the DC predictor (read in
// lane 0), t the block's table set.  Writes the block's 64 words and its
// bit count.
template <bool kCustom>
__device__ __forceinline__ void encode_block(int c0, int c1, int dcp,
                                             const int32_t* t, uint32_t* buf,
                                             int lane, uint64_t* out_row,
                                             int32_t* out_bits) {
  const uint32_t lanes_below = (1u << lane) - 1u;
  // nonzero masks of zigzag positions 0..31 and 32..63; bit 0 (the DC)
  // is always set, so "no nonzero AC before me" reads as position 0
  const uint32_t nz_lo = __ballot_sync(kFullMask, c0 != 0) | 1u;
  const uint32_t nz_hi = __ballot_sync(kFullMask, c1 != 0);
  const uint32_t below_hi = nz_hi & lanes_below;
  typename Body<kCustom>::type v0, v1;
  int zc0, n0, zc1, n1;
  if (lane == 0) {
    zc0 = 0;
    dc_emission(c0 - dcp, t, v0, n0);
  } else {
    ac_emission<kCustom>(c0, lane, 31 - __clz(nz_lo & lanes_below), t, zc0,
                         v0, n0);
  }
  ac_emission<kCustom>(
      c1, lane + 32,
      below_hi != 0u ? 63 - __clz(below_hi) : 31 - __clz(nz_lo), t, zc1, v1,
      n1);
  pack_block(zc0, v0, n0, zc1, v1, n1, t, buf, lane, out_row, out_bits);
}

// One component of the batch: its quantized blocks [N, per_image, 64], its
// table sets (one, or one an image), its outputs.
struct Component {
  const int32_t* q;
  const int32_t* tables;
  uint64_t* words;
  int32_t* bits;
  int per_image;   // blocks an image
  int seg_blocks;  // blocks a restart segment; 0 for none
  int warps;       // warps it takes: ceil(N * per_image / kBlocksPerWarp)
};

// One launch for the batch's three components.  A warp takes
// kBlocksPerWarp consecutive blocks of one component, picked by branches
// (a parameter array indexed at run time would be copied to local
// memory).  Block b's DC predictor is block b - 1's DC in the same image
// and component; 0 where a restart segment starts (every seg_blocks
// blocks), and carry[n, comp] (or 0) at image n's first block.  The warp's
// second block takes the first block's DC, which lane 0 already holds;
// only the first block loads one more DC (4 bytes).  Every predictor and
// table set is decided, and every load started, before any block is
// coded.  The launcher keeps each component's blocks below 2**31, so the
// indices are 32-bit.
template <bool kCustom>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
    encode_blocks_batch_kernel(Component y, Component cb, Component cr,
                               const int32_t* __restrict__ carry, int nimages,
                               int nsets) {
  __shared__ uint32_t bufs[kWarpsPerCta][kWords];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int g = blockIdx.x * kWarpsPerCta + warp;
  Component k = y;
  int comp = 0;
  if (g >= y.warps) {  // every test on g is warp-uniform
    g -= y.warps;
    k = cb;
    comp = 1;
    if (g >= cb.warps) {
      g -= cb.warps;
      k = cr;
      comp = 2;
      if (g >= cr.warps) return;  // whole warps leave together
    }
  }
  const unsigned nblocks = static_cast<unsigned>(nimages) * k.per_image;
  const unsigned b0 = static_cast<unsigned>(g) * kBlocksPerWarp;
  // All loads of the warp's blocks are started before any is used: a block
  // is only 256 bytes, and one block per warp keeps too few bytes in
  // flight to cover the latency of device memory.
  const int z0 = kZigzag[lane];
  const int z1 = kZigzag[lane + 32];
  int c0[kBlocksPerWarp], c1[kBlocksPerWarp], dcp[kBlocksPerWarp];
  bool chained[kBlocksPerWarp];  // predictor: the previous block's DC
  unsigned set[kBlocksPerWarp];
  unsigned n = b0 / k.per_image;
  unsigned at = b0 - n * k.per_image;  // the block's index in its image
#pragma unroll
  for (int i = 0; i < kBlocksPerWarp; ++i) {
    const bool live = b0 + i < nblocks;
    const unsigned b = live ? b0 + i : b0;  // tail: load a valid row
    const int32_t* row = k.q + static_cast<size_t>(b) * kSlots;
    c0[i] = __ldg(row + z0);
    c1[i] = __ldg(row + z1);
    const bool seg_start = k.seg_blocks > 0 && at % k.seg_blocks == 0;
    chained[i] = i > 0 && at != 0 && !seg_start;
    dcp[i] = 0;
    if (live && !seg_start && at == 0 && carry != nullptr)
      dcp[i] = __ldg(carry + n * 3 + comp);
    else if (!seg_start && at != 0 && i == 0 && lane == 0)
      dcp[i] = __ldg(row - kSlots);  // the block before the warp's first
    set[i] = n;
    if (++at == static_cast<unsigned>(k.per_image)) {
      at = 0;
      ++n;
    }
  }
#pragma unroll
  for (int i = 0; i < kBlocksPerWarp; ++i) {
    const unsigned b = b0 + i;
    if (b >= nblocks) break;
    // the previous block's DC is c0[i - 1] in lane 0
    const int pred = chained[i] ? c0[i > 0 ? i - 1 : 0] : dcp[i];
    const int32_t* t = k.tables;
    if constexpr (kCustom) {
      if (nsets > 1) t += set[i] * kSetEntries;
    }
    encode_block<kCustom>(c0[i], c1[i], pred, t, bufs[warp], lane,
                          k.words + static_cast<size_t>(b) * kSlots,
                          k.bits + b);
  }
}

// ---- pass 1 of the optimized encode: per-image symbol counts

constexpr int kHistBins = 256;                 // per row: DC, then AC
constexpr int kHistImageBins = 2 * kHistBins;  // one component's [2, 256]
constexpr int kHistThreads = 256;  // blocks a thread block counts, one each
constexpr int kEobBin = kHistBins + 0x00;
constexpr int kZrlBin = kHistBins + 0xF0;

// Category capped at 12, as the JAX package's comparison ladder
// (bit_category, max_bits=12) caps it.
__device__ __forceinline__ int category12(int v) {
  return min(category(v), 12);
}

// One launch counts every image's three components.  A thread block owns
// kHistThreads consecutive blocks of one (image, component), a thread one
// block: its 64 coefficients in registers (16 coalesced-in-L1 16-byte
// loads), walked in zigzag order with the positions fixed at compile time,
// each nonzero coefficient one shared-memory atomicAdd of its symbol.
// Block i's DC predictor is block i - 1's DC in the same chain (the
// neighbouring thread's, by a shuffle), 0 where a restart segment starts
// (every seg_blocks blocks), and carry[n, c] (or 0) at the image's first
// block.
__global__ void __launch_bounds__(kHistThreads)
    symbol_histograms_batch_kernel(const int32_t* __restrict__ yq,
                                   const int32_t* __restrict__ cbq,
                                   const int32_t* __restrict__ crq,
                                   const int32_t* __restrict__ carry,
                                   int32_t* __restrict__ hist, int luma_blocks,
                                   int chroma_blocks, int ri, int luma_ctas,
                                   int chroma_ctas) {
  // zigzag position k -> natural index; the loop below is unrolled, so
  // every read of this table folds into a register number
  constexpr int kZz[kSlots] = {
      0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
      12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
      35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
      58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
  __shared__ int32_t sh[kHistImageBins];
  for (int i = threadIdx.x; i < kHistImageBins; i += kHistThreads) sh[i] = 0;
  // which (image, component, run of blocks) this thread block owns
  const int per_image = luma_ctas + 2 * chroma_ctas;
  const int n = blockIdx.x / per_image;
  int r = blockIdx.x - n * per_image;
  int comp = 0;
  if (r >= luma_ctas) {
    r -= luma_ctas;
    comp = 1 + r / chroma_ctas;
    r -= (comp - 1) * chroma_ctas;
  }
  const int nb = comp == 0 ? luma_blocks : chroma_blocks;
  const int32_t* q = (comp == 0 ? yq : comp == 1 ? cbq : crq) +
                     static_cast<int64_t>(n) * nb * kSlots;
  const int seg_blocks = ri * (comp == 0 ? 4 : 1);
  const int b = r * kHistThreads + threadIdx.x;
  const bool live = b < nb;
  int c[kSlots];
  const int4* row = reinterpret_cast<const int4*>(q + (live ? b : 0) * kSlots);
#pragma unroll
  for (int k = 0; k < kSlots / 4; ++k) {
    const int4 v = __ldg(row + k);
    c[4 * k] = v.x;
    c[4 * k + 1] = v.y;
    c[4 * k + 2] = v.z;
    c[4 * k + 3] = v.w;
  }
  int pred = __shfl_up_sync(kFullMask, c[0], 1);
  if ((threadIdx.x & 31) == 0 && live && b > 0)
    pred = __ldg(q + (b - 1) * kSlots);
  if (b == 0) pred = carry != nullptr ? __ldg(carry + n * 3 + comp) : 0;
  if (seg_blocks > 0 && b % seg_blocks == 0) pred = 0;
  __syncthreads();
  if (live) {
    atomicAdd(sh + category12(c[0] - pred), 1);
    int last = 0, zrls = 0;
#pragma unroll
    for (int k = 1; k < kSlots; ++k) {
      const int v = c[kZz[k]];
      if (v != 0) {
        const int run = k - last - 1;
        zrls += run >> 4;
        atomicAdd(sh + kHistBins + (((run & 15) << 4) | category12(v)), 1);
        last = k;
      }
    }
    if (last != kSlots - 1) atomicAdd(sh + kEobBin, 1);
    if (zrls > 0) atomicAdd(sh + kZrlBin, zrls);
  }
  __syncthreads();
  // Cb and Cr add into the same chroma rows
  int32_t* out =
      hist + (static_cast<int64_t>(n) * 2 + (comp > 0)) * kHistImageBins;
  for (int i = threadIdx.x; i < kHistImageBins; i += kHistThreads) {
    const int32_t v = sh[i];
    if (v != 0) atomicAdd(out + i, v);
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

template <typename K>
int kernel_info(K kernel, int threads, int* info) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  info[0] = attr.numRegs;
  info[1] = per_sm;
  info[2] = static_cast<int>(attr.sharedSizeBytes);
  info[3] = static_cast<int>(attr.localSizeBytes);
  info[4] = threads;
  return 0;
}

}  // namespace

extern "C" {

// Every entry point launches on `stream` (PyTorch's current stream) and
// returns cudaGetLastError(): 0 on success.  None synchronises.

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

// The batch's three components in one launch.  yq [N, luma_blocks, 64],
// cbq and crq [N, chroma_blocks, 64] int32; luma and chroma: the two
// components' table rows [nsets, kSetEntries] int32, the fixed Annex K
// rows (custom == 0, nsets 1) or the caller's (custom != 0: nsets 1, or N
// and image n takes set n); carry [N, 3] int32 or null; ri the restart
// interval in MCUs (0: none); out per component: words [N, B_c, 64]
// uint64 and bits [N, B_c] int32.
int jz_encode_blocks_batch(const void* yq, const void* cbq, const void* crq,
                           const void* luma, const void* chroma, int nsets,
                           int custom, const void* carry, void* wy, void* wcb,
                           void* wcr, void* by, void* bcb, void* bcr,
                           long long nimages, long long luma_blocks,
                           long long chroma_blocks, long long ri,
                           void* stream) {
  if (nimages <= 0) return 0;
  const long long most = 0x7FFFFFFFll;  // 32-bit block indices
  if (luma_blocks <= 0 || chroma_blocks <= 0 || ri < 0 ||
      nimages * luma_blocks > most || nimages * chroma_blocks > most ||
      4 * ri > most || nsets < 1 || (!custom && nsets != 1) ||
      (nsets > 1 && nsets != nimages))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long luma_warps =
      (nimages * luma_blocks + kBlocksPerWarp - 1) / kBlocksPerWarp;
  const long long chroma_warps =
      (nimages * chroma_blocks + kBlocksPerWarp - 1) / kBlocksPerWarp;
  unsigned grid;
  if (!grid_for(luma_warps + 2 * chroma_warps, 1, &grid) ||
      luma_warps + 2 * chroma_warps > most)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto comp = [](const void* q, const void* t, void* w, void* b,
                       long long per_image, long long seg_blocks,
                       long long warps) {
    return Component{static_cast<const int32_t*>(q),
                     static_cast<const int32_t*>(t), static_cast<uint64_t*>(w),
                     static_cast<int32_t*>(b), static_cast<int>(per_image),
                     static_cast<int>(seg_blocks), static_cast<int>(warps)};
  };
  const Component y = comp(yq, luma, wy, by, luma_blocks, 4 * ri, luma_warps);
  const Component cb =
      comp(cbq, chroma, wcb, bcb, chroma_blocks, ri, chroma_warps);
  const Component cr =
      comp(crq, chroma, wcr, bcr, chroma_blocks, ri, chroma_warps);
  auto kernel = custom ? encode_blocks_batch_kernel<true>
                       : encode_blocks_batch_kernel<false>;
  kernel<<<grid, kWarpsPerCta * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      y, cb, cr, static_cast<const int32_t*>(carry),
      static_cast<int>(nimages), nsets);
  return static_cast<int>(cudaGetLastError());
}

// yq [N, luma_blocks, 64], cbq and crq [N, chroma_blocks, 64] int32, each
// 16-byte aligned; carry [N, 3] int32 or null; hist [N, 4, 256] int32,
// zeroed by the caller.
int jz_symbol_histograms_batch(const void* yq, const void* cbq,
                               const void* crq, const void* carry, void* hist,
                               long long nimages, long long luma_blocks,
                               long long chroma_blocks, long long ri,
                               void* stream) {
  if (nimages <= 0) return 0;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const long long most = 0x7FFFFFFFll / kSlots;  // int block offsets
  if (luma_blocks <= 0 || chroma_blocks <= 0 || luma_blocks > most ||
      chroma_blocks > most || ri < 0 || ri > 0x7FFFFFFFll / 4 ||
      !aligned(yq) || !aligned(cbq) || !aligned(crq))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long luma_ctas = (luma_blocks + kHistThreads - 1) / kHistThreads;
  const long long chroma_ctas =
      (chroma_blocks + kHistThreads - 1) / kHistThreads;
  const long long grid = nimages * (luma_ctas + 2 * chroma_ctas);
  if (grid > 0x7FFFFFFFll)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  symbol_histograms_batch_kernel<<<static_cast<unsigned>(grid), kHistThreads,
                                   0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(yq), static_cast<const int32_t*>(cbq),
      static_cast<const int32_t*>(crq), static_cast<const int32_t*>(carry),
      static_cast<int32_t*>(hist), static_cast<int>(luma_blocks),
      static_cast<int>(chroma_blocks), static_cast<int>(ri),
      static_cast<int>(luma_ctas), static_cast<int>(chroma_ctas));
  return static_cast<int>(cudaGetLastError());
}

// What the card reports for kernel `which` (0: encode_blocks, fixed
// tables; 1: custom tables; 2: symbol_histograms; 3: pack_words):
// info[0] registers a thread, [1] resident thread blocks an SM, [2] static
// shared bytes, [3] local bytes a thread, [4] threads a block.  Returns 0
// or a CUDA error code.
int jz_entropy_kernel_info(int which, int* info) {
  switch (which) {
    case 0:
      return kernel_info(encode_blocks_batch_kernel<false>, kWarpsPerCta * 32,
                         info);
    case 1:
      return kernel_info(encode_blocks_batch_kernel<true>, kWarpsPerCta * 32,
                         info);
    case 2:
      return kernel_info(symbol_histograms_batch_kernel, kHistThreads, info);
    case 3:
      return kernel_info(pack_words_kernel, kWarpsPerCta * 32, info);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* jz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Per-block Huffman entropy encode and bit packing for Hopper (sm_90a),
// and the symbol counts of the optimized encode's first pass.
//
// Replaces the Pallas TPU kernel jpezy_tpu/ops/pack_pallas.py
// (_pack_kernel / pack_words_pallas) and every form of
// jpezy_tpu/ops/entropy.py:pack_block_words (reduce, prefix, fori): it
// folds in the exclusive cumsum of the emission lengths and the 96-bit
// window alignment (entropy._window_words) that the JAX package computes
// around its kernel.  Three entry points:
//
//   jz_pack_words     the one-to-one counterpart of the Pallas kernel.
//     In:  hi, lo [B, 64] uint32 halves of each merged emission (the
//          emission sits MSB-first in the low bits of hi:lo), nbits [B, 64]
//          int32 emission lengths, 0 <= nbits <= 59.
//     Out: words [B, 64] MSB-first packed block bitstring, 32-bit words
//          stored zero-extended as uint64 (the int64 word convention of
//          the plain torch forms); bits [B] int32 total bits.
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
//          fixed Annex K tables.  The blocks, the table rows and the
//          words must be 16-byte aligned.
//     Out: words [N, B_c, 64] per component, 32-bit words (the packed
//          block bitstring, MSB-first, zero past the block's bits), which
//          the stream concat (stream_concat.cu) reads as they are; bits
//          [N, B_c] int32 total bits.
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
// Design of the pack alone: a warp owns an 8x8 block, lane l its
// emissions l and l+32; one warp shuffle scan turns the lengths into bit
// offsets (both slots' lengths ride in the halves of one register), each
// emission is cut into its <= 3 words and ORed with atomicOr into the
// warp's 64-word buffer in shared memory (emission bit ranges are
// disjoint, so OR accumulates them), and the 64 words leave as two
// coalesced stores.  Windows past word 63 are dropped, as the masked forms
// of the JAX package drop them.
//
// Design of the fused kernel (jz_encode_blocks_batch): the blocks are cut
// into runs of kRunBlocks consecutive blocks of one component (with a
// table set an image and images of fewer blocks, a run of one image's
// blocks, so that a run meets at most two images), and a thread block is
// one warp that takes one run, a lane a block.  The lanes copy the run's
// blocks into a shared-memory stage with 16-byte asynchronous copies
// (cp.async; two whole blocks an instruction, read in order from device
// memory), and the table sets the run needs beside them (the component's
// fixed row, or the set of each image the run touches).  Rows are kRow
// words apart, so that the 16 16-byte reads with which a lane takes its
// block into registers meet no bank twice in a quarter warp.  While the
// copies are in flight, each lane finds its block's DC predictor source:
// the previous block's DC (the neighbouring lane's, by a shuffle), 0 at a
// restart segment's start, the carry or 0 at an image's first block, and
// for the run's first block otherwise one 4-byte load.  The lane then
// walks its 64 coefficients in zigzag order (a loop unrolled with the
// positions fixed at compile time, as in the histogram kernel), each
// nonzero coefficient one emission from the table set in shared memory
// (ZRL codes first where its zero run is 16 or more), and appends each
// emission to a 64-bit bit accumulator, whose top 32 bits leave as a word
// (a predicated store) whenever it holds 32.  The words go into the
// lane's own row of the stage, zeroed once its block is in registers, and
// the warp then stores the rows to device memory in 16-byte stores, two
// whole rows an instruction.  So a block costs its lane some tens of
// instructions a nonzero coefficient and a test for each zero, where the
// first fused design (scripts/previous_designs.cu) spent a whole warp on
// every block's 64 emission slots, a shuffle scan and shared-memory
// atomics (measured: that schedule with this design's stage and stores
// read 0.0300 ms on the main batch where the bytes alone read 0.0187,
// scripts/encode_phases.py, PERF.md); and the coefficients arrive by
// asynchronous copies that cost no registers, where that design gathered
// them by 4-byte loads.  A bulk copy (cp.async.bulk) a block and a bulk
// store a row, which the copy engine takes one at a time, read slower
// than these copies and stores (PERF.md).  The launch bounds hold a lane
// to the registers that let kResident thread blocks share an SM (the 64
// coefficients take most of them).  One launch takes the batch's three
// components (Y's runs, then Cb's, then Cr's); the launcher keeps each
// component's blocks below 2**31, so the indices are 32-bit.
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
// 1,028 bytes, 101 MB per 16x512x512 4:2:0 batch of 98,304 blocks (the
// pack alone stores its words zero-extended, 256 bytes a block more).
// That of jz_encode_blocks_batch must read 256 and write 260: 516 bytes,
// 50.7 MB per batch, and the kernel moves just these (the table sets add
// 1,392 bytes a thread block, from L2); its first design stored the words
// zero-extended, 776 bytes a block.  jz_symbol_histograms_batch reads the
// 256 bytes of coefficients and writes 4 KB an image: 25.2 MB per batch.
// These are the bounds.  Times on the card are in PERF.md.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 64;
constexpr int kWords = 64;
constexpr int kWarpsPerCta = 8;  // of the pack alone
// the fused kernel: a thread block is a warp, a lane a block of the run
constexpr int kRunBlocks = 32;
constexpr int kRow = kSlots + 4;  // words a staged block takes: 272 bytes
constexpr int kRunSets = 2;       // table sets a run may meet (custom)
constexpr int kResident = 24;     // thread blocks an SM the bounds ask for
constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kEobIndex = 0;
constexpr int kZrlIndex = 151;
constexpr int kDcEntries = 12;
constexpr int kAcEntries = 162;

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
constexpr int kSetBytes = 4 * kSetEntries;  // 1,392: a multiple of 16

// The pack alone's routine.  Every lane of the warp calls it with its two
// merged emissions (slot `lane` and slot `lane + 32`, <= 64 bits each);
// `buf` is the warp's 64-word buffer in shared memory.
__device__ __forceinline__ void pack_block(uint64_t v0, int n0, uint64_t v1,
                                           int n1, uint32_t* buf, int lane,
                                           uint64_t* out_row,
                                           int32_t* out_bits) {
  // inclusive scan of both slots' lengths at once: 32 * 64 < 2**16, so
  // the two sums never meet
  int incl = n0 | (n1 << 16);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(kFullMask, incl, d);
    if (lane >= d) incl += x;
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

// A lane's bit writer: the block's bits so far, the last `held` of them
// (< 32) still in `acc`, the words before them in the lane's output row.
struct Bits {
  uint64_t acc;
  int held;
  int words;
  int32_t* row;

  // Append the n low bits of v (n <= 32); a full word leaves for the row.
  // Words past the row's 64 land in its padding and are dropped, as the
  // plain forms drop them.
  __device__ __forceinline__ void put(uint32_t v, int n) {
    acc = (acc << n) | v;
    held += n;
    const bool full = held >= 32;
    held &= 31;  // held < 64
    if (full) row[min(words, kWords)] = static_cast<int32_t>(acc >> held);
    words += full;
  }
};

// One component of the batch: its quantized blocks [N, per_image, 64], its
// table sets (one, or one an image), its outputs.
struct Component {
  const int32_t* q;
  const int32_t* tables;
  uint32_t* words;
  int32_t* bits;
  int per_image;   // blocks an image
  int seg_blocks;  // blocks a restart segment; 0 for none
  int run;         // blocks a run (the component's last run fewer)
  int runs;        // its runs: ceil(N * per_image / run)
};

// Run r of the batch (runs [0, y.runs) Y's, then Cb's, then Cr's): its
// component, its first block and block count, the image of its first
// block, and whether it reaches into the next image's table set.
struct Run {
  Component k;
  int comp;
  unsigned b0;
  int count;
  unsigned n0;
  bool two;
};

template <bool kCustom>
__device__ __forceinline__ Run run_of(int r, const Component& y,
                                      const Component& cb,
                                      const Component& cr, int nimages,
                                      int nsets) {
  // picked by branches: a parameter array indexed at run time would be
  // copied to local memory
  Run u;
  u.k = y;
  u.comp = 0;
  if (r >= y.runs) {
    r -= y.runs;
    u.k = cb;
    u.comp = 1;
    if (r >= cb.runs) {
      r -= cb.runs;
      u.k = cr;
      u.comp = 2;
    }
  }
  const unsigned per_image = static_cast<unsigned>(u.k.per_image);
  u.b0 = static_cast<unsigned>(r) * u.k.run;
  u.count = min(u.k.run, static_cast<int>(static_cast<unsigned>(nimages) *
                                              per_image -
                                          u.b0));
  u.n0 = u.b0 / per_image;
  u.two = kCustom && nsets > 1 && (u.b0 + u.count - 1) / per_image != u.n0;
  return u;
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory at src to shared memory at dst, both 16-byte
// aligned, asynchronously (in the issuing lane's current copy group).
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   shared_addr(dst)),
               "l"(src)
               : "memory");
}

// Start the copies of run u, one group a lane: its blocks into the stage's
// rows, 16 bytes a lane and two rows an instruction (each row's 256 bytes
// read by 16 neighbouring lanes), and its table set or sets into `sets`.
template <bool kCustom>
__device__ __forceinline__ void start_run(const Run& u, int nsets,
                                          int32_t* stage, int32_t* sets,
                                          int lane) {
  const int32_t* q = u.k.q + static_cast<size_t>(u.b0) * kSlots;
#pragma unroll
  for (int i = 0; i < kRunBlocks / 2; ++i) {
    const int row = 2 * i + (lane >> 4);
    if (row < u.count)
      copy16(stage + row * kRow + 4 * (lane & 15), q + row * kSlots +
                                                       4 * (lane & 15));
  }
  const int32_t* t = u.k.tables;
  if (kCustom && nsets > 1) t += static_cast<size_t>(u.n0) * kSetEntries;
  const int chunks = (u.two ? 2 : 1) * kSetEntries / 4;
  for (int i = lane; i < chunks; i += 32) copy16(sets + 4 * i, t + 4 * i);
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// One launch for the batch's three components.  A thread block is one
// warp and takes run blockIdx.x, a lane a block (see the header).  Block
// b's DC predictor is block b - 1's DC in the same image and component; 0
// where a restart segment starts (every seg_blocks blocks), and carry[n,
// comp] (or 0) at image n's first block.  With a table set an image
// (custom, nsets > 1), a run meets at most two images (the launcher's
// runs are no longer than an image), and their sets are staged side by
// side.
template <bool kCustom>
__global__ void __launch_bounds__(kRunBlocks, kResident)
    encode_blocks_batch_kernel(Component y, Component cb, Component cr,
                               const int32_t* __restrict__ carry, int nimages,
                               int nsets) {
  // zigzag position k -> natural index; the walk below is unrolled, so
  // every read of this table folds into a register number
  constexpr int kZigzag[kSlots] = {
      0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
      12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
      35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
      58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
  // the run's blocks in, then their words out, a row a block
  __shared__ __align__(128) int32_t stage[kRunBlocks * kRow];
  __shared__ __align__(16) int32_t sets[(kCustom ? kRunSets : 1) *
                                        kSetEntries];
  const int lane = threadIdx.x;
  const Run u = run_of<kCustom>(blockIdx.x, y, cb, cr, nimages, nsets);
  start_run<kCustom>(u, nsets, stage, sets, lane);
  const Component& k = u.k;
  const unsigned b = u.b0 + lane;
  const bool live = lane < u.count;
  // while the copies run: the block's predictor source and table set
  const unsigned per_image = static_cast<unsigned>(k.per_image);
  const unsigned n = b / per_image;
  const unsigned at = b - n * per_image;  // the block's index in its image
  const bool reset =
      k.seg_blocks > 0 && at % static_cast<unsigned>(k.seg_blocks) == 0;
  int pred = 0;
  if (live && !reset) {
    if (at == 0) {
      if (carry != nullptr) pred = __ldg(carry + n * 3 + u.comp);
    } else if (lane == 0) {  // the block before the run
      pred = __ldg(k.q + static_cast<size_t>(b - 1) * kSlots);
    }
  }
  const int32_t* t = sets + (kCustom && u.two && n != u.n0 ? kSetEntries : 0);
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncwarp();  // every lane's copies have landed
  // the block's coefficients into registers; its row then takes its words
  int32_t* row = stage + lane * kRow;
  int c[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots / 4; ++i) {
    const int4 v = reinterpret_cast<const int4*>(row)[i];
    c[4 * i] = v.x;
    c[4 * i + 1] = v.y;
    c[4 * i + 2] = v.z;
    c[4 * i + 3] = v.w;
  }
  const int before = __shfl_up_sync(kFullMask, c[0], 1);
  if (!reset && at != 0 && lane > 0) pred = before;
  if (live) {
#pragma unroll
    for (int i = 0; i < kWords / 4; ++i)
      reinterpret_cast<int4*>(row)[i] = make_int4(0, 0, 0, 0);
    Bits out = {0ull, 0, 0, row};
    {  // the DC difference; its category capped at the table's last
      const int diff = c[0] - pred;
      const int s = min(category(diff), kDcEntries - 1);
      out.put(code_and_extra(static_cast<uint32_t>(t[kDcCode + s]), diff, s),
              t[kDcSize + s] + s);
    }
    int last = 0;  // the zigzag position of the last nonzero coefficient
#pragma unroll
    for (int i = 1; i < kSlots; ++i) {
      const int v = c[kZigzag[i]];
      if (v != 0) {
        int run = i - last - 1;
        if (run >= 16) {  // rare: a ZRL code for each 16 zeros
          const uint32_t z = static_cast<uint32_t>(t[kAcCode + kZrlIndex]);
          const int zs = t[kAcSize + kZrlIndex];
#pragma unroll 1
          for (; run >= 16; run -= 16) out.put(z, zs);
        }
        const int s = category(v);
        const int e = min(run * 10 + s + (run == 15 ? 1 : 0), kAcEntries - 1);
        out.put(code_and_extra(static_cast<uint32_t>(t[kAcCode + e]), v, s),
                t[kAcSize + e] + s);
        last = i;
      }
    }
    if (last != kSlots - 1)
      out.put(static_cast<uint32_t>(t[kAcCode + kEobIndex]),
              t[kAcSize + kEobIndex]);
    if (out.held > 0)  // the last word, zero-padded
      row[min(out.words, kWords)] =
          static_cast<int32_t>(out.acc << (32 - out.held));
    k.bits[b] = 32 * out.words + out.held;
  }
  __syncwarp();  // every row holds its words
  // the rows to device memory: 16 bytes a lane, two whole rows a store
  uint32_t* dst = k.words + static_cast<size_t>(u.b0) * kWords;
#pragma unroll
  for (int i = 0; i < kRunBlocks / 2; ++i) {
    const int w = 2 * i + (lane >> 4);
    if (w < u.count)
      reinterpret_cast<int4*>(dst + w * kWords)[lane & 15] =
          reinterpret_cast<const int4*>(stage + w * kRow)[lane & 15];
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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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
// 32-bit words and bits [N, B_c] int32.  The blocks, the table rows and
// the words must be 16-byte aligned (the 16-byte copies and stores need
// it).
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
      (nsets > 1 && nsets != nimages) || !aligned16(yq) || !aligned16(cbq) ||
      !aligned16(crq) || !aligned16(luma) || !aligned16(chroma) ||
      !aligned16(wy) || !aligned16(wcb) || !aligned16(wcr))
    return static_cast<int>(cudaErrorInvalidValue);
  // with a table set an image, a run no longer than an image meets at
  // most two of them
  const auto run_of = [&](long long per_image) {
    return nsets > 1 && per_image < kRunBlocks ? per_image
                                               : static_cast<long long>(
                                                     kRunBlocks);
  };
  const long long luma_run = run_of(luma_blocks);
  const long long chroma_run = run_of(chroma_blocks);
  const long long luma_runs = (nimages * luma_blocks + luma_run - 1) / luma_run;
  const long long chroma_runs =
      (nimages * chroma_blocks + chroma_run - 1) / chroma_run;
  if (luma_runs + 2 * chroma_runs > most)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kernel = custom ? encode_blocks_batch_kernel<true>
                       : encode_blocks_batch_kernel<false>;
  const long long grid = luma_runs + 2 * chroma_runs;  // a thread block a run
  const auto comp = [](const void* q, const void* t, void* w, void* b,
                       long long per_image, long long seg_blocks,
                       long long run, long long runs) {
    return Component{static_cast<const int32_t*>(q),
                     static_cast<const int32_t*>(t), static_cast<uint32_t*>(w),
                     static_cast<int32_t*>(b), static_cast<int>(per_image),
                     static_cast<int>(seg_blocks), static_cast<int>(run),
                     static_cast<int>(runs)};
  };
  const Component y =
      comp(yq, luma, wy, by, luma_blocks, 4 * ri, luma_run, luma_runs);
  const Component cb = comp(cbq, chroma, wcb, bcb, chroma_blocks, ri,
                            chroma_run, chroma_runs);
  const Component cr = comp(crq, chroma, wcr, bcr, chroma_blocks, ri,
                            chroma_run, chroma_runs);
  kernel<<<static_cast<unsigned>(grid), kRunBlocks, 0,
           static_cast<cudaStream_t>(stream)>>>(
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
  const long long most = 0x7FFFFFFFll / kSlots;  // int block offsets
  if (luma_blocks <= 0 || chroma_blocks <= 0 || luma_blocks > most ||
      chroma_blocks > most || ri < 0 || ri > 0x7FFFFFFFll / 4 ||
      !aligned16(yq) || !aligned16(cbq) || !aligned16(crq))
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
      return kernel_info(encode_blocks_batch_kernel<false>, kRunBlocks, info);
    case 1:
      return kernel_info(encode_blocks_batch_kernel<true>, kRunBlocks, info);
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

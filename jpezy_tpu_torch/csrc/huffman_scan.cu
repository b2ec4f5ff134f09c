// Huffman entropy decode of restart segments for Hopper (sm_90a).
//
// Replaces jpezy_tpu/ops/entropy_decode.py:decode_segments, which the JAX
// package runs as a lax.scan over block slots around a lax.while_loop over
// symbols with all segments in lockstep (XLA-fused on the TPU; it has no
// Pallas source).  Same function, bit for bit, as
// jpezy_tpu_torch/ops/entropy_decode.py:decode_segments_plain, on valid
// and on corrupt input.
//
//   In:  words [S, Lw] uint32, each row one segment's destuffed bytes
//        packed big-endian, zero-padded; nblk [S] int32 blocks to decode
//        per segment; lut [T, 6, 65536] int32, row = component * 2 + (AC ?
//        1 : 0), entry = (HUFFVAL << 8) | code length (1..16) for the
//        16-bit window, or -1, as entropy_decode.build_decode_lut makes it
//        from a prefix code; optional tsel [S] table set per segment,
//        rawlen [S] destuffed byte length, skip0 [S] bits to skip at the
//        start (0..7), preds0 [S, 3] starting DC predictors.
//   Out: blocks [S, max_blocks, 64] int16, natural order, DC absolute
//        within the segment, every slot written by the kernel (the slots
//        from nblk[s] up as zeros): the caller need not clear them; bad
//        [S] uint8 corruption flags.
//
// What bounds it.  The function must move the rows, the LUT and the blocks
// once each, 13 MB for 2,048 segments of 48 blocks: a few microseconds at
// the card's memory rate.  A Huffman stream is serial, though: a symbol's
// position is known only when the one before it is decoded, so a segment
// is one chain of dependent steps, and the kernel lasts as long as the
// longest segment's chain: on the card about 220 cycles a step (a symbol,
// or a block's bookkeeping), some thirty instructions that a warp runs
// nearly one after the other.  Neither memory nor the table read paces it
// any more.  The design keeps every SM busy with chains and takes out of
// a step what does not belong to the chain:
//
//  * One warp per segment, kWarps segments per thread block.  All 32
//    threads carry the same decode state (window, bit count, word index,
//    zigzag position, predictors, flags), so every branch is uniform and a
//    warp ends when its own segment ends.  One thread carrying the state
//    would cost the same warp instructions and add a shuffle per use.
//  * The row in registers.  Each thread holds one word of the row's
//    current 32 words (one coalesced read per 128 bytes, the next 32
//    words prefetched beside it); a refill of the 64-bit window is a
//    __shfl_sync of that register.
//  * Short codes from shared memory.  At its start the block builds, from
//    the full LUT of its first segment's table set, a first-level table
//    indexed by the window's top kFirstBits bits: where a code of at most
//    kFirstBits bits matches the prefix (every window with that prefix
//    then holds the same LUT entry) that entry, split into the fields a
//    step uses (pack_entry), else 0.  A zero sends the symbol to the full
//    LUT (L1 and L2 caches) and splits its entry on the spot, as do all
//    symbols of a warp whose table set is not the block's: its reads of
//    the table are masked to zero.  Segments of one image are neighbours,
//    so such warps are rare, and a table per warp would not fit.  Which
//    prefixes the table answers is entropy_decode.first_level_table; the
//    CPU tests hold that rule to the full LUT on all 65,536 windows.
//  * A step without branches.  An entry says how many bits the symbol
//    takes, where its extra bits are and how far it moves the zigzag
//    position (an EOB: far past the block), so DC, AC, ZRL and EOB symbols
//    all run the same instructions; the run-past-the-block test is made
//    once per block on where the position ended.  Left are the refill,
//    the full-LUT read and the loop.
//  * Blocks written once, coalesced.  The current 8x8 block lives in two
//    registers per thread (natural positions 2t and 2t+1 of thread t); a
//    coefficient reaches its place by two compares with the thread's two
//    zigzag indices, and the finished block leaves with one 128-byte
//    store.  Slots past nblk[s] are stored as zeros, 16 bytes a thread.
//  * The block code is compiled once per component, so predictors and
//    table rows are fixed registers and addresses.
//
// Next would be several decoders per segment that start speculatively at
// later bits and resynchronise, or table entries that hold the decoded
// value of short symbols.  Times on the card are in PERF.md.
//
// Ending on corrupt input: every step consumes at least one bit or ends
// the block (an invalid window is read as 8 bits of a zero symbol, which
// writes the DC or ends the AC run as an EOB would), reads are clamped to
// the row's last word, and a segment whose word index passes Lw ends its
// block after the step, so no warp loops forever or reads outside its row.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 64;
constexpr int kWarps = 16;     // segments per thread block
constexpr int kFirstBits = 9;  // index bits of the first-level table
constexpr int kFirstSize = 1 << kFirstBits;
constexpr int kFirstShift = 32 - kFirstBits;
constexpr int kLutRow = 65536;
constexpr int kLutRows = 6;
constexpr unsigned kFullWarp = 0xFFFFFFFFu;

static_assert(kWarps >= 2 && kWarps <= 32, "2..32 warps per block");
static_assert(kFirstBits >= 1 && kFirstBits <= 10,
              "the first-level table must fit static shared memory");

// kZigzag[k] = natural (row-major) index of the k-th zigzag element.
__constant__ uint8_t kZigzag[kSlots] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// A LUT entry split into the fields a decode step uses, 32 bits, each
// where one instruction reads it:
//   bits 0..4   ln     code length (a shift by it takes it modulo 32)
//   bit  5      flag   the entry is not a baseline symbol: an invalid
//                      window (read as 8 bits of a zero symbol) or a DC
//                      symbol above 15 (read as category 0)
//   byte 1      krun   AC only: what the symbol adds to the zigzag
//                      position: run + 1, 16 for a ZRL, kEndOfBlock for an
//                      EOB
//   byte 2      total  bits the symbol takes: code length + extra bits
//   bits 26..31 sh     32 - number of extra bits, 17..32
// 0 is no entry: in the first-level table it means "read the full LUT".
constexpr uint32_t kFlag = 1u << 5;
constexpr int kEndOfBlock = 128;

__device__ __forceinline__ uint32_t pack_entry(int32_t e, bool ac) {
  int ln = e & 0xFF;
  int val = e >> 8;
  uint32_t flag = 0;
  if (e < 0) {
    ln = 8;
    val = 0;
    flag = kFlag;
  }
  int ncat, krun = 0;
  if (ac) {
    int run = val >> 4;
    if (run > 63) run = 63;  // past the block whatever kk is, like any > 62
    ncat = val & 15;
    krun = ncat ? run + 1 : (run == 15 ? 16 : kEndOfBlock);
  } else {
    if (val > 15) {
      val = 0;
      flag = kFlag;
    }
    ncat = val;
  }
  return static_cast<uint32_t>(ln & 31) | flag |
         static_cast<uint32_t>(krun) << 8 |
         static_cast<uint32_t>((ln + ncat) & 63) << 16 |
         static_cast<uint32_t>(32 - ncat) << 26;
}

__device__ __forceinline__ int entry_krun(uint32_t e) {
  return __byte_perm(e, 0, 0x4441);
}

__device__ __forceinline__ int entry_total(uint32_t e) {
  return __byte_perm(e, 0, 0x4442);
}

// The extra bits of the symbol with entry `e` in the window `hi`,
// sign-extended as in T.81 F.2.2.1; 0 when it has none.  Without a
// branch: with n = all ones where the first extra bit is 0, the magnitude
// is the extra bits XOR n, and the value the magnitude negated where n.
__device__ __forceinline__ int32_t extend(uint32_t hi, uint32_t e) {
  const uint32_t x = hi << (e & 31);
  const int32_t s = static_cast<int32_t>(x) >> 31;  // -1: first bit is 1
  const uint32_t mag = __funnelshift_rc(x ^ ~s, 0u, e >> 26);  // 32 gives 0
  return static_cast<int32_t>(mag ^ ~s) + s + 1;
}

// The bit reader of one segment, the same in all 32 threads of its warp
// but for `cur` and `nxt`: thread t holds word base + t of the row in
// `cur` and word base + 32 + t in `nxt` (indices clamped to the row's last
// word, as every read of the row is).
struct Reader {
  const uint32_t* row;
  int lw;
  int lane;
  uint64_t win;  // next stream bit = bit 63
  int navail;    // valid bits at the top of win
  int widx;      // words taken so far: counts refills, may pass lw
  int klimit;    // 64 while widx <= lw, then 0: a block's AC symbols end
                 // at zigzag position klimit
  int base;
  uint32_t cur, nxt;

  __device__ __forceinline__ uint32_t row_word(int i) const {
    return row[i < lw ? i : lw - 1];
  }

  __device__ __forceinline__ void open(const uint32_t* r, int n, int l) {
    row = r;
    lw = n;
    lane = l;
    win = 0;
    navail = 0;
    widx = 0;
    klimit = kSlots;
    base = 0;
    cur = row_word(lane);
    nxt = row_word(32 + lane);
  }

  // Takes one word into the window when fewer than 32 bits are left.  A
  // symbol takes at most 16 + 15 bits, so once per symbol is enough.
  __device__ __forceinline__ void refill() {
    if (navail < 32) {
      const int i = widx < lw ? widx : lw - 1;
      if (i >= base + 32) {  // widx grows by one: never past the next 32
        base += 32;
        cur = nxt;
        nxt = row_word(base + 32 + lane);
      }
      const uint32_t w = __shfl_sync(kFullWarp, cur, i - base);
      win |= static_cast<uint64_t>(w) << (32 - navail);
      navail += 32;
      if (++widx > lw) klimit = 0;
    }
  }

  __device__ __forceinline__ uint32_t top32() const {
    return static_cast<uint32_t>(win >> 32);
  }

  __device__ __forceinline__ void consume(int k) {  // k <= 31 <= navail
    win <<= k;
    navail -= k;
  }
};

// The thread block's first-level table, 6 rows of split entries.
__shared__ uint32_t first_tab[kLutRows * kFirstSize];
__shared__ uint8_t zigzag_of[kSlots];  // natural position -> zigzag index

// What one segment's decode carries from block to block, the same in all
// threads of the warp but for the two zigzag positions.
struct Segment {
  Reader rd;
  uint32_t use_first;     // all ones if first_tab is of this segment's
                          // table set, else 0
  const int32_t* lut;     // the segment's table set of the full LUT
  uint32_t flags;         // bit kFlag: the segment is corrupt
  int k0p, k1p;           // zigzag index + 1 of natural positions 2 * lane
                          // and 2 * lane + 1
  uint32_t* dst;          // this thread's word of the next block slot

  // The split entry of the window whose top 32 bits are `hi`, in LUT row
  // `r`: from the first-level table where it answers, else from the full
  // LUT.
  __device__ __forceinline__ uint32_t lookup(int r, uint32_t hi) const {
    const uint32_t p =
        first_tab[r * kFirstSize + (hi >> kFirstShift)] & use_first;
    if (p != 0) return p;
    return pack_entry(__ldg(lut + r * kLutRow + (hi >> 16)), r & 1);
  }

  // One 8x8 block of component kComp: decodes it, stores it, moves on.
  template <int kComp>
  __device__ __forceinline__ void decode_block(int32_t& pred) {
    // the DC symbol: natural position 0, the low half of thread 0
    rd.refill();
    uint32_t hi = rd.top32();
    uint32_t e = lookup(kComp * 2, hi);
    flags |= e;
    pred = static_cast<int32_t>(static_cast<uint32_t>(pred) +
                                static_cast<uint32_t>(extend(hi, e)));
    int32_t a0 = rd.lane == 0 ? pred : 0;  // the store cuts both to 16 bits
    int32_t a1 = 0;
    rd.consume(entry_total(e));

    // The AC symbols, one step each without a branch but the refill and
    // the full-LUT read: a symbol moves the zigzag position kk by krun
    // and puts its value (0 for a ZRL) at kk + krun - 1, which for an EOB
    // is no position at all.  kk only grows, so no position is written
    // twice.  The block ends past position 63 or when the row is used up.
    int kk = 1;
    while (kk < rd.klimit) {
      rd.refill();
      hi = rd.top32();
      e = lookup(kComp * 2 + 1, hi);
      flags |= e;
      const int32_t v = extend(hi, e);
      kk += entry_krun(e);
      if (kk == k0p) a0 = v;
      if (kk == k1p) a1 = v;
      rd.consume(entry_total(e));
    }
    // a coefficient or a ZRL's zeros went past position 63 (kk + run > 63,
    // kk + 15 > 63) exactly when kk ended above 64; an EOB ends far above
    if (kk > kSlots && kk < kEndOfBlock) flags = kFlag;
    *dst = __byte_perm(a0, a1, 0x5410);
    dst += 32;
  }
};

// (The second bound, one thread block per SM at the least, leaves ptxas
// the registers it wants: without it ptxas cut them to fit more blocks and
// spilled.)
__global__ void __launch_bounds__(kWarps * 32, 1)
decode_segments_kernel(const uint32_t* __restrict__ words,
                       const int32_t* __restrict__ nblk,
                       const int32_t* __restrict__ lut,
                       const int32_t* __restrict__ tsel,
                       const int32_t* __restrict__ rawlen,
                       const int32_t* __restrict__ skip0,
                       const int32_t* __restrict__ preds0,
                       int16_t* __restrict__ blocks,
                       uint8_t* __restrict__ bad_out,
                       long long nlanes, int lw, int ntab, int max_blocks) {
  const int lane = threadIdx.x & 31;
  const long long s0 = static_cast<long long>(blockIdx.x) * kWarps;
  const long long s = s0 + (threadIdx.x >> 5);
  const bool live = s < nlanes;  // whole warps

  // What does not wait for the tables: the segment's arguments, its row,
  // and the zeros of the slots it does not decode, 16 bytes a thread.
  Segment sg;
  sg.flags = 0;
  int ts = 0, nb = 0;
  if (live) {
    ts = tsel ? tsel[s] : 0;
    if (ts < 0 || ts >= ntab) {
      sg.flags = kFlag;
      ts = 0;
    }
    nb = nblk[s];
    if (nb > max_blocks) nb = max_blocks;
    if (nb < 0) nb = 0;
    sg.rd.open(words + s * lw, lw, lane);
    uint32_t* out =
        reinterpret_cast<uint32_t*>(blocks + s * max_blocks * kSlots);
    sg.dst = out + lane;
    uint4* tail = reinterpret_cast<uint4*>(out + nb * 32);
    const int n16 = (max_blocks - nb) * 8;
    for (int i = lane; i < n16; i += 32) tail[i] = make_uint4(0, 0, 0, 0);
  }

  // The block's first-level table: that of its first segment's table set.
  int block_ts = tsel ? tsel[s0] : 0;
  if (block_ts < 0 || block_ts >= ntab) block_ts = 0;
  if (threadIdx.x < kSlots) zigzag_of[kZigzag[threadIdx.x]] = threadIdx.x;
  const int32_t* src =
      lut + static_cast<size_t>(block_ts) * kLutRows * kLutRow;
  for (int i = threadIdx.x; i < kLutRows * kFirstSize; i += kWarps * 32) {
    const int r = i >> kFirstBits;
    const int p = i & (kFirstSize - 1);
    const int32_t e = __ldg(src + r * kLutRow + (p << (16 - kFirstBits)));
    const int ln = e & 0xFF;
    const uint32_t packed = pack_entry(e, r & 1);
    first_tab[i] = (e > 0 && e < 65536 && ln >= 1 && ln <= kFirstBits &&
                    !(packed & kFlag))
                       ? packed
                       : 0u;
  }
  __syncthreads();
  if (!live) return;  // after the only barrier

  sg.use_first = ts == block_ts ? 0xFFFFFFFFu : 0u;
  sg.lut = lut + static_cast<size_t>(ts) * kLutRows * kLutRow;
  sg.k0p = zigzag_of[2 * lane] + 1;
  sg.k1p = zigzag_of[2 * lane + 1] + 1;

  if (skip0) {
    sg.rd.refill();
    sg.rd.consume(skip0[s] & 7);
  }
  int32_t p0 = 0, p1 = 0, p2 = 0;
  if (preds0) {
    p0 = preds0[3 * s];
    p1 = preds0[3 * s + 1];
    p2 = preds0[3 * s + 2];
  }

  // Block slot b holds component Y, Y, Y, Y, Cb, Cr by b % 6.
  for (int b = 0; b < nb; b += 6) {
    const int left = nb - b;
    const int ny = left < 4 ? left : 4;
#pragma unroll 1
    for (int j = 0; j < ny; ++j) sg.decode_block<0>(p0);
    if (left > 4) sg.decode_block<1>(p1);
    if (left > 5) sg.decode_block<2>(p2);
  }
  if (rawlen) {
    // a valid segment's last payload bit lies in its last destuffed byte
    const long long consumed = 32LL * sg.rd.widx - sg.rd.navail;
    const long long exp = 8LL * rawlen[s];
    if (consumed > exp || consumed <= exp - 8) sg.flags = kFlag;
  }
  if (lane == 0) bad_out[s] = (sg.flags & kFlag) ? 1 : 0;
}

}  // namespace

extern "C" {

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError(): 0 on success.  Does not synchronise.  tsel, rawlen,
// skip0 and preds0 may be null.  `blocks` must be 16-byte aligned.
int jz_decode_segments(const void* words, const void* nblk, const void* lut,
                       const void* tsel, const void* rawlen,
                       const void* skip0, const void* preds0, void* blocks,
                       void* bad, long long nlanes, int lw, int ntab,
                       int max_blocks, void* stream) {
  if (nlanes <= 0 || max_blocks <= 0) return 0;
  if (lw <= 0 || ntab <= 0 || reinterpret_cast<uintptr_t>(blocks) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = (nlanes + kWarps - 1) / kWarps;
  if (grid > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  decode_segments_kernel<<<static_cast<unsigned>(grid), kWarps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(nblk),
      static_cast<const int32_t*>(lut), static_cast<const int32_t*>(tsel),
      static_cast<const int32_t*>(rawlen), static_cast<const int32_t*>(skip0),
      static_cast<const int32_t*>(preds0), static_cast<int16_t*>(blocks),
      static_cast<uint8_t*>(bad), nlanes, lw, ntab, max_blocks);
  return static_cast<int>(cudaGetLastError());
}

// The layout this library was compiled with: segments (warps) per thread
// block, index bits of the first-level table, and the thread blocks one SM
// holds at a time (0 if the occupancy query fails).
int jz_scan_warps_per_block() { return kWarps; }
int jz_scan_first_level_bits() { return kFirstBits; }
int jz_scan_blocks_per_sm() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, decode_segments_kernel, kWarps * 32, 0) != cudaSuccess)
    return 0;
  return n;
}

const char* jz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

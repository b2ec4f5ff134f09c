// A tried design of the Huffman scan for Hopper (sm_90a) that the package
// does not use: it takes the table lookups off the symbol chain.  Same
// function, with the same C interface, as the package's kernel
// (jpezy_tpu_torch/csrc/huffman_scan.cu): bit for bit
// jpezy_tpu_torch/ops/entropy_decode.py:decode_segments_plain, on valid
// and on corrupt input.  scripts/previous_designs.py builds it
// (decode_segments_grid) so that chip_smoke.py phase 9 and
// scripts/scan_phases.py time it in turns with the package's kernel on the
// same inputs.  It is faster on dense rows (noise at quality 100, quality
// 95 with restart markers) and slower on the sparse segments of the
// restart, indexed and optimize paths, so the package keeps the
// single-chain kernel; PERF.md has the readings.
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
// once each, 14 MB for 2,048 segments of 48 blocks: a few microseconds at
// the card's memory rate.  A Huffman stream is serial, though: a symbol's
// position is known only when the one before it is decoded, so a segment
// is one chain of dependent steps and the kernel lasts at least as long as
// the longest segment's chain.  The package's kernel puts the whole
// decode on that chain: refill the window, index the table with it, split
// the entry, shift the window by the symbol's bits, about 300 cycles a
// symbol on the card.  What a
// symbol starting at bit b decodes to, in table row r, depends on the
// stream's bits and r alone, not on the chain, so this kernel takes the
// lookups off the chain:
//
//  * One warp per segment, kWarps segments per thread block, all 32
//    threads carrying the same walk state: every branch of the walk is
//    uniform and a warp ends when its own segment ends.
//  * The block's tables.  Each thread block builds, from the LUT of its
//    first segment's table set, a first-level table indexed by a window's
//    top kFirstBits bits (the LUT entry split into the fields the walk
//    uses, where a code of at most kFirstBits bits matches the prefix;
//    entropy_decode.first_level_table is its rule) and, for the other
//    prefixes while kPoolSlots last, a subtable of split entries by the
//    next kSubBits bits; what neither answers reads the full LUT in the L1
//    and L2 caches, as every lookup of a warp whose table set is another
//    does.  Where Cr's tables are Cb's (the standard tables and most
//    others), Cr blocks use Cb's rows.
//  * A grid of decoded entries.  The stream is cut into chunks of kChunk
//    bit offsets.  For a chunk, the warp's 32 lanes each take the offsets
//    b = c0 + 32 i + lane, form the 32 stream bits from b with one funnel
//    shift of two neighbouring words of the row (held in the warp's
//    registers, one word a thread, and handed round by a shuffle), look
//    them up in each table row the walk can reach there, and store the
//    split entry with the symbol's value into the warp's grid in shared
//    memory: grid[r][b - c0].  A chunk is built for the rows its
//    predecessor used if blocks started there (sparse data: the four or
//    six rows), else for the current block's AC row alone (dense data,
//    where a block spans a thousand bits of one row); a row the walk finds
//    missing is built on the spot with its component's other row.
//  * The walk.  In a run of AC symbols the chain is one shared load and
//    two adds a symbol: the entry after a symbol is read as soon as its
//    position is known, before the branches that decide whether it is
//    needed (ld_ahead), into the register the next step reads (the run is
//    unrolled by two).  A block's DC symbol, its first AC symbol and the
//    next block's DC entry are read the same way.  The zigzag position,
//    the coefficient's place and the flags hang off the chain.  The
//    current 8x8 block lives in two registers per thread (natural
//    positions 2t and 2t+1 of thread t); a coefficient reaches its place by
//    two compares with the thread's two zigzag indices, and the finished
//    block leaves with one 128-byte store.  Slots past nblk[s] are stored
//    as zeros, 16 bytes a thread.
//  * The build is synchronous within the warp; the other warps of the SM
//    walk meanwhile, so their chains hide its latency.
//
// On the card (PERF.md, scripts/scan_phases.py) dense data gains: a run of
// AC symbols costs about 80 cycles a symbol with the builds counted apart,
// against the package kernel's 300.  Sparse data does not: a block of a DC,
// one AC symbol and an EOB spends most of its time in the branches and
// bookkeeping between its three loads, a chunk's four rows cost as much as
// the walk over it, and the block's tables take a few microseconds to
// gather before any segment starts.
//
// Ending on corrupt input: every symbol is decoded from the grid as the
// package's kernel reads it (an invalid window is read as 8 bits of a zero
// symbol, which writes the DC or ends the AC run as an EOB would; a DC
// category above 15 as category 0); reads of the row are clamped to its
// last word; a symbol that starts past the row's last word ends its block
// (the package kernel's word count passing Lw); each AC step raises the
// zigzag position by at least one, so no warp loops forever and no read
// leaves the row or the grid.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 64;
constexpr int kWarps = 16;       // segments per thread block
constexpr int kFirstBits = 9;    // index bits of the first-level table
constexpr int kFirstSize = 1 << kFirstBits;
constexpr int kFirstShift = 32 - kFirstBits;
constexpr int kLutRow = 65536;
constexpr int kRows = 6;
constexpr int kChunkWords = 4;   // a chunk: 32 * kChunkWords bit offsets
constexpr int kChunk = 32 * kChunkWords;
constexpr int kRowBytes = kChunk * 4;              // one row of a grid
constexpr int kGridBytes = kRows * kRowBytes;      // one warp's grid
constexpr int kTableBytes = kRows * kFirstSize * 4;
constexpr int kSubBits = 16 - kFirstBits;  // index bits of a subtable
constexpr int kSubSize = 1 << kSubBits;
constexpr int kPoolSlots = 32;   // subtables of the second level
constexpr int kGridBase = kTableBytes + kPoolSlots * kSubSize * 4;
constexpr int kPadBytes = 128;   // past the last grid: a read ahead's reach
constexpr int kSmemBytes = kGridBase + kWarps * kGridBytes + kPadBytes;
constexpr unsigned kFullWarp = 0xFFFFFFFFu;

static_assert(kWarps >= 2 && kWarps <= 32, "2..32 warps per block");
static_assert(kFirstBits >= 1 && kFirstBits <= 10, "a small first table");
// a symbol takes at most 31 bits, so it leaves a chunk for the next one at
// most; the row window of 64 words holds a chunk's words
static_assert(kChunkWords >= 1 && kChunkWords <= 16, "1..16 words a chunk");

// kZigzag[k] = natural (row-major) index of the k-th zigzag element.
__constant__ uint8_t kZigzag[kSlots] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// A LUT entry split into the fields the build and the walk use, 32 bits:
//   byte 0   total * 4 | flag << 7: total = code length + extra bits (the
//            symbol's bits, at most 31), times 4 the step of a grid
//            position in bytes; flag: the entry is not a baseline symbol,
//            an invalid window (read as 8 bits of a zero symbol) or a DC
//            symbol above 15 (read as category 0)
//   byte 1   krun, AC only: what the symbol adds to the zigzag position:
//            run + 1, 16 for a ZRL, kEndOfBlock for an EOB or an invalid
//            window
//   byte 2   code length (a shift by it takes it modulo 32)
//   byte 3   32 - number of extra bits, 17..32
// In the first-level table, an entry whose byte 0 is 0 is no split entry:
// its bits 8.. index the prefix's subtable in the pool (0: subtable 0, all
// zeros, where the lookup reads the full LUT).  A grid entry keeps bytes
// 0 and 1 and holds the symbol's value (the extra bits sign-extended, at
// most 15 bits and a sign) in bytes 2 and 3.
constexpr uint32_t kFlag = 1u << 7;
constexpr uint32_t kStep = 0x7Cu;  // byte 0 without the flag
constexpr int kEndOfBlock = 128;

__device__ __forceinline__ uint32_t split_entry(int32_t e, bool ac) {
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
  return static_cast<uint32_t>(((ln + ncat) & 31) << 2) | flag |
         static_cast<uint32_t>(krun) << 8 |
         static_cast<uint32_t>(ln & 31) << 16 |
         static_cast<uint32_t>(32 - ncat) << 24;
}

// The value of the symbol with split entry `s` whose window is `hi`: its
// extra bits, sign-extended as in T.81 F.2.2.1; 0 when it has none.
// Without a branch: with n = all ones where the first extra bit is 0, the
// magnitude is the extra bits XOR n, and the value the magnitude negated
// where n.
__device__ __forceinline__ int32_t extend(uint32_t hi, uint32_t s) {
  const uint32_t x = __funnelshift_l(0u, hi, s >> 16);  // hi << code length
  const int32_t n = static_cast<int32_t>(x) >> 31;      // -1: first bit 1
  const uint32_t mag = __funnelshift_rc(x ^ ~n, 0u, s >> 24);  // 32 gives 0
  return static_cast<int32_t>(mag ^ ~n) + n + 1;
}

__device__ __forceinline__ int entry_krun(uint32_t g) {
  return __byte_perm(g, 0, 0x4441);
}

// Shared memory: the thread block's first-level table (kRows rows of
// split entries), its second-level tables (kPoolSlots subtables of
// kSubSize split entries: the windows of one prefix that the first level
// does not answer, by their next kSubBits bits; subtable 0 all zeros),
// then each warp's grid (kRows rows of kChunk grid entries, row r at byte
// r * kRowBytes) and kPadBytes that the walk's read ahead may touch.
extern __shared__ __align__(16) unsigned char scan_smem[];
__shared__ uint8_t zigzag_of[kSlots];    // natural position -> zigzag index
__shared__ int pool_used;                // subtables handed out
__shared__ int16_t pool_src[kPoolSlots]; // first-level index of each
__shared__ int cr_differs;               // Cr's tables are not Cb's

// Whether a warp reads Cb's grid rows for Cr blocks: its table set is the
// block's, whose Cr tables are Cb's.
__device__ __forceinline__ bool use_cb_rows(bool block_set) {
  return block_set && !cr_differs;
}

// x, as a value the compiler must keep in a register (it would otherwise
// compute the grid's addresses again from the thread index in the walk)
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ uint32_t lds(int byte) {
  return *reinterpret_cast<const uint32_t*>(scan_smem + byte);
}

// A read ahead of the walk: issued where it stands, before the branch that
// decides whether its entry is needed (a volatile load is neither sunk
// into that branch nor dropped), so that its latency overlaps the current
// symbol's.  It may read the entry past a chunk's last one: the grid is
// followed by kPadBytes.
__device__ __forceinline__ uint32_t ld_ahead(int byte) {
#if defined(__CUDA_ARCH__)
  uint32_t v;
  asm volatile("ld.volatile.shared.u32 %0, [%1];"
               : "=r"(v)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(
                         scan_smem)) + byte));
  return v;
#else
  return lds(byte);
#endif
}

// One segment's decode: the same in all threads of its warp but for the
// row words, the lane's grid entries and the two zigzag positions.
struct Segment {
  const uint32_t* row;
  const int32_t* lut;  // the segment's table set of the full LUT
  int lw;
  int lane;
  uint32_t use_first;  // all ones if the block's tables are of this
                       // segment's table set, else 0
  int base;            // the words of the row in registers: thread t holds
  uint32_t cur, nxt;   // word base + t in cur and base + 32 + t in nxt
  // Positions are byte addresses in shared memory in the frame of the
  // grid's row 0: grid + 4 * (p - c0) for stream bit p.
  int grid;            // byte address of the warp's grid
  int qend;            // grid + kRowBytes: the chunk's end
  int qlim;            // a symbol whose position is past qlim starts after
                       // bit 32 (Lw - 1) and ends its block
  int stop;            // min(qend, qlim + 4): a run of AC symbols stops
                       // where the next one is not in this chunk or is last
  int c0;              // the chunk's first bit, a multiple of kChunk
  uint32_t have;       // grid rows built for this chunk
  uint32_t used;       // rows the walk has read in this chunk
  int starts;          // blocks that started in this chunk
  uint32_t flags;      // bit kFlag: the segment is corrupt
  int q;               // the next symbol's position
  int k0p, k1p;        // zigzag index + 1 of natural positions 2 * lane
                       // and 2 * lane + 1
  uint32_t* dst;       // this thread's word of the next block slot

  __device__ __forceinline__ uint32_t row_word(int i) const {
    return row[i < lw ? i : lw - 1];
  }

  // Word k of the stream (the row's word min(k, Lw - 1)), in every thread;
  // k - base < 64 (build keeps it so).
  __device__ __forceinline__ uint32_t word(int k) const {
    const int i = (k < lw ? k : lw - 1) - base;
    return __shfl_sync(kFullWarp, i < 32 ? cur : nxt, i & 31);
  }

  __device__ __forceinline__ void set_limit() {
    int rel = 32 * (lw - 1) - c0;  // the launcher bounds both
    if (rel > kChunk) rel = kChunk;
    if (rel < -1) rel = -1;
    qlim = grid + 4 * rel;
    stop = qend < qlim + 4 ? qend : qlim + 4;
  }

  // The split entry of window hi in row r from the block's tables: the
  // first level, where that points to a subtable the subtable (a
  // predicated load, no branch); 0 where neither answers.
  __device__ __forceinline__ uint32_t lookup(int r, uint32_t hi) const {
    uint32_t s = lds((r * kFirstSize + (hi >> kFirstShift)) * 4) & use_first;
    if ((s & 0xFFu) == 0)
      s = lds(kTableBytes + ((s >> 8) + ((hi >> 16) & (kSubSize - 1))) * 4);
    return s;
  }

  // The split entry of window hi in row r from the full LUT.
  __device__ __forceinline__ uint32_t lookup_lut(int r, uint32_t hi) const {
    return split_entry(__ldg(lut + r * kLutRow + (hi >> 16)), r & 1);
  }

  // Fills the grid rows in `rows` for the chunk at c0.  Each lane takes the
  // offsets c0 + 32 i + lane; a lookup reads the first-level table, where
  // that points to a subtable the subtable, and where neither answers (a
  // long code without a subtable, every window of a warp whose table set
  // is not its block's) the full LUT.
  __device__ __forceinline__ void build(uint32_t rows) {
    __syncwarp();  // every thread's reads of the grid are done
    const int k0 = c0 >> 5;
    const int first = k0 < lw ? k0 : lw - 1;
    if (first >= base + 32) {  // c0 grows by at most 16 words a chunk
      base += 32;
      cur = nxt;
      nxt = row_word(base + 32 + lane);
    }
    uint32_t hi[kChunkWords];
    uint32_t w = word(k0);
#pragma unroll
    for (int i = 0; i < kChunkWords; ++i) {
      const uint32_t w1 = word(k0 + i + 1);
      hi[i] = __funnelshift_l(w1, w, lane);  // stream bits c0 + 32 i + lane..
      w = w1;
    }
    const int at = grid + 4 * lane;
#pragma unroll 1
    for (uint32_t m = rows; m != 0; m &= m - 1) {
      const int r = __ffs(m) - 1;
      uint32_t s[kChunkWords];
      bool miss = false;
#pragma unroll
      for (int i = 0; i < kChunkWords; ++i) {
        s[i] = lookup(r, hi[i]);
        miss |= s[i] == 0;
      }
      if (__any_sync(kFullWarp, miss)) {
#pragma unroll
        for (int i = 0; i < kChunkWords; ++i)
          if (s[i] == 0) s[i] = lookup_lut(r, hi[i]);
      }
#pragma unroll
      for (int i = 0; i < kChunkWords; ++i)
        *reinterpret_cast<uint32_t*>(scan_smem + at + r * kRowBytes +
                                     128 * i) =
            __byte_perm(s[i], static_cast<uint32_t>(extend(hi[i], s[i])),
                        0x5410);
    }
    __syncwarp();
  }

  // Makes the grid hold row r at position `at` and returns the position: in
  // the next chunk when `at` has left this one (a symbol takes fewer bits
  // than a chunk holds), with the row (and its component's other row)
  // built when this chunk lacks it.
  __device__ __forceinline__ int ensure(int r, int at) {
    const uint32_t bit = 1u << r;
    if (at >= qend || !(have & bit)) {
      uint32_t rows;
      if (at >= qend) {
        c0 += kChunk;
        at -= kRowBytes;
        set_limit();
        // a chunk in which blocks started needs its rows again (sparse
        // data); else the walk stays in one block's AC row (dense data)
        rows = bit;
        if (starts > 1) rows |= used;
        have = 0;
        used = 0;
        starts = 0;
      } else {
        rows = (3u << (r & ~1)) & ~have;
      }
      build(rows);
      have |= rows;
    }
    used |= bit;
    return at;
  }

  // One 8x8 block of component kComp whose DC entry g lies at q: decodes
  // it, stores it, and returns the next block's DC entry (of component
  // ncomp, at the new q) when `more`.  A symbol moves the zigzag position
  // kk by krun and puts its value (0 for a ZRL) at kk + krun - 1, which
  // for an EOB is no position at all; kk only grows, so no position is
  // written twice.  Each entry is read as soon as its position is known,
  // before the branches that decide whether it is needed; where a chunk
  // ends or a row is missing it is read again after the build.
  template <int kComp>
  __device__ __forceinline__ uint32_t block(uint32_t g, int ncomp,
                                            int32_t& pred, bool more) {
    constexpr int kAc = 2 * kComp + 1;
    constexpr int kAcOff = kAc * kRowBytes;
    // the DC symbol: natural position 0, thread 0's low half
    ++starts;
    flags |= g;
    pred = static_cast<int32_t>(
        static_cast<uint32_t>(pred) +
        static_cast<uint32_t>(static_cast<int32_t>(g) >> 16));
    int32_t a0 = lane == 0 ? pred : 0;  // the store cuts both to 16 bits
    int32_t a1 = 0;
    int kk = 1;
    const bool last = q > qlim;  // it starts past the row's last word
    q += static_cast<int>(g & kStep);
    const int ndc = 2 * ncomp;
    bool ahead = false;  // gd holds the entry at q in the next DC row
    uint32_t gd = 0;
    if (!last) {
      uint32_t ga = ld_ahead(q + kAcOff);  // the entry at q in the AC row
      // the first AC symbol (of a sparse block often its EOB) before the
      // run's loop
      if (q < qend && (have >> kAc & 1u) && q <= qlim) {
        used |= 1u << kAc;
        q += static_cast<int>(ga & kStep);
        kk += entry_krun(ga);
        const int32_t v = static_cast<int32_t>(ga) >> 16;
        if (kk == k0p) a0 = v;
        if (kk == k1p) a1 = v;
        flags |= ga;
        if (kk >= kSlots) {
          gd = ld_ahead(q + ndc * kRowBytes);  // the next block's DC entry
          ahead = true;
        } else {
          ga = ld_ahead(q + kAcOff);
        }
      }
      while (kk < kSlots) {
        if (q >= qend || !(have >> kAc & 1u)) {
          q = ensure(kAc, q);
          ga = lds(q + kAcOff);
        } else {
          used |= 1u << kAc;
        }
        if (q > qlim) {  // the block's last symbol
          q += static_cast<int>(ga & kStep);
          kk += entry_krun(ga);
          const int32_t v = static_cast<int32_t>(ga) >> 16;
          if (kk == k0p) a0 = v;
          if (kk == k1p) a1 = v;
          flags |= ga;
          break;
        }
        // A run of AC symbols, unrolled by two so that each entry read
        // ahead lands in the register the next step reads: the chain is
        // one shared load and two adds a symbol.
        const int qstop = stop + kAcOff;
        int qa = q + kAcOff;
        uint32_t g0 = ga, g1;
        while (true) {
          int qn = qa + static_cast<int>(g0 & kStep);
          g1 = ld_ahead(qn);
          kk += entry_krun(g0);
          int32_t v = static_cast<int32_t>(g0) >> 16;
          if (kk == k0p) a0 = v;
          if (kk == k1p) a1 = v;
          flags |= g0;
          qa = qn;
          if (kk >= kSlots || qa >= qstop) break;
          qn = qa + static_cast<int>(g1 & kStep);
          g0 = ld_ahead(qn);
          kk += entry_krun(g1);
          v = static_cast<int32_t>(g1) >> 16;
          if (kk == k0p) a0 = v;
          if (kk == k1p) a1 = v;
          flags |= g1;
          qa = qn;
          if (kk >= kSlots || qa >= qstop) break;
        }
        q = qa - kAcOff;
        if (kk >= kSlots) {
          gd = ld_ahead(q + ndc * kRowBytes);  // the next block's DC entry
          ahead = true;
          break;
        }
        ga = lds(qa);  // the chunk ends, or the next symbol is the last
      }
    }
    // The block ends: past position 63, or with a symbol that starts past
    // the row's last word.  An invalid window ends it (and is or-ed into
    // the flags); a coefficient or a ZRL's zeros went past position 63
    // (kk + run > 63, kk + 15 > 63) exactly when kk ended above 64; an EOB
    // ends far above.  It leaves in one 128-byte store.
    if (kk > kSlots && kk < kEndOfBlock) flags |= kFlag;
    *dst = __byte_perm(a0, a1, 0x5410);
    dst += 32;
    if (!more) return 0;
    if (ahead && q < qend && (have >> ndc & 1u)) {
      used |= 1u << ndc;
      return gd;
    }
    q = ensure(ndc, q);
    return lds(q + ndc * kRowBytes);
  }
};

// (The second bound, one thread block per SM at the least, leaves ptxas
// the registers it wants.)
__global__ void __launch_bounds__(kWarps * 32, 1)
decode_segments_grid_kernel(const uint32_t* __restrict__ words,
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
  const int warp = threadIdx.x >> 5;
  const long long s0 = static_cast<long long>(blockIdx.x) * kWarps;
  const long long s = s0 + warp;
  const bool live = s < nlanes;  // whole warps

  // What does not wait for the tables: the segment's arguments, its row,
  // and the zeros of the slots it does not decode, 16 bytes a thread.
  Segment sg;
  sg.flags = 0;
  int ts = 0, nb = 0;
  uint32_t* dst = nullptr;  // this thread's word of the next block slot
  if (live) {
    ts = tsel ? tsel[s] : 0;
    if (ts < 0 || ts >= ntab) {
      sg.flags = kFlag;
      ts = 0;
    }
    nb = nblk[s];
    if (nb > max_blocks) nb = max_blocks;
    if (nb < 0) nb = 0;
    sg.row = words + s * lw;
    sg.lw = lw;
    sg.lane = lane;
    sg.base = 0;
    sg.cur = sg.row_word(lane);
    sg.nxt = sg.row_word(32 + lane);
    uint32_t* out =
        reinterpret_cast<uint32_t*>(blocks + s * max_blocks * kSlots);
    dst = out + lane;
    uint4* tail = reinterpret_cast<uint4*>(out + nb * 32);
    const int n16 = (max_blocks - nb) * 8;
    for (int i = lane; i < n16; i += 32) tail[i] = make_uint4(0, 0, 0, 0);
  }

  // The block's tables, of its first segment's table set: the first level
  // (where a code of at most kFirstBits bits matches the prefix, every
  // window with that prefix holds the same LUT entry), and a subtable for
  // each other prefix while they last (a typical table has a few).
  int block_ts = tsel ? tsel[s0] : 0;
  if (block_ts < 0 || block_ts >= ntab) block_ts = 0;
  if (threadIdx.x < kSlots) zigzag_of[kZigzag[threadIdx.x]] = threadIdx.x;
  if (threadIdx.x == 0) {
    pool_used = 1;  // subtable 0: zeros
    cr_differs = 0;
  }
  __syncthreads();
  const int32_t* src =
      lut + static_cast<size_t>(block_ts) * kRows * kLutRow;
  uint32_t* first_tab = reinterpret_cast<uint32_t*>(scan_smem);
  uint32_t* pool = reinterpret_cast<uint32_t*>(scan_smem + kTableBytes);
  // Two passes: the first level and a subtable slot for each other
  // prefix, then the subtables, every thread's loads at once.  Most streams
  // code Cb and Cr with the same tables: then the Cr blocks read Cb's grid
  // rows and a chunk needs four rows, not six.  The second pass holds Cr's
  // entries (rows 4, 5) to Cb's (rows 2, 3), the first level in shared
  // memory and the subtables' windows in the LUT: equal split entries
  // decode alike; a prefix left to the full LUT counts as a difference.
  for (int i = threadIdx.x; i < kRows * kFirstSize; i += kWarps * 32) {
    const int r = i >> kFirstBits;
    const int at = r * kLutRow + ((i & (kFirstSize - 1)) << kSubBits);
    const int32_t e = __ldg(src + at);
    const int ln = e & 0xFF;
    const uint32_t split = split_entry(e, r & 1);
    uint32_t put = 0;  // subtable 0: the full LUT
    if (e > 0 && e < 65536 && ln >= 1 && ln <= kFirstBits &&
        !(split & kFlag)) {
      put = split;
    } else {
      const int slot = atomicAdd(&pool_used, 1);
      if (slot < kPoolSlots) {
        pool_src[slot] = static_cast<int16_t>(i);
        put = static_cast<uint32_t>(slot * kSubSize) << 8;
      } else if (r >= 4) {
        cr_differs = 1;
      }
    }
    first_tab[i] = put;
  }
  __syncthreads();
  for (int i = 4 * kFirstSize + threadIdx.x; i < kRows * kFirstSize;
       i += kWarps * 32) {
    const uint32_t a = first_tab[i], b = first_tab[i - 2 * kFirstSize];
    // two subtables are compared entry by entry below
    if ((a & 0xFFu) || (b & 0xFFu) || a == 0 || b == 0 ? a != b || a == 0
                                                          : false)
      cr_differs = 1;
  }
  const int nsub = pool_used < kPoolSlots ? pool_used : kPoolSlots;
  for (int k = threadIdx.x; k < nsub * kSubSize; k += kWarps * 32) {
    const int slot = k >> kSubBits;
    uint32_t put = 0;
    if (slot > 0) {
      const int i = pool_src[slot];
      const int r = i >> kFirstBits;
      const int at = r * kLutRow +
                     ((i & (kFirstSize - 1)) << kSubBits) + (k & (kSubSize - 1));
      put = split_entry(__ldg(src + at), r & 1);
      if (r >= 4 &&
          put != split_entry(__ldg(src + at - 2 * kLutRow), r & 1))
        cr_differs = 1;
    }
    pool[k] = put;
  }
  __syncthreads();
  if (!live) return;  // after the last barrier

  sg.use_first = ts == block_ts ? 0xFFFFFFFFu : 0u;
  sg.lut = lut + static_cast<size_t>(ts) * kRows * kLutRow;
  sg.grid = opaque(kGridBase + warp * kGridBytes);
  sg.qend = opaque(sg.grid + kRowBytes);
  sg.c0 = 0;
  sg.set_limit();
  sg.used = 0;
  sg.starts = 0;
  sg.have = 0;
  sg.k0p = zigzag_of[2 * lane] + 1;
  sg.k1p = zigzag_of[2 * lane + 1] + 1;
  sg.dst = dst;
  sg.q = sg.grid + (skip0 ? 4 * (skip0[s] & 7) : 0);
  int32_t p0 = 0, p1 = 0, p2 = 0;
  if (preds0) {
    p0 = preds0[3 * s];
    p1 = preds0[3 * s + 1];
    p2 = preds0[3 * s + 2];
  }

  // The walk: block slot b holds component Y, Y, Y, Y, Cb, Cr by b % 6.
  const bool alias = use_cb_rows(ts == block_ts);
  if (nb > 0) {
    const uint32_t rows0 = 0x03u | (nb > 4 ? 0x0Cu : 0u) |
                           (nb > 5 && !alias ? 0x30u : 0u);
    sg.build(rows0);
    sg.have = rows0;
    sg.used = 1u;
    uint32_t g = lds(sg.q);  // block 0's DC entry
    int b = 0;
#pragma unroll 1
    while (true) {
#pragma unroll 1
      for (int y = 0; y < 4; ++y) {
        ++b;
        g = sg.block<0>(g, y < 3 ? 0 : 1, p0, b < nb);
        if (b >= nb) break;
      }
      if (b >= nb) break;
      ++b;
      g = sg.block<1>(g, alias ? 1 : 2, p1, b < nb);
      if (b >= nb) break;
      ++b;
      g = alias ? sg.block<1>(g, 0, p2, b < nb)
                : sg.block<2>(g, 0, p2, b < nb);
      if (b >= nb) break;
    }
  }
  if (rawlen) {
    // a valid segment's last payload bit lies in its last destuffed byte
    const long long consumed = sg.c0 + ((sg.q - sg.grid) >> 2);
    const long long exp = 8LL * rawlen[s];
    if (consumed > exp || consumed <= exp - 8) sg.flags = kFlag;
  }
  if (lane == 0) bad_out[s] = (sg.flags & kFlag) ? 1 : 0;
}

// Lets the kernel take kSmemBytes of dynamic shared memory (above the
// default 48 KB), once a process.
cudaError_t allow_smem() {
  static cudaError_t e = cudaFuncSetAttribute(
      decode_segments_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  return e;
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
  // the walk counts stream bits in an int: a block takes at most 64
  // symbols of at most 31 bits, the reads past the row stop at its end
  if (lw <= 0 || ntab <= 0 || 32LL * lw + 2048LL * max_blocks >= (1LL << 30) ||
      reinterpret_cast<uintptr_t>(blocks) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = (nlanes + kWarps - 1) / kWarps;
  if (grid > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaError_t e = allow_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  decode_segments_grid_kernel<<<static_cast<unsigned>(grid), kWarps * 32,
                           kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(nblk),
      static_cast<const int32_t*>(lut), static_cast<const int32_t*>(tsel),
      static_cast<const int32_t*>(rawlen), static_cast<const int32_t*>(skip0),
      static_cast<const int32_t*>(preds0), static_cast<int16_t*>(blocks),
      static_cast<uint8_t*>(bad), nlanes, lw, ntab, max_blocks);
  return static_cast<int>(cudaGetLastError());
}

// The layout this library was compiled with: segments (warps) per thread
// block, index bits of the first-level table, bit offsets of a chunk of the
// grid, shared bytes a thread block, and what the card reports: registers
// a thread and the thread blocks one SM holds at a time (0 if a query
// fails).
int jz_scan_warps_per_block() { return kWarps; }
int jz_scan_first_level_bits() { return kFirstBits; }
int jz_scan_chunk_bits() { return kChunk; }
int jz_scan_shared_bytes() {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, decode_segments_grid_kernel) != cudaSuccess)
    return 0;
  return static_cast<int>(attr.sharedSizeBytes) + kSmemBytes;
}
int jz_scan_registers() {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, decode_segments_grid_kernel) != cudaSuccess)
    return 0;
  return attr.numRegs;
}
int jz_scan_blocks_per_sm() {
  int n = 0;
  if (allow_smem() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, decode_segments_grid_kernel, kWarps * 32, kSmemBytes) != cudaSuccess)
    return 0;
  return n;
}

const char* jz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

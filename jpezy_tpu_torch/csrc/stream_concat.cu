// Batched stream concat for Hopper (sm_90a): each image's packed 8x8
// blocks, bit offset by bit offset, into one JPEG entropy stream.
//
// Replaces the stream concat that XLA fused behind the Pallas pack on the
// TPU: jpezy_tpu/codec/jax_codec.py:_concat_batch_combined_comp, with
// jpezy_tpu/ops/entropy.py:stream_offsets_batch,
// stream_offsets_restart_batch and _concat_batch_scatter.  Same function,
// bit for bit, as jpezy_tpu_torch/ops/entropy.py:concat_streams_plain.
//
//   In:  per component c (Y, Cb, Cr) words_c [N, B_c, 64] 32-bit words
//        (the packed block bitstring, MSB-first, zero past the block's
//        bits: what jz_encode_blocks_batch writes) and bits_c [N, B_c]
//        int32, B_Y = 4 nm, B_Cb = B_Cr = nm
//        for nm MCUs an image; restart_interval ri (0: none); maxw.
//   Out: combined [N, 1 + S + maxw] int64: the image's total bits, then
//        with restarts the S = ceil(nm / ri) segments' bit counts, then
//        the stream, maxw words; words past maxw are dropped (the caller
//        finds the overflow in the total).
//
// The stream holds the blocks in MCU order (Y0..Y3, Cb, Cr per MCU); the
// blocks stay in component order in memory and the kernel finds a block's
// place by index arithmetic.  With restarts each segment of ri MCUs starts
// on a byte boundary: the (8 - seg_bits % 8) % 8 bits that round segment
// s up are inserted before segment s + 1, and after the last segment for
// the total.  Since every segment starts on a byte boundary, rounding the
// running bit offset up to a multiple of 8 at each segment's first MCU
// inserts exactly that padding.  So an MCU maps the running offset x to
// x + bits, or, where a segment starts, to ceil8(x) + bits; a run of MCUs
// composes to x + a or ceil8(x + a) + c (struct Run), an associative
// operation, so offsets are an ordinary prefix scan over Runs.
//
// One launch, no scratch in device memory.  A thread block owns a tile: a
// run of tile_mcus consecutive MCUs of one image (the wrapper's
// tile_layout: at least 8 tiles a 512 x 512 image, at most 16 an image
// until a tile would pass kMaxTileMcus), so a 16-image batch of 512 x 512
// runs 128 thread blocks on the card's 132 SMs, the image's last tile
// first.  The thread block
//  1. folds the bit counts of all MCUs from the image's start to its
//     tile's end, a contiguous run of MCUs a thread, then scans the
//     threads' Runs.  Its predecessors' counts are re-reduced, not waited
//     for: no tile depends on another, and with at most 16 tiles an image
//     the counts are read at most 8 times (from L2: the entropy kernel has
//     just written them);
//  2. writes its MCUs' first-block offsets and bit counts into shared
//     memory, and the bit counts of the segments that end in the tile (no
//     atomics: each segment ends in one tile);
//  3. assembles its stream words in a shared-memory stage (up to kStage
//     words at a time, or maxw where fewer).  Word w is the
//     tile's when the tile's first offset <= 32 w < the next tile's first
//     offset.  A thread a block (stream order) ORs the block's used words,
//     funnel-shifted to their phase, into the stage, kGroup blocks a
//     thread with their first kAhead words loaded together; one thread,
//     the walker, adds to the tile's last word the bits of the next
//     tiles' blocks (the next tile's first counts loaded during step 1);
//     the stage leaves in coalesced plain stores, and the image's last
//     tile then writes the zeros after the data up to maxw in 16-byte
//     stores.  So every word of the stream, zeros included, is one plain
//     store, no word is zeroed first and none is merged in device memory.
//
// What bounds it: memory traffic, and at these sizes latency.  The
// function must read each block's bit count and used words once and write
// combined once: for a 16 x 512 x 512 4:2:0 batch of photographs about
// 0.4 MB of counts, 0.4 MB of used words and 1.6 MB of combined, under a
// microsecond at the card's rate.  The earlier two-pass design wrote an
// 8-byte offset a block to a scratch array and read it back, zeroed the
// streams in thread blocks of their own and ran one thread block an image
// for the offsets; this one keeps the offsets in shared memory and spreads
// each image over many SMs.  What is left is a chain of dependent steps a
// thread block (the counts from L2, the scan, the block words, the
// stores; times in PERF.md), the image's last tile, which re-reduces the
// whole image and writes its zeros, the longest.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kWords = 64;            // words a block holds
constexpr int kThreads = 512;         // a thread block: one tile
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTileMcus = 2048;    // shared memory: 16 KB of offsets
                                      // and 24 KB of bit counts at most
constexpr int kStage = 32768;         // and up to 128 KB of words being
                                      // assembled (maxw words if fewer)
constexpr int kGroup = 2;             // blocks a thread starts at once
constexpr int kAhead = 6;             // words of each block in flight
constexpr int kNext = 2;              // MCUs of the next tile read early

// Dynamic shared memory of a tile of tile_mcus MCUs and a stage of
// stage_words words.
constexpr size_t smem_bytes(long long tile_mcus, long long stage_words) {
  return 8 * tile_mcus + 2 * ((6 * tile_mcus + 1) & ~1ll) + 4 * stage_words;
}

struct Comps {
  const uint32_t* wy;
  const uint32_t* wcb;
  const uint32_t* wcr;
  const int32_t* by;
  const int32_t* bcb;
  const int32_t* bcr;
};

// Bit counts of MCU m of image n, in stream order Y0..Y3, Cb, Cr (the Y
// counts as one 16-byte load: the launcher checks their alignment).
__device__ __forceinline__ void mcu_bits(const Comps& c, int64_t n,
                                         int64_t nm, int64_t m, int32_t b[6]) {
  const int4 y = __ldg(reinterpret_cast<const int4*>(c.by) + n * nm + m);
  b[0] = y.x;
  b[1] = y.y;
  b[2] = y.z;
  b[3] = y.w;
  b[4] = __ldg(c.bcb + n * nm + m);
  b[5] = __ldg(c.bcr + n * nm + m);
}

// Block j (stream order within the MCU) of MCU m: its 64 words.
__device__ __forceinline__ const uint32_t* block_words(const Comps& c,
                                                       int64_t n, int64_t nm,
                                                       int64_t m, int j) {
  if (j < 4) return c.wy + ((n * nm + m) * 4 + j) * kWords;
  return (j == 4 ? c.wcb : c.wcr) + (n * nm + m) * kWords;
}

__device__ __forceinline__ int64_t ceil8(int64_t x) { return (x + 7) & ~7ll; }

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int64_t lmax(int64_t a, int64_t b) {
  return a > b ? a : b;
}

// A run of MCUs as a map of the running bit offset x: x + a, or, when a
// segment starts inside the run, ceil8(x + a) + c.
struct Run {
  int64_t a, c;
  int bound;
};

// the empty run: x -> x
__device__ __forceinline__ Run none() { return Run{0, 0, 0}; }

// f, then g.  ceil8(ceil8(y) + d) = ceil8(y) + ceil8(d), so two runs with
// segment starts compose into one.
__device__ __forceinline__ Run then(Run f, Run g) {
  if (!g.bound) {
    if (f.bound)
      f.c += g.a;
    else
      f.a += g.a;
    return f;
  }
  if (!f.bound) return Run{f.a + g.a, g.c, 1};
  return Run{f.a, ceil8(f.c + g.a) + g.c, 1};
}

__device__ __forceinline__ int64_t apply(Run f, int64_t x) {
  return f.bound ? ceil8(x + f.a) + f.c : x + f.a;
}

__device__ __forceinline__ Run shfl_up(Run r, int d) {
  return Run{__shfl_up_sync(kFullMask, r.a, d),
             __shfl_up_sync(kFullMask, r.c, d),
             __shfl_up_sync(kFullMask, r.bound, d)};
}

// Exclusive in-order scan of the threads' runs over the thread block;
// *whole receives the run of all of them.  `sh` holds kWarps runs.
__device__ __forceinline__ Run block_scan(Run r, Run* sh, Run* whole) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Run incl = r;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Run o = shfl_up(incl, d);
    if (lane >= d) incl = then(o, incl);
  }
  if (lane == 31) sh[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    Run w = lane < kWarps ? sh[lane] : none();
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const Run o = shfl_up(w, d);
      if (lane >= d) w = then(o, w);
    }
    __syncwarp();
    if (lane < kWarps) sh[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  Run excl = shfl_up(incl, 1);
  if (lane == 0) excl = none();
  const Run before = warp > 0 ? sh[warp - 1] : none();
  *whole = sh[kWarps - 1];
  __syncthreads();  // sh may be reused
  return then(before, excl);
}

// Bits [p, p + 32) of a block of nb > 0 bits at offset o, where the block
// overlaps them (o < p + 32 and o + nb > p): its word i and the next one
// funnel-shifted to the word's phase; the next is read only where the
// block has bits there.
__device__ __forceinline__ uint32_t piece(const uint32_t* w, int nb,
                                          int64_t o, int64_t p) {
  if (o >= p) return __ldg(w) >> static_cast<int>(o - p);
  const int k = static_cast<int>(p - o);  // < nb
  const int i = k >> 5;
  const int r = k & 31;
  const uint32_t hi = __ldg(w + i);
  const uint32_t lo = r != 0 && 32 * (i + 1) < nb ? __ldg(w + i + 1) : 0u;
  return __funnelshift_l(lo, hi, r);
}

// The bits [p, p + 32) that the blocks after the tile put there: the
// tile's last word may reach into the next tiles' blocks, whose offsets
// follow from s_next, the offset where MCU m1 starts (before its
// segment's padding).  The bit counts of the next kNext MCUs are in nxt
// (loaded early); a walk further loads them.
__device__ uint32_t bits_past_tile(const Comps& c, int64_t n, int64_t nm,
                                   int64_t ri, int64_t m1, int64_t s_next,
                                   int64_t p, const int32_t (*nxt)[6]) {
  uint32_t word = 0u;
  int64_t o = s_next;
  for (int64_t m = m1; m < nm && o < p + 32; ++m) {
    if (ri > 0 && m % ri == 0) o = ceil8(o);
    int32_t b[6];
    if (m < m1 + kNext) {
#pragma unroll
      for (int j = 0; j < 6; ++j) b[j] = nxt[m - m1][j];
    } else {
      mcu_bits(c, n, nm, m, b);
    }
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      if (b[j] > 0 && o < p + 32 && o + b[j] > p)
        word |= piece(block_words(c, n, nm, m, j), b[j], o, p);
      o += b[j];
    }
  }
  return word;
}

// What block i (stream order) of a tile puts into the stage's words [lo,
// hi): its output words q + x for x in [x0, x1] (x0 > x1: none), where
// output word q + x takes its words x (shifted right by r) and x - 1, and
// the words [first, last] of its own that these need.
struct Span {
  const uint32_t* w;
  int64_t q;
  int r, nw, x0, x1, first, last;
};

__device__ __forceinline__ Span span_of(const Comps& c, int64_t n,
                                        int64_t nm, int64_t m0,
                                        int64_t tile_mcus, const int64_t* off,
                                        const uint16_t* cnt, int i, int nblk,
                                        int64_t lo, int64_t hi) {
  Span sp = {nullptr, 0, 0, 0, 1, 0, 0, -1};
  if (i >= nblk) return sp;
  const int k = i / 6;
  const int j = i - 6 * k;
  const int nb = cnt[j * tile_mcus + k];
  if (nb == 0) return sp;
  int64_t o = off[k];
  for (int jj = 0; jj < j; ++jj) o += cnt[jj * tile_mcus + k];
  sp.q = o >> 5;
  sp.r = static_cast<int>(o & 31);
  sp.nw = (nb + 31) >> 5;
  // the last output word only where the block's bits reach into it
  const int64_t x0 = lmax(0, lo - sp.q);
  const int64_t x1 = lmin(sp.r > 0 ? sp.nw : sp.nw - 1, hi - 1 - sp.q);
  if (x0 > x1) return sp;
  sp.x0 = static_cast<int>(x0);
  sp.x1 = static_cast<int>(x1);
  sp.first = sp.x0 > 0 ? sp.x0 - 1 : 0;
  sp.last = min(sp.x1, sp.nw - 1);
  sp.w = block_words(c, n, nm, m0 + k, j);
  return sp;
}

// OR a block's output words into the stage.  ahead holds its words first,
// first + 1, ...; each word taken is replaced by the one kAhead later.
__device__ __forceinline__ void place_block(const Span& sp,
                                            uint32_t (&ahead)[kAhead],
                                            uint32_t* stage, int64_t lo) {
  int y = sp.first;  // the word in ahead[0]
  const auto take = [&]() {
    const uint32_t v = ahead[0];
#pragma unroll
    for (int u = 0; u + 1 < kAhead; ++u) ahead[u] = ahead[u + 1];
    ahead[kAhead - 1] = y + kAhead <= sp.last ? __ldg(sp.w + y + kAhead) : 0u;
    ++y;
    return v;
  };
  uint32_t prev = sp.x0 > 0 ? take() : 0u;
  for (int x = sp.x0; x <= sp.x1; ++x) {
    const uint32_t cur = x < sp.nw ? take() : 0u;
    const uint32_t v =
        sp.r == 0 ? cur : (cur >> sp.r) | (prev << (32 - sp.r));
    if (v != 0u) atomicOr(stage + (sp.q + x - lo), v);
    prev = cur;
  }
}

__global__ void __launch_bounds__(kThreads)
    concat_streams_kernel(Comps c, int64_t nimages, int64_t nm, int64_t ri,
                          int64_t nseg, int64_t maxw, int64_t tile_mcus,
                          int64_t ntiles, int64_t stage_words,
                          int64_t* __restrict__ combined) {
  // dynamic shared memory: the tile's MCU offsets, its bit counts (<=
  // 2048; block j of MCU m at cnt[j * tile_mcus + m - m0]) and the stage
  // of stage_words words that its words are assembled in
  extern __shared__ int64_t dyn[];
  int64_t* off = dyn;
  uint16_t* cnt = reinterpret_cast<uint16_t*>(off + tile_mcus);
  uint32_t* stage = reinterpret_cast<uint32_t*>(
      cnt + ((6 * tile_mcus + 1) & ~1ll));
  __shared__ Run sh[kWarps];
  __shared__ int64_t marks[2];  // s_t, and the base of the open segment
  // the bit counts of the next tile's first MCUs, for the tile's last word
  __shared__ int32_t nxt[kNext][6];
  // the image's last tile first: it writes the most words
  const int64_t n = blockIdx.x % nimages;
  const int64_t t = ntiles - 1 - blockIdx.x / nimages;
  const int64_t m0 = t * tile_mcus;
  const int64_t m1 = lmin(nm, m0 + tile_mcus);
  const bool last = m1 == nm;
  // the first MCU of the segment that holds m0
  const int64_t open = ri > 0 ? m0 / ri * ri : m0;

  // 1. the MCUs [0, m1): a contiguous run a thread, then the block's scan
  const int64_t chunk = (m1 + kThreads - 1) / kThreads;
  const int64_t c0 = lmin(m1, static_cast<int64_t>(threadIdx.x) * chunk);
  const int64_t c1 = lmin(m1, c0 + chunk);
  const int64_t phase0 = ri > 0 ? c0 % ri : 1;
  Run mine = none();
  {
    int64_t phase = phase0;
#pragma unroll 4
    for (int64_t m = c0; m < c1; ++m) {
      int32_t b[6];
      mcu_bits(c, n, nm, m, b);
      const int64_t mb = b[0] + b[1] + b[2] + b[3] + b[4] + b[5];
      mine = then(mine, (m > 0 && phase == 0) ? Run{0, mb, 1}
                                              : Run{mb, 0, 0});
      if (ri > 0 && ++phase == ri) phase = 0;
    }
  }
  // the walker, the last thread, takes the tile's last word; the counts
  // it needs first are loaded now, beside the scan's
  const bool walker = threadIdx.x == kThreads - 1 && !last;
  if (walker)
    for (int k = 0; k < kNext && m1 + k < nm; ++k)
      mcu_bits(c, n, nm, m1 + k, nxt[k]);
  Run whole;
  const Run before = block_scan(mine, sh, &whole);
  const int64_t s_next = apply(whole, 0);  // the offset where m1 starts

  // 2. offsets: the value before MCU m0 (s_t), the base of the segment
  // open at m0, and every tile MCU's first-block offset (after padding)
  if (c1 > open) {
    int64_t v = apply(before, 0);
    int64_t phase = phase0;
    for (int64_t m = c0; m < c1; ++m) {
      int32_t b[6];
      mcu_bits(c, n, nm, m, b);
      if (m == m0) marks[0] = v;
      if (m > 0 && phase == 0) v = ceil8(v);
      if (m == open && m < m0) marks[1] = v;
      if (m >= m0) {
        off[m - m0] = v;
#pragma unroll
        for (int j = 0; j < 6; ++j)
          cnt[j * tile_mcus + m - m0] = static_cast<uint16_t>(b[j]);
      }
      v += b[0] + b[1] + b[2] + b[3] + b[4] + b[5];
      if (ri > 0 && ++phase == ri) phase = 0;
    }
  }
  __syncthreads();
  const int64_t s_t = marks[0];
  int64_t* out = combined + n * (1 + nseg + maxw);
  // the bit counts of the segments that end in this tile
  if (ri > 0) {
    for (int64_t s = m0 / ri + threadIdx.x; s <= (m1 - 1) / ri;
         s += kThreads) {
      const int64_t e = lmin((s + 1) * ri, nm) - 1;  // its last MCU
      if (e >= m1) continue;
      int64_t end = off[e - m0];
#pragma unroll
      for (int j = 0; j < 6; ++j) end += cnt[j * tile_mcus + e - m0];
      const int64_t start = s * ri;
      out[1 + s] = end - (start >= m0 ? off[start - m0] : marks[1]);
    }
  }
  if (last && threadIdx.x == 0) out[0] = ri > 0 ? ceil8(s_next) : s_next;

  // 3. the tile's words [w0, w_data): the words that start in its bits,
  // up to maxw, assembled stage_words at a time in shared memory (all at
  // once unless the tile's words are many): a thread a
  // block ORs the block's words, shifted to their phase, into the stage;
  // the walker adds the bits of the next tiles' blocks in the tile's last
  // word; then the stage leaves in coalesced plain stores.  The last tile
  // then writes the zeros after the image's data.
  int64_t* stream = out + 1 + nseg;
  const int64_t w0 = (s_t + 31) >> 5;
  const int64_t w_data = lmin(maxw, (s_next + 31) >> 5);
  const int nblk = static_cast<int>(6 * (m1 - m0));
  for (int64_t lo = w0; lo < w_data; lo += stage_words) {
    const int64_t hi = lmin(lo + stage_words, w_data);
    for (int i = threadIdx.x; i < hi - lo; i += kThreads) stage[i] = 0u;
    __syncthreads();
    uint32_t past = 0u;
    if (walker && hi == w_data && (s_next & 31) != 0)
      past = bits_past_tile(c, n, nm, ri, m1, s_next, (w_data - 1) << 5, nxt);
    // kGroup blocks a thread, all their first kAhead words in flight
    // before any is used, and each block's later words kAhead ahead
    for (int i0 = threadIdx.x; i0 < nblk; i0 += kGroup * kThreads) {
      Span sp[kGroup];
      uint32_t ahead[kGroup][kAhead];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        sp[g] = span_of(c, n, nm, m0, tile_mcus, off, cnt, i0 + g * kThreads,
                        nblk, lo, hi);
#pragma unroll
        for (int u = 0; u < kAhead; ++u)
          ahead[g][u] = sp[g].first + u <= sp[g].last
                            ? __ldg(sp[g].w + sp[g].first + u)
                            : 0u;
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
        if (sp[g].x0 <= sp[g].x1)
          place_block(sp[g], ahead[g], stage, lo);
    }
    if (past != 0u) atomicOr(stage + (w_data - 1 - lo), past);
    __syncthreads();
    for (int i = threadIdx.x; i < hi - lo; i += kThreads)
      stream[lo + i] = stage[i];
    __syncthreads();
  }
  if (last) {  // the words after the image's data: 16-byte stores
    int64_t w = lmax(w0, w_data);
    if (w < maxw && (reinterpret_cast<uintptr_t>(stream + w) & 15) != 0) {
      if (threadIdx.x == 0) stream[w] = 0;
      ++w;
    }
    longlong2* pairs = reinterpret_cast<longlong2*>(stream + w);
    for (int64_t i = threadIdx.x; i < (maxw - w) >> 1; i += kThreads)
      pairs[i] = make_longlong2(0, 0);
    if (w < maxw && ((maxw - w) & 1) != 0 && threadIdx.x == 0)
      stream[maxw - 1] = 0;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (PyTorch's current stream) and returns
// cudaGetLastError(): 0 on success.  Does not synchronise.  combined [N,
// 1 + nseg + maxw] int64 is written whole.  tile_mcus, ntiles: the tiles
// of an image (ops/concat_cuda.py:tile_layout), ntiles * tile_mcus >= nm
// > (ntiles - 1) * tile_mcus, tile_mcus <= kMaxTileMcus.
int jz_concat_streams(const void* wy, const void* wcb, const void* wcr,
                      const void* by, const void* bcb, const void* bcr,
                      void* combined, long long nimages, long long nm,
                      long long ri, long long nseg, long long maxw,
                      long long tile_mcus, long long ntiles, void* stream) {
  if (nimages <= 0) return 0;
  if (nm <= 0 || ri < 0 || maxw <= 0 ||
      nseg != (ri > 0 ? (nm + ri - 1) / ri : 0) || tile_mcus <= 0 ||
      tile_mcus > kMaxTileMcus || ntiles <= 0 || ntiles * tile_mcus < nm ||
      (ntiles - 1) * tile_mcus >= nm ||
      reinterpret_cast<uintptr_t>(by) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nimages * ntiles > 0x7FFFFFFFll)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const Comps c = {static_cast<const uint32_t*>(wy),
                   static_cast<const uint32_t*>(wcb),
                   static_cast<const uint32_t*>(wcr),
                   static_cast<const int32_t*>(by),
                   static_cast<const int32_t*>(bcb),
                   static_cast<const int32_t*>(bcr)};
  static const cudaError_t attr = cudaFuncSetAttribute(
      concat_streams_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(kMaxTileMcus, kStage)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long stage_words = maxw < kStage ? maxw : kStage;
  concat_streams_kernel<<<static_cast<unsigned>(nimages * ntiles), kThreads,
                          smem_bytes(tile_mcus, stage_words),
                          static_cast<cudaStream_t>(stream)>>>(
      c, nimages, nm, ri, nseg, maxw, tile_mcus, ntiles, stage_words,
      static_cast<int64_t*>(combined));
  return static_cast<int>(cudaGetLastError());
}

// What the card reports for the kernel: info[0] registers a thread, [1]
// resident thread blocks an SM and [2] shared bytes a thread block at the
// main path's shape (tiles of 128 MCUs, a budget of 12,288 words), [3]
// local bytes a thread, [4] threads a block.  Returns 0 or a CUDA error code.
int jz_concat_kernel_info(int* info) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, concat_streams_kernel);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, concat_streams_kernel, kThreads, smem_bytes(128, 12288));
  if (e != cudaSuccess) return static_cast<int>(e);
  info[0] = attr.numRegs;
  info[1] = per_sm;
  info[2] = static_cast<int>(attr.sharedSizeBytes + smem_bytes(128, 12288));
  info[3] = static_cast<int>(attr.localSizeBytes);
  info[4] = kThreads;
  return 0;
}

const char* jz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

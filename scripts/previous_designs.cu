// The designs of kernels of jpezy_tpu_torch that later revisions
// replaced, kept so that chip_smoke.py can time them beside the current
// ones in one run, on the same inputs (scripts/previous_designs.py binds
// them; nothing in the package calls them):
//
//   jz_prev_encode_blocks_fused  the first design of the fused entropy
//     kernel (one launch for the three components, each block's DC
//     predictor found in the kernel): a warp took 2 consecutive blocks,
//     gathered their coefficients in zigzag order by 4-byte loads into
//     registers, read every table entry from device memory through the
//     read-only cache, and stored each 32-bit word zero-extended to 64
//     bits (776 bytes moved a block where the function needs 516).  The
//     current jz_encode_blocks_batch stages a thread block's run of 32
//     blocks and its table sets in shared memory by bulk copies and
//     stores 32-bit words.
//   jz_prev_concat_streams  the stream concat as it read those words: the
//     current jz_concat_streams with 64-bit word loads (it uses the low
//     32 bits of each).
//   jz_prev_idct_planes_rgb  the first fast rgb IDCT: a lane a column of its
//     block over the block's own nonzero mask, the [64][64] float32 basis in
//     shared memory (9 shared loads for every 16 float operations; the
//     current kernel holds its basis in registers, takes one product for
//     the four samples of a mirror quad and walks the union of a warp's 4
//     blocks).
//   jz_prev_idct_planes_overflow  the first overflow launch of the ycc420
//     IDCT (block_transforms.cu's jz_idct_planes): a group of 8 lanes an
//     overflow row and a lane a row of 8 samples, each group on its own
//     block's mask, every term's coefficient loaded again from device
//     memory and two 16-byte words of the 16 KB [64][64] basis in shared
//     memory read for 16 float operations (the current launch tiles the
//     rows 8 a warp by component, loads each row once and walks the union
//     of the tile's nonzero coefficients, one product a mirror quad).
//   jz_prev_idct_planes_sparse  the first sparse launch of the ycc420 IDCT
//     (PR 9's design): a warp a unit of up to 16 blocks of one MCU row, its
//     masks and value bytes copied into the warp's shared memory, then the
//     blocks 4 at a time, a group of 8 lanes a block and a lane a row of 8
//     samples over the block's own mask (8 products and 8 adds a term, the
//     4 groups' walks diverging), the 16 KB [64][64] basis copied into
//     shared memory by every thread block, the strip staged in shared
//     memory and stored in 16-byte chunks.  The current launch walks the
//     union of a group of blocks' masks with one product a mirror quad from
//     the 4 KB quad table, loads the next unit while it sums this one, and
//     stores rows straight from registers.
//   jz_prev_idct_planes_dense  the first dense launch of the ycc420 IDCT, the
//     same design on the Huffman scan's int16 blocks: a unit's blocks
//     loaded into the warp's shared memory with nothing in flight behind
//     the sums (their nonzero masks found on the way), the blocks four at
//     a time, a group of 8 lanes a block and a lane a row over its own
//     mask, into a shared image of the unit whose rows sit at their
//     destination's address modulo 16, stored in 16-byte chunks.  The
//     current launch stages the next unit by cp.async while it walks the
//     union of the unit's 16 masks with the sparse launch's walk, and
//     stores 8-byte words from registers.
//   jz_prev_fdct_quantize_exact, jz_prev_idct_planes_exact  exact mode's
//     first float64 kernels: the forward issues all 64 terms of every
//     block, products by COS[0][y] = 1 and cu[i] = 1 and the first adds
//     onto +0 included; the inverse walks each block's own nonzero mask,
//     k different in each of a warp's 4 blocks, with the tables COS and
//     cucv in shared memory (7 shared loads a term).  The current
//     exact_transforms.cu skips the exact products by 1 and the zero
//     samples of a warp's 4 blocks, and walks their union with the tables
//     as constant-bank operands.
//   jz_prev_fdct_quantize  the fDCT kernel of block_transforms.cu as PR 9
//     designed it: the separable float32 form (a row pass and a column
//     pass of 8 terms, then one multiply by c_u c_v / 4), 4 blocks a warp,
//     a lane a row and then a column, the transposes through a per-warp
//     shared tile, the cosines as kernel parameters; 103 registers, 16
//     warps an SM, bound by instruction issue.  The current kernel takes
//     the integer form on the int8 tensor cores, 16 blocks a warp.
//
// All are verbatim but for names: the first fused entropy kernel with the
// helpers of its source in namespace fused_first, the concat it fed in
// namespace concat_first, the exact kernels and the first fast rgb IDCT
// in namespace first_exact, the first overflow launch with the helpers
// and argument structs of its source in namespace first_overflow, the
// first sparse and dense launches with the helpers and argument structs
// of their source in namespace first_sparse, and the first fDCT kernel
// with its helpers in namespace first_fdct.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

namespace fused_first {

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
    encode_blocks_fused_first_kernel(Component y, Component cb, Component cr,
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

// kWarpsPerCta warps per CTA, `per_warp` blocks per warp; false when the
// grid would not fit the launch limits.
bool grid_for(long long nblocks, int per_warp, unsigned* grid) {
  const long long per_cta = static_cast<long long>(kWarpsPerCta) * per_warp;
  const long long g = (nblocks + per_cta - 1) / per_cta;
  if (g > 0x7FFFFFFFll) return false;
  *grid = static_cast<unsigned>(g);
  return true;
}

}  // namespace fused_first

namespace concat_first {

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
  const uint64_t* wy;
  const uint64_t* wcb;
  const uint64_t* wcr;
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
__device__ __forceinline__ const uint64_t* block_words(const Comps& c,
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
__device__ __forceinline__ uint32_t piece(const uint64_t* w, int nb,
                                          int64_t o, int64_t p) {
  if (o >= p)
    return static_cast<uint32_t>(__ldg(w)) >> static_cast<int>(o - p);
  const int k = static_cast<int>(p - o);  // < nb
  const int i = k >> 5;
  const int r = k & 31;
  const uint32_t hi = static_cast<uint32_t>(__ldg(w + i));
  const uint32_t lo = r != 0 && 32 * (i + 1) < nb
                          ? static_cast<uint32_t>(__ldg(w + i + 1))
                          : 0u;
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
  const uint64_t* w;
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
    ahead[kAhead - 1] = y + kAhead <= sp.last
                            ? static_cast<uint32_t>(__ldg(sp.w + y + kAhead))
                            : 0u;
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
    concat_streams_first_kernel(Comps c, int64_t nimages, int64_t nm,
                                int64_t ri, int64_t nseg, int64_t maxw,
                                int64_t tile_mcus, int64_t ntiles,
                                int64_t stage_words,
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
                            ? static_cast<uint32_t>(
                                  __ldg(sp[g].w + sp[g].first + u))
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


}  // namespace concat_first

namespace first_exact {


constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4;       // blocks a warp
constexpr int kStride = 65;    // doubles a block in the warp's tile

// The top-left sample of block bi of a component whose MCUs hold v x h
// blocks in raster order (luma 2 x 2 at 4:2:0: TL, TR, BL, BR).
__device__ __forceinline__ void block_origin(int bi, int v, int h,
                                             int mcus_x, int* row,
                                             int* col) {
  const int per = v * h;
  const int m = bi / per;
  const int r = bi - m * per;
  const int my = m / mcus_x;
  const int mx = m - my * mcus_x;
  const int vy = r / h;
  *row = (my * v + vy) * 8;
  *col = (mx * h + (r - vy * h)) * 8;
}

// ---------------------------------------------------------------------------
// Kernel 1: blockify, float64 ordered forward DCT, quantize
// ---------------------------------------------------------------------------

struct FwdComp {
  const void* base;       // the plane's first sample
  long long sn, sr, sc;   // element strides: image, row, column
  const int32_t* q;       // [64] quant table
  int32_t* out;           // [N, nblocks, 64]
  int nblocks;
};

struct FwdArgs {
  FwdComp comp[3];
  double cosv[64];        // COS[u][x], u * 8 + x
  double cu[8];
  int nimages, mcus_x, gray, rounded;
  int ty, tc;             // tiles of luma, of each chroma component
};

// Row r of a block: 8 samples at column stride sc, as doubles (exact).
__device__ __forceinline__ void load_row(const int8_t* src, long long sc,
                                         double* x) {
  if (sc == 1 && (reinterpret_cast<uintptr_t>(src) & 7) == 0) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(src));
#pragma unroll
    for (int j = 0; j < 8; ++j)
      x[j] = __int2double_rn(static_cast<int8_t>(
          ((j < 4 ? w.x : w.y) >> (8 * (j & 3))) & 0xFF));
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = __int2double_rn(__ldg(src + j * sc));
}

__device__ __forceinline__ void load_row(const int32_t* src, long long sc,
                                         double* x) {
  if (sc == 1 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(src));
    const int4 b = __ldg(reinterpret_cast<const int4*>(src) + 1);
    const int v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = __int2double_rn(v[j]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = __int2double_rn(__ldg(src + j * sc));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fdct_exact_first_kernel(const __grid_constant__ FwdArgs a) {
  __shared__ double tiles[kWarps][kTile * kStride];
  const int lane = threadIdx.x & 31;
  double* tile = tiles[threadIdx.x >> 5];
  const int b = lane >> 3;      // the lane's block in the tile
  const int r = lane & 7;       // its row (load), then its column j
  // COS[j][x] for the lane's column j = r, and cu[j]
  double cj[8];
#pragma unroll
  for (int x = 0; x < 8; ++x) cj[x] = a.cosv[r * 8 + x];
  const double cuj = a.cu[r];
  const int total = a.ty + 2 * a.tc;
  for (int tile_i = blockIdx.x * kWarps + (threadIdx.x >> 5); tile_i < total;
       tile_i += gridDim.x * kWarps) {
    const int c = tile_i < a.ty ? 0 : (tile_i < a.ty + a.tc ? 1 : 2);
    const int first =
        (tile_i - (c == 0 ? 0 : (c == 1 ? a.ty : a.ty + a.tc))) * kTile;
    const FwdComp& P = a.comp[c];
    const int f = first + b;    // the lane's block
    const bool live = f < a.nimages * P.nblocks;
    int32_t* out = P.out + static_cast<long long>(f) * 64 + r;
    if (a.gray && c > 0) {
      if (live) {
#pragma unroll
        for (int i = 0; i < 8; ++i) out[i * 8] = 0;
      }
      continue;
    }
    double x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = 0.0;
    if (live) {
      const int n = f / P.nblocks;
      const int bi = f - n * P.nblocks;
      // 4:2:0: luma blocks TL, TR, BL, BR of MCU bi / 4, chroma MCU bi
      const int m = c == 0 ? bi >> 2 : bi;
      const int my = m / a.mcus_x;
      const int mx = m - my * a.mcus_x;
      const int y0 = c == 0 ? (2 * my + ((bi >> 1) & 1)) * 8 : my * 8;
      const int x0 = c == 0 ? (2 * mx + (bi & 1)) * 8 : mx * 8;
      load_row(static_cast<const T*>(P.base) + n * P.sn + (y0 + r) * P.sr +
                   x0 * P.sc,
               P.sc, x);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) tile[b * kStride + r * 8 + j] = x[j];
    __syncwarp();
    // the 64 terms of column j in the reference's order, k = 8 y + x
    double acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.0;
#pragma unroll
    for (int y = 0; y < 8; ++y) {
#pragma unroll
      for (int xx = 0; xx < 8; ++xx) {
        const double t = __dmul_rn(tile[b * kStride + y * 8 + xx], cj[xx]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          acc[i] = __dadd_rn(acc[i], __dmul_rn(t, a.cosv[i * 8 + y]));
      }
    }
    __syncwarp();  // the tile is loaded again for the next blocks
    if (!live) continue;
    const int32_t* q = P.q;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int cf = __double2int_rz(
          __dmul_rn(__dmul_rn(__dmul_rn(acc[i], cuj), a.cu[i]), 0.25));
      const int qv = __ldg(q + i * 8 + r);
      const int mag = cf < 0 ? -cf : cf;
      const int qm = a.rounded ? (2 * mag + qv) / (2 * qv) : mag / qv;
      out[i * 8] = cf < 0 ? -qm : qm;
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel 2: dequantize, float64 ordered inverse DCT, deblockify
// ---------------------------------------------------------------------------

struct InvComp {
  int nblocks;            // B_c: the component's blocks in one image
  int v, h, width;        // sampling factors, plane width in samples
  int first;              // the component's first block in a coefficient row
  int32_t* out;           // [N, mcus_y v 8, width]
  long long plane;        // samples of one image's plane
};

struct InvArgs {
  InvComp comp[3];
  const void* coeff;      // [N, row_blocks, 64]
  const int32_t* q;       // [ncomp, 64]
  const float* basis;     // the fast form's [64][64] float32 M[p][k] by k
  double cosv[64];        // COS[u][x], u * 8 + x (exact mode)
  double cucv[64];        // fl(cu[u] cv[v]), k = 8 v + u (exact mode)
  int nimages, ncomp, mcus_x, row_blocks, level;
  int tiles[3];           // tiles of each component over the batch
};

// Row r of a block: 8 coefficients as 32-bit integers.
__device__ __forceinline__ void load_coeffs(const int16_t* src, int* c) {
  const int4 w = __ldg(reinterpret_cast<const int4*>(src));
  const int v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    c[2 * j] = static_cast<int16_t>(v[j] & 0xFFFF);
    c[2 * j + 1] = v[j] >> 16;
  }
}

__device__ __forceinline__ void load_coeffs(const int32_t* src, int* c) {
  const int4 a = __ldg(reinterpret_cast<const int4*>(src));
  const int4 b = __ldg(reinterpret_cast<const int4*>(src) + 1);
  c[0] = a.x; c[1] = a.y; c[2] = a.z; c[3] = a.w;
  c[4] = b.x; c[5] = b.y; c[6] = b.z; c[7] = b.w;
}

// The tables of the inverse's two arithmetics: exact mode's float64 factors,
// or the fast form's float32 basis M[p][k] (p = 8 y + x) stored by k, each
// row padded to kBasisStride floats so that the 4 blocks of a warp, at
// different k, read different banks more often.
constexpr int kBasisStride = 72;
template <typename Real>
struct InvTables;
template <>
struct InvTables<double> {
  double cosv[64];        // COS[u][x], u * 8 + x
  double cucv[64];
};
template <>
struct InvTables<float> {
  float basis[64 * kBasisStride];   // basis[k * kBasisStride + p] = M[p][k]
};

// The walk of both inverse kernels: lane 8 b + r loads and dequantizes row
// r of block b, then owns column x = r with 8 accumulators, one per row y,
// over the block's nonzero coefficients in ascending order.  Real = double:
// exact mode's terms ((cucv[k] d[k]) COS[u][x]) COS[v][y] and s / 4 +
// level; Real = float: the fast IDCT's terms d[k] M[8 y + x][k] and s +
// level (block_transform.inverse_model), each a multiply then an add.
template <typename T, typename Real>
__device__ __forceinline__ void idct_planes_walk(const InvArgs& a) {
  constexpr bool kExact = sizeof(Real) == 8;
  __shared__ __align__(16) Real tiles[kWarps][kTile * kStride];
  __shared__ __align__(16) InvTables<Real> tabs;
  __shared__ int qs[3][64];
  const int t = threadIdx.x;
  if constexpr (kExact) {
    for (int i = t; i < 128; i += kThreads) {
      if (i < 64)
        tabs.cosv[i] = a.cosv[i];
      else
        tabs.cucv[i - 64] = a.cucv[i - 64];
    }
  } else {
    for (int i = t; i < 64 * 64; i += kThreads)
      tabs.basis[(i >> 6) * kBasisStride + (i & 63)] = __ldg(a.basis + i);
  }
  for (int i = t; i < 64 * a.ncomp; i += kThreads)
    qs[i >> 6][i & 63] = __ldg(a.q + i);
  __syncthreads();
  const int lane = t & 31;
  Real* tile = tiles[t >> 5];
  const int b = lane >> 3;      // the lane's block in the tile
  const int r = lane & 7;       // its row (load), then its column x
  const Real level = kExact ? Real(__int2double_rn(a.level))
                            : Real(__int2float_rn(a.level));
  const int total = a.tiles[0] + a.tiles[1] + a.tiles[2];
  for (int tile_i = blockIdx.x * kWarps + (t >> 5); tile_i < total;
       tile_i += gridDim.x * kWarps) {
    int c = 0, lt = tile_i;
    while (lt >= a.tiles[c]) lt -= a.tiles[c++];
    const InvComp& P = a.comp[c];
    const int f = lt * kTile + b;   // the lane's block
    const bool live = f < a.nimages * P.nblocks;
    const int n = live ? f / P.nblocks : 0;
    const int bi = f - n * P.nblocks;
    // row r of the block, dequantized: d = c q as a 32-bit integer
    int d[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) d[u] = 0;
    if (live)
      load_coeffs(static_cast<const T*>(a.coeff) +
                      (static_cast<long long>(n) * a.row_blocks + P.first +
                       bi) * 64 + r * 8,
                  d);
    unsigned row_mask = 0;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      d[u] = static_cast<int>(static_cast<unsigned>(d[u]) *
                              static_cast<unsigned>(qs[c][r * 8 + u]));
      row_mask |= (d[u] != 0 ? 1u : 0u) << u;
      if constexpr (kExact)
        tile[b * kStride + r * 8 + u] = __int2double_rn(d[u]);
      else
        tile[b * kStride + r * 8 + u] = __int2float_rn(d[u]);
    }
    // the block's 64-bit nonzero mask, bit k = 8 v + u, in its 8 lanes
    unsigned lo = r < 4 ? row_mask << (8 * r) : 0u;
    unsigned hi = r < 4 ? 0u : row_mask << (8 * (r - 4));
#pragma unroll
    for (int s = 1; s < 8; s <<= 1) {
      lo |= __shfl_xor_sync(kFullMask, lo, s);
      hi |= __shfl_xor_sync(kFullMask, hi, s);
    }
    unsigned long long mask =
        (static_cast<unsigned long long>(hi) << 32) | lo;
    __syncwarp();
    Real acc[8];
#pragma unroll
    for (int y = 0; y < 8; ++y) acc[y] = Real(0);
    while (mask) {
      const int k = __ffsll(static_cast<long long>(mask)) - 1;
      mask &= mask - 1;
      if constexpr (kExact) {
        const int u = k & 7;
        const int v = k >> 3;
        const double cx = __dmul_rn(
            __dmul_rn(tabs.cucv[k], tile[b * kStride + k]),
            tabs.cosv[u * 8 + r]);
        const double2* cy = reinterpret_cast<const double2*>(tabs.cosv +
                                                             v * 8);
#pragma unroll
        for (int y2 = 0; y2 < 4; ++y2) {
          const double2 w = cy[y2];
          acc[2 * y2] = __dadd_rn(acc[2 * y2], __dmul_rn(cx, w.x));
          acc[2 * y2 + 1] = __dadd_rn(acc[2 * y2 + 1], __dmul_rn(cx, w.y));
        }
      } else {
        const float dk = tile[b * kStride + k];
        const float* m = tabs.basis + k * kBasisStride + r;
#pragma unroll
        for (int y = 0; y < 8; ++y)
          acc[y] = __fadd_rn(acc[y], __fmul_rn(dk, m[8 * y]));
      }
    }
    __syncwarp();  // the tile is loaded again for the next blocks
    if (!live) continue;
    int row0, col0;
    block_origin(bi, P.v, P.h, a.mcus_x, &row0, &col0);
    int32_t* out = P.out + n * P.plane +
                   static_cast<long long>(row0) * P.width + col0 + r;
#pragma unroll
    for (int y = 0; y < 8; ++y) {
      int s;
      if constexpr (kExact)
        s = __double2int_rz(__dadd_rn(__dmul_rn(acc[y], 0.25), level));
      else
        s = __float2int_rz(__fadd_rn(acc[y], level));
      out[static_cast<long long>(y) * P.width] = s;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    idct_exact_first_kernel(const __grid_constant__ InvArgs a) {
  idct_planes_walk<T, double>(a);
}

// The first fast rgb IDCT (exact_transforms.cu's kernel 3 as it was first
// made): lane 8 b + r loads and dequantizes row r of block b, then owns
// column x = r with 8 accumulators, one per row y, over the block's nonzero
// coefficients in ascending order: terms d[k] M[8 y + x][k] and s + level
// (block_transform.inverse_model), each a multiply then an add.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    idct_rgb_first_kernel(const __grid_constant__ InvArgs a) {
  __shared__ __align__(16) float tiles[kWarps][kTile * kStride];
  __shared__ __align__(16) float basis[64 * kBasisStride];
  __shared__ int qs[3][64];
  const int t = threadIdx.x;
  for (int i = t; i < 64 * 64; i += kThreads)
    basis[(i >> 6) * kBasisStride + (i & 63)] = __ldg(a.basis + i);
  for (int i = t; i < 64 * a.ncomp; i += kThreads)
    qs[i >> 6][i & 63] = __ldg(a.q + i);
  __syncthreads();
  const int lane = t & 31;
  float* tile = tiles[t >> 5];
  const int b = lane >> 3;      // the lane's block in the tile
  const int r = lane & 7;       // its row (load), then its column x
  const float level = __int2float_rn(a.level);
  const int total = a.tiles[0] + a.tiles[1] + a.tiles[2];
  for (int tile_i = blockIdx.x * kWarps + (t >> 5); tile_i < total;
       tile_i += gridDim.x * kWarps) {
    int c = 0, lt = tile_i;
    while (lt >= a.tiles[c]) lt -= a.tiles[c++];
    const InvComp& P = a.comp[c];
    const int f = lt * kTile + b;   // the lane's block
    const bool live = f < a.nimages * P.nblocks;
    const int n = live ? f / P.nblocks : 0;
    const int bi = f - n * P.nblocks;
    // row r of the block, dequantized: d = c q as a 32-bit integer
    int d[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) d[u] = 0;
    if (live)
      load_coeffs(static_cast<const T*>(a.coeff) +
                      (static_cast<long long>(n) * a.row_blocks + P.first +
                       bi) * 64 + r * 8,
                  d);
    unsigned row_mask = 0;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      d[u] = static_cast<int>(static_cast<unsigned>(d[u]) *
                              static_cast<unsigned>(qs[c][r * 8 + u]));
      row_mask |= (d[u] != 0 ? 1u : 0u) << u;
      tile[b * kStride + r * 8 + u] = __int2float_rn(d[u]);
    }
    // the block's 64-bit nonzero mask, bit k = 8 v + u, in its 8 lanes
    unsigned lo = r < 4 ? row_mask << (8 * r) : 0u;
    unsigned hi = r < 4 ? 0u : row_mask << (8 * (r - 4));
#pragma unroll
    for (int s = 1; s < 8; s <<= 1) {
      lo |= __shfl_xor_sync(kFullMask, lo, s);
      hi |= __shfl_xor_sync(kFullMask, hi, s);
    }
    unsigned long long mask =
        (static_cast<unsigned long long>(hi) << 32) | lo;
    __syncwarp();
    float acc[8];
#pragma unroll
    for (int y = 0; y < 8; ++y) acc[y] = 0.0f;
    while (mask) {
      const int k = __ffsll(static_cast<long long>(mask)) - 1;
      mask &= mask - 1;
      const float dk = tile[b * kStride + k];
      const float* m = basis + k * kBasisStride + r;
#pragma unroll
      for (int y = 0; y < 8; ++y)
        acc[y] = __fadd_rn(acc[y], __fmul_rn(dk, m[8 * y]));
    }
    __syncwarp();  // the tile is loaded again for the next blocks
    if (!live) continue;
    int row0, col0;
    block_origin(bi, P.v, P.h, a.mcus_x, &row0, &col0);
    int32_t* out = P.out + n * P.plane +
                   static_cast<long long>(row0) * P.width + col0 + r;
#pragma unroll
    for (int y = 0; y < 8; ++y)
      out[static_cast<long long>(y) * P.width] =
          __float2int_rz(__fadd_rn(acc[y], level));
  }
}

template <typename K>
cudaError_t grid_for(K kernel, long long units, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (e != cudaSuccess) return e;
  const long long resident =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  *grid = static_cast<int>(units < resident ? units : resident);
  return cudaSuccess;
}

template <typename K>
int kernel_info(K kernel, int* info) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  info[0] = attr.numRegs;
  info[1] = per_sm;
  info[2] = static_cast<int>(attr.sharedSizeBytes);
  info[3] = static_cast<int>(attr.localSizeBytes);
  info[4] = kThreads;
  return 0;
}

template <typename K, typename A>
int launch(K kernel, long long tiles, const A& a, cudaStream_t s) {
  int grid = 0;
  const cudaError_t e = grid_for(kernel, (tiles + kWarps - 1) / kWarps, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// desc (host memory, see jz_idct_planes_exact) -> a's layout and the tiles
// of the launch; 0 or a CUDA error code.
int inverse_layout(int elem_bytes, const long long* desc, const void* coeff,
                   const void* q, void* o0, void* o1, void* o2, InvArgs* a,
                   long long* tiles) {
  const long long nimages = desc[0];
  a->ncomp = static_cast<int>(desc[1]);
  if (a->ncomp < 1 || a->ncomp > 3 || desc[2] <= 0 ||
      nimages * desc[3] > 0x7FFFFFFFll || (elem_bytes != 2 && elem_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  a->nimages = static_cast<int>(nimages);
  a->mcus_x = static_cast<int>(desc[2]);
  a->row_blocks = static_cast<int>(desc[3]);
  a->level = static_cast<int>(desc[4]);
  void* outs[3] = {o0, o1, o2};
  *tiles = 0;
  for (int c = 0; c < 3; ++c) {
    InvComp& p = a->comp[c];
    const long long* d = desc + 5 + 4 * c;
    p.nblocks = static_cast<int>(d[0]);
    p.v = static_cast<int>(d[1]);
    p.h = static_cast<int>(d[2]);
    p.first = static_cast<int>(d[3]);
    p.out = static_cast<int32_t*>(outs[c]);
    a->tiles[c] = 0;
    p.width = p.h * 8 * a->mcus_x;
    p.plane = 0;
    if (c >= a->ncomp) continue;
    if (p.v < 1 || p.h < 1 || d[0] <= 0 ||
        d[0] % (static_cast<long long>(p.v) * p.h * desc[2]) ||
        d[3] + d[0] > desc[3])
      return static_cast<int>(cudaErrorInvalidValue);
    p.plane = d[0] * 64;
    a->tiles[c] = static_cast<int>((nimages * d[0] + kTile - 1) / kTile);
    *tiles += a->tiles[c];
  }
  a->coeff = coeff;
  a->q = static_cast<const int32_t*>(q);
  a->basis = nullptr;
  return 0;
}

}  // namespace first_exact

namespace first_overflow {

constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kIdctThreads = 256;
constexpr int kIdctWarps = kIdctThreads / 32;

// The top-left sample of block bi of a component whose MCUs hold v x h
// blocks in raster order (luma 2 x 2: TL, TR, BL, BR).
__device__ __forceinline__ void block_origin(int bi, int v, int h,
                                             int mcus_x, int* row,
                                             int* col) {
  const int per = v * h;
  const int m = bi / per;
  const int r = bi - m * per;
  const int my = m / mcus_x;
  const int mx = m - my * mcus_x;
  const int vy = r / h;
  *row = (my * v + vy) * 8;
  *col = (mx * h + (r - vy * h)) * 8;
}


struct IdctComp {
  int nblocks;           // B_c: the component's blocks in one image
  int v, h, per;         // sampling factors: v x h = per blocks an MCU
  int width;             // plane width in samples
  int cap;               // sparse: overflow rows
  int slot0;             // dense: the component's first slot in an MCU
  int mcus_y;            // MCU rows
  int mpu, ux;           // MCUs a unit, units an MCU row
  int units;             // units of the component over the batch
  long long plane_off;   // the plane's first byte in an output row
  long long mlo_off, mhi_off, val_off;  // sparse: fields in an image row
  long long oidx_off, orows_off;        // sparse: overflow tail in flat
};

struct IdctArgs {
  IdctComp comp[3];
  const uint8_t* flat;     // sparse: the upload
  const int16_t* blocks;   // dense: the scan's blocks
  const uint8_t* bad;      // dense: [N * nseg] corruption flags
  const int32_t* q;        // quant tables: [ncomp, 64] or [N, ncomp, 64]
  const float* basis_t;    // [64, 64] transposed: basis_t[k][p] = M[p][k]
  uint8_t* out;            // [N, out_stride]
  long long row_bytes;     // sparse: bytes of one image's row
  long long image_blocks;  // dense: block slots of one image
  long long out_stride;    // bytes of one output row
  long long q_stride;      // int32s from one image's tables to the next
  long long planes;        // dense: the flag byte's place in a row
  int ncomp, nimages, mcus_x, K, level, nseg, mcu_blocks;
};

__device__ __forceinline__ uint32_t load_u32(const uint8_t* p) {
  if ((reinterpret_cast<uintptr_t>(p) & 3) == 0)
    return __ldg(reinterpret_cast<const uint32_t*>(p));
  return static_cast<uint32_t>(__ldg(p)) |
         (static_cast<uint32_t>(__ldg(p + 1)) << 8) |
         (static_cast<uint32_t>(__ldg(p + 2)) << 16) |
         (static_cast<uint32_t>(__ldg(p + 3)) << 24);
}

__device__ __forceinline__ int32_t load_i16(const uint8_t* p) {
  if ((reinterpret_cast<uintptr_t>(p) & 1) == 0)
    return __ldg(reinterpret_cast<const int16_t*>(p));
  return static_cast<int16_t>(static_cast<uint16_t>(__ldg(p)) |
                              (static_cast<uint16_t>(__ldg(p + 1)) << 8));
}

// The terms of the set bits of `bits` (coefficients k0 + bit), ascending,
// while fewer than `limit` terms have been added in all (*r counts them).
template <typename Coef>
__device__ __forceinline__ void add_terms(float s[8], const float* mt,
                                          uint32_t bits, int k0, int* r,
                                          int limit, Coef coef, int g) {
  for (; bits && *r < limit; ++*r) {
    const int k = k0 + __ffs(bits) - 1;
    bits &= bits - 1;
    const float ck = __int2float_rn(coef(k, *r));
    const float4 m0 = *reinterpret_cast<const float4*>(mt + k * 64 + 8 * g);
    const float4 m1 =
        *reinterpret_cast<const float4*>(mt + k * 64 + 8 * g + 4);
    s[0] = __fadd_rn(s[0], __fmul_rn(ck, m0.x));
    s[1] = __fadd_rn(s[1], __fmul_rn(ck, m0.y));
    s[2] = __fadd_rn(s[2], __fmul_rn(ck, m0.z));
    s[3] = __fadd_rn(s[3], __fmul_rn(ck, m0.w));
    s[4] = __fadd_rn(s[4], __fmul_rn(ck, m1.x));
    s[5] = __fadd_rn(s[5], __fmul_rn(ck, m1.y));
    s[6] = __fadd_rn(s[6], __fmul_rn(ck, m1.z));
    s[7] = __fadd_rn(s[7], __fmul_rn(ck, m1.w));
  }
}

// The one arithmetic of every form, run by a group of 8 lanes on one
// block: lane g of the group sums the 8 samples of row g, p = 8 g + x,
// over the block's nonzero coefficients in ascending k (the first `limit`
// set bits of the mask mlo | mhi << 32), coefficient k being coef(k, r)
// for the r-th of them (its dequantized value), each term a float32
// multiply then a float32 add, the sums starting at +0.0f; then + level,
// truncation and the clamp.  Returns the row's 8 samples, x = 0 in the low
// byte.  No lane of the group waits on another: each walks the mask
// alone.
template <typename Coef>
__device__ __forceinline__ uint2 row_samples(const float* mt, int level,
                                             uint32_t mlo, uint32_t mhi,
                                             int limit, Coef coef, int g) {
  float s[8];
#pragma unroll
  for (int x = 0; x < 8; ++x) s[x] = 0.f;
  int r = 0;
  add_terms(s, mt, mlo, 0, &r, limit, coef, g);
  add_terms(s, mt, mhi, 32, &r, limit, coef, g);
  // + level, then truncation and the clamp to [0, 255]: the conversion to
  // unsigned saturates below at 0
  const float lv = __int2float_rn(level);
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int x = 0; x < 8; ++x)
    w[x >> 2] |= min(__float2uint_rz(__fadd_rn(s[x], lv)), 255u)
                 << (8 * (x & 3));
  return make_uint2(w[0], w[1]);
}

// The nonzero mask of a block whose coefficients k = 8 g .. 8 g + 7 lane
// g of each group of 8 holds in c[]: every lane of the group gets the
// whole mask.  All 32 lanes call it.
__device__ __forceinline__ void group_mask(const int32_t c[8], int g,
                                           uint32_t* mlo, uint32_t* mhi) {
  uint32_t byte = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) byte |= static_cast<uint32_t>(c[j] != 0) << j;
  uint32_t lo = g < 4 ? byte << (8 * g) : 0u;
  uint32_t hi = g < 4 ? 0u : byte << (8 * (g - 4));
#pragma unroll
  for (int d = 1; d < 8; d <<= 1) {
    lo |= __shfl_xor_sync(kFullMask, lo, d, 8);
    hi |= __shfl_xor_sync(kFullMask, hi, d, 8);
  }
  *mlo = lo;
  *mhi = hi;
}

// 8 bytes of samples at p (in shared or device memory), one store where
// p is 8-byte aligned.
__device__ __forceinline__ void store_row(uint8_t* p, uint2 v) {
  if ((reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    *reinterpret_cast<uint2*>(p) = v;
    return;
  }
#pragma unroll
  for (int x = 0; x < 8; ++x)
    p[x] = static_cast<uint8_t>(((x < 4 ? v.x : v.y) >> (8 * (x & 3))) & 0xFF);
}


__device__ __forceinline__ void load_basis(float* mt, const float* basis_t,
                                           int t) {
  const float4* src = reinterpret_cast<const float4*>(basis_t);
  for (int i = t; i < 64 * 64 / 4; i += kIdctThreads)
    reinterpret_cast<float4*>(mt)[i] = __ldg(src + i);
}


// The overflow launch: every overflow row's block transformed again from
// the row, its samples stored over the first launch's.  A group of 8
// lanes a row, 4 rows a warp at a time, the rows of the three components
// one after the other; no barrier past the basis and the tables.
__global__ void __launch_bounds__(kIdctThreads)
    idct_overflow_first_kernel(const __grid_constant__ IdctArgs a) {
  __shared__ __align__(16) float mt[64 * 64];
  __shared__ int qs[3][64];
  __shared__ IdctComp comps[3];
  const int t = threadIdx.x;
  const int grp = (t & 31) >> 3;
  const int g = t & 7;
  if (t < 3) comps[t] = a.comp[t];
  if (t < 3 * 64) qs[t >> 6][t & 63] = t < a.ncomp * 64 ? __ldg(a.q + t) : 0;
  load_basis(mt, a.basis_t, t);
  __syncthreads();
  const int i0 = comps[0].cap, i1 = comps[1].cap;
  const int rows = i0 + i1 + comps[2].cap;
  for (int base = 4 * (blockIdx.x * kIdctWarps + (t >> 5)); base < rows;
       base += 4 * kIdctWarps * gridDim.x) {
    const int u = base + grp;
    const int c = u < i0 ? 0 : (u < i0 + i1 ? 1 : 2);
    const IdctComp& C = comps[c];
    const int item = u - (c == 0 ? 0 : (c == 1 ? i0 : i0 + i1));
    int f = -1;
    if (u < rows) {
      f = static_cast<int32_t>(load_u32(a.flat + C.oidx_off + 4ll * item));
      if (f < 0 || f >= a.nimages * C.nblocks) f = -1;
    }
    const uint8_t* row = a.flat + C.orows_off + 128ll * item;
    int32_t cf[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      cf[j] = f >= 0 ? load_i16(row + 2 * (8 * g + j)) : 0;
    uint32_t mlo, mhi;
    group_mask(cf, g, &mlo, &mhi);
    const int* q = qs[c];
    const uint2 v = row_samples(
        mt, a.level, mlo, mhi, 64,
        [&](int k, int) { return load_i16(row + 2 * k) * q[k]; }, g);
    if (f >= 0) {
      const int n = f / C.nblocks;
      int y0, x0;
      block_origin(f - n * C.nblocks, C.v, C.h, a.mcus_x, &y0, &x0);
      store_row(a.out + n * a.out_stride + C.plane_off +
                    static_cast<long long>(y0 + g) * C.width + x0,
                v);
    }
  }
}


template <typename K>
cudaError_t grid_for(K kernel, int threads, long long units, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, 0);
  if (e != cudaSuccess) return e;
  const long long resident =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  *grid = static_cast<int>(units < resident ? units : resident);
  return cudaSuccess;
}


}  // namespace first_overflow

namespace first_sparse {

constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kIdctThreads = 256;
constexpr int kIdctWarps = kIdctThreads / 32;
constexpr int kUnitBlocks = 16;   // a unit's blocks (or one MCU's, if more)
constexpr int kMaxK = 64;         // sparse: at most K value bytes a block
constexpr int kMaxV = 4;          // sampling factors 1..4 (JPEG's limit)
// a unit's samples: 8 v rows of at most 1,024 / (8 v) bytes, each row
// padded to 16 bytes plus 16 (its offset modulo 16); 1,536 bytes at most
// for any sampling factors 1..4
constexpr int kUnitImage = 1536;

enum Form { kSparse, kDense };

struct IdctComp {
  int nblocks;           // B_c: the component's blocks in one image
  int v, h, per;         // sampling factors: v x h = per blocks an MCU
  int width;             // plane width in samples
  int cap;               // sparse: overflow rows
  int tiles;             // sparse: the overflow launch's tiles of them
  int slot0;             // dense: the component's first slot in an MCU
  int mcus_y;            // MCU rows
  int mpu, ux;           // MCUs a unit, units an MCU row
  int units;             // units of the component over the batch
  long long plane_off;   // the plane's first byte in an output row
  long long mlo_off, mhi_off, val_off;  // sparse: fields in an image row
  long long oidx_off, orows_off;        // sparse: overflow tail in flat
};

struct IdctArgs {
  IdctComp comp[3];
  const uint8_t* flat;     // sparse: the upload
  const int16_t* blocks;   // dense: the scan's blocks
  const uint8_t* bad;      // dense: [N * nseg] corruption flags
  const int32_t* q;        // quant tables: [ncomp, 64] or [N, ncomp, 64]
  const float* basis_t;    // [64, 64] transposed: basis_t[k][p] = M[p][k]
  const float* quads;      // overflow: the mirror quads' basis (1,024)
  uint8_t* out;            // [N, out_stride]
  long long row_bytes;     // sparse: bytes of one image's row
  long long image_blocks;  // dense: block slots of one image
  long long out_stride;    // bytes of one output row
  long long q_stride;      // int32s from one image's tables to the next
  long long planes;        // dense: the flag byte's place in a row
  int ncomp, nimages, mcus_x, K, level, nseg, mcu_blocks;
};

__device__ __forceinline__ uint32_t load_u32(const uint8_t* p) {
  if ((reinterpret_cast<uintptr_t>(p) & 3) == 0)
    return __ldg(reinterpret_cast<const uint32_t*>(p));
  return static_cast<uint32_t>(__ldg(p)) |
         (static_cast<uint32_t>(__ldg(p + 1)) << 8) |
         (static_cast<uint32_t>(__ldg(p + 2)) << 16) |
         (static_cast<uint32_t>(__ldg(p + 3)) << 24);
}

__device__ __forceinline__ int32_t load_i16(const uint8_t* p) {
  if ((reinterpret_cast<uintptr_t>(p) & 1) == 0)
    return __ldg(reinterpret_cast<const int16_t*>(p));
  return static_cast<int16_t>(static_cast<uint16_t>(__ldg(p)) |
                              (static_cast<uint16_t>(__ldg(p + 1)) << 8));
}

// The terms of the set bits of `bits` (coefficients k0 + bit), ascending,
// while fewer than `limit` terms have been added in all (*r counts them).
template <typename Coef>
__device__ __forceinline__ void add_terms(float s[8], const float* mt,
                                          uint32_t bits, int k0, int* r,
                                          int limit, Coef coef, int g) {
  for (; bits && *r < limit; ++*r) {
    const int k = k0 + __ffs(bits) - 1;
    bits &= bits - 1;
    const float ck = __int2float_rn(coef(k, *r));
    const float4 m0 = *reinterpret_cast<const float4*>(mt + k * 64 + 8 * g);
    const float4 m1 =
        *reinterpret_cast<const float4*>(mt + k * 64 + 8 * g + 4);
    s[0] = __fadd_rn(s[0], __fmul_rn(ck, m0.x));
    s[1] = __fadd_rn(s[1], __fmul_rn(ck, m0.y));
    s[2] = __fadd_rn(s[2], __fmul_rn(ck, m0.z));
    s[3] = __fadd_rn(s[3], __fmul_rn(ck, m0.w));
    s[4] = __fadd_rn(s[4], __fmul_rn(ck, m1.x));
    s[5] = __fadd_rn(s[5], __fmul_rn(ck, m1.y));
    s[6] = __fadd_rn(s[6], __fmul_rn(ck, m1.z));
    s[7] = __fadd_rn(s[7], __fmul_rn(ck, m1.w));
  }
}

// The one arithmetic of every form, run by a group of 8 lanes on one
// block: lane g of the group sums the 8 samples of row g, p = 8 g + x,
// over the block's nonzero coefficients in ascending k (the first `limit`
// set bits of the mask mlo | mhi << 32), coefficient k being coef(k, r)
// for the r-th of them (its dequantized value), each term a float32
// multiply then a float32 add, the sums starting at +0.0f; then + level,
// truncation and the clamp.  Returns the row's 8 samples, x = 0 in the low
// byte.  No lane of the group waits on another: each walks the mask
// alone.
template <typename Coef>
__device__ __forceinline__ uint2 row_samples(const float* mt, int level,
                                             uint32_t mlo, uint32_t mhi,
                                             int limit, Coef coef, int g) {
  float s[8];
#pragma unroll
  for (int x = 0; x < 8; ++x) s[x] = 0.f;
  int r = 0;
  add_terms(s, mt, mlo, 0, &r, limit, coef, g);
  add_terms(s, mt, mhi, 32, &r, limit, coef, g);
  // + level, then truncation and the clamp to [0, 255]: the conversion to
  // unsigned saturates below at 0
  const float lv = __int2float_rn(level);
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int x = 0; x < 8; ++x)
    w[x >> 2] |= min(__float2uint_rz(__fadd_rn(s[x], lv)), 255u)
                 << (8 * (x & 3));
  return make_uint2(w[0], w[1]);
}

// 8 bytes of samples at p (in shared or device memory), one store where
// p is 8-byte aligned.
__device__ __forceinline__ void store_row(uint8_t* p, uint2 v) {
  if ((reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    *reinterpret_cast<uint2*>(p) = v;
    return;
  }
#pragma unroll
  for (int x = 0; x < 8; ++x)
    p[x] = static_cast<uint8_t>(((x < 4 ? v.x : v.y) >> (8 * (x & 3))) & 0xFF);
}

__device__ __forceinline__ void load_basis(float* mt, const float* basis_t,
                                           int t) {
  const float4* src = reinterpret_cast<const float4*>(basis_t);
  for (int i = t; i < 64 * 64 / 4; i += kIdctThreads)
    reinterpret_cast<float4*>(mt)[i] = __ldg(src + i);
}

// A unit: up to mpu MCUs of one MCU row of one image and component, a
// warp's work at a time (kUnitBlocks blocks, or one MCU where an MCU holds
// more).
struct Unit {
  int c, n, b0, nb;   // component, image, first block (bi), blocks
  int rows, width;    // its samples: v 8 rows of width bytes
  long long dst;      // its top-left sample's byte in out
};

__device__ __forceinline__ Unit unit_of(const IdctArgs& a,
                                        const IdctComp* comps, int u) {
  Unit U;
  U.c = 0;
  while (U.c < 2 && u >= comps[U.c].units) u -= comps[U.c++].units;
  const IdctComp& C = comps[U.c];
  const int per_image = C.mcus_y * C.ux;
  U.n = u / per_image;
  u -= U.n * per_image;
  const int my = u / C.ux;
  const int mx0 = (u - my * C.ux) * C.mpu;
  const int nm = min(C.mpu, a.mcus_x - mx0);
  U.b0 = (my * a.mcus_x + mx0) * C.per;
  U.nb = nm * C.per;
  U.rows = C.v * 8;
  U.width = nm * C.h * 8;
  U.dst = U.n * a.out_stride + C.plane_off +
          static_cast<long long>(my * C.v * 8) * C.width + mx0 * C.h * 8;
  return U;
}

// The warp copies [src, src + nbytes) into dst (shared memory, 4-byte
// aligned), byte j of the range to dst[(src & 3) + j]: the aligned words
// whole, the bytes before the first and after the last bytewise.
__device__ __forceinline__ void warp_copy(uint8_t* dst, const uint8_t* src,
                                          int nbytes, int lane) {
  const int s = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 3);
  const uint8_t* base = src - s;
  const int words = (s + nbytes) >> 2;
  for (int w = lane; w < words; w += 32) {
    if (w == 0 && s != 0) {
      for (int j = s; j < 4; ++j) dst[j] = __ldg(base + j);
    } else {
      reinterpret_cast<uint32_t*>(dst)[w] =
          __ldg(reinterpret_cast<const uint32_t*>(base) + w);
    }
  }
  if (words == 0) {
    if (lane >= s && lane < s + nbytes) dst[lane] = __ldg(base + lane);
  } else if (lane < ((s + nbytes) & 3)) {
    dst[4 * words + lane] = __ldg(base + 4 * words + lane);
  }
}

template <int kForm>
__global__ void __launch_bounds__(kIdctThreads)
    idct_sparse_first_kernel(const __grid_constant__ IdctArgs a) {
  __shared__ __align__(16) float mt[64 * 64];  // mt[k * 64 + p] = M[p][k]
  // per component, a unit's block i: at row y, column x of the unit's
  // samples, (y << 16) | x; and (dense) its slot after the unit's first,
  // m mcu_blocks + r for block r of the unit's MCU m
  __shared__ uint32_t place[3][kUnitBlocks];
  __shared__ int slot[3][kUnitBlocks];
  // per warp: the unit's quant table, its sources (sparse: the masks and
  // the value bytes; dense: the int16 blocks) and its samples
  __shared__ int qw[kIdctWarps][64];
  __shared__ __align__(16) uint8_t src_w[kIdctWarps][kUnitBlocks * 128];
  __shared__ __align__(8) uint8_t nz_w[kIdctWarps][kUnitBlocks * 8];
  __shared__ __align__(16) uint8_t img[kIdctWarps][kUnitImage];
  __shared__ IdctComp comps[3];
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int grp = lane >> 3;   // the group's block of the round's 4
  const int g = t & 7;         // the lane's row of it
  if (t < 3) comps[t] = a.comp[t];
  if (t < 3 * kUnitBlocks) {
    const int c = t / kUnitBlocks;
    const int i = t - c * kUnitBlocks;
    const IdctComp& C = a.comp[c];
    if (C.per > 0) {
      const int m = i / C.per;
      const int r = i - m * C.per;
      const int vy = r / C.h;
      place[c][i] = (static_cast<uint32_t>(vy * 8) << 16) |
                    static_cast<uint32_t>((m * C.h + r - vy * C.h) * 8);
      slot[c][i] = m * a.mcu_blocks + r;
    }
  }
  load_basis(mt, a.basis_t, t);
  if (kForm == kDense) {
    // one flag byte per image: any of its segments corrupt
    for (int n = blockIdx.x; n < a.nimages; n += gridDim.x) {
      int any = 0;
      for (int s = t; s < a.nseg; s += kIdctThreads)
        any |= __ldg(a.bad + static_cast<long long>(n) * a.nseg + s);
      any = __syncthreads_or(any);
      if (t == 0) a.out[n * a.out_stride + a.planes] = any ? 1 : 0;
    }
  }
  __syncthreads();
  // a warp a unit: no barrier past this point
  const int total = comps[0].units + comps[1].units + comps[2].units;
  uint8_t* im = img[warp];
  uint8_t* sw = src_w[warp];
  uint8_t* nz = nz_w[warp];  // dense: the blocks' nonzero masks
  int* q = qw[warp];
  for (int u = blockIdx.x * kIdctWarps + warp; u < total;
       u += gridDim.x * kIdctWarps) {
    const Unit U = unit_of(a, comps, u);
    const IdctComp& C = comps[U.c];
    // the unit's sources in one go, all their loads in flight together
    const int32_t* qsrc = a.q + U.n * a.q_stride + U.c * 64;
    q[lane] = __ldg(qsrc + lane);
    q[lane + 32] = __ldg(qsrc + lane + 32);
    const uint8_t* row = a.flat + U.n * a.row_bytes;
    const uint8_t* vals = sw + 8 * kUnitBlocks;
    if (kForm == kSparse) {
      // lanes 0..15 the low mask words, 16..31 the high ones
      static_assert(2 * kUnitBlocks <= 32 &&
                    (kUnitBlocks & (kUnitBlocks - 1)) == 0, "one word a lane");
      const int i = lane & (kUnitBlocks - 1);
      if (lane < 2 * kUnitBlocks && i < U.nb)
        reinterpret_cast<uint32_t*>(sw)[lane] =
            load_u32(row + (lane < kUnitBlocks ? C.mlo_off : C.mhi_off) +
                     4ll * (U.b0 + i));
      const uint8_t* v = row + C.val_off + static_cast<long long>(U.b0) * a.K;
      warp_copy(sw + 8 * kUnitBlocks, v, U.nb * a.K, lane);
      vals += reinterpret_cast<uintptr_t>(v) & 3;
    } else {
      const long long first = U.n * a.image_blocks +
                              static_cast<long long>(U.b0 / C.per) *
                                  a.mcu_blocks + C.slot0;
      for (int k = lane; k < 8 * U.nb; k += 32) {
        const int16_t* src = a.blocks +
            ((first + slot[U.c][k >> 3]) << 6) + 8 * (k & 7);
        int4 w;
        if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
          w = __ldg(reinterpret_cast<const int4*>(src));
        } else {
          int h[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            h[j] = static_cast<uint16_t>(__ldg(src + j));
          w = make_int4(h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                        h[4] | (h[5] << 16), h[6] | (h[7] << 16));
        }
        reinterpret_cast<int4*>(sw)[k] = w;
        // bit j of byte k: coefficient 8 k + j is nonzero
        const int ws[4] = {w.x, w.y, w.z, w.w};
        uint32_t byte = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t m = __vcmpne2(static_cast<uint32_t>(ws[j]), 0u);
          byte |= ((m & 1u) | ((m >> 15) & 2u)) << (2 * j);
        }
        nz[k] = static_cast<uint8_t>(byte);
      }
    }
    __syncwarp();
    const int pitch = ((U.width + 15) & ~15) + 16;
    // row y of the unit's samples sits in im at its destination's address
    // modulo 16: (shift + y wshift) mod 16
    const int shift = static_cast<int>(
        (reinterpret_cast<uintptr_t>(a.out) + U.dst) & 15);
    const int wshift = C.width & 15;
    for (int i0 = 0; i0 < U.nb; i0 += 4) {
      // the round's blocks: group grp takes block i0 + grp
      const int i = i0 + grp;
      const bool live = i < U.nb;
      uint2 v;
      if (kForm == kSparse) {
        // the first K set bits of the mask, ascending, take the value
        // bytes in order (vals[rank])
        const uint32_t* m = reinterpret_cast<const uint32_t*>(sw);
        const int8_t* vb = reinterpret_cast<const int8_t*>(vals + i * a.K);
        v = row_samples(mt, a.level, live ? m[i] : 0u,
                        live ? m[kUnitBlocks + i] : 0u, a.K,
                        [&](int k, int r) { return vb[r] * q[k]; }, g);
      } else {
        const int16_t* blk = reinterpret_cast<const int16_t*>(sw) + 64 * i;
        const uint2 m = live ? reinterpret_cast<const uint2*>(nz)[i]
                             : make_uint2(0u, 0u);
        v = row_samples(mt, a.level, m.x, m.y, 64,
                        [&](int k, int) { return blk[k] * q[k]; }, g);
      }
      if (live) {
        const uint32_t at = place[U.c][i];
        const int y = static_cast<int>(at >> 16) + g;
        store_row(im + y * pitch + ((shift + y * wshift) & 15) +
                      (at & 0xFFFF), v);
      }
    }
    __syncwarp();
    // out: row after row.  The aligned 16-byte chunks of every row in
    // 16-byte stores that fill whole sectors; where a row's destination is
    // not aligned, the bytes before its first chunk and after its last one
    // a row at a time, neighbouring lanes on neighbouring bytes.
    const int per_row = (U.width >> 4) + 1;
    for (int y = lane / per_row, j = lane - y * per_row; y < U.rows;) {
      const int sh = (shift + y * wshift) & 15;
      const int head = min((16 - sh) & 15, U.width);
      if (j < ((U.width - head) >> 4))
        *reinterpret_cast<int4*>(a.out + U.dst +
                                 static_cast<long long>(y) * C.width + head +
                                 16 * j) =
            *reinterpret_cast<const int4*>(im + y * pitch + sh + head +
                                           16 * j);
      for (j += 32; j >= per_row; j -= per_row) ++y;
    }
    if ((shift | wshift | (U.width & 15)) != 0) {
      // a row's ends hold at most 30 bytes, at most 15 (and two rows a
      // pass) where the width is a multiple of 16
      const int two = (U.width & 15) == 0;
      const int b = two ? lane & 15 : lane;
      for (int y = two ? lane >> 4 : 0; y < U.rows; y += 1 + two) {
        const int sh = (shift + y * wshift) & 15;
        const int head = min((16 - sh) & 15, U.width);
        const int full = (U.width - head) >> 4;
        const int x = b < head ? b : head + 16 * full + (b - head);
        if (x < U.width)
          a.out[U.dst + static_cast<long long>(y) * C.width + x] =
              im[y * pitch + sh + x];
      }
    }
    __syncwarp();
  }
}

template <typename K>
cudaError_t grid_for(K kernel, int threads, long long units, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, 0);
  if (e != cudaSuccess) return e;
  const long long resident =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  *grid = static_cast<int>(units < resident ? units : resident);
  return cudaSuccess;
}

// The first dense launch, as block_transforms.cu ran it before the dense
// launch took the union walk (its sparse branches gone by then).
__global__ void __launch_bounds__(kIdctThreads)
    idct_dense_first_kernel(const __grid_constant__ IdctArgs a) {
  __shared__ __align__(16) float mt[64 * 64];  // mt[k * 64 + p] = M[p][k]
  // per component, a unit's block i: at row y, column x of the unit's
  // samples, (y << 16) | x; and its slot after the unit's first, m
  // mcu_blocks + r for block r of the unit's MCU m
  __shared__ uint32_t place[3][kUnitBlocks];
  __shared__ int slot[3][kUnitBlocks];
  // per warp: the unit's quant table, its int16 blocks, their nonzero
  // masks and its samples
  __shared__ int qw[kIdctWarps][64];
  __shared__ __align__(16) uint8_t src_w[kIdctWarps][kUnitBlocks * 128];
  __shared__ __align__(8) uint8_t nz_w[kIdctWarps][kUnitBlocks * 8];
  __shared__ __align__(16) uint8_t img[kIdctWarps][kUnitImage];
  __shared__ IdctComp comps[3];
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int grp = lane >> 3;   // the group's block of the round's 4
  const int g = t & 7;         // the lane's row of it
  if (t < 3) comps[t] = a.comp[t];
  if (t < 3 * kUnitBlocks) {
    const int c = t / kUnitBlocks;
    const int i = t - c * kUnitBlocks;
    const IdctComp& C = a.comp[c];
    if (C.per > 0) {
      const int m = i / C.per;
      const int r = i - m * C.per;
      const int vy = r / C.h;
      place[c][i] = (static_cast<uint32_t>(vy * 8) << 16) |
                    static_cast<uint32_t>((m * C.h + r - vy * C.h) * 8);
      slot[c][i] = m * a.mcu_blocks + r;
    }
  }
  load_basis(mt, a.basis_t, t);
  // one flag byte per image: any of its segments corrupt
  for (int n = blockIdx.x; n < a.nimages; n += gridDim.x) {
    int any = 0;
    for (int s = t; s < a.nseg; s += kIdctThreads)
      any |= __ldg(a.bad + static_cast<long long>(n) * a.nseg + s);
    any = __syncthreads_or(any);
    if (t == 0) a.out[n * a.out_stride + a.planes] = any ? 1 : 0;
  }
  __syncthreads();
  // a warp a unit: no barrier past this point
  const int total = comps[0].units + comps[1].units + comps[2].units;
  uint8_t* im = img[warp];
  uint8_t* sw = src_w[warp];
  uint8_t* nz = nz_w[warp];  // the blocks' nonzero masks
  int* q = qw[warp];
  for (int u = blockIdx.x * kIdctWarps + warp; u < total;
       u += gridDim.x * kIdctWarps) {
    const Unit U = unit_of(a, comps, u);
    const IdctComp& C = comps[U.c];
    // the unit's sources in one go, all their loads in flight together
    const int32_t* qsrc = a.q + U.n * a.q_stride + U.c * 64;
    q[lane] = __ldg(qsrc + lane);
    q[lane + 32] = __ldg(qsrc + lane + 32);
    const long long first = U.n * a.image_blocks +
                            static_cast<long long>(U.b0 / C.per) *
                                a.mcu_blocks + C.slot0;
    for (int k = lane; k < 8 * U.nb; k += 32) {
      const int16_t* src = a.blocks +
          ((first + slot[U.c][k >> 3]) << 6) + 8 * (k & 7);
      int4 w;
      if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        w = __ldg(reinterpret_cast<const int4*>(src));
      } else {
        int h[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          h[j] = static_cast<uint16_t>(__ldg(src + j));
        w = make_int4(h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                      h[4] | (h[5] << 16), h[6] | (h[7] << 16));
      }
      reinterpret_cast<int4*>(sw)[k] = w;
      // bit j of byte k: coefficient 8 k + j is nonzero
      const int ws[4] = {w.x, w.y, w.z, w.w};
      uint32_t byte = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t m = __vcmpne2(static_cast<uint32_t>(ws[j]), 0u);
        byte |= ((m & 1u) | ((m >> 15) & 2u)) << (2 * j);
      }
      nz[k] = static_cast<uint8_t>(byte);
    }
    __syncwarp();
    const int pitch = ((U.width + 15) & ~15) + 16;
    // row y of the unit's samples sits in im at its destination's address
    // modulo 16: (shift + y wshift) mod 16
    const int shift = static_cast<int>(
        (reinterpret_cast<uintptr_t>(a.out) + U.dst) & 15);
    const int wshift = C.width & 15;
    for (int i0 = 0; i0 < U.nb; i0 += 4) {
      // the round's blocks: group grp takes block i0 + grp
      const int i = i0 + grp;
      const bool live = i < U.nb;
      const int16_t* blk = reinterpret_cast<const int16_t*>(sw) + 64 * i;
      const uint2 m = live ? reinterpret_cast<const uint2*>(nz)[i]
                           : make_uint2(0u, 0u);
      const uint2 v = row_samples(mt, a.level, m.x, m.y, 64,
                                  [&](int k, int) { return blk[k] * q[k]; },
                                  g);
      if (live) {
        const uint32_t at = place[U.c][i];
        const int y = static_cast<int>(at >> 16) + g;
        store_row(im + y * pitch + ((shift + y * wshift) & 15) +
                      (at & 0xFFFF), v);
      }
    }
    __syncwarp();
    // out: row after row.  The aligned 16-byte chunks of every row in
    // 16-byte stores that fill whole sectors; where a row's destination is
    // not aligned, the bytes before its first chunk and after its last one
    // a row at a time, neighbouring lanes on neighbouring bytes.
    const int per_row = (U.width >> 4) + 1;
    for (int y = lane / per_row, j = lane - y * per_row; y < U.rows;) {
      const int sh = (shift + y * wshift) & 15;
      const int head = min((16 - sh) & 15, U.width);
      if (j < ((U.width - head) >> 4))
        *reinterpret_cast<int4*>(a.out + U.dst +
                                 static_cast<long long>(y) * C.width + head +
                                 16 * j) =
            *reinterpret_cast<const int4*>(im + y * pitch + sh + head +
                                           16 * j);
      for (j += 32; j >= per_row; j -= per_row) ++y;
    }
    if ((shift | wshift | (U.width & 15)) != 0) {
      // a row's ends hold at most 30 bytes, at most 15 (and two rows a
      // pass) where the width is a multiple of 16
      const int two = (U.width & 15) == 0;
      const int b = two ? lane & 15 : lane;
      for (int y = two ? lane >> 4 : 0; y < U.rows; y += 1 + two) {
        const int sh = (shift + y * wshift) & 15;
        const int head = min((16 - sh) & 15, U.width);
        const int full = (U.width - head) >> 4;
        const int x = b < head ? b : head + 16 * full + (b - head);
        if (x < U.width)
          a.out[U.dst + static_cast<long long>(y) * C.width + x] =
              im[y * pitch + sh + x];
      }
    }
    __syncwarp();
  }
}

}  // namespace first_sparse

namespace first_fdct {

// Kernel 1 of block_transforms.cu as PR 9 designed it: 8 warps a thread
// block, 4 blocks a warp at a time.
constexpr int kFdctThreads = 256;
constexpr int kFdctWarps = kFdctThreads / 32;
constexpr int kFdctTile = 4;      // blocks a warp's tile
constexpr int kBlockWords = 72;   // a block's words in the warp's tile
constexpr int kRowWords = 9;      // a row's words there (the row pass)

struct FdctComp {
  const void* base;       // the plane's first sample
  long long sn, sr, sc;   // element strides: image, row, column
  const int32_t* q;       // [64] quant table
  int32_t* out;           // [N, nblocks, 64]
  int nblocks;
  float rcp_nb;           // 1 / nblocks rounded up (set in the kernel)
};

struct FdctArgs {
  FdctComp comp[3];
  float cosv[64];         // C[v][x], v * 8 + x: the same in every lane
  float scale[64];        // S[u][v], u * 8 + v
  int nimages, mcus_x, gray, rounded;
  int ty, tc;             // tiles of luma, of each chroma component
};

// A lane's row of 8 samples as loaded: 8 bytes (int8) or 8 words.
template <typename T>
struct RowRaw;
template <>
struct RowRaw<int8_t> {
  uint2 w;
  __device__ __forceinline__ void zero() { w = make_uint2(0u, 0u); }
  __device__ __forceinline__ float at(int j) const {
    const uint32_t v = j < 4 ? w.x : w.y;
    return __int2float_rn(static_cast<int8_t>((v >> (8 * (j & 3))) & 0xFF));
  }
};
template <>
struct RowRaw<int32_t> {
  int4 a, b;
  __device__ __forceinline__ void zero() {
    a = b = make_int4(0, 0, 0, 0);
  }
  __device__ __forceinline__ float at(int j) const {
    const int4& p = j < 4 ? a : b;
    const int k = j & 3;
    return __int2float_rn(k == 0 ? p.x : (k == 1 ? p.y : (k == 2 ? p.z
                                                                  : p.w)));
  }
};

__device__ __forceinline__ void load_row(const int8_t* src, long long sc,
                                         RowRaw<int8_t>* raw) {
  if (sc == 1 && (reinterpret_cast<uintptr_t>(src) & 7) == 0) {
    raw->w = __ldg(reinterpret_cast<const uint2*>(src));
    return;
  }
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    lo |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(src + j * sc)))
          << (8 * j);
    hi |= static_cast<uint32_t>(
              static_cast<uint8_t>(__ldg(src + (j + 4) * sc)))
          << (8 * j);
  }
  raw->w = make_uint2(lo, hi);
}

__device__ __forceinline__ void load_row(const int32_t* src, long long sc,
                                         RowRaw<int32_t>* raw) {
  if (sc == 1 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    raw->a = __ldg(reinterpret_cast<const int4*>(src));
    raw->b = __ldg(reinterpret_cast<const int4*>(src) + 1);
    return;
  }
  raw->a = make_int4(__ldg(src), __ldg(src + sc), __ldg(src + 2 * sc),
                     __ldg(src + 3 * sc));
  raw->b = make_int4(__ldg(src + 4 * sc), __ldg(src + 5 * sc),
                     __ldg(src + 6 * sc), __ldg(src + 7 * sc));
}

// C's truncating division num / den for num >= 0 and den >= 1, from
// rcp = 1/den rounded up (the quantizer's and the index arithmetic's
// divisions).  Below 2^22 the product num rcp, rounded up, is at least
// num / den and below num / den + num / den 2^-22 (1 + 2^-24), which stays
// under the next integer since the remainder is at most den - 1; so its
// truncation is the quotient.  Above, or where den is 2^24 or more (rcp
// 0), the integer division.
__device__ __forceinline__ int div_exact(int num, int den, float rcp) {
  if (num >= (1 << 22) || rcp == 0.f) return num / den;
  return __float2int_rz(__fmul_ru(__int2float_rn(num), rcp));
}

// 1/d rounded up for div_exact, 0 from 2^24 on.
__device__ __forceinline__ float rcp_up(int d) {
  return d < (1 << 24) ? __frcp_ru(__int2float_rn(d)) : 0.f;
}

// Tile `tile` (kFdctTile blocks) -> its component and first block; the
// lane's row (lane = 8 b + r: row r of the tile's block b) loaded into
// *raw, zeros past the component's last block and for gray chroma.
template <typename T>
__device__ __forceinline__ void fdct_load(const FdctArgs& a,
                                          const FdctComp* comps,
                                          float rcp_mx, int tile, int lane,
                                          int* c, int* first,
                                          RowRaw<T>* raw) {
  int lt = tile;
  *c = lt < a.ty ? 0 : (lt < a.ty + a.tc ? 1 : 2);
  lt -= *c == 0 ? 0 : (*c == 1 ? a.ty : a.ty + a.tc);
  *first = lt * kFdctTile;
  raw->zero();
  const FdctComp& P = comps[*c];
  const int f = *first + (lane >> 3);
  if (f >= a.nimages * P.nblocks || (a.gray && *c > 0)) return;
  const int n = div_exact(f, P.nblocks, P.rcp_nb);
  const int bi = f - n * P.nblocks;
  // 4:2:0: luma blocks TL, TR, BL, BR of MCU bi / 4, chroma MCU bi
  const int m = *c == 0 ? bi >> 2 : bi;
  const int my = div_exact(m, a.mcus_x, rcp_mx);
  const int mx = m - my * a.mcus_x;
  const int y = (*c == 0 ? (2 * my + ((bi >> 1) & 1)) * 8 : my * 8) +
                (lane & 7);
  const int x0 = *c == 0 ? (2 * mx + (bi & 1)) * 8 : mx * 8;
  const T* src = static_cast<const T*>(P.base) + n * P.sn + y * P.sr +
                 x0 * P.sc;
  load_row(src, P.sc, raw);
}

template <typename T>
__global__ void __launch_bounds__(kFdctThreads)
    fdct_first_kernel(const __grid_constant__ FdctArgs a) {
  __shared__ __align__(16) float tiles[kFdctWarps][kFdctTile * kBlockWords];
  __shared__ float scale[64];
  __shared__ int den[2][64];     // luma, chroma: q, or 2 q when rounded
  __shared__ int bias[2][64];    // what a rounded quotient adds: q, or 0
  __shared__ float rcp[2][64];   // 1 / den, rounded up
  __shared__ FdctComp comps[3];
  const int t = threadIdx.x;
  const int lane = t & 31;
  if (t < 3) {
    comps[t] = a.comp[t];
    comps[t].rcp_nb = rcp_up(a.comp[t].nblocks);
  }
  const float rcp_mx = rcp_up(a.mcus_x);
  if (t < 128) {
    const int k = t & 63;
    const int q = __ldg(a.comp[t >> 6].q + k);
    const int d = a.rounded ? 2 * q : q;
    den[t >> 6][k] = d;
    bias[t >> 6][k] = a.rounded ? q : 0;
    rcp[t >> 6][k] = rcp_up(d);
  } else if (t < 192) {
    scale[t - 128] = a.scale[t - 128];
  }
  __syncthreads();
  float* tile = tiles[t >> 5];
  const int b = lane >> 3;      // the lane's block in the tile
  const int r = lane & 7;       // its row (row pass), then column
  const int total = a.ty + 2 * a.tc;
  const int warps = gridDim.x * kFdctWarps;
  // the samples of the next tile are loaded while this one is summed
  int c_next = 0, first_next = 0;
  RowRaw<T> next;
  int tile_i = blockIdx.x * kFdctWarps + (t >> 5);
  if (tile_i < total)
    fdct_load<T>(a, comps, rcp_mx, tile_i, lane, &c_next, &first_next,
                 &next);
  for (; tile_i < total; tile_i += warps) {
    const int c = c_next;
    const int first = first_next;
    const RowRaw<T> cur = next;
    if (tile_i + warps < total)
      fdct_load<T>(a, comps, rcp_mx, tile_i + warps, lane, &c_next,
                   &first_next, &next);
    const FdctComp& P = comps[c];
    const int nb = a.nimages * P.nblocks;
    int4* out = reinterpret_cast<int4*>(P.out + static_cast<long long>(first)
                                                    * 64);
    if (a.gray && c > 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (first + ((lane + 32 * j) >> 4) < nb)
          out[lane + 32 * j] = make_int4(0, 0, 0, 0);
      continue;
    }
    // row pass: t[r][v], into the tile at b 72 + r 9 + v
    float x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = cur.at(j);
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      // C[0][x] is 1: its products are the samples themselves
      float s = v == 0 ? x[0] : __fmul_rn(x[0], a.cosv[v * 8]);
#pragma unroll
      for (int k = 1; k < 8; ++k)
        s = __fadd_rn(s, v == 0 ? x[k] : __fmul_rn(x[k], a.cosv[v * 8 + k]));
      tile[b * kBlockWords + r * kRowWords + v] = s;
    }
    __syncwarp();
    // column pass: lane 8 b + v takes column v of block b
    float col[8];
#pragma unroll
    for (int y = 0; y < 8; ++y)
      col[y] = tile[b * kBlockWords + y * kRowWords + r];
    __syncwarp();
    const int* dn = den[c > 0];
    const int* bs = bias[c > 0];
    const float* rc = rcp[c > 0];
    const int up = a.rounded;
    int* qtile = reinterpret_cast<int*>(tile);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float o = u == 0 ? col[0] : __fmul_rn(a.cosv[u * 8], col[0]);
#pragma unroll
      for (int y = 1; y < 8; ++y)
        o = __fadd_rn(o, u == 0 ? col[y]
                                : __fmul_rn(a.cosv[u * 8 + y], col[y]));
      // quantize: |c| / q, or (2|c| + q) / (2q) rounded
      const int k = u * 8 + r;
      const int cf = __float2int_rz(__fmul_rn(o, scale[k]));
      const int mag = cf < 0 ? -cf : cf;
      const int qv = div_exact((mag << up) + bs[k], dn[k], rc[k]);
      qtile[b * kBlockWords + k] = cf < 0 ? -qv : qv;
    }
    __syncwarp();
    // out: lane l stores words 4 (l + 32 j) .. + 3 of the tile's 256
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int e = 4 * (lane + 32 * j);
      if (first + (e >> 6) < nb)
        out[lane + 32 * j] = *reinterpret_cast<const int4*>(
            &qtile[(e >> 6) * kBlockWords + (e & 63)]);
    }
    __syncwarp();
  }
}

template <typename K>
cudaError_t grid_for(K kernel, int threads, long long units, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, 0);
  if (e != cudaSuccess) return e;
  const long long resident =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  *grid = static_cast<int>(units < resident ? units : resident);
  return cudaSuccess;
}

}  // namespace first_fdct

extern "C" {

// The first fused entropy kernel, with the arguments of
// jz_encode_blocks_batch but words [N, B_c, 64] uint64 (32-bit words
// zero-extended).
int jz_prev_encode_blocks_fused(
    const void* yq, const void* cbq, const void* crq, const void* luma,
    const void* chroma, int nsets, int custom, const void* carry, void* wy,
    void* wcb, void* wcr, void* by, void* bcb, void* bcr, long long nimages,
    long long luma_blocks, long long chroma_blocks, long long ri,
    void* stream) {
  using namespace fused_first;
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
  auto kernel = custom ? encode_blocks_fused_first_kernel<true>
                       : encode_blocks_fused_first_kernel<false>;
  kernel<<<grid, kWarpsPerCta * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      y, cb, cr, static_cast<const int32_t*>(carry),
      static_cast<int>(nimages), nsets);
  return static_cast<int>(cudaGetLastError());
}

// The concat with 64-bit word loads, with the arguments of
// jz_concat_streams but words [N, B_c, 64] uint64 (the low 32 bits used).
int jz_prev_concat_streams(const void* wy, const void* wcb, const void* wcr,
                           const void* by, const void* bcb, const void* bcr,
                           void* combined, long long nimages, long long nm,
                           long long ri, long long nseg, long long maxw,
                           long long tile_mcus, long long ntiles,
                           void* stream) {
  using namespace concat_first;
  if (nimages <= 0) return 0;
  if (nm <= 0 || ri < 0 || maxw <= 0 ||
      nseg != (ri > 0 ? (nm + ri - 1) / ri : 0) || tile_mcus <= 0 ||
      tile_mcus > kMaxTileMcus || ntiles <= 0 || ntiles * tile_mcus < nm ||
      (ntiles - 1) * tile_mcus >= nm ||
      reinterpret_cast<uintptr_t>(by) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nimages * ntiles > 0x7FFFFFFFll)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const Comps c = {static_cast<const uint64_t*>(wy),
                   static_cast<const uint64_t*>(wcb),
                   static_cast<const uint64_t*>(wcr),
                   static_cast<const int32_t*>(by),
                   static_cast<const int32_t*>(bcb),
                   static_cast<const int32_t*>(bcr)};
  static const cudaError_t attr = cudaFuncSetAttribute(
      concat_streams_first_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(kMaxTileMcus, kStage)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long stage_words = maxw < kStage ? maxw : kStage;
  concat_streams_first_kernel<<<static_cast<unsigned>(nimages * ntiles),
                                kThreads, smem_bytes(tile_mcus, stage_words),
                                static_cast<cudaStream_t>(stream)>>>(
      c, nimages, nm, ri, nseg, maxw, tile_mcus, ntiles, stage_words,
      static_cast<int64_t*>(combined));
  return static_cast<int>(cudaGetLastError());
}

// PR 9's fDCT kernel, with the arguments of jz_fdct_quantize as it was
// then: tabs (host memory), 128 float32, C[v][x] then S[u][v] (the
// separable form's tables, passed to the kernel as parameters).
int jz_prev_fdct_quantize(int elem_bytes, const long long* desc,
                          const float* tabs, const void* y, const void* cb,
                          const void* cr, const void* yq, const void* cq,
                          void* oy, void* ocb, void* ocr, void* stream) {
  using namespace first_fdct;
  const long long nimages = desc[0], mcus_y = desc[1], mcus_x = desc[2];
  if (nimages <= 0 || mcus_y <= 0 || mcus_x <= 0) return 0;
  const long long nm = mcus_y * mcus_x;
  if (nimages * 4 * nm > 0x7FFFFFFFll || (elem_bytes != 1 && elem_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  FdctArgs a;
  const void* bases[3] = {y, cb, cr};
  void* outs[3] = {oy, ocb, ocr};
  for (int c = 0; c < 3; ++c) {
    FdctComp& p = a.comp[c];
    p.base = bases[c];
    p.sn = desc[5 + 3 * c];
    p.sr = desc[6 + 3 * c];
    p.sc = desc[7 + 3 * c];
    p.q = static_cast<const int32_t*>(c == 0 ? yq : cq);
    p.out = static_cast<int32_t*>(outs[c]);
    p.nblocks = static_cast<int>(c == 0 ? 4 * nm : nm);
  }
  for (int i = 0; i < 64; ++i) {
    a.cosv[i] = tabs[i];
    a.scale[i] = tabs[64 + i];
  }
  a.nimages = static_cast<int>(nimages);
  a.mcus_x = static_cast<int>(mcus_x);
  a.gray = desc[3] != 0;
  a.rounded = desc[4] != 0;
  a.ty = static_cast<int>((nimages * 4 * nm + kFdctTile - 1) / kFdctTile);
  a.tc = static_cast<int>((nimages * nm + kFdctTile - 1) / kFdctTile);
  const long long blocks_needed =
      (a.ty + 2ll * a.tc + kFdctWarps - 1) / kFdctWarps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int grid = 0;
  cudaError_t e;
  if (elem_bytes == 1) {
    e = grid_for(fdct_first_kernel<int8_t>, kFdctThreads, blocks_needed,
                 &grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    fdct_first_kernel<int8_t><<<grid, kFdctThreads, 0, s>>>(a);
  } else {
    e = grid_for(fdct_first_kernel<int32_t>, kFdctThreads, blocks_needed,
                 &grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    fdct_first_kernel<int32_t><<<grid, kFdctThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The first exact kernels, with the arguments of jz_fdct_quantize_exact and
// jz_idct_planes_exact (exact_transforms.cu).
int jz_prev_fdct_quantize_exact(int elem_bytes, const long long* desc,
                                const double* tabs, const void* y,
                                const void* cb, const void* cr,
                                const void* yq, const void* cq, void* oy,
                                void* ocb, void* ocr, void* stream) {
  using namespace first_exact;
  const long long nimages = desc[0], mcus_y = desc[1], mcus_x = desc[2];
  if (nimages <= 0 || mcus_y <= 0 || mcus_x <= 0) return 0;
  const long long nm = mcus_y * mcus_x;
  if (nimages * 4 * nm > 0x7FFFFFFFll || (elem_bytes != 1 && elem_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a;
  const void* bases[3] = {y, cb, cr};
  void* outs[3] = {oy, ocb, ocr};
  for (int c = 0; c < 3; ++c) {
    FwdComp& p = a.comp[c];
    p.base = bases[c];
    p.sn = desc[5 + 3 * c];
    p.sr = desc[6 + 3 * c];
    p.sc = desc[7 + 3 * c];
    p.q = static_cast<const int32_t*>(c == 0 ? yq : cq);
    p.out = static_cast<int32_t*>(outs[c]);
    p.nblocks = static_cast<int>(c == 0 ? 4 * nm : nm);
  }
  for (int i = 0; i < 64; ++i) a.cosv[i] = tabs[i];
  for (int i = 0; i < 8; ++i) a.cu[i] = tabs[64 + i];
  a.nimages = static_cast<int>(nimages);
  a.mcus_x = static_cast<int>(mcus_x);
  a.gray = desc[3] != 0;
  a.rounded = desc[4] != 0;
  a.ty = static_cast<int>((nimages * 4 * nm + kTile - 1) / kTile);
  a.tc = static_cast<int>((nimages * nm + kTile - 1) / kTile);
  const long long tiles = a.ty + 2ll * a.tc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return elem_bytes == 1
             ? launch(fdct_exact_first_kernel<int8_t>, tiles, a, s)
             : launch(fdct_exact_first_kernel<int32_t>, tiles, a, s);
}

int jz_prev_idct_planes_exact(int elem_bytes, const long long* desc,
                              const double* tabs, const void* coeff,
                              const void* q, void* o0, void* o1, void* o2,
                              void* stream) {
  using namespace first_exact;
  if (desc[0] <= 0) return 0;
  InvArgs a;
  long long tiles = 0;
  const int rc = inverse_layout(elem_bytes, desc, coeff, q, o0, o1, o2, &a,
                                &tiles);
  if (rc) return rc;
  for (int i = 0; i < 64; ++i) {
    a.cosv[i] = tabs[i];
    a.cucv[i] = tabs[72 + i];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return elem_bytes == 2
             ? launch(idct_exact_first_kernel<int16_t>, tiles, a, s)
             : launch(idct_exact_first_kernel<int32_t>, tiles, a, s);
}

// The first fast rgb IDCT, with the arguments of jz_idct_planes_rgb but
// the basis transposed, basis[k * 64 + p] = M[p][k].
int jz_prev_idct_planes_rgb(int elem_bytes, const long long* desc,
                            const void* basis, const void* coeff,
                            const void* q, void* o0, void* o1, void* o2,
                            void* stream) {
  using namespace first_exact;
  if (desc[0] <= 0) return 0;
  InvArgs a;
  long long tiles = 0;
  const int rc = inverse_layout(elem_bytes, desc, coeff, q, o0, o1, o2, &a,
                                &tiles);
  if (rc) return rc;
  a.basis = static_cast<const float*>(basis);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return elem_bytes == 2
             ? launch(idct_rgb_first_kernel<int16_t>, tiles, a, s)
             : launch(idct_rgb_first_kernel<int32_t>, tiles, a, s);
}

// The first overflow launch alone (idct_overflow_first_kernel: a group of
// 8 lanes a row, its coefficients read again from device memory for every
// term, the [64][64] basis in shared memory), with jz_idct_planes's
// sparse-form desc, upload, tables and planes but the basis transposed
// only; the caller makes the sparse launch first, whose pixels it
// overwrites.
int jz_prev_idct_planes_overflow(const long long* desc, const void* src,
                                 const void* q, const void* basis_t,
                                 void* out, void* stream) {
  using namespace first_overflow;
  IdctArgs a;
  a.nimages = static_cast<int>(desc[0]);
  a.ncomp = static_cast<int>(desc[1]);
  if (a.nimages <= 0) return 0;
  if (a.ncomp < 1 || a.ncomp > 3 || desc[0] > 0x7FFFFFFFll || desc[2] <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  a.mcus_x = static_cast<int>(desc[2]);
  a.level = static_cast<int>(desc[4]);
  a.out_stride = desc[8];
  long long caps = 0;
  for (int c = 0; c < 3; ++c) {
    const long long* d = desc + 12 + 12 * c;
    IdctComp& p = a.comp[c];
    p.nblocks = c < a.ncomp ? static_cast<int>(d[0]) : 0;
    p.v = static_cast<int>(d[1]);
    p.h = static_cast<int>(d[2]);
    p.width = static_cast<int>(d[3]);
    p.cap = c < a.ncomp ? static_cast<int>(d[4]) : 0;
    p.plane_off = d[6];
    p.oidx_off = d[10];
    p.orows_off = d[11];
    caps += p.cap;
  }
  if (caps == 0) return 0;
  a.flat = static_cast<const uint8_t*>(src);
  a.q = static_cast<const int32_t*>(q);
  a.basis_t = static_cast<const float*>(basis_t);
  a.out = static_cast<uint8_t*>(out);
  int grid = 0;
  const cudaError_t e = grid_for(idct_overflow_first_kernel, kIdctThreads,
                                 (caps + 4 * kIdctWarps - 1) /
                                     (4 * kIdctWarps), &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  idct_overflow_first_kernel<<<grid, kIdctThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The first sparse launch of the ycc420 IDCT alone (idct_sparse_first_kernel:
// a group of 8 lanes a block, each lane a row of 8 samples over its own
// block's mask, the [64][64] basis in shared memory, the strip staged in
// shared memory), with jz_idct_planes's sparse-form desc, upload, tables
// and planes and the basis transposed; it writes the level where an
// overflow row replaces a block, and no overflow launch follows.
int jz_prev_idct_planes_sparse(const long long* desc, const void* src,
                               const void* q, const void* basis_t,
                               void* out, void* stream) {
  using namespace first_sparse;
  IdctArgs a;
  a.nimages = static_cast<int>(desc[0]);
  a.ncomp = static_cast<int>(desc[1]);
  if (a.nimages <= 0) return 0;
  if (a.ncomp < 1 || a.ncomp > 3 || desc[0] > 0x7FFFFFFFll ||
      desc[2] <= 0 || desc[3] < 1 || desc[3] > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  a.mcus_x = static_cast<int>(desc[2]);
  a.K = static_cast<int>(desc[3]);
  a.level = static_cast<int>(desc[4]);
  a.nseg = static_cast<int>(desc[5]);
  a.row_bytes = desc[6];
  a.image_blocks = desc[7];
  a.out_stride = desc[8];
  a.q_stride = desc[9];
  a.planes = desc[10];
  a.mcu_blocks = static_cast<int>(desc[11]);
  long long units = 0;
  for (int c = 0; c < 3; ++c) {
    const long long* d = desc + 12 + 12 * c;
    IdctComp& p = a.comp[c];
    p.nblocks = static_cast<int>(d[0]);
    p.v = static_cast<int>(d[1]);
    p.h = static_cast<int>(d[2]);
    p.width = static_cast<int>(d[3]);
    p.cap = p.tiles = 0;
    p.slot0 = static_cast<int>(d[5]);
    p.plane_off = d[6];
    p.mlo_off = d[7];
    p.mhi_off = d[8];
    p.val_off = d[9];
    p.oidx_off = d[10];
    p.orows_off = d[11];
    p.per = p.mcus_y = p.mpu = p.ux = p.units = 0;
    if (c < a.ncomp) {
      if (p.v < 1 || p.v > kMaxV || p.h < 1 || p.h > kMaxV ||
          d[0] <= 0 || d[0] % (static_cast<long long>(p.v) * p.h * desc[2]) ||
          desc[0] * d[0] > 0x7FFFFFFFll)
        return static_cast<int>(cudaErrorInvalidValue);
      p.per = p.v * p.h;
      p.mcus_y = static_cast<int>(d[0] / (p.per * desc[2]));
      p.mpu = p.per < kUnitBlocks ? kUnitBlocks / p.per : 1;
      p.ux = (a.mcus_x + p.mpu - 1) / p.mpu;
      const long long n = desc[0] * p.mcus_y * p.ux;
      if (n > 0x7FFFFFFFll) return static_cast<int>(cudaErrorInvalidValue);
      p.units = static_cast<int>(n);
      units += n;
    } else {
      p.nblocks = 0;
    }
  }
  if (units > 0x7FFFFFFFll) return static_cast<int>(cudaErrorInvalidValue);
  a.flat = static_cast<const uint8_t*>(src);
  a.blocks = nullptr;
  a.bad = nullptr;
  a.q = static_cast<const int32_t*>(q);
  a.basis_t = static_cast<const float*>(basis_t);
  a.quads = nullptr;
  a.out = static_cast<uint8_t*>(out);
  int grid = 0;
  const cudaError_t e = grid_for(idct_sparse_first_kernel<kSparse>,
                                 kIdctThreads,
                                 (units + kIdctWarps - 1) / kIdctWarps, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  idct_sparse_first_kernel<kSparse><<<grid > 0 ? grid : 1, kIdctThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The first dense launch of the ycc420 IDCT (idct_dense_first_kernel: a
// group of 8 lanes a block, each lane a row of 8 samples over its own
// block's mask, the [64][64] basis in shared memory, the strip staged in
// shared memory), with jz_idct_planes's dense-form desc, blocks, flags,
// tables and planes and the basis transposed.
int jz_prev_idct_planes_dense(const long long* desc, const void* src,
                              const void* bad, const void* q,
                              const void* basis_t, void* out, void* stream) {
  using namespace first_sparse;
  IdctArgs a;
  a.nimages = static_cast<int>(desc[0]);
  a.ncomp = static_cast<int>(desc[1]);
  if (a.nimages <= 0) return 0;
  if (a.ncomp < 1 || a.ncomp > 3 || desc[0] > 0x7FFFFFFFll ||
      desc[2] <= 0 || bad == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  a.mcus_x = static_cast<int>(desc[2]);
  a.K = static_cast<int>(desc[3]);
  a.level = static_cast<int>(desc[4]);
  a.nseg = static_cast<int>(desc[5]);
  a.row_bytes = desc[6];
  a.image_blocks = desc[7];
  a.out_stride = desc[8];
  a.q_stride = desc[9];
  a.planes = desc[10];
  a.mcu_blocks = static_cast<int>(desc[11]);
  long long units = 0;
  for (int c = 0; c < 3; ++c) {
    const long long* d = desc + 12 + 12 * c;
    IdctComp& p = a.comp[c];
    p.nblocks = static_cast<int>(d[0]);
    p.v = static_cast<int>(d[1]);
    p.h = static_cast<int>(d[2]);
    p.width = static_cast<int>(d[3]);
    p.cap = p.tiles = 0;
    p.slot0 = static_cast<int>(d[5]);
    p.plane_off = d[6];
    p.mlo_off = d[7];
    p.mhi_off = d[8];
    p.val_off = d[9];
    p.oidx_off = d[10];
    p.orows_off = d[11];
    p.per = p.mcus_y = p.mpu = p.ux = p.units = 0;
    if (c < a.ncomp) {
      if (p.v < 1 || p.v > kMaxV || p.h < 1 || p.h > kMaxV ||
          d[0] <= 0 || d[0] % (static_cast<long long>(p.v) * p.h * desc[2]) ||
          desc[0] * d[0] > 0x7FFFFFFFll)
        return static_cast<int>(cudaErrorInvalidValue);
      p.per = p.v * p.h;
      p.mcus_y = static_cast<int>(d[0] / (p.per * desc[2]));
      p.mpu = p.per < kUnitBlocks ? kUnitBlocks / p.per : 1;
      p.ux = (a.mcus_x + p.mpu - 1) / p.mpu;
      const long long n = desc[0] * p.mcus_y * p.ux;
      if (n > 0x7FFFFFFFll) return static_cast<int>(cudaErrorInvalidValue);
      p.units = static_cast<int>(n);
      units += n;
    } else {
      p.nblocks = 0;
    }
  }
  if (units > 0x7FFFFFFFll) return static_cast<int>(cudaErrorInvalidValue);
  a.flat = nullptr;
  a.blocks = static_cast<const int16_t*>(src);
  a.bad = static_cast<const uint8_t*>(bad);
  a.q = static_cast<const int32_t*>(q);
  a.basis_t = static_cast<const float*>(basis_t);
  a.quads = nullptr;
  a.out = static_cast<uint8_t*>(out);
  int grid = 0;
  const cudaError_t e = grid_for(idct_dense_first_kernel, kIdctThreads,
                                 (units + kIdctWarps - 1) / kIdctWarps, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the flag bytes need a thread block even without units
  idct_dense_first_kernel<<<grid > 0 ? grid : 1, kIdctThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// What the card reports for kernel `which` (0: the first fused entropy
// kernel, fixed tables; 1: the concat with 64-bit loads at the main path's
// shape, tiles of 128 MCUs and a budget of 12,288 words; 2: the first
// exact forward, int8 samples; 3: the first exact inverse, int16
// coefficients; 4: the first fast rgb IDCT, int16 coefficients; 5: the
// first overflow launch of the ycc420 IDCT; 6, 7: PR 9's fDCT kernel, int8
// and int32 samples; 8: the first sparse launch of the ycc420 IDCT; 9:
// the first dense launch of the ycc420 IDCT), as jz_entropy_kernel_info
// reports it.
int jz_prev_kernel_info(int which, int* info) {
  switch (which) {
    case 0:
      return kernel_info(fused_first::encode_blocks_fused_first_kernel<false>,
                         fused_first::kWarpsPerCta * 32, info);
    case 1: {
      using namespace concat_first;
      cudaFuncAttributes attr;
      cudaError_t e = cudaFuncGetAttributes(&attr, concat_streams_first_kernel);
      int per_sm = 0;
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, concat_streams_first_kernel, kThreads,
            smem_bytes(128, 12288));
      if (e != cudaSuccess) return static_cast<int>(e);
      info[0] = attr.numRegs;
      info[1] = per_sm;
      info[2] = static_cast<int>(attr.sharedSizeBytes + smem_bytes(128, 12288));
      info[3] = static_cast<int>(attr.localSizeBytes);
      info[4] = kThreads;
      return 0;
    }
    case 2:
      return first_exact::kernel_info(
          first_exact::fdct_exact_first_kernel<int8_t>, info);
    case 3:
      return first_exact::kernel_info(
          first_exact::idct_exact_first_kernel<int16_t>, info);
    case 4:
      return first_exact::kernel_info(
          first_exact::idct_rgb_first_kernel<int16_t>, info);
    case 5:
      return kernel_info(first_overflow::idct_overflow_first_kernel,
                         first_overflow::kIdctThreads, info);
    case 6:
      return kernel_info(first_fdct::fdct_first_kernel<int8_t>,
                         first_fdct::kFdctThreads, info);
    case 7:
      return kernel_info(first_fdct::fdct_first_kernel<int32_t>,
                         first_fdct::kFdctThreads, info);
    case 8:
      return kernel_info(
          first_sparse::idct_sparse_first_kernel<first_sparse::kSparse>,
          first_sparse::kIdctThreads, info);
    case 9:
      return kernel_info(first_sparse::idct_dense_first_kernel,
                         first_sparse::kIdctThreads, info);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* jz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

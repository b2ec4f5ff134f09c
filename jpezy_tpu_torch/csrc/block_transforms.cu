// The codec's two block transforms for Hopper (sm_90a): the forward DCT
// with quantization on encode, and dequantization with the inverse DCT
// into the packed u8 planes on decode.
//
// Kernel 1, fdct_quantize_kernel, replaces the stage that XLA fused on the
// TPU in jpezy_tpu/parallel/sharded.py:_quantize_local_ycc (reached from
// jpezy_tpu/codec/jax_codec.py:_quantize_batch_ycc and
// _encode_batch_blocks_packed): ops/blocks.py:blockify_luma and
// blockify_chroma, ops/dct.py:forward_dct at float32 and
// ops/quantize.py:quantize.
//   In:  Y-128 [N, H, W] and Cb, Cr [N, H/2, W/2] samples, int8 or int32
//        (within [-128, 127]), at any element strides (the ycc420
//        upload's views, the rgb path's decimated chroma); the B fragments
//        of W_int's three digits (transform_cuda.fragment_table, device
//        memory); one [64] int32 quant table for luma and one for chroma.
//   Out: quantized blocks [N, B_c, 64] int32 per component, natural order,
//        luma blocks TL, TR, BL, BR within each MCU; B_Y = 4 B_Cb.
//   The integer form, with X the block's 64 samples (s = 8 y + x, exact
//   int8): coefficient k = 8 u + v is trunc(sum_s X[s] W_int[s][k] / 2^24)
//   toward zero, W_int = round(W 2^24) with W[s][k] = c_u c_v / 4
//   cos((2 y + 1) u pi / 16) cos((2 x + 1) v pi / 16) (constants.
//   FDCT_INT, made in float64 on the host).  |W_int| < 2^22, so W_int =
//   d0 + 2^8 d1 + 2^16 d2 in balanced signed 8-bit digits, and each
//   digit's product is an exact int32 sum below 2^20: no order of
//   summation changes a bit (block_transform.integer_forward is the
//   model; the flat block's DC is trunc(sum X / 8), its AC terms 0).
//   Then C's truncating division |c| / q (or (2|c| + q) / (2q) when
//   rounded) with the sign put back.  Gray writes zero chroma blocks.
//
// Kernel 2, idct_planes, replaces jpezy_tpu/codec/jax_codec.py:
// _decode_fused_batch_ycc420 (with _densify, ops/quantize.py:dequantize,
// ops/dct.py:inverse_dct and the deblockify transpose) and the same tail
// of _decode_fused_batch_device after decode_segments, in three launches
// that read the coefficients from two layouts:
//   sparse:   idct_planes_sparse_kernel, on the ycc420 transport's single
//             flat uint8 upload, read in place: per image and component
//             mask_lo [B] u32 | mask_hi [B] u32 | vals [B, K] int8; a
//             block's coefficient at natural index j is vals[rank(j)],
//             rank counting the set mask bits below j, and 0 unless bit j
//             is set and the rank is below K.  The fields start at any
//             byte.
//   overflow: idct_planes_overflow_kernel, a second launch when the
//             upload carries overflow rows (per component oidx [cap] i32 |
//             orows [cap, 64] i16 after the image rows, at any byte): each
//             row's block is transformed again from its row and overwrites
//             the pixels the first launch wrote (the host clears an
//             overflow block's mask, so the first launch wrote its level).
//             An index outside [0, N * B_c) (the host's padding sentinel
//             is N * B_c) writes nothing.  It replaces the overflow half of
//             _decode_fused_batch_ycc420: _densify's overflow scatter, then
//             the same dequantize, inverse DCT, level shift, clamp and
//             deblockify.
//   dense:    idct_planes_dense_kernel, on the Huffman scan's blocks
//             [N * nseg, ri * 6, 64] int16 in MCU order (4 Y, Cb, Cr), with
//             one quant table per image and component; one more byte per
//             image ORs its segments' corruption flags.
//   Out: per image the planes Y, Cb, Cr, each mcus_y v 8 x mcus_x h 8 u8
//   samples, row after row (the dense form's flag byte after them).
//   Sample p of a block is sum_k float(c[k] q[k]) * M[p][k] over k in
//   ascending order (float32 multiply, then float32 add), then + level as
//   one more float32 add, truncated toward zero and clamped to [0, 255].
//   Zero coefficients are skipped or add +-0: the sum starts at +0.0f and
//   adding a zero product (+0 or -0) changes no sum, so the launches give
//   the same pixels for the same blocks.  All three launches walk the
//   union of several blocks' nonzero coefficients with one product for a
//   mirror quad's four samples (quad_walk, below).
//
// What bounds them, per 16 x 512 x 512 4:2:0 batch (98,304 blocks):
//  - fdct_quantize must move 6.3 MB of int8 samples in and 25.2 MB of
//    int32 blocks out, 9.4 us at 3.35 TB/s; its products are 2.4 G int8
//    operations (three digits), 1.2 us at the card's 1,979 TOPS, so bytes
//    bound it.  The first design (scripts/previous_designs.cu) summed the
//    separable float32 form on the CUDA cores: about 112 warp
//    instructions a block, with 103 registers for 16 warps an SM, so
//    instruction issue held it at twice its bound.  Design: the sums go
//    to the int8 tensor cores and the transposes vanish.  A warp takes a
//    tile of 16 consecutive blocks of one component (4 luma MCUs or 16
//    chroma ones) as the 16 rows of mma.sync m16n8k32 (s8 by s8 into
//    s32); K = 64 samples is two k-steps, N = 64 coefficients eight
//    n-tiles (n-tile u: coefficient row u), three digits: 48 products a
//    tile.  Lane 4 g + t loads rows 2 t and 2 t + 1 of blocks g and g + 8
//    (one 8-byte load a row where the plane allows, else element by
//    element at the strides), and these words are its A fragments as they
//    are: the samples take the slot order that fits the loads
//    (transform_cuda.slot_sample) and the table's rows the same.  The B
//    fragments, 12,288 bytes, sit in shared memory from the start (one
//    16-byte load a lane, a digit and an n-tile).  Each lane recombines its
//    4 sums of an n-tile in 32-bit steps (recombine), quantizes them with
//    the divisors and reciprocals of shared memory (the reciprocal alone:
//    quantize) and stores them as 8 bytes a
//    block: one store of the warp fills the 32-byte sector of row u of 8
//    blocks (a per-warp stage and 16-byte stores read slower).  Warps stay
//    resident and walk the tiles component after component with the next
//    tile's samples in flight; the only barrier is the one after the
//    tables.  At most 85 registers a thread for 24 warps an SM: a batch's
//    6,144 tiles fill its 3,168 warps nearly twice over, where 32 warps an
//    SM (64 registers) left the second round 45 % full and read slower
//    (scripts/fdct_phases.py).  Tiles past a component's last block load
//    zeros and store nothing there.
//  - idct_planes must move the sparse upload (about 1.8 MB) or the dense
//    blocks (12.6 MB) in and 6.3 MB of planes out: 2.4 or 5.6 us.  Its
//    operations depend on the data, a product for each of 16 mirror quads
//    and 64 adds per nonzero coefficient, two a block on the photographs
//    of the main path, so the function is bound by bytes; the kernels by
//    the instructions a warp issues per block and by each warp's chain of
//    dependent steps, with every warp of the grid in the same step at once
//    (scripts/idct_sparse_phases.py cuts steps off and times them).  Both
//    forms take a warp's unit at a time: up to kDenseUnit (dense) or
//    kSparseUnit (sparse) blocks, whole MCUs, of one MCU row of one image
//    and component, so its sources are contiguous ranges of the input
//    (mask words and value bytes, or each MCU's int16 blocks) and its
//    samples whole 8-row bands of the plane.  A unit of 32 blocks leaves
//    the main batch one unit a warp; of 16, two, and the second unit's
//    wait and copies on each warp's chain of steps (slower on the main
//    batch; faster where a few busy units hold their warps longest, as the
//    chroma at quality 95).
//    The sparse launch: the unit's mask words, value bytes and
//    quant table go into one of the warp's two stages by cp.async while
//    the warp sums the unit before (the bytes before and after a range's
//    whole words by single loads, stored once they have come); per group
//    of kSparseGroup blocks (16: a union walk of fewer blocks read slower)
//    lane l takes block l / kSparseLanes and the kSparseQuads
//    mirror quads of rows y and 7 - y for its rows y, each mask cut to its
//    first K set bits, and the group walks the union of the cut masks
//    (quad_walk: one product a quad from the 4 KB quad table, staged in
//    shared memory by k; a block's coefficient k is its r-th value byte
//    times q[k] where its bit k is set, r counting its set bits below k,
//    else +-0).  A group whose union holds no bit but the DC (flat and
//    DC-only blocks, and every overflow block, whose mask the host
//    clears) takes one term a quad and no walk.  The samples go through
//    the FP32 pipe alone (sample_of) and leave as the lane's rows, 8
//    bytes a store: one store of the warp writes rows of 16 neighbouring
//    blocks, whole 32-byte sectors.  Each component's unit layout and
//    the reciprocals of the units' divisions (div_exact) come from the
//    launcher (SparseComp).  The first
//    design (scripts/previous_designs.cu) ran the sparse form as the
//    dense launch's first design ran, its 16 KB basis copied by every thread block.
//    The dense launch reads 128 bytes a block where the sparse upload
//    holds about 18, so bytes weigh more; on noise every block holds 64
//    coefficients and its operations bound it as the overflow launch's.
//    Its first design (scripts/previous_designs.cu) loaded a
//    unit's blocks with nothing in flight behind the sums, ran them four
//    at a time, a group of 8 lanes a block and a lane a row of it over the
//    block's own mask (the four groups of a warp diverging; the 16 KB
//    basis copied by every thread block, 8 products and 8 adds a term:
//    about 6 warp instructions for each coefficient of a block), through a
//    shared image of the unit.  Design: the sparse launch's walk.  A
//    unit is one walk of kDenseUnit blocks (a luma unit 4 whole 768-byte
//    MCUs, the first 512 bytes of each; a chroma unit 16 blocks of 128
//    bytes, 768 apart), its rows copied by 16-byte cp.async with its quant
//    table into one of the warp's two stages (element by element where the
//    blocks are not 16-byte aligned), row r of block i at chunk r ^ (i & 7)
//    (the walk's loads of one k from 16 blocks fall in 8 banks); a warp's
//    first two units are in flight before the tables, and a stage takes
//    the unit after next once its unit is stored.  Lane l takes block
//    l / kDenseLanes as the sparse launch does; it finds the nonzero
//    coefficients of its rows from the staged words (__vcmpne2), the warp
//    ORs them into the union, and the walk takes c[k], c[k + 1] from one
//    32-bit shared load and q[k], q[k + 1] from one 8-byte load, the term
//    c[k] q[k] as a 32-bit product converted to float; from kDenseTerms
//    union bits all 64 in one straight run (noise, quality-95 luma).  A
//    lane's rows leave as 8-byte words: the planes of image n start at n
//    (P + 1) (the flag byte after each), so a unit's rows sit at one
//    offset s modulo 8, and where it is not 0 a lane stores the aligned
//    word that its row's last s bytes and the first 8 - s of the row of
//    the block to its right (a shuffle from that lane) make, and the
//    unit's edge blocks their ends in aligned pieces of 4, 2 and 1 bytes,
//    the same in every lane (put_row): no shared image.  On the
//    photographs' segments the walks are short (8 union bits a luma
//    group, 2 a chroma one), the kernel's issue goes to each unit's copies,
//    masks, samples and stores, and bytes and issue add
//    (scripts/idct_dense_phases.py cuts steps off and times them).
//  - idct_planes_overflow_kernel must move its rows (132 bytes each) in
//    and their 64 samples out.  Where few blocks overflow (photographs:
//    tens of rows a batch) that and the launch are all; on noise at
//    quality 100 nearly every block is a dense overflow row, 13 MB of rows
//    and 6.3 MB of planes, 0.006 ms, while the separate FMUL/FADD that
//    the roundings need (per nonzero coefficient 64 adds and one product
//    per distinct |M[.][k]|, 384 over the 64 k: chip_smoke.py rgb_inv_ops)
//    take about 0.013 ms at 33.5e12 a second: operations bound it.  The
//    first design (scripts/previous_designs.cu) took a row a group of 8
//    lanes, a row of 8 samples a lane, each group on its own block's mask
//    (the 4 groups of a warp diverged), reloaded every term's coefficient
//    from device memory and read 32 bytes of the 16 KB [64][64] basis in
//    shared memory for 16 float operations.  Design: the rows are tiled
//    by component, a warp a tile of up to 8 (tiles of one component never
//    mix quant tables), so the sums are idct_planes_rgb's
//    (exact_transforms.cu): lane 8 b + r loads row r of rows b and b + 4
//    once (one 16-byte load where the row is aligned, else load_i16) with
//    their indices, dequantizes them into the warp's float32 tile and the
//    warp ORs the 8 blocks' nonzero coefficients into one uniform mask.
//    The basis is mirror-symmetric bit for bit, M[8 y + 7 - x][k] = (-1)^u
//    M[p][k] and M[8 (7 - y) + x][k] = (-1)^v M[p][k] (exact_cuda makes
//    no table of another basis), and fl(d (-m)) = -fl(d m), so one product
//    serves the 4 samples of a mirror quad (y, x), (y, 7 - x), (7 - y, x),
//    (7 - y, 7 - x) as adds of +-t with the same bits: 16 products and 64
//    adds a coefficient of a block where the first design issued 64 and
//    64.  Lane 8 p + j keeps 16 sums (the 4 samples of quads j and j + 8
//    of blocks 2 p and 2 p + 1) and takes two coefficients a step: one
//    16-byte shared load of d[k], d[k + 1] of its two blocks and one of
//    its two quads' M[p][k], M[p][k + 1] from the quads' 4 KB table, then
//    8 products and 32 adds.  All 64 terms in one branch-free run where
//    the mask holds kOvfDenseTerms or more (noise), else each behind a
//    uniform branch; k = 0 stores; a tile of sentinel rows alone ends
//    before the sums.  Each sample is + level, truncated and clamped
//    (sample_of), and the samples go back through the tile as bytes,
//    so that one store of the warp writes 4 rows of all 8 blocks: a tile
//    of neighbouring blocks (on noise two MCUs' luma side by side, or 8
//    MCUs' chroma) fills whole 32-byte sectors, 8 bytes a lane where the
//    destination is 8-byte aligned, else bytewise.
//
// No atomics: every output is written by one thread, so the same input
// gives the same bits on every run.
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr unsigned kFullMask = 0xFFFFFFFFu;

// Kernel 1: 8 warps a thread block, 3 thread blocks an SM (85 registers
// a thread at most), a warp a tile of 16 blocks at a time.
constexpr int kFdctThreads = 256;
constexpr int kFdctWarps = kFdctThreads / 32;
constexpr int kFdctBlocksPerSm = 3;
constexpr int kFdctTile = 16;     // blocks a warp's tile: the mma's 16 rows
// the B fragments' 16-byte words: 3 digits, 8 n-tiles, 32 lanes
constexpr int kDigitWords = 3 * 8 * 32;

// the sparse launch's unit: up to 32 blocks (whole MCUs, or one MCU) of
// one MCU row, walked kSparseGroup at a time
constexpr int kSparseUnit = 32;
constexpr int kMaxK = 64;         // sparse: at most K value bytes a block
constexpr int kMaxV = 4;          // sampling factors 1..4 (JPEG's limit)

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

// ---------------------------------------------------------------------------
// Kernel 1: blockify, forward DCT (integer, on the int8 tensor cores),
// quantize
// ---------------------------------------------------------------------------

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
  const int4* digits;     // the B fragments: [3][8][32] 16-byte words
  int nimages, mcus_x, gray, rounded;
  int ty, tc;             // tiles of luma, of each chroma component
};

// A lane's samples of its tile (lane 4 g + t): rows 2 t and 2 t + 1 of
// blocks g and g + 8, each row as two words of 4 int8, the leftmost
// sample in the low byte.  w[j][2 h + b] is half h of row 2 t + j of
// block g + 8 b: k-step j's A fragment of mma m16n8k32, register for
// register (A's register i holds row g + 8 (i & 1) of the tile, its slots
// 4 t + 16 (i >> 1) .. + 3; transform_cuda.slot_sample).
struct FdctFrag {
  uint32_t w[2][4];
};

// A row of 8 samples as 8 int8 in two words: one 8-byte load where the
// plane allows, else element by element at the column stride.
__device__ __forceinline__ uint2 load_row(const int8_t* src, long long sc) {
  if (sc == 1 && (reinterpret_cast<uintptr_t>(src) & 7) == 0)
    return __ldg(reinterpret_cast<const uint2*>(src));
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    lo |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(src + j * sc)))
          << (8 * j);
    hi |= static_cast<uint32_t>(
              static_cast<uint8_t>(__ldg(src + (j + 4) * sc)))
          << (8 * j);
  }
  return make_uint2(lo, hi);
}

// int32 samples narrowed to their low bytes (the wrapper refuses samples
// outside [-128, 127], so no value changes).
__device__ __forceinline__ uint2 load_row(const int32_t* src, long long sc) {
  int v[8];
  if (sc == 1 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(src));
    const int4 b = __ldg(reinterpret_cast<const int4*>(src) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __ldg(src + j * sc);
  }
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j)
    w[j >> 2] |= (static_cast<uint32_t>(v[j]) & 0xFFu) << (8 * (j & 3));
  return make_uint2(w[0], w[1]);
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
// lane's rows of blocks g and g + 8 loaded into *f, zeros past the
// component's last block and for gray chroma (whose blocks are zero).
template <typename T>
__device__ __forceinline__ void fdct_load(const FdctArgs& a,
                                          const FdctComp* comps,
                                          float rcp_mx, int tile, int lane,
                                          int* c, int* first, FdctFrag* f) {
  int lt = tile;
  *c = lt < a.ty ? 0 : (lt < a.ty + a.tc ? 1 : 2);
  lt -= *c == 0 ? 0 : (*c == 1 ? a.ty : a.ty + a.tc);
  *first = lt * kFdctTile;
  const FdctComp& P = comps[*c];
  const int nb = a.nimages * P.nblocks;
  const bool none = a.gray && *c > 0;
  const int t = lane & 3;
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const int fb = *first + (lane >> 2) + 8 * b;
    uint2 r0 = make_uint2(0u, 0u), r1 = make_uint2(0u, 0u);
    if (fb < nb && !none) {
      const int n = div_exact(fb, P.nblocks, P.rcp_nb);
      const int bi = fb - n * P.nblocks;
      // 4:2:0: luma blocks TL, TR, BL, BR of MCU bi / 4, chroma MCU bi
      const int m = *c == 0 ? bi >> 2 : bi;
      const int my = div_exact(m, a.mcus_x, rcp_mx);
      const int mx = m - my * a.mcus_x;
      const int y = (*c == 0 ? (2 * my + ((bi >> 1) & 1)) * 8 : my * 8) +
                    2 * t;
      const int x0 = *c == 0 ? (2 * mx + (bi & 1)) * 8 : mx * 8;
      const T* src = static_cast<const T*>(P.base) + n * P.sn + y * P.sr +
                     x0 * P.sc;
      r0 = load_row(src, P.sc);
      r1 = load_row(src + P.sr, P.sc);
    }
    f->w[0][b] = r0.x;
    f->w[0][2 + b] = r0.y;
    f->w[1][b] = r1.x;
    f->w[1][2 + b] = r1.y;
  }
}

// acc += A B on the int8 tensor cores: mma m16n8k32, s8 by s8 into s32
// (exact: the sums stay far below 2^31).
__device__ __forceinline__ void mma_s8(int (&acc)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// trunc((a0 + 2^8 a1 + 2^16 a2) / 2^24) toward zero from the three digit
// sums, in 32-bit steps (block_transform.recombine_digits): L = a0 + 2^8
// a1 stays below 2^29 in magnitude, C = a2 + floor(L / 2^16), the floor
// of the quotient is floor(C / 2^8) and the remainder is zero where C's
// low 8 and L's low 16 bits are; a negative floor with a remainder moves
// one up.
__device__ __forceinline__ int recombine(int a0, int a1, int a2) {
  const int lo = a0 + a1 * 256;
  const int c = a2 + (lo >> 16);
  const int q = c >> 8;
  return q + ((q < 0 && ((c & 255) | (lo & 0xFFFF)) != 0) ? 1 : 0);
}

// The quantizer: |c| / q, or (2|c| + q) / (2q) rounded (den = 2q), with
// the sign put back, by the reciprocal alone.  int8 samples keep |c| <=
// 128 max_k sum_s |W[s][k]| = 1,024 (the DC column's), so div_exact's guard
// can never change a quotient: truncating, num <= 1,024 < 2^22, below which
// its proof holds; rounded, num >= 2^22 needs q >= 2^22 - 2,048, and then
// num / den <= 1/2 + 1,024 / q < 0.5003, so both give 0; and from den =
// 2^24 on rcp_up is 0, and so is every quotient.
__device__ __forceinline__ int quantize(int cf, int den, float rcp, int up) {
  const int mag = cf < 0 ? -cf : cf;
  const int num = (mag << up) + (up ? den >> 1 : 0);
  const int qv = __float2int_rz(__fmul_ru(__int2float_rn(num), rcp));
  return cf < 0 ? -qv : qv;
}

// A warp's tile from the lane's samples cur (see the header): n-tile u is
// coefficient row u (k = 8 u + v); each digit's sums in two k-steps, then
// the recombination and the quantizer on the lane's 4: blocks g and g + 8,
// coefficients 8 u + 2 tq and + 1; one 8-byte store a block, so that the
// warp's store fills the 32-byte sector of row u of each of 8 blocks
// (live0, live1: blocks g, g + 8 lie in the component).
__device__ __forceinline__ void fdct_tile(const FdctFrag& cur,
                                          const int4* digits, const int* dn,
                                          const float* rc, int up,
                                          int32_t* out, int lane, bool live0,
                                          bool live1) {
  const int g = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    int acc[3][4];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int4 bw = digits[(d * 8 + u) * 32 + lane];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[d][i] = 0;
      mma_s8(acc[d], cur.w[0], static_cast<uint32_t>(bw.x),
             static_cast<uint32_t>(bw.y));
      mma_s8(acc[d], cur.w[1], static_cast<uint32_t>(bw.z),
             static_cast<uint32_t>(bw.w));
    }
    const int k = 8 * u + 2 * tq;
    const int2 dd = *reinterpret_cast<const int2*>(dn + k);
    const float2 rr = *reinterpret_cast<const float2*>(rc + k);
    int qv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qv[i] = quantize(recombine(acc[0][i], acc[1][i], acc[2][i]),
                       (i & 1) ? dd.y : dd.x, (i & 1) ? rr.y : rr.x, up);
    if (live0)
      *reinterpret_cast<int2*>(out + g * 64 + k) = make_int2(qv[0], qv[1]);
    if (live1)
      *reinterpret_cast<int2*>(out + (g + 8) * 64 + k) =
          make_int2(qv[2], qv[3]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kFdctThreads, kFdctBlocksPerSm)
    fdct_quantize_kernel(const __grid_constant__ FdctArgs a) {
  __shared__ int4 digits[kDigitWords];   // the B fragments, 12,288 bytes
  __shared__ __align__(8) int den[2][64];     // luma, chroma: q, or 2 q
  __shared__ __align__(8) float rcp[2][64];   // 1 / den, rounded up
  __shared__ FdctComp comps[3];
  const int t = threadIdx.x;
  const int lane = t & 31;
  if (t < 3) {
    comps[t] = a.comp[t];
    comps[t].rcp_nb = rcp_up(a.comp[t].nblocks);
  }
  const float rcp_mx = rcp_up(a.mcus_x);
  for (int i = t; i < kDigitWords; i += kFdctThreads)
    digits[i] = __ldg(a.digits + i);
  if (t < 128) {
    const int k = t & 63;
    const int q = __ldg(a.comp[t >> 6].q + k);
    const int d = a.rounded ? 2 * q : q;
    den[t >> 6][k] = d;
    rcp[t >> 6][k] = rcp_up(d);
  }
  __syncthreads();
  const int g = lane >> 2;      // the lane's blocks g, g + 8 of the tile
  const int total = a.ty + 2 * a.tc;
  const int warps = gridDim.x * kFdctWarps;
  const int up = a.rounded;
  // the samples of the next tile are loaded while this one is multiplied
  int c_next = 0, first_next = 0;
  FdctFrag next;
  int tile_i = blockIdx.x * kFdctWarps + (t >> 5);
  if (tile_i < total)
    fdct_load<T>(a, comps, rcp_mx, tile_i, lane, &c_next, &first_next,
                 &next);
  for (; tile_i < total; tile_i += warps) {
    const int c = c_next;
    const int first = first_next;
    const FdctFrag cur = next;
    if (tile_i + warps < total)
      fdct_load<T>(a, comps, rcp_mx, tile_i + warps, lane, &c_next,
                   &first_next, &next);
    const int nb = a.nimages * comps[c].nblocks;
    int32_t* out = comps[c].out + static_cast<long long>(first) * 64;
    if (a.gray && c > 0) {
      // the tile's 4 KB of zeros, lane l words 4 (l + 32 j) .. + 3
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (first + ((lane + 32 * j) >> 4) < nb)
          reinterpret_cast<int4*>(out)[lane + 32 * j] = make_int4(0, 0, 0, 0);
      continue;
    }
    const int* dn = den[c > 0];
    const float* rc = rcp[c > 0];
    const bool live0 = first + g < nb;
    const bool live1 = first + g + 8 < nb;
    fdct_tile(cur, digits, dn, rc, up, out, lane, live0, live1);
  }
}

// ---------------------------------------------------------------------------
// Kernel 2: dequantize, inverse DCT, level shift, clamp, into the planes
// ---------------------------------------------------------------------------

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

// What the sparse and dense launches take of a component besides: its
// units' divisors' reciprocals (rounded up, for div_exact) and per block i
// of a unit: at row y, column x of the unit's samples, (y << 16) | x; its
// slot after the first of the unit's MCU 0 in the scan's blocks, m
// mcu_blocks + r for block r of the unit's MCU m (dense); and the block
// beside it on the right, were the unit whole (dense).
struct SparseComp {
  float rcp_image, rcp_ux;  // 1 / (mcus_y ux), 1 / ux
  uint32_t place[kSparseUnit];
  uint16_t slot[kSparseUnit];
  uint8_t right[kSparseUnit];
};

struct IdctArgs {
  IdctComp comp[3];
  SparseComp sparse[3];
  const uint8_t* flat;     // sparse: the upload
  const int16_t* blocks;   // dense: the scan's blocks
  const uint8_t* bad;      // dense: [N * nseg] corruption flags
  const int32_t* q;        // quant tables: [ncomp, 64] or [N, ncomp, 64]
  const float* quads;      // the mirror quads' basis (1,024 floats)
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

// A unit: up to mpu MCUs of one MCU row of one image and component, a
// warp's work at a time (kSparseUnit or kDenseUnit blocks, or one MCU
// where an MCU holds more).
struct Unit {
  int c, n, b0, nb;   // component, image, first block (bi), blocks
  int m0;             // its first MCU in the image
  int rows, width;    // its samples: v 8 rows of width bytes
  long long dst;      // its top-left sample's byte in out
};

// ---------------------------------------------------------------------------
// Kernel 2's overflow launch: the mirror-quad walk over tiles of 8 rows
// ---------------------------------------------------------------------------

// One tile of kOvfTile overflow rows of one component a warp, kOvfWarps a
// thread block, as many thread blocks as the tiles fill.
constexpr int kOvfThreads = 128;
constexpr int kOvfWarps = kOvfThreads / 32;
constexpr int kOvfTile = 8;
// thread blocks an SM its registers are held to (64 a thread at most)
constexpr int kOvfBlocksPerSm = 8;
// mask bits (of 64) from which a warp takes every term in one straight run
constexpr int kOvfDenseTerms = 32;
// The warp's tile, in floats.  Coefficients: row v of the pair p's blocks
// 2 p and 2 p + 1 at float kPairStride p + kRowStride v, d[k] of block
// 2 p + s at 2 u + s, so that one 16-byte load gives a lane d[k] and
// d[k + 1] of both its blocks (k even); the pad after each row and the
// pairs' offsets put the four pairs' loads of one k in different banks.
// Then, for the stores, the samples as bytes, row y of block ob at
// kSampleStride ob + 8 y (the four pairs' byte stores of one sum fall in
// different banks).
constexpr int kRowStride = 20;
constexpr int kPairStride = 8 * kRowStride + 4;
constexpr int kOvfTileFloats = 3 * kPairStride + 8 * kRowStride;
constexpr int kSampleStride = 72;

// Row r of an overflow row: the 8 int16 coefficients at p, one 16-byte
// load where p is aligned, else one load_i16 a coefficient.
__device__ __forceinline__ int4 load_coeff_row(const uint8_t* p) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0)
    return __ldg(reinterpret_cast<const int4*>(p));
  uint32_t h[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    h[j] = static_cast<uint32_t>(load_i16(p + 2 * j)) & 0xFFFFu;
  return make_int4(static_cast<int>(h[0] | (h[1] << 16)),
                   static_cast<int>(h[2] | (h[3] << 16)),
                   static_cast<int>(h[4] | (h[5] << 16)),
                   static_cast<int>(h[6] | (h[7] << 16)));
}

// A row dequantized (d = c q as a 32-bit integer) into dst as float32, at
// dst[2 (u ^ swap)] for column u (a pair of odd p writes its columns in
// swapped pairs: the warp's stores of one step fall in 32 banks); returns
// the row's nonzero mask.
__device__ __forceinline__ uint32_t dequant_row(int4 w, const int* q,
                                                float* dst, int swap) {
  const int ws[4] = {w.x, w.y, w.z, w.w};
  int d[8];
  uint32_t mask = 0;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int c = (u & 1) ? ws[u >> 1] >> 16
                          : static_cast<int16_t>(ws[u >> 1] & 0xFFFF);
    d[u] = static_cast<int>(static_cast<uint32_t>(c) *
                            static_cast<uint32_t>(q[u]));
    mask |= (d[u] != 0 ? 1u : 0u) << u;
  }
#pragma unroll
  for (int u = 0; u < 8; ++u)
    dst[2 * (u ^ swap)] = __int2float_rn(swap ? d[u ^ 1] : d[u]);
  return mask;
}

// The 64-bit mask of the warp's blocks' nonzero coefficients, bit k = 8 r
// + u of lo (k < 32) or hi, from each lane's mask of its row r:
// warp-uniform.
__device__ __forceinline__ void union_mask(uint32_t row_mask, int r,
                                           uint32_t* lo, uint32_t* hi) {
  *lo = __reduce_or_sync(kFullMask, r < 4 ? row_mask << (8 * r) : 0u);
  *hi = __reduce_or_sync(kFullMask, r < 4 ? 0u : row_mask << (8 * (r - 4)));
}

// Term t = d M[p][k] of a mirror quad's base sample p into its 4 sums:
// acc[0] (y, x), acc[1] (y, 7 - x), acc[2] (7 - y, x), acc[3] (7 - y,
// 7 - x).  The basis is mirror-symmetric bit for bit, M[8 y + 7 - x][k] =
// (-1)^u M[p][k] and M[8 (7 - y) + x][k] = (-1)^v M[p][k], and rounding
// to nearest is symmetric, so each mirrored term is t or -t exactly; the
// k = 0 term is stored in place of its add onto +0.
__device__ __forceinline__ void quad_add(float* acc, float t, int k, int u,
                                         int v) {
  if (k == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = t;
    return;
  }
  acc[0] = __fadd_rn(acc[0], t);
  acc[1] = (u & 1) ? __fsub_rn(acc[1], t) : __fadd_rn(acc[1], t);
  acc[2] = (v & 1) ? __fsub_rn(acc[2], t) : __fadd_rn(acc[2], t);
  acc[3] = ((u ^ v) & 1) ? __fsub_rn(acc[3], t) : __fadd_rn(acc[3], t);
}

// The union walk of both sparse-form launches: the terms of the lane's kB
// blocks and kQ mirror quads into acc[block][quad][sample], in ascending
// k = 8 v + u, two k a step: terms(k, d, m) gives d[h][b] = d[k + h] of
// block b and m[h][j] = M[p][k + h] of quad j's base sample p.  kSkip:
// only where the warp-uniform mask lo | hi << 32 has bit k set (a
// coefficient nonzero in one of the warp's blocks), each behind a uniform
// branch (a row of 8 and a step of 2 behind one more); else all 64 in one
// straight run.  A block without coefficient k adds +-0, which changes no
// sum: a sum is never -0 (it starts at +0, the k = 0 term d[0] M[p][0] is
// +0 where d[0] is 0, and x + (-x) is +0).
template <bool kSkip, int kB, int kQ, typename Terms>
__device__ __forceinline__ void quad_walk(uint32_t lo, uint32_t hi,
                                          Terms terms, float (*acc)[kQ][4]) {
#pragma unroll
  for (int b = 0; b < kB; ++b)
#pragma unroll
    for (int j = 0; j < kQ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[b][j][i] = 0.0f;
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const uint32_t row = ((v < 4 ? lo : hi) >> (8 * (v & 3))) & 0xFFu;
    if (kSkip && row == 0u) continue;
#pragma unroll
    for (int u = 0; u < 8; u += 2) {
      const uint32_t two = (row >> u) & 3u;
      if (kSkip && two == 0u) continue;
      const int k = 8 * v + u;
      float d[2][kB], m[2][kQ];
      terms(k, d, m);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (kSkip && ((two >> h) & 1u) == 0u) continue;
#pragma unroll
        for (int j = 0; j < kQ; ++j)
#pragma unroll
          for (int b = 0; b < kB; ++b)
            quad_add(acc[b][j], __fmul_rn(d[h][b], m[h][j]), k + h, u + h,
                     v);
      }
    }
  }
}

// + level, then truncation and the clamp to [0, 255] of a sample's sum,
// in the low byte of the word returned: the clamp first (a sum below 0
// gives 0, one of 255 or more 255), then 2^23 added rounding down, which
// leaves floor(x) in the low bits of the mantissa.  Every step runs on the
// FP32 pipe, where a conversion to an integer runs at a quarter of its
// rate.
__device__ __forceinline__ uint32_t sample_of(float s, float level) {
  const float x = fminf(fmaxf(__fadd_rn(s, level), 0.0f), 255.0f);
  return __float_as_uint(__fadd_rd(x, 8388608.0f));
}

// The overflow launch (see the header): lane 8 b + r loads row r of the
// tile's rows b and b + 4 and their indices; lane 8 p + j sums the mirror
// quads j and j + 8 of blocks 2 p and 2 p + 1 over the union of the 8
// blocks' nonzero coefficients; lane l stores rows l / 8 and 4 + l / 8 of
// block l % 8.  No barrier past the tables.
__global__ void __launch_bounds__(kOvfThreads, kOvfBlocksPerSm)
    idct_planes_overflow_kernel(const __grid_constant__ IdctArgs a) {
  __shared__ __align__(16) float tiles[kOvfWarps][kOvfTileFloats];
  // the quads' basis, two k a float4: mq[8 (k / 2) + j] = (M[p][k],
  // M[p][k + 1], M[p'][k], M[p'][k + 1]) for quads j and j + 8, p = 8 y + x
  // of quad q = 4 y + x
  __shared__ __align__(16) float4 mq[32 * 8];
  __shared__ __align__(16) int qs[3][64];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int b = lane >> 3;      // loads: row r of the tile's rows b, b + 4
  const int r = lane & 7;
  const int total = a.comp[0].tiles + a.comp[1].tiles + a.comp[2].tiles;
  const int tile_i = blockIdx.x * kOvfWarps + (t >> 5);
  int c = 0, lt = tile_i;
  while (c < 2 && lt >= a.comp[c].tiles) lt -= a.comp[c++].tiles;
  const IdctComp& C = a.comp[c];
  // the warp's indices and rows first: their loads are in flight while the
  // thread block copies its tables.  Each row is loaded once.
  int f[2] = {-1, -1};
  int4 w[2] = {make_int4(0, 0, 0, 0), make_int4(0, 0, 0, 0)};
  if (tile_i < total) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = lt * kOvfTile + b + 4 * h;
      if (i < C.cap) {
        f[h] = static_cast<int32_t>(load_u32(a.flat + C.oidx_off + 4ll * i));
        w[h] = load_coeff_row(a.flat + C.orows_off + 128ll * i + 16 * r);
      }
    }
  }
  for (int i = t; i < 32 * 8; i += kOvfThreads)
    mq[i] = __ldg(reinterpret_cast<const float4*>(a.quads) + i);
  for (int i = t; i < 64 * a.ncomp; i += kOvfThreads)
    qs[i >> 6][i & 63] = __ldg(a.q + i);
  __syncthreads();
  if (tile_i >= total) return;
  // a row whose index is outside [0, N B_c) (the host's sentinel padding)
  // adds no term and stores nothing; a tile of such rows alone ends here
  const int nb = a.nimages * C.nblocks;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (f[h] < 0 || f[h] >= nb) {
      f[h] = -1;
      w[h] = make_int4(0, 0, 0, 0);
    }
  }
  if (!__any_sync(kFullMask, f[0] >= 0 || f[1] >= 0)) return;
  float* tile = tiles[t >> 5];
  // rows r of rows b and b + 4 into the tile: block 2 p + s at pair p
  const int4 q0 = *reinterpret_cast<const int4*>(&qs[c][8 * r]);
  const int4 q1 = *reinterpret_cast<const int4*>(&qs[c][8 * r + 4]);
  const int qv[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
  float* dst = tile + (b >> 1) * kPairStride + kRowStride * r + (b & 1);
  const uint32_t row_mask =
      dequant_row(w[0], qv, dst, b >> 1) |
      dequant_row(w[1], qv, dst + 2 * kPairStride, b >> 1);
  uint32_t lo, hi;
  union_mask(row_mask, r, &lo, &hi);
  __syncwarp();
  // sums: lane 8 p + j takes quads j (y = j / 4, x = j % 4) and j + 8
  // (y + 2) of blocks 2 p and 2 p + 1
  const int pair = lane >> 3;
  const int j = lane & 7;
  float acc[2][2][4];
  const float4* e =
      reinterpret_cast<const float4*>(tile + pair * kPairStride);
  // the terms of k and k + 1: e[5 v + u / 2] holds d[k], d[k + 1] of both
  // blocks, mq[8 (k / 2) + j] the two quads' M[p][k], M[p][k + 1]
  const auto terms = [&](int k, float (&d)[2][2], float (&m)[2][2]) {
    const float4 dk = e[5 * (k >> 3) + ((k & 7) >> 1)];
    const float4 mk = mq[8 * (k >> 1) + j];
    d[0][0] = dk.x;
    d[0][1] = dk.y;
    d[1][0] = dk.z;
    d[1][1] = dk.w;
    m[0][0] = mk.x;
    m[1][0] = mk.y;
    m[0][1] = mk.z;
    m[1][1] = mk.w;
  };
  if (__popc(lo) + __popc(hi) >= kOvfDenseTerms)
    quad_walk<false, 2, 2>(lo, hi, terms, acc);
  else
    quad_walk<true, 2, 2>(lo, hi, terms, acc);
  __syncwarp();  // the tile takes the samples now
  uint8_t* samples = reinterpret_cast<uint8_t*>(tile);
  const float level = __int2float_rn(a.level);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int y = (j >> 2) + 2 * h, x = j & 3;
        samples[kSampleStride * (2 * pair + s) + 8 * ((i & 2) ? 7 - y : y) +
                ((i & 1) ? 7 - x : x)] = static_cast<uint8_t>(
            sample_of(acc[s][h][i], level));
      }
    }
  }
  __syncwarp();
  // out: lane l stores rows l / 8 and 4 + l / 8 of block ob = l % 8, so
  // one store of the warp writes 4 rows of all 8 blocks and fills every
  // sector that lies in them (two MCUs' luma side by side, 8 MCUs'
  // chroma); 8 bytes a store where the destination allows, else bytewise
  const int ob = lane & 7;
  const int fa = __shfl_sync(kFullMask, f[0], 8 * (ob & 3));
  const int fb = __shfl_sync(kFullMask, f[1], 8 * (ob & 3));
  const int fo = ob < 4 ? fa : fb;
  if (fo >= 0) {
    const int n = fo / C.nblocks;
    int y0, x0;
    block_origin(fo - n * C.nblocks, C.v, C.h, a.mcus_x, &y0, &x0);
    uint8_t* base = a.out + n * a.out_stride + C.plane_off +
                    static_cast<long long>(y0) * C.width + x0;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int orow = 4 * k + (lane >> 3);
      store_row(base + static_cast<long long>(orow) * C.width,
                *reinterpret_cast<const uint2*>(
                    samples + kSampleStride * ob + 8 * orow));
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel 2's sparse launch: the mirror-quad walk over groups of a unit's
// blocks
// ---------------------------------------------------------------------------

// 8 warps a thread block, kSparseBlocksPerSm thread blocks an SM (at most
// 85 registers a thread), a warp a unit at a time (sparse_unit) with the
// next unit's sources in flight.
constexpr int kSparseThreads = 256;
constexpr int kSparseWarps = kSparseThreads / 32;
constexpr int kSparseBlocksPerSm = 3;
// the blocks whose masks one walk takes as a union (4, 8 or 16):
// kSparseLanes lanes a block, kSparseQuads mirror quads a lane
constexpr int kSparseGroup = 16;
constexpr int kSparseLanes = 32 / kSparseGroup;
constexpr int kSparseQuads = 16 / kSparseLanes;
static_assert(kSparseGroup == 4 || kSparseGroup == 8 || kSparseGroup == 16,
              "a group of 4, 8 or 16 blocks");
static_assert(kSparseUnit % kSparseGroup == 0, "whole groups a unit");
// a unit's value bytes in words: at most kSparseUnit kMaxK from any byte
// of a word, and a word more for the reads one byte past a block's last
constexpr int kValWords = (3 + kSparseUnit * kMaxK + 3) / 4 + 1;

// The lowest `limit` set bits of bits (all of them where it has fewer).
__device__ __forceinline__ uint32_t first_bits(uint32_t bits, int limit) {
  uint32_t keep = 0u;
  for (; bits != 0u && limit > 0; --limit) {
    const uint32_t low = bits & (0u - bits);
    keep |= low;
    bits ^= low;
  }
  return keep;
}

// A warp's staging of one unit's sources in shared memory (words): the
// mask words of its blocks, low then high, each field from the byte its
// source starts at in its word (kMaskWords), its quant table, its value
// bytes likewise (kValWords); two of them a warp, one for the unit being
// summed and one for the next unit's copies.
constexpr int kMaskWords = kSparseUnit + 2;
constexpr int kStageWords = 2 * kMaskWords + 64 + kValWords;
constexpr int kMaskLo = 0, kMaskHi = kMaskWords, kQ = 2 * kMaskWords,
              kVals = kQ + 64;

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes from device memory to shared memory, both 4-byte aligned,
// asynchronously (in the issuing lane's current copy group).
__device__ __forceinline__ void copy4(uint32_t* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   shared_addr(dst)),
               "l"(src)
               : "memory");
}

// The copy of byte range [src, src + nbytes) (at most kWords words) into
// the stage's words from dst, byte j of the range to byte (src & 3) + j:
// the words that the range holds whole by copy4, a word a lane; the at
// most 3 bytes before the first of them and 3 after the last by lanes
// edge0 .. edge0 + 5, one a lane, loaded into *edge and stored at byte
// *edge_at of the stage once they have come (the range's other bytes are
// not read).
template <int kWords>
__device__ __forceinline__ void start_range(uint32_t* stage, int dst,
                                            const uint8_t* src, int nbytes,
                                            int lane, int edge0,
                                            uint32_t* edge, int* edge_at) {
  const int s = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 3);
  const uint8_t* base = src - s;
  const int end = s + nbytes;
  const int lo = (s + 3) >> 2, hi = max(end >> 2, lo);  // whole: [lo, hi)
#pragma unroll
  for (int j = 0; j < (kWords + 31) / 32; ++j) {
    if (lo + 32 * j >= hi) break;
    const int w = lo + lane + 32 * j;
    if (w < hi) copy4(stage + dst + w, base + 4 * w);
  }
  const int e = lane - edge0;
  if (e >= 0 && e < 6) {
    const int j = e < 3 ? s + e : 4 * hi + e - 3;
    if (j < (e < 3 ? min(4 * lo, end) : end)) {
      *edge = __ldg(base + j);
      *edge_at = 4 * dst + j;
    }
  }
}

// Unit u of the batch (the units of component 0, then 1, then 2; per
// image its MCU rows in order, each row's units from the left), its two
// divisions by reciprocals (div_exact), which the launcher puts in
// SparseComp.  The sparse and the dense launch take their units so.
__device__ __forceinline__ Unit sparse_unit(const IdctArgs& a,
                                            const IdctComp* comps,
                                            const SparseComp* sp, int u) {
  Unit U;
  U.c = 0;
  while (U.c < 2 && u >= comps[U.c].units) u -= comps[U.c++].units;
  const IdctComp& C = comps[U.c];
  const int per_image = C.mcus_y * C.ux;
  U.n = div_exact(u, per_image, sp[U.c].rcp_image);
  u -= U.n * per_image;
  const int my = div_exact(u, C.ux, sp[U.c].rcp_ux);
  const int mx0 = (u - my * C.ux) * C.mpu;
  const int nm = min(C.mpu, a.mcus_x - mx0);
  U.m0 = my * a.mcus_x + mx0;
  U.b0 = U.m0 * C.per;
  U.nb = nm * C.per;
  U.rows = C.v * 8;
  U.width = nm * C.h * 8;
  U.dst = U.n * a.out_stride + C.plane_off +
          static_cast<long long>(my * C.v * 8) * C.width + mx0 * C.h * 8;
  return U;
}

// What a lane keeps of the unit whose copies are in flight: the unit, the
// byte its masks and its value bytes start at in their words, and the
// lane's edge byte (edge_at < 0: none).
struct SparseNext {
  Unit U;
  int mshift, vshift;
  uint32_t edge;
  int edge_at;
};

// Unit u's copies into stage (one copy group): the low masks' edge bytes
// by lanes 0..5, the high ones' by 6..11, the value bytes' by 12..17.
__device__ __forceinline__ void start_unit(const IdctArgs& a,
                                           const IdctComp* comps,
                                           const SparseComp* sp, int u,
                                           uint32_t* stage, int lane,
                                           SparseNext* next) {
  next->U = sparse_unit(a, comps, sp, u);
  const Unit& U = next->U;
  const IdctComp& C = comps[U.c];
  const uint8_t* row = a.flat + U.n * a.row_bytes;
  const uint8_t* lo = row + C.mlo_off + 4ll * U.b0;
  const uint8_t* v = row + C.val_off + static_cast<long long>(U.b0) * a.K;
  next->mshift = static_cast<int>(reinterpret_cast<uintptr_t>(lo) & 3);
  next->vshift = static_cast<int>(reinterpret_cast<uintptr_t>(v) & 3);
  next->edge_at = -1;
  start_range<kMaskWords>(stage, kMaskLo, lo, 4 * U.nb, lane, 0,
                          &next->edge, &next->edge_at);
  start_range<kMaskWords>(stage, kMaskHi, row + C.mhi_off + 4ll * U.b0,
                          4 * U.nb, lane, 6, &next->edge, &next->edge_at);
  start_range<kValWords>(stage, kVals, v, U.nb * a.K, lane, 12, &next->edge,
                         &next->edge_at);
  const int32_t* q = a.q + U.n * a.q_stride + U.c * 64;
  copy4(reinterpret_cast<uint32_t*>(stage + kQ + lane), q + lane);
  copy4(reinterpret_cast<uint32_t*>(stage + kQ + 32 + lane), q + lane + 32);
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// The lane's samples of its block, sb[j][i] for its quad j and i as in
// quad_add, as 8-byte rows at p (the block's top-left sample, rows `width`
// apart; `live`: the block lies in the unit).  kSparseQuads 4 or 8: the
// lane holds whole rows y and 7 - y; 2: half of them, which it trades with
// the lane beside it (lane ^ 1, the other half), so that each stores one
// whole row.  All lanes take part.
__device__ __forceinline__ void store_quads(const uint32_t (*sb)[4],
                                            uint8_t* p, int width, int sub,
                                            bool live) {
  // the low bytes of 4 words as one
  const auto pack = [](uint32_t b0, uint32_t b1, uint32_t b2, uint32_t b3) {
    return __byte_perm(__byte_perm(b0, b1, 0x0040),
                       __byte_perm(b2, b3, 0x0040), 0x5410);
  };
  if constexpr (kSparseQuads == 2) {
    // quads 4 y + 2 h and + 1: x = 2 h, 2 h + 1 and their mirrors 7 - x;
    // a word of each row, bytes x = 2 h, 2 h + 1, 6 - 2 h, 7 - 2 h
    const int y = sub >> 1, h = sub & 1;
    const uint32_t top = pack(sb[0][0], sb[1][0], sb[1][1], sb[0][1]);
    const uint32_t bot = pack(sb[0][2], sb[1][2], sb[1][3], sb[0][3]);
    const uint32_t other = __shfl_xor_sync(kFullMask, h ? top : bot, 1);
    const uint32_t w0 = h ? other : top;     // x = 0, 1, 6, 7
    const uint32_t w1 = h ? bot : other;     // x = 2, 3, 4, 5
    if (live)
      store_row(p + static_cast<long long>(h ? 7 - y : y) * width,
                make_uint2(__byte_perm(w0, w1, 0x5410),
                           __byte_perm(w0, w1, 0x3276)));
  } else {
#pragma unroll
    for (int rr = 0; rr < kSparseQuads / 4; ++rr) {
      const int y = (kSparseQuads / 4) * sub + rr;
      const uint32_t(*r)[4] = sb + 4 * rr;   // quads (y, 0) .. (y, 3)
      if (live) {
        store_row(p + static_cast<long long>(y) * width,
                  make_uint2(pack(r[0][0], r[1][0], r[2][0], r[3][0]),
                             pack(r[3][1], r[2][1], r[1][1], r[0][1])));
        store_row(p + static_cast<long long>(7 - y) * width,
                  make_uint2(pack(r[0][2], r[1][2], r[2][2], r[3][2]),
                             pack(r[3][3], r[2][3], r[1][3], r[0][3])));
      }
    }
  }
}

// The sparse launch (see the header): warps walk the units, each unit's
// masks, quant table and value bytes copied into the warp's stage while it
// sums the unit before; per group of kSparseGroup blocks lane l sums quads
// kSparseQuads (l % kSparseLanes) .. of block l / kSparseLanes over the
// union of the group's masks, each cut to its first K set bits, and
// stores its rows.  No barrier past the tables.
__global__ void __launch_bounds__(kSparseThreads, kSparseBlocksPerSm)
    idct_planes_sparse_kernel(const __grid_constant__ IdctArgs a) {
  // the quads' basis by k: mb[16 k + q] = M[p][k] for quad q = 4 y + x and
  // its base sample p = 8 y + x
  __shared__ __align__(16) float mb[64 * 16];
  __shared__ uint32_t stages[kSparseWarps][2][kStageWords];
  __shared__ IdctComp comps[3];
  __shared__ SparseComp sp[3];
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  if (t < 3) {
    comps[t] = a.comp[t];
    sp[t] = a.sparse[t];
  }
  __syncthreads();
  const int total = comps[0].units + comps[1].units + comps[2].units;
  const int stride = gridDim.x * kSparseWarps;
  int u = blockIdx.x * kSparseWarps + warp;
  // the warp's first unit's copies are in flight while the thread block
  // fills its tables
  SparseNext next;
  if (u < total)
    start_unit(a, comps, sp, u, stages[warp][0], lane, &next);
  // exact_cuda.quad_basis' layout: float4 8 k2 + j holds M[p][2 k2],
  // M[p][2 k2 + 1] of quad j, then of quad j + 8
  for (int i = t; i < 32 * 8; i += kSparseThreads) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(a.quads) + i);
    const int k = 2 * (i >> 3), j = i & 7;
    mb[16 * k + j] = w.x;
    mb[16 * k + 16 + j] = w.y;
    mb[16 * k + j + 8] = w.z;
    mb[16 * k + 24 + j] = w.w;
  }
  __syncthreads();
  const int blk = lane / kSparseLanes;    // the lane's block of a group
  const int sub = lane % kSparseLanes;    // its quads kSparseQuads sub ..
  const float* mbq = mb + kSparseQuads * sub;
  const float level = __int2float_rn(a.level);
  for (int buf = 0; u < total; u += stride, buf ^= 1) {
    // this unit's copies have come; its edge bytes go to their places
    const SparseNext cur = next;
    uint32_t* stage = stages[warp][buf];
    asm volatile("cp.async.wait_all;" ::: "memory");
    if (cur.edge_at >= 0)
      reinterpret_cast<uint8_t*>(stage)[cur.edge_at] =
          static_cast<uint8_t>(cur.edge);
    __syncwarp();
    if (u + stride < total)
      start_unit(a, comps, sp, u + stride, stages[warp][buf ^ 1], lane,
                 &next);
    const Unit& U = cur.U;
    const IdctComp& C = comps[U.c];
    const int* q = reinterpret_cast<const int*>(stage + kQ);
    for (int g0 = 0; g0 < U.nb; g0 += kSparseGroup) {
      const int i = g0 + blk;
      const bool live = i < U.nb;
      // block i's mask words from the byte they start at
      uint32_t lo = __funnelshift_r(stage[kMaskLo + i], stage[kMaskLo + i + 1],
                                    8 * cur.mshift);
      uint32_t hi = __funnelshift_r(stage[kMaskHi + i], stage[kMaskHi + i + 1],
                                    8 * cur.mshift);
      if (!live) lo = hi = 0u;
      // the first K set bits take the value bytes; a mask with more (the
      // transport sends none) loses the rest
      if (__popc(lo) + __popc(hi) > a.K) {
        const uint32_t first = first_bits(lo, a.K);
        hi = first_bits(hi, a.K - __popc(first));
        lo = first;
      }
      const uint32_t ulo = __reduce_or_sync(kFullMask, lo);
      const uint32_t uhi = __reduce_or_sync(kFullMask, hi);
      const int8_t* vb = reinterpret_cast<const int8_t*>(stage + kVals) +
                         cur.vshift + i * a.K;
      uint32_t sb[kSparseQuads][4];
      if ((ulo >> 1) == 0u && uhi == 0u) {
        // no coefficient but DCs in the group (flat and DC-only blocks;
        // every overflow block, whose mask the host clears): a quad's 4
        // samples are its one term d[0] M[p][0], stored, + level
        const float d0 =
            (lo & 1u) ? __int2float_rn(static_cast<int>(
                            static_cast<uint32_t>(vb[0]) *
                            static_cast<uint32_t>(q[0])))
                      : 0.0f;
#pragma unroll
        for (int j = 0; j < kSparseQuads; ++j) {
          const uint32_t v = sample_of(__fmul_rn(d0, mbq[j]), level);
#pragma unroll
          for (int e = 0; e < 4; ++e) sb[j][e] = v;
        }
      } else {
        // the block's coefficient k is its r-th value byte times q[k] where
        // bit k is set (r: the set bits below k), else 0
        int r = 0;
        const auto terms = [&](int k, float (&d)[2][1],
                               float (&m)[2][kSparseQuads]) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int kk = k + h;
            const uint32_t bit = ((kk < 32 ? lo : hi) >> (kk & 31)) & 1u;
            const int c = vb[r];
            r += static_cast<int>(bit);
            d[h][0] = bit ? __int2float_rn(static_cast<int>(
                                static_cast<uint32_t>(c) *
                                static_cast<uint32_t>(q[kk])))
                          : 0.0f;
            if constexpr (kSparseQuads == 2) {
              const float2 w = *reinterpret_cast<const float2*>(mbq +
                                                                16 * kk);
              m[h][0] = w.x;
              m[h][1] = w.y;
            } else {
#pragma unroll
              for (int j = 0; j < kSparseQuads; j += 4) {
                const float4 w =
                    *reinterpret_cast<const float4*>(mbq + 16 * kk + j);
                m[h][j] = w.x;
                m[h][j + 1] = w.y;
                m[h][j + 2] = w.z;
                m[h][j + 3] = w.w;
              }
            }
          }
        };
        float acc[1][kSparseQuads][4];
        quad_walk<true, 1, kSparseQuads>(ulo, uhi, terms, acc);
#pragma unroll
        for (int j = 0; j < kSparseQuads; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sb[j][e] = sample_of(acc[0][j][e], level);
      }
      const uint32_t at = sp[U.c].place[i];
      store_quads(sb,
                  a.out + U.dst + static_cast<long long>(at >> 16) * C.width +
                      (at & 0xFFFF),
                  C.width, sub, live);
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// Kernel 2's dense launch: the same walk over the scan's blocks, staged a
// unit ahead
// ---------------------------------------------------------------------------

// 8 warps a thread block, kDenseBlocksPerSm thread blocks an SM (at most
// 85 registers a thread), a warp a unit of up to kDenseUnit blocks at a
// time (sparse_unit), one walk, with the next unit's blocks in flight:
// kDenseLanes lanes a block, kDenseQuads mirror quads a lane.
constexpr int kDenseThreads = 256;
constexpr int kDenseWarps = kDenseThreads / 32;
constexpr int kDenseBlocksPerSm = 3;
constexpr int kDenseUnit = 16;
constexpr int kDenseLanes = 32 / kDenseUnit;
constexpr int kDenseQuads = 16 / kDenseLanes;
static_assert(kDenseUnit == 8 || kDenseUnit == 16,
              "a lane holds whole rows of its block");
// union bits from which a walk takes all 64 terms in one straight run
constexpr int kDenseTerms = 32;
// A stage (words): the unit's blocks, 32 words each, row r of block i (its
// 16 bytes) at chunk r ^ (i & 7) of the block, so that the walk's loads of
// one k from the 16 blocks fall in 8 banks and a lane's row loads of the
// masks in distinct ones; then the unit's quant table.
constexpr int kDenseQ = kDenseUnit * 32;
constexpr int kDenseStageWords = kDenseQ + 64;

// 16 bytes from device memory to shared memory, both 16-byte aligned,
// asynchronously (in the issuing lane's current copy group).
__device__ __forceinline__ void copy16(uint32_t* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   shared_addr(dst)),
               "l"(src)
               : "memory");
}

// Unit u's blocks and quant table into stage (one copy group): row j & 7
// of the unit's block j >> 3 by lane j % 32, by cp.async where the scan's
// blocks are 16-byte aligned, else loaded element by element and stored
// at once.
__device__ __forceinline__ void start_dense(const IdctArgs& a,
                                            const IdctComp* comps,
                                            const SparseComp* sp, int u,
                                            uint32_t* stage, int lane) {
  const Unit U = sparse_unit(a, comps, sp, u);
  const IdctComp& C = comps[U.c];
  const SparseComp& S = sp[U.c];
  const int16_t* first =
      a.blocks + ((U.n * a.image_blocks +
                   static_cast<long long>(U.m0) * a.mcu_blocks + C.slot0)
                  << 6);
  const bool aligned = (reinterpret_cast<uintptr_t>(a.blocks) & 15) == 0;
  for (int j = lane; j < 8 * U.nb; j += 32) {
    const int i = j >> 3, r = j & 7;
    const int16_t* src = first + (static_cast<int>(S.slot[i]) << 6) + 8 * r;
    uint32_t* dst = stage + 32 * i + 4 * (r ^ (i & 7));
    if (aligned) {
      copy16(dst, src);
    } else {
      uint32_t h[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        h[e] = static_cast<uint16_t>(__ldg(src + e));
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                     h[4] | (h[5] << 16), h[6] | (h[7] << 16));
    }
  }
  const int32_t* q = a.q + U.n * a.q_stride + U.c * 64;
  copy4(stage + kDenseQ + lane, q + lane);
  copy4(stage + kDenseQ + 32 + lane, q + lane + 32);
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Bit j: coefficient j of a row of 8 int16 (w) is nonzero.
__device__ __forceinline__ uint32_t nonzero_bits(uint4 w) {
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
  uint32_t bits = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t m = __vcmpne2(ws[j], 0u);
    bits |= ((m & 1u) | ((m >> 15) & 2u)) << (2 * j);
  }
  return bits;
}

// A row v of 8 samples (x = 0 in the low byte) of a block at p, s = p & 7
// (the unit's: its blocks' columns are multiples of 8).  s = 0: one 8-byte
// store.  Else the 8-byte word from p + 8 - s, the row's last s bytes and
// the first 8 - s of the block to its right in the unit (`right`, that
// row of it), or where none is there the last s bytes alone; and where no
// block of the unit is to its left, its first 8 - s bytes (else the block
// to its left stores them).  The pieces are aligned stores of 4, 2 and 1
// bytes as the bits of their length say, the same ones in every lane:
// every byte once, no store past the row.
__device__ __forceinline__ void put_row(uint8_t* p, int s, uint64_t v,
                                        uint64_t right, bool has_left,
                                        bool has_right) {
  if (s == 0) {
    *reinterpret_cast<uint64_t*>(p) = v;
    return;
  }
  uint8_t* w = p + 8 - s;
  const uint64_t tail = v >> (8 * (8 - s));
  if (has_right) {
    *reinterpret_cast<uint64_t*>(w) = tail | (right << (8 * s));
  } else {
    // [w, w + s): 4 bytes at w, 2 after them, 1 after those
    if (s & 4) *reinterpret_cast<uint32_t*>(w) = static_cast<uint32_t>(tail);
    if (s & 2)
      *reinterpret_cast<uint16_t*>(w + (s & 4)) =
          static_cast<uint16_t>(tail >> (8 * (s & 4)));
    if (s & 1) w[s & 6] = static_cast<uint8_t>(tail >> (8 * (s & 6)));
  }
  if (!has_left) {
    // [p, w), m = 8 - s bytes ending at an 8-byte boundary: 1 byte at p, 2
    // after it, 4 after those
    const int m = 8 - s;
    if (m & 1) *p = static_cast<uint8_t>(v);
    if (m & 2)
      *reinterpret_cast<uint16_t*>(p + (m & 1)) =
          static_cast<uint16_t>(v >> (8 * (m & 1)));
    if (m & 4)
      *reinterpret_cast<uint32_t*>(p + (m & 3)) =
          static_cast<uint32_t>(v >> (8 * (m & 3)));
  }
}

// The dense launch (see the header): warps walk the units, each unit's
// blocks and quant table copied into one of the warp's two stages while
// it sums the unit before (the first two units' copies issued before the
// tables, a stage refilled once its unit is stored, so that a warp never
// waits to issue copies with a unit ready); lane l takes block
// l / kDenseLanes of the unit and its
// kDenseQuads mirror quads of rows y and 7 - y for its rows y, finds its
// rows' nonzero coefficients, and the unit walks the union of its blocks'
// (quad_walk; all 64 terms where the union holds kDenseTerms or more);
// each lane's rows leave as 8-byte words (put_row).  No barrier past the
// tables and the flag bytes.
__global__ void __launch_bounds__(kDenseThreads, kDenseBlocksPerSm)
    idct_planes_dense_kernel(const __grid_constant__ IdctArgs a) {
  // the quads' basis by k, as the sparse launch's
  __shared__ __align__(16) float mb[64 * 16];
  __shared__ __align__(16) uint32_t stages[kDenseWarps][2][kDenseStageWords];
  __shared__ IdctComp comps[3];
  __shared__ SparseComp sp[3];
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  if (t < 3) {
    comps[t] = a.comp[t];
    sp[t] = a.sparse[t];
  }
  __syncthreads();
  const int total = comps[0].units + comps[1].units + comps[2].units;
  const int stride = gridDim.x * kDenseWarps;
  int u = blockIdx.x * kDenseWarps + warp;
  // the warp's first two units' copies are in flight while the thread
  // block fills its table and the flag bytes
  if (u < total) start_dense(a, comps, sp, u, stages[warp][0], lane);
  if (u + stride < total)
    start_dense(a, comps, sp, u + stride, stages[warp][1], lane);
  for (int i = t; i < 32 * 8; i += kDenseThreads) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(a.quads) + i);
    const int k = 2 * (i >> 3), j = i & 7;
    mb[16 * k + j] = w.x;
    mb[16 * k + 16 + j] = w.y;
    mb[16 * k + j + 8] = w.z;
    mb[16 * k + 24 + j] = w.w;
  }
  // one flag byte per image: any of its segments corrupt
  for (int n = blockIdx.x; n < a.nimages; n += gridDim.x) {
    int any = 0;
    for (int s = t; s < a.nseg; s += kDenseThreads)
      any |= __ldg(a.bad + static_cast<long long>(n) * a.nseg + s);
    any = __syncthreads_or(any);
    if (t == 0) a.out[n * a.out_stride + a.planes] = any ? 1 : 0;
  }
  __syncthreads();
  const int i = lane / kDenseLanes;      // the lane's block of the unit
  const int sub = lane % kDenseLanes;    // its quads kDenseQuads sub ..
  const float* mbq = mb + kDenseQuads * sub;
  const float level = __int2float_rn(a.level);
  // block i's row r at word (4 r) ^ sw of its 32
  const int sw = 4 * (i & 7);
  for (int buf = 0; u < total; u += stride, buf ^= 1) {
    // this unit's copies have come (the next unit's may not have)
    if (u + stride < total)
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    else
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncwarp();
    uint32_t* stage = stages[warp][buf];
    const Unit U = sparse_unit(a, comps, sp, u);
    const IdctComp& C = comps[U.c];
    const int* q = reinterpret_cast<const int*>(stage + kDenseQ);
    const uint32_t* bw = stage + 32 * i;
    const bool live = i < U.nb;
    // the lane's rows' nonzero coefficients: bit 8 r + j, coefficient j of
    // row r
    uint64_t nz = 0u;
    if (live) {
#pragma unroll
      for (int rr = 0; rr < 8 / kDenseLanes; ++rr) {
        const int r = (8 / kDenseLanes) * sub + rr;
        nz |= static_cast<uint64_t>(nonzero_bits(
                  *reinterpret_cast<const uint4*>(bw + ((4 * r) ^ sw))))
              << (8 * r);
      }
    }
    const uint32_t ulo = __reduce_or_sync(kFullMask, static_cast<uint32_t>(nz));
    const uint32_t uhi =
        __reduce_or_sync(kFullMask, static_cast<uint32_t>(nz >> 32));
    // block i's coefficient k: c[k] q[k] as a 32-bit product (c[k] and
    // c[k + 1] in one word, q[k] and q[k + 1] in one load), then a float
    const auto terms = [&](int k, float (&d)[2][1],
                           float (&m)[2][kDenseQuads]) {
      const uint32_t cw = bw[((4 * (k >> 3)) ^ sw) + ((k & 7) >> 1)];
      const int2 qk = *reinterpret_cast<const int2*>(q + k);
      d[0][0] = __int2float_rn(static_cast<int>(
          static_cast<uint32_t>(static_cast<int>(static_cast<int16_t>(
              cw & 0xFFFFu))) *
          static_cast<uint32_t>(qk.x)));
      d[1][0] = __int2float_rn(static_cast<int>(
          static_cast<uint32_t>(static_cast<int>(cw) >> 16) *
          static_cast<uint32_t>(qk.y)));
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < kDenseQuads; j += 4) {
          const float4 w =
              *reinterpret_cast<const float4*>(mbq + 16 * (k + h) + j);
          m[h][j] = w.x;
          m[h][j + 1] = w.y;
          m[h][j + 2] = w.z;
          m[h][j + 3] = w.w;
        }
    };
    float acc[1][kDenseQuads][4];
    if (__popc(ulo) + __popc(uhi) >= kDenseTerms)
      quad_walk<false, 1, kDenseQuads>(ulo, uhi, terms, acc);
    else
      quad_walk<true, 1, kDenseQuads>(ulo, uhi, terms, acc);
    // the lane's rows y = (kDenseQuads / 4) sub + rr and 7 - y, 8 bytes
    // each (quads (y, 0) .. (y, 3) and their mirrors), out
    const uint32_t at = sp[U.c].place[i];
    const int x = static_cast<int>(at & 0xFFFF);
    uint8_t* p = a.out + U.dst + static_cast<long long>(at >> 16) * C.width + x;
    const int s = static_cast<int>(reinterpret_cast<uintptr_t>(a.out + U.dst) &
                                   7);
    const bool has_right = x + 8 < U.width;
    const int from = has_right ? kDenseLanes * sp[U.c].right[i] + sub : lane;
    const auto pack = [&](int j0, int e0, int j1, int e1, int j2, int e2,
                          int j3, int e3) {
      const uint32_t b0 = sample_of(acc[0][j0][e0], level);
      const uint32_t b1 = sample_of(acc[0][j1][e1], level);
      const uint32_t b2 = sample_of(acc[0][j2][e2], level);
      const uint32_t b3 = sample_of(acc[0][j3][e3], level);
      return __byte_perm(__byte_perm(b0, b1, 0x0040),
                         __byte_perm(b2, b3, 0x0040), 0x5410);
    };
#pragma unroll
    for (int rr = 0; rr < kDenseQuads / 4; ++rr) {
      const int y = (kDenseQuads / 4) * sub + rr;
      const int j = 4 * rr;   // quads (y, 0) .. (y, 3): j .. j + 3
#pragma unroll
      for (int m = 0; m < 2; ++m) {   // row y, then row 7 - y
        const int e = 2 * m;
        const uint64_t v =
            static_cast<uint64_t>(pack(j, e, j + 1, e, j + 2, e, j + 3, e)) |
            (static_cast<uint64_t>(pack(j + 3, e + 1, j + 2, e + 1, j + 1,
                                        e + 1, j, e + 1))
             << 32);
        const uint64_t rv = s ? __shfl_sync(kFullMask, v, from) : 0u;
        if (live)
          put_row(p + static_cast<long long>(m ? 7 - y : y) * C.width, s, v,
                  rv, x > 0, has_right);
      }
    }
    // every lane is done with the stage: the unit after next into it
    __syncwarp();
    if (u + 2 * stride < total)
      start_dense(a, comps, sp, u + 2 * stride, stage, lane);
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

// rcp_up on the host: 1 / d rounded up to a float (d >= 1), 0 from 2^24
// on.
float rcp_up_host(int d) {
  if (d >= (1 << 24)) return 0.f;
  float r = 1.0f / static_cast<float>(d);
  if (static_cast<double>(r) * d < 1.0) r = std::nextafter(r, 2.0f);
  return r;
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

// Kernel 1 on `stream` (PyTorch's current stream); returns
// cudaGetLastError(), 0 on success.  Does not synchronise.  elem_bytes:
// 1 (int8 samples) or 4 (int32, each within [-128, 127]: the kernel
// narrows them).  desc (host memory): nimages, mcus_y, mcus_x, gray,
// rounded, then per component Y, Cb, Cr its element strides (image, row,
// column).  digits (device memory, 16-byte aligned): the 12,288 bytes of
// transform_cuda.fragment_table, W_int's three digits as B fragments.
int jz_fdct_quantize(int elem_bytes, const long long* desc,
                     const void* digits, const void* y, const void* cb,
                     const void* cr, const void* yq, const void* cq,
                     void* oy, void* ocb, void* ocr, void* stream) {
  const long long nimages = desc[0], mcus_y = desc[1], mcus_x = desc[2];
  if (nimages <= 0 || mcus_y <= 0 || mcus_x <= 0) return 0;
  const long long nm = mcus_y * mcus_x;
  if (nimages * 4 * nm > 0x7FFFFFFFll ||
      (elem_bytes != 1 && elem_bytes != 4) || digits == nullptr ||
      (reinterpret_cast<uintptr_t>(digits) & 15) != 0)
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
  a.digits = static_cast<const int4*>(digits);
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
    e = grid_for(fdct_quantize_kernel<int8_t>, kFdctThreads, blocks_needed,
                 &grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    fdct_quantize_kernel<int8_t><<<grid, kFdctThreads, 0, s>>>(a);
  } else {
    e = grid_for(fdct_quantize_kernel<int32_t>, kFdctThreads, blocks_needed,
                 &grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    fdct_quantize_kernel<int32_t><<<grid, kFdctThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel 2 on `stream`; returns cudaGetLastError(), 0 on success.  Does not
// synchronise.  dense = 0: the sparse form from `src` (the flat upload),
// then, where any component has overflow rows, the overflow launch;
// dense = 1: the dense form from `src` (the scan's int16 blocks) with the
// corruption flags `bad`, one byte each.  quads: the table of the basis'
// 16 mirror quads that every launch walks with, laid out as
// jz_idct_planes_rgb's basis (exact_cuda.quad_basis; 1,024 floats in
// device memory, 16-byte aligned; never null).  desc (host memory):
// nimages, ncomp, mcus_x, K, level, nseg, row_bytes, image_blocks,
// out_stride, q_stride, planes, mcu_blocks, then per component nblocks, v,
// h, width, cap, slot0, plane_off, mlo_off, mhi_off, val_off, oidx_off,
// orows_off.  Sampling factors 1..4; the sparse form takes K in 1..64.
int jz_idct_planes(int dense, const long long* desc, const void* src,
                   const void* bad, const void* q, const void* quads,
                   void* out, void* stream) {
  IdctArgs a;
  a.nimages = static_cast<int>(desc[0]);
  a.ncomp = static_cast<int>(desc[1]);
  if (a.nimages <= 0) return 0;
  if (a.ncomp < 1 || a.ncomp > 3 || desc[0] > 0x7FFFFFFFll ||
      desc[2] <= 0 || (dense && bad == nullptr) || quads == nullptr ||
      (reinterpret_cast<uintptr_t>(quads) & 15) != 0 ||
      (!dense && (desc[3] < 1 || desc[3] > kMaxK)))
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
  long long caps = 0, tiles = 0, units = 0;
  for (int c = 0; c < 3; ++c) {
    const long long* d = desc + 12 + 12 * c;
    IdctComp& p = a.comp[c];
    p.nblocks = static_cast<int>(d[0]);
    p.v = static_cast<int>(d[1]);
    p.h = static_cast<int>(d[2]);
    p.width = static_cast<int>(d[3]);
    p.cap = static_cast<int>(d[4]);
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
      // a dense unit is one walk: an MCU's blocks must fit it
      if (dense && p.per > kDenseUnit)
        return static_cast<int>(cudaErrorInvalidValue);
      p.mcus_y = static_cast<int>(d[0] / (p.per * desc[2]));
      const int unit = dense ? kDenseUnit : kSparseUnit;
      p.mpu = p.per < unit ? unit / p.per : 1;
      p.ux = (a.mcus_x + p.mpu - 1) / p.mpu;
      const long long n = desc[0] * p.mcus_y * p.ux;
      if (n > 0x7FFFFFFFll) return static_cast<int>(cudaErrorInvalidValue);
      p.units = static_cast<int>(n);
      if (p.cap < 0) return static_cast<int>(cudaErrorInvalidValue);
      p.tiles = (p.cap + kOvfTile - 1) / kOvfTile;
      SparseComp& q = a.sparse[c];
      q.rcp_image = rcp_up_host(p.mcus_y * p.ux);
      q.rcp_ux = rcp_up_host(p.ux);
      for (int i = 0; i < kSparseUnit; ++i) {
        const int m = i / p.per, r = i % p.per;
        q.place[i] = (static_cast<uint32_t>(r / p.h * 8) << 16) |
                     static_cast<uint32_t>((m * p.h + r % p.h) * 8);
        q.slot[i] = static_cast<uint16_t>(m * a.mcu_blocks + r);
        q.right[i] = static_cast<uint8_t>(
            r % p.h + 1 < p.h ? i + 1 : (m + 1) * p.per + r / p.h * p.h);
      }
      caps += p.cap;
      tiles += p.tiles;
      units += n;
    } else {
      p.cap = p.nblocks = p.tiles = 0;
    }
  }
  if (units > 0x7FFFFFFFll || tiles > 0x7FFFFFFFll)
    return static_cast<int>(cudaErrorInvalidValue);
  a.flat = static_cast<const uint8_t*>(src);
  a.blocks = static_cast<const int16_t*>(src);
  a.bad = static_cast<const uint8_t*>(bad);
  a.q = static_cast<const int32_t*>(q);
  a.quads = static_cast<const float*>(quads);
  a.out = static_cast<uint8_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int grid = 0;
  cudaError_t e;
  if (dense) {
    e = grid_for(idct_planes_dense_kernel, kDenseThreads,
                 (units + kDenseWarps - 1) / kDenseWarps, &grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    // the flag bytes need a thread block even without units
    idct_planes_dense_kernel<<<grid > 0 ? grid : 1, kDenseThreads, 0, s>>>(
        a);
    return static_cast<int>(cudaGetLastError());
  }
  e = grid_for(idct_planes_sparse_kernel, kSparseThreads,
               (units + kSparseWarps - 1) / kSparseWarps, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  idct_planes_sparse_kernel<<<grid > 0 ? grid : 1, kSparseThreads, 0, s>>>(
      a);
  e = cudaGetLastError();
  if (e != cudaSuccess || caps == 0) return static_cast<int>(e);
  idct_planes_overflow_kernel<<<static_cast<unsigned>(
                                    (tiles + kOvfWarps - 1) / kOvfWarps),
                                kOvfThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// What the card reports for kernel `which` (0: fdct_quantize int8, 1:
// int32, 2: idct_planes sparse, 3: dense, 4: overflow): info[0] registers
// a thread, [1] resident thread blocks an SM, [2] static shared bytes,
// [3] local bytes a thread, [4] threads a block.  Returns 0 or a CUDA
// error code.
int jz_transform_kernel_info(int which, int* info) {
  switch (which) {
    case 0:
      return kernel_info(fdct_quantize_kernel<int8_t>, kFdctThreads, info);
    case 1:
      return kernel_info(fdct_quantize_kernel<int32_t>, kFdctThreads, info);
    case 2:
      return kernel_info(idct_planes_sparse_kernel, kSparseThreads, info);
    case 3:
      return kernel_info(idct_planes_dense_kernel, kDenseThreads, info);
    case 4:
      return kernel_info(idct_planes_overflow_kernel, kOvfThreads, info);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* jz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

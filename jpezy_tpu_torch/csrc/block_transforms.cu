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
//   In:  Y-128 [N, H, W] and Cb, Cr [N, H/2, W/2] samples, int8 or int32,
//        at any element strides (the ycc420 upload's views, the rgb path's
//        decimated chroma); the separable form's tables C and S (kernel
//        parameters); one [64] int32 quant table for luma and one for
//        chroma.
//   Out: quantized blocks [N, B_c, 64] int32 per component, natural order,
//        luma blocks TL, TR, BL, BR within each MCU; B_Y = 4 B_Cb.
//   The separable form, with X the block's samples: C[v][x] =
//   float32(cos((2x + 1) v pi / 16)) (row 0 exactly 1), S[u][v] =
//   float32(c_u c_v / 4) (S[0][0] exactly 0.125).  Row pass t[y][v] = sum
//   over x = 0..7 ascending of X[y][x] C[v][x]; column pass o[u][v] = sum
//   over y = 0..7 ascending of C[u][y] t[y][v]; every term a float32
//   multiply and then a float32 add, never contracted into a fused
//   multiply-add (the first term is taken as it is: adding it to +0.0f
//   could only change the sign of a zero, which the truncation cannot
//   see).  Then o[u][v] S[u][v] as one float32 multiply, truncated toward
//   zero; then C's truncating division |c| / q (or (2|c| + q) / (2q) when
//   rounded) with the sign put back.  Gray writes zero chroma blocks.
//   The normalisation is not folded into the passes' tables: c_0 / 2
//   squared is not 0.125 in float32, and a flat block's DC would be off.
//
// Kernel 2, idct_planes_kernel, replaces jpezy_tpu/codec/jax_codec.py:
// _decode_fused_batch_ycc420 (with _densify, ops/quantize.py:dequantize,
// ops/dct.py:inverse_dct and the deblockify transpose) and the same tail
// of _decode_fused_batch_device after decode_segments.  Its forms read the
// coefficients from two layouts and share one arithmetic function,
// row_samples:
//   sparse:   the ycc420 transport's single flat uint8 upload, read in
//             place: per image and component mask_lo [B] u32 | mask_hi [B]
//             u32 | vals [B, K] int8; a block's coefficient at natural
//             index j is vals[rank(j)], rank counting the set mask bits
//             below j, and 0 unless bit j is set and the rank is below K.
//             The fields start at any byte, so a word that is not aligned
//             is read bytewise.
//   overflow: a second launch (idct_planes_overflow_kernel) when the
//             upload carries overflow rows (per component oidx [cap] i32 |
//             orows [cap, 64] i16 after the image rows): each row's block
//             is transformed again from its row and overwrites the pixels
//             the first launch wrote.  An index outside [0, N * B_c) (the
//             host's padding sentinel is N * B_c) writes nothing.
//   dense:    the Huffman scan's blocks [N * nseg, ri * 6, 64] int16 in
//             MCU order (4 Y, Cb, Cr), with one quant table per image and
//             component; one more byte per image ORs its segments'
//             corruption flags.
//   Out: per image the planes Y, Cb, Cr, each mcus_y v 8 x mcus_x h 8 u8
//   samples, row after row (the dense form's flag byte after them).
//   Sample p of a block is sum_k float(c[k] q[k]) * M[p][k] over k in
//   ascending order (float32 multiply, then float32 add), then + level as
//   one more float32 add, truncated toward zero and clamped to [0, 255].
//   Zero coefficients are skipped: the sum starts at +0.0f and adding a
//   zero product (+0 or -0) changes no sum, so skipping them is exact and
//   both layouts give the same pixels for the same blocks.
//
// What bounds them, per 16 x 512 x 512 4:2:0 batch (98,304 blocks):
//  - fdct_quantize must move 6.3 MB of int8 samples in and 25.2 MB of
//    int32 blocks out, 9.4 us at 3.35 TB/s.  The separable form is 16
//    8-term products a block, 201 M float32 operations, 3 us at the
//    card's float32 rate (6 us issued as separate multiplies and adds), so
//    the function is bound by bytes; in practice the kernel is bound by
//    instruction issue (the passes, the quantizer and the index
//    arithmetic, about 450 instructions a lane for 4 blocks).  The design
//    is warp-synchronous: a warp takes 4 blocks, lane 8 b + r row r of
//    block b, loaded as one 8-byte word where the plane allows (else
//    element by element at the strides); the row pass runs in the lane's
//    registers, the rows go through the warp's own 1,152-byte shared tile
//    (72 words a block, 9 a row: no bank conflicts either way) to a lane
//    per column, the column pass and the quantizer run there, and the
//    quantized block goes back through the tile so that each lane stores
//    16-byte words and the warp writes its 4 blocks' 1 KB in two fully
//    coalesced stores.  The cosines are kernel parameters (the same index
//    in every lane), S and the quant tables' divisors, rounding terms and
//    reciprocals in shared memory, set once per thread block;
//    the products by C's row 0, which is 1, are the samples themselves.
//    The divisions, the quantizer's and the index arithmetic's, multiply
//    by a reciprocal rounded up (div_exact).  Warps stay resident and walk
//    the tiles component after component with the next tile's samples in
//    flight; the only barrier is the one after the tables.
//  - idct_planes must move the sparse upload (about 1.8 MB) or the dense
//    blocks (12.6 MB) in and 6.3 MB of planes out: 2.4 or 5.6 us.  Its
//    operations depend on the data, 64 multiply-adds per nonzero
//    coefficient, two a block on the photographs of the main path, so the
//    function is bound by bytes; the kernel, by instruction issue and by
//    the latency of each warp's loads.  An earlier design lost its time to
//    each block's chain of dependent global loads, to a whole warp per
//    block and to single-byte stores that filled a quarter of every
//    sector.  The work unit is now a warp's strip: up to kUnitBlocks
//    blocks (whole MCUs) of one MCU row of one image and component, so its
//    sources are contiguous ranges of the input (mask words and value
//    bytes, or each MCU's int16 blocks) and its samples whole 8-row bands
//    of the plane.  The warp loads the unit's sources at once into its own
//    shared memory (all the loads in flight together, the dense blocks'
//    nonzero masks found on the way), then runs the blocks four at a
//    time, a group of 8 lanes a block and a lane a row of it (the
//    coefficient's value broadcast from shared memory, the basis, held in
//    shared memory for the whole launch, read as two 16-byte words a
//    term), into a shared image of the unit whose rows sit at the same
//    address modulo 16 as their destination; then the unit leaves row
//    after row in 16-byte stores that fill whole sectors, the ends of rows
//    whose destination is not aligned bytewise, neighbouring lanes on
//    neighbouring bytes.  No barrier past the tables.  A thread block that
//    stages whole strips for all its warps with cp.async, the next strip's
//    copy in flight, was measured slower (PERF.md).
//
// No atomics: every output is written by one thread, so the same input
// gives the same bits on every run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xFFFFFFFFu;

// Kernel 1: 8 warps a thread block, 4 blocks a warp at a time.
constexpr int kFdctThreads = 256;
constexpr int kFdctWarps = kFdctThreads / 32;
constexpr int kFdctTile = 4;      // blocks a warp's tile
constexpr int kBlockWords = 72;   // a block's words in the warp's tile
constexpr int kRowWords = 9;      // a row's words there (the row pass)

// Kernel 2: 8 warps a thread block, a warp a unit, a group of 8 lanes a
// block.
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
// Kernel 1: blockify, forward DCT (separable), quantize
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
    fdct_quantize_kernel(const __grid_constant__ FdctArgs a) {
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

// ---------------------------------------------------------------------------
// Kernel 2: dequantize, inverse DCT, level shift, clamp, into the planes
// ---------------------------------------------------------------------------

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
    idct_planes_kernel(const __grid_constant__ IdctArgs a) {
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

// The overflow launch: every overflow row's block transformed again from
// the row, its samples stored over the first launch's.  A group of 8
// lanes a row, 4 rows a warp at a time, the rows of the three components
// one after the other; no barrier past the basis and the tables.
__global__ void __launch_bounds__(kIdctThreads)
    idct_planes_overflow_kernel(const __grid_constant__ IdctArgs a) {
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
// 1 (int8 samples) or 4 (int32).  desc (host memory): nimages, mcus_y,
// mcus_x, gray, rounded, then per component Y, Cb, Cr its element strides
// (image, row, column).  tabs (host memory): 128 float32, C[v][x] then
// S[u][v], passed to the kernel as parameters.
int jz_fdct_quantize(int elem_bytes, const long long* desc, const float* tabs,
                     const void* y, const void* cb, const void* cr,
                     const void* yq, const void* cq, void* oy, void* ocb,
                     void* ocr, void* stream) {
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
// corruption flags `bad`, one byte each.  basis_t: the
// inverse basis transposed, [k][p].  desc (host memory):
// nimages, ncomp, mcus_x, K, level, nseg, row_bytes, image_blocks,
// out_stride, q_stride, planes, mcu_blocks, then per component nblocks, v,
// h, width, cap, slot0, plane_off, mlo_off, mhi_off, val_off, oidx_off,
// orows_off.  Sampling factors 1..4; the sparse form takes K in 1..64.
int jz_idct_planes(int dense, const long long* desc, const void* src,
                   const void* bad, const void* q, const void* basis_t,
                   void* out, void* stream) {
  IdctArgs a;
  a.nimages = static_cast<int>(desc[0]);
  a.ncomp = static_cast<int>(desc[1]);
  if (a.nimages <= 0) return 0;
  if (a.ncomp < 1 || a.ncomp > 3 || desc[0] > 0x7FFFFFFFll ||
      desc[2] <= 0 || (dense && bad == nullptr) ||
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
  long long caps = 0, units = 0;
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
      p.mcus_y = static_cast<int>(d[0] / (p.per * desc[2]));
      p.mpu = p.per < kUnitBlocks ? kUnitBlocks / p.per : 1;
      p.ux = (a.mcus_x + p.mpu - 1) / p.mpu;
      const long long n = desc[0] * p.mcus_y * p.ux;
      if (n > 0x7FFFFFFFll) return static_cast<int>(cudaErrorInvalidValue);
      p.units = static_cast<int>(n);
      caps += p.cap;
      units += n;
    } else {
      p.cap = p.nblocks = 0;
    }
  }
  if (units > 0x7FFFFFFFll) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks_needed = (units + kIdctWarps - 1) / kIdctWarps;
  a.flat = static_cast<const uint8_t*>(src);
  a.blocks = static_cast<const int16_t*>(src);
  a.bad = static_cast<const uint8_t*>(bad);
  a.q = static_cast<const int32_t*>(q);
  a.basis_t = static_cast<const float*>(basis_t);
  a.out = static_cast<uint8_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int grid = 0;
  cudaError_t e;
  if (dense) {
    e = grid_for(idct_planes_kernel<kDense>, kIdctThreads, blocks_needed,
                 &grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    // the flag bytes need a thread block even without units
    idct_planes_kernel<kDense><<<grid > 0 ? grid : 1, kIdctThreads, 0, s>>>(
        a);
    return static_cast<int>(cudaGetLastError());
  }
  e = grid_for(idct_planes_kernel<kSparse>, kIdctThreads, blocks_needed,
               &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  idct_planes_kernel<kSparse><<<grid > 0 ? grid : 1, kIdctThreads, 0, s>>>(
      a);
  e = cudaGetLastError();
  if (e != cudaSuccess || caps == 0) return static_cast<int>(e);
  e = grid_for(idct_planes_overflow_kernel, kIdctThreads,
               (caps + 4 * kIdctWarps - 1) / (4 * kIdctWarps), &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  idct_planes_overflow_kernel<<<grid, kIdctThreads, 0, s>>>(a);
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
      return kernel_info(idct_planes_kernel<kSparse>, kIdctThreads, info);
    case 3:
      return kernel_info(idct_planes_kernel<kDense>, kIdctThreads, info);
    case 4:
      return kernel_info(idct_planes_overflow_kernel, kIdctThreads, info);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* jz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Exact mode's two block transforms for Hopper (sm_90a): the float64
// forward DCT in the reference's term order with quantization on encode,
// and dequantization with the float64 inverse DCT in the reference's term
// order into int32 planes on decode.  precision="exact" promises streams
// byte-identical to the reference encoder and pixels identical to its
// decoder, so every rounding of the reference's double arithmetic is kept.
//
// Kernel 1, fdct_quantize_exact_kernel, replaces exact mode's half of the
// stage XLA fused on the TPU in jpezy_tpu/parallel/sharded.py:
// _quantize_local_ycc: ops/blocks.py:blockify_luma and blockify_chroma,
// ops/dct.py:_forward_dct_ordered and ops/quantize.py:quantize.
//   In:  Y-128 [N, H, W] and Cb, Cr [N, H/2, W/2] samples, int8 or int32,
//        at any element strides (the ycc420 upload's views, the rgb path's
//        decimated chroma); the float64 tables COS[u][x] = cos((2x + 1) u
//        pi / 16) and cu (cu[0] = 1/sqrt(2), else 1) as kernel parameters;
//        one [64] int32 quant table for luma, one for chroma.
//   Out: quantized blocks [N, B_c, 64] int32 per component, natural order,
//        luma blocks TL, TR, BL, BR within each MCU; gray writes zero
//        chroma blocks.
//   Per block p and coefficient (i, j) (codec/oracle.py:forward_dct): s
//   starts at +0, then for k = 8 y + x ascending s += (p[k] COS[j][x])
//   COS[i][y]; then ((s cu[j]) cu[i]) / 4, truncated toward zero; then C's
//   truncating division |c| / q (or (2|c| + q) / (2q) when rounded) with
//   the sign put back.
//
// Kernel 2, idct_planes_exact_kernel, replaces exact mode's half of
// jpezy_tpu/codec/jax_codec.py:_decode_fused_batch up to the upsampling:
// ops/quantize.py:dequantize, ops/dct.py:_inverse_dct_ordered and the
// deblockify transpose.
//   In:  the rgb transport's coefficients [N, sum B_c, 64] (int16 or int32,
//        every component's blocks of an image in one row, MCU order), the
//        components' [ncomp, 64] int32 quant tables, the float64 tables COS
//        and cucv[k] = fl(cu[u] cv[v]) (k = 8 v + u).
//   Out: per component its int32 plane [N, mcus_y v 8, mcus_x h 8],
//        UNclamped (colour conversion follows in float64).  Gray takes
//        component 0 only.
//   Per block and sample (y, x) (codec/oracle.py:inverse_dct): d[k] =
//   c[k] q[k] as a 32-bit integer; s starts at +0, then for k = 8 v + u
//   ascending s += ((cucv[k] d[k]) COS[u][x]) COS[v][y]; then s / 4 +
//   level (128, or 2048 for 12-bit frames), truncated toward zero.
//
// Kernel 3, idct_planes_rgb_kernel, is the float32 inverse for the rgb
// transport's fast decode: it replaces the float32 half of
// jpezy_tpu/codec/jax_codec.py:_decode_fused_batch up to the upsampling
// (ops/quantize.py:dequantize, ops/dct.py:inverse_dct at float32,
// deblockify).  Same inputs and outputs as kernel 2, with the [64][64]
// float32 inverse basis M[p][k] (p = 8 y + x, k = 8 v + u) in place of the
// float64 tables.
//   Per block and sample p: s starts at +0, then for k ascending over the
//   nonzero d[k], s += fl32(d[k]) M[p][k] (a float32 multiply, then a
//   float32 add); then s + level, truncated toward zero: the numpy model
//   block_transform.inverse_model, bit for bit.  torch.matmul (the plain
//   version) sums in another order, so the two may differ by 1.
//
// The traps, each of which flips the truncation of some coefficient or
// sample (the smoke's tie set finds them):
//  - No contraction.  nvcc contracts a*b + c into DFMA (FFMA) by default,
//    which skips the product's rounding.  Every multiply and add here is
//    __dmul_rn / __dadd_rn (__fmul_rn / __fadd_rn), which are never
//    contracted; chip_smoke.py finds no DFMA in the SASS of kernels 1 and 2
//    and no FFMA in kernel 3's.
//  - No refolding.  cu[i] cu[j], the / 4 and the two cosines of a term are
//    not premultiplied into one table: each product is rounded where the
//    reference rounds it.  Only products the reference computes anyway are
//    shared: p[k] COS[j][x] does not depend on i, so it is computed once per
//    (k, j) and used for the 8 values of i (the same IEEE value), and
//    cucv[k] d[k] once per coefficient.  A / 4 is a multiply by 0.25 (both
//    exact, and equal).
//  - No device trigonometry.  The tables are the port's float64 masters
//    (constants.exact_tables, numpy's cos and sqrt), handed from the host;
//    cos() or sqrt() on the device may differ in the last bit.
//  - Truncation is __double2int_rz, as C's int() and torch's .to(int32).
//
// What the kernels leave out, exactly:
//  - Products by exactly 1 (kernels 1 and 2): x 1 = x for every x.
//    COS[0][x] = cos(0) = 1, cu[j] = 1 for j >= 1 and cucv[k] = 1 where u
//    and v are both nonzero (the launchers refuse tables where these are
//    not 1).
//  - The first add of a sum, onto +0: +0 + t = t but for the sign of a
//    zero.  The first term is stored instead.
//  - Zero inputs: a zero sample or coefficient makes every term of its k
//    +0 or -0, and x + (+-0) = x for every x != 0, so leaving such terms
//    out changes a sum at most in the sign of a zero.  A zero sum's sign
//    is dropped by everything that follows (products keep a zero zero, and
//    the truncation of +-0, or of +-0 + level, is the same integer).  So
//    the outputs are the 64-term sums' bit for bit.
//
// What bounds them, per 16 x 512 x 512 4:2:0 batch (98,304 blocks):
//  - fdct_quantize_exact: float64 issue.  A block with no zero sample
//    needs 8,144 separate DMUL/DADD (chip_smoke.py: EXACT_FWD_OPS),
//    0.80e9 a batch: 0.048 ms at the card's 16.75e12 a second (33.5
//    TFLOP/s with an FMA counted two).  Its bytes (6.3 MB of int8 samples
//    in, 25.2 MB of blocks out) take 0.009 ms.  Design: a warp takes 4
//    blocks; lane 8 b + r loads row r of block b a tile ahead (its loads in
//    flight while the tile before is summed), puts it as doubles into the
//    warp's shared tile (65 doubles a block, so the 4 blocks' same sample
//    falls in different banks), and the warp ORs the 4 blocks' nonzero
//    samples into one 64-bit mask (__reduce_or_sync: a warp-uniform
//    value).  Then the lane owns column j = r of block b, holds
//    COS[j][0..7] and cu[j] in registers and keeps 8 accumulators, one per
//    row i.  Per sample: one shared load, the first product p[k]
//    COS[j][x], its add into row 0 (COS[0][y] = 1), and 7 products by
//    COS[i][y] (kernel parameters at compile-time offsets: uniform
//    operands, no table in shared memory) with 7 adds, eight independent
//    add chains; k = 0 stores.  A warp whose mask holds kDenseTerms or
//    more takes all 64 samples in one branch-free run, which the compiler
//    schedules as a whole; below, each sample behind a uniform branch on
//    the mask (one branch a sample costs the dense run about 15 %).  Then
//    per lane 8 products by cu[j], one by cu[0] for row 0 and 8 by 0.25.
//    A block with no zero sample issues 8,264 operations (the first
//    design, scripts/previous_designs.cu: 8,896): the 120 beyond the need
//    are the products by COS[0][x] and cu[j] = 1 in the lanes whose column
//    j makes them so, which vary with the lane.  The lane truncates and
//    quantizes its 8 coefficients, the divisions by reciprocals rounded up
//    (div_exact: the same quotients as C's, far fewer instructions); the
//    stores of a row i fill whole 32-byte sectors.
//  - idct_planes_exact: bytes, the int16 upload (12.6 MB) and the int32
//    planes (25.2 MB), 0.011 ms; operations, per nonzero coefficient 64
//    adds, 8 column products if u >= 1, 64 row products if v >= 1 and the
//    product cucv[k] d[k] if u or v is 0, and 64 a block (chip_smoke.py:
//    EXACT_INV_OPS), which on photographs is far below the bytes and on
//    noise at quality 100 about 0.047 ms.  Design: a warp takes 4 blocks;
//    lane 8 b + r loads row r of block b's coefficients (one 16-byte load
//    of int16), dequantizes it, multiplies the
//    coefficients whose cucv is not 1 (u = 0 in every lane, u >= 1 in the
//    lanes of row 0) and puts cucv[k] d[k] into the warp's tile as
//    doubles; the warp ORs the 4 blocks' nonzero coefficients into one
//    uniform 64-bit mask.  Then lane 8 b + x owns column x of block b with
//    8 accumulators, one per row y, and takes the coefficients in
//    ascending k: one shared load of the block's cucv[k] d[k], the product
//    by COS[u][x] (in registers; none for u = 0), 8 products by COS[v][y]
//    (uniform operands; none for v = 0) and 8 adds (k = 0 stores).  As in
//    kernel 1, a warp whose mask holds kDenseTerms or more takes all 64 in
//    one branch-free run, else each behind a uniform branch (a row of 8
//    behind one more).  A dense block issues 8,207 operations, the count
//    the bound takes (the first design: 9,344, with 7 shared loads a term
//    where this takes 1).  The index arithmetic divides by reciprocals
//    (div_exact), and registers are held to 64 for 4 thread blocks an SM:
//    on photographs the kernel waits on memory, and the warps keep its
//    loads in flight.  The lane stores its column of int32 samples, each
//    row's 8 lanes one 32-byte sector.
//  - idct_planes_rgb: bytes on photographs, the same 37.8 MB as
//    idct_planes_exact's, 0.011 ms; float32 adds on dense blocks: per
//    nonzero coefficient its 64 adds and one product per distinct
//    |M[.][k]| (384 over the 64 k; chip_smoke.py: rgb_inv_ops), on noise
//    at quality 100 about 0.013 ms at 33.5e12 separate FMUL/FADD a second.
//    Design: the basis is mirror-symmetric bit for bit, M[8 y + 7 - x][k]
//    = (-1)^u M[p][k] and M[8 (7 - y) + x][k] = (-1)^v M[p][k]
//    (exact_cuda makes no table of another basis), and fl(d (-m)) = -fl(d m), so one
//    product serves the 4 samples of a mirror quad (y, x), (y, 7 - x),
//    (7 - y, x), (7 - y, 7 - x) as an add of +-t with the same bits: 16
//    products and 64 adds a coefficient of a block (the first design, a
//    lane a column with the whole basis in shared memory: 64 and 64, and 9
//    shared loads for every 16 float operations, which bound it).  A warp
//    takes 8 blocks; lane 8 b + r loads row r of blocks b and b + 4,
//    dequantizes them into the warp's tile as float32 (blocks 2 p and
//    2 p + 1 side by side) and the warp ORs the 8 blocks' nonzero
//    coefficients into one uniform mask.  Lane 8 p + j keeps 16 sums (the
//    4 samples of quads j and j + 8 of blocks 2 p and 2 p + 1, 16
//    independent add chains) and takes two coefficients a step: one
//    16-byte shared load of d[k], d[k + 1] of its two blocks, one of its
//    two quads' M[p][k], M[p][k + 1] (the 16 quads' 1,024 values stay in
//    shared memory: 64 registers of basis held a draft to 16 warps an SM),
//    8 products and 32 adds.  What the warp reads from shared memory a
//    term, 32 lanes' 16 bytes, serves 8 blocks: 64 bytes a block and term,
//    where 4 blocks a warp (one quad of two blocks a lane) took 96 and the
//    loads' data, not the float32 issue, bounded the sums on dense blocks.
//    Kernel 2's walk: all 64 terms in one branch-free run where the mask
//    holds kRgbDenseTerms or more, else each behind a uniform branch; k = 0
//    stores.  The samples go back through the tile, so that two lanes
//    store each row of 8 (a 32-byte sector) with two 16-byte stores.  One
//    tile a warp, not a persistent grid: with as many warps as the card
//    holds looping over the tiles, the last round left most of them idle.
//
// No atomics: every output is written by one thread, so the same input
// gives the same bits on every run.
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace {

constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4;       // blocks a warp
constexpr int kStride = 65;    // doubles a block in the warp's tile
// mask bits (of 64) from which a warp takes every term in one straight run
constexpr int kDenseTerms = 56;
// thread blocks an SM the inverse's registers are held to (64 a thread):
// more warps to keep the byte-bound sets' loads in flight
constexpr int kInvBlocksPerSm = 4;

// The 64-bit mask of the warp's blocks' nonzero entries, bit k = 8 r + u
// of lo (k < 32) or hi, from each lane's mask of its row r: warp-uniform.
__device__ __forceinline__ void union_mask(unsigned row_mask, int r,
                                           unsigned* lo, unsigned* hi) {
  *lo = __reduce_or_sync(kFullMask, r < 4 ? row_mask << (8 * r) : 0u);
  *hi = __reduce_or_sync(kFullMask, r < 4 ? 0u : row_mask << (8 * (r - 4)));
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

// Row r of a block's samples as loaded (8 bytes of int8 or 32 of int32),
// so that the next tile's loads are in flight while this one is summed.
template <typename T>
struct SampleRow;
template <>
struct SampleRow<int8_t> {
  uint2 w;
  __device__ __forceinline__ double at(int j) const {
    const uint32_t v = j < 4 ? w.x : w.y;
    return __int2double_rn(static_cast<int8_t>((v >> (8 * (j & 3))) & 0xFF));
  }
};
template <>
struct SampleRow<int32_t> {
  int4 a, b;
  __device__ __forceinline__ double at(int j) const {
    const int4& p = j < 4 ? a : b;
    const int k = j & 3;
    return __int2double_rn(k == 0 ? p.x
                                  : (k == 1 ? p.y : (k == 2 ? p.z : p.w)));
  }
};

// 8 samples from src at column stride sc.
__device__ __forceinline__ void load_row(const int8_t* src, long long sc,
                                         SampleRow<int8_t>* row) {
  if (sc == 1 && (reinterpret_cast<uintptr_t>(src) & 7) == 0) {
    row->w = __ldg(reinterpret_cast<const uint2*>(src));
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
  row->w = make_uint2(lo, hi);
}

__device__ __forceinline__ void load_row(const int32_t* src, long long sc,
                                         SampleRow<int32_t>* row) {
  if (sc == 1 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    row->a = __ldg(reinterpret_cast<const int4*>(src));
    row->b = __ldg(reinterpret_cast<const int4*>(src) + 1);
    return;
  }
  row->a = make_int4(__ldg(src), __ldg(src + sc), __ldg(src + 2 * sc),
                     __ldg(src + 3 * sc));
  row->b = make_int4(__ldg(src + 4 * sc), __ldg(src + 5 * sc),
                     __ldg(src + 6 * sc), __ldg(src + 7 * sc));
}

// C's truncating division num / den for num >= 0 and den >= 1, from
// rcp = 1/den rounded up (the quantizer's and the index arithmetic's
// divisions).  Below 2^22 the product num rcp, rounded up, is at least
// num / den and below num / den + num / den 2^-22 (1 + 2^-24), which stays
// under the next integer since the remainder is at most den - 1; so its
// truncation is the quotient.  Above, or where den is 2^24 or more (rcp
// 0), the integer division.  (block_transforms.cu's, the same proof.)
__device__ __forceinline__ int div_exact(int num, int den, float rcp) {
  if (num >= (1 << 22) || rcp == 0.f) return num / den;
  return __float2int_rz(__fmul_ru(__int2float_rn(num), rcp));
}

// The float32 whose bits are i.
__host__ __device__ __forceinline__ float bits_as_float(int i) {
#ifdef __CUDA_ARCH__
  return __int_as_float(i);
#else
  float f;
  std::memcpy(&f, &i, sizeof f);
  return f;
#endif
}

// 1/d rounded up for div_exact (the smallest float32 at or above it), 0
// from 2^24 on, in integer arithmetic alone: __frcp_ru would bring FFMA
// into kernels whose SASS must hold none (chip_smoke.py phase 2).  With
// 2^e <= d < 2^(e+1) and D = d 2^(23-e), 1/d = (2^47 / D) 2^-(e+24): the
// quotient, by restoring division, rounded up, is the 24-bit mantissa.
// Kernels 1 and 2 make their reciprocals with it on the device, kernel 3's
// launcher on the host: one rule.
__host__ __device__ __forceinline__ float rcp_up(int d) {
  if (d < 1 || d >= (1 << 24)) return 0.f;
#ifdef __CUDA_ARCH__
  const int e = 31 - __clz(d);
#else
  int e = 0;
  while (d >> (e + 1)) ++e;
#endif
  if ((d & (d - 1)) == 0) return bits_as_float((127 - e) << 23);
  const unsigned den = static_cast<unsigned>(d) << (23 - e);
  unsigned q = 0, rem = 0;
#pragma unroll 1
  for (int i = 47; i >= 0; --i) {
    rem = (rem << 1) | (i == 47 ? 1u : 0u);
    q <<= 1;
    if (rem >= den) {
      rem -= den;
      q |= 1u;
    }
  }
  q += rem != 0u;   // in (2^23, 2^24]; 2^24 rounds up to 2^-e
  return bits_as_float(q == (1u << 24) ? (127 - e) << 23
                                       : ((126 - e) << 23) |
                                             static_cast<int>(q - (1u << 23)));
}

// Tile tile_i's component *c and first block *first; the lane's row (lane
// 8 b + r: row r of the tile's block b) into *row, zeros past the
// component's last block and for gray chroma.  rcp_nb: 1 / nblocks of
// each component, rounded up.
template <typename T>
__device__ __forceinline__ void fdct_load(const FwdArgs& a,
                                          const float* rcp_nb, float rcp_mx,
                                          int tile_i, int b, int r, int* c,
                                          int* first, SampleRow<T>* row) {
  *c = tile_i < a.ty ? 0 : (tile_i < a.ty + a.tc ? 1 : 2);
  *first = (tile_i - (*c == 0 ? 0 : (*c == 1 ? a.ty : a.ty + a.tc))) * kTile;
  *row = SampleRow<T>{};
  const FwdComp& P = a.comp[*c];
  const int f = *first + b;
  if (f >= a.nimages * P.nblocks || (a.gray && *c > 0)) return;
  const int n = div_exact(f, P.nblocks, rcp_nb[*c]);
  const int bi = f - n * P.nblocks;
  // 4:2:0: luma blocks TL, TR, BL, BR of MCU bi / 4, chroma MCU bi
  const int m = *c == 0 ? bi >> 2 : bi;
  const int my = div_exact(m, a.mcus_x, rcp_mx);
  const int mx = m - my * a.mcus_x;
  const int y0 = *c == 0 ? (2 * my + ((bi >> 1) & 1)) * 8 : my * 8;
  const int x0 = *c == 0 ? (2 * mx + (bi & 1)) * 8 : mx * 8;
  load_row(static_cast<const T*>(P.base) + n * P.sn + (y0 + r) * P.sr +
               x0 * P.sc,
           P.sc, row);
}

// The 64 terms of column j (cj = COS[j][0..7]) of the block whose samples
// are p[0..63] into acc[i], i = 0..7, in the reference's order k = 8 y + x.
// kSkip: only where the mask's bit k is set (a sample nonzero in one of
// the warp's blocks), each behind a uniform branch; else all 64 in one
// straight run, which the compiler schedules as a whole.
template <bool kSkip>
__device__ __forceinline__ void forward_terms(const FwdArgs& a,
                                              const double* p,
                                              const double* cj, unsigned lo,
                                              unsigned hi, double* acc) {
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.0;
#pragma unroll
  for (int y = 0; y < 8; ++y) {
#pragma unroll
    for (int xx = 0; xx < 8; ++xx) {
      const int k = 8 * y + xx;
      if (kSkip && !(((k < 32 ? lo : hi) >> (k & 31)) & 1u)) continue;
      const double t = __dmul_rn(p[k], cj[xx]);
      acc[0] = k == 0 ? t : __dadd_rn(acc[0], t);   // COS[0][y] = 1
#pragma unroll
      for (int i = 1; i < 8; ++i) {
        const double q = __dmul_rn(t, a.cosv[i * 8 + y]);
        acc[i] = k == 0 ? q : __dadd_rn(acc[i], q);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fdct_quantize_exact_kernel(const __grid_constant__ FwdArgs a) {
  __shared__ double tiles[kWarps][kTile * kStride];
  __shared__ int den[2][64];     // luma, chroma: q, or 2 q when rounded
  __shared__ int bias[2][64];    // what a rounded quotient adds: q, or 0
  __shared__ float rcp[2][64];   // 1 / den, rounded up
  __shared__ float rcp_nb[3];    // 1 / nblocks of each component, rounded up
  const int t = threadIdx.x;
  if (t < 3) rcp_nb[t] = rcp_up(a.comp[t].nblocks);
  if (t < 128) {
    const int k = t & 63;
    const int q = __ldg(a.comp[t >> 6].q + k);
    den[t >> 6][k] = a.rounded ? 2 * q : q;
    bias[t >> 6][k] = a.rounded ? q : 0;
    rcp[t >> 6][k] = rcp_up(a.rounded ? 2 * q : q);
  }
  __syncthreads();
  const float rcp_mx = rcp_up(a.mcus_x);
  const int lane = t & 31;
  double* tile = tiles[t >> 5];
  const int b = lane >> 3;      // the lane's block in the tile
  const int r = lane & 7;       // its row (load), then its column j
  // COS[j][x] for the lane's column j = r, and cu[j]
  double cj[8];
#pragma unroll
  for (int x = 0; x < 8; ++x) cj[x] = a.cosv[r * 8 + x];
  const double cuj = a.cu[r];
  const int total = a.ty + 2 * a.tc;
  const int warps = gridDim.x * kWarps;
  // the samples of the next tile are loaded while this one is summed
  int c_next = 0, first_next = 0;
  SampleRow<T> next = {};
  int tile_i = blockIdx.x * kWarps + (t >> 5);
  if (tile_i < total)
    fdct_load<T>(a, rcp_nb, rcp_mx, tile_i, b, r, &c_next, &first_next,
                 &next);
  for (; tile_i < total; tile_i += warps) {
    const int c = c_next;
    const int first = first_next;
    const SampleRow<T> cur = next;
    if (tile_i + warps < total)
      fdct_load<T>(a, rcp_nb, rcp_mx, tile_i + warps, b, r, &c_next,
                   &first_next, &next);
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
    unsigned row_mask = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const double x = cur.at(j);
      tile[b * kStride + r * 8 + j] = x;
      row_mask |= (x != 0.0 ? 1u : 0u) << j;
    }
    unsigned lo, hi;
    union_mask(row_mask, r, &lo, &hi);
    __syncwarp();
    // the 64 terms of column j in the reference's order, k = 8 y + x: all
    // of them where the 4 blocks' samples are nearly all nonzero, else
    // each behind a uniform branch on the mask
    double acc[8];
    if (__popc(lo) + __popc(hi) >= kDenseTerms)
      forward_terms<false>(a, tile + b * kStride, cj, lo, hi, acc);
    else
      forward_terms<true>(a, tile + b * kStride, cj, lo, hi, acc);
    __syncwarp();  // the tile is loaded again for the next blocks
    if (!live) continue;
    const int* dn = den[c > 0];
    const int* bs = bias[c > 0];
    const float* rc = rcp[c > 0];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      double s = __dmul_rn(acc[i], cuj);
      if (i == 0) s = __dmul_rn(s, a.cu[0]);          // cu[i] = 1 for i >= 1
      const int cf = __double2int_rz(__dmul_rn(s, 0.25));
      // quantize: |c| / q, or (2|c| + q) / (2q) rounded
      const int k = i * 8 + r;
      const int mag = cf < 0 ? -cf : cf;
      const int qm = div_exact((mag << a.rounded) + bs[k], dn[k], rc[k]);
      out[i * 8] = cf < 0 ? -qm : qm;
    }
  }
}

// ---------------------------------------------------------------------------
// Kernels 2 and 3: dequantize, ordered inverse DCT, deblockify
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
  const float* basis;     // the fast form's quads' table (jz_idct_planes_rgb)
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

// The divisors of a component's index arithmetic as reciprocals rounded up
// (div_exact): 1 / nblocks, 1 / (v h), 1 / h.
struct InvRcp {
  float nb, per, h;
};

// The offset in its plane of the top-left sample of block bi of component
// P, whose MCUs hold v x h blocks in raster order (luma 2 x 2 at 4:2:0:
// TL, TR, BL, BR): MCU m, row vy of it.
__device__ __forceinline__ long long block_offset(const InvComp& P,
                                                  int mcus_x, int bi,
                                                  const InvRcp& rcp,
                                                  float rcp_mx) {
  const int m = div_exact(bi, P.v * P.h, rcp.per);
  const int rb = bi - m * P.v * P.h;
  const int my = div_exact(m, mcus_x, rcp_mx);
  const int vy = div_exact(rb, P.h, rcp.h);
  const int row0 = (my * P.v + vy) * 8;
  const int col0 = ((m - my * mcus_x) * P.h + (rb - vy * P.h)) * 8;
  return static_cast<long long>(row0) * P.width + col0;
}

// The 64 terms of column x (cx[u] = COS[u][x]) of the block whose
// cucv[k] d[k] are e[0..63] into acc[y], y = 0..7, in ascending k = 8 v + u.
// kSkip: only where the mask's bit k is set, each behind a uniform branch
// (a row of 8 behind one more); else all 64 in one straight run.
template <bool kSkip>
__device__ __forceinline__ void inverse_terms(const InvArgs& a,
                                              const double* e,
                                              const double* cx, unsigned lo,
                                              unsigned hi, double* acc) {
#pragma unroll
  for (int y = 0; y < 8; ++y) acc[y] = 0.0;
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const unsigned row = ((v < 4 ? lo : hi) >> (8 * (v & 3))) & 0xFFu;
    if (kSkip && row == 0u) continue;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (kSkip && !((row >> u) & 1u)) continue;
      const int k = 8 * v + u;
      const double cxk = u == 0 ? e[k] : __dmul_rn(e[k], cx[u]);
#pragma unroll
      for (int y = 0; y < 8; ++y) {
        // COS[0][y] = 1: a term of row v = 0 is its column product
        const double term = v == 0 ? cxk : __dmul_rn(cxk, a.cosv[v * 8 + y]);
        acc[y] = k == 0 ? term : __dadd_rn(acc[y], term);
      }
    }
  }
}

// Kernel 2 (see the header): the warp's 4 blocks walked as one, over the
// union of their nonzero coefficients, every table index a compile-time
// constant but the lane's own column x.
template <typename T>
__global__ void __launch_bounds__(kThreads, kInvBlocksPerSm)
    idct_planes_exact_kernel(const __grid_constant__ InvArgs a) {
  __shared__ double tiles[kWarps][kTile * kStride];
  __shared__ int qs[3][64];
  __shared__ InvRcp rcp[3];
  const int t = threadIdx.x;
  for (int i = t; i < 64 * a.ncomp; i += kThreads)
    qs[i >> 6][i & 63] = __ldg(a.q + i);
  if (t < 3) {
    const InvComp& P = a.comp[t];
    rcp[t] = {rcp_up(P.nblocks), rcp_up(P.v * P.h), rcp_up(P.h)};
  }
  __syncthreads();
  const float rcp_mx = rcp_up(a.mcus_x);
  const int lane = t & 31;
  double* tile = tiles[t >> 5];
  const int b = lane >> 3;      // the lane's block in the tile
  const int r = lane & 7;       // its row (load), then its column x
  // cucv of the lane's row's first coefficient (k = 8 r), and COS[u][x] of
  // its column x = r
  const double cucv_r = a.cucv[8 * r];
  double cx[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) cx[u] = a.cosv[u * 8 + r];
  const double level = __int2double_rn(a.level);
  const int total = a.tiles[0] + a.tiles[1] + a.tiles[2];
  for (int tile_i = blockIdx.x * kWarps + (t >> 5); tile_i < total;
       tile_i += gridDim.x * kWarps) {
    int c = 0, lt = tile_i;
    while (lt >= a.tiles[c]) lt -= a.tiles[c++];
    const InvComp& P = a.comp[c];
    const int f = lt * kTile + b;   // the lane's block
    const bool live = f < a.nimages * P.nblocks;
    const int n = live ? div_exact(f, P.nblocks, rcp[c].nb) : 0;
    const int bi = f - n * P.nblocks;
    int d[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) d[u] = 0;
    if (live)
      load_coeffs(static_cast<const T*>(a.coeff) +
                      (static_cast<long long>(n) * a.row_blocks + P.first +
                       bi) * 64 + r * 8,
                  d);
    // row r of the block dequantized, d = c q as a 32-bit integer, then
    // cucv[k] d[k] into the tile: cucv is 1 but where u or v is 0
    unsigned row_mask = 0;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      d[u] = static_cast<int>(static_cast<unsigned>(d[u]) *
                              static_cast<unsigned>(qs[c][r * 8 + u]));
      row_mask |= (d[u] != 0 ? 1u : 0u) << u;
    }
    double* dst = tile + b * kStride + r * 8;
    dst[0] = __dmul_rn(cucv_r, __int2double_rn(d[0]));
    if (r == 0) {
#pragma unroll
      for (int u = 1; u < 8; ++u)
        dst[u] = __dmul_rn(a.cucv[u], __int2double_rn(d[u]));
    } else {
#pragma unroll
      for (int u = 1; u < 8; ++u) dst[u] = __int2double_rn(d[u]);
    }
    unsigned lo, hi;
    union_mask(row_mask, r, &lo, &hi);
    __syncwarp();
    double acc[8];
    if (__popc(lo) + __popc(hi) >= kDenseTerms)
      inverse_terms<false>(a, tile + b * kStride, cx, lo, hi, acc);
    else
      inverse_terms<true>(a, tile + b * kStride, cx, lo, hi, acc);
    __syncwarp();  // the tile is loaded again for the next blocks
    if (!live) continue;
    int32_t* out = P.out + n * P.plane +
                   block_offset(P, a.mcus_x, bi, rcp[c], rcp_mx) + r;
#pragma unroll
    for (int y = 0; y < 8; ++y)
      out[static_cast<long long>(y) * P.width] =
          __double2int_rz(__dadd_rn(__dmul_rn(acc[y], 0.25), level));
  }
}

// ---------------------------------------------------------------------------
// Kernel 3: dequantize, the fast float32 inverse DCT, deblockify
// ---------------------------------------------------------------------------

// One tile of kRgbTile blocks a warp, kRgbWarps a thread block, as many
// thread blocks as the tiles fill (not a persistent grid: the card's
// scheduler starts a thread block where one ends, and no round of tiles is
// left to a few warps at the end).
constexpr int kRgbThreads = 128;
constexpr int kRgbWarps = kRgbThreads / 32;
constexpr int kRgbTile = 8;
// thread blocks an SM its registers are held to (64 a thread at most)
constexpr int kRgbBlocksPerSm = 8;
// mask bits (of 64) from which a warp takes every term in one straight run
constexpr int kRgbDenseTerms = 32;
// The warp's tile, in floats.  Coefficients: row v of the pair p's blocks
// 2 p and 2 p + 1 at float kPairStride p + kRowStride v, d[k] of block
// 2 p + s at 2 u + s, so that one 16-byte load gives a lane d[k] and
// d[k + 1] of both its blocks (k even); the pad after each row and the
// pairs' offsets put the four pairs' loads of one k in different banks.
// Then, for the stores, the samples as int32 [8][64], block 2 p + s's rows
// and halves of a row permuted by p (sample_at).
constexpr int kRowStride = 20;
constexpr int kPairStride = 8 * kRowStride + 4;
constexpr int kRgbTileFloats = 3 * kPairStride + 8 * kRowStride;

// Kernel 3's arguments: kernel 2's layout, with basis the quads' table
// (jz_idct_planes_rgb), and the reciprocals of the index arithmetic,
// rounded up, made on the host by rcp_up (not in each of its many thread
// blocks).
struct RgbArgs {
  InvArgs in;
  InvRcp rcp[3];
  float rcp_mx;
};

// Row r of a block's coefficients as loaded (16 bytes of int16, or 32 of
// int32), so that the load is in flight while the thread block copies its
// tables; at(u) the coefficient of column u as a 32-bit integer.
template <typename T>
struct CoeffRow;
template <>
struct CoeffRow<int16_t> {
  int4 w;
  __device__ __forceinline__ void load(const int16_t* src) {
    w = __ldg(reinterpret_cast<const int4*>(src));
  }
  __device__ __forceinline__ int at(int u) const {
    const int v = u < 4 ? (u < 2 ? w.x : w.y) : (u < 6 ? w.z : w.w);
    return (u & 1) ? v >> 16 : static_cast<int16_t>(v & 0xFFFF);
  }
};
template <>
struct CoeffRow<int32_t> {
  int4 a, b;
  __device__ __forceinline__ void load(const int32_t* src) {
    a = __ldg(reinterpret_cast<const int4*>(src));
    b = __ldg(reinterpret_cast<const int4*>(src) + 1);
  }
  __device__ __forceinline__ int at(int u) const {
    const int4& p = u < 4 ? a : b;
    const int j = u & 3;
    return j == 0 ? p.x : (j == 1 ? p.y : (j == 2 ? p.z : p.w));
  }
};

// Row r of block f of component P, and off, the element offset of the
// block's top-left sample in P's planes (-1 past P's last block).
template <typename T>
struct RgbRow {
  CoeffRow<T> row;
  long long off;
};

template <typename T>
__device__ __forceinline__ void rgb_load(const InvArgs& a, const InvComp& P,
                                         const InvRcp& rcp, float rcp_mx,
                                         int f, int r, RgbRow<T>* L) {
  L->off = -1;
  L->row = CoeffRow<T>{};
  if (f >= a.nimages * P.nblocks) return;
  const int n = div_exact(f, P.nblocks, rcp.nb);
  const int bi = f - n * P.nblocks;
  L->row.load(static_cast<const T*>(a.coeff) +
              (static_cast<long long>(n) * a.row_blocks + P.first + bi) *
                  64 +
              r * 8);
  L->off = n * P.plane + block_offset(P, a.mcus_x, bi, rcp, rcp_mx);
}

// A row dequantized (d = c q as a 32-bit integer) into dst as float32, at
// dst[2 (u ^ swap)] for column u (a pair of odd p writes its columns in
// swapped pairs: the warp's stores of one step fall in 32 banks); returns
// the row's nonzero mask.
template <typename T>
__device__ __forceinline__ unsigned dequant_row(const CoeffRow<T>& row,
                                                const int* q, float* dst,
                                                int swap) {
  int d[8];
  unsigned mask = 0;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    d[u] = static_cast<int>(static_cast<unsigned>(row.at(u)) *
                            static_cast<unsigned>(q[u]));
    mask |= (d[u] != 0 ? 1u : 0u) << u;
  }
#pragma unroll
  for (int u = 0; u < 8; ++u)
    dst[2 * (u ^ swap)] = __int2float_rn(swap ? d[u ^ 1] : d[u]);
  return mask;
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

// The terms of the lane's two mirror quads of the pair's two blocks into
// acc[block][quad][sample], in ascending k = 8 v + u, two k a step:
// e[5 v + u / 2] holds d[k], d[k + 1] of both blocks, m[8 (k / 2)] the two
// quads' M[p][k], M[p][k + 1].  kSkip: only where the mask's bit k is set
// (a coefficient nonzero in one of the warp's blocks), each behind a
// uniform branch (a row of 8 and a step of 2 behind one more); else all 64
// in one straight run.
template <bool kSkip>
__device__ __forceinline__ void rgb_terms(const float4* e, const float4* m,
                                          unsigned lo, unsigned hi,
                                          float (*acc)[2][4]) {
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[s][h][i] = 0.0f;
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const unsigned row = ((v < 4 ? lo : hi) >> (8 * (v & 3))) & 0xFFu;
    if (kSkip && row == 0u) continue;
#pragma unroll
    for (int u = 0; u < 8; u += 2) {
      const unsigned two = (row >> u) & 3u;
      if (kSkip && two == 0u) continue;
      const int k = 8 * v + u;
      const float4 dk = e[5 * v + u / 2];
      const float4 mk = m[8 * (k / 2)];
      if (!kSkip || (two & 1u)) {
        quad_add(acc[0][0], __fmul_rn(dk.x, mk.x), k, u, v);
        quad_add(acc[1][0], __fmul_rn(dk.y, mk.x), k, u, v);
        quad_add(acc[0][1], __fmul_rn(dk.x, mk.z), k, u, v);
        quad_add(acc[1][1], __fmul_rn(dk.y, mk.z), k, u, v);
      }
      if (!kSkip || (two & 2u)) {
        quad_add(acc[0][0], __fmul_rn(dk.z, mk.y), k + 1, u + 1, v);
        quad_add(acc[1][0], __fmul_rn(dk.w, mk.y), k + 1, u + 1, v);
        quad_add(acc[0][1], __fmul_rn(dk.z, mk.w), k + 1, u + 1, v);
        quad_add(acc[1][1], __fmul_rn(dk.w, mk.w), k + 1, u + 1, v);
      }
    }
  }
}

// Where sample (y, x) of the tile's block ob sits in the samples tile: its
// rows permuted by 2 and its row halves swapped by the block's pair, so
// that the stores of one sum fall in 32 banks.
__device__ __forceinline__ int sample_at(int ob, int y, int x) {
  return ob * 64 + 8 * (y ^ ((ob >> 2) << 1)) + (x ^ (((ob >> 1) & 1) << 2));
}

// Kernel 3 (see the header): lane 8 b + r loads row r of blocks b and
// b + 4; lane 8 p + j sums the mirror quads j and j + 8 of blocks 2 p and
// 2 p + 1 over the union of the 8 blocks' nonzero coefficients; two lanes
// store each row of 8 samples.
template <typename T>
__global__ void __launch_bounds__(kRgbThreads, kRgbBlocksPerSm)
    idct_planes_rgb_kernel(const __grid_constant__ RgbArgs g) {
  const InvArgs& a = g.in;
  __shared__ __align__(16) float tiles[kRgbWarps][kRgbTileFloats];
  // the quads' basis, two k a float4: mq[8 (k / 2) + j] = (M[p][k],
  // M[p][k + 1], M[p'][k], M[p'][k + 1]) for quads j and j + 8, p = 8 y + x
  // of quad q = 4 y + x
  __shared__ __align__(16) float4 mq[32 * 8];
  __shared__ __align__(16) int qs[3][64];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int b = lane >> 3;      // loads: row r of the tile's blocks b, b + 4
  const int r = lane & 7;
  const int total = a.tiles[0] + a.tiles[1] + a.tiles[2];
  const int tile_i = blockIdx.x * kRgbWarps + (t >> 5);
  int c = 0, lt = tile_i;
  while (c < 2 && lt >= a.tiles[c]) lt -= a.tiles[c++];
  const InvComp& P = a.comp[c];
  // the warp's rows first: their loads are in flight while the thread
  // block copies its tables
  RgbRow<T> row0, row1;
  if (tile_i < total) {
    rgb_load<T>(a, P, g.rcp[c], g.rcp_mx, lt * kRgbTile + b, r, &row0);
    rgb_load<T>(a, P, g.rcp[c], g.rcp_mx, lt * kRgbTile + b + 4, r, &row1);
  }
  for (int i = t; i < 32 * 8; i += kRgbThreads)
    mq[i] = __ldg(reinterpret_cast<const float4*>(a.basis) + i);
  for (int i = t; i < 64 * a.ncomp; i += kRgbThreads)
    qs[i >> 6][i & 63] = __ldg(a.q + i);
  __syncthreads();
  if (tile_i >= total) return;
  float* tile = tiles[t >> 5];
  int* samples = reinterpret_cast<int*>(tile);
  // rows r of blocks b and b + 4 into the tile: block 2 p + s at pair p
  const int4 q0 = *reinterpret_cast<const int4*>(&qs[c][8 * r]);
  const int4 q1 = *reinterpret_cast<const int4*>(&qs[c][8 * r + 4]);
  const int qv[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
  float* dst = tile + (b >> 1) * kPairStride + kRowStride * r + (b & 1);
  const unsigned row_mask =
      dequant_row(row0.row, qv, dst, b >> 1) |
      dequant_row(row1.row, qv, dst + 2 * kPairStride, b >> 1);
  unsigned lo, hi;
  union_mask(row_mask, r, &lo, &hi);
  __syncwarp();
  // sums: lane 8 p + j takes quads j (y = j / 4, x = j % 4) and j + 8
  // (y + 2) of blocks 2 p and 2 p + 1
  const int pair = lane >> 3;
  const int j = lane & 7;
  float acc[2][2][4];
  const float4* e =
      reinterpret_cast<const float4*>(tile + pair * kPairStride);
  if (__popc(lo) + __popc(hi) >= kRgbDenseTerms)
    rgb_terms<false>(e, mq + j, lo, hi, acc);
  else
    rgb_terms<true>(e, mq + j, lo, hi, acc);
  __syncwarp();  // the tile takes the samples now
  const float level = __int2float_rn(a.level);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int y = (j >> 2) + 2 * h, x = j & 3;
        samples[sample_at(2 * pair + s, (i & 2) ? 7 - y : y,
                          (i & 1) ? 7 - x : x)] =
            __float2int_rz(__fadd_rn(acc[s][h][i], level));
      }
    }
  }
  __syncwarp();
  // row 8 ob + orow of the tile's samples, columns 4 hf to 4 hf + 3: a
  // store fills 16 rows' 32-byte sectors
#pragma unroll
  for (int k4 = 0; k4 < 4; ++k4) {
    const int ob = 2 * k4 + (lane >> 4);
    const int orow = (lane >> 1) & 7;
    const int hf = lane & 1;
    const long long off = __shfl_sync(
        kFullMask, k4 < 2 ? row0.off : row1.off, 8 * (ob & 3));
    const int4 w = *reinterpret_cast<const int4*>(
        samples + sample_at(ob, orow, 4 * hf));
    if (off >= 0)
      *reinterpret_cast<int4*>(
          P.out + off + static_cast<long long>(orow) * P.width + 4 * hf) =
          w;
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
int kernel_info(K kernel, int* info, int threads = kThreads) {
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

template <typename K, typename A>
int launch(K kernel, long long tiles, const A& a, cudaStream_t s) {
  int grid = 0;
  const cudaError_t e = grid_for(kernel, (tiles + kWarps - 1) / kWarps, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// tabs (see jz_fdct_quantize_exact) holds 1 exactly wherever kernels 1 and
// 2 leave a product out: COS[0][x], cu[j] for j >= 1, cucv[k] for u, v >= 1.
bool ones_where_skipped(const double* tabs) {
  for (int i = 0; i < 8; ++i)
    if (tabs[i] != 1.0 || (i > 0 && tabs[64 + i] != 1.0)) return false;
  for (int k = 0; k < 64; ++k)
    if ((k & 7) && (k >> 3) && tabs[72 + k] != 1.0) return false;
  return true;
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

}  // namespace

extern "C" {

// Kernel 1 on `stream` (PyTorch's current stream); returns
// cudaGetLastError(), 0 on success.  Does not synchronise.  elem_bytes:
// 1 (int8 samples) or 4 (int32).  desc (host memory): nimages, mcus_y,
// mcus_x, gray, rounded, then per component Y, Cb, Cr its element strides
// (image, row, column).  tabs (host memory): 136 float64, COS[u][x], cu,
// cucv (constants.exact_tables; cucv unused here).
int jz_fdct_quantize_exact(int elem_bytes, const long long* desc,
                           const double* tabs, const void* y, const void* cb,
                           const void* cr, const void* yq, const void* cq,
                           void* oy, void* ocb, void* ocr, void* stream) {
  const long long nimages = desc[0], mcus_y = desc[1], mcus_x = desc[2];
  if (nimages <= 0 || mcus_y <= 0 || mcus_x <= 0) return 0;
  const long long nm = mcus_y * mcus_x;
  if (nimages * 4 * nm > 0x7FFFFFFFll ||
      (elem_bytes != 1 && elem_bytes != 4) || !ones_where_skipped(tabs))
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
             ? launch(fdct_quantize_exact_kernel<int8_t>, tiles, a, s)
             : launch(fdct_quantize_exact_kernel<int32_t>, tiles, a, s);
}

// Kernel 2 on `stream`; returns cudaGetLastError(), 0 on success.  Does not
// synchronise.  elem_bytes: 2 (int16 coefficients) or 4 (int32); coeff is
// [N, row_blocks, 64], 16-byte aligned; q [ncomp, 64] int32.  desc (host
// memory): nimages, ncomp (the components transformed, 1 to 3), mcus_x,
// row_blocks, level, then per component nblocks, v, h, first (its first
// block in a row).  tabs: as jz_fdct_quantize_exact's.  outs: the
// components' int32 planes.
int jz_idct_planes_exact(int elem_bytes, const long long* desc,
                         const double* tabs, const void* coeff, const void* q,
                         void* o0, void* o1, void* o2, void* stream) {
  if (desc[0] <= 0) return 0;
  if (!ones_where_skipped(tabs))
    return static_cast<int>(cudaErrorInvalidValue);
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
             ? launch(idct_planes_exact_kernel<int16_t>, tiles, a, s)
             : launch(idct_planes_exact_kernel<int32_t>, tiles, a, s);
}

// Kernel 3 (idct_planes_rgb_kernel: float32, the sum over the nonzero
// coefficients of d[k] M[p][k] in ascending k, then + level) on `stream`,
// with the layout of jz_idct_planes_exact.  basis: the 16 mirror quads'
// rows of the [64][64] float32 inverse basis, quads j and j + 8 and two k
// a float4, basis[32 (k / 2) + 4 j + 2 h + k % 2] = M[p][k] for quad
// q = j + 8 h, p = 8 (q / 4) + q % 4 (exact_cuda.quad_basis), 1,024 floats
// in device memory, 16-byte aligned, from a basis mirror-symmetric bit for
// bit (the header; exact_cuda.quad_basis makes no table of another).
int jz_idct_planes_rgb(int elem_bytes, const long long* desc,
                       const void* basis, const void* coeff, const void* q,
                       void* o0, void* o1, void* o2, void* stream) {
  if (desc[0] <= 0) return 0;
  RgbArgs g;
  long long tiles = 0;
  const int rc = inverse_layout(elem_bytes, desc, coeff, q, o0, o1, o2,
                                &g.in, &tiles);
  if (rc) return rc;
  g.in.basis = static_cast<const float*>(basis);
  for (int c = 0; c < 3; ++c) {
    const InvComp& P = g.in.comp[c];
    g.rcp[c] = {rcp_up(P.nblocks), rcp_up(P.v * P.h), rcp_up(P.h)};
  }
  g.rcp_mx = rcp_up(g.in.mcus_x);
  // the tiles again, of kRgbTile blocks, not kernel 2's kTile
  tiles = 0;
  for (int c = 0; c < g.in.ncomp; ++c) {
    g.in.tiles[c] = static_cast<int>(
        (static_cast<long long>(g.in.nimages) * g.in.comp[c].nblocks +
         kRgbTile - 1) /
        kRgbTile);
    tiles += g.in.tiles[c];
  }
  const long long blocks = (tiles + kRgbWarps - 1) / kRgbWarps;
  if (blocks > 0x7FFFFFFFll) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2)
    idct_planes_rgb_kernel<int16_t>
        <<<static_cast<unsigned>(blocks), kRgbThreads, 0, s>>>(g);
  else
    idct_planes_rgb_kernel<int32_t>
        <<<static_cast<unsigned>(blocks), kRgbThreads, 0, s>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// What the card reports for kernel `which` (0: fdct_quantize_exact int8,
// 1: int32, 2: idct_planes_exact int16, 3: int32, 4: idct_planes_rgb int16,
// 5: int32): info[0] registers a
// thread, [1] resident thread blocks an SM, [2] static shared bytes, [3]
// local bytes a thread, [4] threads a block.  Returns 0 or a CUDA error
// code.
int jz_exact_kernel_info(int which, int* info) {
  switch (which) {
    case 0:
      return kernel_info(fdct_quantize_exact_kernel<int8_t>, info);
    case 1:
      return kernel_info(fdct_quantize_exact_kernel<int32_t>, info);
    case 2:
      return kernel_info(idct_planes_exact_kernel<int16_t>, info);
    case 3:
      return kernel_info(idct_planes_exact_kernel<int32_t>, info);
    case 4:
      return kernel_info(idct_planes_rgb_kernel<int16_t>, info,
                         kRgbThreads);
    case 5:
      return kernel_info(idct_planes_rgb_kernel<int32_t>, info,
                         kRgbThreads);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* jz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

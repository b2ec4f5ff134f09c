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
//        decimated chroma); the [64, 64] float32 forward basis; one [64]
//        int32 quant table for luma and one for chroma.
//   Out: quantized blocks [N, B_c, 64] int32 per component, natural order,
//        luma blocks TL, TR, BL, BR within each MCU; B_Y = 4 B_Cb.
//   Coefficient u of a block is sum_k x[k] * M[u][k] over k = 0..63 in
//   ascending order, each term a float32 multiply and then a float32 add
//   (never contracted into a fused multiply-add), truncated toward zero;
//   then C's truncating division |c| / q (or (2|c| + q) / (2q) when
//   rounded) with the sign put back.  Gray writes zero chroma blocks.
//
// Kernel 2, idct_planes_kernel, replaces jpezy_tpu/codec/jax_codec.py:
// _decode_fused_batch_ycc420 (with _densify, ops/quantize.py:dequantize,
// ops/dct.py:inverse_dct and the deblockify transpose) and the same tail
// of _decode_fused_batch_device after decode_segments.  Its forms read the
// coefficients from two layouts and share one arithmetic function,
// block_to_planes:
//   sparse:   the ycc420 transport's single flat uint8 upload, read in
//             place: per image and component mask_lo [B] u32 | mask_hi [B]
//             u32 | vals [B, K] int8; a block's coefficient at natural
//             index j is vals[rank(j)], rank counting the set mask bits
//             below j, and 0 unless bit j is set and the rank is below K.
//             The fields start at any byte, so a word that is not aligned
//             is read bytewise.
//   overflow: a second launch of the sparse form when the upload carries
//             overflow rows (per component oidx [cap] i32 | orows [cap, 64]
//             i16 after the image rows): each row's block is transformed
//             again from its row and overwrites the pixels the first
//             launch wrote.  An index outside [0, N * B_c) (the host's
//             padding sentinel is N * B_c) writes nothing.
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
//    int32 blocks out, 9.4 us at 3.35 TB/s.  Its 64-term sums are 805 M
//    float32 operations, and kept apart (no fused multiply-add) every one
//    is an instruction: 24 us at the card's float32 issue rate.  So the
//    kernel is bound by operations.  The design keeps each thread's basis
//    row in 64 registers (one thread a coefficient, 64 threads a block),
//    broadcasts a tile's samples from shared memory as float4 reads, and
//    runs four blocks' sums side by side in each thread so that the adds'
//    latency is hidden.  Thread blocks stay resident and walk over the
//    tiles, so the basis is read once per thread block, and each thread
//    loads its four samples of the next tile while the current one is
//    summed; the index arithmetic is 32-bit, and the quantizer divides
//    through a float reciprocal with two exact corrections (div_exact).
//    A separable 8 x 8 form needs a quarter of the operations but rounds
//    differently.
//  - idct_planes must move the sparse upload (about 1.8 MB) or the dense
//    blocks (12.6 MB) in and 6.3 MB of planes out: 2.4 or 5.6 us.  Its
//    operations depend on the data, 64 multiply-adds per nonzero
//    coefficient, two a block on the photographs of the main path, so it
//    is bound by bytes and, in practice, by the latency of each block's
//    dependent loads (mask, then values) and by the instructions that
//    place a block.  The design gives each warp a run of 8 blocks with no
//    barrier, so many runs are in flight on an SM: lanes 0-7 first work
//    out their block's place in the plane and its source (the integer
//    divisions once a run, and the sparse form's two mask words, read
//    together), then the warp takes the blocks four at a time, their
//    addresses broadcast by shuffles and the four blocks' loads in flight
//    together.  On a block a lane holds two coefficients and
//    sums two samples, loops only over the nonzero coefficients (the
//    warp's ballot, so the loop is uniform), takes each coefficient from
//    its lane by a shuffle and the basis, transposed, from shared memory,
//    where the lanes read neighbouring words.
//
// No atomics: every output is written by one thread, so the same input
// gives the same bits on every run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xFFFFFFFFu;

// Kernel 1: 4 groups of 64 threads (one a coefficient), 4 blocks a group.
constexpr int kFdctThreads = 256;
constexpr int kFdctGroups = kFdctThreads / 64;
constexpr int kChains = 4;
constexpr int kFdctTile = kFdctGroups * kChains;  // blocks a step

// Kernel 2: 8 warps, each on a run of 8 blocks, 4 blocks' loads at once.
constexpr int kIdctThreads = 256;
constexpr int kIdctRun = 8;
constexpr int kIdctInFlight = 4;

enum Form { kSparse = 0, kOverflow = 1, kDense = 2 };

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

// Tiles of `per` items each that n x items need (the launchers keep every
// count below 2^31).
__device__ __forceinline__ int tiles_of(int n, int items, int per) {
  return (n * items + per - 1) / per;
}

// Kernel 1's tile index -> component (Y: ty tiles, Cb and Cr: tc each);
// *lt becomes the tile's index within its component.
__device__ __forceinline__ int component_of(int* lt, int ty, int tc) {
  if (*lt < ty) return 0;
  *lt -= ty;
  if (*lt < tc) return 1;
  *lt -= tc;
  return 2;
}

// ---------------------------------------------------------------------------
// Kernel 1: blockify, forward DCT, quantize
// ---------------------------------------------------------------------------

struct FdctComp {
  const void* base;       // the plane's first sample
  long long sn, sr, sc;   // element strides: image, row, column
  const int32_t* q;       // [64] quant table
  int32_t* out;           // [N, nblocks, 64]
  int nblocks;
};

struct FdctArgs {
  FdctComp comp[3];
  const float* basis;     // [64, 64], M[u][k]
  int nimages, mcus_x, gray, rounded;
};

// Kernel 1's tile `tile` -> its component c and first block; thread t's
// four samples (four neighbouring columns of one block's row) converted
// to float in x[].  Zeros past the component's last block.
template <typename T>
__device__ __forceinline__ void fdct_load(const FdctArgs& a,
                                          const FdctComp* comps, int ty,
                                          int tc, int tile, int t, int* c,
                                          int* first, float x[4]) {
  int lt = tile;
  *c = component_of(&lt, ty, tc);
  const FdctComp& P = comps[*c];
  *first = lt * kFdctTile;
  const int f = *first + (t >> 4);
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = 0.f;
  if (f >= a.nimages * P.nblocks || (a.gray && *c > 0)) return;
  const int n = f / P.nblocks;
  const int bi = f - n * P.nblocks;
  // 4:2:0: luma blocks TL, TR, BL, BR of MCU bi / 4, chroma MCU bi
  const int m = *c == 0 ? bi >> 2 : bi;
  const int my = m / a.mcus_x;
  const int mx = m - my * a.mcus_x;
  const int k0 = 4 * (t & 15);
  const int y = *c == 0 ? (2 * my + ((bi >> 1) & 1)) * 8 : my * 8;
  const int x0 = *c == 0 ? (2 * mx + (bi & 1)) * 8 : mx * 8;
  const T* src = static_cast<const T*>(P.base) + n * P.sn +
                 (y + (k0 >> 3)) * P.sr + (x0 + (k0 & 7)) * P.sc;
#pragma unroll
  for (int j = 0; j < 4; ++j, src += P.sc)
    x[j] = __int2float_rn(static_cast<int>(*src));
}

// C's truncating division num / den for num >= 0 and den >= 1, from
// rcp = 1.0f / den: below 2^22 the float quotient is within 1 of the true
// one and the two corrections make it exact; above, the integer division.
__device__ __forceinline__ int div_exact(int num, int den, float rcp) {
  if (num >= (1 << 22)) return num / den;
  int q = __float2int_rz(__fmul_rn(__int2float_rn(num), rcp));
  q += (q + 1) * den <= num;
  q -= q * den > num;
  return q;
}

template <typename T>
__global__ void __launch_bounds__(kFdctThreads)
    fdct_quantize_kernel(FdctArgs a) {
  __shared__ __align__(16) float xs[kFdctTile * 64];
  __shared__ FdctComp comps[3];
  const int t = threadIdx.x;
  const int g = t >> 6;
  const int u = t & 63;
  if (t == 0) {
    comps[0] = a.comp[0];
    comps[1] = a.comp[1];
    comps[2] = a.comp[2];
  }
  float m[64];
  const float4* row = reinterpret_cast<const float4*>(a.basis + u * 64);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float4 v = __ldg(row + i);
    m[4 * i] = v.x;
    m[4 * i + 1] = v.y;
    m[4 * i + 2] = v.z;
    m[4 * i + 3] = v.w;
  }
  __syncthreads();
  const int ty = tiles_of(a.nimages, comps[0].nblocks, kFdctTile);
  const int tc = tiles_of(a.nimages, comps[1].nblocks, kFdctTile);
  const int total = ty + 2 * tc;
  // the samples of the next tile are loaded while this one is summed
  int c_next = 0, first_next = 0;
  float x_next[4];
  if (static_cast<int>(blockIdx.x) < total)
    fdct_load<T>(a, comps, ty, tc, blockIdx.x, t, &c_next, &first_next,
                 x_next);
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const int c = c_next;
    const int first = first_next;
    __syncthreads();  // the previous step's reads of xs are done
    *reinterpret_cast<float4*>(&xs[4 * t]) =
        make_float4(x_next[0], x_next[1], x_next[2], x_next[3]);
    __syncthreads();
    if (tile + static_cast<int>(gridDim.x) < total)
      fdct_load<T>(a, comps, ty, tc, tile + gridDim.x, t, &c_next,
                   &first_next, x_next);
    const FdctComp& P = comps[c];
    const int nb = a.nimages * P.nblocks;
    if (a.gray && c > 0) {
#pragma unroll
      for (int j = 0; j < kChains; ++j) {
        const int f = first + g * kChains + j;
        if (f < nb) P.out[static_cast<long long>(f) * 64 + u] = 0;
      }
      continue;
    }
    float s[kChains];
#pragma unroll
    for (int j = 0; j < kChains; ++j) s[j] = 0.f;
#pragma unroll
    for (int k4 = 0; k4 < 16; ++k4) {
#pragma unroll
      for (int j = 0; j < kChains; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(
            &xs[(g * kChains + j) * 64 + 4 * k4]);
        s[j] = __fadd_rn(s[j], __fmul_rn(x.x, m[4 * k4]));
        s[j] = __fadd_rn(s[j], __fmul_rn(x.y, m[4 * k4 + 1]));
        s[j] = __fadd_rn(s[j], __fmul_rn(x.z, m[4 * k4 + 2]));
        s[j] = __fadd_rn(s[j], __fmul_rn(x.w, m[4 * k4 + 3]));
      }
    }
    // quantize: |c| / q, or (2|c| + q) / (2q) rounded
    const int q = __ldg(P.q + u);
    const int den = a.rounded ? 2 * q : q;
    const float rcp = __frcp_rn(__int2float_rn(den));
#pragma unroll
    for (int j = 0; j < kChains; ++j) {
      const int f = first + g * kChains + j;
      if (f < nb) {
        const int cf = __float2int_rz(s[j]);
        const int mag = cf < 0 ? -cf : cf;
        const int qv = div_exact(a.rounded ? 2 * mag + q : mag, den, rcp);
        P.out[static_cast<long long>(f) * 64 + u] = cf < 0 ? -qv : qv;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel 2: dequantize, inverse DCT, level shift, clamp, into the planes
// ---------------------------------------------------------------------------

struct IdctComp {
  int nblocks;           // B_c: the component's blocks in one image
  int v, h;              // sampling factors: v x h blocks an MCU
  int width;             // plane width in samples
  int cap;               // sparse: overflow rows
  int slot0;             // dense: the component's first slot in an MCU
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

// The one arithmetic of every form, run by a warp on one block: lane l
// holds the dequantized coefficients k = l (lo) and k = l + 32 (hi) and
// sums samples p = l and p = l + 32 over the nonzero coefficients in
// ascending k, each term a float32 multiply then a float32 add, the
// coefficient broadcast from its lane; then + level, truncation, clamp,
// and the two samples' stores at `plane` (the block's top-left sample)
// in rows of `width`.
__device__ __forceinline__ void block_to_planes(const float* mt, int level,
                                                int32_t lo, int32_t hi,
                                                uint8_t* plane, int width,
                                                int lane) {
  const float flo = __int2float_rn(lo);
  const float fhi = __int2float_rn(hi);
  float s0 = 0.f, s1 = 0.f;
  uint32_t mask = __ballot_sync(kFullMask, lo != 0);
  while (mask) {
    const int k = __ffs(mask) - 1;
    mask &= mask - 1;
    const float ck = __shfl_sync(kFullMask, flo, k);
    s0 = __fadd_rn(s0, __fmul_rn(ck, mt[k * 64 + lane]));
    s1 = __fadd_rn(s1, __fmul_rn(ck, mt[k * 64 + lane + 32]));
  }
  mask = __ballot_sync(kFullMask, hi != 0);
  while (mask) {
    const int k = __ffs(mask) - 1;
    mask &= mask - 1;
    const float ck = __shfl_sync(kFullMask, fhi, k);
    s0 = __fadd_rn(s0, __fmul_rn(ck, mt[(k + 32) * 64 + lane]));
    s1 = __fadd_rn(s1, __fmul_rn(ck, mt[(k + 32) * 64 + lane + 32]));
  }
  const float lv = __int2float_rn(level);
  const int v0 = __float2int_rz(__fadd_rn(s0, lv));
  const int v1 = __float2int_rz(__fadd_rn(s1, lv));
  uint8_t* px = plane + (lane >> 3) * width + (lane & 7);  // rows r, r + 4
  px[0] = static_cast<uint8_t>(v0 < 0 ? 0 : (v0 > 255 ? 255 : v0));
  px[4 * width] = static_cast<uint8_t>(v1 < 0 ? 0 : (v1 > 255 ? 255 : v1));
}

template <int kForm>
__global__ void __launch_bounds__(kIdctThreads)
    idct_planes_kernel(IdctArgs a) {
  __shared__ float mt[64 * 64];        // mt[k * 64 + p] = M[p][k]
  __shared__ IdctComp comps[3];
  const int t = threadIdx.x;
  const int lane = t & 31;
  if (t == 0) {
    comps[0] = a.comp[0];
    comps[1] = a.comp[1];
    comps[2] = a.comp[2];
  }
#pragma unroll
  for (int i = t; i < 64 * 64; i += kIdctThreads)
    mt[i] = __ldg(a.basis_t + i);
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
  // the items: blocks (sparse, dense) or overflow rows, component after
  // component, in runs of kIdctRun that stay within a component; none
  // past ncomp, whose nblocks and cap are 0
  const int i0 = kForm == kOverflow ? comps[0].cap
                                    : a.nimages * comps[0].nblocks;
  const int i1 = kForm == kOverflow ? comps[1].cap
                                    : a.nimages * comps[1].nblocks;
  const int i2 = kForm == kOverflow ? comps[2].cap
                                    : a.nimages * comps[2].nblocks;
  const int r0 = (i0 + kIdctRun - 1) / kIdctRun;
  const int r1 = (i1 + kIdctRun - 1) / kIdctRun;
  const int r2 = (i2 + kIdctRun - 1) / kIdctRun;
  const int warps = gridDim.x * (kIdctThreads / 32);
  // a warp a run: no barrier past this point
  for (int run = blockIdx.x * (kIdctThreads / 32) + (t >> 5);
       run < r0 + r1 + r2; run += warps) {
    const int c = run < r0 ? 0 : (run < r0 + r1 ? 1 : 2);
    const IdctComp& C = comps[c];
    const int first =
        (run - (c == 0 ? 0 : (c == 1 ? r0 : r0 + r1))) * kIdctRun;
    const int items = c == 0 ? i0 : (c == 1 ? i1 : i2);
    // lane l < kIdctRun works out where item first + l lies: its block f,
    // the block's top-left sample in the plane, its coefficients' source
    const int item = first + lane;
    int f = lane < kIdctRun && item < items ? item : -1;
    if (kForm == kOverflow && f >= 0) {
      f = static_cast<int32_t>(load_u32(a.flat + C.oidx_off + 4ll * item));
      if (f >= a.nimages * C.nblocks) f = -1;
    }
    int n = 0, bi = 0, y0 = 0, x0 = 0;
    if (f >= 0) {
      n = f / C.nblocks;
      bi = f - n * C.nblocks;
      block_origin(bi, C.v, C.h, a.mcus_x, &y0, &x0);
    }
    const long long dst = n * a.out_stride + C.plane_off +
                          static_cast<long long>(y0) * C.width + x0;
    long long src = 0;                // the block's first coefficient
    uint32_t mlo = 0, mhi = 0;        // sparse: its masks
    if (kForm == kSparse && f >= 0) {
      const long long row = n * a.row_bytes;
      mlo = load_u32(a.flat + row + C.mlo_off + 4ll * bi);
      mhi = load_u32(a.flat + row + C.mhi_off + 4ll * bi);
      src = row + C.val_off + static_cast<long long>(bi) * a.K;
    } else if (kForm == kDense && f >= 0) {
      const int per = C.v * C.h;
      const int m = bi / per;
      src = (n * a.image_blocks + static_cast<long long>(m) * a.mcu_blocks +
             C.slot0 + (bi - m * per)) << 6;
    } else if (kForm == kOverflow && f >= 0) {
      src = C.orows_off + 128ll * item;
    }
    const int32_t* q = a.q + n * a.q_stride + c * 64;
    const uint32_t live = __ballot_sync(kFullMask, f >= 0);
    // the run's blocks four at a time: the four blocks' loads are in
    // flight together, then the four are summed and stored in order
    for (int j0 = 0; j0 < kIdctRun; j0 += kIdctInFlight) {
      int32_t lo[kIdctInFlight], hi[kIdctInFlight];
#pragma unroll
      for (int u = 0; u < kIdctInFlight; ++u) {
        const int j = j0 + u;
        lo[u] = hi[u] = 0;
        if (!((live >> j) & 1)) continue;         // the whole warp
        const long long src_j = __shfl_sync(kFullMask, src, j);
        const int32_t* q_j = reinterpret_cast<const int32_t*>(
            __shfl_sync(kFullMask, reinterpret_cast<uintptr_t>(q), j));
        if (kForm == kSparse) {
          // vals[rank] where bit k of the mask is set and its rank, the
          // set bits below k, is below K; else 0
          const uint32_t ml = __shfl_sync(kFullMask, mlo, j);
          const uint32_t mh = __shfl_sync(kFullMask, mhi, j);
          const uint8_t* vals = a.flat + src_j;
          const uint32_t below = (1u << lane) - 1;  // lane 31: 0x7FFFFFFF
          const int rlo = __popc(ml & below);
          const int rhi = __popc(ml) + __popc(mh & below);
          lo[u] = ((ml >> lane) & 1) && rlo < a.K
                      ? static_cast<int8_t>(__ldg(vals + rlo)) : 0;
          hi[u] = ((mh >> lane) & 1) && rhi < a.K
                      ? static_cast<int8_t>(__ldg(vals + rhi)) : 0;
        } else if (kForm == kDense) {
          lo[u] = __ldg(a.blocks + src_j + lane);
          hi[u] = __ldg(a.blocks + src_j + lane + 32);
        } else {
          lo[u] = load_i16(a.flat + src_j + 2 * lane);
          hi[u] = load_i16(a.flat + src_j + 2 * (lane + 32));
        }
        lo[u] *= __ldg(q_j + lane);
        hi[u] *= __ldg(q_j + lane + 32);
      }
#pragma unroll
      for (int u = 0; u < kIdctInFlight; ++u) {
        const long long dst_j = __shfl_sync(kFullMask, dst, j0 + u);
        if ((live >> (j0 + u)) & 1)
          block_to_planes(mt, a.level, lo[u], hi[u], a.out + dst_j,
                          C.width, lane);
      }
    }
  }
}

template <typename K>
cudaError_t grid_for(K kernel, int threads, long long tiles, int* grid) {
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
  *grid = static_cast<int>(tiles < resident ? tiles : resident);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Kernel 1 on `stream` (PyTorch's current stream); returns
// cudaGetLastError(), 0 on success.  Does not synchronise.  elem_bytes:
// 1 (int8 samples) or 4 (int32).  desc (host memory): nimages, mcus_y,
// mcus_x, gray, rounded, then per component Y, Cb, Cr its element strides
// (image, row, column).
int jz_fdct_quantize(int elem_bytes, const long long* desc, const void* y,
                     const void* cb, const void* cr, const void* yq,
                     const void* cq, const void* basis, void* oy, void* ocb,
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
  a.basis = static_cast<const float*>(basis);
  a.nimages = static_cast<int>(nimages);
  a.mcus_x = static_cast<int>(mcus_x);
  a.gray = desc[3] != 0;
  a.rounded = desc[4] != 0;
  const long long tiles = (nimages * 4 * nm + kFdctTile - 1) / kFdctTile +
                          2 * ((nimages * nm + kFdctTile - 1) / kFdctTile);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int grid = 0;
  cudaError_t e;
  if (elem_bytes == 1) {
    e = grid_for(fdct_quantize_kernel<int8_t>, kFdctThreads, tiles, &grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    fdct_quantize_kernel<int8_t><<<grid, kFdctThreads, 0, s>>>(a);
  } else {
    e = grid_for(fdct_quantize_kernel<int32_t>, kFdctThreads, tiles, &grid);
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
// orows_off.
int jz_idct_planes(int dense, const long long* desc, const void* src,
                   const void* bad, const void* q, const void* basis_t,
                   void* out, void* stream) {
  IdctArgs a;
  a.nimages = static_cast<int>(desc[0]);
  a.ncomp = static_cast<int>(desc[1]);
  if (a.nimages <= 0) return 0;
  if (a.ncomp < 1 || a.ncomp > 3 || desc[0] > 0x7FFFFFFFll ||
      (dense && bad == nullptr))
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
  long long caps = 0, blocks = 0;
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
    if (c < a.ncomp) {
      if (p.nblocks <= 0 || p.v <= 0 || p.h <= 0 ||
          desc[0] * d[0] > 0x7FFFFFFFll)
        return static_cast<int>(cudaErrorInvalidValue);
      caps += p.cap;
      blocks += desc[0] * d[0];
    } else {
      p.cap = p.nblocks = 0;
    }
  }
  a.flat = static_cast<const uint8_t*>(src);
  a.blocks = static_cast<const int16_t*>(src);
  a.bad = static_cast<const uint8_t*>(bad);
  a.q = static_cast<const int32_t*>(q);
  a.basis_t = static_cast<const float*>(basis_t);
  a.out = static_cast<uint8_t*>(out);
  constexpr int kWarps = kIdctThreads / 32;
  const long long tiles = (blocks + kWarps - 1) / kWarps + 3;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int grid = 0;
  cudaError_t e;
  if (dense) {
    e = grid_for(idct_planes_kernel<kDense>, kIdctThreads, tiles, &grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    idct_planes_kernel<kDense><<<grid, kIdctThreads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  e = grid_for(idct_planes_kernel<kSparse>, kIdctThreads, tiles, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  idct_planes_kernel<kSparse><<<grid, kIdctThreads, 0, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || caps == 0) return static_cast<int>(e);
  e = grid_for(idct_planes_kernel<kOverflow>, kIdctThreads,
               (caps + kWarps - 1) / kWarps + 3, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  idct_planes_kernel<kOverflow><<<grid, kIdctThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* jz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

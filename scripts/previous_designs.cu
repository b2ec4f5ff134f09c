// The designs of kernels of jpezy_tpu_torch that later revisions
// replaced, kept so that chip_smoke.py can time them beside the current
// ones in one run, on the same inputs (scripts/previous_designs.py binds
// them; nothing in the package calls them):
//
//   jz_prev_encode_blocks  the per-component fused entropy kernel: one
//     launch a component, each block's DC predictor read from an array
//     the caller builds in plain torch (the current jz_encode_blocks_batch
//     takes the three components in one launch and finds the predictors
//     itself).  Its per-block work is the current kernel's encode_block,
//     so the two differ only in what they launch and read.
//   jz_prev_concat_streams  the two-pass stream concat: pass 1 one thread
//     block an image scans the MCUs' bit counts into an offsets scratch
//     goff [N, 6 nm] while 64 more thread blocks zero the streams; pass 2
//     places each warp's blocks' used words, with atomicOr on the words
//     blocks share (the current jz_concat_streams is one launch of many
//     thread blocks an image, no scratch, every word one plain store).
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
//   jz_prev_fdct_quantize_exact, jz_prev_idct_planes_exact  exact mode's
//     first float64 kernels: the forward issues all 64 terms of every
//     block, products by COS[0][y] = 1 and cu[i] = 1 and the first adds
//     onto +0 included; the inverse walks each block's own nonzero mask,
//     k different in each of a warp's 4 blocks, with the tables COS and
//     cucv in shared memory (7 shared loads a term).  The current
//     exact_transforms.cu skips the exact products by 1 and the zero
//     samples of a warp's 4 blocks, and walks their union with the tables
//     as constant-bank operands.
//
// All are verbatim but for names: the current entropy source is
// included for encode_block and the table layout, the concat's two
// kernels sit in namespace two_pass, the exact kernels and the first
// fast rgb IDCT in namespace first_exact, and the first overflow launch
// with the helpers and argument structs of its source in namespace
// first_overflow.
#include "../jpezy_tpu_torch/csrc/entropy_pack.cu"

namespace {

// The table set of block b out of `nsets` (b / blocks_per_image; the
// launcher keeps b below 2**31 when nsets > 1).
__device__ __forceinline__ const int32_t* table_set(const int32_t* tables,
                                                    int64_t b, int nsets,
                                                    int64_t blocks_per_image) {
  if (nsets <= 1) return tables;
  const int s = min(static_cast<int>(static_cast<uint32_t>(b) /
                                     static_cast<uint32_t>(blocks_per_image)),
                    nsets - 1);
  return tables + s * kSetEntries;
}

template <bool kCustom>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
    encode_blocks_kernel(const int32_t* __restrict__ q,
                         const int32_t* __restrict__ pred,
                         const int32_t* __restrict__ tables, int nsets,
                         int64_t blocks_per_image,
                         uint64_t* __restrict__ words, int32_t* __restrict__ bits,
                         int64_t nblocks) {
  __shared__ uint32_t bufs[kWarpsPerCta][kWords];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t b0 =
      (static_cast<int64_t>(blockIdx.x) * kWarpsPerCta + warp) * kBlocksPerWarp;
  if (b0 >= nblocks) return;
  const int z0 = kZigzag[lane];
  const int z1 = kZigzag[lane + 32];
  int c0[kBlocksPerWarp], c1[kBlocksPerWarp], dcp[kBlocksPerWarp];
#pragma unroll
  for (int i = 0; i < kBlocksPerWarp; ++i) {
    const int64_t b = b0 + i < nblocks ? b0 + i : b0;  // tail: load a valid row
    c0[i] = __ldg(q + b * kSlots + z0);
    c1[i] = __ldg(q + b * kSlots + z1);
    dcp[i] = lane == 0 ? __ldg(pred + b) : 0;
  }
#pragma unroll
  for (int i = 0; i < kBlocksPerWarp; ++i) {
    const int64_t b = b0 + i;
    if (b >= nblocks) break;
    const int32_t* t = tables;
    if constexpr (kCustom) t = table_set(tables, b, nsets, blocks_per_image);
    encode_block<kCustom>(c0[i], c1[i], dcp[i], t, bufs[warp], lane,
                          words + b * kSlots, bits + b);
  }
}

}  // namespace

namespace two_pass {

constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kWords = 64;          // words a block holds
constexpr int kThreads = 1024;      // pass 1: MCUs per round
constexpr int kZeroCtas = 64;       // pass 1: thread blocks zeroing streams
constexpr int kScatterThreads = 256;  // pass 2: blocks a thread block takes
constexpr int kRounds = 2;  // pass 2: output words a lane places per step

struct Comps {
  const uint64_t* words[3];
  const int32_t* bits[3];
};

// Bit counts of MCU m of image n, in stream order Y0..Y3, Cb, Cr.
__device__ __forceinline__ void mcu_bits(const Comps& c, int64_t n,
                                         int64_t nm, int64_t m, int32_t b[6]) {
  const int32_t* y = c.bits[0] + (n * nm + m) * 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) b[j] = __ldg(y + j);
  b[4] = __ldg(c.bits[1] + n * nm + m);
  b[5] = __ldg(c.bits[2] + n * nm + m);
}

// The zero bits that round a segment of seg_bits up to a byte.
__device__ __forceinline__ int64_t pad_of(int64_t seg_bits) {
  return (8 - (seg_bits & 7)) & 7;
}

// Exclusive block-wide scan of x over kThreads threads; *sum receives the
// total.  `warp_sums` holds 32 values in shared memory.
__device__ __forceinline__ int64_t block_scan(int64_t x, int64_t* warp_sums,
                                              int64_t* sum) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int64_t v = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t o = __shfl_up_sync(kFullMask, v, d);
    if (lane >= d) v += o;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int64_t w = warp_sums[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t o = __shfl_up_sync(kFullMask, w, d);
      if (lane >= d) w += o;
    }
    warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const int64_t before = warp > 0 ? warp_sums[warp - 1] : 0;
  *sum = warp_sums[31];
  __syncthreads();  // warp_sums is reused by the next call
  return before + v - x;
}

__global__ void __launch_bounds__(kThreads)
    concat_offsets_kernel(Comps c, int64_t nimages, int64_t nm, int64_t ri,
                          int64_t nseg, int64_t maxw,
                          int64_t* __restrict__ goff,
                          int64_t* __restrict__ combined) {
  __shared__ int64_t warp_sums[32];
  const int64_t row = 1 + nseg + maxw;
  if (blockIdx.x >= nimages) {  // one of the kZeroCtas: zero the streams
    const int64_t stride = static_cast<int64_t>(kZeroCtas) * kThreads;
    for (int64_t i = (blockIdx.x - nimages) * kThreads + threadIdx.x;
         i < nimages * maxw; i += stride) {
      const int64_t n = i / maxw;
      combined[n * row + 1 + nseg + (i - n * maxw)] = 0;
    }
    return;
  }
  const int64_t n = blockIdx.x;
  int64_t* out = combined + n * row;
  unsigned long long* seg = reinterpret_cast<unsigned long long*>(out + 1);
  for (int64_t i = threadIdx.x; i < nseg; i += kThreads) out[1 + i] = 0;
  __syncthreads();
  // the segments' bit counts: MCUs of one segment sit in neighbouring
  // threads; a warp whose MCUs all lie in one segment adds once
  if (ri > 0) {
    for (int64_t m0 = 0; m0 < nm; m0 += kThreads) {
      const int64_t m = m0 + threadIdx.x;
      int32_t b[6] = {0, 0, 0, 0, 0, 0};
      if (m < nm) mcu_bits(c, n, nm, m, b);
      const int64_t s = m < nm ? m / ri : -1;
      const unsigned sum =
          static_cast<unsigned>(b[0] + b[1] + b[2] + b[3] + b[4] + b[5]);
      if (__match_any_sync(kFullMask, s) == kFullMask) {  // warp-uniform
        const unsigned total = __reduce_add_sync(kFullMask, sum);
        if (s >= 0 && (threadIdx.x & 31) == 0 && total != 0u)
          atomicAdd(seg + s, static_cast<unsigned long long>(total));
      } else if (s >= 0 && sum != 0u) {
        atomicAdd(seg + s, static_cast<unsigned long long>(sum));
      }
    }
    __syncthreads();
  }
  // the offsets: one MCU a thread, in rounds of kThreads MCUs
  int64_t carry = 0;
  for (int64_t m0 = 0; m0 < nm; m0 += kThreads) {
    const int64_t m = m0 + threadIdx.x;
    int32_t b[6] = {0, 0, 0, 0, 0, 0};
    int64_t pad = 0;
    if (m < nm) {
      mcu_bits(c, n, nm, m, b);
      if (ri > 0 && m > 0 && m % ri == 0)
        pad = pad_of(static_cast<int64_t>(__ldcg(seg + m / ri - 1)));
    }
    const int64_t mbits = b[0] + b[1] + b[2] + b[3] + b[4] + b[5];
    int64_t round_sum;
    int64_t off = carry + block_scan(mbits + pad, warp_sums, &round_sum) + pad;
    carry += round_sum;
    if (m < nm) {
      int64_t* g = goff + n * 6 * nm;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        g[4 * m + j] = off;
        off += b[j];
      }
      g[4 * nm + m] = off;
      g[5 * nm + m] = off + b[4];
    }
  }
  if (threadIdx.x == 0)
    out[0] = carry + (ri > 0 ? pad_of(static_cast<int64_t>(
                                   __ldcg(seg + nseg - 1)))
                             : 0);
}

// OR v into stream word w (< maxw); a plain store where the block owns the
// word whole.
__device__ __forceinline__ void put(uint64_t* stream, int64_t w, int64_t maxw,
                                    uint32_t v, bool owned) {
  if (v == 0u || w >= maxw) return;
  if (owned)
    stream[w] = v;
  else
    atomicOr(reinterpret_cast<unsigned long long*>(stream + w),
             static_cast<unsigned long long>(v));
}

// Output word j of a block at bit phase r: its word j shifted right by r,
// below the r low bits of its word j - 1.
__device__ __forceinline__ uint32_t shifted(uint64_t cur, uint64_t prev,
                                            int r) {
  const uint32_t a = static_cast<uint32_t>(cur) >> r;
  return r == 0 ? a : a | static_cast<uint32_t>(prev << (32 - r));
}

__global__ void __launch_bounds__(kScatterThreads)
    concat_scatter_kernel(Comps c, int64_t nm, int64_t nseg, int64_t maxw,
                          const int64_t* __restrict__ goff,
                          int64_t* __restrict__ combined, int64_t nblocks) {
  const int lane = threadIdx.x & 31;
  const int64_t g =
      static_cast<int64_t>(blockIdx.x) * kScatterThreads + threadIdx.x;
  // this lane's block: its used words, offset, words and stream
  int nw = 0;
  int64_t off = 0;
  const uint64_t* w = nullptr;
  uint64_t* stream = nullptr;
  if (g < nblocks) {
    const int64_t per_image = 6 * nm;
    const int64_t n = g / per_image;
    int64_t i = g - n * per_image;
    // the component by branches: a parameter array indexed at run time
    // would be copied to local memory
    const int32_t* bits = c.bits[0];
    const uint64_t* words = c.words[0];
    int64_t bc = 4 * nm;
    if (i >= 5 * nm) {
      bits = c.bits[2], words = c.words[2], i -= 5 * nm, bc = nm;
    } else if (i >= 4 * nm) {
      bits = c.bits[1], words = c.words[1], i -= 4 * nm, bc = nm;
    }
    const int nb = __ldg(bits + n * bc + i);
    if (nb > 0) {
      nw = min(kWords, (nb + 31) >> 5);
      off = __ldg(goff + g);
      w = words + (n * bc + i) * kWords;
      stream = reinterpret_cast<uint64_t*>(combined + n * (1 + nseg + maxw) +
                                           1 + nseg);
    }
  }
  // The warp's 32 blocks' output words as one list: a block's nw words
  // and its carry word, from `start` on (an exclusive scan over lanes).
  const int count = nw > 0 ? nw + 1 : 0;
  int start = count;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFullMask, start, d);
    if (lane >= d) start += o;
  }
  const int total = __shfl_sync(kFullMask, start, 31);
  start -= count;
  const auto bcast = [](const void* p, int k) {
    return __shfl_sync(kFullMask, reinterpret_cast<unsigned long long>(p), k);
  };
  for (int f0 = 0; f0 < total; f0 += 32 * kRounds) {
    int j[kRounds], nwk[kRounds], r[kRounds];
    int64_t q[kRounds];
    uint64_t* dst[kRounds];
    uint64_t cur[kRounds], prev[kRounds];
#pragma unroll
    for (int t = 0; t < kRounds; ++t) {
      const int f = f0 + 32 * t + lane;
      // the block of list entry f: the last lane whose words start at or
      // before it (starts do not decrease; an empty block shares its start
      // with the next block)
      int k = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1)
        if (__shfl_sync(kFullMask, start, k + step) <= f) k += step;
      j[t] = f - __shfl_sync(kFullMask, start, k);
      nwk[t] = __shfl_sync(kFullMask, nw, k);
      const int64_t ok = __shfl_sync(kFullMask, off, k);
      const uint64_t* wk = reinterpret_cast<const uint64_t*>(bcast(w, k));
      dst[t] = reinterpret_cast<uint64_t*>(bcast(stream, k));
      r[t] = static_cast<int>(ok & 31);
      q[t] = ok >> 5;
      if (f >= total) j[t] = -1;
      cur[t] = j[t] >= 0 && j[t] < nwk[t] ? __ldg(wk + j[t]) : 0ull;
      prev[t] = j[t] > 0 ? __ldg(wk + j[t] - 1) : 0ull;
    }
    // output word j of a block takes its words j and j - 1
#pragma unroll
    for (int t = 0; t < kRounds; ++t)
      if (j[t] >= 0)
        put(dst[t], q[t] + j[t], maxw, shifted(cur[t], prev[t], r[t]),
            j[t] > 0 && j[t] < nwk[t] - 1);
  }
}

}  // namespace two_pass

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

extern "C" {

// tables [nsets, kSetEntries] int32.  custom != 0: the caller's tables,
// with nsets > 1 block b takes set b / blocks_per_image; custom == 0: the
// one fixed Annex K set (nsets must be 1).
int jz_prev_encode_blocks(const void* q, const void* pred, const void* tables,
                          int nsets, int custom, long long blocks_per_image,
                          void* words, void* bits, long long nblocks,
                          void* stream) {
  if (nblocks <= 0) return 0;
  if (nsets < 1 || (!custom && nsets != 1) ||
      (nsets > 1 && (blocks_per_image <= 0 || nblocks > 0x7FFFFFFFll)))
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned grid;
  if (!grid_for(nblocks, kBlocksPerWarp, &grid))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kernel =
      custom ? encode_blocks_kernel<true> : encode_blocks_kernel<false>;
  kernel<<<grid, kWarpsPerCta * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(q), static_cast<const int32_t*>(pred),
      static_cast<const int32_t*>(tables), nsets, blocks_per_image,
      static_cast<uint64_t*>(words), static_cast<int32_t*>(bits), nblocks);
  return static_cast<int>(cudaGetLastError());
}

// Launches both passes on `stream` and returns cudaGetLastError().  goff
// [N, 6 nm] int64 scratch and combined [N, 1 + nseg + maxw] int64 are
// written whole.
int jz_prev_concat_streams(const void* wy, const void* wcb, const void* wcr,
                           const void* by, const void* bcb, const void* bcr,
                           void* goff, void* combined, long long nimages,
                           long long nm, long long ri, long long nseg,
                           long long maxw, void* stream) {
  using namespace two_pass;
  if (nimages <= 0) return 0;
  if (nm <= 0 || ri < 0 || maxw <= 0 || nimages > 0x7FFFFFFFll ||
      nseg != (ri > 0 ? (nm + ri - 1) / ri : 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nblocks = nimages * 6 * nm;
  const long long grid2 = (nblocks + kScatterThreads - 1) / kScatterThreads;
  if (grid2 > 0x7FFFFFFFll || nimages + kZeroCtas > 0x7FFFFFFFll)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  two_pass::Comps c;
  c.words[0] = static_cast<const uint64_t*>(wy);
  c.words[1] = static_cast<const uint64_t*>(wcb);
  c.words[2] = static_cast<const uint64_t*>(wcr);
  c.bits[0] = static_cast<const int32_t*>(by);
  c.bits[1] = static_cast<const int32_t*>(bcb);
  c.bits[2] = static_cast<const int32_t*>(bcr);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  concat_offsets_kernel<<<static_cast<unsigned>(nimages + kZeroCtas),
                          two_pass::kThreads, 0, s>>>(
      c, nimages, nm, ri, nseg, maxw, static_cast<int64_t*>(goff),
      static_cast<int64_t*>(combined));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  concat_scatter_kernel<<<static_cast<unsigned>(grid2), kScatterThreads, 0,
                          s>>>(c, nm, nseg, maxw,
                               static_cast<const int64_t*>(goff),
                               static_cast<int64_t*>(combined), nblocks);
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

// What the card reports for kernel `which` (0: the per-component fused
// kernel, fixed tables; 1: the concat's pass 1; 2: its pass 2; 3: the
// first exact forward, int8 samples; 4: the first exact inverse, int16
// coefficients; 5: the first fast rgb IDCT, int16 coefficients; 6: the
// first overflow launch of the ycc420 IDCT), as jz_entropy_kernel_info
// reports it.
int jz_prev_kernel_info(int which, int* info) {
  switch (which) {
    case 0:
      return kernel_info(encode_blocks_kernel<false>, kWarpsPerCta * 32,
                         info);
    case 1:
      return kernel_info(two_pass::concat_offsets_kernel,
                         two_pass::kThreads, info);
    case 2:
      return kernel_info(two_pass::concat_scatter_kernel,
                         two_pass::kScatterThreads, info);
    case 3:
      return first_exact::kernel_info(
          first_exact::fdct_exact_first_kernel<int8_t>, info);
    case 4:
      return first_exact::kernel_info(
          first_exact::idct_exact_first_kernel<int16_t>, info);
    case 5:
      return first_exact::kernel_info(
          first_exact::idct_rgb_first_kernel<int16_t>, info);
    case 6:
      return kernel_info(first_overflow::idct_overflow_first_kernel,
                         first_overflow::kIdctThreads, info);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"

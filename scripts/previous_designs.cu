// The designs of two kernels of jpezy_tpu_torch that later revisions
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
//
// Both are verbatim but for names: the current entropy source is
// included for encode_block and the table layout, and the concat's two
// kernels sit in namespace two_pass.
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

// What the card reports for kernel `which` (0: the per-component fused
// kernel, fixed tables; 1: the concat's pass 1; 2: its pass 2), as
// jz_entropy_kernel_info reports it.
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
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"

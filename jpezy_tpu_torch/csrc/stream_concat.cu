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
//        stored zero-extended as uint64 (the packed block bitstring,
//        MSB-first, zero past the block's bits: what jz_encode_blocks
//        writes) and bits_c [N, B_c] int32, B_Y = 4 nm, B_Cb = B_Cr = nm
//        for nm MCUs an image; restart_interval ri (0: none); maxw.
//   Out: combined [N, 1 + S + maxw] int64: the image's total bits, then
//        with restarts the S = ceil(nm / ri) segments' bit counts, then
//        the stream, maxw words; words past maxw are dropped (the caller
//        finds the overflow in the total).
//
// The stream holds the blocks in MCU order (Y0..Y3, Cb, Cr per MCU); the
// blocks stay in component order in memory and the kernel finds a block's
// place by index arithmetic.  A block's bit offset is the exclusive prefix
// sum of the bit counts in MCU order.  With restarts each segment of ri
// MCUs starts on a byte boundary: the (8 - seg_bits % 8) % 8 bits that
// round segment s up are inserted before segment s + 1, and after the last
// segment for the total.
//
// Two launches:
//  1. concat_offsets_kernel: one thread block per image, and kZeroCtas
//     more that zero every image's maxw stream words.  An image's block
//     zeros its segment counts, adds each MCU's bits into its segment's
//     count (atomics, one a warp where the warp's MCUs share one segment),
//     then scans the MCUs: one MCU (six bit counts) per thread, a
//     block-wide scan per round of kThreads MCUs with the running sum
//     carried, the padding of the previous segment added at each
//     segment's first MCU.  It writes every block's offset into the
//     scratch goff [N, 6 nm] (component order) and the total.
//  2. concat_scatter_kernel: a warp takes 32 consecutive blocks and lays
//     their output words (a block's used words, ceil(bits / 32), and the
//     carry word after them) out as one list, by a scan over its lanes;
//     then lane l places entries l, l + 32, ... of the list, kRounds at a
//     time with their loads in flight first.  Output word j of a block
//     takes the block's words j and j - 1 funnel-shifted to the offset's
//     phase.  A block covers its interior words whole, so those take
//     plain stores; its first and last words are shared with its
//     neighbours and take atomicOr (the bits are disjoint, so OR merges
//     them).  Zero words are not written: pass 1 zeroed the stream.
//
// What bounds it: memory traffic, and at these sizes the launches.  The
// function must read each block's bit count and used words once and write
// combined once: for a 16 x 512 x 512 4:2:0 batch of photographs about
// 0.4 MB of counts, 0.8 MB of used words and 1.6 MB of combined, under a
// microsecond at the card's rate.  The offsets scratch (8 bytes a block,
// written and read once) is the price of splitting the scan from the
// scatter.  Blocks differ widely in length: a photograph's use one or two
// words, noise at quality 100 about 22.  A warp per block leaves most
// lanes idle on the first; a thread per block stores 32 blocks' words to
// 32 places at once, uncoalesced, on the second (both measured, PERF.md).
// The list keeps every lane busy on either and the lanes of a block on
// neighbouring words.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

}  // namespace

extern "C" {

// Launches both passes on `stream` (PyTorch's current stream) and returns
// cudaGetLastError(): 0 on success.  Does not synchronise.  goff [N, 6 nm]
// int64 scratch and combined [N, 1 + nseg + maxw] int64 are written whole.
int jz_concat_streams(const void* wy, const void* wcb, const void* wcr,
                      const void* by, const void* bcb, const void* bcr,
                      void* goff, void* combined, long long nimages,
                      long long nm, long long ri, long long nseg,
                      long long maxw, void* stream) {
  if (nimages <= 0) return 0;
  if (nm <= 0 || ri < 0 || maxw <= 0 || nimages > 0x7FFFFFFFll ||
      nseg != (ri > 0 ? (nm + ri - 1) / ri : 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nblocks = nimages * 6 * nm;
  const long long grid2 = (nblocks + kScatterThreads - 1) / kScatterThreads;
  if (grid2 > 0x7FFFFFFFll || nimages + kZeroCtas > 0x7FFFFFFFll)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  Comps c;
  c.words[0] = static_cast<const uint64_t*>(wy);
  c.words[1] = static_cast<const uint64_t*>(wcb);
  c.words[2] = static_cast<const uint64_t*>(wcr);
  c.bits[0] = static_cast<const int32_t*>(by);
  c.bits[1] = static_cast<const int32_t*>(bcb);
  c.bits[2] = static_cast<const int32_t*>(bcr);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  concat_offsets_kernel<<<static_cast<unsigned>(nimages + kZeroCtas),
                          kThreads, 0, s>>>(
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

const char* jz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Per-block entropy bit packing for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel jpezy_tpu/ops/pack_pallas.py
// (_pack_kernel / pack_words_pallas) and, with it, every form of
// jpezy_tpu/ops/entropy.py:pack_block_words (the reduce, prefix and fori
// forms): it takes the merged emissions themselves and folds in the
// exclusive cumsum of their lengths and the 96-bit window alignment
// (entropy._window_words) that the JAX package computes around the kernel.
//
// In:  hi, lo [B, 64] uint32 halves of each emission (MSB-justified in the
//      low bits of hi:lo), nbits [B, 64] int32 emission lengths (<= 59).
// Out: words [B, 64] uint32 MSB-first packed block bitstring,
//      bits [B] int32 total bits per block.
//
// Design: one thread per 8x8 block, a running bit cursor, and a 64-word
// accumulator that the thread owns, so no two threads touch the same word
// and no atomics or barriers are needed.  Each emission is placed into a
// 96-bit window (three words) starting at word cursor>>5; emission bit
// ranges are disjoint, so OR accumulates them.  Windows past word 63 are
// dropped, as the masked forms of the JAX package drop them.
//
// What bounds it: per block it reads 768 bytes and writes 260, with about
// 64 x 3 short integer operations, so it is bound by memory traffic (and,
// in this simple form, by uncoalesced row-per-thread accesses).  Later
// work: a warp per block with a shuffle scan of the lengths, or fusing
// the emissions so they never reach device memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEmissions = 64;
constexpr int kWords = 64;

// low 32 bits of v >> d for d >= 0, of v << -d for d < 0; 0 once the
// shift moves every bit of v out of the low word.
__device__ __forceinline__ uint32_t window_word(uint64_t v, int d) {
  if (d >= 64) return 0u;
  if (d >= 0) return static_cast<uint32_t>(v >> d);
  if (d > -32) return static_cast<uint32_t>(v) << (-d);
  return 0u;
}

__global__ void pack_words_kernel(const uint32_t* __restrict__ hi,
                                  const uint32_t* __restrict__ lo,
                                  const int32_t* __restrict__ nbits,
                                  uint32_t* __restrict__ words,
                                  int32_t* __restrict__ bits,
                                  int64_t nblocks) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= nblocks) return;
  const uint32_t* h = hi + b * kEmissions;
  const uint32_t* l = lo + b * kEmissions;
  const int32_t* n = nbits + b * kEmissions;

  uint32_t acc[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) acc[w] = 0u;

  int cursor = 0;
  for (int e = 0; e < kEmissions; ++e) {
    const int nb = n[e];
    if (nb > 0) {
      const uint64_t v = (static_cast<uint64_t>(h[e]) << 32) | l[e];
      const int w0 = cursor >> 5;
      const int sh = 96 - (cursor & 31) - nb;  // MSB of v lands at bit cursor&31 of word w0
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int w = w0 + k;
        if (w < kWords) acc[w] |= window_word(v, 32 * (2 - k) - sh);
      }
    }
    cursor += nb;
  }

  uint32_t* out = words + b * kWords;
#pragma unroll
  for (int w = 0; w < kWords; ++w) out[w] = acc[w];
  bits[b] = cursor;
}

}  // namespace

extern "C" {

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError(): 0 on success.  Does not synchronise.
int jz_pack_words(const void* hi, const void* lo, const void* nbits,
                  void* words, void* bits, long long nblocks, void* stream) {
  if (nblocks <= 0) return 0;
  constexpr int kThreads = 128;
  const long long grid = (nblocks + kThreads - 1) / kThreads;
  pack_words_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo),
      static_cast<const int32_t*>(nbits), static_cast<uint32_t*>(words),
      static_cast<int32_t*>(bits), static_cast<int64_t>(nblocks));
  return static_cast<int>(cudaGetLastError());
}

const char* jz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

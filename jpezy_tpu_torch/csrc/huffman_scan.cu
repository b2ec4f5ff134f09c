// Huffman entropy decode of restart segments for Hopper (sm_90a).
//
// Replaces jpezy_tpu/ops/entropy_decode.py:decode_segments, which the JAX
// package runs as a lax.scan over block slots around a lax.while_loop over
// symbols with all segments in lockstep (XLA-fused on the TPU; it has no
// Pallas source).  Same function, bit for bit, as
// jpezy_tpu_torch/ops/entropy_decode.py:decode_segments_plain, on valid
// and on corrupt input.
//
//   In:  words [S, Lw] uint32, each row one segment's destuffed bytes
//        packed big-endian, zero-padded; nblk [S] int32 blocks to decode
//        per lane; lut [T, 6, 65536] int32, row = component * 2 + (AC ? 1 :
//        0), entry = (HUFFVAL << 8) | code length (1..16) for the 16-bit
//        window, or -1; optional tsel [S] table set per lane, rawlen [S]
//        destuffed byte length per lane, skip0 [S] bits to skip at the
//        start (0..7), preds0 [S, 3] starting DC predictors.
//   Out: blocks [S, max_blocks, 64] int16, natural order, DC absolute
//        within the lane, zeroed by the caller before the launch (the
//        kernel stores only the nonzero positions it decodes); bad [S]
//        uint8 corruption flags.
//
// Design: one thread per lane.  The lane keeps a 64-bit window in a
// register with `navail` valid bits at the top, refills it with one 32-bit
// word when fewer than 32 are left, reads the LUT once per symbol with
// the window's top 16 bits, sign-extends the extra bits (T.81 F.2.2.1)
// and stores the coefficient at its natural position through the zigzag
// table in constant memory.  A symbol takes at most 16 + 15 bits, so one
// refill per symbol is enough.  Block slot b holds component Y, Y, Y, Y,
// Cb, Cr by b % 6; the three predictors live in three registers.
//
// Ending on corrupt input: every step consumes at least one bit or ends
// the block (an invalid window is read as 8 bits of a zero symbol, which
// writes the DC or ends the AC run as an EOB would), reads are clamped to
// the row's last word, and a lane whose word index passes Lw ends its
// block after the step, so no lane loops forever or reads outside its row.
//
// What bounds it: the function must move the rows, the LUT and the
// blocks once each, 13 MB for 2,048 lanes of 48 blocks: a few
// microseconds of the card's memory rate.  This kernel is nowhere near
// that: each lane is one serial chain of dependent loads (window word,
// LUT entry) and there are only S threads, 64 warps for a 16 x 512 x 512
// batch with a restart interval of 8, on a card that holds 8,448.  It is
// bound by the latency of that chain.  The design does nothing about it
// yet beyond keeping the LUT (1.5 MiB per table set) where the L2 cache
// holds it; lanes that cooperate in a warp, a shared-memory table for the
// short codes and coalesced output are the next steps.  Times on the card
// are in PERF.md.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 64;
constexpr int kLanesPerCta = 32;
constexpr int kLutRow = 65536;
constexpr int kLutRows = 6;

// kZigzag[k] = natural (row-major) index of the k-th zigzag element.
__constant__ uint8_t kZigzag[kSlots] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

__global__ void __launch_bounds__(kLanesPerCta)
decode_segments_kernel(const uint32_t* __restrict__ words,
                       const int32_t* __restrict__ nblk,
                       const int32_t* __restrict__ lut,
                       const int32_t* __restrict__ tsel,
                       const int32_t* __restrict__ rawlen,
                       const int32_t* __restrict__ skip0,
                       const int32_t* __restrict__ preds0,
                       int16_t* __restrict__ blocks,
                       uint8_t* __restrict__ bad_out,
                       long long nlanes, int lw, int ntab, int max_blocks) {
  const long long s =
      static_cast<long long>(blockIdx.x) * kLanesPerCta + threadIdx.x;
  if (s >= nlanes) return;
  const uint32_t* row = words + s * lw;
  bool bad = false;
  int ts = tsel ? tsel[s] : 0;
  if (ts < 0 || ts >= ntab) {
    bad = true;
    ts = 0;
  }
  const int32_t* lane_lut =
      lut + static_cast<size_t>(ts) * kLutRows * kLutRow;

  uint64_t win = 0;  // next stream bit = bit 63
  int navail = 0;
  int widx = 0;
  if (skip0) {
    win = static_cast<uint64_t>(row[0]) << 32;
    navail = 32;
    widx = 1;
    const int k = skip0[s] & 7;
    win <<= k;
    navail -= k;
  }
  int32_t p0 = 0, p1 = 0, p2 = 0;
  if (preds0) {
    p0 = preds0[3 * s];
    p1 = preds0[3 * s + 1];
    p2 = preds0[3 * s + 2];
  }
  int nb = nblk[s];
  if (nb > max_blocks) nb = max_blocks;
  int16_t* out = blocks + s * max_blocks * kSlots;

  for (int b = 0; b < nb; ++b) {
    const int slot = b % 6;
    const int comp = slot < 4 ? 0 : slot - 3;
    int32_t pred = comp == 0 ? p0 : (comp == 1 ? p1 : p2);
    const int32_t* lut_dc = lane_lut + comp * 2 * kLutRow;
    const int32_t* lut_ac = lut_dc + kLutRow;
    int16_t* blk = out + b * kSlots;
    int kk = 0;
    bool done = false;
    while (!done) {
      if (navail < 32) {
        const uint32_t w = row[widx < lw ? widx : lw - 1];
        win |= static_cast<uint64_t>(w) << (32 - navail);
        navail += 32;
        ++widx;
      }
      const uint32_t hi = static_cast<uint32_t>(win >> 32);
      const bool is_dc = kk == 0;
      const int32_t e = (is_dc ? lut_dc : lut_ac)[hi >> 16];
      int ln = e & 0xFF;
      int val = e >> 8;
      if (e < 0) {  // invalid window: skip 8 bits as a zero symbol
        bad = true;
        ln = 8;
        val = 0;
      }
      if (is_dc && val > 15) {
        bad = true;
        val = 0;
      }
      const int run = val >> 4;
      const int size = val & 15;
      const int ncat = is_dc ? val : size;  // extra bits, <= 15
      int32_t v = 0;
      if (ncat > 0) {
        const uint32_t extra = (hi << ln) >> (32 - ncat);
        v = static_cast<int32_t>(extra);
        if (((extra >> (ncat - 1)) & 1u) == 0) v -= (1 << ncat) - 1;
      }
      if (is_dc) {
        pred = static_cast<int32_t>(static_cast<uint32_t>(pred) +
                                    static_cast<uint32_t>(v));
        blk[0] = static_cast<int16_t>(static_cast<uint16_t>(pred));
        kk = 1;
      } else if (size == 0) {
        if (run == 15) {  // ZRL: 16 zeros
          if (kk + 15 > 63) bad = true;
          kk += 16;
        } else {  // EOB
          done = true;
        }
      } else {
        const int kk_ac = kk + run;
        if (kk_ac > 63) {
          bad = true;
        } else {
          blk[kZigzag[kk_ac]] = static_cast<int16_t>(v);
        }
        kk = kk_ac + 1;
      }
      const int k = ln + ncat;  // <= 31, and navail >= 32 here
      win <<= k;
      navail -= k;
      done = done || kk > 63 || widx > lw;
    }
    if (comp == 0) {
      p0 = pred;
    } else if (comp == 1) {
      p1 = pred;
    } else {
      p2 = pred;
    }
  }
  if (rawlen) {
    // a valid segment's last payload bit lies in its last destuffed byte
    const long long consumed = 32LL * widx - navail;
    const long long exp = 8LL * rawlen[s];
    if (consumed > exp || consumed <= exp - 8) bad = true;
  }
  bad_out[s] = bad ? 1 : 0;
}

}  // namespace

extern "C" {

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError(): 0 on success.  Does not synchronise.  tsel, rawlen,
// skip0 and preds0 may be null.
int jz_decode_segments(const void* words, const void* nblk, const void* lut,
                       const void* tsel, const void* rawlen,
                       const void* skip0, const void* preds0, void* blocks,
                       void* bad, long long nlanes, int lw, int ntab,
                       int max_blocks, void* stream) {
  if (nlanes <= 0 || max_blocks <= 0) return 0;
  if (lw <= 0 || ntab <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = (nlanes + kLanesPerCta - 1) / kLanesPerCta;
  if (grid > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  decode_segments_kernel<<<static_cast<unsigned>(grid), kLanesPerCta, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(nblk),
      static_cast<const int32_t*>(lut), static_cast<const int32_t*>(tsel),
      static_cast<const int32_t*>(rawlen), static_cast<const int32_t*>(skip0),
      static_cast<const int32_t*>(preds0), static_cast<int16_t*>(blocks),
      static_cast<uint8_t*>(bad), nlanes, lw, ntab, max_blocks);
  return static_cast<int>(cudaGetLastError());
}

const char* jz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

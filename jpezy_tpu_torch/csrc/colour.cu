// Colour conversion for Hopper (sm_90a): RGB to YCbCr with 4:2:0
// decimation on encode, and nearest upsampling with YCbCr to RGB (or the
// gray clamp) on decode, for the rgb transport, in float32 (fast) and
// float64 (exact) arithmetic.  precision="exact" promises streams
// byte-identical to the reference encoder and pixels identical to its
// decoder, so every rounding of the reference's double arithmetic is kept;
// the float32 forms make eager torch's float32 roundings, so the card and
// the plain torch version agree bit for bit at both precisions.
//
// Kernel 1, rgb_to_ycc420_kernel, replaces jpezy_tpu/ops/colorspace.py:
// rgb_to_ycc and ops/blocks.py:decimate_420, which XLA fused on the TPU
// into jpezy_tpu/parallel/sharded.py:_encode_local.
//   In:  rgb [N, H, W, 3] uint8, H and W multiples of 16.
//   Out: Y - 128 [N, H, W] and Cb, Cr [N, H/2, W/2] int8 (every RGB triple
//        gives Y in -128..127 and Cb, Cr in -127..127); the chroma of each
//        2x2 quad is its top-left pixel's, no averaging.
//   Per pixel, in eager torch's order, every operation one rounding:
//     y  = int(((0.2990 r + 0.5870 g) + 0.1140 b) - 128)
//     cb = int(((-(0.1687 r)) - 0.3313 g) + 0.5000 b)
//     cr = int((0.5000 r - 0.4187 g) - 0.0813 b)
//   with int() truncating toward zero.  The float32 form's constants are
//   the double literals rounded to float32, the scalars torch casts them
//   to.
//
// Kernel 2, ycc_planes_to_rgb_kernel, replaces jpezy_tpu/ops/colorspace.py:
// ycc_to_rgb and clamp_gray and ops/blocks.py:upsample_nearest, which XLA
// fused on the TPU into jpezy_tpu/codec/jax_codec.py:_decode_fused_batch.
//   In:  per component its unclamped int32 plane [N, rows_c, cols_c] (the
//        IDCT's output) and its upsampling factors (dup_y, dup_x), 1 to 4,
//        with rows_c dup_y = the output's rows and cols_c dup_x its
//        columns; one component for gray.
//   Out: [N, rows, cols, 3] uint8 RGB interleaved, or [N, rows, cols, 1]
//        for gray.
//   Per pixel, component c's sample at (row / dup_y, col / dup_x), then in
//   torch's order, every operation one rounding:
//     r = y + (cr - 128) 1.4020
//     g = (y - (cb - 128) 0.3441) - (cr - 128) 0.7139
//     b = y + (cb - 128) 1.7718
//   each truncated toward zero and clamped to [0, 255].  Gray is the clamp
//   alone, which no conversion to float changes, so one form serves both
//   precisions.
//
// The trap: nvcc contracts a * b + c into an FMA by default, which skips
// the product's rounding and flips the truncation of some pixels.  Every
// multiply, add and subtract here is __fmul_rn / __fadd_rn / __fsub_rn
// (__dmul_rn / __dadd_rn / __dsub_rn), which are never contracted;
// chip_smoke.py finds no FFMA or DFMA in the SASS of either kernel.
// Truncation is __float2int_rz / __double2int_rz, as torch's .to(int32).
//
// What bounds them, per 16 x 512 x 512 batch: bytes.  Kernel 1 reads 12.58
// MB and writes 6.29 MB, 0.0056 ms at 3.35 TB/s; its 6 operations a pixel
// for Y and 10 a quad for the chroma (35.7 M) are 0.0021 ms at float64's
// 16.75e12 separate DMUL/DADD a second, less at float32.  Kernel 2
// (colour) reads 25.2 MB of int32 planes at 4:2:0 (Y 16.8 MB, chroma 8.4
// MB) and writes 12.6 MB, 0.0113 ms; gray reads 16.8 MB and writes 4.2 MB,
// 0.0063 ms.
// Design: simple and coalesced.  Kernel 1: a thread takes 8 pixels of two
// rows (four 2x2 quads): three 8-byte loads a row, one 8-byte store of Y a
// row and one 4-byte store each of Cb and Cr.  Kernel 2: a thread takes 4
// adjacent pixels of a row, reads each component's samples with one
// vector load where dup_x is 1, 2 or 4, and writes its 12 bytes of RGB as
// three aligned 4-byte words (4 bytes for gray), so no store is narrower
// than a word.  Neither kernel stages through shared memory.
//
// No atomics: every output is written by one thread, so the same input
// gives the same bits on every run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// one rounding an operation, never contracted
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ int trunc_int(float a) {
  return __float2int_rz(a);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ int trunc_int(double a) {
  return __double2int_rz(a);
}

template <typename Real>
__device__ __forceinline__ Real to_real(int v);
template <>
__device__ __forceinline__ float to_real<float>(int v) {
  return __int2float_rn(v);
}
template <>
__device__ __forceinline__ double to_real<double>(int v) {
  return __int2double_rn(v);
}

// byte k of 4-byte words w
__device__ __forceinline__ int byte_of(const uint32_t* w, int k) {
  return static_cast<int>((w[k >> 2] >> (8 * (k & 3))) & 0xFFu);
}

// ---------------------------------------------------------------------------
// Kernel 1: RGB -> Y - 128, and Cb, Cr of each quad's top-left pixel
// ---------------------------------------------------------------------------

struct EncArgs {
  const uint8_t* rgb;     // [N, H, W, 3]
  int8_t* y;              // [N, H, W]
  int8_t* cb;             // [N, H/2, W/2]
  int8_t* cr;
  long long units;        // N * H/2 * W/8: 8 pixels of a pair of rows
  int width;              // W
};

template <typename Real>
__device__ __forceinline__ int luma(int r, int g, int b) {
  const Real y = add(add(mul(Real(0.2990), to_real<Real>(r)),
                         mul(Real(0.5870), to_real<Real>(g))),
                     mul(Real(0.1140), to_real<Real>(b)));
  return trunc_int(sub(y, Real(128.0)));
}

template <typename Real>
__global__ void __launch_bounds__(kThreads)
    rgb_to_ycc420_kernel(const __grid_constant__ EncArgs a) {
  const int per_pair = a.width >> 3;
  for (long long u = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       u < a.units; u += static_cast<long long>(gridDim.x) * kThreads) {
    const long long pair = u / per_pair;   // image n, row pair i: n H/2 + i
    const int j = static_cast<int>(u - pair * per_pair);
    const long long pix0 = 2 * pair * a.width + 8ll * j;  // row 2i, col 8j
    uint32_t w[2][6];                      // 24 bytes of each row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint2* src = reinterpret_cast<const uint2*>(
          a.rgb + 3 * (pix0 + static_cast<long long>(r) * a.width));
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const uint2 v = __ldg(src + k);
        w[r][2 * k] = v.x;
        w[r][2 * k + 1] = v.y;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      uint32_t out[2] = {0u, 0u};
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int y = luma<Real>(byte_of(w[r], 3 * x),
                                 byte_of(w[r], 3 * x + 1),
                                 byte_of(w[r], 3 * x + 2));
        out[x >> 2] |= (static_cast<uint32_t>(y) & 0xFFu) << (8 * (x & 3));
      }
      *reinterpret_cast<uint2*>(
          a.y + pix0 + static_cast<long long>(r) * a.width) =
          make_uint2(out[0], out[1]);
    }
    uint32_t ocb = 0u, ocr = 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // the quad's top-left: row 2i, col 8j + 2q
      const Real rf = to_real<Real>(byte_of(w[0], 6 * q));
      const Real gf = to_real<Real>(byte_of(w[0], 6 * q + 1));
      const Real bf = to_real<Real>(byte_of(w[0], 6 * q + 2));
      const int cb = trunc_int(add(sub(-mul(Real(0.1687), rf),
                                       mul(Real(0.3313), gf)),
                                   mul(Real(0.5000), bf)));
      const int cr = trunc_int(sub(sub(mul(Real(0.5000), rf),
                                       mul(Real(0.4187), gf)),
                                   mul(Real(0.0813), bf)));
      ocb |= (static_cast<uint32_t>(cb) & 0xFFu) << (8 * q);
      ocr |= (static_cast<uint32_t>(cr) & 0xFFu) << (8 * q);
    }
    const long long c0 = pair * (a.width >> 1) + 4ll * j;
    *reinterpret_cast<uint32_t*>(a.cb + c0) = ocb;
    *reinterpret_cast<uint32_t*>(a.cr + c0) = ocr;
  }
}

// ---------------------------------------------------------------------------
// Kernel 2: nearest upsampling, YCbCr -> RGB or the gray clamp
// ---------------------------------------------------------------------------

struct DecComp {
  const int32_t* plane;   // [N, rows, cols]
  long long image;        // rows * cols
  int cols, dup_y, dup_x;
};

struct DecArgs {
  DecComp comp[3];
  uint8_t* out;           // [N, out_rows, out_cols, 3 or 1]
  long long units;        // N * out_rows * out_cols / 4
  int out_rows, out_cols;
};

// The samples of output columns col0 .. col0 + 3 (col0 a multiple of 4) in
// a plane row upsampled by dx: one 16-, 8- or 4-byte load where dx is 1, 2
// or 4 (the row is 16-byte aligned and col0 / dx lands on that load's
// alignment), four 4-byte loads at dx = 3.
__device__ __forceinline__ void load4(const int32_t* row, int col0, int dx,
                                      int* v) {
  if (dx == 1) {
    const int4 s = __ldg(reinterpret_cast<const int4*>(row + col0));
    v[0] = s.x; v[1] = s.y; v[2] = s.z; v[3] = s.w;
  } else if (dx == 2) {
    const int2 s = __ldg(reinterpret_cast<const int2*>(row + (col0 >> 1)));
    v[0] = v[1] = s.x;
    v[2] = v[3] = s.y;
  } else if (dx == 4) {
    v[0] = v[1] = v[2] = v[3] = __ldg(row + (col0 >> 2));
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __ldg(row + (col0 + k) / dx);
  }
}

__device__ __forceinline__ uint32_t clamp_u8(int v) {
  return static_cast<uint32_t>(min(max(v, 0), 255));
}

template <typename Real, bool kGray>
__global__ void __launch_bounds__(kThreads)
    ycc_planes_to_rgb_kernel(const __grid_constant__ DecArgs a) {
  const int per_row = a.out_cols >> 2;
  constexpr int kComps = kGray ? 1 : 3;
  for (long long u = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       u < a.units; u += static_cast<long long>(gridDim.x) * kThreads) {
    const long long orow = u / per_row;    // n out_rows + row
    const int col0 = 4 * static_cast<int>(u - orow * per_row);
    const int n = static_cast<int>(orow / a.out_rows);
    const int row = static_cast<int>(orow - static_cast<long long>(n) *
                                                a.out_rows);
    int v[kComps][4];
#pragma unroll
    for (int c = 0; c < kComps; ++c) {
      const DecComp& P = a.comp[c];
      load4(P.plane + n * P.image +
                static_cast<long long>(row / P.dup_y) * P.cols,
            col0, P.dup_x, v[c]);
    }
    if (kGray) {
      *reinterpret_cast<uint32_t*>(a.out + 4 * u) =
          clamp_u8(v[0][0]) | clamp_u8(v[0][1]) << 8 |
          clamp_u8(v[0][2]) << 16 | clamp_u8(v[0][3]) << 24;
      continue;
    }
    uint32_t rgb[12];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const Real yf = to_real<Real>(v[0][k]);
      const Real cbf = sub(to_real<Real>(v[kComps > 1 ? 1 : 0][k]),
                           Real(128.0));
      const Real crf = sub(to_real<Real>(v[kComps > 2 ? 2 : 0][k]),
                           Real(128.0));
      rgb[3 * k] = clamp_u8(trunc_int(add(yf, mul(crf, Real(1.4020)))));
      rgb[3 * k + 1] = clamp_u8(trunc_int(
          sub(sub(yf, mul(cbf, Real(0.3441))), mul(crf, Real(0.7139)))));
      rgb[3 * k + 2] = clamp_u8(trunc_int(add(yf, mul(cbf, Real(1.7718)))));
    }
    uint32_t* dst = reinterpret_cast<uint32_t*>(a.out + 12 * u);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      dst[k] = rgb[4 * k] | rgb[4 * k + 1] << 8 | rgb[4 * k + 2] << 16 |
               rgb[4 * k + 3] << 24;
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
  const long long blocks = (units + kThreads - 1) / kThreads;
  const long long resident =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  *grid = static_cast<int>(blocks < resident ? blocks : resident);
  return cudaSuccess;
}

template <typename K, typename A>
int launch(K kernel, long long units, const A& a, cudaStream_t s) {
  int grid = 0;
  const cudaError_t e = grid_for(kernel, units, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
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

}  // namespace

extern "C" {

// Kernel 1 on `stream` (PyTorch's current stream); returns
// cudaGetLastError(), 0 on success.  Does not synchronise.  rgb: [N, H, W,
// 3] uint8, contiguous, 8-byte aligned; y, cb, cr contiguous and 8-byte
// aligned; H and W multiples of 16; exact: 1 for float64, 0 for float32.
int jz_colour_rgb_to_ycc420(int exact, long long nimages, long long height,
                     long long width, const void* rgb, void* y, void* cb,
                     void* cr, void* stream) {
  if (nimages <= 0 || height <= 0 || width <= 0) return 0;
  if (height % 16 || width % 16 || width > 0x7FFFFFFFll)
    return static_cast<int>(cudaErrorInvalidValue);
  EncArgs a;
  a.rgb = static_cast<const uint8_t*>(rgb);
  a.y = static_cast<int8_t*>(y);
  a.cb = static_cast<int8_t*>(cb);
  a.cr = static_cast<int8_t*>(cr);
  a.units = nimages * (height / 2) * (width / 8);
  a.width = static_cast<int>(width);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return exact ? launch(rgb_to_ycc420_kernel<double>, a.units, a, s)
               : launch(rgb_to_ycc420_kernel<float>, a.units, a, s);
}

// Kernel 2 on `stream`; returns cudaGetLastError(), 0 on success.  Does not
// synchronise.  desc (host memory): nimages, ncomp (1 for gray or a
// 1-component frame, else 3), out_rows, out_cols, then per component rows,
// cols, dup_y, dup_x.  planes: the components' int32 planes, contiguous and
// 16-byte aligned; out: [N, out_rows, out_cols, ncomp == 1 ? 1 : 3] uint8.
int jz_colour_planes_to_rgb(int exact, const long long* desc, const void* p0,
                         const void* p1, const void* p2, void* out,
                         void* stream) {
  const long long nimages = desc[0], ncomp = desc[1];
  const long long rows = desc[2], cols = desc[3];
  if (nimages <= 0 || rows <= 0 || cols <= 0) return 0;
  if ((ncomp != 1 && ncomp != 3) || cols % 4 || cols > 0x7FFFFFFFll ||
      rows > 0x7FFFFFFFll)
    return static_cast<int>(cudaErrorInvalidValue);
  DecArgs a;
  const void* planes[3] = {p0, p1, p2};
  for (int c = 0; c < 3; ++c) {
    DecComp& p = a.comp[c];
    const long long* d = desc + 4 + 4 * (c < ncomp ? c : 0);
    p.plane = static_cast<const int32_t*>(planes[c < ncomp ? c : 0]);
    p.image = d[0] * d[1];
    p.cols = static_cast<int>(d[1]);
    p.dup_y = static_cast<int>(d[2]);
    p.dup_x = static_cast<int>(d[3]);
    if (p.dup_y < 1 || p.dup_y > 4 || p.dup_x < 1 || p.dup_x > 4 ||
        d[0] * p.dup_y != rows || d[1] * p.dup_x != cols)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  a.out = static_cast<uint8_t*>(out);
  a.units = nimages * rows * (cols / 4);
  a.out_rows = static_cast<int>(rows);
  a.out_cols = static_cast<int>(cols);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ncomp == 1) return launch(ycc_planes_to_rgb_kernel<float, true>,
                                a.units, a, s);
  return exact ? launch(ycc_planes_to_rgb_kernel<double, false>, a.units, a, s)
               : launch(ycc_planes_to_rgb_kernel<float, false>, a.units, a, s);
}

// What the card reports for kernel `which` (0: rgb_to_ycc420 float32, 1:
// float64, 2: ycc_planes_to_rgb float32, 3: float64, 4: gray): info[0]
// registers a thread, [1] resident thread blocks an SM, [2] static shared
// bytes, [3] local bytes a thread, [4] threads a block.  Returns 0 or a CUDA
// error code.
int jz_colour_kernel_info(int which, int* info) {
  switch (which) {
    case 0:
      return kernel_info(rgb_to_ycc420_kernel<float>, info);
    case 1:
      return kernel_info(rgb_to_ycc420_kernel<double>, info);
    case 2:
      return kernel_info(ycc_planes_to_rgb_kernel<float, false>, info);
    case 3:
      return kernel_info(ycc_planes_to_rgb_kernel<double, false>, info);
    case 4:
      return kernel_info(ycc_planes_to_rgb_kernel<float, true>, info);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* jz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

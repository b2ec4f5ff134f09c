// The float64 rate one H100 sustains outside the tensor cores, as separate
// DMUL and DADD (exact mode's kernels may not contract), for chip_smoke.py
// phase 6: every thread runs kChains independent chains, each step a
// __dmul_rn and a __dadd_rn, so nothing but the float64 pipe, the clock and
// the operands' paths limit the rate.  Three forms: x = x m + c (each
// operation one register operand, m and c uniform), x = x m + y (the add's
// two operands in registers, as an accumulation's are) and x = x y + y
// (both operations two register operands).  The launch holds exactly `blocks_per_sm`
// thread blocks of 256 threads on every SM (dynamic shared memory caps
// the rest), to read the rate at a kernel's occupancy and at the full 64
// warps.  The float32 rate of separate FMUL and FADD likewise
// (jz_fp32_chains; the fast rgb IDCT may not contract either): x = x m +
// y, and the rgb IDCT's step, one product into four adds (t = x m, then
// a[j] += t for 4 sums a chain).  scripts/fp64_ceiling.py binds it;
// nothing in the package calls it.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// chains a thread: 4 keep every form within 32 registers, so that 64
// warps fit an SM, and give each scheduler 24 or more chains at 6 warps
constexpr int kChains = 4;

template <int kForm>
__global__ void __launch_bounds__(kThreads)
    fp64_chains_kernel(double* out, int iters, double m, double c) {
  double x[kChains], y[kChains];
#pragma unroll
  for (int i = 0; i < kChains; ++i) {
    x[i] = (blockIdx.x * kThreads + threadIdx.x) * 1e-9 + i;
    y[i] = __dadd_rn(0.5, x[i] * 1e-12);   // in a register, not uniform
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < kChains; ++i) {
      if (kForm == 0) x[i] = __dadd_rn(__dmul_rn(x[i], m), c);
      if (kForm == 1) x[i] = __dadd_rn(__dmul_rn(x[i], m), y[i]);
      if (kForm == 2) x[i] = __dadd_rn(__dmul_rn(x[i], y[i]), y[i]);
    }
  }
  double s = 0.0;
#pragma unroll
  for (int i = 0; i < kChains; ++i) s = __dadd_rn(s, x[i]);
  if (s == -1.0) out[0] = s;  // never true: keeps the chains live
}

// float32: kForm 0, x = x m + y; kForm 1, t = x m, a[j] += t for j < 4
// and x = t + y (one product into four adds, and the chain carried on)
template <int kForm>
__global__ void __launch_bounds__(kThreads)
    fp32_chains_kernel(float* out, int iters, float m) {
  float x[kChains], y[kChains], a[kChains][4];
#pragma unroll
  for (int i = 0; i < kChains; ++i) {
    x[i] = (blockIdx.x * kThreads + threadIdx.x) * 1e-9f + i;
    y[i] = __fadd_rn(0.5f, x[i] * 1e-12f);   // in a register, not uniform
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = y[i] * j;
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < kChains; ++i) {
      const float t = __fmul_rn(x[i], m);
      if (kForm == 1) {
#pragma unroll
        for (int j = 0; j < 4; ++j) a[i][j] = __fadd_rn(a[i][j], t);
      }
      x[i] = __fadd_rn(t, y[i]);
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kChains; ++i) {
    s = __fadd_rn(s, x[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) s = __fadd_rn(s, a[i][j]);
  }
  if (s == -1.0f) out[0] = s;  // never true: keeps the chains live
}

// The dynamic shared memory that leaves room for exactly blocks_per_sm
// thread blocks of kernel on an SM, or a CUDA error code.
template <typename K>
cudaError_t occupy(K kernel, int blocks_per_sm, int* smem, int* grid) {
  int dev = 0, sms = 0, smem_sm = 0, reserved = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (e != cudaSuccess) return e;
  // a whole number of KB, so that the allocation's granularity cannot
  // leave room for one thread block fewer
  *smem = (smem_sm / blocks_per_sm - reserved) / 1024 * 1024;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           *smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, *smem);
  if (e != cudaSuccess) return e;
  if (per_sm != blocks_per_sm) return cudaErrorInvalidConfiguration;
  *grid = sms * blocks_per_sm;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launches the chains of `form` (0, 1 or 2, see above) on `stream` with
// blocks_per_sm thread blocks on each SM; *ops receives the float64
// operations the launch issues.  Returns 0 or a CUDA error code
// (cudaErrorInvalidConfiguration where the card would not hold exactly
// blocks_per_sm of them).
int jz_fp64_chains(int form, int blocks_per_sm, int iters, void* out,
                   long long* ops, void* stream) {
  void (*kernel)(double*, int, double, double) =
      form == 0 ? fp64_chains_kernel<0>
                : (form == 1 ? fp64_chains_kernel<1> : fp64_chains_kernel<2>);
  if (blocks_per_sm < 1 || iters < 1 || form < 0 || form > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  int smem = 0, grid = 0;
  const cudaError_t e = occupy(kernel, blocks_per_sm, &smem, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  *ops = 2ll * kChains * iters * kThreads * grid;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(out), iters, 0.999999, 1e-6);
  return static_cast<int>(cudaGetLastError());
}

// The float32 chains of `form` (0 or 1, see fp32_chains_kernel), as
// jz_fp64_chains; *ops receives the float32 operations issued.
int jz_fp32_chains(int form, int blocks_per_sm, int iters, void* out,
                   long long* ops, void* stream) {
  void (*kernel)(float*, int, float) =
      form == 0 ? fp32_chains_kernel<0> : fp32_chains_kernel<1>;
  if (blocks_per_sm < 1 || iters < 1 || form < 0 || form > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int smem = 0, grid = 0;
  const cudaError_t e = occupy(kernel, blocks_per_sm, &smem, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  *ops = (form == 0 ? 2ll : 6ll) * kChains * iters * kThreads * grid;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters, 0.999999f);
  return static_cast<int>(cudaGetLastError());
}

const char* jz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

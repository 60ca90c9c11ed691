// dist_update: the AdaBoost sample-distribution update (paper eq. 4).
//
//   w[i] = D[i] * exp((-alpha * y[i]) * h[i])       (f32, in this order)
//   Z    = sum_i w[i]
//   D'[i] = w[i] / (Z + 1e-30)
//
// Replaces the TPU kernel `dist_update_kernel` / `_dist_update_kernel` in
// src/repro/kernels/dist_update.py, which computed w and carried Z in a
// scalar block revisited across a sequential grid (the TPU's grid runs in
// order on one core), with the division left to its wrapper.
//
// Bound on the H100: the bytes.  Each sample takes one exp and a few
// multiplies and adds against 16 bytes of traffic (D, y, h read, D' written),
// far below the card's ratio of operations to bytes.
//
// Design: blocks run in no order here, so the sum is taken in two stages
// and the division in a third, three launches on one stream.  Stage 1: each
// block takes one tile of kTile samples, each thread kPer of them a block's
// width apart (coalesced), writes w and sums its samples in f64 in order;
// the block then adds its threads' sums by a fixed tree in shared memory
// and writes one f64 partial.  Stage 2: one block adds the partials the
// same way and rounds Z once to f32.  Stage 3 writes D' over w.  No atomics:
// every sum is taken in a fixed order, so Z is the same run to run, and the
// f64 sums are closer to the exact sum than the f32 sum of the plain
// version.  Built without fast math: expf is the accurate one (2 ulp) and
// the division is correctly rounded, as on the CPU.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;                      // samples per thread in stage 1
constexpr int kTile = kThreads * kPer;       // samples per block in stage 1
constexpr int kReduceThreads = 1024;         // the one block of stage 2

template <int kN>
__device__ __forceinline__ double block_sum(double v, double* shm) {
  // fixed-order tree over the block's kN threads, returned to every thread
  shm[threadIdx.x] = v;
  __syncthreads();
#pragma unroll
  for (int s = kN / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) shm[threadIdx.x] += shm[threadIdx.x + s];
    __syncthreads();
  }
  return shm[0];
}

__global__ void __launch_bounds__(kThreads)
dist_weights_kernel(const float* __restrict__ alpha,
                    const float* __restrict__ D, const float* __restrict__ y,
                    const float* __restrict__ h, float* __restrict__ w,
                    double* __restrict__ partials, size_t n) {
  __shared__ double shm[kThreads];
  const float na = -alpha[0];
  const size_t base = (size_t)blockIdx.x * kTile + threadIdx.x;
  double acc = 0.0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const size_t i = base + (size_t)k * kThreads;
    if (i < n) {
      const float wi = __fmul_rn(D[i], expf(__fmul_rn(__fmul_rn(na, y[i]),
                                                      h[i])));
      w[i] = wi;
      acc += (double)wi;
    }
  }
  const double total = block_sum<kThreads>(acc, shm);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kReduceThreads)
dist_total_kernel(const double* __restrict__ partials, int n_partials,
                  float* __restrict__ z) {
  __shared__ double shm[kReduceThreads];
  double acc = 0.0;
  for (int i = threadIdx.x; i < n_partials; i += kReduceThreads)
    acc += partials[i];
  const double total = block_sum<kReduceThreads>(acc, shm);
  if (threadIdx.x == 0) z[0] = __double2float_rn(total);
}

__global__ void __launch_bounds__(kThreads)
dist_normalize_kernel(float* __restrict__ w, const float* __restrict__ z,
                      size_t n) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) w[i] = __fdiv_rn(w[i], __fadd_rn(z[0], 1e-30f));
}

}  // namespace

// The number of f64 partials the launcher needs as scratch for n samples.
extern "C" long long dist_update_partials(long long n) {
  return (n + kTile - 1) / kTile;
}

// alpha (1,), D, y, h (n,) -> out (n,) = D', z (1,) = Z, all f32 and
// contiguous on one device; partials: dist_update_partials(n) f64 of
// scratch.  Three launches on `stream`; returns the first CUDA error (0 on
// success).
extern "C" int dist_update_launch(const void* alpha, const void* D,
                                  const void* y, const void* h, void* out,
                                  void* z, void* partials, long long n,
                                  void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long n_partials = dist_update_partials(n);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (n_partials > 0x7fffffffLL || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  dist_weights_kernel<<<(unsigned)n_partials, kThreads, 0, s>>>(
      (const float*)alpha, (const float*)D, (const float*)y, (const float*)h,
      (float*)out, (double*)partials, (size_t)n);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  dist_total_kernel<<<1, kReduceThreads, 0, s>>>(
      (const double*)partials, (int)n_partials, (float*)z);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  dist_normalize_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      (float*)out, (const float*)z, (size_t)n);
  return (int)cudaGetLastError();
}

// stump_scan: weighted error of every polarity-(+1) decision stump.
//
//   err[b, f, t] = sum_n w[b, n] * [ (x[b, n, f] > thr[b, f, t] ? +1 : -1) != y[b, n] ]
//
// Replaces the TPU kernel `stump_scan_kernel` / `_stump_kernel` in
// src/repro/kernels/stump_scan.py, which streamed (block_n, F) sample tiles
// through VMEM and kept the whole (F, T) error tile resident across a
// sequential grid.  Hopper has no sequential grid, so the sum over samples
// moves inside a block instead.
//
// Bound on the H100: at the engine's shapes (a client shard of a few
// hundred rows, F = 64, T = 16, under 100 KB read) the launch itself
// dominates.  The least time for the work is the bytes (N*F + 2N + F*T
// floats read once), the N*F*T compares and f64 adds being far below the
// card's rates.  But the threads of a block read x[n*F + f] a stride of F
// floats apart, so each 32-byte sector a warp loads brings one useful
// float: at large N the loads move about 8x the bytes the work needs,
// through L2, and the kernel runs far above its bound (a later version can
// walk coalesced rows of x, several features per block).
//
// Design: one block per (b, f) pair.  Each thread keeps a chunk of 16
// thresholds and their 16 partial sums in registers and strides over the
// samples in a fixed order; the block then reduces the partial sums with
// warp shuffles and one pass over the warps in order.  No float atomics,
// so the result is the same run to run.  The sums are kept in f64 and
// rounded once to f32, as the plain version does (kernels/ref.py): errors
// that tie in exact arithmetic then tie here and on the CPU alike, and the
// stump pick settles them by index, not by this kernel's summation order.
// Ragged N, F and T are handled here (thresholds past T are never
// written), so the caller pads nothing.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;

__global__ void __launch_bounds__(kThreads)
stump_scan_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  const float* __restrict__ w, const float* __restrict__ thr,
                  float* __restrict__ err, int N, int F, int T) {
  const int f = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* xb = x + (size_t)b * N * F;
  const float* yb = y + (size_t)b * N;
  const float* wb = w + (size_t)b * N;
  const float* thr_f = thr + ((size_t)b * F + f) * T;
  float* err_f = err + ((size_t)b * F + f) * T;
  __shared__ double partial[kWarps][kChunk];

  for (int t0 = 0; t0 < T; t0 += kChunk) {
    float th[kChunk];
    double acc[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      // a threshold past T is +inf: never written out, so any value does
      th[k] = (t0 + k < T) ? thr_f[t0 + k] : __int_as_float(0x7f800000);
      acc[k] = 0.0;
    }
    for (int n = tid; n < N; n += kThreads) {
      const float xv = xb[(size_t)n * F + f];
      const float yv = yb[n];
      const double wv = wb[n];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const float pred = (xv > th[k]) ? 1.0f : -1.0f;
        if (pred != yv) acc[k] += wv;
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      double v = acc[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) partial[warp][k] = v;
    }
    __syncthreads();
    if (tid < kChunk && t0 + tid < T) {
      double s = 0.0;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) s += partial[i][tid];
      err_f[t0 + tid] = __double2float_rn(s);
    }
    __syncthreads();
  }
}

}  // namespace

// x (B,N,F), y (B,N), w (B,N), thr (B,F,T) -> err (B,F,T), all f32 and
// contiguous.  Returns the CUDA error of the launch (0 on success).
extern "C" int stump_scan_launch(const void* x, const void* y, const void* w,
                                 const void* thr, void* err, int B, int N,
                                 int F, int T, void* stream) {
  dim3 grid(F, B);
  stump_scan_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (const float*)w, (const float*)thr,
      (float*)err, N, F, T);
  return (int)cudaGetLastError();
}

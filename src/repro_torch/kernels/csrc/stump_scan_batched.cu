// stump_scan_batched: weighted error of every polarity-(+1) decision stump,
// for every slot of a stacked fleet batch.
//
//   err[b, f, t] = sum_n w[b, n] * [ (x[b, n, f] > thr[b, f, t] ? +1 : -1) != y[b, n] ]
//
// Replaces `_pallas_stump_scan_batched` in src/repro/kernels/dispatch.py, a
// `vmap` of the TPU kernel `stump_scan_kernel` (src/repro/kernels/stump_scan.py)
// over the batch, with its sample block shrunk to next_pow2(N) >= 8.  The
// fleet profile (core/fleet.py) launches it once per fit wave: up to 100,000
// client shards of a few rows each, so the work is many tiny independent
// sums rather than a few long ones.
//
// Bound on the H100: bytes.  Each output cell needs N compares and at most N
// f64 adds, while the kernel must read x, y, w and the threshold grid once
// and write the error grid once; at the fleet's shape (B = 100,000, N = 4,
// F = 48, T = 16) that is 694 MB of traffic against 614 M compares.
//
// Design: one thread per output cell (b, f, t), on a flat index over
// gridDim.x (whose limit is 2^31 - 1; gridDim.y stops at 65,535, which a
// fleet wave exceeds), with size_t offsets.  Neighbouring threads take
// neighbouring t, so threshold reads and error writes are coalesced, and
// the T threads of one (b, f) read the same x, y and w values, which come
// from cache.  Each thread walks n = 0..N-1 in order and sums in f64, then
// rounds once to f32: the same order as the plain version (kernels/ref.py),
// so the two agree bit for bit, run to run, with no atomics.  Errors that
// tie in exact arithmetic then tie here and on the CPU alike.  Any B, N, F
// and T are taken as they are; the caller pads nothing.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
stump_scan_batched_kernel(const float* __restrict__ x,
                          const float* __restrict__ y,
                          const float* __restrict__ w,
                          const float* __restrict__ thr,
                          float* __restrict__ err, size_t cells, int N,
                          int F, int T) {
  const size_t cell = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (cell >= cells) return;
  const size_t bf = cell / (size_t)T;          // b * F + f
  const size_t b = bf / (size_t)F;
  const size_t f = bf - b * (size_t)F;
  const float th = thr[cell];
  const float* xb = x + b * (size_t)N * F + f;
  const float* yb = y + b * (size_t)N;
  const float* wb = w + b * (size_t)N;
  double acc = 0.0;
  for (int n = 0; n < N; ++n) {
    const float pred = (xb[(size_t)n * F] > th) ? 1.0f : -1.0f;
    if (pred != yb[n]) acc += (double)wb[n];
  }
  err[cell] = __double2float_rn(acc);
}

}  // namespace

// x (B,N,F), y (B,N), w (B,N), thr (B,F,T) -> err (B,F,T), all f32 and
// contiguous.  Returns the CUDA error of the launch (0 on success).
extern "C" int stump_scan_batched_launch(const void* x, const void* y,
                                         const void* w, const void* thr,
                                         void* err, long long B, int N, int F,
                                         int T, void* stream) {
  const size_t cells = (size_t)B * F * T;
  if (cells == 0) return 0;
  const size_t blocks = (cells + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffULL) return (int)cudaErrorInvalidConfiguration;
  stump_scan_batched_kernel<<<(unsigned)blocks, kThreads, 0,
                              (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (const float*)w, (const float*)thr,
      (float*)err, cells, N, F, T);
  return (int)cudaGetLastError();
}

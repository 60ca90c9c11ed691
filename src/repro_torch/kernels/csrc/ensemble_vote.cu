// ensemble_vote / ensemble_vote_batched: the weighted vote of an ensemble
// of generic weak learners over their precomputed margins.
//
//   out[b, n] = sum_t alpha[b, t] * m[b, t, n]          (t = 0 .. T-1, in order)
//
// Replaces the TPU kernels `ensemble_vote_batched_kernel` /
// `_batched_vote_kernel` and `ensemble_vote_kernel` / `_vote_kernel` in
// src/repro/kernels/ensemble_vote.py, which walked (block_t, block_n) tiles
// of the margins through VMEM with the output column block resident across
// a sequential t grid.  The batched kernel serves the generic-learner
// tenants of serve/engine.py; `ensemble_vote` is the same kernel at B = 1,
// under its own launcher.
//
// Bound on the H100: the bytes.  Each margin is read once and takes one
// multiply and one add, far below the card's ratio of operations to bytes,
// so the kernel is bound by reading the margins from HBM at large shapes and
// by the launch and the T-long dependent walk at the serving path's small
// ones.
//
// Design: one thread owns one (b, n) column, on a flat index over gridDim.x
// (gridDim.y stops at 65,535) with size_t offsets, and walks t in order, so
// a warp reads 32 consecutive floats of one row (coalesced) and the column's
// sum is taken in a fixed order with no reduction between threads and no
// atomics: the result is the same run to run.  Loads for kDepth rows are
// issued before any is used, so that many are in flight per thread.  The
// multiply and the add are rounded separately (no contraction into a fused
// multiply-add), as the plain version computes them.  Rows of zero alpha
// over zero margins (the batch's padding) add exactly zero.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;
constexpr int kDepth = 8;   // rows whose loads are in flight together

__global__ void __launch_bounds__(kThreads)
ensemble_vote_kernel(const float* __restrict__ margins,
                     const float* __restrict__ alphas,
                     float* __restrict__ out, size_t cols, int T, int N) {
  const size_t col = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (col >= cols) return;
  const size_t b = col / (size_t)N;
  const size_t n = col - b * (size_t)N;
  const float* m = margins + b * (size_t)T * N + n;
  const float* a_b = alphas + b * (size_t)T;
  float acc = 0.0f;
  for (int t0 = 0; t0 < T; t0 += kDepth) {
    float mv[kDepth], a[kDepth];
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const int t = t0 + k;
      const bool in = t < T;
      a[k] = in ? __ldg(a_b + t) : 0.0f;
      mv[k] = in ? m[(size_t)t * N] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      if (t0 + k < T) acc = __fadd_rn(acc, __fmul_rn(a[k], mv[k]));
    }
  }
  out[col] = acc;
}

int launch(const void* margins, const void* alphas, void* out, long long B,
           int T, int N, void* stream) {
  const size_t cols = (size_t)B * (size_t)N;
  if (cols == 0) return 0;
  const size_t blocks = (cols + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffULL) return (int)cudaErrorInvalidConfiguration;
  ensemble_vote_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const float*)margins, (const float*)alphas, (float*)out, cols, T, N);
  return (int)cudaGetLastError();
}

}  // namespace

// margins (B,T,N), alphas (B,T) -> out (B,N), all f32 and contiguous.
// Returns the CUDA error of the launch (0 on success).
extern "C" int ensemble_vote_batched_launch(const void* margins,
                                            const void* alphas, void* out,
                                            long long B, int T, int N,
                                            void* stream) {
  return launch(margins, alphas, out, B, T, N, stream);
}

// margins (T,N), alphas (T,) -> out (N,): the batched kernel at B = 1.
extern "C" int ensemble_vote_launch(const void* margins, const void* alphas,
                                    void* out, int T, int N, void* stream) {
  return launch(margins, alphas, out, 1, T, N, stream);
}

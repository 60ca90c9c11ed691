// stump_vote / stump_vote_fp: the stump-ensemble serving kernels.
//
//   out[b, n] = sum_t alpha[b, t] * pol[b, t] * sign((xsel[b, t, n] - thr[b, t]) + 1e-12)
//
// over the rows with alpha != 0, and, for the fingerprint variant, two
// uint32 lanes per column
//
//   fp_k[b, n] = XOR_t [ (bits(xsel[b, t, n]) ^ SALT_k) * (2 t + ODD_k) ]  (mod 2^32)
//
// over the same rows, t being the row's global index.
//
// Replaces the TPU kernels `stump_vote_batched_kernel` / `_stump_vote_kernel`
// and `stump_vote_fp_batched_kernel` / `_stump_vote_fp_kernel` in
// src/repro/kernels/ensemble_vote.py, which walked (block_t, block_n) tiles
// of xsel through VMEM with the output column block resident across a
// sequential t grid.
//
// Bound on the H100: the bytes.  Each xsel element is read once and takes a
// handful of operations, far below the card's ratio of operations to bytes,
// so the kernel is bound by reading xsel from HBM at large shapes and by the
// launch at the serving path's small ones.
//
// Design: one thread owns one (b, n) column and loops over t in order, so a
// warp reads 32 consecutive floats of one row (coalesced) and the column's
// sum is taken in a fixed order with no reduction between threads.  Loads
// for kDepth rows are issued before any is used, so that many are in
// flight per thread.  The per-row scalars (thr, pol, alpha) are the same
// for every thread of a block and come through the read-only cache.  Rows
// with alpha == 0 (the batch's T padding) are skipped, so they add nothing
// to the vote and the XOR identity to the lanes; the lanes are exact
// integers whatever the order.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kDepth = 8;   // rows whose loads are in flight together
constexpr uint32_t kSalt0 = 0x9E3779B9u;
constexpr uint32_t kSalt1 = 0x85EBCA6Bu;
constexpr uint32_t kOdd0 = 0x00010001u;
constexpr uint32_t kOdd1 = 0x00C2B2AFu;

__device__ __forceinline__ float stump_sign(float d) {
  return d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);
}

template <bool kFingerprint>
__global__ void __launch_bounds__(kThreads)
stump_vote_kernel(const float* __restrict__ xsel, const float* __restrict__ thr,
                  const float* __restrict__ pol, const float* __restrict__ alphas,
                  float* __restrict__ out, uint32_t* __restrict__ fp0,
                  uint32_t* __restrict__ fp1, int T, int N) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (n >= N) return;
  const float* col = xsel + (size_t)b * T * N + n;
  const float* thr_b = thr + (size_t)b * T;
  const float* pol_b = pol + (size_t)b * T;
  const float* a_b = alphas + (size_t)b * T;
  float acc = 0.0f;
  uint32_t f0 = 0u, f1 = 0u;
  for (int t0 = 0; t0 < T; t0 += kDepth) {
    // issue kDepth rows' loads before using any of them: the loop is bound
    // by load latency, not bandwidth, at the serving path's small N
    float xv[kDepth], th[kDepth], pl[kDepth], a[kDepth];
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const int t = t0 + k;
      const bool in = t < T;
      a[k] = in ? __ldg(a_b + t) : 0.0f;     // rows past T count as padding
      th[k] = in ? __ldg(thr_b + t) : 0.0f;
      pl[k] = in ? __ldg(pol_b + t) : 0.0f;
      xv[k] = in ? col[(size_t)t * N] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      if (a[k] != 0.0f) {
        const float d = __fadd_rn(__fsub_rn(xv[k], th[k]), 1e-12f);
        const float m = __fmul_rn(pl[k], stump_sign(d));
        acc = __fadd_rn(acc, __fmul_rn(a[k], m));
        if (kFingerprint) {
          const uint32_t bits = __float_as_uint(xv[k]);
          const uint32_t tt = (uint32_t)(t0 + k);
          f0 ^= (bits ^ kSalt0) * (2u * tt + kOdd0);
          f1 ^= (bits ^ kSalt1) * (2u * tt + kOdd1);
        }
      }
    }
  }
  const size_t o = (size_t)b * N + n;
  out[o] = acc;
  if (kFingerprint) {
    fp0[o] = f0;
    fp1[o] = f1;
  }
}

}  // namespace

// xsel (B,T,N), thr/pol/alphas (B,T) -> out (B,N), all f32 and contiguous.
extern "C" int stump_vote_launch(const void* xsel, const void* thr,
                                 const void* pol, const void* alphas,
                                 void* out, int B, int T, int N,
                                 void* stream) {
  dim3 grid((N + kThreads - 1) / kThreads, B);
  stump_vote_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)xsel, (const float*)thr, (const float*)pol,
      (const float*)alphas, (float*)out, nullptr, nullptr, T, N);
  return (int)cudaGetLastError();
}

// As stump_vote_launch, plus the lanes fp0/fp1 (B,N), 32 bits each.
extern "C" int stump_vote_fp_launch(const void* xsel, const void* thr,
                                    const void* pol, const void* alphas,
                                    void* out, void* fp0, void* fp1, int B,
                                    int T, int N, void* stream) {
  dim3 grid((N + kThreads - 1) / kThreads, B);
  stump_vote_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)xsel, (const float*)thr, (const float*)pol,
      (const float*)alphas, (float*)out, (uint32_t*)fp0, (uint32_t*)fp1, T, N);
  return (int)cudaGetLastError();
}

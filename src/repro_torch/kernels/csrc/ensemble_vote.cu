// ensemble_vote / ensemble_vote_batched: the weighted vote of an ensemble
// of generic weak learners over their precomputed margins.
//
//   out[b, n] = sum_t alpha[b, t] * m[b, t, n]
//
// Replaces two TPU kernels of src/repro/kernels/ensemble_vote.py:
// `ensemble_vote_kernel` (:48, `_vote_kernel`, pallas_call at :57) and
// `ensemble_vote_batched_kernel` (:88, `_batched_vote_kernel`, pallas_call
// at :97).  Both walked (block_t, block_n) tiles of the margins through
// VMEM with the output column block resident across a sequential t grid.
// The batched kernel serves the generic-learner tenants of serve/engine.py;
// `ensemble_vote` is the same kernel at B = 1, under its own launcher.
//
// Bound on the H100: the bytes.  Each margin is read once and takes one
// multiply and one add, far below the card's ratio of operations to bytes.
// By Little's law a stream at the card's 3.35 TB/s with about 1 us per
// load under load needs some 3-4 MB of loads in flight.  The design before
// this one gave each output column one thread that walked all T rows with
// eight 4-byte loads in flight: 256-512 blocks of 128 threads held 1-2 MB
// in flight at the large shapes (1.0-1.9 TB/s), and at the serving path's
// shapes, whose columns fill one or a few SMs, a thread made T/8 dependent
// rounds of loads (38 at T = 300).
//
// Design:
// - A tile is kCols = 128 consecutive columns of one b.  Each lane of a
//   warp loads four of them a row: one 16-byte load (`ld.global.nc.v4`)
//   where N % 4 == 0 and the margins are 16-byte aligned (every row then
//   is), else four 4-byte loads of columns lane + 32 j.  The arithmetic of
//   a column is the same on both routes.
// - T is cut into chunks of kRows = 32 rows; a stage is kWarps = 8
//   consecutive chunks, one a warp of a 256-thread block.  A warp sums its
//   chunk's rows in t order, issuing the loads of 16 rows (8 on the
//   scalar route) before it adds any: a chunk is two dependent rounds of
//   loads.  At 2 blocks an SM (128 registers a thread at most) that is
//   128 KB in flight an SM, some 17 MB on the card.  A grid of at most
//   one block an SM (the serving path's) loads the whole chunk in one
//   round instead ("deep", up to 255 registers).  The stage's partial
//   is a fixed tree over its 8 chunk sums, through shared memory:
//   ((c0 + c1) + (c2 + c3)) + ((c4 + c5) + (c6 + c7)).  A column's result
//   is its stage partials summed in stage order from zero:
//   acc = acc + P_s, s = 0, 1, ....  Chunks and rows past T add nothing.
// - One block a tile walks all of its tile's stages and adds their
//   partials into the column's result itself: one launch, no workspace.
//   The launcher loads a whole chunk in one round where the tiles are at
//   most one block an SM, and half a chunk at two blocks an SM otherwise.
// - So a column's result is a fixed function of its own alphas and
//   margins: the same bits whatever B, N, zero padding in T or N, load
//   route or load depth, and run to run.  No atomics.  Zero-alpha rows
//   over zero margins add exactly zero.
// - Arithmetic: the multiply and the add are rounded separately
//   (__fmul_rn, __fadd_rn: no fused multiply-add), as the plain version
//   and the CPU emulation `ref.vote_in_kernel_order` compute them.
// - Blocks are flat over gridDim.x (gridDim.y stops at 65,535), offsets
//   in size_t.  kWarps and kRows are mirrored by the CPU emulation of the
//   order in `kernels/ref.py` (VOTE_ROWS, VOTE_WARPS).
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kLanes = 32;
constexpr int kWarps = 8;                    // chunks a stage, one a warp
constexpr int kRows = 32;                    // rows a chunk
constexpr int kStageRows = kWarps * kRows;   // 256
constexpr int kCols = 4 * kLanes;            // columns a tile
constexpr int kThreads = kWarps * kLanes;    // 256

// Rows a warp has in flight: 16-byte loads a lane on the vector route,
// 4 x 4 bytes on the scalar one.  A grid that fills the card runs 2
// blocks an SM (128 registers a thread) with half a chunk in flight; one
// that leaves SMs idle runs the whole chunk in one round.
template <bool kVec, bool kDeep>
__host__ __device__ constexpr int depth() {
  return (kDeep ? 32 : 16) / (kVec ? 1 : 2);
}

// The four margins of row `row` that this lane sums: columns
// n0 + 4 lane + j on the vector route, n0 + lane + 32 j on the scalar one.
template <bool kVec>
__device__ __forceinline__ float4 load_row(const float* row, int n0,
                                           int lane, int N) {
  if (kVec) {
    const int n = n0 + 4 * lane;
    return n < N ? __ldg(reinterpret_cast<const float4*>(row + n))
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  const int n = n0 + lane;
  return make_float4(n < N ? __ldg(row + n) : 0.0f,
                     n + 32 < N ? __ldg(row + n + 32) : 0.0f,
                     n + 64 < N ? __ldg(row + n + 64) : 0.0f,
                     n + 96 < N ? __ldg(row + n + 96) : 0.0f);
}

template <bool kVec, bool kDeep>
__global__ void __launch_bounds__(kThreads, kDeep ? 1 : 2)
ensemble_vote_kernel(const float* __restrict__ margins,
                     const float* __restrict__ alphas,
                     float* __restrict__ out, int T, int N, int tiles) {
  __shared__ __align__(16) float part[2][kWarps][kCols];
  const int n0 = (int)(blockIdx.x % (unsigned)tiles) * kCols;
  const size_t b = blockIdx.x / (unsigned)tiles;
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int col = n0 + threadIdx.x;      // the column a thread < kCols owns
  const float* m_b = margins + b * (size_t)T * N;
  const float* a_b = alphas + b * (size_t)T;
  const int S = (T + kStageRows - 1) / kStageRows;
  constexpr int kDepth = depth<kVec, kDeep>();
  float acc = 0.0f;
  for (int s = 0; s < S; ++s) {
    const int t0 = s * kStageRows + warp * kRows;
    float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;   // the chunk sums
#pragma unroll
    for (int r = 0; r < kRows; r += kDepth) {
      float4 v[kDepth];
      float a[kDepth];
#pragma unroll
      for (int k = 0; k < kDepth; ++k) {
        const int t = t0 + r + k;
        const bool in = t < T;
        a[k] = in ? __ldg(a_b + t) : 0.0f;
        v[k] = in ? load_row<kVec>(m_b + (size_t)t * N, n0, lane, N)
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int k = 0; k < kDepth; ++k) {
        if (t0 + r + k < T) {
          c0 = __fadd_rn(c0, __fmul_rn(a[k], v[k].x));
          c1 = __fadd_rn(c1, __fmul_rn(a[k], v[k].y));
          c2 = __fadd_rn(c2, __fmul_rn(a[k], v[k].z));
          c3 = __fadd_rn(c3, __fmul_rn(a[k], v[k].w));
        }
      }
    }
    // two buffers: a stage's writes never meet the previous stage's reads
    float* p = part[s & 1][warp];
    if (kVec) {
      reinterpret_cast<float4*>(p)[lane] = make_float4(c0, c1, c2, c3);
    } else {
      p[lane] = c0;
      p[lane + 32] = c1;
      p[lane + 64] = c2;
      p[lane + 96] = c3;
    }
    __syncthreads();
    if (threadIdx.x < kCols) {
      float q[kWarps];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) q[w] = part[s & 1][w][threadIdx.x];
#pragma unroll
      for (int width = kWarps / 2; width >= 1; width /= 2) {
#pragma unroll
        for (int i = 0; i < width; ++i)
          q[i] = __fadd_rn(q[2 * i], q[2 * i + 1]);
      }
      acc = __fadd_rn(acc, q[0]);
    }
  }
  if (threadIdx.x < kCols && col < N)
    out[b * (size_t)N + col] = acc;
}

int launch(const void* margins, const void* alphas, void* out, long long B,
           int T, int N, void* stream) {
  if (B < 0 || T < 0 || N < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return 0;
  const long long tiles = (N + kCols - 1) / kCols;
  if (B * tiles > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const bool vec = N % 4 == 0 && ((uintptr_t)margins & 15) == 0;
  const bool deep = B * tiles <= sms;
  auto kernel = vec ? (deep ? ensemble_vote_kernel<true, true>
                            : ensemble_vote_kernel<true, false>)
                    : (deep ? ensemble_vote_kernel<false, true>
                            : ensemble_vote_kernel<false, false>);
  kernel<<<(unsigned)(B * tiles), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)margins, (const float*)alphas, (float*)out, T, N,
      (int)tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// margins (B,T,N), alphas (B,T) -> out (B,N), all f32 and contiguous, on
// the current device.  Returns the CUDA error of the launch (0 on success).
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

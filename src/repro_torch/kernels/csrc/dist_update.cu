// dist_update: the AdaBoost sample-distribution update (paper eq. 4).
//
//   w[i] = D[i] * exp((-alpha * y[i]) * h[i])       (f32, in this order)
//   Z    = sum_i w[i]
//   D'[i] = w[i] / (Z + 1e-30)
//
// Replaces the TPU kernel `dist_update_kernel` / `_dist_update_kernel` in
// src/repro/kernels/dist_update.py (:44, :27; pallas_call at :52), which
// computed w and carried Z in a scalar block revisited across a sequential
// grid (the TPU's grid runs in order on one core), with the division left
// to its wrapper.  Here the division stays in the kernel.
//
// Bound on the H100: the bytes.  Each sample takes one exp and a few
// multiplies and adds against 16 bytes of traffic (D, y, h read once, D'
// written once), far below the card's ratio of operations to bytes.  At
// the kernel API path's N = 8,192 the bytes bound is far under the launch
// floor: there the time is the launch and the chain of a load, a reduction
// across blocks and a store.
//
// Design: one launch a call, w kept on chip across one barrier, one Z.
// - Loads and stores stream (evict-first): each byte is touched once.
// - The samples are float4 vectors v = i / 4 (16-byte loads and stores
//   where D, y, h and D' are 16-byte aligned, else 4-byte ones; the
//   ragged last vector always 4-byte).  Block b takes `tile` consecutive
//   vectors; its thread t takes the block's vectors t, t + threads, ...
//   It computes w, keeps the first `held` vectors of the tile in dynamic
//   shared memory and adds its samples to an f64 sum in order.
// - A block's sum: the fixed tree of a warp (lanes xor 16, 8, 4, 2, 1),
//   then the same tree over its warps' sums, padded with zeros to 32.
// - The blocks' sums, p[0..G), meet across a barrier, and every warp of
//   every block adds them in one order: lane l sums p[l], p[l + 32], ...
//   from zero, then the warp's tree.  So every block holds the same f64 Z,
//   rounded once to f32, and Z is the same run to run.  No atomics.
//   `ref.dist_update_in_kernel_order` replays this order on the CPU.
// - Two routes, one kernel (`ops.dist_split` picks the route and the grid
//   from N and the SM count):
//   * cluster: at most 8 blocks in one thread-block cluster; each block
//     stores its sum into every block's shared memory (distributed shared
//     memory), then one cluster barrier; no global scratch.  The barrier
//     that makes sure every block has started before those stores is
//     arrived at before the loads and waited for after them, so its
//     latency hides under theirs.
//   * grid: one block an SM, launched cooperatively so that every block is
//     resident; the block sums go through f64 scratch in global memory and
//     `grid.sync()`.  A grid that cannot be co-resident is refused by the
//     launch with its CUDA error; it never hangs.  Where a block's tile
//     exceeds what its shared memory holds (kMaxHeld vectors), the rest of
//     w is computed again after the barrier from D, y and h, with the
//     same instructions and so the same bits.
// - What bounds the large shapes: the call is two streams split by the
//   barrier, the reads (12 bytes a sample) and then the writes (4); D'
//   needs all of Z, so neither overlaps the other.  Loads staged through
//   cp.async, more threads or blocks an SM, more loads in flight, a
//   grid-stride layout and a 16-block cluster were each timed on the card
//   and were no faster.
// Built without fast math: expf is the accurate one (2 ulp), every
// multiply is rounded on its own (__fmul_rn, no contraction) and the
// division is correctly rounded, as on the CPU.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 8;       // the portable cluster size
constexpr int kMaxHeld = 14336;      // float4 a block keeps: 224 KB
// whole vectors a thread loads at once: two on the grid route (one block
// of 512 threads an SM; more threads or more in flight measured slower);
// on the cluster route a thread has one vector
constexpr int kBatch = 2;

__device__ __forceinline__ float weight(float na, float d, float y, float h) {
  return __fmul_rn(d, expf(__fmul_rn(__fmul_rn(na, y), h)));
}

// D, y and h of one whole vector v (samples 4v .. 4v + 3 < n)
struct Inputs {
  float4 d, y, h;
};

template <bool kVec>
__device__ __forceinline__ Inputs load(const float* __restrict__ D,
                                       const float* __restrict__ y,
                                       const float* __restrict__ h,
                                       long long v) {
  if (kVec)
    return {__ldcs(reinterpret_cast<const float4*>(D) + v),
            __ldcs(reinterpret_cast<const float4*>(y) + v),
            __ldcs(reinterpret_cast<const float4*>(h) + v)};
  const long long i = 4 * v;
  return {make_float4(__ldg(D + i), __ldg(D + i + 1), __ldg(D + i + 2),
                      __ldg(D + i + 3)),
          make_float4(__ldg(y + i), __ldg(y + i + 1), __ldg(y + i + 2),
                      __ldg(y + i + 3)),
          make_float4(__ldg(h + i), __ldg(h + i + 1), __ldg(h + i + 2),
                      __ldg(h + i + 3))};
}

__device__ __forceinline__ float4 weigh(float na, const Inputs& r) {
  return make_float4(weight(na, r.d.x, r.y.x, r.h.x),
                     weight(na, r.d.y, r.y.y, r.h.y),
                     weight(na, r.d.z, r.y.z, r.h.z),
                     weight(na, r.d.w, r.y.w, r.h.w));
}

// w of the last vector v where n % 4 != 0; samples past n give 0
__device__ __forceinline__ float4 ragged(float na, const float* __restrict__ D,
                                         const float* __restrict__ y,
                                         const float* __restrict__ h,
                                         long long n, long long v) {
  const long long i = 4 * v;
  float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
  w.x = weight(na, D[i], y[i], h[i]);
  if (i + 1 < n) w.y = weight(na, D[i + 1], y[i + 1], h[i + 1]);
  if (i + 2 < n) w.z = weight(na, D[i + 2], y[i + 2], h[i + 2]);
  return w;
}

template <bool kVec>
__device__ __forceinline__ void store(float* __restrict__ out, long long n,
                                      long long v, float4 q) {
  const long long i = 4 * v;
  if (kVec && i + 4 <= n) {
    __stcs(reinterpret_cast<float4*>(out) + v, q);
    return;
  }
  if (i < n) out[i] = q.x;
  if (i + 1 < n) out[i + 1] = q.y;
  if (i + 2 < n) out[i + 2] = q.z;
  if (i + 3 < n) out[i + 3] = q.w;
}

// the warp's fixed tree; every lane gets the same sum
__device__ __forceinline__ double warp_fold(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <bool kCluster, bool kVec>
__global__ void __launch_bounds__(kMaxThreads, 1)
dist_update_kernel(const float* __restrict__ alpha, float alpha_value,
                   const float* __restrict__ D, const float* __restrict__ y,
                   const float* __restrict__ h, float* __restrict__ out,
                   float* __restrict__ z, double* __restrict__ partials,
                   long long n, int tile, int held) {
  extern __shared__ float4 kept[];
  __shared__ double warp_sums[32];
  __shared__ double block_sums[kMaxCluster];   // the cluster's, pushed here
  const float na = -(alpha != nullptr ? *alpha : alpha_value);
  const int lane = threadIdx.x & 31;
  const long long first = (long long)blockIdx.x * tile;
  const long long left = (n + 3) / 4 - first;
  const int mine = left <= 0 ? 0 : left < tile ? (int)left : tile;

  // the block's whole vectors; the ragged last one (n % 4 != 0), if this
  // block holds it, is its vector `whole` and its owner's last
  const int whole = (int)max(0LL, min((long long)mine, n / 4 - first));
  constexpr int batch = kCluster ? 1 : kBatch;
  double acc = 0.0;
  if constexpr (kCluster)   // started: waited for before any remote store
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  for (int base = threadIdx.x; base < whole; base += batch * blockDim.x) {
    Inputs r[batch];
#pragma unroll
    for (int u = 0; u < batch; ++u) {
      const int lv = base + u * blockDim.x;
      if (lv < whole) r[u] = load<kVec>(D, y, h, first + lv);
    }
#pragma unroll
    for (int u = 0; u < batch; ++u) {
      const int lv = base + u * blockDim.x;
      if (lv < whole) {
        const float4 w = weigh(na, r[u]);
        if (lv < held) kept[lv] = w;
        acc += (double)w.x;
        acc += (double)w.y;
        acc += (double)w.z;
        acc += (double)w.w;
      }
    }
  }
  if (whole < mine && threadIdx.x == whole % blockDim.x) {
    const float4 w = ragged(na, D, y, h, n, first + whole);
    if (whole < held) kept[whole] = w;
    acc += (double)w.x;
    acc += (double)w.y;
    acc += (double)w.z;
    acc += (double)w.w;
  }
  acc = warp_fold(acc);
  if (lane == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  const double part =
      warp_fold(lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0.0);

  double total = 0.0;
  if constexpr (kCluster) {
    // every block of the cluster has started: thread r stores this
    // block's sum into block r's slot; after the barrier each block reads
    // only its own shared memory, so none waits to leave
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    if (threadIdx.x < gridDim.x)
      *cg::this_cluster().map_shared_rank(&block_sums[blockIdx.x],
                                          (int)threadIdx.x) = part;
    cg::this_cluster().sync();
    for (int r = lane; r < (int)gridDim.x; r += 32) total += block_sums[r];
    total = warp_fold(total);
  } else {
    if (threadIdx.x == 0) {
      partials[blockIdx.x] = part;
      __threadfence();
    }
    cg::this_grid().sync();
    for (int r = lane; r < (int)gridDim.x; r += 32)
      total += __ldcg(partials + r);
    total = warp_fold(total);
  }
  const float zf = __double2float_rn(total);
  if (blockIdx.x == 0 && threadIdx.x == 0) z[0] = zf;
  const float denom = __fadd_rn(zf, 1e-30f);

  for (int lv = threadIdx.x; lv < mine; lv += blockDim.x) {
    const float4 w =
        lv < held ? kept[lv]
        : lv < whole ? weigh(na, load<kVec>(D, y, h, first + lv))
                     : ragged(na, D, y, h, n, first + lv);
    store<kVec>(out, n, first + lv,
                make_float4(__fdiv_rn(w.x, denom), __fdiv_rn(w.y, denom),
                            __fdiv_rn(w.z, denom), __fdiv_rn(w.w, denom)));
  }
}

template <bool kCluster, bool kVec>
int launch(const float* alpha, float alpha_value, const float* D,
           const float* y, const float* h, float* out, float* z,
           double* partials, long long n, int blocks, int threads, int tile,
           int held, cudaStream_t stream) {
  auto kernel = dist_update_kernel<kCluster, kVec>;
  // above 48 KB a block's shared memory must be asked for, once a device
  static std::atomic<unsigned long long> asked{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !(asked.load() >> dev & 1)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxHeld * (int)sizeof(float4));
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) asked.fetch_or(1ull << dev);
  }
  cudaLaunchAttribute attr[1];
  if (kCluster) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
  } else {
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)held * sizeof(float4);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, alpha, alpha_value, D, y, h, out, z,
                           partials, n, tile, held);
  if (err != cudaSuccess) cudaGetLastError();   // not left for the next call
  return (int)err;
}

}  // namespace

// alpha: a device pointer to one f32, or null to take alpha_value; D, y, h
// (n,) -> out (n,) = D', z (1,) = Z, all f32 on one device.  The split
// (ops.dist_split): `blocks` blocks of `threads` threads (a power of two,
// 32..1024), `tile` float4 vectors a block (blocks * tile * 4 >= n), the
// first `held` (<= tile, <= 14336) kept in shared memory; one cluster
// (cluster = 1, blocks <= 8) or a cooperative grid (cluster = 0) with
// `partials` holding `blocks` doubles of scratch.  One launch on `stream`;
// returns its CUDA error (0 on success): 720 for a grid that cannot be
// co-resident.
extern "C" int dist_update_launch(const void* alpha, float alpha_value,
                                  const void* D, const void* y, const void* h,
                                  void* out, void* z, void* partials,
                                  long long n, int cluster, int blocks,
                                  int threads, int tile, int held,
                                  void* stream) {
  if (n <= 0) return 0;
  if (blocks < 1 || tile < 1 || held < 0 || held > tile ||
      held > kMaxHeld || threads < 32 || threads > kMaxThreads ||
      (threads & (threads - 1)) != 0 || (long long)blocks * tile * 4 < n ||
      (cluster ? blocks > kMaxCluster : partials == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool vec = ((reinterpret_cast<uintptr_t>(D) |
                     reinterpret_cast<uintptr_t>(y) |
                     reinterpret_cast<uintptr_t>(h) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* a = (const float*)alpha;
#define DIST_LAUNCH(C, V)                                                    \
  return launch<C, V>(a, alpha_value, (const float*)D, (const float*)y,    \
                      (const float*)h, (float*)out, (float*)z,             \
                      (double*)partials, n, blocks, threads, tile, held, s)
  if (cluster) {
    if (vec) DIST_LAUNCH(true, true);
    DIST_LAUNCH(true, false);
  }
  if (vec) DIST_LAUNCH(false, true);
  DIST_LAUNCH(false, false);
#undef DIST_LAUNCH
}

// stump_scan / stump_scan_batched: weighted error of every polarity-(+1)
// decision stump, for one client shard or for every slot of a fleet batch.
//
//   err[b, f, t] = sum_n w[b, n] * [ (x[b, n, f] > thr[b, f, t] ? +1 : -1) != y[b, n] ]
//
// Replaces the TPU kernel `stump_scan_kernel` (src/repro/kernels/stump_scan.py:41,
// `_stump_kernel`, pallas_call at :50), which streamed (block_n, F) sample
// tiles through VMEM and kept the whole (F, T) error tile resident across a
// sequential grid, and `_pallas_stump_scan_batched`
// (src/repro/kernels/dispatch.py:245), a `vmap` of it over a fleet batch.
// `stump_scan` fits one stump (models/weak.py:fit_stump, B = 1);
// `stump_scan_batched` fits a wave of the fleet profile (core/fleet.py), up
// to 100,000 client shards of a few rows each, and every client of
// fed_mesh's step (core/fed_mesh.py), a few shards of many rows.
//
// Every sum is taken in f64 and rounded once to f32, as the plain versions
// (kernels/ref.py) do: errors that tie in exact arithmetic tie on every
// device, and the stump pick settles them by index.  No atomics.
//
// The row walk, shared by both kernels: a thread owns up to kChunk = 16
// consecutive thresholds of one (b, f) row, in registers, with 16 f64
// accumulators.  It walks its rows in order: one x[b, n, f] load a row
// (neighbouring threads take neighbouring f), y and w as broadcast loads,
// each group of kDepth rows loaded before the previous group's compares.
// A cell costs two instructions a row: `set` folds the compare with y's
// sign into 1.0f or 0.0f, and one fma adds w or w * 0 (add_if_miss; the
// compiler's own code for `if (miss) acc += w` spells the test out in
// integers, adds unconditionally and selects each half of the sum).
// Thresholds are read, and errors written, with 16-byte accesses where
// T % 4 == 0 and the pointers are 16-byte aligned (the wrapper picks the
// route), else with 4-byte ones.  T > 16 walks the rows once for each
// further chunk of 16.
//
// stump_scan_batched, two routes, one launch each; kernels/ops.py:
// scan_batched_split picks one from (B, N, F, T) and the SM count.
// - One thread a (b, f) row, flat over gridDim.x (B reaches 100,000;
//   gridDim.y stops at 65,535), blocks of 64 threads, rows walked in
//   order, so the kernel gives the plain version's bits
//   (ref.stump_scan_batched_ref).  Taken wherever its blocks reach every
//   SM or a slot has few rows.  Bound on the H100: at the fleet's wave
//   (100,000, 4, 48, 16) the bytes (thresholds read and errors written,
//   307 MB each; 694 MB in all); at large shards (4096, 333, 64, 16) the
//   bytes (394 MB, mostly x), with the FP64 pipe (1.4 G fmas, 64 an SM a
//   clock) and the issue of two instructions a cell close behind.  The
//   design before this one gave each output cell a thread: one 4-byte
//   threshold load in flight a thread (8 KB an SM, where Little's law
//   asks for some 25 KB), two 64-bit divisions before it, and at large N
//   three loads a row a cell.  Here a thread keeps 64 bytes of thresholds
//   in flight from its first instruction, makes one 32-bit division, and
//   loads x once a row for 16 cells, 8 rows ahead at large N.
// - The split (stump_scan_batched_kernel_split), where B * F leaves SMs
//   idle and N is long: fed_mesh's ten covtype shards, (10, 43575, 54,
//   16), gave the row route 540 threads, 9 blocks of 64 on 132 SMs, each
//   thread a chain of 43,575 rows (5.05 ms).  Each slot's rows are split
//   as stump_scan's are (below), and a column group's G <= 8 blocks form
//   one thread-block cluster that adds its block sums in distributed
//   shared memory inside the launch: one kernel a call, no second pass,
//   no scratch.  Bound on the H100 at that shape: the bytes (97.7 MB,
//   29.2 us), with the FP64 fmas (377 M, 23 us at 1.98 GHz) and the issue
//   of two instructions a cell close behind.  What the design does about
//   it: a slot's column groups go to the SMs together, so the 32-byte
//   pieces of a 216-byte row that neighbouring groups read share their
//   sectors through L2 and x comes from HBM about once; the grid is one
//   wave where it can be (3 blocks a group, 210 blocks of 256 threads at
//   two an SM).  It runs at 0.093 ms, 31% of the bound: a thread walks a
//   chunk of 454 rows with 16 f64 accumulators at the cap of 128
//   registers (12 bytes spilled), two blocks an SM, and loads 4 rows
//   ahead do not cover the latency at 16 warps an SM.  8 rows ahead
//   spill more: 12% faster at this shape, up to 4% slower at the picks
//   for four others.  A cooperative grid in place of the cluster (block
//   sums through global scratch and grid.sync()) gave the same bits and
//   ran 1.3% slower (0.0943 against 0.0931 ms).
//   ref.scan_batched_in_kernel_order emulates its order on the CPU.
//
// stump_scan: B = 1 gives only F rows of thresholds (64 on the path), far
// too few threads for 132 SMs, so the rows are split too: chunks of `rows`
// consecutive rows, `chunks` a column, each walked in order by one thread
// into its own accumulators.  A block holds `cols` consecutive features
// and kb = 256 / cols consecutive chunks of each; its sum of a cell is a
// fixed tree over its kb chunk sums, through shared memory ([cell][chunk])
// and, for kb >= 16, kb / 16 lanes a cell.  Where one block a column group
// leaves its chunks at most a few rows (the path's 333-row shard: 64
// blocks of chunks of 2 rows), that is the whole sum: one launch.  Else
// (large N) a column group takes G blocks, two blocks an SM over the grid,
// and a second kernel adds the G block sums as a pairwise tree, a warp a
// cell; no atomics, and no thread block cluster (its launch and barrier
// took longer than the second pass at (24000, 64, 16) on the H100).
// ref.scan_in_kernel_order emulates the order on the CPU.  The split is
// picked in Python (kernels/ops.py:scan_split) from the shape and the SM
// count.  Bound on the H100: at
// (333, 64, 16) the launch itself (86 KB, 0.03 us of bytes); at (24000,
// 64, 16) the bytes (6.2 MB) and the FP64 pipe (24.6 M fmas), about 2 us
// each.  The design before this one ran one block per feature (64 blocks:
// 68 SMs idle at large N) with 16 shuffle trees a chunk of 16 thresholds.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;     // a block of stump_scan_kernel
// a block of stump_scan_batched_kernel: small blocks keep every SM busy to
// the end of a wave
constexpr int kBatchThreads = 64;
constexpr int kChunk = 16;        // thresholds a thread
// kDepth, the rows of a group of loads: the launchers take 8 for a fleet
// batch's long walks (N >= 32, 16-byte route), 2 for one slot's chunks in
// one pass (a few rows each) and 4 otherwise
constexpr int kMinBlocks = 2;     // blocks an SM: at most 128 registers
constexpr int kMaxPerLane = 16;   // block sums a lane of the second pass
// the split route of stump_scan_batched: blocks a column group (one
// cluster; the portable cluster size) and the widest block, whose shared
// memory (tree and cluster sums) stays under 48 KB
constexpr int kMaxCluster = 8;
constexpr int kSplitMaxCols = 64;
// gridDim.y's limit: the split's (slot, chunk of 16 thresholds) pairs
constexpr int kMaxGridY = 65535;

// thresholds [0, tc) of a chunk into th (the rest are never compared)
template <bool kVec>
__device__ __forceinline__ void load_thresholds(const float* __restrict__ p,
                                                int tc, float (&th)[kChunk]) {
  if (kVec) {
#pragma unroll
    for (int q = 0; q < kChunk / 4; ++q) {
      const float4 v = 4 * q < tc
                           ? __ldg(reinterpret_cast<const float4*>(p) + q)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      th[4 * q] = v.x;
      th[4 * q + 1] = v.y;
      th[4 * q + 2] = v.z;
      th[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) th[k] = k < tc ? __ldg(p + k) : 0.0f;
  }
}

template <bool kVec>
__device__ __forceinline__ void store_errors(float* __restrict__ p, int tc,
                                             const double (&acc)[kChunk]) {
  if (kVec) {
#pragma unroll
    for (int q = 0; q < kChunk / 4; ++q) {
      if (4 * q < tc)
        reinterpret_cast<float4*>(p)[q] = make_float4(
            __double2float_rn(acc[4 * q]), __double2float_rn(acc[4 * q + 1]),
            __double2float_rn(acc[4 * q + 2]),
            __double2float_rn(acc[4 * q + 3]));
    }
  } else {
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      if (k < tc) p[k] = __double2float_rn(acc[k]);
  }
}

// acc += w * miss, miss in {0, 1}: the stump predicts +1 where x > thr,
// else -1, and for y in {+1, -1} it misses exactly where (x > thr)
// differs from (y == +1).  `set` folds the compare with y's sign into one
// instruction that writes 1.0f or 0.0f; that word as the high half of a
// double is 2^-7 or +0.0, so one fma of w * 2^7 (`w128`, exact) adds w or
// w * 0 (+-0, as the plain versions' product does): two instructions a
// cell.
__device__ __forceinline__ void add_if_miss(double& acc, float xv, float th,
                                            unsigned ypos, double w128) {
  asm("{\n\t"
      ".reg .pred py;\n\t"
      ".reg .b32 m, z;\n\t"
      ".reg .f64 md;\n\t"
      "setp.ne.u32 py, %4, 0;\n\t"
      "set.gt.xor.f32.f32 m, %1, %2, py;\n\t"
      "mov.b32 z, 0;\n\t"
      "mov.b64 md, {z, m};\n\t"
      "fma.rn.f64 %0, %3, md, %0;\n\t"
      "}"
      : "+d"(acc)
      : "f"(xv), "f"(th), "d"(w128), "r"(ypos));
}

// One row into the accumulators.  kFull: all 16 thresholds live.
template <bool kFull>
__device__ __forceinline__ void add_row(float xv, float yv, double wv, int tc,
                                        const float (&th)[kChunk],
                                        double (&acc)[kChunk]) {
  if (yv == 1.0f || yv == -1.0f) {
    const unsigned ypos = yv == 1.0f;
    const double w128 = wv * 128.0;
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      if (kFull || k < tc) add_if_miss(acc[k], xv, th[k], ypos, w128);
  } else {      // any other y: both predictions miss it
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      if (kFull || k < tc) acc[k] += wv;
  }
}

// Rows [n0, n1) of one column in order; xcol points at x[0, f] of the slot,
// F floats a row.  Rows go in groups of kDepth: a group's loads are all
// issued before its compares, and the next group's before this group's
// compares; while both groups are whole no load or compare is masked.
template <bool kFull, int kDepth>
__device__ __forceinline__ void walk_rows(const float* __restrict__ xcol,
                                          int F, const float* __restrict__ y,
                                          const float* __restrict__ w, int n0,
                                          int n1, int tc,
                                          const float (&th)[kChunk],
                                          double (&acc)[kChunk]) {
  float xv[kDepth], yv[kDepth], wv[kDepth];
  float xn[kDepth], yn[kDepth], wn[kDepth];
#pragma unroll
  for (int i = 0; i < kDepth; ++i) {
    const bool in = n0 + i < n1;
    xv[i] = in ? __ldg(xcol + (size_t)(n0 + i) * F) : 0.0f;
    yv[i] = in ? __ldg(y + n0 + i) : 0.0f;
    wv[i] = in ? __ldg(w + n0 + i) : 0.0f;
  }
  int n = n0;
  for (; n + 2 * kDepth <= n1; n += kDepth) {
    const float* xp = xcol + (size_t)(n + kDepth) * F;
#pragma unroll
    for (int i = 0; i < kDepth; ++i) {
      xn[i] = __ldg(xp + (size_t)i * F);
      yn[i] = __ldg(y + n + kDepth + i);
      wn[i] = __ldg(w + n + kDepth + i);
    }
#pragma unroll
    for (int i = 0; i < kDepth; ++i)
      add_row<kFull>(xv[i], yv[i], (double)wv[i], tc, th, acc);
#pragma unroll
    for (int i = 0; i < kDepth; ++i) {
      xv[i] = xn[i];
      yv[i] = yn[i];
      wv[i] = wn[i];
    }
  }
  // the last one or two groups, either of them short
  for (; n < n1; n += kDepth) {
#pragma unroll
    for (int i = 0; i < kDepth; ++i) {
      const int m = n + kDepth + i;
      const bool in = m < n1;
      xn[i] = in ? __ldg(xcol + (size_t)m * F) : 0.0f;
      yn[i] = in ? __ldg(y + m) : 0.0f;
      wn[i] = in ? __ldg(w + m) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kDepth; ++i)
      if (n + i < n1) add_row<kFull>(xv[i], yv[i], (double)wv[i], tc, th, acc);
#pragma unroll
    for (int i = 0; i < kDepth; ++i) {
      xv[i] = xn[i];
      yv[i] = yn[i];
      wv[i] = wn[i];
    }
  }
}

template <int kDepth>
__device__ __forceinline__ void walk(const float* xcol, int F, const float* y,
                                     const float* w, int n0, int n1, int tc,
                                     const float (&th)[kChunk],
                                     double (&acc)[kChunk]) {
  if (tc == kChunk)
    walk_rows<true, kDepth>(xcol, F, y, w, n0, n1, tc, th, acc);
  else
    walk_rows<false, kDepth>(xcol, F, y, w, n0, n1, tc, th, acc);
}

// A block's sum of each of its cells (c = t * cols + j, cols * 16 of
// them) over its kb chunks, thread k * cols + j holding chunk k's sums in
// acc: the chunks' sums to shared memory, [cell][k] with rows padded to S
// doubles, then a cell's chunks as a grid of I rows of R (chunk i * R + q;
// R = kb / 16 lanes a cell where kb >= 16, else 1): a pairwise tree over i
// in one thread (zeros past I add nothing), then over q across the R
// lanes.  emit(c, sum) runs once a cell, in the thread that holds it.
template <typename Emit>
__device__ __forceinline__ void block_sums(double* part,
                                           const double (&acc)[kChunk],
                                           int kb, int cols, int k, int j,
                                           Emit emit) {
  const int cells = cols * kChunk;
  const int S = kb >= 16 ? kb + 1 : kb;
#pragma unroll
  for (int t = 0; t < kChunk; ++t) part[(t * cols + j) * S + k] = acc[t];
  __syncthreads();
  const int R = kb >= 16 ? kb / 16 : 1;
  const int I = kb / R;
  for (int base = 0; base < cells * R; base += kThreads) {
    const int id = base + (int)threadIdx.x;
    const int c = id / R;
    const int q = id - c * R;
    double v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      v[i] = i < I && c < cells ? part[c * S + i * R + q] : 0.0;
#pragma unroll
    for (int h = 1; h < 16; h <<= 1) {
#pragma unroll
      for (int i = 0; i + h < 16; i += 2 * h) v[i] += v[i + h];
    }
    double sum = v[0];
    for (int m = 1; m < R; m <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, m);
    if (q == 0 && c < cells) emit(c, sum);
  }
}

// One thread a (b, f) row of thresholds: i = b * F + f over the flat grid.
template <bool kVec, int kDepth>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
stump_scan_batched_kernel(const float* __restrict__ x,
                          const float* __restrict__ y,
                          const float* __restrict__ w,
                          const float* __restrict__ thr,
                          float* __restrict__ err, unsigned rows, int N,
                          int F, int T) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const unsigned b = i / (unsigned)F;
  const unsigned f = i - b * (unsigned)F;
  const size_t slot = (size_t)b * N;               // first row of slot b
  const float* xcol = x + slot * F + f;
  const float* thr_row = thr + (size_t)i * T;
  float* err_row = err + (size_t)i * T;
  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int tc = min(kChunk, T - t0);
    float th[kChunk];
    double acc[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) acc[k] = 0.0;
    load_thresholds<kVec>(thr_row + t0, tc, th);
    walk<kDepth>(xcol, F, y + slot, w + slot, 0, N, tc, th, acc);
    store_errors<kVec>(err_row + t0, tc, acc);
  }
}

// Thread tid = k * cols + j walks chunk blockIdx.x * kb + k of feature
// f0 + j; blockIdx.y is a column group (cols features, a power of two, of
// one chunk of 16 thresholds).
template <bool kVec, int kDepth>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
stump_scan_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  const float* __restrict__ w, const float* __restrict__ thr,
                  float* __restrict__ err, double* __restrict__ ws, int N,
                  int F, int T, int rows, int kb, int cols, int fgroups) {
  // the chunks' sums, [cell][chunk]: 32 KB, and a double of padding a
  // cell where kb >= 16
  extern __shared__ double part[];
  const int G = (int)gridDim.x;
  const int r = (int)blockIdx.x;
  const int tci = (int)blockIdx.y / fgroups;
  const int f0 = ((int)blockIdx.y - tci * fgroups) * cols;
  const int t0 = tci * kChunk;
  const int tc = min(kChunk, T - t0);
  const int k = (int)threadIdx.x / cols;
  const int j = (int)threadIdx.x - k * cols;
  const int cells = cols * kChunk;
  double acc[kChunk];
#pragma unroll
  for (int t = 0; t < kChunk; ++t) acc[t] = 0.0;
  const int f = f0 + j;
  const long long n0 = (long long)(r * kb + k) * rows;   // kb * cols = 256
  if (f < F && n0 < N) {
    float th[kChunk];
    load_thresholds<kVec>(thr + (size_t)f * T + t0, tc, th);
    walk<kDepth>(x + f, F, y, w, (int)n0, (int)min((long long)N, n0 + rows),
                 tc, th, acc);
  }
  // the block's sum: rounded and written (one block a column group), or
  // kept for the second pass
  block_sums(part, acc, kb, cols, k, j, [&](int c, double sum) {
    const int t = c / cols;
    const int fc = f0 + c - t * cols;
    if (G == 1) {
      if (fc < F && t < tc)
        err[(size_t)fc * T + t0 + t] = __double2float_rn(sum);
    } else {
      ws[((size_t)blockIdx.y * G + r) * cells + c] = sum;
    }
  });
}

// The second pass where a column group takes G > 1 blocks: one warp a
// cell, lane L holding the block sums L * P .. L * P + P - 1 (P a power of
// two, 32 * P >= G): a pairwise tree over them in the lane, then over the
// lanes, zeros past G adding nothing; rounded once and written.
__global__ void __launch_bounds__(kThreads)
stump_scan_combine_kernel(const double* __restrict__ ws,
                          float* __restrict__ err, int F, int T, int G, int P,
                          int cols, int fgroups, int total) {
  const int cellw = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = (int)(threadIdx.x & 31);
  if (cellw >= total) return;                  // the whole warp together
  const int cells = cols * kChunk;
  const int gy = cellw / cells;
  const int cell = cellw - gy * cells;
  const double* p = ws + (size_t)gy * G * cells + cell;
  double v[kMaxPerLane];
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int g = lane * P + i;
    v[i] = i < P && g < G ? p[(size_t)g * cells] : 0.0;
  }
#pragma unroll
  for (int h = 1; h < kMaxPerLane; h <<= 1) {
#pragma unroll
    for (int i = 0; i + h < kMaxPerLane; i += 2 * h) v[i] += v[i + h];
  }
  double sum = v[0];
#pragma unroll
  for (int m = 1; m < 32; m <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  const int tci = gy / fgroups;
  const int t = cell / cols;
  const int f = (gy - tci * fgroups) * cols + cell - t * cols;
  const int t0 = tci * kChunk;
  if (lane == 0 && f < F && t0 + t < T)
    err[(size_t)f * T + t0 + t] = __double2float_rn(sum);
}

// The split route of stump_scan_batched (kernels/ops.py:scan_batched_split):
// stump_scan_kernel's split of one slot's rows, for every slot of the
// batch, with the G blocks of a column group summed inside the launch.
// blockIdx.x = g * G + r: column group g (cols features of one chunk of 16
// thresholds) and its block r, one thread-block cluster of G blocks a
// column group; blockIdx.y = b * tgroups + tci, slot b's chunk tci of 16
// thresholds.  So a slot's column groups come to the SMs together and
// share x's sectors through L2.  Thread k * cols + j walks chunk r * kb + k
// of feature g * cols + j.  A block's sums are stump_scan_kernel's tree;
// then block r pushes its sum of cell c into block c % G's shared memory
// (distributed shared memory), one cluster barrier, and each block adds
// the G sums of its cells r, r + G, ... as a pairwise tree over 8 (zeros
// past G), rounds once and writes.  No atomics, no global scratch.  A
// thread reads its 16 thresholds once, with 4-byte loads: the 16-byte
// route's registers cost more than its loads save (at (10, 43575, 54,
// 16) it spilled and ran 0.1013 ms against 0.0937 on the H100).
template <int kDepth>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
stump_scan_batched_kernel_split(const float* __restrict__ x,
                                const float* __restrict__ y,
                                const float* __restrict__ w,
                                const float* __restrict__ thr,
                                float* __restrict__ err, int N, int F, int T,
                                int rows, int kb, int cols, int G,
                                int tgroups) {
  // the block's tree ([cell][chunk], as stump_scan_kernel's), then the
  // cluster's sums of this block's cells, [source block][cell / G]
  extern __shared__ double part[];
  const int g = (int)blockIdx.x / G;
  const int r = (int)blockIdx.x - g * G;       // its rank in the cluster
  const int b = (int)blockIdx.y / tgroups;
  const int tci = (int)blockIdx.y - b * tgroups;
  const int f0 = g * cols;
  const int t0 = tci * kChunk;
  const int tc = min(kChunk, T - t0);
  const int k = (int)threadIdx.x / cols;
  const int j = (int)threadIdx.x - k * cols;
  const int cells = cols * kChunk;
  const int per = (cells + G - 1) / G;         // cells a block rounds
  double* recv = part + cells * (kb >= 16 ? kb + 1 : kb);
  if (G > 1)   // started: waited for before any remote store
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  double acc[kChunk];
#pragma unroll
  for (int t = 0; t < kChunk; ++t) acc[t] = 0.0;
  const size_t slot = (size_t)b * N;               // first row of slot b
  const int f = f0 + j;
  const long long n0 = (long long)(r * kb + k) * rows;   // kb * cols = 256
  if (f < F && n0 < N) {
    float th[kChunk];
    load_thresholds<false>(thr + ((size_t)b * F + f) * T + t0, tc, th);
    walk<kDepth>(x + slot * F + f, F, y + slot, w + slot, (int)n0,
                 (int)min((long long)N, n0 + rows), tc, th, acc);
  }
  float* err_b = err + (size_t)b * F * T + t0;
  if (G == 1) {
    block_sums(part, acc, kb, cols, k, j, [&](int c, double sum) {
      const int t = c / cols;
      const int fc = f0 + c - t * cols;
      if (fc < F && t < tc)
        err_b[(size_t)fc * T + t] = __double2float_rn(sum);
    });
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  block_sums(part, acc, kb, cols, k, j, [&](int c, double sum) {
    const int i = c / G;
    *cluster.map_shared_rank(recv + r * per + i, c - i * G) = sum;
  });
  cluster.sync();
  for (int i = (int)threadIdx.x; i < per; i += kThreads) {
    const int c = r + i * G;
    if (c >= cells) break;
    double v[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      v[q] = q < G ? recv[q * per + i] : 0.0;
#pragma unroll
    for (int h = 1; h < kMaxCluster; h <<= 1) {
#pragma unroll
      for (int q = 0; q + h < kMaxCluster; q += 2 * h) v[q] += v[q + h];
    }
    const int t = c / cols;
    const int fc = f0 + c - t * cols;
    if (fc < F && t < tc)
      err_b[(size_t)fc * T + t] = __double2float_rn(v[0]);
  }
}


// The split route: `rows`, `chunks`, `blocks` and `cols` as
// stump_scan_launch takes them, with blocks a column group one cluster (at
// most kMaxCluster) and cols at most kSplitMaxCols; no scratch.
int launch_split(const float* x, const float* y, const float* w,
                 const float* thr, float* err, long long B, int N, int F,
                 int T, int rows, int chunks, int blocks, int cols,
                 cudaStream_t stream) {
  if (rows < 1 || blocks < 1 || blocks > kMaxCluster || cols < 1 ||
      cols > kSplitMaxCols || (cols & (cols - 1)) != 0 || chunks < blocks ||
      chunks % blocks != 0 || (long long)rows * chunks < N)
    return (int)cudaErrorInvalidValue;
  const int kb = chunks / blocks;
  if ((long long)kb * cols != kThreads) return (int)cudaErrorInvalidValue;
  const int tgroups = (T + kChunk - 1) / kChunk;
  const long long gx = (long long)((F + cols - 1) / cols) * blocks;
  const long long gy = B * tgroups;
  if (gx > INT_MAX || gy > kMaxGridY) return (int)cudaErrorInvalidConfiguration;
  const int cells = cols * kChunk;
  const size_t smem = ((size_t)cells * (kb >= 16 ? kb + 1 : kb) +
                       (size_t)(cells + blocks - 1) / blocks * blocks) *
                      sizeof(double);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)gx, (unsigned)gy, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = blocks > 1 ? 1 : 0;
  cudaError_t e =
      cudaLaunchKernelEx(&cfg, stump_scan_batched_kernel_split<4>, x, y, w,
                         thr, err, N, F, T, rows, kb, cols, blocks, tgroups);
  if (e != cudaSuccess) cudaGetLastError();   // not left for the next call
  return (int)e;
}

}  // namespace

// x (N,F), y (N,), w (N,), thr (F,T) -> err (F,T), all f32 and contiguous,
// on the current device, the split as kernels/ops.py:scan_split says:
// chunks of `rows` rows, `chunks` a column (covering N) over `blocks`
// blocks, `cols` features a block (a power of two up to 256); `vec` the
// 16-byte threshold loads (T % 4 == 0, thr 16-byte aligned).  Where
// blocks > 1 (at most 512), `ws` holds
// blocks * ceil(F / cols) * ceil(T / 16) * cols * 16 doubles of scratch
// and a second kernel adds the block sums.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int stump_scan_launch(const void* x, const void* y, const void* w,
                                 const void* thr, void* err, void* ws, int N,
                                 int F, int T, int rows, int chunks,
                                 int blocks, int cols, int vec,
                                 void* stream) {
  if (N < 0 || F < 1 || T < 1 || rows < 1 || blocks < 1 ||
      blocks > 32 * kMaxPerLane || cols < 1 ||
      cols > kThreads || (cols & (cols - 1)) != 0 || chunks < blocks ||
      chunks % blocks != 0 || (long long)rows * chunks < N ||
      (vec && T % 4 != 0) || (blocks > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const int kb = chunks / blocks;
  if ((long long)kb * cols != kThreads) return (int)cudaErrorInvalidValue;
  const int fgroups = (F + cols - 1) / cols;
  const long long gy = (long long)fgroups * ((T + kChunk - 1) / kChunk);
  if (gy > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)blocks, (unsigned)gy, 1);
  const float* xf = (const float*)x;
  const float* yf = (const float*)y;
  const float* wf = (const float*)w;
  const float* tf = (const float*)thr;
  float* ef = (float*)err;
  double* wsd = (double*)ws;
  const size_t smem =
      (size_t)cols * kChunk * (kb >= 16 ? kb + 1 : kb) * sizeof(double);
  auto kernel = blocks == 1 ? (vec ? stump_scan_kernel<true, 2>
                                    : stump_scan_kernel<false, 2>)
                            : (vec ? stump_scan_kernel<true, 4>
                                   : stump_scan_kernel<false, 4>);
  kernel<<<grid, kThreads, smem, s>>>(xf, yf, wf, tf, ef, wsd, N, F, T, rows,
                                      kb, cols, fgroups);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || blocks == 1) return (int)e;
  int P = 1;
  while (32 * P < blocks) P <<= 1;
  const long long total = gy * cols * kChunk;        // cells: a warp each
  if (total > INT_MAX / 32) return (int)cudaErrorInvalidConfiguration;
  stump_scan_combine_kernel<<<(unsigned)((total * 32 + kThreads - 1) /
                                         kThreads),
                              kThreads, 0, s>>>(wsd, ef, F, T, blocks, P,
                                                cols, fgroups, (int)total);
  return (int)cudaGetLastError();
}

// x (B,N,F), y (B,N), w (B,N), thr (B,F,T) -> err (B,F,T), all f32 and
// contiguous, on the current device; `vec` the row route's 16-byte loads
// and stores (T % 4 == 0, thr and err 16-byte aligned; the split takes
// 4-byte ones).  Two routes, one launch each:
// - one thread a (b, f) row, rows walked in order, where chunks == 0 (and
//   rows, blocks and cols 0).  `threads` (a multiple of 32 up to 256) and
//   `depth` (4 rows a group of loads) fix the launch where a caller asks
//   (0: the launcher's own, 64 threads and a depth of 8 on the 16-byte
//   route at N >= 32, else 4); any other value is refused.  The bits are
//   the plain version's.
// - the split (threads and depth 0), as kernels/ops.py:scan_batched_split
//   says: each slot's rows in `chunks` chunks of `rows` rows over `blocks`
//   blocks (a cluster, at most 8), `cols` features a block (a power of two
//   up to 64); ref.scan_batched_in_kernel_order gives its bits.
// Returns the CUDA error of the launch (0 on success).
extern "C" int stump_scan_batched_launch(const void* x, const void* y,
                                         const void* w, const void* thr,
                                         void* err, long long B, int N, int F,
                                         int T, int vec, int threads,
                                         int depth, int rows, int chunks,
                                         int blocks, int cols, void* stream) {
  if (B < 0 || N < 0 || F < 0 || T < 0 || (vec && T % 4 != 0) ||
      threads < 0 || threads > kThreads || threads % 32 != 0 ||
      (depth != 0 && depth != 4) ||
      (chunks ? threads || depth : rows || blocks || cols))
    return (int)cudaErrorInvalidValue;
  const long long rows_bf = B * F;
  if (rows_bf == 0 || T == 0) return 0;
  const float* xf = (const float*)x;
  const float* yf = (const float*)y;
  const float* wf = (const float*)w;
  const float* tf = (const float*)thr;
  float* ef = (float*)err;
  if (chunks)
    return launch_split(xf, yf, wf, tf, ef, B, N, F, T, rows, chunks, blocks,
                        cols, (cudaStream_t)stream);
  const int bt = threads ? threads : kBatchThreads;
  const long long nblocks = (rows_bf + bt - 1) / bt;
  if (rows_bf > (long long)UINT_MAX - kThreads || nblocks > INT_MAX)
    return (int)cudaErrorInvalidConfiguration;
  auto kernel = !vec ? stump_scan_batched_kernel<false, 4>
                : N >= 32 && !depth ? stump_scan_batched_kernel<true, 8>
                                    : stump_scan_batched_kernel<true, 4>;
  kernel<<<(unsigned)nblocks, bt, 0, (cudaStream_t)stream>>>(
      xf, yf, wf, tf, ef, (unsigned)rows_bf, N, F, T);
  return (int)cudaGetLastError();
}

// stump_vote / stump_vote_fp: the stump-ensemble serving kernels.
//
//   out[b, n] = sum_t alpha[b, t] * (pol[b, t] * sign((xsel[b, t, n] - thr[b, t]) + 1e-12))
//
// over the rows with alpha != 0, and, for the fingerprint variant, two
// uint32 lanes per column
//
//   fp_k[b, n] = XOR_t [ (bits(xsel[b, t, n]) ^ SALT_k) * (2 t + ODD_k) ]  (mod 2^32)
//
// over the same rows, t being the row's global index.  A zero-alpha row
// adds nothing to either, whatever its thr, pol or xsel hold (NaN too).
//
// Replaces two TPU kernels of src/repro/kernels/ensemble_vote.py:
// `stump_vote_batched_kernel` (:203, `_stump_vote_kernel`, pallas_call at
// :215) and `stump_vote_fp_batched_kernel` (:168, `_stump_vote_fp_kernel`,
// pallas_call at :185).  Both walked (block_t, block_n) tiles of xsel
// through VMEM with the output column block resident across a sequential
// t grid.  They serve the stump tenants of serve/engine.py (the fused
// fingerprint path and the plain one).
//
// Bound on the H100: the bytes at large shapes.  Each xsel element is
// read once and takes a handful of operations, far below the card's ratio
// of operations to bytes.  At the serving path's shapes (one or two
// tenants, a few hundred rows, at most 64 columns) the bytes bound is
// under the launch floor: the time is the chain of load rounds and the
// issue of the cells' instructions on the few SMs the columns fill.  The
// design before this one gave each column one thread that walked all T
// rows with eight 4-byte loads and three scalar loads a row: at
// (8,1024,4096) 37% of the bytes bound, at (2,300,64) 38 dependent
// rounds of loads on 2 SMs.
//
// Design: the order of ensemble_vote.cu, with the stump margin in place
// of the precomputed one.
// - T is cut into chunks of kRows = 32 rows; a stage is kWarps = 8
//   consecutive chunks.  A warp sums one chunk's rows in t order from
//   zero.  The stage's partial is the fixed tree ((c0 + c1) + (c2 + c3))
//   + ((c4 + c5) + (c6 + c7)) over its chunk sums, through shared memory;
//   a column's result is its stage partials added in stage order from
//   zero.  Every multiply and add is rounded on its own (__fmul_rn,
//   __fadd_rn).  So a column's result is a fixed function of its own rows:
//   the same bits whatever B, N, zero-alpha padding in T, tile width, load
//   route, load depth or stages a round, run to run, and through either
//   kernel.  `ref.vote_in_kernel_order` emulates the order on the CPU
//   (VOTE_ROWS, VOTE_WARPS there are kRows and kWarps here).  No atomics.
// - A tile is 32 kC consecutive columns of one b, kC a lane a row.  At
//   kC = 4 a lane takes one 16-byte load (`ld.global.nc.v4`) where
//   N % 4 == 0 and xsel is 16-byte aligned, else 4-byte loads of columns
//   lane + 32 j.  The launcher takes kC = 4 where the grid fills the card,
//   else the narrowest tile (kC 2 or 1) that keeps the grid within one
//   block an SM: at the serving path's few columns every lane then has
//   work, and a warp issues kC cells a row, not 4.
// - A block is one warp group of kWarps warps (one stage a round), or
//   two (two stages a round, 512 threads) where the tiles are narrow, the
//   grid is within one block an SM and T has two stages or more: the
//   serving shape's two stages then take one round of loads, not two.
// - Loads: a whole chunk's rows in flight where the grid is within one
//   block an SM ("deep"), else half a chunk at two blocks an SM.  No
//   branch a row: rows past T load row T - 1 again and add +-0, so the
//   compiler schedules a chunk as one block of code (a guard a row split
//   it into 32, and its rows ran one after the other).
// - Row scalars once a warp: lane k loads row t0 + k's thr, alpha and pol
//   (coalesced) and forms ap = alpha * pol (0 where alpha == 0 or past
//   T); a row's thr and ap reach the other lanes by __shfl_sync.  A cell
//   is then d = (x - thr) + 1e-12, the select of ap, -ap or 0 by the sign
//   of d, and the add into the chunk sum.  That is the TPU kernel's
//   alpha * (pol * sign(d)) bit for bit: s in {-1, 0, 1} and
//   round-to-nearest is symmetric in sign, so fl(alpha * fl(pol * s)) =
//   s * fl(alpha * pol), subnormals included (no -ftz); a sum that starts
//   at +0 is never -0, so adding +-0 leaves its bits.
// - The lanes: a thread XORs its columns' terms over its chunks of every
//   round, masked by the row's alpha != 0 (a ballot of the chunk); the
//   warps' lanes meet by XOR at the end (exact, so in any order).  A row's
//   2 t + ODD factors are computed once a row.
// - Blocks are flat over gridDim.x (gridDim.y stops at 65,535), offsets
//   in size_t.
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kLanes = 32;
constexpr int kWarps = 8;                    // chunks a stage, one a warp
constexpr int kRows = 32;                    // rows a chunk
constexpr int kStageRows = kWarps * kRows;   // 256
constexpr int kThreads = kWarps * kLanes;    // 256
constexpr uint32_t kSalt0 = 0x9E3779B9u;
constexpr uint32_t kSalt1 = 0x85EBCA6Bu;
constexpr uint32_t kOdd0 = 0x00010001u;
constexpr uint32_t kOdd1 = 0x00C2B2AFu;

// Rows a warp has in flight: a whole chunk where the grid is at most one
// block an SM, half a chunk at two blocks an SM; half that again on the
// scalar route of four columns a lane (four loads a row).
template <int kC, bool kVec, bool kDeep>
__host__ __device__ constexpr int depth() {
  return (kDeep ? 32 : 16) / (kC == 4 && !kVec ? 2 : 1);
}

// The column of a tile that value j of a lane is: n0 + 4 lane + j on the
// vector route (kC = 4, one 16-byte load), n0 + lane + 32 j otherwise.
template <bool kVec>
__device__ __forceinline__ int col_of(int lane, int j) {
  return kVec ? 4 * lane + j : lane + 32 * j;
}

// The kC values of row `row` that this lane takes (0 past N).
template <int kC, bool kVec>
__device__ __forceinline__ void load_row(float (&v)[kC], const float* row,
                                         int n0, int lane, int N) {
  if (kVec) {
    const int n = n0 + 4 * lane;
    const float4 q = n < N ? __ldg(reinterpret_cast<const float4*>(row + n))
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < kC; ++j) {
    const int n = n0 + lane + 32 * j;
    v[j] = n < N ? __ldg(row + n) : 0.0f;
  }
}

// One cell: the chunk sum c plus alpha * pol * sign((x - th) + 1e-12),
// with ap = alpha * pol (0 on a zero-alpha row).  d NaN selects 0.
__device__ __forceinline__ float cell(float c, float x, float th, float ap) {
  const float d = __fadd_rn(__fsub_rn(x, th), 1e-12f);
  return __fadd_rn(c, d > 0.0f ? ap : (d < 0.0f ? -ap : 0.0f));
}

__device__ __forceinline__ uint32_t mix(float x, uint32_t salt,
                                        uint32_t odd) {
  return (__float_as_uint(x) ^ salt) * odd;
}

// kC values a lane over kC * 32 columns (a tile): kC in {1, 2, 4}.  The
// launcher takes the narrowest tile that keeps the grid within one block
// an SM, so at the serving path's few columns every lane of a warp has
// work and a warp issues fewer instructions a row.  A block is kGroups
// warp groups of kWarps warps; group g takes stage s0 + g of a round, so
// a round covers kGroups stages (two where the tiles are narrow and the
// grid leaves SMs idle: 512 threads at up to 128 registers).
template <bool kFp, int kC, bool kVec, bool kDeep, int kGroups>
__global__ void __launch_bounds__(kThreads * kGroups, kDeep ? 1 : 2)
stump_vote_kernel(const float* __restrict__ xsel, const float* __restrict__ thr,
                  const float* __restrict__ pol,
                  const float* __restrict__ alphas, float* __restrict__ out,
                  uint32_t* __restrict__ fp0, uint32_t* __restrict__ fp1,
                  int T, int N, int tiles) {
  constexpr int kCols = kC * kLanes;              // columns a tile
  constexpr int kAll = kGroups * kWarps;          // warps a block
  __shared__ __align__(16) float part[2][kAll][kCols];
  __shared__ uint32_t lanes[2][kFp ? kAll : 1][kCols];
  const int n0 = (int)(blockIdx.x % (unsigned)tiles) * kCols;
  const size_t b = blockIdx.x / (unsigned)tiles;
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const float* x_b = xsel + b * (size_t)T * N;
  const float* thr_b = thr + b * (size_t)T;
  const float* pol_b = pol + b * (size_t)T;
  const float* a_b = alphas + b * (size_t)T;
  const int S = (T + kStageRows - 1) / kStageRows;
  constexpr int kDepth = depth<kC, kVec, kDeep>();
  float acc = 0.0f;
  uint32_t f0[kC], f1[kC];
#pragma unroll
  for (int j = 0; j < kC; ++j) f0[j] = f1[j] = 0u;
  for (int s0 = 0, round = 0; s0 < S; s0 += kGroups, ++round) {
    // warp w's chunk: chunk w % kWarps of stage s0 + w / kWarps
    const int t0 = s0 * kStageRows + warp * kRows;
    float c[kC];                                             // its sums
#pragma unroll
    for (int j = 0; j < kC; ++j) c[j] = 0.0f;
    if (t0 < T) {                                   // uniform in the warp
      // the chunk's row scalars: lane k holds row t0 + k's
      const int tl = t0 + lane;
      float th_l = 0.0f, ap_l = 0.0f, a_l = 0.0f;
      if (tl < T) {
        a_l = __ldg(a_b + tl);
        th_l = __ldg(thr_b + tl);
        const float p_l = __ldg(pol_b + tl);
        ap_l = a_l != 0.0f ? __fmul_rn(a_l, p_l) : 0.0f;
      }
      const unsigned live = kFp ? __ballot_sync(0xffffffffu, a_l != 0.0f)
                                : 0u;
      // No branch a row: rows past T load row T - 1 again and add +-0
      // (their ap is 0), and their lanes are masked off, so the compiler
      // schedules the chunk's rows as one block.
#pragma unroll
      for (int r = 0; r < kRows; r += kDepth) {
        if (t0 + r >= T) break;                     // uniform in the warp
        float v[kDepth][kC];
#pragma unroll
        for (int k = 0; k < kDepth; ++k) {
          const int t = min(t0 + r + k, T - 1);
          load_row<kC, kVec>(v[k], x_b + (size_t)t * N, n0, lane, N);
        }
#pragma unroll
        for (int k = 0; k < kDepth; ++k) {
          const float th = __shfl_sync(0xffffffffu, th_l, r + k);
          const float ap = __shfl_sync(0xffffffffu, ap_l, r + k);
#pragma unroll
          for (int j = 0; j < kC; ++j) c[j] = cell(c[j], v[k][j], th, ap);
          if (kFp) {
            const uint32_t t = (uint32_t)(t0 + r + k);
            const uint32_t keep = 0u - ((live >> (r + k)) & 1u);
            const uint32_t m0 = 2u * t + kOdd0, m1 = 2u * t + kOdd1;
#pragma unroll
            for (int j = 0; j < kC; ++j) {
              f0[j] ^= mix(v[k][j], kSalt0, m0) & keep;
              f1[j] ^= mix(v[k][j], kSalt1, m1) & keep;
            }
          }
        }
      }
    }
    // two buffers: a round's writes never meet the previous round's reads
    float* p = part[round & 1][warp];
    if (kVec) {
      reinterpret_cast<float4*>(p)[lane] = make_float4(c[0], c[1 % kC],
                                                       c[2 % kC], c[3 % kC]);
    } else {
#pragma unroll
      for (int j = 0; j < kC; ++j) p[col_of<false>(lane, j)] = c[j];
    }
    __syncthreads();
    if (threadIdx.x < kCols) {
      // each stage of the round: the tree over its chunk sums, then into
      // the column's result in stage order
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        if (s0 + g >= S) break;
        float q[kWarps];
#pragma unroll
        for (int w = 0; w < kWarps; ++w)
          q[w] = part[round & 1][g * kWarps + w][threadIdx.x];
#pragma unroll
        for (int width = kWarps / 2; width >= 1; width /= 2) {
#pragma unroll
          for (int i = 0; i < width; ++i)
            q[i] = __fadd_rn(q[2 * i], q[2 * i + 1]);
        }
        acc = __fadd_rn(acc, q[0]);
      }
    }
  }
  if (threadIdx.x >= kCols && !kFp) return;
  const bool writer = threadIdx.x < kCols && n0 + (int)threadIdx.x < N;
  const size_t o = b * (size_t)N + n0 + threadIdx.x;
  if (kFp) {
    // the warps' lanes meet by XOR (exact: any order)
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      lanes[0][warp][col_of<kVec>(lane, j)] = f0[j];
      lanes[1][warp][col_of<kVec>(lane, j)] = f1[j];
    }
    __syncthreads();
    if (writer) {
      uint32_t h0 = 0u, h1 = 0u;
#pragma unroll
      for (int w = 0; w < kAll; ++w) {
        h0 ^= lanes[0][w][threadIdx.x];
        h1 ^= lanes[1][w][threadIdx.x];
      }
      fp0[o] = h0;
      fp1[o] = h1;
    }
  }
  if (writer) out[o] = acc;
}

struct Args {
  const float *xsel, *thr, *pol, *alphas;
  float* out;
  uint32_t *fp0, *fp1;
  int T, N;
};

template <bool kFp, int kC, bool kVec, bool kDeep, int kGroups>
cudaError_t start(const Args& a, long long B, cudaStream_t stream) {
  const int tiles = (a.N + kC * kLanes - 1) / (kC * kLanes);
  stump_vote_kernel<kFp, kC, kVec, kDeep, kGroups>
      <<<(unsigned)(B * tiles), kThreads * kGroups, 0, stream>>>(
          a.xsel, a.thr, a.pol, a.alphas, a.out, a.fp0, a.fp1, a.T, a.N,
          tiles);
  return cudaGetLastError();
}

// The launch: tile_c (1, 2 or 4 columns a lane a row), deep (1: a whole
// chunk of loads in flight, 0: half a chunk at two blocks an SM) and
// groups (stages a round, 1 or 2; 2 only on the deep, narrow routes) as a
// caller asks, or the launcher's own choice where tile_c or groups is 0
// or deep -1; anything else is refused.  The bits do not depend on them.
template <bool kFp>
int launch(const Args& a, long long B, int tile_c, int deep_knob, int groups,
           void* stream) {
  if (B < 0 || a.T < 0 || a.N < 0 ||
      (tile_c != 0 && tile_c != 1 && tile_c != 2 && tile_c != 4) ||
      deep_knob < -1 || deep_knob > 1 || groups < 0 || groups > 2)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || a.N == 0) return 0;
  int sms = 0;
  if (tile_c == 0 || deep_knob < 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  auto tiles = [&](int C) { return (a.N + 32LL * C - 1) / (32LL * C); };
  // 128-column tiles, or the narrowest tile that keeps the grid within one
  // block an SM; two stages a round where the tiles are narrow, the grid
  // is within one block an SM and T has two stages or more
  int C = tile_c;
  if (C == 0) {
    C = 4;
    while (C > 1 && B * tiles(C / 2) <= sms) C /= 2;
  }
  if (B * tiles(C) > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const bool deep = deep_knob < 0 ? B * tiles(C) <= sms : deep_knob == 1;
  const bool two = groups == 0 ? C < 4 && deep && a.T > kStageRows
                               : groups == 2;
  if (two && (C == 4 || !deep)) return (int)cudaErrorInvalidValue;
  const bool vec = C == 4 && a.N % 4 == 0 && ((uintptr_t)a.xsel & 15) == 0;
  auto go = C == 1 ? (two ? start<kFp, 1, false, true, 2>
                          : deep ? start<kFp, 1, false, true, 1>
                                 : start<kFp, 1, false, false, 1>)
          : C == 2 ? (two ? start<kFp, 2, false, true, 2>
                          : deep ? start<kFp, 2, false, true, 1>
                                 : start<kFp, 2, false, false, 1>)
          : vec ? (deep ? start<kFp, 4, true, true, 1>
                        : start<kFp, 4, true, false, 1>)
                : (deep ? start<kFp, 4, false, true, 1>
                        : start<kFp, 4, false, false, 1>);
  return (int)go(a, B, (cudaStream_t)stream);
}

}  // namespace

// xsel (B,T,N), thr/pol/alphas (B,T) -> out (B,N), all f32 and contiguous,
// on the current device; tile_c, deep and groups as launch() takes them.
// Returns the CUDA error of the launch (0 on success).
extern "C" int stump_vote_launch(const void* xsel, const void* thr,
                                 const void* pol, const void* alphas,
                                 void* out, int B, int T, int N, int tile_c,
                                 int deep, int groups, void* stream) {
  const Args a{(const float*)xsel, (const float*)thr, (const float*)pol,
               (const float*)alphas, (float*)out, nullptr, nullptr, T, N};
  return launch<false>(a, B, tile_c, deep, groups, stream);
}

// As stump_vote_launch, plus the lanes fp0/fp1 (B,N), 32 bits each.
extern "C" int stump_vote_fp_launch(const void* xsel, const void* thr,
                                    const void* pol, const void* alphas,
                                    void* out, void* fp0, void* fp1, int B,
                                    int T, int N, int tile_c, int deep,
                                    int groups, void* stream) {
  const Args a{(const float*)xsel, (const float*)thr, (const float*)pol,
               (const float*)alphas, (float*)out, (uint32_t*)fp0,
               (uint32_t*)fp1, T, N};
  return launch<true>(a, B, tile_c, deep, groups, stream);
}

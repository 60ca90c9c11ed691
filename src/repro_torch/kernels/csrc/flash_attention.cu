// flash_attention: blockwise softmax attention with an online softmax,
// causal or full, on Hopper's tensor cores.
//
//   out[b, h, i, :] = sum_j softmax_j(q[b, h, i] . k[b, h / G, j] / sqrt(d))
//                     v[b, h / G, j, :]
//   (under `causal` only the keys j <= i take part; G = H / Hkv)
//
// q and out are (B, H, T, d), k and v (B, Hkv, T, d), all f32 or all bf16,
// each with any strides whose last one is 1 (a (B, T, H, d) tensor seen
// through .transpose(1, 2) is read and written in place).  The softmax is
// f32; the output is rounded once to the input's type.
//
// Replaces the TPU kernel `flash_attention_kernel` / `_flash_kernel` in
// src/repro/kernels/flash_attention.py, whose grid walked (bh, q-block,
// k-block) with the k-block innermost and sequential, carrying the running
// max, denominator and accumulator across k-steps in VMEM scratch.  Here the
// k-loop runs inside one block, any T (the ragged tail is masked) and any d
// up to 128 (zero-filled by TMA, the scale that of the true d).
//
// Bound on the H100: the operations.  At the LM path's shape (B 4, H 16,
// T 512, d 64, causal) the work is 2 BH T^2 d = 2.1 GFLOP against 33.6 MB
// of q, k, v and out, some 64 FLOP per byte.  bf16 runs at the tensor
// cores' 989 TFLOP/s.  f32 must hold the f32 tolerance (2e-4), which one
// TF32 product (a 10-bit mantissa) does not; the cheapest route that does
// is three TF32 products for each (split TF32, below), so its bound is
// 3 x work at the 495 TFLOP/s TF32 rate, still 2.5x under the CUDA cores'
// 67 TFLOP/s of f32.
//
// Both routes.  One block per (b, h, q tile), numbered so that the q tiles
// with the most causal work start first.  The last warp is the producer:
// one of its threads loads the Q tile once and keeps K and V tiles of 64
// rows (32 in f32 above d 64) in flight through TMA (cp.async.bulk.tensor,
// 4-d tensor maps over (d, T, H, B) with the caller's strides) into a ring
// of stages, each signalled on an mbarrier with its bytes; the consumers
// free a stage on a second mbarrier.  Boxes are 128 bytes wide with the
// 128-byte swizzle (a d-128 tile is two bf16 boxes or four f32 ones);
// columns past d and rows past T land as zeros (TMA's out-of-bounds fill),
// so no padded copy is made.  Scores are scaled into base 2, keys past T
// and, under causality, past the row are set to -inf, and the running max,
// denominator and output stay in registers in the accumulator fragments: a
// row's max and sum come from shuffles across the four threads that hold
// it.  Under causality a warpgroup skips the k tiles past its last row and
// masks only the tiles that cross its diagonal.  The k-tile order is fixed
// and there are no atomics: a result is the same from run to run.
//
// bf16 route: one consumer warpgroup of 64 q rows a block.  S = Q . K^T is
// wgmma.mma_async m64n64k16 with Q and K read from shared memory, K-major
// as they lie; P is rounded to bf16 in registers, where the f32 accumulator
// fragment of S is already the A fragment of the second wgmma (16 columns
// at a time), and O += P . V reads V from shared memory as an MN-major B
// operand (the transpose bit set).  S_j and P_{j-1} . V_{j-1} are issued
// together and the softmax of S_j runs while P . V does, so a stage is
// freed a tile later and the ring keeps three.
//
// f32 route: split TF32.  Each operand x is split into hi = tf32_rna(x) and
// lo = tf32_rna(x - hi), and each product accumulates lo.hi + hi.lo + hi.hi
// in f32: the dropped lo.lo term and the roundings are about 2^-22
// relative, which holds 2e-4 where one product (2^-11) does not.  Two
// consumer warpgroups of 64 q rows a block.  The consumers split Q once and
// each K tile (and, up to d 64, each V tile) in shared memory, the high
// halves in place and the low ones into planes of the same swizzled layout,
// and meet at a named barrier.  S = Q . K^T is then three
// wgmma.mma_async m64nNk8 TF32 products a step of 8 columns of d (TF32
// wgmma reads both operands K-major, as Q and K lie).  P . V runs on
// mma.sync.m16n8k8 TF32, three products as well, each warp on its 16 rows:
// V is MN-major, which TF32 wgmma cannot read, and mma.sync takes its
// fragments from any layout.  The 8 keys of a k-step go to the operands' k
// index t (key 2t) and t + 4 (key 2t + 1), so the accumulator fragment of S
// is the A fragment as it stands, with no shuffle; the swizzle keeps every
// fragment load free of bank conflicts.
//
// Shared memory a block: bf16 56 KB at d 64 (three blocks an SM), 112 KB at
// d 128 (two); f32 192 KB at d 64 (Q and its low plane 64 KB, two stages of
// K, V and their low planes), 224 KB at d 128 (32-row tiles, V split as it
// is read).  One f32 block an SM: its nine warps cap a thread at 168
// registers.
//
// Launch shapes.  The above is the launcher's own choice.  A caller (the
// dispatcher's calibrated layout, `stages`) may ask for a bf16 ring of two
// stages in place of three; f32 has its own two only.  Either is the same
// kernel template, and every row sees the same k tiles in the same order.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kLine = 128;                      // bytes of a swizzled box row

// the block's shape: kBQ q rows and K and V tiles of kBK rows, with one
// consumer warpgroup per 64 q rows (bf16 one, f32 two) and the producer
// warp; kMinBlocks blocks an SM.  The shared memory holds Q, then a ring of
// kStages stages of K and V; in f32 also the low TF32 halves of Q (after Q)
// and of each stage's K, and V where kSplitV (after V).
template <typename T, int D, int NS>
struct Cfg {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kBQ = kF32 ? 128 : 64;
  static constexpr int kBK = kF32 && D > 64 ? 32 : 64;
  static constexpr int kWarps = kBQ / 16;
  static constexpr int kThreads = 32 * (kWarps + 1);
  static constexpr int kMinBlocks = kF32 ? 1 : D <= 64 ? 3 : 2;
  // the K/V ring: the launcher's own is f32 2 and bf16 3, as bf16 frees a
  // stage one tile later (P . V overlaps the next tile's softmax)
  static constexpr int kStages = NS;
  static constexpr int kCols = kLine / (int)sizeof(T);   // columns per box
  static constexpr int kBoxes = D / kCols;
  static constexpr int kQ = kBQ * D * (int)sizeof(T);
  static constexpr int kTile = kBK * D * (int)sizeof(T);
  // f32 splits V once a block too where the shared memory allows it
  static constexpr bool kSplitV = kF32 && D <= 64;
  static constexpr int kStage = (kF32 ? (kSplitV ? 4 : 3) : 2) * kTile;
  static constexpr int kRing = (kF32 ? 2 : 1) * kQ;      // the first stage
  static constexpr int kBars = kRing + kStages * kStage;
  // barriers, and slack to align the base to the swizzle's 1024 bytes
  static constexpr int kBytes = kBars + 64 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// one box of a 4-d tensor map at (c0, c1, c2, c3) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ------------------------------------------------------------------ wgmma
// shared-memory matrix descriptor, 128-byte swizzle; lbo/sbo in bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  wgmma_commit();
  wgmma_wait<0>();
}
// the consumer warps (all but the producer) wait for each other
template <int kConsumers>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumers) : "memory");
}

// keeps the compiler from moving reads or writes of a wgmma's registers
// across the asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (64 x 64, f32) += A (64 x 8) . B (64 x 8)^T in TF32, A and B in shared
// memory, both K-major
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 32, f32) += A (64 x 8) . B (32 x 8)^T in TF32, A and B in shared
// memory, both K-major
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64, f32) = A (64 x 16) . B (64 x 16)^T [+ d when accumulate],
// A and B in shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers) . B (16 x 64),
// B in shared memory, MN-major (the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, bf16 in registers) . B (16 x 128),
// B in shared memory, MN-major (the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// ------------------------------------------------------------- mma.sync
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// `bytes` of f32 at x split in place into their high TF32 halves, the low
// ones written at the same offsets from lo (the layout, swizzle included,
// is kept), by `n` threads; then made visible to wgmma's reads
__device__ __forceinline__ void split_tile(uint8_t* x, uint8_t* lo, int bytes,
                                           int tid, int n) {
  for (int off = 16 * tid; off < bytes; off += 16 * n) {
    const float4 v = *reinterpret_cast<const float4*>(x + off);
    uint4 hi, low;
    split(v.x, hi.x, low.x);
    split(v.y, hi.y, low.y);
    split(v.z, hi.z, low.z);
    split(v.w, hi.w, low.w);
    *reinterpret_cast<uint4*>(x + off) = hi;
    *reinterpret_cast<uint4*>(lo + off) = low;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b in split TF32: lo.hi + hi.lo + hi.hi
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           const uint32_t (&bhi)[2],
                                           const uint32_t (&blo)[2]) {
  float (&acc)[4] = *reinterpret_cast<float(*)[4]>(c);
  mma_tf32(acc, alo, bhi[0], bhi[1]);
  mma_tf32(acc, ahi, blo[0], blo[1]);
  mma_tf32(acc, ahi, bhi[0], bhi[1]);
}

// the f32 at (row r, column c) of an R-row tile of 32-float swizzled boxes
template <int R>
__device__ __forceinline__ float lds(const uint8_t* tile, int r, int c) {
  const int cc = c & 31;
  return *reinterpret_cast<const float*>(
      tile + (c >> 5) * R * kLine + r * kLine +
      ((((cc >> 2) ^ (r & 7)) << 4) | ((cc & 3) << 2)));
}

// --------------------------------------------------- the shared row logic
// A fragment of 16 rows x 8 NC columns, as both routes hold it: s[4i + e]
// is row r (e < 2) or r + 8 (e >= 2), column 8i + 2t + (e & 1), where
// r = lane / 4 and t = lane % 4.  Scales into base 2, masks, and folds the
// tile into the running max m and per-thread partial sums l, leaving the
// probabilities in s and the factor that rescales the rows' output in corr.
template <int NC>
__device__ __forceinline__ void softmax_tile(float (&s)[NC * 4],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int row0,
                                             int col0, int Tlen, bool masked,
                                             bool causal, float scale_log2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < NC; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * i + e] * scale_log2;
      if (masked) {
        const int col = col0 + 8 * i + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        if (col >= Tlen || (causal && col > row)) x = -INFINITY;
      }
      s[4 * i + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    float m_new = fmaxf(m[h], mx[h]);
    if (m_new == -INFINITY) m_new = 0.0f;       // a row with no key yet
    corr[h] = exp2f(m[h] - m_new);
    m[h] = m_new;
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < NC; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[4 * i + e] - m[e >> 1]);
      s[4 * i + e] = p;
      sum[e >> 1] += p;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];
}

// the output fragment's rows times their factors
template <int NO>
__device__ __forceinline__ void rescale(float (&o)[NO * 4],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * i + e] *= corr[e >> 1];
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// rows row0 and row0 + 8 of the output fragment, divided by their sums
template <typename T, int NO>
__device__ __forceinline__ void store_rows(T* out, long long o_st,
                                           const float (&o)[NO * 4],
                                           float (&l)[2], int row0, int col0,
                                           int Tlen, int d) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= Tlen) continue;
    const float inv = 1.0f / l[h];
    T* orow = out + (long long)row * o_st;
#pragma unroll
    for (int i = 0; i < NO; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + 8 * i + e;
        if (col < d) store(orow + col, o[4 * i + 2 * h + e] * inv);
      }
  }
}

struct Job {
  int q0, n_kt, Tlen, d, causal;
  float scale_log2;
};

// ------------------------------------------------------------ consumers
// bf16: the block's one warpgroup owns its 64 q rows.  P . V of one tile
// runs on the tensor cores while the next tile's softmax runs on the CUDA
// cores: S_j and P_{j-1} . V_{j-1} are issued together, and the wait for
// the second comes after the softmax of S_j.
template <int D, int NS>
__device__ __forceinline__ void consume_wgmma(uint8_t* smem, uint64_t* bars,
                                              __nv_bfloat16* out,
                                              long long o_st, const Job& job) {
  using S = Cfg<__nv_bfloat16, D, NS>;
  static_assert(S::kBQ == 64, "one consumer warpgroup");
  constexpr int BK = S::kBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first = job.q0;                       // the block's rows
  const int row0 = first + 16 * warp + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  uint64_t* full = bars;
  uint64_t* empty = bars + NS;
  uint64_t* qbar = bars + 2 * NS;
  const uint32_t qbase = smem_u32(smem);
  const uint32_t ring = smem_u32(smem + S::kRing);

  float o[D / 2], sc[BK / 2], corr[2];
  uint32_t pa[BK / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  // S = Q . K_kt^T, issued and committed, not waited for
  auto issue_s = [&](int kt) {
    const uint32_t kbase = ring + (kt % NS) * S::kStage;
    mbar_wait(&full[kt % NS], (kt / NS) & 1);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.0f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {         // 16 columns of d a step
      const uint32_t off = (j & 3) * 32;
      wgmma_ss_n64(
          sc, sw128_desc(qbase + (j >> 2) * S::kBQ * kLine + off, 0, 1024),
          sw128_desc(kbase + (j >> 2) * BK * kLine + off, 0, 1024), j);
    }
    wgmma_commit();
  };
  // O += P . V_kt, issued and committed, not waited for
  auto issue_pv = [&](int kt) {
    const uint32_t vbase = ring + (kt % NS) * S::kStage + S::kTile;
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {     // 16 keys a step
      const uint64_t dv =
          sw128_desc(vbase + 16 * kk * kLine, BK * kLine, 1024);
      if constexpr (D == 64)
        wgmma_rs_n64(o, pa[kk], dv);
      else
        wgmma_rs_n128(o, pa[kk], dv);
    }
    wgmma_commit();
  };
  auto softmax = [&](int kt) {
    const int k0 = kt * BK;
    const bool masked = (job.causal && k0 + BK - 1 > first) ||
                        k0 + BK > job.Tlen;
    softmax_tile<BK / 8>(sc, m, l, corr, row0, k0 + col0, job.Tlen, masked,
                         job.causal, job.scale_log2);
  };
  // P rounded to bf16: the f32 accumulator fragment of S is the A
  // fragment of the second product, 16 columns at a time
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        __nv_bfloat162 two = __floats2bfloat162_rn(sc[8 * kk + 2 * r],
                                                   sc[8 * kk + 2 * r + 1]);
        pa[kk][r] = *reinterpret_cast<uint32_t*>(&two);
      }
  };
  auto release = [&](int kt) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[kt % NS]);
  };

  // every q tile of the grid has a row below T and a first k tile to see
  mbar_wait(qbar, 0);
  issue_s(0);
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(0);
  pack_p();
  for (int kt = 1; kt < job.n_kt; ++kt) {
    issue_s(kt);
    issue_pv(kt - 1);
    wgmma_wait<1>();                            // S_kt has landed
    fence_regs(sc);
    softmax(kt);
    wgmma_wait<0>();                            // and P . V_{kt-1}
    fence_regs(o);
    fence_regs(pa);
    release(kt - 1);
    rescale<D / 8>(o, corr);
    pack_p();
  }
  issue_pv(job.n_kt - 1);
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(pa);
  release(job.n_kt - 1);
  store_rows<__nv_bfloat16, D / 8>(out, o_st, o, l, row0, col0, job.Tlen,
                                   job.d);
}

// f32: warpgroup wg owns q rows [64 wg, 64 wg + 64) of the tile for S, and
// warp w the rows [16 w, 16 w + 16) of them for P . V
template <int D, int NS>
__device__ __forceinline__ void consume_tf32(uint8_t* smem, uint64_t* bars,
                                             float* out, long long o_st,
                                             const Job& job) {
  using S = Cfg<float, D, NS>;
  constexpr int BK = S::kBK;
  constexpr int kConsumers = 32 * S::kWarps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int first = job.q0 + 64 * (warp >> 2);   // the warpgroup's rows
  const int row0 = job.q0 + 16 * warp + g;
  const bool live = first < job.Tlen;
  uint64_t* full = bars;
  uint64_t* empty = bars + S::kStages;
  uint64_t* qbar = bars + 2 * S::kStages;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  mbar_wait(qbar, 0);
  split_tile(smem, smem + S::kQ, S::kQ, threadIdx.x, kConsumers);
  consumers_sync<S::kWarps>();
  const uint32_t qhi = smem_u32(smem) + 64 * (warp >> 2) * kLine;
  const uint32_t qlo = qhi + S::kQ;
  for (int kt = 0; kt < job.n_kt; ++kt) {
    const int s = kt % S::kStages;
    const int k0 = kt * BK;
    uint8_t* ks = smem + S::kRing + s * S::kStage;
    const uint8_t* vs = ks + S::kTile;
    mbar_wait(&full[s], (kt / S::kStages) & 1);
    // K (and V) into high halves in place and low ones after V
    split_tile(ks, ks + 2 * S::kTile, (S::kSplitV ? 2 : 1) * S::kTile,
               threadIdx.x, kConsumers);
    consumers_sync<S::kWarps>();
    if (live && (!job.causal || k0 <= first + 63)) {
      // S = Q . K^T on wgmma: lo.hi + hi.lo + hi.hi, 8 columns of d a step
      const uint32_t khi = smem_u32(ks), klo = khi + 2 * S::kTile;
      float sc[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = 0.0f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const uint32_t col = (j & 3) * 32;
        const uint32_t qo = (j >> 2) * S::kBQ * kLine + col;
        const uint32_t ko = (j >> 2) * BK * kLine + col;
        const uint64_t dqh = sw128_desc(qhi + qo, 0, 1024);
        const uint64_t dkh = sw128_desc(khi + ko, 0, 1024);
        if constexpr (BK == 64) {
          wgmma_tf32_n64(sc, sw128_desc(qlo + qo, 0, 1024), dkh);
          wgmma_tf32_n64(sc, dqh, sw128_desc(klo + ko, 0, 1024));
          wgmma_tf32_n64(sc, dqh, dkh);
        } else {
          wgmma_tf32_n32(sc, sw128_desc(qlo + qo, 0, 1024), dkh);
          wgmma_tf32_n32(sc, dqh, sw128_desc(klo + ko, 0, 1024));
          wgmma_tf32_n32(sc, dqh, dkh);
        }
      }
      wgmma_commit_wait();
      fence_regs(sc);
      const bool masked = (job.causal && k0 + BK - 1 > first) ||
                          k0 + BK > job.Tlen;
      float corr[2];
      softmax_tile<BK / 8>(sc, m, l, corr, row0, k0 + 2 * t, job.Tlen,
                           masked, job.causal, job.scale_log2);
      rescale<D / 8>(o, corr);
      // O += P . V on mma.sync, V split as it is read
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {     // 8 keys a step, permuted
        uint32_t phi[4], plo[4];
        split(sc[4 * kk + 0], phi[0], plo[0]);   // (r,     key 2t)
        split(sc[4 * kk + 2], phi[1], plo[1]);   // (r + 8, key 2t)
        split(sc[4 * kk + 1], phi[2], plo[2]);   // (r,     key 2t + 1)
        split(sc[4 * kk + 3], phi[3], plo[3]);   // (r + 8, key 2t + 1)
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {       // 8 columns of d each
          uint32_t bhi[2], blo[2];
          const float v0 = lds<BK>(vs, 8 * kk + 2 * t, 8 * n + g);
          const float v1 = lds<BK>(vs, 8 * kk + 2 * t + 1, 8 * n + g);
          if constexpr (S::kSplitV) {
            const uint8_t* vlo = vs + 2 * S::kTile;
            bhi[0] = __float_as_uint(v0);
            bhi[1] = __float_as_uint(v1);
            blo[0] = __float_as_uint(lds<BK>(vlo, 8 * kk + 2 * t, 8 * n + g));
            blo[1] = __float_as_uint(
                lds<BK>(vlo, 8 * kk + 2 * t + 1, 8 * n + g));
          } else {
            split(v0, bhi[0], blo[0]);
            split(v1, bhi[1], blo[1]);
          }
          mma_3xtf32(&o[4 * n], phi, plo, bhi, blo);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  if (live) store_rows<float, D / 8>(out, o_st, o, l, row0, 2 * t, job.Tlen,
                                     job.d);
}

// ---------------------------------------------------------------- kernel
template <typename T, int D, int NS>
__global__ void __launch_bounds__(Cfg<T, D, NS>::kThreads,
                                  Cfg<T, D, NS>::kMinBlocks)
flash_attention_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       T* __restrict__ out, long long o_sb, long long o_sh,
                       long long o_st, int H, int group, int Tlen, int d,
                       int causal, float scale_log2) {
  using S = Cfg<T, D, NS>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kBars);
  uint64_t* full = bars;
  uint64_t* empty = bars + S::kStages;
  uint64_t* qbar = bars + 2 * S::kStages;

  const int n_qt = (Tlen + S::kBQ - 1) / S::kBQ;
  const int BH = (int)(gridDim.x / (unsigned)n_qt);
  const int qt = n_qt - 1 - (int)(blockIdx.x / (unsigned)BH);
  const int bh = (int)(blockIdx.x % (unsigned)BH);
  const int b = bh / H, h = bh % H;
  Job job;
  job.q0 = qt * S::kBQ;
  const int k_end = causal ? min(Tlen, job.q0 + S::kBQ) : Tlen;
  job.n_kt = (k_end + S::kBK - 1) / S::kBK;
  job.Tlen = Tlen;
  job.d = d;
  job.causal = causal;
  job.scale_log2 = scale_log2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], S::kWarps);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  if (warp == S::kWarps) {
    // the producer: one thread issues every copy
    if ((threadIdx.x & 31) != 0) return;
    const int hk = h / group;
    mbar_expect_tx(qbar, S::kQ);
    for (int i = 0; i < S::kBoxes; ++i)
      tma_load(smem + i * S::kBQ * kLine, &tq, qbar, i * S::kCols, job.q0, h,
               b);
    for (int kt = 0; kt < job.n_kt; ++kt) {
      const int s = kt % S::kStages;
      if (kt >= S::kStages) mbar_wait(&empty[s], (kt / S::kStages - 1) & 1);
      uint8_t* kd = smem + S::kRing + s * S::kStage;
      mbar_expect_tx(&full[s], 2 * S::kTile);
      for (int i = 0; i < S::kBoxes; ++i) {
        tma_load(kd + i * S::kBK * kLine, &tk, &full[s], i * S::kCols,
                 kt * S::kBK, hk, b);
        tma_load(kd + S::kTile + i * S::kBK * kLine, &tv, &full[s],
                 i * S::kCols, kt * S::kBK, hk, b);
      }
    }
    return;
  }
  T* o = out + (long long)b * o_sb + (long long)h * o_sh;
  if constexpr (std::is_same<T, float>::value)
    consume_tf32<D, NS>(smem, bars, o, o_st, job);
  else
    consume_wgmma<D, NS>(smem, bars, o, o_st, job);
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, looked up once through the runtime
// (no link against libcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

constexpr int kEncodeError = 1000;   // + the CUresult of a failed encode

// a (B, H, T, d) tensor with element strides (sb, sh, st, 1) as a 4-d map
// over (d, T, H, B) whose box is 128 bytes of d by `rows` of T
int encode(CUtensorMap* map, const void* ptr, bool bf16, int B, int H, int T,
           int d, const long long* st, int rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return kEncodeError + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t e = bf16 ? 2 : 4;
  // a dimension of extent 1 is never stepped: give it a stride TMA accepts
  const cuuint64_t row =
      T > 1 ? (cuuint64_t)st[2] * e : ((cuuint64_t)d * e + 15) / 16 * 16;
  const cuuint64_t head = H > 1 ? (cuuint64_t)st[1] * e : row * T;
  const cuuint64_t batch = B > 1 ? (cuuint64_t)st[0] * e : head * H;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)T, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {row, head, batch};
  const cuuint32_t box[4] = {(cuuint32_t)(kLine / e), (cuuint32_t)rows, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map,
      bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      4, const_cast<void*>(ptr), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

template <typename T, int D, int NS>
int launch_d(const void* q, const void* k, const void* v, void* out,
             const long long* strides, int B, int H, int Hkv, int Tlen, int d,
             int causal, float scale_log2, cudaStream_t stream) {
  using S = Cfg<T, D, NS>;
  const bool bf16 = !S::kF32;
  CUtensorMap tq, tk, tv;
  int rc;
  if ((rc = encode(&tq, q, bf16, B, H, Tlen, d, strides, S::kBQ)) ||
      (rc = encode(&tk, k, bf16, B, Hkv, Tlen, d, strides + 3, S::kBK)) ||
      (rc = encode(&tv, v, bf16, B, Hkv, Tlen, d, strides + 6, S::kBK)))
    return rc;
  // above 48 KB a block's shared memory must be asked for, once a device
  static unsigned long long asked = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !(asked >> dev & 1)) {
    err = cudaFuncSetAttribute(flash_attention_kernel<T, D, NS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               S::kBytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) asked |= 1ull << dev;
  }
  const long long blocks = (long long)B * H * ((Tlen + S::kBQ - 1) / S::kBQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const long long* so = strides + 9;
  flash_attention_kernel<T, D, NS>
      <<<(unsigned)blocks, S::kThreads, S::kBytes, stream>>>(
          tq, tk, tv, (T*)out, so[0], so[1], so[2], H, H / Hkv, Tlen, d,
          causal, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out (B, H, T, d) and k, v (B, Hkv, T, d), H a multiple of Hkv, all f32
// (is_bf16 = 0) or all bf16; `strides` holds the element strides (b, h, t)
// of q, k, v and out in that order, 12 values, each last stride 1.  Every
// stride of an extent above 1 is a multiple of 16 bytes and q, k, v lie on
// 16-byte boundaries (the tensor maps' rule; the wrapper pads a copy where
// they do not).  d in 1..128; scale_log2 = log2(e) / sqrt(d).  `stages`
// is the K/V ring's depth (0: the launcher's own, bf16 3 and f32 2; bf16
// also takes 2, any other is refused).  Returns 0, a CUDA error, or 1000 +
// the CUresult of a tensor map that failed to encode.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out,
                                      const long long* strides, int B, int H,
                                      int Hkv, int Tlen, int d, int causal,
                                      int is_bf16, float scale_log2,
                                      int stages, void* stream) {
  if (B <= 0 || H <= 0 || Tlen <= 0) return 0;
  if (d < 1 || d > 128 || Hkv <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const int ns = stages ? stages : is_bf16 ? 3 : 2;
  cudaStream_t s = (cudaStream_t)stream;
#define FLASH_LAUNCH(T, D, NS)                                             \
  return launch_d<T, D, NS>(q, k, v, out, strides, B, H, Hkv, Tlen, d,     \
                            causal, scale_log2, s)
  if (is_bf16 && ns == 3) {
    if (d <= 64) FLASH_LAUNCH(__nv_bfloat16, 64, 3);
    FLASH_LAUNCH(__nv_bfloat16, 128, 3);
  }
  if (is_bf16 && ns == 2) {
    if (d <= 64) FLASH_LAUNCH(__nv_bfloat16, 64, 2);
    FLASH_LAUNCH(__nv_bfloat16, 128, 2);
  }
  if (is_bf16 || ns != 2) return (int)cudaErrorInvalidValue;
  if (d <= 32) FLASH_LAUNCH(float, 32, 2);
  if (d <= 64) FLASH_LAUNCH(float, 64, 2);
  if (d <= 96) FLASH_LAUNCH(float, 96, 2);
  FLASH_LAUNCH(float, 128, 2);
#undef FLASH_LAUNCH
}

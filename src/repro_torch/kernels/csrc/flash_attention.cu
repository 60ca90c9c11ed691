// flash_attention: blockwise softmax attention with an online softmax,
// causal or full, for the LM stack's prefill.
//
//   out[bh, i, :] = sum_j softmax_j(q[bh, i] . k[bh, j] / sqrt(d)) v[bh, j, :]
//   (under `causal` only the keys j <= i take part)
//
// q, k, v and out are (BH, T, d), contiguous, all f32 or all bf16; the math
// is f32 and the output is rounded once to the input's type.
//
// Replaces the TPU kernel `flash_attention_kernel` / `_flash_kernel` in
// src/repro/kernels/flash_attention.py, whose grid walked (bh, q-block,
// k-block) with the k-block innermost and sequential, carrying the running
// max, denominator and accumulator across k-steps in VMEM scratch, visiting
// fully masked causal tiles too; its wrapper (kernels/dispatch.py
// `_pallas_flash_attention`) padded d to 128 lanes with a pre-scale of q
// and clamped the blocks to divisors of T.  None of that carries over: here
// d is any value up to 128 (padded with zeros in shared memory only, the
// scale is that of the true d), T is any length (the ragged tail is
// masked), and the k-loop runs inside one block.
//
// Bound on the H100: the operations.  At the LM path's shape (B 4, H 16,
// T 512, d 64) the causal work is 2 BH T^2 d = 2.1 GFLOP against 33.6 MB of
// q, k, v and out, some 64 FLOP per byte, far above the card's f32 ratio of
// about 20.  This first kernel does its math in f32 on the CUDA cores (no
// tensor cores: TF32 would not hold the f32 tolerance), so its ceiling is
// the 67 TFLOP/s f32 rate.
//
// Design: one block of 256 threads per (bh, 64-row q tile); blocks are
// numbered so that the q tiles with the most causal work start first.  Q is
// staged once into shared memory as f32; K and V tiles of 64 rows follow in
// order.  Thread (ty, tx) of the 16 x 16 grid owns q rows 4ty..4ty+3: it
// computes their scores against keys tx + 16j (j < 4), so the 16 threads of
// one half-warp hold a whole row and reduce its max and sum with shuffles;
// the probabilities go through shared memory (transposed, so a thread reads
// its four rows as one float4) for the product with V, where the thread owns
// output columns tx*DC..tx*DC+DC-1 (DC = padded d / 16).  Running max,
// denominator and accumulator stay in registers in f32, in base 2 (the scale
// carries log2 e).  Under causality the k-tiles past the diagonal are
// skipped (their probabilities are 0, so the output does not change) and
// the diagonal tile is masked.  The k-tile order is fixed and there are no
// atomics: the result is the same from run to run.  Shared-memory rows of
// Q, K and P carry 4 floats of padding so the float4 reads of a quarter-warp
// fall on distinct banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // k rows per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPad = 4;        // floats of padding per shared row

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// rows [r0, r0 + kRows) of a (T, d) matrix into shared rows of `stride`
// floats, as f32; rows past T and columns past d are zero
template <typename T, int D, int kRows>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* __restrict__ src, int r0,
                                          int n_rows, int d) {
  for (int idx = threadIdx.x; idx < kRows * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    float val = 0.0f;
    if (r0 + r < n_rows && c < d) val = to_f32(src[(size_t)(r0 + r) * d + c]);
    dst[r * stride + c] = val;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int BH,
                       int Tlen, int d, int causal, float scale_log2) {
  constexpr int DC = D / 16;           // output columns per thread
  constexpr int QS = D + kPad;         // row strides in floats
  constexpr int KS = D + kPad;
  constexpr int PS = kBQ + kPad;
  extern __shared__ float smem[];
  float* Qs = smem;                    // [kBQ][QS]
  float* Ks = Qs + kBQ * QS;           // [kBK][KS]
  float* Vs = Ks + kBK * KS;           // [kBK][D]
  float* Ps = Vs + kBK * D;            // [kBK][PS], P transposed

  const int n_qt = (Tlen + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - (int)(blockIdx.x / (unsigned)BH);
  const int bh = (int)(blockIdx.x % (unsigned)BH);
  const int q0 = qt * kBQ;
  const size_t base = (size_t)bh * Tlen * d;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<T, D, kBQ>(Qs, QS, q + base, q0, Tlen, d);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }

  const int n_kt = causal ? qt + 1 : (Tlen + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's readers are done
    load_tile<T, D, kBK>(Ks, KS, k + base, k0, Tlen, d);
    load_tile<T, D, kBK>(Vs, D, v + base, k0, Tlen, d);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int dd = 0; dd < D; dd += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * QS + dd]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * KS + dd]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // scale into base 2, mask, and fold the tile into the running softmax
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale_log2;
        if (col >= Tlen || (causal && col > row)) x = -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float m_new = fmaxf(m[i], mx);
      if (m_new == -INFINITY) m_new = 0.0f;   // a row with no key yet
      const float corr = exp2f(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Ps[(tx + 16 * j) * PS + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(&Ps[kk * PS + ty * 4]);
      const float* vrow = &Vs[kk * D + tx * DC];
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = vrow[c];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        acc[0][c] = fmaf(p.x, vv[c], acc[0][c]);
        acc[1][c] = fmaf(p.y, vv[c], acc[1][c]);
        acc[2][c] = fmaf(p.z, vv[c], acc[2][c]);
        acc[3][c] = fmaf(p.w, vv[c], acc[3][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Tlen) continue;
    const float inv = 1.0f / l[i];
    T* orow = out + base + (size_t)row * d;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx * DC + c;
      if (col < d) store(orow + col, acc[i][c] * inv);
    }
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int BH,
             int Tlen, int d, int causal, float scale_log2,
             cudaStream_t stream) {
  constexpr size_t smem =
      sizeof(float) * ((size_t)kBQ * (D + kPad) + (size_t)kBK * (D + kPad) +
                       (size_t)kBK * D + (size_t)kBK * (kBQ + kPad));
  // above 48 KB a block's shared memory must be asked for (per device)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const size_t blocks = (size_t)BH * ((Tlen + kBQ - 1) / kBQ);
  if (blocks > 0x7fffffffULL) return (int)cudaErrorInvalidConfiguration;
  flash_attention_kernel<T, D><<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, BH, Tlen, d, causal,
      scale_log2);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, void* out, int BH,
             int Tlen, int d, int causal, float scale_log2,
             cudaStream_t stream) {
  if (d <= 32)
    return launch_d<T, 32>(q, k, v, out, BH, Tlen, d, causal, scale_log2,
                           stream);
  if (d <= 64)
    return launch_d<T, 64>(q, k, v, out, BH, Tlen, d, causal, scale_log2,
                           stream);
  if (d <= 96)
    return launch_d<T, 96>(q, k, v, out, BH, Tlen, d, causal, scale_log2,
                           stream);
  return launch_d<T, 128>(q, k, v, out, BH, Tlen, d, causal, scale_log2,
                          stream);
}

}  // namespace

// q, k, v, out (BH, T, d), contiguous, f32 (is_bf16 = 0) or bf16; d in
// 1..128; scale_log2 = log2(e) / sqrt(d).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int BH,
                                      int Tlen, int d, int causal, int is_bf16,
                                      float scale_log2, void* stream) {
  if (BH <= 0 || Tlen <= 0) return 0;
  if (d < 1 || d > 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_t<__nv_bfloat16>(q, k, v, out, BH, Tlen, d, causal,
                                   scale_log2, s);
  return launch_t<float>(q, k, v, out, BH, Tlen, d, causal, scale_log2, s);
}

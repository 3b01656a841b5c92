// What the two bf16 WN kernels share (waveglow_wn_bf16.cu,
// waveflow_row_bf16.cu): the block's shape (a producer warpgroup whose
// first thread keeps TMA loads in flight, two consumer warpgroups on
// wgmma), the operand split of an f32 value into three bf16 pieces, the
// gate, the launch of a layer kernel, and the start and end 1x1 products
// as CUDA-core kernels of their own.
//
// Layouts (ops/hopper_kernels.py): activations channel-major [B][C][T'] with
// a row pitch Tp (a multiple of 8, >= T'); weights input-major ([in][out],
// out = (a or res half, channel)); C a multiple of 8 (the caller pads the
// weights with zero channels, which stay zero through every layer). Every
// tensor a kernel reads by TMA is addressed through a map whose dimensions
// are the true sizes, so a box past an end (the sequence's zero padding, the
// channels past C) lands as zeros.
#pragma once
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "bf16_mma.cuh"
#include "tma.cuh"
#include "wgmma_bf16.cuh"

namespace wnb {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 384;        // the producer and two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kMaxRing = 8;          // stages in flight at most
constexpr int kSmemMax = 232448;
constexpr int kSmall = 256;          // threads of the start and end kernels
constexpr int kCo = 8;               // channels a thread of the start and end kernels

// A consumer warpgroup's block of CB channels is a product of N = 2 CB
// columns (the a and g halves, or res and skip, of the same channels),
// staged as 2 CB / AW atoms of AW columns (one TMA box each), swizzled as
// wgmma reads them.
__host__ __device__ constexpr int atom_width(int CB) { return CB < 64 ? CB : 64; }

__host__ __device__ constexpr uint32_t wgmma_layout(int AW) {
  return AW == 64 ? wgmma::kSwizzle128 : AW == 32 ? wgmma::kSwizzle64 : wgmma::kSwizzle32;
}

inline CUtensorMapSwizzle map_swizzle(int AW) {
  return AW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                  : AW == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
}

__host__ __device__ constexpr bool valid_cb(int CB) {
  return CB == 16 || CB == 32 || CB == 64 || CB == 128;
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The split of two f32 values (the low and high halves of an A register)
// into three bf16 pieces each, hi + mid + lo: hi is v rounded to bf16,
// mid the remainder rounded, lo the remainder of that. Each remainder is
// exact in f32, and lo is exact in bf16 (24 significant bits = 3 x 8), so
// the three pieces hold v exactly and the three products with a bf16 weight
// are exact: f32 arithmetic on bf16 weights, as JAX's dot of a bf16 and an
// f32 array computes.
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = v0 - hf.x, r1 = v1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = as_u32(h);
  mid = as_u32(m);
  lo = as_u32(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
}

// JAX's gated tanh unit: tanh(a) * sigmoid(g).
__device__ __forceinline__ float gtu(float a, float g) {
  return tanhf(a) / (1.f + expf(-g));
}

// The dynamic shared memory of a kernel template, set once per size.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem, int& allowed) {
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) allowed = smem;
  return e;
}

// A weight tensor [layers][rows][C][2][C'] (rows kernel taps, each C input
// channels; out = (half, channel), C' = C) as a map of 5 dims (channel,
// half, input channel, row, layer), box AW x 1 x KC x 1 x 1: one atom of a
// stage. rows == 0: [layers][C][2][C] as 4 dims.
inline int encode_weights(CUtensorMap* map, const bf16* w, int C, int rows, int layers,
                          int AW, int KC) {
  const cuuint64_t row = (cuuint64_t)2 * C * 2, mat = row * C;
  if (rows > 0) {
    const cuuint64_t dims[5] = {(cuuint64_t)C, 2, (cuuint64_t)C, (cuuint64_t)rows,
                                (cuuint64_t)layers};
    const cuuint64_t strides[4] = {(cuuint64_t)C * 2, row, mat, mat * rows};
    const cuuint32_t box[5] = {(cuuint32_t)AW, 1, (cuuint32_t)KC, 1, 1};
    return tma::encode_bf16(map, w, 5, dims, strides, box, map_swizzle(AW));
  }
  const cuuint64_t dims[4] = {(cuuint64_t)C, 2, (cuuint64_t)C, (cuuint64_t)layers};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, row, mat};
  const cuuint32_t box[4] = {(cuuint32_t)AW, 1, (cuuint32_t)KC, 1};
  return tma::encode_bf16(map, w, 4, dims, strides, box, map_swizzle(AW));
}

// h[b][c][t] = sum_ci w[ci][c] * bf16(x[b][ci][t]) + bias[c] (WaveGlow:
// JAX's start product takes x rounded to bf16, adds the f32 bias after the
// dot, and keeps h f32). grid (ceil(T / kSmall), ceil(C / kCo), B).
__global__ void __launch_bounds__(kSmall)
glow_start(const float* __restrict__ x, const bf16* __restrict__ w,
           const float* __restrict__ bias, int Cin, int C, int T, int Tp,
           float* __restrict__ h) {
  const int t = blockIdx.x * kSmall + threadIdx.x;
  if (t >= T) return;
  const int b = blockIdx.z, c0 = blockIdx.y * kCo, n = min(kCo, C - c0);
  float acc[kCo];
#pragma unroll
  for (int i = 0; i < kCo; ++i) acc[i] = 0.f;
  for (int ci = 0; ci < Cin; ++ci) {
    const float xv = bf2f(__float2bfloat16(x[((size_t)b * Cin + ci) * T + t]));
#pragma unroll
    for (int i = 0; i < kCo; ++i)
      if (i < n) acc[i] = fmaf(bf2f(w[(size_t)ci * C + c0 + i]), xv, acc[i]);
  }
#pragma unroll
  for (int i = 0; i < kCo; ++i)
    if (i < n) h[((size_t)b * C + c0 + i) * Tp + t] = __fadd_rn(acc[i], bias[c0 + i]);
}

// h[b][c][t] = bf16(w[c] * x[b][t] + bias[c]) (WaveFlow's one input
// channel: the product and the sum each rounded in f32, then to bf16, as
// JAX's start computes it) into a ring slot. grid as glow_start's.
__global__ void __launch_bounds__(kSmall)
flow_start(const float* __restrict__ x, const bf16* __restrict__ w,
           const bf16* __restrict__ bias, int C, int W, int Wp, bf16* __restrict__ h) {
  const int t = blockIdx.x * kSmall + threadIdx.x;
  if (t >= W) return;
  const int b = blockIdx.z, c0 = blockIdx.y * kCo, n = min(kCo, C - c0);
  const float xv = x[(size_t)b * W + t];
#pragma unroll
  for (int i = 0; i < kCo; ++i)
    if (i < n)
      h[((size_t)b * C + c0 + i) * Wp + t] = __float2bfloat16(
          __fadd_rn(__fmul_rn(bf2f(w[c0 + i]), xv), bf2f(bias[c0 + i])));
}

// st[b][o][t] = sum_c w[c][o] * skip[b][c][t] + bias[o] (kRound: skip
// rounded to bf16 first, WaveFlow's end). grid (ceil(T / 32), ceil(Cout /
// kCo), B), kSmall threads: warp q sums channels q, q + 8, ... for the
// block's 32 samples (one a lane), and the 8 partial sums of each output
// meet in shared memory.
template <bool kRound>
__global__ void __launch_bounds__(kSmall)
wn_end(const float* __restrict__ skip, const bf16* __restrict__ w,
       const float* __restrict__ bias, int C, int Cout, int T, int Tp,
       float* __restrict__ st) {
  constexpr int kWarps = kSmall / 32;
  static_assert(kWarps == kCo, "a warp sums each output's partials");
  __shared__ float part[kWarps][kCo][32];
  const int q = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * 32 + lane;
  const int b = blockIdx.z, o0 = blockIdx.y * kCo, n = min(kCo, Cout - o0);
  float acc[kCo];
#pragma unroll
  for (int i = 0; i < kCo; ++i) acc[i] = 0.f;
  if (t < T)
    for (int c = q; c < C; c += kWarps) {
      float v = skip[((size_t)b * C + c) * Tp + t];
      if (kRound) v = bf2f(__float2bfloat16(v));
#pragma unroll
      for (int i = 0; i < kCo; ++i)
        if (i < n) acc[i] = fmaf(bf2f(w[(size_t)c * Cout + o0 + i]), v, acc[i]);
    }
#pragma unroll
  for (int i = 0; i < kCo; ++i) part[q][i][lane] = acc[i];
  __syncthreads();
  if (q < n && t < T) {
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < kWarps; ++r) sum += part[r][q][lane];
    st[((size_t)b * Cout + o0 + q) * T + t] = __fadd_rn(sum, bias[o0 + q]);
  }
}

inline dim3 small_grid(int T, int C, int B) {
  return dim3((T + kSmall - 1) / kSmall, (C + kCo - 1) / kCo, B);
}

inline dim3 end_grid(int T, int Cout, int B) {
  return dim3((T + 31) / 32, (Cout + kCo - 1) / kCo, B);
}

inline bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

}  // namespace wnb

// One dilation pair of a HiFi-GAN MRF ResBlock1, fused:
//   y = x + conv2(lrelu(conv1(lrelu(x), dilation d)), dilation 1)
// with both convs k taps, C -> C channels, zero padding at the sequence
// edges (torch's symmetric "same" padding).
//
// Replaces the TPU kernel cookietts_tpu/ops/pallas_kernels.py:
// hifigan_resblock (body _hifigan_resblock_kernel), which keeps a whole
// resblock (all three dilation pairs) resident per tile. Here one launch is
// one dilation pair, so a resblock is 3 launches: at C=256 in f32 with the
// k=11 halo of a whole resblock ((k//2) * sum(d+1) = 60 on each side) the
// tile would not fit the 227 KB of shared memory a block may use, while one
// pair's halo ((k//2) * (d+1) <= 30) does. Between pairs the activation goes
// through device memory once; inside a pair the intermediate never does.
//
// Bound on the H100: operations. A pair does 4*C*C*k flops per sample
// (2*C*C*k per conv) against 8*C bytes of activation in and out, so it sits
// far above the card's flop-per-byte balance: the f32 rate bounds it.
// Design: one block per (batch row, time tile). The tile of lrelu(x) plus
// both convs' halos is staged in shared memory, conv1 writes
// lrelu(conv1 + b1) for the tile plus conv2's halo into a second shared
// buffer (zeroed outside [0, T), which is conv2's zero padding), and conv2
// reads it from there. Each thread owns an 8-channel x 8-sample register
// tile; weights are stored [k][C_in][C_out] so a thread's 8 output channels
// are two float4 loads, and the activations come from shared memory. The
// conv1 span (tile plus conv2's halo) is 16384 / C samples (64 at C=256,
// 512 at C=32), so 256 threads cover it in exactly one pass; the tile
// itself is that span less conv2's halo, and conv2 covers it in one pass
// too. The residual x is re-read from device memory at the tile's own
// samples when y is written.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCo = 8;   // output channels per thread
constexpr int kT = 8;    // samples per thread

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v >= 0.f ? v : v * slope;
}

// acc[i][j] += sum_{tap, ci} w[tap][ci][co0 + i] * src[ci][s0 + j + tap*dil]
__device__ __forceinline__ void conv_tile(const float* __restrict__ src,
                                          int src_stride, int s0,
                                          const float* __restrict__ w, int C,
                                          int K, int dil, int co0,
                                          float (&acc)[kCo][kT]) {
  for (int tap = 0; tap < K; ++tap) {
    const float* wt = w + (size_t)tap * C * C + co0;
    const float* st = src + s0 + tap * dil;
#pragma unroll 4
    for (int ci = 0; ci < C; ++ci) {
      const float4 wa = __ldg(reinterpret_cast<const float4*>(wt + (size_t)ci * C));
      const float4 wb = __ldg(reinterpret_cast<const float4*>(wt + (size_t)ci * C + 4));
      const float wv[kCo] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
      const float* sr = st + ci * src_stride;
      float xv[kT];
#pragma unroll
      for (int j = 0; j < kT; ++j) xv[j] = sr[j];
#pragma unroll
      for (int i = 0; i < kCo; ++i)
#pragma unroll
        for (int j = 0; j < kT; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
resblock_pair_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                     const float* __restrict__ b1, const float* __restrict__ w2,
                     const float* __restrict__ b2, int C, int T, int K, int dil,
                     float slope, float* __restrict__ y) {
  extern __shared__ float smem[];
  const int half = K / 2;
  const int halo1 = half * dil;             // conv1's reach
  const int halo2 = half;                   // conv2's reach
  const int co_groups = C / kCo;
  const int t_groups = kThreads / co_groups;
  const int hw = t_groups * kT;             // conv1 outputs (one pass)
  const int Wt = hw - 2 * halo2;            // output samples per tile
  const int xw = hw + 2 * halo1;            // x samples needed by conv1
  // conv2's last chunk reads up to 2 * halo2 columns past hw (outputs
  // that are discarded), so the h rows carry that much slack
  const int xs_stride = xw, hs_stride = hw + 2 * halo2;
  float* xs = smem;                         // [C][xs_stride] lrelu(x)
  float* hs = smem + (size_t)C * xs_stride; // [C][hs_stride] lrelu(conv1)

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * Wt;
  const int hbase = t0 - halo2;             // global sample of hs column 0
  const int xbase = hbase - halo1;          // global sample of xs column 0
  const float* xb = x + (size_t)b * C * T;

  for (int i = threadIdx.x; i < C * xw; i += kThreads) {
    const int ci = i / xw, s = i - ci * xw;
    const int p = xbase + s;
    xs[i] = (p >= 0 && p < T) ? lrelu(xb[(size_t)ci * T + p], slope) : 0.f;
  }
  __syncthreads();

  const int cg = threadIdx.x / t_groups, tg = threadIdx.x - cg * t_groups;
  const int co0 = cg * kCo;

  // conv1 over hs columns [0, hw): one chunk of kT samples per thread
  {
    const int s0 = tg * kT;
    float acc[kCo][kT];
#pragma unroll
    for (int i = 0; i < kCo; ++i) {
      const float bi = b1[co0 + i];
#pragma unroll
      for (int j = 0; j < kT; ++j) acc[i][j] = bi;
    }
    conv_tile(xs, xs_stride, s0, w1, C, K, dil, co0, acc);
#pragma unroll
    for (int i = 0; i < kCo; ++i)
#pragma unroll
      for (int j = 0; j < kT; ++j) {
        const int p = hbase + s0 + j;
        hs[(size_t)(co0 + i) * hs_stride + s0 + j] =
            (p >= 0 && p < T) ? lrelu(acc[i][j], slope) : 0.f;
      }
  }
  __syncthreads();

  // conv2 over the tile's own samples [t0, t0 + Wt): one chunk per thread
  if (tg * kT < Wt) {
    const int s0 = tg * kT;
    float acc[kCo][kT];
#pragma unroll
    for (int i = 0; i < kCo; ++i) {
      const float bi = b2[co0 + i];
#pragma unroll
      for (int j = 0; j < kT; ++j) acc[i][j] = bi;
    }
    conv_tile(hs, hs_stride, s0, w2, C, K, 1, co0, acc);
#pragma unroll
    for (int i = 0; i < kCo; ++i)
#pragma unroll
      for (int j = 0; j < kT; ++j) {
        const int p = t0 + s0 + j;
        if (s0 + j < Wt && p < T) {
          const size_t o = ((size_t)b * C + co0 + i) * T + p;
          y[o] = x[o] + acc[i][j];
        }
      }
  }
}

}  // namespace

// Shared memory a launch needs, in bytes (the wrapper checks it first).
extern "C" long long hifigan_resblock_smem(int C, int K, int dil) {
  const int hw = kThreads / (C / kCo) * kT;
  const int xw = hw + 2 * (K / 2) * dil;
  return (long long)C * (xw + hw + 2 * (K / 2)) * sizeof(float);
}

extern "C" int hifigan_resblock_pair(const float* x, const float* w1,
                                     const float* b1, const float* w2,
                                     const float* b2, int B, int C, int T, int K,
                                     int dil, float slope, float* y,
                                     void* stream) {
  const int Wt = kThreads / (C / kCo) * kT - 2 * (K / 2);
  const size_t smem = (size_t)hifigan_resblock_smem(C, K, dil);
  cudaError_t err = cudaFuncSetAttribute(
      resblock_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + Wt - 1) / Wt, B);
  resblock_pair_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, w1, b1, w2, b2, C, T, K, dil, slope, y);
  return (int)cudaGetLastError();
}

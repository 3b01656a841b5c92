// One LSTM gate step, fused: the [B,F] x [F,4H] gate product, the gate
// nonlinearities and the cell update, pre-zoneout.
//
// Replaces the TPU kernel cookietts_tpu/ops/pallas_kernels.py:lstm_gates_step
// (body _lstm_kernel). Computes, with W the untouched [F, 4H] gate matrix
// (gate blocks i, f, g, o of width H):
//   gates = xh @ W + bias
//   c' = sigmoid(f + 1) * c + sigmoid(i) * tanh(g)
//   h' = sigmoid(o) * tanh(c')
//
// Bound on the H100: bytes. At decode batch the step is a skinny product
// that must stream all of W (F*4H floats) for a handful of rows: at F=2816,
// H=1280 that is 57.7 MB a step against 2*B*F flops per column.
// Design: the product kernel gives each block 32 neighbouring columns j of
// every gate (one per lane, so each warp reads 128 contiguous bytes of a W
// row per gate), a group of kRows batch rows, and one of S slices of F; its
// 8 warps split the slice again and keep the 4 x kRows partial sums in
// registers, so W is read once per row group. S is chosen by the caller so
// that a decode-size batch still puts a few hundred blocks on the card (a
// stream of W needs many loads in flight). The warps' sums meet in shared
// memory and each block writes one [4, kRows, 32] partial; a second small
// kernel adds the S partials and the bias and runs the f32 epilogue, writing
// only c' and h'. The [B, 4H] gate block reaches device memory only as the
// S partials (S*B*4H floats, under 2% of W's bytes at the serving shapes).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLanes = 32;   // columns j per block
constexpr int kWarps = 8;    // sub-slices of F per block
constexpr int kRows = 8;     // batch rows per block

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// partial[s][b][g*H + j] = sum over F slice s of xh[b, f] * W[f, g*H + j]
__global__ void __launch_bounds__(kLanes * kWarps)
lstm_gates_product_kernel(const float* __restrict__ xh,
                          const float* __restrict__ W, int B, int F, int H,
                          int f_per_slice, float* __restrict__ partial) {
  __shared__ float part[kWarps][4][kRows][kLanes];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x * kLanes + lane;
  const int b0 = blockIdx.y * kRows;
  const int nb = min(kRows, B - b0);
  const int slice = blockIdx.z;

  float acc[4][kRows];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[g][r] = 0.f;

  if (j < H) {
    const int fs0 = slice * f_per_slice, fs1 = min(F, fs0 + f_per_slice);
    const int chunk = (fs1 - fs0 + kWarps - 1) / kWarps;
    const int f0 = fs0 + warp * chunk, f1 = min(fs1, f0 + chunk);
    const size_t H4 = 4 * (size_t)H;
#pragma unroll 4
    for (int f = f0; f < f1; ++f) {
      const float* wrow = W + f * H4 + j;
      const float w0 = __ldg(wrow), w1 = __ldg(wrow + H);
      const float w2 = __ldg(wrow + 2 * H), w3 = __ldg(wrow + 3 * H);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < nb) {
          const float x = __ldg(xh + (size_t)(b0 + r) * F + f);
          acc[0][r] = fmaf(w0, x, acc[0][r]);
          acc[1][r] = fmaf(w1, x, acc[1][r]);
          acc[2][r] = fmaf(w2, x, acc[2][r]);
          acc[3][r] = fmaf(w3, x, acc[3][r]);
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int r = 0; r < kRows; ++r) part[warp][g][r][lane] = acc[g][r];
  __syncthreads();

  // thread (r, lane) writes the block's sums for batch row b0 + r, column j
  const int r = threadIdx.x / kLanes;
  if (r >= nb || j >= H) return;
  float* out = partial + ((size_t)slice * B + b0 + r) * 4 * H + j;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) s += part[k][g][r][lane];
    out[g * H] = s;
  }
}

__global__ void lstm_gates_epilogue_kernel(const float* __restrict__ partial,
                                           const float* __restrict__ bias,
                                           const float* __restrict__ c_prev,
                                           int B, int H, int slices,
                                           float* __restrict__ c_out,
                                           float* __restrict__ h_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * H) return;
  const int b = i / H, j = i - b * H;
  float g[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float s = bias[k * H + j];
    for (int sl = 0; sl < slices; ++sl)
      s += partial[((size_t)sl * B + b) * 4 * H + k * H + j];
    g[k] = s;
  }
  const float c = sigmoidf(g[1] + 1.f) * c_prev[i] + sigmoidf(g[0]) * tanhf(g[2]);
  c_out[i] = c;
  h_out[i] = sigmoidf(g[3]) * tanhf(c);
}

}  // namespace

// partial: caller-allocated scratch of slices * B * 4H floats.
extern "C" int lstm_gates(const float* xh, const float* W, const float* bias,
                          const float* c_prev, int B, int F, int H, int slices,
                          float* partial, float* c_out, float* h_out,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int f_per_slice = (F + slices - 1) / slices;
  const dim3 grid((H + kLanes - 1) / kLanes, (B + kRows - 1) / kRows, slices);
  lstm_gates_product_kernel<<<grid, kLanes * kWarps, 0, st>>>(
      xh, W, B, F, H, f_per_slice, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lstm_gates_epilogue_kernel<<<(B * H + 255) / 256, 256, 0, st>>>(
      partial, bias, c_prev, B, H, slices, c_out, h_out);
  return (int)cudaGetLastError();
}

// One LSTM gate step, fused into one launch: the [B,F] x [F,4H] gate
// product, the gate nonlinearities and the cell update, pre-zoneout.
//
// Replaces the TPU kernel cookietts_tpu/ops/pallas_kernels.py:lstm_gates_step
// (:236, body _lstm_kernel :195; fused_lstm_gates :286). Computes, with W the
// untouched [F, 4H] gate matrix (gate blocks i, f, g, o of width H):
//   gates = xh @ W + bias
//   c' = sigmoid(f + 1) * c + sigmoid(i) * tanh(g)
//   h' = sigmoid(o) * tanh(c')
//
// Bound on the H100: bytes. At decode batch (B <= 32) the step does at most
// 2 * B / 4 = 16 flops per byte of W, under the card's f32 balance of 20, and
// W is nearly all the bytes: 57.7 MB at F=2816, H=1280, 31.5 and 18.9 MB for
// the two 768-wide cells, 32 us a decode step at 3.35 TB/s.
//
// Design (v3): one launch per cell, W streamed once in 16-byte copies.
// - Grid (col_tiles, slices, row_groups), sized by lstm_gates_plan
//   (ops/hopper_kernels.py) to about two blocks per SM of the card's 132: a
//   block owns 64 columns of each of the four gate blocks (256 columns of W,
//   1 KB of every row) and one of `slices` equal runs of W's F rows, so every
//   element of W belongs to exactly one block and blocks take equal shares.
// - W goes through shared memory in stages of kStageRows rows with cp.async
//   (16 bytes a copy, kStages stages in flight, past the L1), so about 48 KB
//   of loads are in flight per block while it computes on an earlier stage.
// - All batch rows of a row group (up to 32) are handled by the block that
//   streams the W tile: the block's xh slice is staged in shared memory,
//   and each thread owns 4 adjacent columns of one gate for a quarter of the
//   rows, so W is read once for B <= 32 (once per group of 32 beyond that).
// - Split-K reduction inside the launch, by ticket: each block writes its
//   [rows][4 x 64] partial sums to `partial`, fences, and takes a ticket from
//   the counter of its (row group, column tile) with atomicAdd. The block that
//   draws ticket slices - 1 is the last to arrive: it adds the partials of
//   slices 0 .. slices-1 in that fixed order (so the result is the same bits
//   on every call, whatever order the blocks ran in), adds the bias, runs the
//   f32 epilogue, writes c' and h', and stores 0 back into the counter, so the
//   next call, or the next replay of a CUDA graph, finds every counter at 0.
//   The counters are the caller's: zeroed once when allocated, then left at
//   0 by every launch. Two launches that run at once must not share them, so
//   the caller keeps one set per stream and one per CUDA-graph capture
//   (_tickets in ops/hopper_kernels.py; lstm_capture_id below tells it which
//   capture a launch is recorded into).
//
// The bf16 form is a kernel of its own (TMA-fed, split-K reduced in a
// thread-block cluster): lstm_gates_bf16.cu.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 64;                  // columns of each gate per block
constexpr int kGroups = 4 * kCols / 4;     // float4 column groups per block
static_assert(kThreads / kGroups == 4, "four row quarters");
constexpr int kGroupRows = 32;             // batch rows per row group
constexpr int kStageRows = 16;             // W rows per pipeline stage
constexpr int kStages = 4;
constexpr int kTileFloats = kStageRows * 4 * kCols;   // one stage: 16 KB

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ void copy_async16(float* dst, const float* src,
                                             bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void copy_async4(float* dst, const float* src,
                                            bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// One stage of the block's W rows [f, f + kStageRows) x its 256 columns:
// ws[r][g * kCols + c] = W[f + r][g * H + j0 + c]; rows past f1 and columns
// past H are zeros. vec: H % 4 == 0, so 16-byte copies are aligned.
__device__ __forceinline__ void load_stage(float* ws, const float* __restrict__ W,
                                           int f, int f1, int H, int j0,
                                           bool vec) {
  const size_t H4 = 4 * (size_t)H;
  if (vec) {
    for (int i = threadIdx.x; i < kStageRows * kGroups; i += kThreads) {
      const int r = i / kGroups, q = i - r * kGroups;
      const int g = q / (kCols / 4), c = (q - g * (kCols / 4)) * 4;
      const bool ok = f + r < f1 && j0 + c < H;
      const float* src = ok ? W + (f + r) * H4 + g * H + j0 + c : W;
      copy_async16(ws + r * 4 * kCols + g * kCols + c, src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kStageRows * 4 * kCols; i += kThreads) {
      const int r = i / (4 * kCols), q = i - r * 4 * kCols;
      const int g = q / kCols, c = q - g * kCols;
      const bool ok = f + r < f1 && j0 + c < H;
      const float* src = ok ? W + (f + r) * H4 + g * H + j0 + c : W;
      copy_async4(ws + i, src, ok);
    }
  }
}

// RB: batch rows per thread (each of the 4 row quarters), 4 * RB <= 32.
template <int RB>
__global__ void __launch_bounds__(kThreads)
lstm_gates_kernel(const float* __restrict__ xh, const float* __restrict__ W,
                  const float* __restrict__ bias,
                  const float* __restrict__ c_prev, int B, int F, int H,
                  int f_per_slice, float* __restrict__ partial,
                  int* __restrict__ tickets, float* __restrict__ c_out,
                  float* __restrict__ h_out) {
  extern __shared__ float smem[];
  float* ws = smem;                                  // [kStages][tile]
  float* xs = smem + kStages * kTileFloats;          // [f_per_slice][4 * RB]
  __shared__ int ticket;

  const int tile = blockIdx.x, slice = blockIdx.y, group = blockIdx.z;
  const int slices = gridDim.y;
  const int j0 = tile * kCols;
  const int b0 = group * kGroupRows;
  const int nb = min(4 * RB, B - b0);               // rows of this pass
  const int f0 = slice * f_per_slice, f1 = min(F, f0 + f_per_slice);
  const int nf = max(0, f1 - f0);
  const int n_stages = (nf + kStageRows - 1) / kStageRows;
  const bool vec = (H & 3) == 0;

  // the first kStages - 1 stages of W, then xh while they fly
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages)
      load_stage(ws + s * kTileFloats, W, f0 + s * kStageRows, f1, H, j0, vec);
    commit_async();
  }
  for (int i = threadIdx.x; i < nf * 4 * RB; i += kThreads) {
    const int f = i / (4 * RB), r = i - f * (4 * RB);
    xs[i] = r < nb ? xh[(size_t)(b0 + r) * F + f0 + f] : 0.f;
  }

  const int q = threadIdx.x % kGroups;               // column group
  const int quarter = threadIdx.x / kGroups;         // rows quarter*RB + i
  const int g = q / (kCols / 4), c = (q - g * (kCols / 4)) * 4;
  float4 acc[RB];
#pragma unroll
  for (int i = 0; i < RB; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const bool active = quarter * RB < nb;

  for (int s = 0; s < n_stages; ++s) {
    const int next = s + kStages - 1;
    if (next < n_stages)
      load_stage(ws + (next % kStages) * kTileFloats, W,
                 f0 + next * kStageRows, f1, H, j0, vec);
    commit_async();
    wait_async<kStages - 1>();
    __syncthreads();
    if (active) {
      const float* wt = ws + (s % kStages) * kTileFloats + g * kCols + c;
      const int rows = min(kStageRows, nf - s * kStageRows);
      const float* xr = xs + (s * kStageRows) * 4 * RB + quarter * RB;
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        const float4 w = *reinterpret_cast<const float4*>(wt + r * 4 * kCols);
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          const float x = xr[r * 4 * RB + i];
          acc[i].x = fmaf(w.x, x, acc[i].x);
          acc[i].y = fmaf(w.y, x, acc[i].y);
          acc[i].z = fmaf(w.z, x, acc[i].z);
          acc[i].w = fmaf(w.w, x, acc[i].w);
        }
      }
    }
    __syncthreads();
  }

  // partial[slice][b][g * H + j]
  const size_t H4 = 4 * (size_t)H;
  if (active) {
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const int r = quarter * RB + i;
      if (r >= nb) break;
      float* out = partial + ((size_t)slice * B + b0 + r) * H4 + g * H + j0 + c;
      const float v[4] = {acc[i].x, acc[i].y, acc[i].z, acc[i].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j0 + c + e < H) out[e] = v[e];
    }
  }
  __threadfence();
  __syncthreads();
  int* counter = tickets + group * gridDim.x + tile;
  if (threadIdx.x == 0) ticket = atomicAdd(counter, 1);
  __syncthreads();
  if (ticket != slices - 1) return;

  // the last block of this (row group, column tile): fixed-order sum
  __threadfence();
  for (int i = threadIdx.x; i < nb * kCols; i += kThreads) {
    const int r = i / kCols, j = j0 + (i - r * kCols);
    if (j >= H) continue;
    const int b = b0 + r;
    float gs[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) gs[k] = 0.f;
    const float* p = partial + (size_t)b * H4 + j;
#pragma unroll 8
    for (int sl = 0; sl < slices; ++sl) {
#pragma unroll
      for (int k = 0; k < 4; ++k) gs[k] += __ldcg(p + k * H);
      p += (size_t)B * H4;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) gs[k] += bias[k * H + j];
    const size_t o = (size_t)b * H + j;
    const float cn = sigmoidf(gs[1] + 1.f) * c_prev[o] + sigmoidf(gs[0]) * tanhf(gs[2]);
    c_out[o] = cn;
    h_out[o] = sigmoidf(gs[3]) * tanhf(cn);
  }
  if (threadIdx.x == 0) *counter = 0;
}

template <int RB>
int launch(const float* xh, const float* W, const float* bias,
           const float* c_prev, int B, int F, int H, int col_tiles,
           int slices, int f_per_slice, float* partial, int* tickets,
           float* c_out, float* h_out, cudaStream_t st) {
  const size_t smem =
      (kStages * kTileFloats + (size_t)f_per_slice * 4 * RB) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_gates_kernel<RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(col_tiles, slices, (B + kGroupRows - 1) / kGroupRows);
  lstm_gates_kernel<RB><<<grid, kThreads, smem, st>>>(
      xh, W, bias, c_prev, B, F, H, f_per_slice, partial, tickets, c_out,
      h_out);
  return (int)cudaGetLastError();
}

}  // namespace

// The launch plan (col_tiles, slices, f_per_slice) comes from
// lstm_gates_plan in ops/hopper_kernels.py. partial: scratch of
// slices * B * 4H floats; tickets: ceil(B / 32) * col_tiles ints, all 0.
extern "C" int lstm_gates(const float* xh, const float* W, const float* bias,
                          const float* c_prev, int B, int F, int H,
                          int col_tiles, int slices, int f_per_slice,
                          float* partial, int* tickets, float* c_out,
                          float* h_out, void* stream) {
  if (col_tiles * kCols < H || slices * f_per_slice < F) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = B < kGroupRows ? B : kGroupRows;
  if (rows <= 4)
    return launch<1>(xh, W, bias, c_prev, B, F, H, col_tiles, slices,
                     f_per_slice, partial, tickets, c_out, h_out, st);
  if (rows <= 8)
    return launch<2>(xh, W, bias, c_prev, B, F, H, col_tiles, slices,
                     f_per_slice, partial, tickets, c_out, h_out, st);
  if (rows <= 16)
    return launch<4>(xh, W, bias, c_prev, B, F, H, col_tiles, slices,
                     f_per_slice, partial, tickets, c_out, h_out, st);
  return launch<8>(xh, W, bias, c_prev, B, F, H, col_tiles, slices,
                   f_per_slice, partial, tickets, c_out, h_out, st);
}

// The id of the CUDA-graph capture under way on `stream` (unique in the
// process), or 0 when the stream is not capturing.
extern "C" int lstm_capture_id(void* stream, unsigned long long* id) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long capture = 0;
  const cudaError_t err =
      cudaStreamGetCaptureInfo((cudaStream_t)stream, &status, &capture);
  *id = status == cudaStreamCaptureStatusActive ? capture : 0;
  return (int)err;
}

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
// - W goes through shared memory in stages of 16 KB (16 rows) with cp.async
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
// The bf16 form (lstm_gates_bf16): xh, W and the bias are bf16, c_prev, c'
// and h' f32, all math f32, as the JAX package's Pallas path computes on
// the bf16-rounded operands (cookietts_tpu/ops/lstm.py:64-70,
// pallas_kernels.py:253-256). W's rows are half the bytes: a stage holds 32
// rows (still 16 KB), each 16-byte copy 8 values, and a thread widens its 4
// columns (8 bytes) to f32 in registers; xh is widened as it is staged and
// the bias in the epilogue. Partial sums, tickets and the epilogue are the
// f32 form's. Its bound is half the f32 form's: 16 us a decode step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 64;                  // columns of each gate per block
constexpr int kGroups = 4 * kCols / 4;     // 4-column groups per block
static_assert(kThreads / kGroups == 4, "four row quarters");
constexpr int kGroupRows = 32;             // batch rows per row group
constexpr int kStages = 4;
constexpr int kStageBytes = 16384;         // one stage of W

// E: the type of W, xh and the bias (float or __nv_bfloat16). A stage is
// kRows rows of the block's 256 columns of W, kStageBytes bytes; a 16-byte
// copy moves kVec values.
template <typename E>
struct Stage {
  static constexpr int kRows = kStageBytes / (4 * kCols * (int)sizeof(E));
  static constexpr int kVec = 16 / (int)sizeof(E);
  static constexpr int kTile = kRows * 4 * kCols;      // values of a stage
};

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Four adjacent values at p (16-byte aligned for f32, 8 for bf16) as f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void copy_async16(void* dst, const void* src,
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

// A bf16 value has no cp.async of its own size: an ordinary load and
// store, ordered for the readers by the stage's barrier.
__device__ __forceinline__ void copy_async4(__nv_bfloat16* dst,
                                            const __nv_bfloat16* src,
                                            bool valid) {
  *dst = valid ? *src : __float2bfloat16(0.f);
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// One stage of the block's W rows [f, f + kRows) x its 256 columns:
// ws[r][g * kCols + c] = W[f + r][g * H + j0 + c]; rows past f1 and columns
// past H are zeros. vec: H is a multiple of kVec, so 16-byte copies are
// aligned.
template <typename E>
__device__ __forceinline__ void load_stage(E* ws, const E* __restrict__ W,
                                           int f, int f1, int H, int j0,
                                           bool vec) {
  constexpr int kRows = Stage<E>::kRows, kVec = Stage<E>::kVec;
  const size_t H4 = 4 * (size_t)H;
  if (vec) {
    constexpr int kCopies = 4 * kCols / kVec;        // 16-byte copies a row
    for (int i = threadIdx.x; i < kRows * kCopies; i += kThreads) {
      const int r = i / kCopies, q = i - r * kCopies;
      const int g = q / (kCols / kVec), c = (q - g * (kCols / kVec)) * kVec;
      const bool ok = f + r < f1 && j0 + c < H;
      const E* src = ok ? W + (f + r) * H4 + g * H + j0 + c : W;
      copy_async16(ws + r * 4 * kCols + g * kCols + c, src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * 4 * kCols; i += kThreads) {
      const int r = i / (4 * kCols), q = i - r * 4 * kCols;
      const int g = q / kCols, c = q - g * kCols;
      const bool ok = f + r < f1 && j0 + c < H;
      const E* src = ok ? W + (f + r) * H4 + g * H + j0 + c : W;
      copy_async4(ws + i, src, ok);
    }
  }
}

// RB: batch rows per thread (each of the 4 row quarters), 4 * RB <= 32.
template <typename E, int RB>
__global__ void __launch_bounds__(kThreads)
lstm_gates_kernel(const E* __restrict__ xh, const E* __restrict__ W,
                  const E* __restrict__ bias,
                  const float* __restrict__ c_prev, int B, int F, int H,
                  int f_per_slice, float* __restrict__ partial,
                  int* __restrict__ tickets, float* __restrict__ c_out,
                  float* __restrict__ h_out) {
  constexpr int kRows = Stage<E>::kRows, kTile = Stage<E>::kTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* ws = reinterpret_cast<E*>(smem_raw);            // [kStages][tile]
  float* xs = reinterpret_cast<float*>(smem_raw + kStages * kStageBytes);
                                                     // [f_per_slice][4 * RB]
  __shared__ int ticket;

  const int tile = blockIdx.x, slice = blockIdx.y, group = blockIdx.z;
  const int slices = gridDim.y;
  const int j0 = tile * kCols;
  const int b0 = group * kGroupRows;
  const int nb = min(4 * RB, B - b0);               // rows of this pass
  const int f0 = slice * f_per_slice, f1 = min(F, f0 + f_per_slice);
  const int nf = max(0, f1 - f0);
  const int n_stages = (nf + kRows - 1) / kRows;
  const bool vec = H % Stage<E>::kVec == 0;

  // the first kStages - 1 stages of W, then xh while they fly
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages)
      load_stage(ws + s * kTile, W, f0 + s * kRows, f1, H, j0, vec);
    commit_async();
  }
  for (int i = threadIdx.x; i < nf * 4 * RB; i += kThreads) {
    const int f = i / (4 * RB), r = i - f * (4 * RB);
    xs[i] = r < nb ? to_f32(xh[(size_t)(b0 + r) * F + f0 + f]) : 0.f;
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
      load_stage(ws + (next % kStages) * kTile, W, f0 + next * kRows, f1, H,
                 j0, vec);
    commit_async();
    wait_async<kStages - 1>();
    __syncthreads();
    if (active) {
      const E* wt = ws + (s % kStages) * kTile + g * kCols + c;
      const int rows = min(kRows, nf - s * kRows);
      const float* xr = xs + (s * kRows) * 4 * RB + quarter * RB;
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        const float4 w = load4(wt + r * 4 * kCols);
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
    for (int k = 0; k < 4; ++k) gs[k] += to_f32(bias[k * H + j]);
    const size_t o = (size_t)b * H + j;
    const float cn = sigmoidf(gs[1] + 1.f) * c_prev[o] + sigmoidf(gs[0]) * tanhf(gs[2]);
    c_out[o] = cn;
    h_out[o] = sigmoidf(gs[3]) * tanhf(cn);
  }
  if (threadIdx.x == 0) *counter = 0;
}

template <typename E, int RB>
int launch(const E* xh, const E* W, const E* bias, const float* c_prev, int B,
           int F, int H, int col_tiles, int slices, int f_per_slice,
           float* partial, int* tickets, float* c_out, float* h_out,
           cudaStream_t st) {
  const size_t smem =
      kStages * kStageBytes + (size_t)f_per_slice * 4 * RB * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_gates_kernel<E, RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(col_tiles, slices, (B + kGroupRows - 1) / kGroupRows);
  lstm_gates_kernel<E, RB><<<grid, kThreads, smem, st>>>(
      xh, W, bias, c_prev, B, F, H, f_per_slice, partial, tickets, c_out,
      h_out);
  return (int)cudaGetLastError();
}

template <typename E>
int launch_rows(const E* xh, const E* W, const E* bias, const float* c_prev,
                int B, int F, int H, int col_tiles, int slices,
                int f_per_slice, float* partial, int* tickets, float* c_out,
                float* h_out, void* stream) {
  if (col_tiles * kCols < H || slices * f_per_slice < F) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = B < kGroupRows ? B : kGroupRows;
  if (rows <= 4)
    return launch<E, 1>(xh, W, bias, c_prev, B, F, H, col_tiles, slices,
                        f_per_slice, partial, tickets, c_out, h_out, st);
  if (rows <= 8)
    return launch<E, 2>(xh, W, bias, c_prev, B, F, H, col_tiles, slices,
                        f_per_slice, partial, tickets, c_out, h_out, st);
  if (rows <= 16)
    return launch<E, 4>(xh, W, bias, c_prev, B, F, H, col_tiles, slices,
                        f_per_slice, partial, tickets, c_out, h_out, st);
  return launch<E, 8>(xh, W, bias, c_prev, B, F, H, col_tiles, slices,
                      f_per_slice, partial, tickets, c_out, h_out, st);
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
  return launch_rows(xh, W, bias, c_prev, B, F, H, col_tiles, slices,
                     f_per_slice, partial, tickets, c_out, h_out, stream);
}

// The bf16 form: xh, W and the bias bf16; the rest as lstm_gates.
extern "C" int lstm_gates_bf16(const __nv_bfloat16* xh, const __nv_bfloat16* W,
                               const __nv_bfloat16* bias, const float* c_prev,
                               int B, int F, int H, int col_tiles, int slices,
                               int f_per_slice, float* partial, int* tickets,
                               float* c_out, float* h_out, void* stream) {
  return launch_rows(xh, W, bias, c_prev, B, F, H, col_tiles, slices,
                     f_per_slice, partial, tickets, c_out, h_out, stream);
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

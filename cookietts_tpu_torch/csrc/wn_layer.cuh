// The three kernels a WaveNet coupling net (WN) is made of on the card,
// shared by waveglow_wn.cu and waveflow_row.cu:
//
//   wn_start_kernel   h = start_w^T x + start_b                 (1x1)
//   wn_layer_kernel   one WN layer, fused: (rows x kw)-tap dilated conv as a
//                     [2C, rows*kw*C] product + cond -> tanh(a) * sigmoid(g)
//                     -> res/skip 1x1 product -> h_out = h + res, skip += skip
//   wn_end_kernel     st = end_w^T skip + end_b                 (1x1)
//
// Activations are channel-major [B][C][T] f32 with the batch a real axis.
// Weights are input-major ([in][out]), so the 8 output channels a thread
// owns are two float4 loads. Zero padding at the ends of the sequence is an
// index mask on the loads: nothing outside [0, T) exists in memory, so the
// start bias cannot leak into the padding.
//
// wn_layer_kernel: one block of 256 threads per (batch row, tile of Wt
// samples). A thread owns 8 channels of the tanh half and the same 8 of the
// sigmoid half for kT samples (up to 128 accumulators), so the gate needs
// no exchange. The layer is one K loop: the conv's kh * kw * C / 32 steps
// (kernel row, tap, 32 input channels), then C / 32 steps of the res/skip
// product over the gated tile. Each step's 32 rows of weights ([32][2C],
// contiguous) and, for a conv step, the [32][Wt] window of the input row
// shifted by the tap's offset are copied to shared memory with cp.async one
// step ahead of the step being computed (two stages), so the products read
// both operands from shared memory and no load from device memory or the
// L2 sits in front of an fma. (A first version read the weights through the
// read-only cache inside the loop: every weight row is used once per block,
// so each step waited for the L2, and it ran at 20% of the f32 rate.) The
// gated tile [C][Wt] stays in shared memory between the two products and
// never goes to device memory. Wt = 256 / (C / 8) * kT, with kT of 8, 5 or 4
// picked per launch (wn_pick_kt): 64, 40 or 32 samples at C = 256. The
// layer's input rows are a ring of kh slots (kh = 1: a plain buffer); the
// residual is added to the current row, re-read from device memory, and
// written to h_out, which is never the buffer other blocks read their halos
// from. C must be a power of two from 32 to 256 (shared memory).
#pragma once
#include <cuda_runtime.h>

namespace wn {

constexpr int kThreads = 256;  // threads of a layer block
constexpr int kCo = 8;         // channels per thread, in each half
constexpr int kKc = 32;        // rows of the weights staged per K step
constexpr int kStages = 2;     // stages of the copy pipeline
constexpr int kSmall = 256;    // threads of the start and end kernels

// N floats from shared memory: float4 loads where N and the offset allow.
template <int N>
__device__ __forceinline__ void load_x(const float* p, float (&x)[N]) {
  if (N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + j);
      x[j] = v.x; x[j + 1] = v.y; x[j + 2] = v.z; x[j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = p[j];
  }
}

template <int kT>
__device__ __forceinline__ void fma_tile(const float (&w)[kCo], const float (&x)[kT],
                                         float (&acc)[kCo][kT]) {
#pragma unroll
  for (int i = 0; i < kCo; ++i)
#pragma unroll
    for (int j = 0; j < kT; ++j) acc[i][j] = fmaf(w[i], x[j], acc[i][j]);
}

// Device to shared memory without passing through registers (cp.async).
// copy_async4: one float, zero when !valid (src is then not read).
__device__ __forceinline__ void copy_async4(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(n));
}

// copy_async16: four floats, both addresses 16-byte aligned; past the L1.
__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

template <int kPending>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// h[b][c][t] = sum_ci w[ci][c] * x[b][ci][t] + bias[c].
// grid (ceil(T / kSmall), C / kCo, B).
__global__ void __launch_bounds__(kSmall)
wn_start_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, int Cin, int C, int T,
                float* __restrict__ h) {
  const int t = blockIdx.x * kSmall + threadIdx.x;
  if (t >= T) return;
  const int b = blockIdx.z, c0 = blockIdx.y * kCo;
  float acc[kCo];
#pragma unroll
  for (int i = 0; i < kCo; ++i) acc[i] = bias[c0 + i];
  for (int ci = 0; ci < Cin; ++ci) {
    const float xv = x[((size_t)b * Cin + ci) * T + t];
#pragma unroll
    for (int i = 0; i < kCo; ++i)
      acc[i] = fmaf(w[(size_t)ci * C + c0 + i], xv, acc[i]);
  }
#pragma unroll
  for (int i = 0; i < kCo; ++i) h[((size_t)b * C + c0 + i) * T + t] = acc[i];
}

// st[b][o][t] = sum_c w[c][o] * skip[b][c][t] + bias[o].
// grid (ceil(T / kSmall), ceil(Cout / kCo), B).
__global__ void __launch_bounds__(kSmall)
wn_end_kernel(const float* __restrict__ skip, const float* __restrict__ w,
              const float* __restrict__ bias, int C, int Cout, int T,
              float* __restrict__ st) {
  const int t = blockIdx.x * kSmall + threadIdx.x;
  if (t >= T) return;
  const int b = blockIdx.z, o0 = blockIdx.y * kCo;
  const int n = min(kCo, Cout - o0);
  float acc[kCo];
#pragma unroll
  for (int i = 0; i < kCo; ++i) acc[i] = i < n ? bias[o0 + i] : 0.f;
  for (int c = 0; c < C; ++c) {
    const float v = skip[((size_t)b * C + c) * T + t];
#pragma unroll
    for (int i = 0; i < kCo; ++i)
      if (i < n) acc[i] = fmaf(__ldg(w + (size_t)c * Cout + o0 + i), v, acc[i]);
  }
#pragma unroll
  for (int i = 0; i < kCo; ++i)
    if (i < n) st[((size_t)b * Cout + o0 + i) * T + t] = acc[i];
}

// One WN layer. rows: the layer's ring of kh input rows, each [B][C][T],
// slot_stride floats apart; the row of kernel row r (oldest first) is slot
// (rot + 1 + r) % kh, the current row is slot rot. cond: this layer's
// [2C][T] slice of batch row 0, cond_bstride floats between batch rows.
// k [kh*kw*C][2C], rs_w [C][2C], rs_b [2C]. first: skip is written, not
// added to. kHasRes false (the last layer): no res half, h_out unused.
// grid (ceil(T / Wt), B), kThreads threads, wn_layer_smem(C, kT) bytes.
template <int kT, bool kHasRes>
__global__ void __launch_bounds__(kThreads)
wn_layer_kernel(const float* __restrict__ rows, size_t slot_stride, int kh,
                int rot, const float* __restrict__ cond, size_t cond_bstride,
                const float* __restrict__ k, const float* __restrict__ rs_w,
                const float* __restrict__ rs_b, int C, int T, int kw, int dil,
                int first, float* __restrict__ h_out, float* __restrict__ skip) {
  extern __shared__ __align__(16) float smem[];
  const int t_groups = kThreads / (C / kCo);
  const int Wt = t_groups * kT;
  const int C2 = 2 * C;
  float* outs = smem;                        // [C][Wt] gated activations
  float* stages = smem + (size_t)C * Wt;     // kStages x {ws [kKc][2C], xs [kKc][Wt]}
  const int stage_floats = kKc * (C2 + Wt);

  const int b = blockIdx.y, t0 = blockIdx.x * Wt;
  const int cg = threadIdx.x / t_groups, tg = threadIdx.x - cg * t_groups;
  const int co0 = cg * kCo, s0 = tg * kT;
  const size_t bct = (size_t)b * C * T;
  // staging the input window: thread -> column col0 (+ kThreads ...), rows
  // q, q + nq, ...; threads beyond nq * Wt sit it out
  const int nq = kThreads / Wt > 0 ? kThreads / Wt : 1;
  const int q = threadIdx.x / Wt, col0 = threadIdx.x - q * Wt;
  // K steps: kh * kw * chunks of the conv (kernel row r, tap, input channels
  // [c0, c0 + kKc)), then chunks of the res/skip product over the gated tile
  const int chunks = C / kKc, conv_steps = kh * kw * chunks;
  const int steps = conv_steps + chunks;

  // Start the copies of K step s into its stage: kKc rows of the weights
  // (contiguous in k and in rs_w) and, for a conv step, the input window.
  auto prefetch = [&](int s) {
    if (s < steps) {
      float* ws = stages + (size_t)(s % kStages) * stage_floats;
      const float* src = s < conv_steps ? k + (size_t)s * kKc * C2
                                        : rs_w + (size_t)(s - conv_steps) * kKc * C2;
      for (int i = threadIdx.x * 4; i < kKc * C2; i += kThreads * 4)
        copy_async16(ws + i, src + i);
      if (s < conv_steps) {
        float* xs = ws + kKc * C2;
        const int rt = s / chunks, c0 = (s - rt * chunks) * kKc;
        const int r = rt / kw, tap = rt - r * kw;
        const int off = (tap - kw / 2) * dil;
        const float* row = rows + (size_t)((rot + 1 + r) % kh) * slot_stride + bct +
                           (size_t)c0 * T;
        if (q < nq)
          for (int col = col0; col < Wt; col += kThreads) {
            const int p = t0 + col + off;
            const bool valid = p >= 0 && p < T;
            for (int ci = q; ci < kKc; ci += nq)
              copy_async4(xs + ci * Wt + col, valid ? row + (size_t)ci * T + p : row,
                          valid);
          }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);   // one group per step, even empty
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) prefetch(s);

  float acc_a[kCo][kT], acc_g[kCo][kT];
  {
    const float* cb = cond + (size_t)b * cond_bstride;
#pragma unroll
    for (int i = 0; i < kCo; ++i)
#pragma unroll
      for (int j = 0; j < kT; ++j) {
        const int p = t0 + s0 + j;
        acc_a[i][j] = p < T ? cb[(size_t)(co0 + i) * T + p] : 0.f;
        acc_g[i][j] = p < T ? cb[(size_t)(C + co0 + i) * T + p] : 0.f;
      }
  }

  for (int s = 0; s < steps; ++s) {
    wait_async<kStages - 2>();     // step s has landed
    __syncthreads();               // ... for every thread; step s - 1 is consumed
    prefetch(s + kStages - 1);     // into the stage step s - 1 used
    const float* ws = stages + (size_t)(s % kStages) * stage_floats + co0;
    if (s < conv_steps) {
      const float* xs = ws - co0 + kKc * C2 + s0;
#pragma unroll 4
      for (int ci = 0; ci < kKc; ++ci) {
        float wa[kCo], wg[kCo], xv[kT];
        load_x(ws + ci * C2, wa);
        load_x(ws + ci * C2 + C, wg);
        load_x(xs + ci * Wt, xv);
        fma_tile(wa, xv, acc_a);
        fma_tile(wg, xv, acc_g);
      }
      if (s == conv_steps - 1) {
        // gate; the tile is read after the next step's barrier. Then the
        // accumulators start over: acc_a the res half, acc_g the skip half
#pragma unroll
        for (int i = 0; i < kCo; ++i) {
          const float br = kHasRes ? rs_b[co0 + i] : 0.f, bs = rs_b[C + co0 + i];
#pragma unroll
          for (int j = 0; j < kT; ++j) {
            outs[(size_t)(co0 + i) * Wt + s0 + j] =
                tanhf(acc_a[i][j]) / (1.f + expf(-acc_g[i][j]));
            acc_a[i][j] = br;
            acc_g[i][j] = bs;
          }
        }
      }
    } else {
      const float* xs = outs + (size_t)(s - conv_steps) * kKc * Wt + s0;
#pragma unroll 4
      for (int ci = 0; ci < kKc; ++ci) {
        float w[kCo], xv[kT];
        load_x(xs + ci * Wt, xv);
        if (kHasRes) {
          load_x(ws + ci * C2, w);
          fma_tile(w, xv, acc_a);
        }
        load_x(ws + ci * C2 + C, w);
        fma_tile(w, xv, acc_g);
      }
    }
  }

  const float* cur = rows + (size_t)rot * slot_stride + bct;
#pragma unroll
  for (int i = 0; i < kCo; ++i)
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      const int p = t0 + s0 + j;
      if (p < T) {
        const size_t o = (size_t)(co0 + i) * T + p;
        if (kHasRes) h_out[bct + o] = cur[o] + acc_a[i][j];
        skip[bct + o] = first ? acc_g[i][j] : skip[bct + o] + acc_g[i][j];
      }
    }
}

// Shared memory of a layer launch: the gated tile and the stages.
inline size_t wn_layer_smem(int C, int kT) {
  const int Wt = kThreads / (C / kCo) * kT;
  return ((size_t)C * Wt + (size_t)kStages * kKc * (2 * C + Wt)) * sizeof(float);
}

// Samples per thread for a launch over B rows of T samples. The tile is
// t_groups * kT samples wide and a block fills an SM, so a launch takes
// ceil(blocks / SMs) waves; a wave's time grows with kT as measured on an
// H100 (in tenths of the kT = 4 wave: 10, 14, 19; kT = 5 pays for scalar
// shared-memory loads). The cheapest wins: 10 000 samples at C = 256 are
// 157 tiles of 64 (two waves on 132 SMs, the second 19% full) but 250 tiles
// of 40 (two waves, both full); at 4 x 10 000 the widest tile wins.
// tools/bench_wn_tiles.py measures the table.
inline int& wn_forced_kt() {   // 0: pick; 4, 5 or 8: what a benchmark forces
  static int kt = 0;
  return kt;
}

inline int wn_pick_kt(int B, int C, int T) {
  if (wn_forced_kt()) return wn_forced_kt();
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  const int t_groups = kThreads / (C / kCo);
  const int kts[3] = {8, 5, 4}, wave_cost[3] = {19, 14, 10};
  int best = 0;
  long best_cost = 0;
  for (int i = 0; i < 3; ++i) {
    const int Wt = t_groups * kts[i];
    const long blocks = (long)B * ((T + Wt - 1) / Wt);
    const long cost = (blocks + n_sm - 1) / n_sm * wave_cost[i];
    if (i == 0 || cost < best_cost) {
      best = kts[i];
      best_cost = cost;
    }
  }
  return best;
}

inline cudaError_t launch_start(const float* x, const float* w, const float* bias,
                                int B, int Cin, int C, int T, float* h,
                                cudaStream_t stream) {
  const dim3 grid((T + kSmall - 1) / kSmall, C / kCo, B);
  wn_start_kernel<<<grid, kSmall, 0, stream>>>(x, w, bias, Cin, C, T, h);
  return cudaGetLastError();
}

inline cudaError_t launch_end(const float* skip, const float* w, const float* bias,
                              int B, int C, int Cout, int T, float* st,
                              cudaStream_t stream) {
  const dim3 grid((T + kSmall - 1) / kSmall, (Cout + kCo - 1) / kCo, B);
  wn_end_kernel<<<grid, kSmall, 0, stream>>>(skip, w, bias, C, Cout, T, st);
  return cudaGetLastError();
}

template <int kT>
inline cudaError_t launch_layer_kt(bool has_res, const float* rows, size_t slot_stride,
                                   int kh, int rot, const float* cond,
                                   size_t cond_bstride, const float* k,
                                   const float* rs_w, const float* rs_b, int B, int C,
                                   int T, int kw, int dil, int first, float* h_out,
                                   float* skip, cudaStream_t stream) {
  const int Wt = kThreads / (C / kCo) * kT;
  const size_t smem = wn_layer_smem(C, kT);
  auto kernel = has_res ? wn_layer_kernel<kT, true> : wn_layer_kernel<kT, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + Wt - 1) / Wt, B);
  kernel<<<grid, kThreads, smem, stream>>>(rows, slot_stride, kh, rot, cond,
                                           cond_bstride, k, rs_w, rs_b, C, T, kw,
                                           dil, first, h_out, skip);
  return cudaGetLastError();
}

template <typename... Args>
inline cudaError_t launch_layer(int kT, Args... args) {
  switch (kT) {
    case 4: return launch_layer_kt<4>(args...);
    case 5: return launch_layer_kt<5>(args...);
    default: return launch_layer_kt<8>(args...);
  }
}

}  // namespace wn

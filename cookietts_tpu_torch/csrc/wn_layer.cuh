// The kernels a WaveNet coupling net (WN) is made of on the card, shared by
// waveglow_wn.cu and waveflow_row.cu:
//
//   wn_start_kernel   h = start_w^T x + start_b                 (1x1)
//   wn_gemm<conv>     z = tanh(a) * sigmoid(g), (a; g) = the layer's
//                     (rows x kw)-tap dilated conv + cond, a [2C, rows*kw*C]
//                     product over the layer's input rows
//   wn_gemm<rs>       (res; skip) = rs_w^T z + rs_b: h_out = h + res,
//                     skip_sum += skip (written at layer 0)
//   wn_end_kernel     st = end_w^T skip_sum + end_b             (1x1)
//
// Activations are channel-major [B][C][T] f32 with the batch a real axis.
// Weights are input-major ([in][out]). Zero padding at the ends of the
// sequence is an index mask on the loads: nothing outside [0, T) exists in
// memory, so the start bias cannot leak into the padding.
//
// Design (v3): each layer is two implicit-GEMM launches on the tensor cores
// (mma.sync.m16n8k8 TF32 in the 3xTF32 split, tf32x3.cuh), M = output
// channels, N = samples, K = input channels x kernel rows x taps.
// - Why two launches. v2 fused the layer into one launch, so a block had to
//   own all 2C output channels of its time tile (the res/skip product reads
//   the whole gated tile): 213 KB of shared memory at C = 256, one block of
//   8 warps an SM, and 1-8 blocks for a 250-sample request. A fused
//   tensor-core block at C = 256 would still own 512 rows, and T' = 1500
//   would give it 24 tiles of 64 samples: not one wave of 132 SMs. Here the
//   conv launch writes z [B][C][T] (10 MB at C = 256, T' = 10000, which stays
//   in the 50 MB L2) and the res/skip launch reads it back, so both tile
//   the output channels and every launch can fill the card.
// - Pairing. A block's M tile is m channel pairs: warp w owns tanh rows
//   c0 + 16 w .. + 16 and the sigmoid rows C + c0 + 16 w .. + 16, staged side
//   by side in shared memory, so a thread holds a and g of the same
//   (channel, sample) and the gate is the conv's epilogue. The res/skip
//   launch pairs res channel c with skip channel c the same way; the last
//   layer has no res half (its weights are zero) and computes it anyway,
//   1.5% of a WN's products, rather than carry a second tile layout.
// - Tiles. A launch is (WM x WN) warps, each 32 rows x 8 NJ samples: m = 16
//   WM pairs by 8 WN NJ samples a block. Which of the eight shapes of
//   WN_TILES (ops/hopper_kernels.py, in the order of launch_layer below)
//   each launch takes, and the shared memory it gets, is planned in Python
//   (wn_layer_plan) by the blocks it gives and the SMs they fill; the C side
//   checks the geometry and trusts the choice.
// - K steps. One step is (kernel row r, 32 input channels, tap). Its weight
//   slab [32][2m] goes through a ring of kStages buffers by cp.async, two
//   steps ahead, one barrier a step. The input window of (r, 32 channels) is
//   staged once, at the chunk's first tap, and read by all kw taps: as one
//   span (dil < N, the taps overlap) or as kw disjoint segments of N samples
//   (dil >= N, where one span would stage mostly columns no tap reads), in
//   16-byte copies where T % 4 == 0 (the span starts on a multiple of 4),
//   zeros outside [0, T). Two window buffers suffice for kw >= 2 (a window
//   is loaded kw - 2 steps after the one two back was last read), three for
//   the res/skip launch (kw = 1). Row strides are padded to 8 mod 16 words
//   so that fragment loads do not conflict on banks.
// - Each step is summed into a fresh accumulator and added in f32 (the
//   tensor core's accumulation truncates, tf32x3.cuh).
// - Widths. Any C: where m does not divide C the last channel block, and
//   where 32 does not divide it the last K step, stage the weight columns
//   and rows and the window rows past C as zeros (cp.async's zero fill), so
//   they add nothing, and the epilogue writes channels below C only. The
//   weight slabs go in 16-byte copies where C % 4 == 0 (a 4-column group
//   is then all inside C or all past it, and every row starts on 16 bytes),
//   else in 4-byte copies. These checks are a variant of their own (kPad):
//   a C that m and 32 divide runs the kernel without them (in every
//   launch they cost a full-width WN call 7-19% on an H100, PERF.md).
// - Rows. The conv reads its kh input rows from a ring of slots, slot_stride
//   floats apart: kernel row r reads slot (rot + 1 + r) % kh (kh = 1: a plain
//   buffer). The res/skip launch reads and writes only its own (channel,
//   sample) elements, so h_out may be the buffer its residual comes from.
//
// mma.sync, not wgmma: wgmma needs both TF32 operands K-major in shared
// memory, and the tap shift of the input window does not map onto its
// descriptors' core matrices. mma.sync peaks near 324 TFLOP/s in TF32 on the
// H100 (tools/bench_mma_rate.py), so 3xTF32 on it tops out near 108.
//
// The start and end products (Cin of 1 to 12 channels in, 2 to 24 out) are
// under 1% of a WN's operations and stay CUDA-core kernels of their own:
// measured, they take 0.5-3% of a call (PERF.md), under what folding them
// into the first and last layers' launches could save.
#pragma once
#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace wn {

using namespace tf32x3;

constexpr int kKc = 32;        // input channels of a K step
constexpr int kStages = 3;     // weight slabs in flight
constexpr int kSmall = 256;    // threads of the start and end kernels
constexpr int kCo = 8;         // channels per thread of the start and end kernels
constexpr int kSmemMax = 232448;

// h[b][c][t] = sum_ci w[ci][c] * x[b][ci][t] + bias[c].
// grid (ceil(T / kSmall), ceil(C / kCo), B).
__global__ void __launch_bounds__(kSmall)
wn_start_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, int Cin, int C, int T,
                float* __restrict__ h) {
  const int t = blockIdx.x * kSmall + threadIdx.x;
  if (t >= T) return;
  const int b = blockIdx.z, c0 = blockIdx.y * kCo;
  const int n = min(kCo, C - c0);
  float acc[kCo];
#pragma unroll
  for (int i = 0; i < kCo; ++i) acc[i] = i < n ? bias[c0 + i] : 0.f;
  for (int ci = 0; ci < Cin; ++ci) {
    const float xv = x[((size_t)b * Cin + ci) * T + t];
#pragma unroll
    for (int i = 0; i < kCo; ++i)
      if (i < n) acc[i] = fmaf(w[(size_t)ci * C + c0 + i], xv, acc[i]);
  }
#pragma unroll
  for (int i = 0; i < kCo; ++i)
    if (i < n) h[((size_t)b * C + c0 + i) * T + t] = acc[i];
}

// st[b][o][t] = sum_c w[c][o] * skip[b][c][t] + bias[o].
// grid (ceil(T / 32), ceil(Cout / kCo), B), kSmall threads: warp q sums
// channels q, q + 8, ... for the block's 32 samples (one a lane), and the 8
// partial sums of each output meet in shared memory. (One thread per sample
// over all C channels made a serial chain of C loads: 0.05-0.06 ms a call
// whatever T, 11% of a 250-sample WaveGlow WN.)
__global__ void __launch_bounds__(kSmall)
wn_end_kernel(const float* __restrict__ skip, const float* __restrict__ w,
              const float* __restrict__ bias, int C, int Cout, int T,
              float* __restrict__ st) {
  constexpr int kWarps = kSmall / 32;
  static_assert(kWarps == kCo, "a warp sums each output's partials");
  __shared__ float part[kWarps][kCo][32];
  const int q = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * 32 + lane;
  const int b = blockIdx.z, o0 = blockIdx.y * kCo;
  const int n = min(kCo, Cout - o0);
  float acc[kCo];
#pragma unroll
  for (int i = 0; i < kCo; ++i) acc[i] = 0.f;
  if (t < T)
    for (int c = q; c < C; c += kWarps) {
      const float v = skip[((size_t)b * C + c) * T + t];
#pragma unroll
      for (int i = 0; i < kCo; ++i)
        if (i < n) acc[i] = fmaf(__ldg(w + (size_t)c * Cout + o0 + i), v, acc[i]);
    }
#pragma unroll
  for (int i = 0; i < kCo; ++i) part[q][i][lane] = acc[i];
  __syncthreads();
  if (q < n && t < T) {                      // warp q: output o0 + q
    float sum = bias[o0 + q];
#pragma unroll
    for (int r = 0; r < kWarps; ++r) sum += part[r][q][lane];
    st[((size_t)b * Cout + o0 + q) * T + t] = sum;
  }
}

// One launch of a layer. conv: src is the layer's ring of kh input rows,
// each [B][C][T], slot_stride floats apart; w = k [kh*kw*C][2C]; cond is
// this layer's [2C][T] slice of batch row 0, cond_bstride floats between
// batch rows; out = z. rs: src = z (kh = 1, kw = 1); w = rs_w [C][2C];
// bias = rs_b [2C]; cur = the layer's input h; out = h_out (unused when
// !has_res); skip is written when first, else added to. win_stride: the
// padded row stride of a staged window, >= kw * N.
struct LayerArgs {
  const float* src;
  size_t slot_stride;
  int kh, rot;
  const float* w;
  const float* cond;
  size_t cond_bstride;
  const float* bias;
  const float* cur;
  float* out;
  float* skip;
  int C, T, kw, dil, first, has_res, win_stride;
};

__host__ __device__ constexpr int tile_rows(int WM) { return 32 * WM; }
__host__ __device__ constexpr int tile_samples(int WN, int NJ) { return 8 * WN * NJ; }

inline long long gemm_smem(int WM, int kw, int win_stride) {
  return 4LL * kKc * (kStages * pad_stride(tile_rows(WM)) +
                      (kw >= 2 ? 2 : 3) * win_stride);
}

// grid (ceil(T / N), ceil(C / m), B) with m = 16 WM, N = 8 WN NJ; WM x WN warps,
// gemm_smem(WM, kw, win_stride) bytes of shared memory. kPad: C is not a
// multiple of m and 32, and the channels past it are staged as zeros.
template <int WM, int WN, int NJ, bool kRs, bool kPad>
__global__ void __launch_bounds__(WM * WN * 32, 16 / (WM * WN))
wn_gemm(const LayerArgs a) {
  constexpr int NT = WM * WN * 32;
  constexpr int MB = tile_rows(WM), NB = tile_samples(WN, NJ);
  constexpr int WST = pad_stride(MB);
  extern __shared__ __align__(16) float smem[];
  const int sst = a.win_stride;
  const int nwin = a.kw >= 2 ? 2 : 3;
  float* wbuf = smem;                             // [kStages][kKc][WST]
  float* xbuf = smem + kStages * kKc * WST;       // [nwin][kKc][sst]

  const int C = a.C, T = a.T, C2 = 2 * C, kw = a.kw, dil = a.dil;
  const int t0 = blockIdx.x * NB, c0 = blockIdx.y * (16 * WM), b = blockIdx.z;
  const size_t bct = (size_t)b * C * T;
  const int chunks = kPad ? (C + kKc - 1) / kKc : C / kKc;
  const int n_steps = a.kh * chunks * kw;         // (kernel row, chunk, tap)
  const int half = kw / 2;
  // The staged window of a chunk: kw segments of NB samples (seg), or one
  // span whose column j is sample g0 + j, g0 a multiple of 4.
  const bool seg = dil >= NB;
  const int lead = t0 - half * dil;
  const int g0 = lead & ~3;
  const int span = seg ? kw * NB : (lead - g0 + NB + (kw - 1) * dil + 3) & ~3;
  const bool vec = (T & 3) == 0;

  auto load_step = [&](int s) {
    const int win = s / kw, tap = s - win * kw;
    const int r = win / chunks, ci0 = (win - r * chunks) * kKc;
    // weights: rows (r, tap, ci0 ..) of w; warp w's 32 columns are the
    // first half's c0 + 16 w .. + 16, then the second half's
    // (zeros past C: rows ci0 + k >= C, columns of channel >= C)
    const float* wsrc = a.w + ((size_t)(r * kw + tap) * C + ci0) * C2;
    float* wdst = wbuf + (s % kStages) * kKc * WST;
    for (int i = threadIdx.x; i < kKc * MB / 4; i += NT) {
      const int k = i / (MB / 4), j = (i - k * (MB / 4)) * 4;
      const int ch = c0 + 16 * (j >> 5) + (j & 15);
      const int col = ch + ((j >> 4) & 1) * C;
      const float* src = wsrc + (size_t)k * C2 + col;
      if constexpr (!kPad) {
        copy_async16(wdst + k * WST + j, src);
      } else if ((C & 3) == 0) {
        const bool ok = ci0 + k < C && ch < C;
        copy_async16z(wdst + k * WST + j, ok ? src : a.w, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = ci0 + k < C && ch + e < C;
          copy_async4(wdst + k * WST + j + e, ok ? src + e : a.w, ok);
        }
      }
    }
    if (tap == 0) {
      const float* row = a.src + (size_t)((a.rot + 1 + r) % a.kh) * a.slot_stride +
                         bct + (size_t)ci0 * T;
      float* xdst = xbuf + (win % nwin) * kKc * sst;
      auto sample = [&](int j) {
        if (!seg) return g0 + j;
        const int q = j / NB;
        return t0 + (q - half) * dil + (j - q * NB);
      };
      if (vec) {
        const int n4 = span / 4;
        for (int i = threadIdx.x; i < kKc * n4; i += NT) {
          const int k = i / n4, j = (i - k * n4) * 4;
          const int p = sample(j);
          const bool ok = p >= 0 && p < T && (!kPad || ci0 + k < C);
          copy_async16z(xdst + k * sst + j, ok ? row + (size_t)k * T + p : row, ok);
        }
      } else {
        for (int i = threadIdx.x; i < kKc * span; i += NT) {
          const int k = i / span, j = i - k * span;
          const int p = sample(j);
          const bool ok = p >= 0 && p < T && (!kPad || ci0 + k < C);
          copy_async4(xdst + k * sst + j, ok ? row + (size_t)k * T + p : row, ok);
        }
      }
    }
  };
  load_step(0);
  commit_async();
  if (n_steps > 1) load_step(1);
  commit_async();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % WM, m0 = 32 * wm, n0 = (warp / WM) * 8 * NJ;
  float acc[2][NJ][4];
  zero(acc);

  for (int s = 0; s < n_steps; ++s) {
    wait_async<1>();                         // step s is in
    __syncthreads();                         // ... for all; step s - 1 is done
    if (s + 2 < n_steps) load_step(s + 2);   // into buffers no step reads now
    commit_async();
    const int win = s / kw, tap = s - win * kw;
    const float* xs = xbuf + (win % nwin) * kKc * sst +
                      (seg ? tap * NB : lead - g0 + tap * dil);
    mma_chunk<2, NJ>(wbuf + (s % kStages) * kKc * WST, WST, m0, MB, xs, sst, n0,
                     kKc, acc);
  }

  // tile 0 holds the first half's channel c, tile 1 the second half's
  const float* cb = kRs ? nullptr : a.cond + (size_t)b * a.cond_bstride;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + 16 * wm + g + (e >= 2 ? 8 : 0);
      const int p = t0 + n0 + 8 * j + 2 * t + (e & 1);
      if (p >= T || (kPad && c >= C)) continue;
      const size_t o = bct + (size_t)c * T + p;
      if (!kRs) {
        const float va = acc[0][j][e] + cb[(size_t)c * T + p];
        const float vg = acc[1][j][e] + cb[(size_t)(C + c) * T + p];
        a.out[o] = tanhf(va) / (1.f + expf(-vg));
      } else {
        if (a.has_res) a.out[o] = a.cur[o] + (acc[0][j][e] + a.bias[c]);
        const float v = acc[1][j][e] + a.bias[C + c];
        a.skip[o] = a.first ? v : a.skip[o] + v;
      }
    }
}

template <int WM, int WN, int NJ, bool kRs>
cudaError_t launch_gemm(const LayerArgs& a, int B, long long smem,
                        cudaStream_t stream) {
  constexpr int NB = tile_samples(WN, NJ);
  if (a.C < 1 || a.win_stride < a.kw * NB ||
      smem < gemm_smem(WM, a.kw, a.win_stride) || smem > kSmemMax)
    return cudaErrorInvalidValue;
  const bool pad = a.C % (16 * WM) || a.C % kKc;
  auto kernel = pad ? wn_gemm<WM, WN, NJ, kRs, true> : wn_gemm<WM, WN, NJ, kRs, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + NB - 1) / NB, (a.C + 16 * WM - 1) / (16 * WM), B);
  kernel<<<grid, WM * WN * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// One launch of a layer with tile shape `tile` of WN_TILES
// (ops/hopper_kernels.py): (WM, WN, NJ) in this order.
template <bool kRs>
cudaError_t launch_layer(int tile, const LayerArgs& a, int B, long long smem,
                         cudaStream_t stream) {
  switch (tile) {
    case 0: return launch_gemm<4, 2, 4, kRs>(a, B, smem, stream);
    case 1: return launch_gemm<4, 2, 2, kRs>(a, B, smem, stream);
    case 2: return launch_gemm<4, 2, 1, kRs>(a, B, smem, stream);
    case 3: return launch_gemm<4, 1, 1, kRs>(a, B, smem, stream);
    case 4: return launch_gemm<2, 4, 2, kRs>(a, B, smem, stream);
    case 5: return launch_gemm<2, 4, 1, kRs>(a, B, smem, stream);
    case 6: return launch_gemm<2, 2, 1, kRs>(a, B, smem, stream);
    case 7: return launch_gemm<2, 1, 1, kRs>(a, B, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The plan of one WN call, from wn_layer_plan: per launch of a layer
// (conv, then res/skip) its tile, window stride and shared memory bytes.
struct Plan {
  int conv_tile, conv_win_stride, conv_smem, rs_tile, rs_win_stride, rs_smem;
};

inline cudaError_t launch_start(const float* x, const float* w, const float* bias,
                                int B, int Cin, int C, int T, float* h,
                                cudaStream_t stream) {
  const dim3 grid((T + kSmall - 1) / kSmall, (C + kCo - 1) / kCo, B);
  wn_start_kernel<<<grid, kSmall, 0, stream>>>(x, w, bias, Cin, C, T, h);
  return cudaGetLastError();
}

inline cudaError_t launch_end(const float* skip, const float* w, const float* bias,
                              int B, int C, int Cout, int T, float* st,
                              cudaStream_t stream) {
  const dim3 grid((T + 31) / 32, (Cout + kCo - 1) / kCo, B);
  wn_end_kernel<<<grid, kSmall, 0, stream>>>(skip, w, bias, C, Cout, T, st);
  return cudaGetLastError();
}

// Layer i of a WN: the conv launch over `rows` (a ring of kh slots) into z,
// then the res/skip launch from z. w_conv, cond, w_rs, bias: this layer's.
// Counts the launches made in *launches.
inline cudaError_t launch_wn_layer(const Plan& plan, int i, int L, const float* rows,
                                   size_t slot_stride, int kh, int rot,
                                   const float* cond, size_t cond_bstride,
                                   const float* w_conv, const float* w_rs,
                                   const float* bias, int B, int C, int T, int kw,
                                   float* z, float* h_out, float* skip,
                                   int* launches, cudaStream_t stream) {
  LayerArgs conv{rows, slot_stride, kh, rot, w_conv, cond, cond_bstride, nullptr,
                 nullptr, z, nullptr, C, T, kw, 1 << i, 0, 0,
                 plan.conv_win_stride};
  cudaError_t err = launch_layer<false>(plan.conv_tile, conv, B, plan.conv_smem, stream);
  if (err != cudaSuccess) return err;
  ++*launches;
  LayerArgs rs{z, 0, 1, 0, w_rs, nullptr, 0, bias,
               rows + (size_t)rot * slot_stride, h_out, skip, C, T, 1, 1,
               i == 0, i < L - 1, plan.rs_win_stride};
  err = launch_layer<true>(plan.rs_tile, rs, B, plan.rs_smem, stream);
  if (err == cudaSuccess) ++*launches;
  return err;
}

}  // namespace wn

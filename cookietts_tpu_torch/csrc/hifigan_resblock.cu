// One dilation pair of a HiFi-GAN MRF ResBlock1:
//   y = x + conv2(lrelu(conv1(lrelu(x), dilation d) + b1), dilation 1) + b2
// with both convs k taps (k odd), C -> C channels, zero padding at the
// sequence edges (torch's symmetric "same" padding), f32 in and out.
//
// Replaces the TPU kernel cookietts_tpu/ops/pallas_kernels.py:
// hifigan_resblock (:724, body _hifigan_resblock_kernel :663), which keeps a
// whole resblock (three dilation pairs) resident per tile. Here a resblock is
// three pairs, each one launch (fused variant) or two (split variant).
//
// Bound on the H100: operations. A pair does 4*C*C*k flops per sample
// against 8*C bytes of activation in and out: at C=256, k=11 that is 35
// GFLOP for 25 MB at B=3, T=4096, about 100x above the card's balance. The
// 12 resblocks of one main-path generator call (B=3, T_mel=512) are 1.22
// TFLOP: 18.2 ms on the f32 CUDA cores (67 TFLOP/s), 7.4 ms on the tensor
// cores in 3xTF32 (495 / 3 = 165 TFLOP/s), the bound this design is held to.
//
// Design (v3): implicit-GEMM convs on the tensor cores in 3xTF32.
// - Each tap is a GEMM, out[co, t] += W_tap[co, ci] * src[ci, t + tap*dil]:
//   M = output channels, N = samples, K = input channels, summed over taps
//   and over K chunks. Warps run mma.sync.m16n8k8 in TF32 with f32
//   accumulation on fragments read from shared memory (row strides padded
//   to 8 mod 16 words, so every fragment load hits 32 banks).
// - 3xTF32: each operand a is split as hi = a with its 13 low mantissa bits
//   cleared (a TF32 value) and lo = a - hi (exact), which the tensor core
//   reads as TF32 in turn; a*b is taken as lo_a*hi_b + hi_a*lo_b + hi_a*hi_b.
//   hi*hi alone (1xTF32) keeps 10 mantissa bits of each operand, a relative
//   error near 2^-11 per product, 1e-3 on a 3000-term sum: over the 1e-4
//   tolerance against the f32 plain version. The three products keep about
//   20 bits of each operand, and the dropped lo*lo is under 2^-20 relative,
//   so the result stays within f32's error of the plain version
//   (tests/test_torch_kernels.py emulates the split in numpy).
// - The tensor core's own accumulation truncates. Summed into one register
//   over a whole C*k-long dot product (2816 terms at C=256, k=11), that
//   bias grows to about 1e-4 of the output, so each K step (one tap,
//   up to 64 input channels) is summed into a fresh accumulator and added
//   to the running sum with an ordinary f32 add. Within a step a warp issues
//   all its lo*hi products, then the hi*lo, then the hi*hi, so consecutive
//   products never wait on one accumulator.
// - Weights, stored [k][C_in][C_out], are staged in shared memory a slab at
//   a time ([C_in chunk][C_out] of one tap) through a cp.async ring of three
//   slabs, two steps ahead, with one barrier a step; each weight element is
//   read from the L2 once per block and used across its whole time tile.
// - The lrelu prologue is applied once, in shared memory, after the
//   activation is staged (4-byte cp.async, zeros outside [0, T)); the
//   biases, conv1's lrelu and the residual add are fused into the epilogues.
//
// Which widths fuse the pair (hifigan_resblock_plan in ops/hopper_kernels.py
// picks the variant by C, never on failure):
// - fused, C in {8, 16, 32, 64}: one block of 16 warps per (time tile,
//   batch row) holds lrelu(x) for all C channels over the tile plus both
//   halos, computes conv1 into a second shared buffer (zeros outside
//   [0, T): conv2's padding), and conv2 from there; the intermediate never
//   reaches device memory. At C=32 (T=262144, B=3 on the main path) one
//   activation is 100 MB, and moving the intermediate through device memory
//   would cost about as much as the 3xTF32 compute (1.2 ms per stage each),
//   so these widths fuse. Their tiles are wide (256 to 1024 conv columns),
//   so conv1 recomputing conv2's halo costs 1-4%. C=8 pads the MMA's 16 rows
//   with zeros. A block of 8 warps (two blocks an SM) measured no faster.
// - split, every other C: at C=256, k=11, d=5 a fused tile wide enough
//   for the MMA would need more shared memory than a block may have. Two
//   launches, conv1 -> h in device memory, then conv2 + residual, each over
//   BM x 64 output tiles with 32-channel K chunks; a chunk's activation
//   window is staged once and read by all k taps. h costs two more passes
//   over the activation (25 MB at C=256, B=3, T=4096: 8 us against 0.2 ms of
//   compute), and the small tiles give two blocks an SM and 384 blocks at
//   C=256 (128-sample tiles leave the card's second wave half empty there).
//   BM, the output channels of a block, is 128, 64 or 32: the plan takes
//   the one that pads C least (128 for every multiple of 128; 64 at C=192,
//   32 at C=96 and 24, 64 at 48). Channels past C, in a block's rows or in
//   the last K chunk, are staged as zeros and never written, so any C runs;
//   weight rows go in 16-byte copies where C is a multiple of 4, else in
//   4-byte ones. Where BM and 32 divide C (kWhole) those checks compile
//   out: with them, C=256 and 128 ran 2-5% slower (PERF.md).
//
// What holds it back: mma.sync peaks at about 324 TFLOP/s in TF32 on the
// H100 (tools/bench_mma_rate.py), two thirds of the wgmma rate, so 3xTF32
// on it tops out near 108 TFLOP/s; the kernel reaches 31-42% of that,
// by stage (PERF.md).
// wgmma needs both TF32 operands K-major in shared memory, and the tap
// shift of the activation does not map onto its descriptors' core matrices.
//
// The bf16 form is a kernel of its own, on wgmma with h kept on chip at
// the narrow widths: hifigan_resblock_bf16.cu.
#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int kThreads = 256;   // split: threads per block (8 warps)
constexpr int kWarps = kThreads / 32;
constexpr int kSplitN = 64;     // split: samples per block
constexpr int kSplitKc = 32;    // split: input channels per K chunk

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v >= 0.f ? v : v * slope;
}

// ---- fused variant -------------------------------------------------------
// 16 warps as WM (channels, 16 MI rows each) x 16 / WM (samples, 8 NJ
// columns each). Conv1 and conv2 are both computed over N1 = (16 / WM) 8 NJ
// columns; the block's output tile is the first N1 - 2 (k / 2) of conv2.
constexpr int kFusedWarps = 16;

// Weights go through shared memory in slabs of one tap x KC input channels
// x C output channels, in a ring of kFusedStages slabs: the slab two ahead
// is copied while one is computed, so one barrier a slab orders the ring.
constexpr int kFusedStages = 3;

__host__ __device__ inline long long fused_smem(int C, int K, int dil, int n1,
                                                int kc) {
  const int half = K / 2;
  return 4LL * (C * (pad_stride(n1 + 2 * half * dil) + pad_stride(n1 + 2 * half)) +
                kFusedStages * kc * pad_stride(C));
}

template <int MI, int NJ, int WM, int KC>
__global__ void __launch_bounds__(kFusedWarps * 32)
resblock_pair_fused(const float* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, int C, int T, int K, int dil,
                    float slope, float* __restrict__ y) {
  constexpr int NT = kFusedWarps * 32, N1 = kFusedWarps / WM * 8 * NJ;
  extern __shared__ float smem[];
  const int half = K / 2, halo1 = half * dil;
  const int tile = N1 - 2 * half;
  const int xw = N1 + 2 * halo1, hw = N1 + 2 * half;
  const int xst = pad_stride(xw), hst = pad_stride(hw), wst = pad_stride(C);
  float* xs = smem;                          // [C][xst]  lrelu(x)
  float* hs = xs + (size_t)C * xst;          // [C][hst]  lrelu(conv1 + b1)
  float* wbuf = hs + (size_t)C * hst;        // [3][KC][wst] weight slabs

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int hbase = t0 - half;               // sample of hs column 0
  const int xbase = hbase - halo1;           // sample of xs column 0
  const float* xb = x + (size_t)b * C * T;
  const int n_ch = C / KC;
  const int n_conv = K * n_ch;               // slabs of one conv: (tap, chunk)
  const int n_slabs = 2 * n_conv;            // conv1's, then conv2's

  // slab s: conv s / n_conv, tap, input channels [ci0, ci0 + KC)
  auto load_slab = [&](int s) {
    const int r = s % n_conv, tap = r / n_ch, ci0 = (r - tap * n_ch) * KC;
    const float* src = (s < n_conv ? w1 : w2) + ((size_t)tap * C + ci0) * C;
    float* dst = wbuf + (s % kFusedStages) * KC * wst;
    for (int i = threadIdx.x; i < KC * C / 4; i += NT) {
      const int ci = i / (C / 4), c4 = (i - ci * (C / 4)) * 4;
      copy_async16(dst + ci * wst + c4, src + (size_t)ci * C + c4);
    }
  };
  // x's window (zeros outside [0, T)) and the first two slabs in flight
  for (int i = threadIdx.x; i < C * xw; i += NT) {
    const int ci = i / xw, s = i - ci * xw;
    const int p = xbase + s;
    const bool ok = p >= 0 && p < T;
    copy_async4(xs + ci * xst + s, ok ? xb + (size_t)ci * T + p : xb, ok);
  }
  load_slab(0);
  commit_async();
  load_slab(1);                              // n_slabs >= 2
  commit_async();
  // conv2's discarded columns read up to 2 half past N1
  for (int i = threadIdx.x; i < C * 2 * half; i += NT) {
    const int ci = i / (2 * half);
    hs[ci * hst + N1 + (i - ci * 2 * half)] = 0.f;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp % WM) * 16 * MI, n0 = (warp / WM) * 8 * NJ;
  float acc[MI][NJ][4];
  zero(acc);

  for (int s = 0; s < n_slabs; ++s) {
    wait_async<1>();                         // slab s is in
    __syncthreads();                         // ... for all; slab s - 1 is done
    if (s + 2 < n_slabs) load_slab(s + 2);   // into slab s - 1's buffer
    commit_async();
    if (s == 0) {                            // the lrelu prologue, once
      for (int i = threadIdx.x; i < C * xw; i += NT) {
        const int ci = i / xw;
        float* v = xs + ci * xst + (i - ci * xw);
        *v = lrelu(*v, slope);
      }
      __syncthreads();
    }
    const float* ws = wbuf + (s % kFusedStages) * KC * wst;
    const int r = s % n_conv, tap = r / n_ch, ci0 = (r - tap * n_ch) * KC;
    if (s < n_conv)
      mma_chunk<MI, NJ>(ws, wst, m0, C, xs + ci0 * xst + tap * dil, xst, n0, KC, acc);
    else
      mma_chunk<MI, NJ>(ws, wst, m0, C, hs + ci0 * hst + tap, hst, n0, KC, acc);
    if (s == n_conv - 1) {
      // conv1 epilogue: hs = lrelu(acc + b1), zero outside [0, T)
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int co = m0 + 16 * i + g + (e >= 2 ? 8 : 0);
            const int n = n0 + 8 * j + 2 * t + (e & 1);
            const int p = hbase + n;
            if (co < C)
              hs[co * hst + n] = (p >= 0 && p < T)
                                     ? lrelu(acc[i][j][e] + b1[co], slope)
                                     : 0.f;
          }
      zero(acc);                             // the next barrier orders hs
    }
  }

  // conv2 epilogue: y = x + acc + b2 on the tile's own samples
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = m0 + 16 * i + g + (e >= 2 ? 8 : 0);
        const int n = n0 + 8 * j + 2 * t + (e & 1);
        const int p = t0 + n;
        if (co < C && n < tile && p < T) {
          const size_t o = ((size_t)b * C + co) * T + p;
          y[o] = x[o] + acc[i][j][e] + b2[co];
        }
      }
}

// ---- split variant -------------------------------------------------------
// One conv of the pair over a [BM x kSplitN] output tile; 8 warps as WM
// (channels, 16 MI rows each) x 8 / WM (samples, 8 NJ columns each). kFirst:
// conv1, src = x, out = lrelu(conv(lrelu(x)) + b1) = h. Else conv2, src = h,
// out = res + conv(h) + b2 = y. A K step is one (32-channel chunk, tap);
// its weight slab and, at a chunk's first tap, the chunk's activation
// window go through rings of kSplitStages buffers, two steps ahead, with
// one barrier a step. Channels >= C are staged as zeros; kWhole: BM and
// kSplitKc divide C, so there are none and no check is made.
constexpr int kSplitStages = 3;

__host__ __device__ inline long long split_smem(int K, int dil, int BM) {
  return 4LL * kSplitStages * kSplitKc * (pad_stride(kSplitN + (K - 1) * dil) +
                                          pad_stride(BM));
}

template <bool kFirst, int BM, bool kWhole>
__global__ void __launch_bounds__(kThreads, 2)
resblock_conv_split(const float* __restrict__ src, const float* __restrict__ w,
                    const float* __restrict__ bias,
                    const float* __restrict__ res, int C, int T, int K,
                    int dil, float slope, float* __restrict__ out) {
  constexpr int WM = BM >= 64 ? 4 : 2;       // warps along the channels
  constexpr int MI = BM / WM / 16, NJ = kSplitN / (kWarps / WM) / 8;
  extern __shared__ float smem[];
  const int sw = kSplitN + (K - 1) * dil;    // samples of a staged chunk
  const int sst = pad_stride(sw), wst = pad_stride(BM);
  float* sbuf = smem;                        // [3][kSplitKc][sst]
  float* wbuf = smem + kSplitStages * kSplitKc * sst;  // [3][kSplitKc][wst]

  const int t0 = blockIdx.x * kSplitN, co0 = blockIdx.y * BM;
  const int b = blockIdx.z;
  const int sbase = t0 - (K / 2) * dil;      // sample of staged column 0
  const float* srcb = src + (size_t)b * C * T;
  const int n_steps = (C + kSplitKc - 1) / kSplitKc * K;   // (K chunk, tap)
  const bool vec = C % 4 == 0;               // weight rows 16-byte aligned

  auto load_step = [&](int s) {
    const int chunk = s / K, tap = s - chunk * K;
    const int ci0 = chunk * kSplitKc;
    const float* wsrc = w + ((size_t)tap * C + ci0) * C + co0;
    float* wdst = wbuf + (s % kSplitStages) * kSplitKc * wst;
    for (int i = threadIdx.x; i < kSplitKc * BM / 4; i += kThreads) {
      const int r = i / (BM / 4), c4 = (i - r * (BM / 4)) * 4;
      const bool row = kWhole || ci0 + r < C;
      if (kWhole) {
        copy_async16(wdst + r * wst + c4, wsrc + (size_t)r * C + c4);
      } else if (vec) {
        const bool ok = row && co0 + c4 < C;
        copy_async16z(wdst + r * wst + c4, ok ? wsrc + (size_t)r * C + c4 : w, ok);
      } else {
        for (int e = 0; e < 4; ++e) {
          const bool ok = row && co0 + c4 + e < C;
          copy_async4(wdst + r * wst + c4 + e,
                      ok ? wsrc + (size_t)r * C + c4 + e : w, ok);
        }
      }
    }
    if (tap == 0) {
      float* sdst = sbuf + (chunk % kSplitStages) * kSplitKc * sst;
      for (int i = threadIdx.x; i < kSplitKc * sw; i += kThreads) {
        const int r = i / sw, c = i - r * sw;
        const int p = sbase + c;
        const bool ok = p >= 0 && p < T && (kWhole || ci0 + r < C);
        copy_async4(sdst + r * sst + c,
                    ok ? srcb + (size_t)(ci0 + r) * T + p : srcb, ok);
      }
    }
  };
  load_step(0);
  commit_async();
  if (n_steps > 1) load_step(1);
  commit_async();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp % WM) * (16 * MI), n0 = (warp / WM) * (8 * NJ);
  float acc[MI][NJ][4];
  zero(acc);

  for (int s = 0; s < n_steps; ++s) {
    wait_async<1>();                         // step s is in
    __syncthreads();                         // ... for all; step s - 1 is done
    if (s + 2 < n_steps) load_step(s + 2);   // into buffers no step reads now
    commit_async();
    const int chunk = s / K, tap = s - chunk * K;
    float* sc = sbuf + (chunk % kSplitStages) * kSplitKc * sst;
    if (kFirst && tap == 0) {                // the lrelu prologue, once a chunk
      for (int i = threadIdx.x; i < kSplitKc * sw; i += kThreads) {
        const int r = i / sw, c = i - r * sw;
        sc[r * sst + c] = lrelu(sc[r * sst + c], slope);
      }
      __syncthreads();
    }
    mma_chunk<MI, NJ>(wbuf + (s % kSplitStages) * kSplitKc * wst, wst, m0,
                      BM, sc + tap * dil, sst, n0, kSplitKc, acc);
  }

#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = co0 + m0 + 16 * i + g + (e >= 2 ? 8 : 0);
        const int p = t0 + n0 + 8 * j + 2 * t + (e & 1);
        if ((kWhole || co < C) && p < T) {
          const size_t o = ((size_t)b * C + co) * T + p;
          const float v = acc[i][j][e] + bias[co];
          out[o] = kFirst ? lrelu(v, slope) : res[o] + v;
        }
      }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, long long smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int MI, int NJ, int WM, int KC>
int launch_fused(const float* x, const float* w1, const float* b1,
                 const float* w2, const float* b2, int B, int C, int T, int K,
                 int dil, float slope, int tile, long long smem, float* y,
                 cudaStream_t st) {
  constexpr int N1 = kFusedWarps / WM * 8 * NJ;
  if (tile != N1 - 2 * (K / 2) || tile <= 0 ||
      smem < fused_smem(C, K, dil, N1, KC))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = set_smem(resblock_pair_fused<MI, NJ, WM, KC>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T + tile - 1) / tile, B);
  resblock_pair_fused<MI, NJ, WM, KC><<<grid, kFusedWarps * 32, smem, st>>>(
      x, w1, b1, w2, b2, C, T, K, dil, slope, y);
  return (int)cudaGetLastError();
}

template <int BM, bool kWhole>
int launch_split(const float* x, const float* w1, const float* b1,
                 const float* w2, const float* b2, int B, int C, int T, int K,
                 int dil, float slope, long long smem, float* h, float* y,
                 cudaStream_t st) {
  if (smem < split_smem(K, dil, BM)) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + kSplitN - 1) / kSplitN, (C + BM - 1) / BM, B);
  cudaError_t e = set_smem(resblock_conv_split<true, BM, kWhole>, smem);
  if (e != cudaSuccess) return (int)e;
  resblock_conv_split<true, BM, kWhole><<<grid, kThreads, smem, st>>>(
      x, w1, b1, nullptr, C, T, K, dil, slope, h);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = set_smem(resblock_conv_split<false, BM, kWhole>, smem);
  if (e != cudaSuccess) return (int)e;
  resblock_conv_split<false, BM, kWhole><<<grid, kThreads, smem, st>>>(
      h, w2, b2, x, C, T, K, 1, slope, y);
  return (int)cudaGetLastError();
}

template <int BM>
int launch_split_rows(const float* x, const float* w1, const float* b1,
                      const float* w2, const float* b2, int B, int C, int T,
                      int K, int dil, float slope, long long smem, float* h,
                      float* y, cudaStream_t st) {
  if (C % BM == 0 && C % kSplitKc == 0)
    return launch_split<BM, true>(x, w1, b1, w2, b2, B, C, T, K, dil, slope,
                                  smem, h, y, st);
  return launch_split<BM, false>(x, w1, b1, w2, b2, B, C, T, K, dil, slope,
                                 smem, h, y, st);
}

}  // namespace

// One dilation pair, x -> y. The plan (variant, tile, rows, smem) comes
// from hifigan_resblock_plan in ops/hopper_kernels.py and is checked here
// against this file's own geometry. variant 0 (fused): one launch, h and
// rows unused. variant 1 (split): two launches through h, a [B, C, T]
// scratch buffer, over blocks of `rows` (BM) output channels.
extern "C" int hifigan_resblock_pair(const float* x, const float* w1,
                                     const float* b1, const float* w2,
                                     const float* b2, int B, int C, int T,
                                     int K, int dil, float slope, int variant,
                                     int tile, int rows, long long smem,
                                     float* h, float* y, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (K % 2 == 0 || C <= 0 || smem > 232448) return (int)cudaErrorInvalidValue;
  if (variant == 0) {
    switch (C) {
      case 8:
        return launch_fused<1, 8, 1, 8>(x, w1, b1, w2, b2, B, C, T, K, dil,
                                        slope, tile, smem, y, st);
      case 16:
        return launch_fused<1, 8, 1, 16>(x, w1, b1, w2, b2, B, C, T, K, dil,
                                         slope, tile, smem, y, st);
      case 32:
        return launch_fused<2, 4, 1, 32>(x, w1, b1, w2, b2, B, C, T, K, dil,
                                         slope, tile, smem, y, st);
      case 64:
        return launch_fused<2, 4, 2, 64>(x, w1, b1, w2, b2, B, C, T, K, dil,
                                         slope, tile, smem, y, st);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (variant != 1 || tile != kSplitN) return (int)cudaErrorInvalidValue;
  return rows == 128 ? launch_split_rows<128>(x, w1, b1, w2, b2, B, C, T, K, dil,
                                               slope, smem, h, y, st)
       : rows == 64 ? launch_split_rows<64>(x, w1, b1, w2, b2, B, C, T, K, dil,
                                            slope, smem, h, y, st)
       : rows == 32 ? launch_split_rows<32>(x, w1, b1, w2, b2, B, C, T, K, dil,
                                            slope, smem, h, y, st)
       : (int)cudaErrorInvalidValue;
}

// One dilation pair of a HiFi-GAN MRF ResBlock1 in bf16:
//   y = x + conv2(lrelu(conv1(lrelu(x), dilation d) + b1), dilation 1) + b2
// with both convs k taps (k odd), C -> C channels, zero padding outside
// [0, T); x, y and the weights bf16, the biases f32.
//
// Replaces the TPU kernel cookietts_tpu/ops/pallas_kernels.py:
// hifigan_resblock (:724, body _hifigan_resblock_kernel :663) as the JAX
// package runs it with bf16 operands (models/hifigan.py:243-246), and
// rounds where that body rounds: lrelu on the bf16 input (its product by
// the slope rounded to bf16, the slope itself a bf16 value, as JAX's
// weak-typed constant is), each conv accumulated in f32 on the bias,
// conv1's lrelu in f32 rounded to bf16 (h), conv2's sum rounded to bf16
// before the residual add, the residual sum rounded to bf16.
//
// Bound on the H100: operations. A pair does 4 C^2 k flops a sample; the
// 12 resblocks of one main-path generator call (B=3, T_mel=512, C = 256,
// 128, 64, 32) are 1.22 TFLOP, 1.23 ms at 989 TFLOP/s. Moving x and y once
// a resblock (4 C bytes a sample) is 0.23 ms; the first bf16 form moved
// 10 C a pair (h out and back, x twice), 1.8 ms.
//
// Design: an implicit GEMM on wgmma, one tile of 128 samples (two consumer
// warpgroups of 64) by N output channels (N = 16 to 256, C padded up; 256
// a column tile past that), K = 16 input channels of one tap a product.
// - The weights of a run of taps for a chunk of input channels are wgmma's
//   shared-memory operand (MN-major: the weights' output channels are
//   contiguous), brought by TMA (3-D boxes of [taps][channels in][channels
//   out], swizzled as wgmma reads them; zeros past C) into a ring of
//   stages with full / empty mbarriers, by one producer thread.
// - The shifted activation window is the register operand: it is staged
//   sample-major ([sample][channel], rows of KC + 8 values, so an ldmatrix
//   row is 16-byte aligned and eight rows fall on distinct banks), so a
//   tap's shift of tap * d samples is a row offset. The other three warps
//   of the producer warpgroup stage it with 16-byte loads (T a multiple of
//   8; 2-byte loads else), transposed by shuffles, into one of two buffers
//   while the consumers compute on the other. For conv1 the loaders apply
//   lrelu as they stage (packed bf16 pairs), so the buffer holds lrelu(x)
//   and the epilogue reads the residual x again from device memory.
// - A persistent grid walks over the (batch, channel tile, sample tile)
//   tiles; the producer runs ahead by the ring and the second buffer.
// - Narrow stages (C <= 64: byte-bound, 38-282 flops per byte in two
//   launches) run the pair in one launch (kFused): conv1 over the tile and
//   conv2's halo of (k - 1) / 2 samples each side into h in shared memory
//   (rounded to bf16, zeros outside [0, T)), then conv2 from it, then the
//   residual add, which reads x again (the samples the tile's window
//   staged just before): h never leaves the SM, so x is read twice and y
//   written once (6 C bytes a sample and the windows' halos, against 10 C
//   for two launches; the output tile is tile_rows - (k - 1) samples, a multiple
//   of 8).
//   Wide stages (C > 64) are compute-bound and take two launches through h
//   in device memory (kConv1, kConv2), whose bytes are small beside their
//   products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "bf16_mma.cuh"
#include "tma.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int kThreads = 384;      // a producer and two consumer warpgroups
constexpr int kLoaders = 96;       // producer warps 1-3 stage the windows
constexpr int kConsumerWarps = 8;
constexpr int kMaxRing = 32;
constexpr int kSmemMax = 232448;

enum Mode { kConv1 = 0, kConv2 = 1, kFused = 2 };

// 64-row blocks a consumer warpgroup takes (1 at N = 256, 2 at 128 and
// 64, 4 below): a warpgroup runs MI of them on each weight stage (a tile
// of 128 MI rows), which shares the stage's wait, the weights' bytes (the
// tile streams all of them from L2) and a tile's fixed costs over more
// samples; N x MI is at most 256 (128 accumulators a thread).
__host__ __device__ constexpr int m_blocks(int N) { return N == 256 ? 1 : N >= 64 ? 2 : 4; }

// Rows a tile computes.
__host__ __device__ constexpr int tile_rows(int N) { return 128 * m_blocks(N); }

// Products (k steps of 16 channels) a stage holds at most: their A
// fragments (MI of them a step) stay in registers until the stage's
// products are done: max_steps x MI x 4 registers beside N x MI / 2
// accumulators.
__host__ __device__ constexpr int max_steps(int N) {
  return N == 256 ? 4 : 8 / m_blocks(N);
}

__host__ __device__ constexpr int atom_width(int N) { return N < 64 ? N : 64; }

// Bytes of a stage: the boxes of its N / atom_width atoms, each TG taps x
// KC channels in x atom_width channels out, rounded to 1 KB.
__host__ __device__ inline int stage_bytes(int N, int KC, int TG) {
  return (N / atom_width(N) * TG * KC * 2 * atom_width(N) + 1023) / 1024 * 1024;
}

__host__ __device__ inline int window_rows(int N, int K, int kd) {
  return (tile_rows(N) + 7 + (K - 1) * kd + 7) / 8 * 8;
}

// Values of the staging area: the output tile channel-major (N rows of
// tile_rows + 8 samples), and in kFused first h (tile_rows + k - 1 rows of
// xs values).
__host__ __device__ inline int staging_values(int N, int mode, int K, int xs) {
  const int out = N * (tile_rows(N) + 8);
  const int h = mode == kFused ? (tile_rows(N) + K - 1 + 15) / 16 * 16 * xs : 0;
  return out > h ? out : h;
}

// Output samples a tile writes: kFused loses conv2's halo of k - 1 rows and
// keeps a multiple of 8 (16-byte stores).
__host__ __device__ inline int tile_samples(int N, int mode, int K) {
  return mode == kFused ? (tile_rows(N) - (K - 1)) / 8 * 8 : tile_rows(N);
}

// Dynamic shared memory of a launch: alignment slack, the ring, two window
// buffers, the staging area, the channel tile's two biases, the barriers.
__host__ __device__ inline int smem_bytes(int N, int mode, int K, int d, int KC,
                                          int TG, int ring) {
  const int xs = KC + 8;
  const int kd = mode == kConv2 ? 1 : d;
  return 1024 + ring * stage_bytes(N, KC, TG) + 2 * window_rows(N, K, kd) * xs * 2 +
         staging_values(N, mode, K, xs) * 2 + 2 * N * 4 + (2 * kMaxRing + 4) * 8;
}

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v >= 0.f ? v : v * slope;
}

// JAX's lrelu of two packed bf16 values: each kept where it is >= 0, else
// its product by the bf16 slope rounded to bf16.
__device__ __forceinline__ uint32_t lrelu2(uint32_t v, __nv_bfloat162 s2) {
  const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&v);
  const __nv_bfloat162 m = __hmul2(x, s2);
  const uint32_t mv = *reinterpret_cast<const uint32_t*>(&m);
  const uint32_t lo = (v & 0x8000u) && (v & 0x7FFFu) ? 0x0000FFFFu : 0u;
  const uint32_t hi = (v & 0x80000000u) && (v & 0x7FFF0000u) ? 0xFFFF0000u : 0u;
  const uint32_t mask = lo | hi;
  return (mv & mask) | (v & ~mask);
}

// An 8 x 8 transpose of 16-bit values across the 8 lanes of a group (c =
// lane % 8): lane c's element e becomes lane e's element c. Three butterfly
// steps (lanes 4, 2, 1 apart) swap the off-diagonal blocks.
__device__ __forceinline__ void transpose8(uint32_t (&w)[4], int c) {
  bool hi = c & 4;
  uint32_t s0 = hi ? w[0] : w[2], s1 = hi ? w[1] : w[3];
  uint32_t r0 = __shfl_xor_sync(0xffffffffu, s0, 4);
  uint32_t r1 = __shfl_xor_sync(0xffffffffu, s1, 4);
  if (hi) {
    w[0] = r0;
    w[1] = r1;
  } else {
    w[2] = r0;
    w[3] = r1;
  }
  hi = c & 2;
  s0 = hi ? w[0] : w[1];
  s1 = hi ? w[2] : w[3];
  r0 = __shfl_xor_sync(0xffffffffu, s0, 2);
  r1 = __shfl_xor_sync(0xffffffffu, s1, 2);
  if (hi) {
    w[0] = r0;
    w[2] = r1;
  } else {
    w[1] = r0;
    w[3] = r1;
  }
  hi = c & 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t r = __shfl_xor_sync(0xffffffffu, hi ? w[i] & 0xFFFFu : w[i] >> 16, 1);
    w[i] = hi ? (w[i] & 0xFFFF0000u) | r : (r << 16) | (w[i] & 0xFFFFu);
  }
}

__device__ __forceinline__ int floor8(int v) { return v >= 0 ? v & ~7 : -((-v + 7) & ~7); }

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// The products of one stage for this warpgroup's MI row blocks: taps
// g TG + [0, TG) (those below K), each KC / 16 k steps. win: the window (or
// h), rows of xs values; row: this lane's ldmatrix row for tap 0 of its
// first row block (the others 64 rows apart); stage: its shared address.
// The products are waited for before the stage's slot is freed: keeping a
// stage's products in flight while the next loads its fragments (a second
// register buffer, wait_group 1) measured slower.
template <int N>
__device__ __forceinline__ void stage_products(float (&acc)[m_blocks(N)][N / 2],
                                               const __nv_bfloat16* win, int xs,
                                               int row, int col, int kd, int g,
                                               int TG, int K, int KC,
                                               uint32_t stage) {
  constexpr int MI = m_blocks(N), AW = atom_width(N), RB = 2 * AW;
  constexpr uint32_t kLayout = RB == 128 ? wgmma::kSwizzle128
                               : RB == 64 ? wgmma::kSwizzle64
                                          : wgmma::kSwizzle32;
  constexpr int kSteps = max_steps(N);
  const int sub = KC / 16;
  const int taps = min(TG, K - g * TG);
  const int steps = taps * sub;
  uint32_t a[kSteps][MI][4];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int tt = s / sub, i = s - tt * sub;
#pragma unroll
    for (int mb = 0; mb < MI; ++mb) {
      if (s < steps) {
        bf16mma::ldmatrix_x4(
            a[s][mb], win + (row + 64 * mb + (g * TG + tt) * kd) * xs + 16 * i + col);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[s][mb][e] = 0u;
      }
    }
  }
#pragma unroll
  for (int mb = 0; mb < MI; ++mb)
#pragma unroll
    for (int e = 0; e < N / 2; ++e) wgmma::keep(acc[mb][e]);
  wgmma::fence();
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    if (s < steps) {
      const int tt = s / sub, i = s - tt * sub;
      const uint64_t b = wgmma::desc(stage + (uint32_t)((tt * KC + 16 * i) * RB),
                                     (uint32_t)(TG * KC * RB), 8 * RB, kLayout);
#pragma unroll
      for (int mb = 0; mb < MI; ++mb) wgmma::Mma<N>::run(acc[mb], a[s][mb], b);
    }
  }
  wgmma::commit();
  wgmma::wait<0>();
#pragma unroll
  for (int mb = 0; mb < MI; ++mb)
#pragma unroll
    for (int e = 0; e < N / 2; ++e) wgmma::keep(acc[mb][e]);
#pragma unroll
  for (int s = 0; s < kSteps; ++s)
#pragma unroll
    for (int mb = 0; mb < MI; ++mb)
#pragma unroll
      for (int e = 0; e < 4; ++e) wgmma::keep(a[s][mb][e]);
}

// One conv (kConv1: x -> h; kConv2: h -> y with the residual x) or the
// whole pair (kFused: x -> y) over a persistent walk of the tiles. wa: the
// first (only) conv's weights, wb: conv2's (kFused); tap0 = p K, the pair's
// first tap in the maps; res: the residual x (kConv2); vec: T a multiple
// of 8 and the activations 16-byte aligned (16-byte loads and stores).
template <int N, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
resblock_bf16_kernel(const __grid_constant__ CUtensorMap wa,
                     const __grid_constant__ CUtensorMap wb,
                     const __nv_bfloat16* __restrict__ src,
                     const __nv_bfloat16* __restrict__ res,
                     const float* __restrict__ ba, const float* __restrict__ bb,
                     int B, int C, int T, int K, int dil, int tap0, int KC,
                     int TG, int ring, int co_tiles, bool vec,
                     float slope_bf16, float slope,
                     __nv_bfloat16* __restrict__ out) {
  constexpr int MI = m_blocks(N), AW = atom_width(N), RB = 2 * AW;
  constexpr int kAtoms = N / AW, kRows = tile_rows(N), kSt = kRows + 8;
  constexpr bool kLreluX = kMode != kConv2;      // the window holds lrelu(x)
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = tma::align1024(smem_raw);
  const int xs = KC + 8;
  const int kd = kMode == kConv2 ? 1 : dil;
  const int half = K / 2;
  const int WR = window_rows(N, K, kd);
  const int SB = stage_bytes(N, KC, TG);
  const int TM = tile_samples(N, kMode, K);
  __nv_bfloat16* win = reinterpret_cast<__nv_bfloat16*>(smem + ring * SB);
  __nv_bfloat16* stg = win + 2 * WR * xs;        // h (kFused), the output tile
  float* bias_s = reinterpret_cast<float*>(stg + staging_values(N, kMode, K, xs));
  uint64_t* bars = reinterpret_cast<uint64_t*>(bias_s + 2 * N);   // [2][N]: ba, bb
  uint64_t* full = bars;
  uint64_t* empty = bars + kMaxRing;
  uint64_t* wfull = bars + 2 * kMaxRing;
  uint64_t* wempty = wfull + 2;
  const __nv_bfloat162 s2 = __floats2bfloat162_rn(slope_bf16, slope_bf16);

  const int n_chunks = (C + KC - 1) / KC;
  const int n_groups = (K + TG - 1) / TG;
  const int t_tiles = (T + TM - 1) / TM;
  const int tiles = B * co_tiles * t_tiles;
  // resident: a tile's stages all fit the ring, so the weights are loaded
  // once (one channel tile) and every tile reads them in place
  const bool resident =
      co_tiles == 1 && n_chunks * n_groups + (kMode == kFused ? n_groups : 0) <= ring;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ring; ++s) {
      tma::mbar_init(&full[s], 1);
      tma::mbar_init(&empty[s], kConsumerWarps);
    }
    for (int s = 0; s < 2; ++s) {
      tma::mbar_init(&wfull[s], kLoaders);
      tma::mbar_init(&wempty[s], kConsumerWarps);
    }
    tma::fence_mbar_init();
  }
  __syncthreads();

  if (warp < 4) {
  // the producer warpgroup keeps 88 registers a thread (the loaders hold 8
  // 16-byte loads in flight) and gives the rest to the consumers: 208
  // (128 accumulators and the A fragments of a stage at N x MI = 256)
  asm volatile("setmaxnreg.dec.sync.aligned.u32 88;\n" ::: "memory");
  if (warp == 0) {
    // the weights: every stage of every tile, in the consumers' order
    if (lane == 0) {
      tma::prefetch_map(&wa);
      if (kMode == kFused) tma::prefetch_map(&wb);
      const uint32_t tx = (uint32_t)(kAtoms * TG * KC * RB);
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int co0 = (tile / t_tiles) % co_tiles * N;
        if (resident && tile != (int)blockIdx.x) break;   // every stage is in place
        int i = 0;
        for (int conv = 0; conv < (kMode == kFused ? 2 : 1); ++conv) {
          const CUtensorMap* map = conv == 0 ? &wa : &wb;
          for (int c = 0; c < (conv == 0 ? n_chunks : 1); ++c)
            for (int g = 0; g < n_groups; ++g, ++i) {
              const int s = resident ? i : it % ring;
              if (!resident) {
                if (it >= ring)
                  tma::mbar_wait(&empty[s], ((uint32_t)(it / ring) & 1u) ^ 1u);
                ++it;
              }
              tma::mbar_expect_tx(&full[s], tx);
              unsigned char* dst = smem + s * SB;
#pragma unroll
              for (int a = 0; a < kAtoms; ++a)
                tma::load_3d(dst + a * TG * KC * RB, map, &full[s], co0 + a * AW,
                             c * KC, tap0 + g * TG);
            }
        }
      }
    }
  } else {
    // the windows: chunk c's KC channels of rows [s_al, s_al + rows) of src
    // (lrelu applied for conv1), sample-major
    const int lt = threadIdx.x - 32;
    int wi = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int b = tile / (t_tiles * co_tiles);
      const int t0 = (tile % t_tiles) * TM;
      const int u0 = kMode == kFused ? t0 - half : t0;
      const int ws0 = u0 - half * kd;
      const int s_al = floor8(ws0);
      const int rows = (ws0 - s_al + kRows + (K - 1) * kd + 7) / 8 * 8;
      const __nv_bfloat16* sb = src + (size_t)b * C * T;
      for (int c = 0; c < n_chunks; ++c, ++wi) {
        const int buf = wi & 1;
        if (wi >= 2) tma::mbar_wait(&wempty[buf], ((uint32_t)(wi >> 1) & 1u) ^ 1u);
        __nv_bfloat16* w = win + buf * WR * xs;
        const int ci0 = c * KC;
        if (vec) {
          // groups of 8 lanes: 16 bytes (8 samples) of 8 channels each,
          // transposed across the group into 8 samples x 8 channels, one
          // 16-byte row segment a lane; the 4 groups of a warp take 4
          // consecutive sample groups of the same channels, 8 loads in
          // flight a lane
          const int nsg = rows / 8, n = (KC / 8) * nsg;
          const int grp = (lt >> 5) * 4 + ((lt & 31) >> 3), cl = lt & 7;
          for (int i0 = 0; i0 < n; i0 += 8 * 12) {
            uint32_t v[8][4];
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              const int i = i0 + u * 12 + grp;
              const int sg = i % nsg, ci = ci0 + (i / nsg) * 8 + cl;
              const int p = s_al + 8 * sg;
              uint4 t = make_uint4(0u, 0u, 0u, 0u);
              if (i < n && ci < C && p >= 0 && p < T)
                t = *reinterpret_cast<const uint4*>(sb + (size_t)ci * T + p);
              v[u][0] = t.x;
              v[u][1] = t.y;
              v[u][2] = t.z;
              v[u][3] = t.w;
            }
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              if (kLreluX) {
#pragma unroll
                for (int e = 0; e < 4; ++e) v[u][e] = lrelu2(v[u][e], s2);
              }
              transpose8(v[u], cl);
              const int i = i0 + u * 12 + grp;
              if (i < n) {
                const int sg = i % nsg, o = i / nsg;
                *reinterpret_cast<uint4*>(w + (8 * sg + cl) * xs + 8 * o) =
                    make_uint4(v[u][0], v[u][1], v[u][2], v[u][3]);
              }
            }
          }
        } else {
          const int n = KC * rows;
          const __nv_bfloat16 zero = __float2bfloat16(0.f);
          for (int i = lt; i < n; i += kLoaders) {
            const int ci = i % KC, r = i / KC;
            const int p = s_al + r;
            const bool ok = ci0 + ci < C && p >= 0 && p < T;
            __nv_bfloat16 v = ok ? sb[(size_t)(ci0 + ci) * T + p] : zero;
            if (kLreluX && __bfloat162float(v) < 0.f)
              v = __float2bfloat16(__bfloat162float(v) * slope_bf16);
            w[r * xs + ci] = v;
          }
        }
        tma::mbar_arrive(&wfull[buf]);
      }
    }
  }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 208;\n" ::: "memory");
    // the consumers: warpgroup cw's row blocks cw MI + [0, MI) of the tile
    const int cw = (warp >> 2) - 1, w4 = warp & 3;
    const int q = lane >> 3, r = lane & 7;
    const int g8 = lane >> 2, t4 = lane & 3;
    const int ct = threadIdx.x - 128;                    // 0 .. 255
    const int lrow = 64 * MI * cw + 16 * w4 + r + ((q & 1) << 3);   // ldmatrix row
    const int lcol = (q >> 1) << 3;
    const int mrow = 64 * MI * cw + 16 * w4 + g8;        // accumulator row (+ 8, + 64 mb)
    const uint32_t ring0 = tma::smem_u32(smem);
    float acc[MI][N / 2];
    int it = 0, wi = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int b = tile / (t_tiles * co_tiles);
      const int co0 = (tile / t_tiles) % co_tiles * N;
      const int t0 = (tile % t_tiles) * TM;
      const int u0 = kMode == kFused ? t0 - half : t0;
      const int ws0 = u0 - half * kd;
      const int r0 = ws0 - floor8(ws0);
#pragma unroll
      for (int mb = 0; mb < MI; ++mb)
#pragma unroll
        for (int e = 0; e < N / 2; ++e) acc[mb][e] = 0.f;
      if (tile == (int)blockIdx.x || co_tiles > 1) {
        // the channel tile's biases (read after the epilogue's first sync;
        // the last tile's readers are past its second)
        for (int j = ct; j < 2 * N; j += 256) {
          const float* bsrc = j < N ? ba : bb;
          const int co = co0 + (j < N ? j : j - N);
          bias_s[j] = bsrc != nullptr && co < C ? bsrc[co] : 0.f;
        }
      }
      int i = 0;
      for (int c = 0; c < n_chunks; ++c, ++wi) {
        const int buf = wi & 1;
        tma::mbar_wait(&wfull[buf], (uint32_t)(wi >> 1) & 1u);
        const __nv_bfloat16* w = win + buf * WR * xs;
        for (int g = 0; g < n_groups; ++g, ++i) {
          const int s = resident ? i : it % ring;
          tma::mbar_wait(&full[s], resident ? 0u : (uint32_t)(it / ring) & 1u);
          stage_products<N>(acc, w, xs, r0 + lrow, lcol, kd, g, TG, K, KC,
                            ring0 + s * SB);
          if (!resident) {
            __syncwarp();
            if (lane == 0) tma::mbar_arrive(&empty[s]);
            ++it;
          }
        }
        __syncwarp();
        if (lane == 0) tma::mbar_arrive(&wempty[buf]);
      }
      const size_t plane = (size_t)b * C * T;
      if (kMode == kFused) {
        // h = bf16(lrelu(conv1 + b1)) over rows u0 + [0, kRows) into stg
        consumer_sync();              // the last tile's epilogue has read stg
#pragma unroll
        for (int mb = 0; mb < MI; ++mb)
#pragma unroll
          for (int j = 0; j < N / 8; ++j)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int m = mrow + 64 * mb + 8 * hh;
              const int co = 8 * j + 2 * t4;
              const int u = u0 + m;
              if (co < KC) {
                float v0 = 0.f, v1 = 0.f;
                if (u >= 0 && u < T) {
                  if (co < C) v0 = lrelu(acc[mb][4 * j + 2 * hh] + bias_s[co], slope);
                  if (co + 1 < C)
                    v1 = lrelu(acc[mb][4 * j + 2 * hh + 1] + bias_s[co + 1], slope);
                }
                *reinterpret_cast<__nv_bfloat162*>(stg + m * xs + co) =
                    __floats2bfloat162_rn(v0, v1);
              }
            }
        consumer_sync();              // h is whole
#pragma unroll
        for (int mb = 0; mb < MI; ++mb)
#pragma unroll
          for (int e = 0; e < N / 2; ++e) acc[mb][e] = 0.f;
        for (int g = 0; g < n_groups; ++g, ++i) {
          const int s = resident ? i : it % ring;
          tma::mbar_wait(&full[s], resident ? 0u : (uint32_t)(it / ring) & 1u);
          stage_products<N>(acc, stg, xs, lrow, lcol, 1, g, TG, K, KC, ring0 + s * SB);
          if (!resident) {
            __syncwarp();
            if (lane == 0) tma::mbar_arrive(&empty[s]);
            ++it;
          }
        }
      }
      // the epilogue: the tile's values (conv1: bf16(lrelu(v)); else
      // bf16(v)), v = acc + bias, staged channel-major in stg, then written
      // in 16-byte runs of samples (conv2: y = bf16(x + staged), x read from
      // device memory); T not a multiple of 8 takes 2-byte writes instead
      const float* bias = bias_s + (kMode == kFused ? N : 0);
      const __nv_bfloat16* xres = kMode == kFused ? src : res;
      const int n_co = min(N, C - co0);
      consumer_sync();                // the last pass (kFused: conv2) read stg
#pragma unroll
      for (int mb = 0; mb < MI; ++mb)
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = mrow + 64 * mb + 8 * (e >> 1);
            const int co = 8 * j + 2 * t4 + (e & 1);
            if (co < n_co) {
              const float v = acc[mb][4 * j + e] + bias[co];
              stg[co * kSt + m] = __float2bfloat16(kMode == kConv1 ? lrelu(v, slope) : v);
            }
          }
      consumer_sync();
      if (vec) {
        // eight runs a thread at a time: their residual loads in flight
        // together
        const int m8s = TM / 8, n_runs = n_co * m8s;
        for (int k0 = 0; k0 < n_runs; k0 += 8 * 256) {
          uint4 xv[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int k2 = k0 + u * 256 + ct;
            const int co = k2 / m8s, m8 = k2 - co * m8s;
            xv[u] = make_uint4(0u, 0u, 0u, 0u);
            if (kMode != kConv1 && k2 < n_runs && t0 + 8 * m8 < T)
              xv[u] = *reinterpret_cast<const uint4*>(
                  xres + plane + (size_t)(co0 + co) * T + t0 + 8 * m8);
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int k2 = k0 + u * 256 + ct;
            const int co = k2 / m8s, m8 = k2 - co * m8s;
            const int t = t0 + 8 * m8;
            if (k2 >= n_runs || t >= T) continue;
            uint4 yv = *reinterpret_cast<const uint4*>(stg + co * kSt + 8 * m8);
            if (kMode != kConv1) {
              const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&xv[u]);
              __nv_bfloat162* y2 = reinterpret_cast<__nv_bfloat162*>(&yv);
#pragma unroll
              for (int q2 = 0; q2 < 4; ++q2) {
                const float2 a2 = __bfloat1622float2(x2[q2]), b2 = __bfloat1622float2(y2[q2]);
                y2[q2] = __floats2bfloat162_rn(a2.x + b2.x, a2.y + b2.y);
              }
            }
            *reinterpret_cast<uint4*>(out + plane + (size_t)(co0 + co) * T + t) = yv;
          }
        }
      } else {
        for (int k2 = ct; k2 < n_co * TM; k2 += 256) {
          const int co = k2 / TM, m = k2 - co * TM;
          const int u = t0 + m;
          if (u >= T) continue;
          const size_t o = plane + (size_t)(co0 + co) * T + u;
          const __nv_bfloat16 v = stg[co * kSt + m];
          out[o] = kMode == kConv1 ? v
                                   : __float2bfloat16(__bfloat162float(xres[o]) +
                                                      __bfloat162float(v));
        }
      }
    }
  }
}

struct LaunchCache {
  int max_smem = 48 * 1024;
  int occ_smem = -1, occ = 1;
};

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

template <int N, int kMode>
int launch(const CUtensorMap& wa, const CUtensorMap& wb,
           const __nv_bfloat16* src, const __nv_bfloat16* res, const float* ba,
           const float* bb, int B, int C, int T, int K, int dil, int tap0,
           int KC, int TG, int ring, bool vec, float slope, __nv_bfloat16* out,
           cudaStream_t st) {
  static LaunchCache cache;
  auto kernel = resblock_bf16_kernel<N, kMode>;
  const int smem = smem_bytes(N, kMode, K, dil, KC, TG, ring);
  const int TM = tile_samples(N, kMode, K);
  if (smem > kSmemMax || TM < 8) return (int)cudaErrorInvalidValue;
  if (smem > cache.max_smem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    cache.max_smem = smem;
  }
  if (smem != cache.occ_smem) {
    int occ = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel,
                                                                  kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    cache.occ = occ < 1 ? 1 : occ;
    cache.occ_smem = smem;
  }
  const int co_tiles = (C + N - 1) / N;
  const long long tiles = (long long)B * co_tiles * ((T + TM - 1) / TM);
  const long long cap = (long long)sm_count() * cache.occ;
  const int grid = (int)(tiles < cap ? tiles : cap);
  const float slope_bf16 = __bfloat162float(__float2bfloat16(slope));
  kernel<<<grid, kThreads, smem, st>>>(wa, wb, src, res, ba, bb, B, C, T, K,
                                       dil, tap0, KC, TG, ring, co_tiles, vec,
                                       slope_bf16, slope, out);
  return (int)cudaGetLastError();
}

template <int N>
int launch_pair(const CUtensorMap& w1, const CUtensorMap& w2,
                const __nv_bfloat16* x, const float* b1, const float* b2,
                int B, int C, int T, int K, int dil, int p, int fused, int KC,
                int TG, int ring, float slope, __nv_bfloat16* h,
                __nv_bfloat16* y, cudaStream_t st) {
  if (TG * (KC / 16) > max_steps(N)) return (int)cudaErrorInvalidValue;
  const bool vec = T % 8 == 0 && ((size_t)x & 15) == 0 && ((size_t)y & 15) == 0 &&
                   ((size_t)h & 15) == 0;
  const int tap0 = p * K;
  if (fused) {
    if (N > 64 || C > KC) return (int)cudaErrorInvalidValue;
    if constexpr (N <= 64) {
      return launch<N, kFused>(w1, w2, x, nullptr, b1, b2, B, C, T, K, dil, tap0,
                               KC, TG, ring, vec, slope, y, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  // two launches only past C = 64 (N = 128, 256): N = 64 runs fused
  if constexpr (N >= 128) {
    const int err = launch<N, kConv1>(w1, w1, x, nullptr, b1, nullptr, B, C, T, K,
                                      dil, tap0, KC, TG, ring, vec, slope, h, st);
    if (err) return err;
    return launch<N, kConv2>(w2, w2, h, x, b2, nullptr, B, C, T, K, 1, tap0, KC, TG,
                             ring, vec, slope, y, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The tensor map of one conv's weights w [P, K, C_in, C_out] (bf16, C a
// multiple of 8, 16-byte aligned) in the kernel's boxes (N output
// channels wide tiles, KC input channels, TG taps), written into `map`
// (128 bytes); the caller caches it with the weights (ops/hopper_kernels.py).
extern "C" int hifigan_resblock_bf16_weight_map(const __nv_bfloat16* w, int P,
                                                int K, int C, int N, int KC,
                                                int TG, void* map) {
  if (C % 8 != 0 || ((size_t)w & 15) != 0 || (N != 16 && N != 32 && N != 64 &&
                                               N != 128 && N != 256))
    return (int)cudaErrorInvalidValue;
  const int aw = atom_width(N);
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)C, (cuuint64_t)P * K};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)C * C * 2};
  const cuuint32_t box[3] = {(cuuint32_t)aw, (cuuint32_t)KC, (cuuint32_t)TG};
  const CUtensorMapSwizzle sw = aw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : aw == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap m;                      // the encoder wants 64-byte alignment
  const int err = tma::encode_bf16(&m, w, 3, dims, strides, box, sw);
  if (err == 0) memcpy(map, &m, sizeof m);
  return err;
}

// One dilation pair p in bf16, x -> y (x, y, h [B, C, T] bf16; C a
// multiple of 8). fused: one launch (C <= KC <= 64, h on chip); else two
// through h. The plan (N, KC, TG, ring) comes from
// hifigan_resblock_bf16_plan in ops/hopper_kernels.py; w1_map / w2_map
// from hifigan_resblock_bf16_weight_map over the P pairs' weights.
extern "C" int hifigan_resblock_pair_bf16(
    const void* w1_map, const void* w2_map, const __nv_bfloat16* x,
    const float* b1, const float* b2, int B, int C, int T, int K, int dil,
    int p, float slope, int fused, int N, int KC, int TG, int ring,
    __nv_bfloat16* h, __nv_bfloat16* y, void* stream) {
  if (K % 2 == 0 || C <= 0 || C % 8 != 0 || T < 1 || KC < 16 || KC % 16 != 0 ||
      KC > 64 || TG < 1 || ring < 2 || ring > kMaxRing)
    return (int)cudaErrorInvalidValue;
  CUtensorMap w1, w2;                 // 64-byte aligned copies
  memcpy(&w1, w1_map, sizeof w1);
  memcpy(&w2, w2_map, sizeof w2);
  cudaStream_t st = (cudaStream_t)stream;
  switch (N) {
    case 16:
      return launch_pair<16>(w1, w2, x, b1, b2, B, C, T, K, dil, p, fused, KC, TG,
                             ring, slope, h, y, st);
    case 32:
      return launch_pair<32>(w1, w2, x, b1, b2, B, C, T, K, dil, p, fused, KC, TG,
                             ring, slope, h, y, st);
    case 64:
      return launch_pair<64>(w1, w2, x, b1, b2, B, C, T, K, dil, p, fused, KC, TG,
                             ring, slope, h, y, st);
    case 128:
      return launch_pair<128>(w1, w2, x, b1, b2, B, C, T, K, dil, p, fused, KC, TG,
                              ring, slope, h, y, st);
    case 256:
      return launch_pair<256>(w1, w2, x, b1, b2, B, C, T, K, dil, p, fused, KC, TG,
                              ring, slope, h, y, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

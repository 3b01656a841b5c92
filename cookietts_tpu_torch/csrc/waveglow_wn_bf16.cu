// The WaveNet coupling net (WN) of one WaveGlow flow in its bf16 form:
//   h = start(bf16(x)); for each of L layers {acts = conv_{kw taps, dilation
//   2^i}(h) + cond_bc[i]; z = tanh(acts_a) * sigmoid(acts_g); (res, skip) =
//   rs_w^T z + rs_b; h += res; skip_sum += skip}; st = end(skip_sum)
// with bf16 weights and cond_bc, f32 biases, and h, z, the residual sum and
// the skip sum f32.
//
// Replaces the TPU kernel cookietts_tpu/ops/pallas_kernels.py:
// waveglow_wn_forward (:609, body _waveglow_wn_kernel :544) as the JAX
// package runs it with bf16 weights (models/waveglow.py:681-719): x is
// rounded to bf16 only as the start product's operand (:563), every other
// product is f32 arithmetic on the bf16 weights (a dot of a bf16 and an f32
// array widens the bf16 side), and h, z, the residual and skip sums stay
// f32 (:566-600).
//
// Bound on the H100: operations. A layer does 2 * 2C * (kw + 1) * C flops a
// sample (1.05 MFLOP at C = 256, kw = 3). Here each f32 operand is three
// bf16 pieces, so a flop is three bf16 tensor-core products: the 48 calls of
// a 5 s infer (T' = 10000) are 4.03 TFLOP, 12.2 ms at 989 / 3 TFLOP/s
// (16.0 ms at the 2xTF32 rate of the first bf16 form). A layer moves about
// 50 MB (h in and out and the skip sum in f32, cond_bc in bf16): 15 us, 5.7
// ms an infer.
//
// Design: one launch a layer (L + 2 a call with the start and end
// products), an implicit GEMM on wgmma, z kept on chip.
// - A block owns 64 samples of one batch row (the M of one wgmma) and all
//   2C outputs of both products, so the res/skip product finds all of z in
//   the block. Its two consumer warpgroups split the channels: pass p, warp-
//   group w owns channel block j = 2p + w of CB channels, and computes its
//   a and g halves as one product of N = 2 CB columns (a in the first CB,
//   g in the last), so a thread holds a and g of the same (sample, channel)
//   and the gate is elementwise in registers.
// - The activation window is wgmma's register operand (the tap's shift of
//   (tap - kw/2) 2^i samples would not fit a shared operand's layout): TMA
//   brings the f32 h of 16 channels around the tap's 64 shifted samples per
//   stage (three 32-sample boxes, 128-byte swizzled, zeros past either end
//   of the sequence; a box's first sample must start on 16 bytes, so they
//   start at the shifted first sample rounded down to 4, and the reads skip
//   the remaining 0-3 rows), and each thread reads its A fragment's 8 values
//   and splits each into three bf16 pieces (split3): three wgmmas, lo, mid, hi,
//   share one B, the stage's bf16 weights, also by TMA (MN-major: [in][out]
//   as it is). A stage is (pass, tap, 16 input channels), in a ring of full
//   and empty mbarriers fed by one producer thread.
// - The gate: z = gtu(a + cond_a, g + cond_g), cond_bc read from device
//   memory in the accumulator's layout. z goes to shared memory in the
//   layout of the thread that computed it: the A fragment of the res/skip
//   product for a thread's rows is, register for register, that thread's
//   accumulator of the conv (rows 16 w + g, + 8; columns 8 j + 2 t, + 1),
//   so each thread later reads back the fragment of the other warpgroup's
//   thread with the same index, after one barrier between the two.
// - res/skip: stages of rs_w (16 z channels each) against z's three pieces;
//   warpgroup w of pass p owns res and skip of channel block 2p + w (N =
//   2 CB: res first), and its epilogue writes h_out = h + res into the other
//   of two h buffers (the conv of this launch still reads h around other
//   blocks' samples) and adds skip to the skip sum.
// - The tensor core sums a product's terms with truncation; the hi, mid
//   and lo products of each stage go into one accumulator, lo first.
#include "wn_bf16.cuh"

namespace {

using namespace wnb;

constexpr int kTile = 64;                  // samples a block
constexpr int kKC = 16;                    // input channels a stage
constexpr int kWinBytes = 3 * kKC * 128;   // three boxes of 16 channels x 32 f32 samples
constexpr int kChunk = 8;                  // epilogue values whose loads go out together

// Bytes of a stage: the window and two warpgroups' weights (16 rows of
// 2 x 2 CB columns).
__host__ __device__ constexpr int stage_bytes(int CB) { return kWinBytes + 128 * CB; }

__host__ __device__ inline int smem_bytes(int CB, int P, int ring) {
  return 1024 + ring * stage_bytes(CB) + 512 * P * CB + 2 * kMaxRing * 8;
}

// The byte of f32 window value (channel k, sample m) in a stage: boxes of
// 32 samples, rows of 128 bytes, 16-byte chunks swizzled by the row.
__device__ __forceinline__ int win_off(int k, int m) {
  return (m >> 5) * (kKC * 128) + k * 128 + ((((m & 31) >> 2) ^ (k & 7)) << 4) +
         (m & 3) * 4;
}

// One stage's three products: acc += A(v) B, A's 8 values v in fragment
// order (a0 lo, a0 hi, a1 lo, ..., a3 hi), split into three bf16 pieces;
// B at shared address wb (this warpgroup's 2 CB / AW atoms).
template <int CB>
__device__ __forceinline__ void products(float (&acc)[CB], const float (&v)[8],
                                         uint32_t wb) {
  constexpr int AW = atom_width(CB), RB = 2 * AW;
  uint32_t a[3][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) split3(v[2 * r], v[2 * r + 1], a[0][r], a[1][r], a[2][r]);
  const uint64_t b = wgmma::desc(wb, kKC * RB, 8 * RB, wgmma_layout(AW));
#pragma unroll
  for (int e = 0; e < CB; ++e) wgmma::keep(acc[e]);
  wgmma::fence();
  wgmma::Mma<2 * CB>::run(acc, a[2], b);
  wgmma::Mma<2 * CB>::run(acc, a[1], b);
  wgmma::Mma<2 * CB>::run(acc, a[0], b);
  wgmma::commit();
  wgmma::wait<0>();
#pragma unroll
  for (int e = 0; e < CB; ++e) wgmma::keep(acc[e]);
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int r = 0; r < 4; ++r) wgmma::keep(a[q][r]);
}

// One layer. hmap: h_in as (T, C, B) f32; kmap, rmap: k_all and rs_w
// (encode_weights); cond [B][L][2C][Tp] bf16; rs_b [L][2C]. grid
// (ceil(T / 64), B), kThreads threads.
template <int CB>
__global__ void __launch_bounds__(kThreads, 1)
glow_layer(const __grid_constant__ CUtensorMap hmap,
           const __grid_constant__ CUtensorMap kmap,
           const __grid_constant__ CUtensorMap rmap, const float* __restrict__ h_in,
           float* __restrict__ h_out, float* __restrict__ skip,
           const bf16* __restrict__ cond, const float* __restrict__ rs_b, int layer,
           int L, int C, int T, int Tp, int kw, int dil, int P, int ring, int first,
           int has_res) {
  constexpr int AW = atom_width(CB), ATOM = kKC * 2 * AW, NA = CB / AW;
  constexpr int SB = stage_bytes(CB);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = tma::align1024(smem_raw);
  float* zs = reinterpret_cast<float*>(smem + ring * SB);        // [2P][CB/2][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(zs + P * CB * 128);
  uint64_t* empty = full + kMaxRing;
  const int b = blockIdx.y, t0 = blockIdx.x * kTile;
  const int nk = (C + kKC - 1) / kKC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ring; ++s) {
      tma::mbar_init(&full[s], 1);
      tma::mbar_init(&empty[s], kConsumerWarps);
    }
    tma::fence_mbar_init();
  }
  __syncthreads();

  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      tma::prefetch_map(&hmap);
      tma::prefetch_map(&kmap);
      tma::prefetch_map(&rmap);
      int it = 0;
      auto next = [&](uint32_t bytes) {
        const int s = it % ring;
        if (it >= ring) tma::mbar_wait(&empty[s], ((uint32_t)(it / ring) & 1u) ^ 1u);
        ++it;
        tma::mbar_expect_tx(&full[s], bytes);
        return s;
      };
      for (int p = 0; p < P; ++p)
        for (int tap = 0; tap < kw; ++tap)
          for (int kc = 0; kc < nk; ++kc) {
            const int s = next(SB);
            unsigned char* dst = smem + s * SB;
            const int lead = (t0 + (tap - kw / 2) * dil) & ~3;
            for (int box = 0; box < 3; ++box)
              tma::load_3d(dst + box * kKC * 128, &hmap, &full[s], lead + 32 * box,
                           kc * kKC, b);
            for (int w = 0; w < 2; ++w)
              for (int half = 0; half < 2; ++half)
                for (int a = 0; a < NA; ++a)
                  tma::load_5d(dst + kWinBytes + ((w * 2 + half) * NA + a) * ATOM, &kmap,
                               &full[s], (2 * p + w) * CB + a * AW, half, kc * kKC, tap,
                               layer);
          }
      for (int p = 0; p < P; ++p)
        for (int kc = 0; kc < nk; ++kc) {
          const int s = next(SB - kWinBytes);
          unsigned char* dst = smem + s * SB + kWinBytes;
          for (int w = 0; w < 2; ++w)
            for (int half = 0; half < 2; ++half)
              for (int a = 0; a < NA; ++a)
                tma::load_4d(dst + ((w * 2 + half) * NA + a) * ATOM, &rmap, &full[s],
                             (2 * p + w) * CB + a * AW, half, kc * kKC, layer);
        }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = (warp >> 2) - 1, w4 = warp & 3;
    const int ct = threadIdx.x - 128 * (cw + 1);          // 0 .. 127
    const int g = lane >> 2, t4 = lane & 3;
    const int m0 = 16 * w4 + g;                           // rows m0, m0 + 8
    const uint32_t ring0 = tma::smem_u32(smem);
    const uint32_t wofs = kWinBytes + cw * 2 * NA * ATOM; // this warpgroup's weights
    const size_t plane = (size_t)C * Tp;
    float acc[CB];
    int it = 0;

    for (int p = 0; p < P; ++p) {
      const int j = 2 * p + cw;
#pragma unroll
      for (int e = 0; e < CB; ++e) acc[e] = 0.f;
      for (int tap = 0; tap < kw; ++tap) {
        // the window's first row is the shifted first sample rounded down
        // to 4: this thread's fragment values lie `lag` rows further
        const int lag = ((tap - kw / 2) * dil) & 3;
        int off[8];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            off[2 * r + e] = win_off(2 * t4 + e + 8 * (r >> 1), m0 + 8 * (r & 1) + lag);
        for (int kc = 0; kc < nk; ++kc, ++it) {
          const int s = it % ring;
          tma::mbar_wait(&full[s], (uint32_t)(it / ring) & 1u);
          const unsigned char* win = smem + s * SB;
          float v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = *reinterpret_cast<const float*>(win + off[e]);
          products<CB>(acc, v, ring0 + s * SB + wofs);
          __syncwarp();
          if (lane == 0) tma::mbar_arrive(&empty[s]);
        }
      }
      // the gate, into z's shared memory in this thread's fragment order,
      // kChunk values at a time: their cond_bc loads first, all in flight
      // together (a load after a store would wait for it)
      const bf16* ca = cond + (((size_t)b * L + layer) * 2 * C) * Tp;
      float* zw = zs + (size_t)j * (CB / 2) * 128 + ct;
#pragma unroll
      for (int i0 = 0; i0 < CB / 2; i0 += kChunk) {
        float xa[kChunk], xg[kChunk];
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const int i = i0 + u;
          const int c = j * CB + 8 * (i >> 2) + 2 * t4 + (i & 1);
          const int t = t0 + m0 + 8 * ((i >> 1) & 1);
          const bool ok = c < C && t < T;
          xa[u] = ok ? bf2f(ca[(size_t)c * Tp + t]) : 0.f;
          xg[u] = ok ? bf2f(ca[(size_t)(C + c) * Tp + t]) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const int i = i0 + u;
          const int c = j * CB + 8 * (i >> 2) + 2 * t4 + (i & 1);
          zw[i * 128] = c < C ? gtu(acc[i] + xa[u], acc[i + CB / 2] + xg[u]) : 0.f;
        }
      }
    }
    consumer_sync();                                      // all of z is in

    const float* bias = rs_b + (size_t)layer * 2 * C;
    for (int p = 0; p < P; ++p) {
      const int j = 2 * p + cw;
#pragma unroll
      for (int e = 0; e < CB; ++e) acc[e] = 0.f;
      for (int kc = 0; kc < nk; ++kc, ++it) {
        const int s = it % ring;
        tma::mbar_wait(&full[s], (uint32_t)(it / ring) & 1u);
        // z channels 16 kc ..: block jb's fragment values lc / 2 .. + 8
        const int jb = kc * kKC / CB, lc = kc * kKC - jb * CB;
        const float* zr = zs + ((size_t)jb * (CB / 2) + lc / 2) * 128 + ct;
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = zr[e * 128];
        products<CB>(acc, v, ring0 + s * SB + wofs);
        __syncwarp();
        if (lane == 0) tma::mbar_arrive(&empty[s]);
      }
      // kChunk values at a time: every load first, then the stores
#pragma unroll
      for (int i0 = 0; i0 < CB / 2; i0 += kChunk) {
        float hv[kChunk], sv[kChunk], br[kChunk], bs[kChunk];
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const int i = i0 + u;
          const int c = j * CB + 8 * (i >> 2) + 2 * t4 + (i & 1);
          const int t = t0 + m0 + 8 * ((i >> 1) & 1);
          const bool ok = c < C && t < T;
          const size_t o = (size_t)b * plane + (size_t)c * Tp + t;
          hv[u] = ok && has_res ? h_in[o] : 0.f;
          sv[u] = ok && !first ? skip[o] : 0.f;
          br[u] = ok ? bias[c] : 0.f;
          bs[u] = ok ? bias[C + c] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const int i = i0 + u;
          const int c = j * CB + 8 * (i >> 2) + 2 * t4 + (i & 1);
          const int t = t0 + m0 + 8 * ((i >> 1) & 1);
          if (c >= C || t >= T) continue;
          const size_t o = (size_t)b * plane + (size_t)c * Tp + t;
          if (has_res) h_out[o] = hv[u] + (acc[i] + br[u]);
          const float v = acc[i + CB / 2] + bs[u];
          skip[o] = first ? v : sv[u] + v;
        }
      }
    }
  }
}

template <int CB>
int run(const float* x, const bf16* cond, const bf16* start_w, const float* start_b,
        const bf16* k_all, const bf16* rs_w, const float* rs_b, const bf16* end_w,
        const float* end_b, int B, int Cin, int C, int Cout, int T, int Tp, int L,
        int kw, int P, int ring, float* scratch, float* st, int* launches,
        cudaStream_t stream) {
  constexpr int AW = atom_width(CB);
  const int smem = smem_bytes(CB, P, ring);
  if (smem > kSmemMax || 2 * P * CB < C) return (int)cudaErrorInvalidValue;
  static int allowed = 48 * 1024;
  auto kernel = glow_layer<CB>;
  int err = (int)allow_smem(kernel, smem, allowed);
  if (err) return err;
  const size_t bct = (size_t)B * C * Tp;
  float* h[2] = {scratch, scratch + bct};
  float* skip = scratch + 2 * bct;
  CUtensorMap hmap[2], kmap, rmap;
  for (int i = 0; i < 2 && !err; ++i) {
    const cuuint64_t dims[3] = {(cuuint64_t)T, (cuuint64_t)C, (cuuint64_t)B};
    const cuuint64_t strides[2] = {(cuuint64_t)Tp * 4, (cuuint64_t)C * Tp * 4};
    const cuuint32_t box[3] = {32, kKC, 1};
    err = tma::encode(&hmap[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, h[i], 3, dims, strides,
                      box, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (!err) err = encode_weights(&kmap, k_all, C, kw, L, AW, kKC);
  if (!err) err = encode_weights(&rmap, rs_w, C, 0, L, AW, kKC);
  if (err) return err;
  glow_start<<<small_grid(T, C, B), kSmall, 0, stream>>>(x, start_w, start_b, Cin, C,
                                                         T, Tp, h[0]);
  if ((err = (int)cudaGetLastError())) return err;
  ++*launches;
  const dim3 grid((T + kTile - 1) / kTile, B);
  for (int i = 0; i < L; ++i) {
    kernel<<<grid, kThreads, smem, stream>>>(hmap[i & 1], kmap, rmap, h[i & 1],
                                             h[(i + 1) & 1], skip, cond, rs_b, i, L, C,
                                             T, Tp, kw, 1 << i, P, ring, i == 0,
                                             i < L - 1);
    if ((err = (int)cudaGetLastError())) return err;
    ++*launches;
  }
  wn_end<false><<<end_grid(T, Cout, B), kSmall, 0, stream>>>(skip, end_w, end_b, C,
                                                             Cout, T, Tp, st);
  if ((err = (int)cudaGetLastError())) return err;
  ++*launches;
  return 0;
}

}  // namespace

// x [B][Cin][T] f32; cond [B][L][2C][Tp] bf16; start_w [Cin][C] bf16,
// start_b [C] f32; k_all [L][kw*C][2C], rs_w [L][C][2C] bf16; rs_b [L][2C]
// f32; end_w [C][Cout] bf16, end_b [Cout] f32; C a multiple of 8, Tp a
// multiple of 8 and >= T (the rows' pitch of cond and of scratch); plan:
// (CB, passes, ring) from wn_bf16_plan("glow", ...) in ops/hopper_kernels.py;
// scratch [3][B][C][Tp] f32 (two h buffers, the skip sum); st [B][Cout][T]
// f32. Counts the kernels launched in *launches (L + 2). Returns a CUDA
// error code.
extern "C" int waveglow_wn_forward_bf16(
    const float* x, const __nv_bfloat16* cond, const __nv_bfloat16* start_w,
    const float* start_b, const __nv_bfloat16* k_all, const __nv_bfloat16* rs_w,
    const float* rs_b, const __nv_bfloat16* end_w, const float* end_b, int B,
    int Cin, int C, int Cout, int T, int Tp, int L, int kw, const int* plan,
    float* scratch, float* st, int* launches, void* stream) {
  *launches = 0;
  const int CB = plan[0], P = plan[1], ring = plan[2];
  if (C < 8 || C % 8 || Tp % 8 || Tp < T || T < 1 || kw % 2 == 0 || P < 1 ||
      ring < 2 || ring > kMaxRing || !aligned16(k_all) || !aligned16(rs_w) ||
      !aligned16(scratch))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (CB) {
    case 16:
      return run<16>(x, cond, start_w, start_b, k_all, rs_w, rs_b, end_w, end_b, B,
                     Cin, C, Cout, T, Tp, L, kw, P, ring, scratch, st, launches, s);
    case 32:
      return run<32>(x, cond, start_w, start_b, k_all, rs_w, rs_b, end_w, end_b, B,
                     Cin, C, Cout, T, Tp, L, kw, P, ring, scratch, st, launches, s);
    case 64:
      return run<64>(x, cond, start_w, start_b, k_all, rs_w, rs_b, end_w, end_b, B,
                     Cin, C, Cout, T, Tp, L, kw, P, ring, scratch, st, launches, s);
    case 128:
      return run<128>(x, cond, start_w, start_b, k_all, rs_w, rs_b, end_w, end_b, B,
                      Cin, C, Cout, T, Tp, L, kw, P, ring, scratch, st, launches, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

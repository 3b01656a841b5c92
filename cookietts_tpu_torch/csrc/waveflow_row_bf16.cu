// One height row of the WaveFlow inverse in its bf16 form: the 2-D WaveNet
// coupling net (WN2D) for the row below the rows generated so far,
//   h = bf16(start(x_prev)); for each of L layers {acts = conv_{kh rows x kw
//   taps, width dilation 2^i}(the layer's last kh-1 input rows, h) +
//   cond_bc[i]; z = bf16(tanh(acts_a) * sigmoid(acts_g)); (res, skip) =
//   rs_w^T z + rs_b; h = bf16(h + bf16(res)); skip_sum += skip};
//   (log_s, t) = end_w^T bf16(skip_sum) + end_b
// with every layer's input rows kept in a ring of kh row slots.
//
// Replaces the TPU kernel cookietts_tpu/ops/pallas_kernels.py:
// waveflow_row_step (:467, body _waveflow_row_kernel :360) as the JAX
// package runs it with bf16 queues (models/waveglow.py:905-956): the ring,
// z, the weights, cond_bc and the start bias bf16, x_prev and the skip sum
// f32, the rs and end biases f32; products of bf16 operands summed in f32;
// h rounded after the start (:393), z after the gate (:448), h + bf16(res)
// a bf16 sum (:452), the skip sum rounded as the end product's operand
// (:456). The ring: row `step` of layer i's input lives in slot step % kh
// of ring [L][kh][B][C][W]; the conv reads all kh slots with its kernel
// rows rotated by step % kh, and the epilogue writes h + res into slot
// step % kh of layer i+1's ring, the oldest row there, which no block of the
// launch reads (ops/hopper_kernels.py: waveflow_row_step).
//
// Bound on the H100: bytes. A layer does 2 * 2C * (kh kw + 1) * C flops a
// sample (164 kFLOP at C = 64, kh = kw = 3) and moves 2 * 2C bytes of cond,
// 2 * (kh + 1) C of rows and 8 C of the f32 skip sum (read and written): 130
// flops a byte, under the bf16 balance (295): the 48 row steps of a 5 s
// infer (W = 30000) move 7.4 GB, 2.2 ms at 3.35 TB/s.
//
// Design: one launch a layer (L + 2 a row with the start and end
// products), an implicit GEMM on wgmma with z on chip.
// - A block owns 128 samples of one batch row and all 2C outputs: each of
//   its two consumer warpgroups 64 samples (the M of one wgmma) by N = 2 CB
//   columns, the a half then the g half of the same CB >= C channels, so a
//   thread holds a and g of the same (sample, channel).
// - The activation window is wgmma's register operand. A stage is (kernel
//   row r, tap, 64 input channels): TMA brings the ring slot's bf16 row
//   around the tap's shifted samples, channel-major, in three boxes of
//   [channel][64 samples] (128-byte swizzled; zeros past either end of the
//   row) that start at the block's shifted first sample rounded down to 8
//   (a box's first sample must start on 16 bytes). Where the shift is a
//   multiple of 8 (dilations from 8 on, and every centre tap)
//   ldmatrix.trans reads the A fragments out of it; else each register is
//   packed from two 2-byte reads, 0-7 rows further. The stage's weights
//   come by TMA too (MN-major: [in][out] as it is), into a ring of full /
//   empty mbarriers fed by one producer thread. The block's cond_bc tile
//   comes by TMA at the start.
// - The gate runs in registers and its bf16 output is packed straight into
//   the A fragments of the res/skip product (the accumulator of rows 16 w
//   + g, + 8 and columns 8 j + 2 t, + 1 is, register for register, the A
//   fragment of those rows): z never leaves the registers. The res/skip
//   product (N = 2 CB: res, then skip) reads rs_w by TMA; its epilogue
//   writes h + bf16(res) into the next layer's ring and adds skip to the
//   f32 skip sum.
#include "wn_bf16.cuh"

namespace {

using namespace wnb;

constexpr int kTile = 128;                 // samples a block, 64 a consumer warpgroup
constexpr int kChunk = 8;                  // epilogue values whose loads go out together

__host__ __device__ constexpr int kc_of(int CB) { return CB < 64 ? CB : 64; }

// Bytes of a stage: the window, three boxes of KC channels x 64 samples,
// and the weights (KC rows of 2 CB columns).
__host__ __device__ constexpr int stage_bytes(int CB) {
  return 3 * kc_of(CB) * 128 + 4 * kc_of(CB) * CB;
}

// cond_bc's tile: [warpgroup][a, g][CB channels][64 samples].
__host__ __device__ constexpr int cond_bytes(int CB) { return 4 * CB * 128; }

__host__ __device__ inline int smem_bytes(int CB, int ring) {
  return 1024 + cond_bytes(CB) + ring * stage_bytes(CB) + (2 * kMaxRing + 1) * 8;
}

// The byte of bf16 value (channel k, sample m) in a [rows][64 samples] box:
// rows of 128 bytes, 16-byte chunks swizzled by the row.
__device__ __forceinline__ int box_off(int k, int m) {
  return k * 128 + ((((m >> 3) ^ (k & 7))) << 4) + (m & 7) * 2;
}

// One layer. ringmap: the ring as (W, C, B, kh, L); condmap: cond_bc as
// (W, C, 2, L, B); kmap, rmap: k_all and rs_w (encode_weights); rs_b
// [L][2C]. grid (ceil(W / 128), B), kThreads threads.
template <int CB>
__global__ void __launch_bounds__(kThreads, 1)
flow_layer(const __grid_constant__ CUtensorMap ringmap,
           const __grid_constant__ CUtensorMap condmap,
           const __grid_constant__ CUtensorMap kmap,
           const __grid_constant__ CUtensorMap rmap, __nv_bfloat16* __restrict__ ring,
           float* __restrict__ skip, const float* __restrict__ rs_b, int layer,
           int C, int W, int Wp, int B, int kh, int kw, int rot, int dil, int n_ring,
           int first, int has_res) {
  constexpr int KC = kc_of(CB), NKC = CB / KC;
  constexpr int AW = atom_width(CB), RB = 2 * AW, ATOM = KC * RB, NA = CB / AW;
  constexpr int BOX = KC * 128, WIN = 3 * BOX, SB = stage_bytes(CB), N = 2 * CB;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = tma::align1024(smem_raw);
  unsigned char* stages = smem + cond_bytes(CB);
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + n_ring * SB);
  uint64_t* empty = full + kMaxRing;
  uint64_t* cbar = empty + kMaxRing;
  const int b = blockIdx.y, t0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < n_ring; ++s) {
      tma::mbar_init(&full[s], 1);
      tma::mbar_init(&empty[s], kConsumerWarps);
    }
    tma::mbar_init(cbar, 1);
    tma::fence_mbar_init();
  }
  __syncthreads();

  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      tma::prefetch_map(&ringmap);
      tma::prefetch_map(&condmap);
      tma::prefetch_map(&kmap);
      tma::prefetch_map(&rmap);
      tma::mbar_expect_tx(cbar, cond_bytes(CB));
      for (int w = 0; w < 2; ++w)
        for (int half = 0; half < 2; ++half)
          tma::load_5d(smem + (w * 2 + half) * CB * 128, &condmap, cbar, t0 + 64 * w, 0,
                       half, layer, b);
      int it = 0;
      auto next = [&](uint32_t bytes) {
        const int s = it % n_ring;
        if (it >= n_ring) tma::mbar_wait(&empty[s], ((uint32_t)(it / n_ring) & 1u) ^ 1u);
        ++it;
        tma::mbar_expect_tx(&full[s], bytes);
        return s;
      };
      for (int r = 0; r < kh; ++r) {
        const int slot = (rot + 1 + r) % kh;
        for (int tap = 0; tap < kw; ++tap)
          for (int kc = 0; kc < NKC; ++kc) {
            const int s = next(SB);
            unsigned char* dst = stages + s * SB;
            const int lead = (t0 + (tap - kw / 2) * dil) & ~7;
            for (int box = 0; box < 3; ++box)
              tma::load_5d(dst + box * BOX, &ringmap, &full[s], lead + 64 * box, kc * KC,
                           b, slot, layer);
            for (int half = 0; half < 2; ++half)
              for (int a = 0; a < NA; ++a)
                tma::load_5d(dst + WIN + (half * NA + a) * ATOM, &kmap, &full[s], a * AW,
                             half, kc * KC, r * kw + tap, layer);
          }
      }
      for (int kc = 0; kc < NKC; ++kc) {
        const int s = next(SB - WIN);
        unsigned char* dst = stages + s * SB + WIN;
        for (int half = 0; half < 2; ++half)
          for (int a = 0; a < NA; ++a)
            tma::load_4d(dst + (half * NA + a) * ATOM, &rmap, &full[s], a * AW, half,
                         kc * KC, layer);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = (warp >> 2) - 1, w4 = warp & 3;
    const int g = lane >> 2, t4 = lane & 3;
    const int m0 = 16 * w4 + g;                         // rows m0, m0 + 8
    // ldmatrix.trans: lane gives row (channel) k0 + 8 (q / 2) + r of the
    // 8 x 8 matrix q at samples 16 w + 8 (q % 2) ..: A fragment a[q]
    const int q = lane >> 3, r8 = lane & 7;
    const int krow = 8 * (q >> 1) + r8, mchunk = 2 * w4 + (q & 1);
    const uint32_t stage0 = tma::smem_u32(stages);
    constexpr uint32_t kLayout = wgmma_layout(AW);
    float acc[CB];
#pragma unroll
    for (int e = 0; e < CB; ++e) acc[e] = 0.f;
    int it = 0;
    for (int r = 0; r < kh; ++r)
      for (int tap = 0; tap < kw; ++tap) {
        // the window's first row is the shifted first sample rounded down to
        // 8: this warpgroup's rows start `lag` rows into box cw
        const int lag = ((tap - kw / 2) * dil) & 7;
#pragma unroll
        for (int kc = 0; kc < NKC; ++kc, ++it) {
          const int s = it % n_ring;
          tma::mbar_wait(&full[s], (uint32_t)(it / n_ring) & 1u);
          const unsigned char* win = stages + s * SB;
          uint32_t a[KC / 16][4];
          if (lag == 0) {
#pragma unroll
            for (int kk = 0; kk < KC / 16; ++kk) {
              const int k = 16 * kk + krow;
              bf16mma::ldmatrix_x4_trans(
                  a[kk], win + cw * BOX + k * 128 + ((mchunk ^ (k & 7)) << 4));
            }
          } else {
            // a[kk][i]: rows m0 + 8 (i % 2), channels 16 kk + 2 t4 + 8 (i / 2), + 1
#pragma unroll
            for (int kk = 0; kk < KC / 16; ++kk)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int k = 16 * kk + 2 * t4 + 8 * (i >> 1);
                const int m = 64 * cw + m0 + 8 * (i & 1) + lag;
                const unsigned char* p = win + (m >> 6) * BOX;
                a[kk][i] = (uint32_t)*reinterpret_cast<const unsigned short*>(
                               p + box_off(k, m & 63)) |
                           ((uint32_t)*reinterpret_cast<const unsigned short*>(
                                p + box_off(k + 1, m & 63))
                            << 16);
              }
          }
#pragma unroll
          for (int e = 0; e < CB; ++e) wgmma::keep(acc[e]);
          wgmma::fence();
#pragma unroll
          for (int kk = 0; kk < KC / 16; ++kk)
            wgmma::Mma<N>::run(acc, a[kk],
                               wgmma::desc(stage0 + s * SB + WIN + kk * 16 * RB, ATOM,
                                           8 * RB, kLayout));
          wgmma::commit();
          wgmma::wait<0>();
#pragma unroll
          for (int e = 0; e < CB; ++e) wgmma::keep(acc[e]);
#pragma unroll
          for (int kk = 0; kk < KC / 16; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) wgmma::keep(a[kk][e]);
          __syncwarp();
          if (lane == 0) tma::mbar_arrive(&empty[s]);
        }
      }

    // the gate: z = bf16(gtu(a + cond_a, g + cond_g)), packed into the A
    // fragments of the res/skip product (k16 chunk i / 8, register i % 8 / 2)
    tma::mbar_wait(cbar, 0);
    const unsigned char* cs = smem + cw * 2 * CB * 128;
    uint32_t zf[CB / 16][4];
#pragma unroll
    for (int jj = 0; jj < CB / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int c = 8 * jj + 2 * t4, m = m0 + 8 * (e >> 1);
        float z[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float xa = bf2f(*reinterpret_cast<const bf16*>(cs + box_off(c + u, m)));
          const float xg =
              bf2f(*reinterpret_cast<const bf16*>(cs + CB * 128 + box_off(c + u, m)));
          z[u] = c + u < C ? gtu(acc[4 * jj + e + u] + xa,
                                 acc[4 * (jj + CB / 8) + e + u] + xg)
                           : 0.f;
        }
        const int i = 4 * jj + e;
        zf[i >> 3][(i & 7) >> 1] = as_u32(__floats2bfloat162_rn(z[0], z[1]));
      }

#pragma unroll
    for (int e = 0; e < CB; ++e) acc[e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < NKC; ++kc, ++it) {
      const int s = it % n_ring;
      tma::mbar_wait(&full[s], (uint32_t)(it / n_ring) & 1u);
#pragma unroll
      for (int e = 0; e < CB; ++e) wgmma::keep(acc[e]);
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
        wgmma::Mma<N>::run(acc, zf[kc * (KC / 16) + kk],
                           wgmma::desc(stage0 + s * SB + WIN + kk * 16 * RB, ATOM, 8 * RB,
                                       kLayout));
      wgmma::commit();
      wgmma::wait<0>();
#pragma unroll
      for (int e = 0; e < CB; ++e) wgmma::keep(acc[e]);
#pragma unroll
      for (int kk = 0; kk < CB / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) wgmma::keep(zf[kk][e]);
      __syncwarp();
      if (lane == 0) tma::mbar_arrive(&empty[s]);
    }

    // h + bf16(res) into slot rot of layer i+1's ring; skip into the sum
    const size_t slot = (size_t)B * C * Wp;
    const __nv_bfloat16* h = ring + ((size_t)layer * kh + rot) * slot;
    __nv_bfloat16* h_next = ring + ((size_t)(layer + 1) * kh + rot) * slot;
    const float* bias = rs_b + (size_t)layer * 2 * C;
    // kChunk values at a time: every load first, all in flight together (a
    // load after a store through a pointer it may alias would wait for it)
#pragma unroll
    for (int i0 = 0; i0 < CB / 2; i0 += kChunk) {
      float hv[kChunk], sv[kChunk], br[kChunk], bs[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int i = i0 + u;
        const int c = 8 * (i >> 2) + 2 * t4 + (i & 1);
        const int t = t0 + 64 * cw + m0 + 8 * ((i >> 1) & 1);
        const bool ok = c < C && t < W;
        const size_t o = ((size_t)b * C + c) * Wp + t;
        hv[u] = ok && has_res ? bf2f(h[o]) : 0.f;
        sv[u] = ok && !first ? skip[o] : 0.f;
        br[u] = ok ? bias[c] : 0.f;
        bs[u] = ok ? bias[C + c] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int i = i0 + u;
        const int c = 8 * (i >> 2) + 2 * t4 + (i & 1);
        const int t = t0 + 64 * cw + m0 + 8 * ((i >> 1) & 1);
        if (c >= C || t >= W) continue;
        const size_t o = ((size_t)b * C + c) * Wp + t;
        if (has_res)
          h_next[o] = __float2bfloat16(hv[u] + bf2f(__float2bfloat16(acc[i] + br[u])));
        const float v = acc[i + CB / 2] + bs[u];
        skip[o] = first ? v : sv[u] + v;
      }
    }
  }
}

template <int CB>
int run(const float* x_prev, __nv_bfloat16* ring, int step, const bf16* cond,
        const bf16* start_w, const bf16* start_b, const bf16* k_all, const bf16* rs_w,
        const float* rs_b, const bf16* end_w, const float* end_b, int B, int C, int W,
        int Wp, int L, int kh, int kw, int n_ring, float* skip, float* st,
        int* launches, cudaStream_t stream) {
  constexpr int AW = atom_width(CB), KC = kc_of(CB);
  const int smem = smem_bytes(CB, n_ring);
  if (smem > kSmemMax || C > CB) return (int)cudaErrorInvalidValue;
  static int allowed = 48 * 1024;
  auto kernel = flow_layer<CB>;
  int err = (int)allow_smem(kernel, smem, allowed);
  if (err) return err;
  CUtensorMap ringmap, condmap, kmap, rmap;
  {
    const cuuint64_t row = (cuuint64_t)Wp * 2;
    const cuuint64_t dims[5] = {(cuuint64_t)W, (cuuint64_t)C, (cuuint64_t)B,
                                (cuuint64_t)kh, (cuuint64_t)L};
    const cuuint64_t strides[4] = {row, row * C, row * C * B, row * C * B * kh};
    const cuuint32_t box[5] = {64, (cuuint32_t)KC, 1, 1, 1};
    err = tma::encode_bf16(&ringmap, ring, 5, dims, strides, box,
                           CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (!err) {
    const cuuint64_t row = (cuuint64_t)Wp * 2;
    const cuuint64_t dims[5] = {(cuuint64_t)W, (cuuint64_t)C, 2, (cuuint64_t)L,
                                (cuuint64_t)B};
    const cuuint64_t strides[4] = {row, row * C, row * C * 2, row * C * 2 * L};
    const cuuint32_t box[5] = {64, (cuuint32_t)CB, 1, 1, 1};
    err = tma::encode_bf16(&condmap, cond, 5, dims, strides, box,
                           CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (!err) err = encode_weights(&kmap, k_all, C, kh * kw, L, AW, KC);
  if (!err) err = encode_weights(&rmap, rs_w, C, 0, L, AW, KC);
  if (err) return err;
  const int rot = step % kh;
  const size_t slot = (size_t)B * C * Wp;
  flow_start<<<small_grid(W, C, B), kSmall, 0, stream>>>(x_prev, start_w, start_b, C,
                                                         W, Wp, ring + rot * slot);
  if ((err = (int)cudaGetLastError())) return err;
  ++*launches;
  const dim3 grid((W + kTile - 1) / kTile, B);
  for (int i = 0; i < L; ++i) {
    kernel<<<grid, kThreads, smem, stream>>>(ringmap, condmap, kmap, rmap, ring, skip,
                                             rs_b, i, C, W, Wp, B, kh, kw, rot, 1 << i,
                                             n_ring, i == 0, i < L - 1);
    if ((err = (int)cudaGetLastError())) return err;
    ++*launches;
  }
  wn_end<true><<<end_grid(W, 2, B), kSmall, 0, stream>>>(skip, end_w, end_b, C, 2, W,
                                                         Wp, st);
  if ((err = (int)cudaGetLastError())) return err;
  ++*launches;
  return 0;
}

}  // namespace

// x_prev [B][W] f32; ring [L][kh][B][C][Wp] bf16; cond [B][L][2C][Wp] bf16;
// start_w [C], start_b [C] bf16; k_all [L][kh*kw*C][2C], rs_w [L][C][2C]
// bf16; rs_b [L][2C] f32; end_w [C][2] bf16, end_b [2] f32; C a multiple of
// 8, at most 128; Wp a multiple of 8 and >= W (the rows' pitch of the ring,
// cond and scratch); plan: (CB, ring) from wn_bf16_plan("flow", ...) in
// ops/hopper_kernels.py; scratch [B][C][Wp] f32 (the skip sum); st [B][2][W]
// = (log_s, t). Counts the kernels launched in *launches (L + 2). Returns a
// CUDA error code.
extern "C" int waveflow_row_step_bf16(
    const float* x_prev, __nv_bfloat16* ring, int step, const __nv_bfloat16* cond,
    const __nv_bfloat16* start_w, const __nv_bfloat16* start_b,
    const __nv_bfloat16* k_all, const __nv_bfloat16* rs_w, const float* rs_b,
    const __nv_bfloat16* end_w, const float* end_b, int B, int C, int W, int Wp, int L,
    int kh, int kw, const int* plan, float* scratch, float* st, int* launches,
    void* stream) {
  *launches = 0;
  const int CB = plan[0], n_ring = plan[1];
  if (C < 8 || C % 8 || Wp % 8 || Wp < W || W < 1 || kw % 2 == 0 || kh < 1 ||
      n_ring < 2 || n_ring > kMaxRing || !aligned16(ring) || !aligned16(cond) ||
      !aligned16(k_all) || !aligned16(rs_w))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (CB) {
    case 16:
      return run<16>(x_prev, ring, step, cond, start_w, start_b, k_all, rs_w, rs_b,
                     end_w, end_b, B, C, W, Wp, L, kh, kw, n_ring, scratch, st,
                     launches, s);
    case 32:
      return run<32>(x_prev, ring, step, cond, start_w, start_b, k_all, rs_w, rs_b,
                     end_w, end_b, B, C, W, Wp, L, kh, kw, n_ring, scratch, st,
                     launches, s);
    case 64:
      return run<64>(x_prev, ring, step, cond, start_w, start_b, k_all, rs_w, rs_b,
                     end_w, end_b, B, C, W, Wp, L, kh, kw, n_ring, scratch, st,
                     launches, s);
    case 128:
      return run<128>(x_prev, ring, step, cond, start_w, start_b, k_all, rs_w, rs_b,
                      end_w, end_b, B, C, W, Wp, L, kh, kw, n_ring, scratch, st,
                      launches, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

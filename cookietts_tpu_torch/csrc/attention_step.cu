// One step of location-sensitive attention, fused: energies, mask, softmax
// and the context product in one pass per batch row.
//
// Replaces the TPU kernel cookietts_tpu/ops/pallas_kernels.py:attention_step
// (body _attention_kernel). Computes, for batch row b:
//   e[t]   = scale * sum_a v[a] * tanh(qp[b,a] + lp[b,t,a] + mp[b,t,a])
//   e[t]   = mask[b,t] ? e[t] : -1e30
//   w[b,:] = softmax(e)
//   ctx[b,d] = sum_t w[b,t] * memory[b,t,d]
// scale is a device scalar (the learned softmax temperature) or null for 1.
//
// Bound on the H100: bytes. The step reads lp, mp and memory once
// ([B,T,A] twice and [B,T,D]) and does O(T*(A+D)) flops on them, far below
// the card's flop-per-byte balance. Design: one block per batch row; warps
// take two t at a time and reduce over A with shuffles (lanes read
// neighbouring a, so each warp's loads of a row are coalesced); the
// energies and then the weights stay in shared memory. For the context,
// each thread owns 4 neighbouring d (one float4 load per t) and one of
// 256 / (D/4) interleaved subsets of t, so a row's loads are coalesced and
// several rows are in flight at once; the subsets' sums meet in shared
// memory. With a decode-size batch there are only B blocks, so the design
// aims at short dependent chains rather than at occupancy. Nothing but w
// and ctx goes back to device memory. D must be a multiple of 4.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reduction through `red` (32 floats); every thread gets the result.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float r = lane < kThreads / 32 ? red[lane] : (kMax ? -INFINITY : 0.f);
    r = kMax ? warp_max(r) : warp_sum(r);
    if (lane == 0) red[0] = r;
  }
  __syncthreads();
  const float out = red[0];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(kThreads)
attention_step_kernel(const float* __restrict__ qp, const float* __restrict__ lp,
                      const float* __restrict__ mp, const float* __restrict__ v,
                      const float* __restrict__ memory,
                      const unsigned char* __restrict__ mask,
                      const float* __restrict__ scale, int T, int A, int D,
                      float* __restrict__ ctx, float* __restrict__ w) {
  extern __shared__ float smem[];
  float* q_s = smem;       // [A]
  float* v_s = q_s + A;    // [A]
  float* e_s = v_s + A;    // [T] energies, then weights
  float* c_s = e_s + T;    // [parts][D] context partial sums
  __shared__ float red[32];

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float sc = scale ? *scale : 1.f;
  for (int a = threadIdx.x; a < A; a += kThreads) {
    q_s[a] = qp[(size_t)b * A + a];
    v_s[a] = v[a];
  }
  __syncthreads();

  const float* lp_b = lp + (size_t)b * T * A;
  const float* mp_b = mp + (size_t)b * T * A;
  for (int t = 2 * warp; t < T; t += kThreads / 16) {
    const bool two = t + 1 < T;           // the pair's second row exists
    const float* l0 = lp_b + (size_t)t * A;
    const float* m0 = mp_b + (size_t)t * A;
    float s0 = 0.f, s1 = 0.f;
    for (int a = lane; a < A; a += 32) {
      s0 += v_s[a] * tanhf(q_s[a] + l0[a] + m0[a]);
      if (two) s1 += v_s[a] * tanhf(q_s[a] + l0[A + a] + m0[A + a]);
    }
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);
    if (lane == 0) {
      e_s[t] = mask[(size_t)b * T + t] ? s0 * sc : kNeg;
      if (two) e_s[t + 1] = mask[(size_t)b * T + t + 1] ? s1 * sc : kNeg;
    }
  }
  __syncthreads();

  float m = -INFINITY;
  for (int t = threadIdx.x; t < T; t += kThreads) m = fmaxf(m, e_s[t]);
  m = block_reduce<true>(m, red);
  float s = 0.f;
  for (int t = threadIdx.x; t < T; t += kThreads) {
    const float p = expf(e_s[t] - m);
    e_s[t] = p;
    s += p;
  }
  s = block_reduce<false>(s, red);
  for (int t = threadIdx.x; t < T; t += kThreads) {
    const float wt = e_s[t] / s;
    e_s[t] = wt;
    w[(size_t)b * T + t] = wt;
  }
  __syncthreads();

  const int D4 = D / 4;
  const int parts = max(1, kThreads / D4);
  const float4* mem_b = reinterpret_cast<const float4*>(memory + (size_t)b * T * D);
  for (int i = threadIdx.x; i < parts * D4; i += kThreads) {
    const int part = i / D4, d4 = i - part * D4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int t = part; t < T; t += parts) {
      const float wt = e_s[t];
      const float4 mv = __ldg(mem_b + (size_t)t * D4 + d4);
      acc.x += wt * mv.x;
      acc.y += wt * mv.y;
      acc.z += wt * mv.z;
      acc.w += wt * mv.w;
    }
    float* c = c_s + part * D + 4 * d4;
    c[0] = acc.x;
    c[1] = acc.y;
    c[2] = acc.z;
    c[3] = acc.w;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float acc = 0.f;
    for (int part = 0; part < parts; ++part) acc += c_s[part * D + d];
    ctx[(size_t)b * D + d] = acc;
  }
}

}  // namespace

extern "C" int attention_step(const float* qp, const float* lp, const float* mp,
                              const float* v, const float* memory,
                              const unsigned char* mask, const float* scale,
                              int B, int T, int A, int D, float* ctx, float* w,
                              void* stream) {
  const int parts = kThreads / (D / 4) > 1 ? kThreads / (D / 4) : 1;
  const size_t smem = (size_t)(2 * A + T + parts * D) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        attention_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  attention_step_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      qp, lp, mp, v, memory, mask, scale, T, A, D, ctx, w);
  return (int)cudaGetLastError();
}

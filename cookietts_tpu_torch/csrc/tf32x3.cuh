// Tensor-core building blocks shared by the kernels that compute f32
// products on TF32 tensor cores in the 3xTF32 split (hifigan_resblock.cu,
// wn_layer.cuh): padded shared-memory strides, cp.async copies, the operand
// split, one m16n8k8 product, and a warp's share of one K step.
//
// - 3xTF32: each operand a is split as hi = a with its 13 low mantissa bits
//   cleared (a TF32 value) and lo = a - hi (exact), which the tensor core
//   reads as TF32 in turn; a*b is taken as lo_a*hi_b + hi_a*lo_b + hi_a*hi_b.
//   hi*hi alone (1xTF32) keeps 10 mantissa bits of each operand, a relative
//   error near 2^-11 per product: 1e-3 on a sum of thousands of terms. The
//   three products keep about 20 bits of each operand, and the dropped
//   lo*lo is under 2^-20 relative, so the result stays within f32's error
//   (tests/test_torch_kernels.py emulates the split in numpy).
// - The tensor core's own accumulation truncates. Summed into one register
//   over a dot product thousands of terms long, that bias grows to about
//   1e-4 of the output, so mma_chunk sums each K step into a fresh
//   accumulator and adds it to the running sum with an ordinary f32 add.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// A shared-memory row stride >= w with stride % 16 == 8 (8 or 24 mod 32):
// the fragment loads of a warp (4 rows x 8 columns) hit 32 banks.
__host__ __device__ constexpr int pad_stride(int w) {
  return (w - 8 + 15) / 16 * 16 + 8;
}

// Device to shared memory without passing through registers (cp.async).
// copy_async16: four floats, both addresses 16-byte aligned; past the L1.
__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// copy_async16z: as copy_async16, zeros when !valid (src is then not read).
__device__ __forceinline__ void copy_async16z(float* dst, const float* src,
                                              bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

// copy_async4: one float, zero when !valid (src is then not read).
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

// 3xTF32 split of one operand, two instructions: hi = a with the 13 low
// mantissa bits cleared (a TF32 value), lo = a - hi (exact). lo goes in as
// its f32 bits, of which the tensor core reads the TF32 part, so a product
// keeps about 20 bits of each operand.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(a) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

// d += a * b, one m16n8k8 TF32 product with f32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int MI, int NJ>
__device__ __forceinline__ void zero(float (&acc)[MI][NJ][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// A warp's share of one K step (kc input channels), in 3xTF32:
//   acc[i][j] (rows m0 + 16 i .., columns n0 + 8 j ..) +=
//     sum_{k < kc} ws[k][m] * src[k][n]
// ws: weights [kc][wst] (output channel fastest); src: activations [kc][sst]
// (sample fastest), already offset by the tap. Rows m >= m_valid read as 0.
// Fragment layouts of m16n8k8 (g = lane / 4, t = lane % 4): A (g, t),
// (g+8, t), (g, t+4), (g+8, t+4); B (t, g), (t+4, g); D (g, 2t), (g, 2t+1),
// (g+8, 2t), (g+8, 2t+1).
// The step is summed into a fresh accumulator, then added to acc with an
// f32 add (the truncation note at the head of this file). Within a step a
// warp runs all its lo*hi products, then the hi*lo, then the hi*hi, so
// consecutive products never wait on one accumulator.
template <int MI, int NJ>
__device__ __forceinline__ void mma_chunk(const float* ws, int wst, int m0,
                                          int m_valid, const float* src,
                                          int sst, int n0, int kc,
                                          float (&acc)[MI][NJ][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float part[MI][NJ][4];
  zero(part);
  for (int k0 = 0; k0 < kc; k0 += 8) {
    uint32_t ah[MI][4], al[MI][4], bh[NJ][2], bl[NJ][2];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int m = m0 + 16 * i + g;
      const float* w0 = ws + (k0 + t) * wst + m;
      const float* w4 = w0 + 4 * wst;
      const bool lo_ok = m < m_valid, hi_ok = m + 8 < m_valid;
      split_tf32(lo_ok ? w0[0] : 0.f, ah[i][0], al[i][0]);
      split_tf32(hi_ok ? w0[8] : 0.f, ah[i][1], al[i][1]);
      split_tf32(lo_ok ? w4[0] : 0.f, ah[i][2], al[i][2]);
      split_tf32(hi_ok ? w4[8] : 0.f, ah[i][3], al[i][3]);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* s0 = src + (k0 + t) * sst + n0 + 8 * j + g;
      split_tf32(s0[0], bh[j][0], bl[j][0]);
      split_tf32(s0[4 * sst], bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma_tf32(part[i][j], al[i], bh[j]);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma_tf32(part[i][j], ah[i], bl[j]);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma_tf32(part[i][j], ah[i], bh[j]);
  }
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
}

}  // namespace tf32x3

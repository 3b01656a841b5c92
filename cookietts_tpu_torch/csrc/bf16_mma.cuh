// bf16 tensor-core building blocks (the bf16 kernels: lstm_gates_bf16.cu,
// hifigan_resblock_bf16.cu, waveflow_row_bf16.cu): fragment loads from
// shared memory with ldmatrix and one m16n8k16 product with bf16 operands
// and f32 accumulators.
//
// Fragment layouts of mma.m16n8k16 with bf16 operands (g = lane / 4,
// t = lane % 4; each register holds two bf16, the lower index in the low
// half):
//   A (16 x 16, row m, column k): a[0] (g, 2t..2t+1), a[1] (g+8, 2t..),
//     a[2] (g, 2t+8..), a[3] (g+8, 2t+8..);
//   B (16 x 8, row k, column n): b[0] (2t..2t+1, g), b[1] (2t+8.., g);
//   D (16 x 8): d[0] (g, 2t), d[1] (g, 2t+1), d[2] (g+8, 2t), d[3] (g+8, 2t+1).
// ldmatrix.x4 loads four 8 x 8 matrices of 16-bit values; lane L gives the
// address of row L % 8 of matrix L / 8 (16 contiguous, 16-byte aligned
// bytes), and register j of every lane receives its share of matrix j:
// (row g, columns 2t, 2t+1) as stored, or, with .trans, (rows 2t, 2t+1,
// column g).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bf16mma {

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a * b: one m16n8k16 product, bf16 operands, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t b0, const uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace bf16mma

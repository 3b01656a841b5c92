#!/usr/bin/env python3
"""The card's rate for warp-level tensor-core products (mma.sync), the
instruction the hifigan_resblock kernel is built on.

    python3 tools/bench_mma_rate.py

Builds a small CUDA file with nvcc (sm_90a) into build/, then times kernels
whose warps issue nothing but independent mma.sync products on registers:
TF32 m16n8k8 (f32 accumulate) and, for comparison, BF16 m16n8k16. Prints
TFLOP/s beside the card's name and power limit. The 3xTF32 ceiling of a
kernel built on mma.sync is a third of the TF32 rate.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = r'''
#include <cuda_runtime.h>
#include <stdint.h>
constexpr int kAcc = 16;
__global__ void __launch_bounds__(256) tf32_rate(int iters, float* out) {
  float acc[kAcc][4] = {};
  uint32_t a[4], b[2];
  for (int e = 0; e < 4; ++e) a[e] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + e);
  for (int e = 0; e < 2; ++e) b[e] = __float_as_uint(1.0f - threadIdx.x * 1e-3f + e);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(acc[i][0]), "+f"(acc[i][1]), "+f"(acc[i][2]), "+f"(acc[i][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int i = 0; i < kAcc; ++i) s += acc[i][0] + acc[i][1] + acc[i][2] + acc[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void __launch_bounds__(256) bf16_rate(int iters, float* out) {
  float acc[kAcc][4] = {};
  uint32_t a[4], b[2];
  for (int e = 0; e < 4; ++e) a[e] = 0x3f803f80u + threadIdx.x + e;
  for (int e = 0; e < 2; ++e) b[e] = 0x3f803f80u - threadIdx.x + e;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
      asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(acc[i][0]), "+f"(acc[i][1]), "+f"(acc[i][2]), "+f"(acc[i][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int i = 0; i < kAcc; ++i) s += acc[i][0] + acc[i][1] + acc[i][2] + acc[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(int which, int blocks, int iters, float* out, float* ms) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int rep = 0; rep < 2; ++rep) {       // the first is the warm-up
    cudaEventRecord(e0);
    if (which == 0) tf32_rate<<<blocks, 256>>>(iters, out);
    else bf16_rate<<<blocks, 256>>>(iters, out);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
  }
  cudaEventElapsedTime(ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return (int)cudaGetLastError();
}
'''


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("bench_mma_rate: no CUDA device", file=sys.stderr)
        return 1
    out_dir = ROOT / "build" / "bench_mma_rate"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "mma_rate.cu").write_text(SRC)
    lib_path = out_dir / "libmma_rate.so"
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(lib_path),
                    str(out_dir / "mma_rate.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 8 * 256, device="cuda")
    iters = 20000
    for which, name, flops_per_mma in ((0, "tf32 m16n8k8", 2 * 16 * 8 * 8),
                                       (1, "bf16 m16n8k16", 2 * 16 * 8 * 16)):
        for blocks_per_sm in (1, 2, 4, 8):
            blocks = sms * blocks_per_sm
            ms = ctypes.c_float()
            err = lib.run(which, blocks, iters, ctypes.c_void_p(out.data_ptr()),
                          ctypes.byref(ms))
            if err:
                raise RuntimeError(f"CUDA error {err}")
            flops = blocks * 8 * 16 * iters * flops_per_mma
            print(f"{name}: {blocks_per_sm} blocks of 8 warps per SM: "
                  f"{flops / ms.value / 1e9:.1f} TFLOP/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

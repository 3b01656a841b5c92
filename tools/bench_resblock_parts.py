#!/usr/bin/env python3
"""Where the hifigan_resblock kernel's time goes, by taking work out of it.

    python3 tools/bench_resblock_parts.py

Builds csrc/hifigan_resblock.cu as it is and in three altered copies, each
with nvcc (sm_90a) into build/bench_resblock_parts/, and times the 3
resblocks of each of the main path's four generator stages (B=3, T_mel=512:
C=256 ... 32) with each build, in CUDA-graph replay:
  kernel     the kernel as shipped (3xTF32: three products per product)
  no-split   operands passed as they are, no hi/lo split (wrong results)
  one-mma    only the hi*hi product (1xTF32: about 1e-2 off)
The difference between kernel and one-mma is the cost of two thirds of the
tensor-core products; what one-mma keeps besides its products is the
kernel's overhead (loads, splits, addressing, barriers, epilogues).
Prints the card's name and power limit, and each time beside the max abs
error against the plain version.
"""
from __future__ import annotations

import concurrent.futures as cf
import ctypes
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "cookietts_tpu_torch" / "csrc" / "hifigan_resblock.cu"
SPLIT_A = '''      split_tf32(lo_ok ? w0[0] : 0.f, ah[i][0], al[i][0]);
      split_tf32(hi_ok ? w0[8] : 0.f, ah[i][1], al[i][1]);
      split_tf32(lo_ok ? w4[0] : 0.f, ah[i][2], al[i][2]);
      split_tf32(hi_ok ? w4[8] : 0.f, ah[i][3], al[i][3]);'''
RAW_A = '''      ah[i][0] = al[i][0] = __float_as_uint(w0[0]);
      ah[i][1] = al[i][1] = __float_as_uint(w0[8]);
      ah[i][2] = al[i][2] = __float_as_uint(w4[0]);
      ah[i][3] = al[i][3] = __float_as_uint(w4[8]);'''
SPLIT_B = '''      split_tf32(s0[0], bh[j][0], bl[j][0]);
      split_tf32(s0[4 * sst], bh[j][1], bl[j][1]);'''
RAW_B = '''      bh[j][0] = bl[j][0] = __float_as_uint(s0[0]);
      bh[j][1] = bl[j][1] = __float_as_uint(s0[4 * sst]);'''
SMALL_PRODUCTS = '''#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma_tf32(part[i][j], al[i], bh[j]);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma_tf32(part[i][j], ah[i], bl[j]);
'''


def variants(src: str):
    for pattern in (SPLIT_A, SPLIT_B, SMALL_PRODUCTS):
        if pattern not in src:
            raise SystemExit(f"bench_resblock_parts: {SRC.name} no longer has "
                             f"the code this tool alters:\n{pattern}")
    return {"kernel": src,
            "no-split": src.replace(SPLIT_A, RAW_A).replace(SPLIT_B, RAW_B),
            "one-mma": src.replace(SMALL_PRODUCTS, "")}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("bench_resblock_parts: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from cookietts_tpu_torch.ops import hopper_kernels as hk
    torch.backends.cudnn.allow_tf32 = False
    out = ROOT / "build" / "bench_resblock_parts"
    out.mkdir(parents=True, exist_ok=True)

    def build(item):
        name, text = item
        src = out / f"{name}.cu"
        src.write_text(text)
        lib = out / f"lib{name}.so"
        subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode",
                        "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), str(src)],
                       check=True)
        return name, ctypes.CDLL(str(lib))

    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(3) as ex:
        libs = dict(ex.map(build, variants(SRC.read_text()).items()))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s")

    def run(lib, x, w1, b1, w2, b2, dilations, slope):
        B, C, T = x.shape
        k = w1.shape[1]
        plans = [hk.hifigan_resblock_plan(B, C, T, k, d) for d in dilations]
        h = torch.empty_like(x) if plans[0][3] == "split" else None
        for p, (d, (tile, _, smem, variant)) in enumerate(zip(dilations, plans)):
            y = torch.empty_like(x)
            err = lib.hifigan_resblock_pair(
                hk._ptr(x), hk._ptr(w1[p]), hk._ptr(b1[p]), hk._ptr(w2[p]),
                hk._ptr(b2[p]), B, C, T, k, d, ctypes.c_float(slope),
                0 if variant == "fused" else 1, tile, ctypes.c_longlong(smem),
                hk._ptr(h), hk._ptr(y), hk._stream())
            if err:
                raise RuntimeError(f"CUDA error {err}")
            x = y
        return x

    g = torch.Generator(device="cuda").manual_seed(0)
    for C, T in ((256, 4096), (128, 32768), (64, 131072), (32, 262144)):
        x = torch.randn(3, C, T, device="cuda", generator=g)
        stage = []
        for k in (3, 7, 11):
            _, w1, b1, w2, b2 = cs.resblock_inputs(1, C, 8, k, g)
            stage.append((x, w1, b1, w2, b2, (1, 3, 5), 0.1))
        want = hk.hifigan_resblock_plain(*stage[-1])
        line = f"stage C={C} T={T}, 3 resblocks:"
        for name, lib in libs.items():
            err = float((run(lib, *stage[-1]) - want).abs().max())
            ms = cs.time_ms(lambda: [run(lib, *a) for a in stage], 5)
            line += f" {name} {ms:.3f} ms (max abs err {err:.1e});"
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the time of the 3xTF32 kernels goes (hifigan_resblock and the WN
layer kernel), by taking work out of them.

    python3 tools/bench_resblock_parts.py

Builds csrc/hifigan_resblock.cu and csrc/waveglow_wn.cu as they are and
with two altered copies of the header they take their products from
(csrc/tf32x3.cuh), each with nvcc (sm_90a) into
build/bench_resblock_parts/<variant>/, and times with each build the 3
resblocks of each of the main path's four generator stages (B=3, T_mel=512:
C=256 ... 32) and one WaveGlow WN call at the main path's shape (B=1,
T'=10000, 256 channels, 8 layers), in CUDA-graph replay:
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
HEADER = SRC.with_name("tf32x3.cuh")
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


def variants(header: str):
    """The header as it is and altered, by variant name."""
    for pattern in (SPLIT_A, SPLIT_B, SMALL_PRODUCTS):
        if pattern not in header:
            raise SystemExit(f"bench_resblock_parts: {HEADER.name} no longer has "
                             f"the code this tool alters:\n{pattern}")
    return {"kernel": header,
            "no-split": header.replace(SPLIT_A, RAW_A).replace(SPLIT_B, RAW_B),
            "one-mma": header.replace(SMALL_PRODUCTS, "")}


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
        (name, header), source = item
        src = out / name / source
        src.parent.mkdir(exist_ok=True)
        for f in [source] + [h.name for h in SRC.parent.glob("*.cuh")]:
            src.with_name(f).write_text(SRC.with_name(f).read_text())
        src.with_name(HEADER.name).write_text(header)    # found beside src first
        lib = out / name / f"lib{src.stem}.so"
        subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode",
                        "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), str(src)],
                       check=True)
        return (name, source), ctypes.CDLL(str(lib))

    t0 = time.perf_counter()
    jobs = [(v, source) for v in variants(HEADER.read_text()).items()
            for source in (SRC.name, "waveglow_wn.cu")]
    with cf.ThreadPoolExecutor(len(jobs)) as ex:
        built = dict(ex.map(build, jobs))
    libs = {name: built[name, SRC.name] for name, _ in built}
    wn_libs = {name: built[name, "waveglow_wn.cu"] for name, _ in built}
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

    def run_wn(lib, x, cond, start_w, start_b, k_all, rs_w, rs_b, end_w, end_b):
        B, Cin, T = x.shape
        L, K, C2 = k_all.shape
        C, Cout = C2 // 2, end_w.shape[1]
        plan = hk.wn_layer_plan(B, C, T, 1, K // C)
        scratch = torch.empty((3, B, C, T), device="cuda")
        st = torch.empty((B, Cout, T), device="cuda")
        launches = ctypes.c_int(0)
        err = lib.waveglow_wn_forward(
            *(hk._ptr(t) for t in (x, cond, start_w, start_b, k_all, rs_w, rs_b,
                                   end_w, end_b)),
            B, Cin, C, Cout, T, L, K // C, (ctypes.c_int * 6)(*plan.ints()),
            hk._ptr(scratch),
            hk._ptr(st), ctypes.byref(launches), hk._stream())
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return st

    args = (torch.randn(1, 12, 10000, device="cuda", generator=g),
            torch.randn(1, 8, 512, 10000, device="cuda", generator=g),
            *cs.wn_weights(g, 12, 256, 24, 8, 1, 3))
    want = hk.waveglow_wn_forward_plain(*args)
    line = "waveglow_wn_forward B=1 T'=10000, one call:"
    for name, lib in wn_libs.items():
        err = float((run_wn(lib, *args) - want).abs().max())
        ms = cs.time_ms(lambda: run_wn(lib, *args), 20)
        line += f" {name} {ms:.4f} ms (max abs err {err:.1e});"
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

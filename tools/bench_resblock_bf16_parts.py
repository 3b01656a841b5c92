#!/usr/bin/env python3
"""Where the time of the bf16 resblock kernel goes, stage by stage.

    python3 tools/bench_resblock_bf16_parts.py

Builds csrc/hifigan_resblock_bf16.cu (nvcc, sm_90a) into
build/bench_resblock_bf16_parts/ as shipped and with parts cut from its
text (PARTS, by bit: 1 the windows' loads, 2 the stores of the output, 4
the products; 7 leaves the kernel's skeleton of barriers, weight stream
and epilogue), and times the 3 resblocks of each of the bench-serving
generator's four stages (B=3, T_mel=512: C = 256 ... 32) with each build
in CUDA-graph replay. Then a build with clock64 probes patched in (PROBES)
runs one resblock (k = 3 and 11) of each stage and prints, per block and
launch, the clocks the first consumer thread spent waiting for windows and
weight stages, in products, in h's epilogue, in staging and writing the
output, and the loaders' and the producer's waits. Prints the card's name
and power limit.
"""
from __future__ import annotations

import concurrent.futures as cf
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PARTS = {0: "kernel", 2: "no stores", 4: "no products", 7: "skeleton"}
# the text each bit of PARTS replaces
CUTS = {
    1: [("        if (vec) {\n          // groups of 8 lanes",
         "        if (true) {\n        } else if (vec) {\n          // groups of 8 lanes")],
    2: [("            *reinterpret_cast<uint4*>(out + plane + (size_t)(co0 + co) * T + t)"
         " = yv;\n", "")],
    4: [("  const int steps = taps * sub;\n", "  const int steps = 0;\n")],
}
# clock64 probes: g_prof[i] sums the clocks of the spans named in PROFILE
PROF_DEFS = """
__device__ unsigned long long g_prof[16];
#define PROF_T(v) const long long v = clock64()
#define PROF_ADD(i, t) atomicAdd(&g_prof[i], (unsigned long long)(clock64() - (t)))
"""
PROF_EXPORT = """
extern "C" int hifigan_resblock_bf16_profile(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  if (reset) {
    unsigned long long z[16] = {};
    cudaMemcpyToSymbol(g_prof, z, sizeof(z));
  }
  return (int)e;
}
"""
STAGE_WAIT = "          tma::mbar_wait(&full[s], resident ? 0u : (uint32_t)(it / ring) & 1u);\n"
PROBES = [
    ('#include "wgmma_bf16.cuh"\n', '#include "wgmma_bf16.cuh"\n' + PROF_DEFS),
    ("                if (it >= ring)\n"
     "                  tma::mbar_wait(&empty[s], ((uint32_t)(it / ring) & 1u) ^ 1u);\n",
     "                PROF_T(pe);\n"
     "                if (it >= ring)\n"
     "                  tma::mbar_wait(&empty[s], ((uint32_t)(it / ring) & 1u) ^ 1u);\n"
     "                PROF_ADD(10, pe);\n"),
    ("        if (wi >= 2) tma::mbar_wait(&wempty[buf], ((uint32_t)(wi >> 1) & 1u) ^ 1u);\n",
     "        PROF_T(lw);\n"
     "        if (wi >= 2) tma::mbar_wait(&wempty[buf], ((uint32_t)(wi >> 1) & 1u) ^ 1u);\n"
     "        if (lt == 0) PROF_ADD(8, lw);\n        PROF_T(ll);\n"),
    ("        tma::mbar_arrive(&wfull[buf]);\n",
     "        if (lt == 0) PROF_ADD(9, ll);\n        tma::mbar_arrive(&wfull[buf]);\n"),
    ('    asm volatile("setmaxnreg.inc.sync.aligned.u32 208;\\n" ::: "memory");\n',
     '    asm volatile("setmaxnreg.inc.sync.aligned.u32 208;\\n" ::: "memory");\n'
     "    long long g_start = 0, c_start = clock64();\n"
     '    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_start));\n'
     "    int n_tiles = 0;\n"),
    ("        tma::mbar_wait(&wfull[buf], (uint32_t)(wi >> 1) & 1u);\n",
     "        PROF_T(cw0);\n"
     "        tma::mbar_wait(&wfull[buf], (uint32_t)(wi >> 1) & 1u);\n"
     "        if (ct == 0) PROF_ADD(0, cw0);\n"),
    (STAGE_WAIT + "          stage_products<N>(acc, w, xs, r0 + lrow, lcol, kd, g, TG, K, KC,\n"
     "                            ring0 + s * SB);\n",
     "          PROF_T(cf0);\n" + STAGE_WAIT + "          if (ct == 0) PROF_ADD(1, cf0);\n"
     "          PROF_T(cp0);\n"
     "          stage_products<N>(acc, w, xs, r0 + lrow, lcol, kd, g, TG, K, KC,\n"
     "                            ring0 + s * SB);\n"
     "          if (ct == 0) PROF_ADD(2, cp0);\n"),
    ("      if (kMode == kFused) {\n", "      PROF_T(ch0);\n      if (kMode == kFused) {\n"),
    ("          for (int e = 0; e < N / 2; ++e) acc[mb][e] = 0.f;\n"
     "        for (int g = 0; g < n_groups; ++g, ++i) {\n",
     "          for (int e = 0; e < N / 2; ++e) acc[mb][e] = 0.f;\n"
     "        if (ct == 0) PROF_ADD(3, ch0);\n"
     "        if (ct == 128) PROF_ADD(7, ch0);   // the second warpgroup's\n"
     "        for (int g = 0; g < n_groups; ++g, ++i) {\n"),
    (STAGE_WAIT + "          stage_products<N>(acc, stg, xs, lrow, lcol, 1, g, TG, K, KC,"
     " ring0 + s * SB);\n",
     "          PROF_T(cf1);\n" + STAGE_WAIT + "          if (ct == 0) PROF_ADD(1, cf1);\n"
     "          PROF_T(cp1);\n"
     "          stage_products<N>(acc, stg, xs, lrow, lcol, 1, g, TG, K, KC,"
     " ring0 + s * SB);\n"
     "          if (ct == 0) PROF_ADD(4, cp1);\n"),
    ("      consumer_sync();                // the last pass",
     "      PROF_T(cs0);\n      consumer_sync();                // the last pass"),
    ("      consumer_sync();\n      if (vec) {\n",
     "      consumer_sync();\n      if (ct == 0) PROF_ADD(5, cs0);\n      PROF_T(cq0);\n"
     "      if (vec) {\n"),
    ("                                                      __bfloat162float(v));\n"
     "        }\n      }\n    }\n  }\n}\n",
     "                                                      __bfloat162float(v));\n"
     "        }\n      }\n      if (ct == 0) PROF_ADD(6, cq0);\n      ++n_tiles;\n    }\n"
     "    if (ct == 0) {\n      long long g_end = 0;\n"
     '      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_end));\n'
     "      PROF_ADD(11, c_start);\n"
     "      atomicAdd(&g_prof[12], (unsigned long long)(g_end - g_start));\n"
     "      atomicAdd(&g_prof[13], (unsigned long long)n_tiles);\n"
     "      atomicAdd(&g_prof[14], 1ull);\n    }\n  }\n}\n"),
]


def patched(text: str, edits) -> str:
    """text with each (old, new) of edits applied; each old must occur once."""
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"{old!r} occurs {text.count(old)} times")
        text = text.replace(old, new)
    return text


def variant(text: str, v) -> str:
    """The source of a PARTS value, or of "profile"."""
    if v == "profile":
        return patched(text, PROBES) + PROF_EXPORT
    return patched(text, [e for bit, edits in CUTS.items() if v & bit for e in edits])
PROFILE = ("wait window", "wait stage", "conv1 products", "h epilogue",
           "conv2 (waits, products)", "staging", "writes",
           "h epilogue (second warpgroup)", "loaders: wait", "loaders: load",
           "producer: wait", "total")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("bench_resblock_bf16_parts: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from cookietts_tpu_torch.ops import _build
    from cookietts_tpu_torch.ops import hopper_kernels as hk
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    _build.load_all()
    src = _build.CSRC / "hifigan_resblock_bf16.cu"
    out = ROOT / "build" / "bench_resblock_bf16_parts"
    out.mkdir(parents=True, exist_ok=True)

    def build(name, v):
        cu, lib = out / f"{name}.cu", out / f"lib{name}.so"
        cu.write_text(variant(src.read_text(), v))
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                        "-o", str(lib), str(cu)], check=True, capture_output=True)
        return name, ctypes.CDLL(str(lib))

    jobs = [(str(v), v) for v in PARTS] + [("profile", "profile")]
    with cf.ThreadPoolExecutor(len(jobs)) as ex:
        libs = dict(ex.map(lambda j: build(*j), jobs))

    g = torch.Generator(device="cuda").manual_seed(0)
    B, T, stages = 3, 512, []
    for C, u in ((256, 8), (128, 8), (64, 4), (32, 2)):
        T *= u
        x = cs.bf16(torch.randn(B, C, T, device="cuda", generator=g))
        blocks = []
        for k in (3, 7, 11):
            _, w1, b1, w2, b2 = cs.resblock_inputs(1, C, 1, k, g)
            blocks.append((x, cs.bf16(w1), b1, cs.bf16(w2), b2, (1, 3, 5), 0.1))
        stages.append((C, T, blocks))
    print(f"3 resblocks a stage, B={B}, ms in graph replay ({smi})", flush=True)
    for v, what in PARTS.items():
        _build._LIBS["hifigan_resblock_bf16"] = libs[str(v)]
        row = [cs.time_ms(lambda: [hk.hifigan_resblock(*a) for a in blocks], 3)
               for _, _, blocks in stages]
        print(f"  {what:12s} " + "  ".join(f"C={C} {ms:.4f}" for (C, _, _), ms in
                                          zip(stages, row))
              + f"  total {sum(row):.4f}", flush=True)

    prof = libs["profile"]
    _build._LIBS["hifigan_resblock_bf16"] = prof
    buf = (ctypes.c_ulonglong * 16)()
    print("per block and launch, Mclk of the first consumer thread (the "
          "loaders' first thread, the producer)", flush=True)
    for C, T, blocks in stages:
        for a in (blocks[0], blocks[2]):
            hk.hifigan_resblock(*a)
            torch.cuda.synchronize()
            prof.hifigan_resblock_bf16_profile(buf, 1)
            hk.hifigan_resblock(*a)
            torch.cuda.synchronize()
            prof.hifigan_resblock_bf16_profile(buf, 1)
            n = max(1, buf[14])
            print(f"  C={C} T={T} k={a[1].shape[1]}: {n} block launches, "
                  f"{buf[13] / n:.2f} tiles a block, {buf[11] / max(1, buf[12]):.3f} GHz; "
                  + ", ".join(f"{name} {buf[i] / n / 1e6:.4f}"
                              for i, name in enumerate(PROFILE) if name), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

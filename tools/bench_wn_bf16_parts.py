#!/usr/bin/env python3
"""Where the time of the two bf16 WN kernels goes, by part.

    python3 tools/bench_wn_bf16_parts.py

Builds csrc/waveglow_wn_bf16.cu and csrc/waveflow_row_bf16.cu (nvcc,
sm_90a) into build/bench_wn_bf16_parts/ as shipped and with parts cut from
their text (PARTS, by bit: 1 the wgmma products, 2 the gate and the
epilogue's loads and stores, 4 the TMA loads, whose barriers then complete
with no bytes; 7 leaves the skeleton of barriers, fragment reads and
launches), and times the 48 calls of a 5 s infer of each (phase 21b's
inputs: WaveGlow's 48 flows at T' = 10000, WaveFlow's 6 x 8 rows at W =
30000) with each build in CUDA-graph replay. A part's share is the kernel's
time less the time without it (parts overlap, so the shares need not sum to
the whole). Prints the card's name and power limit.
"""
from __future__ import annotations

import concurrent.futures as cf
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PARTS = {0: "kernel", 1: "no products", 2: "no gate/epilogue", 4: "no loads",
         7: "skeleton"}
SOURCES = {"waveglow_wn_bf16": "waveglow_wn_forward_bf16",
           "waveflow_row_bf16": "waveflow_row_step_bf16"}
# (pattern, replacement) of each bit, by source; every pattern must match
CUTS = {
    1: {"*": [(r"wgmma::Mma<([^>]+)>::run\(", r"if (0) wgmma::Mma<\1>::run(")]},
    2: {"waveglow_wn_bf16": [(r"c < C \? gtu\(", "false ? gtu("),
                             (r"if \(c >= C \|\| t >= T\) continue;", "continue;")],
        "waveflow_row_bf16": [(r"z\[u\] = c \+ u < C \? gtu\(", "z[u] = false ? gtu("),
                              (r"if \(c >= C \|\| t >= W\) continue;", "continue;")]},
    4: {"*": [(r"tma::load_(\d)d\(", r"if (0) tma::load_\1d("),
              (r"tma::mbar_expect_tx\(([^,]+), [^;]+\);", r"tma::mbar_arrive(\1);")]},
}


def variant(name: str, text: str, v: int) -> str:
    """The source of PARTS value v: each cut of its bits applied."""
    for bit, by_source in CUTS.items():
        if not v & bit:
            continue
        for pattern, repl in by_source.get("*", []) + by_source.get(name, []):
            text, n = re.subn(pattern, repl, text)
            if n == 0:
                raise ValueError(f"{name}: {pattern!r} matches nothing")
    return text


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("bench_wn_bf16_parts: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from cookietts_tpu_torch.ops import _build
    from cookietts_tpu_torch.ops import hopper_kernels as hk
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    _build.load_all()
    out = ROOT / "build" / "bench_wn_bf16_parts"
    out.mkdir(parents=True, exist_ok=True)

    def build(name, v):
        cu, lib = out / f"{name}_{v}.cu", out / f"lib{name}_{v}.so"
        cu.write_text(variant(name, (_build.CSRC / f"{name}.cu").read_text(), v))
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                        "-o", str(lib), str(cu)], check=True, capture_output=True)
        return (name, v), ctypes.CDLL(str(lib))

    jobs = [(name, v) for name in SOURCES for v in PARTS]
    with cf.ThreadPoolExecutor(len(jobs)) as ex:
        libs = dict(ex.map(lambda j: build(*j), jobs))

    g = torch.Generator(device="cuda").manual_seed(19)
    r = lambda *s: torch.randn(*s, device="cuda", generator=g)  # noqa: E731
    L, kw, kh, T, W = 8, 3, 3, 10000, 30000
    glow = []
    for k in range(cs.WAVEGLOW["n_flows"]):
        Cin = 12 - k // 4
        w16, _ = cs.bf16_weights(cs.wn_weights(g, Cin, 256, 2 * Cin, L, 1, kw), "glow_bf16")
        glow.append((r(1, Cin, T), w16))
    cond_g = cs.bf16(r(1, L, 512, T))
    flows = [cs.bf16_weights(cs.wn_weights(g, 1, 64, 2, L, kh, kw), "flow_bf16")[0]
             for _ in range(cs.WAVEFLOW["n_flows"])]
    cond_f, ring, x_prev = cs.bf16(r(1, L, 128, W)), cs.bf16(r(L, kh, 1, 64, W)), r(1, W)
    calls = {
        "waveglow_wn_bf16": lambda: [hk.waveglow_wn_forward(x, cond_g, *w) for x, w in glow],
        "waveflow_row_bf16": lambda: [hk.waveflow_row_step(x_prev, ring, h, cond_f, *w)
                                      for w in flows for h in range(cs.WAVEFLOW["n_group"])]}
    for name, entry in SOURCES.items():
        print(f"{entry}: the 48 calls of a 5 s infer, ms in graph replay ({smi})",
              flush=True)
        times = {}
        for v, what in PARTS.items():
            _build._LIBS[name] = libs[(name, v)]
            times[v] = min(cs.time_ms(calls[name], 3) for _ in range(2))
            print(f"  {what:17s} {times[v]:.4f}", flush=True)
        whole = times[0]
        print(f"  split: products {whole - times[1]:.4f}, gate/epilogue "
              f"{whole - times[2]:.4f}, loads {whole - times[4]:.4f}, skeleton "
              f"{times[7]:.4f} of {whole:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

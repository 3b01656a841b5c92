#!/usr/bin/env python3
"""Where the time of the bf16 LSTM gate step goes: fill and stream, the
products, the split-K tail.

    python3 tools/bench_lstm_parts.py [--parent DIR]

Builds csrc/lstm_gates_bf16.cu (nvcc, sm_90a) as shipped and with parts
cut from its text, "stream" (each block only streams its run of W and xh
through the TMA ring) and "compute" (it also runs the products, but
neither reduces over the cluster nor writes), into build/bench_lstm_parts/,
and times a decode step
(the three decoder cells of LSTM_SHAPES at B=4, and at B=32) with each in
CUDA-graph replay: stream is launch, fill and streaming; compute - stream
the products left in the way; full - compute the cluster reduction and the
epilogue.

With --parent DIR (a checkout whose csrc/lstm_gates.cu holds the bf16 form
that copied the f32 form's plan, as before this kernel), the same steps
with that form as it was and with its split-K tail cut (each block's
partial sums, the fence, the ticket and the last block's sum), which says
what the tail of that design cost. Prints the card's name and power limit
beside the times.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# csrc/lstm_gates_bf16.cu's products and its cluster reduction and epilogue
PRODUCTS = ("      const unsigned char* wb = smem + s * kStage + gate * kGateBox;\n",
            "          for (int j = 0; j < NT; ++j) mma_bf16(acc[m][j], a[m], bf[j][0],"
            " bf[j][1]);\n      }\n")
TAIL = ("  // every stage has landed and been read: the ring becomes the partials\n",
        "  cluster.sync();      // no block leaves while another reads its partials\n")
SINK = """  float sink = 0.f;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sink += acc[m][j][e];
  if (sink == 1234.5f) c_out[0] = sink;     // keeps the products
"""
OLD_TAIL_START = "  // partial[slice][b][g * H + j]\n"
OLD_TAIL_END = "  if (threadIdx.x == 0) *counter = 0;\n}\n"
OLD_SINK = ("  if (acc[0].x == 1234.5f) c_out[0] = acc[0].y;   // keeps the products\n"
            "}\n")


def cut(text: str, span, new: str = "") -> str:
    """text with the run from span's first line through its last (each
    found once) replaced by new."""
    start, end = span
    if text.count(start) != 1 or text.count(end) != 1:
        raise ValueError(f"{span} does not mark one run of the source")
    a, b = text.index(start), text.index(end) + len(end)
    if b <= a:
        raise ValueError(f"{span} ends before it starts")
    return text[:a] + new + text[b:]


def build(out: Path, name: str, src: Path, text: str):
    """Compile `text` (the source at src, maybe altered) into out/name.so."""
    from cookietts_tpu_torch.ops import _build
    d = out / name
    d.mkdir(parents=True, exist_ok=True)
    cu = d / src.name
    cu.write_text(text)
    lib = d / f"lib{name}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(lib), str(cu)], check=True,
                   capture_output=True)
    return name, ctypes.CDLL(str(lib))


def old_plan(B, F, H):
    """(col_tiles, slices, f_per_slice, groups) as the copied f32 plan gave
    them for 2-byte values (64 rows a stage pair, 264 target blocks)."""
    col_tiles, groups = -(-H // 64), -(-B // 32)
    slices = max(1, min(264 // (col_tiles * groups), F // 64))
    f_per_slice = -(-F // slices)
    return col_tiles, -(-F // f_per_slice), f_per_slice, groups


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_lstm_parts: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from cookietts_tpu_torch.ops import _build
    from cookietts_tpu_torch.ops import hopper_kernels as hk
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    _build.load_all()
    out = ROOT / "build" / "bench_lstm_parts"
    src = _build.CSRC / "lstm_gates_bf16.cu"
    text = src.read_text()
    jobs = [("stream", src, cut(cut(text, TAIL), PRODUCTS)),
            ("compute", src, cut(text, TAIL, SINK))]
    if args.parent:
        old = (args.parent / "cookietts_tpu_torch" / "csrc" / "lstm_gates.cu")
        text = old.read_text()
        jobs += [("old", old, text),
                 ("old-no-tail", old, cut(text, (OLD_TAIL_START, OLD_TAIL_END), OLD_SINK))]
    with cf.ThreadPoolExecutor(len(jobs)) as ex:
        libs = dict(ex.map(lambda j: build(out, *j), jobs))
    libs["full"] = _build.library("lstm_gates_bf16")

    def new_step(cases):
        return lambda: [hk.lstm_gates(*a) for a in cases]

    def old_step(lib, cases):
        calls = []
        for xh, W, b, c in cases:
            B, F = xh.shape
            H = c.shape[1]
            tiles, slices, fps, groups = old_plan(B, F, H)
            part = torch.empty(slices * B * 4 * H, device="cuda")
            tickets = torch.zeros(groups * tiles, dtype=torch.int32, device="cuda")
            c_new, h_new = torch.empty_like(c), torch.empty_like(c)
            calls.append((xh, W, b, c, B, F, H, tiles, slices, fps, part, tickets,
                          c_new, h_new))

        def run():
            for xh, W, b, c, B, F, H, tiles, slices, fps, part, tickets, cn, hn in calls:
                hk._raise_on(lib.lstm_gates_bf16(
                    hk._ptr(xh), hk._ptr(W), hk._ptr(b), hk._ptr(c), B, F, H, tiles,
                    slices, fps, hk._ptr(part), hk._ptr(tickets), hk._ptr(cn),
                    hk._ptr(hn), hk._stream()), "old lstm_gates_bf16")
        return run

    g = torch.Generator(device="cuda").manual_seed(20)
    for B in (4, 32):
        cases = []
        for _, F, H in cs.LSTM_SHAPES:
            xh, W, b, c = cs.lstm_inputs(B, F, H, g)
            cases.append((cs.bf16(xh), cs.bf16(W), cs.bf16(b), c))
        bound = cs.bound_of([cs.lstm_bound_bf16(B, F, H) for _, F, H in cs.LSTM_SHAPES])
        times = {}
        for name in ("stream", "compute", "full"):
            _build._LIBS["lstm_gates_bf16"] = libs[name]
            times[name] = cs.graph_ms(new_step(cases))
        _build._LIBS["lstm_gates_bf16"] = libs["full"]
        for name in ("old", "old-no-tail"):
            if name in libs:
                times[name] = cs.graph_ms(old_step(libs[name], cases))
        line = ", ".join(f"{k} {v:.4f}" for k, v in times.items())
        print(f"decode step B={B} (3 cells), ms a step in a graph of 20: {line}; "
              f"bound {bound[0]:.4f} ({bound[1]}) ({smi})", flush=True)
        print(f"  fill and stream {times['stream']:.4f}, products "
              f"{times['compute'] - times['stream']:.4f}, reduction and epilogue "
              f"{times['full'] - times['compute']:.4f}"
              + (f"; the old form's split-K tail {times['old'] - times['old-no-tail']:.4f}"
                 if "old" in times else ""), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the WN layer kernel's tile shapes on one NVIDIA card.

    python3 tools/bench_wn_tiles.py [B,T ...]

For each shape B,T (default: 1,250 1,500 1,1500 1,10000 4,250 4,1500
4,10000) it times one whole WN evaluation of both kernels of the PyTorch
port at full width:
``waveglow_wn_forward`` (256 channels, 8 layers, 3 taps, on T samples) and
``waveflow_row_step`` (64 channels, 8 layers, 3 rows x 3 taps, on a width of
3 T), beside their plain PyTorch versions. Each is run with the plan
``wn_layer_plan`` picks ("plan") and with every tile shape of
``WN_TILES`` that the width takes forced onto both launches of every layer
("tile<i>"), and each run is checked against the plain version first. Then
torch.profiler splits one planned call of each kernel into its kernels
(start, the conv and res/skip launches, end), so the share of the start and
end products is read off. Prints the card's name and power limit, one line
per measurement and a JSON object last. float32, TF32 off.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def kernel_split(fn, reps=5):
    """Device ms per call of ``fn`` by CUDA kernel name (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("bench_wn_tiles: needs a CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import time_ms, wn_weights
    from cookietts_tpu_torch.ops import hopper_kernels as hk
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    shapes = [tuple(int(v) for v in a.split(",")) for a in sys.argv[1:]] or [
        (1, 250), (1, 500), (1, 1500), (1, 10000), (4, 250), (4, 1500), (4, 10000)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    r = lambda *s, scale=1.0: torch.randn(*s, device="cuda", generator=gen) * scale

    rows, splits = [], {}
    for B, T in shapes:
        w = wn_weights(gen, 12, 256, 24, 8, 1, 3)
        x, cond = r(B, 12, T), r(B, 8, 512, T)
        W = 3 * T
        w2 = wn_weights(gen, 1, 64, 2, 8, 3, 3)
        cond2, x_prev = r(B, 8, 128, W), r(B, W)
        # row 0 again and again: it reads slots 1 and 2, which it never
        # writes, so every call computes the same row
        ring = torch.zeros(8, 3, B, 64, W, device="cuda").normal_(generator=gen)
        queues = hk.ring_queues(ring, 0).contiguous()
        cases = (
            ("waveglow_wn_forward", f"B={B} T'={T}", 256, T, 1,
             lambda plan: hk.waveglow_wn_forward(x, cond, *w, plan=plan),
             lambda: hk.waveglow_wn_forward_plain(x, cond, *w)),
            ("waveflow_row_step", f"B={B} W={W}", 64, W, 3,
             lambda plan: hk.waveflow_row_step(x_prev, ring, 0, cond2, *w2,
                                               plan=plan)[1],
             lambda: hk.waveflow_row_step_plain(x_prev, queues, cond2, *w2)[1]))
        for name, shape, C, n, kh, kernel, plain in cases:
            want = plain()
            planned = hk.wn_layer_plan(B, C, n, kh, 3)
            plans = {"plan": planned}
            for i, (wm, _, _) in enumerate(hk.WN_TILES):
                if C % (16 * wm) == 0:
                    plans[f"tile{i}"] = hk.WnPlan(hk.wn_launch(i, B, C, n, 3),
                                                  hk.wn_launch(i, B, C, n, 1))
            row = {"kernel": name, "shape": shape,
                   "plan": f"conv tile{planned.conv.tile} "
                           f"({planned.conv.blocks} blocks), rs "
                           f"tile{planned.rs.tile} ({planned.rs.blocks} blocks)",
                   "plain_ms": time_ms(plain, 5)}
            for key, plan in plans.items():
                err = float((kernel(plan) - want).abs().max())
                if not err < 2e-5:
                    raise SystemExit(f"{name} {shape} {key}: max abs error {err}")
                row[f"{key}_ms"] = time_ms(lambda: kernel(plan), 5)
            print(" ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                           for k, v in row.items()), flush=True)
            rows.append(row)
            split = kernel_split(lambda: kernel(planned))
            splits[f"{name} {shape}"] = split
            print(f"  {name} {shape} by kernel (device ms per call): "
                  + "; ".join(f"{k} {v:.4f}" for k, v in split.items()), flush=True)
    print(smi)
    print(json.dumps({"card": smi, "rows": rows, "kernel_split": splits}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

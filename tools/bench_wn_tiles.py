#!/usr/bin/env python3
"""Time the WN layer kernel's tile widths on one NVIDIA card.

    python3 tools/bench_wn_tiles.py [B,T ...]

For each shape B,T (default: 1,10000 4,10000 2,10000 1,1500) and each of the
layer kernel's samples-per-thread settings (0 = picked per launch, 8, 5, 4)
it times one whole WN evaluation of both kernels of the PyTorch port at full
width: ``waveglow_wn_forward`` (256 channels, 8 layers, 3 taps) and
``waveflow_row_step`` (64 channels, 8 layers, 3 rows x 3 taps, on a width of
3 T), beside their plain PyTorch versions, and checks each against it. The
per-wave costs in csrc/wn_layer.cuh:wn_pick_kt come from these times:
(ms of a forced setting) / (layers x waves), waves = ceil(tiles / SMs).
Prints one line per measurement and a JSON object last. float32, TF32 off.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("bench_wn_tiles: needs a CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import wn_weights
    from cookietts_tpu_torch.ops import _build
    from cookietts_tpu_torch.ops import hopper_kernels as hk
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shapes = [tuple(int(v) for v in a.split(",")) for a in sys.argv[1:]] or [
        (1, 10000), (4, 10000), (2, 10000), (1, 1500)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    r = lambda *s, scale=1.0: torch.randn(*s, device="cuda", generator=gen) * scale

    def ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    libs = _build.load_all()
    rows = []
    for B, T in shapes:
        w = wn_weights(gen, 12, 256, 24, 8, 1, 3)
        x, cond = r(B, 12, T), r(B, 8, 512, T)
        W = 3 * T
        w2 = wn_weights(gen, 1, 64, 2, 8, 3, 3)
        cond2, x_prev = r(B, 8, 128, W), r(B, W)
        ring = torch.zeros(8, 3, B, 64, W, device="cuda").normal_(generator=gen)
        queues = hk.ring_queues(ring, 0).contiguous()
        cases = (
            ("waveglow_wn_forward", f"B={B} T'={T}", "waveglow_wn",
             lambda: hk.waveglow_wn_forward(x, cond, *w),
             lambda: hk.waveglow_wn_forward_plain(x, cond, *w)),
            ("waveflow_row_step", f"B={B} W={W}", "waveflow_row",
             lambda: hk.waveflow_row_step(x_prev, ring.clone(), 0, cond2, *w2)[1],
             lambda: hk.waveflow_row_step_plain(x_prev, queues, cond2, *w2)[1]))
        for name, shape, lib, kernel, plain in cases:
            want = plain()
            row = {"kernel": name, "shape": shape, "plain_ms": ms(plain)}
            for kt in (0, 8, 5, 4):
                getattr(libs[lib], f"{lib}_force_kt")(kt)
                err = float((kernel() - want).abs().max())
                if not err < 2e-5:
                    raise SystemExit(f"{name} {shape} kt={kt}: max abs error {err}")
                row[f"kt{kt}_ms"] = ms(kernel)
            getattr(libs[lib], f"{lib}_force_kt")(0)
            print(" ".join(f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
                           for k, v in row.items()), flush=True)
            rows.append(row)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

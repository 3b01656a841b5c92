#!/usr/bin/env python3
"""Time the bf16 serving kernels of a checkout: phase 18a of its own
chip_smoke.py (each bf16 form against its plain version, timed by CUDA-graph
replay beside its f32 form), in a process of its own.

    python3 tools/bench_bf16_tree.py DIR

DIR is the root of a checkout (this one, or another unpacked with `git
archive <commit> | tar -x -C DIR`); it builds its own kernels into
DIR/build/. To compare two trees on one card, run it for each in turns in
one call (parent, change, change, parent). Prints one line per bf16 form
with the card's name and power limit.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    root = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("bench_bf16_tree: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from cookietts_tpu_torch.ops import _build
    from cookietts_tpu_torch.ops import hopper_kernels as hk
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    _build.load_all()
    out = cs.phase18a(hk, cs.Check(), smi)
    for name, o in out.items():
        print(f"{root.name} {name} ({o['unit']}): kernel {o['ms']:.4f} ms, f32 form "
              f"{o['f32_ms']:.4f}, plain {o['plain_ms']:.4f}, bound "
              f"{o['bound'][0]:.4f} ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

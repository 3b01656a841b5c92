#!/usr/bin/env python3
"""Time the bf16 kernels of a checkout with its own chip_smoke.py, in a
process of its own.

    python3 tools/bench_bf16_tree.py DIR [PHASE]

PHASE "18a" (the default): the serving path's three bf16 forms, each
against its plain version and timed by CUDA-graph replay beside its f32
form (phase 18a). PHASE "19a": the flow vocoders' two bf16 WN forms over
the 48 calls of a 5 s infer, beside their f32 forms (phase 21b in a
checkout that has it, phase 19a before). DIR is the root of a checkout
(this one, or another unpacked with `git archive <commit> | tar -x -C
DIR`); it builds its own kernels into DIR/build/. To compare two trees on
one card, run it for each in turns in one call (parent, change, change,
parent). Prints one line per bf16 form with the card's name and power
limit.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path


def timing(cs, hk, phase, smi):
    if phase == "18a":
        return cs.phase18a(hk, cs.Check(), smi)
    if hasattr(cs, "phase21b"):
        return cs.phase21b(hk, smi)
    return cs.phase19a(hk, cs.Check(), smi)


def main() -> int:
    if len(sys.argv) not in (2, 3) or sys.argv[2:] not in ([], ["18a"], ["19a"]):
        print(__doc__, file=sys.stderr)
        return 2
    root = Path(sys.argv[1]).resolve()
    phase = (sys.argv[2:] or ["18a"])[0]
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
    for name, o in timing(cs, hk, phase, smi).items():
        print(f"{root.name} {name} ({o['unit']}): kernel {o['ms']:.4f} ms, f32 form "
              f"{o['f32_ms']:.4f}, plain {o['plain_ms']:.4f}, bound "
              f"{o['bound'][0]:.4f} ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

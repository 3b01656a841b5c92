#!/usr/bin/env python3
"""Time attention_step's launch plans on one NVIDIA card.

    python3 tools/bench_attention.py [--tree DIR] [--out FILE] [--parts]

At each shape of ``chip_smoke.py``'s phase 3 (B = 1, 4, 32 by T = 64, 128,
384 at A = 192, D = 512 with a window-16 mask; the full length mask at
B = 32, T = 128 and 384; D = 1313 at B = 4, T = 64) it times the
``attention_step`` of the PyTorch port in DIR (default: the checkout holding
this tool) beside its plain version, and the empty-kernel floor: an empty
kernel launched on the same grid, and one block. Where DIR's port has
``attention_step_plan``, every plan is forced too: clusters of 1, 2, 4, 8
and 16 blocks, each with one stage for all of a block's rows (where it
fits) and with stages of 8, 16, 32 and 48 rows. Each is timed as
``chip_smoke.py`` times it (a CUDA graph of one call a replay) and as a
call in a graph of 20 (``graph_ms``), where the launches follow each other
on the device. Every run is checked against the plain version first; a
shape the kernel refuses is recorded with its error. Run it on two trees in
one call to compare them on one card. With --parts, copies of the kernel
that stop after each of its steps are built into build/bench_attention/
and timed beside it at B=4, T=64 and B=32, T=128, so the time of each step
is read off. The host's cost is timed too: each call issued from Python
(``eager_ms``), and an empty launch of one block and of 4 clusters of 16.
Prints the card's name and power limit and one line per measurement; the JSON of every number goes to FILE, or is printed last.
float32.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
SRC = HERE / "cookietts_tpu_torch" / "csrc" / "attention_step.cu"
# --parts: copies of the kernel that stop after a step (text inserted before
# the anchor), built beside the shipped one; what each adds over the one
# before is the time of its step.
STOP = "  return;\n"
PARTS = (("launch and mask", "  // 2. stage the admitted rows'", STOP),
         ("+ copies, energies, partials",
          "  if (tid == 0) {\n    stat_s[0] = m_run;", STOP),
         ("+ first cluster barrier", "  // 4. warp 0 reads", STOP),
         ("+ statistics, w", "  // 5. this block's D/S slice",
          "  cluster.sync();\n  return;\n"))
SHAPES = [(B, T, 512, 16) for B in (1, 4, 32) for T in (64, 128, 384)] + [
    (32, 128, 512, 0), (32, 384, 512, 0), (4, 64, 1313, 16)]


def parts(hk, time_fn, shapes=((4, 64), (32, 128))):
    """Device ms a call (in a graph of 20) of the kernel cut after each step
    and of the whole kernel, at the default plan: where its time goes."""
    import ctypes
    import torch
    from chip_smoke import attention_inputs
    from cookietts_tpu_torch.ops import _build
    text = SRC.read_text()
    out = HERE / "build" / "bench_attention"
    builds = {}
    for name, anchor, stop in PARTS:
        if anchor not in text:
            raise SystemExit(f"bench_attention: {SRC.name} no longer has {anchor!r}")
        d = out / name.replace(" ", "_").replace(",", "").replace("+", "p")
        d.mkdir(parents=True, exist_ok=True)
        (d / SRC.name).write_text(text.replace(anchor, stop + anchor, 1))
        builds[name] = d
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
         str(d / SRC.name)], stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        for name, d in builds.items()}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"bench_attention: {name} did not build:\n"
                             + proc.stderr.read().decode())
    libs = {name: ctypes.CDLL(str(d / "lib.so")) for name, d in builds.items()}
    libs["whole kernel"] = _build.library("attention_step")
    gen = torch.Generator(device="cuda").manual_seed(5)
    result = {}
    for B, T in shapes:
        a = attention_inputs(B, T, gen)
        plan = hk.attention_step_plan(B, T, 192, 512)
        ctx = torch.empty(B, 512, device="cuda")
        w = torch.empty(B, T, device="cuda")
        row = {}
        for name, lib in libs.items():
            call = lambda: hk._raise_on(lib.attention_step(
                *(hk._ptr(t) for t in a), hk._ptr(None), B, T, 192, 512,
                *plan.ints(), hk._ptr(ctx), hk._ptr(w), hk._stream()), name)
            row[name] = time_fn(call)
        print(f"  parts at B={B} T={T} (plan {plan.ints()}), ms a call in a "
              "graph of 20: " + "; ".join(f"{k} {v:.4f}" for k, v in row.items()),
              flush=True)
        result[f"B={B} T={T}"] = row
    return result


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(HERE))
    ap.add_argument("--out", default=None)
    ap.add_argument("--parts", action="store_true",
                    help="also time the kernel cut after each step")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_attention: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    from chip_smoke import attention_inputs, eager_ms, graph_ms, time_ms
    sys.path.insert(0, str(Path(args.tree).resolve()))
    for name in [m for m in sys.modules if m.startswith("cookietts_tpu_torch")]:
        del sys.modules[name]
    from cookietts_tpu_torch.ops import _build
    from cookietts_tpu_torch.ops import hopper_kernels as hk
    print(f"bench_attention: port from {Path(hk.__file__).parents[2]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    lib = _build.library("attention_step")
    empty = getattr(lib, "attention_empty_launch", None)
    plan_of = getattr(hk, "attention_step_plan", None)

    def floor_ms(B, S, timer=None):
        if empty is None:
            return None
        call = lambda: hk._raise_on(empty(B, S, hk._stream()), "empty kernel")
        return (timer or (lambda f: time_ms(f, 200)))(call)

    gen = torch.Generator(device="cuda").manual_seed(3)
    eager = lambda f: eager_ms(f, 500)
    results = {"card": smi, "tree": str(Path(args.tree).resolve()),
               "floor_one_block_ms": floor_ms(1, 0),
               "floor_one_block_ms_in_graph_of_20": floor_ms(1, 0, graph_ms),
               # the host's cost of a launch: one plain block, then a
               # cluster launch as the main path's (B=4, clusters of 16)
               "floor_one_block_eager_ms": floor_ms(1, 0, eager),
               "floor_cluster_eager_ms": floor_ms(4, 16, eager),
               "shapes": []}
    print(f"  empty kernel, one block: {results['floor_one_block_ms']} ms a "
          f"graph of one call, {results['floor_one_block_ms_in_graph_of_20']} "
          f"ms a call in a graph of 20; issued from Python, one block "
          f"{results['floor_one_block_eager_ms']} ms, 4 clusters of 16 "
          f"{results['floor_cluster_eager_ms']} ms")
    for B, T, D, window in SHAPES:
        a = attention_inputs(B, T, gen, D=D, window=window)
        tag = f"B={B} T={T} D={D} " + (f"window {window}" if window else "full mask")
        row = {"B": B, "T": T, "D": D, "window": window,
               "plain_ms": time_ms(lambda: hk.attention_step_plain(*a), 200)}
        ctx_p, w_p = hk.attention_step_plain(*a)
        try:
            ctx, w = hk.attention_step(*a)
        except (RuntimeError, ValueError) as e:
            row["error"] = str(e)
            print(f"  {tag}: raises: {e}; plain {row['plain_ms']:.4f} ms")
            results["shapes"].append(row)
            continue
        ok = (torch.allclose(w, w_p, atol=2e-5, rtol=1e-4)
              and torch.allclose(ctx, ctx_p, atol=1e-4, rtol=1e-4))
        if not ok:
            raise SystemExit(f"bench_attention: {tag} disagrees with plain")
        row["ms"] = time_ms(lambda: hk.attention_step(*a), 200)
        row["ms_in_graph_of_20"] = graph_ms(lambda: hk.attention_step(*a))
        row["eager_ms"] = eager(lambda: hk.attention_step(*a))
        row["plain_ms_in_graph_of_20"] = graph_ms(lambda: hk.attention_step_plain(*a))
        plans = []
        if plan_of is not None:
            plan = plan_of(B, T, 192, D)
            row["plan"] = list(plan.ints())
            row["floor_ms"] = floor_ms(B, plan.cluster)
            row["floor_ms_in_graph_of_20"] = floor_ms(B, plan.cluster, graph_ms)
            for S in (1, 2, 4, 8, 16):
                R = -(-T // S)
                for sr in sorted({R} | {n for n in (8, 16, 32, 48) if n < R}):
                    try:
                        p = plan_of(B, T, 192, D, cluster=S, stage_rows=sr)
                    except ValueError:
                        continue
                    got = hk.attention_step(*a, plan=p)
                    if not (torch.allclose(got[1], w_p, atol=2e-5, rtol=1e-4) and
                            torch.allclose(got[0], ctx_p, atol=1e-4, rtol=1e-4)):
                        raise SystemExit(f"bench_attention: {tag} plan {p} "
                                         "disagrees with plain")
                    plans.append({"plan": list(p.ints()), "smem": p.smem,
                                  "ms": time_ms(lambda: hk.attention_step(
                                      *a, plan=p), 200),
                                  "ms_in_graph_of_20": graph_ms(
                                      lambda: hk.attention_step(*a, plan=p))})
        row["forced"] = plans
        best = min(plans, key=lambda x: x["ms_in_graph_of_20"]) if plans else None
        print(f"  {tag}: kernel {row['ms']:.4f} ms (plan {row.get('plan')}), "
              f"floor {row.get('floor_ms')}, plain {row['plain_ms']:.4f} ms; "
              f"a call in a graph of 20: kernel {row['ms_in_graph_of_20']:.4f} ms, "
              f"floor {row.get('floor_ms_in_graph_of_20')}, plain "
              f"{row['plain_ms_in_graph_of_20']:.4f} ms; eager {row['eager_ms']:.4f} ms"
              + (f"; fastest forced {best['plan']} {best['ms_in_graph_of_20']:.4f} "
                 "ms in a graph of 20" if best else ""),
              flush=True)
        for x in plans:
            print(f"    S,R,stage_rows={x['plan']}: {x['ms']:.4f} ms, "
                  f"{x['ms_in_graph_of_20']:.4f} ms in a graph of 20")
        results["shapes"].append(row)
    if args.parts:
        results["parts"] = parts(hk, graph_ms)
    text = json.dumps(results)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

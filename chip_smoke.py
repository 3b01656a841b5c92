#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, in order; any failure exits
non-zero:

1. environment: versions, the card's name and power limit. Every phase
   runs in float32 with TF32 off (both torch.backends.cuda.matmul and
   torch.backends.cudnn), so the kernels and their plain versions compute
   the same function.
2. build the CUDA kernels from cookietts_tpu_torch/csrc (nvcc, sm_90a).
3. each kernel against its plain PyTorch version at the full-width serving
   shapes, batch 1 and 32.
4. the main path: T2S -> Tacotron2 (Tacotron2Config() defaults) -> HiFi-GAN
   (the bench-serving generator) at full width with random weights from a
   seed, answering 3 requests (one of them multi-segment). Launch counters
   are zeroed just before and read just after; every kernel must have run.
   Then each kernel is timed at the shapes this run gave it, beside its
   plain version, a library call where one computes the same function, and
   its bound on the card.
5. the whole slice with kernels against the same slice with the plain
   versions swapped in, on the card: a 32-step decode and one vocoder batch.

The second-to-last line is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS = 67e12              # H100 SXM f32, outside the tensor cores
SR, HOP = 44100, 512
KERNEL_SOURCES = {
    "attention_step": ("cookietts_tpu_torch/csrc/attention_step.cu",
                       "cookietts_tpu/ops/pallas_kernels.py:74"),
    "lstm_gates": ("cookietts_tpu_torch/csrc/lstm_gates.cu",
                   "cookietts_tpu/ops/pallas_kernels.py:236"),
    "hifigan_resblock": ("cookietts_tpu_torch/csrc/hifigan_resblock.cu",
                         "cookietts_tpu/ops/pallas_kernels.py:724"),
}
# the three decoder cells at full width: (name, F = in + H, H)
LSTM_SHAPES = (("attention_rnn", 2816, 1280), ("decoder_rnn", 2560, 768),
               ("second_decoder_rnn", 1536, 768))
TOL = {"attention_step": (2e-5, 1e-4), "lstm_gates": (2e-5, 1e-4),
       "hifigan_resblock": (1e-4, 1e-4)}


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn``: the calls are captured once in a CUDA
    graph and the graph is replayed ``reps`` times between CUDA events, so
    the host's per-call Python and launch cost is left out (a launch-bound
    loop would otherwise time the host). ``eager_ms`` times the host path."""
    import torch
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def eager_ms(fn, reps: int) -> float:
    """Wall ms per call of ``fn`` issued from Python (host cost included)."""
    import torch
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


def decode_busy_share(taco, B=4, T=64, steps=64):
    """Device-busy share of the decode loop: kernel time summed by
    torch.profiler over one fixed-length decode, over the wall time of the
    same decode run without the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device="cuda").manual_seed(7)
    text = torch.randint(1, taco.cfg.n_symbols, (B, T), device="cuda", generator=g)
    args = (text, torch.full((B,), T, device="cuda"),
            torch.zeros(B, dtype=torch.long, device="cuda"))
    run = lambda: taco.inference(*args, max_decoder_steps=steps)
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA) / 1e3
    return wall_ms / steps, device_ms / steps


class Check:
    """Max abs error per kernel across every comparison, failing fast."""

    def __init__(self):
        self.max_abs = {}

    def __call__(self, name, got, want, atol, rtol, what=""):
        import torch
        err = (got - want).abs()
        max_abs = float(err.max())
        max_rel = float((err / want.abs().clamp_min(atol)).max())
        ok = bool(torch.allclose(got, want, atol=atol, rtol=rtol))
        self.max_abs[name] = max(self.max_abs.get(name, 0.0), max_abs)
        log(f"  {name:17s} {what:34s} max_abs {max_abs:.3e} max_rel "
            f"{max_rel:.3e} (atol {atol:g}, rtol {rtol:g}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok or not math.isfinite(max_abs):
            raise SystemExit(f"chip_smoke: {name} {what} disagrees with its "
                             "plain version")


@contextlib.contextmanager
def plain_kernels(hk):
    """Swap the plain versions in for the kernels' entries (phase 5)."""
    names = ("attention_step", "lstm_gates", "hifigan_resblock")
    saved = {n: getattr(hk, n) for n in names}
    for n in names:
        setattr(hk, n, getattr(hk, n + "_plain"))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(hk, n, fn)


# -- per-kernel inputs, bounds and comparisons --------------------------------

def attention_inputs(B, T, gen, A=192, D=512, window=16):
    import torch
    dev = "cuda"
    r = lambda *s, scale=1.0: torch.randn(*s, device=dev, generator=gen) * scale
    lengths = torch.randint(T // 2, T + 1, (B,), device=dev, generator=gen)
    idx = torch.arange(T, device=dev)[None, :]
    start = torch.randint(0, T // 2, (B, 1), device=dev, generator=gen)
    mask = (idx < lengths[:, None]) & (idx >= start) & (idx <= start + 2 * window)
    return (r(B, A, scale=0.5), r(B, T, A, scale=0.5), r(B, T, A, scale=0.5),
            r(A, scale=A ** -0.5), r(B, T, D), mask.contiguous())


def attention_bound(B, T, A=192, D=512):
    nbytes = 4 * (B * A + 2 * B * T * A + A + B * T * D + B * D + B * T) + B * T
    flops = B * T * (4 * A + 2 * D)
    return nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS


def lstm_inputs(B, F, H, gen):
    import torch
    r = lambda *s, scale=1.0: torch.randn(*s, device="cuda", generator=gen) * scale
    return (r(B, F), r(F, 4 * H, scale=F ** -0.5), r(4 * H, scale=0.1), r(B, H))


def library_lstm_cell(W, b, H):
    """torch.nn.LSTMCell computing lstm_gates(xh, W, b, c) for xh = [x; h]:
    the same weights, with the forget +1 folded into its bias."""
    import torch
    n_in = W.shape[0] - H
    cell = torch.nn.LSTMCell(n_in, H).cuda()
    with torch.no_grad():
        cell.weight_ih.copy_(W[:n_in].t())
        cell.weight_hh.copy_(W[n_in:].t())
        cell.bias_ih.copy_(b)
        cell.bias_ih[H:2 * H] += 1.0
        cell.bias_hh.zero_()
    return cell


def lstm_bound(B, F, H):
    nbytes = 4 * (B * F + F * 4 * H + 4 * H + 3 * B * H)
    return nbytes / HBM_BYTES_PER_S, 2 * B * F * 4 * H / F32_FLOPS


def resblock_bound(B, C, T, k, P=3):
    nbytes = 4 * (2 * B * C * T + 2 * P * (C * C * k + C))
    return nbytes / HBM_BYTES_PER_S, P * 2 * 2 * C * C * k * T * B / F32_FLOPS


def resblock_inputs(B, C, T, k, gen, P=3):
    import torch
    r = lambda *s, scale=1.0: torch.randn(*s, device="cuda", generator=gen) * scale
    w = lambda: r(P, k, C, C, scale=(C * k) ** -0.5)
    return r(B, C, T), w(), r(P, C, scale=0.1), w(), r(P, C, scale=0.1)


def bound_of(parts):
    t_bytes = sum(p[0] for p in parts)
    t_ops = sum(p[1] for p in parts)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def log_times(what, kernel, plain, library=None):
    lib = "none" if library is None else f"{library(): .4f} ms"
    log(f"    {what:34s} kernel {kernel():.4f} ms, plain {plain():.4f} ms, "
        f"yardstick {lib}")


def phase3(hk, check):
    """Each kernel against its plain version at full width, B = 1 and 32,
    with device times (kernel, plain, and the one-call yardstick where
    PyTorch has one)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(3)
    for B in (1, 32):
        args = attention_inputs(B, 128, gen)
        for scale in (None, torch.full((1,), 1.3, device="cuda")):
            ctx, w = hk.attention_step(*args, scale)
            ctx_p, w_p = hk.attention_step_plain(*args, scale)
            tag = f"B={B} T=128" + (" scaled" if scale is not None else "")
            check("attention_step", w, w_p, *TOL["attention_step"], tag + " w")
            check("attention_step", ctx, ctx_p, 1e-4, 1e-4, tag + " ctx")
        log_times(f"attention_step B={B} T=128",
                  lambda: time_ms(lambda: hk.attention_step(*args), 100),
                  lambda: time_ms(lambda: hk.attention_step_plain(*args), 100))
        for name, F, H in LSTM_SHAPES:
            args = lstm_inputs(B, F, H, gen)
            for i, (got, want) in enumerate(zip(hk.lstm_gates(*args),
                                                hk.lstm_gates_plain(*args))):
                check("lstm_gates", got, want, *TOL["lstm_gates"],
                      f"B={B} {name} {'ch'[i]}")
            xh, W, b, c = args
            cell = library_lstm_cell(W, b, H)
            x, h = xh[:, :F - H].contiguous(), xh[:, F - H:].contiguous()
            with torch.no_grad():
                log_times(f"lstm_gates B={B} {name}",
                          lambda: time_ms(lambda: hk.lstm_gates(*args), 100),
                          lambda: time_ms(lambda: hk.lstm_gates_plain(*args), 100),
                          lambda: time_ms(lambda: cell(x, (h, c)), 100))
        T_mel = 32
        for C, up in ((256, 8), (128, 64), (64, 256), (32, 512)):
            for k in (3, 7, 11):
                args = resblock_inputs(B, C, T_mel * up, k, gen)
                got = hk.hifigan_resblock(*args, (1, 3, 5), 0.1)
                want = hk.hifigan_resblock_plain(*args, (1, 3, 5), 0.1)
                tag = f"B={B} C={C} T={T_mel * up} k={k}"
                check("hifigan_resblock", got, want, *TOL["hifigan_resblock"], tag)
                log_times(f"hifigan_resblock {tag}",
                          lambda: time_ms(lambda: hk.hifigan_resblock(
                              *args, (1, 3, 5), 0.1), 3),
                          lambda: time_ms(lambda: hk.hifigan_resblock_plain(
                              *args, (1, 3, 5), 0.1), 3))
                del args, got, want
        torch.cuda.synchronize()


def phase4(t2s, hk):
    """The main path: 3 requests through T2S; returns the result with the
    most audio, whose shapes phase4_timing uses."""
    import numpy as np
    requests = [
        ("The quick brown fox jumps over the lazy dog.", ["alice"]),
        ('She looked up and said, "It is a fine day for a walk." Then she '
         "left the room without another word.", ["alice", "bob"]),
        ("Serving on the card, one more request for the smoke test.", ["bob"]),
    ]
    t2s.infer("A warm-up request.", speaker=["alice"], seed=99)
    hk.reset_launch_counts()
    largest, n_segments = None, []
    for i, (text, speakers) in enumerate(requests):
        t0 = time.perf_counter()
        res = t2s.infer(text, speaker=speakers, seed=i)
        seconds = time.perf_counter() - t0
        audio = res["audio"]
        n_samples = int(res["mel_lengths"].sum()) * HOP
        log(f"  request {i}: {len(res['segments'])} segment(s), mel_lengths "
            f"{res['mel_lengths'].tolist()}, {seconds:.3f} s (decode "
            f"{res['gen_time']:.3f} s, vocode "
            f"{res['total_time'] - res['gen_time']:.3f} s), "
            f"{res['audio_seconds'] / seconds:.2f} x realtime")
        if not np.isfinite(audio).all():
            raise SystemExit(f"chip_smoke: request {i} audio is not finite")
        if len(audio) != n_samples:
            raise SystemExit(f"chip_smoke: request {i} audio has {len(audio)} "
                             f"samples, expected {n_samples}")
        if largest is None or res["audio_seconds"] > largest["audio_seconds"]:
            largest = res
        n_segments.append(len(res["segments"]))
    if max(n_segments) < 2:
        raise SystemExit("chip_smoke: no request was multi-segment")
    launches = dict(hk.LAUNCHES)
    log(f"  launches on the main path: {launches}")
    if min(launches.values()) <= 0:
        raise SystemExit("chip_smoke: a kernel of the main path never launched")
    step_ms, device_ms = decode_busy_share(t2s.model)
    busy = (f"{device_ms / step_ms:.3f}" if device_ms > 0
            else "not measured (the profiler saw no device time)")
    log(f"  decode loop, B=4, T_enc=64: {step_ms:.3f} ms per step wall, "
        f"{device_ms:.3f} ms per step on the device, device busy share {busy}")
    return largest, launches


def phase4_timing(hk, check, taco, gen, res, batch_size):
    """Time each kernel at the shapes the main path gave it (the request
    with the most audio)."""
    import torch
    from cookietts_tpu_torch.text import text_to_sequence
    g = torch.Generator(device="cuda").manual_seed(4)
    cleaners = ("english_cleaners",)
    t_max = max(len(text_to_sequence(s, cleaners)) for s in res["segments"])
    T_enc = -(-t_max // 32) * 32
    B = batch_size
    out = {}

    # attention_step: one decode step
    args = attention_inputs(B, T_enc, g)
    check("attention_step", hk.attention_step(*args)[1],
          hk.attention_step_plain(*args)[1], *TOL["attention_step"],
          f"main path B={B} T={T_enc} w")
    out["attention_step"] = dict(
        unit=f"one decode step, B={B}, T_enc={T_enc}",
        ms=time_ms(lambda: hk.attention_step(*args), 200),
        eager_ms=eager_ms(lambda: hk.attention_step(*args), 200),
        plain_ms=time_ms(lambda: hk.attention_step_plain(*args), 200),
        library_ms=None, bound=bound_of([attention_bound(B, T_enc)]))

    # lstm_gates: the three decoder cells of one step
    cells = [(taco.decoder.attention_rnn, 1280), (taco.decoder.decoder_rnn, 768),
             (taco.decoder.second_decoder_rnn, 768)]
    cases = []
    for cell, H in cells:
        W, b = cell.fused()
        xh = torch.randn(B, W.shape[0], device="cuda", generator=g)
        c = torch.randn(B, H, device="cuda", generator=g)
        lib_cell = library_lstm_cell(W, b, H)
        x, h = xh[:, :W.shape[0] - H].contiguous(), xh[:, W.shape[0] - H:].contiguous()
        cases.append((xh, W, b, c, lib_cell, x, h))
        c_k, h_k = hk.lstm_gates(xh, W, b, c)
        c_p, h_p = hk.lstm_gates_plain(xh, W, b, c)
        check("lstm_gates", h_k, h_p, *TOL["lstm_gates"],
              f"main path B={B} H={H} h")
        with torch.no_grad():
            h_l, c_l = lib_cell(x, (h, c))
        check("lstm_gates", c_k, c_l, 1e-4, 1e-4, f"vs nn.LSTMCell H={H} c")

    def run(fn):
        return lambda: [fn(*cs) for cs in cases]
    with torch.no_grad():
        out["lstm_gates"] = dict(
            unit=f"one decode step (3 cells), B={B}",
            ms=time_ms(run(lambda xh, W, b, c, *_: hk.lstm_gates(xh, W, b, c)), 200),
            eager_ms=eager_ms(run(lambda xh, W, b, c, *_:
                                  hk.lstm_gates(xh, W, b, c)), 200),
            plain_ms=time_ms(run(lambda xh, W, b, c, *_:
                                 hk.lstm_gates_plain(xh, W, b, c)), 200),
            library_ms=time_ms(run(lambda *cs: cs[4](cs[5], (cs[6], cs[3]))), 200),
            bound=bound_of([lstm_bound(B, W.shape[0], W.shape[1] // 4)
                            for _, W, *_ in cases]))

    # hifigan_resblock: the 12 resblocks of one generator call
    B_voc = len(res["mels"])
    T_pad = -(-int(max(res["mel_lengths"])) // 32) * 32
    blocks, parts, T = [], [], T_pad
    n_k = len(gen.cfg.resblock_kernel_sizes)
    for i, u in enumerate(gen.cfg.upsample_rates):
        T *= u
        C = gen.cfg.upsample_initial_channel // 2 ** (i + 1)
        x = torch.randn(B_voc, C, T, device="cuda", generator=g)
        for rb in gen.resblocks[i * n_k:(i + 1) * n_k]:
            blocks.append((x, *rb.kernel_weights(), rb.dilations, rb.slope))
            parts.append(resblock_bound(B_voc, C, T, rb.convs1[0].kernel_size[0],
                                        len(rb.dilations)))
    for args in blocks[::4]:
        check("hifigan_resblock", hk.hifigan_resblock(*args),
              hk.hifigan_resblock_plain(*args), *TOL["hifigan_resblock"],
              f"main path B={B_voc} C={args[0].shape[1]} T={args[0].shape[2]}")
    out["hifigan_resblock"] = dict(
        unit=f"one generator call (12 resblocks), B={B_voc}, T_mel={T_pad}",
        ms=time_ms(lambda: [hk.hifigan_resblock(*a) for a in blocks], 3),
        eager_ms=eager_ms(lambda: [hk.hifigan_resblock(*a) for a in blocks], 3),
        plain_ms=time_ms(lambda: [hk.hifigan_resblock_plain(*a) for a in blocks], 3),
        library_ms=None, bound=bound_of(parts))
    for name, o in out.items():
        log(f"  {name:17s} {o['unit']}: kernel {o['ms']:.4f} ms (eager "
            f"{o['eager_ms']:.4f} ms), plain "
            f"{o['plain_ms']:.4f} ms, library {o['library_ms']}, bound "
            f"{o['bound'][0]:.4f} ms ({o['bound'][1]})")
    return out


def phase5(hk, check, cfgs):
    """Kernel path against plain path for the whole slice, on the card."""
    import dataclasses

    import torch
    from cookietts_tpu_torch.models.hifigan import Generator
    from cookietts_tpu_torch.models.tacotron2 import Tacotron2
    tcfg, hcfg = cfgs
    torch.manual_seed(5)
    taco = Tacotron2(dataclasses.replace(tcfg, p_prenet_dropout=0.0), device="cuda")
    gen = Generator(hcfg, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(6)
    text = torch.randint(1, tcfg.n_symbols, (2, 64), device="cuda", generator=g)
    lengths = torch.tensor([64, 41], device="cuda")
    spk = torch.tensor([0, 1], device="cuda")

    def run():
        out = taco.inference(text, lengths, spk, max_decoder_steps=32)
        return out, gen(out["mel_outputs_postnet"])
    k_out, k_audio = run()
    with plain_kernels(hk):
        p_out, p_audio = run()
    for key, atol in (("mel_outputs_postnet", 1e-3), ("gate_outputs", 1e-3),
                      ("alignments", 1e-4)):
        check("slice", k_out[key], p_out[key], atol, 1e-3, key)
    check("slice", k_audio, p_audio, 1e-3, 1e-3, "HiFi-GAN audio")
    if not torch.equal(k_out["mel_lengths"], p_out["mel_lengths"]):
        raise SystemExit("chip_smoke: slice mel_lengths differ")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    if not (ROOT / "cookietts_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout holding cookietts_tpu_torch/",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from cookietts_tpu_torch.models.hifigan import Generator, HiFiGANConfig
    from cookietts_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
    from cookietts_tpu_torch.ops import _build
    from cookietts_tpu_torch.ops import hopper_kernels as hk
    from cookietts_tpu_torch.pipeline.text2speech import T2S, T2SConfig
    from cookietts_tpu_torch.text import N_SYMBOLS

    t_all = time.perf_counter()
    log("phase 1: environment")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    log(f"  nvidia-smi: {smi}; TF32 off (matmul and cuDNN)")

    log("phase 2: build")
    _build.load_all()
    log(f"  built/loaded {len(_build._LIBS)} kernel libraries in "
        f"{_build.BUILD_SECONDS:.1f} s")
    for logf in sorted(_build._build_dir().glob("*.log")):
        for line in logf.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {logf.stem}: {line.strip()}")

    check = Check()
    log("phase 3: kernels against their plain versions (full width)")
    phase3(hk, check)

    log("phase 4: main path, full width, 3 requests")
    tcfg = Tacotron2Config(n_symbols=N_SYMBOLS)
    hcfg = HiFiGANConfig(upsample_rates=(8, 8, 4, 2),
                         upsample_kernel_sizes=(16, 16, 8, 4))
    torch.manual_seed(0)
    taco = Tacotron2(tcfg, device="cuda")
    gen = Generator(hcfg, device="cuda")
    t2s_cfg = T2SConfig(batch_size=4, max_attempts=1, step_buckets=(256, 512),
                        max_decoder_steps=512)
    t2s = T2S(t2s_cfg, taco, {"alice": 0, "bob": 1}, vocoder_fn=gen,
              sample_rate=SR, hop_length=HOP, device="cuda")
    res, launches = phase4(t2s, hk)
    timing = phase4_timing(hk, check, taco, gen, res, t2s_cfg.batch_size)

    log("phase 5: whole slice, kernels against plain versions")
    phase5(hk, check, (tcfg, hcfg))

    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": check.max_abs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"],
            "eager_ms": t["eager_ms"], "unit": t["unit"]})
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
   shapes: the attention kernel at batch 1, 4 and 32 by T_enc 64, 128 and
   384 with the decoder's window-16 mask, the full length mask, a row that
   admits nothing, D = 1313 and a plan forced into 8 stages (each call one
   launch, two calls bit-identical, the plan's shared memory the kernel's);
   the HiFi-GAN kernel at batch 1 and 32 (the
   resblock at every generator width, 256 down to 8 channels), the LSTM
   kernel at batch 1, 4 and 32 for the three decoder cells (two calls must
   give the same bits; timed beside nn.LSTMCell), the two WN kernels of the
   flow vocoders at batch 1 and 4, at a request's length, at 1500 and at
   the main path's (each with the tiles wn_layer_plan picks).
4. the main path: T2S -> Tacotron2 (Tacotron2Config() defaults) -> HiFi-GAN
   (the bench-serving generator) at full width with random weights from a
   seed, answering 3 requests (one of them multi-segment); T2S decodes
   through its CUDA-graph chunk program. Launch counters are zeroed just
   before and read just after; every kernel must have run.
   Then each kernel is timed at the shapes this run gave it, beside its
   plain version, a library call where one computes the same function, and
   its bound on the card (the resblock's both on the f32 CUDA cores and on
   the tensor cores in 3xTF32, the one it is held to; and each of the
   generator's four stages alone); beside the attention kernel's, the bytes
   of the rows its mask admits and the empty-kernel floor of its launch,
   and its time as a call in a CUDA graph of 20 (graph_ms).
4b. the flow vocoders' path: a Tacotron2 of the same configuration at the
   flow vocoders' 160 mel channels behind T2S, once with the full-width
   WaveGlow (48 flows, 256 channels) and once with the full-width WaveFlow
   (6 flows x 8 rows, 64 channels) as a stochastic vocoder_fn, each with a
   Denoiser built from it: one request with denoise_strength > 0, then
   WaveGlow.infer alone on a 400-frame mel (5 s at 48 kHz, batch 1). The
   launch counters are zeroed before and must afterwards show exactly the
   launches the shapes predict. The same infer is then timed with the
   kernels and with their plain versions, and split into its parts; the WN
   kernel's calls beside their bounds (3xTF32 tensor cores, held to, and
   f32 CUDA cores).
5. the whole slice with kernels against the same slice with the plain
   versions swapped in, on the card: a 32-step decode and one vocoder batch,
   then a 32-step decode of Tacotron2Config(use_memory_bottleneck=False)
   (decoder memory 1313 wide); and the whole inverse of each flow vocoder
   at full width, same z.
6. the streaming and serving slice at full width (the phase-4 Tacotron2
   and HiFi-GAN): the decode chunk captured as a CUDA graph
   (pipeline/chunk_graph.py) replayed against the same chunk run eagerly
   (same seed, bit for bit) and against the plain kernels; decode ms per
   step, wall and device, eager against replayed, at B=4, T_enc=64;
   streaming_tts at B=1 and B=4 (32-step chunks, a 32-frame vocoder halo, a
   fixed 256-step decode) against the whole pipeline on the card with the
   same generator seed, with time to first audio, request time, and replays
   against captures, launch counters zeroed before and read after; the HTTP
   handler's body (handle_tts, no tornado) twice on a ModelRegistry, with the
   reference field names and with the aliases; lstm_gates cells on two
   streams at once and in two CUDA graphs replayed at once, against the
   plain version (and once with one counter set forced on both streams, to
   show what the per-stream counters prevent), two captured decode chunks
   replayed at once on two streams; the resblock widths the kernel does not
   take (C = 96, 192: plain under "auto", raising under True); and a chunk
   that cannot be captured, which must raise.
7. the training slice at full width (Tacotron2Config()): the port's train
   command in-process on a 48-utterance evidence corpus (22050 Hz, hop
   256, 80 mels, one 144-frame bucket and TBPTT segment, batch 16), 6
   iterations with validation and a checkpoint every 3, then --resume to
   8: every loss finite, the checkpoints there, the resume at step 6, and
   the two training kernels launched once per decoder step (lstm_gates: 3
   cells) in training and in both validations; the two kernels at the
   training shapes against their plain versions, timed forward, with their
   backward (autograd of the plain version) timed; one train step (loss,
   backward, clipping, Adam) at B=16, T_txt=64, T_dec=800 with the kernels
   and with the plain versions from the same weights and generator seed:
   loss within rel 1e-5, every gradient within relative L2 1e-4, the
   updated parameters, each path's s/iter split into forward and backward,
   its peak memory, and the device-busy share of a kernel-path step.

The second-to-last line is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS = 67e12              # H100 SXM f32, outside the tensor cores
TF32X3_FLOPS = 495e12 / 3      # H100 SXM TF32 tensor cores, 3 products a flop
SR, HOP = 44100, 512
KERNEL_SOURCES = {
    "attention_step": ("cookietts_tpu_torch/csrc/attention_step.cu",
                       "cookietts_tpu/ops/pallas_kernels.py:74"),
    "lstm_gates": ("cookietts_tpu_torch/csrc/lstm_gates.cu",
                   "cookietts_tpu/ops/pallas_kernels.py:236"),
    "hifigan_resblock": ("cookietts_tpu_torch/csrc/hifigan_resblock.cu",
                         "cookietts_tpu/ops/pallas_kernels.py:724"),
    "waveglow_wn_forward": ("cookietts_tpu_torch/csrc/waveglow_wn.cu",
                            "cookietts_tpu/ops/pallas_kernels.py:609"),
    "waveflow_row_step": ("cookietts_tpu_torch/csrc/waveflow_row.cu",
                          "cookietts_tpu/ops/pallas_kernels.py:467"),
}
# the flow vocoders at full width (48 kHz, hop 600, 160 mel channels)
FLOW_SR, FLOW_HOP, FLOW_MELS = 48000, 600, 160
WAVEGLOW = dict(n_mel_channels=FLOW_MELS, n_flows=48, n_group=24,
                n_early_every=4, n_early_size=2, n_layers=8, n_channels=256,
                kernel_size=3, hop_length=FLOW_HOP, upsample_strides=(5, 5),
                upsample_channels=256, sampling_rate=FLOW_SR)
WAVEFLOW = dict(n_mel_channels=FLOW_MELS, n_flows=6, n_group=8, n_early_every=0,
                channel_mixing="permuteheight", n_layers=8, n_channels=64,
                kernel_size=3, kernel_size_h=3, hop_length=FLOW_HOP,
                upsample_strides=(75,), upsample_channels=128,
                sampling_rate=FLOW_SR)
# the three decoder cells at full width: (name, F = in + H, H)
LSTM_SHAPES = (("attention_rnn", 2816, 1280), ("decoder_rnn", 2560, 768),
               ("second_decoder_rnn", 1536, 768))
# a spin on the device (about 25 ms) that holds two streams while the host
# queues their work, so the work then runs at the same time (phase 6)
HOLD_CYCLES = 50_000_000
# (atol, rtol). The WN kernels sum 768 to 1536 products per output in 3xTF32
# and in another order than cuDNN, through 8 layers: a few 1e-6 at values
# near 2 (tests/test_torch_kernels.py emulates the split).
TOL = {"attention_step": (2e-5, 1e-4), "lstm_gates": (2e-5, 1e-4),
       "hifigan_resblock": (1e-4, 1e-4), "waveglow_wn_forward": (2e-5, 1e-4),
       "waveflow_row_step": (2e-5, 1e-4)}


def log(*a):
    print(*a, flush=True)


def ptxas_report(text):
    """(kernel, "N registers, ... spill ...") per entry function of an
    `nvcc -Xptxas -v` log; a template's arguments follow its name."""
    import re
    out, kernel, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = name = m.group(1)
            at = re.search(r"_cu_[0-9a-f]{8}(\d+)", name)
            if at:
                n = int(at.group(1))
                kernel = name[at.end():at.end() + n]
                rest = name[at.end() + n:]
                if rest.startswith("I") and "EEv" in rest:
                    args = re.findall(r"L[ib](\d+)E", rest[:rest.index("EEv") + 1])
                    kernel += "<" + ",".join(args) + ">"
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and kernel:
            out.append((kernel, line.split("Used", 1)[1].strip() + "; " + spill))
            kernel = None
    return out


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


def graph_ms(fn, calls: int = 20, reps: int = 50) -> float:
    """Device ms per call of ``fn`` with ``calls`` calls captured in one
    graph: the launches follow each other on the device, as a captured
    decode's would, and the host's cost of launching the graph is shared by
    them (time_ms's floor is mostly that cost for a call of a few us)."""
    return time_ms(lambda: [fn() for _ in range(calls)], reps) / calls


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
    plain = {"attention_step": hk.attention_step_plain,
             "lstm_gates": hk.lstm_gates_plain,
             "hifigan_resblock": hk.hifigan_resblock_plain,
             "waveglow_wn_forward": hk.waveglow_wn_forward_plain,
             "waveflow_row_step": hk.waveflow_row_step_ring_plain}
    saved = {n: getattr(hk, n) for n in plain}
    for n, fn in plain.items():
        setattr(hk, n, fn)
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(hk, n, fn)


# -- per-kernel inputs, bounds and comparisons --------------------------------

def attention_inputs(B, T, gen, A=192, D=512, window=16, empty_row=False):
    """Random inputs of one attention step: the length mask of each row
    (lengths from T/2 to T), cut to a window of 2 * window + 1 rows unless
    window is 0 (the windowed_attention_range=0 configuration); with
    ``empty_row`` row 0 admits nothing."""
    import torch
    dev = "cuda"
    r = lambda *s, scale=1.0: torch.randn(*s, device=dev, generator=gen) * scale
    lengths = torch.randint(T // 2, T + 1, (B,), device=dev, generator=gen)
    idx = torch.arange(T, device=dev)[None, :]
    start = torch.randint(0, T // 2, (B, 1), device=dev, generator=gen)
    mask = idx < lengths[:, None]
    if window:
        mask &= (idx >= start) & (idx <= start + 2 * window)
    if empty_row:
        mask[0] = False
    return (r(B, A, scale=0.5), r(B, T, A, scale=0.5), r(B, T, A, scale=0.5),
            r(A, scale=A ** -0.5), r(B, T, D), mask.contiguous())


def attention_bound(B, T, A=192, D=512):
    nbytes = 4 * (B * A + 2 * B * T * A + A + B * T * D + B * D + B * T) + B * T
    flops = B * T * (4 * A + 2 * D)
    return nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS


def attention_admitted_bytes(mask, A=192, D=512):
    """Bytes v3 moves: the bound's count with lp, mp and memory cut to the
    rows the mask admits (not the bound, which counts every row)."""
    B, T = mask.shape
    n_adm = int(mask.sum())
    return 4 * (B * A + A + B * D + B * T + n_adm * (2 * A + D)) + B * T


def launch_floor_ms(hk, B, S, timer=lambda fn: time_ms(fn, 200)):
    """Device ms of an empty kernel launched on attention_step's grid (S
    blocks a cluster, B clusters; S = 0: one plain block), by default in
    time_ms's CUDA-graph harness: the least a launch of that shape takes."""
    from cookietts_tpu_torch.ops import _build
    lib = _build.library("attention_step")
    return timer(lambda: hk._raise_on(
        lib.attention_empty_launch(B, S, hk._stream()), "empty kernel"))


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


def resblock_bound(B, C, T, k, P=3, rate=TF32X3_FLOPS):
    """(s by bytes, s by operations) of one resblock: by default on the
    tensor cores in 3xTF32, the rate the kernel is held to; rate=F32_FLOPS
    gives the f32 CUDA-core bound."""
    nbytes = 4 * (2 * B * C * T + 2 * P * (C * C * k + C))
    return nbytes / HBM_BYTES_PER_S, P * 2 * 2 * C * C * k * T * B / rate


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
    phase3_attention(hk, check, gen)
    for B in (1, 32):
        T_mel = 32
        for C, up in ((256, 8), (128, 64), (64, 256), (32, 512), (16, 512),
                      (8, 512)):
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
    phase3_lstm(hk, check, gen)


def phase3_attention(hk, check, gen):
    """attention_step against its plain version at A=192: B = 1, 4, 32 by
    T = 64, 128, 384 with a window-16 mask (scaled too at T = 128), the full
    length mask at B=32, T=128, a row that admits nothing, and D = 1313 (the
    decoder memory without its bottleneck). Each call must be one launch,
    two calls must give the same bits, and the plan's shared memory must be
    the kernel's. Timed beside the plain version. Then a plan forced into 8
    stages a block, which the default plans do not reach."""
    import torch
    cases = [(B, T, 512, 16, False) for B in (1, 4, 32) for T in (64, 128, 384)]
    cases += [(32, 128, 512, 0, False), (4, 64, 512, 16, True),
              (4, 64, 1313, 16, False)]
    from cookietts_tpu_torch.ops import _build
    lib = _build.library("attention_step")
    for B, T, D, window, empty_row in cases:
        plan = hk.attention_step_plan(B, T, 192, D)
        if lib.attention_step_smem(192, D, *plan.ints()[1:]) != plan.smem:
            raise SystemExit(f"chip_smoke: attention_step_plan's shared memory "
                             f"{plan.smem} is not the kernel's layout")
        args = attention_inputs(B, T, gen, D=D, window=window, empty_row=empty_row)
        tag = (f"B={B} T={T} D={D} " + (f"window {window}" if window else "full mask")
               + (" empty row 0" if empty_row else ""))
        scales = [None] + ([torch.full((1,), 1.3, device="cuda")] if T == 128 else [])
        for scale in scales:
            before = hk.LAUNCHES["attention_step"]
            ctx, w = hk.attention_step(*args, scale)
            again = hk.attention_step(*args, scale)
            launches = hk.LAUNCHES["attention_step"] - before
            ctx_p, w_p = hk.attention_step_plain(*args, scale)
            what = tag + (" scaled" if scale is not None else "")
            check("attention_step", w, w_p, *TOL["attention_step"], what + " w")
            check("attention_step", ctx, ctx_p, 1e-4, 1e-4, what + " ctx")
            same = torch.equal(ctx, again[0]) and torch.equal(w, again[1])
            if launches != 2 or not same:
                raise SystemExit(f"chip_smoke: attention_step {what}: {launches} "
                                 f"launches for 2 calls, bit-identical {same}")
        log_times(f"attention_step {tag}",
                  lambda: time_ms(lambda: hk.attention_step(*args), 100),
                  lambda: time_ms(lambda: hk.attention_step_plain(*args), 100))
    # more admitted rows than a stage holds: 8 stages of 8 rows a block
    staged = hk.attention_step_plan(32, 128, 192, 512, cluster=2, stage_rows=8)
    args = attention_inputs(32, 128, gen, window=0)
    ctx, w = hk.attention_step(*args, plan=staged)
    ctx_p, w_p = hk.attention_step_plain(*args)
    check("attention_step", w, w_p, *TOL["attention_step"], f"full mask {staged.ints()} w")
    check("attention_step", ctx, ctx_p, 1e-4, 1e-4, f"full mask {staged.ints()} ctx")
    log("  attention_step: one launch a call, two calls bit-identical, at "
        "every shape")
    torch.cuda.synchronize()


def phase3_lstm(hk, check, gen):
    """lstm_gates against its plain version, bit-identical over two calls
    (the split-K sum runs in a fixed order), and timed beside its plain
    version and nn.LSTMCell, for the three cells at B = 1, 4 and 32."""
    import torch
    for B in (1, 4, 32):
        for name, F, H in LSTM_SHAPES:
            args = lstm_inputs(B, F, H, gen)
            first = hk.lstm_gates(*args)
            for i, (got, want) in enumerate(zip(first, hk.lstm_gates_plain(*args))):
                check("lstm_gates", got, want, *TOL["lstm_gates"],
                      f"B={B} {name} {'ch'[i]}")
            again = hk.lstm_gates(*args)
            same = all(torch.equal(a, b) for a, b in zip(first, again))
            log(f"  lstm_gates        B={B} {name}: two calls bit-identical: {same}")
            if not same:
                raise SystemExit(f"chip_smoke: lstm_gates B={B} {name} is not "
                                 "deterministic")
            xh, W, b, c = args
            cell = library_lstm_cell(W, b, H)
            x, h = xh[:, :F - H].contiguous(), xh[:, F - H:].contiguous()
            with torch.no_grad():
                log_times(f"lstm_gates B={B} {name}",
                          lambda: time_ms(lambda: hk.lstm_gates(*args), 100),
                          lambda: time_ms(lambda: hk.lstm_gates_plain(*args), 100),
                          lambda: time_ms(lambda: cell(x, (h, c)), 100))
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
    launches = {name: hk.LAUNCHES[name] for name in
                ("attention_step", "lstm_gates", "hifigan_resblock")}
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
    plan = hk.attention_step_plan(B, T_enc, 192, 512)
    log(f"  attention_step B={B} T_enc={T_enc}: plan {plan}; admitted rows "
        f"{int(args[-1].sum())} of {B * T_enc}, their bytes "
        f"{attention_admitted_bytes(args[-1])} = "
        f"{attention_admitted_bytes(args[-1]) / HBM_BYTES_PER_S * 1e3:.5f} ms "
        f"(not the bound, which counts every row: "
        f"{out['attention_step']['bound'][0]:.5f} ms); empty-kernel floor "
        f"{launch_floor_ms(hk, B, plan.cluster):.4f} ms on the same grid, "
        f"{launch_floor_ms(hk, 1, 0):.4f} ms for one block; a call in a graph "
        f"of 20: kernel {graph_ms(lambda: hk.attention_step(*args)):.4f} ms, "
        f"plain {graph_ms(lambda: hk.attention_step_plain(*args)):.4f} ms, "
        f"floor {launch_floor_ms(hk, B, plan.cluster, graph_ms):.4f} ms")

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
    blocks, parts, parts_f32, stages, T = [], [], [], [], T_pad
    n_k = len(gen.cfg.resblock_kernel_sizes)
    for i, u in enumerate(gen.cfg.upsample_rates):
        T *= u
        C = gen.cfg.upsample_initial_channel // 2 ** (i + 1)
        x = torch.randn(B_voc, C, T, device="cuda", generator=g)
        stages.append((C, T, len(blocks)))
        for rb in gen.resblocks[i * n_k:(i + 1) * n_k]:
            blocks.append((x, *rb.kernel_weights(), rb.dilations, rb.slope))
            shape = (B_voc, C, T, rb.convs1[0].kernel_size[0], len(rb.dilations))
            parts.append(resblock_bound(*shape))
            parts_f32.append(resblock_bound(*shape, rate=F32_FLOPS))
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
    f32_bound = bound_of(parts_f32)
    log(f"  hifigan_resblock bounds of one generator call: 3xTF32 tensor cores "
        f"{out['hifigan_resblock']['bound'][0]:.4f} ms, f32 CUDA cores "
        f"{f32_bound[0]:.4f} ms ({f32_bound[1]}); the kernel runs 3xTF32 "
        "mma.sync and is held to the first")
    for C, T, first in stages:
        stage = blocks[first:first + n_k]
        log(f"    stage C={C} T={T}: {n_k} resblocks kernel "
            f"{time_ms(lambda: [hk.hifigan_resblock(*a) for a in stage], 3):.4f} ms, "
            f"plain {time_ms(lambda: [hk.hifigan_resblock_plain(*a) for a in stage], 3):.4f} ms, "
            f"3xTF32 bound {bound_of(parts[first:first + n_k])[0]:.4f} ms")
    for name, o in out.items():
        log(f"  {name:17s} {o['unit']}: kernel {o['ms']:.4f} ms (eager "
            f"{o['eager_ms']:.4f} ms), plain "
            f"{o['plain_ms']:.4f} ms, library {o['library_ms']}, bound "
            f"{o['bound'][0]:.4f} ms ({o['bound'][1]})")
    return out


# -- the flow vocoders: inputs, bounds, phases ---------------------------------

def wn_weights(gen, Cin, C, Cout, L, rows, kw):
    """Random WN weights in the kernels' layouts (ops/hopper_kernels.py)."""
    import torch
    r = lambda *s, scale=1.0: torch.randn(*s, device="cuda", generator=gen) * scale
    k = rows * kw * C
    rs_w, rs_b = r(L, C, 2 * C, scale=C ** -0.5), r(L, 2 * C, scale=0.1)
    rs_w[-1, :, :C] = 0                      # the last layer has no res half
    rs_b[-1, :C] = 0
    return (r(Cin, C, scale=Cin ** -0.5), r(C, scale=0.1),
            r(L, k, 2 * C, scale=k ** -0.5), rs_w, rs_b,
            r(C, Cout, scale=(C * L) ** -0.5), r(Cout, scale=0.1))


def wn_bound(B, T, Cin, C, Cout, L, rows, kw, rate=TF32X3_FLOPS):
    """(seconds by bytes, seconds by operations) of one WN evaluation: x,
    cond_bc, the weights and (for a row step) the rows of the queues read
    once, the output and the new row of each queue written once; the last
    layer's res half is not needed and not counted. By default on the
    tensor cores in 3xTF32, the rate the kernels are held to; rate=F32_FLOPS
    gives the f32 CUDA-core bound."""
    weights = Cin * C + C + L * (rows * kw * C * 2 * C + C * 2 * C + 2 * C) \
        + C * Cout + Cout
    state = L * rows * C * T * B if rows > 1 else 0     # queues in, rows out
    nbytes = 4 * (B * T * (Cin + L * 2 * C + Cout) + weights + state)
    flops = B * T * (2 * Cin * C + L * 2 * 2 * C * (rows * kw + 1) * C
                     - 2 * C * C + 2 * C * Cout)
    return nbytes / HBM_BYTES_PER_S, flops / rate


def plan_text(hk, B, C, T, rows, kw):
    """wn_layer_plan's two launches of a layer, with their blocks."""
    plan = hk.wn_layer_plan(B, C, T, rows, kw)
    return ", ".join(f"{name} tile{p.tile} {p.m}x{p.n} {p.blocks} blocks"
                     for name, p in (("conv", plan.conv), ("res/skip", plan.rs)))


def phase3_flow(hk, check):
    """The two WN kernels against their plain versions at full width, B = 1
    and 4, at a request's length (T' = 250), phase 3's 1500 and the main
    path's (WaveGlow 10000, WaveFlow 30000): WaveGlow's first flow (12
    input channels) and last (1), ends included (T' beyond twice the
    dilations' reach of 255); four consecutive WaveFlow rows, so that the
    ring has gone round once. Each timed beside its plain version."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(33)
    r = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    L, kw, kh = 8, 3, 3
    for B in (1, 4):
        for T in (250, 1500, 10000):
            log(f"    waveglow_wn_forward B={B} T'={T}: "
                f"{plan_text(hk, B, 256, T, 1, kw)}")
            for Cin in (12, 1):
                w = wn_weights(gen, Cin, 256, 2 * Cin, L, 1, kw)
                x, cond = r(B, Cin, T), r(B, L, 512, T)
                got = hk.waveglow_wn_forward(x, cond, *w)
                want = hk.waveglow_wn_forward_plain(x, cond, *w)
                tag = f"B={B} Cin={Cin} T'={T}"
                check("waveglow_wn_forward", got, want, *TOL["waveglow_wn_forward"], tag)
                for part, sl in (("first 300", slice(0, 300)),
                                 ("last 300", slice(-300, None))):
                    check("waveglow_wn_forward", got[..., sl], want[..., sl],
                          *TOL["waveglow_wn_forward"], f"{tag} {part}")
                log_times(f"waveglow_wn_forward {tag}",
                          lambda: time_ms(lambda: hk.waveglow_wn_forward(x, cond, *w), 3),
                          lambda: time_ms(lambda: hk.waveglow_wn_forward_plain(
                              x, cond, *w), 3))
                del x, cond, got, want
        for W in (250, 1500, 30000):
            log(f"    waveflow_row_step B={B} W={W}: {plan_text(hk, B, 64, W, kh, kw)}")
            w = wn_weights(gen, 1, 64, 2, L, kh, kw)
            cond = r(B, L, 128, W)
            ring = torch.zeros(L, kh, B, 64, W, device="cuda")
            queues = torch.zeros(L, kh - 1, B, 64, W, device="cuda")
            x_prev = torch.zeros(B, W, device="cuda")
            for step in range(4):
                log_s, t = hk.waveflow_row_step(x_prev, ring, step, cond, *w)
                ls_p, t_p, queues = hk.waveflow_row_step_plain(x_prev, queues, cond, *w)
                tag = f"B={B} W={W} kh={kh} row {step}"
                check("waveflow_row_step", log_s, ls_p, *TOL["waveflow_row_step"],
                      tag + " log_s")
                check("waveflow_row_step", t, t_p, *TOL["waveflow_row_step"], tag + " t")
                check("waveflow_row_step", hk.ring_queues(ring, step + 1), queues,
                      *TOL["waveflow_row_step"], tag + " queues")
                x_prev = r(B, W)
            log_times(f"waveflow_row_step B={B} W={W}",
                      lambda: time_ms(lambda: hk.waveflow_row_step(
                          x_prev, ring, 4, cond, *w), 3),
                      lambda: time_ms(lambda: hk.waveflow_row_step_plain(
                          x_prev, queues, cond, *w), 3))
            del ring, queues, cond
    torch.cuda.synchronize()


def make_flow_vocoder(kw, seed):
    """A full-width flow vocoder with random weights from ``seed``: torch's
    default inits, and end layers small but not zero, so that every flow
    transforms its input and 48 of them stay well-conditioned."""
    import torch
    from cookietts_tpu_torch.models.waveglow import WaveGlow, WaveGlowConfig
    torch.manual_seed(seed)
    model = WaveGlow(WaveGlowConfig(**kw), device="cuda")
    with torch.no_grad():
        for wn in model.WN:
            wn.end.weight.normal_(std=0.05 * kw["n_channels"] ** -0.5)
            wn.end.bias.normal_(std=0.02)
    return model


def wall_ms(fn, reps=2):
    """Wall ms per call of ``fn``, ending in a synchronise, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def flow_parts(model, mel, kernel_calls):
    """Where one infer's time goes: wall ms of the whole infer and of its
    parts run on their own at the same shapes (upsampler, the flows' cond
    projections, ``kernel_calls``: the WN kernel calls, the 1x1 inverses)."""
    import torch
    n = mel.shape[1] * model.cfg.hop_length // model.cfg.n_group
    with torch.no_grad():
        cond = model._cond(mel)
        parts = {"upsampler": lambda: model._cond(mel),
                 "cond projection": lambda: [wn.cond_bc(cond) for wn in model.WN],
                 "kernel": kernel_calls}
        if not model.waveflow:
            ys = [torch.randn(1, c.conv.in_channels, n, device="cuda")
                  for c in model.convinv]
            parts["1x1 inverse"] = lambda: [c.inverse(y)
                                            for c, y in zip(model.convinv, ys)]
        gen = torch.Generator(device="cuda").manual_seed(1)
        total = wall_ms(lambda: model.infer(mel, gen))
        times = {name: wall_ms(fn) for name, fn in parts.items()}
    times["other (coupling, concat, z, host)"] = total - sum(times.values())
    return total, times


def phase4b(hk, check, taco160, name, kw):
    """One flow vocoder behind T2S with its denoiser, then infer alone on a
    400-frame mel; returns (model, launches counted, the 400-frame mel)."""
    import numpy as np
    import torch
    from cookietts_tpu_torch.models.denoiser import Denoiser
    from cookietts_tpu_torch.pipeline.text2speech import (T2S, T2SConfig,
                                                          make_flow_vocoder_fn)
    key = "waveflow_row_step" if kw.get("channel_mixing") else "waveglow_wn_forward"
    model = make_flow_vocoder(kw, seed=11)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {name}: {n_params / 1e6:.1f} M parameters")
    calls = kw["n_flows"] * (kw["n_group"] if model.waveflow else 1)
    per_infer = calls * hk.wn_launches(kw["n_layers"])
    vocoder_fn, infer_with_generator = make_flow_vocoder_fn(model, sigma=0.6, seed=5)
    t2s_cfg = T2SConfig(batch_size=4, max_attempts=1, step_buckets=(256,),
                        max_decoder_steps=256)
    mel400 = torch.randn(1, 400, FLOW_MELS, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(8))

    hk.reset_launch_counts()
    denoiser = Denoiser(infer_with_generator, sampling_rate=FLOW_SR,
                        n_mel_channels=FLOW_MELS, device="cuda")
    t2s = T2S(t2s_cfg, taco160, {"alice": 0, "bob": 1}, vocoder_fn=vocoder_fn,
              denoiser_fn=denoiser, sample_rate=FLOW_SR, hop_length=FLOW_HOP,
              device="cuda")
    t0 = time.perf_counter()
    res = t2s.infer("The quick brown fox jumps over the lazy dog.",
                    speaker=["alice"], seed=0, denoise_strength=0.1)
    seconds = time.perf_counter() - t0
    audio400 = model.infer(mel400, torch.Generator(device="cuda").manual_seed(2))
    torch.cuda.synchronize()
    launches = dict(hk.LAUNCHES)

    n_samples = int(res["mel_lengths"].sum()) * FLOW_HOP
    log(f"  {name} request: mel_lengths {res['mel_lengths'].tolist()}, "
        f"{seconds:.3f} s (decode {res['gen_time']:.3f} s, vocode + denoise "
        f"{res['total_time'] - res['gen_time']:.3f} s), "
        f"{res['audio_seconds'] / seconds:.2f} x realtime")
    if not np.isfinite(res["audio"]).all() or not bool(torch.isfinite(audio400).all()):
        raise SystemExit(f"chip_smoke: {name} audio is not finite")
    if len(res["audio"]) != n_samples or audio400.shape != (1, 400 * FLOW_HOP):
        raise SystemExit(f"chip_smoke: {name} audio has {len(res['audio'])} and "
                         f"{tuple(audio400.shape)} samples, expected {n_samples} "
                         f"and {(1, 400 * FLOW_HOP)}")
    # the denoiser's bias pass, the request's one vocoder batch, infer alone
    expected = 3 * per_infer
    log(f"  {name} launches: {launches[key]} of {key} (expected {expected} = "
        f"3 infers x {calls} calls x {hk.wn_launches(kw['n_layers'])} launches)")
    n = 400 * FLOW_HOP // kw["n_group"]
    rows = kw["kernel_size_h"] if model.waveflow else 1
    log(f"  {name} plan of a layer at B=1, T'={n} (infer alone): "
        f"{plan_text(hk, 1, kw['n_channels'], n, rows, kw['kernel_size'])}")
    if launches[key] != expected:
        raise SystemExit(f"chip_smoke: {key} launched {launches[key]} times, "
                         f"expected {expected}")
    return model, launches[key], mel400


def phase4b_timing(hk, check, model, name, mel):
    """infer alone (400 frames, 5 s of audio, batch 1): kernels beside plain
    versions, the parts of the kernel path, and the kernel's calls of one
    infer timed on the device beside their bound."""
    import torch
    cfg = model.cfg
    seconds = mel.shape[1] * FLOW_HOP / FLOW_SR
    gen = torch.Generator(device="cuda").manual_seed(1)
    kernel_ms = wall_ms(lambda: model.infer(mel, gen))
    with plain_kernels(hk):
        plain_ms = wall_ms(lambda: model.infer(mel, gen))
    log(f"  {name}.infer, {mel.shape[1]} frames ({seconds:.1f} s of audio), B=1: "
        f"kernels {kernel_ms:.1f} ms = {seconds * 1e3 / kernel_ms:.1f} x realtime, "
        f"plain versions {plain_ms:.1f} ms = {seconds * 1e3 / plain_ms:.1f} x realtime")

    n = mel.shape[1] * cfg.hop_length // cfg.n_group
    L, C, kw = cfg.n_layers, cfg.n_channels, cfg.kernel_size
    g = torch.Generator(device="cuda").manual_seed(9)
    with torch.no_grad():
        cond_bc = model.WN[0].cond_bc(model._cond(mel)[..., :n].contiguous())
        if model.waveflow:
            kh = cfg.kernel_size_h
            ring = model.WN[0].init_ring(1, n).normal_(generator=g)
            queues = hk.ring_queues(ring, 0).contiguous()
            x_prev = torch.randn(1, n, device="cuda", generator=g)
            calls = [(wn.kernel_weights(), h) for wn in model.WN
                     for h in range(cfg.n_group)]
            run = lambda: [hk.waveflow_row_step(x_prev, ring, h, cond_bc, *w)
                           for w, h in calls]
            run_plain = lambda: [hk.waveflow_row_step_plain(x_prev, queues, cond_bc, *w)
                                 for w, _ in calls]
            parts = [(1, n, 1, C, 2, L, kh, kw)] * len(calls)
            key = "waveflow_row_step"
            w0 = calls[0][0]
            got = hk.waveflow_row_step(x_prev, ring.clone(), 0, cond_bc, *w0)[1]
            want = hk.waveflow_row_step_plain(x_prev, queues, cond_bc, *w0)[1]
        else:
            calls = [(torch.randn(1, wn.start.in_channels, n, device="cuda",
                                  generator=g), wn.kernel_weights())
                     for wn in model.WN]
            run = lambda: [hk.waveglow_wn_forward(x, cond_bc, *w) for x, w in calls]
            run_plain = lambda: [hk.waveglow_wn_forward_plain(x, cond_bc, *w)
                                 for x, w in calls]
            parts = [(1, n, x.shape[1], C, 2 * x.shape[1], L, 1, kw) for x, _ in calls]
            key = "waveglow_wn_forward"
            x0, w0 = calls[0]
            got = hk.waveglow_wn_forward(x0, cond_bc, *w0)
            want = hk.waveglow_wn_forward_plain(x0, cond_bc, *w0)
        check(key, got, want, *TOL[key], f"main path B=1 T'={n}")
        bound = bound_of([wn_bound(*a) for a in parts])
        f32_bound = bound_of([wn_bound(*a, rate=F32_FLOPS) for a in parts])
        total, parts = flow_parts(model, mel, run)
        log(f"  {name}.infer parts (wall ms, each run alone): total {total:.1f}; "
            + "; ".join(f"{k} {v:.1f} ({v / total:.0%})" for k, v in parts.items()))
        out = dict(unit=f"the {len(calls)} WN calls of one infer, B=1, T'={n} "
                        f"({hk.wn_launches(L)} launches each)",
                   ms=time_ms(run, 2), eager_ms=eager_ms(run, 2),
                   plain_ms=time_ms(run_plain, 2), library_ms=None, bound=bound)
    log(f"  {key:17s} {out['unit']}: kernel {out['ms']:.3f} ms (eager "
        f"{out['eager_ms']:.3f} ms, {out['ms'] / len(calls):.3f} ms a call), plain "
        f"{out['plain_ms']:.3f} ms, library none, bound {bound[0]:.3f} ms ({bound[1]}, "
        f"3xTF32 tensor cores, held to; f32 CUDA cores {f32_bound[0]:.3f} ms)")
    return key, out


def phase5_flow(hk, check, model, name):
    """The whole inverse at full width on a short mel, same z: kernels
    against plain versions. The difference of one WN (1e-6) goes through
    every later flow's coupling and 1x1 inverse, hence the wider tolerance."""
    import torch
    cfg = model.cfg
    g = torch.Generator(device="cuda").manual_seed(12)
    B, T_mel = 2, 32
    n = T_mel * cfg.hop_length // cfg.n_group
    mel = torch.randn(B, T_mel, FLOW_MELS, device="cuda", generator=g)
    shape = (B, cfg.n_group, n) if model.waveflow else (B, n, cfg.n_group)
    z = 0.6 * torch.randn(shape, device="cuda", generator=g)
    got = model.inverse(z, mel)
    with plain_kernels(hk):
        want = model.inverse(z, mel)
    check("slice", got, want, 1e-3, 1e-3, f"{name} inverse B={B} T'={n}")


def phase5(hk, check, cfgs):
    """Kernel path against plain path for the whole slice, on the card."""
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

    # the decoder memory without its bottleneck: D = 1024 + 256 + 1 + 32
    del taco
    taco = Tacotron2(dataclasses.replace(tcfg, p_prenet_dropout=0.0,
                                         use_memory_bottleneck=False),
                     device="cuda")
    D = taco.decoder.memory_dim
    before = hk.LAUNCHES["attention_step"]
    k_out = taco.inference(text, lengths, spk, max_decoder_steps=32)
    launches = hk.LAUNCHES["attention_step"] - before
    with plain_kernels(hk):
        p_out = taco.inference(text, lengths, spk, max_decoder_steps=32)
    log(f"  use_memory_bottleneck=False: memory D={D}, {launches} "
        "attention_step launches in a 32-step decode")
    if launches <= 0:
        raise SystemExit("chip_smoke: the D=1313 decode never launched "
                         "attention_step")
    for key, atol in (("mel_outputs_postnet", 1e-3), ("gate_outputs", 1e-3),
                      ("alignments", 1e-4)):
        check("slice", k_out[key], p_out[key], atol, 1e-3, f"D={D} {key}")


# -- phase 6: the streaming and serving slice ----------------------------------

def decode_inputs(taco, B, T, seed):
    """Random token ids [B, T], lengths from T down to about T/2 (row 0 the
    longest), speakers alternating 0 and 1."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    text = torch.randint(1, taco.cfg.n_symbols, (B, T), device="cuda", generator=g)
    lengths = torch.tensor([T - T * i // (2 * B) for i in range(B)], device="cuda")
    return text, lengths, torch.arange(B, device="cuda") % 2


def chunk_step_ms(chunk, memory, const, state, steps, chunks, seed=7):
    """(wall ms, device ms) per decode step of ``chunks`` calls of ``chunk``
    (decode_chunk's signature) from ``state``, after a warm-up: wall on the
    host clock ending in a synchronise, device as kernel time summed by
    torch.profiler over the same calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        s, g = state, torch.Generator(device="cuda").manual_seed(seed)
        for _ in range(chunks):
            *_, s = chunk(memory, const, s, steps, g)
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    device = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA) / 1e3
    return wall / (steps * chunks), device / (steps * chunks)


def phase6_chunk(hk, check, taco, smi):
    """The decode chunk replayed as a CUDA graph against the same chunk run
    eagerly (same seed: bit for bit) and against the plain kernels; a replay
    must advance the launch counts by exactly the captured launches. Then
    decode ms per step, eager against replayed, at B=4, T_enc=64."""
    import torch
    from cookietts_tpu_torch.pipeline.chunk_graph import DecodeChunkGraphs
    B, T, S = 4, 64, 32
    memory, const, state = taco.inference_prepare(*decode_inputs(taco, B, T, 11))
    program = DecodeChunkGraphs(taco.decoder)
    seeded = lambda: torch.Generator(device="cuda").manual_seed(21)
    first = program(memory, const, state, S, seeded())        # eager, then capture
    per_replay = program.graphs[(tuple(memory.shape), S)].launches
    want = {**{k: 0 for k in hk.LAUNCHES}, "attention_step": S, "lstm_gates": 3 * S}
    before = dict(hk.LAUNCHES)
    replayed = program(memory, const, state, S, seeded())
    moved = {k: hk.LAUNCHES[k] - before[k] for k in before}
    eager = taco.decode_chunk(memory, const, state, S, seeded())
    with plain_kernels(hk):
        plain = taco.decode_chunk(memory, const, state, S, seeded())
    log(f"  chunk program B={B} T_enc={T} S={S}: {program.captures} capture, "
        f"{program.replays} replay, {program.eager_calls} eager call; the replay "
        f"launched {moved}")
    if per_replay != want or moved != want:
        raise SystemExit(f"chip_smoke: a replay must launch {want}; the capture "
                         f"recorded {per_replay}, the counters moved {moved}")
    for i, name in enumerate(("mel", "gate", "alignments")):
        same = torch.equal(replayed[i], eager[i]) and torch.equal(first[i], eager[i])
        log(f"  replayed chunk {name}: bit-identical to the eager chunk: {same}")
        if not same:
            raise SystemExit(f"chip_smoke: the replayed chunk's {name} differs "
                             "from the eager chunk's")
        check("slice", replayed[i], plain[i], (1e-3, 1e-3, 1e-4)[i], 1e-3,
              f"replayed chunk {name} vs plain kernels")

    steps, chunks = 64, 4
    memory, const, state = taco.inference_prepare(*decode_inputs(taco, B, T, 12))
    rows = {"eager": chunk_step_ms(taco.decode_chunk, memory, const, state,
                                   steps, chunks),
            "replayed": chunk_step_ms(DecodeChunkGraphs(taco.decoder), memory,
                                      const, state, steps, chunks)}
    for name, (wall, device) in rows.items():
        dev = f"{device:.4f}" if device > 0 else "not measured (no device time seen)"
        log(f"  decode B={B} T_enc={T}, {chunks} chunks of {steps} steps, {name}: "
            f"{wall:.4f} ms per step wall, {dev} ms per step on the device ({smi})")
    log(f"  lstm_gates counter set zeroed in a graph (the repair's cost, once a "
        f"replay): {graph_ms(lambda: torch.zeros(4096, dtype=torch.int32, device='cuda')):.5f} ms")
    return rows


def lstm_sets(hk, gen, B):
    """Two sets of the three full-width cells' inputs and plain outputs."""
    sets = [[lstm_inputs(B, F, H, gen) for _, F, H in LSTM_SHAPES] for _ in range(2)]
    return sets, [[hk.lstm_gates_plain(*a) for a in cells] for cells in sets]


def lstm_compare(check, got, want, what, count_only=False):
    """got: per stream (or graph), a list of rounds, each the three cells'
    (c, h); want: per stream, the cells' plain (c, h). Holds every output
    against the plain version (one check line per stream and part), or with
    ``count_only`` counts the cells that disagree."""
    import torch
    atol, rtol = TOL["lstm_gates"]
    wrong = 0
    for i, rounds in enumerate(got):
        if count_only:
            wrong += sum(not all(torch.allclose(g, w, rtol=rtol, atol=atol)
                                 for g, w in zip(cell, want[i][j]))
                         for cells in rounds for j, cell in enumerate(cells))
            continue
        for part in (0, 1):
            flat = lambda seq: torch.cat([t.flatten() for t in seq])
            check("lstm_gates",
                  flat(cells[j][part] for cells in rounds for j in range(len(cells))),
                  flat(want[i][j][part] for cells in rounds for j in range(len(cells))),
                  atol, rtol, f"{what} {i}, {len(rounds)} rounds {'ch'[part]}")
    return wrong


def lstm_two_streams(hk, check, B=4, rounds=40, shared=False):
    """The three full-width cells on two streams at once, ``rounds`` rounds,
    every output against the plain version. ``shared`` forces one counter
    set onto both streams (the fault the per-stream sets repair) and counts
    the cells that came out wrong instead of failing. Returns (wrong,
    cells)."""
    import torch
    sets, want = lstm_sets(hk, torch.Generator(device="cuda").manual_seed(31), B)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    key = hk._counter_key
    if shared:
        hk._counter_key = lambda device: ("shared", device)
    got = [[], []]
    try:
        for st in streams:
            st.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(st):
                torch.cuda._sleep(HOLD_CYCLES)    # both queues fill, then drain together
        for _ in range(rounds):
            for i, st in enumerate(streams):
                with torch.cuda.stream(st):
                    got[i].append([hk.lstm_gates(*a) for a in sets[i]])
        for st in streams:
            torch.cuda.current_stream().wait_stream(st)
        torch.cuda.synchronize()
    finally:
        hk._counter_key = key
        hk.release_tickets([k for k in hk._TICKETS if k[0] == "shared"])
    return (lstm_compare(check, got, want, "two streams: stream", count_only=shared),
            2 * rounds * len(LSTM_SHAPES))


def lstm_two_graphs(hk, check, B=4, calls=8, replays=20):
    """Two CUDA graphs, each ``calls`` rounds of the three full-width cells,
    replayed at once on two streams ``replays`` times (each capture has its
    own counters); every replay's last round against the plain version."""
    import torch
    sets, want = lstm_sets(hk, torch.Generator(device="cuda").manual_seed(32), B)
    graphs, outs = [], []
    for cells in sets:
        [hk.lstm_gates(*a) for a in cells]
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="thread_local"):
            out = [[hk.lstm_gates(*a) for a in cells] for _ in range(calls)]
        graphs.append(g)
        outs.append(out[-1])
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for st in streams:
        with torch.cuda.stream(st):
            torch.cuda._sleep(HOLD_CYCLES)
    for _ in range(replays):
        for i, (g, st) in enumerate(zip(graphs, streams)):
            with torch.cuda.stream(st):
                g.replay()
                got[i].append([tuple(t.clone() for t in ch) for ch in outs[i]])
    for st in streams:
        torch.cuda.current_stream().wait_stream(st)
    torch.cuda.synchronize()
    lstm_compare(check, got, want, "two graphs: graph")


def two_chunk_graphs(hk, taco, rounds=4, shared_stream=False):
    """Two captured decode chunks (two programs, two captures) replayed at
    once on two streams, each bit for bit as when replayed alone. With
    ``shared_stream`` both programs capture on one stream (so their graphs
    share cuBLAS's workspace) and the rounds that differ are counted
    instead of failing."""
    import torch
    from cookietts_tpu_torch.pipeline.chunk_graph import DecodeChunkGraphs
    S = 32
    progs = [DecodeChunkGraphs(taco.decoder) for _ in range(2)]
    if shared_stream:
        progs[0].stream = progs[1].stream = torch.cuda.Stream()
    inputs = [taco.inference_prepare(*decode_inputs(taco, 4, 64, seed))
              for seed in (41, 42)]
    seeded = lambda i: torch.Generator(device="cuda").manual_seed(50 + i)
    for p, args in zip(progs, inputs):
        p(*args, S, seeded(0))                      # eager, then capture
    alone = [p(*args, S, seeded(i)) for i, (p, args) in enumerate(zip(progs, inputs))]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    differ = 0
    for r in range(rounds):
        for st in streams:
            st.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(st):
                torch.cuda._sleep(HOLD_CYCLES)
        outs = []
        for i, (p, args, st) in enumerate(zip(progs, inputs, streams)):
            with torch.cuda.stream(st):
                outs.append(p(*args, S, seeded(i)))
        for st in streams:
            torch.cuda.current_stream().wait_stream(st)
        torch.cuda.synchronize()
        for i in range(2):
            if all(torch.equal(a, b) for a, b in zip(outs[i][:3], alone[i][:3])):
                continue
            differ += 1
            if not shared_stream:
                raise SystemExit(f"chip_smoke: decode chunk graph {i} replayed beside "
                                 f"another (round {r}) differs from its replay alone")
    if shared_stream:
        log(f"  two decode chunk programs captured on one stream, replayed at once: "
            f"{differ} of {2 * rounds} chunks differ from their replay alone")
        if not differ:
            raise SystemExit("chip_smoke: the shared-stream control broke nothing, "
                             "so the two graphs did not run at once")
    else:
        log(f"  two captured decode chunks (B=4, T_enc=64, {S} steps) replayed at "
            f"once on two streams, {rounds} rounds: each bit-identical to its "
            "replay alone")


def resblock_widths(hk, check, hcfg, smi):
    """Every stage runs the resblock kernel under "auto": the main path's
    four (256, 128, 64, 32) and a 384-wide generator's (192, 96, 48, 24),
    whose audio is held against the same weights on the plain path
    (pallas_resblocks=False) with its exact launch count. The kernel at
    C = 192, 96, 48, 24 and 6 (weights in 4-byte copies) against its plain
    version; True raises at construction for an even kernel size."""
    import torch
    from cookietts_tpu_torch.models.hifigan import Generator
    main = Generator(hcfg, device="cuda").kernel_stages()
    log(f"  main path HiFi-GAN stages (C, kernel): {main}")
    if main != ((256, True), (128, True), (64, True), (32, True)):
        raise SystemExit("chip_smoke: the main path's HiFi-GAN stages must all "
                         "run the resblock kernel")
    wide = dataclasses.replace(hcfg, upsample_initial_channel=384)
    torch.manual_seed(3)
    gen = Generator(wide, device="cuda")
    plain = Generator(dataclasses.replace(wide, pallas_resblocks=False), device="cuda")
    plain.load_state_dict(gen.state_dict())
    mel = torch.randn(2, 32, 80, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(4)) - 4
    before = hk.LAUNCHES["hifigan_resblock"]
    audio = gen(mel)
    torch.cuda.synchronize()
    n = hk.LAUNCHES["hifigan_resblock"] - before
    log(f"  upsample_initial_channel=384, \"auto\": stages {gen.kernel_stages()}, "
        f"{n} resblock launches (expected {vocoder_launches(hk, gen, 1)})")
    if n != vocoder_launches(hk, gen, 1) or n == 0 \
            or not all(k for _, k in gen.kernel_stages()):
        raise SystemExit("chip_smoke: the 384-wide generator must run the "
                         "resblock kernel at every stage")
    check("slice", audio, plain(mel), 1e-3, 1e-3, "384-wide HiFi-GAN audio")
    T, g = 512, torch.Generator(device="cuda").manual_seed(8)
    n_k = len(wide.resblock_kernel_sizes)
    for i, u in enumerate(wide.upsample_rates):
        T *= u
        C = wide.upsample_initial_channel // 2 ** (i + 1)
        x = torch.randn(3, C, T, device="cuda", generator=g)
        rbs = gen.resblocks[i * n_k:(i + 1) * n_k]
        stage = [(x, *rb.kernel_weights(), rb.dilations, rb.slope) for rb in rbs]
        bound = bound_of([resblock_bound(3, C, T, rb.convs1[0].kernel_size[0],
                                         len(rb.dilations)) for rb in rbs])
        log(f"    384-wide stage C={C} T={T} B=3 ({n_k} resblocks, split "
            f"{hk.resblock_split_rows(C)} rows): kernel "
            f"{time_ms(lambda: [hk.hifigan_resblock(*a) for a in stage], 3):.4f} ms, "
            f"plain {time_ms(lambda: [hk.hifigan_resblock_plain(*a) for a in stage], 3):.4f}"
            f" ms, 3xTF32 bound {bound[0]:.4f} ms ({smi})")
        del x, stage
    for C in (192, 96, 48, 24, 6):
        for k in (3, 7, 11):
            args = resblock_inputs(1, C, 4096 + 7, k,
                                   torch.Generator(device="cuda").manual_seed(C + k))
            check("hifigan_resblock", hk.hifigan_resblock(*args, (1, 3, 5), 0.1),
                  hk.hifigan_resblock_plain(*args, (1, 3, 5), 0.1),
                  *TOL["hifigan_resblock"], f"C={C} k={k} T=4103 split "
                  f"{hk.resblock_split_rows(C)} rows")
    try:
        Generator(dataclasses.replace(wide, pallas_resblocks=True,
                                      resblock_kernel_sizes=(3, 4, 11)), device="cuda")
    except ValueError as e:
        log(f"  pallas_resblocks=True with kernel size 4: raises ({e})")
    else:
        raise SystemExit("chip_smoke: pallas_resblocks=True must raise for an "
                         "even kernel size")


def chunk_graph_cache_bound(hk, taco):
    """A chunk program that keeps 2 graphs, fed batch sizes 1, 2, 3 and 1
    again (a server meeting new batch sizes): it keeps at most 2, releases
    the least recently used with its lstm_gates counters, and what it
    captures again replays as the eager chunk does."""
    import torch
    from cookietts_tpu_torch.pipeline.chunk_graph import DecodeChunkGraphs
    S = 8
    prog = DecodeChunkGraphs(taco.decoder, max_graphs=2)
    inputs = {B: taco.inference_prepare(*decode_inputs(taco, B, 64, 70 + B))
              for B in (1, 2, 3)}
    seeded = lambda: torch.Generator(device="cuda").manual_seed(9)
    held = lambda: len([k for k in hk._TICKETS if k[0] == "capture"])
    n, sets = held(), []
    for B in (1, 2, 3, 1, 1):
        prog(*inputs[B], S, seeded())
        sets.append(held() - n)
        if len(prog.graphs) > 2:
            raise SystemExit("chip_smoke: the chunk program kept more graphs "
                             "than its bound")
    eager = taco.decode_chunk(*inputs[1], S, seeded())
    replayed = prog(*inputs[1], S, seeded())
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(replayed[:3], eager[:3]))
    log(f"  chunk program bounded to 2 graphs, batch sizes 1, 2, 3, 1: "
        f"{prog.captures} captures, {prog.releases} releases, {prog.replays} "
        f"replays, capture counter sets held after each call {sets}; replay after re-capture "
        f"bit-identical to eager: {same}")
    if (prog.captures, prog.releases, prog.replays) != (4, 2, 2) or not same \
            or sets != [1, 2, 2, 2, 2]:
        raise SystemExit("chip_smoke: the bounded chunk program did not release, "
                         "re-capture and replay as expected")


def vocoder_launches(hk, gen, calls):
    """Resblock kernel launches of ``calls`` generator calls."""
    return calls * sum(hk.hifigan_resblock_launches(rb.convs1[0].in_channels,
                                                    len(rb.dilations))
                       for rb in gen.resblocks if rb.use_kernel)


def phase6_stream(hk, check, taco, gen, B, smi, steps=256):
    """streaming_tts at a fixed decode length (gate threshold 2.0: the gate
    never stops it) against the whole pipeline run on the card with the same
    generator seed. Counters zeroed before the warm stream, read after; the
    decode kernels must show one launch per step (attention) and three
    (lstm), the resblock kernel its launches per vocoder call."""
    import numpy as np
    import torch
    from cookietts_tpu_torch.pipeline.streaming import make_streaming_fns, streaming_tts
    text, lengths, spk = decode_inputs(taco, B, 64, 60 + B)
    fns = make_streaming_fns(taco)
    calls = [0]

    def vocoder(mel):
        calls[0] += 1
        return gen(mel)

    kw = dict(text=text, text_lengths=lengths, speaker_id=spk,
              max_decoder_steps=steps, decode_chunk_steps=32, vocoder_halo=32,
              hop_length=HOP, gate_threshold=2.0, gate_delay=10, fns=fns)

    def stream():
        t0 = time.perf_counter()
        pieces, first = [], None
        for _, piece in streaming_tts(
                taco, vocoder, generator=torch.Generator(device="cuda").manual_seed(5),
                **kw):
            first = first or time.perf_counter() - t0
            pieces.append(piece)
        return np.concatenate(pieces, axis=1), first, time.perf_counter() - t0

    _, cold_first, cold_total = stream()            # captures the chunk
    hk.reset_launch_counts()
    calls[0] = 0
    replays = fns[1].replays
    audio, first, total = stream()
    torch.cuda.synchronize()
    launches = {k: hk.LAUNCHES[k] for k in ("attention_step", "lstm_gates",
                                            "hifigan_resblock")}
    want = {"attention_step": steps, "lstm_gates": 3 * steps,
            "hifigan_resblock": vocoder_launches(hk, gen, calls[0])}
    seconds = audio.shape[1] / SR
    log(f"  streaming_tts B={B}, {steps} steps ({seconds:.2f} s of audio a row): "
        f"time to first audio {first * 1e3:.1f} ms, request {total * 1e3:.1f} ms "
        f"({seconds / total:.2f} x realtime a row); cold (captures the chunk): "
        f"{cold_first * 1e3:.1f} and {cold_total * 1e3:.1f} ms; {fns[1].replays - replays} "
        f"replays, {fns[1].captures} capture, {fns[1].eager_calls} eager chunk; "
        f"{calls[0]} vocoder calls ({smi})")
    log(f"  streaming launches {launches} (expected {want})")
    if launches != want:
        raise SystemExit("chip_smoke: the streaming path's launch counts are "
                         f"{launches}, expected {want}")

    whole = taco.inference(text, lengths, spk, max_decoder_steps=steps,
                           generator=torch.Generator(device="cuda").manual_seed(5))
    ref = gen(whole["mel_outputs_postnet"]).cpu()
    tail = 2 * taco.cfg.postnet_n_convolutions * HOP
    got = torch.from_numpy(audio)
    if got.shape != ref.shape:
        raise SystemExit(f"chip_smoke: streamed audio {tuple(got.shape)}, whole "
                         f"{tuple(ref.shape)}")
    check("slice", got[:, :-tail], ref[:, :-tail], 1e-4, 0.0,
          f"streamed audio B={B} vs whole, tail cut")
    log(f"    with the last {tail // HOP} frames too: max abs "
        f"{float((got - ref).abs().max()):.3e}")
    return dict(first_ms=first * 1e3, total_ms=total * 1e3, cold_first_ms=cold_first * 1e3,
                replays=fns[1].replays, captures=fns[1].captures)


def phase6_server(taco, gen, smi):
    """handle_tts (the /tts handler's body; no tornado on this machine) twice
    on a ModelRegistry: the reference field names, then the aliases. Each
    must give a RIFF WAV at 44.1 kHz of the stated length and the stats."""
    import io
    import tempfile
    import wave
    from cookietts_tpu_torch.pipeline.server import ModelRegistry, handle_tts
    from cookietts_tpu_torch.pipeline.text2speech import T2S, T2SConfig
    t2s = T2S(T2SConfig(max_decoder_steps=512, step_buckets=(256, 512)), taco,
              {"alice": 0, "bob": 1}, vocoder_fn=gen, sample_rate=SR, hop_length=HOP,
              device="cuda")
    registry = ModelRegistry({"main": t2s, "again": lambda: t2s}, "again")
    spellings = {
        "reference": {"input_text": 'Hello there. "A quote," she said.',
                      "input_speaker": "alice,bob", "input_multispeaker_mode": "quotes",
                      "input_batch_size": "4", "input_max_attempts": "1",
                      "input_target_score": "0.1", "input_ttm_current": "main"},
        "aliases": {"text": "The quick brown fox jumps over the lazy dog.",
                    "speaker": "bob", "batch_size": 4, "max_attempts": 1,
                    "target_score": 0.1, "model": "main", "gate_delay": 10},
    }
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as out:
        for name, fields in spellings.items():
            t0 = time.perf_counter()
            stats, wav = handle_tts(registry, fields.get, out, "alice")
            seconds = time.perf_counter() - t0
            with wave.open(io.BytesIO(wav)) as w:
                rate, n = w.getframerate(), w.getnframes()
            missing = [k for k in ("segments", "speakers", "scores", "attempts",
                                   "failure_rate", "audio_seconds", "total_time",
                                   "xrt", "model", "voice") if k not in stats]
            log(f"  handle_tts ({name} field names): {len(wav)} bytes, {rate} Hz, "
                f"{n} samples, segments {stats['segments']}, model {stats['model']}, "
                f"{seconds:.3f} s ({smi})")
            if wav[:4] != b"RIFF" or rate != SR or n != round(stats["audio_seconds"] * SR) \
                    or n == 0 or missing or stats["model"] != "main":
                raise SystemExit(f"chip_smoke: handle_tts ({name}) gave a bad WAV or "
                                 f"stats (missing {missing})")


def failed_capture_raises(hk):
    """A chunk that reads a value back to the host cannot be captured: the
    program must raise, keep no graph and leave the launch counts as they
    were, and the card must go on working."""
    import torch
    from cookietts_tpu_torch.pipeline.chunk_graph import DecodeChunkGraphs

    class HostSync:
        def decode_chunk(self, memory, const, state, steps, generator=None):
            return memory * float(memory.sum()), state

    program = DecodeChunkGraphs(HostSync())
    x = torch.ones(2, 3, 4, device="cuda")
    before = dict(hk.LAUNCHES)
    try:
        program(x, {}, (x,), 1)
    except RuntimeError as e:
        log(f"  a chunk that syncs with the host: the capture raises "
            f"({str(e).splitlines()[0][:100]})")
    else:
        raise SystemExit("chip_smoke: a failed capture must raise")
    torch.cuda.synchronize()
    torch.randn(4, device="cuda")              # the default generator still draws
    if program.graphs or hk.LAUNCHES != before or float((x + 1).sum()) != 48.0:
        raise SystemExit("chip_smoke: a failed capture left a graph, moved the "
                         "launch counts or broke the card")


def phase6(hk, check, tcfg, hcfg, smi):
    import torch
    from cookietts_tpu_torch.models.hifigan import Generator
    from cookietts_tpu_torch.models.tacotron2 import Tacotron2
    torch.manual_seed(0)
    taco = Tacotron2(tcfg, device="cuda")
    gen = Generator(hcfg, device="cuda")
    out = {"chunk": phase6_chunk(hk, check, taco, smi)}
    for B in (1, 4):
        out[f"stream_B{B}"] = phase6_stream(hk, check, taco, gen, B, smi)
    phase6_server(taco, gen, smi)
    lstm_two_streams(hk, check)
    wrong, total = lstm_two_streams(hk, check, shared=True)
    log(f"  lstm_gates on two streams forced onto one counter set (the repaired "
        f"fault): {wrong} of {total} cells wrong")
    if not wrong:
        raise SystemExit("chip_smoke: the shared-counter control broke nothing, "
                         "so the two streams did not run at once")
    lstm_two_graphs(hk, check)
    two_chunk_graphs(hk, taco)
    two_chunk_graphs(hk, taco, shared_stream=True)
    chunk_graph_cache_bound(hk, taco)
    resblock_widths(hk, check, hcfg, smi)
    failed_capture_raises(hk)
    return out


# -- phase 7: the training slice ----------------------------------------------

# the evidence corpus' audio front end, its one mel bucket and TBPTT segment
TRAIN_HPARAMS = ("sampling_rate=22050,filter_length=1024,hop_length=256,"
                 "win_length=1024,mel_fmax=8000.0,trim_enable=False,"
                 "n_mel_channels=80,mel_buckets=[144],max_segment_frames=144,"
                 "batch_size=16,validation_interval=3,checkpoint_interval=3,"
                 "log_every=1")
TRAIN_B, TRAIN_TXT, TRAIN_DEC = 16, 64, 800      # one TBPTT segment


def train_events(run):
    """([(step, train loss, s of the iteration)], [validation loss]) from the
    run's events, in the order they were written."""
    train, val = [], []
    for line in (run / "events.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if rec["prefix"] == "train":
            train.append((rec["step"], rec["loss"], rec["iter_s"]))
        elif rec["prefix"] == "validation":
            val.append(rec["val_loss"])
    return train, val


def expected_launches(trainer, iters, validations):
    """attention_step launches of ``iters`` iterations (one per decoder
    step of the 144-wide bucket) and ``validations`` validations (the
    teacher-forced pass and the free-running decode, each one a step, over
    every validation batch)."""
    vb = trainer.val_batches
    return iters * 144 + validations * 2 * len(vb) * vb.pad[1]


def phase7_cli(hk, tmp):
    """The port's train command on the evidence corpus at full width: 6
    iterations with validation and a checkpoint every 3, then a resume to
    8. Every loss finite, the checkpoints there, the resume at step 6, the
    kernels launched once per decoder step (lstm_gates: 3 cells)."""
    import torch
    from cookietts_tpu_torch.cli import main as cli
    from cookietts_tpu_torch.data.evidence_corpus import make_corpus
    train_fl, _ = make_corpus(str(tmp / "corpus"), seed=0, n_train=32,
                              n_val=16)
    run = tmp / "run"
    args = ["train", "--model", "tacotron2", "--filelist", train_fl,
            "--run_dir", str(run), "--hparams", TRAIN_HPARAMS, "--seed", "0"]
    for iters, resume, validations in ((6, [], 2), (8, ["--resume"], 0)):
        hk.reset_launch_counts()
        t0 = time.perf_counter()
        trainer = cli(args + ["--iters", str(iters)] + resume)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = dict(hk.LAUNCHES)
        done = iters - (6 if resume else 0)
        want = expected_launches(trainer, done, validations)
        log(f"  train {'--resume ' if resume else ''}to {iters}: {dt:.1f} s "
            f"(data and validation included); launches attention_step "
            f"{n['attention_step']} (want {want}), lstm_gates "
            f"{n['lstm_gates']} (want {3 * want})")
        if (n["attention_step"], n["lstm_gates"]) != (want, 3 * want):
            raise SystemExit("chip_smoke: the train command's kernel "
                             "launches are not one per decoder step")
        if int(trainer.state.step) != iters:
            raise SystemExit(f"chip_smoke: trained to {trainer.state.step}, "
                             f"not {iters}")
    # one record an iteration: steps 0-5, then 6 and 7 after the resume
    train, val = train_events(run)
    log(f"  losses by step {[(k, round(v, 4)) for k, v, _ in train]}; "
        f"validation {[round(v, 4) for v in val]}; s per iteration "
        f"(data to the card included) {[round(t, 3) for _, _, t in train]}")
    if [k for k, _, _ in train] != list(range(8)) or len(val) != 2 or not all(
            math.isfinite(v) for v in [v for _, v, _ in train] + val):
        raise SystemExit("chip_smoke: a training or validation loss is "
                         "missing or not finite, or the resume did not "
                         "start at step 6")
    files = sorted(p.name for p in run.iterdir())
    for name in ("checkpoint_3", "checkpoint_6", "checkpoint_8",
                 "best_val_model", "best_inf_attsc"):
        if name not in files:
            raise SystemExit(f"chip_smoke: {name} missing from {files}")
    log(f"  checkpoints {[f for f in files if not f.endswith('.json')]}")


def synthetic_batch(cfg, seed, B=TRAIN_B, T_txt=TRAIN_TXT, T_dec=TRAIN_DEC):
    """A seeded full-width training batch on the card: lengths up to the
    padded widths (one row full), smooth log-mel-like targets, gate targets
    from each row's last frame, the batch's frame mean for drop-frame."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    text_len = torch.randint(T_txt // 2, T_txt + 1, (B,), device=dev, generator=g)
    mel_len = torch.randint(3 * T_dec // 4, T_dec + 1, (B,), device=dev,
                            generator=g)
    text_len[0], mel_len[0] = T_txt, T_dec
    text = torch.randint(1, cfg.n_symbols, (B, T_txt), device=dev, generator=g)
    text = text * (torch.arange(T_txt, device=dev) < text_len[:, None])
    base = torch.randn(B, T_dec // 16 + 1, cfg.n_mel_channels, device=dev,
                       generator=g)
    mels = torch.nn.functional.interpolate(
        base.transpose(1, 2), size=T_dec, mode="linear").transpose(1, 2)
    valid = torch.arange(T_dec, device=dev)[None, :] < mel_len[:, None]
    mels = (mels * 2.0 - 6.0) * valid[:, :, None]
    gate = (torch.arange(T_dec, device=dev)[None, :]
            >= mel_len[:, None] - 1).float()
    return {"text": text, "text_lengths": text_len, "mels": mels.contiguous(),
            "mel_lengths": mel_len, "gate_target": gate,
            "speaker_id": torch.randint(0, cfg.n_speakers, (B,), device=dev,
                                        generator=g),
            "sylps": 3.0 + 3.0 * torch.rand(B, device=dev, generator=g),
            "pres_prev_state": torch.zeros(B, device=dev),
            "global_mean": (mels.sum((0, 1)) / valid.sum()).contiguous()}


def timed_train_step(model, state, batch, ctrl, seed):
    """One train step as make_tacotron2_train_step runs it (forward in
    training mode, loss, backward, clipping, Adam), timed in parts on the
    host's clock with a synchronize after each. Returns (loss, clipped-
    before gradients by name, ms forward, ms backward, ms update)."""
    import torch
    from cookietts_tpu_torch.losses import DEFAULT_LOSS_SCALARS, tacotron2_loss
    from cookietts_tpu_torch.runtime.optim import clip_by_global_norm
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model.train()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _ = model(
        batch["text"], batch["text_lengths"], batch["mels"],
        batch["mel_lengths"], batch["speaker_id"], batch["sylps"],
        generator=gen, p_teacher_forcing=ctrl["p_teacher_forcing"],
        teacher_force_till=ctrl["teacher_force_till"],
        drop_frame_rate=ctrl["drop_frame_rate"],
        global_mean=batch["global_mean"])
    total, _, _ = tacotron2_loss(
        out, {k: batch[k] for k in ("mels", "mel_lengths", "text_lengths",
                                    "sylps", "gate_target",
                                    "pres_prev_state")},
        {k: ctrl[k] for k in DEFAULT_LOSS_SCALARS}, 10.0,
        ctrl["guided_att_sigma"])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    params = state.params
    grads = dict(zip(params, torch.autograd.grad(
        total, list(params.values()), allow_unused=True)))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    clipped, _ = clip_by_global_norm(grads, ctrl["grad_clip"])
    state.apply_gradients(clipped, ctrl["lr"])
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return (total.item(), grads, 1e3 * (t1 - t0), 1e3 * (t2 - t1),
            1e3 * (t3 - t2))


def rel_l2(a, b):
    return float((a - b).norm() / b.norm()) if float(b.norm()) else float(a.norm())


def phase7_step(hk, tcfg, smi):
    """One full-width train step at B=16, T_txt=64, T_dec=800 with the
    kernels and with the plain versions from the same weights and
    generator seed: loss, every gradient and the updated parameters
    against each other, each timed with its peak memory; then the kernel
    path once more, warm, under torch.profiler (CUDA activity only): its
    time and device-busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from cookietts_tpu_torch.losses import DEFAULT_LOSS_SCALARS
    from cookietts_tpu_torch.models.tacotron2 import Tacotron2
    from cookietts_tpu_torch.runtime.live_config import LiveConfig
    from cookietts_tpu_torch.runtime.optim import adam
    from cookietts_tpu_torch.runtime.train_state import TrainState
    torch.manual_seed(3)
    model = Tacotron2(tcfg, device="cuda")
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batch = synthetic_batch(tcfg, seed=5)
    live = LiveConfig(None)
    ctrl = {"lr": 1e-3, "grad_clip": 1.0, "p_teacher_forcing": 1.0,
            "teacher_force_till": 20,
            "drop_frame_rate": float(live.get("drop_frame_rate")),
            "guided_att_sigma": 0.5, **DEFAULT_LOSS_SCALARS}
    runs, times = {}, {"kernels": [], "plain": []}

    def run(path, keep, prof=None):
        model.load_state_dict(init)
        state = TrainState.create(model, adam())
        hk.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        ctx = plain_kernels(hk) if path == "plain" else (
            prof or contextlib.nullcontext())
        with ctx:
            loss, grads, fwd, bwd, upd = timed_train_step(model, state, batch,
                                                          ctrl, seed=11)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n = dict(hk.LAUNCHES)
        times[path].append((fwd, bwd, upd, peak))
        if keep:
            runs[path] = (loss, {k: v.clone() for k, v in grads.items()
                                 if v is not None},
                          {k: v.detach().clone()
                           for k, v in model.state_dict().items()}, n)
        del grads, state

    for path in ("kernels", "plain"):
        run(path, keep=True)
    lk, gk, pk, nk = runs["kernels"]
    lp, gp, pp, np_ = runs["plain"]
    steps = TRAIN_DEC // tcfg.n_frames_per_step
    log(f"  launches of the kernel-path step: attention_step "
        f"{nk['attention_step']}, lstm_gates {nk['lstm_gates']} (want "
        f"{steps}, {3 * steps}); plain path {np_['attention_step']}, "
        f"{np_['lstm_gates']}")
    if (nk["attention_step"], nk["lstm_gates"]) != (steps, 3 * steps) or any(
            np_[k] for k in ("attention_step", "lstm_gates")):
        raise SystemExit("chip_smoke: train step launch counts")
    loss_rel = abs(lk - lp) / abs(lp)
    if set(gk) != set(gp):
        raise SystemExit("chip_smoke: the two paths give gradients to "
                         "different parameters")
    g_all = math.sqrt(sum(float(g.norm()) ** 2 for g in gp.values()))
    worst, tiny = [], []
    for k in gp:
        r = rel_l2(gk[k], gp[k])
        # a conv bias ahead of a training-mode BatchNorm has a zero
        # gradient; its computed one is rounding noise on both paths
        if float(gp[k].norm()) < 1e-6 * g_all:
            tiny.append(k)
            r = float((gk[k] - gp[k]).norm()) / g_all
        worst.append((r, k))
    worst.sort(reverse=True)
    # after one Adam step: a numerically-zero gradient's rounding noise
    # becomes a step of up to lr of either sign (g / (|g| + eps)), so those
    # parameters are held to 2 lr; every other entry to relative L2 1e-4
    p_rel = max((rel_l2(pk[k].float(), pp[k].float()), k) for k in pk
                if pk[k].is_floating_point() and k not in tiny)
    p_tiny = max(float((pk[k] - pp[k]).abs().max()) for k in tiny)
    log(f"  loss kernels {lk:.7f} plain {lp:.7f} rel {loss_rel:.2e} "
        f"(limit 1e-5); {len(gp)} gradients, largest relative L2 "
        f"{', '.join(f'{k} {r:.2e}' for r, k in worst[:4])} (limit 1e-4; "
        f"{len(tiny)} numerically zero, held to the whole gradient's norm: "
        f"{tiny}); parameters and statistics after the update: largest "
        f"relative L2 {p_rel[1]} {p_rel[0]:.2e} (limit 1e-4), of the "
        f"numerically zero ones max abs {p_tiny:.2e} (limit {2 * ctrl['lr']:g})")
    if not (loss_rel <= 1e-5 and worst[0][0] <= 1e-4 and p_rel[0] <= 1e-4
            and p_tiny <= 2 * ctrl["lr"] and math.isfinite(lk)):
        raise SystemExit("chip_smoke: the kernel-path train step disagrees "
                         "with the plain path")
    del runs
    prof = profile(activities=[ProfilerActivity.CUDA])
    run("kernels", keep=False, prof=prof)
    for path, ts in times.items():
        for i, (fwd, bwd, upd, peak) in enumerate(ts):
            what = "first" if i == 0 else "warm, profiled"
            log(f"  train step {path:7s} ({what}) B={TRAIN_B} T_dec="
                f"{TRAIN_DEC}: {(fwd + bwd + upd) / 1e3:.3f} s/iter (forward "
                f"{fwd:.1f} ms, backward {bwd:.1f} ms, clip+Adam {upd:.1f} "
                f"ms), peak {peak:.2f} GiB")
    # the raw kineto events: key_averages() over the step's ~10^5 kernel
    # records takes tens of seconds
    t0 = time.perf_counter()
    device_ms = sum(e.duration_ns() for e in
                    prof.profiler.kineto_results.events()
                    if e.device_type() == DeviceType.CUDA) / 1e6
    walls = [sum(t[:3]) for t in times["kernels"]]
    log(f"  device busy {device_ms:.1f} ms of a kernel-path step: "
        f"{device_ms / walls[1]:.3f} of the profiled step's {walls[1]:.1f} "
        f"ms, {device_ms / walls[0]:.3f} of the unprofiled first step's "
        f"{walls[0]:.1f} ms (profile read in {time.perf_counter() - t0:.1f} s)")
    return times, device_ms / walls[1]


def phase7_kernels(hk, check, smi):
    """The two training kernels at the train step's shapes (B=16, T_enc=64,
    the three decoder cells): forward against the plain version, each
    timed, and the backward (autograd of the plain version) timed eagerly."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(17)
    out = {}
    args = attention_inputs(TRAIN_B, TRAIN_TXT, gen)
    flat = lambda out: torch.cat([t.flatten() for t in out])  # noqa: E731
    check("attention_step", flat(hk.attention_step(*args)),
          flat(hk.attention_step_plain(*args)), *TOL["attention_step"],
          f"train B={TRAIN_B} T={TRAIN_TXT}")
    g = [torch.randn_like(t) for t in hk.attention_step_plain(*args)]
    out["attention_step"] = (
        time_ms(lambda: hk.attention_step(*args), 200),
        time_ms(lambda: hk.attention_step_plain(*args), 200),
        eager_ms(lambda: hk.attention_step_vjp(*args, None, *g), 50),
        bound_of([attention_bound(TRAIN_B, TRAIN_TXT)]))
    for name, F_, H in LSTM_SHAPES:
        a = lstm_inputs(TRAIN_B, F_, H, gen)
        check("lstm_gates", flat(hk.lstm_gates(*a)),
              flat(hk.lstm_gates_plain(*a)), *TOL["lstm_gates"],
              f"train {name} B={TRAIN_B}")
        g = [torch.randn_like(t) for t in hk.lstm_gates_plain(*a)]
        out[name] = (time_ms(lambda: hk.lstm_gates(*a), 200),
                     time_ms(lambda: hk.lstm_gates_plain(*a), 200),
                     eager_ms(lambda: hk.lstm_gates_vjp(*a, *g), 50),
                     bound_of([lstm_bound(TRAIN_B, F_, H)]))
    for name, (k, p, b, (bound, by)) in out.items():
        log(f"  {name:18s} B={TRAIN_B} forward kernel {k:.4f} ms, plain "
            f"{p:.4f} ms, bound {bound:.5f} ms ({by}); backward (autograd "
            f"of plain, eager) {b:.4f} ms")
    return out


def phase7(hk, check, tcfg, smi):
    import tempfile
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t0 = time.perf_counter()
        phase7_cli(hk, Path(tmp))
        log(f"  phase 7a in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase7_kernels(hk, check, smi)
    phase7_step(hk, tcfg, smi)
    log(f"  phase 7b-c in {time.perf_counter() - t0:.1f} s; {smi}")


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
        for kernel, report in ptxas_report(logf.read_text()):
            log(f"  {logf.stem}: {kernel}: {report}")

    check = Check()
    log("phase 3: kernels against their plain versions (full width)")
    phase3(hk, check)
    phase3_flow(hk, check)

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

    del t2s, gen
    log("phase 4b: the flow vocoders behind T2S, full width")
    torch.manual_seed(1)
    taco160 = Tacotron2(dataclasses.replace(tcfg, n_mel_channels=FLOW_MELS),
                        device="cuda")
    flows = []
    for name, kw in (("WaveGlow", WAVEGLOW), ("WaveFlow", WAVEFLOW)):
        model, n_launches, mel400 = phase4b(hk, check, taco160, name, kw)
        key, timing[key] = phase4b_timing(hk, check, model, name, mel400)
        launches[key] = n_launches
        flows.append((name, model))
    del taco160

    log("phase 5: whole slice, kernels against plain versions")
    phase5(hk, check, (tcfg, hcfg))
    for name, model in flows:
        phase5_flow(hk, check, model, name)
    del flows, model

    log("phase 6: the streaming and serving slice, full width")
    phase6(hk, check, tcfg, hcfg, smi)

    log("phase 7: the training slice, full width")
    phase7(hk, check, tcfg, smi)

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

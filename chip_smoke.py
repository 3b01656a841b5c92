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
   the main path's (each with the tiles wn_layer_plan picks), and at the
   widths C = 512 (the reference WaveFlow's), 384, 96, 48 and 50 (past C
   the kernels stage zeros) at batch 1 and a request's length, each call
   making the launches wn_launches predicts. Every kernel is a
   torch.library custom op (torch.ops.cookietts_tpu_torch.*).
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
8. vocoder training at full width, through the port's train command on
   seeded synthetic WAVs, each run 4 iterations with validation and a
   checkpoint every 2, then --resume to 6 (every loss finite, the
   checkpoints there, the resume at step 4, exact launch counts: training
   launches no kernel). 8a: HiFi-GAN at HiFiGANConfig() (MPD periods 2, 3,
   5, 7, 11; MSD 3 scales) on HiFi-GAN V1's recipe (22050 Hz, hop 256, 80
   mels, 8192-sample segments, batch 16); checkpoints hold G and D; the D
   and G steps timed, peak memory, the device-busy share. 8b: WaveGlow at
   WaveGlowConfig() (12 flows x 8 layers x 256 channels) and WaveFlow at
   phase 4b's configuration, 48 kHz, 24000-sample segments, batch 4: each
   validation batch launches waveglow_wn_forward 216 or waveflow_row_step
   864 times, validation from the trained weights and one z against the
   plain versions; the step timed with memory_efficient on and off. 8c:
   one step of each trainer on the card against the CPU from the same
   weights and batch (losses within rel 1e-4; every gradient within
   relative L2 1e-3, or, for a gradient ill-conditioned in its input, 10
   times what a relative 1e-6 nudge of the audio moves it on the CPU),
   and 8a's generator checkpoint served through hifigan_resblock
   (launches counted) against the plain path and the training form.
9. serving checkpoints through the port's own commands, at full width:
   seeded checkpoints with their sidecars (Tacotron2Config() with use_gst
   and use_emotionnet, at 80 and at 160 mels; phase 4's HiFi-GAN; phase
   4b's WaveGlow; the full torchMoji, 50000 x 256 and 2 x BiLSTM 512), a
   vocabulary of the specials and 5000 words, an ARPA dictionary and a
   speaker_info.txt. 9a: `python -m cookietts_tpu_torch tts` as a process,
   default device, with --torchmoji, --arpa_dict and --speaker_info (gate
   threshold 2, one 128-step bucket, one attempt: a fixed decode length);
   the WAV's length, the stats line, the process's cold wall time. 9b: the
   same with the WaveGlow behind the 160-mel Tacotron2 and --denoiser,
   through the command's entry point (cli.main) in this process. 9c:
   the server's worker from _build_t2s, three requests through handle_tts
   (style_mode torchmoji and none, both field spellings), warm latency and
   peak memory; the torchmoji and none mels must differ, and the same
   requests through the plain versions must give the same mels and audio
   (phase 5's tolerance). 9d: TorchMojiEncoder on the card against the CPU
   (1e-5 relative), ms per segment and its share of a request. 9e: each
   run's launches must equal the decode steps (attention_step 1 and
   lstm_gates 3 a step) and the vocoder calls (resblock launches of a
   generator call; 18 waveglow_wn_forward launches a flow of the vocode;
   the tts command counts from the request on, after the worker and its
   denoiser are built).
10. the other attention types, training with the style heads, and the
   convert command, at full width. 10a: Tacotron2Config(attention_type=1,
   num_att_mixtures=5) (GMM) and Tacotron2Config(attention_type=2) (DCA,
   128 filters of 21) behind phase 4's HiFi-GAN, gate threshold 2 (a fixed
   128-step decode): one T2S request each, launch counters zeroed before
   and read after (attention_step exactly 0 times: GMM and DCA are plain
   PyTorch; lstm_gates 3 a step; the resblock its launches a vocoder call);
   the decode chunk replayed as a CUDA graph against the eager chunk (bit
   for bit, every state leaf, GMM's means included) and against the plain
   kernels (phase 5's tolerance); one streaming_tts request each (phase 6's
   checks). 10b: one train step with use_gst and use_emotionnet at B=16,
   T_txt=64, T_dec=200 (phase 7's 800 cut to hold the script's time), with
   a quarter of the emotion ids unknown: kernels against the plain versions
   (loss rel 1e-5, every gradient relative L2 1e-4), then the card against
   the CPU with nothing drawn (dropouts 0, no postnet, the eps given; 1e-4);
   the train command with both heads on phase 7a's corpus, emotion ids on
   half of its lines, 2 iterations then a resume to 3 (launches counted).
   10c: the convert command (its entry point, cli.main, in this process) on
   reference-layout .pt files of phase 9's seeded weights (Tacotron2 with
   both heads, HiFi-GAN, torchMoji) and of a WaveGlow at phase 4b's widths
   in the reference layout: each converted state dict equals its source bit
   for bit; the converted Tacotron2 and HiFi-GAN served through _build_t2s
   give phase 9's checkpoints' mels and audio exactly.
11. serving exported artifacts (runtime/export_serving.py: torch.export
   programs calling the kernels' custom ops). 11a: the export command (its
   entry point, cli.main, in this process) on phase 9's seeded Tacotron2
   (GST and EmotionNet) and HiFi-GAN (B=4, one text bucket of 64, 128 steps,
   gate threshold 2), its wall time and bytes; then `tts --artifact` the
   same way with phase 9a's flags: the WAV's length, the stats line, exact
   launches, its wall time. 11b: three
   requests through _build_t2s(--artifact)'s worker, launch counters zeroed
   just before (attention_step 1 and lstm_gates 3 a decode step, the
   resblock its launches a vocoder call), mels and audio against the live
   --checkpoint worker at the same seeds (phase 5's tolerance), a warm
   request's ms of each, the artifact's chunk captures and replays. 11c:
   phase 4b's WaveGlow (ISO 226 de-emphasis off, then on) and WaveFlow
   exported as vocoder artifacts: each vocode against the live
   WaveGlow.infer at the same z, exact WN launches, the copies of the ring
   (auto_functionalized nodes) in the WaveFlow program, vocode ms against
   the live infer's.
12. the GTA stage and its two adversarial trainers, at full width. 12a: a
   seeded Tacotron2Config() checkpoint; the gta command (its entry point,
   cli.main, in this process) on a 12-utterance evidence corpus (22050 Hz, 80 mels, the
   data config's buckets) at batch 8, so the last batch is short: one map
   line an utterance, finite [T, 80] mels whose letter durations sum to T,
   attention_step once and lstm_gates 3 times a decoder step (the steps
   from the written mels' lengths and the buckets); one batch of 8 through
   GTAGenerator with the kernels against the plain versions (1e-4), and
   with prenet dropout off the card against the CPU (1e-3); --extremeGTA 128
   on two utterances; seconds per utterance and per second of audio, and
   the device-busy share. 12b: `train --model gan_postnet` over 12a's map
   at GANPostnetConfig() with the checkpoint's speaker table, 4 iterations;
   the D and G steps timed; one D+G step on unit-variance mels card
   against CPU by phase 8's rule (`step_parity`: losses rel 1e-4,
   gradients and their norms 1e-3 or 10 times what a 1e-6 nudge of the
   inputs moves them on the CPU), and the parameters after the step
   within 1e-4 (2 lr where the gradient is within rounding of zero).
   12c: `train --model hifigan_denoiser` at HiFiGANDenoiserConfig() on 48
   kHz clean wavs with a noise folder, batch 4: stage 0 at 8400-sample
   segments for 3 iterations, then --resume at stage=2 (fresh critics) at
   76800 (DS takes at least 73800) to 5; each stage's step timed; one
   stage-2 step at B=1 on broadband audio card against CPU as in 12b.
   Training launches no
   kernel.
13. the non-autoregressive TTS family on phase 12's corpus, whose wavs now
   carry 12a's .gdur.npy letter durations. 13a: `train --model untts` at
   UnTTSConfig() (embedding 384, 4 FFT blocks x 2 heads x 1024, predictors
   256, decoder 6 flows x 3 layers x 192, 80 mels), batch 8, DIO f0, 3
   iterations with a validation and a checkpoint, then --resume to 5 (no
   kernel launched: training and its validation run the WNs' training
   form); the step's s/iter, peak memory and busy share; one step at B=4
   card against CPU by 12b's rule (`step_parity`, dropout 0). 13b:
   UnTTS.inference at full width with VarGlow, B=4, 100-70 chars, up to
   1024 frames, every WN end layer drawn nonzero (N(0, 0.02^2)): exactly
   6 x wn_launches(3) waveglow_wn_forward launches a call, 4 x
   wn_launches(2) more with VarGlow's sampled prosody, 6 x wn_launches(3)
   with positional attention; the kernel path against the plain path at
   the same z (1e-3), the card against the CPU at sigma 0 (1e-4), the same
   durations; ms a call and per second of mel; the decoder's WN (C=192,
   T'=1024) and VarGlow's (C=64, T'=25, cond 2048) against their plain
   versions, timed beside their bounds. 13c: `train --model gantts` at
   GANTTSConfig(), batch 8, 3 iterations, then --resume to 5; the D and G
   steps timed; one D+G step card against CPU with z and the window starts
   given (dropout 0).
14. data-parallel training across processes (cookietts_tpu_torch/parallel/).
   One `python -m torch.distributed.run --standalone --nproc_per_node 2`
   launch of this script (--rank-jobs: two ranks sharing the card, gloo,
   TF32 off) runs the train command's entry point for 14a, 14b, 16b and 16c
   in turn, so the ranks start once. 14a: `train` at phase 7's widths on a
   48-utterance evidence corpus, global batch 16, 4 iterations with a
   validation at the start (validate_at_start) and a validation and a
   checkpoint at 4 (async_save), against the same command in this process
   (phase 16b's twin too): per-iteration losses,
   gradient norms and the validation loss within rel 1e-5 before the
   first update, 1e-4 after it and 1e-2 after more (dp_limit), the final
   weights every element within 2 lr an iteration, one writer's files,
   each rank's attention_step and lstm_gates launches one a decoder step,
   each run's s/iter (not a speed-up: one card). 14b: the same for `train
   --model hifigan` at phase 8's widths and recipe, 2 iterations (no kernel
   launched). 14c: a world-1 NCCL group in this process (TCP store on
   localhost): the full-width Tacotron2 train step with the kernels at
   B=16, T_dec=200 under the group against the step with no group, loss
   terms within rel 1e-6, every gradient (the conv biases ahead of a
   BatchNorm, rounding noise, left out) within relative L2 1e-4, exactly
   200 attention_step and 600 lstm_gates launches; the group destroyed
   after.
15. pipeline stages 0 and 1 (pipeline/preprocess.py, no kernel of the
   port on the path). 15a: 96 seeded speech-like clips (1.5-10 s with
   0.2-0.6 s of low noise at each end, mono 16-bit at 22050 Hz; an LJSpeech
   layout and a four-speaker Clipper layout), then `python -m
   cookietts_tpu_torch preprocess` as a process at configs/preprocess.json's
   values (44.1 kHz, high-pass 150 and 40 Hz, 3 trim passes at 45 dB, -27
   LUFS, 0.9 s minimum) with 4 spawned workers and the feature dump on the
   card (filter 2048, hop 512, 80 mels, 20-11025 Hz, batches of 16): the
   whole output inventory, one mel/len cache and .gt.f0/.gt.energy pair per
   kept clip, the native audio path taken; the process's wall time split
   into the audio step and the dump, device ms a batch, seconds of audio
   per second, peak memory and the dump's device-busy share. 15b: the
   card's frontend against the port's CPU frontend on one full batch (16
   clips, bucket 2^19; mel 1e-3, loudness 1e-3 LU, energy rel 1e-4, f0 and
   voicing equal on 99% of frames) and against the host anchors
   (mel_spectrogram_np on the unpadded clips with their tail frames, 2e-3;
   estimate_f0_autocorr, 99%; dsp.measure_loudness_lufs, 0.1 LU), the
   anchor's s per clip on 8 clips. 15c: the port's TTSDataset over the
   written filelist serves every mel from the cache (the mel computation
   stubbed to raise) and collates a batch. 15d: Griffin-Lim (B=1, 200
   frames, 30 iterations) on the card against the CPU from the same angles
   (1e-3 of the peak). No kernel is launched.
16. tensor parallelism (parallel/tp.py, `train --tp 2`). 16a: lstm_gates at
   the N = 2 shard widths of Tacotron2Config() (each rank's units' columns
   of the four gate blocks: W [F, 4H/2] for H = 1280, 768, 768) at B = 16
   and 4, each shard against its plain version and against the matching
   columns of the unsharded kernel call (phase 3's limits), timed beside
   the full call, with its bound. 16b: `train --model tacotron2 --tp 2` at
   full width in phase 14's launch (validate_at_start, async_save) against
   14a's one-process run: per-iteration losses and gradient norms, the
   iteration-0 and later validations, the final weights (dp_limit's
   rule), one writer's files, each rank's attention_step and lstm_gates
   launches one a decoder step (lstm_gates at 4H/2 columns), whether the
   validation images were written (the card's machine may lack matplotlib
   and tensorboardX: reported, not required); the tp run's checkpoint loads
   into a full Tacotron2 here. 16c: `train --model waveglow --tp 2` at
   WaveGlowConfig() (48 kHz, batch 4), 2 iterations, validations at the
   start and at 2 on the gathered weights (waveglow_wn_forward's launches
   of one process on each rank), against the same command in this process.
17. sequence parallelism (parallel/sp.py, `train --sp 2`, time-sharded
   WaveGlow and HiFi-GAN inference; see phase17's docstring).
18. the bf16 serving path (Tacotron2 and HiFi-GAN with dtype=bfloat16).
   18a: the bf16 forms of attention_step (B=4, 32 by T_enc=64, 384, a
   window and a full mask, D=1313 with row 0 empty), lstm_gates (the three
   cells at B=4 and 32) and hifigan_resblock (the 12 resblocks of the
   bench-serving generator at B=3, T_mel=512, and C=96, 24, 6) against
   their plain bf16 versions (attention and LSTM at f32 rounding; the
   resblock within two bf16 ulps at the output's largest value, its mean
   error logged), one launch a call and two calls bit-identical for
   attention and LSTM; each timed by CUDA-graph replay beside its f32 form
   on the same values, with its bound (bf16 bytes at 3.35 TB/s, operations
   at 989 TFLOP/s). 18b: T2S over Tacotron2Config(dtype=bfloat16) and the
   bench-serving HiFi-GAN in bf16 with phase 4's weights, phase 4's three
   requests through the CUDA-graph chunks (counters zeroed before and read
   after: each bf16 form launched, no f32 form), request s, decode and
   vocode s, x realtime and peak memory beside phase 4's; a replayed bf16
   chunk bit-identical to the eager bf16 chunk; JAX's quality gates
   (bench.py's bench_quality_gate) against the same weights in f32:
   Tacotron2 teacher-forced mel MSE < 5e-3 and MCD < 0.5 dB (B=8,
   T_txt=96, T_mel=384), HiFi-GAN MCD < 1.0 dB (256 frames); one
   `tts --hparams ...,dtype=bfloat16` through the command's entry point in
   this process on seeded checkpoints, exact bf16 launch counts.
19. the bf16 flow vocoders (WaveGlow and WaveFlow with dtype=bfloat16).
   19a: the bf16 forms of waveglow_wn_forward (T' = 10000, Cin 12 and 1;
   C = 48 and 50) and waveflow_row_step (4 rows at W = 30000; C = 48 and
   50) against their plain bf16 versions (WaveGlow's at f32 rounding,
   WaveFlow's within two bf16 ulps), each call the launches wn_launches
   predicts for its form and no other (phase 21b times them). 19b:
   phase 4b's two vocoders in bf16 (same weights), a 5 s infer each with
   exact bf16 launch counts and no f32 form, x realtime beside f32; JAX's
   WaveGlow gate (bench_quality_gate on the chip: 160 frames, one f32 z,
   flax's initialisation with the end fill): STFT MSE < 0.05, MCD < 1.0
   dB; the pair logged for WaveFlow and for phase 4b's weights. 19c: `tts
   --hparams ...,dtype=bfloat16` with a full-width WaveGlow and
   --denoiser, and `train --model waveglow --hparams ...,dtype=bfloat16`
   at WaveGlowConfig() for 2 iterations with a validation.
20. the main path's two bf16 kernels as redesigned for Hopper
   (lstm_gates_bf16: TMA ring, split-K in a thread-block cluster;
   hifigan_resblock_bf16: wgmma, h on chip up to 64 channels). 20a: the
   LSTM at the three decoder cells for B = 1, 4, 32, 128 and the resblock
   at the bench-serving generator's 12 resblocks (B=3, T_mel=512; B = 1
   and 32 at T_mel=32) and at C = 96, 24, 6 with T = 4103, each against its
   plain version at phase 18a's tolerances, one launch a call (the
   resblock: the launches hifigan_resblock_launches predicts) and a second
   call equal to the bit. 20b: CUDA-graph replay times beside the f32 form
   on the same values, the plain version and the bound: the decode step
   at each B beside nn.LSTMCell in bf16 (the LSTM's library_ms), the
   generator call and each of its four stages (phases 18 and 19 run the
   same kernels through the main path).
21. the flow vocoders' two bf16 WN kernels as redesigned for Hopper
   (waveglow_wn_forward_bf16 and waveflow_row_step_bf16: one launch a layer
   on wgmma with the gate's output kept on chip). 21a: WaveGlow's WN at
   the main path's shapes (B=1, C=256, T' = 10000, Cin 12 and 1), C = 48
   and 50, T' = 250 and B=4 at a validation segment's T' = 1000, at f32
   rounding; WaveFlow over 4 rows (the ring round once) at W = 30000,
   C = 48 and 50, W = 250 and B=4 at W = 3000, within two bf16 ulps on
   log_s, t and the ring's queues; exact launches (L + 2 a call) and a
   second call equal to the bit. 21b: CUDA-graph replay times of the 48
   calls of a 5 s infer beside the f32 form on the same values, the plain
   version and the bounds (the kernels line's: WaveGlow's operations at
   989 / 3 TFLOP/s, three bf16 products a flop; WaveFlow's bf16 bytes);
   tools/bench_wn_bf16_parts.py splits them by part.

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
    # the bf16 forms of the serving path's three kernels (phase 18)
    "attention_step_bf16": ("cookietts_tpu_torch/csrc/attention_step.cu",
                            "cookietts_tpu/ops/pallas_kernels.py:74"),
    "lstm_gates_bf16": ("cookietts_tpu_torch/csrc/lstm_gates_bf16.cu",
                        "cookietts_tpu/ops/pallas_kernels.py:236"),
    "hifigan_resblock_bf16": ("cookietts_tpu_torch/csrc/hifigan_resblock_bf16.cu",
                              "cookietts_tpu/ops/pallas_kernels.py:724"),
    # the bf16 forms of the flow vocoders' two WN kernels (phase 19)
    "waveglow_wn_forward_bf16": ("cookietts_tpu_torch/csrc/waveglow_wn_bf16.cu",
                                 "cookietts_tpu/ops/pallas_kernels.py:609"),
    "waveflow_row_step_bf16": ("cookietts_tpu_torch/csrc/waveflow_row_bf16.cu",
                               "cookietts_tpu/ops/pallas_kernels.py:467"),
}
BF16_FLOPS = 989e12            # H100 SXM bf16 tensor cores, dense
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
# queues their work, so the work then runs at the same time (phase 6); made
# 4x longer, up to the second value, while the host queues for longer
HOLD_CYCLES, MAX_HOLD_CYCLES = 50_000_000, 3_200_000_000
# (atol, rtol). The WN kernels sum 768 to 1536 products per output in 3xTF32
# and in another order than cuDNN, through 8 layers: a few 1e-6 at values
# near 2 (tests/test_torch_kernels.py emulates the split).
TOL = {"attention_step": (2e-5, 1e-4), "lstm_gates": (2e-5, 1e-4),
       "hifigan_resblock": (1e-4, 1e-4), "waveglow_wn_forward": (2e-5, 1e-4),
       "waveflow_row_step": (2e-5, 1e-4),
       # the bf16 forms of attention and the LSTM compute in f32 on the same
       # bf16 values as their plain versions: f32 rounding, as the f32 forms;
       # so does WaveGlow's bf16 WN (2xTF32 on exact bf16 weights)
       "attention_step_bf16": (2e-5, 1e-4), "lstm_gates_bf16": (2e-5, 1e-4),
       "waveglow_wn_forward_bf16": (2e-5, 1e-4)}


PHASE_STARTS = []     # (phase, perf_counter at its header line)


def log(*a):
    print(*a, flush=True)


def phase(name: str, title: str) -> None:
    """A phase's header line; it also starts the phase's clock."""
    PHASE_STARTS.append((name, time.perf_counter()))
    log(f"phase {name}: {title}")


def phase_seconds(end: float) -> dict:
    """Each phase's seconds, from its header to the next one's (or
    ``end``)."""
    marks = PHASE_STARTS + [(None, end)]
    return {p: round(b - a, 1) for (p, a), (_, b) in zip(marks, marks[1:])}


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
        got, want = got.detach(), want.detach()
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


MAIN_REQUESTS = [
    ("The quick brown fox jumps over the lazy dog.", ["alice"]),
    ('She looked up and said, "It is a fine day for a walk." Then she '
     "left the room without another word.", ["alice", "bob"]),
    ("Serving on the card, one more request for the smoke test.", ["bob"]),
]
P4_FIGURES = {}     # phase 4's per-request figures and peak memory (phase 18)


def request_figures(res, seconds):
    return {"s": seconds, "decode_s": res["gen_time"],
            "vocode_s": res["total_time"] - res["gen_time"],
            "xrt": res["audio_seconds"] / seconds,
            "mel_lengths": res["mel_lengths"].tolist()}


def phase4(t2s, hk):
    """The main path: 3 requests through T2S; returns the result with the
    most audio, whose shapes phase4_timing uses."""
    import numpy as np
    import torch
    t2s.infer("A warm-up request.", speaker=["alice"], seed=99)
    torch.cuda.reset_peak_memory_stats()
    P4_FIGURES["base_bytes"] = torch.cuda.memory_allocated()
    hk.reset_launch_counts()
    largest, n_segments = None, []
    P4_FIGURES["requests"] = []
    for i, (text, speakers) in enumerate(MAIN_REQUESTS):
        t0 = time.perf_counter()
        res = t2s.infer(text, speaker=speakers, seed=i)
        seconds = time.perf_counter() - t0
        audio = res["audio"]
        n_samples = int(res["mel_lengths"].sum()) * HOP
        P4_FIGURES["requests"].append(request_figures(res, seconds))
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
    P4_FIGURES["peak_bytes"] = torch.cuda.max_memory_allocated()
    launches = {name: hk.LAUNCHES[name] for name in
                ("attention_step", "lstm_gates", "hifigan_resblock")}
    log(f"  launches on the main path: {launches}; peak memory "
        f"{P4_FIGURES['peak_bytes'] / 2 ** 30:.3f} GiB, "
        f"{P4_FIGURES['base_bytes'] / 2 ** 30:.3f} GiB before the requests")
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


def phase3_widths(hk, check, T=250):
    """Every WN width on the card: both kernels against their plain
    versions at C = 512 (the reference WaveFlow's), 384, 96, 48 (not a
    multiple of 32: the last K step and channel block staged with zeros)
    and 50 (not a multiple of 4 either: the weights staged in 4-byte
    copies), B = 1, at a request's length, each call making the launches
    wn_launches predicts; each timed beside its plain version."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(35)
    r = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    L, kw, kh, times = 8, 3, 3, {}
    for C in (512, 384, 96, 48, 50):
        log(f"    WN width C={C}: waveglow {plan_text(hk, 1, C, T, 1, kw)}; "
            f"waveflow {plan_text(hk, 1, C, T, kh, kw)}")
        w = wn_weights(gen, 4, C, 8, L, 1, kw)
        x, cond = r(1, 4, T), r(1, L, 2 * C, T)
        hk.reset_launch_counts()
        got = hk.waveglow_wn_forward(x, cond, *w)
        if hk.LAUNCHES["waveglow_wn_forward"] != hk.wn_launches(L):
            raise SystemExit(f"chip_smoke: waveglow_wn_forward C={C} made "
                             f"{hk.LAUNCHES['waveglow_wn_forward']} launches, "
                             f"not {hk.wn_launches(L)}")
        want = hk.waveglow_wn_forward_plain(x, cond, *w)
        check("waveglow_wn_forward", got, want, *TOL["waveglow_wn_forward"],
              f"B=1 C={C} T'={T}")
        times[f"waveglow C={C}"] = (
            time_ms(lambda: hk.waveglow_wn_forward(x, cond, *w), 3),
            time_ms(lambda: hk.waveglow_wn_forward_plain(x, cond, *w), 3))
        w = wn_weights(gen, 1, C, 2, L, kh, kw)
        cond = r(1, L, 2 * C, T)
        ring = torch.zeros(L, kh, 1, C, T, device="cuda")
        queues = torch.zeros(L, kh - 1, 1, C, T, device="cuda")
        x_prev = torch.zeros(1, T, device="cuda")
        hk.reset_launch_counts()
        for step in range(4):
            log_s, t = hk.waveflow_row_step(x_prev, ring, step, cond, *w)
            ls_p, t_p, queues = hk.waveflow_row_step_plain(x_prev, queues, cond, *w)
            tag = f"B=1 C={C} W={T} row {step}"
            check("waveflow_row_step", log_s, ls_p, *TOL["waveflow_row_step"],
                  tag + " log_s")
            check("waveflow_row_step", t, t_p, *TOL["waveflow_row_step"], tag + " t")
            check("waveflow_row_step", hk.ring_queues(ring, step + 1), queues,
                  *TOL["waveflow_row_step"], tag + " queues")
            x_prev = r(1, T)
        if hk.LAUNCHES["waveflow_row_step"] != 4 * hk.wn_launches(L):
            raise SystemExit(f"chip_smoke: waveflow_row_step C={C} made "
                             f"{hk.LAUNCHES['waveflow_row_step']} launches in 4 "
                             f"rows, not {4 * hk.wn_launches(L)}")
        times[f"waveflow C={C}"] = (
            time_ms(lambda: hk.waveflow_row_step(x_prev, ring, 4, cond, *w), 3),
            time_ms(lambda: hk.waveflow_row_step_plain(x_prev, queues, cond, *w), 3))
        for key in (f"waveglow C={C}", f"waveflow C={C}"):
            log(f"    {key}: kernel {times[key][0]:.4f} ms, plain "
                f"{times[key][1]:.4f} ms")
    hk.reset_launch_counts()
    torch.cuda.synchronize()


def make_flow_vocoder(kw, seed):
    """A full-width flow vocoder with random weights from ``seed``: torch's
    default inits, and end layers small but not zero, so that every flow
    transforms its input and 48 of them stay well-conditioned."""
    import torch
    from cookietts_tpu_torch.models.waveglow import WaveGlow, WaveGlowConfig
    torch.manual_seed(seed)
    model = WaveGlow(WaveGlowConfig(**kw), device=DEV)
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
    P4_FIGURES[f"{name}_infer_ms"] = kernel_ms
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
        return out, gen(out["mel_outputs_postnet"], infer=True)
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


def behind_hold(streams, enqueue, what):
    """Runs ``enqueue()``, which queues work on ``streams``, behind a spin on
    each stream, so that the work drains from all of them at once, and
    returns its result once the card is done. The spin must outlast the
    host's queueing: where a spin had ended before ``enqueue`` returned, the
    work may have run one stream after the other, and the run is made again
    with a spin 4x as long."""
    import torch
    cycles = HOLD_CYCLES
    while cycles <= MAX_HOLD_CYCLES:
        ends = []
        for st in streams:
            st.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(st):
                torch.cuda._sleep(cycles)
                ends.append(torch.cuda.Event())
                ends[-1].record(st)
        t0 = time.perf_counter()
        out = enqueue()
        queued_ms = (time.perf_counter() - t0) * 1e3
        late = any(e.query() for e in ends)
        for st in streams:
            torch.cuda.current_stream().wait_stream(st)
        torch.cuda.synchronize()
        if not late:
            return out
        log(f"  {what}: the host queued for {queued_ms:.1f} ms, longer than the "
            f"spin of {cycles} cycles; again with {4 * cycles}")
        cycles *= 4
    raise SystemExit(f"chip_smoke: {what}: the host queued for longer than a spin "
                     f"of {MAX_HOLD_CYCLES} cycles")


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

    def enqueue():
        got = [[], []]
        for _ in range(rounds):
            for i, st in enumerate(streams):
                with torch.cuda.stream(st):
                    got[i].append([hk.lstm_gates(*a) for a in sets[i]])
        return got

    try:
        got = behind_hold(streams, enqueue, "lstm_gates on two streams")
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

    def enqueue():
        got = [[], []]
        for _ in range(replays):
            for i, (g, st) in enumerate(zip(graphs, streams)):
                with torch.cuda.stream(st):
                    g.replay()
                    got[i].append([tuple(t.clone() for t in ch) for ch in outs[i]])
        return got

    got = behind_hold(streams, enqueue, "lstm_gates in two graphs")
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

    def enqueue():
        outs = []
        for i, (p, args, st) in enumerate(zip(progs, inputs, streams)):
            with torch.cuda.stream(st):
                outs.append(p(*args, S, seeded(i)))
        return outs

    for r in range(rounds):
        outs = behind_hold(streams, enqueue, "two captured decode chunks")
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
    audio = gen(mel, infer=True)
    torch.cuda.synchronize()
    n = hk.LAUNCHES["hifigan_resblock"] - before
    log(f"  upsample_initial_channel=384, \"auto\": stages {gen.kernel_stages()}, "
        f"{n} resblock launches (expected {vocoder_launches(hk, gen, 1)})")
    if n != vocoder_launches(hk, gen, 1) or n == 0 \
            or not all(k for _, k in gen.kernel_stages()):
        raise SystemExit("chip_smoke: the 384-wide generator must run the "
                         "resblock kernel at every stage")
    check("slice", audio, plain(mel, infer=True), 1e-3, 1e-3,
          "384-wide HiFi-GAN audio")
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
    """Resblock kernel launches of ``calls`` generator calls (its bf16
    form's for a bf16 generator)."""
    import torch
    bf16 = gen.cfg.dtype == torch.bfloat16
    return calls * sum(hk.hifigan_resblock_launches(rb.convs1[0].in_channels,
                                                    len(rb.dilations), bf16)
                       for rb in gen.resblocks if rb.use_kernel)


def phase6_stream(hk, check, taco, gen, B, smi, steps=256):
    """streaming_tts at a fixed decode length (gate threshold 2.0: the gate
    never stops it) against the whole pipeline run on the card with the same
    generator seed. Counters zeroed before the warm stream, read after; the
    decode kernels must show one launch per step (attention; none for the
    GMM and DCA attention types, which are plain PyTorch) and three (lstm),
    the resblock kernel its launches per vocoder call."""
    import numpy as np
    import torch
    from cookietts_tpu_torch.pipeline.streaming import make_streaming_fns, streaming_tts
    text, lengths, spk = decode_inputs(taco, B, 64, 60 + B)
    fns = make_streaming_fns(taco)
    calls = [0]

    def vocoder(mel):
        calls[0] += 1
        return gen(mel, infer=True)

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
    want = {"attention_step": steps if taco.cfg.attention_type == 0 else 0,
            "lstm_gates": 3 * steps,
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
    ref = gen(whole["mel_outputs_postnet"], infer=True).cpu()
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


def timed_train_step(model, state, batch, ctrl, seed, **noise):
    """One train step as make_tacotron2_train_step runs it (forward in
    training mode, loss, backward, clipping, Adam), timed in parts on the
    host's clock with a synchronize after each; the batch's emotion labels,
    where it has them, go to the model and the loss, and ``noise``
    (sylps_noise, head_noise) to the model. Returns (loss, clipped-before
    gradients by name, ms forward, ms backward, ms update)."""
    import torch
    from cookietts_tpu_torch.losses import DEFAULT_LOSS_SCALARS, tacotron2_loss
    from cookietts_tpu_torch.runtime.optim import clip_by_global_norm
    dev = batch["text"].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    sync = torch.cuda.synchronize if dev.type == "cuda" else lambda: None
    model.train()
    sync()
    t0 = time.perf_counter()
    out, _ = model(
        batch["text"], batch["text_lengths"], batch["mels"],
        batch["mel_lengths"], batch["speaker_id"], batch["sylps"],
        generator=gen, p_teacher_forcing=ctrl["p_teacher_forcing"],
        teacher_force_till=ctrl["teacher_force_till"],
        drop_frame_rate=ctrl["drop_frame_rate"],
        global_mean=batch["global_mean"], emotion_id=batch.get("emotion_id"),
        emotion_onehot=batch.get("emotion_onehot"), **noise)
    keys = ("mels", "mel_lengths", "text_lengths", "sylps", "gate_target",
            "pres_prev_state", "emotion_id", "emotion_onehot")
    total, _, _ = tacotron2_loss(
        out, {k: batch[k] for k in keys if k in batch},
        {k: ctrl[k] for k in DEFAULT_LOSS_SCALARS}, 10.0,
        ctrl["guided_att_sigma"])
    sync()
    t1 = time.perf_counter()
    params = state.params
    grads = dict(zip(params, torch.autograd.grad(
        total, list(params.values()), allow_unused=True)))
    sync()
    t2 = time.perf_counter()
    clipped, _ = clip_by_global_norm(grads, ctrl["grad_clip"])
    state.apply_gradients(clipped, ctrl["lr"])
    sync()
    t3 = time.perf_counter()
    return (total.item(), grads, 1e3 * (t1 - t0), 1e3 * (t2 - t1),
            1e3 * (t3 - t2))


def rel_l2(a, b):
    return float((a - b).norm() / b.norm()) if float(b.norm()) else float(a.norm())


def compare_grads(got, want):
    """([(relative L2, name)] worst first, [names of numerically zero
    gradients]): a gradient below 1e-6 of the whole gradient's norm (a conv
    bias ahead of a training-mode BatchNorm has a zero gradient; its
    computed one is rounding noise on both sides) is held to that norm."""
    if set(got) != set(want):
        raise SystemExit("chip_smoke: the two runs give gradients to "
                         "different parameters")
    g_all = math.sqrt(sum(float(g.norm()) ** 2 for g in want.values()))
    worst, tiny = [], []
    for k in want:
        g = got[k].to(want[k].device)
        r = rel_l2(g, want[k])
        if float(want[k].norm()) < 1e-6 * g_all:
            tiny.append(k)
            r = float((g - want[k]).norm()) / g_all
        worst.append((r, k))
    worst.sort(reverse=True)
    return worst, tiny


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
    worst, tiny = compare_grads(gk, gp)
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


# -- phase 8: vocoder training --------------------------------------------------

# HiFi-GAN V1's recipe: 22050 Hz, hop 256, 80 mels, 8192-sample segments,
# batch 16; the generator and discriminators at HiFiGANConfig()'s widths
# (HIFIGAN: its overrides, none)
HIFIGAN = {}
HIFIGAN_DATA = dict(sampling_rate=22050, filter_length=1024, hop_length=256,
                    win_length=1024, n_mel_channels=80, mel_fmax=8000.0,
                    segment_length=8192, batch_size=16)
# WaveGlow at WaveGlowConfig() (WAVEGLOW_TRAIN: its overrides, none) and
# WaveFlow at phase 4b's WAVEFLOW, on Mel2SampConfig()'s front end (48 kHz,
# hop 600, 160 mels, 24000-sample segments) at batch 4
WAVEGLOW_TRAIN = {}
FLOW_DATA = dict(batch_size=4)
FLOW_SEGMENT = 24000
CADENCE = dict(load_from_disk_dtw=False, validation_interval=2,
               checkpoint_interval=2, log_every=1)
DEV = "cuda"    # phases 8 and 9's device (a rehearsal of their control flow
                # on the CPU, at small sizes, sets "cpu")


def hparams_of(kw):
    """A config dict as --hparams text (tuples as [a,b], nested too)."""
    def text(v):
        if isinstance(v, (tuple, list)):
            return "[" + ",".join(map(text, v)) + "]"
        return str(v)
    return ",".join(f"{k}={text(v)}" for k, v in kw.items())


def vocoder_corpus(root, sr, n, seconds, seed):
    """``n`` seeded WAVs of harmonic tones with vibrato and noise, and a map
    file of them (no GTA mels). Returns the map file's path."""
    import numpy as np
    from cookietts_tpu_torch.data import audio_io
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    lines = []
    for i in range(n):
        f0 = rng.uniform(90, 300) * (1 + 0.03 * np.sin(2 * np.pi * 5 * t))
        phase = 2 * np.pi * np.cumsum(f0) / sr
        audio = sum(0.3 / h * np.sin(h * phase) for h in range(1, 6))
        audio = audio * (0.5 + 0.5 * np.sin(np.pi * t / seconds))
        audio = audio + 0.005 * rng.standard_normal(len(t))
        path = root / f"v{i:02d}.wav"
        audio_io.save_wav(str(path), audio.astype(np.float32), sr)
        lines.append(f"{path}||{i % 4}")
    (root / "map.txt").write_text("\n".join(lines) + "\n")
    return str(root / "map.txt")


def vocoder_train_cli(hk, run, model, map_file, hparams, key, per_batch):
    """The train command: 4 iterations with validation and a checkpoint every
    2, then --resume to 6. Training launches no kernel (it runs cuDNN, as
    JAX trains on stock XLA); each validation batch launches ``key``
    ``per_batch`` times. Returns (the last trainer, the train records
    [(step, loss, s)], the validation records)."""
    import torch
    from cookietts_tpu_torch.cli import main as cli
    args = ["train", "--model", model, "--filelist", map_file, "--run_dir",
            str(run), "--hparams", hparams, "--seed", "0", "--device", DEV]
    for iters, resume, validations in ((4, [], 2), (6, ["--resume"], 1)):
        hk.reset_launch_counts()
        t0 = time.perf_counter()
        trainer = cli(args + ["--iters", str(iters)] + resume)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = dict(hk.LAUNCHES)
        want = {k: 0 for k in got}
        if key:
            want[key] = validations * len(trainer.val_batches) * per_batch
        log(f"  train {'--resume ' if resume else ''}to {iters}: {dt:.1f} s "
            f"(data, validation and model set-up included); launches {got} "
            f"(want {want})")
        if got != want:
            raise SystemExit(f"chip_smoke: {run.name} launch counts")
        if int(trainer.state.step) != iters:
            raise SystemExit(f"chip_smoke: {run.name} trained to "
                             f"{trainer.state.step}, not {iters}")
    train, val = [], []
    for line in (run / "events.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if rec["prefix"] == "train":
            train.append((rec["step"], rec["loss"], rec["iter_s"]))
        elif rec["prefix"] == "validation":
            val.append(rec)
    losses = [v for _, v, _ in train] + [v["val_loss"] for v in val]
    log(f"  losses by step {[(k, round(v, 4)) for k, v, _ in train]}; "
        f"validation {[(v['step'], round(v['val_loss'], 4)) for v in val]}; "
        f"s per iteration (data to the card included) "
        f"{[round(t, 3) for _, _, t in train]}")
    if ([k for k, _, _ in train] != list(range(6))
            or [v["step"] for v in val] != [2, 4, 6]
            or not all(math.isfinite(v) for v in losses)):
        raise SystemExit(f"chip_smoke: {run.name}: a loss is missing or not "
                         "finite, or the resume did not start at step 4")
    files = sorted(p.name for p in run.iterdir())
    for name in ("checkpoint_2", "checkpoint_4", "checkpoint_6",
                 "best_val_model"):
        if name not in files:
            raise SystemExit(f"chip_smoke: {name} missing from {files}")
    return trainer, train, val


def busy_share(fn):
    """(wall ms of one ``fn()``, device-busy ms inside it): torch.profiler's
    CUDA kernel records summed from the raw kineto events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA) / 1e6
    return wall, busy


def gan_step_times(trainer, batch, smi, reps=3):
    """The GAN step of the trained state at the run's batch shape: s per
    iteration split into the D and the G step (host clock, synchronised),
    peak memory, and the device-busy share of one more iteration."""
    import torch
    from cookietts_tpu_torch.device import batch_to_device
    step, state = trainer.train_step, trainer.state
    ctrl = trainer.ctrl(int(state.step))
    dev = batch_to_device(batch, DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        step.d_step(state.d, state.g, dev, ctrl)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step.g_step(state.g, state.d, dev, ctrl)
        torch.cuda.synchronize()
        times.append((t1 - t0, time.perf_counter() - t1))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    wall, busy = busy_share(lambda: step(state, dev, None, ctrl))
    d, g = (min(t[i] for t in times) for i in (0, 1))
    log(f"  HiFi-GAN step B={batch['audio'].shape[0]} x "
        f"{batch['audio'].shape[1]} samples: {d + g:.3f} s/iter (D step "
        f"{d:.3f} s, G step {g:.3f} s; best of {reps}), peak "
        f"{peak:.2f} GiB; device busy {busy:.1f} ms of a profiled "
        f"iteration's {wall:.1f} ms = {busy / wall:.3f} ({smi})")
    return {"d_s": d, "g_s": g, "peak_gib": peak, "busy": busy / wall}


def flow_step_times(trainer, batch, name, smi):
    """The flow step of the trained weights at the run's batch shape, with
    memory_efficient on and off: s per iteration, peak memory, and the
    device-busy share of one iteration (on)."""
    import torch
    from cookietts_tpu_torch.models.waveglow import WaveGlow
    from cookietts_tpu_torch.runtime.optim import adam
    from cookietts_tpu_torch.runtime.train_state import TrainState
    from cookietts_tpu_torch.device import batch_to_device
    from cookietts_tpu_torch.runtime.trainer import make_waveglow_train_step
    src = trainer.state.model
    dev = batch_to_device(batch, DEV)
    ctrl = trainer.ctrl(int(trainer.state.step))
    out = {}
    for me in (True, False):
        model = WaveGlow(dataclasses.replace(src.cfg, memory_efficient=me),
                         device=DEV)
        model.load_state_dict(src.state_dict())
        state = TrainState.create(model, adam())
        step = make_waveglow_train_step(model)
        step(state, dev, None, ctrl)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(2):
            step(state, dev, None, ctrl)
        torch.cuda.synchronize()
        s = (time.perf_counter() - t0) / 2
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        busy = busy_share(lambda: step(state, dev, None, ctrl)) if me else None
        out[me] = (s, peak, busy)
        del model, state, step
    (s1, p1, (wall, busy)), (s0, p0, _) = out[True], out[False]
    log(f"  {name} step B={batch['audio'].shape[0]} x "
        f"{batch['audio'].shape[1]} samples: memory_efficient on {s1:.3f} "
        f"s/iter, peak {p1:.2f} GiB; off {s0:.3f} s/iter, peak {p0:.2f} GiB; "
        f"device busy (on) {busy:.1f} ms of {wall:.1f} ms = "
        f"{busy / wall:.3f} ({smi})")
    return {"s_on": s1, "peak_on": p1, "s_off": s0, "peak_off": p0,
            "busy": busy / wall}


def flow_validation_parity(hk, check, trainer, name, key):
    """Validation through the inverse from the trained weights and one z:
    the kernels against their plain versions (the launches counted)."""
    import torch
    from cookietts_tpu_torch.device import batch_to_device
    from cookietts_tpu_torch.runtime.trainer import make_waveglow_val_step
    model = trainer.state.model
    cfg = model.cfg
    batch = batch_to_device(trainer.val_batches[0], DEV)
    B, T_mel = batch["mels"].shape[:2]
    n = T_mel * cfg.hop_length // cfg.n_group
    shape = (B, cfg.n_group, n) if model.waveflow else (B, n, cfg.n_group)
    z = torch.randn(shape, device=DEV,
                    generator=torch.Generator(device=DEV).manual_seed(13))
    val = make_waveglow_val_step(model)
    hk.reset_launch_counts()
    got = val(None, batch, None, z=z)
    launches = hk.LAUNCHES[key]
    with plain_kernels(hk):
        want = val(None, batch, None, z=z)
    calls = cfg.n_flows * (cfg.n_group if model.waveflow else 1)
    log(f"  {name} validation B={B}: val_MSE {float(got['val_MSE']):.6g} "
        f"(plain {float(want['val_MSE']):.6g}), val_MAE "
        f"{float(got['val_MAE']):.6g} (plain {float(want['val_MAE']):.6g}); "
        f"{launches} {key} launches (want {calls * hk.wn_launches(cfg.n_layers)})")
    if launches != calls * hk.wn_launches(cfg.n_layers):
        raise SystemExit(f"chip_smoke: {name} validation launch count")
    for k in ("val_MSE", "val_MAE"):
        check("slice", got[k], want[k], 0.0, 1e-3, f"{name} validation {k}")


def moments_grads(side):
    """The gradients of one Adam step from zero moments, unclipped:
    mu / (1 - b1)."""
    return {k: v / 0.1 for k, v in side.opt_state.mu.items()}


def parity_run(build, step_of, batch, ctrl, device):
    """One train step from ``build()``'s modules (built on the CPU under
    seed 0, moved to ``device``) -> (metrics, gradients from Adam's first
    moments, the parameters after the step, all on the CPU, seconds). On
    the card with cuDNN's deterministic algorithms (step_parity says why)."""
    import torch
    from cookietts_tpu_torch.device import batch_to_device
    torch.manual_seed(0)
    modules = [m.to(device) for m in build()]
    step, state = step_of(modules, device)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = device != "cpu" or deterministic
    try:
        t0 = time.perf_counter()
        state, metrics = step(state, batch_to_device(batch, device), None,
                              ctrl)
        if device != "cpu":
            torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    sides = [state.g, state.d] if hasattr(state, "d") else [state]
    return ({k: float(v) for k, v in metrics.items()},
            {f"{i}.{k}": g.cpu() for i, side in enumerate(sides)
             for k, g in moments_grads(side).items()},
            {f"{i}.{k}": p.detach().cpu() for i, side in enumerate(sides)
             for k, p in side.params.items()},
            time.perf_counter() - t0)


def step_parity(name, build, step_of, batch, ctrl, check_params=False):
    """One train step on the card against the same step on the CPU, from
    the same weights (``build()`` on the CPU, copied) and batch: every
    reported metric within 1e-4 of itself or of the loss (a log-determinant
    of a near-rotation is rounding noise about 0), every gradient (from
    Adam's first moments) within relative L2 1e-3 (a zero gradient zero on
    both). A gradient can be ill-conditioned in its input: leaky ReLU kinks
    that rounding flips, sums that cancel (the MSD's first scale: moving the
    audio by a relative 1e-6 moves its first conv's weight gradient by 8e-4
    on the CPU, H100 run), the log of a spectrum's smallest bins (the
    denoiser's critics). So where a gradient or a gradient's norm is over
    its limit, the CPU runs the step once more with every float input of
    the batch moved by a relative 1e-6 (about 16 ulp a value), and that
    number is held to 10 times what the nudge moves it (rounding acts at
    each of some 30 layers, not once at the input). A loss has no such
    escape. The card's step takes cuDNN's deterministic algorithms: with
    the default ones, 12b's g_adv (a G loss after the D step's Adam update)
    read 0.660222-0.66032 in five runs of this script on an H100, a spread
    of 5e-5 of the loss, against the CPU's 0.660109 and a limit of 1e-4 of
    the loss, and one of the five failed.

    ``check_params``: every parameter after the step within 1e-4, but where
    the CPU's gradient is within rounding of zero, which Adam's normalised
    first step moves by up to lr either way: there within 2 lr. Within
    rounding: an element that the nudge (which then always runs) or the
    card moves by more than a tenth of its value, or every element of a
    gradient the nudge moves by more than a tenth in L2 (a conv bias ahead
    of a training-form BatchNorm, the weight_v of a one-element weight-norm
    group). The card's own difference counts because the nudge cannot see
    rounding in a sum that cancels (the flax BatchNorm's variance,
    E[x^2] - E[x]^2, of a channel whose mean dwarfs its spread), and it
    cannot hide a wrong gradient: the gradient check above holds each
    gradient whole."""
    import numpy as np
    import torch

    def run(device, b):
        return parity_run(build, step_of, b, ctrl, device)

    (mc, gc, pc, tc), (mg, gg, pg, tg) = run("cpu", batch), run(DEV, batch)
    rel_m = lambda m, k: abs(m[k] - mc[k]) / max(abs(mc[k]), abs(mc["loss"]))  # noqa: E731
    rel = lambda g, k: float((g[k] - gc[k]).norm()) / float(gc[k].norm())  # noqa: E731
    nonzero = [k for k in gc if float(gc[k].norm()) > 0.0]
    bad = [k for k in gc if k not in nonzero and float(gg[k].norm()) != 0.0]
    rows = sorted(((rel(gg, k), k) for k in nonzero), reverse=True)
    over = [(r, k) for r, k in rows if r > 1e-3]
    over_m = [k for k in sorted(mc) if rel_m(mg, k) > 1e-4]
    text, params = "none", ""
    if over or over_m or check_params:  # the CPU at a nudged input
        rng = np.random.default_rng(0)
        mn, gn = run("cpu", {k: (v * (1 + 1e-6 * rng.standard_normal(
            v.shape))).astype(np.float32) if v.dtype.kind == "f" else v
            for k, v in ((k, np.asarray(v)) for k, v in batch.items())})[:2]
        bad += [k for r, k in over if r > 10 * rel(gn, k)]
        bad += [k for k in over_m if not k.endswith("grad_norm")
                or rel_m(mg, k) > 10 * rel_m(mn, k)]
        text = (", ".join(f"{k} {rel_m(mg, k):.2e} (nudged {rel_m(mn, k):.2e})"
                          for k in over_m)
                + "; " * bool(over_m and over)
                + ", ".join(f"{k} {r:.2e} (nudged {rel(gn, k):.2e})"
                            for r, k in over[:12])
                + (f" and {len(over) - 12} more" if len(over) > 12 else "")
                ) or "none"
    if check_params:
        worst, n_round, n_card = (0.0, ""), 0, 0
        for k in pc:
            diff = (pg[k] - pc[k]).abs()
            nudged = gc[k].abs() <= 10 * (gn[k] - gc[k]).abs()
            if k in nonzero and rel(gn, k) > 0.1:
                nudged = torch.ones_like(nudged)
            rounding = nudged | (gc[k].abs() <= 10 * (gg[k] - gc[k]).abs())
            n_round += int(rounding.sum())
            n_card += int((rounding & ~nudged).sum())
            fail = torch.where(rounding, diff > 2 * ctrl["lr"] + 1e-6,
                               diff > 1e-4)
            if bool(fail.any()):
                i = int(torch.argmax(torch.where(fail, diff, 0.0)))
                bad.append(f"{k}: {int(fail.sum())} elements, the largest "
                           f"{float(diff.flatten()[i]):.2e} (gradient "
                           f"{float(gc[k].flatten()[i]):.3e} on the CPU, "
                           f"{float(gn[k].flatten()[i]):.3e} nudged, "
                           f"{float(gg[k].flatten()[i]):.3e} on the card)")
            worst = max(worst, (float(torch.where(rounding, 0.0, diff).max()),
                                k))
        params = (f"; parameters after the step, largest difference "
                  f"{worst[0]:.2e} ({worst[1]}; limit 1e-4), {n_round} of "
                  f"{sum(v.numel() for v in pc.values())} elements with a "
                  f"gradient within rounding of zero, {n_card} of them by the "
                  f"card's difference alone (limit 2 lr)")
    log(f"  {name} step on the card ({tg:.2f} s) against the CPU ({tc:.2f} s): "
        f"losses {', '.join(f'{k} {mg[k]:.6g}' for k in sorted(mg))}; largest "
        f"difference over the value or the loss "
        f"{max(rel_m(mg, k) for k in mc):.2e} (limit 1e-4); {len(gc)} "
        f"gradients, largest relative L2 "
        f"{', '.join(f'{k} {r:.2e}' for r, k in rows[:3])} (limit 1e-3); "
        f"over their limits, with what the nudged inputs move them on the "
        f"CPU: {text}{params}")
    if bad:
        raise SystemExit(f"chip_smoke: the {name} train step on the card "
                         f"disagrees with the CPU's ({bad})")


def phase8_parity(hk, check, run_dir, smi):
    """8c: one train step of each trainer, card against CPU; the HiFi-GAN
    checkpoint of 8a served through hifigan_resblock."""
    import numpy as np
    import torch
    from torch import nn
    from cookietts_tpu_torch.audio.stft import TacotronSTFT
    from cookietts_tpu_torch.data.mel2samp import Mel2SampConfig
    from cookietts_tpu_torch.models.hifigan import (
        Generator, HiFiGANConfig, MultiPeriodDiscriminator,
        MultiScaleDiscriminator)
    from cookietts_tpu_torch.models.waveglow import WaveGlow, WaveGlowConfig
    from cookietts_tpu_torch.runtime.optim import adam
    from cookietts_tpu_torch.runtime.train_state import GANTrainState, TrainState
    from cookietts_tpu_torch.runtime.trainer import (
        make_gan_trainer_step, make_hifigan_train_steps,
        make_waveglow_train_step)
    rng = np.random.default_rng(21)
    d = Mel2SampConfig(**{k: v for k, v in HIFIGAN_DATA.items()
                          if k != "batch_size"})
    hcfg = HiFiGANConfig(**HIFIGAN, n_mel_channels=d.n_mel_channels)
    stft_args = (d.filter_length, d.hop_length, d.win_length,
                 d.n_mel_channels, d.sampling_rate, d.mel_fmin, d.mel_fmax)
    seg = d.segment_length
    audio = (0.3 * np.sin(np.arange(2 * seg) * 0.05).reshape(2, seg)
             + 0.05 * rng.standard_normal((2, seg))).astype(np.float32)
    mels = TacotronSTFT(*stft_args, device="cpu").mel_spectrogram_np(audio)

    def gan_build():
        return (Generator(hcfg, device="cpu", weight_norm=True),
                nn.ModuleDict({"mpd": MultiPeriodDiscriminator(hcfg, "cpu"),
                               "msd": MultiScaleDiscriminator(hcfg, "cpu")}))

    def gan_step(modules, device):
        gen, disc = modules
        mel_fn = TacotronSTFT(*stft_args, device=device).mel_spectrogram
        return (make_gan_trainer_step(*make_hifigan_train_steps(
                    gen, disc["mpd"], disc["msd"], mel_fn)),
                GANTrainState(TrainState.create(gen, adam(weight_decay=0.01)),
                              TrainState.create(disc, adam(weight_decay=0.01))))

    step_parity("HiFi-GAN", gan_build, gan_step,
                {"audio": audio, "mels": mels.astype(np.float32)},
                {"lr": 2e-4, "grad_clip": 1e9})
    for name, kw in (("WaveGlow", WAVEGLOW_TRAIN), ("WaveFlow", WAVEFLOW)):
        cfg = WaveGlowConfig(**kw)

        def flow_build(cfg=cfg):
            model = WaveGlow(cfg, device="cpu")
            with torch.no_grad():        # end layers off zero: every WN learns
                for wn in model.WN:
                    wn.end.weight.normal_(std=0.05 * cfg.n_channels ** -0.5)
            return (model,)

        def flow_step(modules, device):
            return (make_waveglow_train_step(modules[0]),
                    TrainState.create(modules[0], adam()))

        a = (0.3 * rng.standard_normal((1, FLOW_SEGMENT))).astype(np.float32)
        m = rng.normal(-6, 1.5, (1, FLOW_SEGMENT // cfg.hop_length,
                                 cfg.n_mel_channels)).astype(np.float32)
        step_parity(name, flow_build, flow_step, {"audio": a, "mels": m},
                    {"lr": 1e-4, "grad_clip": 1e9})

    # the generator 8a trained, served
    serving = Generator(hcfg, device=DEV)
    serving.load_state_dict(torch.load(run_dir / "checkpoint_6",
                                       map_location=DEV)["state_dict"])
    trained = Generator(hcfg, device=DEV, weight_norm=True)
    trained.load_state_dict(torch.load(run_dir / "checkpoint_6",
                                       map_location=DEV)["state_dict"])
    mel = torch.from_numpy(mels).to(DEV)
    hk.reset_launch_counts()
    audio_k = serving(mel, infer=True)
    torch.cuda.synchronize()
    n = hk.LAUNCHES["hifigan_resblock"]
    with plain_kernels(hk):
        audio_p = serving(mel, infer=True)
    with torch.no_grad():
        audio_t = trained(mel)
    want = vocoder_launches(hk, serving, 1)
    log(f"  the trained checkpoint served (B=2, T_mel={mel.shape[1]}): "
        f"{n} hifigan_resblock launches (want {want})")
    if n != want or n == 0:
        raise SystemExit("chip_smoke: the served checkpoint's resblock "
                         "launches")
    check("slice", audio_k, audio_p, 1e-3, 1e-3,
          "trained HiFi-GAN served, kernel vs plain")
    check("slice", audio_k, audio_t, 1e-3, 1e-3,
          "served vs the training form's convs")
    rb = serving.resblocks[0]
    x = torch.randn(2, rb.convs1[0].in_channels, 1024, device=DEV,
                    generator=torch.Generator(device=DEV).manual_seed(3))
    args = (x, *rb.kernel_weights(), rb.dilations, rb.slope)
    check("hifigan_resblock", hk.hifigan_resblock(*args),
          hk.hifigan_resblock_plain(*args), *TOL["hifigan_resblock"],
          "trained checkpoint, resblock 0")


def phase8(hk, check, smi):
    """8a HiFi-GAN and 8b WaveGlow / WaveFlow through the train command at
    full width, each with its step timed; 8c card-against-CPU steps and
    the trained HiFi-GAN served."""
    import tempfile
    import torch
    from cookietts_tpu_torch.models.hifigan import HiFiGANConfig
    from cookietts_tpu_torch.models.waveglow import WaveGlowConfig
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        sr = HIFIGAN_DATA["sampling_rate"]
        hifigan_map = vocoder_corpus(tmp / "wav22k", sr, 20,
                                     2.5 * HIFIGAN_DATA["segment_length"] / sr,
                                     seed=4)
        flow_map = vocoder_corpus(tmp / "wav48k", 48000, 10,
                                  1.5 * FLOW_SEGMENT / 48000, seed=5)
        hcfg = HiFiGANConfig(**HIFIGAN)
        hp = hparams_of({**HIFIGAN, **HIFIGAN_DATA})
        log(f"  8a HiFi-GAN, HiFiGANConfig({hparams_of(HIFIGAN)}) (MPD periods "
            f"{hcfg.mpd_periods}, MSD {hcfg.msd_scales} scales): {hp}")
        trainer, *_ = vocoder_train_cli(
            hk, tmp / "hifigan", "hifigan", hifigan_map,
            hparams_of({**HIFIGAN, **HIFIGAN_DATA, **CADENCE}), None, 0)
        tree = torch.load(tmp / "hifigan" / "checkpoint_6")
        if not {"state_dict", "opt_state", "d_state_dict",
                "d_opt_state"} <= set(tree):
            raise SystemExit(f"chip_smoke: the HiFi-GAN checkpoint holds "
                             f"{sorted(tree)}, not G and D")
        del tree
        gan_step_times(trainer, trainer.val_batches[0], smi)
        del trainer
        log(f"  phase 8a in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        for name, kw, key in (("WaveGlow", WAVEGLOW_TRAIN, "waveglow_wn_forward"),
                              ("WaveFlow", WAVEFLOW, "waveflow_row_step")):
            cfg = WaveGlowConfig(**kw)
            log(f"  8b {name}: WaveGlowConfig({hparams_of(kw)}), "
                f"{hparams_of(FLOW_DATA)}")
            per_batch = cfg.n_flows * (
                cfg.n_group if cfg.channel_mixing == "permuteheight" else 1
            ) * hk.wn_launches(cfg.n_layers)
            trainer, *_ = vocoder_train_cli(
                hk, tmp / name, "waveglow", flow_map,
                hparams_of({**kw, **FLOW_DATA, **CADENCE}), key, per_batch)
            flow_validation_parity(hk, check, trainer, name, key)
            flow_step_times(trainer, trainer.val_batches[0], name, smi)
            del trainer
        log(f"  phase 8b in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase8_parity(hk, check, tmp / "hifigan", smi)
        log(f"  phase 8c in {time.perf_counter() - t0:.1f} s; {smi}")


# -- phase 9: serving checkpoints through the tts and server commands ---------

P9_STEPS = 128
# the gates of random weights fire at once or never: a threshold above 1,
# one step bucket and one attempt fix every decode at P9_STEPS steps
P9_HPARAMS = (f"batch_size=4,step_buckets=[{P9_STEPS}],"
              f"max_decoder_steps={P9_STEPS},gate_threshold=2.0")
P9_TEXT = ('Hello world, the port serves a checkpoint. "What a quick fox!" '
           "she said.")
P9_SEGMENTS = 3
P9_ARPA = ("HELLO  HH AH0 L OW1\nWORLD  W ER1 L D\nQUICK  K W IH1 K\n"
           "FOX  F AA1 K S\nPORT  P AO1 R T\n")
TORCHMOJI_VOCAB_WORDS = 5000


def p9_files(tmp, tcfg, hcfg, flows=True):
    """Seeded checkpoints with their sidecars (Tacotron2 with GST and
    EmotionNet at 80 and, with ``flows``, at 160 mels, the phase-4
    HiFi-GAN, with ``flows`` the phase-4b WaveGlow, the full torchMoji as a
    pytorch_model.bin), a vocabulary of the ten specials and some thousands
    of words, an ARPA dictionary and a speaker_info.txt. Returns their
    paths."""
    import random
    import torch
    from cookietts_tpu_torch.models.hifigan import Generator
    from cookietts_tpu_torch.models.tacotron2 import Tacotron2
    from cookietts_tpu_torch.models.torchmoji import SPECIAL_TOKENS, TorchMoji
    from cookietts_tpu_torch.runtime.checkpoint import save_checkpoint
    config_json = lambda cfg: {k: v for k, v in dataclasses.asdict(  # noqa: E731
        cfg).items() if k != "dtype"}
    heads = {"use_gst": True, "use_emotionnet": True}
    files = {k: str(tmp / k) for k in ("taco80", "taco160", "hifigan",
                                       "waveglow", "pytorch_model.bin",
                                       "vocabulary.json", "merged.dict",
                                       "speaker_info.txt")}
    for key, n_mel, seed in (("taco80", tcfg.n_mel_channels, 20),
                             ("taco160", FLOW_MELS, 21))[:2 if flows else 1]:
        torch.manual_seed(seed)
        cfg = dataclasses.replace(tcfg, n_mel_channels=n_mel, **heads)
        save_checkpoint(files[key],
                        {"state_dict": Tacotron2(cfg, device="cpu").state_dict()},
                        {"model": "tacotron2", "model_config": config_json(cfg),
                         "speaker_ids": {"narrator": 0},
                         "audio": {"sampling_rate": SR, "hop_length": HOP,
                                   "n_mel_channels": n_mel}})
    torch.manual_seed(22)
    save_checkpoint(files["hifigan"],
                    {"state_dict": Generator(hcfg, device="cpu").state_dict()},
                    {"model": "hifigan", "model_config": config_json(hcfg),
                     "audio": {"sampling_rate": SR, "hop_length": HOP,
                               "n_mel_channels": hcfg.n_mel_channels}})
    if flows:
        save_checkpoint(
            files["waveglow"],
            {"state_dict": make_flow_vocoder(WAVEGLOW, seed=23).state_dict()},
            {"model": "waveglow", "model_config": WAVEGLOW,
             "audio": {"sampling_rate": FLOW_SR, "hop_length": FLOW_HOP,
                       "n_mel_channels": FLOW_MELS}})
    torch.manual_seed(24)
    torch.save(TorchMoji(device="cpu").state_dict(), files["pytorch_model.bin"])
    rng = random.Random(25)
    words = {w.strip('.,!"').lower() for w in P9_TEXT.split()} | {".", "!", ","}
    while len(words) < TORCHMOJI_VOCAB_WORDS:
        words.add("".join(rng.choice("abcdefghijklmnopqrstuvwxyz")
                          for _ in range(rng.randint(2, 9))))
    vocab = {t: i for i, t in enumerate(SPECIAL_TOKENS)}
    vocab.update({w: len(vocab) + i for i, w in enumerate(sorted(words))})
    Path(files["vocabulary.json"]).write_text(json.dumps(vocab))
    Path(files["merged.dict"]).write_text(P9_ARPA)
    Path(files["speaker_info.txt"]).write_text(
        ";dataset|speaker_name|speaker_id|duration_hrs\n"
        "ds|alice|0|1.0\nds|bob|1|1.0\n")
    return files




def p9_tts(files, taco, vocoder, extra, out, smi, source=None):
    """The tts command's entry point (cli.main) in this process, default
    device, from the checkpoints (or the flags ``source``, such as an
    --artifact); returns (its stats line, its kernel launches)."""
    import io

    from cookietts_tpu_torch.cli import main as cli
    source = source or ["--checkpoint", files[taco], "--vocoder", files[vocoder]]
    argv = ["tts", *source,
            "--torchmoji", files["pytorch_model.bin"],
            "--torchmoji_vocab", files["vocabulary.json"],
            "--arpa_dict", files["merged.dict"],
            "--speaker_info", files["speaker_info.txt"], "--speaker", "bob",
            "--text", P9_TEXT, "--max_attempts", "1", "--hparams", P9_HPARAMS,
            "-o", str(out), *extra, *([] if DEV == "cuda" else ["--device", DEV])]
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli(argv)
    stdout = buf.getvalue()
    seconds = time.perf_counter() - t0
    lines = stdout.strip().splitlines()
    stats = json.loads(lines[-1])
    launches = next(json.loads(l)["kernel_launches"] for l in lines
                    if l.startswith('{"kernel_launches"'))
    log(f"  tts {vocoder}: in this process (imports and CUDA warm) "
        f"{seconds:.2f} s wall (imports, "
        f"checkpoint loads and the first capture included); its own gen_time "
        f"{stats['gen_time']:.3f} s, total {stats['total_time']:.3f} s, xrt "
        f"{stats['xrt']:.3f}, {stats['audio_seconds']:.3f} s of audio; "
        f"launches {launches} ({smi})")
    return stats, launches


def p9_expect(got, want, what):
    log(f"  {what} launches {got}, expected {want}")
    if any(got.get(k) != n for k, n in want.items()) or min(want.values()) <= 0:
        raise SystemExit(f"chip_smoke: {what} launch counts")


def phase9(hk, check, tcfg, hcfg, smi):
    """9a, 9b: the tts command (its entry point in this process) on the
    card, with --torchmoji,
    --arpa_dict and --speaker_info, HiFi-GAN then WaveGlow with --denoiser;
    9c: the server's worker from _build_t2s answering three requests
    through handle_tts, kernels against the plain path; 9d: TorchMojiEncoder
    on the card against the CPU; 9e: launch counts against the decode and
    vocode steps."""
    import io
    import tempfile
    import wave

    import numpy as np
    import torch
    from cookietts_tpu_torch import cli
    from cookietts_tpu_torch.models.torchmoji import TorchMojiEncoder
    from cookietts_tpu_torch.pipeline.server import ModelRegistry, handle_tts
    from cookietts_tpu_torch.pipeline.text2speech import T2S

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        files = p9_files(tmp, tcfg, hcfg)
        mb = sum(Path(f).stat().st_size for f in files.values()) / 2 ** 20
        log(f"  checkpoints, vocabulary ({TORCHMOJI_VOCAB_WORDS} words), ARPA "
            f"dictionary and speaker_info written in "
            f"{time.perf_counter() - t0:.1f} s ({mb:.0f} MiB)")
        decode = {"attention_step": P9_STEPS, "lstm_gates": 3 * P9_STEPS}
        n_samples = P9_SEGMENTS * P9_STEPS * HOP

        # 9a: HiFi-GAN
        stats, got = p9_tts(files, "taco80", "hifigan", [], tmp / "a.wav", smi)
        with wave.open(str(tmp / "a.wav")) as w:
            rate, n = w.getframerate(), w.getnframes()
        if (rate, n, stats["segments"]) != (SR, n_samples, P9_SEGMENTS):
            raise SystemExit(f"chip_smoke: 9a wrote {n} samples at {rate} Hz in "
                             f"{stats['segments']} segments, expected "
                             f"{n_samples} at {SR} in {P9_SEGMENTS}")
        gen = cli._load_vocoder(files["hifigan"], {}, device=DEV)[0]
        p9_expect(got, {**decode, "hifigan_resblock":
                            vocoder_launches(hk, gen, 1)}, "9a tts (HiFi-GAN)")
        del gen

        # 9b: WaveGlow behind a 160-mel Tacotron2, with the denoiser
        stats, got = p9_tts(files, "taco160", "waveglow",
                            ["--denoiser", "--denoise_strength", "0.1"],
                            tmp / "b.wav", smi)
        with wave.open(str(tmp / "b.wav")) as w:
            rate, n = w.getframerate(), w.getnframes()
        flow = P9_SEGMENTS * P9_STEPS * FLOW_HOP
        if (rate, n) != (FLOW_SR, flow):
            raise SystemExit(f"chip_smoke: 9b wrote {n} samples at {rate} Hz, "
                             f"expected {flow} at {FLOW_SR}")
        # the request's one vocode (the denoiser's bias pass runs while the
        # worker is built, before the command starts counting)
        per_infer = WAVEGLOW["n_flows"] * hk.wn_launches(WAVEGLOW["n_layers"])
        p9_expect(got, {**decode, "waveglow_wn_forward": per_infer},
                  "9b tts (WaveGlow, --denoiser)")

        # 9c: the server's worker, in this process
        torch.cuda.reset_peak_memory_stats()
        args = cli.build_parser().parse_args(
            ["server", "--checkpoint", files["taco80"], "--vocoder",
             files["hifigan"], "--torchmoji", files["pytorch_model.bin"],
             "--torchmoji_vocab", files["vocabulary.json"], "--arpa_dict",
             files["merged.dict"], "--speaker_info", files["speaker_info.txt"],
             "--hparams", P9_HPARAMS, "--device", DEV])
        t0 = time.perf_counter()
        t2s = cli._build_t2s(args)
        log(f"  9c _build_t2s in {time.perf_counter() - t0:.2f} s")
        plain = T2S(t2s.cfg, t2s.model, t2s.speaker_ids, vocoder_fn=t2s.vocoder_fn,
                    torchmoji_fn=t2s.torchmoji_fn, arpa_fn=t2s.arpa_fn,
                    sample_rate=t2s.sample_rate, hop_length=t2s.hop_length,
                    device=DEV)
        results = {}

        def recording(worker, name):
            infer = worker.infer

            def run(*a, **kw):
                res = infer(*a, **kw)
                results.setdefault((name, kw["style_mode"]), []).append(res)
                return res
            worker.infer = run
        recording(t2s, "main")
        recording(plain, "plain")
        registry = ModelRegistry({"main": t2s, "plain": plain}, "main")
        requests = [{"text": P9_TEXT, "speaker": "alice", "style_mode": "torchmoji",
                     "use_arpabet": "1", "batch_size": 4, "max_attempts": 1},
                    {"input_text": P9_TEXT, "input_speaker": "bob",
                     "input_style_mode": "none", "input_batch_size": "4",
                     "input_max_attempts": "1"},
                    {"text": P9_TEXT, "speaker": "bob", "style_mode": "torchmoji",
                     "batch_size": 4, "max_attempts": 1}]
        gen = t2s.vocoder_fn.func
        (tmp / "out").mkdir()
        handle_tts(registry, requests[0].get, str(tmp / "out"))    # warm-up
        results.clear()
        hk.reset_launch_counts()
        times = []
        for fields in requests:
            t0 = time.perf_counter()
            _, wav = handle_tts(registry, fields.get, str(tmp / "out"))
            times.append(time.perf_counter() - t0)
            with wave.open(io.BytesIO(wav)) as w:
                if (w.getframerate(), w.getnframes()) != (SR, n_samples):
                    raise SystemExit("chip_smoke: 9c handle_tts gave a bad WAV")
        got = dict(hk.LAUNCHES)
        log(f"  9c handle_tts, warm: {', '.join(f'{t * 1e3:.1f}' for t in times)} "
            f"ms per request ({P9_SEGMENTS} segments, {P9_STEPS} steps, B=4); "
            f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
            f"({smi})")
        p9_expect(got, {k: 3 * n for k, n in decode.items()} | {
            "hifigan_resblock": vocoder_launches(hk, gen, 3)},
            "9c handle_tts x3")
        diff = max(float(np.abs(a - b).max()) for a, b in zip(
            results[("main", "torchmoji")][0]["mels"],
            results[("main", "none")][0]["mels"]))
        log(f"  9c style_mode torchmoji against none: max |mel diff| {diff:.3e}")
        if not diff > 1e-3:
            raise SystemExit("chip_smoke: the torchMoji feature does not "
                             "condition the served mels")
        with plain_kernels(hk):
            for fields in requests:
                handle_tts(registry, lambda k, _f=fields: "plain" if k == "model"
                           else _f.get(k), str(tmp / "out"))
        for mode in ("torchmoji", "none"):
            for k_res, p_res in zip(results[("main", mode)],
                                    results[("plain", mode)]):
                for m_k, m_p in zip(k_res["mels"], p_res["mels"]):
                    check("slice", torch.from_numpy(m_k), torch.from_numpy(m_p),
                          1e-3, 1e-3, f"9c served mel ({mode})")
                check("slice", torch.from_numpy(k_res["audio"]),
                      torch.from_numpy(p_res["audio"]), 1e-3, 1e-3,
                      f"9c served audio ({mode})")

        # 9d: torchMoji on the card against the CPU, and its share
        enc = t2s.torchmoji_fn
        cpu = TorchMojiEncoder(enc.vocab, enc.model.state_dict(), device="cpu")
        segs = results[("main", "torchmoji")][0]["segments"]
        for text in segs + ["@someone check https://x.org 3.5 :)"]:
            card, ref = torch.from_numpy(enc(text)), torch.from_numpy(cpu(text))
            check("torchmoji", card, ref, 1e-5 * float(ref.abs().max()), 1e-5,
                  "card against CPU")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for text in segs * 5:
            enc(text)
        tm_ms = (time.perf_counter() - t0) * 1e3 / (5 * len(segs))
        share = tm_ms * len(segs) / (times[0] * 1e3)
        log(f"  9d torchMoji: {tm_ms:.2f} ms per segment (tokens to the feature "
            f"on the host), {share:.3f} of a warm {P9_SEGMENTS}-segment request "
            f"({smi})")
        del t2s, plain, registry, gen, enc


# -- phase 10: GMM and DCA attention, training with the heads, convert -------

P10_STEPS = 128
P10_TYPES = ((1, dict(num_att_mixtures=5)), (2, {}))     # GMM 5, DCA 128 x 21
P10_DEC = 200            # phase 7's T_dec (800) cut to hold the script's time


def phase10a(hk, check, tcfg, hcfg, smi):
    """GMM (5 mixtures) and DCA (128 filters of 21) decodes at full width
    behind phase 4's HiFi-GAN, gate threshold 2 (a fixed length): one T2S
    request (attention_step must launch 0 times, lstm_gates 3 a step, the
    resblock its launches a vocoder call), the decode chunk replayed as a
    CUDA graph against the eager chunk (bit for bit, every state leaf and
    GMM's means included) and against the plain kernels (phase 5's
    tolerance), and one streaming_tts request."""
    import torch
    from cookietts_tpu_torch.models.hifigan import Generator
    from cookietts_tpu_torch.models.tacotron2 import Tacotron2
    from cookietts_tpu_torch.pipeline.chunk_graph import DecodeChunkGraphs
    from cookietts_tpu_torch.pipeline.text2speech import T2S, T2SConfig
    from torch.utils import _pytree as pytree
    out = {}
    for att, extra in P10_TYPES:
        name = {1: "GMM", 2: "DCA"}[att]
        torch.manual_seed(30 + att)
        taco = Tacotron2(dataclasses.replace(tcfg, attention_type=att,
                                             gate_threshold=2.0, **extra),
                         device="cuda")
        gen = Generator(hcfg, device="cuda")
        t2s = T2S(T2SConfig(batch_size=4, max_attempts=1,
                            step_buckets=(P10_STEPS,),
                            max_decoder_steps=P10_STEPS, gate_threshold=2.0),
                  taco, {"alice": 0, "bob": 1}, vocoder_fn=gen,
                  sample_rate=SR, hop_length=HOP, device="cuda")
        t2s.infer(P9_TEXT, speaker=["alice"], seed=1)          # captures
        hk.reset_launch_counts()
        t0 = time.perf_counter()
        res = t2s.infer(P9_TEXT, speaker=["alice", "bob"], seed=2)
        torch.cuda.synchronize()
        req_ms = (time.perf_counter() - t0) * 1e3
        got = {k: hk.LAUNCHES[k] for k in ("attention_step", "lstm_gates",
                                           "hifigan_resblock")}
        want = {"attention_step": 0, "lstm_gates": 3 * P10_STEPS,
                "hifigan_resblock": vocoder_launches(hk, gen, 1)}
        n = len(res["audio"])
        log(f"  10a {name}: T2S request, {len(res['segments'])} segments at "
            f"B=4, {P10_STEPS} steps: {req_ms:.1f} ms ({req_ms / P10_STEPS:.3f} "
            f"ms a decode step, vocoder included), {n / SR:.2f} s of audio; "
            f"launches {got} (expected {want}) ({smi})")
        if got != want:
            raise SystemExit(f"chip_smoke: 10a {name} launch counts")
        if n != len(res["segments"]) * P10_STEPS * HOP or not np_finite(res["audio"]):
            raise SystemExit(f"chip_smoke: 10a {name} audio: {n} samples")

        B, T, S = 4, 64, 32
        memory, const, state = taco.inference_prepare(*decode_inputs(taco, B, T, 13))
        program = DecodeChunkGraphs(taco.decoder)
        seeded = lambda: torch.Generator(device="cuda").manual_seed(23)  # noqa: E731
        program(memory, const, state, S, seeded())              # eager, capture
        per_replay = program.graphs[(tuple(memory.shape), S)].launches
        replayed = program(memory, const, state, S, seeded())
        eager = taco.decode_chunk(memory, const, state, S, seeded())
        with plain_kernels(hk):
            plain = taco.decode_chunk(memory, const, state, S, seeded())
        want = {**{k: 0 for k in hk.LAUNCHES}, "lstm_gates": 3 * S}
        same = all(torch.equal(a, b) for a, b in zip(
            pytree.tree_leaves(replayed), pytree.tree_leaves(eager)))
        log(f"  10a {name}: replayed chunk (B={B} T_enc={T} S={S}, launches "
            f"{per_replay}) bit-identical to the eager chunk, every state leaf "
            f"(mu {tuple(eager[3].attention.mu.shape)}) included: {same}")
        if per_replay != want or not same:
            raise SystemExit(f"chip_smoke: 10a {name} replayed chunk")
        for i, what in enumerate(("mel", "gate", "alignments")):
            check("slice", eager[i], plain[i], (1e-3, 1e-3, 1e-4)[i], 1e-3,
                  f"{name} chunk {what} vs plain")
        out[name] = dict(request_ms=req_ms,
                         stream=phase6_stream(hk, check, taco, gen, 1, smi,
                                              steps=P10_STEPS))
        del t2s, taco, gen, program
    return out


def np_finite(a):
    import numpy as np
    return bool(np.isfinite(a).all())


def labelled_batch(cfg, seed, T_dec):
    """synthetic_batch with emotion ids (a quarter unknown) and their
    one-hot rows."""
    import torch
    batch = synthetic_batch(cfg, seed, T_dec=T_dec)
    C = cfg.n_emotion_classes
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    ids = torch.randint(0, C, (TRAIN_B,), device="cuda", generator=g)
    ids[::4] = C
    onehot = torch.nn.functional.one_hot(ids.clamp_max(C - 1), C).float()
    batch["emotion_id"] = ids
    batch["emotion_onehot"] = onehot * (ids < C)[:, None]
    return batch


def phase10b_step(hk, tcfg, smi):
    """One train step with both heads at B=16, T_txt=64, T_dec=200: the
    kernels against the plain versions from the same weights and generator
    seed (loss rel 1e-5, every gradient relative L2 1e-4), then the card
    against the CPU with every draw fixed (dropouts 0, no postnet, SylpsNet
    and zu eps given; 1e-4)."""
    import torch
    from cookietts_tpu_torch.losses import DEFAULT_LOSS_SCALARS
    from cookietts_tpu_torch.models.tacotron2 import Tacotron2
    from cookietts_tpu_torch.runtime.optim import adam
    from cookietts_tpu_torch.runtime.train_state import TrainState
    cfg = dataclasses.replace(tcfg, use_gst=True, use_emotionnet=True)
    ctrl = {"lr": 1e-3, "grad_clip": 1.0, "p_teacher_forcing": 1.0,
            "teacher_force_till": 20, "drop_frame_rate": 0.0,
            "guided_att_sigma": 0.5, **DEFAULT_LOSS_SCALARS}
    batch = labelled_batch(cfg, 8, P10_DEC)

    def step(model, b, plain=False, **noise):
        state = TrainState.create(model, adam())
        hk.reset_launch_counts()
        with plain_kernels(hk) if plain else contextlib.nullcontext():
            loss, grads, fwd, bwd, upd = timed_train_step(model, state, b, ctrl,
                                                          seed=12, **noise)
        return (loss, {k: v for k, v in grads.items() if v is not None},
                fwd + bwd + upd, dict(hk.LAUNCHES))

    torch.manual_seed(9)
    model = Tacotron2(cfg, device="cuda")
    init = {k: v.clone() for k, v in model.state_dict().items()}
    lk, gk, msk, nk = step(model, batch)
    model.load_state_dict(init)
    lp, gp, msp, np_ = step(model, batch, plain=True)
    model.load_state_dict(init)
    msk_warm = step(model, batch)[2]          # the first step ran cold
    worst, tiny = compare_grads(gk, gp)
    loss_rel = abs(lk - lp) / abs(lp)
    heads = sum(1 for k in gk if k.startswith(("gst.", "emotion_net.",
                                               "aux_emotion_net.")))
    log(f"  10b train step with both heads, B={TRAIN_B} T_dec={P10_DEC}: kernels "
        f"{msk / 1e3:.3f} s/iter (first), {msk_warm / 1e3:.3f} (warm), plain "
        f"{msp / 1e3:.3f} s/iter ({smi}); "
        f"launches attention_step {nk['attention_step']} lstm_gates "
        f"{nk['lstm_gates']} (want {P10_DEC}, {3 * P10_DEC}); loss kernels "
        f"{lk:.7f} plain {lp:.7f} rel {loss_rel:.2e} (limit 1e-5); {len(gp)} "
        f"gradients ({heads} of the heads), largest relative L2 "
        f"{', '.join(f'{k} {r:.2e}' for r, k in worst[:3])} (limit 1e-4; "
        f"{len(tiny)} numerically zero)")
    if (nk["attention_step"], nk["lstm_gates"]) != (P10_DEC, 3 * P10_DEC) or any(
            np_[k] for k in ("attention_step", "lstm_gates")):
        raise SystemExit("chip_smoke: 10b train step launch counts")
    if not (loss_rel <= 1e-5 and worst[0][0] <= 1e-4 and heads > 0
            and math.isfinite(lk)):
        raise SystemExit("chip_smoke: 10b the kernel-path train step with the "
                         "heads disagrees with the plain path")
    del model, gk, gp

    # the card against the CPU: nothing drawn
    fixed = dataclasses.replace(cfg, p_prenet_dropout=0.0, encoder_conv_dropout=0.0,
                                p_attrnn_dropout=0.0, p_decrnn_dropout=0.0,
                                use_postnet=False)
    g = torch.Generator(device="cuda").manual_seed(14)
    noise = {"sylps_noise": torch.randn(TRAIN_B, device="cuda", generator=g),
             "head_noise": {k: torch.randn(TRAIN_B, cfg.emotionnet_latent_dim,
                                           device="cuda", generator=g)
                            for k in ("emotion_net", "aux_emotion_net")}}
    runs = {}
    for dev in ("cuda", "cpu"):
        torch.manual_seed(9)
        model = Tacotron2(fixed, device="cpu")
        for net in (model.emotion_net, model.aux_emotion_net):
            net.cfg = dataclasses.replace(net.cfg, classifier_dropout=0.0,
                                          encoder_outputs_dropout=0.0)
        model.to(dev)
        to = lambda t: t.to(dev)  # noqa: E731
        runs[dev] = step(model, {k: to(v) for k, v in batch.items()},
                         sylps_noise=to(noise["sylps_noise"]),
                         head_noise={k: to(v) for k, v in noise["head_noise"].items()})
        del model
    (lc, gc, msc, _), (lh, gh, msh, _) = runs["cuda"], runs["cpu"]
    worst, tiny = compare_grads(gc, gh)
    loss_rel = abs(lc - lh) / abs(lh)
    log(f"  10b card against CPU (no draws): loss {lc:.7f} / {lh:.7f} rel "
        f"{loss_rel:.2e} (limit 1e-4); largest gradient relative L2 "
        f"{', '.join(f'{k} {r:.2e}' for r, k in worst[:3])} (limit 1e-4; "
        f"{len(tiny)} numerically zero); card {msc / 1e3:.3f} s/iter, CPU "
        f"{msh / 1e3:.3f} s/iter")
    if not (loss_rel <= 1e-4 and worst[0][0] <= 1e-4):
        raise SystemExit("chip_smoke: 10b the card's train step with the heads "
                         "disagrees with the CPU's")
    return dict(kernels_s=msk_warm / 1e3, plain_s=msp / 1e3)


def phase10b_cli(hk, tmp):
    """The train command with both heads on phase 7a's corpus, emotion ids
    on half of its lines (the rest unlabelled): 2 iterations, then a resume
    to 3 (with a validation); the kernels launched once per decoder step."""
    import torch
    from cookietts_tpu_torch.cli import main as cli
    from cookietts_tpu_torch.data.evidence_corpus import make_corpus
    train_fl, val_fl = make_corpus(str(tmp / "corpus"), seed=0, n_train=32,
                                   n_val=16)
    for fl in (train_fl, val_fl):
        lines = Path(fl).read_text().splitlines()
        Path(fl).write_text("".join(ln + (f"||{i % 5}" if i % 2 == 0 else "")
                                    + "\n" for i, ln in enumerate(lines)))
    run = tmp / "run10"
    args = ["train", "--model", "tacotron2", "--filelist", train_fl,
            "--run_dir", str(run), "--seed", "0", "--hparams",
            TRAIN_HPARAMS + ",use_gst=True,use_emotionnet=True"]
    for iters, resume, validations in ((2, [], 0), (3, ["--resume"], 1)):
        hk.reset_launch_counts()
        t0 = time.perf_counter()
        trainer = cli(args + ["--iters", str(iters)] + resume)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = dict(hk.LAUNCHES)
        want = expected_launches(trainer, iters - (2 if resume else 0), validations)
        log(f"  10b train with both heads {'--resume ' if resume else ''}to "
            f"{iters}: {dt:.1f} s (data and validation included); launches "
            f"attention_step {n['attention_step']} (want {want}), lstm_gates "
            f"{n['lstm_gates']} (want {3 * want})")
        if (n["attention_step"], n["lstm_gates"]) != (want, 3 * want):
            raise SystemExit("chip_smoke: 10b train command launch counts")
        if int(trainer.state.step) != iters:
            raise SystemExit(f"chip_smoke: 10b trained to {trainer.state.step}")
    train, val = train_events(run)
    log(f"  10b losses by step {[(k, round(v, 4)) for k, v, _ in train]}; "
        f"validation {[round(v, 4) for v in val]}")
    if [k for k, _, _ in train] != [0, 1, 2] or len(val) != 1 or not all(
            math.isfinite(v) for v in [v for _, v, _ in train] + val):
        raise SystemExit("chip_smoke: 10b a loss is missing or not finite")
    meta = json.loads((run / "checkpoint_3.json").read_text())
    if not (meta["model_config"].get("use_gst")
            and meta["model_config"].get("use_emotionnet")):
        raise SystemExit("chip_smoke: 10b checkpoint sidecar lacks the heads")


def p10_convert(model, src, dst):
    """The convert command's entry point (cli.main) in this process; its
    seconds."""
    import io
    from cookietts_tpu_torch.cli import main as cli
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli(["convert", "--model", model, "--torch_ckpt", str(src), "-o",
             str(dst)])
    return time.perf_counter() - t0


def phase10c(tmp, tcfg, hcfg, smi):
    """The convert command on reference-layout files of phase 9's seeded
    weights (Tacotron2 with both heads, the phase-4 HiFi-GAN, torchMoji) and
    a WaveGlow of phase 4b's widths in the reference layout (single
    upsampler, coupling "second"): every converted state dict equals its
    source bit for bit; the converted Tacotron2 and HiFi-GAN served through
    _build_t2s give phase 9's checkpoints' mels and audio."""
    import numpy as np
    import torch
    from cookietts_tpu_torch import cli
    from cookietts_tpu_torch.models.hifigan import Generator
    from cookietts_tpu_torch.models.tacotron2 import Tacotron2
    from cookietts_tpu_torch.models.torchmoji import TorchMoji
    from cookietts_tpu_torch.runtime.checkpoint import load_checkpoint, save_checkpoint
    heads = {"use_gst": True, "use_emotionnet": True}
    cfg = dataclasses.replace(tcfg, **heads)
    torch.manual_seed(20)                               # p9_files' taco80
    taco = Tacotron2(cfg, device="cpu").state_dict()
    torch.manual_seed(22)                               # p9_files' hifigan
    hifi = Generator(hcfg, device="cpu").state_dict()
    torch.manual_seed(24)
    tm = TorchMoji(device="cpu").state_dict()
    wg = make_flow_vocoder(dict(WAVEGLOW, upsample_mode="single",
                                upsample_win_length=2 * FLOW_HOP,
                                couple_transform="second", upsample_strides=()),
                           seed=23).cpu().state_dict()
    sources = {"tacotron2": ({"state_dict": taco}, taco),
               "hifigan": ({"model": hifi}, hifi),
               "torchmoji": (tm, tm), "waveglow": ({"state_dict": wg}, wg)}
    times = {}
    for name, (tree, sd) in sources.items():
        torch.save(tree, tmp / f"{name}_ref.pt")
        times[name] = p10_convert(name, tmp / f"{name}_ref.pt", tmp / name)
        got, meta = load_checkpoint(str(tmp / name))
        same = set(got["state_dict"]) == set(sd) and all(
            torch.equal(got["state_dict"][k], t) for k, t in sd.items())
        log(f"  10c convert {name}: {times[name]:.2f} s in this process "
            f"({sum(t.numel() for t in sd.values()) / 1e6:.1f} M values); "
            f"state dict bit for bit: {same}; sidecar {meta}")
        if not same or meta["model"] != name:
            raise SystemExit(f"chip_smoke: 10c convert {name}")
    hints = json.loads((tmp / "waveglow.json").read_text())["model_config"]
    if any(hints[k] != WAVEGLOW[k] for k in ("n_flows", "n_group", "n_layers",
                                             "n_channels", "n_early_every",
                                             "n_early_size")):
        raise SystemExit(f"chip_smoke: 10c WaveGlow hints {hints}")

    # phase 9's checkpoints of the same weights, and the converted ones
    save_checkpoint(str(tmp / "taco80"), {"state_dict": taco},
                    {"model": "tacotron2", "model_config": {
                        k: v for k, v in dataclasses.asdict(cfg).items()
                        if k != "dtype"}, "speaker_ids": {"narrator": 0}})
    save_checkpoint(str(tmp / "hifigan80"), {"state_dict": hifi},
                    {"model": "hifigan", "model_config": {
                        k: v for k, v in dataclasses.asdict(hcfg).items()
                        if k != "dtype"}})
    served = {}
    for key, taco_ckpt, voc in (("phase 9", "taco80", "hifigan80"),
                                ("converted", "tacotron2", "hifigan")):
        args = cli.build_parser().parse_args(
            ["server", "--checkpoint", str(tmp / taco_ckpt), "--vocoder",
             str(tmp / voc), "--device", "cuda", "--hparams",
             P9_HPARAMS + ",use_gst=True,use_emotionnet=True"])
        t2s = cli._build_t2s(args)
        t0 = time.perf_counter()
        served[key] = t2s.infer(P9_TEXT, seed=3, max_attempts=1)
        log(f"  10c {key} checkpoints served through _build_t2s: "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms (cold, captures "
            f"included) ({smi})")
        del t2s
    a, b = served["phase 9"], served["converted"]
    diff = max([float(np.abs(x - y).max()) for x, y in zip(a["mels"], b["mels"])]
               + [float(np.abs(a["audio"] - b["audio"]).max())])
    log(f"  10c converted against phase 9's checkpoints: max |diff| of mels "
        f"and audio {diff:.3e} (must be 0)")
    if diff != 0.0 or len(a["audio"]) == 0:
        raise SystemExit("chip_smoke: 10c the converted checkpoints serve "
                         "other mels or audio")
    return times


def phase10(hk, check, tcfg, hcfg, smi):
    import tempfile
    t0 = time.perf_counter()
    out = {"a": phase10a(hk, check, tcfg, hcfg, smi)}
    log(f"  phase 10a in {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    out["b"] = phase10b_step(hk, tcfg, smi)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        phase10b_cli(hk, Path(tmp))
        log(f"  phase 10b in {time.perf_counter() - t1:.1f} s")
        t2 = time.perf_counter()
        out["c"] = phase10c(Path(tmp), tcfg, hcfg, smi)
        log(f"  phase 10c in {time.perf_counter() - t2:.1f} s; {smi}")
    return out


# -- phase 11: serving exported artifacts --------------------------------------

P11_TEXT_BUCKET, P11_SEEDS = 64, (0, 1, 2)
# 11b's requests: four segments, one a row of the batch of 4, so that the
# best-of-N pick has one candidate a segment (two candidates of one
# segment can score within rounding of each other, and the two workers
# then pick different rows)
P11_TEXT = ('Hello world, the port serves an artifact. "What a quick fox!" '
            'she said. "Go!"')
P11_SEGMENTS = 4
P11_MEL_FRAMES = 32      # the flow vocoders' artifacts: 0.4 s of 48 kHz audio


def p11_export(files, out, smi):
    """The export command in this process on phase 9's seeded Tacotron2 and
    HiFi-GAN: B = 4, one text bucket of 64, P9_STEPS decoder steps, a mel
    bucket of P9_STEPS frames, the gate threshold 2; logs its wall time and
    the artifact's bytes."""
    import io
    from cookietts_tpu_torch.cli import main as cli
    argv = ["export", "--checkpoint", files["taco80"], "--vocoder",
            files["hifigan"], "-o", str(out), "--batch", "4", "--text_buckets",
            str(P11_TEXT_BUCKET), "--mel_buckets", str(P9_STEPS),
            "--max_decoder_steps", str(P9_STEPS), "--hparams",
            "gate_threshold=2.0", *([] if DEV == "cuda" else ["--device", DEV])]
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli(argv)
    seconds = time.perf_counter() - t0
    got = json.loads(buf.getvalue().strip().splitlines()[-1])
    log(f"  11a export: {seconds:.2f} s wall in this process (its entry "
        f"point, cli.main), {got['bytes']} bytes "
        f"({Path(out).stat().st_size} on disk), functions {got['functions']} "
        f"({smi})")


def p11_requests(hk, t2s, seeds):
    """Each seed's request of P11_TEXT through ``t2s.infer`` (phase 9a's
    flags): (the results, the launches of all of them, each request's wall
    ms)."""
    import torch
    hk.reset_launch_counts()
    results, ms = [], []
    for seed in seeds:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results.append(t2s.infer(P11_TEXT, speaker="bob", use_arpabet=True,
                                 max_attempts=1, seed=seed))
        if len(results[-1]["segments"]) != P11_SEGMENTS:
            raise SystemExit(f"chip_smoke: 11b split P11_TEXT into "
                             f"{results[-1]['segments']}")
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return results, dict(hk.LAUNCHES), ms


def phase11_serving(hk, check, files, art, smi):
    """11b: three requests (P11_TEXT) through _build_t2s(--artifact)'s
    worker, launch counters zeroed just before (attention_step 1 and
    lstm_gates 3 a decode step, the resblock its launches a vocoder call),
    against the live --checkpoint worker at the same seeds (phase 5's
    tolerance); three warm requests of each, and the artifact's chunk
    replays and captures."""
    import torch
    from cookietts_tpu_torch import cli
    flags = ["--torchmoji", files["pytorch_model.bin"], "--torchmoji_vocab",
             files["vocabulary.json"], "--arpa_dict", files["merged.dict"],
             "--speaker_info", files["speaker_info.txt"], "--hparams",
             P9_HPARAMS, "--device", DEV]
    parse = lambda src: cli.build_parser().parse_args(["server", *src, *flags])
    t0 = time.perf_counter()
    served = cli._build_t2s(parse(["--artifact", str(art)]))
    t1 = time.perf_counter()
    live = cli._build_t2s(parse(["--checkpoint", files["taco80"], "--vocoder",
                                 files["hifigan"]]))
    log(f"  11b _build_t2s (torchMoji included): --artifact {t1 - t0:.2f} s, "
        f"--checkpoint {time.perf_counter() - t1:.2f} s")
    if served.model is not None or served.cfg.batch_size != 4:
        raise SystemExit("chip_smoke: the artifact worker holds a model or "
                         "the wrong batch")
    got, launches, _ = p11_requests(hk, served, P11_SEEDS)
    gen = cli._load_vocoder(files["hifigan"], {}, device=DEV)[0]
    n = len(P11_SEEDS)
    p9_expect(launches, {"attention_step": n * P9_STEPS,
                         "lstm_gates": 3 * n * P9_STEPS,
                         "hifigan_resblock": vocoder_launches(hk, gen, n)},
              f"11b artifact worker x{n}")
    want, _, _ = p11_requests(hk, live, P11_SEEDS)
    for seed, g, w in zip(P11_SEEDS, got, want):
        if g["mel_lengths"].tolist() != w["mel_lengths"].tolist():
            raise SystemExit(f"chip_smoke: 11b mel lengths {g['mel_lengths']} "
                             f"against live {w['mel_lengths']}")
        for m_g, m_w in zip(g["mels"], w["mels"]):
            check("slice", torch.from_numpy(m_g), torch.from_numpy(m_w), 1e-3,
                  1e-3, f"11b artifact mel against live (seed {seed})")
        check("slice", torch.from_numpy(g["audio"]), torch.from_numpy(w["audio"]),
              1e-3, 1e-3, f"11b artifact audio against live (seed {seed})")
    warm = {"artifact": [], "live": []}
    for seed in (7, 8, 9):                  # alternating, host timings spread
        for name, t2s in (("artifact", served), ("live", live)):
            warm[name] += p11_requests(hk, t2s, (seed,))[2]
    dec = served.decode_fn.__self__
    chunks = dec.chunk_programs[0]
    log(f"  11b warm requests ({P11_SEGMENTS} segments, B=4, {P9_STEPS} steps, "
        f"HiFi-GAN), alternating: artifact "
        f"{', '.join(f'{t:.1f}' for t in warm['artifact'])} ms, live "
        f"{', '.join(f'{t:.1f}' for t in warm['live'])} ms; artifact chunk "
        f"program: {chunks.captures} "
        f"captures, {chunks.replays} replays, {chunks.eager_calls} eager "
        f"chunks; live: {live.decode_chunk.captures} captures, "
        f"{live.decode_chunk.replays} replays ({smi})")


def p11_flow(hk, check, name, model, gen, smi):
    """One flow vocoder as an artifact (11c), exported in this process at
    B = 1 and P11_MEL_FRAMES frames: its vocode against the live
    WaveGlow.infer at the same z (phase 5's tolerance), the WN kernel's
    launches exactly one infer's, the auto_functionalized nodes (a copy of
    the ring a row step) in the program, and the vocode's ms against the
    live infer's."""
    import io

    import torch
    from cookietts_tpu_torch.device import full_float32
    from cookietts_tpu_torch.runtime import export_serving as es
    cfg = model.cfg
    n = P11_MEL_FRAMES * cfg.hop_length // cfg.n_group
    z_shape = lambda B, T: ((B, cfg.n_group, n) if model.waveflow
                            else (B, n, cfg.n_group))
    mel = torch.randn(1, P11_MEL_FRAMES, FLOW_MELS, device="cuda", generator=gen)
    z = 0.6 * torch.randn(z_shape(1, P11_MEL_FRAMES), device="cuda",
                          generator=gen)
    t0 = time.perf_counter()
    blob = es.export_vocoder_serving(lambda m, z_: model.infer(m, z=z_),
                                     FLOW_MELS, [(1, P11_MEL_FRAMES)],
                                     needs_key=True, z_shape=z_shape)
    seconds = time.perf_counter() - t0
    key = f"vocoder_b1_t{P11_MEL_FRAMES}"
    program = torch.export.load(io.BytesIO(blob[key]))
    copies = sum("auto_functionalized" in str(node.target)
                 for node in program.graph.nodes)
    fn = program.module()
    kernel = "waveflow_row_step" if model.waveflow else "waveglow_wn_forward"
    per_infer = cfg.n_flows * hk.wn_launches(cfg.n_layers) * (
        cfg.n_group if model.waveflow else 1)
    hk.reset_launch_counts()
    with full_float32():
        got = fn(mel, z)
    if hk.LAUNCHES[kernel] != per_infer:
        raise SystemExit(f"chip_smoke: 11c {name} artifact launched {kernel} "
                         f"{hk.LAUNCHES[kernel]} times, not {per_infer}")
    check("slice", got, model.infer(mel, z=z), 1e-3, 1e-3,
          f"11c {name} artifact against live infer, same z")
    with full_float32():
        art_ms = wall_ms(lambda: fn(mel, z), reps=3)
    live_ms = wall_ms(lambda: model.infer(mel, z=z), reps=3)
    log(f"  11c {name}: export {seconds:.2f} s, {len(blob[key])} bytes; "
        f"{per_infer} {kernel} launches; {copies} auto_functionalized nodes; "
        f"vocode {art_ms:.2f} ms artifact, {live_ms:.2f} ms live ({smi})")


def phase11(hk, check, tcfg, hcfg, smi):
    """11a: the export command, then tts --artifact, each through its entry
    point (cli.main) in this process at the default device on phase 9's
    seeded checkpoints and phase 9a's flags (the WAV's length, the stats
    line, launches, wall time); 11b and 11c above."""
    import tempfile
    import wave

    import torch
    from cookietts_tpu_torch import cli
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        files = p9_files(tmp, tcfg, hcfg, flows=False)
        art = tmp / "serving.npz"
        p11_export(files, art, smi)
        stats, got = p9_tts(files, None, "artifact", [], tmp / "a.wav", smi,
                            source=["--artifact", str(art)])
        with wave.open(str(tmp / "a.wav")) as w:
            rate, n = w.getframerate(), w.getnframes()
        if (rate, n, stats["segments"]) != (SR, P9_SEGMENTS * P9_STEPS * HOP,
                                            P9_SEGMENTS):
            raise SystemExit(f"chip_smoke: 11a wrote {n} samples at {rate} Hz "
                             f"in {stats['segments']} segments")
        gen = cli._load_vocoder(files["hifigan"], {}, device=DEV)[0]
        p9_expect(got, {"attention_step": P9_STEPS, "lstm_gates": 3 * P9_STEPS,
                        "hifigan_resblock": vocoder_launches(hk, gen, 1)},
                  "11a tts --artifact")
        del gen

        phase11_serving(hk, check, files, art, smi)
    # 11c: phase 4b's WaveGlow with ISO 226 de-emphasis off, then on, and
    # its WaveFlow
    gen = torch.Generator(device="cuda").manual_seed(111)
    glow = make_flow_vocoder(WAVEGLOW, seed=3)
    p11_flow(hk, check, "WaveGlow", glow, gen, smi)
    glow.cfg = dataclasses.replace(glow.cfg, iso226_deemphasis=True)
    p11_flow(hk, check, "WaveGlow+ISO226", glow, gen, smi)
    del glow
    p11_flow(hk, check, "WaveFlow", make_flow_vocoder(WAVEFLOW, seed=3), gen, smi)


# -- phase 12: the GTA stage and its two adversarial trainers -----------------

# the evidence corpus's front end (22050 Hz, hop 256) at the model's 80 mels,
# the data config's own text and mel buckets
GTA_HPARAMS = ("sampling_rate=22050,filter_length=1024,hop_length=256,"
               "win_length=1024,mel_fmax=8000.0,trim_enable=False,"
               "n_mel_channels=80,p_arpabet=0.0")
GTA_UTTERANCES, GTA_BATCH = 12, 8
# the GAN postnet at GANPostnetConfig() on 12a's map (the speaker width from
# the checkpoint's table); the denoiser at HiFiGANDenoiserConfig() on 48 kHz
# clean wavs, batch 4: stage 0 at DenoiserDataConfig()'s 8400-sample
# segments, stage 2 at 76800 (DS's four VALID blocks and crush conv take at
# least 123 frames of the 600-hop bank, 73800 samples; at 8400 JAX's DS
# returns NaN and the port's refuses)
POSTNET = {}            # GANPostnetConfig() (a CPU rehearsal shrinks these)
POSTNET_HPARAMS = (GTA_HPARAMS.replace(",trim_enable=False", "")
                   .replace(",p_arpabet=0.0", "")
                   + ",batch_size=8,validation_interval=2,"
                     "checkpoint_interval=2,log_every=1")
DENOISER = {}           # HiFiGANDenoiserConfig()
DENOISER_HPARAMS = ("batch_size=4,validation_interval=2,checkpoint_interval=2,"
                    "log_every=1")
DENOISER_STAGE2_SEGMENT = 76800


def gta_steps(map_lines, dcfg, batch):
    """Decoder steps the gta command must run: each batch of ``batch``
    lines in map order padded to the data config's mel bucket (or past the
    last bucket in 64-frame steps), from the written mels' lengths."""
    import numpy as np
    from cookietts_tpu_torch.data.dataset import bucket_size
    lengths = [np.load(ln.split("|")[1], mmap_mode="r").shape[0]
               for ln in map_lines]
    steps = 0
    for i in range(0, len(lengths), batch):
        m = max(lengths[i:i + batch])
        pad = bucket_size(m, dcfg.mel_buckets)
        steps += pad if pad >= m else -(-m // 64) * 64
    return steps


def p12_gta_files(map_lines, n_mel):
    """Every map line's mel is finite [T, n_mel] and its letter durations
    sum to T."""
    import numpy as np
    for ln in map_lines:
        wav, mel_path, _ = ln.split("|")
        mel = np.load(mel_path)
        dur = np.load(mel_path.replace(".mel", ".gdur"))
        if (mel.ndim != 2 or mel.shape[1] != n_mel
                or not np.isfinite(mel).all() or int(dur.sum()) != mel.shape[0]
                or not mel_path.startswith(wav + ".mel")):
            raise SystemExit(f"chip_smoke: GTA output of {wav}: mel "
                             f"{mel.shape}, durations sum {dur.sum()}")


def phase12a(hk, check, tcfg, smi, tmp):
    """12a: a seeded full-width Tacotron2 checkpoint; the gta command in
    this process on the card over a 12-utterance evidence corpus at batch 8 (a
    short last batch): one map line an utterance, finite [T, 80] mels whose
    letter durations sum to T, attention_step once and lstm_gates 3 times a
    decoder step; one batch through GTAGenerator with the kernels against
    the plain versions (1e-4) and, prenet dropout off, the card against the
    CPU (1e-3); --extremeGTA on two utterances; seconds per utterance and
    per second of audio, and the device-busy share. Returns the checkpoint,
    the map and the corpus's filelist (whose wavs now have .gdur.npy
    letter durations beside them)."""
    import numpy as np
    import torch
    from cookietts_tpu_torch.cli import _load_tacotron2
    from cookietts_tpu_torch.cli import main as cli
    from cookietts_tpu_torch.config import parse_override_string
    from cookietts_tpu_torch.data.dataset import DataConfig, TTSDataset, collate
    from cookietts_tpu_torch.data.evidence_corpus import make_corpus
    from cookietts_tpu_torch.data.filelist import load_filelist
    from cookietts_tpu_torch.models.tacotron2 import Tacotron2
    from cookietts_tpu_torch.pipeline.gta import GTAGenerator
    from cookietts_tpu_torch.runtime.checkpoint import save_checkpoint
    train_fl, _ = make_corpus(str(tmp / "corpus"), seed=12,
                              n_train=GTA_UTTERANCES, n_val=0)
    ckpt = tmp / "taco.pt"
    torch.manual_seed(30)
    save_checkpoint(str(ckpt), {"state_dict": Tacotron2(
        tcfg, device="cpu").state_dict()}, {
            "model": "tacotron2", "model_config": {
                k: v for k, v in dataclasses.asdict(tcfg).items()
                if k != "dtype"}, "speaker_ids": {"narrator": 0}})
    overrides = parse_override_string(GTA_HPARAMS)
    dcfg = DataConfig(**{k: v for k, v in overrides.items()
                         if k in DataConfig.__dataclass_fields__})
    out = tmp / "gta"
    t0 = time.perf_counter()
    stats = cli(["gta", "--checkpoint", str(ckpt), "--filelist", train_fl,
                 "-o", str(out), "--batch_size", str(GTA_BATCH), "--hparams",
                 GTA_HPARAMS, "--device", DEV])
    wall = time.perf_counter() - t0
    map_path = out / "map_train_0.txt"
    lines = map_path.read_text().splitlines()
    if len(lines) != GTA_UTTERANCES or stats["utterances"] != len(lines):
        raise SystemExit(f"chip_smoke: gta wrote {len(lines)} map lines for "
                         f"{GTA_UTTERANCES} utterances")
    p12_gta_files(lines, tcfg.n_mel_channels)
    steps = gta_steps(lines, dcfg, GTA_BATCH)
    got = stats["kernel_launches"]
    log(f"  12a gta command: {len(lines)} utterances in batches of "
        f"{GTA_BATCH}, {stats['decoder_steps']} decoder steps (want {steps}); "
        f"launches {got}")
    if (stats["decoder_steps"], got["attention_step"], got["lstm_gates"]) != (
            steps, steps, 3 * steps) or any(
                got[k] for k in got if k not in ("attention_step", "lstm_gates")):
        raise SystemExit("chip_smoke: the gta command's launches are not one "
                         "attention_step and three lstm_gates a decoder step")
    log(f"  12a gta: {stats['seconds']:.3f} s for {stats['audio_seconds']:.2f} "
        f"s of audio in the process (model load left out; loading and "
        f"collating the data {stats['data_seconds']:.3f} s of it; by batch "
        f"{[round(t, 3) for t in stats['batch_seconds']]}): "
        f"{stats['seconds'] / len(lines):.4f} s per utterance, "
        f"{stats['seconds'] / stats['audio_seconds']:.4f} s per second of "
        f"audio; the command {wall:.2f} s wall in this process, its model "
        f"load included ({smi})")

    # one batch in-process: kernels against plain, then card against CPU
    model, _ = _load_tacotron2(str(ckpt), overrides, DEV)
    ds = TTSDataset(load_filelist(train_fl), dcfg)
    batch = collate([ds[i] for i in range(GTA_BATCH)], dcfg)
    gen = GTAGenerator(model, str(tmp / "gta_in"))
    hk.reset_launch_counts()
    mel_k, al_k = gen.forward(batch)
    torch.cuda.synchronize()
    n = dict(hk.LAUNCHES)
    T = batch["mels"].shape[1]
    if (n["attention_step"], n["lstm_gates"]) != (T, 3 * T):
        raise SystemExit(f"chip_smoke: GTAGenerator launches {n} for {T} "
                         "steps")
    with plain_kernels(hk):
        mel_p, al_p = gen.forward(batch)
    check("slice", mel_k, mel_p, 1e-4, 1e-4,
          f"GTA B={GTA_BATCH} T={T} mels, kernel vs plain")
    check("slice", al_k, al_p, 1e-4, 1e-4, "GTA alignments, kernel vs plain")
    for _ in range(2):
        t0 = time.perf_counter()
        gen.forward(batch)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
    wall, busy = busy_share(lambda: gen.forward(batch))
    audio_s = float(batch["mel_lengths"].sum()) * dcfg.hop_length / \
        dcfg.sampling_rate
    log(f"  12a one warm batch B={GTA_BATCH} x {T} steps: {warm:.3f} s, "
        f"{warm / audio_s:.4f} s per second of its {audio_s:.2f} s of audio; "
        f"device busy {busy:.1f} ms of a profiled batch's {wall:.1f} ms = "
        f"{busy / wall:.3f} ({smi})")
    model.decoder.prenet.p = 0.0            # nothing drawn: card against CPU
    cpu, _ = _load_tacotron2(str(ckpt), overrides, "cpu")
    cpu.decoder.prenet.p = 0.0
    mel_g, al_g = gen.forward(batch)
    mel_c, al_c = GTAGenerator(cpu, str(tmp / "gta_cpu")).forward(batch)
    check("slice", mel_g.cpu(), mel_c, 1e-3, 1e-3,
          "GTA mels, card vs CPU (prenet dropout off)")
    check("slice", al_g.cpu(), al_c, 1e-3, 1e-3, "GTA alignments, card vs CPU")
    del cpu, model

    # --extremeGTA on two utterances, in-process
    two = tmp / "two.txt"
    two.write_text("\n".join(Path(train_fl).read_text().splitlines()[:2]))
    hk.reset_launch_counts()
    ex = cli(["gta", "--checkpoint", str(ckpt), "--filelist", str(two), "-o",
              str(tmp / "gta_x"), "--extremeGTA", "128", "--hparams",
              GTA_HPARAMS, "--device", DEV])
    xlines = (tmp / "gta_x" / "map_train_0.txt").read_text().splitlines()
    p12_gta_files(xlines, tcfg.n_mel_channels)
    suffixes = sorted(ln.split("|")[1].rsplit(".wav", 1)[1] for ln in xlines)
    log(f"  12a --extremeGTA 128 on 2 utterances: {len(xlines)} map lines "
        f"{suffixes}, {ex['decoder_steps']} steps, launches "
        f"{ex['kernel_launches']}")
    if (suffixes != [".mel.npy"] * 2 + [".mel128.npy"] * 2
            or ex["kernel_launches"]["attention_step"] != ex["decoder_steps"]):
        raise SystemExit("chip_smoke: --extremeGTA output")
    return ckpt, map_path, train_fl


def p12_train(hk, args, what):
    """The train command in-process on the card: no kernel launched
    (training runs cuDNN), every logged loss finite. Returns the trainer
    and its train records [(step, loss, s)]."""
    import torch
    from cookietts_tpu_torch.cli import main as cli
    hk.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = cli(args)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = dict(hk.LAUNCHES)
    run = Path(args[args.index("--run_dir") + 1])
    train, val = [], []
    for line in (run / "events.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if rec["prefix"] == "train":
            train.append((rec["step"], rec["loss"], rec["iter_s"]))
        elif rec["prefix"] == "validation":
            val.append((rec["step"], rec["val_loss"]))
    log(f"  {what}: {dt:.1f} s (data, validation and set-up included); "
        f"losses {[(k, round(v, 4)) for k, v, _ in train]}, validation "
        f"{[(k, round(v, 4)) for k, v in val]}; launches {got}")
    if any(got.values()) or not all(
            math.isfinite(v) for v in [v for _, v, _ in train]
            + [v for _, v in val]):
        raise SystemExit(f"chip_smoke: {what}: a kernel launched or a loss is "
                         "not finite")
    return trainer, train


def peak_text(base):
    """The peak allocated since the last reset of the peak, and its part
    above ``base``, the bytes resident before the timed steps (the earlier
    phases' leftovers, the models and their optimizer state)."""
    import torch
    peak = torch.cuda.max_memory_allocated()
    return (f"peak {peak / 2 ** 30:.2f} GiB ({(peak - base) / 2 ** 30:.2f} GiB "
            f"above the {base / 2 ** 30:.2f} GiB resident before the step)")


def p12_step_times(trainer, batch, name, smi, reps=3):
    """s per iteration of the trained state's step at the run's batch,
    split into the D and the G step (host clock, synchronised; best of
    ``reps``), peak memory, and the device-busy share of one iteration."""
    import torch
    from cookietts_tpu_torch.device import batch_to_device
    step, state = trainer.train_step, trainer.state
    ctrl = trainer.ctrl(int(state.step))
    dev = batch_to_device(batch, DEV)
    gen = torch.Generator(DEV).manual_seed(0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(reps):
        # the iteration's draws (the postnet's noise; GAN-TTS's z, windows)
        b = step.prepare(dev, gen) if step.prepare else dev
        t0 = time.perf_counter()
        step.d_step(state.d, state.g, b, ctrl)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step.g_step(state.g, state.d, b, ctrl)
        torch.cuda.synchronize()
        times.append((t1 - t0, time.perf_counter() - t1))
    peak = peak_text(base)
    wall, busy = busy_share(lambda: step(state, dev, gen, ctrl))
    d, g = (min(t[i] for t in times) for i in (0, 1))
    shape = "x".join(str(s) for s in next(iter(dev.values())).shape)
    log(f"  {name} step at {shape}: {d + g:.4f} s/iter (D step {d:.4f} s, "
        f"G step {g:.4f} s; best of {reps}), {peak}; device "
        f"busy {busy:.1f} ms of a profiled iteration's {wall:.1f} ms = "
        f"{busy / wall:.3f} ({smi})")


def phase12b(hk, ckpt, map_path, tmp, smi):
    """12b: train --model gan_postnet over 12a's map at GANPostnetConfig()
    with the checkpoint's speaker table, 4 iterations (validation and a
    checkpoint every 2); its D and G steps timed; one D+G step card against
    CPU."""
    import numpy as np
    import torch
    from cookietts_tpu_torch.models.gan_postnet import (GANDiscriminator,
                                                        GANPostnet,
                                                        GANPostnetConfig)
    from cookietts_tpu_torch.runtime.optim import adam
    from cookietts_tpu_torch.runtime.train_state import GANTrainState, TrainState
    from cookietts_tpu_torch.runtime.trainer import (
        gan_postnet_noise, make_gan_postnet_train_steps, make_gan_trainer_step)
    run = tmp / "postnet"
    trainer, _ = p12_train(hk, [
        "train", "--model", "gan_postnet", "--filelist", str(map_path),
        "--run_dir", str(run), "--iters", "4", "--seed", "0", "--device", DEV,
        "--hparams", POSTNET_HPARAMS + f",tacotron2_checkpoint={ckpt}"
        + ("," + hparams_of(POSTNET) if POSTNET else "")],
        "12b train --model gan_postnet to 4")
    tree = torch.load(run / "checkpoint_4", map_location="cpu")
    table = torch.load(ckpt, map_location="cpu")["state_dict"][
        "speaker_embedding.weight"]
    cfg = trainer.state.g.model.cfg
    if (cfg.speaker_embedding_dim != table.shape[1]
            or "d_state_dict" not in tree or cfg != GANPostnetConfig(**{
                **POSTNET, "speaker_embedding_dim": table.shape[1]})):
        raise SystemExit(f"chip_smoke: the GAN postnet's config {cfg} or "
                         "checkpoint")
    batch = trainer.val_batches[0]
    p12_step_times(trainer, batch, "12b GAN postnet", smi)
    del trainer
    # unit-variance mels, as the CPU tests': a random Tacotron2's GTA mels
    # are near constant in time, and BatchNorm's batch statistics over them
    # magnify rounding into the gradients
    rng = np.random.default_rng(0)
    shape = batch["decoder_mel"].shape
    batch = dict(batch, **{k: rng.standard_normal(shape).astype(np.float32)
                           for k in ("decoder_mel", "gt_mel")},
                 noise=rng.standard_normal(shape[:2] + (cfg.noise_dim,))
                 .astype(np.float32))

    def build():
        return GANPostnet(cfg, "cpu"), GANDiscriminator(cfg, "cpu")

    def step_of(modules, device):
        post, disc = modules
        return (make_gan_trainer_step(*make_gan_postnet_train_steps(post, disc),
                                      prepare=gan_postnet_noise(cfg.noise_dim)),
                GANTrainState(TrainState.create(post, adam()),
                              TrainState.create(disc, adam())))

    step_parity("12b GAN postnet", build, step_of, batch,
                {"lr": 2e-4, "grad_clip": 10.0}, check_params=True)


def phase12c(hk, tmp, smi):
    """12c: train --model hifigan_denoiser at HiFiGANDenoiserConfig() on 48
    kHz clean wavs with a noise folder, batch 4: stage 0 for 3 iterations,
    then --resume at stage=2 to 5 (fresh critics); each stage's step timed;
    one stage-2 step card against CPU."""
    import numpy as np
    import torch
    from cookietts_tpu_torch.data import audio_io
    from cookietts_tpu_torch.models.hifigan_denoiser import (
        DenoiserWN, HiFiGANDenoiserConfig, MultiResSpect, SpectDiscriminator,
        WaveDiscriminator)
    from cookietts_tpu_torch.runtime.optim import adam
    from cookietts_tpu_torch.runtime.train_state import GANTrainState, TrainState
    from cookietts_tpu_torch.runtime.trainer import (
        make_gan_trainer_step, make_hifigan_denoiser_train_steps)
    rng = np.random.default_rng(13)
    sr, n = 48000, int(1.8 * DENOISER_STAGE2_SEGMENT)
    clean = []
    for i in range(8):
        t = np.arange(n) / sr
        f0 = rng.uniform(90, 300)
        audio = sum(0.25 / h * np.sin(2 * np.pi * h * f0 * t) for h in range(1, 6))
        audio = audio + 0.01 * rng.standard_normal(n)
        path = tmp / f"clean{i}.wav"
        audio_io.save_wav(str(path), audio.astype(np.float32), sr)
        clean.append(str(path))
    (tmp / "noise").mkdir()
    audio_io.save_wav(str(tmp / "noise" / "hiss.wav"),
                      (0.1 * rng.standard_normal(sr)).astype(np.float32), sr)
    filelist = tmp / "clean.txt"
    filelist.write_text("\n".join(clean) + "\n")
    run = tmp / "denoiser"
    base = ["train", "--model", "hifigan_denoiser", "--filelist",
            str(filelist), "--run_dir", str(run), "--seed", "0", "--device",
            DEV]
    hp = (DENOISER_HPARAMS + f",noise_dir={tmp / 'noise'}"
          + ("," + hparams_of(DENOISER) if DENOISER else ""))
    trainer, _ = p12_train(hk, base + ["--iters", "3", "--hparams", hp],
                           "12c train --model hifigan_denoiser stage 0 to 3")
    p12_step_times(trainer, trainer.val_batches[0], "12c denoiser stage 0", smi)
    del trainer
    hp2 = hp + f",stage=2,segment_length={DENOISER_STAGE2_SEGMENT}"
    trainer, train = p12_train(
        hk, base + ["--iters", "5", "--resume", "--hparams", hp2],
        "12c --resume at stage=2 to 5")
    if [k for k, _, _ in train] != [0, 1, 2, 3, 4] or trainer.state.step != 5:
        raise SystemExit("chip_smoke: the stage promotion did not resume at "
                         "step 3")
    tree = torch.load(run / "checkpoint_4", map_location="cpu")
    if not any(k.startswith("ds.end_conv") for k in tree["d_state_dict"]):
        raise SystemExit("chip_smoke: the stage-2 checkpoint holds no critics")
    batch = trainer.val_batches[0]
    p12_step_times(trainer, batch, "12c denoiser stage 2", smi)
    del trainer
    cfg = HiFiGANDenoiserConfig(stage=2, **DENOISER)
    # broadband audio, as the CPU tests': the log of the near-empty STFT
    # bins of a harmonic clean wav magnifies rounding into the gradients
    t = np.arange(DENOISER_STAGE2_SEGMENT) / sr
    clean = (0.3 * np.sin(2 * np.pi * 97.0 * t)
             + 0.2 * rng.standard_normal(t.shape))[None].astype(np.float32)
    one = {"noisy": (clean + 0.05 * rng.standard_normal(clean.shape)
                     ).astype(np.float32), "clean": clean}

    def build():
        return (DenoiserWN(cfg, "cpu"), WaveDiscriminator(cfg, "cpu"),
                SpectDiscriminator(cfg, "cpu"))

    def step_of(modules, device):
        gen, dw, ds = modules
        mrs = MultiResSpect(cfg.window_lengths, cfg.hop_lengths, device)
        critics = torch.nn.ModuleDict({"dw": dw, "ds": ds})
        return (make_gan_trainer_step(*make_hifigan_denoiser_train_steps(
                    gen, dw, ds, mrs, stage=2), loss_key="loss"),
                GANTrainState(TrainState.create(gen, adam()),
                              TrainState.create(critics, adam())))

    step_parity("12c denoiser stage 2 (B=1)", build, step_of, one,
                {"lr": 2e-4, "grad_clip": 100.0}, check_params=True)


def phase12(hk, check, tcfg, smi, tmp):
    """12a GTA, 12b the GAN postnet, 12c the HiFi-GAN denoiser. Returns 12a's
    corpus filelist (its wavs with .gdur.npy sidecars) for phase 13."""
    t0 = time.perf_counter()
    ckpt, map_path, train_fl = phase12a(hk, check, tcfg, smi, tmp)
    log(f"  phase 12a in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase12b(hk, ckpt, map_path, tmp, smi)
    log(f"  phase 12b in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase12c(hk, tmp, smi)
    log(f"  phase 12c in {time.perf_counter() - t0:.1f} s; {smi}")
    return train_fl


# -- phase 13: the non-autoregressive TTS family ---------------------------------

# UnTTS at UnTTSConfig() and GAN-TTS at GANTTSConfig() (a CPU rehearsal
# shrinks these) on phase 12's corpus, 22050 Hz, 80 mels, batch 8. f0 is in
# Hz, so UnTTS's f0 MSE (weight 0.1) starts near 1e3-1e4, above the default
# explosion threshold of 1e3, which would roll every early step back.
UNTTS = {}
GANTTS = {}
NAR_HPARAMS = (GTA_HPARAMS + ",batch_size=8,validation_interval=3,"
               "checkpoint_interval=3,log_every=1")
UNTTS_HPARAMS = NAR_HPARAMS + ",f0_method=dio,loss_explosion_threshold=1e6"
# 13b: UnTTS inference at B = 4, up to 1024 frames, with durations scaled to
# a few frames a char (a random predictor gives about one)
INFER_B, INFER_FRAMES, INFER_CHARS, INFER_DUR_SCALE = 4, 1024, 100, 8.0
NAR_HOP, NAR_SR = 256, 22050


def p13_step_times(trainer, batch, name, smi, reps=3):
    """s per iteration of UnTTS's trained step at the run's batch (host
    clock, synchronised; best of ``reps``), peak memory (see peak_text) and
    the device-busy share of one more iteration."""
    import torch
    from cookietts_tpu_torch.device import batch_to_device
    step, state = trainer.train_step, trainer.state
    ctrl = trainer.ctrl(int(state.step))
    dev = batch_to_device(batch, DEV)
    gen = torch.Generator(DEV).manual_seed(0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        step(state, dev, gen, ctrl)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = peak_text(base)
    wall, busy = busy_share(lambda: step(state, dev, gen, ctrl))
    shape = "x".join(str(s) for s in dev["mels"].shape)
    log(f"  {name} step at mels {shape}: {min(times):.4f} s/iter (best of "
        f"{reps}; {[round(t, 4) for t in times]}), {peak}; "
        f"device busy {busy:.1f} ms of a profiled iteration's {wall:.1f} ms = "
        f"{busy / wall:.3f} ({smi})")


def p13_batch(trainer, keys, rows):
    """The first validation batch's ``keys``, its first ``rows`` rows."""
    batch = next(iter(trainer.val_batches))
    return {k: batch[k][:rows] for k in keys if k in batch}


def phase13a(hk, corpus, tmp, smi):
    """13a: train --model untts at UnTTSConfig() on phase 12's corpus (its
    .gdur.npy durations), batch 8, DIO f0, 3 iterations with a validation,
    then --resume to 5; the step timed; one step card against CPU."""
    import torch
    from cookietts_tpu_torch.cli import UNTTS_KEYS
    from cookietts_tpu_torch.models.untts import UnTTS
    from cookietts_tpu_torch.runtime.optim import adam
    from cookietts_tpu_torch.runtime.train_state import TrainState
    from cookietts_tpu_torch.runtime.trainer import make_untts_train_step
    run = tmp / "untts"
    base = ["train", "--model", "untts", "--filelist", corpus, "--run_dir",
            str(run), "--seed", "0", "--device", DEV, "--hparams",
            UNTTS_HPARAMS + ("," + hparams_of(UNTTS) if UNTTS else "")]
    trainer, _ = p12_train(hk, base + ["--iters", "3"],
                           "13a train --model untts to 3")
    del trainer
    trainer, train = p12_train(hk, base + ["--iters", "5", "--resume"],
                               "13a --resume to 5")
    meta = json.loads((run / "checkpoint_3.json").read_text())
    if ([k for k, _, _ in train] != [0, 1, 2, 3, 4] or trainer.state.step != 5
            or meta["model"] != "untts" or not (run / "checkpoint_5").exists()):
        raise SystemExit("chip_smoke: the UnTTS run did not resume at step 3 "
                         "or its checkpoints are missing")
    cfg = trainer.state.model.cfg
    p13_step_times(trainer, next(iter(trainer.val_batches)), "13a UnTTS", smi)
    batch = p13_batch(trainer, UNTTS_KEYS, 4)
    del trainer
    torch.cuda.empty_cache()
    cfg0 = dataclasses.replace(cfg, dropout=0.0)

    def build():
        return (UnTTS(cfg0, device="cpu"),)

    def step_of(modules, device):
        return (make_untts_train_step(modules[0]),
                TrainState.create(modules[0], adam()))

    step_parity("13a UnTTS (B=4, dropout 0)", build, step_of, batch,
                {"lr": 1e-4, "grad_clip": 10.0})


def seeded_untts(cfg, seed, device):
    """An UnTTS from ``seed`` with every WN end layer drawn N(0, 0.02^2) (a
    fresh end is zero, and the inverse the identity whatever the kernel
    does)."""
    import torch
    from cookietts_tpu_torch.models.untts import UnTTS
    torch.manual_seed(seed)
    model = UnTTS(cfg, device="cpu")
    with torch.no_grad():
        for wn in [*model.decoder.wn] + (
                [*model.varglow.wn] if cfg.use_varglow else []):
            wn.end.weight.normal_(0.0, 0.02)
            wn.end.bias.normal_(0.0, 0.02)
    return model.to(device)


def untts_inputs(cfg, seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    lengths = torch.tensor([INFER_CHARS - 10 * i for i in range(INFER_B)])
    text = torch.randint(1, cfg.n_symbols, (INFER_B, INFER_CHARS), generator=g)
    text = text * (torch.arange(INFER_CHARS)[None] < lengths[:, None])
    return (text.to(DEV), lengths.to(DEV),
            torch.arange(INFER_B).to(DEV))


def p13_infer(hk, model, args, what, want_launches, **kw):
    """One inference with the launch counters zeroed before and read after;
    the mels finite and nonzero, the lengths within max_frames."""
    import torch
    hk.reset_launch_counts()
    out = model.inference(*args, max_frames=INFER_FRAMES,
                          duration_scale=INFER_DUR_SCALE, **kw)
    torch.cuda.synchronize()
    n = dict(hk.LAUNCHES)
    mel, lengths = out["mel_outputs"], out["mel_lengths"]
    log(f"  13b {what}: mel lengths {lengths.tolist()} of {INFER_FRAMES}; "
        f"launches {n} (want waveglow_wn_forward {want_launches})")
    if (n["waveglow_wn_forward"] != want_launches
            or any(v for k, v in n.items() if k != "waveglow_wn_forward")):
        raise SystemExit(f"chip_smoke: UnTTS inference ({what}) launches")
    if not (bool(torch.isfinite(mel).all()) and float(mel.abs().max()) > 0
            and int(lengths.min()) > 0 and int(lengths.max()) <= INFER_FRAMES):
        raise SystemExit(f"chip_smoke: UnTTS inference ({what}) output")
    return out


def phase13b(hk, check, smi):
    """13b: UnTTS.inference at full width, B = 4, up to 1024 frames, end
    layers drawn nonzero: exactly 6 x wn_launches(3) waveglow_wn_forward
    launches a call (4 x wn_launches(2) more with VarGlow's sampled
    prosody; positional attention too), the kernel path against the plain
    path at the same z (1e-3) and the card against the CPU at sigma = 0
    (1e-4); ms a call and per second of mel; the decoder's and VarGlow's WN
    calls timed against their plain versions beside their bounds."""
    import copy

    import torch
    from cookietts_tpu_torch.models.untts import UnTTSConfig
    from cookietts_tpu_torch.text import N_SYMBOLS
    cfg = UnTTSConfig(n_symbols=N_SYMBOLS, use_varglow=True, **UNTTS)
    model = seeded_untts(cfg, 40, DEV)
    args = untts_inputs(cfg, 41)
    dec = cfg.dec_n_flows * hk.wn_launches(cfg.dec_n_layers)
    var = cfg.varglow_n_flows * hk.wn_launches(2)
    gen = lambda: torch.Generator(DEV).manual_seed(7)  # noqa: E731
    out = p13_infer(hk, model, args, "predicted durations, sigma 1", dec,
                    generator=gen())
    with plain_kernels(hk):
        plain = model.inference(*args, max_frames=INFER_FRAMES,
                                duration_scale=INFER_DUR_SCALE,
                                generator=gen())
    if not torch.equal(out["durations"], plain["durations"]):
        raise SystemExit("chip_smoke: UnTTS durations, kernel vs plain")
    check("slice", out["mel_outputs"], plain["mel_outputs"], 1e-3, 1e-3,
          "UnTTS inference mels, kernel vs plain (same z)")
    samp = p13_infer(hk, model, args, "VarGlow sample_prosody", dec + var,
                     generator=gen(), sample_prosody=True)
    with plain_kernels(hk):
        samp_p = model.inference(*args, max_frames=INFER_FRAMES,
                                 duration_scale=INFER_DUR_SCALE,
                                 generator=gen(), sample_prosody=True)
    if not torch.equal(samp["durations"], samp_p["durations"]):
        raise SystemExit("chip_smoke: UnTTS sampled durations, kernel vs plain")
    check("slice", samp["mel_outputs"], samp_p["mel_outputs"], 1e-3, 1e-3,
          "UnTTS sampled prosody, kernel vs plain")
    # the card against the CPU, nothing drawn
    zero = p13_infer(hk, model, args, "sigma 0", dec, sigma=0.0)
    cpu = copy.deepcopy(model).to("cpu")
    want = cpu.inference(*[a.cpu() for a in args], max_frames=INFER_FRAMES,
                         duration_scale=INFER_DUR_SCALE, sigma=0.0)
    if not torch.equal(zero["durations"].cpu(), want["durations"]):
        raise SystemExit("chip_smoke: UnTTS durations, card vs CPU")
    check("slice", zero["mel_outputs"].cpu(), want["mel_outputs"], 1e-4, 1e-4,
          "UnTTS inference at sigma 0, card vs CPU")
    del cpu
    # timing: one call, and per second of mel
    call = lambda: model.inference(  # noqa: E731
        *args, max_frames=INFER_FRAMES, duration_scale=INFER_DUR_SCALE,
        generator=gen())
    ms = eager_ms(call, 5)
    with plain_kernels(hk):
        ms_plain = eager_ms(call, 5)
    mel_s = float(out["mel_lengths"].sum()) * NAR_HOP / NAR_SR
    log(f"  13b UnTTS.inference B={INFER_B} x {INFER_FRAMES} frames "
        f"({mel_s:.2f} s of mel in all): {ms:.3f} ms a call with the kernel, "
        f"{ms_plain:.3f} ms plain; {ms / mel_s:.3f} ms per second of mel "
        f"({smi})")
    # the WN calls alone at the inference's shapes
    for name, wn, Cin, T, n_cond in (
            ("decoder", model.decoder.wn[0], cfg.n_mel_channels // 2,
             INFER_FRAMES, cfg.dec_n_channels),
            ("VarGlow", model.varglow.wn[0], 4, -(-INFER_CHARS // 4),
             4 * (cfg.symbols_embedding_dim + cfg.speaker_embedding_dim))):
        g = torch.Generator(DEV).manual_seed(9)
        x = torch.randn(INFER_B, Cin, T, device=DEV, generator=g)
        cond = wn.cond_bc(torch.randn(INFER_B, n_cond, T, device=DEV,
                                      generator=g))
        w = wn.kernel_weights()
        got = hk.waveglow_wn_forward(x, cond, *w)
        check("waveglow_wn_forward", got,
              hk.waveglow_wn_forward_plain(x, cond, *w),
              *TOL["waveglow_wn_forward"], f"UnTTS {name} B={INFER_B} T'={T}")
        L, C = wn.n_layers, wn.n_channels
        bound = bound_of([wn_bound(INFER_B, T, Cin, C, 2 * Cin, L, 1, 3)])
        k_ms = time_ms(lambda: hk.waveglow_wn_forward(x, cond, *w), 20)
        p_ms = time_ms(lambda: hk.waveglow_wn_forward_plain(x, cond, *w), 20)
        log(f"    waveglow_wn_forward UnTTS {name} (C={C}, L={L}, Cin={Cin}, "
            f"B={INFER_B}, T'={T}; {plan_text(hk, INFER_B, C, T, 1, 3)}): "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
            f"{bound[0]:.4f} ms ({bound[1]}) ({smi})")
    # positional attention: the total length from the durations
    pcfg = dataclasses.replace(cfg, use_varglow=False,
                               use_positional_attention=True)
    pos = seeded_untts(pcfg, 42, DEV)
    pos_k = p13_infer(hk, pos, args, "positional attention", dec,
                      generator=gen())
    with plain_kernels(hk):
        pos_p = pos.inference(*args, max_frames=INFER_FRAMES,
                              duration_scale=INFER_DUR_SCALE, generator=gen())
    check("slice", pos_k["mel_outputs"], pos_p["mel_outputs"], 1e-3, 1e-3,
          "UnTTS positional attention, kernel vs plain")


def phase13c(hk, corpus, tmp, smi):
    """13c: train --model gantts at GANTTSConfig() on phase 12's corpus,
    batch 8, 3 iterations, then --resume to 5; the D and G steps timed; one
    D+G step card against CPU with z and the window starts passed in."""
    import numpy as np
    from cookietts_tpu_torch.cli import GANTTS_KEYS
    from cookietts_tpu_torch.models.gantts import (GANTTSDiscriminator,
                                                   GANTTSGenerator)
    from cookietts_tpu_torch.runtime.optim import adam
    from cookietts_tpu_torch.runtime.train_state import GANTrainState, TrainState
    from cookietts_tpu_torch.runtime.trainer import (gantts_draws,
                                                     make_gan_trainer_step,
                                                     make_gantts_train_steps)
    run = tmp / "gantts"
    base = ["train", "--model", "gantts", "--filelist", corpus, "--run_dir",
            str(run), "--seed", "0", "--device", DEV, "--hparams",
            NAR_HPARAMS + ("," + hparams_of(GANTTS) if GANTTS else "")]
    trainer, _ = p12_train(hk, base + ["--iters", "3"],
                           "13c train --model gantts to 3")
    del trainer
    trainer, train = p12_train(hk, base + ["--iters", "5", "--resume"],
                               "13c --resume to 5")
    if [k for k, _, _ in train] != [0, 1, 2, 3, 4] or trainer.state.step != 5:
        raise SystemExit("chip_smoke: the GAN-TTS run did not resume at step 3")
    cfg = trainer.state.g.model.cfg
    batch = p13_batch(trainer, GANTTS_KEYS, 8)
    p12_step_times(trainer, batch, "13c GAN-TTS", smi)
    del trainer
    cfg0 = dataclasses.replace(cfg, dropout=0.0)
    rng = np.random.default_rng(0)
    T = batch["mels"].shape[1]
    batch = dict(batch, z=rng.standard_normal(
        (batch["mels"].shape[0], cfg0.z_dim)).astype(np.float32),
        window_starts=np.array([rng.integers(0, T - w) if T > w else 0
                                for w in cfg0.d_windows]))

    def build():
        return GANTTSGenerator(cfg0, "cpu"), GANTTSDiscriminator(cfg0, "cpu")

    def step_of(modules, device):
        gen, disc = modules
        return (make_gan_trainer_step(
                    *make_gantts_train_steps(gen, disc),
                    prepare=gantts_draws(cfg0.z_dim, cfg0.d_windows)),
                GANTrainState(TrainState.create(gen, adam()),
                              TrainState.create(disc, adam())))

    step_parity("13c GAN-TTS (dropout 0, z and windows given)", build, step_of,
                batch, {"lr": 1e-4, "grad_clip": 10.0}, check_params=True)


def phase13(hk, check, corpus, tmp, smi):
    """13a UnTTS training, 13b UnTTS inference, 13c GAN-TTS training."""
    t0 = time.perf_counter()
    phase13a(hk, corpus, tmp, smi)
    log(f"  phase 13a in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase13b(hk, check, smi)
    log(f"  phase 13b in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase13c(hk, corpus, tmp, smi)
    log(f"  phase 13c in {time.perf_counter() - t0:.1f} s; {smi}")


# -- phase 14: data-parallel training across processes ------------------------

# phase 7's corpus and widths (one 144-frame bucket and TBPTT segment, below
# phase 10's T_dec cap of 200), global batch 16, 4 iterations with a
# validation at the start and a validation and a checkpoint at 4, written in
# the background: the same run is phase 16b's one-process twin
DP_TACO_HPARAMS = TRAIN_HPARAMS.replace(
    "validation_interval=3,checkpoint_interval=3",
    "validation_interval=4,checkpoint_interval=4,validate_at_start=True,"
    "async_save=True")
DP_ITERS = {"tacotron2": 4, "hifigan": 2}


def dp_limit(updates: int) -> float:
    """The relative difference allowed between the 2-rank run's losses and
    gradient norms and one process's after ``updates`` optimizer steps.
    Before any (iteration 0) the two start from the same weights and only
    the order of the global sums differs: 1e-5. After one, within phase 8's
    step_parity, 1e-4. After more, the trajectories have separated: Adam's
    normalised steps move every element by lr, so an element whose
    gradient's sign is rounding noise moves by 2 lr one way or the other,
    and training amplifies that about tenfold an iteration (H100 runs:
    Tacotron2 1e-7 to 2.5e-4 and HiFi-GAN 5e-5 to 3.3e-4 by the third to
    sixth iteration, the first exact): 1e-2. Each bug of the reductions
    shows earlier: a local mean or BatchNorm moves iteration 0's loss, a
    wrong gradient reduction its gradient norm, an unsynchronised update
    iteration 1's loss."""
    return 1e-5 if updates == 0 else 1e-4 if updates == 1 else 1e-2
DP_WORLD = 2


def dp_events(run):
    """(train records {step: record}, validation records) of a run."""
    train, val = {}, []
    for line in (run / "events.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if rec["prefix"] == "train":
            train[rec["step"]] = rec
        elif rec["prefix"] == "validation":
            val.append(rec)
    return train, val


def dp_run(hk, args, run):
    """The train command on ``run`` in this process (one rank). Returns
    (wall seconds, its kernel launches, the trainer)."""
    import torch
    from cookietts_tpu_torch.cli import main as cli
    hk.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = cli(args + ["--run_dir", str(run)])
    torch.cuda.synchronize()
    return time.perf_counter() - t0, dict(hk.LAUNCHES), trainer


def rank_launch(jobs, tmp):
    """The train commands ``jobs`` ([(name, argv)]) one after another in one
    ``python -m torch.distributed.run --standalone --nproc_per_node 2``
    launch of this script (``--rank-jobs``): each rank starts once (its
    imports, CUDA, the kernels' load) and calls the command's entry point,
    cli.main, for each job, with gloo (the ranks share the card) and TF32
    off as in this process (NVIDIA_TF32_OVERRIDE=0: the train command
    leaves torch's defaults, which take cuDNN's convolutions in TF32).
    Returns (the launch's wall seconds, {name: [each rank's record: seconds,
    kernel launches, sharding]}); each record is a file beside the spec
    (a line on the shared stdout could interleave with the other rank's)."""
    import os
    spec = tmp / "rank_jobs.json"
    spec.write_text(json.dumps({"device": DEV, "jobs": [
        [name, args + ([] if args[0] == SP_INFER_JOB
                       else ["--dist_backend", "gloo"])]
        for name, args in jobs]}))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(DP_WORLD), str(ROOT / "chip_smoke.py"),
         "--rank-jobs", str(spec)], cwd=ROOT, capture_output=True, text=True,
        timeout=1100,
        env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="4",
                 NVIDIA_TF32_OVERRIDE="0"))
    dt = time.perf_counter() - t0
    if proc.returncode:
        log(proc.stdout[-3000:])
        log(proc.stderr[-6000:])
        raise SystemExit(f"chip_smoke: the {DP_WORLD}-rank launch failed "
                         f"(exit {proc.returncode})")
    out = {}
    for path in tmp.glob("rank_job_*.json"):
        rec = json.loads(path.read_text())
        out.setdefault(rec["job"], {})[rec["rank"]] = rec
    for name, _ in jobs:
        if sorted(out.get(name, {})) != list(range(DP_WORLD)):
            raise SystemExit(f"chip_smoke: job {name}: records of ranks "
                             f"{sorted(out.get(name, {}))} of {DP_WORLD}")
    return dt, {k: [v[r] for r in range(DP_WORLD)] for k, v in out.items()}


TP_CELLS = ("attention_rnn", "decoder_rnn", "second_decoder_rnn")


def rank_jobs_main(spec) -> int:
    """One rank of rank_launch: each job's train command in turn, its
    seconds and kernel launches (counted from zero for each job) in
    ``rank_job_<job>_<rank>.json`` beside ``spec``, with what shows the
    model's tp sharding on this rank: each sharded tensor's axis and local shape, the decoder cells'
    state widths and the column counts of the W that lstm_gates received
    (with how many calls of each)."""
    import collections
    import gc
    sys.path.insert(0, str(ROOT))
    import torch
    from cookietts_tpu_torch.cli import main as cli
    from cookietts_tpu_torch.ops import _build
    from cookietts_tpu_torch.ops import hopper_kernels as hk
    from cookietts_tpu_torch.parallel import (HALO, process_index,
                                              reset_halo_counts, shutdown)
    from cookietts_tpu_torch.parallel.tp import layout_of
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    global DEV
    out = Path(spec).parent
    spec = json.loads(Path(spec).read_text())
    DEV = spec["device"]
    cuda = DEV == "cuda"
    if cuda:
        _build.load_all()
    cols = collections.Counter()
    gates = hk.lstm_gates

    def gates_seen(xh, w, b, c):
        cols[str(w.shape[1])] += 1
        return gates(xh, w, b, c)

    hk.lstm_gates = gates_seen
    try:
        for name, args in spec["jobs"]:
            hk.reset_launch_counts()
            reset_halo_counts()
            cols.clear()
            if args[0] == SP_INFER_JOB:
                sp_infer_job(hk, name, Path(args[1]), out)
                continue
            t0 = time.perf_counter()
            trainer = cli(args)
            if cuda:
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            model = trainer.state.model
            layout, local = layout_of(model), model.state_dict()
            decoder = getattr(model, "decoder", None)
            rank = process_index()
            (out / f"rank_job_{name}_{rank}.json").write_text(json.dumps({
                "job": name, "rank": rank, "seconds": seconds,
                "kernel_launches": dict(hk.LAUNCHES),
                "sharded": {k: [p.dim, list(local[k].shape)] for k, p in
                            (layout.placements.items() if layout else ())},
                "cell_widths": {c: getattr(decoder, c).state_width
                                for c in TP_CELLS
                                if getattr(decoder, c, None) is not None},
                "lstm_cols": dict(cols), "halo": dict(HALO)}))
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutdown()
    return 0


def dp_compare(name, runs, iters, lr, smi, what="2 ranks"):
    """Two runs of ``name`` (one process, then 2 ranks): the same
    per-iteration losses and gradient norms, and validation losses, within
    ``dp_limit`` of the updates before them; the final weights every element
    within 2 lr an iteration: Adam's normalised step moves an element whose
    gradient is rounding noise by lr either way (a conv bias ahead of a
    training-form BatchNorm, a weight ahead of one whose sum cancels), and
    the reduction order of 2 ranks is not one process's (their largest
    relative L2 is printed); one writer's files. Prints each run's
    s/iter."""
    import torch
    one, two = runs
    (t1, v1), (t2, v2) = (dp_events(r) for r in runs)
    if (sorted(t1) != list(range(iters)) or sorted(t2) != sorted(t1)
            or not v1 or [v["step"] for v in v1] != [v["step"] for v in v2]):
        raise SystemExit(f"chip_smoke: {name}: the runs logged steps "
                         f"{sorted(t1)} / {sorted(t2)}, validations "
                         f"{[v['step'] for v in v1]} / "
                         f"{[v['step'] for v in v2]}")
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-12)  # noqa: E731
    keys = [m for m in t1[0] if m.endswith(("loss", "grad_norm"))]
    d2 = [max(rel(t2[k][m], t1[k][m]) for m in keys) for k in range(iters)]
    val2 = [rel(b["val_loss"], a["val_loss"]) for a, b in zip(v1, v2)]
    sd = [torch.load(r / f"checkpoint_{iters}") for r in runs]
    w_abs, w_rel = (0.0, ""), (0.0, "")
    for part in ("state_dict", "d_state_dict"):
        for k, a in sd[0].get(part, {}).items():
            if not a.is_floating_point():
                continue
            d = sd[1][part][k].float() - a.float()
            w_abs = max(w_abs, (float(d.abs().max()), k))
            if "weight" in k.rsplit(".", 1)[-1] and float(a.norm()) > 0:
                w_rel = max(w_rel, (float(d.norm() / a.norm()), k))
    files = lambda d: sorted(p.name for p in d.iterdir()  # noqa: E731
                             if not p.name.startswith("events.out"))
    tb = [sum(p.name.startswith("events.out") for p in d.iterdir())
          for d in runs]
    s_iter = [sum(t[k]["iter_s"] for k in t if k) / (iters - 1)
              for t in (t1, t2)]
    log(f"  {name}: losses {[round(t1[k]['loss'], 4) for k in range(iters)]}; "
        f"{what} against 1 process, largest relative difference of a loss "
        f"or gradient norm by iteration {[f'{d:.1e}' for d in d2]}, of the "
        f"validation losses {[f'{d:.1e}' for d in val2]} at steps "
        f"{[v['step'] for v in v1]} (limits "
        f"{[dp_limit(k) for k in range(iters)]} by iteration, the validations "
        f"the iteration's they follow); final "
        f"weights largest difference {w_abs[0]:.2e} ({w_abs[1]}; limit "
        f"{2 * lr * iters:.1e}), largest relative L2 {w_rel[0]:.2e} "
        f"({w_rel[1]}); files "
        f"{'the same' if files(one) == files(two) else 'differ'}, tensorboard "
        f"files {tb}; s/iter after the first: 1 process {s_iter[0]:.3f}, "
        f"{what} sharing the card {s_iter[1]:.3f} (not a speed-up: one card); "
        f"{smi}")
    limits = ([dp_limit(k) for k in range(iters)]
              + [dp_limit(v["step"]) for v in v1])
    if (any(d > m for d, m in zip(d2 + val2, limits))
            or w_abs[0] > 2 * lr * iters or files(one) != files(two)
            or tb[0] != tb[1] or tb[0] > 1
            or len((two / "events.jsonl").read_text().splitlines())
            != len((one / "events.jsonl").read_text().splitlines())):
        raise SystemExit(f"chip_smoke: {name} at {what} is not the "
                         "one-process run, or left more than one writer's "
                         "files")


def phase14_jobs(tmp):
    """Phase 14's and phase 16's train commands: {name: argv} (without
    --run_dir), their run directories {name: (one process, ranks)}, and
    the corpora."""
    from cookietts_tpu_torch.data.evidence_corpus import make_corpus
    train_fl, _ = make_corpus(str(tmp / "corpus14"), seed=0, n_train=32,
                              n_val=16)
    sr = HIFIGAN_DATA["sampling_rate"]
    hifigan_map = vocoder_corpus(tmp / "wav14", sr, 20,
                                 2.5 * HIFIGAN_DATA["segment_length"] / sr,
                                 seed=4)
    flow_map = vocoder_corpus(tmp / "wav16", 48000, 6,
                              1.5 * FLOW_SEGMENT / 48000, seed=6)
    taco = ["train", "--model", "tacotron2", "--filelist", train_fl,
            "--hparams", DP_TACO_HPARAMS, "--seed", "0", "--iters",
            str(DP_ITERS["tacotron2"])]
    hifigan = ["train", "--model", "hifigan", "--filelist", hifigan_map,
               "--hparams", hparams_of({**HIFIGAN, **HIFIGAN_DATA, **CADENCE}),
               "--seed", "0", "--iters", str(DP_ITERS["hifigan"])]
    flow = ["train", "--model", "waveglow", "--filelist", flow_map,
            "--hparams", TP_FLOW_HPARAMS, "--seed", "0", "--iters",
            str(TP_FLOW_ITERS)]
    waveflow = ["train", "--model", "waveglow", "--filelist", flow_map,
                "--hparams", SP_WAVEFLOW_HPARAMS, "--seed", "0", "--iters",
                str(SP_FLOW_ITERS)]
    dev = [] if DEV == "cuda" else ["--device", DEV]
    return {"14a": taco + dev, "14b": hifigan + dev, "16c": flow + dev,
            "17b": waveflow + dev}


def phase14a(runs, trainer, n1, dt1, rec, smi):
    """The Tacotron2 train command at 2 ranks (gloo, one card) against one
    process at phase 7's widths, with the kernels."""
    iters = DP_ITERS["tacotron2"]
    # one launch a decoder step (lstm_gates 3) of the 144-frame bucket in
    # every iteration and the two decodes of the validation batches in each
    # validation (at the start and at 4): each rank decodes its rows of
    # every batch
    want = expected_launches(trainer, iters, 2)
    n2 = [r["kernel_launches"] for r in rec]
    log(f"  14a Tacotron2 (Tacotron2Config() widths, batch 16, {iters} "
        f"iterations, validation at the start and, with a checkpoint, at "
        f"{iters}): 1 process {dt1:.1f} s, {DP_WORLD} ranks "
        f"{[round(r['seconds'], 1) for r in rec]} s in the launch; "
        f"launches attention_step / lstm_gates: 1 process "
        f"{n1['attention_step']} / {n1['lstm_gates']}, ranks "
        f"{[(n['attention_step'], n['lstm_gates']) for n in n2]} (want "
        f"{want} / {3 * want} each)")
    for n in [n1] + n2:
        if (n["attention_step"], n["lstm_gates"]) != (want, 3 * want):
            raise SystemExit("chip_smoke: the data-parallel train command's "
                             "kernel launches are not one per decoder step")
    lr = 0.5e-3 + (1e-3 - 0.5e-3) * iters / 1000   # the live warm-up's
    dp_compare("14a Tacotron2", runs, iters, lr, smi)
    return want


def phase14b(runs, n1, dt1, rec, smi):
    """The HiFi-GAN train command at 2 ranks against one process at phase
    8's widths and recipe."""
    iters = DP_ITERS["hifigan"]
    n2 = [r["kernel_launches"] for r in rec]
    log(f"  14b HiFi-GAN (HiFiGANConfig(), batch 16, {iters} iterations, "
        f"validation and a checkpoint every 2): 1 process {dt1:.1f} s, "
        f"{DP_WORLD} ranks {[round(r['seconds'], 1) for r in rec]} s in the "
        f"launch; kernel launches {sum(n1.values())}, ranks "
        f"{[sum(n.values()) for n in n2]} (training and its validation "
        f"run the generator's training form: none)")
    if any(any(n.values()) for n in [n1] + n2):
        raise SystemExit("chip_smoke: HiFi-GAN training launched a kernel")
    dp_compare("14b HiFi-GAN", runs, iters, 2e-4, smi)


def phase14c(hk, tcfg, smi):
    """A world-1 NCCL group in this process (TCP store on localhost): the
    full-width Tacotron2 train step with the kernels under the group against
    the step with no group, from the same weights, batch and generator
    seed. Returns the group step's launches."""
    import socket
    import torch
    import torch.distributed as dist
    from cookietts_tpu_torch.models.tacotron2 import Tacotron2
    from cookietts_tpu_torch.parallel import DataParallel
    from cookietts_tpu_torch.runtime.optim import adam
    from cookietts_tpu_torch.runtime.train_state import TrainState
    from cookietts_tpu_torch.runtime.trainer import make_tacotron2_train_step
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        dp = DataParallel()
        batch = synthetic_batch(tcfg, 14, T_dec=200)
        ctrl = {"lr": 1e-3, "grad_clip": 1.0, "p_teacher_forcing": 1.0,
                "teacher_force_till": 0, "drop_frame_rate": 0.0,
                "guided_att_sigma": 0.5}
        out = []
        for group in (None, dp):
            torch.manual_seed(0)
            model = Tacotron2(tcfg, device="cuda")
            state = TrainState.create(model, adam())
            step = make_tacotron2_train_step(model, dp=group)
            hk.reset_launch_counts()
            _, ld, _, _ = step(state, batch,
                               torch.Generator("cuda").manual_seed(3), ctrl)
            torch.cuda.synchronize()
            out.append(({k: float(v) for k, v in ld.items()},
                        moments_grads(state), dict(hk.LAUNCHES)))
    finally:
        dist.destroy_process_group()
    (l0, g0, _), (l1, g1, n1) = out
    loss_rel = max((abs(l1[k] - l0[k]) / max(abs(l0[k]), abs(l0["loss"])), k)
                   for k in l0)
    # a conv bias ahead of a training-form BatchNorm has a gradient of
    # rounding noise, whose relative difference means nothing
    grad_rel = max((float((g1[k] - g0[k]).norm() / g0[k].norm()), k)
                   for k in g0 if float(g0[k].norm()) > 0
                   and not k.endswith(".0.conv.bias"))
    log(f"  14c world-1 NCCL group, B=16, T_dec=200, kernels: loss "
        f"{l1['loss']:.6f} against {l0['loss']:.6f} with no group; largest "
        f"relative difference of a loss term {loss_rel[0]:.2e} "
        f"({loss_rel[1]}; limit 1e-6), of a gradient (relative L2; the conv "
        f"biases ahead of a BatchNorm left out) {grad_rel[0]:.2e} "
        f"({grad_rel[1]}; limit 1e-4); launches {n1} (want 200 / 600); {smi}")
    if loss_rel[0] > 1e-6 or grad_rel[0] > 1e-4 or (
            n1["attention_step"], n1["lstm_gates"]) != (200, 600):
        raise SystemExit("chip_smoke: the train step under a world-1 NCCL "
                         "group is not the step with no group")
    return n1


def phase14(hk, tcfg, tmp, smi):
    """14a Tacotron2 and 14b HiFi-GAN through the train command at 2 ranks
    against one process; 14c a world-1 NCCL group in this process. The one
    2-rank launch also runs phase 16's two tp commands (16b, 16c), and this
    phase runs 16c's one-process twin; 14a's one-process run is 16b's
    twin. The launch also runs phase 17's sp jobs (17a WaveGlow, 17b
    WaveFlow, 17c sharded inference), and this phase runs 17b's one-process
    twin (16c's is 17a's). Returns what phases 16 and 17 read."""
    t0 = time.perf_counter()
    jobs = phase14_jobs(tmp)
    one = {}
    for name in ("14a", "14b", "16c", "17b"):
        run = tmp / f"run{name}_1"
        dt, n, trainer = dp_run(hk, jobs[name], run)
        one[name] = (run, dt, n)
        if name == "14a":       # its validation batches size the launches
            taco_trainer = trainer
        del trainer
    log(f"  14a, 14b, 16c and 17b one-process runs in "
        f"{time.perf_counter() - t0:.1f} s")
    launch = [(name, jobs[name] + ["--run_dir", str(tmp / f"run{name}_2")])
              for name in ("14a", "14b")]
    launch += [(name, jobs[key] + ["--run_dir", str(tmp / f"run{name}_2"),
                                   "--tp", str(TP)])
               for name, key in (("16b", "14a"), ("16c", "16c"))]
    launch += [(name, jobs[key] + ["--run_dir", str(tmp / f"run{name}_2"),
                                   "--sp", str(SP)])
               for name, key in (("17a", "16c"), ("17b", "17b"))]
    launch.append(("17c", [SP_INFER_JOB, str(p17c_inputs(tmp))]))
    dt, rec = rank_launch(launch, tmp)
    log(f"  the {DP_WORLD}-rank launch (14a, 14b, 16b, 16c, 17a, 17b, 17c in "
        "turn) "
        f"{dt:.1f} s wall, of which the jobs "
        f"{ {k: round(max(r['seconds'] for r in v), 1) for k, v in rec.items()} } s "
        f"(the rest: the ranks' start, imports and CUDA); {smi}")
    t2 = time.perf_counter()
    run, dt1, n1 = one["14a"]
    want = phase14a((run, tmp / "run14a_2"), taco_trainer, n1, dt1,
                    rec["14a"], smi)
    del taco_trainer
    run, dt1, n1 = one["14b"]
    phase14b((run, tmp / "run14b_2"), n1, dt1, rec["14b"], smi)
    phase14c(hk, tcfg, smi)
    log(f"  phase 14's checks in {time.perf_counter() - t2:.1f} s")
    return {"one": one, "rec": rec, "want": want, "tmp": tmp,
            "launch_s": dt}


# -- phase 15: pipeline stages 0 and 1 (the preprocess command) ---------------

P15_CLIPS = 96        # the phase's one cut: a real corpus has thousands
P15_SR_IN = 22050     # the corpus's rate: preprocess resamples to 44.1 kHz


def p15_corpus(root, n, seed=0):
    """``n`` seeded speech-like clips (harmonics with vibrato, breath noise,
    0.2-0.6 s of low noise before and after; 1.5-10 s a clip), mono 16-bit
    at 22050 Hz, half in an LJSpeech layout (one speaker, metadata.csv),
    half in a Clipper layout (four speakers, a .txt beside each clip).
    Returns (the dataset directories, the seconds of audio)."""
    import numpy as np
    from cookietts_tpu_torch.data import audio_io
    rng = np.random.default_rng(seed)
    lj, clip = root / "LJSpeech", root / "Clipper_MLP"
    (lj / "wavs").mkdir(parents=True)
    clip.mkdir()
    words = ("hello there friend please call stella the quick brown fox "
             "jumps over lazy dog a pony named twilight reads every book "
             "in the library").split()
    lines, seconds = [], 0.0
    for i in range(n):
        speech = rng.uniform(1.1, 8.8)
        t = np.arange(int(P15_SR_IN * speech)) / P15_SR_IN
        f0 = rng.uniform(90, 300) * (1 + 0.04 * np.sin(2 * np.pi * 5 * t))
        phase = 2 * np.pi * np.cumsum(f0) / P15_SR_IN
        x = sum(np.sin(h * phase) / h for h in range(1, 7))
        x *= 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(1, 3) * t) ** 2
        x = 0.3 * x / np.abs(x).max() + 0.01 * rng.standard_normal(len(t))
        x *= np.clip(np.minimum(t, t[-1] - t) / 0.05, 0, 1)
        sil = [1e-4 * rng.standard_normal(int(P15_SR_IN * rng.uniform(0.2, 0.6)))
               for _ in range(2)]
        audio = np.concatenate([sil[0], x, sil[1]]).astype(np.float32)
        seconds += len(audio) / P15_SR_IN
        quote = " ".join(rng.choice(words, size=int(rng.integers(4, 12))))
        quote = quote.capitalize() + "."
        if i % 2 == 0:
            name = f"LJ{i // 2 // 100 + 1:03d}-{i // 2 % 100:04d}"
            audio_io.save_wav(str(lj / "wavs" / f"{name}.wav"), audio,
                              P15_SR_IN)
            lines.append(f"{name}|{quote}|{quote}")
        else:
            speaker = ("Twilight", "Rarity", "Applejack", "Fluttershy")[
                (i // 2) % 4]
            stem = (f"00_{i // 60:02d}_{i % 60:02d}_{speaker}_Neutral__"
                    f"{quote[:-1]}")
            audio_io.save_wav(str(clip / f"{stem}.wav"), audio, P15_SR_IN)
            (clip / f"{stem}.txt").write_text(quote)
    (lj / "metadata.csv").write_text("\n".join(lines) + "\n")
    return [str(lj), str(clip)], seconds


def p15_preprocess(tmp, smi):
    """The preprocess command (its entry point in this process) on the
    corpus at configs/preprocess.json's values (44.1 kHz, high-pass 150 and 40 Hz, 3
    trim passes at 45 dB, -27 LUFS, 0.9 s minimum) with 4 worker processes
    and the feature dump on the card (PreprocessConfig's frontend: filter
    2048, hop 512, 80 mels, 20-11025 Hz; batches of 16). Returns (the
    config, its stats line, the kept entries)."""
    import io
    import os
    from cookietts_tpu_torch.data.filelist import load_filelist
    from cookietts_tpu_torch.pipeline.preprocess import (PreprocessConfig,
                                                         feature_cache_hash)
    t0 = time.perf_counter()
    dirs, seconds = p15_corpus(tmp / "corpus15", P15_CLIPS)
    t_corpus = time.perf_counter() - t0
    conf = json.loads((ROOT / "configs" / "preprocess.json").read_text())
    conf.update(dataset_dirs=dirs, threads=4, on_device_features=True,
                feature_batch=16, out_dir=str(tmp / "pre15"))
    cfg_path = tmp / "preprocess15.json"
    cfg_path.write_text(json.dumps(conf))
    cfg = PreprocessConfig(**conf)
    from cookietts_tpu_torch.cli import main as cli
    args = ["preprocess", "-c", str(cfg_path),
            *([] if DEV == "cuda" else ["--device", DEV])]
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli(args)
    wall = time.perf_counter() - t0
    stdout = buf.getvalue()
    stats = json.loads(stdout.strip().splitlines()[-1])["preprocess_stats"]
    feats = stats["features"]
    path_line = [ln for ln in stdout.splitlines()
                 if ln.startswith("[preprocess] audio path:")]
    out = Path(conf["out_dir"])
    missing = [name for name in (
        "filelist_train.txt", "filelist_validation.txt", "speaker_info.txt",
        "emotion_info.txt", "meta_dump.json", "preprocess_config.json",
        "LJSpeech/filelist_train.txt", "Clipper_MLP/filelist_train.txt")
        if not (out / name).is_file()]
    entries = (load_filelist(str(out / "filelist_train.txt"))
               + load_filelist(str(out / "filelist_validation.txt")))
    h = feature_cache_hash(cfg)
    for e in entries:
        for sfx in (f".{h}.mel.npy", f".{h}.len.npy", ".gt.f0.npy",
                    ".gt.energy.npy"):
            if not os.path.isfile(e["path"] + sfx):
                missing.append(os.path.basename(e["path"]) + sfx)
    speakers = [ln.split("|")[1] for ln in
                (out / "speaker_info.txt").read_text().splitlines()[1:]]
    batch_ms = feats["batch_ms"]
    peak = feats["peak_bytes"] or 0
    log(f"  15a corpus: {P15_CLIPS} clips, {seconds:.1f} s of audio at "
        f"{P15_SR_IN} Hz, written in {t_corpus:.1f} s; the preprocess command "
        f"in this process {wall:.1f} s wall: the audio step (resample to "
        f"{cfg.target_sr}, "
        f"high-pass, trim, loudness; {cfg.threads} spawned workers) "
        f"{stats['audio_step_s']:.2f} s on the {stats['audio_path']} path, "
        f"the feature dump {feats['wall_s']:.2f} s ({feats['load_s']:.2f} s "
        f"reading the wavs), {stats['total_s']:.2f} s in run_preprocess; "
        f"{smi}")
    log(f"  15a the command's feature dump on {feats['device']}: "
        f"{feats['batches']} batches of up to {cfg.feature_batch} (sorted by "
        f"length, buckets {feats['buckets']}), wall ms a batch "
        f"{[round(x, 2) for x in batch_ms]} (CUDA events around each call: "
        f"the pageable copy to the card and the host's launch gaps included; "
        f"the first batch pays the libraries' start-up, each new bucket its "
        f"FFT plans), {feats['audio_s'] / feats['wall_s']:.0f} s "
        f"of audio per second of the dump; peak memory "
        f"{peak / 2 ** 30:.3f} GiB; {smi}")
    if DEV == "cuda":
        # the dump again in this process, warm, then traced: its device time
        # from torch.profiler's CUDA records (rewrites the same files)
        from cookietts_tpu_torch.pipeline.preprocess import (
            dump_features_on_device)
        paths = [e["path"] for e in entries]
        dump_features_on_device(paths, cfg, DEV)
        warm = {}
        dump_wall, busy = busy_share(lambda: warm.update(
            dump_features_on_device(paths, cfg, DEV)))
        log(f"  15a a warm dump in-process, traced: {dump_wall:.0f} ms wall, "
            f"device-busy {busy:.1f} ms ({busy / warm['batches']:.2f} ms a "
            f"batch), share {busy / dump_wall:.3f}; "
            f"{warm['audio_s'] / (busy / 1e3):.0f} s of audio per device "
            f"second, {warm['audio_s'] / (dump_wall / 1e3):.0f} per second of "
            f"the dump; {smi}")
    log(f"  15a outputs: {len(entries)} kept clips of {stats['wavs']}, "
        f"speakers {speakers}; {path_line}; missing {missing[:8]}")
    if (missing or stats["audio_path"] != "native" or not path_line
            or "native (" not in path_line[0] or len(entries) != P15_CLIPS
            or feats["clips"] != P15_CLIPS or len(speakers) != 5):
        raise SystemExit("chip_smoke: preprocess's outputs are incomplete, "
                         "or it did not take the native audio path")
    return cfg, entries


def p15_frontend(cfg, entries, smi):
    """The card's frontend against the port's CPU frontend on one full
    batch (the 16 longest clips, bucket 2^19), and against the host
    anchors. Returns the batch's clips."""
    import numpy as np
    import torch
    from cookietts_tpu_torch.audio import dsp
    from cookietts_tpu_torch.audio.features import estimate_f0
    from cookietts_tpu_torch.audio.stft import TacotronSTFT
    from cookietts_tpu_torch.data import audio_io
    from cookietts_tpu_torch.pipeline.preprocess import (bucket_batch,
                                                         feature_frontend)
    clips = [audio_io.remove_dc_offset(audio_io.load_wav(
        e["path"], target_sr=cfg.target_sr)[0]) for e in entries]
    clips = sorted(clips, key=len)[-16:]
    batch, lengths = bucket_batch(clips, cfg)
    if batch.shape != (16, 2 ** 19):
        raise SystemExit(f"chip_smoke: the batch is {batch.shape}, not 16 x "
                         "2^19")
    dev = torch.device(DEV)
    fn = feature_frontend(cfg, dev)
    fn(batch, lengths)                                  # warm
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    card = {k: v.cpu().numpy() for k, v in fn(batch, lengths).items()}
    t_card = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base
            if dev.type == "cuda" else 0)
    wall, busy = (busy_share(lambda: fn(batch, lengths))
                  if dev.type == "cuda" else (1.0, 0.0))
    t0 = time.perf_counter()
    cpu = {k: v.numpy() for k, v in
           feature_frontend(cfg, "cpu")(batch, lengths).items()}
    t_cpu = time.perf_counter() - t0
    mel_err = float(np.abs(card["mel"] - cpu["mel"]).max())
    lufs_err = float(np.abs(card["loudness"] - cpu["loudness"]).max())
    energy_rel = float((np.abs(card["energy"] - cpu["energy"])
                        / np.abs(cpu["energy"])).max())
    f0_agree = float(np.isclose(card["f0"], cpu["f0"], rtol=1e-5,
                                atol=1e-3).mean())
    voiced_agree = float((card["voiced"] == cpu["voiced"]).mean())
    log(f"  15b one batch (16 x 2^19, {lengths.min() / cfg.target_sr:.2f}-"
        f"{lengths.max() / cfg.target_sr:.2f} s) card against the CPU: mel "
        f"max abs {mel_err:.2e} (limit 1e-3), loudness {lufs_err:.2e} LU "
        f"(1e-3), energy max rel {energy_rel:.2e} (1e-4), f0 frames equal "
        f"{f0_agree:.4f} (0.99), voicing equal {voiced_agree:.4f} (0.99); card "
        f"{1e3 * t_card:.1f} ms wall (the copy back included), "
        f"{busy / wall:.3f} of a call device-busy, peak {peak / 2 ** 20:.0f} "
        f"MiB above the {base / 2 ** 20 if dev.type == 'cuda' else 0:.0f} MiB "
        f"resident; CPU {t_cpu:.2f} s; {smi}")
    if not (mel_err <= 1e-3 and lufs_err <= 1e-3 and energy_rel <= 1e-4
            and f0_agree >= 0.99 and voiced_agree >= 0.99):
        raise SystemExit("chip_smoke: the card's feature frontend disagrees "
                         "with the CPU's")

    # the host anchors on the unpadded clips
    stft = TacotronSTFT(cfg.filter_length, cfg.hop_length, cfg.win_length,
                        cfg.n_mel_channels, cfg.target_sr, cfg.mel_fmin,
                        cfg.mel_fmax, device="cpu")
    mel_host, f0_share, lufs_host, t_host = 0.0, 1.0, 0.0, 0.0
    for j, clip in enumerate(clips):
        t0 = time.perf_counter()
        host = stft.mel_spectrogram_np(clip)
        hf0, hvoiced = audio_io.estimate_f0_autocorr(
            clip, cfg.target_sr, hop_length=cfg.hop_length,
            frame_length=cfg.filter_length)
        if j < 8:
            t_host += time.perf_counter() - t0
        n = len(clip) // cfg.hop_length + 1
        if host.shape[0] != n:
            raise SystemExit("chip_smoke: the host mel's frame count")
        mel_host = max(mel_host, float(np.abs(card["mel"][j, :n]
                                              - host).max()))
        with torch.no_grad():
            f0, voiced = estimate_f0(
                torch.from_numpy(clip[None]).to(dev), cfg.target_sr,
                hop_length=cfg.hop_length, frame_length=cfg.filter_length)
        f0_share = min(f0_share, float(np.isclose(
            f0[0].cpu().numpy(), hf0, rtol=1e-4, atol=1e-3).mean()),
            float((voiced[0].cpu().numpy() == hvoiced).mean()))
        lufs_host = max(lufs_host, abs(float(card["loudness"][j])
                                       - dsp.measure_loudness_lufs(
                                           clip, cfg.target_sr)))
    log(f"  15b against the host anchors: mel_spectrogram_np on the unpadded "
        f"clips, tail frames included, max abs {mel_host:.2e} (limit 2e-3); "
        f"estimate_f0_autocorr frames and voicing equal, least share "
        f"{f0_share:.4f} (0.99); dsp.measure_loudness_lufs max "
        f"{lufs_host:.2e} LU (0.1); the host anchor (mel and autocorrelation "
        f"f0) {t_host / 8:.3f} s a clip on 8 clips; {smi}")
    if mel_host > 2e-3 or f0_share < 0.99 or lufs_host > 0.1:
        raise SystemExit("chip_smoke: the card's frontend disagrees with the "
                         "host anchors")
    return clips


def p15_dataset(cfg, smi):
    """The stage boundary: the port's TTSDataset over the written
    filelist_train.txt with the matching DataConfig serves every mel from
    the cache (the mel computation stubbed to raise); one batch collated."""
    import numpy as np
    from cookietts_tpu_torch.data.dataset import DataConfig, TTSDataset, collate
    from cookietts_tpu_torch.data.filelist import load_filelist
    from cookietts_tpu_torch.pipeline.preprocess import feature_cache_hash
    dcfg = DataConfig(
        sampling_rate=cfg.target_sr, filter_length=cfg.filter_length,
        hop_length=cfg.hop_length, win_length=cfg.win_length,
        n_mel_channels=cfg.n_mel_channels, mel_fmin=cfg.mel_fmin,
        mel_fmax=cfg.mel_fmax, trim_enable=False, target_lufs=None,
        p_arpabet=0.0)
    entries = load_filelist(str(Path(cfg.out_dir) / "filelist_train.txt"))
    ds = TTSDataset(entries, dcfg, features=["text", "mel", "speaker_id"])

    def refuse(*_a, **_k):
        raise SystemExit("chip_smoke: the dataset computed a mel that "
                         "preprocess cached")
    ds.stft.mel_spectrogram_np = refuse
    t0 = time.perf_counter()
    items = [ds[i] for i in range(len(entries))]
    dt = time.perf_counter() - t0
    h = feature_cache_hash(cfg)
    for e, item in zip(entries, items):
        if not np.array_equal(item["mel"], np.load(e["path"]
                                                   + f".{h}.mel.npy")):
            raise SystemExit("chip_smoke: a served mel is not its cache")
    short = sorted(items, key=lambda it: it["mel_length"])[:8]
    batch = collate(short, dcfg)
    log(f"  15c TTSDataset over filelist_train.txt: {len(items)} items, every "
        f"mel from the cache ({1e3 * dt / len(items):.2f} ms an item); one "
        f"collated batch mels {tuple(batch['mels'].shape)}, text "
        f"{tuple(batch['text'].shape)}; {smi}")


def p15_griffin_lim(cfg, clips, smi):
    """Griffin-Lim on the card (B=1, 200 frames) against the CPU from the
    same initial angles, twice. One iteration, where rounding has not yet
    been fed back, is held to a fixed 1e-4 of the peak. Thirty iterations
    of the accelerated scheme (momentum 0.99) feed rounding back, so they
    are held to a fixed 1e-2 of the peak; both runs to the CPU's spectral
    convergence (the rebuilt audio's STFT magnitude against the target's,
    relative L2, within 1%). Beside each limit: what a relative 1e-6 nudge
    of the magnitudes moves the CPU's own result."""
    import torch
    from cookietts_tpu_torch.audio.stft import TacotronSTFT
    audio = torch.from_numpy(clips[-1][:199 * cfg.hop_length][None].copy())
    stfts = {dev: TacotronSTFT(cfg.filter_length, cfg.hop_length,
                               cfg.win_length, cfg.n_mel_channels,
                               cfg.target_sr, cfg.mel_fmin, cfg.mel_fmax,
                               device=dev) for dev in (DEV, "cpu")}
    with torch.no_grad():
        mag, _ = stfts["cpu"].stft.transform(audio, return_phase=False)
    angles = (torch.rand(mag.shape, generator=torch.Generator()
                         .manual_seed(15)) * 2 - 1) * math.pi
    nudged_mag = mag * (1 + 1e-6 * torch.randn(
        mag.shape, generator=torch.Generator().manual_seed(16)))
    ok = True
    for n_iters, limit in ((1, 1e-4), (30, 1e-2)):
        out, ms, conv = {}, {}, {}
        for dev, stft in stfts.items():
            m = mag.to(dev)
            with torch.no_grad():
                stft.griffin_lim(m, n_iters=2, angles=angles.to(dev))  # warm
                if dev == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                out[dev] = stft.griffin_lim(m, n_iters=n_iters,
                                            angles=angles.to(dev)).cpu()
                ms[dev] = 1e3 * (time.perf_counter() - t0)
                rebuilt, _ = stft.stft.transform(out[dev].to(dev),
                                                 return_phase=False)
                conv[dev] = float((rebuilt - m).norm() / m.norm())
        with torch.no_grad():
            nudged = stfts["cpu"].griffin_lim(nudged_mag, n_iters=n_iters,
                                              angles=angles)
        a, b = out[DEV], out["cpu"]
        peak = float(b.abs().max())
        err = float((a - b).abs().max()) / peak
        nudge = float((nudged - b).abs().max()) / peak
        log(f"  15d Griffin-Lim (B=1, {tuple(angles.shape)[1]} frames, "
            f"{n_iters} iteration(s), momentum 0.99) card against the CPU, "
            f"same angles: max abs {err:.2e} of the peak (limit {limit:.0e}; a "
            f"1e-6 nudge of the magnitudes moves the CPU's {nudge:.2e}); "
            f"spectral convergence card {conv[DEV]:.4f}, CPU "
            f"{conv['cpu']:.4f}; card {ms[DEV]:.1f} ms, CPU {ms['cpu']:.1f} "
            f"ms; {smi}")
        ok = ok and (err <= limit and bool(torch.isfinite(a).all())
                     and abs(conv[DEV] - conv["cpu"]) <= 0.01 * conv["cpu"]
                     and a.shape == b.shape == (1, 199 * cfg.hop_length))
    if not ok:
        raise SystemExit("chip_smoke: Griffin-Lim on the card disagrees with "
                         "the CPU's")


def phase15(hk, tmp, smi):
    """15a the preprocess command as a process, 15b the card's frontend
    against the CPU's and the host anchors, 15c the dataset from the
    caches, 15d Griffin-Lim. No kernel of the port lies on this path."""
    hk.reset_launch_counts()
    t0 = time.perf_counter()
    cfg, entries = p15_preprocess(tmp, smi)
    t1 = time.perf_counter()
    clips = p15_frontend(cfg, entries, smi)
    t2 = time.perf_counter()
    p15_dataset(cfg, smi)
    t3 = time.perf_counter()
    p15_griffin_lim(cfg, clips, smi)
    log(f"  phase 15a {t1 - t0:.1f} s, 15b {t2 - t1:.1f} s, 15c {t3 - t2:.1f} "
        f"s, 15d {time.perf_counter() - t3:.1f} s")
    if any(hk.LAUNCHES.values()):
        raise SystemExit(f"chip_smoke: phase 15 launched {hk.LAUNCHES}")


# -- phase 16: tensor parallelism (train --tp) ---------------------------------

TP = 2
# WaveGlowConfig() on phase 8b's front end (48 kHz, batch 4, 24000 samples),
# 2 iterations, a validation at the start and, with a checkpoint, at 2, one
# validation batch
TP_FLOW_ITERS = 2
TP_FLOW_HPARAMS = hparams_of({**WAVEGLOW_TRAIN, **FLOW_DATA, **CADENCE,
                              "validate_at_start": True, "async_save": True,
                              "max_val_batches": 1})


def phase16a(hk, check, smi):
    """lstm_gates at the tp shard widths of Tacotron2Config() (N = 2: H/N =
    640, 384, 384) at the training (B = 16) and serving (B = 4) batches:
    each rank's shard (its units' columns of all four gate blocks, by
    parallel/tp.py's layout) against its plain version and against the
    matching columns of the unsharded kernel call, phase 3's limits; each
    shard timed beside the full call, with its bound."""
    import torch
    from cookietts_tpu_torch.parallel.tp import Placement, shard_tensor
    gen = torch.Generator(device="cuda").manual_seed(16)
    out = []
    for B in (16, 4):
        for name, F, H in LSTM_SHAPES:
            xh, W, b, c = lstm_inputs(B, F, H, gen)
            full = hk.lstm_gates(xh, W, b, c)
            h = H // TP
            for k in range(TP):
                cols = slice(k * h, (k + 1) * h)
                Wk = shard_tensor(W, Placement(1, H), k, TP).contiguous()
                bk = shard_tensor(b, Placement(0, H), k, TP).contiguous()
                ck = c[:, cols].contiguous()
                got = hk.lstm_gates(xh, Wk, bk, ck)
                for i, want in enumerate(hk.lstm_gates_plain(xh, Wk, bk, ck)):
                    check("lstm_gates", got[i], want, *TOL["lstm_gates"],
                          f"tp {k}/{TP} B={B} {name} {'ch'[i]} plain")
                    check("lstm_gates", got[i], full[i][:, cols],
                          *TOL["lstm_gates"],
                          f"tp {k}/{TP} B={B} {name} {'ch'[i]} full")
            args = (xh, Wk, bk, ck)
            with torch.no_grad():
                ms = time_ms(lambda: hk.lstm_gates(*args), 100)
                plain = time_ms(lambda: hk.lstm_gates_plain(*args), 100)
                full_ms = time_ms(lambda: hk.lstm_gates(xh, W, b, c), 100)
            bound = max(lstm_bound(B, F, h)) * 1e3
            out.append((B, name, h, ms, plain, bound, full_ms))
            log(f"  16a lstm_gates B={B} {name} shard W [{F}, {4 * h}]: "
                f"{ms:.4f} ms (plain {plain:.4f}, bound {bound:.5f} by "
                f"bytes), the full W [{F}, {4 * H}] {full_ms:.4f} ms; {smi}")
    return out


def tp_images(run):
    """Whether a run wrote validation images (TensorBoard event files; the
    card's machine may have neither matplotlib nor tensorboardX)."""
    import importlib.util
    tb = [p for p in run.iterdir() if p.name.startswith("events.out")]
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("matplotlib", "tensorboardX")}
    return (f"validation images {'written' if tb else 'not written'} "
            f"(matplotlib {have['matplotlib']}, tensorboardX "
            f"{have['tensorboardX']})")


def tp_sharding(name, rec, full, need):
    """Each rank's sharded tensors against the full checkpoint ``full``:
    the sharded axis at 1/TP of the checkpoint's, the other axes whole;
    ``need`` ({what: (pattern, count)}): how many of them each pattern must
    match."""
    import re
    counts = {w: n for w, (_, n) in need.items()}
    for r in rec:
        sh = r["sharded"]
        for k, (dim, shape) in sh.items():
            want = list(full[k].shape)
            want[dim] //= TP
            if shape != want or want[dim] * TP != full[k].shape[dim]:
                raise SystemExit(f"chip_smoke: {name}: rank {r['rank']} "
                                 f"holds {k} at {shape}, the checkpoint "
                                 f"{list(full[k].shape)} (want {want})")
        got = {w: sum(bool(re.search(pat, k)) for k in sh)
               for w, (pat, _) in need.items()}
        if got != counts:
            raise SystemExit(f"chip_smoke: {name}: rank {r['rank']}'s "
                             f"sharded tensors are {got}, want {counts}")
    if [sorted(r["sharded"]) for r in rec[1:]] != [sorted(rec[0]["sharded"])
                                                   ] * (len(rec) - 1):
        raise SystemExit(f"chip_smoke: {name}: the ranks shard different "
                         "tensors")
    log(f"  {name} sharding: each rank holds {len(rec[0]['sharded'])} "
        f"tensors at 1/{TP} of the checkpoint's axis: "
        f"{counts}; the rest replicated")


def phase16b(tcfg, p14, smi):
    """train --model tacotron2 --tp 2 at full width (2 gloo ranks sharing
    the card, validate_at_start and async_save; run in phase 14's launch)
    against 14a's one-process run of the same command: per-iteration
    losses and gradient norms, the iteration-0 validation, the final
    weights, one writer's files; each rank's lstm_gates launches (3 a
    decoder step at 4H/N columns) and attention_step launches; the
    checkpoint loads into a full Tacotron2 in this process."""
    import torch
    from cookietts_tpu_torch.models.tacotron2 import Tacotron2
    tmp, want = p14["tmp"], p14["want"]
    iters = DP_ITERS["tacotron2"]
    one, two = tmp / "run14a_1", tmp / "run16b_2"
    rec = p14["rec"]["16b"]
    n2 = [r["kernel_launches"] for r in rec]
    log(f"  16b Tacotron2 --tp {TP} (Tacotron2Config(), batch 16, {iters} "
        f"iterations): ranks {[round(r['seconds'], 1) for r in rec]} s in "
        f"phase 14's launch (1 process {p14['one']['14a'][1]:.1f} s); "
        f"launches attention_step / lstm_gates by rank "
        f"{[(n['attention_step'], n['lstm_gates']) for n in n2]} (want "
        f"{want} / {3 * want} each); {tp_images(two)}")
    if any((n["attention_step"], n["lstm_gates"]) != (want, 3 * want)
           for n in n2):
        raise SystemExit("chip_smoke: the tp train command's kernel launches "
                         "are not one per decoder step and cell")
    lr = 0.5e-3 + (1e-3 - 0.5e-3) * iters / 1000
    dp_compare(f"16b Tacotron2 tp {TP}", (one, two), iters, lr, smi,
               what=f"tp {TP}")
    full = torch.load(two / f"checkpoint_{iters}")["state_dict"]
    hidden = {c: getattr(tcfg, f"{c}_dim") for c in TP_CELLS
              if getattr(tcfg, f"{c}_dim")}
    tp_sharding("16b", rec, full, {
        "cells' weights and biases": (
            r"decoder\.\w+_rnn\.(weight_ih|weight_hh|bias_ih|bias_hh)$",
            4 * len(hidden)),
        "encoder convs": (r"encoder\.convolutions\.\d+\.0\.conv\.weight$",
                          tcfg.encoder_n_convolutions)})
    widths = {c: h // TP for c, h in hidden.items()}
    cols = {}
    for h in widths.values():
        cols[str(4 * h)] = cols.get(str(4 * h), 0) + want
    log(f"  16b decoder cells' c widths by rank "
        f"{[r['cell_widths'] for r in rec]}, lstm_gates W columns by rank "
        f"{[r['lstm_cols'] for r in rec]} (want {widths}, {cols}: 4H/{TP} "
        f"of H = {hidden})")
    if any(r["cell_widths"] != widths or r["lstm_cols"] != cols
           for r in rec):
        raise SystemExit("chip_smoke: 16b: the decoder cells did not run "
                         f"lstm_gates at 4H/{TP} columns")
    model = Tacotron2(tcfg, device="cuda")
    model.load_state_dict(full)
    log(f"  16b the tp run's checkpoint_{iters} loads into a full "
        f"Tacotron2 in one process (strict)")


def phase16c(hk, p14, smi):
    """train --model waveglow --tp 2 at WaveGlowConfig() (run in phase 14's
    launch) against one process: per-iteration losses and gradient norms,
    both validations, the final weights, one writer; each rank's validation
    runs waveglow_wn_forward on the gathered weights (the launches of one
    process's), training none; each rank holds its shards of every WN's
    start, cond projection, gated and res/skip layers."""
    import torch
    from cookietts_tpu_torch.models.waveglow import WaveGlowConfig
    tmp = p14["tmp"]
    run1, dt1, n1 = p14["one"]["16c"]
    rec = p14["rec"]["16c"]
    cfg = WaveGlowConfig(**WAVEGLOW_TRAIN)
    want = {k: 0 for k in n1}
    want["waveglow_wn_forward"] = 2 * cfg.n_flows * hk.wn_launches(
        cfg.n_layers)
    n2 = [r["kernel_launches"] for r in rec]
    log(f"  16c WaveGlow --tp {TP} (WaveGlowConfig(), batch 4, "
        f"{TP_FLOW_ITERS} iterations): ranks "
        f"{[round(r['seconds'], 1) for r in rec]} s in phase 14's launch, 1 "
        f"process {dt1:.1f} s; launches 1 process {n1}, ranks {n2} (want "
        f"{want}: two validations of one batch)")
    if any(n != want for n in [n1] + n2):
        raise SystemExit("chip_smoke: the tp WaveGlow run's launch counts")
    dp_compare(f"16c WaveGlow tp {TP}", (run1, tmp / "run16c_2"),
               TP_FLOW_ITERS, 1e-4, smi, what=f"tp {TP}")
    full = torch.load(tmp / "run16c_2" / f"checkpoint_{TP_FLOW_ITERS}")[
        "state_dict"]
    layers = cfg.n_flows * cfg.n_layers
    tp_sharding("16c", rec, full, {
        "starts": (r"WN\.\d+\.start\.weight$", cfg.n_flows),
        "cond layers": (r"WN\.\d+\.cond_layer\.weight$", cfg.n_flows),
        "gated layers": (r"WN\.\d+\.in_layers\.\d+\.weight$", layers),
        "res/skip layers": (r"WN\.\d+\.res_skip_layers\.\d+\.weight$",
                            layers)})


def phase16(hk, check, tcfg, p14, smi):
    t0 = time.perf_counter()
    shards = phase16a(hk, check, smi)
    t1 = time.perf_counter()
    phase16b(tcfg, p14, smi)
    t2 = time.perf_counter()
    phase16c(hk, p14, smi)
    jobs = {k: max(r["seconds"] for r in p14["rec"][k]) for k in ("16b", "16c")}
    log(f"  phase 16a {t1 - t0:.1f} s, 16b {t2 - t1:.1f} s of checks here "
        f"({jobs['16b']:.1f} s of ranks in phase 14's launch), 16c "
        f"{time.perf_counter() - t2:.1f} s of checks here ({jobs['16c']:.1f} s "
        f"of ranks in the launch, {p14['one']['16c'][1]:.1f} s for its "
        f"one-process twin in phase 14); {smi}")
    return shards


# -- phase 17: sequence parallelism (train --sp), sharded inference -----------

SP = 2
# 17a: 16c's command at --sp 2; 17b: WaveFlow at phase 8b's recipe, 2
# iterations, validations at the start and, with a checkpoint, at 2
SP_FLOW_ITERS = 2
SP_WAVEFLOW_HPARAMS = hparams_of({**WAVEFLOW, **FLOW_DATA, **CADENCE,
                                  "validate_at_start": True,
                                  "async_save": True, "max_val_batches": 1})
# 17c: WaveGlow at phase 4b's widths on a 30 s mel, HiFi-GAN at phase 4's
# bench-serving configuration on a 2048-frame mel
SP_INFER_JOB = "sp-infer"
SP_WAVEGLOW_FRAMES = 30 * FLOW_SR // FLOW_HOP
SP_HIFIGAN_FRAMES = 2048
SP_HIFIGAN = dict(upsample_rates=(8, 8, 4, 2),
                  upsample_kernel_sizes=(16, 16, 8, 4))


def p17c_inputs(tmp):
    """17c's inputs, seeded, in a file the ranks read: the models'
    configurations, the mels and z."""
    import torch
    g = torch.Generator().manual_seed(17)
    frames = SP_WAVEGLOW_FRAMES
    cols = frames * WAVEGLOW["hop_length"] // WAVEGLOW["n_group"]
    path = tmp / "sp_infer_inputs.pt"
    torch.save({"glow_kw": WAVEGLOW, "hifigan_kw": SP_HIFIGAN,
                "mel": torch.randn(1, frames, WAVEGLOW["n_mel_channels"],
                                   generator=g),
                "z": 0.6 * torch.randn(1, cols, WAVEGLOW["n_group"],
                                       generator=g),
                "hmel": torch.randn(1, SP_HIFIGAN_FRAMES, 80, generator=g)
                - 5.0}, path)
    return path


def p17c_models(inp):
    """The WaveGlow of phase 4b (seed 11) and the HiFi-GAN of phase 4
    (seed 0) at ``inp``'s configurations, on DEV."""
    import torch
    from cookietts_tpu_torch.models.hifigan import Generator, HiFiGANConfig
    glow = make_flow_vocoder(inp["glow_kw"], seed=11)
    torch.manual_seed(0)
    return glow, Generator(HiFiGANConfig(**inp["hifigan_kw"]), device=DEV)


def device_parts(fn, prefixes):
    """(the output of one ``fn()``, its wall ms, the device-busy ms inside
    it, and the device ms of the kernels whose names hold each of
    ``prefixes``): torch.profiler's raw kineto records."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    busy = sum(e.duration_ns() for e in events) / 1e6
    parts = {p: sum(e.duration_ns() for e in events if p in e.name()) / 1e6
             for p in prefixes}
    return out, wall, busy, parts


# the kernels' device functions: the WN's (csrc/wn_layer.cuh) and the
# resblock's (csrc/hifigan_resblock.cu)
WN_KERNELS = ("wn_start_kernel", "wn_gemm", "wn_end_kernel")
RESBLOCK_KERNELS = ("resblock_pair_fused", "resblock_conv_split")


def p17c_alone(glow, gen, cols, frames):
    """Device ms alone on the card (CUDA-graph replay, time_ms) at a rank's
    shapes and at one process's: one infer's WN calls (their cond
    projections and kernels; the time depends on the shapes only) at
    ``cols`` columns and at the whole utterance's, and the generator at
    ``frames`` mel frames and at the whole mel's."""
    import torch
    out = {}
    g = torch.Generator(device=DEV).manual_seed(3)
    D = glow.WN[0].cond_layer.in_channels
    with torch.no_grad():
        for what, n, f in (("run", cols[0], frames[0]),
                           ("whole", cols[1], frames[1])):
            xs = [torch.randn(1, wn.start.in_channels, n, generator=g,
                              device=DEV) for wn in glow.WN]
            cond = torch.randn(1, D, n, generator=g, device=DEV)
            out[f"waveglow_{what}"] = time_ms(
                lambda: [wn(x, cond) for wn, x in zip(glow.WN, xs)], 2)
            del xs, cond
            mel = torch.randn(1, f, 80, generator=g, device=DEV)
            out[f"hifigan_{what}"] = time_ms(lambda: gen(mel, infer=True), 2)
    return out


def p17c_run(hk, model, fn, prefixes):
    """``fn`` warmed, then once with its launches counted and its device
    time split: (output, record)."""
    fn()
    hk.reset_launch_counts()
    out, wall, busy, parts = device_parts(fn, prefixes)
    return out, {"launches": dict(hk.LAUNCHES), "wall_ms": wall,
                 "busy_ms": busy, "kernel_ms": sum(parts.values())}


def sp_infer_job(hk, name, inputs, out):
    """17c on one rank of the launch: WaveGlow's ``infer`` and HiFi-GAN's
    generator on this rank's run of the mels at sp SP (z the rank's columns
    of one process's), each warmed, then counted and timed; the runs saved
    beside the spec for the main process, the record as the train jobs'."""
    import torch
    from cookietts_tpu_torch.parallel import (HALO, initialize, make_mesh,
                                              process_index)
    initialize(DEV, "gloo")
    rank = process_index()
    _, _, sp = make_mesh(1, SP)
    inp = torch.load(inputs)
    glow, gen = p17c_models(inp)

    def run_of(x):
        n = x.shape[1] // SP
        return x[:, sp.rank * n:(sp.rank + 1) * n].to(DEV)

    mel, z, hmel = run_of(inp["mel"]), run_of(inp["z"]), run_of(inp["hmel"])
    t0 = time.perf_counter()
    audio, rec_glow = p17c_run(hk, glow, lambda: glow.infer(mel, z=z, sp=sp),
                               WN_KERNELS)
    halo = dict(HALO)
    wav, rec_gen = p17c_run(hk, gen, lambda: gen(hmel, infer=True, sp=sp),
                            RESBLOCK_KERNELS)
    torch.save({"waveglow": audio.cpu(), "hifigan": wav.cpu()},
               out / f"sp_infer_{rank}.pt")
    (out / f"rank_job_{name}_{rank}.json").write_text(json.dumps({
        "job": name, "rank": rank, "seconds": time.perf_counter() - t0,
        "waveglow": rec_glow, "hifigan": rec_gen, "halo": halo,
        "kernel_launches": {}}))


def halo_per_iteration(rec):
    """Each rank's halo bytes sent under autograd (the training steps'
    forwards, recomputes and backwards) over the iterations."""
    return [(r["halo"]["bytes"] - r["halo"]["bytes_no_grad"]) / SP_FLOW_ITERS
            for r in rec]


def phase17a(hk, p14, smi):
    """train --model waveglow --sp 2 at WaveGlowConfig() (run in phase 14's
    launch) against 16c's one-process run of the same command: per-iteration
    losses and gradient norms, both validations, the final weights, one
    writer; each rank's validation runs waveglow_wn_forward on its widened
    runs (one process's launches), training none. Prints the halo bytes an
    iteration."""
    from cookietts_tpu_torch.models.waveglow import WaveGlowConfig, wn_reach
    tmp = p14["tmp"]
    run1, dt1, n1 = p14["one"]["16c"]
    rec = p14["rec"]["17a"]
    cfg = WaveGlowConfig(**WAVEGLOW_TRAIN)
    want = {k: 0 for k in n1}
    want["waveglow_wn_forward"] = 2 * cfg.n_flows * hk.wn_launches(
        cfg.n_layers)
    n2 = [r["kernel_launches"] for r in rec]
    train_bytes = halo_per_iteration(rec)
    log(f"  17a WaveGlow --sp {SP} (WaveGlowConfig(), batch 4, "
        f"{FLOW_SEGMENT} samples, {SP_FLOW_ITERS} iterations, validations "
        f"at the start and at {SP_FLOW_ITERS}): ranks "
        f"{[round(r['seconds'], 1) for r in rec]} s in phase 14's launch, 1 "
        f"process {dt1:.1f} s; launches 1 process {n1}, ranks {n2} (want "
        f"{want}); halo bytes sent an iteration by rank {train_bytes} "
        f"(exchanges in the job {[r['halo']['exchanges'] for r in rec]}; "
        f"the validations' {[r['halo']['bytes_no_grad'] for r in rec]} bytes, "
        f"the WN's reach {wn_reach(cfg)} columns a flow)")
    if any(n != want for n in [n1] + n2) or not all(train_bytes):
        raise SystemExit("chip_smoke: the sp WaveGlow run's launch counts or "
                         "halo exchanges")
    dp_compare(f"17a WaveGlow sp {SP}", (run1, tmp / "run17a_2"),
               TP_FLOW_ITERS, 1e-4, smi, what=f"sp {SP}")


def phase17b(hk, p14, smi):
    """WaveFlow at phase 8b's recipe, --sp 2, against its one-process twin:
    the losses, both validations (the row kernel on the gathered time axis
    on every rank: one process's launches), the final weights."""
    from cookietts_tpu_torch.models.waveglow import WaveGlowConfig
    tmp = p14["tmp"]
    run1, dt1, n1 = p14["one"]["17b"]
    rec = p14["rec"]["17b"]
    cfg = WaveGlowConfig(**WAVEFLOW)
    want = {k: 0 for k in n1}
    want["waveflow_row_step"] = (2 * cfg.n_flows * cfg.n_group
                                 * hk.wn_launches(cfg.n_layers))
    n2 = [r["kernel_launches"] for r in rec]
    log(f"  17b WaveFlow --sp {SP} (phase 4b's, batch 4, {SP_FLOW_ITERS} "
        f"iterations): ranks {[round(r['seconds'], 1) for r in rec]} s in the "
        f"launch, 1 process {dt1:.1f} s; launches 1 process {n1}, ranks {n2} "
        f"(want {want}: the validations gather the time axis); halo bytes "
        f"sent an iteration by rank {halo_per_iteration(rec)}")
    if any(n != want for n in [n1] + n2):
        raise SystemExit("chip_smoke: the sp WaveFlow run's launch counts")
    dp_compare(f"17b WaveFlow sp {SP}", (run1, tmp / "run17b_2"),
               SP_FLOW_ITERS, 1e-4, smi, what=f"sp {SP}")


def phase17c(hk, p14, smi):
    """Sharded inference at sp 2 against one process on the same inputs:
    WaveGlow's infer with the same z (atol 2e-4), HiFi-GAN's generator
    (phase 5's resblock tolerance); each rank's launches of the kernel (a
    whole WN a flow, a resblock a call, on the widened runs: one process's
    counts), device ms beside one process's."""
    import torch
    from cookietts_tpu_torch.models.waveglow import wn_reach
    tmp = p14["tmp"]
    rec = p14["rec"]["17c"]
    inp = torch.load(tmp / "sp_infer_inputs.pt")
    glow, gen = p17c_models(inp)
    mel, z, hmel = (inp[k].to(DEV) for k in ("mel", "z", "hmel"))
    with torch.no_grad():
        audio, one_glow = p17c_run(hk, glow, lambda: glow.infer(mel, z=z),
                                   WN_KERNELS)
        wav, one_gen = p17c_run(hk, gen, lambda: gen(hmel, infer=True),
                                RESBLOCK_KERNELS)
    reach = wn_reach(glow.cfg)
    alone = p17c_alone(glow, gen, (z.shape[1] // SP + reach, z.shape[1]),
                       (hmel.shape[1] // SP + gen.reach(), hmel.shape[1]))
    log(f"  17c alone on the card, device ms (CUDA-graph replay) at a "
        f"rank's widened run and at the whole utterance: WaveGlow's 48 WN "
        f"calls "
        f"{alone['waveglow_run']:.2f} at {z.shape[1] // SP + reach} columns, "
        f"{alone['waveglow_whole']:.2f} at {z.shape[1]} (ratio "
        f"{alone['waveglow_run'] / max(alone['waveglow_whole'], 1e-9):.3f}); "
        f"the generator {alone['hifigan_run']:.2f} at "
        f"{hmel.shape[1] // SP + gen.reach()} frames, "
        f"{alone['hifigan_whole']:.2f} at {hmel.shape[1]} (ratio "
        f"{alone['hifigan_run'] / max(alone['hifigan_whole'], 1e-9):.3f}); "
        f"{smi}")
    runs = [torch.load(tmp / f"sp_infer_{r}.pt") for r in range(DP_WORLD)]
    got_glow = torch.cat([r["waveglow"] for r in runs], 1).to(DEV)
    got_gen = torch.cat([r["hifigan"] for r in runs], 1).to(DEV)
    d_glow = float((got_glow - audio).abs().max())
    d_gen = float((got_gen - wav).abs().max())
    log(f"  17c WaveGlow: {SP_WAVEGLOW_FRAMES} frames (30 s), each rank's "
        f"run widened by {wn_reach(glow.cfg)} columns a flow, halo bytes by "
        f"rank {[r['halo']['bytes'] for r in rec]}; max abs against one "
        f"process {d_glow:.2e} (limit 2e-4); HiFi-GAN {SP_HIFIGAN_FRAMES} "
        f"frames, reach {gen.reach()} frames: {d_gen:.2e} (limit "
        f"{TOL['hifigan_resblock'][0]:.0e} + {TOL['hifigan_resblock'][1]:.0e}"
        f" |x|); {smi}")
    if not (torch.allclose(got_glow, audio, atol=2e-4, rtol=1e-4)
            and torch.allclose(got_gen, wav,
                               atol=TOL["hifigan_resblock"][0],
                               rtol=TOL["hifigan_resblock"][1])):
        raise SystemExit("chip_smoke: 17c: the sharded inference is not one "
                         "process's")
    for what, one, key in (("WaveGlow", one_glow, "waveglow_wn_forward"),
                           ("HiFi-GAN", one_gen, "hifigan_resblock")):
        part = "waveglow" if what == "WaveGlow" else "hifigan"
        ranks = [r[part] for r in rec]
        log(f"  17c {what} at sp {SP}: launches of {key} 1 process "
            f"{one['launches'].get(key, 0)}, ranks "
            f"{[r['launches'].get(key, 0) for r in ranks]}; the kernel's "
            f"device ms 1 process {one['kernel_ms']:.2f}, ranks "
            f"{[round(r['kernel_ms'], 2) for r in ranks]}; device-busy ms "
            f"{one['busy_ms']:.2f}, ranks "
            f"{[round(r['busy_ms'], 2) for r in ranks]}; wall ms "
            f"{one['wall_ms']:.1f}, ranks "
            f"{[round(r['wall_ms'], 1) for r in ranks]} (the ranks share the "
            f"card)")
        want = one["launches"].get(key, 0)
        if want == 0 or any(r["launches"].get(key, 0) != want for r in ranks):
            raise SystemExit(f"chip_smoke: 17c {what}: the ranks did not "
                             f"launch {key} as one process does")


def phase17(hk, p14, smi):
    t0 = time.perf_counter()
    phase17a(hk, p14, smi)
    t1 = time.perf_counter()
    phase17b(hk, p14, smi)
    t2 = time.perf_counter()
    phase17c(hk, p14, smi)
    jobs = {k: max(r["seconds"] for r in p14["rec"][k])
            for k in ("17a", "17b", "17c")}
    log(f"  phase 17a {t1 - t0:.1f} s, 17b {t2 - t1:.1f} s, 17c "
        f"{time.perf_counter() - t2:.1f} s of checks here; {jobs} s of ranks "
        f"in phase 14's launch ({p14['one']['17b'][1]:.1f} s for 17b's "
        f"one-process twin in phase 14); {smi}")


# -- phase 18: the bf16 serving path -------------------------------------------

BF16_GATES = {"tacotron2_mse": 5e-3, "tacotron2_mcd_db": 0.5,
              "hifigan_mcd_db": 1.0}     # JAX's bench_quality_gate (bench.py)


def bf16(t):
    import torch
    return t.to(torch.bfloat16)


def bf16_ulp(x) -> float:
    """One bf16 ulp at the scale of max |x| (8 significant bits)."""
    m = float(x.detach().abs().max())
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


def attention_bound_bf16(B, T, A=192, D=512):
    """(s by bytes, s by operations) of the bf16 form: qp, lp, mp and memory
    in bf16, v, ctx and w in f32, the mask 1 byte; the operations at the
    bf16 tensor-core rate."""
    nbytes = 2 * (B * A + 2 * B * T * A + B * T * D) + 4 * (A + B * D + B * T) + B * T
    return nbytes / HBM_BYTES_PER_S, B * T * (4 * A + 2 * D) / BF16_FLOPS


def lstm_bound_bf16(B, F, H):
    nbytes = 2 * (B * F + F * 4 * H + 4 * H) + 4 * 3 * B * H
    return nbytes / HBM_BYTES_PER_S, 2 * B * F * 4 * H / BF16_FLOPS


def resblock_bound_bf16(B, C, T, k, P=3):
    nbytes = 2 * (2 * B * C * T + 2 * P * C * C * k) + 4 * 2 * P * C
    return nbytes / HBM_BYTES_PER_S, P * 2 * 2 * C * C * k * T * B / BF16_FLOPS


def p18_times(f32_fn, kernel_fn, plain_fn, reps, graph=False):
    """(bf16 kernel, f32 kernel, bf16 plain) device ms by CUDA-graph replay,
    in turns (f32, bf16, bf16, f32) so neither gets the warmer card."""
    timer = graph_ms if graph else (lambda fn: time_ms(fn, reps))
    f32_a = timer(f32_fn)
    ms = min(timer(kernel_fn), timer(kernel_fn))
    f32_ms = min(f32_a, timer(f32_fn))
    return ms, f32_ms, timer(plain_fn)


def phase18a(hk, check, smi):
    """The bf16 forms of the serving path's three kernels against their
    plain bf16 versions on the card, at the main path's shapes (the decode
    step at B=4, T_enc=64, the LSTM cells at B=4 and 32, the 12 resblocks of
    the bench-serving generator at B=3, T_mel=512), plus a ragged attention
    memory (D=1313, row 0 empty) and ragged resblock widths; each timed by
    CUDA-graph replay beside its f32 form on the same values, with its bound
    (bf16 bytes at 3.35 TB/s, operations at 989 TFLOP/s)."""
    import torch
    from cookietts_tpu_torch.ops import _build
    g = torch.Generator(device="cuda").manual_seed(18)
    lib = _build.library("attention_step")
    out = {}

    # attention_step_bf16
    for B, T, D, window, empty in ((4, 64, 512, 16, False), (1, 128, 1313, 16, True),
                                   (32, 384, 512, 16, False), (4, 64, 512, 0, False)):
        a32 = attention_inputs(B, T, g, D=D, window=window, empty_row=empty)
        a16 = (bf16(a32[0]), bf16(a32[1]), bf16(a32[2]), a32[3], bf16(a32[4]), a32[5])
        plan = hk.attention_step_plan(B, T, 192, D, elem=2)
        if lib.attention_step_smem_bf16(192, D, *plan.ints()[1:]) != plan.smem:
            raise SystemExit("chip_smoke: attention_step_plan's bf16 shared "
                             "memory is not the kernel's layout")
        before = hk.LAUNCHES["attention_step_bf16"]
        ctx, w = hk.attention_step(*a16)
        again = hk.attention_step(*a16)
        ctx_p, w_p = hk.attention_step_plain(*a16)
        tag = f"B={B} T={T} D={D} {'window 16' if window else 'full mask'}" + (
            " empty row 0" if empty else "")
        check("attention_step_bf16", w, w_p, *TOL["attention_step_bf16"], tag + " w")
        check("attention_step_bf16", ctx, ctx_p, 1e-4, 1e-4, tag + " ctx")
        same = torch.equal(ctx, again[0]) and torch.equal(w, again[1])
        if hk.LAUNCHES["attention_step_bf16"] - before != 2 or not same \
                or ctx.dtype != torch.float32:
            raise SystemExit(f"chip_smoke: attention_step_bf16 {tag}: one f32 "
                             "launch a call, bit-identical twice")
        if (B, T, D, window) == (4, 64, 512, 16):
            fns = (lambda: hk.attention_step(*a32), lambda: hk.attention_step(*a16),
                   lambda: hk.attention_step_plain(*a16))
            ms, f32_ms, plain_ms = p18_times(*fns, 200)
            in_graph = p18_times(*fns, 200, graph=True)
            log(f"  attention_step_bf16 B={B} T_enc={T}: a call in a graph of 20 "
                f"{in_graph[0]:.4f} ms, the f32 form {in_graph[1]:.4f}, plain "
                f"{in_graph[2]:.4f}")
            out["attention_step_bf16"] = dict(
                unit=f"one decode step, B={B}, T_enc={T}",
                ms=ms, f32_ms=f32_ms, plain_ms=plain_ms, library_ms=None,
                eager_ms=eager_ms(lambda: hk.attention_step(*a16), 200),
                bound=bound_of([attention_bound_bf16(B, T)]), plan=plan.ints())

    # lstm_gates_bf16: the three decoder cells
    for B in (4, 32):
        cases32, cases16 = [], []
        for name, F, H in LSTM_SHAPES:
            xh, W, b, c = lstm_inputs(B, F, H, g)
            cases32.append((xh, W, b, c))
            cases16.append((bf16(xh), bf16(W), bf16(b), c))
            first = hk.lstm_gates(*cases16[-1])
            for i, (got, want) in enumerate(zip(first, hk.lstm_gates_plain(
                    *cases16[-1]))):
                check("lstm_gates_bf16", got, want, *TOL["lstm_gates_bf16"],
                      f"B={B} {name} {'ch'[i]}")
            again = hk.lstm_gates(*cases16[-1])
            if not all(torch.equal(a, b_) for a, b_ in zip(first, again)):
                raise SystemExit(f"chip_smoke: lstm_gates_bf16 B={B} {name} is "
                                 "not deterministic")
        if B == 4:
            run = lambda cases, fn: lambda: [fn(*cs) for cs in cases]  # noqa: E731
            ms, f32_ms, plain_ms = p18_times(
                run(cases32, hk.lstm_gates), run(cases16, hk.lstm_gates),
                run(cases16, hk.lstm_gates_plain), 200)
            out["lstm_gates_bf16"] = dict(
                unit=f"one decode step (3 cells), B={B}", ms=ms, f32_ms=f32_ms,
                plain_ms=plain_ms, library_ms=None,
                eager_ms=eager_ms(run(cases16, hk.lstm_gates), 200),
                bound=bound_of([lstm_bound_bf16(B, F, H) for _, F, H in LSTM_SHAPES]))

    # hifigan_resblock_bf16: the 12 resblocks of one bench-serving generator
    # call at B=3, T_mel=512 (stages C = 256, 128, 64, 32)
    B, T, blocks32, blocks16, parts = 3, 512, [], [], []
    for C, u in ((256, 8), (128, 8), (64, 4), (32, 2)):
        T *= u
        x = torch.randn(B, C, T, device="cuda", generator=g)
        for k in (3, 7, 11):
            _, w1, b1, w2, b2 = resblock_inputs(1, C, 1, k, g)
            w1, w2 = bf16(w1).float(), bf16(w2).float()   # the same values in both
            blocks32.append((x, w1, b1, w2, b2, (1, 3, 5), 0.1))
            blocks16.append((bf16(x), bf16(w1), b1, bf16(w2), b2, (1, 3, 5), 0.1))
            parts.append(resblock_bound_bf16(B, C, T, k))
        del x
    means = []
    for a in blocks16:
        before = hk.LAUNCHES["hifigan_resblock_bf16"]
        got = hk.hifigan_resblock(*a)
        n = hk.LAUNCHES["hifigan_resblock_bf16"] - before
        want = hk.hifigan_resblock_plain(*a)
        atol = 2 * bf16_ulp(want)
        means.append(float((got.float() - want.float()).abs().mean()))
        check("hifigan_resblock_bf16", got.float(), want.float(), atol, 0.0,
              f"B={B} C={a[0].shape[1]} T={a[0].shape[2]} k={a[1].shape[1]} "
              f"(2 ulps at max: {atol:.3g}; mean abs {means[-1]:.3g})")
        if n != hk.hifigan_resblock_launches(a[0].shape[1], 3, True) \
                or got.dtype != torch.bfloat16:
            raise SystemExit("chip_smoke: hifigan_resblock_bf16 launch count "
                             "or dtype")
        del got, want
    for C in (96, 24, 6):                         # ragged widths, 2-byte weights
        a = resblock_inputs(1, C, 4096 + 7, 7, torch.Generator(
            device="cuda").manual_seed(C))
        a = (bf16(a[0]), bf16(a[1]), a[2], bf16(a[3]), a[4], (1, 3, 5), 0.1)
        want = hk.hifigan_resblock_plain(*a)
        check("hifigan_resblock_bf16", hk.hifigan_resblock(*a).float(),
              want.float(), 2 * bf16_ulp(want), 0.0, f"C={C} k=7 T=4103 ragged")
    ms, f32_ms, plain_ms = p18_times(
        lambda: [hk.hifigan_resblock(*a) for a in blocks32],
        lambda: [hk.hifigan_resblock(*a) for a in blocks16],
        lambda: [hk.hifigan_resblock_plain(*a) for a in blocks16], 3)
    out["hifigan_resblock_bf16"] = dict(
        unit=f"one generator call (12 resblocks), B={B}, T_mel=512",
        ms=ms, f32_ms=f32_ms, plain_ms=plain_ms, library_ms=None,
        eager_ms=eager_ms(lambda: [hk.hifigan_resblock(*a) for a in blocks16], 3),
        bound=bound_of(parts), mean_abs=max(means))
    del blocks32, blocks16
    for name, o in out.items():
        log(f"  {name:22s} {o['unit']}: kernel {o['ms']:.4f} ms (eager "
            f"{o['eager_ms']:.4f} ms), f32 form {o['f32_ms']:.4f} ms, plain "
            f"{o['plain_ms']:.4f} ms, bound {o['bound'][0]:.4f} ms "
            f"({o['bound'][1]}) ({smi})")
    torch.cuda.synchronize()
    return out


def p18_checkpoints(tmp, tcfg, hcfg):
    """Seeded Tacotron2 (no style heads) and HiFi-GAN checkpoints with their
    sidecars, as phase 9 writes them, for the bf16 tts command."""
    import torch
    from cookietts_tpu_torch.models.hifigan import Generator
    from cookietts_tpu_torch.models.tacotron2 import Tacotron2
    from cookietts_tpu_torch.runtime.checkpoint import save_checkpoint
    config_json = lambda cfg: {k: v for k, v in dataclasses.asdict(  # noqa: E731
        cfg).items() if k != "dtype"}
    files = {k: str(tmp / k) for k in ("taco", "hifigan")}
    torch.manual_seed(30)
    save_checkpoint(files["taco"],
                    {"state_dict": Tacotron2(tcfg, device="cpu").state_dict()},
                    {"model": "tacotron2", "model_config": config_json(tcfg),
                     "speaker_ids": {"narrator": 0},
                     "audio": {"sampling_rate": SR, "hop_length": HOP,
                               "n_mel_channels": tcfg.n_mel_channels}})
    torch.manual_seed(31)
    save_checkpoint(files["hifigan"],
                    {"state_dict": Generator(hcfg, device="cpu").state_dict()},
                    {"model": "hifigan", "model_config": config_json(hcfg),
                     "audio": {"sampling_rate": SR, "hop_length": HOP,
                               "n_mel_channels": hcfg.n_mel_channels}})
    return files


F32_FORMS = ("attention_step", "lstm_gates", "hifigan_resblock")
BF16_FORMS = tuple(n + "_bf16" for n in F32_FORMS)


def p18_launches(hk, got, want, what):
    """The bf16 forms launched as ``want`` says (at least once where want
    is None) and no f32 form of the three."""
    log(f"  {what} launches {got}")
    for name in BF16_FORMS:
        n = got.get(name, 0)
        if n <= 0 or (want is not None and n != want[name]):
            raise SystemExit(f"chip_smoke: {what}: {name} launched {n} times"
                             + ("" if want is None else f", expected {want[name]}"))
    if any(got.get(name, 0) for name in F32_FORMS):
        raise SystemExit(f"chip_smoke: {what}: an f32 form launched on the "
                         "bf16 path")


def phase18b(hk, check, tcfg, hcfg, smi):
    """The main path in bf16: T2S over Tacotron2Config(dtype=bfloat16) and
    the bench-serving HiFi-GAN in bf16, phase 4's weights (same seed), phase
    4's three requests through the CUDA-graph chunks; the counters zeroed
    before and read after (each bf16 form launched, no f32 form); a
    replayed bf16 chunk against the eager bf16 chunk, bit for bit; JAX's
    quality gates against the same weights in f32 (bench_quality_gate:
    Tacotron2 teacher-forced mel MSE < 5e-3 and MCD < 0.5 dB at B=8,
    T_txt=96, T_mel=384, phase 4's weights; HiFi-GAN MCD < 1.0 dB on a
    256-frame mel at flax's initialisation, which JAX's gate measures, and
    logged, not gated, at phase 4's weights); one
    ``tts --hparams ...,dtype=bfloat16`` through the command's entry point
    in this process. Returns the bf16 forms' main-path launches."""
    import io
    import tempfile
    import wave

    import numpy as np
    import torch
    from cookietts_tpu_torch.audio.stft import TacotronSTFT
    from cookietts_tpu_torch.cli import main as cli
    from cookietts_tpu_torch.models.hifigan import Generator
    from cookietts_tpu_torch.models.tacotron2 import Tacotron2
    from cookietts_tpu_torch.ops.mcd import mcd
    from cookietts_tpu_torch.pipeline.chunk_graph import DecodeChunkGraphs
    from cookietts_tpu_torch.pipeline.text2speech import T2S, T2SConfig

    t0 = time.perf_counter()
    torch.manual_seed(0)                        # phase 4's weights
    # the f32 twins wait on the host until the gates, so the requests' peak
    # memory holds what phase 4's holds: one model pair and its caches
    taco32 = Tacotron2(tcfg, device="cpu")
    gen32 = Generator(hcfg, device="cpu")
    taco = Tacotron2(dataclasses.replace(tcfg, dtype="bfloat16"), device="cpu")
    taco.load_state_dict(taco32.state_dict())
    taco.to("cuda")
    gen = Generator(dataclasses.replace(hcfg, dtype=torch.bfloat16), device="cpu")
    gen.load_state_dict(gen32.state_dict())
    gen.to("cuda")
    log(f"  bf16 models from phase 4's weights in {time.perf_counter() - t0:.1f} s")

    # 18b.1: phase 4's requests
    t2s_cfg = T2SConfig(batch_size=4, max_attempts=1, step_buckets=(256, 512),
                        max_decoder_steps=512)
    t2s = T2S(t2s_cfg, taco, {"alice": 0, "bob": 1}, vocoder_fn=gen,
              sample_rate=SR, hop_length=HOP, device="cuda")
    t2s.infer("A warm-up request.", speaker=["alice"], seed=99)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    hk.reset_launch_counts()
    figures = []
    for i, (text, speakers) in enumerate(MAIN_REQUESTS):
        t1 = time.perf_counter()
        res = t2s.infer(text, speaker=speakers, seed=i)
        seconds = time.perf_counter() - t1
        n_samples = int(res["mel_lengths"].sum()) * HOP
        if not np.isfinite(res["audio"]).all() or len(res["audio"]) != n_samples \
                or res["audio"].dtype != np.float32:
            raise SystemExit(f"chip_smoke: bf16 request {i}: audio not finite "
                             f"f32 of {n_samples} samples")
        figures.append(request_figures(res, seconds))
    peak = torch.cuda.max_memory_allocated()
    launches = {name: hk.LAUNCHES[name] for name in BF16_FORMS}
    p18_launches(hk, dict(hk.LAUNCHES), None, "bf16 main path")
    f32 = P4_FIGURES.get("requests") or [None] * len(figures)
    for i, (b, f) in enumerate(zip(figures, f32)):
        log(f"  request {i}: bf16 {b['s']:.3f} s (decode {b['decode_s']:.3f} s, "
            f"vocode {b['vocode_s']:.3f} s), {b['xrt']:.2f} x realtime, "
            f"mel_lengths {b['mel_lengths']}; " + (
                "f32 (phase 4) not run" if f is None else
                f"f32 (phase 4) {f['s']:.3f} s (decode {f['decode_s']:.3f} s, "
                f"vocode {f['vocode_s']:.3f} s), {f['xrt']:.2f} x realtime, "
                f"mel_lengths {f['mel_lengths']}"))
    gib = lambda n: n / 2 ** 30  # noqa: E731
    p4_peak, p4_base = P4_FIGURES.get("peak_bytes", 0), P4_FIGURES.get("base_bytes", 0)
    log(f"  peak memory: bf16 {gib(peak):.3f} GiB, {gib(peak - base):.3f} above "
        f"the {gib(base):.3f} GiB allocated before the requests (the models, "
        f"their bf16 copies and what earlier phases keep); f32 (phase 4) "
        f"{gib(p4_peak):.3f} GiB, {gib(p4_peak - p4_base):.3f} above "
        f"{gib(p4_base):.3f} ({smi})")
    del t2s

    # 18b.2: a replayed bf16 chunk equals the eager bf16 chunk
    B, T, S = 4, 64, 32
    memory, const, state = taco.inference_prepare(*decode_inputs(taco, B, T, 11))
    if memory.dtype != torch.bfloat16 or state.attn[0].dtype != torch.float32:
        raise SystemExit("chip_smoke: the bf16 decode's memory must be bf16 "
                         "and its cells' states f32")
    program = DecodeChunkGraphs(taco.decoder)
    seeded = lambda: torch.Generator(device="cuda").manual_seed(21)  # noqa: E731
    first = program(memory, const, state, S, seeded())       # eager, then capture
    before = dict(hk.LAUNCHES)
    replayed = program(memory, const, state, S, seeded())
    moved = {k: hk.LAUNCHES[k] - before[k] for k in before}
    eager = taco.decode_chunk(memory, const, state, S, seeded())
    want = {**{k: 0 for k in hk.LAUNCHES}, "attention_step_bf16": S,
            "lstm_gates_bf16": 3 * S}
    if moved != want:
        raise SystemExit(f"chip_smoke: a bf16 chunk replay must launch {want}, "
                         f"moved {moved}")
    for i, name in enumerate(("mel", "gate", "alignments")):
        same = torch.equal(replayed[i], eager[i]) and torch.equal(first[i], eager[i])
        log(f"  replayed bf16 chunk {name} ({replayed[i].dtype}): bit-identical "
            f"to the eager bf16 chunk: {same}")
        if not same:
            raise SystemExit(f"chip_smoke: the replayed bf16 chunk's {name} "
                             "differs from the eager chunk's")
    del program, first, replayed, eager, memory, const, state

    # 18b.3: JAX's quality gates against the same weights in f32
    taco32.to("cuda")
    gen32.to("cuda")
    rng = np.random.default_rng(7)
    Bq, T_txt, T_mel = 8, 96, 384
    batch = dict(
        text=torch.as_tensor(rng.integers(1, tcfg.n_symbols, (Bq, T_txt)),
                             device="cuda"),
        text_lengths=torch.full((Bq,), T_txt, device="cuda"),
        mels=torch.as_tensor(np.log(np.clip(np.abs(rng.standard_normal(
            (Bq, T_mel, tcfg.n_mel_channels))), 1e-5, None)),
            dtype=torch.float32, device="cuda"),
        mel_lengths=torch.full((Bq,), T_mel, device="cuda"),
        speaker_id=torch.as_tensor(rng.integers(0, tcfg.n_speakers, (Bq,)),
                                   device="cuda"),
        sylps=torch.full((Bq,), 4.0, device="cuda"))
    mels = {}
    for name, model in (("f32", taco32), ("bf16", taco)):
        g = torch.Generator(device="cuda").manual_seed(3)
        mels[name] = model.eval_forward(batch, g)["mel_outputs_postnet"].float(
            ).cpu().numpy()
    t2_mse = float(np.mean((mels["f32"] - mels["bf16"]) ** 2))
    t2_mcd = float(np.mean([mcd(mels["f32"][i], mels["bf16"][i]) for i in range(Bq)]))
    mel_h = torch.as_tensor(rng.standard_normal((1, 256, hcfg.n_mel_channels)),
                            dtype=torch.float32, device="cuda")
    hstft = TacotronSTFT(filter_length=2048, hop_length=HOP, win_length=2048,
                         n_mel_channels=80, sampling_rate=SR, mel_fmax=11025.0,
                         device="cpu")

    def vocoder_gate(g32, g16):
        w32, w16 = g32(mel_h, infer=True), g16(mel_h, infer=True)
        if w16.dtype != torch.float32:
            raise SystemExit("chip_smoke: the bf16 generator must return f32 audio")
        return (mcd(hstft.mel_spectrogram_np(w32[0].cpu().numpy()),
                    hstft.mel_spectrogram_np(w16[0].cpu().numpy())),
                float(((w32 - w16) ** 2).mean()))

    # JAX's gate measures flax's initialisation: weight norm's scale of ones
    # (every filter of unit norm) and zero biases; the port's training form
    # starts there (weight_g = 1), its biases zeroed
    torch.manual_seed(5)
    flax_init = {k: torch.zeros_like(t) if k.endswith("bias") else t for k, t in
                 Generator(hcfg, device="cpu", weight_norm=True).state_dict().items()}
    g32 = Generator(hcfg, device="cpu")
    g32.load_state_dict(flax_init)
    g16 = Generator(dataclasses.replace(hcfg, dtype=torch.bfloat16), device="cpu")
    g16.load_state_dict(flax_init)
    h_mcd, h_mse = vocoder_gate(g32.to("cuda"), g16.to("cuda"))
    p4_mcd, p4_mse = vocoder_gate(gen32, gen)
    gates = {"tacotron2_mse": t2_mse, "tacotron2_mcd_db": t2_mcd,
             "hifigan_mcd_db": h_mcd}
    log(f"  quality gates, bf16 against f32 from the same weights: Tacotron2 "
        f"(phase 4's weights) teacher-forced mel MSE {t2_mse:.3e} (< 5e-3), MCD "
        f"{t2_mcd:.4f} dB (< 0.5); HiFi-GAN (flax's initialisation) MCD "
        f"{h_mcd:.4f} dB (< 1.0), waveform MSE {h_mse:.3e}; not gated: "
        f"HiFi-GAN with phase 4's weights (torch's default initialisation, "
        f"filters about 1/1.7 of unit norm, random biases) MCD {p4_mcd:.4f} dB, "
        f"waveform MSE {p4_mse:.3e}")
    if any(not v < BF16_GATES[k] for k, v in gates.items()):
        raise SystemExit(f"chip_smoke: a bf16 quality gate failed: {gates}")
    del taco32, gen32, taco, gen, batch, g32, g16

    # 18b.4: tts --hparams dtype=bfloat16 in this process
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        files = p18_checkpoints(tmp, tcfg, hcfg)
        argv = ["tts", "--checkpoint", files["taco"], "--vocoder", files["hifigan"],
                "--text", P9_TEXT, "--max_attempts", "1", "--device", DEV,
                "--hparams", P9_HPARAMS + ",dtype=bfloat16", "-o",
                str(tmp / "b.wav")]
        t1 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli(argv)
        seconds = time.perf_counter() - t1
        lines = buf.getvalue().strip().splitlines()
        stats = json.loads(lines[-1])
        got = next(json.loads(l)["kernel_launches"] for l in lines
                   if l.startswith('{"kernel_launches"'))
        with wave.open(str(tmp / "b.wav")) as w:
            rate, n = w.getframerate(), w.getnframes()
    n_samples = P9_SEGMENTS * P9_STEPS * HOP
    log(f"  tts --hparams dtype=bfloat16 in this process: {seconds:.2f} s wall "
        f"(checkpoint loads and the first capture included), gen_time "
        f"{stats['gen_time']:.3f} s, total {stats['total_time']:.3f} s, "
        f"{stats['audio_seconds']:.3f} s of audio, {n} samples at {rate} Hz")
    if (rate, n, stats["segments"]) != (SR, n_samples, P9_SEGMENTS):
        raise SystemExit(f"chip_smoke: bf16 tts wrote {n} samples at {rate} Hz, "
                         f"expected {n_samples} at {SR}")
    resblocks = sum(hk.hifigan_resblock_launches(
        hcfg.upsample_initial_channel // 2 ** (i + 1), len(rd), True)
        for i in range(len(hcfg.upsample_rates)) for rd in hcfg.resblock_dilations)
    p18_launches(hk, got, {"attention_step_bf16": P9_STEPS,
                           "lstm_gates_bf16": 3 * P9_STEPS,
                           "hifigan_resblock_bf16": resblocks}, "bf16 tts")
    torch.cuda.synchronize()
    return launches, gates


def phase18(hk, check, tcfg, hcfg, smi):
    """18a, then 18b; returns (timing, launches) of the bf16 forms for the
    kernels line."""
    log("  18a: the three bf16 kernels against their plain versions")
    timing = phase18a(hk, check, smi)
    log("  18b: the main path in bf16")
    launches, _ = phase18b(hk, check, tcfg, hcfg, smi)
    return timing, launches


# -- phase 19: the bf16 flow vocoders ---------------------------------------------

WN_F32_FORMS = ("waveglow_wn_forward", "waveflow_row_step")
TF32X2_FLOPS = 495e12 / 2      # TF32 tensor cores, 2 products a flop (bf16 weights)
P19_GATE_FRAMES = 160          # bench_quality_gate's on-chip mel (2 s at 48 kHz)
WAVEGLOW_GATE = {"stft_mse": 0.05, "mcd_db": 1.0}    # bench.py:517-520


def wn_bound_bf16(B, T, Cin, C, Cout, L, rows, kw, rate):
    """wn_bound of a bf16 form: x and the output f32, cond_bc, the weights
    and (for a row step) the queues' rows bf16; the operations at ``rate``
    (2xTF32 for WaveGlow's form, bf16 for WaveFlow's)."""
    weights = Cin * C + C + L * (rows * kw * C * 2 * C + C * 2 * C + 2 * C) \
        + C * Cout + Cout
    state = L * rows * C * T * B if rows > 1 else 0
    nbytes = 4 * B * T * (Cin + Cout) + 2 * (B * T * L * 2 * C + weights + state)
    flops = B * T * (2 * Cin * C + L * 2 * 2 * C * (rows * kw + 1) * C
                     - 2 * C * C + 2 * C * Cout)
    return nbytes / HBM_BYTES_PER_S, flops / rate


def bf16_weights(w, form):
    """WN weights (start_w, ..., end_b) in the dtypes of the kernel's bf16
    ``form`` (hk.WN_BF16_DTYPES), and the same values in f32."""
    from cookietts_tpu_torch.ops import hopper_kernels as hk
    dtypes = list(hk.WN_BF16_DTYPES[form].values())[-len(w):]
    w16 = [t.to(d).contiguous() for t, d in zip(w, dtypes)]
    return w16, [t.float() for t in w16]


def p19_check_bf16(check, name, got, want, what):
    """A bf16 form that rounds to bf16 inside (WaveFlow's): within two bf16
    ulps at the largest value (an f32 ulp of another summation order can
    flip a rounding), the mean logged."""
    got, want = got.float(), want.float()
    atol = 2 * bf16_ulp(want)
    mean = float((got - want).abs().mean())
    check(name, got, want, atol, 0.0, f"{what} (mean {mean:.2e})")
    return mean


def phase19a(hk, check):
    """Both bf16 WN forms against their plain bf16 versions on the card at
    the main path's shapes, batch 1: WaveGlow's WN at T' = 10000 (5 s), its
    first flow (12 input channels) and last (1); four WaveFlow rows at W =
    30000 (the ring round once); ragged widths (C = 48; C = 50 at T' = 250,
    padded to 56 channels and 256 samples). Phase 21b times them."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(19)
    r = lambda *s: torch.randn(*s, device="cuda", generator=gen)  # noqa: E731
    L, kw, kh = 8, 3, 3

    # waveglow_wn_forward_bf16
    for C, T, cins in ((256, 10000, (12, 1)), (48, 1500, (4,)), (50, 250, (4,))):
        for Cin in cins:
            w16, _ = bf16_weights(wn_weights(gen, Cin, C, 2 * Cin, L, 1, kw),
                                  "glow_bf16")
            x, cond16 = r(1, Cin, T), bf16(r(1, L, 2 * C, T))
            before = dict(hk.LAUNCHES)
            got = hk.waveglow_wn_forward(x, cond16, *w16)
            moved = {k: hk.LAUNCHES[k] - before[k] for k in before}
            want = hk.waveglow_wn_forward_plain(x, cond16, *w16)
            check("waveglow_wn_forward_bf16", got, want,
                  *TOL["waveglow_wn_forward_bf16"], f"B=1 C={C} Cin={Cin} T'={T}")
            if moved != {**{k: 0 for k in moved},
                         "waveglow_wn_forward_bf16": hk.wn_launches(L, "glow_bf16")} \
                    or got.dtype != torch.float32:
                raise SystemExit(f"chip_smoke: waveglow_wn_forward_bf16 C={C}: "
                                 f"launches {moved}, dtype {got.dtype}")

    # waveflow_row_step_bf16
    for C, W in ((64, 30000), (48, 1500), (50, 250)):
        w16, _ = bf16_weights(wn_weights(gen, 1, C, 2, L, kh, kw), "flow_bf16")
        cond = bf16(r(1, L, 2 * C, W))
        ring = torch.zeros(L, kh, 1, C, W, device="cuda", dtype=torch.bfloat16)
        queues = torch.zeros(L, kh - 1, 1, C, W, device="cuda", dtype=torch.bfloat16)
        x_prev = torch.zeros(1, W, device="cuda")
        before = dict(hk.LAUNCHES)
        for step in range(4):
            log_s, t = hk.waveflow_row_step(x_prev, ring, step, cond, *w16)
            ls_p, t_p, queues = hk.waveflow_row_step_plain(x_prev, queues, cond, *w16)
            tag = f"B=1 C={C} W={W} row {step}"
            p19_check_bf16(check, "waveflow_row_step_bf16", log_s, ls_p, tag + " log_s")
            p19_check_bf16(check, "waveflow_row_step_bf16", t, t_p, tag + " t")
            p19_check_bf16(check, "waveflow_row_step_bf16",
                           hk.ring_queues(ring, step + 1), queues, tag + " queues")
            x_prev = r(1, W)
        moved = {k: hk.LAUNCHES[k] - before[k] for k in before}
        if moved != {**{k: 0 for k in moved},
                     "waveflow_row_step_bf16": 4 * hk.wn_launches(L, "flow_bf16")} \
                or log_s.dtype != torch.float32 or ring.dtype != torch.bfloat16:
            raise SystemExit(f"chip_smoke: waveflow_row_step_bf16 C={C}: "
                             f"launches {moved}")
        del ring, queues, cond
    torch.cuda.synchronize()


def flax_init(model, seed):
    """The weights bench_quality_gate measures (bench.py:463-481): flax's
    initialisation (lecun-normal kernels, a truncated normal of std
    fan_in^-0.5 / 0.8796 cut at 2 std; zero biases; the 1x1 convs kept as
    the rotations they are built as), then the end layers' kernels filled
    with 0.002 normals."""
    import torch
    from torch import nn
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, mod in model.named_modules():
            if not isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d)) \
                    or name.startswith("convinv"):
                continue
            w = mod.weight
            fan_in = w[0].numel() if not isinstance(mod, nn.ConvTranspose1d) \
                else w.shape[0] * w[0, 0].numel()
            std = fan_in ** -0.5 / 0.87962566103423978
            if name.endswith(".end"):
                new = 0.002 * torch.randn(w.shape, generator=g)
            else:
                new = torch.empty(w.shape)
                nn.init.trunc_normal_(new, std=std, a=-2 * std, b=2 * std,
                                      generator=g)
            w.copy_(new)
            if mod.bias is not None:
                mod.bias.zero_()


def gate_metrics(a, b):
    """JAX's WaveGlow gate (bench.py:497-516): STFT magnitude MSE over
    1200- and 2400-sample windows, and the MCD of 160-band mels, 48 kHz."""
    import torch
    from cookietts_tpu_torch.audio.stft import STFT, TacotronSTFT
    from cookietts_tpu_torch.ops.mcd import mcd
    n = min(a.shape[-1], b.shape[-1])
    a, b = a[..., :n].float(), b[..., :n].float()
    mse = 0.0
    for f, h, w in ((1200, 300, 1200), (2400, 600, 2400)):
        bank = STFT(f, h, w, device=DEV)
        ma, _ = bank.transform(a, return_phase=False)
        mb, _ = bank.transform(b, return_phase=False)
        mse += float(torch.mean((ma - mb) ** 2)) / 2
    stft = TacotronSTFT(filter_length=2400, hop_length=600, win_length=2400,
                        n_mel_channels=160, sampling_rate=FLOW_SR,
                        mel_fmax=16000.0, device="cpu")
    return mse, mcd(stft.mel_spectrogram_np(a[0].cpu().numpy()),
                    stft.mel_spectrogram_np(b[0].cpu().numpy()))


def phase19b(hk, check, smi):
    """The full-width flow vocoders in bf16: phase 4b's weights (same seed)
    in f32 and in bf16, the 5 s infer of each (400 frames, batch 1) with the
    counters zeroed before and read after (each bf16 WN form exactly its
    launches, no f32 form), wall time in turns beside f32; then JAX's
    WaveGlow gate at bench_quality_gate's on-chip shapes (160 frames, one
    fixed f32 z through the f32 path and the bf16 kernel path, flax's
    initialisation with the end fill): STFT MSE < 0.05, MCD < 1.0 dB;
    logged, not gated: WaveFlow at the same initialisation and WaveGlow at
    phase 4b's. Returns the bf16 forms' launches."""
    import numpy as np
    import torch
    launches = {}
    mel400 = torch.randn(1, 400, FLOW_MELS, device=DEV,
                         generator=torch.Generator(device=DEV).manual_seed(8))
    g = torch.Generator(device=DEV).manual_seed(19)
    mel_gate = torch.randn(1, P19_GATE_FRAMES, FLOW_MELS, device=DEV, generator=g)
    for name, kw in (("WaveGlow", WAVEGLOW), ("WaveFlow", WAVEFLOW)):
        key = "waveflow_row_step_bf16" if kw.get("channel_mixing") \
            else "waveglow_wn_forward_bf16"
        m32 = make_flow_vocoder(kw, seed=11)
        m16 = make_flow_vocoder(dict(kw, dtype="bfloat16"), seed=11)
        m16.load_state_dict(m32.state_dict())
        calls = kw["n_flows"] * (kw["n_group"] if m16.waveflow else 1)
        gen = lambda: torch.Generator(device=DEV).manual_seed(2)  # noqa: E731
        hk.reset_launch_counts()
        audio = m16.infer(mel400, gen())
        torch.cuda.synchronize()
        got = dict(hk.LAUNCHES)
        form = "flow_bf16" if m16.waveflow else "glow_bf16"
        want = {**{k: 0 for k in got}, key: calls * hk.wn_launches(kw["n_layers"], form)}
        log(f"  {name} bf16 infer (400 frames, B=1) launches: {key} {got[key]} "
            f"(want {want[key]}), f32 forms "
            f"{[got[k] for k in WN_F32_FORMS]}")
        if got != want:
            raise SystemExit(f"chip_smoke: {name} bf16 infer launched {got}")
        launches[key] = got[key]
        if audio.dtype != torch.float32 or audio.shape != (1, 400 * FLOW_HOP) \
                or not bool(torch.isfinite(audio).all()):
            raise SystemExit(f"chip_smoke: {name} bf16 audio {audio.dtype} "
                             f"{tuple(audio.shape)} or not finite")
        seconds = 400 * FLOW_HOP / FLOW_SR
        f32_a = wall_ms(lambda: m32.infer(mel400, gen()))
        b_ms = min(wall_ms(lambda: m16.infer(mel400, gen())) for _ in range(2))
        f32_ms = min(f32_a, wall_ms(lambda: m32.infer(mel400, gen())))
        p4b = P4_FIGURES.get(f"{name}_infer_ms")
        log(f"  {name}.infer 5 s, B=1: bf16 {b_ms:.1f} ms = "
            f"{seconds * 1e3 / b_ms:.1f} x realtime; f32 {f32_ms:.1f} ms = "
            f"{seconds * 1e3 / f32_ms:.1f} x realtime (phase 4b: "
            + ("not run" if p4b is None else f"{p4b:.1f} ms") + f") ({smi})")
        # JAX's gate: one fixed f32 z through both paths
        n = P19_GATE_FRAMES * FLOW_HOP // kw["n_group"]
        z = torch.randn((1, kw["n_group"], n) if m16.waveflow else
                        (1, n, kw["n_group"]), device=DEV, generator=g)
        torch_init = gate_metrics(m32.inverse(z, mel_gate), m16.inverse(z, mel_gate))
        flax_init(m32, seed=5)
        m16.load_state_dict(m32.state_dict())
        mse, mcd_db = gate_metrics(m32.inverse(z, mel_gate), m16.inverse(z, mel_gate))
        log(f"  {name} gate, bf16 against f32 on one f32 z ({P19_GATE_FRAMES} "
            f"frames): flax's initialisation with the end fill STFT MSE "
            f"{mse:.3e}, MCD {mcd_db:.4f} dB"
            + (" (gated: < 0.05, < 1.0 dB)" if name == "WaveGlow" else
               " (logged)") + f"; phase 4b's weights (torch's initialisation) "
            f"STFT MSE {torch_init[0]:.3e}, MCD {torch_init[1]:.4f} dB (logged)")
        if name == "WaveGlow" and not (mse < WAVEGLOW_GATE["stft_mse"]
                                       and mcd_db < WAVEGLOW_GATE["mcd_db"]):
            raise SystemExit(f"chip_smoke: the bf16 WaveGlow gate failed: "
                             f"{mse}, {mcd_db}")
        if not np.isfinite([mse, mcd_db, *torch_init]).all():
            raise SystemExit(f"chip_smoke: {name} gate numbers not finite")
        del m32, m16, z
    torch.cuda.synchronize()
    return launches


def phase19c(hk, tcfg, smi):
    """In-process entry points in bf16: one ``tts --hparams
    ...,dtype=bfloat16`` with a seeded full-width WaveGlow checkpoint behind
    a 160-mel Tacotron2 and ``--denoiser`` (the command's launch counts:
    the bf16 forms only); then ``train --model waveglow --hparams
    ...,dtype=bfloat16`` at WaveGlowConfig() on a synthetic 48 kHz corpus,
    2 iterations with one validation: finite losses, the validation
    launching waveglow_wn_forward_bf16 only."""
    import io
    import tempfile
    import wave
    import torch
    from cookietts_tpu_torch.cli import main as cli
    from cookietts_tpu_torch.models.tacotron2 import Tacotron2
    from cookietts_tpu_torch.runtime.checkpoint import save_checkpoint
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        cfg = dataclasses.replace(tcfg, n_mel_channels=FLOW_MELS)
        audio = {"sampling_rate": FLOW_SR, "hop_length": FLOW_HOP,
                 "n_mel_channels": FLOW_MELS}
        torch.manual_seed(32)
        save_checkpoint(str(tmp / "taco"),
                        {"state_dict": Tacotron2(cfg, device="cpu").state_dict()},
                        {"model": "tacotron2", "model_config": {
                            k: v for k, v in dataclasses.asdict(cfg).items()
                            if k != "dtype"}, "speaker_ids": {"narrator": 0},
                         "audio": {"sampling_rate": SR, "hop_length": HOP,
                                   "n_mel_channels": FLOW_MELS}})
        save_checkpoint(str(tmp / "glow"),
                        {"state_dict": make_flow_vocoder(WAVEGLOW, 33).state_dict()},
                        {"model": "waveglow", "model_config": WAVEGLOW,
                         "audio": audio})
        argv = ["tts", "--checkpoint", str(tmp / "taco"), "--vocoder",
                str(tmp / "glow"), "--denoiser", "--denoise_strength", "0.1",
                "--text", P9_TEXT, "--max_attempts", "1", "--device", DEV,
                "--hparams", P9_HPARAMS + ",dtype=bfloat16", "-o",
                str(tmp / "b.wav")]
        t1 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli(argv)
        seconds = time.perf_counter() - t1
        lines = buf.getvalue().strip().splitlines()
        stats = json.loads(lines[-1])
        got = next(json.loads(l)["kernel_launches"] for l in lines
                   if l.startswith('{"kernel_launches"'))
        with wave.open(str(tmp / "b.wav")) as w:
            rate, n = w.getframerate(), w.getnframes()
        want = P9_SEGMENTS * P9_STEPS * FLOW_HOP
        log(f"  19c tts bf16 (WaveGlow, --denoiser) in this process: "
            f"{seconds:.2f} s wall (checkpoints written in {t1 - t0:.1f} s), "
            f"gen_time {stats['gen_time']:.3f} s, total {stats['total_time']:.3f} "
            f"s, {n} samples at {rate} Hz; launches {got}")
        if (rate, n) != (FLOW_SR, want):
            raise SystemExit(f"chip_smoke: 19c tts wrote {n} samples at {rate} "
                             f"Hz, expected {want} at {FLOW_SR}")
        per_infer = WAVEGLOW["n_flows"] * hk.wn_launches(WAVEGLOW["n_layers"],
                                                         "glow_bf16")
        expect = {**{k: 0 for k in got}, "attention_step_bf16": P9_STEPS,
                  "lstm_gates_bf16": 3 * P9_STEPS,
                  "waveglow_wn_forward_bf16": per_infer}
        if got != expect:
            raise SystemExit(f"chip_smoke: 19c tts launches {got}, expected "
                             f"{expect}")
        p19_train(hk, tmp, smi)
    torch.cuda.synchronize()


def p19_train(hk, tmp, smi):
    """19c's ``train --model waveglow --hparams ...,dtype=bfloat16``."""
    import torch
    from cookietts_tpu_torch.cli import main as cli
    from cookietts_tpu_torch.models.waveglow import WaveGlowConfig
    t1 = time.perf_counter()
    flow_map = vocoder_corpus(tmp / "wav48k", FLOW_SR, 10,
                              1.5 * FLOW_SEGMENT / FLOW_SR, seed=19)
    cfg = WaveGlowConfig(**WAVEGLOW_TRAIN)
    per_batch = cfg.n_flows * hk.wn_launches(cfg.n_layers, "glow_bf16")
    hk.reset_launch_counts()
    trainer = cli(["train", "--model", "waveglow", "--filelist", flow_map,
                   "--run_dir", str(tmp / "run"), "--seed", "0",
                   "--device", DEV, "--iters", "2", "--hparams",
                   hparams_of({**WAVEGLOW_TRAIN, **FLOW_DATA, **CADENCE,
                               "dtype": "bfloat16"})])
    torch.cuda.synchronize()
    got = dict(hk.LAUNCHES)
    want = {**{k: 0 for k in got},
            "waveglow_wn_forward_bf16": len(trainer.val_batches) * per_batch}
    ev = [json.loads(line) for line in
          (tmp / "run" / "events.jsonl").read_text().splitlines()]
    train = [(e["step"], e["loss"], e["iter_s"]) for e in ev
             if e["prefix"] == "train"]
    val = [e["val_loss"] for e in ev if e["prefix"] == "validation"]
    log(f"  19c train --model waveglow bf16 (WaveGlowConfig(), batch "
        f"{FLOW_DATA['batch_size']}): {time.perf_counter() - t1:.1f} s; "
        f"losses {[(k, round(v, 4)) for k, v, _ in train]}, s per iteration "
        f"{[round(t, 3) for _, _, t in train]}, validation {val}; "
        f"launches {got} (want {want}) ({smi})")
    if got != want or trainer.state.model.cfg.dtype != torch.bfloat16 \
            or [k for k, _, _ in train] != [0, 1] or len(val) != 1 \
            or not all(math.isfinite(v) for v in [l for _, l, _ in train] + val):
        raise SystemExit("chip_smoke: 19c bf16 WaveGlow training")


def phase19(hk, check, tcfg, smi):
    """19a, 19b, 19c; returns the launches of the two bf16 WN forms for the
    kernels line (19b's bf16 infers)."""
    log("  19a: the two bf16 WN forms against their plain versions")
    phase19a(hk, check)
    log("  19b: the full-width flow vocoders in bf16")
    launches = phase19b(hk, check, smi)
    log("  19c: bf16 tts with a flow vocoder and the denoiser, bf16 training")
    phase19c(hk, tcfg, smi)
    return launches


# -- phase 20: the main path's two bf16 kernels, redesigned for Hopper ------------

P20_LSTM_B = (1, 4, 32, 128)


def library_lstm_cell_bf16(W, b, H):
    """nn.LSTMCell in bf16 computing lstm_gates(xh, W, b, c) for xh = [x; h]
    (library_lstm_cell's weights, cast): the yardstick of the bf16 form."""
    import torch
    return library_lstm_cell(W.float(), b.float(), H).to(torch.bfloat16)


def phase20a(hk, check, smi):
    """lstm_gates_bf16 (TMA-fed, split-K in a cluster) at the three cells
    for B = 1, 4, 32, 128, and hifigan_resblock_bf16 (wgmma; h on chip up to
    C = 64) at the bench-serving generator's 12 resblocks (B=3, T_mel=512,
    and B = 1, 32 at T_mel=32) and phase 18a's ragged widths, each against
    its plain version at phase 18a's tolerances, with exact launches and a
    repeated call equal to the bit. Returns the timing cases."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(20)
    lstm = {}
    for B in P20_LSTM_B:
        cases = []
        for name, F, H in LSTM_SHAPES:
            xh, W, b, c = lstm_inputs(B, F, H, g)
            a16 = (bf16(xh), bf16(W), bf16(b), c)
            before = hk.LAUNCHES["lstm_gates_bf16"]
            got = hk.lstm_gates(*a16)
            again = hk.lstm_gates(*a16)
            n = hk.LAUNCHES["lstm_gates_bf16"] - before
            for i, (x_, w_) in enumerate(zip(got, hk.lstm_gates_plain(*a16))):
                check("lstm_gates_bf16", x_, w_, *TOL["lstm_gates_bf16"],
                      f"20a B={B} {name} {'ch'[i]}")
            if n != 2 or not all(torch.equal(x_, y_) for x_, y_ in zip(got, again)):
                raise SystemExit(f"chip_smoke: lstm_gates_bf16 B={B} {name}: one "
                                 "launch a call, bit-identical twice")
            cases.append(((xh, W, b, c), a16, F, H))
        lstm[B] = cases
        plan = [hk.lstm_gates_bf16_plan(B, F, H).ints() for _, F, H in LSTM_SHAPES]
        log(f"  lstm_gates_bf16 B={B}: plans (nt, cluster, ring) {plan}")

    def resblocks(B, T_mel):
        blocks, T = [], T_mel
        for C, u in ((256, 8), (128, 8), (64, 4), (32, 2)):
            T *= u
            x = torch.randn(B, C, T, device="cuda", generator=g)
            for k in (3, 7, 11):
                _, w1, b1, w2, b2 = resblock_inputs(1, C, 1, k, g)
                w1, w2 = bf16(w1).float(), bf16(w2).float()
                blocks.append(((x, w1, b1, w2, b2, (1, 3, 5), 0.1),
                               (bf16(x), bf16(w1), b1, bf16(w2), b2, (1, 3, 5), 0.1)))
        return blocks

    def check_block(a, what):
        C, k = a[0].shape[1], a[1].shape[1]
        before = hk.LAUNCHES["hifigan_resblock_bf16"]
        got = hk.hifigan_resblock(*a)
        again = hk.hifigan_resblock(*a)
        n = hk.LAUNCHES["hifigan_resblock_bf16"] - before
        want = hk.hifigan_resblock_plain(*a)
        check("hifigan_resblock_bf16", got.float(), want.float(),
              2 * bf16_ulp(want), 0.0, f"20a {what} C={C} T={a[0].shape[2]} k={k}")
        if n != 2 * hk.hifigan_resblock_launches(C, 3, True) or \
                not torch.equal(got, again) or got.dtype != torch.bfloat16:
            raise SystemExit(f"chip_smoke: hifigan_resblock_bf16 {what} C={C} "
                             f"k={k}: launches {n}, bit-identical twice, bf16")

    main_blocks = resblocks(3, 512)
    for _, a in main_blocks:
        check_block(a, "B=3 T_mel=512")
    for B in (1, 32):
        for _, a in resblocks(B, 32):
            check_block(a, f"B={B} T_mel=32")
    for C in (96, 24, 6):
        a = resblock_inputs(1, C, 4096 + 7, 7, torch.Generator(device="cuda").manual_seed(C))
        check_block((bf16(a[0]), bf16(a[1]), a[2], bf16(a[3]), a[4], (1, 3, 5), 0.1),
                    "ragged")
    torch.cuda.synchronize()
    return lstm, main_blocks


def phase20b(hk, lstm, main_blocks, smi):
    """Times by CUDA-graph replay, each beside the f32 form on the same
    values, the plain version and the bound (bf16 bytes at 3.35 TB/s,
    operations at 989 TFLOP/s): the decode step's three cells at B = 1, 4,
    32, 128 beside nn.LSTMCell in bf16; the 12 resblocks of a generator
    call at B=3, T_mel=512 and each of its four stages. Returns the two
    kernels' entries of the kernels line (the B=4 step, the generator
    call)."""
    import torch
    out = {}
    run = lambda cases, fn: lambda: [fn(*cs) for cs in cases]  # noqa: E731
    for B, cases in lstm.items():
        c32 = [c[0] for c in cases]
        c16 = [c[1] for c in cases]
        cells = [(library_lstm_cell_bf16(W, b_, H), bf16(xh[:, :F - H]), bf16(xh[:, F - H:]),
                  bf16(c)) for (xh, W, b_, c), _, F, H in cases]
        with torch.no_grad():
            ms, f32_ms, plain_ms = p18_times(run(c32, hk.lstm_gates), run(c16, hk.lstm_gates),
                                             run(c16, hk.lstm_gates_plain), 200)
            lib_ms = time_ms(run(cells, lambda cell, x, h, c: cell(x, (h, c))), 200)
            in_graph = graph_ms(run(c16, hk.lstm_gates))
        bound = bound_of([lstm_bound_bf16(B, F, H) for _, F, H in LSTM_SHAPES])
        log(f"  lstm_gates_bf16 decode step B={B}: kernel {ms:.4f} ms (a step in a "
            f"graph of 20 {in_graph:.4f}), f32 form {f32_ms:.4f}, plain {plain_ms:.4f}, "
            f"nn.LSTMCell bf16 {lib_ms:.4f}, bound {bound[0]:.4f} ({bound[1]}) ({smi})")
        if B == 4:
            out["lstm_gates_bf16"] = dict(
                unit=f"one decode step (3 cells), B={B}", ms=ms, f32_ms=f32_ms,
                plain_ms=plain_ms, library_ms=lib_ms,
                eager_ms=eager_ms(run(c16, hk.lstm_gates), 200), bound=bound)
    del lstm
    for i in range(4):
        blocks = main_blocks[3 * i:3 * i + 3]
        B, C, T = blocks[0][1][0].shape
        bound = bound_of([resblock_bound_bf16(B, C, T, a[1].shape[1]) for _, a in blocks])
        ms = time_ms(lambda: [hk.hifigan_resblock(*a) for _, a in blocks], 5)
        how = ("one launch a pair, h on chip" if hk.hifigan_resblock_bf16_plan(
            B, C, T, 11, 5).fused else "two launches a pair")
        log(f"  hifigan_resblock_bf16 stage C={C} T={T} ({how}): {ms:.4f} ms, bound "
            f"{bound[0]:.4f} ({bound[1]}), {bound[0] / ms:.2f} of it ({smi})")
    ms, f32_ms, plain_ms = p18_times(
        lambda: [hk.hifigan_resblock(*a) for a, _ in main_blocks],
        lambda: [hk.hifigan_resblock(*a) for _, a in main_blocks],
        lambda: [hk.hifigan_resblock_plain(*a) for _, a in main_blocks], 3)
    B, C, T = main_blocks[0][1][0].shape
    bound = bound_of([resblock_bound_bf16(*a[0].shape, a[1].shape[1])
                      for _, a in main_blocks])
    log(f"  hifigan_resblock_bf16 generator call B={B} T_mel=512 (12 resblocks): "
        f"kernel {ms:.4f} ms, f32 form {f32_ms:.4f}, plain {plain_ms:.4f}, bound "
        f"{bound[0]:.4f} ({bound[1]}) ({smi})")
    out["hifigan_resblock_bf16"] = dict(
        unit=f"one generator call (12 resblocks), B={B}, T_mel=512", ms=ms,
        f32_ms=f32_ms, plain_ms=plain_ms, library_ms=None,
        eager_ms=eager_ms(lambda: [hk.hifigan_resblock(*a) for _, a in main_blocks], 3),
        bound=bound)
    torch.cuda.synchronize()
    return out


def phase20(hk, check, smi):
    """20a, then 20b; returns the two kernels' timing for the kernels line."""
    log("  20a: lstm_gates_bf16 and hifigan_resblock_bf16 against their plain "
        "versions")
    lstm, main_blocks = phase20a(hk, check, smi)
    log("  20b: times by graph replay")
    return phase20b(hk, lstm, main_blocks, smi)


# -- phase 21: the flow vocoders' two bf16 WN kernels, redesigned for Hopper ------

BF16X3_FLOPS = BF16_FLOPS / 3  # f32 operands as three bf16 pieces: 3 products a flop
# (B, C, T', Cin): the main path's first and last flow, the ragged widths, T'
# not a multiple of 8, a validation batch (phase 8b: 24000 samples, 24 groups)
P21_GLOW = ((1, 256, 10000, 12), (1, 256, 10000, 1), (1, 48, 1500, 4),
            (1, 50, 250, 4), (1, 256, 250, 12), (4, 256, 1000, 12))
# (B, C, W): the main path, the ragged widths, W = 250, a validation batch
P21_FLOW = ((1, 64, 30000), (1, 48, 1500), (1, 50, 250), (4, 64, 3000))


def phase21a(hk, check):
    """waveglow_wn_forward_bf16 and waveflow_row_step_bf16 (one launch a layer
    on wgmma) against their plain versions at phase 19a's tolerances at
    every shape of P21_GLOW and P21_FLOW (WaveFlow over 4 rows, the ring
    round once), each call exactly wn_launches(L, form) launches, and a
    second call on the same inputs (WaveFlow: on a copy of the ring) equal
    to the bit."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(21)
    r = lambda *s: torch.randn(*s, device="cuda", generator=gen)  # noqa: E731
    L, kw, kh = 8, 3, 3
    for B, C, T, Cin in P21_GLOW:
        w16, _ = bf16_weights(wn_weights(gen, Cin, C, 2 * Cin, L, 1, kw), "glow_bf16")
        x, cond16 = r(B, Cin, T), bf16(r(B, L, 2 * C, T))
        before = dict(hk.LAUNCHES)
        got = hk.waveglow_wn_forward(x, cond16, *w16)
        again = hk.waveglow_wn_forward(x, cond16, *w16)
        moved = {k: hk.LAUNCHES[k] - before[k] for k in before}
        want = hk.waveglow_wn_forward_plain(x, cond16, *w16)
        check("waveglow_wn_forward_bf16", got, want, *TOL["waveglow_wn_forward_bf16"],
              f"21a B={B} C={C} Cin={Cin} T'={T}")
        if moved != {**{k: 0 for k in moved},
                     "waveglow_wn_forward_bf16": 2 * hk.wn_launches(L, "glow_bf16")} \
                or not torch.equal(got, again):
            raise SystemExit(f"chip_smoke: 21a waveglow_wn_forward_bf16 B={B} C={C} "
                             f"T'={T}: launches {moved}, bit-identical twice "
                             f"{torch.equal(got, again)}")
    for B, C, W in P21_FLOW:
        w16, _ = bf16_weights(wn_weights(gen, 1, C, 2, L, kh, kw), "flow_bf16")
        cond = bf16(r(B, L, 2 * C, W))
        ring = torch.zeros(L, kh, B, C, W, device="cuda", dtype=torch.bfloat16)
        queues = torch.zeros(L, kh - 1, B, C, W, device="cuda", dtype=torch.bfloat16)
        x_prev = torch.zeros(B, W, device="cuda")
        before = dict(hk.LAUNCHES)
        for step in range(4):
            twin = ring.clone()
            log_s, t = hk.waveflow_row_step(x_prev, ring, step, cond, *w16)
            log_s2, t2 = hk.waveflow_row_step(x_prev, twin, step, cond, *w16)
            ls_p, t_p, queues = hk.waveflow_row_step_plain(x_prev, queues, cond, *w16)
            tag = f"21a B={B} C={C} W={W} row {step}"
            p19_check_bf16(check, "waveflow_row_step_bf16", log_s, ls_p, tag + " log_s")
            p19_check_bf16(check, "waveflow_row_step_bf16", t, t_p, tag + " t")
            p19_check_bf16(check, "waveflow_row_step_bf16",
                           hk.ring_queues(ring, step + 1), queues, tag + " queues")
            if not (torch.equal(log_s, log_s2) and torch.equal(t, t2)
                    and torch.equal(ring, twin)):
                raise SystemExit(f"chip_smoke: {tag}: a second call differs")
            x_prev = r(B, W)
        moved = {k: hk.LAUNCHES[k] - before[k] for k in before}
        if moved != {**{k: 0 for k in moved},
                     "waveflow_row_step_bf16": 8 * hk.wn_launches(L, "flow_bf16")}:
            raise SystemExit(f"chip_smoke: 21a waveflow_row_step_bf16 B={B} C={C} "
                             f"W={W}: launches {moved}")
        del ring, queues, cond
    torch.cuda.synchronize()


def phase21b(hk, smi):
    """The two bf16 WN kernels timed by CUDA-graph replay over the 48 calls of
    one 5 s infer (WaveGlow: 48 flows at T' = 10000, Cin 12 - k // 4;
    WaveFlow: 6 flows x 8 rows at W = 30000), in turns beside the f32 form
    on the same values, with the plain version and the bound: WaveGlow's by
    operations at 989 / 3 TFLOP/s (the design's three bf16 products a flop;
    at the first bf16 form's 2xTF32 rate too), WaveFlow's by bf16 bytes.
    Returns the kernels line's entries."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(19)
    r = lambda *s: torch.randn(*s, device="cuda", generator=gen)  # noqa: E731
    L, kw, kh, out = 8, 3, 3, {}
    T, n_calls = 10000, WAVEGLOW["n_flows"]
    calls = []
    for k in range(n_calls):             # WAVEGLOW's flow k: 12 - k // 4 inputs
        Cin = 12 - k // 4
        w16, w32 = bf16_weights(wn_weights(gen, Cin, 256, 2 * Cin, L, 1, kw),
                                "glow_bf16")
        calls.append((r(1, Cin, T), w16, w32))
    cond16 = bf16(r(1, L, 512, T))
    cond32 = cond16.float()
    fns = (lambda: [hk.waveglow_wn_forward(x, cond32, *w) for x, _, w in calls],
           lambda: [hk.waveglow_wn_forward(x, cond16, *w) for x, w, _ in calls],
           lambda: [hk.waveglow_wn_forward_plain(x, cond16, *w) for x, w, _ in calls])
    ms, f32_ms, plain_ms = p18_times(*fns, 2)
    parts = [(1, T, x.shape[1], 256, 2 * x.shape[1], L, 1, kw) for x, _, _ in calls]
    first_form = bound_of([wn_bound_bf16(*p, rate=TF32X2_FLOPS) for p in parts])
    out["waveglow_wn_forward_bf16"] = dict(
        unit=f"the {n_calls} WN calls of one 5 s infer, B=1, T'={T}",
        ms=ms, f32_ms=f32_ms, plain_ms=plain_ms, library_ms=None,
        eager_ms=eager_ms(fns[1], 2),
        bound=bound_of([wn_bound_bf16(*p, rate=BF16X3_FLOPS) for p in parts]),
        note=f"bound at the 2xTF32 rate {first_form[0]:.3f} ms")
    del calls, cond16, cond32

    W = 30000
    n_calls = WAVEFLOW["n_flows"] * WAVEFLOW["n_group"]
    flows = [bf16_weights(wn_weights(gen, 1, 64, 2, L, kh, kw), "flow_bf16")
             for _ in range(WAVEFLOW["n_flows"])]
    cond16 = bf16(r(1, L, 128, W))
    cond32 = cond16.float()
    ring16 = bf16(r(L, kh, 1, 64, W))
    ring32 = ring16.float()
    queues16 = hk.ring_queues(ring16, 0).contiguous()
    x_prev = r(1, W)
    rows = [(w, h) for w in flows for h in range(WAVEFLOW["n_group"])]
    fns = (lambda: [hk.waveflow_row_step(x_prev, ring32, h, cond32, *w[1])
                    for w, h in rows],
           lambda: [hk.waveflow_row_step(x_prev, ring16, h, cond16, *w[0])
                    for w, h in rows],
           lambda: [hk.waveflow_row_step_plain(x_prev, queues16, cond16, *w[0])
                    for w, _ in rows])
    ms, f32_ms, plain_ms = p18_times(*fns, 2)
    out["waveflow_row_step_bf16"] = dict(
        unit=f"the {n_calls} row steps of one 5 s infer, B=1, W={W}",
        ms=ms, f32_ms=f32_ms, plain_ms=plain_ms, library_ms=None,
        eager_ms=eager_ms(fns[1], 2),
        bound=bound_of([wn_bound_bf16(1, W, 1, 64, 2, L, kh, kw, BF16_FLOPS)]
                       * n_calls), note="")
    del flows, rows, cond16, cond32, ring16, ring32, queues16
    for name, o in out.items():
        note = o.pop("note")
        log(f"  {name:24s} {o['unit']}: kernel {o['ms']:.4f} ms (eager "
            f"{o['eager_ms']:.3f} ms), f32 form {o['f32_ms']:.4f} ms on the same "
            f"values, plain {o['plain_ms']:.3f} ms, bound {o['bound'][0]:.4f} ms "
            f"({o['bound'][1]}), {o['bound'][0] / o['ms']:.2f} of it"
            + (f"; {note}" if note else "") + f" ({smi})")
    torch.cuda.synchronize()
    return out


def phase21(hk, check, smi):
    """21a, then 21b; returns the two kernels' timing for the kernels line."""
    log("  21a: waveglow_wn_forward_bf16 and waveflow_row_step_bf16 against "
        "their plain versions")
    phase21a(hk, check)
    log("  21b: times by graph replay")
    return phase21b(hk, smi)


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
    phase("1", "environment")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    log(f"  nvidia-smi: {smi}; TF32 off (matmul and cuDNN)")

    phase("2", "build")
    _build.load_all()
    log(f"  built/loaded {len(_build._LIBS)} kernel libraries in "
        f"{_build.BUILD_SECONDS:.1f} s")
    for logf in sorted(_build._build_dir().glob("*.log")):
        for kernel, report in ptxas_report(logf.read_text()):
            log(f"  {logf.stem}: {kernel}: {report}")

    check = Check()
    phase("3", "kernels against their plain versions (full width)")
    phase3(hk, check)
    phase3_flow(hk, check)
    phase3_widths(hk, check)

    phase("4", "main path, full width, 3 requests")
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
    phase("4b", "the flow vocoders behind T2S, full width")
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

    phase("5", "whole slice, kernels against plain versions")
    phase5(hk, check, (tcfg, hcfg))
    for name, model in flows:
        phase5_flow(hk, check, model, name)
    del flows, model

    phase("6", "the streaming and serving slice, full width")
    phase6(hk, check, tcfg, hcfg, smi)

    phase("7", "the training slice, full width")
    phase7(hk, check, tcfg, smi)

    phase("8", "vocoder training, full width")
    phase8(hk, check, smi)

    phase("9", "serving checkpoints through the tts and server commands")
    phase9(hk, check, tcfg, hcfg, smi)

    phase("10", "GMM and DCA attention, training with the heads, convert")
    phase10(hk, check, tcfg, hcfg, smi)

    phase("11", "serving exported artifacts (torch.export)")
    phase11(hk, check, tcfg, hcfg, smi)

    import tempfile
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        phase("12", "the GTA stage, the GAN postnet and the HiFi-GAN "
              "denoiser")
        corpus = phase12(hk, check, tcfg, smi, Path(tmp))

        phase("13", "UnTTS and GAN-TTS training, UnTTS inference")
        phase13(hk, check, corpus, Path(tmp), smi)

        phase("14", "data-parallel training across processes")
        p14 = phase14(hk, tcfg, Path(tmp), smi)

        phase("15", "pipeline stages 0 and 1: the preprocess command, the "
              "feature frontend on the card, Griffin-Lim")
        phase15(hk, Path(tmp), smi)

        phase("16", f"tensor parallelism, train --tp {TP}")
        phase16(hk, check, tcfg, p14, smi)

        phase("17", f"sequence parallelism, train --sp {SP}, sharded "
              "inference")
        phase17(hk, p14, smi)
        del p14

    phase("18", "the bf16 serving path")
    b16_timing, b16_launches = phase18(hk, check, tcfg, hcfg, smi)
    timing.update(b16_timing)
    launches.update(b16_launches)

    phase("19", "the bf16 flow vocoders")
    launches.update(phase19(hk, check, tcfg, smi))

    phase("20", "the main path's two bf16 kernels on Hopper: lstm_gates_bf16 "
          "and hifigan_resblock_bf16")
    timing.update(phase20(hk, check, smi))

    phase("21", "the flow vocoders' two bf16 WN kernels on Hopper: "
          "waveglow_wn_forward_bf16 and waveflow_row_step_bf16")
    timing.update(phase21(hk, check, smi))

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
    t_end = time.perf_counter()
    log(f"  phase seconds {json.dumps(phase_seconds(t_end))}")
    log(f"all phases passed in {t_end - t_all:.1f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-jobs"]:
        sys.exit(rank_jobs_main(sys.argv[2]))
    sys.exit(main())

"""Command-line interface of the port (cookietts_tpu/cli.py:32-41, 193-486,
701-977, 979-1339, 1454-1697).

Stages 0 and 1 of the pipeline, the corpus from the datasets' archives to
the filelists ``train`` reads:

    python -m cookietts_tpu_torch download -c download.json
    python -m cookietts_tpu_torch preprocess -c preprocess.json \
        [--device cuda|cpu]

``preprocess`` rewrites the wavs in place (resample, high-pass, trim,
loudness; the C++ kernels of data/native.py, built into ``build/`` at first
use) and writes the filelists, speaker and emotion info and
``meta_dump.json``; with ``on_device_features`` the fused feature frontend
runs on the device and writes the dataset's mel caches and the ``.gt.f0`` /
``.gt.energy`` dumps (pipeline/preprocess.py). The config's keys are
``PreprocessConfig``'s (configs/preprocess.json drives both packages).

    python -m cookietts_tpu_torch train --model tacotron2|hifigan|waveglow|\
        gan_postnet|hifigan_denoiser|untts|gantts --filelist f.txt \
        [--val_filelist v.txt] \
        [--hparams "a=1,b=[2,3]"] \
        [--run_dir runs/x] [--iters N] [--resume [ckpt]] [--warm_start ckpt] \
        [--live_config f.py] [--device cuda|cpu] [--seed S] \
        [--dist_backend nccl|gloo]

Training, on the card unless ``--device cpu`` is given (without a card the
default raises); validation on held-out data, checkpoints and full resume in
``--run_dir``. ``--hparams`` uses the reference's ``k=v,k2=[..]`` grammar
(config.parse_override_string).

Data parallel across processes, one per card (parallel/):

    torchrun --nproc_per_node N -m cookietts_tpu_torch train ...

(across hosts add ``--nnodes``, ``--node_rank`` and ``--master_addr`` /
``--master_port``, with ``--run_dir`` on a shared file system). Each rank
loads its rows of every global batch of ``batch_size`` rows (which must
divide by the ranks), the step's losses, BatchNorm statistics and draws are
the global batch's, the gradients are summed over the ranks, and rank 0
alone reads the live config and writes checkpoints and logs: N ranks train
what one process trains on the same batches. NCCL on the card, gloo on the
CPU; ``--dist_backend gloo`` lets ranks share a card. ``tacotron2``,
``hifigan``, ``gan_postnet``, ``hifigan_denoiser`` and ``gantts`` take a
world above 1; ``untts`` and ``waveglow`` refuse one, as JAX's have no dp
(``waveglow`` takes one with ``--tp``, as JAX's tp mesh has dp = W / N).

- ``tacotron2``: TBPTT batches from the filelist through a background
  prefetcher; keys of Tacotron2Config, DataConfig and the live config
  apply, and ``batch_size``, ``n_iters`` and ``log_every``.
- ``hifigan`` and ``waveglow`` (WaveFlow with
  ``channel_mixing=permuteheight``): random segments of the wavs of a map
  file (``wav|gta_mel|speaker`` lines; the mel may be empty) through
  Mel2Samp; keys of Mel2SampConfig and HiFiGANConfig / WaveGlowConfig
  apply, and ``batch_size``, ``n_iters``, ``lr``, ``grad_clip``,
  ``optimizer`` (waveglow: adam or lamb), ``validation_interval``,
  ``checkpoint_interval``, ``loss_explosion_threshold``,
  ``max_val_batches`` and ``log_every``. Batch i
  draws its segments' files from ``numpy.random.default_rng(i)``, so a
  resumed run goes on with the data sequence.
- ``gan_postnet``: the adversarial postnet on a GTA map (the ``gta``
  command's), speaker codes from ``tacotron2_checkpoint=`` (or
  ``--warm_start``); keys of GANPostnetConfig and the audio front end apply,
  and ``postnet_segment_frames``, ``mel_weight`` and the cadence keys above.
- ``hifigan_denoiser``: the staged denoiser on a list of clean wavs
  (``noise_dir=`` for real noise); ``stage=2`` with ``--resume`` of a stage-0
  run promotes it (fresh critics); keys of HiFiGANDenoiserConfig and
  DenoiserDataConfig apply.
- ``untts`` and ``gantts``: the non-autoregressive TTS models on a TTS
  filelist, with per-char durations from each audio file's ``.dur.npy``,
  ``.gdur.npy`` (the ``gta`` command's) or TextGrid sidecar, else spread
  evenly; UnTTS also takes DIO f0 (``f0_method``) and energy. Batch i draws
  its files from ``numpy.random.default_rng(i)``; keys of UnTTSConfig /
  GANTTSConfig and DataConfig apply, and the cadence keys above; UnTTS
  takes ``--warm_start`` with ``ignore_layers``, GAN-TTS ``mel_weight`` and
  ``d_lr_scale``.

Stage 3 of the pipeline, GTA mels for the vocoders and the postnet:

    python -m cookietts_tpu_torch gta --checkpoint taco.pt --filelist f.txt \
        [-o gta_out] [--batch_size 8] [--extremeGTA N] [--hparams "..."] \
        [--device cuda|cpu]

Serving, on the card unless ``--device cpu`` is given:

    python -m cookietts_tpu_torch tts --checkpoint taco.pt --text "Hi." \
        [--vocoder voc.pt [--vocoder_model hifigan|waveglow] [--denoiser]] \
        [--torchmoji pytorch_model.bin --torchmoji_vocab vocabulary.json] \
        [--arpa_dict merged.dict] [--speaker_info speaker_info.txt] \
        [-c t2s_config.json] [--hparams "..."] [-o out.wav] [--speaker S] \
        [--target_score x] [--max_attempts n] [--denoise_strength x] \
        [--cat_silence_s x] [--seed n]
    python -m cookietts_tpu_torch server --checkpoint taco.pt [...] [--port P]

The checkpoints are the port's own (``torch.save`` trees with a
``state_dict`` and the JSON sidecar the train command writes). Without
``--vocoder``, ``tts`` writes the mel as ``.npy``.

Serving artifacts (runtime/export_serving.py): ``export`` bakes the
checkpoints into ``torch.export`` programs at fixed buckets, and ``tts`` /
``server`` serve them with ``--artifact`` in place of ``--checkpoint``, with
no model code on the serving side; an explicit ``--vocoder`` overrides the
artifact's vocoder:

    python -m cookietts_tpu_torch export --checkpoint taco.pt \
        [--vocoder voc.pt [--vocoder_model hifigan|waveglow]] [-o serving.npz] \
        [--batch B] [--text_buckets 64 128] [--mel_buckets 256 512] \
        [--max_decoder_steps N] [--hparams "..."] [--device cuda|cpu]
    python -m cookietts_tpu_torch tts --artifact serving.npz --text "Hi." [...]

Reference CookieTTS checkpoints become the port's (convert/reference.py):

    python -m cookietts_tpu_torch convert --model tacotron2|waveglow|hifigan|\
        torchmoji|gst|emotionnet|auxemotionnet --torch_ckpt X.pt|X.npz -o Y

Tensor parallelism, ``--tp N`` under torchrun for ``tacotron2`` and
``waveglow`` (WaveFlow too): the world of W ranks is dp x tp, dp = W / N;
each tp group shards the decoder cells' gate matrices by hidden unit and
the encoder convs by channel (Tacotron2), or the WNs' gated layers and
their cond projection by channel pair with the res/skip layers
row-parallel (WaveGlow), and trains what one process trains
(parallel/tp.py). Rank 0 writes the full checkpoint, which loads in one
process and resumes at any N. Other models refuse ``--tp`` above 1, and a
world that N does not divide refuses; ``--sp`` above 1 (sequence
parallelism) refuses: it comes with the next slice of the parallel
runtime.

    torchrun --nproc_per_node 2 -m cookietts_tpu_torch train --tp 2 ...
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

TRAINERS = ("tacotron2", "waveglow", "hifigan", "untts", "gantts",
            "hifigan_denoiser", "gan_postnet")
# the trainers that take a world above 1 (JAX's dp mesh trainers)
DP_TRAINERS = ("tacotron2", "hifigan", "gan_postnet", "hifigan_denoiser",
               "gantts")
# the trainers that take --tp above 1 (JAX wires tp for these two)
TP_TRAINERS = ("tacotron2", "waveglow")
# the trainers that take --sp above 1 (JAX wires sp for the flow vocoders)
SP_TRAINERS = ("waveglow",)
# --hparams keys that reach the live config, with their types
LIVE_OVERRIDES = (("validation_interval", int), ("checkpoint_interval", int),
                  ("LossExplosionThreshold", float),
                  ("grad_clip_thresh", float), ("drop_frame_rate", float),
                  ("p_teacher_forcing", float), ("teacher_force_till", int),
                  ("curation_enable", bool), ("curation_min_att_score", float),
                  ("curation_min_avg_max_attention", float),
                  ("validate_at_start", bool))


def _speaker_map(args, entries):
    """{speaker_name: id} for checkpoint metadata: from --speaker_info when
    given, else synthesized from the filelist's integer ids."""
    if getattr(args, "speaker_info", None):
        from .data.filelist import load_speaker_info
        return load_speaker_info(args.speaker_info)
    return {f"speaker{int(e['speaker_id'])}": int(e["speaker_id"])
            for e in entries}


def _heldout_split(args, entries, load_val=None):
    """(train_entries, val_entries, desc): ``--val_filelist``; else a
    sibling ``filelist_validation.txt`` next to ``--filelist``; else the
    tail of the training filelist; a filelist under 4 entries validates on
    its training data, loudly. ``load_val`` reads a validation file (the
    TTS filelist reader by default)."""
    if load_val is None:
        from .data.filelist import load_filelist as load_val
    vf = getattr(args, "val_filelist", None)
    if vf:
        val = load_val(vf)
        if not val:
            raise SystemExit(f"--val_filelist {vf} is empty")
        return entries, val, f"--val_filelist {vf} ({len(val)} entries)"
    base = getattr(args, "filelist", None)
    if base:
        sib = os.path.join(os.path.dirname(os.path.abspath(base)),
                           "filelist_validation.txt")
        if (os.path.exists(sib)
                and os.path.abspath(sib) != os.path.abspath(base)):
            try:
                val = load_val(sib)
            except Exception as e:           # wrong format for this trainer
                print(f"[val] ignoring sibling {sib}: {e}")
                val = None
            if val:
                return entries, val, f"sibling {sib} ({len(val)} entries)"
    n = len(entries)
    if n >= 4:
        n_val = max(1, n // 10)
        return (entries[:-n_val], entries[-n_val:],
                f"held-out tail ({n_val} of {n} entries)")
    print("[val] WARNING: no --val_filelist, no sibling "
          "filelist_validation.txt, and the filelist is too small to "
          "hold out a tail — validating ON TRAINING DATA")
    return entries, list(entries), "training data (smoke run)"


def _cycle_chunks(n: int, batch_size: int, cap: int = 0):
    """Index chunks covering [0, n) in fixed-size batches; the last chunk
    cycle-fills from the head so every batch has ONE shape."""
    chunks = []
    for j in range(0, n, batch_size):
        chunks.append([(j + k) % n for k in range(batch_size)])
        if cap and len(chunks) >= cap:
            unused = n - cap * batch_size
            if unused > 0:
                print(f"[val] capped at {cap} batches; "
                      f"{unused} validation entries unused")
            break
    return chunks


class ValBatches:
    """Fixed-shape validation batches, collated on demand in each pass (at
    most one batch in memory; features ride the disk cache). Every batch is
    padded to ``pad`` = (text, mel) widths of the whole validation set.
    Under a group each rank collates only its rows of every batch
    (``dp``)."""

    def __init__(self, vds, dcfg, chunks, pad, dp=None):
        self.vds, self.dcfg, self.chunks, self.pad = vds, dcfg, chunks, pad
        self.dp = dp

    def __len__(self):
        return len(self.chunks)

    def __iter__(self):
        from .data.dataset import collate
        for chunk in self.chunks:
            if self.dp is not None:
                chunk = chunk[self.dp.rows(len(chunk))]
            yield collate([self.vds[i] for i in chunk], self.dcfg,
                          pad_to=self.pad)


def _tts_val_batches(val_entries, dcfg, features, batch_size, overrides,
                     desc, dp=None) -> ValBatches:
    """The whole validation set in fixed-shape batches (the last one
    cycle-fills from the head), padded to the set's text and mel buckets;
    this rank's rows of each under ``dp``."""
    from .data.dataset import TTSDataset, bucket_size
    vds = TTSDataset(val_entries, dcfg, features=features)
    m_req = max(vds.mel_frame_lengths())
    t_req = max(vds.text_length(i) for i in range(len(vds)))
    t_pad = bucket_size(t_req, dcfg.text_buckets)
    if t_pad < t_req:
        t_pad = -(-t_req // 32) * 32
    m_pad = bucket_size(m_req, dcfg.mel_buckets)
    if m_pad < m_req:
        m_pad = -(-m_req // 64) * 64
    chunks = _cycle_chunks(len(vds), batch_size,
                           int(overrides.get("max_val_batches", 0) or 0))
    print(f"[val] {desc}: {len(vds)} entries streamed in {len(chunks)} "
          f"batch(es) of {batch_size} at text={t_pad} mel={m_pad}")
    return ValBatches(vds, dcfg, chunks, (t_pad, m_pad), dp)


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def _dataclass_kwargs(cls, mapping):
    """The keys of ``mapping`` that are fields of the dataclass ``cls``,
    lists (a JSON sidecar's) as tuples."""
    valid = set(cls.__dataclass_fields__)
    return {k: _tuples(v) for k, v in mapping.items() if k in valid}


def _tacotron2_config(overrides):
    """Tacotron2Config from the overrides' model keys (n_symbols from the
    text frontend)."""
    from .models.tacotron2 import Tacotron2Config
    from .text import N_SYMBOLS
    return Tacotron2Config(**{"n_symbols": N_SYMBOLS,
                              **_dataclass_kwargs(Tacotron2Config, overrides)})


def _build_tacotron2(overrides, device, seed: int):
    """Tacotron2Config from the overrides and the model on ``device``,
    initialised from ``seed`` without touching the caller's global RNG
    state."""
    import torch
    from .models.tacotron2 import Tacotron2
    cfg = _tacotron2_config(overrides)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = Tacotron2(cfg, device="cpu")
    return model.to(device), cfg


def cmd_download(args):
    from .pipeline.download import run_downloads
    run_downloads(args.config)


def cmd_preprocess(args):
    """Preprocess; the device is resolved first (raises without a card
    unless ``--device cpu``). Returns the filelist result."""
    from .config import load_json_config
    from .device import resolve_device
    from .pipeline.preprocess import PreprocessConfig, run_preprocess
    device = resolve_device(args.device)
    conf = load_json_config(args.config) if args.config else {}
    return run_preprocess(PreprocessConfig(**conf), device=device)


def cmd_train(args):
    """Train; returns the Trainer. Under torchrun's environment the rank
    joins the group first (parallel.initialize) and trains its rows."""
    from .parallel import initialize, process_count, rank_device
    from .parallel.mesh import mesh_dp
    sp = int(getattr(args, "sp", 1) or 1)
    if sp > 1 and args.model not in SP_TRAINERS:
        # never drop a parallelism request silently (JAX's message)
        raise SystemExit(
            "--sp (vocoder time-axis sequence parallelism) is only wired "
            "for --model waveglow/waveflow; remove the flag or use that "
            "trainer")
    tp = int(getattr(args, "tp", 1) or 1)
    if tp > 1 and args.model not in TP_TRAINERS:
        raise SystemExit(
            f"--tp {tp} (tensor parallelism) shards --model tacotron2 and "
            f"--model waveglow (WaveFlow too), as JAX does; --model "
            f"{args.model} trains with --tp 1")
    if initialize(args.device, getattr(args, "dist_backend", None)):
        if (process_count() > 1 and args.model not in DP_TRAINERS
                and not (tp > 1 and args.model in TP_TRAINERS)
                and not (sp > 1 and args.model in SP_TRAINERS)):
            raise SystemExit(
                f"--model {args.model} trains in one process only (JAX's "
                f"trainer has no data parallelism); run it without torchrun "
                f"(this run has {process_count()} ranks)")
        args.device = str(rank_device(args.device))
    mesh_dp(process_count(), tp, sp)  # one process too, before any loading
    trainer = OTHER_TRAINERS.get(args.model, _train_tacotron2)(args)
    if process_count() > 1:
        # each rank's kernel launches, training and validation (the
        # counters are per process)
        import json
        from .ops import hopper_kernels as hk
        from .parallel import process_index
        print(json.dumps({"rank": process_index(),
                          "kernel_launches": dict(hk.LAUNCHES)}))
    return trainer


def _mesh(batch_size: int, tp: int = 1, sp: int = 1):
    """(DataParallel, TensorParallel, SequenceParallel) of the group as dp x
    tp x sp, dp = world / (``tp`` ``sp``) (None, None, None in one process;
    TensorParallel None at tp 1, SequenceParallel None at sp 1), once the
    global ``batch_size`` is known to divide by the dp ranks. The
    DataParallel's group is the replica group (dp x sp ranks)."""
    import torch.distributed as dist
    from .parallel import make_mesh
    if not dist.is_initialized():
        return None, None, None
    dp, tpg, spg = make_mesh(tp, sp)
    rows = dp.row_count
    if batch_size % rows:
        raise SystemExit(f"batch_size={batch_size} must divide evenly over "
                         f"the {rows} ranks (each rank trains batch_size / "
                         f"{rows} rows of every global batch)")
    if dp.primary:
        print(f"[train] data parallel: {rows} ranks, "
              f"{batch_size // rows} rows of each global batch of "
              f"{batch_size} per rank"
              + (f"; tensor parallel over {tp} ranks" if tp > 1 else "")
              + (f"; sequence parallel over {spg.size} ranks, each a "
                 "run of the time axis" if spg is not None else ""))
    return dp, tpg, spg


def _data_parallel(batch_size: int):
    """The group's DataParallel (None in one process)."""
    return _mesh(batch_size)[0]


def _shard(model, rules, tp, dp):
    """``model`` sharded over ``tp`` by ``rules`` (parallel/tp.py), its
    sharded tensors listed by rank 0."""
    from .parallel import describe, shard_model
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    layout = shard_model(model, rules, tp)
    if dp.primary:
        print(f"[train] tp={tp.size} sharded:\n"
              + describe(layout.placements, shapes, tp.size))


def _train_tacotron2(args):
    import numpy as np
    import torch

    from .config import parse_override_string
    from .data.dataset import (DataConfig, TBPTTSampler, TTSDataset, collate,
                               collate_local_shard)
    from .data.filelist import load_filelist
    from .data.prefetch import Prefetcher
    from .device import resolve_device
    from .runtime.checkpoint import load_checkpoint, warm_start
    from .runtime.optim import adam
    from .runtime.train_state import TrainState
    from .runtime.trainer import (
        Trainer, TrainerConfig, make_tacotron2_eval_step,
        make_tacotron2_inference_eval_step, make_tacotron2_train_step)

    overrides = parse_override_string(args.hparams) if args.hparams else {}
    device = resolve_device(args.device)
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)
        print("[train] detect_anomaly: autograd anomaly mode on (slow)")
    batch_size = int(overrides.get("batch_size", 8))
    n_iters = int(overrides.get("n_iters", args.iters))
    dp, tp, _ = _mesh(batch_size, int(getattr(args, "tp", 1) or 1))
    primary = dp is None or dp.primary

    entries = load_filelist(args.filelist)
    dcfg = DataConfig(**{k: v for k, v in overrides.items()
                         if k in set(DataConfig.__dataclass_fields__)})
    features = ["text", "mel", "speaker_id", "sylps", "gate"]
    if overrides.get("use_emotionnet"):
        # the filelist's emotion ids reach EmotionNet and sup_em_nll
        # (n_emotion_classes is a key of both configs)
        features.append("emotion_id")
    entries, val_entries, val_desc = _heldout_split(args, entries)
    dataset = TTSDataset(entries, dcfg, features=features)
    model, mcfg = _build_tacotron2(overrides, device, args.seed)

    # drop-frame's global mean: a first-batch estimate until drop-frame is
    # on, then the dataset-wide mean (persisted next to the filelist)
    first = collate([dataset[i % len(dataset)] for i in range(batch_size)],
                    dcfg)
    m = np.asarray(first["mels"], np.float32)
    valid = (np.arange(m.shape[1])[None, :]
             < np.asarray(first["mel_lengths"])[:, None])
    gm = {"mean": ((m * valid[:, :, None]).sum((0, 1))
                   / max(valid.sum(), 1)).astype(np.float32), "full": False}
    mean_sidecar = (os.path.abspath(args.filelist)
                    + f".{dataset._cfg_hash()}.mean.npy")

    def global_mean_now(live):
        if not gm["full"] and float(live.get("drop_frame_rate", 0.0)) > 0:
            t0 = time.time()
            # one rank computes it (and writes the sidecar), every rank
            # takes its value
            mean = dataset.global_mel_mean(mean_sidecar) if primary else None
            gm["mean"] = mean if dp is None else dp.replicate_global(mean)
            gm["full"] = True
            print(f"[dfr] dataset-wide global mel mean over {len(dataset)} "
                  f"entries in {time.time() - t0:.1f}s")
        return gm["mean"]

    if args.warm_start:
        tree, _ = load_checkpoint(args.warm_start)
        ig = tuple(overrides.get("ignore_layers", ()) or ())
        sd, n_l, n_s = warm_start(model.state_dict(), tree["state_dict"],
                                  ignore_layers=ig)
        model.load_state_dict(sd)
        print(f"warm start: {n_l} loaded, {n_s} skipped"
              + (f" (ignore_layers={list(ig)})" if ig else ""))
    if tp is not None:
        from .parallel import TACOTRON2_TP_RULES
        _shard(model, TACOTRON2_TP_RULES, tp, dp)

    state = TrainState.create(model, adam())
    val_batches = _tts_val_batches(val_entries, dcfg, features, batch_size,
                                   overrides, val_desc, dp)
    trainer = Trainer(
        TrainerConfig(run_dir=args.run_dir, live_config_path=args.live_config,
                      seed=args.seed,
                      log_every=int(overrides.get("log_every", 10)),
                      async_save=bool(overrides.get("async_save", False))),
        state, make_tacotron2_train_step(model, dp=dp),
        make_tacotron2_eval_step(model, dp=dp), val_batches=val_batches,
        inference_eval_step=make_tacotron2_inference_eval_step(model, dp=dp),
        device=device, dp=dp)
    for k, cast in LIVE_OVERRIDES:
        if k in overrides:
            trainer.live.values[k] = cast(overrides[k])
    trainer.default_metadata = {
        "model": "tacotron2",
        "model_config": {k: v for k, v in overrides.items()
                         if k in set(type(mcfg).__dataclass_fields__)},
        "speaker_ids": _speaker_map(args, entries),
        "audio": {"sampling_rate": dcfg.sampling_rate,
                  "hop_length": dcfg.hop_length,
                  "n_mel_channels": dcfg.n_mel_channels},
    }
    if args.resume:
        trainer.resume(None if args.resume == "auto" else args.resume)

    it = int(trainer.state.step)
    epoch = 0
    entries_cur = list(entries)
    while it < n_iters:
        dataset.epoch = epoch          # re-randomizes the ARPA decisions
        sampler = TBPTTSampler(dataset.mel_frame_lengths(), batch_size,
                               dcfg.max_segment_frames, seed=epoch)

        def load(segs):
            if dp is not None:     # this rank's rows, at the global widths
                return collate_local_shard(dataset, segs, dcfg, dp.rank,
                                           dp.size)
            return collate([dataset[s.file_idx] for s in segs], dcfg,
                           segments=segs)

        for batch in Prefetcher(load, sampler, depth=2):
            batch["global_mean"] = global_mean_now(trainer.live)
            metrics = trainer.step(batch)
            if it % 10 == 0 and primary:
                print(f"iter {it}: "
                      f"loss={metrics.get('loss', float('nan')):.4f}")
            it += 1
            if it >= n_iters:
                break
        epoch += 1
        if dp is not None:
            # every rank scored its own rows: curate from every rank's
            # statistics, so every rank rebuilds the same dataset
            _merge_file_losses(trainer)
        # epoch-boundary curation: drop weak-attention files, resample by
        # MSE, rebuild the sampler
        if (trainer.live.get("curation_enable", True)
                and trainer.file_db.db and it < n_iters):
            from .data.curation import (filter_by_attention_quality,
                                        mse_weighted_resample)
            cur = filter_by_attention_quality(
                entries_cur, trainer.file_db.db,
                min_att_score=float(
                    trainer.live.get("curation_min_att_score", 0.5)),
                min_avg_max_attention=float(
                    trainer.live.get("curation_min_avg_max_attention", 0.45)))
            cur = mse_weighted_resample(
                cur, trainer.file_db.db,
                exp_factor=float(trainer.live.get("curation_mse_exponent",
                                                  1.0)),
                seed=epoch)
            if len(cur) >= batch_size:
                entries_cur = cur
                dataset = TTSDataset(entries_cur, dcfg, features=features)
                print(f"[curation] epoch {epoch}: dataset rebuilt with "
                      f"{len(entries_cur)} entries")
    trainer.save(periodic=True)
    trainer.ckpt.wait()        # the last save on disk before reporting done
    if dp is not None:
        _merge_file_losses(trainer)
    if primary:
        trainer.file_db.to_csv(os.path.join(args.run_dir, "file_losses.csv"))
    print(f"done: {it} iters, checkpoints in {args.run_dir}")
    return trainer


def _merge_file_losses(trainer) -> None:
    """Every rank's per-file losses on every rank: for each file the entry
    last updated (a rank holds a merged copy of the files it did not
    score)."""
    from .parallel import allgather_object
    merged = {}
    for db in allgather_object(trainer.file_db.db):
        for path, entry in db.items():
            if entry.get("time", 0.0) >= merged.get(path, {}).get("time", -1.0):
                merged[path] = entry
    trainer.file_db.db = dict(sorted(merged.items()))


# -- the vocoder trainers ------------------------------------------------------

def _build_seeded(seed: int, device, build):
    """``build()`` on the CPU under the global RNG seeded ``seed`` (the
    caller's RNG state untouched), then moved to ``device``."""
    import torch
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build()
    return model.to(device)


def _vocoder_data(args, overrides):
    """(Mel2SampConfig, train dataset, validation items, description) from
    the map file and the held-out split."""
    from .data.mel2samp import Mel2Samp, Mel2SampConfig, load_map_file
    dcfg = Mel2SampConfig(**{k: v for k, v in overrides.items()
                             if k in set(Mel2SampConfig.__dataclass_fields__)})
    entries = load_map_file(args.filelist)
    train_entries, val_map, desc = _heldout_split(args, entries, load_map_file)
    val = Mel2Samp(val_map, dcfg)
    return dcfg, Mel2Samp(train_entries, dcfg), [val[i] for i in
                                                 range(len(val))], desc


def _vocoder_batches(dataset, val_items, batch_size, overrides, desc, keys):
    """(make_batch(it), val_batches): batch ``it`` draws its files from
    ``numpy.random.default_rng(it)``; the validation items, materialised
    once, in batches at the training shape (the last cycle-filled)."""
    import numpy as np
    from .data.mel2samp import collate_mel2samp

    def pick(batch):
        return {k: batch[k] for k in keys}

    def make_batch(it):
        rng = np.random.default_rng(it)
        idx = rng.integers(0, len(dataset), batch_size)
        return pick(collate_mel2samp([dataset[int(i)] for i in idx]))

    cap = int(overrides.get("max_val_batches", 0) or 0)
    val_batches = [pick(collate_mel2samp([val_items[i] for i in chunk]))
                   for chunk in _cycle_chunks(len(val_items), batch_size, cap)]
    print(f"[val] {desc}: {len(val_items)} segments in {len(val_batches)} "
          f"batch(es)")
    return make_batch, val_batches


def _make_trainer(args, overrides, state, train_step, device, eval_step=None,
                  val_batches=None, plateau=None, base_lr=1e-4,
                  grad_clip=150.0, validation_interval=200, dp=None):
    """The Trainer of a vocoder: a constant live LR (``lr``), the validation
    and checkpoint cadence and the explosion threshold from the overrides,
    all under the live file (``--live_config``)."""
    from .runtime.trainer import Trainer, TrainerConfig
    trainer = Trainer(
        TrainerConfig(run_dir=args.run_dir, live_config_path=args.live_config,
                      seed=args.seed,
                      log_every=int(overrides.get("log_every", 10)),
                      grad_clip=float(overrides.get("grad_clip", grad_clip)),
                      plateau=plateau,
                      async_save=bool(overrides.get("async_save", False))),
        state, train_step, eval_step, val_batches=val_batches, device=device,
        dp=dp)
    trainer.set_live_defaults({
        "A_": float(overrides.get("lr", base_lr)),
        "warmup_end": 0, "decay_start": 10 ** 12, "drop_frame_rate": 0.0,
        "validation_interval": int(overrides.get("validation_interval",
                                                 validation_interval)),
        "checkpoint_interval": int(overrides.get("checkpoint_interval", 0)),
        "LossExplosionThreshold": float(
            overrides.get("loss_explosion_threshold", 1e3)),
        "validate_at_start": bool(overrides.get("validate_at_start", False)),
    })
    return trainer


def _trainer_loop(trainer, make_batch, n_iters, run_dir, resume=None,
                  loss_name="loss"):
    """Run ``trainer`` to ``n_iters`` (after a full --resume) and save a
    final periodic checkpoint. Returns the trainer."""
    if resume:
        path = trainer.ckpt.latest() if resume == "auto" else resume
        if path is None or not os.path.exists(path):
            raise SystemExit(f"--resume: no checkpoint in {run_dir}")
        if trainer.resume(path) >= n_iters:
            raise SystemExit(f"--resume: checkpoint already at iter "
                             f"{trainer.state.step} >= --iters {n_iters}; "
                             "nothing to do")
    it = int(trainer.state.step)
    while it < n_iters:
        metrics = trainer.step(make_batch(it))
        if it % 10 == 0 and trainer.dp.primary:
            print(f"iter {it}: {loss_name}="
                  f"{metrics.get('loss', float('nan')):.4f}")
        it_next = int(trainer.state.step)
        it = it_next if it_next > it else it + 1     # an explosion rolls back
    trainer.save(periodic=True)
    trainer.ckpt.wait()        # the last save on disk before reporting done
    print(f"done: checkpoints in {run_dir}")
    return trainer


def _vocoder_metadata(name, dcfg, overrides, model_keys, base):
    """The metadata stamped on a vocoder's checkpoints: the model's kind,
    ``base`` and the model's keys among the overrides, the audio front end."""
    return {
        "model": name,
        "model_config": {**base, **{k: v for k, v in overrides.items()
                                    if k in model_keys and k not in base}},
        "audio": {"sampling_rate": dcfg.sampling_rate,
                  "hop_length": dcfg.hop_length,
                  "n_mel_channels": dcfg.n_mel_channels},
    }


def _train_waveglow(args):
    """WaveGlow / WaveFlow training (cookietts_tpu/cli.py:_train_waveglow):
    the flow NLL with Adam or LAMB, validation through the inverse (STFT
    MSE / MAE) driving ReduceLROnPlateau and best_val_model."""
    from .config import parse_override_string
    from .device import resolve_device
    from .models.waveglow import WaveGlow, WaveGlowConfig
    from .runtime.optim import ReduceLROnPlateau, adam, lamb
    from .runtime.train_state import TrainState
    from .runtime.trainer import (make_waveglow_train_step,
                                  make_waveglow_val_step)

    device = resolve_device(args.device)
    overrides = parse_override_string(args.hparams) if args.hparams else {}
    batch_size = int(overrides.get("batch_size", 4))
    n_iters = int(overrides.get("n_iters", args.iters))
    dcfg, dataset, val_items, desc = _vocoder_data(args, overrides)
    m_keys = set(WaveGlowConfig.__dataclass_fields__)
    wcfg = WaveGlowConfig(
        n_mel_channels=dcfg.n_mel_channels, hop_length=dcfg.hop_length,
        **{k: tuple(v) if isinstance(v, list) else v
           for k, v in overrides.items()
           if k in m_keys and k not in ("n_mel_channels", "hop_length")})
    sp_n = int(getattr(args, "sp", 1) or 1)
    if sp_n > 1 and dcfg.segment_length % (sp_n * dcfg.hop_length):
        raise SystemExit(
            f"--sp {sp_n}: segment_length={dcfg.segment_length} must split "
            f"into {sp_n} runs of whole hops of {dcfg.hop_length} samples "
            f"(a multiple of sp * hop_length = {sp_n * dcfg.hop_length})")
    dp, tp, sp = _mesh(batch_size, int(getattr(args, "tp", 1) or 1), sp_n)
    if tp is not None and (wcfg.cond_layers > 1 or wcfg.cond_residual):
        raise SystemExit(
            f"--tp {tp.size}: the sharded WN covers one cond projection "
            f"without a residual; cond_layers={wcfg.cond_layers}, "
            f"cond_residual={wcfg.cond_residual} train with --tp 1")
    build = lambda: WaveGlow(wcfg, device="cpu")  # noqa: E731
    model = _build_seeded(args.seed, device, build)
    replica = None
    if tp is not None:
        from .parallel import WAVEGLOW_TP_RULES
        _shard(model, WAVEGLOW_TP_RULES, tp, dp)
        # validation runs the inverse's kernels on the gathered weights
        replica = _build_seeded(args.seed, device, build)
    keys = ("audio", "mels") + (("speaker_id",) if wcfg.n_speakers else ())
    make_batch, val_batches = _vocoder_batches(dataset, val_items, batch_size,
                                               overrides, desc, keys)
    if dp is not None:         # this rank's rows of every global batch
        rates = {"audio": 1, "mels": dcfg.hop_length}

        def local(batch):       # and, under sp, its run of the time axis
            batch = dp.shard_batch(batch)
            return batch if sp is None else sp.shard_batch(batch, rates)

        global_batch = make_batch
        make_batch = lambda it: local(global_batch(it))  # noqa: E731
        val_batches = [local(b) for b in val_batches]
    tx = lamb() if str(overrides.get("optimizer", "adam")) == "lamb" else adam()
    val_step = make_waveglow_val_step(model, dp=dp, replica=replica, sp=sp)

    def eval_step(state, batch, generator, ctrl):
        m = val_step(state, batch, generator)
        return ({"loss": m["val_MSE"], "MSE": m["val_MSE"],
                 "MAE": m["val_MAE"]}, {}, None)

    trainer = _make_trainer(args, overrides, TrainState.create(model, tx),
                            make_waveglow_train_step(model, dp=dp, sp=sp),
                            device,
                            eval_step=eval_step, val_batches=val_batches,
                            plateau=ReduceLROnPlateau(), grad_clip=150.0,
                            dp=dp)
    trainer.default_metadata = _vocoder_metadata(
        "waveglow", dcfg, overrides, m_keys,
        {"n_mel_channels": dcfg.n_mel_channels, "hop_length": dcfg.hop_length})
    return _trainer_loop(trainer, make_batch, n_iters, args.run_dir,
                         resume=args.resume, loss_name="nll")


def _train_hifigan(args):
    """HiFi-GAN adversarial training (cookietts_tpu/cli.py:_train_hifigan):
    AdamW (weight decay 0.01) on both sides, a discriminator then a
    generator step each iteration, validation by the generated audio's mel
    L1; checkpoints hold G and D."""
    import numpy as np
    from torch import nn

    from .audio.stft import TacotronSTFT
    from .config import parse_override_string
    from .device import resolve_device
    from .models.hifigan import (Generator, HiFiGANConfig,
                                 MultiPeriodDiscriminator,
                                 MultiScaleDiscriminator)
    from .runtime.checkpoint import load_checkpoint, warm_start
    from .runtime.optim import adam
    from .runtime.train_state import GANTrainState, TrainState
    from .runtime.trainer import (make_hifigan_eval_step,
                                  make_hifigan_train_steps)

    device = resolve_device(args.device)
    overrides = parse_override_string(args.hparams) if args.hparams else {}
    batch_size = int(overrides.get("batch_size", 4))
    dp = _data_parallel(batch_size)
    dcfg, dataset, val_items, desc = _vocoder_data(args, overrides)
    h_keys = set(HiFiGANConfig.__dataclass_fields__)
    hcfg = HiFiGANConfig(
        n_mel_channels=dcfg.n_mel_channels,
        **{k: tuple(v) if isinstance(v, list) else v
           for k, v in overrides.items()
           if k in h_keys and k != "n_mel_channels"})
    up_prod = int(np.prod(hcfg.upsample_rates))
    if up_prod != dcfg.hop_length:
        raise SystemExit(f"prod(upsample_rates)={up_prod} must equal "
                         f"hop_length={dcfg.hop_length}")
    gen = _build_seeded(args.seed, device, lambda: Generator(
        hcfg, device="cpu", weight_norm=True))
    disc = _build_seeded(args.seed + 1, device, lambda: nn.ModuleDict({
        "mpd": MultiPeriodDiscriminator(hcfg, device="cpu"),
        "msd": MultiScaleDiscriminator(hcfg, device="cpu")}))
    if args.warm_start:
        tree, _ = load_checkpoint(args.warm_start)
        ig = tuple(overrides.get("ignore_layers", ()) or ())
        sd, n_l, n_s = warm_start(gen.state_dict(), tree["state_dict"],
                                  ignore_layers=ig)
        gen.load_state_dict(sd)
        print(f"[hifigan] warm start: {n_l} loaded, {n_s} skipped"
              + (f" (ignore_layers={list(ig)})" if ig else ""))
    stft = TacotronSTFT(dcfg.filter_length, dcfg.hop_length, dcfg.win_length,
                        dcfg.n_mel_channels, dcfg.sampling_rate,
                        dcfg.mel_fmin, dcfg.mel_fmax, device=device)
    d_step, g_step = make_hifigan_train_steps(
        gen, disc["mpd"], disc["msd"], stft.mel_spectrogram, dp=dp)
    make_batch, val_batches = _vocoder_batches(
        dataset, val_items, batch_size, overrides, desc, ("audio", "mels"))
    state = GANTrainState(g=TrainState.create(gen, adam(weight_decay=0.01)),
                          d=TrainState.create(disc, adam(weight_decay=0.01)))
    return _gan_trainer(
        args, overrides, state, d_step, g_step, device,
        make_hifigan_eval_step(gen, stft.mel_spectrogram, dp), val_batches,
        "hifigan", base_lr=2e-4, grad_clip=1000.0, batches=make_batch, dp=dp,
        metadata=_vocoder_metadata("hifigan", dcfg, overrides, h_keys, {
            "n_mel_channels": dcfg.n_mel_channels}))


def _gan_trainer(args, overrides, state, d_step, g_step, device, eval_step,
                 val_batches, name, base_lr, grad_clip, batches, prepare=None,
                 metadata=None, loss_key="g_loss", d_lr_scale=1.0, dp=None):
    """The Trainer of an adversarial model over ``state`` (a GANTrainState)
    with its metadata, run on ``batches(it)`` to ``--iters`` (after a full
    --resume); D's LR is the live LR times ``d_lr_scale``. Under ``dp``
    every rank makes each global batch as one process does and keeps its
    rows (of the validation batches too). Returns the trainer."""
    from .runtime.trainer import make_gan_trainer_step
    if dp is not None:
        make_batch = batches
        batches = lambda it: dp.shard_batch(make_batch(it))  # noqa: E731
        if isinstance(val_batches, ValBatches):
            val_batches.dp = dp
        else:
            val_batches = [dp.shard_batch(b) for b in val_batches]
    trainer = _make_trainer(
        args, overrides, state,
        make_gan_trainer_step(d_step, g_step, loss_key, d_lr_scale=d_lr_scale,
                              prepare=prepare, dp=dp),
        device,
        eval_step=eval_step, val_batches=val_batches, base_lr=base_lr,
        grad_clip=grad_clip, dp=dp)
    trainer.default_metadata = {"model": name, **(metadata or {})}
    if args.resume:
        print(f"[{name}] resuming G+D from "
              f"{trainer.ckpt.latest() if args.resume == 'auto' else args.resume}")
    return _trainer_loop(trainer, batches,
                         int(overrides.get("n_iters", args.iters)),
                         args.run_dir, resume=args.resume, loss_name=loss_key)


def _train_gan_postnet(args):
    """Adversarial mel-refinement postnet training from a GTA map
    (cookietts_tpu/cli.py:_train_gan_postnet): the postnet pulls the
    teacher-forced decoder mels toward the ground truth while fooling a
    speaker-conditioned fakeness discriminator.

    ``--filelist`` is a ``wav|mel|speaker`` GTA map; decoder mels come from
    the ``.mel*.npy`` files, ground-truth mels from the audio through the
    port's TacotronSTFT. Speaker codes are the ``speaker_embedding.weight``
    table of the Tacotron2 checkpoint that made the map
    (``tacotron2_checkpoint=<path>`` or ``--warm_start``), else seeded
    per-speaker codes (smoke training only). Batch i crops
    ``postnet_segment_frames`` at random from files drawn by
    ``numpy.random.default_rng(i)``; validation crops at frame 0."""
    import numpy as np

    from .audio.stft import TacotronSTFT
    from .config import parse_override_string
    from .data.audio_io import load_wav
    from .data.mel2samp import load_map_file
    from .device import resolve_device
    from .models.gan_postnet import (GANDiscriminator, GANPostnet,
                                     GANPostnetConfig)
    from .runtime.checkpoint import load_checkpoint
    from .runtime.optim import adam
    from .runtime.train_state import GANTrainState, TrainState
    from .runtime.trainer import (gan_postnet_noise, make_gan_postnet_eval_step,
                                  make_gan_postnet_train_steps)

    device = resolve_device(args.device)
    overrides = parse_override_string(args.hparams) if args.hparams else {}
    batch_size = int(overrides.get("batch_size", 8))
    dp = _data_parallel(batch_size)
    seg = int(overrides.get("postnet_segment_frames", 64))
    sr = int(overrides.get("sampling_rate", 44100))
    stft = TacotronSTFT(
        filter_length=int(overrides.get("filter_length", 2048)),
        hop_length=int(overrides.get("hop_length", 512)),
        win_length=int(overrides.get("win_length", 2048)),
        n_mel_channels=int(overrides.get("n_mel_channels", 80)),
        sampling_rate=sr, mel_fmax=float(overrides.get("mel_fmax", 11025.0)),
        device="cpu")

    # the learned speaker table of the Tacotron2 checkpoint behind the map
    embed_table = None
    t2_ckpt = overrides.get("tacotron2_checkpoint") or args.warm_start
    if t2_ckpt:
        tree, _ = load_checkpoint(str(t2_ckpt))
        table = tree.get("state_dict", {}).get("speaker_embedding.weight")
        if table is None:
            raise SystemExit(f"{t2_ckpt} has no speaker_embedding table; pass "
                             "a Tacotron2 checkpoint of the port")
        embed_table = table.float().numpy()
        overrides = dict(overrides,
                         speaker_embedding_dim=int(embed_table.shape[1]))
        print(f"[gan_postnet] speaker embeddings from {t2_ckpt}: "
              f"{embed_table.shape[0]} speakers x {embed_table.shape[1]}")

    def load_map(path):
        return [(w, m, s) for w, m, s, _ in load_map_file(path)
                if m is not None]

    entries = load_map(args.filelist)
    if not entries:
        raise SystemExit("map file has no mel sidecars; run gta first")
    entries, val_entries, val_desc = _heldout_split(args, entries, load_map)

    pcfg = GANPostnetConfig(n_mel_channels=stft.n_mel_channels, **{
        k: v for k, v in _dataclass_kwargs(GANPostnetConfig, overrides).items()
        if k != "n_mel_channels"})
    post = _build_seeded(args.seed, device, lambda: GANPostnet(pcfg, "cpu"))
    disc = _build_seeded(args.seed + 1, device,
                         lambda: GANDiscriminator(pcfg, "cpu"))

    def speaker_code(sid: int) -> np.ndarray:
        if embed_table is not None:
            if not 0 <= sid < embed_table.shape[0]:
                raise SystemExit(
                    f"map file speaker id {sid} out of range for the "
                    f"checkpoint's {embed_table.shape[0]}-speaker embedding "
                    "table: mismatched map/checkpoint pair")
            return embed_table[sid]
        return np.random.default_rng(1000 + sid).standard_normal(
            pcfg.speaker_embedding_dim).astype(np.float32)

    def item(entry, rng=None):
        """(decoder mel segment, ground-truth mel segment, speaker code);
        with no ``rng`` (validation) the crop starts at frame 0."""
        wav_path, mel_path, sid = entry
        dmel = np.load(mel_path).astype(np.float32)            # [T, M]
        audio, _ = load_wav(wav_path, target_sr=sr)
        gmel = stft.mel_spectrogram_np(audio).astype(np.float32)
        n = min(dmel.shape[0], gmel.shape[0])
        if n >= seg:
            s = int(rng.integers(0, n - seg + 1)) if rng is not None else 0
            d, g = dmel[s:s + seg], gmel[s:s + seg]
        else:
            pad = ((0, seg - n), (0, 0))
            d, g = np.pad(dmel[:n], pad), np.pad(gmel[:n], pad)
        return d, g, speaker_code(sid)

    def stack(items):
        dec, gt, spk = zip(*items)
        return {"decoder_mel": np.stack(dec), "gt_mel": np.stack(gt),
                "speaker_embed": np.stack(spk)}

    def make_batch(it):
        rng = np.random.default_rng(it)
        return stack([item(entries[int(i)], rng)
                      for i in rng.integers(0, len(entries), batch_size)])

    cap = int(overrides.get("max_val_batches", 0) or 0)
    val_batches = [stack([item(val_entries[i]) for i in chunk])
                   for chunk in _cycle_chunks(len(val_entries), batch_size, cap)]
    print(f"[val] {val_desc}: {len(val_entries)} rows in {len(val_batches)} "
          f"batch(es)")
    d_step, g_step = make_gan_postnet_train_steps(
        post, disc, mel_weight=float(overrides.get("mel_weight", 1.0)), dp=dp)
    state = GANTrainState(g=TrainState.create(post, adam()),
                          d=TrainState.create(disc, adam()))
    return _gan_trainer(
        args, overrides, state, d_step, g_step, device,
        make_gan_postnet_eval_step(post, dp), val_batches, "gan_postnet",
        base_lr=2e-4, grad_clip=10.0, batches=make_batch, dp=dp,
        prepare=gan_postnet_noise(pcfg.noise_dim),
        metadata={"model_config": dataclasses.asdict(pcfg)})


def _train_hifigan_denoiser(args):
    """Staged HiFi-GAN denoiser training
    (cookietts_tpu/cli.py:_train_hifigan_denoiser): stage < 2 trains the WN
    generator on the multi-res spectral L1 plus the audio L1 over synthetic
    noisy/clean pairs; stage >= 2 adds the wave and spectrogram critics
    (built only then: ``--resume`` of a stage-0 checkpoint at ``stage=2``
    resumes the generator and starts fresh critics). ``--filelist`` lists
    CLEAN wavs (a pipe-separated filelist's first field); ``noise_dir=``
    mixes in every ``*.wav`` below it. Batch i draws its files from
    ``numpy.random.default_rng(i)``; validation, spectral only at every
    stage, scores noisy mixes made once."""
    import glob as globlib

    import numpy as np
    import torch
    from torch import nn

    from .config import parse_override_string
    from .data.denoiser_data import (DenoiserDataConfig, DenoiserDataset,
                                     collate_denoiser)
    from .device import resolve_device
    from .models.hifigan_denoiser import (DenoiserWN, HiFiGANDenoiserConfig,
                                          MultiResSpect, SpectDiscriminator,
                                          WaveDiscriminator)
    from .runtime.optim import adam
    from .runtime.train_state import GANTrainState, TrainState
    from .runtime.trainer import (make_hifigan_denoiser_eval_step,
                                  make_hifigan_denoiser_train_steps)

    device = resolve_device(args.device)
    overrides = parse_override_string(args.hparams) if args.hparams else {}
    batch_size = int(overrides.get("batch_size", 4))
    dp = _data_parallel(batch_size)
    stage = int(overrides.get("stage", 0))

    def load_clean(path):
        with open(path) as f:
            return [ln.split("|")[0].strip() for ln in f
                    if ln.strip() and not ln.startswith("#")]

    clean_files, val_files, val_desc = _heldout_split(
        args, load_clean(args.filelist), load_clean)
    noise_files = []
    if overrides.get("noise_dir"):
        noise_files = sorted(globlib.glob(os.path.join(
            str(overrides["noise_dir"]), "**", "*.wav"), recursive=True))
    dcfg = DenoiserDataConfig(**_dataclass_kwargs(DenoiserDataConfig,
                                                  overrides))
    dataset = DenoiserDataset(clean_files, dcfg, noise_files=noise_files)
    mcfg = HiFiGANDenoiserConfig(stage=stage, **{
        k: v for k, v in _dataclass_kwargs(HiFiGANDenoiserConfig,
                                           overrides).items() if k != "stage"})
    gen = _build_seeded(args.seed, device, lambda: DenoiserWN(mcfg, "cpu"))
    mrs = MultiResSpect(mcfg.window_lengths, mcfg.hop_lengths, device=device)
    # the critics exist only once the adversarial stage turns on
    dw = ds = None
    critics = nn.ModuleDict()
    if stage >= 2:
        dw = _build_seeded(args.seed + 1, device,
                           lambda: WaveDiscriminator(mcfg, "cpu"))
        ds = _build_seeded(args.seed + 2, device,
                           lambda: SpectDiscriminator(mcfg, "cpu"))
        critics.update({"dw": dw, "ds": ds})
        frames = mrs(torch.zeros(1, dcfg.segment_length, device=device)).shape[2]
        if frames < ds.min_frames():
            raise SystemExit(
                f"segment_length={dcfg.segment_length} gives DS {frames} "
                f"spectrogram frames; it takes at least {ds.min_frames()}")

    def make_batch(it):
        rng = np.random.default_rng(it)
        return collate_denoiser([dataset[int(i)] for i in
                                 rng.integers(0, len(dataset), batch_size)])

    # noisy mixes of the held-out clean wavs, made once: every validation
    # scores the same pairs
    val_dataset = DenoiserDataset(val_files, dcfg, noise_files=noise_files)
    cap = int(overrides.get("max_val_batches", 0) or 0)
    val_batches = [collate_denoiser([val_dataset[int(i)] for i in chunk])
                   for chunk in _cycle_chunks(len(val_dataset), batch_size, cap)]
    print(f"[val] {val_desc}: {len(val_dataset)} wavs in {len(val_batches)} "
          f"batch(es)")
    d_step, g_step = make_hifigan_denoiser_train_steps(gen, dw, ds, mrs,
                                                       stage=stage, dp=dp)
    state = GANTrainState(g=TrainState.create(gen, adam()),
                          d=TrainState.create(critics, adam()))
    return _gan_trainer(
        args, overrides, state, d_step, g_step, device,
        make_hifigan_denoiser_eval_step(gen, mrs, stage, dp), val_batches,
        "hifigan_denoiser", base_lr=2e-4, grad_clip=100.0, batches=make_batch,
        dp=dp,
        metadata={"stage": stage, "model_config": dataclasses.asdict(mcfg),
                  "audio": {"sampling_rate": dcfg.sampling_rate}},
        loss_key="loss")


# -- the non-autoregressive TTS trainers ------------------------------------------

# the batch keys the NAR trainers read
UNTTS_KEYS = ("text", "text_lengths", "mels", "mel_lengths", "speaker_id",
              "durations", "f0", "energy", "frame_f0", "frame_energy",
              "frame_voiced")
GANTTS_KEYS = UNTTS_KEYS[:6]


def _nar_data(args, overrides, features, keys):
    """(DataConfig, train entries, make_batch(it), validation batches) of a
    NAR trainer: batch ``it`` collates files drawn from
    ``numpy.random.default_rng(it)``, validation streams the held-out set."""
    import numpy as np

    from .data.dataset import DataConfig, TTSDataset, collate
    from .data.filelist import load_filelist
    dcfg = DataConfig(**_dataclass_kwargs(DataConfig, overrides))
    batch_size = int(overrides.get("batch_size", 8))
    entries, val_entries, val_desc = _heldout_split(
        args, load_filelist(args.filelist))
    dataset = TTSDataset(entries, dcfg, features=features)

    def make_batch(it):
        idx = np.random.default_rng(it).integers(0, len(dataset), batch_size)
        b = collate([dataset[int(i)] for i in idx], dcfg)
        return {k: b[k] for k in keys if k in b}

    val_batches = _tts_val_batches(val_entries, dcfg, features, batch_size,
                                   overrides, val_desc)
    return dcfg, entries, make_batch, val_batches


def _nar_config(cls, dcfg, overrides):
    """The model's config from the overrides (n_symbols from the text front
    end, n_mel_channels from the data config)."""
    from .text import N_SYMBOLS
    return cls(n_symbols=N_SYMBOLS, n_mel_channels=dcfg.n_mel_channels, **{
        k: v for k, v in _dataclass_kwargs(cls, overrides).items()
        if k not in ("n_symbols", "n_mel_channels", "dtype")})


def _nar_metadata(name, cfg, dcfg, speakers):
    return {"model": name,
            "model_config": {k: v for k, v in dataclasses.asdict(cfg).items()
                             if k != "dtype"},
            "speaker_ids": speakers,
            "audio": {"sampling_rate": dcfg.sampling_rate,
                      "hop_length": dcfg.hop_length,
                      "n_mel_channels": dcfg.n_mel_channels}}


def _train_untts(args):
    """UnTTS training (cookietts_tpu/cli.py:_train_untts): the decoder flow
    NLL and the predictors' MSEs (and VarGlow's NLL with ``use_varglow``)
    with Adam, clipping at 10; validation by the same loss without dropout
    on the held-out set."""
    from .config import parse_override_string
    from .device import resolve_device
    from .models.untts import UnTTS, UnTTSConfig
    from .runtime.checkpoint import load_checkpoint, warm_start
    from .runtime.optim import adam
    from .runtime.train_state import TrainState
    from .runtime.trainer import make_untts_eval_step, make_untts_train_step

    device = resolve_device(args.device)
    overrides = parse_override_string(args.hparams) if args.hparams else {}
    dcfg, entries, make_batch, val_batches = _nar_data(
        args, overrides,
        ("text", "mel", "speaker_id", "f0", "energy", "durations"), UNTTS_KEYS)
    ucfg = _nar_config(UnTTSConfig, dcfg, overrides)
    model = _build_seeded(args.seed, device, lambda: UnTTS(ucfg, device="cpu"))
    if args.warm_start:
        tree, _ = load_checkpoint(args.warm_start)
        ig = tuple(overrides.get("ignore_layers", ()) or ())
        sd, n_l, n_s = warm_start(model.state_dict(), tree["state_dict"],
                                  ignore_layers=ig)
        model.load_state_dict(sd)
        print(f"[untts] warm start: {n_l} loaded, {n_s} skipped"
              + (f" (ignore_layers={list(ig)})" if ig else ""))
    trainer = _make_trainer(args, overrides, TrainState.create(model, adam()),
                            make_untts_train_step(model), device,
                            eval_step=make_untts_eval_step(model),
                            val_batches=val_batches, grad_clip=10.0)
    trainer.default_metadata = _nar_metadata("untts", ucfg, dcfg,
                                             _speaker_map(args, entries))
    return _trainer_loop(trainer, make_batch,
                         int(overrides.get("n_iters", args.iters)),
                         args.run_dir, resume=args.resume)


def _train_gantts(args):
    """GAN-TTS adversarial training (cookietts_tpu/cli.py:_train_gantts): a
    discriminator then a generator step each iteration (BCE on the window
    logits, the generator's plus ``mel_weight`` times the masked mel L1),
    Adam both sides, D's LR scaled by ``d_lr_scale``; validation by the
    generator's mel L1 over the whole held-out set. Each iteration's z,
    window starts and dropout masks come from the trainer's generator;
    checkpoints hold G and D."""
    from .config import parse_override_string
    from .device import resolve_device
    from .models.gantts import (GANTTSConfig, GANTTSDiscriminator,
                                GANTTSGenerator)
    from .runtime.optim import adam
    from .runtime.train_state import GANTrainState, TrainState
    from .runtime.trainer import (gantts_draws, make_gantts_eval_step,
                                  make_gantts_train_steps)

    device = resolve_device(args.device)
    overrides = parse_override_string(args.hparams) if args.hparams else {}
    dp = _data_parallel(int(overrides.get("batch_size", 8)))
    dcfg, entries, make_batch, val_batches = _nar_data(
        args, overrides, ("text", "mel", "speaker_id", "durations"),
        GANTTS_KEYS)
    gcfg = _nar_config(GANTTSConfig, dcfg, overrides)
    gen = _build_seeded(args.seed, device,
                        lambda: GANTTSGenerator(gcfg, device="cpu"))
    disc = _build_seeded(args.seed + 1, device,
                         lambda: GANTTSDiscriminator(gcfg, device="cpu"))
    d_step, g_step = make_gantts_train_steps(
        gen, disc, mel_weight=float(overrides.get("mel_weight", 1.0)), dp=dp)
    state = GANTrainState(g=TrainState.create(gen, adam()),
                          d=TrainState.create(disc, adam()))
    return _gan_trainer(
        args, overrides, state, d_step, g_step, device,
        make_gantts_eval_step(gen, dp), val_batches, "gantts", base_lr=1e-4,
        grad_clip=10.0, batches=make_batch, dp=dp,
        prepare=gantts_draws(gcfg.z_dim, gcfg.d_windows),
        metadata=_nar_metadata("gantts", gcfg, dcfg,
                               _speaker_map(args, entries)),
        d_lr_scale=float(overrides.get("d_lr_scale", 1.0)))


OTHER_TRAINERS = {"waveglow": _train_waveglow, "hifigan": _train_hifigan,
                  "gan_postnet": _train_gan_postnet,
                  "hifigan_denoiser": _train_hifigan_denoiser,
                  "untts": _train_untts, "gantts": _train_gantts}


# -- serving: tts and server ---------------------------------------------------

def _vocoder_model(path, overrides, vocoder_model=None, device="cuda"):
    """(kind, model, audio_info) from a port vocoder checkpoint: HiFi-GAN or
    WaveGlow/WaveFlow from the sidecar's ``model``, else from the state
    dict's layout. A HiFi-GAN checkpoint's weight-norm pairs are folded on
    load."""
    import numpy as np
    from .runtime.checkpoint import load_checkpoint

    tree, meta = load_checkpoint(path)
    meta = meta or {}
    sd = tree["state_dict"]
    kind = vocoder_model or meta.get("model")
    if not kind:
        roots = {k.split(".")[0] for k in sd}
        kind = ("hifigan" if "conv_pre" in roots
                else "waveglow" if "WN" in roots else None)
        if kind is None:
            raise SystemExit(f"cannot detect the vocoder type of {path}; "
                             "pass --vocoder_model")
    if kind not in ("hifigan", "waveglow"):
        raise SystemExit(f"{path} holds a {kind} model, not a vocoder")
    mc = {**meta.get("model_config", {}), **overrides}
    audio_info = dict(meta.get("audio", {}))

    if kind == "hifigan":
        from .models.hifigan import Generator, HiFiGANConfig
        kw = _dataclass_kwargs(HiFiGANConfig, mc)
        if "upsample_kernel_sizes" in kw and "upsample_rates" not in kw:
            # the reference configs use rate = kernel // 2 throughout
            kw["upsample_rates"] = tuple(k // 2 for k in kw["upsample_kernel_sizes"])
        cfg = HiFiGANConfig(**kw)
        gen = Generator(cfg, device="cpu")
        gen.load_state_dict(sd)
        gen.to(device)
        audio_info.setdefault("hop_length", int(np.prod(cfg.upsample_rates)))
        audio_info.setdefault("n_mel_channels", cfg.n_mel_channels)
        return kind, gen, audio_info

    from .models.waveglow import WaveGlow, WaveGlowConfig
    cfg = WaveGlowConfig(**_dataclass_kwargs(WaveGlowConfig, mc))
    model = WaveGlow(cfg, device="cpu")
    model.load_state_dict(sd)
    model.to(device)
    audio_info.setdefault("hop_length", cfg.hop_length)
    audio_info.setdefault("sampling_rate", cfg.sampling_rate)
    audio_info.setdefault("n_mel_channels", cfg.n_mel_channels)
    return kind, model, audio_info


def _load_vocoder(path, overrides, vocoder_model=None, device="cuda"):
    """(vocoder_fn, infer_with_generator, audio_info) from a port vocoder
    checkpoint (cookietts_tpu/cli.py:_load_vocoder). A flow vocoder draws
    each call's z from a generator seeded from a counter and is marked
    ``stochastic`` (make_flow_vocoder_fn)."""
    kind, model, audio_info = _vocoder_model(path, overrides, vocoder_model,
                                             device)
    if kind == "hifigan":
        return model, lambda mel, generator: model(mel, infer=True), audio_info
    from .pipeline.text2speech import make_flow_vocoder_fn
    vocoder_fn, infer = make_flow_vocoder_fn(
        model, sigma=float(overrides.get("sigma", model.cfg.sigma)))
    return vocoder_fn, infer, audio_info


def _load_tacotron2(path, overrides, device):
    """(model on ``device``, sidecar meta) from a port Tacotron2 checkpoint;
    the sidecar's model config under the overrides."""
    from .models.tacotron2 import Tacotron2
    from .runtime.checkpoint import load_checkpoint
    tree, meta = load_checkpoint(path)
    meta = meta or {}
    model = Tacotron2(_tacotron2_config({**meta.get("model_config", {}),
                                         **overrides}), device="cpu")
    model.load_state_dict(tree["state_dict"])
    return model.to(device), meta


def _build_t2s(args):
    """A serving T2S worker from the port's checkpoints or an exported
    artifact, and the flags (cookietts_tpu/cli.py:_build_t2s). With
    ``--checkpoint`` its sidecar gives the model config, the speaker map and
    the audio front end; with ``--artifact`` its meta does, its buckets fix
    the batch, and its vocoder serves unless ``--vocoder`` gives a live one.
    The vocoder, denoiser, ARPAbet dictionary and torchMoji are optional. On
    ``args.device``, the card unless ``--device cpu``."""
    import json

    import torch

    from .config import parse_override_string
    from .device import resolve_device
    from .pipeline.text2speech import T2S, T2SConfig

    if not (args.checkpoint or args.artifact):
        raise SystemExit("pass --checkpoint (a Tacotron2 checkpoint) or "
                         "--artifact (an exported serving artifact)")
    device = resolve_device(args.device)
    overrides = parse_override_string(args.hparams) if args.hparams else {}
    cfg_kw = {}
    if args.config:
        with open(args.config) as f:
            cfg_kw = _dataclass_kwargs(T2SConfig, json.load(f))
    cfg_kw.update(_dataclass_kwargs(T2SConfig, overrides))

    model = artifact = None
    if args.artifact:
        # exported programs only: no model classes, checkpoints or
        # converters for the decode
        from .runtime.export_serving import ArtifactT2SDecoder
        artifact = ArtifactT2SDecoder(args.artifact, device)
        cfg_kw["batch_size"] = artifact.batch
        cfg_kw.setdefault("max_text_len", artifact.text_buckets[-1])
        speaker_ids = artifact.speaker_ids
        audio_info = dict(artifact.audio)
    else:
        model, meta = _load_tacotron2(args.checkpoint, overrides, device)
        speaker_ids = meta.get("speaker_ids") or {"default": 0}
        audio_info = dict(meta.get("audio", {}))
    if args.speaker_info:
        from .data.filelist import load_speaker_info
        speaker_ids = load_speaker_info(args.speaker_info)

    vocoder_fn = denoiser_fn = None
    if args.vocoder:
        # an explicit live vocoder overrides (or supplies) the artifact's
        vocoder_fn, infer, v_audio = _load_vocoder(
            args.vocoder, overrides, args.vocoder_model, device)
        audio_info.update(v_audio)
        if args.denoiser:
            from .models.denoiser import Denoiser
            denoiser_fn = Denoiser(
                infer, sampling_rate=int(audio_info.get("sampling_rate", 44100)),
                n_mel_channels=int(audio_info.get("n_mel_channels", 80)),
                device=device)
    elif args.denoiser:
        raise SystemExit(
            "--denoiser needs a live --vocoder checkpoint" + (
                " (the artifact's exported vocoder cannot expose the "
                "generator-driven bias-extraction call)" if artifact else ""))
    elif artifact is not None and artifact.has_vocoder:
        vocoder_fn = artifact.make_vocoder_fn()

    arpa_fn = None
    if args.arpa_dict:
        from .text.cmudict import ARPADict
        arpa_fn = ARPADict(args.arpa_dict).get

    torchmoji_fn = None
    if args.torchmoji:
        from .models.torchmoji import TorchMojiEncoder, load_vocabulary
        if not args.torchmoji_vocab:
            raise SystemExit("--torchmoji needs --torchmoji_vocab")
        # the published pytorch_model.bin (a state dict) or a port checkpoint
        tm = torch.load(args.torchmoji, map_location="cpu", weights_only=True)
        torchmoji_fn = TorchMojiEncoder(load_vocabulary(args.torchmoji_vocab),
                                        tm.get("state_dict", tm), device=device)

    sr = int(overrides.get("sampling_rate", audio_info.get("sampling_rate", 44100)))
    hop = int(overrides.get("hop_length", audio_info.get("hop_length", 512)))
    return T2S(T2SConfig(**cfg_kw), model, speaker_ids, vocoder_fn=vocoder_fn,
               denoiser_fn=denoiser_fn, torchmoji_fn=torchmoji_fn,
               arpa_fn=arpa_fn, sample_rate=sr, hop_length=hop, device=device,
               decode_fn=None if artifact is None else artifact.decode,
               torchmoji_dim=None if artifact is None else artifact.torchmoji_dim)


def cmd_tts(args):
    """One-shot synthesis: text -> a WAV, or the mel as .npy without a
    vocoder; prints the hand-written kernels' launch counts (none on the
    CPU) on one line, then the stats JSON line (cookietts_tpu/cli.py:cmd_tts)."""
    import json

    import numpy as np

    from .device import full_float32
    from .ops import hopper_kernels as hk

    t2s = _build_t2s(args)
    hk.reset_launch_counts()
    with full_float32():
        res = t2s.infer(args.text, speaker=args.speaker or (),
                        use_arpabet=bool(args.arpa_dict),
                        target_score=args.target_score,
                        max_attempts=args.max_attempts,
                        denoise_strength=args.denoise_strength,
                        cat_silence_s=args.cat_silence_s, seed=args.seed)
    print(json.dumps({"kernel_launches": dict(hk.LAUNCHES)}))
    stats = {k: (float(v) if isinstance(v, (int, float, np.floating)) else None)
             for k, v in res.items()
             if k in ("audio_seconds", "gen_time", "total_time", "xrt",
                      "failure_rate")}
    stats["segments"] = len(res["segments"])
    stats["scores"] = [round(float(s), 4) for s in res["scores"]]
    if res["audio"].size:
        from .data.audio_io import save_wav
        save_wav(args.out, res["audio"], t2s.sample_rate)
        stats["out"] = args.out
    else:
        out = args.out.rsplit(".", 1)[0] + ".mel.npy"
        np.save(out, res["mels"][0] if len(res["mels"]) == 1
                else np.asarray(res["mels"], dtype=object))
        stats["out"] = out
        stats["note"] = "no --vocoder: wrote mel instead of audio"
    print(json.dumps(stats))
    return stats


def cmd_server(args):
    """The HTTP server (pipeline/server.py) over one worker from
    ``_build_t2s``."""
    from .device import full_float32
    from .pipeline.server import serve
    t2s = _build_t2s(args)
    with full_float32():
        serve(t2s, port=args.port)


def cmd_export(args):
    """Export serving programs (cookietts_tpu/cli.py:cmd_export): the
    Tacotron2 checkpoint's encode, decode step and postnet at each (batch,
    text) bucket and the vocoder at each (batch, mel frames) bucket, as
    ``torch.export`` programs with the weights baked in, on ``--device``;
    one ``.npz`` (runtime/export_serving.py). Prints one JSON line: the
    artifact, its functions and their bytes."""
    import json

    import torch

    from .config import compute_dtype, parse_override_string, refuse_bf16
    from .device import resolve_device
    from .runtime.export_serving import (export_tacotron2_serving,
                                         export_vocoder_serving,
                                         save_artifact, tacotron2_meta)

    device = resolve_device(args.device)
    overrides = parse_override_string(args.hparams) if args.hparams else {}
    if "dtype" in overrides:
        refuse_bf16(compute_dtype(overrides["dtype"]), "export",
                    "bf16 export and artifacts")
    entries, meta = {}, {"device": device.type, "torch": torch.__version__}
    steps = args.max_decoder_steps or None
    if args.checkpoint:
        model, ck_meta = _load_tacotron2(args.checkpoint, overrides, device)
        buckets = [(int(args.batch), int(t)) for t in args.text_buckets]
        entries.update(export_tacotron2_serving(model, buckets, steps))
        meta["t2s"] = tacotron2_meta(model, buckets, steps,
                                     speaker_ids=ck_meta.get("speaker_ids"),
                                     audio=ck_meta.get("audio", {}))
    if args.vocoder:
        kind, voc, v_audio = _vocoder_model(args.vocoder, overrides,
                                            args.vocoder_model, device)
        n_mel = int(overrides.get("n_mel_channels", v_audio["n_mel_channels"]))
        vb = [(int(args.batch), int(t)) for t in args.mel_buckets]
        voc_meta = {"buckets": [list(b) for b in vb], "n_mel_channels": n_mel,
                    "audio": v_audio, "needs_key": kind == "waveglow"}
        if kind == "hifigan":
            entries.update(export_vocoder_serving(
                lambda mel: voc(mel, infer=True), n_mel, vb, device=device))
        else:
            cfg = voc.cfg

            def z_shape(B, T):
                n = T * cfg.hop_length // cfg.n_group
                return (B, cfg.n_group, n) if voc.waveflow else (B, n, cfg.n_group)

            entries.update(export_vocoder_serving(
                lambda mel, z: voc.infer(mel, z=z), n_mel, vb, needs_key=True,
                z_shape=z_shape, device=device))
            voc_meta.update(sigma=float(overrides.get("sigma", cfg.sigma)),
                            z_shapes={f"b{b}_t{t}": list(z_shape(b, t))
                                      for b, t in vb})
        meta["vocoder"] = voc_meta
    if not entries:
        raise SystemExit("export: pass --checkpoint and/or --vocoder")
    save_artifact(args.out, entries, meta)
    out = {"out": args.out, "functions": sorted(entries),
           "bytes": sum(len(v) for v in entries.values()),
           "device": device.type}
    print(json.dumps(out))
    return out


def cmd_gta(args):
    """Teacher-forced GTA mels of a port Tacotron2 checkpoint over a filelist
    (cookietts_tpu/cli.py:cmd_gta): ``<audio>.mel.npy`` and
    ``<audio>.gdur.npy`` beside each file and ``map_train_0.txt`` in
    ``--outdir``; ``--extremeGTA N`` again from the audio offset by each
    multiple of N below the hop (``.mel{offset}.npy``). Batches of
    ``--batch_size`` in filelist order (the last one short), padded to the
    data config's buckets. Prints the map's path, then one JSON line: the
    utterances, the decoder steps, the audio seconds, the generation's
    seconds (model loading left out), the part of them spent loading and
    collating the data, each batch's seconds (the data, the forward and
    the files; a card's first batch pays its cold start), and the kernels'
    launches (none on the CPU)."""
    import json

    import torch

    from .config import parse_override_string
    from .data.dataset import DataConfig, TTSDataset, collate
    from .data.filelist import load_filelist
    from .device import resolve_device
    from .ops import hopper_kernels as hk
    from .pipeline.gta import (GTAGenerator, extreme_gta_offsets,
                               offset_item_mels)

    device = resolve_device(args.device)
    overrides = parse_override_string(args.hparams) if args.hparams else {}
    dcfg = DataConfig(**_dataclass_kwargs(DataConfig, overrides))
    dataset = TTSDataset(load_filelist(args.filelist), dcfg)
    model, _ = _load_tacotron2(args.checkpoint, overrides, device)
    gen = GTAGenerator(model, args.outdir)
    offsets = (extreme_gta_offsets(dcfg.hop_length, args.extreme_gta)
               if args.extreme_gta else [0])
    hk.reset_launch_counts()
    t0 = time.perf_counter()
    lines, frames, B, data_s, batch_s = [], 0, args.batch_size, 0.0, []
    for offset in offsets:
        for i0 in range(0, len(dataset), B):
            t_data = time.perf_counter()
            items = [dataset[i] for i in range(i0, min(i0 + B, len(dataset)))]
            # extremeGTA: the mels again from the offset audio, so every
            # offset is a shifted teacher-forcing target
            batch = collate(offset_item_mels(dataset, items, offset), dcfg)
            data_s += time.perf_counter() - t_data
            frames += int(batch["mel_lengths"].sum())
            lines += gen.process_batch(batch, batch.pop("audiopath"),
                                       offset=offset)
            batch_s.append(time.perf_counter() - t_data)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    print(gen.write_map(lines))
    stats = {"utterances": len(lines), "decoder_steps": gen.decoder_steps,
             "audio_seconds": frames * dcfg.hop_length / dcfg.sampling_rate,
             "seconds": seconds, "data_seconds": data_s,
             "batch_seconds": batch_s,
             "kernel_launches": dict(hk.LAUNCHES)}
    print(json.dumps(stats))
    return stats


def cmd_convert(args):
    """A reference torch checkpoint -> a port checkpoint with its sidecar
    (cookietts_tpu/cli.py:cmd_convert)."""
    from .convert.reference import convert_checkpoint
    meta = convert_checkpoint(args.model, args.torch_ckpt, args.output)
    print(f"converted {args.model} -> {args.output} (sidecar {meta})")
    return meta


def _add_t2s_args(sp):
    sp.add_argument("--artifact", default=None,
                    help="a serving artifact from the export command (in "
                         "place of --checkpoint: no model code needed)")
    sp.add_argument("--checkpoint", default=None,
                    help="Tacotron2 checkpoint of the port (its JSON sidecar "
                         "gives the model config, speakers and audio)")
    sp.add_argument("-c", "--config", default=None,
                    help="t2s_config.json (T2SConfig keys)")
    sp.add_argument("--vocoder", default=None,
                    help="HiFi-GAN, WaveGlow or WaveFlow checkpoint of the port")
    sp.add_argument("--vocoder_model", default=None,
                    choices=("hifigan", "waveglow"),
                    help="override the vocoder's detection")
    sp.add_argument("--denoiser", action="store_true",
                    help="vocoder-bias removal (denoise_strength per request)")
    sp.add_argument("--arpa_dict", default=None,
                    help="merged.dict for {ARPA} substitution")
    sp.add_argument("--torchmoji", default=None,
                    help="torchMoji weights: pytorch_model.bin or a port "
                         "checkpoint")
    sp.add_argument("--torchmoji_vocab", default=None,
                    help="vocabulary.json for --torchmoji")
    sp.add_argument("--speaker_info", default=None,
                    help="speaker_info.txt overriding the checkpoint's "
                         "speaker map")
    sp.add_argument("--hparams", default="",
                    help='overrides of T2SConfig and the model configs, e.g. '
                         '"batch_size=8,gate_threshold=0.6"')
    sp.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("cookietts_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("download", help="fetch the datasets of a config")
    d.add_argument("-c", "--config", required=True)
    d.set_defaults(fn=cmd_download)

    pr = sub.add_parser("preprocess", help="wavs to filelists, with the "
                        "feature frontend on the device")
    pr.add_argument("-c", "--config", default=None,
                    help="JSON of PreprocessConfig's keys")
    pr.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    pr.set_defaults(fn=cmd_preprocess)

    t = sub.add_parser("train")
    t.add_argument("--model", default="tacotron2", choices=TRAINERS)
    t.add_argument("--filelist", required=True)
    t.add_argument("--val_filelist", default=None,
                   help="held-out validation filelist (default: a sibling "
                        "filelist_validation.txt, else the filelist's tail)")
    t.add_argument("--warm_start", default=None)
    t.add_argument("--resume", nargs="?", const="auto", default=None,
                   help="full resume (model, optimizer, step) from a "
                        "checkpoint path, or the latest in --run_dir when bare")
    t.add_argument("--live_config", default=None)
    t.add_argument("--iters", type=int, default=1000)
    t.add_argument("--speaker_info", default=None,
                   help="speaker_info.txt stamping {name: id} into "
                        "checkpoint metadata")
    t.add_argument("--detect_anomaly", action="store_true",
                   help="autograd anomaly mode: raise at the op that first "
                        "produces a NaN (slow; debugging only)")
    t.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    t.add_argument("--seed", type=int, default=1234,
                   help="seeds the weights and every random draw")
    t.add_argument("--dist_backend", default=None, choices=("nccl", "gloo"),
                   help="the process group's backend under torchrun (default "
                        "nccl on the card, gloo on the CPU; gloo lets ranks "
                        "share a card)")
    t.add_argument("--tp", type=int, default=1,
                   help="tensor parallelism: the ranks of each tp group "
                   "shard the weights (tacotron2, waveglow; the world is dp "
                   "x tp under torchrun)")
    t.add_argument("--sp", type=int, default=1,
                   help="sequence parallelism: the ranks of each sp group "
                   "hold runs of the vocoders' time axis and exchange the "
                   "convolutions' halos (waveglow/waveflow; the world is dp "
                   "x tp x sp under torchrun)")
    t.add_argument("--hparams", default="",
                   help='override string, e.g. "batch_size=32,p_arpabet=0"')
    t.add_argument("--run_dir", default="runs/default")
    t.set_defaults(fn=cmd_train)

    sv = sub.add_parser("server", help="the HTTP TTS server")
    _add_t2s_args(sv)
    sv.add_argument("--port", type=int, default=5000)
    sv.set_defaults(fn=cmd_server)

    tt = sub.add_parser("tts", help="one-shot synthesis: text -> wav")
    _add_t2s_args(tt)
    tt.add_argument("--text", required=True)
    tt.add_argument("-o", "--out", default="tts_out.wav")
    tt.add_argument("--speaker", action="append", default=None,
                    help="speaker name (repeatable; fuzzy-matched)")
    tt.add_argument("--target_score", type=float, default=None)
    tt.add_argument("--max_attempts", type=int, default=None)
    tt.add_argument("--denoise_strength", type=float, default=0.0)
    tt.add_argument("--cat_silence_s", type=float, default=0.0)
    tt.add_argument("--seed", type=int, default=0)
    tt.set_defaults(fn=cmd_tts)

    g = sub.add_parser("gta", help="teacher-forced GTA mels and the "
                       "vocoder map from a Tacotron2 checkpoint")
    g.add_argument("--checkpoint", required=True,
                   help="Tacotron2 checkpoint of the port (its JSON sidecar "
                        "gives the model config)")
    g.add_argument("--filelist", required=True)
    g.add_argument("-o", "--outdir", default="gta_out")
    g.add_argument("--batch_size", type=int, default=8)
    g.add_argument("--extremeGTA", dest="extreme_gta", type=int, default=0,
                   help="also synthesise from the audio offset by each "
                        "multiple of N samples below the hop")
    g.add_argument("--hparams", default="",
                   help="DataConfig and Tacotron2Config overrides")
    g.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    g.set_defaults(fn=cmd_gta)

    ex = sub.add_parser(
        "export", help="export serving programs (torch.export, weights "
                       "baked in, fixed buckets) into one artifact that "
                       "tts/server --artifact serve without model code")
    ex.add_argument("--checkpoint", default=None,
                    help="Tacotron2 checkpoint of the port")
    ex.add_argument("--vocoder", default=None,
                    help="HiFi-GAN, WaveGlow or WaveFlow checkpoint of the port")
    ex.add_argument("--vocoder_model", default=None,
                    choices=("hifigan", "waveglow"))
    ex.add_argument("-o", "--out", default="serving.npz")
    ex.add_argument("--batch", type=int, default=16)
    ex.add_argument("--text_buckets", type=int, nargs="+", default=[64, 128])
    ex.add_argument("--mel_buckets", type=int, nargs="+", default=[256, 512])
    ex.add_argument("--max_decoder_steps", type=int, default=0,
                    help="decoder steps of the artifact (0: the config's)")
    ex.add_argument("--hparams", default="")
    ex.add_argument("--device", default="cuda",
                    help="the device type the programs run on: cuda (the "
                         "default; raises without a card) or cpu")
    ex.set_defaults(fn=cmd_export)

    from .convert.reference import MODELS
    c = sub.add_parser("convert", help="convert a reference torch checkpoint "
                       "into the port's checkpoint format")
    c.add_argument("--model", choices=MODELS, required=True)
    c.add_argument("--torch_ckpt", required=True,
                   help=".pt/.pth (unpickled: trusted files only) or an .npz "
                        "of the state dict")
    c.add_argument("-o", "--output", required=True)
    c.set_defaults(fn=cmd_convert)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)

"""Command-line interface of the port (cookietts_tpu/cli.py:193-486).

    python -m cookietts_tpu_torch train --model tacotron2 --filelist f.txt \
        [--val_filelist v.txt] [--hparams "a=1,b=[2,3]"] [--run_dir runs/x] \
        [--iters N] [--resume [ckpt]] [--warm_start ckpt] [--live_config f.py] \
        [--device cuda|cpu] [--seed S]

Single-process Tacotron2 training: TBPTT batches from the filelist through
a background prefetcher, validation on a held-out filelist, checkpoints and
full resume in ``--run_dir``. The run is on the card unless ``--device cpu``
is given (without a card the default raises). ``--hparams`` uses the
reference's ``k=v,k2=[..]`` grammar (config.parse_override_string); keys of
Tacotron2Config, DataConfig and the live config apply, and ``batch_size``,
``n_iters`` and ``log_every``. The other models' trainers, multi-host runs and ``--tp`` /
``--sp`` are not ported yet.
"""
from __future__ import annotations

import argparse
import os
import time

TRAINERS = ("tacotron2", "waveglow", "hifigan", "untts", "gantts",
            "hifigan_denoiser", "gan_postnet")
# --hparams keys that reach the live config, with their types
LIVE_OVERRIDES = (("validation_interval", int), ("checkpoint_interval", int),
                  ("LossExplosionThreshold", float),
                  ("grad_clip_thresh", float), ("drop_frame_rate", float),
                  ("p_teacher_forcing", float), ("teacher_force_till", int),
                  ("curation_enable", bool), ("curation_min_att_score", float),
                  ("curation_min_avg_max_attention", float))


def _speaker_map(args, entries):
    """{speaker_name: id} for checkpoint metadata: from --speaker_info when
    given, else synthesized from the filelist's integer ids."""
    if getattr(args, "speaker_info", None):
        from .data.filelist import load_speaker_info
        return load_speaker_info(args.speaker_info)
    return {f"speaker{int(e['speaker_id'])}": int(e["speaker_id"])
            for e in entries}


def _heldout_split(args, entries):
    """(train_entries, val_entries, desc): ``--val_filelist``; else a
    sibling ``filelist_validation.txt`` next to ``--filelist``; else the
    tail of the training filelist; a filelist under 4 entries validates on
    its training data, loudly."""
    from .data.filelist import load_filelist
    vf = getattr(args, "val_filelist", None)
    if vf:
        val = load_filelist(vf)
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
                val = load_filelist(sib)
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
    padded to ``pad`` = (text, mel) widths of the whole validation set."""

    def __init__(self, vds, dcfg, chunks, pad):
        self.vds, self.dcfg, self.chunks, self.pad = vds, dcfg, chunks, pad

    def __len__(self):
        return len(self.chunks)

    def __iter__(self):
        from .data.dataset import collate
        for chunk in self.chunks:
            yield collate([self.vds[i] for i in chunk], self.dcfg,
                          pad_to=self.pad)


def _tts_val_batches(val_entries, dcfg, features, batch_size, overrides,
                     desc) -> ValBatches:
    """The whole validation set in fixed-shape batches (the last one
    cycle-fills from the head), padded to the set's text and mel buckets."""
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
    return ValBatches(vds, dcfg, chunks, (t_pad, m_pad))


def _build_tacotron2(overrides, device, seed: int):
    """Tacotron2Config from the overrides (n_symbols from the text
    frontend) and the model on ``device``, initialised from ``seed``
    without touching the caller's global RNG state."""
    import torch
    from .models.tacotron2 import Tacotron2, Tacotron2Config
    from .text import N_SYMBOLS
    valid = set(Tacotron2Config.__dataclass_fields__)
    cfg = Tacotron2Config(**{"n_symbols": N_SYMBOLS,
                             **{k: v for k, v in overrides.items()
                                if k in valid}})
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = Tacotron2(cfg, device="cpu")
    return model.to(device), cfg


def cmd_train(args):
    """Train; returns the Trainer."""
    if args.model != "tacotron2":
        raise SystemExit(f"training CLI for {args.model!r} not wired yet in "
                         "the port; only --model tacotron2")
    import numpy as np
    import torch

    from .config import parse_override_string
    from .data.dataset import DataConfig, TBPTTSampler, TTSDataset, collate
    from .data.filelist import load_filelist
    from .data.prefetch import Prefetcher
    from .device import resolve_device
    from .runtime.checkpoint import load_checkpoint, warm_start
    from .runtime.optim import adam
    from .runtime.train_state import TrainState
    from .runtime.trainer import (
        Trainer, TrainerConfig, make_tacotron2_eval_step,
        make_tacotron2_inference_eval_step, make_tacotron2_train_step)

    device = resolve_device(args.device)
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)
        print("[train] detect_anomaly: autograd anomaly mode on (slow)")
    overrides = parse_override_string(args.hparams) if args.hparams else {}
    batch_size = int(overrides.get("batch_size", 8))
    n_iters = int(overrides.get("n_iters", args.iters))

    entries = load_filelist(args.filelist)
    dcfg = DataConfig(**{k: v for k, v in overrides.items()
                         if k in set(DataConfig.__dataclass_fields__)})
    features = ["text", "mel", "speaker_id", "sylps", "gate"]
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
            gm["mean"], gm["full"] = dataset.global_mel_mean(mean_sidecar), True
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

    state = TrainState.create(model, adam())
    val_batches = _tts_val_batches(val_entries, dcfg, features, batch_size,
                                   overrides, val_desc)
    trainer = Trainer(
        TrainerConfig(run_dir=args.run_dir, live_config_path=args.live_config,
                      seed=args.seed,
                      log_every=int(overrides.get("log_every", 10))),
        state, make_tacotron2_train_step(model),
        make_tacotron2_eval_step(model), val_batches=val_batches,
        inference_eval_step=make_tacotron2_inference_eval_step(model),
        device=device)
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
            return collate([dataset[s.file_idx] for s in segs], dcfg,
                           segments=segs)

        for batch in Prefetcher(load, sampler, depth=2):
            batch["global_mean"] = global_mean_now(trainer.live)
            metrics = trainer.step(batch)
            if it % 10 == 0:
                print(f"iter {it}: "
                      f"loss={metrics.get('loss', float('nan')):.4f}")
            it += 1
            if it >= n_iters:
                break
        epoch += 1
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
    trainer.file_db.to_csv(os.path.join(args.run_dir, "file_losses.csv"))
    print(f"done: {it} iters, checkpoints in {args.run_dir}")
    return trainer


def main(argv=None):
    p = argparse.ArgumentParser("cookietts_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
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
    t.add_argument("--hparams", default="",
                   help='override string, e.g. "batch_size=32,p_arpabet=0"')
    t.add_argument("--run_dir", default="runs/default")
    t.set_defaults(fn=cmd_train)
    args = p.parse_args(argv)
    return args.fn(args)

"""Dataset preprocessing pipeline (cookietts_tpu/pipeline/preprocess.py).

Capability rebuild of CookieTTS/_1_preprocess/start_preprocess.py (the
14-step script) around the port's own DSP (data/audio_io.py, with the C++
kernels of data/native.py) instead of librosa/sox/normalize-audio CLIs:

1. recursively extract archives (start_preprocess.py:42-83)
2. per-file audio processing in a process pool
   (scripts/audio_preprocessing.py:78-204): load -> mono -> resample ->
   high-pass chain (150 Hz, 40 Hz) -> multi-pass trim -> loudness -> write
3. with ``on_device_features``, the fused feature frontend
   (audio/features.py) on the device over length-bucketed batches, writing
   the dataset's hash-keyed mel caches and ``.gt.f0`` / ``.gt.energy`` dumps
4. metadata collection via dataset autodiscovery (:416-436)
5. speaker/emotion info + filelists + meta_dump.json (:448-675)
6. optional ARPAbet transcripts (:530-552) and MFA alignment (:554-598)

The pool of step 2 comes from a ``spawn`` context: its workers run numpy
only, and a spawned worker inherits nothing of a parent that has touched
CUDA. The native library is built before the pool starts; a failed build
raises with the compiler's output.
"""
from __future__ import annotations

import dataclasses
import json
import multiprocessing
import os
import time
from glob import glob
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data import audio_io
from ..data.extract import extract, is_archive
from ..data.filelist import generate_filelist_from_datasets, write_filelists


@dataclasses.dataclass
class PreprocessConfig:
    dataset_dirs: Sequence[str] = ()
    target_sr: int = 44100
    highpass_hz: Sequence[float] = (150.0, 40.0)
    trim_passes: int = 3
    trim_top_db: float = 45.0
    target_lufs: Optional[float] = None      # None = skip loudness step
    min_duration: float = 0.9
    min_speaker_duration: float = 0.0
    threads: int = 1
    out_dir: str = "preprocessed"
    backup_originals: bool = False
    # dataset-specific fixes (start_preprocess.py:161-208)
    delete_noisy: bool = False               # Clipper *_Noisy_* removal
    delete_very_noisy: bool = False          # Clipper *_Very Noisy_*
    vctk_use_aux_mic: bool = False           # keep _mic2 instead of _mic1
    # phonetic transcripts / forced alignment (:530-598)
    arpa_dict_path: Optional[str] = None     # merged.dict for {ARPA} quotes
    use_forced_aligner: bool = False
    mfa_binary: Optional[str] = None
    mfa_lexicon: Optional[str] = None        # defaults to arpa_dict_path
    # the fused feature frontend on the device (dump_features_on_device):
    # the dataset's mel/len caches and the .gt.f0/.gt.energy dumps
    on_device_features: bool = False
    feature_batch: int = 16
    filter_length: int = 2048
    hop_length: int = 512
    win_length: int = 2048
    n_mel_channels: int = 80
    mel_fmin: float = 20.0
    mel_fmax: Optional[float] = 11025.0


def apply_dataset_fixes(cfg: PreprocessConfig) -> Dict[str, int]:
    """Dataset-specific cleanup before audio processing
    (reference start_preprocess.py:161-208):
    - Clipper_MLP: delete ``*_Noisy_*`` / ``*_Very Noisy_*`` clips;
    - VCTK: keep one microphone, renaming ``_mic1.wav``/``_mic2.wav`` to
      ``.wav`` (the Blizzard2011 studio slicing step is dataset-payload
      specific and out of scope here).
    """
    counts = {"clipper_deleted": 0, "vctk_renamed": 0}
    for d in cfg.dataset_dirs:
        name = os.path.basename(os.path.normpath(d))
        if name.lower().startswith("clipper"):
            patterns = []
            if cfg.delete_very_noisy:
                patterns.append("*_Very Noisy_*")
            if cfg.delete_noisy:
                patterns.append("*_Noisy_*")
            for pat in patterns:
                for p in glob(os.path.join(d, "**", pat), recursive=True):
                    os.unlink(p)
                    counts["clipper_deleted"] += 1
        if name.lower().startswith("vctk"):
            keep = "_mic2.wav" if cfg.vctk_use_aux_mic else "_mic1.wav"
            drop = "_mic1.wav" if cfg.vctk_use_aux_mic else "_mic2.wav"
            for p in glob(os.path.join(d, "**", f"*{keep}"),
                          recursive=True):
                os.rename(p, p.replace(keep, ".wav"))
                counts["vctk_renamed"] += 1
            for p in glob(os.path.join(d, "**", f"*{drop}"),
                          recursive=True):
                os.unlink(p)
    return counts


def run_forced_alignment(result: Dict[str, Any],
                         cfg: PreprocessConfig) -> Optional[str]:
    """MFA over all clips, one corpus per speaker
    (reference start_preprocess.py:554-598): writes per-clip
    ``<wav>.dur.npy`` phone-duration sidecars (the untts training input),
    phoneme transcripts into the entries, and a ``missing_vocab.txt``
    dump of out-of-lexicon words. Returns the missing-vocab path (alignment
    is skipped, and uniform durations apply downstream, when no aligner
    binary or lexicon is available)."""
    import shutil
    import tempfile

    from ..data.mfa import (durations_from_textgrid, find_mfa, oov_words,
                            parse_textgrid, run_alignment)

    lexicon_path = cfg.mfa_lexicon or cfg.arpa_dict_path
    entries = result["train"] + result["validation"]

    # missing-vocab dump works even without the binary
    missing_path = os.path.join(cfg.out_dir, "missing_vocab.txt")
    lexicon: Dict[str, str] = {}
    if lexicon_path and os.path.exists(lexicon_path):
        with open(lexicon_path, encoding="utf-8", errors="replace") as f:
            for ln in f:
                parts = ln.split()
                if len(parts) >= 2:
                    lexicon[parts[0].upper()] = " ".join(parts[1:])
    os.makedirs(cfg.out_dir, exist_ok=True)
    with open(missing_path, "w", encoding="utf-8") as f:
        f.write("\n".join(oov_words([m["quote"] for m in entries],
                                    lexicon)))

    mfa = (cfg.mfa_binary or find_mfa()) if cfg.use_forced_aligner else None
    if mfa is None or lexicon_path is None:
        if cfg.use_forced_aligner:
            print("[preprocess] MFA binary or lexicon unavailable — "
                  "skipping forced alignment (uniform durations apply)")
        return missing_path

    # per-speaker corpora: wav + .lab transcript pairs
    by_speaker: Dict[str, list] = {}
    for m in entries:
        by_speaker.setdefault(m.get("speaker", str(m["speaker_id"])),
                              []).append(m)
    for speaker, items in by_speaker.items():
        with tempfile.TemporaryDirectory() as tmp:
            corpus = os.path.join(tmp, "corpus")
            os.makedirs(corpus)
            # corpus names are index-prefixed: chapter-numbered layouts
            # (a/0001.wav, b/0001.wav) share basenames, and a flat copy
            # would overwrite wav+lab pairs and hand BOTH clips the one
            # surviving TextGrid's durations
            names = {}
            for j, m in enumerate(items):
                base = os.path.splitext(os.path.basename(m["path"]))[0]
                names[id(m)] = f"u{j:06d}_{base}"
            for m in items:
                base = names[id(m)]
                shutil.copy(m["path"], os.path.join(corpus, base + ".wav"))
                with open(os.path.join(corpus, base + ".lab"), "w",
                          encoding="utf-8") as f:
                    f.write(m["quote"])
            out = os.path.join(tmp, "aligned")
            try:
                run_alignment(corpus, lexicon_path, out, mfa_binary=mfa)
            except Exception as e:
                print(f"[preprocess] MFA failed for {speaker}: {e!r}")
                continue
            for m in items:
                base = names[id(m)]
                tg = None
                for cand in (os.path.join(out, base + ".TextGrid"),
                             os.path.join(out, speaker,
                                          base + ".TextGrid")):
                    if os.path.exists(cand):
                        tg = cand
                        break
                if tg is None:
                    continue
                tiers = parse_textgrid(tg)
                # durations on the MEL frame grid the dataset trains on
                # (hop/sr: the dataset reads the sidecar as mel frames)
                hop_s = cfg.hop_length / float(cfg.target_sr)
                dur = durations_from_textgrid(tiers, "phones", hop_s)
                np.save(m["path"] + ".dur.npy", np.asarray(dur, np.int32))
                phones = " ".join(lbl for _, _, lbl in
                                  tiers.get("phones", []) if lbl)
                if phones:
                    m["phoneme_transcript"] = "{" + phones + "}"
    return missing_path


def extract_archives_recursively(root: str, max_depth: int = 3) -> int:
    """Extract every archive under root (newly extracted archives too)."""
    n = 0
    for _ in range(max_depth):
        archives = [p for p in glob(os.path.join(root, "**", "*"),
                                    recursive=True) if is_archive(p)]
        todo = [p for p in archives
                if not os.path.exists(p + ".extracted")]
        if not todo:
            break
        for p in todo:
            extract(p)
            open(p + ".extracted", "w").close()
            n += 1
    return n


def process_audio_file(args) -> Optional[str]:
    """One file of step 2 (a pool worker): rewrites the wav in place."""
    path, cfg = args
    try:
        audio, sr = audio_io.load_wav(path, target_sr=cfg.target_sr)
        audio = audio_io.remove_dc_offset(audio)
        for hz in cfg.highpass_hz:
            if len(audio) > 128:
                audio = audio_io.butter_highpass(audio, cfg.target_sr, hz)
        audio = audio_io.trim_silence(
            audio, cfg.target_sr, top_db=cfg.trim_top_db,
            n_passes=cfg.trim_passes)
        if cfg.target_lufs is not None and len(audio) > cfg.target_sr // 10:
            audio = audio_io.loudness_normalize(
                audio, cfg.target_sr, target_lufs=cfg.target_lufs)
        if cfg.backup_originals and not os.path.exists(path + ".orig"):
            os.replace(path, path + ".orig")
        audio_io.save_wav(path, audio, cfg.target_sr)
        return None
    except Exception as e:      # collect failures, don't crash the pool
        return f"{path}: {e!r}"


def process_audio_multiprocess(paths: Sequence[str],
                               cfg: PreprocessConfig) -> List[str]:
    """Step 2 over ``paths``: in this process when ``cfg.threads`` <= 1,
    else in a pool of spawned workers. Returns the failures."""
    args = [(p, cfg) for p in paths]
    if cfg.threads <= 1:
        results = [process_audio_file(a) for a in args]
    else:
        with multiprocessing.get_context("spawn").Pool(cfg.threads) as pool:
            results = pool.map(process_audio_file, args)
    return [r for r in results if r]


def native_audio_path() -> str:
    """Build (or find) the native library before any worker needs it and
    name the audio path step 2 takes (``audio_io``'s rule). A failed build
    raises."""
    from ..data import native
    native.load(build_if_missing=True)
    if audio_io._native() is None:
        return "numpy/scipy (COOKIETTS_DISABLE_NATIVE is set)"
    return f"native ({native.library_path()})"


def bucket_len(n: int, cfg: PreprocessConfig) -> int:
    """The power-of-two multiple of 8 hops that holds ``n`` samples: few
    distinct shapes for the frontend."""
    t = cfg.hop_length * 8
    while t < n:
        t *= 2
    return t


def bucket_batch(clips: Sequence[np.ndarray], cfg: PreprocessConfig
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Clips -> (audio [B, bucket] float32, lengths [B] int32). Each row's
    pad starts with the clip's own tail reflection: the STFT reflect-pads
    the bucket's edge, so without it the frames near the clip's end would
    window zeros where the dataset, on the unpadded clip, windows its
    reflection."""
    T = bucket_len(max(len(a) for a in clips), cfg)
    batch = np.zeros((len(clips), T), np.float32)
    lengths = np.zeros((len(clips),), np.int32)
    for j, a in enumerate(clips):
        n = len(a)
        batch[j, :n] = a
        lengths[j] = n
        m = min(cfg.filter_length, n - 1, T - n)
        if m > 0:
            batch[j, n:n + m] = a[::-1][1:1 + m]
    return batch, lengths


def feature_cache_hash(cfg: PreprocessConfig) -> str:
    """The dataset's mel-cache key (data/dataset.py:mel_cache_hash) of the
    files step 2 wrote: this frontend, trim and loudness off."""
    from ..data.dataset import DataConfig, mel_cache_hash
    return mel_cache_hash(DataConfig(
        sampling_rate=cfg.target_sr, filter_length=cfg.filter_length,
        hop_length=cfg.hop_length, win_length=cfg.win_length,
        n_mel_channels=cfg.n_mel_channels, mel_fmin=cfg.mel_fmin,
        mel_fmax=(cfg.mel_fmax if cfg.mel_fmax is not None
                  else cfg.target_sr / 2),
        trim_enable=False, target_lufs=None))


def feature_frontend(cfg: PreprocessConfig, device, target_lufs=None):
    """The fused frontend of ``cfg``'s STFT on ``device``."""
    from ..audio.features import fused_frontend
    from ..audio.stft import TacotronSTFT
    stft = TacotronSTFT(
        filter_length=cfg.filter_length, hop_length=cfg.hop_length,
        win_length=cfg.win_length, n_mel_channels=cfg.n_mel_channels,
        sampling_rate=cfg.target_sr, mel_fmin=cfg.mel_fmin,
        mel_fmax=cfg.mel_fmax, device=device)
    return fused_frontend(stft, sr=cfg.target_sr, target_lufs=target_lufs,
                          device=device)


def dump_features_on_device(paths: Sequence[str], cfg: PreprocessConfig,
                            device="cuda") -> Dict[str, Any]:
    """The fused frontend on ``device`` over every clip, in length buckets
    of ``cfg.feature_batch`` clips (the replacement for the reference's
    per-file pyworld :815-838, pyloudnorm :786-803 and librosa :571-577).
    Runs after step 2, so the wavs are already trimmed and normalised and
    no second normalisation is applied.

    Writes, per clip:
    - ``<wav>.{hash}.mel.npy`` + ``.{hash}.len.npy``: the dataset's own cache
      entries (``feature_cache_hash``), which training and TBPTT planning
      read instead of computing the mel; n_frames = len // hop + 1.
    - ``<wav>.gt.f0.npy`` / ``.gt.energy.npy``: analysis dumps on the mel's
      frame grid (the f0 frames centre-padded like the mel). Not training
      caches: the dataset's default f0 is DIO.

    Returns the stats: ``clips`` (the number written), ``load_s`` (reading
    the wavs), ``wall_s``, ``batch_ms`` (each batch's frontend call between
    two CUDA events, or on the host's clock on the CPU: the pageable copy to
    the card and the host's launch gaps included, so not device time),
    ``buckets`` (each batch's padded length), ``audio_s`` and
    ``peak_bytes`` (the device's peak memory)."""
    import torch

    from ..device import resolve_device
    dev = resolve_device(device)
    t0 = time.perf_counter()
    fn = feature_frontend(cfg, dev)
    cache_hash = feature_cache_hash(cfg)

    loaded = []
    for p in paths:
        try:
            audio, _ = audio_io.load_wav(p, target_sr=cfg.target_sr)
            # the dataset's loader removes the DC offset before the mel
            loaded.append((p, audio_io.remove_dc_offset(audio)))
        except Exception as e:
            print(f"[preprocess] feature dump skip {p}: {e!r}")
    loaded.sort(key=lambda pa: len(pa[1]))
    t_load = time.perf_counter() - t0
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    batch_ms, buckets = [], []
    done = 0
    for i in range(0, len(loaded), cfg.feature_batch):
        chunk = loaded[i:i + cfg.feature_batch]
        batch, lengths = bucket_batch([a for _, a in chunk], cfg)
        buckets.append(batch.shape[1])
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        else:
            t1 = time.perf_counter()
        out = fn(batch, lengths)
        if cuda:
            ev[1].record()
        mel, f0, energy = (out[k].cpu().numpy() for k in ("mel", "f0",
                                                         "energy"))
        batch_ms.append(ev[0].elapsed_time(ev[1]) if cuda
                        else 1e3 * (time.perf_counter() - t1))
        for j, (p, a) in enumerate(chunk):
            n = min(len(a) // cfg.hop_length + 1, mel.shape[1])
            np.save(p + f".{cache_hash}.mel.npy", mel[j, :n])
            np.save(p + f".{cache_hash}.len.npy", np.asarray(n, np.int64))
            np.save(p + ".gt.f0.npy", f0[j, :n])
            np.save(p + ".gt.energy.npy", energy[j, :n])
            done += 1
    return dict(
        clips=done, load_s=t_load, wall_s=time.perf_counter() - t0,
        batch_ms=batch_ms, batches=len(batch_ms), buckets=buckets,
        audio_s=sum(len(a) for _, a in loaded) / cfg.target_sr,
        peak_bytes=torch.cuda.max_memory_allocated(dev) if cuda else None)


def run_preprocess(cfg: PreprocessConfig, arpa_lookup=None,
                   device="cuda") -> Dict[str, Any]:
    """Run the full preprocess pipeline; returns the filelist result.

    Output-file inventory matches the reference script
    (start_preprocess.py:416-675): filelist_train/validation.txt (all-in-
    one AND per dataset), speaker_info.txt, emotion_info.txt,
    meta_dump.json, missing_vocab.txt (when a lexicon is given), plus
    per-clip .dur.npy alignment sidecars when MFA runs. The feature dump
    runs on ``device`` (the card unless the CPU is asked for; without a
    card the default raises). The last line printed is one JSON object
    ``{"preprocess_stats": ...}`` with the steps' seconds."""
    from ..device import resolve_device
    dev = resolve_device(device)
    t0 = time.perf_counter()
    for d in cfg.dataset_dirs:
        extract_archives_recursively(d)

    apply_dataset_fixes(cfg)

    wavs: List[str] = []
    for d in cfg.dataset_dirs:
        wavs.extend(glob(os.path.join(d, "**", "*.wav"), recursive=True))
    wavs = sorted(set(wavs))
    path = native_audio_path()
    print(f"[preprocess] audio path: {path}; {len(wavs)} wavs, "
          f"{max(cfg.threads, 1)} process(es)")
    t_audio = time.perf_counter()
    failures = process_audio_multiprocess(wavs, cfg)
    stats: Dict[str, Any] = {
        "audio_path": path.split()[0], "wavs": len(wavs),
        "audio_step_s": time.perf_counter() - t_audio}
    if failures:
        print(f"[preprocess] {len(failures)} file failures "
              f"(first: {failures[0]})")

    if cfg.on_device_features:
        dump = dump_features_on_device(wavs, cfg, dev)
        stats["features"] = dict(dump, device=str(dev))
        print(f"[preprocess] features dumped on {dev} for {dump['clips']} "
              "clips")

    result = generate_filelist_from_datasets(
        cfg.dataset_dirs, min_duration=cfg.min_duration,
        min_speaker_duration=cfg.min_speaker_duration)

    # phonetic transcripts ({ARPA} substitution, reference :530-552)
    if arpa_lookup is None and cfg.arpa_dict_path \
            and os.path.exists(cfg.arpa_dict_path):
        from ..text.cmudict import ARPADict
        arpa_lookup = ARPADict(cfg.arpa_dict_path).get
    if arpa_lookup is not None:
        for split in ("train", "validation"):
            for m in result[split]:
                m["phoneme_transcript"] = arpa_lookup(m["quote"])

    if cfg.use_forced_aligner or cfg.mfa_lexicon or cfg.arpa_dict_path:
        run_forced_alignment(result, cfg)

    write_filelists(result, cfg.out_dir)
    with open(os.path.join(cfg.out_dir, "preprocess_config.json"),
              "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1, default=list)
    stats["total_s"] = time.perf_counter() - t0
    print(json.dumps({"preprocess_stats": stats}))
    return result

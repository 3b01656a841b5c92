"""Filelist generation with speaker accounting.

Capability rebuild of ``generate_filelist_from_datasets``
(CookieTTS/utils/dataset/data_utils.py:37-254): collect per-dataset
metadata, measure per-clip/per-speaker durations, drop clips shorter than
a minimum, assign stable integer speaker IDs, split train/validation, and
dump speaker / emotion info files
(_1_preprocess/start_preprocess.py:448-516,609-675).
"""
from __future__ import annotations

import json
import os
import random
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import audio_io
from .metadata import get_dataset_meta


def clip_duration(path: str) -> float:
    """Duration in seconds from the WAV header (no full decode)."""
    import wave
    try:
        with wave.open(path, "rb") as w:
            return w.getnframes() / float(w.getframerate())
    except Exception:
        audio, sr = audio_io.load_wav(path)
        return len(audio) / sr


def generate_filelist_from_datasets(
        dataset_dirs: Sequence[str],
        default_speakers: Optional[Dict[str, str]] = None,
        min_duration: float = 0.9,
        max_duration: float = 0.0,          # 0 disables
        val_fraction: float = 0.01,
        val_min_per_speaker: int = 1,
        min_speaker_duration: float = 0.0,   # drop tiny speakers (ref
        seed: int = 1234,                    # MIN_SPEAKER_DURATION_SECONDS)
        measure_durations: bool = True) -> Dict[str, Any]:
    """Returns dict with train/validation entry lists + lookups.

    Each entry: {path, quote, speaker, speaker_id, emotion_id?, duration,
    dataset}.
    """
    default_speakers = default_speakers or {}
    meta: List[Dict[str, Any]] = []
    for d in dataset_dirs:
        name = os.path.basename(os.path.normpath(d))
        start = len(meta)
        get_dataset_meta(d, meta=meta,
                         default_speaker=default_speakers.get(name, name))
        for m in meta[start:]:
            m["dataset"] = name

    # durations + min-duration filter
    kept = []
    speaker_durations: Dict[str, float] = {}
    for m in meta:
        dur = clip_duration(m["path"]) if measure_durations else 0.0
        if measure_durations and dur < min_duration:
            continue
        if max_duration and dur > max_duration:
            continue
        m = dict(m, duration=dur)
        kept.append(m)
        speaker_durations[m["speaker"]] = \
            speaker_durations.get(m["speaker"], 0.0) + dur

    if min_speaker_duration > 0.0 and measure_durations:
        kept = [m for m in kept
                if speaker_durations[m["speaker"]] >= min_speaker_duration]

    # stable speaker-ID assignment (sorted by name)
    speakers = sorted({m["speaker"] for m in kept})
    speaker_ids = {s: i for i, s in enumerate(speakers)}
    # emotion classes: only REAL labels get ids. Non-clipper datasets
    # default emotions=["unknown"] (metadata.py:172), so mixing labeled
    # and unlabeled datasets must not hand every unlabeled clip a REAL
    # supervised class — unlabeled stays -1, which collate maps to the
    # semi-supervised "unknown" one-hot (class C) and the emotion loss
    # leaves unsupervised
    emotions = sorted({e for m in kept for e in m.get("emotions", [])
                       if e and e != "unknown"})
    emotion_ids = {e: i for i, e in enumerate(emotions)}
    for m in kept:
        m["speaker_id"] = speaker_ids[m["speaker"]]
        first = (m.get("emotions") or [None])[0]
        m["emotion_id"] = emotion_ids.get(first, -1) if first else -1

    # train/val split: at least val_min_per_speaker from each speaker
    rng = random.Random(seed)
    by_speaker: Dict[str, List[Dict[str, Any]]] = {}
    for m in kept:
        by_speaker.setdefault(m["speaker"], []).append(m)
    train, val = [], []
    for s, items in sorted(by_speaker.items()):
        rng.shuffle(items)
        n_val = max(int(len(items) * val_fraction),
                    val_min_per_speaker if len(items) > 1 else 0)
        val.extend(items[:n_val])
        train.extend(items[n_val:])
    rng.shuffle(train)

    return {
        "train": train,
        "validation": val,
        "speaker_ids": speaker_ids,
        "emotion_ids": emotion_ids,
        "speaker_durations": speaker_durations,
    }


def _filelist_line(m: Dict[str, Any]) -> str:
    """Canonical line: ``path|quote|speaker_id`` plus optional extended
    columns ``|phoneme_transcript|emotion_id|noise`` when present
    (reference octuplet format, start_preprocess.py:602-640).

    '|' is the column separator, so a transcript containing one would
    shift every later column (speaker_id parsed from transcript text);
    replace it with '/' in the text fields."""
    clean = lambda s: str(s).replace("|", "/")  # noqa: E731
    line = f"{clean(m['path'])}|{clean(m['quote'])}|{m['speaker_id']}"
    if m.get("phoneme_transcript") or "emotion_id" in m or m.get("noise"):
        line += (f"|{clean(m.get('phoneme_transcript', ''))}"
                 f"|{m.get('emotion_id', '')}"
                 f"|{clean(m.get('noise', ''))}")
    return line


def write_filelists(result: Dict[str, Any], out_dir: str,
                    per_dataset: bool = True) -> None:
    """Write filelist_train.txt / filelist_validation.txt (all-in-one AND
    per dataset) / speaker_info.txt / emotion_info.txt / meta_dump.json
    (start_preprocess.py:448-516,602-675 output surface)."""
    os.makedirs(out_dir, exist_ok=True)
    for split in ("train", "validation"):
        with open(os.path.join(out_dir, f"filelist_{split}.txt"), "w",
                  encoding="utf-8") as f:
            for m in result[split]:
                f.write(_filelist_line(m) + "\n")
        if per_dataset:
            by_ds: Dict[str, List[Dict[str, Any]]] = {}
            for m in result[split]:
                if m.get("dataset"):
                    by_ds.setdefault(m["dataset"], []).append(m)
            for ds, items in by_ds.items():
                ds_dir = os.path.join(out_dir, ds)
                os.makedirs(ds_dir, exist_ok=True)
                with open(os.path.join(ds_dir, f"filelist_{split}.txt"),
                          "w", encoding="utf-8") as f:
                    for m in items:
                        f.write(_filelist_line(m) + "\n")
    with open(os.path.join(out_dir, "speaker_info.txt"), "w",
              encoding="utf-8") as f:
        f.write(";dataset|speaker_name|speaker_id|duration_hrs\n")
        dataset_of = {m["speaker"]: m.get("dataset", "")
                      for split in ("train", "validation")
                      for m in result[split]}
        for name, sid in sorted(result["speaker_ids"].items(),
                                key=lambda kv: kv[1]):
            dur = result["speaker_durations"].get(name, 0.0)
            f.write(f"{dataset_of.get(name, '')}|{name}|{sid}"
                    f"|{dur / 3600:.4f}\n")
    with open(os.path.join(out_dir, "emotion_info.txt"), "w",
              encoding="utf-8") as f:
        # arousal/valence columns left 0.0 for the user to fill in, like
        # the reference's blank table (start_preprocess.py:503-516)
        f.write(";emotion|emotion_id|arousal|valence\n")
        for name, eid in sorted(result["emotion_ids"].items(),
                                key=lambda kv: kv[1]):
            f.write(f"{name}|{eid}|0.0|0.0\n")
    with open(os.path.join(out_dir, "meta_dump.json"), "w",
              encoding="utf-8") as f:
        json.dump({"train": result["train"],
                   "validation": result["validation"],
                   "speaker_ids": result["speaker_ids"],
                   "emotion_ids": result["emotion_ids"],
                   "speaker_durations": result["speaker_durations"]},
                  f, indent=1)


def load_speaker_info(path: str) -> Dict[str, int]:
    """Parse ``speaker_info.txt`` (``;dataset|speaker_name|speaker_id|
    duration_hrs`` — the :func:`write_filelists` output surface, matching
    the reference's speaker info file, start_preprocess.py:448-497) into
    a {speaker_name: id} lookup. Two-column ``name|id`` lines are also
    accepted."""
    out: Dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for ln in f:
            if not ln.strip() or ln.startswith(";"):
                continue
            parts = ln.rstrip("\n").split("|")
            if len(parts) >= 3:
                out[parts[1]] = int(parts[2])
            elif len(parts) == 2:
                out[parts[0]] = int(parts[1])
    return out


def load_filelist(path: str) -> List[Dict[str, Any]]:
    """Parse ``path|quote|speaker_id[|phoneme|emotion_id|noise]`` lines."""
    entries = []
    with open(path, encoding="utf-8") as f:
        for ln in f:
            if not ln.strip() or ln.startswith(";"):
                continue
            parts = ln.rstrip("\n").split("|")
            p, quote, sid = parts[:3]
            e: Dict[str, Any] = {"path": p, "quote": quote,
                                 "speaker_id": int(sid)}
            if len(parts) > 3 and parts[3]:
                e["phoneme_transcript"] = parts[3]
            if len(parts) > 4 and parts[4]:
                e["emotion_id"] = int(parts[4])
            if len(parts) > 5 and parts[5]:
                e["noise"] = parts[5]
            entries.append(e)
    return entries

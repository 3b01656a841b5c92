"""Dataset-layout autodiscovery.

Behavioral rebuild of CookieTTS/utils/dataset/metadata.py:5-340. Given a
dataset root it detects HOW transcripts are stored and extracts per-file
metadata (path, transcript, speaker, emotions, noise level, source):

Detection rules (identify_transcript_storage, metadata.py:5-73):
1. "clipper"  — ≥90% of audio files have a same-basename ``.txt`` sibling.
2. "tacotron" — exactly one ``*_master_dataset.txt`` filelist; or more
   than one pipe-delimited filelist whose paths resolve to audio files.
3. "ljspeech" — exactly one pipe-delimited ``path|transcript|...``
   filelist whose first column resolves to ≥95% of listed audio files.
4. "vctk"     — ≥90% of audio files have a same-basename ``.txt`` in a
   DIFFERENT directory.

Clipper filename scheme (metadata.py:280-310):
``HH_MM_SS_Speaker_Emotion_NoiseLevel_Transcript.wav`` — ≥6 underscore
fields yield speaker (title-cased), space-separated emotion list,
lower-cased noise level; known franchise folders override speaker/source
(clipper_naming_exceptions, metadata.py:125-151).

This implementation never calls ``os.chdir`` and returns deterministic
sorted output.
"""
from __future__ import annotations

import os
from glob import glob
from typing import Any, Dict, List, Optional, Sequence, Tuple


def _basename_noext(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def _read_text(path: str) -> str:
    try:
        with open(path, encoding="utf-8") as f:
            return f.read()
    except UnicodeDecodeError:
        with open(path, encoding="latin-1") as f:
            return f.read()


def remove_ending_periods(directory: str) -> None:
    """Strip stray periods before extensions (``...coming..wav``) —
    reference metadata.py:166-177 (clipper dataset inconsistency fix)."""
    for path in sorted(glob(os.path.join(directory, "**/*.*"),
                            recursive=True)):
        root, ext = os.path.splitext(path)
        fixed = root.rstrip(".") + ext
        if fixed != path and not os.path.exists(fixed):
            os.rename(path, fixed)


def identify_transcript_storage(
        directory: str, audio_files: Sequence[str],
        txt_files: Sequence[str],
        audio_basename_lookup: Dict[str, str],
) -> Tuple[str, List[str]]:
    """Returns (style, relevant_filelists)."""
    set_txt = set(txt_files)

    # 1. clipper: same-dir same-basename txt for >=90% of audio
    with_txt = sum(1 for a in audio_files
                   if os.path.splitext(a)[0] + ".txt" in set_txt)
    if audio_files and with_txt >= len(audio_files) * 0.9:
        return "clipper", []

    # 2. single *_master_dataset.txt
    masters = [t for t in txt_files
               if t.endswith("_master_dataset.txt")
               and os.path.getsize(t) > 4]
    if len(masters) == 1:
        return "tacotron", masters

    # 3. pipe-delimited filelists whose first column hits audio basenames
    valid: List[str] = []
    for t in txt_files:
        if os.path.getsize(t) <= 80:
            continue
        text = _read_text(t)
        if text.count("|") <= 2 or text.count("\n") < 1:
            continue
        paths = [ln.split("|")[0] for ln in text.split("\n")
                 if ln.strip()]
        if not paths:
            continue
        hits = sum(1 for p in paths
                   if _basename_noext(p) in audio_basename_lookup)
        if hits / len(paths) > 0.95:
            valid.append(t)
    if len(valid) == 1:
        return "ljspeech", valid
    if len(valid) > 1:
        return "tacotron", valid

    # 4. vctk: same-basename txt anywhere else
    txt_basenames = {_basename_noext(t) for t in txt_files}
    n_hit = sum(1 for a in audio_files
                if _basename_noext(a) in txt_basenames)
    if audio_files and n_hit / len(audio_files) > 0.9:
        return "vctk", []

    raise NotImplementedError(
        f'Could not identify transcript type for the "{directory}" dataset')


CLIPPER_NAMING_EXCEPTIONS = [
    # (path substring, source_type, source, speaker-or-None-keep)
    ("Other/Star Trek (John de Lancie, Discord)", "Show", "Star Trek", "Q"),
    ("Other/Eli, Elite Dangerous (John de Lancie, Discord)",
     "Game", "Elite Dangerous", "Eli"),
    ("Other/A Little Bit Wicked (Kristin Chenoworth, Skystar)",
     "Audiobook", "A Little Bit Wicked", None),
    ("Other/Sum - Tales From the Afterlives (Emily Blunt, Tempest)",
     "Audiobook", "Sum - Tales From the Afterlives", None),
    ("Other/Dr. Who", "Audiobook", "Dr. Who", None),
    ("Other/Dan vs", "Show", "Dan vs", None),
    ("Other/TFH", "Game", "Them's Fightin' Herds", None),
    ("Other/CGP Grey", "Show", "CGP Grey", None),
    ("Other/ATHF", "Show", "Aqua Teen Hunger Force", None),
    ("/Songs", "Music", "My Little Pony", None),
]


def clipper_naming_exceptions(audio_file: str, source, source_type, voice):
    p = audio_file.replace("\\", "/")
    for substr, st, src, v in CLIPPER_NAMING_EXCEPTIONS:
        if substr in p:
            return (v or voice), src, st
    return voice, source, source_type


def _parse_clipper_name(audio_basename: str):
    """Returns (voice, emotions, noise_level) or None if not clipper-style."""
    parts = audio_basename.split("_")
    if len(parts) < 6:
        return None
    try:
        for s in parts[0:3]:
            int(s)
    except ValueError:
        raise ValueError(
            f'"{audio_basename}" has 6 or more underscores but does not '
            f"follow clipper naming scheme.")
    voice = parts[3].title()
    emotions = parts[4].lower().split(" ")
    noise_level = parts[5].lower()
    return voice, emotions, noise_level


def get_dataset_meta(directory: str,
                     meta: Optional[List[Dict[str, Any]]] = None,
                     default_speaker: Optional[str] = None,
                     default_emotion: Optional[str] = None,
                     default_noise_level: Optional[str] = None,
                     default_source: Optional[str] = None,
                     default_source_type: str = "audiobook",
                     audio_ext: Sequence[str] = ("*.wav",),
                     audio_rejects: Sequence[str] = (),
                     fix_ending_periods: bool = False
                     ) -> List[Dict[str, Any]]:
    """Walk a dataset folder and return a list of metadata dicts
    ``{path, quote, speaker, emotions, noise, source, source_type}``.

    Reference: get_dataset_meta (metadata.py:181-340).
    """
    if meta is None:
        meta = []
    if default_emotion is None:
        default_emotion = "unknown"
    assert default_speaker, \
        f'default speaker required for dataset "{directory}".'
    directory = os.path.abspath(directory)
    if fix_ending_periods:
        remove_ending_periods(directory)

    audio_files: List[str] = []
    for ext in audio_ext:
        audio_files.extend(glob(os.path.join(directory, "**", ext),
                                recursive=True))
    banned = set()
    for rjct in audio_rejects:
        banned.update(glob(os.path.join(directory, "**", rjct),
                           recursive=True))
    audio_files = sorted(set(audio_files) - banned)
    assert audio_files, f'no audio files found for "{directory}" dataset.'

    audio_basename_lookup = {_basename_noext(a): a for a in audio_files}
    txt_files = sorted(
        set(glob(os.path.join(directory, "**", "*.txt"), recursive=True))
        | set(glob(os.path.join(directory, "**", "*.csv"), recursive=True)))
    assert txt_files, f'no text files found for "{directory}" dataset.'
    txt_name_lookup = {os.path.basename(t): t for t in txt_files}

    style, filelists = identify_transcript_storage(
        directory, audio_files, txt_files, audio_basename_lookup)

    # central filelist for ljspeech/tacotron styles
    transcript_by_key: Dict[str, str] = {}
    if style in ("ljspeech", "tacotron"):
        for t in filelists:
            base_dir = os.path.dirname(t)
            for ln in _read_text(t).split("\n"):
                if not ln.strip() or "{" in ln:   # skip provided ARPAbet
                    continue
                fields = ln.strip().split("|")
                if len(fields) < 2:
                    continue
                p = fields[0].replace(".npy", ".wav").replace("\\", "/")
                quote = fields[1].strip()
                transcript_by_key[os.path.normpath(
                    os.path.join(base_dir, p))] = quote
                transcript_by_key[os.path.basename(p)] = quote
                transcript_by_key[_basename_noext(p)] = quote

    def lookup_transcript(audio_file: str) -> Optional[str]:
        if style == "clipper":
            txt = os.path.splitext(audio_file)[0] + ".txt"
            return _read_text(txt).strip() if os.path.exists(txt) else None
        if style in ("ljspeech", "tacotron"):
            for key in (os.path.normpath(audio_file),
                        os.path.basename(audio_file),
                        _basename_noext(audio_file)):
                if key in transcript_by_key:
                    return transcript_by_key[key]
            return None
        if style == "vctk":
            t = txt_name_lookup.get(_basename_noext(audio_file) + ".txt")
            return _read_text(t).strip() if t else None
        return None

    files_added = files_skipped = 0
    for audio_file in audio_files:
        transcript = lookup_transcript(audio_file)
        if transcript is None or len(transcript) < 2:
            files_skipped += 1
            continue

        voice = default_speaker
        emotions = [default_emotion]
        noise_level = default_noise_level
        source = default_source
        source_type = default_source_type

        parsed = _parse_clipper_name(_basename_noext(audio_file))
        if parsed is not None:
            voice, emotions, noise_level = parsed
            if "Sliced Dialogue" in audio_file:
                voice, source, source_type = clipper_naming_exceptions(
                    audio_file, source, source_type, voice)

        meta.append({
            "path": audio_file,
            "quote": transcript,
            "speaker": voice,
            "emotions": emotions,
            "noise": noise_level,
            "source": source,
            "source_type": source_type,
        })
        files_added += 1

    return meta

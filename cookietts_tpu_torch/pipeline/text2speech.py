"""T2S — the text-to-speech inference worker
(cookietts_tpu/pipeline/text2speech.py), live-model path.

- :func:`parse_text_into_segments` — quote/sentence-aware splitting.
- speaker fuzzy matching and per-segment speaker interleave modes.
- best-of-N rejection sampling: batch-generate candidates, score them with
  the alignment ``weighted_score``, keep the best per segment, retry
  below-target segments until ``target_score`` or ``max_attempts``.
- decode step counts rounded up to a few buckets.
- batched vocoding and in-process concatenation of the output audio.

Decoding and vocoding run on the model's device; the host loop only does
control flow. Prenet dropout draws from a ``torch.Generator`` seeded from
the request's ``seed``.
"""
from __future__ import annotations

import dataclasses
import difflib
import re
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.tacotron2 import Tacotron2
from ..ops.metrics import alignment_metric, weighted_score
from ..text import text_to_sequence

_SENT_SPLIT = re.compile(r"(?<=[.!?;:])\s+")


def parse_text_into_segments(text: str, split_at_quotes: bool = True,
                             target_segment_length: int = 120,
                             max_segment_length: int = 256) -> List[str]:
    """Split input into segments at quote and sentence boundaries.

    Quoted spans are kept intact as their own segments when
    ``split_at_quotes`` (dialogue keeps one voice); long stretches are
    re-packed into chunks near ``target_segment_length`` chars without
    crossing ``max_segment_length``.
    """
    text = text.replace("\n", " ").strip()
    # word processors auto-curl quotes; normalize so dialogue splitting
    # and speaker_mode="quotes" see them
    text = text.replace("“", '"').replace("”", '"')
    if not text:
        return []

    spans: List[str] = []
    if split_at_quotes and '"' in text:
        parts = text.split('"')
        for i, part in enumerate(parts):
            part = part.strip()
            if not part:
                continue
            spans.append(f'"{part}"' if i % 2 == 1 else part)
    else:
        spans = [text]

    segments: List[str] = []
    for span in spans:
        quoted = span.lstrip().startswith(('"', "“"))
        pieces: List[str] = []
        sentences = [s.strip() for s in _SENT_SPLIT.split(span) if s.strip()]
        cur = ""
        for s in sentences:
            while len(s) > max_segment_length:   # hard-split huge sentences
                cut = s.rfind(" ", 0, max_segment_length)
                cut = cut if cut > 0 else max_segment_length
                if cur:
                    pieces.append(cur)
                    cur = ""
                pieces.append(s[:cut].strip())
                s = s[cut:].strip()
            if cur and len(cur) + 1 + len(s) > target_segment_length:
                pieces.append(cur)
                cur = s
            else:
                cur = f"{cur} {s}".strip()
        if cur:
            pieces.append(cur)
        if quoted:
            # every piece of a re-packed quote keeps its quote marker, or
            # speaker_mode="quotes" hands the continuation to the narrator
            pieces = [p if p.startswith(('"', "“")) else f'"{p}'
                      for p in pieces]
        segments.extend(pieces)
    return segments


def fuzzy_match_speaker(name: str, known: Sequence[str]) -> str:
    """Closest known speaker name (difflib)."""
    matches = difflib.get_close_matches(name, known, n=1, cutoff=0.0)
    if not matches:
        raise KeyError(f"unknown speaker {name!r}")
    return matches[0]


def interleave_speakers(segments: Sequence[str] | int,
                        speakers: Sequence[str],
                        mode: str = "cycle next",
                        rng: Optional[np.random.Generator] = None
                        ) -> List[str]:
    """Assign a speaker to each segment. Modes: "cycle next" / "cycle all"
    / "random" / "quotes" (the first speaker narrates unquoted segments,
    quoted segments cycle through the others); anything else gives every
    segment the first speaker."""
    texts = [""] * segments if isinstance(segments, int) else list(segments)
    n_segments = len(texts)
    rng = rng or np.random.default_rng(0)
    if mode == "quotes":
        narrator = speakers[0]
        voices = list(speakers[1:]) or [speakers[0]]
        out, i = [], 0
        for t in texts:
            if t.strip().startswith(('"', "“")):
                out.append(voices[i % len(voices)])
                i += 1
            else:
                out.append(narrator)
        return out
    if mode == "cycle next":
        return [speakers[i % len(speakers)] for i in range(n_segments)]
    if mode == "cycle all":
        out, i = [], 0
        for _ in range(n_segments):
            out.append(speakers[i])
            i = (i + 1) % len(speakers)
        return out
    if mode == "random":
        return [speakers[int(rng.integers(len(speakers)))]
                for _ in range(n_segments)]
    return [speakers[0] for _ in range(n_segments)]


@dataclasses.dataclass
class T2SConfig:
    target_score: float = 0.75
    max_attempts: int = 64
    batch_size: int = 32           # candidates per generation round
    max_text_len: int = 256        # padded text length cap
    frames_per_char: float = 10.0  # dynamic max decoder steps scale
    max_decoder_steps: int = 3000
    vocoder_batch_size: int = 16
    gate_threshold: float = 0.5
    gate_delay: int = 10
    text_cleaners: Tuple[str, ...] = ("english_cleaners",)
    step_buckets: Tuple[int, ...] = (256, 512, 1024, 2048)
    split_at_quotes: bool = True
    target_segment_length: int = 120
    max_segment_length: int = 256


class T2S:
    """Programmatic TTS API.

        T2S(cfg, tts_model, speaker_ids={name: id}, vocoder_fn=generator)

    ``vocoder_fn(mel [B, T, M] tensor) -> audio [B, T * hop]`` (the port's
    HiFi-GAN ``Generator``); ``torchmoji_fn(text) -> [torchmoji_dim]`` and
    ``arpa_fn(text) -> text`` are optional host callables.
    """

    def __init__(self, cfg: T2SConfig, tts_model: Tacotron2,
                 speaker_ids: Dict[str, int],
                 vocoder_fn: Optional[Callable] = None,
                 torchmoji_fn: Optional[Callable[[str], np.ndarray]] = None,
                 arpa_fn: Optional[Callable[[str], str]] = None,
                 sample_rate: int = 44100, hop_length: int = 512,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if tts_model.device.type != self.device.type:
            raise ValueError(f"model is on {tts_model.device}, T2S on "
                             f"{self.device}")
        self.cfg = cfg
        self.model = tts_model
        self.torchmoji_dim = tts_model.cfg.torchmoji_dim
        self.speaker_ids = dict(speaker_ids)
        self.vocoder_fn = vocoder_fn
        self.torchmoji_fn = torchmoji_fn
        self.arpa_fn = arpa_fn
        self.sample_rate = sample_rate
        self.hop_length = hop_length

    def _generate(self, text, text_lengths, speaker_id, torchmoji, generator,
                  max_steps, gate_threshold, gate_delay):
        """Early-exit decode of one candidate batch + its scores."""
        out = self.model.inference(
            text, text_lengths, speaker_id, torchmoji, generator=generator,
            max_decoder_steps=max_steps, early_exit=True,
            chunk_size=max(64, self.model.cfg.gate_delay),
            gate_threshold=gate_threshold, gate_delay=gate_delay)
        lengths = torch.as_tensor(text_lengths, device=self.device)
        atd = alignment_metric(out["alignments"], lengths, out["mel_lengths"])
        scores = weighted_score(atd, lengths, out["mel_lengths"])
        return out["mel_outputs_postnet"], out["mel_lengths"], scores

    def _round_steps(self, n: int) -> int:
        """Round max decoder steps up to a small set of bucket sizes."""
        for s in self.cfg.step_buckets:
            if n <= s:
                return s
        return self.cfg.max_decoder_steps

    @torch.no_grad()
    def infer(self, text: str, speaker: Sequence[str] | str = (),
              use_arpabet: bool = False,
              speaker_mode: str = "cycle next",
              target_score: Optional[float] = None,
              max_attempts: Optional[int] = None,
              batch_size: Optional[int] = None,
              gate_threshold: Optional[float] = None,
              gate_delay: Optional[int] = None,
              max_decoder_steps: Optional[int] = None,
              max_duration_s: Optional[float] = None,
              dyna_max_duration_s: Optional[float] = None,
              style_mode: str = "torchmoji",
              split_at_quotes: Optional[bool] = None,
              target_segment_length: Optional[int] = None,
              cat_silence_s: float = 0.0,
              seed: int = 0) -> Dict[str, Any]:
        """Synthesize ``text``. Returns dict with mels per segment, scores,
        attempts, timing stats, and (if a vocoder is attached) the audio.
        ``dyna_max_duration_s`` is the per-character duration cap in
        seconds (decoder steps = min(chars * dyna * sr/hop,
        max_duration_s * sr/hop)); it replaces ``frames_per_char``."""
        cfg = self.cfg
        target = target_score if target_score is not None else cfg.target_score
        max_att = cfg.max_attempts if max_attempts is None else max_attempts
        bsz = cfg.batch_size if batch_size is None else batch_size
        for nm, v in (("max_attempts", max_att), ("batch_size", bsz),
                      ("max_decoder_steps", max_decoder_steps)):
            if v is not None and v <= 0:
                raise ValueError(f"{nm} must be positive, got {v}")
        thr = cfg.gate_threshold if gate_threshold is None else gate_threshold
        delay = cfg.gate_delay if gate_delay is None else gate_delay
        # the early-exit decode stops one chunk after the model's own gate
        # threshold fires and generates only that chunk past it: a larger
        # delay or threshold would count never-generated frames
        chunk_limit = max(64, self.model.cfg.gate_delay)
        if delay > chunk_limit:
            print(f"[t2s] gate_delay {delay} clamped to {chunk_limit} "
                  "(early-exit chunk size)")
            delay = chunk_limit
        if thr > self.model.cfg.gate_threshold:
            print(f"[t2s] gate_threshold {thr} clamped to the model's "
                  f"{self.model.cfg.gate_threshold}")
            thr = self.model.cfg.gate_threshold
        steps_cap = (cfg.max_decoder_steps if max_decoder_steps is None
                     else max_decoder_steps)
        if max_duration_s:
            steps_cap = min(steps_cap, max(1, int(
                max_duration_s * self.sample_rate / self.hop_length)))
        t_start = time.time()

        if isinstance(speaker, str):
            speaker = [speaker]
        if not speaker:
            speaker = [next(iter(self.speaker_ids))]
        known = list(self.speaker_ids)
        speaker = [fuzzy_match_speaker(s, known) for s in speaker]

        segments = parse_text_into_segments(
            text,
            split_at_quotes=(cfg.split_at_quotes if split_at_quotes is None
                             else split_at_quotes),
            target_segment_length=(target_segment_length
                                   or cfg.target_segment_length),
            max_segment_length=cfg.max_segment_length)
        if not segments:
            return {"segments": [], "mels": [], "scores": [],
                    "audio": np.zeros(0, np.float32)}

        def _encode(t_):
            t2 = self.arpa_fn(t_) if use_arpabet and self.arpa_fn else t_
            return np.asarray(text_to_sequence(t2, cfg.text_cleaners), np.int64)

        seqs = [_encode(t_) for t_ in segments]
        # never truncate tokens: a segment whose expansion passes
        # max_text_len is split at a space instead
        i = 0
        while i < len(segments):
            t_ = segments[i]
            if len(seqs[i]) <= cfg.max_text_len or " " not in t_.strip():
                i += 1
                continue
            cut = t_.rfind(" ", 1, len(t_) // 2 + 1)
            cut = cut if cut > 0 else t_.find(" ", 1)
            halves = [t_[:cut].strip(), t_[cut:].strip()]
            if t_.lstrip().startswith(('"', "“")):
                halves = [h if h.startswith(('"', "“")) else f'"{h}'
                          for h in halves]
            segments[i: i + 1] = halves
            seqs[i: i + 1] = [_encode(h) for h in halves]
        seg_speakers = interleave_speakers(segments, speaker, speaker_mode,
                                           np.random.default_rng(seed))
        tm = None
        if self.torchmoji_fn is not None and style_mode != "none":
            tm = [self.torchmoji_fn(s).astype(np.float32) for s in segments]

        best_mels: List[Optional[np.ndarray]] = [None] * len(segments)
        best_scores = np.full(len(segments), -np.inf)
        best_lengths = np.zeros(len(segments), np.int64)
        attempts = np.zeros(len(segments), np.int64)
        generator = torch.Generator(device=self.device).manual_seed(seed)

        pending = list(range(len(segments)))
        while pending:
            # fill one candidate batch: spread attempts across pending segs
            batch_idx = (pending * ((bsz // len(pending)) + 1))[:bsz]
            t_max = max(len(seqs[i]) for i in batch_idx)
            t_pad = min(-(-t_max // 32) * 32, cfg.max_text_len)
            text_arr = np.zeros((bsz, t_pad), np.int64)
            lens = np.zeros((bsz,), np.int64)
            spk = np.zeros((bsz,), np.int64)
            tm_arr = np.zeros((bsz, max(self.torchmoji_dim, 1)), np.float32)
            for row, i in enumerate(batch_idx):
                n = min(len(seqs[i]), t_pad)
                text_arr[row, :n] = seqs[i][:n]
                lens[row] = n
                spk[row] = self.speaker_ids[seg_speakers[i]]
                if tm is not None:
                    tm_arr[row] = tm[i]
            # decode at bucket step counts; the per-request cap applies to
            # mel_lengths afterwards
            fpc = (dyna_max_duration_s * self.sample_rate / self.hop_length
                   if dyna_max_duration_s else cfg.frames_per_char)
            cap_here = (max(1, min(steps_cap, int(t_max * fpc) + int(delay)))
                        if dyna_max_duration_s else steps_cap)
            max_steps = self._round_steps(min(
                int(t_max * fpc) + int(delay), steps_cap))

            mels, mel_lengths, scores = self._generate(
                text_arr, lens, spk, tm_arr, generator, max_steps, thr, delay)
            mels = mels.cpu().numpy()
            mel_lengths = np.minimum(mel_lengths.cpu().numpy(), cap_here)
            scores = scores.cpu().numpy()

            # a diverged decode can score NaN, which would never beat the
            # -inf sentinel and leave best_mels[i] = None forever
            scores = np.where(np.isfinite(scores), scores, -1e9)
            for row, i in enumerate(batch_idx):
                attempts[i] += 1
                if scores[row] > best_scores[i]:
                    best_scores[i] = scores[row]
                    best_lengths[i] = mel_lengths[row]
                    best_mels[i] = mels[row, : mel_lengths[row]].copy()
            pending = [i for i in pending
                       if best_scores[i] < target and attempts[i] < max_att]

        gen_time = time.time() - t_start

        audio = np.zeros(0, np.float32)
        if self.vocoder_fn is not None:
            pieces: List[np.ndarray] = []
            vb = cfg.vocoder_batch_size
            n_mel = best_mels[0].shape[1]
            silence = np.zeros(int(cat_silence_s * self.sample_rate),
                               np.float32)
            for i0 in range(0, len(best_mels), vb):
                chunk = best_mels[i0:i0 + vb]
                t_pad = -(-max(m.shape[0] for m in chunk) // 32) * 32
                # pad with the log-mel of silence
                mel_in = np.full((len(chunk), t_pad, n_mel), -11.52, np.float32)
                for r, m in enumerate(chunk):
                    mel_in[r, : m.shape[0]] = m
                wav = self.vocoder_fn(torch.from_numpy(mel_in).to(self.device))
                wav = wav.cpu().numpy()
                for r, m in enumerate(chunk):
                    if pieces and len(silence):
                        pieces.append(silence)
                    pieces.append(wav[r, : m.shape[0] * self.hop_length])
            audio = np.concatenate(pieces) if pieces else audio

        total = time.time() - t_start
        audio_seconds = float(best_lengths.sum() * self.hop_length
                              / self.sample_rate)
        return {
            "segments": segments,
            "speakers": seg_speakers,
            "mels": best_mels,
            "mel_lengths": best_lengths,
            "scores": best_scores,
            "attempts": attempts,
            "failure_rate": float(np.mean(best_scores < 0.6)),
            "audio": audio,
            "audio_seconds": audio_seconds,
            "gen_time": gen_time,
            "total_time": total,
            "xrt": audio_seconds / max(total, 1e-6),
        }

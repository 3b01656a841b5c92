"""The Tacotron2 dataset with static-shape batching
(cookietts_tpu/data/dataset.py: DataConfig, TTSDataset, Segment,
TBPTTSampler, collate, bucket_size, global_bucket_shapes,
collate_local_shard), through the port's TacotronSTFT.

Rebuild of the reference's TTSDataset
(CookieTTS/utils/dataset/data_utils.py:329-905):

- features are selected by NAME: text, mel, speaker_id, sylps, gate,
  torchmoji, emotion_id, and the NAR models' f0, energy and durations.
  ``emotion_id`` is the filelist's (-1 when it has none); collate maps
  every id outside [0, n_emotion_classes) to the "unknown" class
  n_emotion_classes and adds the ``emotion_onehot`` rows (zero for unknown
  ids).
- f0 (``f0_method``: DIO, data/dio.py, or frame autocorrelation) with its
  voiced flags, energy (the mean of exp(mel) over the channels) and
  per-char durations from, in order, a ``.dur.npy`` sidecar (forced
  alignment), a ``.gdur.npy`` sidecar (the ``gta`` command's attention
  durations), a ``.TextGrid`` / ``.textgrid`` (data/mfa.py), else spread
  evenly; the char averages of f0 and energy over those durations. Collate
  refits the durations to the bucketed text width and the collated mel
  length and adds the frame-rate ``frame_f0`` / ``frame_energy`` /
  ``frame_voiced`` rows; durations of TBPTT segments are refused.
- batches are padded to BUCKETED static shapes (text and mel lengths are
  rounded up to bucket boundaries), so a run sees a handful of shapes
  instead of one per batch — replaces the reference's sort-by-length
  dynamic padding (data_utils.py:1009-1014).
- TBPTT: long utterances are split into fixed-size mel segments; the
  :class:`TBPTTSampler` schedules batches so consecutive iterations
  continue the same utterances and flags ``pres_prev_state``
  (reference update_dataloader_indexes, data_utils.py:430-498).
- gate targets: 1.0 from the last frame on (padding included), but only
  on the FINAL segment of an utterance (data_utils.py:1066-1072).
- ``force_load``: unreadable files are replaced by a random other file
  (data_utils.py:888-902).
- mel/feature caching to ``.npy`` sidecar files (the reference caches
  ``.pt`` tensors).
- data parallel: :func:`collate_local_shard` loads only a rank's rows of a
  global batch, padded to the global batch's widths, which
  :func:`global_bucket_shapes` takes from metadata alone.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import random
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..audio.stft import TacotronSTFT
from ..text import text_to_sequence
from . import audio_io


def _atomic_save(path: str, arr: np.ndarray) -> None:
    """np.save via temp-file + rename so concurrent readers (Prefetcher
    threads, multiple trainer processes) never see a partial .npy."""
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp.npy"
    try:
        np.save(tmp, arr)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


@dataclasses.dataclass
class DataConfig:
    # audio frontend (tacotron2_tm/hparams.py:119-151)
    sampling_rate: int = 44100
    filter_length: int = 2048
    hop_length: int = 512
    win_length: int = 2048
    n_mel_channels: int = 80
    mel_fmin: float = 20.0
    mel_fmax: float = 11025.0
    clamp_val: float = 1e-5
    # preprocessing
    trim_enable: bool = True
    trim_top_db: float = 45.0
    target_lufs: Optional[float] = -27.0
    # text
    text_cleaners: Sequence[str] = ("english_cleaners",)
    p_arpabet: float = 0.5
    # f0 extraction: "dio" = the port of pyworld's DIO (the reference's
    # extractor, data_utils.py:815-838); "autocorr" = the cheaper
    # frame-autocorrelation stand-in
    f0_method: str = "dio"
    # TBPTT (hparams.py:53-54: max 800 frames/segment)
    max_segment_frames: int = 800
    # static-shape bucketing
    text_buckets: Sequence[int] = (32, 64, 96, 128, 192, 256)
    mel_buckets: Sequence[int] = (128, 256, 384, 512, 640, 800)
    # misc
    cache_mels: bool = True
    force_load: bool = True
    torchmoji_dim: int = 2304
    # semi-supervised emotion (id == n_emotion_classes -> unlabelled)
    n_emotion_classes: int = 16


def mel_cache_hash(cfg: "DataConfig") -> str:
    """Mel-cache key over every knob that changes the cached values.

    Module-level so producers OTHER than the dataset (the preprocess
    on-device feature dump) can write sidecars the dataset will
    actually hit as cache entries."""
    return hashlib.md5(
        f"{cfg.sampling_rate}_{cfg.filter_length}_"
        f"{cfg.hop_length}_{cfg.win_length}_"
        f"{cfg.n_mel_channels}_"
        f"{cfg.mel_fmin}_{cfg.mel_fmax}_"
        f"{cfg.clamp_val}_"
        f"{cfg.trim_top_db if cfg.trim_enable else 'raw'}_"
        f"{cfg.target_lufs}".encode()).hexdigest()[:8]


def bucket_size(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


FEATURES = ("text", "mel", "speaker_id", "sylps", "gate", "torchmoji",
            "emotion_id", "f0", "energy", "durations", "audio")


def fit_durations(dur: np.ndarray, n_text: int, t_mel: int) -> np.ndarray:
    """Fit per-char frame durations to exactly ``n_text`` chars summing to
    exactly ``t_mel`` frames (alignment lengths rarely match the mel hop
    grid; the reference re-derives durations from the alignment matrix,
    data_utils.py:779-813)."""
    dur = np.asarray(dur, np.int64)
    if len(dur) >= n_text:
        dur = dur[:n_text].copy()
    else:
        dur = np.concatenate(
            [dur, np.zeros(n_text - len(dur), np.int64)])
    ends = np.minimum(np.cumsum(dur), t_mel)     # clamp overflow
    starts = np.concatenate([[0], ends[:-1]])
    dur = ends - starts
    short = t_mel - int(dur.sum())
    if short > 0 and n_text > 0:
        last = int(np.max(np.nonzero(dur)[0])) if dur.any() else n_text - 1
        dur[last] += short                        # absorb rounding remainder
    return dur.astype(np.int32)


def uniform_durations(n_text: int, t_mel: int) -> np.ndarray:
    """Fallback when no alignment exists: spread frames evenly."""
    base = t_mel // max(n_text, 1)
    dur = np.full(n_text, base, np.int64)
    dur[: t_mel - base * n_text] += 1
    return dur.astype(np.int32)


def char_average(frame_values: np.ndarray, durations: np.ndarray
                 ) -> np.ndarray:
    """Average frame-level values (f0, energy) over each char's frames —
    the reference's per-char alignment matmul (data_utils.py:805-813)."""
    T = len(frame_values)
    ends = np.clip(np.cumsum(durations.astype(np.int64)), 0, T)
    starts = np.concatenate([[0], ends[:-1]])
    cs = np.concatenate([[0.0], np.cumsum(frame_values, dtype=np.float64)])
    sums = cs[ends] - cs[starts]
    n = np.maximum(ends - starts, 1)
    return (sums / n).astype(np.float32)


class TTSDataset:
    """Maps filelist entries -> per-utterance feature dicts (numpy)."""

    def __init__(self, entries: Sequence[Dict[str, Any]], config: DataConfig,
                 arpa_lookup: Optional[Callable[[str], str]] = None,
                 torchmoji_fn: Optional[Callable[[str], np.ndarray]] = None,
                 features: Sequence[str] = ("text", "mel", "speaker_id",
                                            "sylps", "gate"),
                 seed: int = 1234):
        unknown = set(features) - set(FEATURES)
        if unknown:
            raise NotImplementedError(
                f"dataset features {sorted(unknown)} are not ported yet")
        self.entries = list(entries)
        self.cfg = config
        self.features = set(features)
        self.arpa_lookup = arpa_lookup
        self.torchmoji_fn = torchmoji_fn
        self.rng = random.Random(seed)
        self._seed = seed
        self.epoch = 0               # re-randomizes the ARPA decisions
        self._len_cache: Dict[int, int] = {}
        self._text_len_cache: Dict[Any, int] = {}
        self.stft = TacotronSTFT(
            config.filter_length, config.hop_length, config.win_length,
            config.n_mel_channels, config.sampling_rate, config.mel_fmin,
            config.mel_fmax, config.clamp_val, device="cpu")

    def __len__(self):
        return len(self.entries)

    # -- audio/mel -----------------------------------------------------------
    def _cfg_hash(self) -> str:
        return mel_cache_hash(self.cfg)

    def _cache_path(self, audiopath: str) -> str:
        return audiopath + f".{self._cfg_hash()}.mel.npy"

    def _len_cache_path(self, audiopath: str) -> str:
        return audiopath + f".{self._cfg_hash()}.len.npy"

    def load_audio(self, audiopath: str) -> np.ndarray:
        audio, sr = audio_io.load_wav(audiopath,
                                      target_sr=self.cfg.sampling_rate)
        audio = audio_io.remove_dc_offset(audio)
        if self.cfg.trim_enable and len(audio) > self.cfg.filter_length:
            audio = audio_io.trim_silence(
                audio, sr, top_db=self.cfg.trim_top_db,
                frame_length=self.cfg.filter_length,
                hop_length=self.cfg.hop_length)
        if self.cfg.target_lufs is not None and len(audio) > sr // 10:
            audio = audio_io.loudness_normalize(
                audio, sr, target_lufs=self.cfg.target_lufs)
        return audio

    # -- cheap length metadata (TBPTT planning over the FULL filelist) --------
    def mel_frame_length(self, index: int) -> int:
        """Mel frame count for entry ``index`` WITHOUT computing a mel.

        The reference plans TBPTT batches over every filelist entry from
        pre-measured lengths (data_utils.py:430-498, train.py:634-827);
        loading full feature items just to read lengths would make epoch
        setup O(dataset audio). Resolution order:

        1. in-memory cache,
        2. the mel cache sidecar's npy HEADER (mmap, no data read),
        3. a persisted ``.len.npy`` sidecar,
        4. one audio load (trim changes the length, so the wav header
           alone is not enough) — then persist the sidecar so every
           later epoch/run is pure metadata.
        """
        n = self._len_cache.get(index)
        if n is not None:
            return n
        path = self.entries[index]["path"]
        mel_cache = self._cache_path(path)
        if self.cfg.cache_mels and os.path.exists(mel_cache):
            try:
                n = int(np.load(mel_cache, mmap_mode="r").shape[0])
            except (OSError, ValueError):
                n = None
        if n is None:
            len_cache = self._len_cache_path(path)
            if os.path.exists(len_cache):
                try:
                    n = int(np.load(len_cache))
                except (OSError, ValueError):
                    n = None
            if n is None:
                try:
                    audio = self.load_audio(path)
                    n = len(audio) // self.cfg.hop_length + 1
                except Exception:
                    if not self.cfg.force_load:
                        raise
                    # unreadable file: plan it as a median-ish length —
                    # __getitem__ will substitute a random readable file
                    # at load time anyway (reference force_load)
                    n = max(int(self.cfg.max_segment_frames), 1)
                if self.cfg.cache_mels:
                    _atomic_save(len_cache, np.asarray(n, np.int64))
        self._len_cache[index] = n
        return n

    def mel_frame_lengths(self, workers: int = 8) -> List[int]:
        """Lengths for ALL entries; first touch parallelizes the audio
        loads over a thread pool, later calls are in-memory lookups."""
        from concurrent.futures import ThreadPoolExecutor
        idx = list(range(len(self.entries)))
        if workers > 1 and len(idx) > 1:
            with ThreadPoolExecutor(max_workers=workers) as ex:
                return list(ex.map(self.mel_frame_length, idx))
        return [self.mel_frame_length(i) for i in idx]

    def get_mel(self, audiopath: str,
                audio: Optional[np.ndarray] = None) -> np.ndarray:
        cache = self._cache_path(audiopath)
        if self.cfg.cache_mels and os.path.exists(cache):
            try:
                return np.load(cache)
            except (OSError, ValueError):
                pass                       # corrupt/partial -> recompute
        if audio is None:
            audio = self.load_audio(audiopath)
        mel = self.stft.mel_spectrogram_np(audio).astype(np.float32)
        if self.cfg.cache_mels:
            _atomic_save(cache, mel)
        return mel                         # [T_frames, n_mel]

    def global_mel_mean(self, sidecar_path: Optional[str] = None,
                        workers: int = 8) -> np.ndarray:
        """Dataset-wide per-channel mel mean for drop-frame-rate.

        The reference averages the WHOLE dataset once and persists the
        result (``calculate_global_mean`` + ``global_mean_npy``,
        tacotron2_tm/train.py:463-480); estimating from one init batch
        biases the DFR replacement frames toward whatever utterances it
        sampled. One streaming sum/count pass over every entry (thread
        pool; rides the mel cache when warm), persisted to
        ``sidecar_path`` so later runs load it instantly. Unreadable
        entries are skipped under ``force_load`` (they are substituted
        at train time anyway)."""
        if sidecar_path and os.path.exists(sidecar_path):
            try:
                m = np.load(sidecar_path)
                if m.shape == (self.cfg.n_mel_channels,):
                    return m.astype(np.float32)
            except (OSError, ValueError):
                pass
        from concurrent.futures import ThreadPoolExecutor

        def acc(i):
            try:
                mel = self.get_mel(self.entries[i]["path"])
            except Exception:
                if not self.cfg.force_load:
                    raise
                return np.zeros(self.cfg.n_mel_channels, np.float64), 0
            return mel.sum(0, dtype=np.float64), mel.shape[0]

        idx = range(len(self.entries))
        if workers > 1 and len(self.entries) > 1:
            with ThreadPoolExecutor(max_workers=workers) as ex:
                parts = list(ex.map(acc, idx))
        else:
            parts = [acc(i) for i in idx]
        total = sum(p[0] for p in parts)
        n = sum(p[1] for p in parts)
        mean = (total / max(n, 1)).astype(np.float32)
        if sidecar_path:
            _atomic_save(sidecar_path, mean)
        return mean

    # -- text ------------------------------------------------------------------
    def arpa_decision(self, index: int) -> bool:
        """Deterministic per-(seed, epoch, index) ARPA coin flip.

        The reference draws per access (data_utils.py p_arpabet); here the
        draw is a hash of (seed, epoch, index) so EVERY HOST in a
        multi-host run makes the same decision without loading the item —
        global padded shapes can then be derived from metadata alone.
        Re-randomizes each epoch via :attr:`epoch` (set by the trainer)."""
        if self.arpa_lookup is None or self.cfg.p_arpabet <= 0:
            return False
        h = hashlib.md5(
            f"{self._seed}_{getattr(self, 'epoch', 0)}_{index}".encode()
        ).digest()
        return int.from_bytes(h[:4], "little") / 2**32 < self.cfg.p_arpabet

    def get_text_ids(self, quote: str, use_arpabet: Optional[bool] = None,
                     index: Optional[int] = None) -> np.ndarray:
        text = quote
        if self.arpa_lookup is not None:
            if use_arpabet is None:
                use_arpabet = (self.arpa_decision(index)
                               if index is not None
                               else self.rng.random() < self.cfg.p_arpabet)
            if use_arpabet:
                text = self.arpa_lookup(quote)
        ids = text_to_sequence(text, self.cfg.text_cleaners)
        return np.asarray(ids, np.int32)

    def text_length(self, index: int) -> int:
        """Token count for entry ``index`` WITHOUT any audio IO (cheap
        host-side tokenization; deterministic ARPA decision), cached per
        (epoch, index). Lets every host agree on the global text bucket
        while loading only its own rows. Only the current epoch's
        lengths are ever queried, so the cache is cleared when the
        epoch changes (it would otherwise grow by O(dataset) per epoch
        over reference-scale multi-day runs)."""
        epoch = getattr(self, "epoch", 0)
        # plain attribute compare: Prefetcher threads call this
        # concurrently, and inspecting the dict's first key races its
        # own clear/insert
        if getattr(self, "_text_len_epoch", epoch) != epoch:
            self._text_len_cache = {}
        self._text_len_epoch = epoch
        key = (epoch, index)
        n = self._text_len_cache.get(key)
        if n is None:
            n = len(self.get_text_ids(self.entries[index]["quote"],
                                      index=index))
            self._text_len_cache[key] = n
        return n

    # -- item ----------------------------------------------------------------
    def __getitem__(self, index: int) -> Dict[str, Any]:
        for attempt in range(20 if self.cfg.force_load else 1):
            try:
                item = self._get(index)
                if attempt:
                    # a random stand-in (reference data_utils.py:888-902)
                    # has DIFFERENT lengths than the entry the batch
                    # shapes were planned from — collate clamps marked
                    # rows instead of asserting/corrupting
                    item["_substituted"] = True
                return item
            except Exception:
                if not self.cfg.force_load or attempt == 19:
                    raise
                index = self.rng.randrange(len(self.entries))
        raise RuntimeError("unreachable")

    def _get(self, index: int) -> Dict[str, Any]:
        e = self.entries[index]
        cfg = self.cfg
        out: Dict[str, Any] = {"audiopath": e["path"], "index": index}

        audio = None
        # the audio itself, f0 and energy need the clip even when the mel
        # is cached (cookietts_tpu/data/dataset.py:431-440)
        needs_audio = any(f in self.features for f in ("audio", "f0",
                                                       "energy"))
        if "mel" in self.features or "sylps" in self.features or needs_audio:
            if needs_audio or not (cfg.cache_mels and os.path.exists(
                    self._cache_path(e["path"]))):
                audio = self.load_audio(e["path"])
                out["audio"] = audio
        if "mel" in self.features:
            mel = self.get_mel(e["path"], audio)
            out["mel"] = mel
            out["mel_length"] = mel.shape[0]
        if "text" in self.features:
            ids = self.get_text_ids(e["quote"], index=index)
            out["text"] = ids
            out["text_length"] = len(ids)
            out["transcript"] = e["quote"]
        if "speaker_id" in self.features:
            out["speaker_id"] = int(e.get("speaker_id", 0))
        if "emotion_id" in self.features:
            out["emotion_id"] = int(e.get("emotion_id", -1))   # -1: unknown
        if "sylps" in self.features:
            n_syl = audio_io.count_syllables(e["quote"])
            # mel_length when the mel was built; otherwise the cheap
            # frame-count metadata (a 1-frame default would inflate
            # sylps ~1000x)
            n_frames = out.get("mel_length") or self.mel_frame_length(index)
            dur = n_frames * cfg.hop_length / cfg.sampling_rate
            out["sylps"] = np.float32(n_syl / max(dur, 1e-2))
        if "f0" in self.features:
            if cfg.f0_method == "dio":
                f0, voiced = audio_io.estimate_f0_dio(
                    audio, cfg.sampling_rate, hop_length=cfg.hop_length)
            else:
                f0, voiced = audio_io.estimate_f0_autocorr(
                    audio, cfg.sampling_rate, hop_length=cfg.hop_length,
                    frame_length=cfg.filter_length)
            out["f0"], out["voiced"] = f0, voiced
        if "energy" in self.features:
            if "mel" not in out:
                raise ValueError("the energy feature needs the mel feature")
            out["energy"] = np.exp(out["mel"]).mean(axis=1).astype(np.float32)
        if "torchmoji" in self.features:
            if self.torchmoji_fn is not None:
                # per-file embedding cache, keyed by the transcript
                # (reference caches torchMoji .pt files,
                # data_utils.py:714-721). v2: the feature merge order
                # changed to the reference's [lstm_1, lstm_0, embed]
                # (models/torchmoji.py) — v1 caches hold block-permuted
                # vectors and must not be reused
                qh = hashlib.md5(e["quote"].encode()).hexdigest()[:8]
                tm_cache = e["path"] + f".{qh}.tm.v2.npy"
                out["torchmoji"] = None
                if cfg.cache_mels and os.path.exists(tm_cache):
                    try:
                        out["torchmoji"] = np.load(tm_cache)
                    except (OSError, ValueError):
                        pass               # corrupt/partial -> recompute
                if out["torchmoji"] is None:
                    out["torchmoji"] = np.asarray(
                        self.torchmoji_fn(e["quote"]), np.float32)
                    if cfg.cache_mels:
                        _atomic_save(tm_cache, out["torchmoji"])
            else:
                out["torchmoji"] = np.zeros(cfg.torchmoji_dim, np.float32)
        if "durations" in self.features:
            # per-char durations (reference data_utils.py:779-784 loads
            # cached alignments; the char f0/energy averages follow the
            # alignment matmul, :805-813)
            if "mel" not in out or "text" not in out:
                raise ValueError("the durations feature needs mel and text")
            dur = self._get_durations(e["path"], out["mel_length"],
                                      out["text_length"])
            out["durations"] = dur
            if "f0" in out:
                out["char_f0"] = char_average(out["f0"], dur)
            if "energy" in out:
                out["char_energy"] = char_average(out["energy"], dur)
        return out

    def _get_durations(self, audiopath: str, t_mel: int,
                       n_text: int) -> np.ndarray:
        """Durations fitted to (n_text, t_mel) from, in order: the
        ``.dur.npy`` sidecar (forced-alignment phone durations), the
        ``.gdur.npy`` sidecar (the gta command's attention durations), a
        ``.TextGrid`` / ``.textgrid`` (its phones tier, else words, else
        the first), else uniform."""
        for sfx in (".dur.npy", ".gdur.npy"):
            sidecar = audiopath + sfx
            if os.path.exists(sidecar):
                return fit_durations(np.load(sidecar), n_text, t_mel)
        base = os.path.splitext(audiopath)[0]
        for ext in (".TextGrid", ".textgrid"):
            tg = base + ext
            if os.path.exists(tg):
                from .mfa import durations_from_textgrid, parse_textgrid
                tiers = parse_textgrid(tg)
                tier = "phones" if "phones" in tiers else (
                    "words" if "words" in tiers else
                    next(iter(tiers), None))
                if tier is not None:
                    hop_s = self.cfg.hop_length / self.cfg.sampling_rate
                    dur = durations_from_textgrid(tiers, tier, hop_s)
                    return fit_durations(np.asarray(dur), n_text, t_mel)
        return uniform_durations(n_text, t_mel)


# -- TBPTT segment scheduling --------------------------------------------------

@dataclasses.dataclass
class Segment:
    file_idx: int
    seg_idx: int
    n_segs: int


class TBPTTSampler:
    """Plans batches so each batch lane continues its utterance across
    consecutive iterations (reference data_utils.py:430-498)."""

    def __init__(self, mel_lengths: Sequence[int], batch_size: int,
                 max_segment_frames: int, shuffle: bool = True,
                 seed: int = 0):
        self.batch_size = batch_size
        self.max_frames = max_segment_frames
        order = list(range(len(mel_lengths)))
        if shuffle:
            random.Random(seed).shuffle(order)
        self.queue: List[List[Segment]] = []
        for i in order:
            n = max(-(-int(mel_lengths[i]) // max_segment_frames), 1)
            self.queue.append(
                [Segment(i, s, n) for s in range(n)])

    def __iter__(self):
        from collections import deque
        lanes: List[deque] = [deque() for _ in range(self.batch_size)]
        pending = deque(self.queue)       # O(1) popleft at filelist scale
        while True:
            batch: List[Segment] = []
            for lane in lanes:
                if not lane:
                    if pending:
                        lane.extend(pending.popleft())
                    else:
                        return
                batch.append(lane.popleft())
            yield batch


def collate(items: Sequence[Dict[str, Any]],
            cfg: DataConfig,
            segments: Optional[Sequence[Segment]] = None,
            static_shapes: bool = True,
            pad_to: Optional[Tuple[int, int]] = None
            ) -> Dict[str, np.ndarray]:
    """Pad-and-stack a batch with bucketed static shapes + gate targets.

    Reference Collate.__call__ (data_utils.py:996-1076): left-aligned
    padding, gate target 1.0 from the last valid frame on (final segment
    only), ``pres_prev_state`` marks TBPTT continuations.

    ``pad_to=(t_max, m_max)`` overrides the computed text/mel widths
    (validation pads every batch to the validation set's widths).
    """
    B = len(items)
    out: Dict[str, Any] = {}

    if "text" in items[0]:
        if pad_to is not None:
            t_max = pad_to[0]
        else:
            t_max = max(len(it["text"]) for it in items)
            if static_shapes:
                t_max = bucket_size(t_max, cfg.text_buckets)
        if pad_to is None:
            over = max((len(it["text"]) for it in items
                        if not it.get("_substituted")), default=0)
            if over > t_max:
                # never silently truncate real transcripts (mel has the
                # same guarantee below); extend past the largest bucket
                # in 32-token steps
                t_max = -(-over // 32) * 32
        text = np.zeros((B, t_max), np.int32)
        text_lengths = np.zeros((B,), np.int32)
        for i, it in enumerate(items):
            n = min(len(it["text"]), t_max)
            if n < len(it["text"]) and not it.get("_substituted"):
                raise ValueError(
                    f"text row {i} ({len(it['text'])} tokens) exceeds the "
                    f"planned width {t_max}")
            text[i, :n] = it["text"][:n]
            text_lengths[i] = n
        out["text"] = text
        out["text_lengths"] = text_lengths

    if "mel" in items[0]:
        # the width each row ACTUALLY needs: for TBPTT rows that is the
        # remaining frames of the segment (a final tail can be far
        # shorter than both the full utterance and max_segment_frames —
        # sizing by those would inflate single-host buckets and reject
        # correct multi-host continuation batches). Matches the
        # metadata-only global_bucket_shapes formula.
        if segments is None:
            m_req = max(it["mel"].shape[0] for it in items)
        else:
            m_req = max(
                min(it["mel"].shape[0]
                    - s.seg_idx * cfg.max_segment_frames,
                    cfg.max_segment_frames)
                for it, s in zip(items, segments))
        if pad_to is not None:
            m_max = pad_to[1]
            real_req = max(
                (min(it["mel"].shape[0]
                     - (s.seg_idx * cfg.max_segment_frames if s else 0),
                     cfg.max_segment_frames if s else it["mel"].shape[0])
                 for it, s in zip(items, segments or [None] * B)
                 if not it.get("_substituted")), default=0)
            assert m_max >= real_req, \
                "pad_to mel width would truncate a row"
        else:
            m_max = m_req
        if static_shapes and pad_to is None:
            m_max = bucket_size(m_req, cfg.mel_buckets)
            if m_max < m_req:
                # never silently truncate (full utterances OR a TBPTT
                # segment when max_segment_frames exceeds the largest
                # bucket): extend past the bucket in 64-frame steps
                # instead of dropping frames and mis-placing gate=1
                m_max = -(-m_req // 64) * 64
        n_mel = items[0]["mel"].shape[1]
        mels = np.zeros((B, m_max, n_mel), np.float32)
        mel_lengths = np.zeros((B,), np.int32)
        gate = np.zeros((B, m_max), np.float32)
        pres_prev = np.zeros((B,), np.float32)
        cont_next = np.zeros((B,), np.float32)
        for i, it in enumerate(items):
            mel = it["mel"]
            seg = segments[i] if segments is not None else None
            if seg is not None:
                start = seg.seg_idx * cfg.max_segment_frames
                mel = mel[start:start + cfg.max_segment_frames]
                pres_prev[i] = float(seg.seg_idx > 0)
                cont_next[i] = float(seg.seg_idx < seg.n_segs - 1)
            n = min(mel.shape[0], m_max)
            mels[i, :n] = mel[:n]
            mel_lengths[i] = n
            if cont_next[i] == 0.0:   # gate only on the final segment
                gate[i, max(n - 1, 0):] = 1.0
        out["mels"] = mels
        out["mel_lengths"] = mel_lengths
        out["gate_target"] = gate
        out["pres_prev_state"] = pres_prev
        out["cont_next_iter"] = cont_next

    if "durations" in items[0] and "text" in out:
        if segments is not None and any(s.n_segs > 1 for s in segments):
            raise NotImplementedError(
                "durations + TBPTT segments: whole-utterance durations "
                "cannot be refit to a mid-utterance segment (the NAR "
                "models collate full utterances)")
        # refit to the bucketed text width and the collated mel length so
        # length_regulate sees a consistent batch
        N = out["text"].shape[1]
        durs = np.zeros((B, N), np.int32)
        for i, it in enumerate(items):
            durs[i] = fit_durations(it["durations"], N,
                                    int(out["mel_lengths"][i]))
        out["durations"] = durs
        for src, dst in (("char_f0", "f0"), ("char_energy", "energy")):
            if src in items[0]:
                arr = np.zeros((B, N), np.float32)
                for i, it in enumerate(items):
                    v = np.asarray(it[src])[:N]
                    arr[i, : len(v)] = v
                out[dst] = arr
        # frame-rate prosody for the decoder's conditioning (the reference
        # conditions its decoder flow on [voiced, f0, energy] at frame
        # rate, untts/model.py:437,538; the char averages above feed the
        # predictors and VarGlow)
        m_pad = out["mels"].shape[1] if "mels" in out else 0
        for src, dst in (("f0", "frame_f0"), ("energy", "frame_energy"),
                         ("voiced", "frame_voiced")):
            if src in items[0] and m_pad:
                arr = np.zeros((B, m_pad), np.float32)
                for i, it in enumerate(items):
                    v = np.asarray(it[src], np.float32)[:m_pad]
                    arr[i, : len(v)] = v
                out[dst] = arr

    if "speaker_id" in items[0]:
        out["speaker_id"] = np.asarray([it["speaker_id"] for it in items],
                                       np.int32)
    if "emotion_id" in items[0]:
        C = cfg.n_emotion_classes
        ids = np.asarray([it["emotion_id"] for it in items], np.int32)
        unknown = (ids < 0) | (ids >= C)
        out["emotion_id"] = np.where(unknown, C, ids).astype(np.int32)
        onehot = np.zeros((len(items), C), np.float32)
        known = np.nonzero(~unknown)[0]
        onehot[known, ids[known]] = 1.0
        out["emotion_onehot"] = onehot
    if "sylps" in items[0]:
        out["sylps"] = np.asarray([it["sylps"] for it in items], np.float32)
    if "torchmoji" in items[0]:
        out["torchmoji"] = np.stack([it["torchmoji"] for it in items])
    out["audiopath"] = [it["audiopath"] for it in items]
    return out


def global_bucket_shapes(dataset: "TTSDataset", segs: Sequence[Segment],
                         cfg: DataConfig) -> Tuple[int, int]:
    """(text width, mel width) of the global batch of ``segs``, from
    metadata only: mel lengths from the length cache, text lengths from the
    tokenizer; no audio or mel is loaded. Every rank computes the same
    widths for the same segments, with collate's own rules (the buckets,
    and past the largest one 32-token and 64-frame steps)."""
    t_req = max(dataset.text_length(s.file_idx) for s in segs)
    m_req = max(min(dataset.mel_frame_length(s.file_idx)
                    - s.seg_idx * cfg.max_segment_frames,
                    cfg.max_segment_frames) for s in segs)
    t_pad = bucket_size(t_req, cfg.text_buckets)
    if t_pad < t_req:
        t_pad = -(-t_req // 32) * 32
    m_pad = bucket_size(m_req, cfg.mel_buckets)
    if m_pad < m_req:
        m_pad = -(-m_req // 64) * 64
    return (t_pad, m_pad)


def collate_local_shard(dataset: "TTSDataset", segs: Sequence[Segment],
                        cfg: DataConfig, process_index: int,
                        process_count: int) -> Dict[str, np.ndarray]:
    """This rank's rows of the global batch of ``segs`` (rows ``[i * B/n,
    (i + 1) * B/n)``), loading only them, padded to the global batch's
    widths (:func:`global_bucket_shapes`): padded to its own widths a rank
    would change the shape of the gate loss's plain mean."""
    B = len(segs)
    if B % process_count:
        raise ValueError(f"global batch {B} is not divisible by the "
                         f"{process_count} ranks")
    per = B // process_count
    pad = global_bucket_shapes(dataset, segs, cfg)
    local = list(segs[process_index * per: (process_index + 1) * per])
    return collate([dataset[s.file_idx] for s in local], cfg, segments=local,
                   pad_to=pad)

"""Mel2Samp, the vocoder training dataset (cookietts_tpu/data/mel2samp.py).

Host-side numpy, as in the JAX package; mels come from the port's
``TacotronSTFT.mel_spectrogram_np`` and GTA alignment from the numpy
``ops/dtw.py``. Capability rebuild of CookieTTS/_4_mtw/waveglow/mel2samp.py:121-434:

- map-file entries ``wav|mel|speaker`` (GTA output) or plain wav lists.
- random fixed-length segments with silence rejection: retry up to 20
  times until segment std > exp(min_log_std) (mel2samp.py:283-289).
- ``load_mel_from_disk`` is a PROBABILITY of using the GTA mel instead of
  a ground-truth mel (mel2samp.py:295).
- GTA offset parsing from ``.mel{offset}.npy`` filenames (extremeGTA).
- logvar-channel support ([2*n_mel, T] GTA dumps -> first half).
- optional DTW alignment of the GTA mel to the GT mel with max-L1/MSE
  file rejection (mel2samp.py:320-331).
- short files are padded with silence (-11.5129 log-mel) like the
  reference's get_segment (mel2samp.py:243-259).

Layout is time-major: mel [T_mel, n_mel]; audio [T].
"""
from __future__ import annotations

import dataclasses
import os
import random
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..audio.stft import TacotronSTFT
from ..ops.dtw import dtw_align
from . import audio_io

LOG_MEL_SILENCE = -11.512925


class FileNotSuitableException(Exception):
    pass


@dataclasses.dataclass
class Mel2SampConfig:
    segment_length: int = 24000
    sampling_rate: int = 48000
    filter_length: int = 2400
    hop_length: int = 600
    win_length: int = 2400
    n_mel_channels: int = 160
    mel_fmin: float = 0.0
    mel_fmax: float = 16000.0
    min_log_std: float = -6.0
    load_mel_from_disk: float = 0.0      # probability of using GTA mel
    use_logvar_channels: bool = False
    load_from_disk_dtw: bool = True
    dtw_scale_factor: int = 5
    dtw_range: int = 3
    max_l1_err: float = 0.0              # 0 disables rejection
    max_mse_err: float = 0.0
    # hidden-state conditioning: train the vocoder on the TTS model's
    # decoder hidden states instead of mels (reference mel2samp.py:274-292)
    load_hidden_from_disk: bool = False
    # GaussianBlur mel augmentation (reference mel2samp.py:71-78)
    blur_prob: float = 0.0
    blur_strength: float = 1.0


def gaussian_blur_mel(mel: np.ndarray, strength: float = 1.0) -> np.ndarray:
    """Blur a [T, n_mel] mel along the CHANNEL axis with a CDF-binned
    gaussian kernel + reflect padding (reference GaussianBlur,
    mel2samp.py:71-78 blurs the 'height' axis)."""
    from scipy.stats import norm
    r = max(int(strength * 3), 1)
    ks = np.array([norm.cdf(i + 0.5, scale=strength)
                   - norm.cdf(i - 0.5, scale=strength)
                   for i in range(-r, r + 1)], np.float64)
    pad = (len(ks) - 1) // 2
    x = np.pad(mel, ((0, 0), (pad, pad)), mode="reflect")
    out = np.apply_along_axis(
        lambda row: np.convolve(row, ks, mode="valid"), 1, x)
    return out.astype(mel.dtype)


def load_map_file(path: str
                  ) -> List[Tuple[str, Optional[str], int, Optional[str]]]:
    """Parse ``wav|mel|speaker[|hidden]`` lines (GTA map files)."""
    entries = []
    with open(path) as f:
        for ln in f:
            if not ln.strip():
                continue
            parts = ln.strip().split("|")
            wav = parts[0]
            mel = parts[1] if len(parts) > 1 and parts[1] else None
            spk = int(parts[2]) if len(parts) > 2 and parts[2] else 0
            hdn = parts[3] if len(parts) > 3 and parts[3] else None
            entries.append((wav, mel, spk, hdn))
    return entries


class Mel2Samp:
    def __init__(self, entries: Sequence[Tuple[str, Optional[str], int]],
                 cfg: Mel2SampConfig, seed: int = 1234):
        self.entries = list(entries)
        self.cfg = cfg
        self.rng = random.Random(seed)
        self.stft = TacotronSTFT(
            cfg.filter_length, cfg.hop_length, cfg.win_length,
            cfg.n_mel_channels, cfg.sampling_rate, cfg.mel_fmin,
            cfg.mel_fmax, device="cpu")

    def __len__(self):
        return len(self.entries)

    def get_mel(self, audio: np.ndarray) -> np.ndarray:
        return self.stft.mel_spectrogram_np(audio).astype(np.float32)

    def _segment(self, audio: np.ndarray, mel: Optional[np.ndarray]
                 ) -> Tuple[np.ndarray, Optional[np.ndarray], int]:
        """Random aligned (audio, mel) segment w/ silence pad for shorts."""
        cfg = self.cfg
        seg = cfg.segment_length
        mel_seg = seg // cfg.hop_length + 1
        if len(audio) >= seg:
            max_mel_start = (len(audio) - seg) // cfg.hop_length - 1
            if mel is not None:
                # a GTA dump can run a few frames short of
                # len(audio)//hop (teacher-forcing length mismatch);
                # keep the random start inside the dumped frames so the
                # slice stays full-height whenever possible
                max_mel_start = min(max_mel_start, mel.shape[0] - mel_seg)
            mel_start = (self.rng.randint(0, max_mel_start)
                         if max_mel_start > 0 else 0)
            a0 = mel_start * cfg.hop_length
            audio = audio[a0:a0 + seg]
            if mel is not None:
                mel = mel[mel_start:mel_start + mel_seg]
        else:
            mel_start = 0
            audio = np.pad(audio, (0, seg - len(audio)))
        if mel is not None and mel.shape[0] < mel_seg:
            # static shapes: a short slice would make collate min-crop
            # every mel in the batch (audio stays seg long: silently
            # truncated supervision)
            pad = np.full((mel_seg - mel.shape[0], mel.shape[1]),
                          LOG_MEL_SILENCE, np.float32)
            mel = np.concatenate([mel, pad], axis=0)
        return audio, mel, mel_start

    def __getitem__(self, index: int) -> Dict[str, Any]:
        """Item loader with rejection resampling: a segment whose GTA
        mel misses the max_l1_err/max_mse_err gate substitutes a
        different random entry (the reference's FileNotSuitable loop —
        an uncaught raise here would kill a multi-hour run on one bad
        dump). After 10 substitutions the thresholds themselves are the
        problem; raise with that diagnosis."""
        rejected = []
        for _ in range(10):
            try:
                return self._load_item(index)
            except FileNotSuitableException as e:
                rejected.append(str(e))
                index = self.rng.randrange(len(self.entries))
        raise FileNotSuitableException(
            "10 consecutive segments rejected by max_l1_err/max_mse_err "
            f"({self.cfg.max_l1_err}/{self.cfg.max_mse_err}) — the "
            "thresholds reject (nearly) everything; loosen them or "
            f"regenerate the GTA dumps. Rejected: {rejected[:3]}...")

    def _load_item(self, index: int) -> Dict[str, Any]:
        cfg = self.cfg
        entry = self.entries[index]
        wav_path, mel_path, speaker = entry[0], entry[1], entry[2]
        hdn_path = entry[3] if len(entry) > 3 else None
        audio, sr = audio_io.load_wav(wav_path)
        if sr != cfg.sampling_rate:
            raise ValueError(f"{sr} SR doesn't match target "
                             f"{cfg.sampling_rate} SR ({wav_path})")

        if cfg.load_hidden_from_disk and hdn_path is not None:
            # condition on TTS decoder hidden states instead of mels
            # (reference mel2samp.py:274-292, '.hdn{offset}.npy' naming)
            hdn = np.load(hdn_path).astype(np.float32)
            if hdn.ndim == 2 and hdn.shape[0] < hdn.shape[1]:
                hdn = hdn.T                               # [T, C]
            stem = os.path.basename(hdn_path)
            if ".hdn" in stem and stem.endswith(".npy"):
                tail = stem.split(".hdn")[-1][:-4]
                if tail.isdigit():
                    audio = audio[int(tail):]
            threshold = float(np.exp(cfg.min_log_std)) * max(
                1e-5, float(np.abs(audio).max()))
            for _ in range(20):
                a_seg, h_seg, _ = self._segment(audio, hdn)
                if np.std(a_seg) > threshold:
                    break
            return {"audio": a_seg.astype(np.float32),
                    "mel": h_seg.astype(np.float32),
                    "speaker_id": speaker,
                    "audiopath": wav_path}

        use_gta = (mel_path is not None
                   and self.rng.random() < cfg.load_mel_from_disk)
        gta_mel = None
        if use_gta:
            gta_mel = np.load(mel_path).astype(np.float32)
            if gta_mel.ndim == 2 and gta_mel.shape[0] in (
                    cfg.n_mel_channels, 2 * cfg.n_mel_channels) \
                    and gta_mel.shape[0] < gta_mel.shape[1]:
                gta_mel = gta_mel.T        # tolerate [C, T] dumps
            if gta_mel.shape[1] == 2 * cfg.n_mel_channels:
                gta_mel = gta_mel[:, : cfg.n_mel_channels]  # drop logvar
            # extremeGTA offset encoded in the filename: '.mel{offset}.npy'
            # (GTAGenerator writes this; reference mel2samp.py:297-299)
            stem = os.path.basename(mel_path)
            if ".mel" in stem and stem.endswith(".npy"):
                tail = stem.split(".mel")[-1][:-4]
                if tail.isdigit():
                    audio = audio[int(tail):]

        # silence-rejecting random segment (20 tries)
        threshold = float(np.exp(cfg.min_log_std)) * max(
            1e-5, float(np.abs(audio).max()))
        for _ in range(20):
            a_seg, m_seg, mel_start = self._segment(audio, gta_mel)
            if np.std(a_seg) > threshold:
                break
        audio_seg, mel_seg = a_seg, m_seg

        if use_gta:
            mel = mel_seg
            if cfg.load_from_disk_dtw or cfg.max_l1_err or cfg.max_mse_err:
                gt = self.get_mel(audio_seg)[: mel.shape[0]]
                mel = mel[: gt.shape[0]]
                l1 = float(np.abs(mel - gt).mean())
                if cfg.max_l1_err and l1 > cfg.max_l1_err:
                    raise FileNotSuitableException(wav_path)
                if cfg.max_mse_err and float(((mel - gt) ** 2).mean()) \
                        > cfg.max_mse_err:
                    raise FileNotSuitableException(wav_path)
                if cfg.load_from_disk_dtw:
                    mel = dtw_align(mel[None], gt[None], cfg.dtw_scale_factor,
                                    cfg.dtw_range)[0]
        else:
            mel = self.get_mel(audio_seg)
            if cfg.blur_prob > 0.0 and self.rng.random() < cfg.blur_prob:
                mel = gaussian_blur_mel(mel, cfg.blur_strength)

        return {"audio": audio_seg.astype(np.float32),
                "mel": mel.astype(np.float32),
                "speaker_id": speaker,
                "audiopath": wav_path}


def collate_mel2samp(items: Sequence[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    """Stack fixed-length segments (shapes are already static)."""
    t_mel = min(it["mel"].shape[0] for it in items)
    return {
        "audio": np.stack([it["audio"] for it in items]),
        "mels": np.stack([it["mel"][:t_mel] for it in items]),
        "speaker_id": np.asarray([it["speaker_id"] for it in items],
                                 np.int32),
        "audiopath": [it["audiopath"] for it in items],
    }

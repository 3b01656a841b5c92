"""Noisy/clean pair dataset for HiFiGAN-Denoiser training: a copy of
cookietts_tpu/data/denoiser_data.py (numpy only) over the port's audio_io, so
the same seed gives the same pairs bit for bit (where the JAX package
resamples with scipy too). A rebuild of
CookieTTS/_4_mtw/HiFiGAN_Denoiser/mel2samp.py (noisify_audio, :216-248).
The reference's exact corruption order, which low-passes ONLY the clean copy
and then adds the folder noise FULL-BAND on top (:242-247), is preserved:

1. "lazy low-pass" of the clean segment — resample down to a
   uniform-random rate and back (:242-244),
2. white noise with log10-uniform std (:246),
3. a random segment of a noise-folder file scaled to a uniform-random
   target SNR, added un-low-passed (:231-239, :247; skipped when no
   noise files are given),

then clamped to [-1, 1]. Items are fixed-length segments.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from .audio_io import load_wav, resample


@dataclasses.dataclass(frozen=True)
class DenoiserDataConfig:
    segment_length: int = 8400
    sampling_rate: int = 48000
    min_snr_db: float = 5.0
    max_snr_db: float = 30.0
    min_white_noise_log10_std: float = -4.0
    max_white_noise_log10_std: float = -1.0
    min_augmented_sample_rate: int = 22050
    max_augmented_sample_rate: int = 48000


class DenoiserDataset:
    """items: {noisy [T], clean [T]} float32 at ``segment_length``."""

    def __init__(self, clean_files: Sequence[str],
                 cfg: DenoiserDataConfig,
                 noise_files: Sequence[str] = (), seed: int = 0):
        if not clean_files:
            raise ValueError("no clean files")
        self.clean_files = list(clean_files)
        self.noise_files = list(noise_files)
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.clean_files)

    def _segment(self, audio: np.ndarray) -> np.ndarray:
        L = self.cfg.segment_length
        if audio.shape[0] >= L:
            start = int(self.rng.integers(0, audio.shape[0] - L + 1))
            return audio[start:start + L]
        return np.pad(audio, (0, L - audio.shape[0]))

    def _noise_segment(self, n: int) -> np.ndarray:
        # reference loops until it draws a long-enough file (:219-225);
        # tiling short files avoids the unbounded loop. Empty/header-only
        # wavs fall back to silence (the white-noise term still corrupts).
        path = self.noise_files[int(self.rng.integers(
            0, len(self.noise_files)))]
        noise, _ = load_wav(path, target_sr=self.cfg.sampling_rate)
        if noise.shape[0] == 0:
            return np.zeros(n, np.float32)
        if noise.shape[0] < n:
            noise = np.tile(noise, int(np.ceil(n / noise.shape[0])))
        start = int(self.rng.integers(0, noise.shape[0] - n + 1))
        return noise[start:start + n].astype(np.float32)

    def noisify(self, clean: np.ndarray) -> np.ndarray:
        cfg = self.cfg
        noisy = clean.astype(np.float32).copy()

        # lazy low-pass: down/up resample (:242-244). The rate rounds to
        # a 100 Hz grid: an arbitrary integer (the reference draws one,
        # but librosa's kaiser resampler takes any ratio) can be coprime
        # with sampling_rate, which turns the scipy resample_poly
        # fallback into a ~500k-tap polyphase — seconds per item
        aug_sr = int(round(self.rng.uniform(
            cfg.min_augmented_sample_rate,
            cfg.max_augmented_sample_rate) / 100.0) * 100)
        if aug_sr < cfg.sampling_rate:
            down = resample(noisy, cfg.sampling_rate, aug_sr)
            noisy = resample(down, aug_sr, cfg.sampling_rate)
            if noisy.shape[0] < clean.shape[0]:
                noisy = np.pad(noisy, (0, clean.shape[0] - noisy.shape[0]))
            noisy = noisy[: clean.shape[0]]

        # white noise with log10-uniform std (:246)
        log_std = self.rng.uniform(cfg.min_white_noise_log10_std,
                                   cfg.max_white_noise_log10_std)
        noisy = noisy + self.rng.standard_normal(
            clean.shape[0]).astype(np.float32) * (10.0 ** log_std)

        # noise-folder mix at target SNR (:231-239)
        if self.noise_files:
            noise = self._noise_segment(clean.shape[0])
            snr_db = self.rng.uniform(cfg.min_snr_db, cfg.max_snr_db)
            target = 10.0 ** (snr_db / 10.0)
            n_pow = float(np.sum((noise - noise.mean()) ** 2)) + 1e-12
            c_pow = float(np.sum((clean - clean.mean()) ** 2)) + 1e-12
            noisy = noisy + noise * np.sqrt(c_pow / (n_pow * target))

        return np.clip(noisy, -1.0, 1.0).astype(np.float32)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        audio, _ = load_wav(self.clean_files[i % len(self.clean_files)],
                            target_sr=self.cfg.sampling_rate)
        clean = self._segment(audio.astype(np.float32))
        return {"clean": clean, "noisy": self.noisify(clean)}


def collate_denoiser(items: List[Dict[str, np.ndarray]]
                     ) -> Dict[str, np.ndarray]:
    return {k: np.stack([it[k] for it in items]).astype(np.float32)
            for k in ("noisy", "clean")}

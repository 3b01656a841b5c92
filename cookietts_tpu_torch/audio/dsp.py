"""Host-side audio DSP for the data pipeline: resampling, filtering,
silence trimming, and BS.1770 loudness measurement/normalization.

Capability parity targets:
- high-pass + resample + multi-pass trim
  (reference: CookieTTS/_1_preprocess/scripts/audio_preprocessing.py:78-204)
- multi-pass spectrogram-margin trim used by the dataset
  (reference: CookieTTS/utils/dataset/data_utils.py:542-569)
- BS.1770 loudness normalize to target LUFS via pyloudnorm
  (reference: CookieTTS/utils/dataset/data_utils.py:786-803)

These run per-file in host worker processes (numpy/scipy); the batched
mel frontend lives in :mod:`..audio.stft`. A copy of cookietts_tpu/audio/dsp.py
(no JAX there): its ``_k_weighting_coeffs`` is what the feature frontend's
FIR (audio/features.py) is cut from. pyloudnorm is not a dependency, so
BS.1770-4 (K-weighting + gated blocks) is implemented here directly.
"""
from __future__ import annotations

import numpy as np
from scipy import signal


# ---------------------------------------------------------------------------
# Resampling / filtering
# ---------------------------------------------------------------------------

def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase FIR resampling (kaiser-windowed sinc)."""
    if orig_sr == target_sr:
        return audio
    from math import gcd

    g = gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    return signal.resample_poly(audio, up, down).astype(audio.dtype)


def butter_highpass(audio: np.ndarray, sr: int, cutoff_hz: float,
                    order: int = 2) -> np.ndarray:
    """Zero-phase Butterworth high-pass (the preprocess stage runs two of
    these, e.g. 150 Hz then 40 Hz, to kill rumble)."""
    sos = signal.butter(order, cutoff_hz, btype="highpass", fs=sr, output="sos")
    return signal.sosfiltfilt(sos, audio).astype(audio.dtype)


def dc_offset_removal(audio: np.ndarray) -> np.ndarray:
    return (audio - np.mean(audio)).astype(audio.dtype)


# ---------------------------------------------------------------------------
# Silence trimming
# ---------------------------------------------------------------------------

def _frame_db(audio: np.ndarray, window_length: int, hop_length: int,
              ref: str = "amax") -> np.ndarray:
    """Per-frame dB level relative to `ref` ('amax' = peak amplitude)."""
    n = len(audio)
    if n < window_length:
        return np.array([0.0])
    n_frames = 1 + (n - window_length) // hop_length
    idx = np.arange(n_frames)[:, None] * hop_length + np.arange(window_length)[None, :]
    frames = audio[idx]
    rms = np.sqrt(np.mean(frames**2, axis=1) + 1e-12)
    if ref == "amax":
        ref_val = np.max(np.abs(audio)) + 1e-12
    else:
        ref_val = float(ref)
    return 20.0 * np.log10(rms / ref_val + 1e-12)


def trim_silence(
    audio: np.ndarray,
    sr: int,
    top_db: float = 46.0,
    window_length: int = 2048,
    hop_length: int = 256,
    margin_left: float = 0.0125,
    margin_right: float = 0.0125,
    ref: str = "amax",
) -> np.ndarray:
    """One trim pass: drop leading/trailing audio quieter than top_db below
    ref, keeping a margin (seconds) on each side."""
    db = _frame_db(audio, window_length, hop_length, ref)
    above = np.nonzero(db > -top_db)[0]
    if len(above) == 0:
        return audio
    start = max(0, int(above[0] * hop_length - margin_left * sr))
    end = min(len(audio), int(above[-1] * hop_length + window_length + margin_right * sr))
    return audio[start:end]


def trim_silence_multipass(
    audio: np.ndarray,
    sr: int,
    top_db=(50, 46, 46, 46, 46),
    window_length=(8192, 4096, 2048, 1024, 512),
    hop_length=(1024, 512, 256, 128, 128),
    margin_left=(0.0125,) * 5,
    margin_right=(0.0125,) * 5,
    ref=("amax",) * 5,
) -> np.ndarray:
    """Multi-pass coarse→fine trim (same 5-pass schedule as the reference's
    defaults, tacotron2_tm/hparams.py:126-132)."""
    for td, wl, hl, ml, mr, r in zip(top_db, window_length, hop_length,
                                     margin_left, margin_right, ref):
        audio = trim_silence(audio, sr, td, wl, hl, ml, mr, r)
        if len(audio) < wl:
            break
    return audio


# ---------------------------------------------------------------------------
# BS.1770-4 loudness
# ---------------------------------------------------------------------------

def _k_weighting_coeffs(sr: int):
    """K-weighting pre-filter: stage-1 high-shelf + stage-2 high-pass
    biquads, redesigned for arbitrary sample rate via the analog prototypes
    from ITU-R BS.1770-4 (same approach as pyloudnorm)."""
    # Stage 1: spherical-head high shelf
    f0, G, Q = 1681.974450955533, 3.999843853973347, 0.7071752369554196
    K = np.tan(np.pi * f0 / sr)
    Vh = 10.0 ** (G / 20.0)
    Vb = Vh ** 0.4996667741545416
    a0 = 1.0 + K / Q + K * K
    b_shelf = np.array([
        (Vh + Vb * K / Q + K * K) / a0,
        2.0 * (K * K - Vh) / a0,
        (Vh - Vb * K / Q + K * K) / a0,
    ])
    a_shelf = np.array([1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / Q + K * K) / a0])
    # Stage 2: high-pass
    f0, Q = 38.13547087602444, 0.5003270373238773
    K = np.tan(np.pi * f0 / sr)
    a_hp = np.array([
        1.0,
        2.0 * (K * K - 1.0) / (1.0 + K / Q + K * K),
        (1.0 - K / Q + K * K) / (1.0 + K / Q + K * K),
    ])
    b_hp = np.array([1.0, -2.0, 1.0])
    return (b_shelf, a_shelf), (b_hp, a_hp)


def measure_loudness_lufs(audio: np.ndarray, sr: int,
                          block_s: float = 0.400, overlap: float = 0.75) -> float:
    """Integrated loudness (LUFS) per ITU-R BS.1770-4 with -70 LUFS absolute
    and -10 LU relative gating. Mono input [T] (or [C, T] multichannel)."""
    x = np.atleast_2d(audio.astype(np.float64))  # [C, T]
    (b1, a1), (b2, a2) = _k_weighting_coeffs(sr)
    for c in range(x.shape[0]):
        x[c] = signal.lfilter(b2, a2, signal.lfilter(b1, a1, x[c]))

    step = int(sr * block_s * (1 - overlap))
    blk = int(sr * block_s)
    if x.shape[1] < blk:
        ms = np.mean(x**2, axis=1, keepdims=True)  # single undersized block
    else:
        n_blocks = 1 + (x.shape[1] - blk) // step
        idx = np.arange(n_blocks)[:, None] * step + np.arange(blk)[None, :]
        ms = np.stack([np.mean(x[c][idx] ** 2, axis=1) for c in range(x.shape[0])])
    # channel weights: 1.0 for mono/stereo front channels
    block_loudness = -0.691 + 10.0 * np.log10(np.sum(ms, axis=0) + 1e-30)

    gated = block_loudness > -70.0
    if not np.any(gated):
        return -np.inf
    rel_thresh = (
        -0.691 + 10.0 * np.log10(np.sum(np.mean(ms[:, gated], axis=1)) + 1e-30) - 10.0
    )
    gated &= block_loudness > rel_thresh
    if not np.any(gated):
        return -np.inf
    return float(-0.691 + 10.0 * np.log10(np.sum(np.mean(ms[:, gated], axis=1)) + 1e-30))


def normalize_loudness(audio: np.ndarray, sr: int, target_lufs: float = -27.0,
                       max_gain_db: float = 60.0) -> np.ndarray:
    """Scale audio to the target integrated loudness (no limiting)."""
    current = measure_loudness_lufs(audio, sr)
    if not np.isfinite(current):
        return audio
    gain_db = np.clip(target_lufs - current, -max_gain_db, max_gain_db)
    return (audio * 10.0 ** (gain_db / 20.0)).astype(audio.dtype)

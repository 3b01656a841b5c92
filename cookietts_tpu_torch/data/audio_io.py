"""Host-side audio I/O + preprocessing DSP (numpy/scipy, no librosa).

Self-contained rebuilds of what the reference outsources to
soundfile/librosa/pyloudnorm/pyworld:

- :func:`load_wav` / :func:`save_wav` — int-PCM normalize on read
  (reference utils/dataset/utils.py:7-52: int16/int32 -> [-1,1] floats,
  NaN/Inf asserts), scipy.io.wavfile under the hood.
- :func:`remove_dc_offset`, :func:`resample`, :func:`butter_highpass` —
  the preprocess chain (reference scripts/audio_preprocessing.py:138-201).
- :func:`trim_silence` — multi-pass dB-threshold trim with margins
  (reference's 5-pass librosa.effects.trim loop, data_utils.py:542-569).
- :func:`bs1770_loudness` / :func:`loudness_normalize` — ITU-R BS.1770-4
  K-weighted gated loudness (reference uses pyln, data_utils.py:786-803).
- :func:`estimate_f0_dio` — the DIO f0 track (data/dio.py) with the
  reference's post-processing (data_utils.py:815-838);
  :func:`estimate_f0_autocorr` — frame-wise autocorrelation f0 +
  voicedness, the cheaper stand-in.
- :func:`count_syllables` — heuristic vowel-group counter (stand-in for
  the ``syllables`` package, data_utils.py:856-859).

Resampling, the high-pass, the trim bounds and the loudness take the C++
kernels of :mod:`.native` when that library is built (the JAX package's
rule), numpy/scipy otherwise; ``COOKIETTS_DISABLE_NATIVE=1`` forces
numpy/scipy.
"""
from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import numpy as np
from scipy import signal
from scipy.io import wavfile


def _native():
    """The C++ kernel library (data/native.py) if it is built, else None.
    Set COOKIETTS_DISABLE_NATIVE=1 to force the numpy/scipy path."""
    if os.environ.get("COOKIETTS_DISABLE_NATIVE"):
        return None
    from . import native
    return native if native.available() else None


def load_wav(path: str, target_sr: Optional[int] = None,
             check_finite: bool = True) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 mono audio in [-1, 1], sample_rate)."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        audio = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) / 128.0
    else:
        audio = data.astype(np.float32)
    if audio.ndim > 1:
        audio = audio.mean(axis=1)
    if check_finite and not np.isfinite(audio).all():
        raise ValueError(f"non-finite samples in {path}")
    if target_sr is not None and target_sr != sr:
        audio = resample(audio, sr, target_sr)
        sr = target_sr
    return audio, sr


def save_wav(path: str, audio: np.ndarray, sr: int,
             dtype=np.int16) -> None:
    audio = np.clip(audio, -1.0, 1.0)
    if dtype == np.int16:
        wavfile.write(path, sr, (audio * 32767.0).astype(np.int16))
    else:
        wavfile.write(path, sr, audio.astype(np.float32))


def remove_dc_offset(audio: np.ndarray) -> np.ndarray:
    return audio - np.mean(audio)


def resample(audio: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling — same role as librosa.resample. Uses the
    native windowed-sinc kernel when built, scipy otherwise."""
    if sr == target_sr:
        return audio
    nat = _native()
    if nat is not None:
        return nat.resample(audio, int(sr), int(target_sr)).astype(
            audio.dtype)
    g = np.gcd(int(sr), int(target_sr))
    return signal.resample_poly(audio, target_sr // g, sr // g).astype(
        audio.dtype)


def butter_highpass(audio: np.ndarray, sr: int, cutoff_hz: float,
                    order: int = 2) -> np.ndarray:
    """Zero-phase butterworth high-pass (reference uses sosfilt chains of
    150 Hz then 40 Hz high-passes, audio_preprocessing.py:128-137)."""
    sos = signal.butter(order, cutoff_hz, btype="highpass", fs=sr,
                        output="sos")
    nat = _native()
    if nat is not None:
        return nat.sos_filtfilt(audio, sos).astype(audio.dtype)
    return signal.sosfiltfilt(sos, audio).astype(audio.dtype)


def _frame_rms_db(audio: np.ndarray, frame: int, hop: int) -> np.ndarray:
    n = max(1 + (len(audio) - frame) // hop, 1)
    idx = np.arange(n)[:, None] * hop + np.arange(frame)[None, :]
    idx = np.minimum(idx, len(audio) - 1)
    frames = audio[idx]
    rms = np.sqrt(np.mean(frames**2, axis=1) + 1e-12)
    return 20.0 * np.log10(rms + 1e-12)


def trim_silence(audio: np.ndarray, sr: int, top_db: float = 45.0,
                 frame_length: int = 2048, hop_length: int = 512,
                 margin_left: float = 0.0, margin_right: float = 0.0,
                 n_passes: int = 1) -> np.ndarray:
    """Energy trim relative to peak frame (librosa.effects.trim semantics).

    The reference runs up to 5 passes with different windows/thresholds
    (data_utils.py:542-569); pass a list via successive calls or n_passes.
    """
    out = audio
    nat = _native()
    for _ in range(max(n_passes, 1)):
        if len(out) < frame_length:
            break
        if nat is not None:
            s, e = nat.trim_bounds(out, frame_length, hop_length, top_db)
            s = max(int(s - margin_left * sr), 0)
            e = min(int(e + margin_right * sr), len(out))
            out = out[s:e]
            continue
        db = _frame_rms_db(out, frame_length, hop_length)
        keep = np.nonzero(db > (db.max() - top_db))[0]
        if len(keep) == 0:
            break
        start = max(int(keep[0] * hop_length - margin_left * sr), 0)
        end = min(int((keep[-1] + 1) * hop_length + frame_length
                      + margin_right * sr), len(out))
        out = out[start:end]
    return out


# -- BS.1770-4 loudness -----------------------------------------------------

def _k_weighting_sos(sr: int) -> np.ndarray:
    """K-weighting = shelving (stage 1) + RLB high-pass (stage 2),
    bilinear-transformed from the BS.1770-4 analog prototypes."""
    # stage 1: high-shelf  (f0=1681.97 Hz, G=+3.9998 dB, Q=0.7072)
    db, f0, Q = 3.999843853973347, 1681.974450955533, 0.7071752369554196
    K = np.tan(np.pi * f0 / sr)
    Vh = 10.0 ** (db / 20.0)
    Vb = Vh ** 0.4996667741545416
    a0 = 1.0 + K / Q + K * K
    b_shelf = np.array([
        (Vh + Vb * K / Q + K * K) / a0,
        2.0 * (K * K - Vh) / a0,
        (Vh - Vb * K / Q + K * K) / a0])
    a_shelf = np.array([1.0, 2.0 * (K * K - 1.0) / a0,
                        (1.0 - K / Q + K * K) / a0])
    # stage 2: high-pass (f0=38.135 Hz, Q=0.5003)
    f0, Q = 38.13547087602444, 0.5003270373238773
    K = np.tan(np.pi * f0 / sr)
    a0 = 1.0 + K / Q + K * K
    b_hp = np.array([1.0, -2.0, 1.0])
    a_hp = np.array([1.0, 2.0 * (K * K - 1.0) / a0,
                     (1.0 - K / Q + K * K) / a0])
    b_hp = b_hp / a0 * 1.0
    sos1 = np.concatenate([b_shelf, a_shelf])
    sos2 = np.concatenate([b_hp, a_hp])
    return np.stack([sos1, sos2])


def bs1770_loudness(audio: np.ndarray, sr: int) -> float:
    """Integrated LUFS with -70 LUFS absolute + -10 LU relative gating."""
    nat = _native()
    if nat is not None:
        return nat.bs1770_loudness(audio, int(sr))
    x = audio.astype(np.float64)
    sos = _k_weighting_sos(sr)
    for s in sos:
        x = signal.lfilter(s[:3], s[3:], x)
    block = int(0.400 * sr)
    hop = int(0.100 * sr)
    if len(x) < block:
        ms = np.mean(x**2) + 1e-12
        return float(-0.691 + 10.0 * np.log10(ms))
    n = 1 + (len(x) - block) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(block)[None, :]
    ms = np.mean(x[idx] ** 2, axis=1) + 1e-12
    lk = -0.691 + 10.0 * np.log10(ms)
    gated = ms[lk > -70.0]
    if len(gated) == 0:
        return -70.0
    rel_thresh = -0.691 + 10.0 * np.log10(np.mean(gated)) - 10.0
    gated2 = ms[(lk > -70.0) & (lk > rel_thresh)]
    if len(gated2) == 0:
        gated2 = gated
    return float(-0.691 + 10.0 * np.log10(np.mean(gated2)))


def loudness_normalize(audio: np.ndarray, sr: int,
                       target_lufs: float = -27.0,
                       max_gain_db: float = 30.0) -> np.ndarray:
    """Gain to target LUFS (reference data_utils.py:786-803 w/ pyln)."""
    lufs = bs1770_loudness(audio, sr)
    gain_db = np.clip(target_lufs - lufs, -max_gain_db, max_gain_db)
    out = audio * (10.0 ** (gain_db / 20.0))
    peak = np.abs(out).max() + 1e-9
    if peak > 1.0:
        out = out / peak
    return out.astype(audio.dtype)


# -- f0 / voicedness ----------------------------------------------------------

def estimate_f0_dio(audio: np.ndarray, sr: int, hop_length: int = 512,
                    f0_floor: float = 71.0, f0_ceil: float = 800.0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """DIO pitch track with the reference's post-processing
    (data_utils.py:815-838): pyworld-default limits 71-800 Hz, frame
    period = one mel hop, clamp to [0, 800], voiced = f0 > 3 Hz, and
    unvoiced frames FILLED with the voiced mean (so the f0 feature is
    smooth for the predictors). Returns (f0[n], voiced[n])."""
    from .dio import dio
    f0, _ = dio(np.asarray(audio, np.float64), sr,
                f0_floor=f0_floor, f0_ceil=f0_ceil,
                frame_period_ms=hop_length / sr * 1000.0)
    f0 = np.clip(f0, 0.0, 800.0)
    voiced = f0 > 3.0
    if voiced.any():
        f0 = np.where(voiced, f0, f0[voiced].mean())
    return f0.astype(np.float32), voiced


def estimate_f0_autocorr(audio: np.ndarray, sr: int,
                         hop_length: int = 512, frame_length: int = 2048,
                         f0_min: float = 55.0, f0_max: float = 760.0,
                         voiced_thresh: float = 0.3
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Frame-wise autocorrelation pitch track -> (f0[n], voiced[n]).

    Stand-in for pyworld DIO (reference data_utils.py:815-838); f0=0 on
    unvoiced frames like the reference's masked output.
    """
    n = max(1 + (len(audio) - frame_length) // hop_length, 1)
    idx = np.arange(n)[:, None] * hop_length + np.arange(frame_length)[None, :]
    idx = np.minimum(idx, len(audio) - 1)
    frames = audio[idx] * np.hanning(frame_length)
    # FFT autocorrelation
    spec = np.fft.rfft(frames, n=2 * frame_length, axis=1)
    ac = np.fft.irfft(np.abs(spec) ** 2, axis=1)[:, :frame_length]
    ac0 = ac[:, 0] + 1e-9
    lag_min = int(sr / f0_max)
    lag_max = min(int(sr / f0_min), frame_length - 1)
    window = ac[:, lag_min:lag_max]
    best = np.argmax(window, axis=1) + lag_min
    strength = window.max(axis=1) / ac0
    f0 = sr / best.astype(np.float64)
    voiced = strength > voiced_thresh
    f0 = np.where(voiced, f0, 0.0)
    return f0.astype(np.float32), voiced


_VOWEL_GROUP = re.compile(r"[aeiouy]+", re.IGNORECASE)


def count_syllables(text: str) -> int:
    """Heuristic per-word vowel-group syllable count (>=1 per word)."""
    total = 0
    for word in re.findall(r"[A-Za-z']+", text):
        groups = len(_VOWEL_GROUP.findall(word))
        if word.lower().endswith("e") and groups > 1 \
                and not word.lower().endswith(("le", "ee", "ye")):
            groups -= 1
        total += max(groups, 1)
    return total

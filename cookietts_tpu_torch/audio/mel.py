"""Mel filterbank construction (host-side numpy; the result is a constant
matrix baked into jitted mel ops).

Implements the Slaney-style mel scale and filter normalization, numerically
matching ``librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax)`` with its
default ``htk=False, norm='slaney'`` — the exact basis the reference bakes
into its mel frontend (reference: CookieTTS/utils/audio/stft.py:163-166).
librosa is not available in this environment, so the construction is done
from the published formulas directly.
"""
from __future__ import annotations

import numpy as np

_F_SP = 200.0 / 3  # Hz per mel below the break frequency
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0  # step size above the break frequency


def hz_to_mel(freq):
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    freq = np.asarray(freq, dtype=np.float64)
    mels = freq / _F_SP
    log_region = freq >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(freq, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )
    return mels


def mel_to_hz(mel):
    mel = np.asarray(mel, dtype=np.float64)
    freqs = _F_SP * mel
    log_region = mel >= _MIN_LOG_MEL
    freqs = np.where(
        log_region,
        _MIN_LOG_HZ * np.exp(_LOGSTEP * (np.maximum(mel, _MIN_LOG_MEL) - _MIN_LOG_MEL)),
        freqs,
    )
    return freqs


def mel_filterbank(
    sampling_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank, shape [n_mels, n_fft//2 + 1]."""
    if fmax is None:
        fmax = float(sampling_rate) / 2
    fft_freqs = np.linspace(0.0, float(sampling_rate) / 2, n_fft // 2 + 1)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)  # [n_mels + 2]

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]  # [n_mels+2, n_freq]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney normalization: each filter integrates to ~2/bandwidth.
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(dtype)

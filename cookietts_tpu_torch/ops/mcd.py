"""Mel-cepstral distortion and f0 comparison metrics (cookietts_tpu/ops/
mcd.py, copied: host numpy and scipy, no tensor of the port's).

MCD and the f0 differences of CookieTTS's tacotron2 ``metric.py``, whose
own version calls a ``cepstrum_from_mel`` that no longer exists upstream.
They run on evaluation batches, not in the train step.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.fft import dct


def cepstrum_from_mel(log_mel: np.ndarray, n_mfcc: int = 13) -> np.ndarray:
    """[T, n_mel] log-mel -> [T, n_mfcc] mel cepstrum (DCT-II, ortho)."""
    return dct(np.asarray(log_mel, np.float64), type=2, axis=-1,
               norm="ortho")[..., :n_mfcc]


_MCD_CONST = 10.0 / np.log(10.0) * np.sqrt(2.0)


def mcd(mel_a: np.ndarray, mel_b: np.ndarray, n_mfcc: int = 13,
        exclude_c0: bool = True) -> float:
    """Mel-cepstral distortion (dB) between two [T, n_mel] log-mels.

    Frames are compared 1:1 after truncating to the shorter length.
    """
    T = min(mel_a.shape[0], mel_b.shape[0])
    ca = cepstrum_from_mel(mel_a[:T], n_mfcc)
    cb = cepstrum_from_mel(mel_b[:T], n_mfcc)
    if exclude_c0:
        ca, cb = ca[:, 1:], cb[:, 1:]
    dist = np.sqrt(np.sum((ca - cb) ** 2, axis=1))
    return float(_MCD_CONST * np.mean(dist))


def mcd_dtw(mel_a: np.ndarray, mel_b: np.ndarray, n_mfcc: int = 13
            ) -> float:
    """MCD with dynamic-time-warped frame pairing (for free-running
    outputs whose timing differs from ground truth)."""
    ca = cepstrum_from_mel(mel_a, n_mfcc)[:, 1:]
    cb = cepstrum_from_mel(mel_b, n_mfcc)[:, 1:]
    Ta, Tb = len(ca), len(cb)
    # frame-pair cost matrix
    cost = np.sqrt(((ca[:, None, :] - cb[None, :, :]) ** 2).sum(-1))
    acc = np.full((Ta + 1, Tb + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, Ta + 1):
        j0 = max(1, i - 200)            # Sakoe-Chiba band
        j1 = min(Tb + 1, i + 200)
        for j in range(j0, j1):
            acc[i, j] = cost[i - 1, j - 1] + min(
                acc[i - 1, j], acc[i, j - 1], acc[i - 1, j - 1])
    path_len = Ta + Tb
    return float(_MCD_CONST * acc[Ta, Tb] / path_len)


def f0_metrics(f0_a: np.ndarray, f0_b: np.ndarray
               ) -> Tuple[float, float, float]:
    """(rmse_hz on co-voiced frames, voicing decision error, corr)."""
    T = min(len(f0_a), len(f0_b))
    a, b = np.asarray(f0_a[:T]), np.asarray(f0_b[:T])
    va, vb = a > 0, b > 0
    vde = float(np.mean(va != vb)) if T else 0.0
    both = va & vb
    if both.sum() < 2:
        return 0.0, vde, 0.0
    rmse = float(np.sqrt(np.mean((a[both] - b[both]) ** 2)))
    corr = float(np.corrcoef(a[both], b[both])[0, 1])
    return rmse, vde, corr

"""Elementwise audio processing (cookietts_tpu/audio/processing.py).

Dynamic-range compression and decompression on tensors, with the 1e-5
clamp of the reference (CookieTTS/utils/audio/audio_processing.py), and the
host-side window helpers of the STFT: the periodic Hann window, centre
padding and the window-sum-square envelope that normalises the inverse
STFT's overlap-add.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.signal import get_window


def dynamic_range_compression(x: torch.Tensor, C: float = 1.0,
                              clip_val: float = 1e-5) -> torch.Tensor:
    """Natural-log dynamic-range compression with a floor clamp."""
    return torch.log(x.clamp_min(clip_val) * C)


def dynamic_range_decompression(x: torch.Tensor, C: float = 1.0
                                ) -> torch.Tensor:
    return torch.exp(x) / C


def periodic_hann(win_length: int, dtype=np.float64) -> np.ndarray:
    """fftbins=True Hann window (periodic), as used by STFT frontends."""
    return get_window("hann", win_length, fftbins=True).astype(dtype)


def pad_center(window: np.ndarray, size: int) -> np.ndarray:
    """Zero-pad a window symmetrically to ``size`` samples."""
    n = len(window)
    lpad = (size - n) // 2
    out = np.zeros(size, dtype=window.dtype)
    out[lpad:lpad + n] = window
    return out


def window_sumsquare(window_name: str, n_frames: int, hop_length: int,
                     win_length: int, n_fft: int, dtype=np.float32
                     ) -> np.ndarray:
    """Sum-square envelope of an overlapped window sequence (accumulated in
    float64, returned as ``dtype``)."""
    n = n_fft + hop_length * (n_frames - 1)
    x = np.zeros(n, dtype=np.float64)
    win_sq = pad_center(get_window(window_name, win_length, fftbins=True) ** 2,
                        n_fft)
    for i in range(n_frames):
        sample = i * hop_length
        x[sample:min(n, sample + n_fft)] += win_sq[:max(0, min(n_fft, n - sample))]
    return x.astype(dtype)

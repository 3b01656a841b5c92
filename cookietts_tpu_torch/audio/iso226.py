"""ISO 226:2003 equal-loudness emphasis and de-emphasis
(cookietts_tpu/audio/iso226.py).

An STFT (audio/stft.py), each bin's magnitude reweighted by the 60-phon
contour, and the inverse STFT. The contour comes from the published ISO
226:2003 table and formula, interpolated by a cubic spline over frequency
and held flat past 12.5 kHz; the tables and the spline are host numpy
(scipy), as in the JAX package, and the per-bin weights are torch buffers on
the module's device.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.interpolate import InterpolatedUnivariateSpline
from torch import nn

from ..device import resolve_device
from .stft import STFT

# ISO 226:2003 Table 1: frequency, exponent alpha_f, transfer-function
# magnitude L_u (dB), threshold of hearing T_f (dB).
_ISO226_FREQ = np.array([
    20, 25, 31.5, 40, 50, 63, 80, 100, 125, 160, 200, 250, 315, 400, 500,
    630, 800, 1000, 1250, 1600, 2000, 2500, 3150, 4000, 5000, 6300, 8000,
    10000, 12500,
], dtype=np.float64)
_ISO226_ALPHA = np.array([
    0.532, 0.506, 0.480, 0.455, 0.432, 0.409, 0.387, 0.367, 0.349, 0.330,
    0.315, 0.301, 0.288, 0.276, 0.267, 0.259, 0.253, 0.250, 0.246, 0.244,
    0.243, 0.243, 0.243, 0.242, 0.242, 0.245, 0.254, 0.271, 0.301,
])
_ISO226_LU = np.array([
    -31.6, -27.2, -23.0, -19.1, -15.9, -13.0, -10.3, -8.1, -6.2, -4.5,
    -3.1, -2.0, -1.1, -0.4, 0.0, 0.3, 0.5, 0.0, -2.7, -4.1, -1.0, 1.7,
    2.5, 1.2, -2.1, -7.1, -11.2, -10.7, -3.1,
])
_ISO226_TF = np.array([
    78.5, 68.7, 59.5, 51.1, 44.0, 37.5, 31.5, 26.5, 22.1, 17.9, 14.4,
    11.4, 8.6, 6.2, 4.4, 3.0, 2.2, 2.4, 3.5, 1.7, -1.3, -4.2, -6.0,
    -5.4, -1.5, 6.0, 12.6, 13.9, 12.3,
])


def iso226_spl(loudness_phon: float = 60.0) -> tuple[np.ndarray, np.ndarray]:
    """Sound-pressure level (dB SPL) of the equal-loudness contour at the
    29 ISO 226 reference frequencies, for a loudness in phon."""
    ln = float(loudness_phon)
    a_f = (4.47e-3 * (10 ** (0.025 * ln) - 1.15)
           + (0.4 * 10 ** ((_ISO226_TF + _ISO226_LU) / 10 - 9)) ** _ISO226_ALPHA)
    spl = (10.0 / _ISO226_ALPHA) * np.log10(a_f) - _ISO226_LU + 94.0
    return _ISO226_FREQ.copy(), spl


def iso226_spl_interpolator(loudness_phon: float = 60.0, hfe: bool = True):
    """Spline SPL(freq); ``hfe`` holds the contour flat past 12.5 kHz (and
    toward 0 Hz below 20 Hz)."""
    freqs, spl = iso226_spl(loudness_phon)
    if hfe:
        freqs = np.concatenate([[1.0], freqs, [20000.0, 48000.0]])
        spl = np.concatenate([[spl[0]], spl, [spl[-1], spl[-1]]])
    return InterpolatedUnivariateSpline(freqs, spl, k=3)


class ISO226(nn.Module):
    """Equal-loudness emphasis (``forward``) and de-emphasis (``inverse``),
    [B, T] audio to [B, T] audio, by STFT reweighting."""

    def __init__(self, sampling_rate: int = 48000, filter_length: int = 2400,
                 hop_length: int = 600, win_length: int = 2400,
                 loudness_phon: float = 60.0,
                 device: str | torch.device = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self.stft = STFT(filter_length, hop_length, win_length, device=device)
        spl = iso226_spl_interpolator(loudness_phon, hfe=True)
        freqs = np.linspace(0, sampling_rate // 2, filter_length // 2 + 1)
        ref_power = 10 ** (loudness_phon / 10.0)
        w = np.array([ref_power / (10 ** (spl(f) / 10.0)) for f in freqs])
        w_inv = np.where(w < 0.008, 1e5, w)
        as_t = lambda a: torch.tensor(a, dtype=torch.float32,
                                      device=device)[None, None, :]
        self.register_buffer("freq_weights", as_t(w), persistent=False)
        self.register_buffer("inv_freq_weights", as_t(1.0 / w_inv),
                             persistent=False)

    def _reweight(self, audio: torch.Tensor, weights: torch.Tensor):
        magnitude, phase = self.stft.transform(audio)
        return self.stft.inverse(magnitude * weights, phase)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        """Apply the loudness emphasis."""
        return self._reweight(audio, self.freq_weights)

    def inverse(self, audio: torch.Tensor) -> torch.Tensor:
        """Remove the loudness emphasis."""
        return self._reweight(audio, self.inv_freq_weights)

"""Matmul-based STFT and inverse STFT (cookietts_tpu/audio/stft.py:STFT).

Reflect padding of ``filter_length // 2`` on each side, a windowed DFT basis
applied at hop-length stride, magnitude and phase split at the cutoff bin, and
a pseudo-inverse basis with window-sum-square overlap-add correction.
Spectrograms are time-major, [B, n_frames, cutoff], as in the JAX package.
``TacotronSTFT`` adds the Slaney mel projection and the log compression with
the 1e-5 clamp (cookietts_tpu/audio/stft.py:TacotronSTFT); Griffin-Lim is not
ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy.signal import get_window

from ..device import resolve_device
from .mel import mel_filterbank


def pad_center(window: np.ndarray, size: int) -> np.ndarray:
    """Zero-pad a window symmetrically to ``size`` samples."""
    n = len(window)
    lpad = (size - n) // 2
    out = np.zeros(size, dtype=window.dtype)
    out[lpad:lpad + n] = window
    return out


def window_sumsquare(window_name: str, n_frames: int, hop_length: int,
                     win_length: int, n_fft: int) -> np.ndarray:
    """Sum-square envelope of an overlapped window sequence (float64)."""
    n = n_fft + hop_length * (n_frames - 1)
    x = np.zeros(n, dtype=np.float64)
    win_sq = pad_center(get_window(window_name, win_length, fftbins=True) ** 2,
                        n_fft)
    for i in range(n_frames):
        sample = i * hop_length
        x[sample:min(n, sample + n_fft)] += win_sq[:max(0, min(n_fft, n - sample))]
    return x


def _dft_bases(filter_length: int, win_length: int, window: Optional[str]):
    """(forward, inverse) windowed DFT bases, each [2 * cutoff, filter_length]
    float64. The inverse is the plain pseudo-inverse of the forward basis."""
    fourier = np.fft.fft(np.eye(filter_length))
    cutoff = filter_length // 2 + 1
    basis = np.vstack([np.real(fourier[:cutoff]), np.imag(fourier[:cutoff])])
    inv = np.linalg.pinv(basis).T
    if window is not None:
        if filter_length < win_length:
            raise ValueError("filter_length must be at least win_length")
        w = pad_center(get_window(window, win_length, fftbins=True),
                       filter_length)
        basis, inv = basis * w, inv * w
    return basis, inv


class STFT:
    """Forward/inverse STFT with precomputed windowed DFT bases."""

    def __init__(self, filter_length: int = 800, hop_length: int = 200,
                 win_length: int = 800, window: Optional[str] = "hann",
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.filter_length = int(filter_length)
        self.hop_length = int(hop_length)
        self.win_length = int(win_length)
        self.window = window
        self.cutoff = self.filter_length // 2 + 1
        fwd, inv = _dft_bases(self.filter_length, self.win_length, window)
        as_t = lambda a: torch.tensor(a.T, dtype=torch.float32, device=self.device)
        self.forward_basis = as_t(fwd)      # [filter_length, 2 * cutoff]
        self.inverse_basis = as_t(inv)      # [filter_length, 2 * cutoff]
        self._wss_cache: Dict[int, torch.Tensor] = {}

    def transform(self, audio: torch.Tensor, return_phase: bool = True
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """[B, T] audio -> (magnitude [B, n_frames, cutoff], phase or None)."""
        pad = self.filter_length // 2
        x = F.pad(audio[:, None, :], (pad, pad), mode="reflect")[:, 0]
        frames = x.unfold(1, self.filter_length, self.hop_length)
        spec = torch.matmul(frames, self.forward_basis)
        real, imag = spec[..., :self.cutoff], spec[..., self.cutoff:]
        magnitude = torch.sqrt(real ** 2 + imag ** 2)
        return magnitude, (torch.atan2(imag, real) if return_phase else None)

    def _window_sum(self, n_frames: int) -> torch.Tensor:
        if n_frames not in self._wss_cache:
            wss = window_sumsquare(self.window, n_frames, self.hop_length,
                                   self.win_length, self.filter_length
                                   ).astype(np.float32)
            tiny = np.finfo(np.float32).tiny
            self._wss_cache[n_frames] = torch.from_numpy(
                np.where(wss > tiny, wss, np.float32(1.0))).to(self.device)
        return self._wss_cache[n_frames]

    def inverse(self, magnitude: torch.Tensor, phase: torch.Tensor
                ) -> torch.Tensor:
        """(mag, phase) [B, n_frames, cutoff] -> audio [B, T] (overlap-add)."""
        n_frames = magnitude.shape[1]
        recomb = torch.cat([magnitude * torch.cos(phase),
                            magnitude * torch.sin(phase)], dim=-1)
        frames = torch.matmul(recomb, self.inverse_basis.t())
        t_full = self.filter_length + self.hop_length * (n_frames - 1)
        out = F.fold(frames.transpose(1, 2), (1, t_full),
                     (1, self.filter_length), stride=(1, self.hop_length))[:, 0, 0]
        if self.window is not None:
            out = out / self._window_sum(n_frames)
        pad = self.filter_length // 2
        return out[:, pad:-pad]

    def __call__(self, audio: torch.Tensor) -> torch.Tensor:
        return self.inverse(*self.transform(audio))


class TacotronSTFT:
    """Mel-spectrogram frontend: STFT magnitude -> Slaney mel -> ln with a
    ``clamp_val`` floor. Mels are time-major, [B, n_frames, n_mel].
    ``mel_spectrogram`` runs in torch on ``device``; ``mel_spectrogram_np``
    is its numpy mirror for host-side feature extraction (the dataset)."""

    def __init__(self, filter_length: int = 1024, hop_length: int = 256,
                 win_length: int = 1024, n_mel_channels: int = 80,
                 sampling_rate: int = 22050, mel_fmin: float = 0.0,
                 mel_fmax: Optional[float] = 8000.0, clamp_val: float = 1e-5,
                 device: str | torch.device = "cuda"):
        self.n_mel_channels = n_mel_channels
        self.sampling_rate = sampling_rate
        self.clip_val = clamp_val
        self.hop_length = hop_length
        self.stft = STFT(filter_length, hop_length, win_length, device=device)
        self.device = self.stft.device
        basis = mel_filterbank(sampling_rate, filter_length, n_mel_channels,
                               mel_fmin, mel_fmax)
        self.mel_basis_np = np.ascontiguousarray(basis.T, np.float32)
        self.mel_basis = torch.from_numpy(self.mel_basis_np).to(self.device)
        self._fwd_np = self.stft.forward_basis.cpu().numpy()

    def mel_spectrogram(self, audio: torch.Tensor) -> torch.Tensor:
        """[B, T] audio in [-1, 1] -> log-mel [B, n_frames, n_mel]."""
        magnitudes, _ = self.stft.transform(audio, return_phase=False)
        mel = torch.matmul(magnitudes, self.mel_basis)
        return torch.log(mel.clamp_min(self.clip_val))

    def mel_spectrogram_np(self, audio) -> np.ndarray:
        """Numpy mirror of :meth:`mel_spectrogram`; takes [T] or [B, T]."""
        squeeze = np.ndim(audio) == 1
        x = np.atleast_2d(np.asarray(audio, np.float32))
        n_fft, hop = self.stft.filter_length, self.stft.hop_length
        x = np.pad(x, ((0, 0), (n_fft // 2, n_fft // 2)), mode="reflect")
        n_frames = (x.shape[1] - n_fft) // hop + 1
        idx = (np.arange(n_frames)[:, None] * hop
               + np.arange(n_fft)[None, :])
        spec = x[:, idx] @ self._fwd_np                     # [B, T, 2*cutoff]
        c = self.stft.cutoff
        mag = np.sqrt(spec[..., :c] ** 2 + spec[..., c:] ** 2)
        mel = np.log(np.clip(mag @ self.mel_basis_np, self.clip_val, None))
        return mel[0] if squeeze else mel

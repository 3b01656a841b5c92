"""Vocoder bias removal, the spectral denoiser
(cookietts_tpu/models/denoiser.py).

The vocoder runs once on a near-silent mel (noise * ``var``) to expose its
bias; the mean magnitude spectrum of that audio is stored, and ``strength``
times it is subtracted from generated audio in the STFT domain, which is
then resynthesised with the original phase.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..audio.stft import STFT
from ..device import resolve_device


class Denoiser:
    def __init__(self, infer_fn: Callable[[torch.Tensor, torch.Generator],
                                          torch.Tensor],
                 sampling_rate: int = 48000, n_mel_channels: int = 160,
                 n_frames: int = 20, mu: float = 0.0, var: float = 0.01,
                 filter_length: Optional[int] = None,
                 hop_length: Optional[int] = None,
                 win_length: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 device: str | torch.device = "cuda"):
        """infer_fn(mel [1, T, M], generator) -> audio [1, T * hop], on
        ``device``; ``generator`` (on ``device``) draws the near-silent mel
        and is handed on to ``infer_fn``."""
        self.device = resolve_device(device)
        self.stft = STFT(filter_length or sampling_rate // 40,
                         hop_length or sampling_rate // 400,
                         win_length or sampling_rate // 40, device=self.device)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        mel_input = mu + var * torch.randn(
            (1, n_frames, n_mel_channels), generator=generator,
            device=self.device, dtype=torch.float32)
        bias_audio = infer_fn(mel_input, generator).float()
        if not torch.isfinite(bias_audio).all():
            raise ValueError("non-finite elements in vocoder bias output")
        bias_spec, _ = self.stft.transform(bias_audio, return_phase=False)
        self.bias_spec = bias_spec.mean(dim=1, keepdim=True)   # [1, 1, cutoff]

    @torch.no_grad()
    def __call__(self, audio: torch.Tensor, strength: float = 0.1
                 ) -> torch.Tensor:
        """audio [B, T] -> denoised audio [B, T'] (T' = overlap-add length)."""
        audio = torch.as_tensor(audio, dtype=torch.float32, device=self.device)
        mag, phase = self.stft.transform(audio)
        mag = torch.clamp(mag - strength * self.bias_spec, min=0.0)
        return self.stft.inverse(mag, phase)

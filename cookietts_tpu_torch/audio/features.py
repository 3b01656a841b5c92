"""The fused feature frontend on the device (cookietts_tpu/audio/features.py).

One call takes a padded [B, T] audio batch and computes every per-frame
feature of the preprocess stage: BS.1770 loudness (and the loudness-
normalised audio), the log-mel, the energy and an autocorrelation f0 with
its voicing. It replaces the reference's per-file host loop (pyworld f0,
data_utils.py:815-838; pyloudnorm, :786-803; librosa mel, stft.py:180-207).

Plain PyTorch on tensors on an explicit device, in float32 with TF32 off
(``device.full_float32``): TF32 in the long FIR would move loudness by far
more than its truncation does. The JAX package computes all of this as plain
XLA (no Pallas kernel), so library calls are the port here: ``torch.fft``
for the autocorrelation and the FIR, matrix products for the mel.

Host anchors (tests/test_torch_features.py, chip_smoke.py phase 15):
- ``estimate_f0``      = data/audio_io.py:estimate_f0_autocorr (numpy)
- ``measure_loudness`` = audio/dsp.py:measure_loudness_lufs (BS.1770-4, the
  biquad cascade replaced by its 8192-tap impulse response: about 1e-3 LU,
  since the IIR decays within a few ms)
- ``energy``           = the dataset's (the mean over channels of exp(mel))
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import full_float32, resolve_device
from .stft import TacotronSTFT


def _frame(audio: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """[B, T] -> [B, N, frame_length], N = max(1 + (T - frame_length) // hop,
    1), the indices clamped to T - 1 (data/audio_io.py's numpy framing). A
    clip of at least one frame never reaches the clamp and is framed as a
    strided view."""
    T = audio.shape[-1]
    if T >= frame_length:
        return audio.unfold(-1, frame_length, hop)
    n = max(1 + (T - frame_length) // hop, 1)
    idx = (torch.arange(n, device=audio.device)[:, None] * hop
           + torch.arange(frame_length, device=audio.device)[None, :])
    return audio[:, idx.clamp_max(T - 1)]


@functools.lru_cache(maxsize=8)
def _hanning(frame_length: int) -> np.ndarray:
    return np.hanning(frame_length).astype(np.float32)


def estimate_f0(audio: torch.Tensor, sr: int, hop_length: int = 512,
                frame_length: int = 2048, f0_min: float = 55.0,
                f0_max: float = 760.0, voiced_thresh: float = 0.3,
                center: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched autocorrelation pitch track: [B, T] -> (f0 [B, N], voiced).

    Hann-windowed frames, the FFT autocorrelation (at n = 2 frame_length, so
    it is linear, not circular), the peak inside the [sr/f0_max, sr/f0_min]
    lag window, peak/ac0 as the voicing strength, f0 = 0 where unvoiced.
    ``center=True`` reflect-pads frame_length // 2 on each side like the
    STFT, so frame k is centred on sample k*hop, on the mel's grid (1 +
    T // hop frames); the default start-aligned frames are the host
    anchor's."""
    x = audio.float()
    if center:
        pad = frame_length // 2
        x = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    win = torch.from_numpy(_hanning(frame_length)).to(x.device)
    frames = _frame(x, frame_length, hop_length) * win
    spec = torch.fft.rfft(frames, n=2 * frame_length, dim=-1)
    ac = torch.fft.irfft(spec.abs() ** 2, n=2 * frame_length,
                         dim=-1)[..., :frame_length]
    ac0 = ac[..., 0] + 1e-9
    lag_min = int(sr / f0_max)
    lag_max = min(int(sr / f0_min), frame_length - 1)
    peak, best = ac[..., lag_min:lag_max].max(dim=-1)
    f0 = sr / (best + lag_min).float()
    voiced = peak / ac0 > voiced_thresh
    return torch.where(voiced, f0, torch.zeros_like(f0)), voiced


@functools.lru_cache(maxsize=8)
def _k_weighting_fir(sr: int, numtaps: int = 8192) -> np.ndarray:
    """Truncated impulse response of the BS.1770 K-weighting biquad cascade
    (audio/dsp.py:_k_weighting_coeffs): the IIR pre-filter as one FIR."""
    from scipy import signal

    from .dsp import _k_weighting_coeffs
    (b1, a1), (b2, a2) = _k_weighting_coeffs(sr)
    impulse = np.zeros(numtaps)
    impulse[0] = 1.0
    h = signal.lfilter(b2, a2, signal.lfilter(b1, a1, impulse))
    return h.astype(np.float32)


def _causal_fir(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """True (causal) convolution xw[t] = sum_j h[j] x[t - j], t < T, as one
    FFT product over the batch (the zero padding makes it linear)."""
    T, K = x.shape[-1], h.shape[-1]
    n = 1 << (T + K - 1 - 1).bit_length()
    spec = torch.fft.rfft(x, n=n, dim=-1) * torch.fft.rfft(h, n=n)
    return torch.fft.irfft(spec, n=n, dim=-1)[..., :T]


def measure_loudness(audio: torch.Tensor,
                     lengths: Optional[torch.Tensor] = None, *, sr: int,
                     block_s: float = 0.400, overlap: float = 0.75
                     ) -> torch.Tensor:
    """Integrated loudness [B] in LUFS per ITU-R BS.1770-4 (mono), with the
    -70 LUFS absolute and -10 LU relative gates. ``lengths`` masks each
    row's padded tail: a block counts when it ends inside the clip, and a
    clip shorter than one block keeps block 0 alone."""
    x = audio.float()
    B, T = x.shape
    h = torch.from_numpy(_k_weighting_fir(sr)).to(x.device)
    sq = _causal_fir(x, h) ** 2

    blk = int(sr * block_s)
    step = max(int(sr * block_s * (1 - overlap)), 1)
    if T < blk:
        ms = sq.mean(dim=-1, keepdim=True)                      # [B, 1]
        valid = torch.ones_like(ms, dtype=torch.bool)
    else:
        ms = sq.unfold(-1, blk, step).mean(dim=-1)              # [B, N]
        if lengths is None:
            valid = torch.ones_like(ms, dtype=torch.bool)
        else:
            starts = torch.arange(ms.shape[1], device=x.device) * step
            lengths = torch.as_tensor(lengths, device=x.device)
            valid = (starts[None, :] + blk) <= lengths[:, None]
            none_valid = ~valid.any(dim=1, keepdim=True)
            first = torch.arange(ms.shape[1], device=x.device)[None, :] == 0
            valid = valid | (none_valid & first)

    def gated_loudness(gate):
        mean = (torch.where(gate, ms, torch.zeros_like(ms)).sum(dim=-1)
                / gate.sum(dim=-1).clamp_min(1))
        return -0.691 + 10.0 * torch.log10(mean + 1e-30)

    block_l = -0.691 + 10.0 * torch.log10(ms + 1e-30)
    gate = valid & (block_l > -70.0)
    rel = gated_loudness(gate)[:, None] - 10.0
    return gated_loudness(gate & (block_l > rel))


def fused_frontend(stft: TacotronSTFT, *, sr: int,
                   target_lufs: Optional[float] = -27.0,
                   f0_min: float = 55.0, f0_max: float = 760.0,
                   device: str | torch.device = "cuda"
                   ) -> Callable[..., Dict[str, torch.Tensor]]:
    """The one-call feature extractor on ``device`` (``stft``'s device).

    Returns ``fn(audio [B, T], lengths [B] or None) -> dict`` of tensors on
    the device: ``loudness`` (LUFS before normalisation), ``audio``
    (normalised to ``target_lufs`` with the host's +/-30 dB gain clamp and
    peak division, or as given when ``target_lufs`` is None), ``mel`` [B, N,
    n_mel], ``energy`` [B, N] and ``f0`` / ``voiced`` [B, N] on the mel's
    centre-padded frame grid. ``audio`` and ``lengths`` may be numpy."""
    dev = resolve_device(device)
    if stft.device != dev:
        raise ValueError(f"the STFT lives on {stft.device}, the frontend on "
                         f"{dev}")

    def fn(audio, lengths=None) -> Dict[str, torch.Tensor]:
        with full_float32(), torch.no_grad():
            audio = torch.as_tensor(audio, dtype=torch.float32, device=dev)
            if lengths is not None:
                lengths = torch.as_tensor(lengths, device=dev)
            lufs = measure_loudness(audio, lengths, sr=sr)
            if target_lufs is not None:
                # the host anchor's rule (audio_io.loudness_normalize): a
                # +/-30 dB clamp (a fully gated near-silent clip measures
                # about -300 LUFS here, where the host returns -70), then
                # peak division instead of hard clipping
                gain_db = (target_lufs - lufs).clamp(-30.0, 30.0)
                audio = audio * (10.0 ** (gain_db / 20.0))[:, None]
                peak = audio.abs().amax(dim=-1, keepdim=True) + 1e-9
                audio = torch.where(peak > 1.0, audio / peak, audio)
            mel = stft.mel_spectrogram(audio)                  # [B, N, M]
            energy = torch.exp(mel).mean(dim=-1)               # [B, N]
            f0, voiced = estimate_f0(
                audio, sr, hop_length=stft.hop_length,
                frame_length=stft.stft.filter_length, f0_min=f0_min,
                f0_max=f0_max, center=True)
            n = min(mel.shape[1], f0.shape[1])
            return {"audio": audio, "loudness": lufs, "mel": mel[:, :n],
                    "energy": energy[:, :n], "f0": f0[:, :n],
                    "voiced": voiced[:, :n]}

    return fn

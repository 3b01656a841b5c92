"""GAN-TTS style generator and discriminator
(cookietts_tpu/models/gantts.py; the reference CookieTTS/_2_ttm/GANTTS/).

- :class:`ConditionalBatchNorm`: a LayerNorm without scale or bias, then a
  scale and shift predicted from the latent z (a LayerNorm where the
  reference has BatchNorm, as JAX).
- :class:`GBlock`: z-conditioned residual block of dilated "SAME" convs.
- :class:`DBlock`: downsampling residual block; the pooling is flax's
  ``avg_pool(padding="SAME")``, which divides a window that overhangs the
  end by its full size (torch's ``avg_pool1d`` would divide by the
  elements inside).
- :class:`GANTTSGenerator`: UnTTS's FFT text encoder (models/untts.py) and
  length regulator, then the GBlock stack and a mel projection.
- :class:`GANTTSDiscriminator`: one DBlock stack per window length over a
  window of the mel, each giving a logit per utterance.

Layouts are JAX's ([B, T, C]); parameter names are JAX's module names
(``enc{i}``, ``gblock{i}.cbn{j}.scale``, ``w{wi}_dblock{i}``, ...). The
latent z and the windows' starts are drawn from ``torch.Generator``s (or
passed in), never threefry.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import compute_dtype, refuse_bf16
from ..device import resolve_device
from ..ops.masking import get_mask_from_lengths
from ..parallel.mesh import draw_rows
from .untts import FFTBlock, SameConv1d, _positions, flax_layer_norm, \
    length_regulate


@dataclasses.dataclass(frozen=True)
class GANTTSConfig:
    n_symbols: int = 256
    symbols_embedding_dim: int = 256
    n_speakers: int = 512
    speaker_embedding_dim: int = 64
    n_mel_channels: int = 80
    z_dim: int = 128
    enc_layers: int = 2
    enc_heads: int = 2
    enc_ffn_dim: int = 512
    g_channels: Tuple[int, ...] = (256, 256, 128)
    g_dilations: Tuple[int, ...] = (1, 2, 4, 8)
    d_channels: Tuple[int, ...] = (64, 128, 256)
    d_windows: Tuple[int, ...] = (32, 64, 128)   # random mel windows
    dropout: float = 0.1
    dtype: Any = torch.float32

    def __post_init__(self):
        # torch.float32 / torch.bfloat16 or their names (config.compute_dtype)
        object.__setattr__(self, "dtype", compute_dtype(self.dtype))


class ConditionalBatchNorm(nn.Module):
    """flax LayerNorm without scale or bias over the last axis of x [B, T,
    F], then x (1 + scale(z)) + shift(z) with z [B, Z]."""

    def __init__(self, features: int, z_dim: int):
        super().__init__()
        self.scale = nn.Linear(z_dim, features)
        self.shift = nn.Linear(z_dim, features)

    def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        h = flax_layer_norm(x)
        return h * (1.0 + self.scale(z)[:, None, :]) + self.shift(z)[:, None, :]


class GBlock(nn.Module):
    """z-conditioned residual block: ``res_proj`` of the input plus, per
    dilation, ConditionalBatchNorm, leaky ReLU (0.1) and a dilated conv."""

    def __init__(self, in_ch: int, channels: int, z_dim: int,
                 dilations: Sequence[int] = (1, 2, 4, 8), kernel_size: int = 3):
        super().__init__()
        self.n = len(dilations)
        self.res_proj = nn.Linear(in_ch, channels)
        for i, d in enumerate(dilations):
            c_in = in_ch if i == 0 else channels
            self.add_module(f"cbn{i}", ConditionalBatchNorm(c_in, z_dim))
            self.add_module(f"conv{i}", SameConv1d(c_in, channels, kernel_size,
                                                   dilation=d))

    def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.n):
            h = F.leaky_relu(getattr(self, f"cbn{i}")(h, z), 0.1)
            h = getattr(self, f"conv{i}")(h)
        return h + self.res_proj(x)


def avg_pool_same(x: torch.Tensor, scale: int) -> torch.Tensor:
    """flax ``avg_pool(x, (s,), strides=(s,), padding="SAME")`` over x [B,
    T, C]: ceil(T / s) windows, the padding split with the smaller half on
    the left, every window divided by s (the padding counted)."""
    T = x.shape[1]
    total = -(-T // scale) * scale - T
    h = F.pad(x.transpose(1, 2), (total // 2, total - total // 2))
    return F.avg_pool1d(h, scale, scale).transpose(1, 2)


class DBlock(nn.Module):
    """Downsampling residual block: flax-"SAME" average pooling by
    ``scale``, then ``res_proj`` plus leaky ReLU (0.1) and dilated convs."""

    def __init__(self, in_ch: int, channels: int, scale: int = 2,
                 kernel_size: int = 3, dilations: Sequence[int] = (1, 2)):
        super().__init__()
        self.scale, self.n = scale, len(dilations)
        self.res_proj = nn.Linear(in_ch, channels)
        for i, d in enumerate(dilations):
            self.add_module(f"conv{i}", SameConv1d(
                in_ch if i == 0 else channels, channels, kernel_size,
                dilation=d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.scale > 1:
            x = avg_pool_same(x, self.scale)
        h = x
        for i in range(self.n):
            h = getattr(self, f"conv{i}")(F.leaky_relu(h, 0.1))
        return h + self.res_proj(x)


class GANTTSGenerator(nn.Module):
    """Text, durations and z -> mel [B, t_out, n_mel] and its frame mask."""

    def __init__(self, cfg: GANTTSConfig, device: str | torch.device = "cuda"):
        super().__init__()
        refuse_bf16(cfg.dtype, "GAN-TTS", "bf16 UnTTS and GAN-TTS")
        self.cfg = cfg
        D = cfg.symbols_embedding_dim
        self.embedding = nn.Embedding(cfg.n_symbols, D)
        self.pos_scale = nn.Parameter(torch.ones(()))
        for i in range(cfg.enc_layers):
            self.add_module(f"enc{i}", FFTBlock(D, cfg.enc_heads,
                                                cfg.enc_ffn_dim,
                                                dropout=cfg.dropout))
        self.speaker_embedding = nn.Embedding(cfg.n_speakers,
                                              cfg.speaker_embedding_dim)
        ch = D + cfg.speaker_embedding_dim
        for i, c in enumerate(cfg.g_channels):
            self.add_module(f"gblock{i}", GBlock(ch, c, cfg.z_dim,
                                                 cfg.g_dilations))
            ch = c
        self.mel_proj = nn.Linear(ch, cfg.n_mel_channels)
        self.to(resolve_device(device))

    def forward(self, text, text_lengths, speaker_id, durations,
                z: Optional[torch.Tensor] = None, t_out: int = 256,
                generator: Optional[torch.Generator] = None,
                deterministic: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """z [B, z_dim], standard normal from ``generator`` when None;
        dropout (unless ``deterministic``) from ``generator`` too. ->
        (mel zero past each length, frame_mask [B, t_out])."""
        cfg = self.cfg
        B, N = text.shape
        mask = get_mask_from_lengths(text_lengths, N)
        x = self.embedding(torch.clamp(text, 0, cfg.n_symbols - 1))
        pe = _positions(N, cfg.symbols_embedding_dim, x)
        x = (x + self.pos_scale * pe[None]) * mask[:, :, None].to(x.dtype)
        for i in range(cfg.enc_layers):
            x = getattr(self, f"enc{i}")(x, mask, deterministic, generator)
        spk = self.speaker_embedding(speaker_id)
        x = torch.cat([x, spk[:, None, :].expand(-1, N, -1)], dim=-1)
        if z is None:
            z = draw_rows(torch.randn, (B, cfg.z_dim), generator=generator,
                            device=x.device)
        h, frame_mask = length_regulate(x, durations, t_out)
        for i in range(len(cfg.g_channels)):
            h = getattr(self, f"gblock{i}")(h, z)
        mel = self.mel_proj(h)
        return mel * frame_mask[:, :, None].to(mel.dtype), frame_mask


def window_starts(T: int, windows: Sequence[int],
                  generator: Optional[torch.Generator] = None,
                  device: str | torch.device = "cpu") -> torch.Tensor:
    """One start per window length, uniform in [0, T - window) where T
    exceeds the window (JAX's ``randint(0, T - window)``), else 0; int64
    [len(windows)] drawn from ``generator`` on ``device``."""
    return torch.stack([
        torch.randint(0, T - w, (), generator=generator, device=device)
        if T > w else torch.zeros((), dtype=torch.long, device=device)
        for w in windows])


class GANTTSDiscriminator(nn.Module):
    """Ensemble of window discriminators over mel [B, T, M]."""

    def __init__(self, cfg: GANTTSConfig, device: str | torch.device = "cuda"):
        super().__init__()
        self.cfg = cfg
        for wi in range(len(cfg.d_windows)):
            ch = cfg.n_mel_channels
            for i, c in enumerate(cfg.d_channels):
                self.add_module(f"w{wi}_dblock{i}",
                                DBlock(ch, c, scale=2 if i else 1))
                ch = c
            self.add_module(f"w{wi}_out", nn.Linear(ch, 1))
        self.to(resolve_device(device))

    def forward(self, mel: torch.Tensor,
                starts: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
        """-> per-window logits [B] (the mean of each window's map).
        Window wi covers [starts[wi], starts[wi] + window) where T exceeds
        the window; with no ``starts`` (JAX's key=None), or where T does
        not exceed it, the mel's first ``window`` frames."""
        cfg = self.cfg
        T = mel.shape[1]
        logits = []
        for wi, window in enumerate(cfg.d_windows):
            s = int(starts[wi]) if starts is not None and T > window else 0
            x = mel[:, s:s + window]
            for i in range(len(cfg.d_channels)):
                x = getattr(self, f"w{wi}_dblock{i}")(x)
            out = getattr(self, f"w{wi}_out")(F.leaky_relu(x, 0.1))
            logits.append(out.mean(dim=(1, 2)))
        return logits

"""Adversarial (GAN) postnet and its mel discriminator
(cookietts_tpu/models/gan_postnet.py).

- :class:`GANPostnet`: a conv stack over [decoder mel, the speaker
  embedding broadcast over time, per-frame noise] giving a refined mel,
  with a residual add every ``residual_connections`` layers.
- :class:`GANDiscriminator`: a conv stack over [mel, speaker embedding]
  giving each utterance's predicted fakeness in [0, 1].
- :func:`gan_postnet_losses`: the BCE fakeness losses of both sides (real
  label 0, fake label 1).

Mels are time-major, [B, T, n_mel], as in JAX; the convs run channels-first
inside, "SAME" padded. BatchNorm is flax's (ops/batchnorm.py): batch
statistics in training, running averages in eval. Parameter names are JAX's
module names (``post_conv{i}``, ``post_bn{i}``, ``dis_conv{i}``,
``dis_bn{i}``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.batchnorm import BatchNorm1d
from ..parallel.mesh import draw_rows


@dataclasses.dataclass(frozen=True)
class GANPostnetConfig:
    n_mel_channels: int = 80
    speaker_embedding_dim: int = 256
    noise_dim: int = 32
    n_convolutions: int = 5
    embedding_dim: int = 512
    kernel_size: int = 5
    residual_connections: int = 2


class _ConvStack(nn.Module):
    """The shared residual conv-BN-leaky stack (JAX ``_conv_stack``), built
    into the module itself so the parameter names are JAX's.

    Two reference quirks are kept on purpose, as JAX keeps them: (a) a
    "connected" layer skips its LeakyReLU, expecting relu(h + res) to supply
    it, but layer 0 always changes width and takes the anchor-refresh
    branch, so conv0-BN-conv1 has no nonlinearity between; (b) the residual
    anchor refreshes only on a width change, never after an add, so every
    later skip reaches back to the layer that last changed width."""

    def _build(self, cfg: GANPostnetConfig, in_dim: int, out_final: int,
               prefix: str) -> None:
        self.cfg, self.prefix = cfg, prefix
        n, width = cfg.n_convolutions, in_dim
        for i in range(n):
            out = out_final if i == n - 1 else cfg.embedding_dim
            # torch's "same" pads an even kernel as flax's does (the extra
            # tap on the right)
            self.add_module(f"{prefix}conv{i}", nn.Conv1d(
                width, out, cfg.kernel_size, padding="same"))
            if i != n - 1:
                self.add_module(f"{prefix}bn{i}", BatchNorm1d(out))
            width = out

    def _stack(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C_in, T] -> [B, out_final, T]."""
        cfg = self.cfg
        res, n = x, cfg.n_convolutions
        for i in range(n):
            last = i == n - 1
            h = getattr(self, f"{self.prefix}conv{i}")(x)
            connected = bool(cfg.residual_connections) and \
                i % cfg.residual_connections == 0
            if not connected:
                h = F.leaky_relu(h, 0.1)
            if not last:
                h = getattr(self, f"{self.prefix}bn{i}")(h)
            if h.shape[1] != res.shape[1]:
                res = x = h
            elif connected:
                x = F.relu(h + res)
            else:
                x = h
        return x


def _with_speaker(mel: torch.Tensor, speaker_embed: torch.Tensor,
                  *extra: torch.Tensor) -> torch.Tensor:
    """[B, T, M] + [B, S] (+ [B, T, N]) -> channels-first [B, M+S(+N), T]."""
    B, T, _ = mel.shape
    spk = speaker_embed[:, None, :].expand(B, T, speaker_embed.shape[-1])
    return torch.cat([mel.float(), spk.float(), *extra], -1).transpose(1, 2)


class GANPostnet(_ConvStack):
    def __init__(self, cfg: GANPostnetConfig,
                 device: str | torch.device = "cuda"):
        super().__init__()
        self._build(cfg, cfg.n_mel_channels + cfg.speaker_embedding_dim
                    + cfg.noise_dim, cfg.n_mel_channels, "post_")
        self.to(resolve_device(device))

    def forward(self, mel: torch.Tensor, speaker_embed: torch.Tensor,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, T, M] + [B, S] -> refined mel [B, T, M]. ``noise`` [B, T,
        noise_dim] is drawn from ``generator`` (standard normal) unless
        given."""
        B, T, _ = mel.shape
        if noise is None:
            noise = draw_rows(torch.randn, (B, T, self.cfg.noise_dim),
                              generator=generator, device=mel.device)
        x = _with_speaker(mel, speaker_embed, noise.float())
        return self._stack(x).transpose(1, 2)


class GANDiscriminator(_ConvStack):
    def __init__(self, cfg: GANPostnetConfig,
                 device: str | torch.device = "cuda"):
        super().__init__()
        self._build(cfg, cfg.n_mel_channels + cfg.speaker_embedding_dim, 1,
                    "dis_")
        self.to(resolve_device(device))

    def forward(self, mel: torch.Tensor,
                speaker_embed: torch.Tensor) -> torch.Tensor:
        """[B, T, M] + [B, S] -> predicted fakeness [B] in [0, 1]. The mean
        over T is unmasked, as the reference's (zero-padded frames score as
        content for real and fake alike, so the bias cancels in the BCE)."""
        out = self._stack(_with_speaker(mel, speaker_embed))      # [B, 1, T]
        return torch.sigmoid(out[:, 0].float().mean(1))


def gan_postnet_losses(d_real: torch.Tensor, d_fake: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(generator_loss, discriminator_loss) with the reference labels (real
    = 0 fakeness, fake = 1; BCE on the sigmoid outputs)."""
    eps = 1e-6
    d_loss = -(torch.log(1.0 - d_real + eps).mean()
               + torch.log(d_fake + eps).mean())
    g_loss = -torch.log(1.0 - d_fake + eps).mean()
    return g_loss, d_loss

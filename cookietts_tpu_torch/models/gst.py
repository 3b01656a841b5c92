"""Global Style Tokens, the text-predicted ("TP") style path
(cookietts_tpu/models/gst.py).

- :class:`ReferenceEncoder`: stride-2 3x3 Conv2d + BatchNorm2d + ReLU over
  the reference mel "image", a GRU, a Linear and tanh.
- :class:`StyleAttention`: multi-head attention of the reference embedding
  over the learned style-token embeddings.
- :class:`GST`: the style-token layer with four reference modes (1: from a
  mel, 0: token weights given, 2/3: predicted from the torchMoji hidden),
  the token activation, and the VAE / semi-supervised-VAE token draws.

The geometry is the reference torch model's, which the JAX package matches:
Conv2d pads (1, 1) (XLA's "SAME" would pad (0, 1)), BatchNorm2d eps 1e-3,
and a channel-major flatten before the GRU. Parameter names are the ones
cookietts_tpu/convert/gst_torch.py reads (``ref_encoder.convs.{i}.weight``,
``ref_encoder.convs.{i}.batch_norm.*``, ``ref_encoder.gru.*``,
``ref_encoder.fc.0.*``, ``att.conv_Q.*``, ``att.fc_Q.0.*``, ...,
``token_embedding``, ``map_lin.linear_layer.*``, ``ss_vae_layers.0.*``).
Flax's GRU has no bias on the hidden side of the r and z gates; torch's
``nn.GRU`` has, and ``convert.from_jax`` sets those to zero.

In eval mode the VAE draws return the mean. In training mode the BatchNorms
follow flax (ops/batchnorm.py: the biased batch variance, running averages
moved by 0.01) and every draw comes from the ``generator`` passed in, or is
the ``eps`` given.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import LinearNorm
from ..ops.batchnorm import BatchNorm2d
from ..parallel.mesh import draw_rows


@dataclasses.dataclass(frozen=True)
class GSTConfig:
    n_frames_per_step: int = 1
    n_mel_channels: int = 80
    token_embedding_size: int = 256
    token_num: int = 10
    num_heads: int = 8
    gst_att_dim: int = 128
    ref_enc_filters: Sequence[int] = (32, 32, 64, 64, 128, 128)
    token_activation: str = "softmax"    # softmax | sigmoid | tanh | linear
    vae_mode: bool = False
    ss_vae: bool = False
    ss_vae_zu_dim: int = 10
    vae_classes: int = 16
    torchmoji_dim: int = 2304
    output_tanh: bool = True


def draw_normal(like: torch.Tensor, eps: Optional[torch.Tensor],
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """``eps`` when given, else a standard normal draw from ``generator``."""
    if eps is not None:
        return eps.to(like)
    return draw_rows(torch.randn, like.shape, generator=generator,
                     device=like.device, dtype=like.dtype)


class ConvBN2d(nn.Conv2d):
    """Bias-free stride-2 3x3 Conv2d, pads (1, 1), with its BatchNorm2d
    under ``batch_norm`` (the reference's key layout)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(in_ch, out_ch, 3, stride=2, padding=1, bias=False)
        self.batch_norm = BatchNorm2d(out_ch, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.batch_norm(super().forward(x)))


class ReferenceEncoder(nn.Module):
    """Mel [B, T, M] -> reference embedding [B, E]."""

    def __init__(self, cfg: GSTConfig):
        super().__init__()
        channels = list(cfg.ref_enc_filters) + [cfg.token_embedding_size]
        self.convs = nn.ModuleList(
            ConvBN2d(c_in, c_out) for c_in, c_out in zip([1] + channels[:-1],
                                                         channels))
        m = cfg.n_mel_channels
        for _ in channels:
            m = (m + 1) // 2
        E = cfg.token_embedding_size
        self.gru = nn.GRU(channels[-1] * m, E, batch_first=True)
        self.fc = nn.Sequential(nn.Linear(E, E))

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = mel[:, None]                                  # [B, 1, T, M]
        for conv in self.convs:
            x = conv(x)
        B, C, T, M = x.shape
        # channel-major: [B, T', C, M'] flattened with C the slow axis
        x = x.permute(0, 2, 1, 3).reshape(B, T, C * M)
        out, _ = self.gru(x)
        return torch.tanh(self.fc(out[:, -1]))


class StyleAttention(nn.Module):
    """Multi-head attention of the reference embedding over the tokens ->
    raw token weights [B, out_dim]."""

    def __init__(self, cfg: GSTConfig, out_dim: int):
        super().__init__()
        E, U, H = cfg.token_embedding_size, cfg.gst_att_dim, cfg.num_heads
        self.num_heads, self.split = H, U // H
        self.conv_Q = nn.Conv1d(E, U, 1)
        self.conv_K = nn.Conv1d(E, U, 1)
        self.fc_Q = nn.Sequential(nn.Linear(U, U))
        self.fc_K = nn.Sequential(nn.Linear(U, U))
        self.fc_V = nn.Sequential(nn.Linear(E, self.split))
        self.fc_A = nn.Sequential(nn.Linear(H * self.split, out_dim))

    def forward(self, ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """ref [B, E], tokens [N, E]."""
        H, S = self.num_heads, self.split
        q = torch.tanh(self.fc_Q(F.linear(ref, self.conv_Q.weight[:, :, 0],
                                          self.conv_Q.bias)))       # [B, U]
        k = torch.tanh(self.fc_K(F.linear(tokens, self.conv_K.weight[:, :, 0],
                                          self.conv_K.bias)))       # [N, U]
        v = torch.tanh(self.fc_V(tokens))                           # [N, S]
        B, N = ref.shape[0], tokens.shape[0]
        q = q.reshape(B, H, S)
        k = k.reshape(N, H, S)
        att = torch.softmax(torch.einsum("bhs,nhs->bhn", q, k) / S ** 0.5, -1)
        y = torch.einsum("bhn,ns->bhs", att, v).reshape(B, H * S)
        return torch.tanh(self.fc_A(y))


class GST(nn.Module):
    def __init__(self, cfg: GSTConfig):
        super().__init__()
        self.cfg = cfg
        out_dim = (cfg.vae_classes if cfg.ss_vae
                   else cfg.token_num * (1 + int(cfg.vae_mode)))
        n_tokens = cfg.ss_vae_zu_dim if cfg.ss_vae else cfg.token_num
        self.ref_encoder = ReferenceEncoder(cfg)
        self.att = StyleAttention(cfg, out_dim)
        self.token_embedding = nn.Parameter(
            torch.randn(n_tokens, cfg.token_embedding_size) * 0.5)
        self.map_lin = LinearNorm(cfg.torchmoji_dim, out_dim)
        if cfg.ss_vae:
            self.ss_vae_layers = nn.Sequential(
                nn.Linear(out_dim, 2 * cfg.ss_vae_zu_dim))

    def _activate(self, tokens: torch.Tensor) -> torch.Tensor:
        act = self.cfg.token_activation
        if act == "softmax":
            return torch.softmax(tokens, -1)
        if act == "sigmoid":
            return torch.sigmoid(tokens)
        if act == "tanh":
            return torch.tanh(tokens)
        return tokens

    def forward(self, ref: torch.Tensor, ref_mode: int = 1,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """ref: a mel [B, T, M] (ref_mode 1), token weights [B, N] (0), or
        the torchMoji hidden [B, torchmoji_dim] (2, 3). Returns
        style_embedding [B, E], style_tokens, and in VAE mode mu, logvar
        (and zs_log_prob with ss_vae)."""
        cfg = self.cfg
        if ref_mode == 1:
            style_tokens = self.att(self.ref_encoder(ref), self.token_embedding)
        elif ref_mode == 0:
            style_tokens = ref
        else:
            style_tokens = self.map_lin(ref)
        style_tokens = self._activate(style_tokens)
        out: Dict[str, torch.Tensor] = {}
        if cfg.vae_mode:
            if cfg.ss_vae:
                zs = style_tokens
                zu = torch.tanh(self.ss_vae_layers(zs))
                out["zs_log_prob"] = torch.log_softmax(zs, -1)
            else:
                zu = style_tokens
            mu, logvar = zu.chunk(2, dim=-1)
            style_tokens = mu
            if self.training:
                style_tokens = mu + torch.exp(0.5 * logvar) * draw_normal(
                    mu, eps, generator)
            out["mu"], out["logvar"] = mu, logvar
        embed = style_tokens @ self.token_embedding
        if cfg.output_tanh:
            embed = torch.tanh(embed)
        out["style_embedding"] = embed
        out["style_tokens"] = style_tokens
        return out

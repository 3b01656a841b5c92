"""EmotionNet and AuxEmotionNet, the semi-supervised emotion VAE heads
(cookietts_tpu/models/emotionnet.py).

- :class:`EmotionNet`: the emotion class from a reference mel (a small
  ReferenceEncoder), the speaker embedding and a GRU summary of the encoder
  outputs; items with a known label take their one-hot instead
  ("semi-supervised"); a latent layer gives the VAE posterior zu.
- :class:`AuxEmotionNet`: the same (zs, zu) from the torchMoji hidden, the
  speaker and the text alone, so inference drives the emotion from text.

Parameter names are the ones cookietts_tpu/convert/gst_torch.py reads
(``ref_enc.*`` as in GST, ``text_rnn.*``, ``classifier_layer.linear_layer``,
``latent_layer.linear_layer``; ``seq_layers.{2i}.linear_layer`` and
``latent_classifier_layer.linear_layer`` for AuxEmotionNet). In eval mode zu
is the mean; in training mode dropout and the zu draw come from the
``generator`` passed in (or zu's noise is the ``eps`` given).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import LinearNorm
from ..ops.masking import dropout
from .gst import GSTConfig, ReferenceEncoder, draw_normal

EPSILON = 1e-6


@dataclasses.dataclass(frozen=True)
class EmotionNetConfig:
    n_classes: int = 16
    latent_dim: int = 32
    ref_enc_filters: Sequence[int] = (32, 32, 64, 64, 128, 128)
    ref_enc_rnn_dim: int = 128
    rnn_dim: int = 128                  # text GRU summary
    speaker_embedding_dim: int = 256
    torchmoji_dim: int = 2304
    aux_layer_dims: Sequence[int] = (256,)
    classifier_dropout: float = 0.25
    encoder_outputs_dropout: float = 0.25
    n_mel_channels: int = 80
    encoder_dim: int = 1024             # the encoder outputs' width


def _reparameterize(mu, logvar, training, generator, eps):
    if not training:
        return mu
    return mu + torch.exp(0.5 * logvar) * draw_normal(mu, eps, generator)


def _text_summary(rnn: nn.GRU, encoder_outputs: torch.Tensor,
                  text_lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """The GRU's output at each row's last valid position [B, rnn_dim]."""
    out, _ = rnn(encoder_outputs)
    if text_lengths is None:
        return out[:, -1]
    idx = (text_lengths - 1).clamp_min(0)
    return out[torch.arange(out.shape[0], device=out.device), idx]


class _Head(nn.Module):
    def _drop(self, x, p, generator):
        return dropout(x, p, generator) if self.training and p > 0 else x


class EmotionNet(_Head):
    def __init__(self, cfg: EmotionNetConfig):
        super().__init__()
        self.cfg = cfg
        self.ref_enc = ReferenceEncoder(GSTConfig(
            n_mel_channels=cfg.n_mel_channels,
            token_embedding_size=cfg.ref_enc_rnn_dim,
            ref_enc_filters=tuple(cfg.ref_enc_filters)))
        self.text_rnn = nn.GRU(cfg.encoder_dim, cfg.rnn_dim, batch_first=True)
        cat = cfg.ref_enc_rnn_dim + cfg.speaker_embedding_dim + cfg.rnn_dim
        self.classifier_layer = LinearNorm(cat, cfg.n_classes)
        self.latent_layer = LinearNorm(cat + cfg.n_classes, 2 * cfg.latent_dim)

    def forward(self, gt_mels, speaker_embed, encoder_outputs,
                text_lengths=None, emotion_id=None, emotion_onehot=None,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        ref = self.ref_enc(gt_mels)
        encoder_outputs = self._drop(encoder_outputs,
                                     cfg.encoder_outputs_dropout, generator)
        text_sum = _text_summary(self.text_rnn, encoder_outputs, text_lengths)
        cat = torch.cat([ref, speaker_embed, text_sum], dim=-1)
        cat = self._drop(cat, cfg.classifier_dropout, generator)
        zs = F.log_softmax(self.classifier_layer(cat), -1)
        ss_zs = zs
        if emotion_id is not None and emotion_onehot is not None:
            # a known label (unknown = n_classes) overrides the classifier
            known = (emotion_id != cfg.n_classes)[:, None]
            ss_zs = torch.where(known, torch.log(emotion_onehot + EPSILON), zs)
        zu_params = self.latent_layer(torch.cat([cat, ss_zs], dim=-1))
        mu, logvar = zu_params.chunk(2, dim=-1)
        zu = _reparameterize(mu, logvar, self.training, generator, eps)
        return {"zs": zs, "ss_zs": ss_zs, "zu": zu, "zu_mu": mu,
                "zu_logvar": logvar, "zu_params": zu_params}


class AuxEmotionNet(_Head):
    def __init__(self, cfg: EmotionNetConfig):
        super().__init__()
        self.cfg = cfg
        dims = list(cfg.aux_layer_dims)
        layers, d_in = [], cfg.torchmoji_dim
        for i, d in enumerate(dims):
            d_out = cfg.torchmoji_dim if i == len(dims) - 1 else d
            layers.append(LinearNorm(d_in, d_out))
            if i != len(dims) - 1:
                layers.append(nn.LeakyReLU(0.05))
            d_in = d_out
        self.seq_layers = nn.Sequential(*layers)
        self.text_rnn = nn.GRU(cfg.encoder_dim, cfg.rnn_dim, batch_first=True)
        self.latent_classifier_layer = LinearNorm(
            cfg.torchmoji_dim + cfg.speaker_embedding_dim + cfg.rnn_dim,
            cfg.n_classes + 2 * cfg.latent_dim)

    def forward(self, torchmoji_hidden, speaker_embed, encoder_outputs,
                text_lengths=None, generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        h = self.seq_layers(torchmoji_hidden)
        encoder_outputs = self._drop(encoder_outputs,
                                     cfg.encoder_outputs_dropout, generator)
        text_sum = _text_summary(self.text_rnn, encoder_outputs, text_lengths)
        cat = torch.cat([h, speaker_embed, text_sum], dim=-1)
        cat = self._drop(cat, cfg.classifier_dropout, generator)
        energies = self.latent_classifier_layer(cat)
        zs = F.log_softmax(energies[:, :cfg.n_classes], -1)
        zu_params = energies[:, cfg.n_classes:]
        mu, logvar = zu_params.chunk(2, dim=-1)
        zu = _reparameterize(mu, logvar, self.training, generator, eps)
        return {"zs": zs, "zu": zu, "zu_mu": mu, "zu_logvar": logvar,
                "zu_params": zu_params}

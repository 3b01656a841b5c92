"""UnTTS, the non-autoregressive flow TTS (cookietts_tpu/models/untts.py;
the reference CookieTTS/_2_ttm/untts/).

- :class:`FFTBlock`: masked multi-head self-attention and a conv FFN, each
  followed by a LayerNorm (the reference's FastPitch FFTransformer).
- :class:`TemporalPredictor`: conv, ReLU, LayerNorm layers and a linear
  head giving one scalar per char (duration, f0, energy).
- :func:`length_regulate`: char features expanded to frames by ONE
  interval matrix [T, N] per row times the features.
- :class:`PositionalAttention`: Flow-TTS's soft alignment, sinusoidal frame
  queries attending over the encoder.
- :class:`MelFlowDecoder`: a conditional flow over mel frames, invertible
  1x1 channel mixing and WN affine couplings over the port's WaveGlow
  modules (models/waveglow.py). ``forward`` (training) runs each WN's
  ``forward_train`` under autograd; ``inverse`` (inference) runs without
  autograd through ``WN.forward``, which on the card is the Hopper kernel
  ``waveglow_wn_forward`` for the GTU unit the decoder uses.
- :class:`VarGlow`: a char-level flow over (log-duration [, f0]) grouped
  ``n_group`` chars a step, so inference can sample prosody; its inverse
  runs through ``WN.forward`` too.
- :class:`UnTTS`: the training forward (the flow NLL's terms and the
  predictors' outputs) and ``inference``, the whole utterance in one
  parallel pass.

Layouts are JAX's: text [B, N], mels [B, T, n_mel], features [B, N, D]; the
flows run channels-first inside (the WN's layout), transposed once at their
edges. Parameter names are JAX's module names (``enc{i}``,
``duration_predictor``, ``cond_proj``, ...); the flows' are ``convinv.{k}``
and ``wn.{k}`` with the WaveGlow WN's names, end rows ordered (t, log_s).

Flax semantics kept: LayerNorm's variance is E[x^2] - E[x]^2 (flax's
``use_fast_variance``); attention scales the queries by 1/sqrt(head_dim),
masks with finfo(float32).min (a row that admits nothing attends
uniformly) and drops attention weights with one mask shared over batch and
heads; "SAME" convs pad (k - 1) d in total, the smaller half on the left.
Random draws (dropout, the latents) come from the ``torch.Generator`` the
caller passes, never threefry.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import compute_dtype, refuse_bf16
from ..device import full_float32, resolve_device
from ..ops.masking import dropout, get_mask_from_lengths
from .waveglow import WN, Invertible1x1Conv


@dataclasses.dataclass(frozen=True)
class UnTTSConfig:
    n_symbols: int = 256
    symbols_embedding_dim: int = 384
    n_speakers: int = 512
    speaker_embedding_dim: int = 128
    n_mel_channels: int = 80
    # encoder FFT stack
    enc_layers: int = 4
    enc_heads: int = 2
    enc_ffn_dim: int = 1024
    enc_kernel_size: int = 3
    dropout: float = 0.1
    # predictors
    predictor_kernel_size: int = 3
    predictor_filter_size: int = 256
    predictor_layers: int = 2
    predict_f0: bool = True
    predict_energy: bool = True
    # prosody flow: sample durations (and f0) at inference
    use_varglow: bool = False
    varglow_n_group: int = 4
    varglow_n_flows: int = 4
    # Flow-TTS positional attention in place of the hard expansion
    use_positional_attention: bool = False
    pos_attention_heads: int = 2
    # decoder flow
    dec_n_flows: int = 6
    dec_n_layers: int = 3
    dec_n_channels: int = 192
    dec_kernel_size: int = 3
    max_frames_per_char: float = 40.0
    sigma: float = 1.0
    dtype: Any = torch.float32

    def __post_init__(self):
        # torch.float32 / torch.bfloat16 or their names (config.compute_dtype)
        object.__setattr__(self, "dtype", compute_dtype(self.dtype))


# -- flax-semantics layers -------------------------------------------------------

def flax_layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None,
                    eps: float = 1e-5) -> torch.Tensor:
    """flax ``nn.LayerNorm`` over the last axis: var = max(E[x^2] - E[x]^2,
    0), y = (x - E[x]) * rsqrt(var + eps) * weight + bias."""
    mu = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mu * mu, min=0.0)
    mul = torch.rsqrt(var + eps)
    if weight is not None:
        mul = mul * weight
    y = (x - mu) * mul
    return y if bias is None else y + bias


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return flax_layer_norm(x, self.weight, self.bias, self.eps)


class SameConv1d(nn.Conv1d):
    """flax ``nn.Conv(padding="SAME")`` over time-major x [B, T, C_in] ->
    [B, T, C_out]: (k - 1) d padding in total, the smaller half left."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int,
                 dilation: int = 1):
        super().__init__(c_in, c_out, kernel_size, dilation=dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        total = (self.kernel_size[0] - 1) * self.dilation[0]
        h = F.pad(x.transpose(1, 2), (total // 2, total - total // 2))
        return F.conv1d(h, self.weight, self.bias,
                        dilation=self.dilation).transpose(1, 2)


class MultiHeadAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention``: query / key / value
    projections to ``heads`` x head_dim (``qkv_features`` in all, by default
    the query's width), queries scaled by 1/sqrt(head_dim), masked logits
    finfo(float32).min, softmax, dropout of the weights with one mask over
    batch and heads, the output projection (``out_features``, by default
    the query's width)."""

    def __init__(self, q_dim: int, kv_dim: int, heads: int,
                 qkv_features: Optional[int] = None,
                 out_features: Optional[int] = None, dropout: float = 0.0):
        super().__init__()
        qkv = qkv_features or q_dim
        if qkv % heads:
            raise ValueError(f"qkv_features {qkv} is not a multiple of "
                             f"heads {heads}")
        self.heads, self.p = heads, dropout
        self.query = nn.Linear(q_dim, qkv)
        self.key = nn.Linear(kv_dim, qkv)
        self.value = nn.Linear(kv_dim, qkv)
        self.out = nn.Linear(qkv, out_features or q_dim)

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor,
                mask: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """q_in [B, Tq, Dq], kv_in [B, Tk, Dk], mask [B, Tk] bool."""
        B, Tq, _ = q_in.shape
        Tk, H = kv_in.shape[1], self.heads
        q = self.query(q_in).view(B, Tq, H, -1)
        hd = q.shape[-1]
        q = q / math.sqrt(hd)
        k = self.key(kv_in).view(B, Tk, H, hd)
        v = self.value(kv_in).view(B, Tk, H, hd)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        w = torch.where(mask[:, None, None, :], w,
                        torch.finfo(torch.float32).min)
        w = torch.softmax(w, dim=-1)
        if not deterministic and self.p > 0.0:
            keep = torch.rand((Tq, Tk), generator=generator,
                              device=w.device) < 1.0 - self.p
            w = w * (keep.to(w.dtype) / (1.0 - self.p))
        y = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, Tq, H * hd)
        return self.out(y)


# -- blocks -------------------------------------------------------------------

class FFTBlock(nn.Module):
    """Masked self-attention + conv FFN (the reference's FFTransformer
    layer); x [B, N, D], mask [B, N] bool."""

    def __init__(self, dim: int, heads: int, ffn_dim: int,
                 kernel_size: int = 3, dropout: float = 0.1):
        super().__init__()
        self.p = dropout
        self.mha = MultiHeadAttention(dim, dim, heads, dropout=dropout)
        self.ln1 = LayerNorm(dim)
        self.ffn1 = SameConv1d(dim, ffn_dim, kernel_size)
        self.ffn2 = SameConv1d(ffn_dim, dim, kernel_size)
        self.ln2 = LayerNorm(dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        m = mask[:, :, None].to(x.dtype)
        h = self.mha(x, x, mask, deterministic, generator)
        x = self.ln1(x + h) * m
        h = F.relu(self.ffn1(x))
        if not deterministic and self.p > 0.0:
            h = dropout(h, self.p, generator)
        x = self.ln2(x + self.ffn2(h))
        return x * m


class TemporalPredictor(nn.Module):
    """Per-position scalar predictor (the reference's
    fastpitch/length_predictor.py:23): conv, ReLU, LayerNorm (eps 1e-5),
    dropout per layer, then a linear head; x [B, N, D] -> [B, N]."""

    def __init__(self, in_dim: int, filter_size: int = 256,
                 kernel_size: int = 3, n_layers: int = 2,
                 dropout: float = 0.1):
        super().__init__()
        self.p, self.n_layers = dropout, n_layers
        for i in range(n_layers):
            self.add_module(f"conv{i}", SameConv1d(
                in_dim if i == 0 else filter_size, filter_size, kernel_size))
            self.add_module(f"ln{i}", LayerNorm(filter_size))
        self.fc = nn.Linear(filter_size, 1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        m = mask.to(x.dtype)
        h = x * m[:, :, None]
        for i in range(self.n_layers):
            h = getattr(self, f"ln{i}")(F.relu(getattr(self, f"conv{i}")(h)))
            if not deterministic and self.p > 0.0:
                h = dropout(h, self.p, generator)
        return self.fc(h)[..., 0] * m


def sinusoid_positions(t_out: int, dim: int) -> np.ndarray:
    """The sinusoidal position table [t_out, dim] (the reference's
    FFTransformer PositionalEmbedding), float32."""
    pos = np.arange(t_out)[:, None]
    div = np.exp(np.arange(0, dim, 2) * (-np.log(10000.0) / dim))
    pe = np.zeros((t_out, dim), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div[: pe[:, 1::2].shape[1]])
    return pe


def _positions(t_out: int, dim: int, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(sinusoid_positions(t_out, dim)).to(like.device)


class PositionalAttention(nn.Module):
    """Flow-TTS positional attention (the reference's flowtts/model.py:113):
    sinusoidal frame-position queries attend over the encoder states, a
    LayerNorm of the result plus the queries, then a projection to
    ``out_dim``. enc [B, N, D] -> [B, t_out, out_dim]."""

    def __init__(self, enc_dim: int, out_dim: int, num_heads: int = 2):
        super().__init__()
        self.mha = MultiHeadAttention(enc_dim, enc_dim, num_heads,
                                      qkv_features=enc_dim,
                                      out_features=enc_dim)
        self.ln = LayerNorm(enc_dim)
        self.proj = nn.Linear(enc_dim, out_dim)

    def forward(self, enc: torch.Tensor, char_mask: torch.Tensor,
                t_out: int) -> torch.Tensor:
        B, _, D = enc.shape
        q = _positions(t_out, D, enc).expand(B, t_out, D)
        y = self.mha(q, enc, char_mask)
        return self.proj(self.ln(y + q))


def length_regulate(char_feats: torch.Tensor, durations: torch.Tensor,
                    t_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand [B, N, D] char features to [B, t_out, D] frames: frame t
    copies char i iff cumsum(dur)[i-1] <= t < cumsum(dur)[i], as the
    interval matrix [B, t_out, N] times the features. Returns (frames,
    frame_mask [B, t_out])."""
    ends = torch.cumsum(durations, dim=1)
    starts = ends - durations
    t = torch.arange(t_out, device=durations.device,
                     dtype=durations.dtype)[None, :, None]
    A = (t >= starts[:, None, :]) & (t < ends[:, None, :])
    frames = torch.bmm(A.to(char_feats.dtype), char_feats)
    return frames, t[..., 0] < ends[:, -1:]


# -- the flows ------------------------------------------------------------------

def _couple_forward(convinv, wn, half, x, cond):
    """One flow of a training forward on channels-first x: 1x1 mixing,
    then the affine coupling of the first ``half`` channels from the rest.
    -> (x, log_s, log|det W|)."""
    x, logdet = convinv(x)
    xa, xb = x[:, :half], x[:, half:]
    log_s, t = wn.forward_train(xb, cond)
    return torch.cat([xa * torch.exp(log_s) + t, xb], dim=1), log_s, logdet


def _couple_inverse(convinv, wn, half, x, cond, m=None):
    """One flow of an inverse (WN.forward: the kernel on the card)."""
    xa, xb = x[:, :half], x[:, half:]
    log_s, t = wn(xb, cond)
    x = torch.cat([(xa - t) * torch.exp(-log_s), xb], dim=1)
    return convinv.inverse(x if m is None else x * m)


class MelFlowDecoder(nn.Module):
    """Conditional flow over mel frames [B, T, n_mel], conditioned on cond
    [B, T, dec_n_channels]."""

    def __init__(self, cfg: UnTTSConfig):
        super().__init__()
        M = cfg.n_mel_channels
        self.n_flows, self.half = cfg.dec_n_flows, M // 2
        self.convinv = nn.ModuleList(Invertible1x1Conv(M)
                                     for _ in range(cfg.dec_n_flows))
        self.wn = nn.ModuleList(
            WN(M - self.half, M - self.half, cfg.dec_n_channels,
               cfg.dec_n_layers, cfg.dec_n_channels, cfg.dec_kernel_size, "GTU")
            for _ in range(cfg.dec_n_flows))

    def forward(self, mel: torch.Tensor, cond: torch.Tensor,
                frame_mask: torch.Tensor):
        """mel -> (z [B, T, n_mel], sum of log_s, sum of the 1x1
        log-determinants, n_elements); masked frames excluded, and x
        re-masked after every flow (the WN's convs reach past the end, where
        training's zero padding and inference's z differ)."""
        m = frame_mask[:, None, :].to(torch.float32)
        x = mel.transpose(1, 2) * m
        c = cond.transpose(1, 2)
        n_frames = m.sum()
        log_s_sum = logdet_sum = x.new_zeros(())
        for k in range(self.n_flows):
            x, log_s, logdet = _couple_forward(self.convinv[k], self.wn[k],
                                               self.half, x, c)
            x = x * m
            log_s_sum = log_s_sum + (log_s * m).sum()
            logdet_sum = logdet_sum + logdet * n_frames
        return (x.transpose(1, 2), log_s_sum, logdet_sum,
                n_frames * mel.shape[-1])

    @torch.no_grad()
    def inverse(self, z: torch.Tensor, cond: torch.Tensor,
                frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """z [B, T, n_mel] -> mel, with forward's between-flow masking (no
        mask: every frame valid)."""
        m = None if frame_mask is None else \
            frame_mask[:, None, :].to(z.dtype)
        x = z.transpose(1, 2)
        x = x if m is None else x * m
        c = cond.transpose(1, 2).contiguous()
        for k in reversed(range(self.n_flows)):
            x = _couple_inverse(self.convinv[k], self.wn[k], self.half, x, c, m)
        return x.transpose(1, 2)


class VarGlow(nn.Module):
    """Char-level conditional flow over prosody scalars (the reference's
    CVarGlow/VarGlow, untts/waveglow/{cvarglow,varglow}.py): values
    [B, N, C] are grouped ``n_group`` chars a step ([B, N/g, g C], the
    tail group padded by repeating the last char) and go through 1x1
    mixing and WN couplings conditioned on the grouped text features
    (``cond_dim`` wide a char, zero-padded)."""

    def __init__(self, n_channels_in: int, cond_dim: int, n_group: int = 4,
                 n_flows: int = 4, wn_layers: int = 2, wn_channels: int = 64):
        super().__init__()
        C = n_channels_in * n_group
        self.n_in, self.n_group, self.n_flows = n_channels_in, n_group, n_flows
        self.half = C // 2
        self.convinv = nn.ModuleList(Invertible1x1Conv(C)
                                     for _ in range(n_flows))
        self.wn = nn.ModuleList(
            WN(C - self.half, C - self.half, n_group * cond_dim, wn_layers,
               wn_channels, 3, "GTU") for _ in range(n_flows))

    def _pad_len(self, N: int) -> int:
        return -(-N // self.n_group) * self.n_group

    def _squeeze(self, values: torch.Tensor) -> torch.Tensor:
        """[B, N, C] -> [B, g C, ceil(N/g)] channels-first, the tail group
        edge-padded."""
        B, N, C = values.shape
        Np = self._pad_len(N)
        if Np != N:
            values = torch.cat([values, values[:, -1:].expand(B, Np - N, C)], 1)
        return values.reshape(B, Np // self.n_group, -1).transpose(1, 2)

    def _group_cond(self, text_feats: torch.Tensor) -> torch.Tensor:
        """[B, N, D] -> [B, g D, ceil(N/g)], zero-padded."""
        B, N, _ = text_feats.shape
        feats = F.pad(text_feats, (0, 0, 0, self._pad_len(N) - N))
        return feats.reshape(B, feats.shape[1] // self.n_group, -1).transpose(1, 2)

    def forward(self, values: torch.Tensor, text_feats: torch.Tensor,
                char_mask: Optional[torch.Tensor] = None):
        """values [B, N, C], text_feats [B, N, D] -> (z [B, N/g, g C], sum
        of log_s, sum of the log-determinants, n_elements). ``char_mask``
        masks the NLL by group (a group counts while it holds a valid char);
        padded groups' z are zeroed."""
        x = self._squeeze(values.to(torch.float32))
        cond = self._group_cond(text_feats)
        B, gC, Ng = x.shape
        if char_mask is None:
            gmask = x.new_ones((B, Ng))
        else:
            cm = F.pad(char_mask.to(torch.float32),
                       (0, self._pad_len(char_mask.shape[1]) - char_mask.shape[1]))
            gmask = cm.reshape(B, Ng, self.n_group).amax(-1)
        n_groups = gmask.sum()
        log_s_sum = logdet_sum = x.new_zeros(())
        for k in range(self.n_flows):
            x, log_s, logdet = _couple_forward(self.convinv[k], self.wn[k],
                                               self.half, x, cond)
            log_s_sum = log_s_sum + (log_s * gmask[:, None, :]).sum()
            logdet_sum = logdet_sum + logdet * n_groups
        return (x * gmask[:, None, :]).transpose(1, 2), log_s_sum, \
            logdet_sum, n_groups * gC

    @torch.no_grad()
    def inverse(self, z: torch.Tensor, text_feats: torch.Tensor) -> torch.Tensor:
        """z [B, N/g, g C] -> values [B, N', C] (N' = N padded to g)."""
        cond = self._group_cond(text_feats).contiguous()
        x = z.transpose(1, 2)
        for k in reversed(range(self.n_flows)):
            x = _couple_inverse(self.convinv[k], self.wn[k], self.half, x, cond)
        B, _, Ng = x.shape
        return x.transpose(1, 2).reshape(B, Ng * self.n_group, self.n_in)

    @torch.no_grad()
    def sample(self, text_feats: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               sigma: float = 0.7) -> torch.Tensor:
        """Prosody scalars [B, N', C] for [B, N, D] text features from
        z ~ N(0, sigma) drawn from ``generator``."""
        B, N, _ = text_feats.shape
        z = sigma * torch.randn(
            (B, self._pad_len(N) // self.n_group, self.n_group * self.n_in),
            generator=generator, device=text_feats.device)
        return self.inverse(z, text_feats)


def varglow_loss(z, log_s_sum, logdet_w_sum, n_elements,
                 sigma: float = 1.0) -> torch.Tensor:
    """Per-element NLL of the prosody flow."""
    z = z.float()
    return ((z * z).sum() / (2.0 * sigma * sigma) - log_s_sum
            - logdet_w_sum) / n_elements


# -- the model -------------------------------------------------------------------

class UnTTS(nn.Module):
    """NAR flow TTS: ``forward`` is the training forward, ``inference``
    generates."""

    def __init__(self, cfg: UnTTSConfig, device: str | torch.device = "cuda"):
        super().__init__()
        refuse_bf16(cfg.dtype, "UnTTS", "bf16 UnTTS and GAN-TTS")
        self.cfg = cfg
        D = cfg.symbols_embedding_dim
        enc_dim = D + cfg.speaker_embedding_dim
        self.embedding = nn.Embedding(cfg.n_symbols, D)
        self.speaker_embedding = nn.Embedding(cfg.n_speakers,
                                              cfg.speaker_embedding_dim)
        self.pos_scale = nn.Parameter(torch.ones(()))
        for i in range(cfg.enc_layers):
            self.add_module(f"enc{i}", FFTBlock(
                D, cfg.enc_heads, cfg.enc_ffn_dim, cfg.enc_kernel_size,
                cfg.dropout))

        def predictor():
            return TemporalPredictor(enc_dim, cfg.predictor_filter_size,
                                     cfg.predictor_kernel_size,
                                     cfg.predictor_layers, cfg.dropout)

        self.duration_predictor = predictor()
        if cfg.predict_f0:
            self.f0_predictor = predictor()
        if cfg.predict_energy:
            self.energy_predictor = predictor()
        if cfg.use_positional_attention:
            self.pos_attention = PositionalAttention(
                enc_dim, cfg.dec_n_channels, cfg.pos_attention_heads)
        else:
            self.cond_proj = nn.Linear(enc_dim, cfg.dec_n_channels)
        if cfg.predict_f0 or cfg.predict_energy:
            # frame-rate [voiced, f0, energy] conditioning of the decoder
            # (the reference's untts/model.py:437,538,649)
            self.prosody_proj = nn.Linear(3, cfg.dec_n_channels)
        if cfg.use_varglow:
            self.varglow = VarGlow(1 + int(cfg.predict_f0), enc_dim,
                                   cfg.varglow_n_group, cfg.varglow_n_flows)
        self.decoder = MelFlowDecoder(cfg)
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.pos_scale.device

    def _encode(self, text, text_lengths, speaker_id, deterministic=True,
                generator=None):
        """-> (enc [B, N, D + speaker dim], char_mask [B, N])."""
        cfg = self.cfg
        N = text.shape[1]
        mask = get_mask_from_lengths(text_lengths, N)
        x = self.embedding(torch.clamp(text, 0, cfg.n_symbols - 1))
        pe = _positions(N, cfg.symbols_embedding_dim, x)
        x = (x + self.pos_scale * pe[None]) * mask[:, :, None].to(x.dtype)
        for i in range(cfg.enc_layers):
            x = getattr(self, f"enc{i}")(x, mask, deterministic, generator)
        spk = self.speaker_embedding(speaker_id)
        x = torch.cat([x, spk[:, None, :].expand(-1, N, -1)], dim=-1)
        return x, mask

    def _prosody_cond(self, f0_frames, energy_frames, voiced_frames, shape):
        """[B, T] frame prosody -> the dec_n_channels conditioning term,
        always from three channels [voiced, f0, energy] (zeros for the
        absent ones; voiced from f0 > 0 when not given)."""
        zero = torch.zeros(shape, device=self.device)
        f0f = zero if f0_frames is None else f0_frames.float()
        en = zero if energy_frames is None else energy_frames.float()
        vo = (f0f > 0).float() if voiced_frames is None else voiced_frames.float()
        return self.prosody_proj(torch.stack([vo, f0f, en], dim=-1))

    def forward(self, text, text_lengths, mels, mel_lengths, speaker_id,
                durations, f0=None, energy=None, frame_f0=None,
                frame_energy=None, frame_voiced=None,
                deterministic: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """Training forward with ground-truth char durations [B, N] (ints),
        char f0 / energy [B, N] (the predictors' and VarGlow's targets) and
        frame-rate f0 / energy / voiced [B, T] (the decoder's
        conditioning). Returns the flow NLL's terms (z, log_s_sum,
        logdet_w_sum, n_elements, frame_mask), the predictors' outputs and
        char_mask, and VarGlow's terms (varglow_*) when it has one."""
        cfg = self.cfg
        enc, char_mask = self._encode(text, text_lengths, speaker_id,
                                      deterministic, generator)
        pred = lambda p: p(enc, char_mask, deterministic, generator)  # noqa: E731
        out: Dict[str, torch.Tensor] = {
            "log_dur_pred": pred(self.duration_predictor),
            "char_mask": char_mask}
        if cfg.predict_f0:
            out["f0_pred"] = pred(self.f0_predictor)
        if cfg.predict_energy:
            out["energy_pred"] = pred(self.energy_predictor)

        if cfg.use_varglow:
            # padded chars take the row's last valid value (channel mixing
            # blends a boundary group's chars); the NLL masks by group
            last = torch.clamp(text_lengths - 1, min=0)[:, None]

            def edge_fill(v):
                return torch.where(char_mask, v,
                                   torch.gather(v, 1, last).expand_as(v))

            vals = [edge_fill(torch.log(torch.clamp(durations.float(),
                                                    min=1e-1)))]
            if cfg.predict_f0 and f0 is not None:
                vals.append(edge_fill(f0.float()))
            vz, vls, vlw, vn = self.varglow(torch.stack(vals, dim=-1), enc,
                                            char_mask)
            out.update({"varglow_z": vz, "varglow_log_s": vls,
                        "varglow_logdet_w": vlw, "varglow_n": vn})

        T = mels.shape[1]
        frame_mask = get_mask_from_lengths(mel_lengths, T)
        fm = frame_mask[:, :, None].to(torch.float32)
        if cfg.use_positional_attention:
            cond = self.pos_attention(enc, char_mask, T) * fm
        else:
            cond = self.cond_proj(length_regulate(enc, durations, T)[0])
        if cfg.predict_f0 or cfg.predict_energy:
            cond = cond + self._prosody_cond(frame_f0, frame_energy,
                                             frame_voiced, (mels.shape[0], T)) * fm
        z, log_s, logdet_w, n_valid = self.decoder(mels, cond, frame_mask)
        out.update({"z": z, "log_s_sum": log_s, "logdet_w_sum": logdet_w,
                    "n_elements": n_valid, "frame_mask": frame_mask})
        return out

    @torch.no_grad()
    def inference(self, text, text_lengths, speaker_id,
                  generator: Optional[torch.Generator] = None,
                  max_frames: int = 2048, duration_scale: float = 1.0,
                  sigma: Optional[float] = None, sample_prosody: bool = False,
                  prosody_sigma: float = 0.7, z: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
        """Parallel generation: predict (or, with ``sample_prosody`` and
        VarGlow, sample) durations, expand, invert the mel flow. The latents
        come from ``generator`` (VarGlow's first); the mel flow's is the
        ``z`` given, if any. -> {mel_outputs [B, max_frames, n_mel] (zero
        past each length), mel_lengths, durations}."""
        cfg = self.cfg
        sigma = cfg.sigma if sigma is None else sigma
        with full_float32():
            enc, char_mask = self._encode(text, text_lengths, speaker_id)
            B, N = char_mask.shape
            char_f0 = char_energy = None
            if sample_prosody and cfg.use_varglow:
                sampled = self.varglow.sample(enc, generator, prosody_sigma)
                log_dur = sampled[:, :N, 0]
                if cfg.predict_f0 and sampled.shape[-1] > 1:
                    char_f0 = sampled[:, :N, 1]
            else:
                log_dur = self.duration_predictor(enc, char_mask)
            if char_f0 is None and cfg.predict_f0:
                char_f0 = self.f0_predictor(enc, char_mask)
            if cfg.predict_energy:
                char_energy = self.energy_predictor(enc, char_mask)
            dur = torch.round(torch.exp(log_dur) * duration_scale)
            dur = (torch.clamp(dur, 0.0, cfg.max_frames_per_char)
                   * char_mask).long()
            if cfg.use_positional_attention:
                # the durations set only the total length (Flow-TTS)
                total = torch.clamp(dur.sum(1), max=max_frames)
                frame_mask = (torch.arange(max_frames, device=dur.device)[None]
                              < total[:, None])
                cond = self.pos_attention(enc, char_mask, max_frames) \
                    * frame_mask[:, :, None]
            else:
                frames, frame_mask = length_regulate(enc, dur, max_frames)
                cond = self.cond_proj(frames)
            fm = frame_mask[:, :, None].to(torch.float32)
            if cfg.predict_f0 or cfg.predict_energy:
                # the predicted or sampled char prosody over the same
                # duration matrix conditions the decoder
                zc = torch.zeros((B, N), device=enc.device)
                chans = torch.stack(
                    [zc if char_f0 is None else char_f0.float(),
                     zc if char_energy is None else char_energy.float()], -1)
                pros, _ = length_regulate(chans, dur, max_frames)
                cond = cond + self._prosody_cond(pros[..., 0], pros[..., 1],
                                                 None, (B, max_frames)) * fm
            if z is None:
                z = sigma * torch.randn((B, max_frames, cfg.n_mel_channels),
                                        generator=generator, device=enc.device)
            mel = self.decoder.inverse(z, cond, frame_mask)
        return {"mel_outputs": mel * fm,
                "mel_lengths": torch.clamp(dur.sum(1), max=max_frames),
                "durations": dur}


def untts_loss(out: Dict[str, torch.Tensor], gt: Dict[str, torch.Tensor],
               sigma: float = 1.0, dur_weight: float = 0.1,
               f0_weight: float = 0.1, energy_weight: float = 0.1
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Flow NLL + log-duration MSE + masked f0 / energy MSE."""
    z = out["z"].float()
    m = out["frame_mask"][:, :, None].float()
    n = torch.clamp(out["n_elements"], min=1.0)
    nll = ((z * z * m).sum() / (2.0 * sigma * sigma)
           - out["log_s_sum"] - out["logdet_w_sum"]) / n
    loss_dict = {"flow_nll": nll}
    cmask = out["char_mask"].float()
    n_char = torch.clamp(cmask.sum(), min=1.0)
    log_dur_gt = torch.log(torch.clamp(gt["durations"].float(), min=1e-1))
    dur_mse = (((out["log_dur_pred"] - log_dur_gt) ** 2) * cmask).sum() / n_char
    loss_dict["dur_MSE"] = dur_mse
    total = nll + dur_weight * dur_mse
    if "f0_pred" in out and "f0" in gt:
        f0_mse = (((out["f0_pred"] - gt["f0"]) ** 2) * cmask).sum() / n_char
        loss_dict["f0_MSE"] = f0_mse
        total = total + f0_weight * f0_mse
    if "energy_pred" in out and "energy" in gt:
        e_mse = (((out["energy_pred"] - gt["energy"]) ** 2) * cmask).sum() \
            / n_char
        loss_dict["energy_MSE"] = e_mse
        total = total + energy_weight * e_mse
    loss_dict["loss"] = total
    return total, loss_dict

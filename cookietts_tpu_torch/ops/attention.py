"""The decoder's three attention families (cookietts_tpu/ops/attention.py),
one per ``attention_type``:

- 0, :class:`LocationSensitiveAttention`: location-sensitive attention with
  windowing. Submodule and parameter names follow the reference torch
  checkpoint (``query_layer.linear_layer``,
  ``location_layer.location_conv.conv``, ``windowed_att_pos_offset``,
  ``softmax_temp``, ...). The position-smoothing factor belongs to the
  decoder in that checkpoint, so the decoder owns it and passes it in. Each
  step's energies, mask, softmax and context run in the ``attention_step``
  kernel.
- 1, :class:`GMMAttention`: the reference's monotonic mixture-of-gaussians
  "erf window" attention, under the reference's names (``F.0.linear_layer``,
  ``F.2``). Padded positions score 0, not -inf (the reference's
  ``score_mask_value=0``), so they take softmax weight.
- 2, :class:`DynamicConvolutionAttention`: the JAX package's DCA (static and
  query-generated dynamic filters over the previous weights plus a
  beta-binomial prior), which differs from the reference's on purpose; its
  parameters carry the JAX module names (``dynamic_fc``, ``static_conv``,
  ``W_static``, ``W_dynamic``, ``v``), since no reference checkpoint fits it.

GMM and DCA run in plain PyTorch, as JAX runs them in plain XLA.

Location-sensitive attention over a bf16 memory (the bf16 serving path)
follows the JAX module at ``dtype=bfloat16`` with its Pallas kernel
(cookietts_tpu/ops/attention.py:149-170): the query, location and memory
projections are bf16 (``ops/precision.py``), the location features are
rounded to bf16 before the location conv, the step runs in the bf16 form of
``attention_step`` (v, the mask, the softmax, the weights and the position
f32) and the context is rounded to bf16. GMM and DCA refuse bf16 (a later
slice).
Each class has ``precompute(memory, lengths)`` (once per utterance),
``init_state(batch, t_enc, device)`` and
``forward(query, memory, const, state, exp_smoothing_factor=None)`` ->
``(context, weights, state)``.
"""
from __future__ import annotations

from math import lgamma
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import hopper_kernels as hk
from . import precision


class LinearNorm(nn.Module):
    """A Linear under the reference's ``<name>.linear_layer`` key."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True):
        super().__init__()
        self.linear_layer = nn.Linear(in_dim, out_dim, bias=bias)

    def forward(self, x):
        return self.linear_layer(x)


class ConvNorm(nn.Module):
    """A Conv1d with "same" padding under the reference's ``<name>.conv``
    key; channels-first [B, C, T]."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 bias: bool = True):
        super().__init__()
        self.conv = nn.Conv1d(in_ch, out_ch, kernel_size,
                              padding=(kernel_size - 1) // 2, bias=bias)

    def forward(self, x):
        return self.conv(x)


class LocationLayer(nn.Module):
    def __init__(self, n_filters: int, kernel_size: int, attention_dim: int):
        super().__init__()
        self.location_conv = ConvNorm(2, n_filters, kernel_size, bias=False)
        self.location_dense = LinearNorm(n_filters, attention_dim, bias=False)

    def forward(self, loc_feats, dtype=torch.float32):   # [B, 2, T] -> [B, T, A]
        """In ``dtype`` (ops/precision.py): bf16 rounds the features too."""
        conv = precision.conv1d(self.location_conv, loc_feats.to(dtype), dtype)
        return precision.dense(self.location_dense, conv.transpose(1, 2), dtype)


class AttentionState(NamedTuple):
    weights: torch.Tensor       # [B, T_enc] previous attention weights
    weights_cum: torch.Tensor   # [B, T_enc] cumulative attention weights
    position: torch.Tensor      # [B] exp-smoothed expected position
    mu: torch.Tensor            # [B, K] GMM means; [B, 1] zeros otherwise


def _init_state(batch: int, t_enc: int, device, k: int = 1,
                first_token: bool = False) -> AttentionState:
    """Zero weights (a one-hot on token 0 with ``first_token``, as DCA
    seeds them), zero cumulative weights and position, ``k`` means."""
    w = torch.zeros((batch, t_enc), device=device)
    if first_token:
        w[:, 0] = 1.0
    return AttentionState(w, torch.zeros((batch, t_enc), device=device),
                          torch.zeros(batch, device=device),
                          torch.zeros((batch, k), device=device))


def _length_mask(memory: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    return (torch.arange(memory.shape[1], device=memory.device)[None, :]
            < lengths[:, None])


def _attend(weights: torch.Tensor, memory: torch.Tensor):
    """(context [B, D], expected position [B]) of weights [B, T]."""
    T = weights.shape[1]
    context = torch.einsum("bt,btd->bd", weights, memory)
    return context, (weights * torch.arange(T, device=weights.device,
                                            dtype=torch.float32)).sum(-1)


class LocationSensitiveAttention(nn.Module):
    def __init__(self, query_dim: int, memory_dim: int, attention_dim: int = 128,
                 location_n_filters: int = 32, location_kernel_size: int = 31,
                 windowed_attention_range: int = 0,
                 windowed_att_pos_learned: bool = True,
                 windowed_att_pos_offset: float = 0.0,
                 learn_temperature: bool = False):
        super().__init__()
        self.query_layer = LinearNorm(query_dim, attention_dim, bias=False)
        self.memory_layer = LinearNorm(memory_dim, attention_dim, bias=False)
        self.v = LinearNorm(attention_dim, 1, bias=False)
        self.location_layer = LocationLayer(location_n_filters,
                                            location_kernel_size, attention_dim)
        self.window_range = windowed_attention_range
        self.pos_learned = windowed_att_pos_learned
        self.pos_offset = windowed_att_pos_offset
        if windowed_att_pos_learned:
            self.windowed_att_pos_offset = nn.Parameter(torch.zeros(1))
        if learn_temperature:
            self.softmax_temp = nn.Parameter(torch.ones(1))
        self.learn_temperature = learn_temperature

    def precompute(self, memory: torch.Tensor,
                   memory_lengths: torch.Tensor) -> Dict[str, Any]:
        T = memory.shape[1]
        return {
            "processed_memory": precision.dense(self.memory_layer, memory,
                                                memory.dtype).contiguous(),
            "mask": torch.arange(T, device=memory.device)[None, :]
                    < memory_lengths[:, None],
            "lengths": memory_lengths,
        }

    @staticmethod
    def init_state(batch: int, t_enc: int, device) -> AttentionState:
        return _init_state(batch, t_enc, device)

    def window_mask(self, position: torch.Tensor, lengths: torch.Tensor,
                    t_enc: int) -> torch.Tensor:
        """Offset the tracked position, clamp it into [range, len-1-range],
        and keep the INCLUSIVE [round(pos-range), +2*range] index window.
        torch.round rounds half to even, like jnp.round."""
        r = float(self.window_range)
        pos = position
        if self.pos_learned:
            pos = pos + self.windowed_att_pos_offset[0]
        elif self.pos_offset:
            pos = pos + self.pos_offset
        max_end = lengths.float() - 1.0 - r
        pos = torch.minimum(pos.clamp_min(r), max_end)
        start = torch.round((pos - r).clamp_min(0.0))[:, None]
        idx = torch.arange(t_enc, device=position.device,
                           dtype=torch.float32)[None, :]
        return (idx >= start) & (idx <= start + 2.0 * r)

    def forward(self, query: torch.Tensor, memory: torch.Tensor,
                const: Dict[str, Any], state: AttentionState,
                exp_smoothing_factor: Optional[torch.Tensor] = None):
        """query [B, rnn_dim]; memory [B, T, D] -> (context, weights, state)."""
        T = state.weights.shape[1]
        dt = memory.dtype
        processed_query = precision.dense(self.query_layer, query, dt)
        loc = torch.stack([state.weights, state.weights_cum], dim=1)
        processed_loc = self.location_layer(loc, dt)
        mask = const["mask"]
        if self.window_range > 0:
            mask = mask & self.window_mask(state.position, const["lengths"], T)
        scale = F.softplus(self.softmax_temp) if self.learn_temperature else None
        context, weights = hk.attention_step(
            processed_query.to(dt).contiguous(), processed_loc.to(dt).contiguous(),
            const["processed_memory"], self.v.linear_layer.weight[0].contiguous(),
            memory, mask.contiguous(), scale)
        context = context.to(dt)
        expected = (weights * torch.arange(T, device=weights.device,
                                           dtype=torch.float32)).sum(-1)
        if self.window_range > 0:
            s = torch.sigmoid(exp_smoothing_factor[0])
            position = state.position * s + expected * (1.0 - s)
        else:
            position = expected
        return context, weights, AttentionState(
            weights, state.weights_cum + weights, position, state.mu)


class GMMAttention(nn.Module):
    """Monotonic GMM attention (attention_type 1): from tanh(query) the
    reference's ``F`` (Linear, tanh, Linear) predicts each mixture's weight,
    step and scale; the means only move forward (mu += sigmoid(delta), at
    least ``delta_min`` when that is nonzero, plus ``delta_offset``); each
    mixture puts the mass of an erf window of width 1 on every encoder
    index; a softmax over the positions follows, padded ones scoring 0."""

    def __init__(self, query_dim: int, n_mixtures: int = 5,
                 attention_dim: int = 128, delta_min: float = 0.0,
                 delta_offset: float = 0.0):
        super().__init__()
        self.n_mixtures = n_mixtures
        self.delta_min, self.delta_offset = delta_min, delta_offset
        self.F = nn.Sequential(LinearNorm(query_dim, attention_dim), nn.Tanh(),
                               nn.Linear(attention_dim, 3 * n_mixtures,
                                         bias=False))

    def precompute(self, memory: torch.Tensor,
                   memory_lengths: torch.Tensor) -> Dict[str, Any]:
        return {"mask": _length_mask(memory, memory_lengths)}

    def init_state(self, batch: int, t_enc: int, device) -> AttentionState:
        return _init_state(batch, t_enc, device, k=self.n_mixtures)

    def forward(self, query: torch.Tensor, memory: torch.Tensor,
                const: Dict[str, Any], state: AttentionState,
                exp_smoothing_factor: Optional[torch.Tensor] = None):
        T = state.weights.shape[1]
        w_hat, delta_hat, scale_hat = self.F(torch.tanh(query)).float().chunk(3, -1)
        delta = torch.sigmoid(delta_hat)
        if self.delta_min:
            delta = delta.clamp_min(self.delta_min)
        if self.delta_offset:
            delta = delta + self.delta_offset
        loc = state.mu + delta                                      # [B, K]
        scale = (torch.sigmoid(scale_hat) * 2.0 + 1.0)[:, None, :]  # [B, 1, K]
        d = loc[:, None, :] - torch.arange(T, device=loc.device,
                                           dtype=torch.float32)[None, :, None]
        z = 0.5 * (torch.erf((d + 0.5) * scale) - torch.erf((d - 0.5) * scale))
        energies = torch.einsum("btk,bk->bt", z, torch.sigmoid(w_hat))
        energies = torch.where(const["mask"], energies, 0.0)
        weights = torch.softmax(energies, -1)
        context, expected = _attend(weights, memory)
        return context, weights, AttentionState(
            weights, state.weights_cum + weights, expected, loc)


def beta_binomial_prior(length: int, alpha: float, beta: float) -> np.ndarray:
    """The beta-binomial prior's ``length`` taps (DCA's "move forward about
    one token a step" filter)."""
    def log_beta(a, b):
        return lgamma(a) + lgamma(b) - lgamma(a + b)

    n = length - 1
    return np.asarray([np.exp(lgamma(n + 1) - lgamma(k + 1) - lgamma(n - k + 1)
                              + log_beta(k + alpha, n - k + beta)
                              - log_beta(alpha, beta))
                       for k in range(length)], np.float32)


class DynamicConvolutionAttention(nn.Module):
    """Dynamic convolution attention (attention_type 2), as the JAX package
    computes it: energies = v . tanh(W_static(static conv of the previous
    weights) + W_dynamic(their convolution with filters generated from the
    query)) + log(prior), the prior the causal filtering of the previous
    weights by the reversed beta-binomial taps, clipped at 1e-6. Padded
    positions take finfo(float32).min / 2. The weights start as a one-hot
    on token 0."""

    def __init__(self, query_dim: int, attention_dim: int = 128,
                 static_channels: int = 8, static_kernel_size: int = 21,
                 dynamic_channels: int = 8, dynamic_kernel_size: int = 21,
                 prior_length: int = 11, alpha: float = 0.1, beta: float = 0.9):
        super().__init__()
        self.dynamic_channels = dynamic_channels
        self.dynamic_kernel_size = dynamic_kernel_size
        self.dynamic_fc = nn.Linear(query_dim,
                                    dynamic_channels * dynamic_kernel_size)
        self.static_conv = nn.Conv1d(1, static_channels, static_kernel_size,
                                     padding=(static_kernel_size - 1) // 2,
                                     bias=False)
        self.W_static = nn.Linear(static_channels, attention_dim, bias=False)
        self.W_dynamic = nn.Linear(dynamic_channels, attention_dim)
        self.v = nn.Linear(attention_dim, 1, bias=False)
        prior = beta_binomial_prior(prior_length, alpha, beta)[::-1].copy()
        self.register_buffer("prior_filter", torch.from_numpy(prior).view(1, 1, -1),
                             persistent=False)

    def precompute(self, memory: torch.Tensor,
                   memory_lengths: torch.Tensor) -> Dict[str, Any]:
        return {"mask": _length_mask(memory, memory_lengths)}

    @staticmethod
    def init_state(batch: int, t_enc: int, device) -> AttentionState:
        return _init_state(batch, t_enc, device, first_token=True)

    def forward(self, query: torch.Tensor, memory: torch.Tensor,
                const: Dict[str, Any], state: AttentionState,
                exp_smoothing_factor: Optional[torch.Tensor] = None):
        prev = state.weights
        B = prev.shape[0]
        L = self.prior_filter.shape[-1]
        prior = F.conv1d(F.pad(prev, (L - 1, 0))[:, None], self.prior_filter)[:, 0]
        prior_energy = torch.log(prior.clamp_min(1e-6))
        static = self.static_conv(prev[:, None]).transpose(1, 2)    # [B, T, Cs]
        K = self.dynamic_kernel_size
        filt = self.dynamic_fc(torch.tanh(query)).view(B, K, self.dynamic_channels)
        patches = F.pad(prev, (K // 2, K // 2)).unfold(1, K, 1)     # [B, T, K]
        dynamic = torch.einsum("btk,bkc->btc", patches, filt)       # [B, T, Cd]
        energies = self.v(torch.tanh(self.W_static(static) + self.W_dynamic(
            dynamic)))[..., 0].float() + prior_energy
        energies = torch.where(const["mask"], energies,
                               torch.finfo(torch.float32).min / 2.0)
        weights = torch.softmax(energies, -1)
        context, expected = _attend(weights, memory)
        return context, weights, AttentionState(
            weights, state.weights_cum + weights, expected, state.mu)

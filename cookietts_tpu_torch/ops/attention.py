"""Location-sensitive attention with windowing, attention_type 0
(cookietts_tpu/ops/attention.py:LocationSensitiveAttention).

Submodule and parameter names follow the reference torch checkpoint
(``query_layer.linear_layer``, ``location_layer.location_conv.conv``,
``windowed_att_pos_offset``, ``softmax_temp``, ...). The position-smoothing
factor belongs to the decoder in that checkpoint, so the decoder owns it and
passes it in. Each step's energies, mask, softmax and context run in the
``attention_step`` kernel.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import hopper_kernels as hk


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

    def forward(self, loc_feats):          # [B, 2, T] -> [B, T, A]
        return self.location_dense(self.location_conv(loc_feats).transpose(1, 2))


class AttentionState(NamedTuple):
    weights: torch.Tensor       # [B, T_enc] previous attention weights
    weights_cum: torch.Tensor   # [B, T_enc] cumulative attention weights
    position: torch.Tensor      # [B] exp-smoothed expected position


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
            "processed_memory": self.memory_layer(memory).contiguous(),
            "mask": torch.arange(T, device=memory.device)[None, :]
                    < memory_lengths[:, None],
            "lengths": memory_lengths,
        }

    @staticmethod
    def init_state(batch: int, t_enc: int, device) -> AttentionState:
        z = torch.zeros((batch, t_enc), device=device)
        return AttentionState(z, z.clone(), torch.zeros(batch, device=device))

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
        processed_query = self.query_layer(query)
        loc = torch.stack([state.weights, state.weights_cum], dim=1)
        processed_loc = self.location_layer(loc)
        mask = const["mask"]
        if self.window_range > 0:
            mask = mask & self.window_mask(state.position, const["lengths"], T)
        scale = F.softplus(self.softmax_temp) if self.learn_temperature else None
        context, weights = hk.attention_step(
            processed_query.float().contiguous(), processed_loc.float().contiguous(),
            const["processed_memory"], self.v.linear_layer.weight[0].contiguous(),
            memory, mask.contiguous(), scale)
        expected = (weights * torch.arange(T, device=weights.device,
                                           dtype=torch.float32)).sum(-1)
        if self.window_range > 0:
            s = torch.sigmoid(exp_smoothing_factor[0])
            position = state.position * s + expected * (1.0 - s)
        else:
            position = expected
        return context, weights, AttentionState(
            weights, state.weights_cum + weights, position)

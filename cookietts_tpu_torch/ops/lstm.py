"""Zoneout LSTM cell, eval form (cookietts_tpu/ops/lstm.py:ZoneoutLSTMCell).

Parameters keep the reference torch names and layout (``weight_ih`` [4H, In],
``weight_hh`` [4H, H], ``bias_ih``, ``bias_hh``, gate order i, f, g, o), so
reference checkpoints load as they are. The step runs as ONE
``[x; h] @ W[F, 4H]`` product with the forget gate's +1 added inside the
``lstm_gates`` kernel, like the JAX cell; W and the bias (with that +1 taken
out) are derived from the parameters once and rebuilt only when they change.
Eval applies no zoneout blend and no dropout, like the JAX cell's
deterministic branch.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from . import hopper_kernels as hk


class ZoneoutLSTMCell(nn.Module):
    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        H = hidden_size
        self.weight_ih = nn.Parameter(torch.empty(4 * H, input_size))
        self.weight_hh = nn.Parameter(torch.empty(4 * H, H))
        self.bias_ih = nn.Parameter(torch.empty(4 * H))
        self.bias_hh = nn.Parameter(torch.empty(4 * H))
        bound = H ** -0.5
        for p in self.parameters():
            nn.init.uniform_(p, -bound, bound)

    def fused(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(W [In+H, 4H], bias [4H]) in the kernel's layout; the bias has
        the forget block's +1 taken out because the kernel adds it."""
        def build():
            H = self.hidden_size
            w = torch.cat([self.weight_ih.t(), self.weight_hh.t()], 0)
            b = (self.bias_ih + self.bias_hh).clone()
            b[H:2 * H] -= 1.0
            return w.float().contiguous(), b.float().contiguous()
        return hk.derived(self, "_fused", list(self.parameters()), build)

    def forward(self, x: torch.Tensor,
                state: Tuple[torch.Tensor, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, In]; state (c, h) [B, H] f32 -> new (c, h)."""
        c, h = state
        w, b = self.fused()
        xh = torch.cat([x, h.to(x.dtype)], dim=-1).float().contiguous()
        return hk.lstm_gates(xh, w, b, c.contiguous())

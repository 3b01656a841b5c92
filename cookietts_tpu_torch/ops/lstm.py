"""Zoneout LSTM cell (cookietts_tpu/ops/lstm.py:ZoneoutLSTMCell).

Parameters keep the reference torch names and layout (``weight_ih`` [4H, In],
``weight_hh`` [4H, H], ``bias_ih``, ``bias_hh``, gate order i, f, g, o), so
reference checkpoints load as they are. The step runs as ONE
``[x; h] @ W[F, 4H]`` product with the forget gate's +1 added inside the
``lstm_gates`` kernel, like the JAX cell; W and the bias (with that +1 taken
out) are derived from the parameters. In eval they are cached and rebuilt
only when the parameters change. In training the caller builds them once per
model call with ``fused()`` (so one ``cat`` gathers every step's gradient)
and passes them to each step.

The JAX cell has one bias where the reference has two, so ``bias_hh`` is
frozen (``requires_grad=False``): Adam moves the pair's sum as JAX moves its
one bias. Zoneout and dropout follow the JAX cell outside the kernel: with
``zoneout`` > 0 in training each state element keeps its previous value with
probability ``zoneout``, and the dropout branch is not taken; else dropout
``dropout`` on the new h. Eval applies neither (no zoneout blend).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from . import hopper_kernels as hk


class ZoneoutLSTMCell(nn.Module):
    def __init__(self, input_size: int, hidden_size: int,
                 zoneout: float = 0.0, dropout: float = 0.0):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.zoneout, self.dropout = zoneout, dropout
        H = hidden_size
        self.weight_ih = nn.Parameter(torch.empty(4 * H, input_size))
        self.weight_hh = nn.Parameter(torch.empty(4 * H, H))
        self.bias_ih = nn.Parameter(torch.empty(4 * H))
        self.bias_hh = nn.Parameter(torch.empty(4 * H), requires_grad=False)
        bound = H ** -0.5
        for p in self.parameters():
            nn.init.uniform_(p, -bound, bound)

    def _build(self) -> Tuple[torch.Tensor, torch.Tensor]:
        H = self.hidden_size
        w = torch.cat([self.weight_ih.t(), self.weight_hh.t()], 0)
        b = self.bias_ih + self.bias_hh
        b = torch.cat([b[:H], b[H:2 * H] - 1.0, b[2 * H:]])
        return w.float().contiguous(), b.float().contiguous()

    def fused(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(W [In+H, 4H], bias [4H]) in the kernel's layout; the bias has
        the forget block's +1 taken out because the kernel adds it. Under
        autograd with trainable weights they are built with gradient;
        otherwise cached on the module."""
        if torch.is_grad_enabled() and self.weight_ih.requires_grad:
            return self._build()
        return hk.derived(self, "_fused", list(self.parameters()), self._build)

    def forward(self, x: torch.Tensor,
                state: Tuple[torch.Tensor, torch.Tensor],
                fused: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, In]; state (c, h) [B, H] f32 -> new (c, h). ``fused`` is
        ``self.fused()`` built by the caller; ``generator`` draws zoneout
        and dropout in training."""
        c, h = state
        w, b = fused if fused is not None else self.fused()
        xh = torch.cat([x, h.to(x.dtype)], dim=-1).float().contiguous()
        c_new, h_new = hk.lstm_gates(xh, w, b, c.contiguous())
        if not self.training:
            return c_new, h_new
        if self.zoneout > 0.0:
            zc = torch.rand(c.shape, generator=generator, device=c.device)
            zh = torch.rand(h.shape, generator=generator, device=h.device)
            c_new = torch.where(zc < self.zoneout, c, c_new)
            h_new = torch.where(zh < self.zoneout, h, h_new)
        elif self.dropout > 0.0:
            keep = torch.rand(h.shape, generator=generator,
                              device=h.device) < 1.0 - self.dropout
            h_new = torch.where(keep, h_new / (1.0 - self.dropout), 0.0)
        return c_new, h_new

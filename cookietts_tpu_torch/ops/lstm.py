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

Under tensor parallelism (parallel/tp.py, ``self.tp`` set by
``shard_model``) the cell is sharded by hidden unit: rank k holds, for units
[kH/N, (k+1)H/N), the rows of all four gate blocks of ``weight_ih`` /
``weight_hh`` / the biases, and that slice of ``c``. It runs ``lstm_gates``
on the full ``xh`` with its W [In+H, 4H/N], gets its slice of (c, h), and
all-gathers h (the next step's input and attention's query). The zoneout
and dropout masks are drawn at the full [B, H] shape from the shared
generator and sliced (c) or applied to the gathered h, so N ranks draw what
one process draws.

A bf16 ``x`` runs the cell as the JAX cell does at ``dtype=bfloat16`` with
its Pallas kernel (cookietts_tpu/ops/lstm.py:64-70): ``[x; h]``, W and the
bias rounded to bf16 (bf16 copies of W and the bias, cached as the f32 ones
are), the gates in f32 inside the bf16 form of ``lstm_gates``, c and h
kept in f32. The tp-sharded cell refuses bf16 (a later slice).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..parallel.mesh import draw_rows
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

    @property
    def state_width(self) -> int:
        """The width of this rank's c: H, or H / N under tp."""
        return self.weight_ih.shape[0] // 4

    def _build(self) -> Tuple[torch.Tensor, torch.Tensor]:
        H = self.state_width
        w = torch.cat([self.weight_ih.t(), self.weight_hh.t()], 0)
        b = self.bias_ih + self.bias_hh
        b = torch.cat([b[:H], b[H:2 * H] - 1.0, b[2 * H:]])
        return w.float().contiguous(), b.float().contiguous()

    def fused(self, dtype: torch.dtype = torch.float32
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(W [In+H, 4H], bias [4H]) in the kernel's layout, in ``dtype``;
        the bias has the forget block's +1 taken out because the kernel adds
        it. Under autograd with trainable weights they are built with
        gradient; otherwise cached on the module."""
        if dtype != torch.float32:
            return hk.derived(self, "_fused_bf16", list(self.parameters()),
                              lambda: tuple(t.to(dtype) for t in self._build()))
        if torch.is_grad_enabled() and self.weight_ih.requires_grad:
            return self._build()
        return hk.derived(self, "_fused", list(self.parameters()), self._build)

    def forward(self, x: torch.Tensor,
                state: Tuple[torch.Tensor, torch.Tensor],
                fused: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, In]; state (c, h) [B, H] f32 -> new (c, h) (c [B, H/N]
        under tp). ``fused`` is ``self.fused()`` built by the caller;
        ``generator`` draws zoneout and dropout in training."""
        tp = getattr(self, "tp", None)
        c, h = state
        if x.dtype == torch.bfloat16:
            if tp is not None:
                raise NotImplementedError(
                    "a tp-sharded LSTM cell in bfloat16 comes with a later "
                    "slice of the port (bf16 tp and sp); it runs in float32")
            w, b = self.fused(x.dtype)
            xh = torch.cat([x, h.to(x.dtype)], dim=-1).contiguous()
            return hk.lstm_gates(xh, w, b, c.contiguous())
        w, b = fused if fused is not None else self.fused()
        xh = torch.cat([x, h.to(x.dtype)], dim=-1).float().contiguous()
        if tp is not None:
            xh = tp.copy_in(xh)
        c_new, h_new = hk.lstm_gates(xh, w, b, c.contiguous())
        if tp is not None:
            h_new = tp.gather(h_new, -1)
        if not self.training:
            return c_new, h_new
        if self.zoneout > 0.0:
            full = (h.shape[0], self.hidden_size)
            zc = draw_rows(torch.rand, full, generator=generator,
                           device=c.device)
            if tp is not None:
                zc = zc[:, tp.part(self.hidden_size)]
            zh = draw_rows(torch.rand, full, generator=generator,
                           device=h.device)
            c_new = torch.where(zc < self.zoneout, c, c_new)
            h_new = torch.where(zh < self.zoneout, h, h_new)
        elif self.dropout > 0.0:
            keep = draw_rows(torch.rand, h.shape, generator=generator,
                             device=h.device) < 1.0 - self.dropout
            h_new = torch.where(keep, h_new / (1.0 - self.dropout), 0.0)
        return c_new, h_new

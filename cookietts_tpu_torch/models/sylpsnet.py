"""SylpsNet (cookietts_tpu/models/sylpsnet.py).

A tiny residual MLP maps (sylps, ln sylps) -> (mu, logvar); eval uses
``zu = mu``, training samples ``zu = mu + exp(logvar / 2) * eps``. The last layer outputs 1 value that is added, scaled by
``res_weight``, to both channels. Parameter names follow the reference
checkpoint (``seq_layers.{0,2,...}.linear_layer``, ``res_weight``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.attention import LinearNorm


class SylpsNet(nn.Module):
    def __init__(self, layer_dims: Sequence[int] = (32, 32)):
        super().__init__()
        layers, in_dim = [], 2
        for i, dim in enumerate(layer_dims):
            last = i == len(layer_dims) - 1
            out_dim = 1 if last else dim
            layers.append(LinearNorm(in_dim, out_dim))
            if not last:
                layers.append(nn.LeakyReLU(0.05))
            in_dim = out_dim
        self.seq_layers = nn.Sequential(*layers)
        self.res_weight = nn.Parameter(torch.tensor(0.01))

    def forward(self, sylps: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """[B] sylps -> (syl_zu [B, 1], mu [B], logvar [B]). In training
        eps is ``noise`` [B] when given, else drawn from ``generator``."""
        x = torch.stack([sylps, torch.log(sylps.clamp_min(1e-6))], dim=1)
        params = x + self.res_weight * self.seq_layers(x)
        mu, logvar = params[:, 0], params[:, 1]
        zu = mu
        if self.training:
            if noise is None:
                noise = torch.randn(mu.shape, generator=generator,
                                    device=mu.device)
            zu = mu + torch.exp(0.5 * logvar) * noise
        return zu[:, None], mu, logvar

"""BatchNorm with flax's training statistics (flax.linen.BatchNorm, which
the JAX package's models use): normalise by the biased batch variance
E[x^2] - E[x]^2 over every axis but the channel one (padding included),
and move the running averages by 1 - 0.99 with that same variance. Eval
uses the running averages as torch's BatchNorm does.

Under a data-parallel group (parallel/mesh.py) the training statistics come
from the sum and the sum of squares all-reduced over the group, with
gradient, and the running averages move with those global statistics: the
BatchNorm JAX runs over the global batch of a dp mesh. (Not
``nn.SyncBatchNorm``, whose running variance is the unbiased one.)"""
from __future__ import annotations

import torch
from torch import nn

from ..parallel.mesh import batch_means


class _FlaxStatistics:
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        mean, sq = batch_means(x, x * x, dims=dims)
        var = (sq - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
            self.num_batches_tracked.add_(1)
        y = (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
        return y * self.weight.view(shape) + self.bias.view(shape)


class BatchNorm1d(_FlaxStatistics, nn.BatchNorm1d):
    """[B, C] or [B, C, T]; flax's default epsilon 1e-5."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=0.01)


class BatchNorm2d(_FlaxStatistics, nn.BatchNorm2d):
    """[B, C, H, W]."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=0.01)

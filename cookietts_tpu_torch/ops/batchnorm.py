"""BatchNorm with flax's training statistics (flax.linen.BatchNorm, which
the JAX package's models use): normalise by the biased batch variance
E[x^2] - E[x]^2 over every axis but the channel one (padding included),
and move the running averages by 1 - 0.99 with that same variance. Eval
uses the running averages as torch's BatchNorm does.

Under a data-parallel group (parallel/mesh.py) the training statistics come
from the sum and the sum of squares all-reduced over the group, with
gradient, and the running averages move with those global statistics: the
BatchNorm JAX runs over the global batch of a dp mesh. (Not
``nn.SyncBatchNorm``, whose running variance is the unbiased one.)

A bf16 input (the bf16 serving path) is normalised in eval as flax's
``BatchNorm(dtype=bfloat16)`` does it: in f32, ``(x - mean) * (rsqrt(var +
eps) * scale) + bias`` with the f32 running statistics, the result rounded
to bf16. Training statistics are f32 only."""
from __future__ import annotations

import torch
from torch import nn

from ..parallel.mesh import batch_means


class _FlaxStatistics:
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training and x.dtype != torch.float32:
            shape = [1, -1] + [1] * (x.dim() - 2)
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            y = ((x.float() - self.running_mean.view(shape)) * mul.view(shape)
                 + self.bias.view(shape))
            return y.to(x.dtype)
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

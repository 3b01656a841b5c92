"""HiFi-GAN generator, inference (cookietts_tpu/models/hifigan.py:Generator).

mel [B, T_mel, n_mel] -> audio [B, T_mel * prod(upsample_rates)]; channels-
first [B, C, T] inside. Parameter names follow the reference (upstream
jik876/hifi-gan) checkpoint: ``conv_pre``, ``ups.{i}``,
``resblocks.{i * n_kernels + j}.convs{1,2}.{m}``, ``conv_post``. Weight norm
is folded at load: a ``weight_g``/``weight_v`` pair in a loaded state dict
becomes the plain ``weight`` (torch's weight_norm, dim 0).

Each MRF resblock runs in the ``hifigan_resblock`` kernel; its weights are
re-laid out for the kernel once and cached until the parameters change.
Traps kept from the JAX model: ConvTranspose ``padding=(k-u)//2`` matches
flax's "SAME" transposed conv (the checkpoint kernel is the flipped flax
one), the MRF averages its resblocks, and the final leaky ReLU uses slope
0.01, not ``lrelu_slope``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops import hopper_kernels as hk


@dataclasses.dataclass(frozen=True)
class HiFiGANConfig:
    n_mel_channels: int = 80
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilations: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    lrelu_slope: float = 0.1
    dtype: Any = torch.float32


def _padding(k: int, d: int = 1) -> int:
    return d * (k - 1) // 2


class ResBlock1(nn.Module):
    """MRF residual block: per dilation, lrelu -> conv(d) -> lrelu ->
    conv(1) -> residual add."""

    def __init__(self, channels: int, kernel_size: int, dilations, slope: float):
        super().__init__()
        self.dilations = tuple(dilations)
        self.slope = slope
        self.convs1 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=_padding(kernel_size, d)) for d in self.dilations)
        self.convs2 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size,
                      padding=_padding(kernel_size)) for _ in self.dilations)

    def kernel_weights(self):
        """(w1, b1, w2, b2) with w [P, k, C_in, C_out], b [P, C]."""
        def build():
            w = lambda convs: torch.stack(
                [c.weight.permute(2, 1, 0) for c in convs]).contiguous()
            b = lambda convs: torch.stack([c.bias for c in convs]).contiguous()
            return w(self.convs1), b(self.convs1), w(self.convs2), b(self.convs2)
        return hk.derived(self, "_kernel_weights", list(self.parameters()), build)

    def forward(self, x: torch.Tensor) -> torch.Tensor:      # [B, C, T]
        return hk.hifigan_resblock(x.contiguous(), *self.kernel_weights(),
                                   self.dilations, self.slope)


def _fold_weight_norm(state_dict, prefix, *args, **kwargs):
    """Load-time fold of torch weight_norm pairs (dim 0) into ``weight``."""
    for key in [k for k in state_dict if k.startswith(prefix)
                and k.endswith(".weight_g")]:
        base = key[:-len("_g")]
        g, v = state_dict.pop(key), state_dict.pop(base + "_v")
        norm = v.flatten(1).norm(dim=1).reshape(g.shape)
        state_dict[base] = g * v / norm


class Generator(nn.Module):
    def __init__(self, cfg: HiFiGANConfig, device: str | torch.device = "cuda"):
        super().__init__()
        if cfg.dtype != torch.float32:
            raise NotImplementedError("the port's kernels run in float32")
        self.cfg = cfg
        ch = cfg.upsample_initial_channel
        self.conv_pre = nn.Conv1d(cfg.n_mel_channels, ch, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                       cfg.upsample_kernel_sizes)):
            self.ups.append(nn.ConvTranspose1d(ch // 2 ** i, ch // 2 ** (i + 1),
                                               k, u, padding=(k - u) // 2))
            for rk, rd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilations):
                self.resblocks.append(
                    ResBlock1(ch // 2 ** (i + 1), rk, rd, cfg.lrelu_slope))
        self.conv_post = nn.Conv1d(ch // 2 ** len(cfg.upsample_rates), 1, 7,
                                   padding=3)
        self._register_load_state_dict_pre_hook(_fold_weight_norm)
        self.eval()
        self.to(resolve_device(device))

    @torch.no_grad()
    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """[B, T_mel, n_mel] -> [B, T_mel * prod(upsample_rates)]."""
        cfg = self.cfg
        n_k = len(cfg.resblock_kernel_sizes)
        x = self.conv_pre(torch.as_tensor(
            mel, dtype=torch.float32, device=self.conv_pre.weight.device
        ).transpose(1, 2))
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, cfg.lrelu_slope))
            blocks = self.resblocks[i * n_k:(i + 1) * n_k]
            acc = blocks[0](x)
            for block in blocks[1:]:
                acc = acc + block(x)
            x = acc / n_k
        x = self.conv_post(F.leaky_relu(x, 0.01))
        return torch.tanh(x)[:, 0]

"""Layers in the compute dtype of a model, as the JAX package casts them.

The JAX package's models keep their parameters in f32 and cast at use: a
flax ``Dense`` or ``Conv`` with ``dtype=bfloat16`` rounds its input and its
kernel to bf16, takes the product (f32 accumulation, the result rounded to
bf16) and then adds its bias rounded to bf16, which rounds again; its
activations then run on bf16 values. These helpers apply a torch layer the
same way. In f32 each is the layer's own call, unchanged. The bf16 copies
of a layer's weights are made once and kept until its parameters change
(``hopper_kernels.derived``), so the state dict, checkpoints and the
converters stay f32; a forward that autograd records casts them in the
graph instead.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import hopper_kernels as hk


def _inner(layer: nn.Module) -> nn.Module:
    """The torch layer under a reference-named wrapper (``LinearNorm``'s
    ``linear_layer``, ``ConvNorm``'s ``conv``)."""
    return getattr(layer, "linear_layer", getattr(layer, "conv", layer))


def cast_params(layer: nn.Module, dtype: torch.dtype
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(weight, bias or None) of ``layer`` in ``dtype``, cached on it; where
    autograd records (a bf16 training forward) cast in the graph instead,
    so that the gradients reach the f32 parameters."""
    bias = layer.bias
    if torch.is_grad_enabled() and layer.weight.requires_grad:
        return layer.weight.to(dtype), None if bias is None else bias.to(dtype)
    sources = [layer.weight] + ([] if bias is None else [bias])
    return hk.derived(
        layer, f"_cast_{dtype}".replace("torch.", ""), sources,
        lambda: (layer.weight.to(dtype),
                 None if bias is None else bias.to(dtype)))


def _add_bias(y: torch.Tensor, b: Optional[torch.Tensor], channel_dim: int
              ) -> torch.Tensor:
    if b is None:
        return y
    return y + (b if channel_dim == -1 else b[:, None])


def dense(layer: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)`` through a torch Linear."""
    lin = _inner(layer)
    if dtype == torch.float32:
        return layer(x)
    w, b = cast_params(lin, dtype)
    return _add_bias(F.linear(x.to(dtype), w), b, -1)


def conv1d(layer: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Conv(dtype=dtype)`` through a torch Conv1d; x [B, C, T]."""
    conv = _inner(layer)
    if dtype == torch.float32:
        return layer(x)
    w, b = cast_params(conv, dtype)
    y = F.conv1d(x.to(dtype), w, None, conv.stride, conv.padding,
                 conv.dilation, conv.groups)
    return _add_bias(y, b, 1)


def conv_transpose1d(layer: nn.ConvTranspose1d, x: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """flax ``ConvTranspose(dtype=dtype)`` through a torch ConvTranspose1d."""
    if dtype == torch.float32:
        return layer(x)
    w, b = cast_params(layer, dtype)
    y = F.conv_transpose1d(x.to(dtype), w, None, layer.stride, layer.padding,
                           layer.output_padding, layer.groups, layer.dilation)
    return _add_bias(y, b, 1)


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """flax's leaky ReLU: on bf16 values the slope is a bf16 constant and
    the product is rounded to bf16 (hopper_kernels.leaky_relu_bf16)."""
    if x.dtype == torch.bfloat16:
        return hk.leaky_relu_bf16(x, slope)
    return F.leaky_relu(x, slope)

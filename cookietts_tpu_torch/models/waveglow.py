"""WaveGlow / WaveFlow flow vocoder (cookietts_tpu/models/waveglow.py):
the training forward and loss, and the inverse.

- ``channel_mixing='1x1conv'``       -> WaveGlow: invertible 1x1 conv and an
  affine coupling over grouped channels, parallel over time.
- ``channel_mixing='permuteheight'`` -> WaveFlow: height permutations and a
  height-causal 2-D WN coupling, autoregressive over the ``n_group`` rows.

Public layout is the JAX model's: audio [B, T], mel [B, T_mel, n_mel], z
[B, T/G, G] (WaveGlow) or [B, G, T/G] (WaveFlow). Inside, activations are
channels-first [B, C, T], which is also the kernels' layout.

``WaveGlow.forward(audio, mel)`` is the training forward (audio to z,
with the log-determinants ``waveglow_loss`` takes): every flow's WN runs
``forward_train`` from the live parameters under autograd, the coupling
net of all rows at once for WaveFlow (causal in height), and with
``memory_efficient`` (the default) each flow is recomputed in the backward
(``torch.utils.checkpoint``), as JAX rematerialises each flow. The inverse
(``inverse``, ``infer``; validation and serving) runs without autograd, and
with the gated unit GTU each WN runs through the Hopper kernels
``waveglow_wn_forward`` / ``waveflow_row_step`` (ops/hopper_kernels.py); any
other unit of ``GATED_UNITS`` takes the plain PyTorch version. That choice is
made from the call (forward or inverse) and the configuration, never after a
failed launch. The kernels' packed weights are cached and rebuilt when a
parameter changes, so the inverse after an optimizer step sees the new
weights.

Parameter names follow the reference glow.py checkpoint that
cookietts_tpu/convert/waveglow_torch.py reads: ``WN.{k}.start``,
``WN.{k}.in_layers.{i}``, ``WN.{k}.res_skip_layers.{i}``,
``WN.{k}.cond_layer``, ``WN.{k}.end``, ``convinv.{k}.conv`` and, for
``upsample_mode='single'``, ``upsample``. With ``upsample_mode='single'`` and
``couple_transform='second'`` a dump of the state dict goes through
``convert_waveglow_state_dict`` unchanged. The same scheme names what the
reference layout lacks: ``upsample.{i}`` (the multi-stage upsampler's
transposed convs), ``speaker_embed``, and for WaveFlow the same ``WN.{k}.*``
keys with Conv2d weights (``in_layers`` [2C, C, kh, kw]). As in the reference
checkpoints the rows of ``end`` are ordered (t, log_s); the modules return
(log_s, t) like the JAX model.

Traps kept from the JAX model: flax's "SAME" transposed conv with kernel 2s
and stride s is the full transposed conv cut at ``_same_offset(s)``; torch's
``padding=s // 2`` matches it only for even s (5 and 75 are odd). W^-1 of
the 1x1 conv and its log-determinant are taken in float32 and both
directions run with TF32 off, or forward and inverse stop being inverses at
the 1e-2 level.

With ``iso226_deemphasis``, ``infer`` removes the ISO 226 equal-loudness
emphasis from its audio (audio/iso226.py), as the JAX model does.

``WaveGlowConfig(dtype=torch.bfloat16)`` (or ``"bfloat16"``) runs in bf16
with the JAX model's casts; the parameters stay f32 and their bf16 copies
are cached (``hopper_kernels.derived``, ``ops/precision.py``):

- the inverse follows JAX's Pallas path (models/waveglow.py:664-760 and
  :873-956 there): the upsampler and the speaker embedding run in bf16 (a
  bf16 transposed conv rounds its product and its bias sum), each flow's
  cond projection rounds as JAX's callers round it (``cond_bc``), and the
  WN kernels run their bf16 forms (``waveglow_wn_forward`` on bf16 weights
  with f32 activations, ``waveflow_row_step`` on a bf16 ring). WaveGlow's
  coupling chain keeps z's dtype: an f32 z stays f32 against the bf16
  log_s and t, a bf16 z (``infer`` draws z in f32 and rounds it, as JAX
  draws it in bf16) rounds every step; the 1x1 inverse is W^-1 in f32
  rounded to z's dtype. WaveFlow's rows stay f32 and its audio is rounded
  to bf16. The audio is returned as f32 either way.
- the training forward runs every flow's WN, the 1x1 convs and the
  coupling on bf16 values (flax's bf16 Dense and Conv: the product and the
  bias sum each rounded; the casts recorded by autograd, so the gradients
  reach the f32 parameters); the log-determinants and the sums of log_s
  are f32, and so is the loss.
- sequence parallelism (``sp``) and tensor parallelism refuse bf16 (a later
  slice).

Sequence parallelism (parallel/sp.py): ``forward``, ``inverse`` and
``infer`` take an ``sp`` group whose ranks each hold a run of the time axis
(the audio's samples, the mel's frames; ``SequenceParallel.shard_batch``).
The flows are pointwise in time given their conditioning but for the WN's
dilated convs and the upsampler, so:

- the upsampler runs on the rank's mel frames widened by its reach in
  frames, computed from the configuration (``upsample_reach``), and keeps
  the rank's columns;
- in training each WN layer pads its conv input with ``halo_pad``: the
  neighbours' columns, zeros past the utterance's ends, as ``F.pad`` does
  in one process; the loss terms are the rank's parts of the global sums;
- in the inverse one exchange a flow widens the WN's input by the whole
  WN's reach (``wn_reach``), the ``waveglow_wn_forward`` kernel runs on the
  widened run and the rank keeps the centre. At the utterance's ends a run
  widens inward only: the kernel's own zero padding is one process's;
- WaveFlow's inverse, causal in height with width halos in its ring from
  row to row, gathers the time axis and runs the row kernel on the whole
  utterance on every rank (what GSPMD does with a Pallas call it cannot
  partition), each rank keeping its columns.
"""
from __future__ import annotations

import dataclasses
import math
from fractions import Fraction
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..config import compute_dtype, refuse_bf16
from ..device import full_float32, resolve_device
from ..ops import hopper_kernels as hk
from ..ops import precision
from ..parallel.mesh import draw_rows
from ..parallel.sp import conv_transpose_reach


def _tanhshrink(x):
    return x - torch.tanh(x)


def _siren(a):
    """sin(16 a), with 15 a hidden from autograd (the JAX model's SIREN)."""
    return torch.sin(a + (15.0 * a).detach())


BF16 = torch.bfloat16
F32 = torch.float32


def _refuse_bf16_sp(dtype) -> None:
    refuse_bf16(dtype, "sequence-parallel WaveGlow and WaveFlow",
                "bf16 tp and sp")


def _conv(layer: nn.Module, x: torch.Tensor, fn=None, **kw) -> torch.Tensor:
    """``fn(x, weight, bias, **kw)`` (F.conv1d or F.conv2d, by default the
    one of the layer's kind) of ``layer`` in x's dtype, as flax's
    ``Conv(dtype)`` computes it (ops/precision.py): in bf16 the product of
    the bf16 input and weight, rounded, then the bias rounded to bf16 added."""
    fn = fn or (F.conv2d if isinstance(layer, nn.Conv2d) else F.conv1d)
    if x.dtype == F32:
        return fn(x, layer.weight, layer.bias, **kw)
    w, b = precision.cast_params(layer, x.dtype)
    y = fn(x, w, None, **kw)
    return y + b.view((-1,) + (1,) * (y.dim() - 2))


# (a, b) are the two pre-activation halves of the WN conv output.
GATED_UNITS: Dict[str, Callable] = {
    "GTU": hk.gtu,
    "GTRU": lambda a, b: torch.tanh(a) * F.relu(b),
    "GLU": lambda a, b: a * torch.sigmoid(b),
    "TTU": lambda a, b: torch.tanh(a) * torch.tanh(b),
    "STU": lambda a, b: torch.tanh(a) * F.selu(b),
    "GTSU": lambda a, b: _tanhshrink(a) * torch.sigmoid(b),
    "SPTU": lambda a, b: torch.tanh(a) * F.softplus(b),
    "GSIU": lambda a, b: torch.sin(a) * torch.sigmoid(b),
    "GSIRU": lambda a, b: _siren(a) * torch.sigmoid(b),
    "GTSRU": lambda a, b: _tanhshrink(a) * F.relu(b),
    "GSIRRU": lambda a, b: _siren(a) * F.relu(b),
    "GSIRLRU": lambda a, b: _siren(a) * F.leaky_relu(b, 0.01),
    "GSIRRLRU": lambda a, b: _siren(a) * F.leaky_relu(b, 0.055),
    "GTLRU": lambda a, b: torch.tanh(a) * F.leaky_relu(b, 0.01),
    "linear": lambda a, b: a,
}


@dataclasses.dataclass(frozen=True)
class WaveGlowConfig:
    """The JAX model's configuration. Its knobs for the TPU kernels and the
    scan (``pallas_row_step``, ``pallas_row_tile``, ``inverse_height_unroll``)
    are accepted, so that a stored configuration loads, and ignored: the
    card's kernels pick their own tiles and there is one inverse path per
    gated unit. ``fused_height_inverse`` is ignored too: both of its JAX
    paths compute the row step ported here. ``memory_efficient`` recomputes
    each flow in the training backward.
    ``cond_residual`` and ``cond_layers`` are carried as the JAX model carries
    them: neither model reads them."""
    n_mel_channels: int = 160
    n_flows: int = 12
    n_group: int = 8              # WaveGlow: channel groups; WaveFlow: height
    n_early_every: int = 4        # emit early z channels every k flows (0=off)
    n_early_size: int = 2
    channel_mixing: str = "1x1conv"   # '1x1conv' | 'permuteheight'
    n_layers: int = 8
    n_channels: int = 256
    kernel_size: int = 3
    kernel_size_h: int = 3        # WaveFlow: causal height kernel
    gated_unit: str = "GTU"
    hop_length: int = 600
    upsample_strides: Tuple[int, ...] = (5, 5, 3)   # product * n_group == hop
    upsample_channels: int = 256
    cond_residual: bool = False
    cond_layers: int = 1
    upsample_mode: str = "multi"      # 'multi' | 'single' (reference glow.py)
    upsample_win_length: int = 0      # 'single' kernel size
    couple_transform: str = "first"   # 'first' | 'second' (reference glow.py)
    n_speakers: int = 0
    speaker_embed_dim: int = 32
    iso226_deemphasis: bool = False
    sampling_rate: int = 48000
    fused_height_inverse: bool = True
    inverse_height_unroll: int = 8
    pallas_row_step: Any = "auto"
    pallas_row_tile: int = 1536
    memory_efficient: bool = True
    sigma: float = 1.0
    dtype: Any = torch.float32

    def __post_init__(self):
        # torch.float32 / torch.bfloat16 or their names (config.compute_dtype)
        object.__setattr__(self, "dtype", compute_dtype(self.dtype))


def permute_height_order(h: int, kind: str, flow_idx: int) -> np.ndarray:
    """Static height permutation orders: 'reverse' flips the height each
    flow; 'bipartize' alternates flipping the two halves and swapping them."""
    idx = np.arange(h)
    if kind == "reverse":
        return idx[::-1].copy()
    half = h // 2
    if flow_idx % 2 == 0:
        return np.concatenate([idx[:half][::-1], idx[half:][::-1]])
    return np.concatenate([idx[half:], idx[:half]])


class Invertible1x1Conv(nn.Module):
    """The 1x1 channel-mixing conv on [B, C, T]: y = W x, and x = W^-1 y."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv1d(channels, channels, 1, bias=False)
        q = torch.linalg.qr(torch.randn(channels, channels))[0]
        if torch.det(q) < 0:
            q[:, 0] = -q[:, 0]
        with torch.no_grad():
            self.conv.weight.copy_(q[:, :, None])

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(W x in x's dtype, log|det W|), the log-determinant in float32."""
        w = self.conv.weight[:, :, 0]
        return torch.matmul(w.to(x.dtype), x), torch.linalg.slogdet(w.float())[1]

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        """W^-1 y: W^-1 taken in f32, rounded to y's dtype."""
        w = self.conv.weight
        w_inv = hk.derived(self, "_w_inv", [w],
                           lambda: torch.linalg.inv(w[:, :, 0].float()))
        return torch.matmul(w_inv.to(y.dtype), y)


class _WNBase(nn.Module):
    """What WN and WN2D share: the layers' names and the packing of their
    weights into the kernels' layouts (ops/hopper_kernels.py). ``BF16_FORM``
    names the bf16 form of the subclass's kernel (hk.WN_BF16_DTYPES)."""
    BF16_FORM = ""

    def _make(self, conv, n_in, n_out, n_cond, in_kernel):
        """The layers are parameter holders with the checkpoint's shapes: the
        arithmetic runs on their packed weights (layer i has dilation 2**i)."""
        L, C = self.n_layers, self.n_channels
        one = (1,) * len(in_kernel)
        self.start = conv(n_in, C, one)
        self.cond_layer = nn.Conv1d(n_cond, 2 * C * L, 1)
        self.in_layers = nn.ModuleList(conv(C, 2 * C, in_kernel) for _ in range(L))
        self.res_skip_layers = nn.ModuleList(
            conv(C, 2 * C if i < L - 1 else C, one) for i in range(L))
        # zero-initialised end layer: an identity flow at the start of training
        self.end = conv(C, 2 * n_out, one)
        nn.init.zeros_(self.end.weight)
        nn.init.zeros_(self.end.bias)

    @property
    def tp(self):
        """The tp group its layers are sharded over (parallel/tp.py), or
        None."""
        return getattr(self.in_layers[0], "tp", None)

    def _train_input(self, x, cond):
        """(the start's output h [B, C, ...], the cond projection) of the
        training forward. Under tp both products are column-parallel: the
        start's channels all-gathered, the cond projection this rank's
        channel pairs."""
        tp = self.tp
        if tp is None:
            return _conv(self.start, x), _conv(self.cond_layer, cond)
        return (tp.gather(self.start(tp.copy_in(x)), 1),
                self.cond_layer(tp.copy_in(cond)))

    def _train_layers(self, h, cond_all, conv):
        """The layers and the end of the training forward, from the start's
        output ``h`` and the cond projection ``cond_all`` [B, 2CL, ...];
        ``conv(i, layer, h)`` is layer i's dilated conv. -> (log_s, t).
        Under tp each rank holds C/N channel pairs of every gated layer
        (its conv's and the cond projection's outputs j and j + C) and the
        res/skip rows over them: their products are summed over the group
        (one all-reduce a layer) before the bias."""
        gate = GATED_UNITS[self.gated_unit]
        tp = self.tp
        C, L = self.n_channels, self.n_layers
        c = self.in_layers[0].weight.shape[0] // 2     # this rank's pairs
        cond_all = cond_all if h.dim() == 3 else cond_all[:, :, None]
        skip = 0
        for i, (layer, rs) in enumerate(zip(self.in_layers,
                                            self.res_skip_layers)):
            acts = (conv(i, layer, h if tp is None else tp.copy_in(h))
                    + cond_all[:, 2 * c * i:2 * c * (i + 1)])
            gated = gate(acts[:, :c], acts[:, c:])
            if tp is None:
                r = _conv(rs, gated)
            else:
                r = tp.reduce(rs._conv_forward(gated, rs.weight, None))
                r = r + rs.bias.view((1, -1) + (1,) * (r.dim() - 2))
            if i < L - 1:
                h = h + r[:, :C]
                skip = skip + r[:, C:]
            else:
                skip = skip + r
        st = _conv(self.end, skip)              # rows (t, log_s)
        half = st.shape[1] // 2
        return st[:, half:], st[:, :half]

    def kernel_weights(self, dtype: torch.dtype = F32):
        """(start_w, start_b, k_all, rs_w, rs_b, end_w, end_b) as the kernels
        take them, end rows reordered to (log_s, t); for bf16 in the dtypes
        of the kernel's bf16 form (the weights bf16, the biases f32 but
        WaveFlow's start bias)."""
        def build():
            C = self.n_channels
            mat = lambda conv: conv.weight.flatten(1).t()     # 1x1: [in, out]
            k_all = torch.stack([
                layer.weight.permute(*range(2, layer.weight.dim()), 1, 0)
                .reshape(-1, 2 * C) for layer in self.in_layers])
            rs_w = torch.stack([F.pad(mat(layer), (2 * C - layer.out_channels, 0))
                                for layer in self.res_skip_layers])
            rs_b = torch.stack([F.pad(layer.bias, (2 * C - layer.out_channels, 0))
                                for layer in self.res_skip_layers])
            half = self.end.out_channels // 2
            order = [*range(half, 2 * half), *range(half)]
            return (mat(self.start).contiguous(), self.start.bias.detach(),
                    k_all.contiguous(), rs_w.contiguous(), rs_b.contiguous(),
                    mat(self.end)[:, order].contiguous(),
                    self.end.bias[order].contiguous())
        params = list(self.parameters())
        f32 = hk.derived(self, "_kernel_weights", params, build)
        if dtype == F32:
            return f32
        dtypes = list(hk.WN_BF16_DTYPES[self.BF16_FORM].values())[-len(f32):]
        return hk.derived(self, "_kernel_weights_bf16", params, lambda: tuple(
            t.to(d).contiguous() for t, d in zip(f32, dtypes)))

    def cond_bc(self, cond: torch.Tensor) -> torch.Tensor:
        """cond [B, D, T] -> [B, L, 2C, T]: every layer's cond projection in
        one product, with the in_layers' biases folded in. A bf16 cond gives
        the bf16 cond_bc of JAX's Pallas callers: WaveGlow's (models/
        waveglow.py:687-692 there) is the bf16 product plus the cond and
        conv biases summed in f32 and rounded, a bf16 sum; WaveFlow's
        (:913-916) is flax's bf16 Dense (the product and its bias sum each
        rounded) plus the conv biases in f32, rounded."""
        params = list(self.parameters())
        in_b = lambda: torch.cat([layer.bias for layer in self.in_layers])  # noqa: E731
        if cond.dtype == BF16:
            w, b_cond, b_sum, b_in = hk.derived(
                self, "_cond_weights_bf16", params, lambda: (
                    self.cond_layer.weight[:, :, 0].to(BF16).contiguous(),
                    self.cond_layer.bias.to(BF16),
                    (self.cond_layer.bias + in_b()).to(BF16), in_b()))
            y = torch.matmul(w, cond)
            out = (((y + b_cond[:, None]).float() + b_in[:, None]).to(BF16)
                   if self.BF16_FORM == "flow_bf16" else y + b_sum[:, None])
        else:
            w, b = hk.derived(self, "_cond_weights", params, lambda: (
                self.cond_layer.weight[:, :, 0].contiguous(),
                self.cond_layer.bias + in_b()))
            out = torch.matmul(w, cond).add_(b[:, None])
        return out.view(cond.shape[0], self.n_layers, 2 * self.n_channels, -1)


def _refuse_sharded(wn: _WNBase) -> None:
    if wn.tp is not None:
        raise RuntimeError("the inverse runs on the full weights: validate "
                           "a tp-sharded WaveGlow on a replica that holds "
                           "them gathered (runtime/trainer.py: "
                           "make_waveglow_val_step)")


class WN(_WNBase):
    """Non-causal dilated-conv WaveNet producing the affine (log_s, t)."""
    BF16_FORM = "glow_bf16"

    def __init__(self, n_in: int, n_out: int, n_cond: int, n_layers: int,
                 n_channels: int, kernel_size: int, gated_unit: str):
        super().__init__()
        self.n_layers, self.n_channels = n_layers, n_channels
        self.gated_unit = gated_unit
        self._make(nn.Conv1d, n_in, n_out, n_cond, (kernel_size,))

    def forward_train(self, x: torch.Tensor, cond: torch.Tensor, sp=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The training forward (JAX ``WN.__call__``) from the live
        parameters: x [B, C_in, T], cond [B, D, T] -> (log_s, t). Under
        ``sp`` (bound to the time axis) T is this rank's run and each
        layer's padding holds the neighbours' columns."""
        h, cond_all = self._train_input(x, cond)
        pad = F.pad if sp is None else (
            lambda h, lr: sp.halo_pad(h, lr[0], lr[1]))

        def conv(i, layer, h):
            total = (layer.kernel_size[0] - 1) * 2 ** i     # flax's "SAME"
            return _conv(layer, pad(h, (total // 2, total - total // 2)),
                         dilation=2 ** i)

        return self._train_layers(h, cond_all, conv)

    def forward(self, x: torch.Tensor, cond: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The inverse's WN, without autograd: x [B, C_in, T], cond
        [B, D, T] -> (log_s, t), each [B, C_out, T] f32. A bf16 cond runs
        the kernel's bf16 form, x widened to f32 as JAX's caller pads it."""
        _refuse_sharded(self)
        cond_bc = self.cond_bc(cond)
        args = (x.float().contiguous(), cond_bc,
                *self.kernel_weights(cond_bc.dtype))
        if self.gated_unit == "GTU":
            st = hk.waveglow_wn_forward(*args)
        else:
            st = hk.waveglow_wn_forward_plain(
                *args, gate=GATED_UNITS[self.gated_unit])
        return st.chunk(2, dim=1)


class WN2D(_WNBase):
    """Height-causal 2-D WaveNet of the WaveFlow coupling, one row at a time:
    row h of (log_s, t) depends on the rows above h only. Each layer keeps
    its last ``kernel_size_h`` input rows in a ring (see
    ``hopper_kernels.waveflow_row_step``)."""
    BF16_FORM = "flow_bf16"

    def __init__(self, n_cond: int, n_layers: int, n_channels: int,
                 kernel_size: int, kernel_size_h: int, gated_unit: str):
        super().__init__()
        self.n_layers, self.n_channels = n_layers, n_channels
        self.kernel_size_h, self.gated_unit = kernel_size_h, gated_unit
        self._make(nn.Conv2d, 1, 1, n_cond, (kernel_size_h, kernel_size))

    def forward_train(self, x: torch.Tensor, cond: torch.Tensor, sp=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The training forward over every row at once (JAX
        ``WN2D.__call__``), from the live parameters: x [B, H, W], cond
        [B, D, W] -> (log_s, t), each [B, H, W]; row h depends on the rows
        above it only (the input shifted down a row, causal padding). Under
        ``sp`` W is this rank's run: the width padding holds the
        neighbours' columns, the height padding stays causal and local."""
        kh = self.kernel_size_h
        h, cond_all = self._train_input(
            F.pad(x, (0, 0, 1, 0))[:, None, :-1], cond)

        def conv(i, layer, h):
            pad = (layer.kernel_size[1] // 2) * 2 ** i
            h = (F.pad(h, (pad, pad)) if sp is None
                 else sp.halo_pad(h, pad, pad))
            return _conv(layer, F.pad(h, (0, 0, kh - 1, 0)),
                         dilation=(1, 2 ** i))

        log_s, t = self._train_layers(h, cond_all, conv)
        return log_s[:, 0], t[:, 0]

    def init_ring(self, batch: int, width: int,
                  dtype: torch.dtype = F32) -> torch.Tensor:
        """[L, kh, B, C, W] zeros: the causal zero padding above row 0 (bf16
        for the row kernel's bf16 form)."""
        return torch.zeros((self.n_layers, self.kernel_size_h, batch,
                            self.n_channels, width),
                           device=self.start.weight.device, dtype=dtype)

    def row_step(self, x_prev: torch.Tensor, ring: torch.Tensor, step: int,
                 cond_bc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One height row: x_prev [B, W] is the row generated before (zeros
        for row 0); ``ring`` advances in place. -> (log_s, t), each [B, W]
        f32; a bf16 cond_bc (and ring) runs the kernel's bf16 form."""
        _refuse_sharded(self)
        args = (x_prev.contiguous(), ring, step, cond_bc,
                *self.kernel_weights(cond_bc.dtype))
        if self.gated_unit == "GTU":
            return hk.waveflow_row_step(*args)
        return hk.waveflow_row_step_ring_plain(
            *args, gate=GATED_UNITS[self.gated_unit])


def _same_offset(stride: int) -> int:
    """Where flax's ConvTranspose(kernel 2s, stride s, padding="SAME") cuts
    its T * s outputs out of the full transposed conv's (T - 1) * s + 2s: it
    pads the dilated input by ceil((3s - 2) / 2) on the left where the full
    conv pads by 2s - 1."""
    return (2 * stride - 1) - -(-(3 * stride - 2) // 2)


def upsample_reach(cfg: WaveGlowConfig) -> Tuple[Fraction, Fraction]:
    """(left, right) reach of the conditioning in mel frames: cond column c
    (at group rate, mel position c G / hop) depends on the mel frames within
    [c G / hop - left, c G / hop + right]. Each stage of the "multi"
    upsampler is a transposed conv (kernel 2s, stride s) cut at
    ``_same_offset(s)``, in units of its input; "single" is one transposed
    conv (``upsample_win_length``, stride hop) cut at 0, whose samples fold
    G to a column."""
    if cfg.upsample_mode == "single":
        left, right = conv_transpose_reach(cfg.upsample_win_length,
                                           cfg.hop_length, 0)
        return left, right + Fraction(cfg.n_group - 1, cfg.hop_length)
    left = right = Fraction(0)
    rate = 1
    for s in cfg.upsample_strides:
        l, r = conv_transpose_reach(2 * s, s, _same_offset(s))
        left, right = left + l / rate, right + r / rate
        rate *= s
    return left, right


def wn_reach(cfg: WaveGlowConfig) -> int:
    """The columns one WN reaches on either side (its dilated convs'
    "SAME" padding summed over the layers, the wider side)."""
    return sum((cfg.kernel_size - 1) * 2 ** i
               - (cfg.kernel_size - 1) * 2 ** i // 2
               for i in range(cfg.n_layers))


class UpsampleNet(nn.ModuleList):
    """Multi-stage transposed-conv mel upsampler: [B, M, T_mel] ->
    [B, channels, T_mel * prod(strides)], leaky ReLU (0.4) between stages.
    A ModuleList, so that the stages are named ``{i}``."""

    def __init__(self, n_mel: int, strides, channels: int):
        dims = [n_mel] + [channels] * len(strides)
        super().__init__(nn.ConvTranspose1d(a, b, 2 * s, stride=s)
                         for a, b, s in zip(dims[:-1], dims[1:], strides))

    def forward(self, mel: torch.Tensor, dtype: torch.dtype = F32) -> torch.Tensor:
        """In ``dtype``, as flax's ConvTranspose(dtype) and leaky ReLU."""
        h = mel
        for i, layer in enumerate(self):
            s = layer.stride[0]
            start, n = _same_offset(s), h.shape[-1] * s
            h = precision.conv_transpose1d(layer, h, dtype)[..., start:start + n]
            if i != len(self) - 1:
                h = precision.leaky_relu(h, 0.4)
        return h


class WaveGlow(nn.Module):
    """Unified WaveGlow/WaveFlow flow vocoder: ``inverse`` maps a latent to
    audio, ``infer`` samples the latent first."""

    def __init__(self, cfg: WaveGlowConfig, device: str | torch.device = "cuda"):
        super().__init__()
        if cfg.gated_unit not in GATED_UNITS:
            raise ValueError(f"unknown gated unit {cfg.gated_unit!r}")
        self.cfg = cfg
        self.waveflow = cfg.channel_mixing == "permuteheight"
        if cfg.upsample_mode == "single":
            if cfg.upsample_win_length <= 0:
                raise ValueError("upsample_mode='single' needs upsample_win_length")
            self.upsample = nn.ConvTranspose1d(
                cfg.n_mel_channels, cfg.n_mel_channels,
                cfg.upsample_win_length, stride=cfg.hop_length)
            n_cond = cfg.n_mel_channels * cfg.n_group
        else:
            up_prod = int(np.prod(cfg.upsample_strides))
            if up_prod * cfg.n_group != cfg.hop_length:
                raise ValueError(
                    f"prod(upsample_strides)={up_prod} * n_group={cfg.n_group} "
                    f"must equal hop_length={cfg.hop_length}")
            self.upsample = UpsampleNet(cfg.n_mel_channels, cfg.upsample_strides,
                                        cfg.upsample_channels)
            n_cond = cfg.upsample_channels
        if cfg.n_speakers > 0:
            self.speaker_embed = nn.Embedding(cfg.n_speakers, cfg.speaker_embed_dim)
            n_cond += cfg.speaker_embed_dim

        self.WN = nn.ModuleList()
        self.convinv = nn.ModuleList()
        early, halves = [], []
        remaining = cfg.n_group
        for k in range(cfg.n_flows):
            if (not self.waveflow and cfg.n_early_every
                    and k % cfg.n_early_every == 0 and k > 0):
                remaining -= cfg.n_early_size
                early.append(cfg.n_early_size)
            else:
                early.append(0)
            if self.waveflow:
                self.WN.append(WN2D(n_cond, cfg.n_layers, cfg.n_channels,
                                    cfg.kernel_size, cfg.kernel_size_h,
                                    cfg.gated_unit))
                halves.append(0)
            else:
                if remaining % 2 or remaining <= 0:
                    raise ValueError("every flow needs an even, positive "
                                     f"channel count, flow {k} has {remaining}")
                half = remaining // 2
                halves.append(half)
                self.WN.append(WN(half, half, n_cond, cfg.n_layers,
                                  cfg.n_channels, cfg.kernel_size,
                                  cfg.gated_unit))
                self.convinv.append(Invertible1x1Conv(remaining))
        self._early, self._half = tuple(early), tuple(halves)
        self.eval()
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.WN[0].start.weight.device

    def _upsample(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, M, T_mel] -> the upsampled conditioning [B, D, T_mel hop
        / G] at group rate, before the speaker."""
        cfg = self.cfg
        if cfg.upsample_mode == "single":
            G, B, t = cfg.n_group, mel.shape[0], mel.shape[2] * cfg.hop_length
            up = precision.conv_transpose1d(self.upsample, mel, cfg.dtype)[..., :t]
            # unfold: feature index m * G + g, as the reference's view order
            return up.reshape(B, cfg.n_mel_channels, t // G, G).permute(
                0, 1, 3, 2).reshape(B, cfg.n_mel_channels * G, t // G)
        return self.upsample(mel, cfg.dtype)

    def _cond(self, mel: torch.Tensor,
              speaker_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mel [B, T_mel, M] -> cond [B, D, T/G] at group rate."""
        return self._speaker(self._upsample(mel.transpose(1, 2)), mel,
                             speaker_ids)

    def _cond_run(self, mel: torch.Tensor, speaker_ids, msp, xsp,
                  extra: int = 0) -> torch.Tensor:
        """This rank's columns of the cond, widened by up to ``extra`` on
        either side (none past the utterance's ends), from its run of the
        mel ``mel`` [B, T_run, M] (``msp`` bound to the mel frames, ``xsp``
        to the columns): the mel frames widened by the upsampler's reach
        and ``extra``'s, upsampled, and cut."""
        cfg = self.cfg
        G, hop = cfg.n_group, cfg.hop_length
        if hop % G or xsp.offset * G != msp.offset * hop:
            raise ValueError(
                f"the runs of the columns (from {xsp.offset}, hop {hop}, "
                f"group {G}) and of the mel frames (from {msp.offset}) "
                "must start together")
        c0 = max(0, xsp.offset - extra)
        c1 = min(xsp.total, xsp.offset + xsp.length + extra)
        reach = math.ceil(max(upsample_reach(cfg))
                          + Fraction(extra * G, hop)) + 1
        wide, l, _ = msp.widen(mel.transpose(1, 2), reach, reach)
        start = c0 - (msp.offset - l) * hop // G
        cond = self._upsample(wide)[..., start:start + c1 - c0]
        if cond.shape[-1] != c1 - c0:
            raise ValueError(f"the mel frames reach column "
                             f"{start + cond.shape[-1]}, the run needs "
                             f"{c1 - c0}")
        return self._speaker(cond, mel, speaker_ids)

    def _speaker(self, cond: torch.Tensor, mel: torch.Tensor,
                 speaker_ids=None) -> torch.Tensor:
        """cond with the speaker embedding appended to every column."""
        cfg = self.cfg
        if cfg.n_speakers > 0:
            if speaker_ids is None:
                speaker_ids = torch.zeros(mel.shape[0], dtype=torch.long,
                                          device=mel.device)
            spk = self.speaker_embed(torch.as_tensor(
                speaker_ids, device=mel.device)).to(cond.dtype)
            cond = torch.cat([cond, spk[:, :, None].expand(
                -1, -1, cond.shape[-1])], dim=1)
        return cond

    def _flow(self, fn, *args):
        if self.cfg.memory_efficient:
            return torch.utils.checkpoint.checkpoint(fn, *args,
                                                     use_reentrant=False)
        return fn(*args)

    def _glow_flow(self, k: int, x: torch.Tensor, cond: torch.Tensor,
                   sp=None):
        """Flow k forward: 1x1 mixing, then the affine coupling. -> (y,
        sum of log_s, log|det W|)."""
        y, logdet = self.convinv[k](x)
        xa, xb = y[:, :self._half[k]], y[:, self._half[k]:]
        if self.cfg.couple_transform == "second":
            log_s, t = self.WN[k].forward_train(xa, cond, sp)
            xb = xb * torch.exp(log_s) + t
        else:
            log_s, t = self.WN[k].forward_train(xb, cond, sp)
            xa = xa * torch.exp(log_s) + t
        return torch.cat([xa, xb], dim=1), log_s.float().sum(), logdet

    def _forward_waveglow(self, x: torch.Tensor, cond: torch.Tensor,
                          sp=None):
        """x [B, G, T'] -> (z [B, G, T'] with the early outputs first,
        sum of log_s, sum of the 1x1 log-determinants over positions; this
        rank's parts of the sums under ``sp``)."""
        B, _, T = x.shape
        log_s_sum = logdet_sum = x.new_zeros((), dtype=F32)
        early = []
        for k in range(self.cfg.n_flows):
            if self._early[k]:
                early.append(x[:, :self._early[k]])
                x = x[:, self._early[k]:]
            x, ls, lw = self._flow(self._glow_flow, k, x, cond, sp)
            log_s_sum = log_s_sum + ls
            logdet_sum = logdet_sum + lw * (B * T)
        return torch.cat(early + [x], dim=1), log_s_sum, logdet_sum

    def _flow_2d(self, k: int, x: torch.Tensor, cond: torch.Tensor,
                 sp=None):
        log_s, t = self.WN[k].forward_train(x, cond, sp)
        return x * torch.exp(log_s) + t, log_s.float().sum()

    def _forward_waveflow(self, x: torch.Tensor, cond: torch.Tensor,
                          sp=None):
        """x [B, H, W] -> (z [B, H, W], sum of log_s, 0): each flow permutes
        the rows, then its height-causal affine coupling."""
        log_s_sum = x.new_zeros((), dtype=F32)
        for k in range(self.cfg.n_flows):
            x = x[:, permute_height_order(self.cfg.n_group, "bipartize", k)]
            x, ls = self._flow(self._flow_2d, k, x, cond, sp)
            log_s_sum = log_s_sum + ls
        return x, log_s_sum, x.new_zeros((), dtype=F32)

    def forward(self, audio: torch.Tensor, mel: torch.Tensor,
                speaker_ids: Optional[torch.Tensor] = None, sp=None
                ) -> Dict[str, Any]:
        """Training forward (JAX ``WaveGlow.__call__``): audio [B, T], mel
        [B, T_mel, M] -> dict(z, log_s_sum, logdet_w_sum, n_elements), z in
        the JAX layout: [B, T/G, G] for WaveGlow, [B, G, T/G] for WaveFlow.
        Under an sp group (parallel/sp.py) audio and mel are this rank's
        runs (``SequenceParallel.shard_batch``) and so are z and the sums:
        ``waveglow_loss`` of them is this rank's part of the loss over the
        rank's count, which the step shares over the group. A bf16 model
        runs the flows on the audio rounded to bf16 (JAX's
        ``_squeeze(audio).astype(cfg.dtype)``); z is then bf16."""
        G = self.cfg.n_group
        B, T = audio.shape
        if sp is not None:
            _refuse_bf16_sp(self.cfg.dtype)
        x = audio[:, :(T // G) * G].reshape(B, T // G, G).transpose(1, 2).to(
            self.cfg.dtype)
        with full_float32():
            if sp is None:
                cond = self._cond(mel, speaker_ids)[..., :x.shape[2]]
            else:
                sp = sp.bind(x.shape[2])
                cond = self._cond_run(mel, speaker_ids,
                                      sp.bind(mel.shape[1]), sp)
            if self.waveflow:
                z, log_s, logdet = self._forward_waveflow(x, cond, sp)
            else:
                z, log_s, logdet = self._forward_waveglow(x, cond, sp)
                z = z.transpose(1, 2)
        return {"z": z, "log_s_sum": log_s, "logdet_w_sum": logdet,
                "n_elements": B * (T // G) * G}

    def _wn_inverse(self, k: int, x: torch.Tensor, cond: torch.Tensor,
                    sp=None):
        """Flow k's WN on the inverse's kernels. Under ``sp`` x is the
        rank's run and ``cond`` its columns widened by the WN's reach: x is
        widened as far (one exchange), the kernel runs on the widened run
        and the rank keeps the centre."""
        if sp is None:
            return self.WN[k](x, cond)
        reach = wn_reach(self.cfg)
        wide, l, _ = sp.widen(x, reach, reach)
        log_s, t = self.WN[k](wide, cond)
        n = x.shape[-1]
        return log_s[..., l:l + n], t[..., l:l + n]

    def _inverse_waveglow(self, z: torch.Tensor, cond: torch.Tensor,
                          sp=None) -> torch.Tensor:
        """z [B, G, T'] channels-first (early outputs first) -> x [B, G, T']
        in z's dtype; log_s and t rounded to the model's dtype."""
        second = self.cfg.couple_transform == "second"
        dt = self.cfg.dtype
        *early_parts, x = z.split([e for e in self._early if e]
                                  + [2 * self._half[-1]], dim=1)
        for k in reversed(range(self.cfg.n_flows)):
            xa, xb = x[:, :self._half[k]], x[:, self._half[k]:]
            if second:
                log_s, t = (v.to(dt) for v in self._wn_inverse(k, xa, cond, sp))
                xb = (xb - t) * torch.exp(-log_s)
            else:
                log_s, t = (v.to(dt) for v in self._wn_inverse(k, xb, cond, sp))
                xa = (xa - t) * torch.exp(-log_s)
            x = self.convinv[k].inverse(torch.cat([xa, xb], dim=1))
            if self._early[k]:
                x = torch.cat([early_parts.pop(), x], dim=1)
        return x

    def _inverse_waveflow(self, z: torch.Tensor, cond: torch.Tensor
                          ) -> torch.Tensor:
        """Autoregressive in height: x[h] = (z[h] - t(x[<h])) / s(x[<h]), one
        row step per row and flow. z, x [B, H, W] f32; a bf16 model's ring is
        bf16 and its x rounded to bf16 at the end."""
        B, H, W = z.shape
        ring = self.WN[0].init_ring(B, W, self.cfg.dtype)
        for k in reversed(range(self.cfg.n_flows)):
            wn = self.WN[k]
            cond_bc = wn.cond_bc(cond)
            ring.zero_()
            x_prev, rows = z.new_zeros((B, W)), []
            for h in range(H):
                log_s, t = wn.row_step(x_prev, ring, h, cond_bc)
                x_prev = (z[:, h] - t) * torch.exp(-log_s)
                rows.append(x_prev)
            order = permute_height_order(self.cfg.n_group, "bipartize", k)
            z = torch.stack(rows, dim=1)[:, np.argsort(order)]
        return z.to(self.cfg.dtype)

    @torch.no_grad()
    def inverse(self, z: torch.Tensor, mel: torch.Tensor,
                speaker_ids: Optional[torch.Tensor] = None, sp=None
                ) -> torch.Tensor:
        """Latent -> audio [B, T] f32. Under an sp group z and mel are this
        rank's runs of the time axis, and so is the audio. A bf16 model
        keeps a bf16 z as it is (WaveGlow's coupling then runs in bf16) and
        returns its bf16-valued audio as f32."""
        dev = self.device
        z = torch.as_tensor(z, device=dev)
        if not (self.cfg.dtype == BF16 and z.dtype == BF16):
            z = z.float()
        mel = torch.as_tensor(mel, dtype=torch.float32, device=dev)
        if sp is not None:
            _refuse_bf16_sp(self.cfg.dtype)
            return self._inverse_run(z, mel, speaker_ids, sp)
        with full_float32():
            cond = self._cond(mel, speaker_ids)
            if self.waveflow:
                x = self._inverse_waveflow(z.float(),
                                           cond[..., :z.shape[2]].contiguous())
                x = x.transpose(1, 2)                            # [B, W, G]
            else:
                x = self._inverse_waveglow(
                    z.transpose(1, 2), cond[..., :z.shape[1]].contiguous())
                x = x.transpose(1, 2)                            # [B, T', G]
        return x.reshape(x.shape[0], -1).float()

    def _inverse_run(self, z, mel, speaker_ids, sp) -> torch.Tensor:
        """``inverse`` of this rank's runs of z and mel."""
        G = self.cfg.n_group
        msp = sp.bind(mel.shape[1])
        if self.waveflow:
            # the row kernel's ring carries width halos from row to row:
            # gather the time axis, run the whole utterance, keep the run
            zsp = sp.bind(z.shape[2])
            full = self.inverse(zsp.gather(z, 2), msp.gather(mel, 1),
                                speaker_ids)
            return full[:, zsp.offset * G:(zsp.offset + zsp.length) * G]
        zsp = sp.bind(z.shape[1])
        with full_float32():
            cond = self._cond_run(mel, speaker_ids, msp, zsp,
                                  wn_reach(self.cfg)).contiguous()
            x = self._inverse_waveglow(z.transpose(1, 2), cond, zsp)
            x = x.transpose(1, 2)                                # [B, T', G]
        return x.reshape(x.shape[0], -1)

    def iso226(self):
        """The ISO 226 de-emphasis at the model's sampling rate, built once
        per device (its STFT's pseudo-inverse takes seconds at filter length
        2400) and kept out of the state dict."""
        cached = self.__dict__.get("_iso226")
        if cached is None or cached.stft.device != self.device:
            from ..audio.iso226 import ISO226
            cached = ISO226(sampling_rate=self.cfg.sampling_rate,
                            device=self.device)
            self.__dict__["_iso226"] = cached
        return cached

    @torch.no_grad()
    def infer(self, mel: torch.Tensor,
              generator: Optional[torch.Generator] = None,
              sigma: Optional[float] = None,
              speaker_ids: Optional[torch.Tensor] = None,
              z: Optional[torch.Tensor] = None, sp=None) -> torch.Tensor:
        """Sample z ~ N(0, sigma) from ``generator`` (a generator on the
        model's device) and invert; a given ``z`` is used as it is. With
        ``iso226_deemphasis`` the audio then loses the equal-loudness
        emphasis (JAX ``WaveGlow.infer``). Under an sp group (parallel/
        sp.py) ``mel`` (and a given ``z``) is this rank's run of the time
        axis, the draw is the one-process draw's columns of the run, and
        the audio is the run's. A bf16 model's z is drawn in f32 and rounded
        to bf16, then scaled by bf16(sigma) (JAX draws z in the model's dtype)."""
        cfg = self.cfg
        if sp is not None:
            _refuse_bf16_sp(cfg.dtype)
        if z is None:
            sigma = cfg.sigma if sigma is None else sigma
            B, T_mel = mel.shape[:2]
            n = T_mel * cfg.hop_length // cfg.n_group
            shape = (B, cfg.n_group, n) if self.waveflow else (B, n, cfg.n_group)
            kw = dict(generator=generator, device=self.device,
                      dtype=torch.float32)
            # under a dp group's scope this rank's rows of the global draw
            noise = (draw_rows(torch.randn, shape, **kw) if sp is None
                     else sp.bind(n).draw(torch.randn, shape,
                                          2 if self.waveflow else 1, **kw))
            z = (sigma * noise if cfg.dtype == F32
                 else noise.to(cfg.dtype) * hk.bf16_value(sigma))
        audio = self.inverse(z, mel, speaker_ids, sp)
        if cfg.iso226_deemphasis:
            with full_float32():
                if sp is None:
                    audio = self.iso226().inverse(audio)
                else:       # an STFT filter: over the whole utterance
                    asp = sp.bind(audio.shape[1])
                    audio = asp.columns(self.iso226().inverse(
                        asp.gather(audio, 1)), 1)
        return audio


def waveglow_loss(out: Dict[str, Any], sigma: float = 1.0
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The flow NLL per element: (sum z^2 / (2 sigma^2) - log_s_sum -
    logdet_w_sum) / n_elements, with its parts."""
    z = out["z"].float()
    n = out["n_elements"]
    nll = ((z * z).sum() / (2.0 * sigma * sigma) - out["log_s_sum"]
           - out["logdet_w_sum"]) / n
    return nll, {"loss": nll, "z_mean_sq": (z * z).mean(),
                 "log_s_mean": out["log_s_sum"] / n,
                 "logdet_w_mean": out["logdet_w_sum"] / n}

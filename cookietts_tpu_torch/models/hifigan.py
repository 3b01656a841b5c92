"""HiFi-GAN (cookietts_tpu/models/hifigan.py): the generator, for serving
and for training, the two discriminators and the losses.

mel [B, T_mel, n_mel] -> audio [B, T_mel * prod(upsample_rates)]; channels-
first [B, C, T] inside. Parameter names follow the reference (upstream
jik876/hifi-gan) checkpoints: ``conv_pre``, ``ups.{i}``,
``resblocks.{i * n_kernels + j}.convs{1,2}.{m}``, ``conv_post``;
``discriminators.{i}.convs.{j}`` and ``discriminators.{i}.conv_post`` for
each discriminator.

Two forms of the generator. ``Generator(cfg)`` serves: plain convs, and a
``weight_g``/``weight_v`` pair in a loaded state dict is folded into
``weight`` at load (``wn_weight``, by ``weight_g``'s shape, so both a
reference checkpoint and one the port's trainer wrote fold to the function
they hold). ``Generator(cfg, weight_norm=True)`` trains: every conv keeps
weight norm as a (``weight_g``, ``weight_v``) pair (``WNConv``), grouped as
flax's ``WeightNorm`` groups it: one norm per output channel, over every
other axis, for the transposed ``ups`` convs too (torch's
``weight_norm(dim=0)`` of a ``ConvTranspose1d`` groups by input channel),
with flax's epsilon; ``weight_g`` starts at ones, as flax's scale does.

``Generator.forward(mel, infer=False)`` mirrors JAX's ``infer``: with
``infer=False`` the MRF resblocks run the modules' own convs, under
autograd; ``infer=True`` (every serving call site, through
``serving_vocoder``) runs without autograd and takes the resblock kernel
where ``HiFiGANConfig.pallas_resblocks`` (the JAX field's name and values)
chose it at construction: True and "auto" (the default), every stage;
False, none. The kernel takes every width (``hifigan_resblock_plan``); True
also checks each resblock's plan at construction and raises for what it
does not take (an even kernel size, a window past shared memory), where
"auto" leaves that to the launch on the card. As with every kernel entry,
a CPU tensor takes the plain version. JAX's "auto" also picks by backend
and batch (``pallas_auto_batch_max``, a TPU measurement); the port's
ignores the batch until the kernel is timed at large batches.
``Generator.kernel_stages()`` reports the choice. A kernel resblock's
weights are re-laid out for the kernel once and cached until the
parameters change.

The discriminators train only. The multi-scale one's first scale is
spectrally normalised through ``SNConv``: the exact top singular value of
the weight (``eigh`` of the smaller Gram matrix, u and v detached) at every
call, as the JAX model computes it, not torch's power iteration.

Sequence parallelism (parallel/sp.py): ``Generator.forward(mel, infer,
sp=sp)`` takes this rank's run of the mel frames and returns its run of the
audio. The generator's reach in mel frames (``Generator.reach``: conv_pre,
each transposed conv, each stage's widest MRF at its rate, conv_post) is
computed from the configuration; the run is widened by that many frames
from the neighbours (inward only at the utterance's ends, where the convs'
own zero padding is one process's), the whole generator runs on the widened
run (the resblock kernel included) and the rank keeps its samples.

``Generator(HiFiGANConfig(dtype=torch.bfloat16))`` serves in bf16 with the
JAX package's casts (``ops/precision.py``): conv_pre, the transposed convs
and conv_post round input, weights and output to bf16 (bias added in bf16),
the leaky ReLUs run on bf16 values, each stage's MRF sums and averages its
resblocks in bf16, and every resblock runs the bf16 form of
``hifigan_resblock`` on bf16 copies of its weights (JAX's Pallas path,
``models/hifigan.py:243-246``). The audio is bf16-valued and returned as
f32. Only ``infer=True`` serves in bf16: training, the weight-norm form and
sequence parallelism refuse it (later slices).

Traps kept from the JAX model: ConvTranspose ``padding=(k-u)//2`` matches
flax's "SAME" transposed conv (the checkpoint kernel is the flipped flax
one), the MRF averages its resblocks, and the final leaky ReLU uses slope
0.01, not ``lrelu_slope``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from fractions import Fraction
from typing import Any, Callable, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import compute_dtype, refuse_bf16
from ..device import resolve_device
from ..ops import hopper_kernels as hk
from ..ops import precision
from ..parallel.sp import conv_transpose_reach


@dataclasses.dataclass(frozen=True)
class HiFiGANConfig:
    n_mel_channels: int = 80
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilations: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    mpd_periods: Tuple[int, ...] = (2, 3, 5, 7, 11)
    msd_scales: int = 3
    lrelu_slope: float = 0.1
    dtype: Any = torch.float32
    pallas_resblocks: Any = "auto"      # True, False or "auto" (see above)

    def __post_init__(self):
        # torch.float32 / torch.bfloat16 or their names (config.compute_dtype)
        object.__setattr__(self, "dtype", compute_dtype(self.dtype))


WN_EPS = 1e-12                          # flax WeightNorm's epsilon


def wn_weight(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The weight of a weight-norm pair as flax computes it,
    ``v * rsqrt(sum(v^2) + eps) * g``, the sum over the axes where ``g``
    has size 1."""
    dims = [i for i, n in enumerate(g.shape) if n == 1]
    return v * torch.rsqrt((v * v).sum(dims, keepdim=True) + WN_EPS) * g


class WNConv(nn.Module):
    """A conv (Conv1d, Conv2d or ConvTranspose1d, given built) under weight
    norm in flax's grouping: ``weight_v`` is the conv's initial weight,
    ``weight_g`` [out] (kept with the weight's rank, size 1 but on the
    output axis) starts at ones; ``weight`` is ``wn_weight(v, g)``."""

    def __init__(self, conv: nn.modules.conv._ConvNd):
        super().__init__()
        w = conv.weight.detach()
        out_axis = 1 if conv.transposed else 0
        shape = [1] * w.dim()
        shape[out_axis] = w.shape[out_axis]
        self.weight_g = nn.Parameter(torch.ones(shape, dtype=w.dtype))
        self.weight_v = nn.Parameter(w.clone())
        self.bias = conv.bias
        self.in_channels, self.out_channels = conv.in_channels, conv.out_channels
        args = dict(stride=conv.stride, padding=conv.padding,
                    dilation=conv.dilation, groups=conv.groups)
        if conv.transposed:
            self._conv = functools.partial(F.conv_transpose1d,
                                           output_padding=conv.output_padding,
                                           **args)
        else:
            self._conv = functools.partial(
                F.conv2d if w.dim() == 4 else F.conv1d, **args)

    @property
    def weight(self) -> torch.Tensor:
        return wn_weight(self.weight_v, self.weight_g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv(x, self.weight, self.bias)


def _plain(conv: nn.Module) -> nn.Module:
    return conv


def _padding(k: int, d: int = 1) -> int:
    return d * (k - 1) // 2


class ResBlock1(nn.Module):
    """MRF residual block: per dilation, lrelu -> conv(d) -> lrelu ->
    conv(1) -> residual add."""

    def __init__(self, channels: int, kernel_size: int, dilations, slope: float,
                 use_kernel: bool = True, wrap: Callable = _plain):
        super().__init__()
        self.dilations = tuple(dilations)
        self.slope = slope
        self.use_kernel = use_kernel
        self.convs1 = nn.ModuleList(
            wrap(nn.Conv1d(channels, channels, kernel_size, dilation=d,
                           padding=_padding(kernel_size, d)))
            for d in self.dilations)
        self.convs2 = nn.ModuleList(
            wrap(nn.Conv1d(channels, channels, kernel_size,
                           padding=_padding(kernel_size)))
            for _ in self.dilations)

    def kernel_weights(self, dtype: torch.dtype = torch.float32):
        """(w1, b1, w2, b2) with w [P, k, C_in, C_out] in ``dtype``, b
        [P, C] f32; built without autograd, for the inference kernel only."""
        def build():
            w = lambda convs: torch.stack(
                [c.weight.permute(2, 1, 0) for c in convs]).to(dtype).contiguous()
            b = lambda convs: torch.stack([c.bias for c in convs]).contiguous()
            return w(self.convs1), b(self.convs1), w(self.convs2), b(self.convs2)
        name = "_kernel_weights" + ("" if dtype == torch.float32 else "_bf16")
        return hk.derived(self, name, list(self.parameters()), build)

    def forward(self, x: torch.Tensor, infer: bool = False) -> torch.Tensor:
        """[B, C, T] -> [B, C, T]; the kernel's entry with ``infer`` where
        the stage takes it (its bf16 form for a bf16 x), else the modules'
        own convs."""
        if infer and self.use_kernel:
            return hk.hifigan_resblock(x.contiguous(),
                                       *self.kernel_weights(x.dtype),
                                       self.dilations, self.slope)
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2(F.leaky_relu(c1(F.leaky_relu(x, self.slope)), self.slope))
        return x


def _fold_weight_norm(state_dict, prefix, *args, **kwargs):
    """Load-time fold of weight-norm pairs into ``weight`` (``wn_weight``:
    by ``weight_g``'s shape, so torch's dim-0 pairs and the port's trained
    ones alike)."""
    for key in [k for k in state_dict if k.startswith(prefix)
                and k.endswith(".weight_g")]:
        base = key[:-len("_g")]
        g, v = state_dict.pop(key), state_dict.pop(base + "_v")
        state_dict[base] = wn_weight(v, g)


class Generator(nn.Module):
    def __init__(self, cfg: HiFiGANConfig, device: str | torch.device = "cuda",
                 weight_norm: bool = False):
        super().__init__()
        if weight_norm:
            refuse_bf16(cfg.dtype, "HiFi-GAN's weight-norm (training) form",
                        "bf16 training")
        if cfg.pallas_resblocks is False:
            refuse_bf16(cfg.dtype, "HiFi-GAN without the resblock kernel",
                        "bf16 training")
        if cfg.pallas_resblocks not in (True, False, "auto"):
            raise ValueError(f"pallas_resblocks={cfg.pallas_resblocks!r}: "
                             "True, False or 'auto'")
        self.cfg = cfg
        wrap = WNConv if weight_norm else _plain
        ch = cfg.upsample_initial_channel
        self.conv_pre = wrap(nn.Conv1d(cfg.n_mel_channels, ch, 7, padding=3))
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                       cfg.upsample_kernel_sizes)):
            self.ups.append(wrap(nn.ConvTranspose1d(
                ch // 2 ** i, ch // 2 ** (i + 1), k, u, padding=(k - u) // 2)))
            use_kernel = self._stage_uses_kernel(ch // 2 ** (i + 1))
            for rk, rd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilations):
                self.resblocks.append(ResBlock1(ch // 2 ** (i + 1), rk, rd,
                                                cfg.lrelu_slope, use_kernel,
                                                wrap))
        self.conv_post = wrap(nn.Conv1d(ch // 2 ** len(cfg.upsample_rates), 1,
                                        7, padding=3))
        if not weight_norm:
            self._register_load_state_dict_pre_hook(_fold_weight_norm)
        self.eval()
        self.to(resolve_device(device))

    def _stage_uses_kernel(self, C: int) -> bool:
        if self.cfg.pallas_resblocks is True:   # raises for what it does not take
            for k, dilations in zip(self.cfg.resblock_kernel_sizes,
                                    self.cfg.resblock_dilations):
                for d in dilations:
                    hk.hifigan_resblock_plan(1, C, 1, k, int(d))
        return self.cfg.pallas_resblocks is not False

    def kernel_stages(self) -> Tuple[Tuple[int, bool], ...]:
        """(channels, runs the hifigan_resblock kernel with infer=True) of
        each upsampling stage, as chosen at construction."""
        n_k = len(self.cfg.resblock_kernel_sizes)
        return tuple((self.resblocks[i * n_k].convs1[0].in_channels,
                      self.resblocks[i * n_k].use_kernel)
                     for i in range(len(self.ups)))

    def reach(self) -> int:
        """The mel frames an output sample depends on beyond its own, on
        the wider side, rounded up: conv_pre's (k - 1) / 2 at the mel rate;
        each transposed conv's reach in its input steps; each stage's widest
        MRF, sum over its dilation pairs of (k - 1) / 2 (d + 1), at the
        stage's rate; conv_post's at the audio rate."""
        cfg = self.cfg
        half = lambda conv: (conv.weight.shape[-1] - 1) // 2  # noqa: E731
        side = [Fraction(half(self.conv_pre))] * 2
        rate = 1
        for u, k in zip(cfg.upsample_rates, cfg.upsample_kernel_sizes):
            for i, r in enumerate(conv_transpose_reach(k, u, (k - u) // 2)):
                side[i] += r / rate
            rate *= u
            mrf = max((rk - 1) // 2 * sum(int(d) + 1 for d in rd)
                      for rk, rd in zip(cfg.resblock_kernel_sizes,
                                        cfg.resblock_dilations))
            side = [v + Fraction(mrf, rate) for v in side]
        side = [v + Fraction(half(self.conv_post), rate) for v in side]
        return math.ceil(max(side))

    def forward(self, mel: torch.Tensor, infer: bool = False, sp=None
                ) -> torch.Tensor:
        """[B, T_mel, n_mel] -> [B, T_mel * prod(upsample_rates)]. Under an
        sp group (parallel/sp.py) ``mel`` is this rank's run of the frames
        and the audio its run of the samples."""
        if not infer or sp is not None:
            refuse_bf16(self.cfg.dtype, "HiFi-GAN's training forward and "
                        "sequence-parallel inference", "bf16 training, tp "
                        "and sp")
        if sp is not None:
            msp = sp.bind(mel.shape[1])
            reach = self.reach()
            wide, l, _ = msp.widen(torch.as_tensor(
                mel, dtype=torch.float32, device=self.conv_pre.bias.device),
                reach, reach, dim=1)
            hop = math.prod(self.cfg.upsample_rates)
            out = self.forward(wide, infer)
            return out[:, l * hop:(l + mel.shape[1]) * hop]
        if infer:
            with torch.no_grad():
                return self._forward(mel, True)
        return self._forward(mel, False)

    def _forward(self, mel: torch.Tensor, infer: bool) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.dtype
        n_k = len(cfg.resblock_kernel_sizes)
        mel = torch.as_tensor(mel, device=self.conv_pre.bias.device)
        x = precision.conv1d(self.conv_pre, mel.to(dt).transpose(1, 2), dt)
        for i, up in enumerate(self.ups):
            x = precision.conv_transpose1d(
                up, precision.leaky_relu(x, cfg.lrelu_slope), dt)
            blocks = self.resblocks[i * n_k:(i + 1) * n_k]
            acc = blocks[0](x, infer)
            for block in blocks[1:]:
                acc = acc + block(x, infer)
            x = acc / n_k
        x = precision.conv1d(self.conv_post, precision.leaky_relu(x, 0.01), dt)
        return torch.tanh(x)[:, 0].float()


def serving_vocoder(fn: Callable) -> Callable:
    """A vocoder_fn as the serving paths call it: a ``Generator`` with
    ``infer=True``; any other callable as it is."""
    return functools.partial(fn, infer=True) if isinstance(fn, Generator) else fn


# -- discriminators (train only) ----------------------------------------------

class SNConv(nn.Module):
    """Conv1d under spectral norm with the exact sigma, as the JAX model's
    ``SNConv``: the top singular pair of the weight (as JAX lays it out,
    [k * in, out]) from ``eigh`` of the smaller Gram matrix, u and v
    detached, so d(sigma)/dW = v u^T; padding ((k - 1) // 2, k // 2).
    Parameters ``weight_orig`` [out, in / groups, k] and ``bias``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, groups: int = 1):
        super().__init__()
        conv = nn.Conv1d(in_channels, out_channels, kernel_size, stride,
                         groups=groups)
        self.weight_orig = nn.Parameter(conv.weight.detach().clone())
        self.bias = conv.bias
        self.stride, self.groups = stride, groups

    def sigma(self) -> torch.Tensor:
        w = self.weight_orig
        mat = w.permute(2, 1, 0).reshape(-1, w.shape[0])
        m = mat.detach()
        if m.shape[0] >= m.shape[1]:                  # eigh the smaller Gram
            u = torch.linalg.eigh(m.t() @ m)[1][:, -1]
            v = m @ u
            v = v / (v.norm() + 1e-12)
        else:
            v = torch.linalg.eigh(m @ m.t())[1][:, -1]
            u = m.t() @ v
            u = u / (u.norm() + 1e-12)
        return v @ (mat @ u)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight_orig.shape[-1]
        return F.conv1d(F.pad(x, ((k - 1) // 2, k // 2)),
                        self.weight_orig / self.sigma(), self.bias,
                        self.stride, groups=self.groups)


def _pair_forward(d: nn.Module, real: torch.Tensor, fake: torch.Tensor):
    """One discriminator on real and fake in one batch (it has no state
    across rows): (real logits, fake logits, real fmaps, fake fmaps)."""
    logits, fmaps = d(torch.cat([real, fake]))
    B = real.shape[0]
    return (logits[:B], logits[B:], [f[:B] for f in fmaps],
            [f[B:] for f in fmaps])


def _collect(outs):
    """Per-discriminator 4-tuples -> (real logits, fake logits, real fmaps,
    fake fmaps), each a list with one entry per discriminator."""
    return tuple(map(list, zip(*outs))) if outs else ([], [], [], [])


class PeriodDiscriminator(nn.Module):
    """One period of the MPD: the audio folded to [B, 1, T / p, p] (reflect
    padded to a multiple of p), five (5, 1) convs, the first four of
    stride 3, and a (3, 1) conv_post."""

    def __init__(self, period: int, slope: float = 0.1):
        super().__init__()
        self.period, self.slope = period, slope
        chans = (1, 32, 128, 512, 1024, 1024)
        self.convs = nn.ModuleList(
            WNConv(nn.Conv2d(a, b, (5, 1), (3 if i < 4 else 1, 1),
                             padding=(2, 0)))
            for i, (a, b) in enumerate(zip(chans[:-1], chans[1:])))
        self.conv_post = WNConv(nn.Conv2d(1024, 1, (3, 1), padding=(1, 0)))

    def forward(self, audio: torch.Tensor):
        """[B, T] -> (logits [B, n], feature maps)."""
        B, T = audio.shape
        p = self.period
        x = F.pad(audio[:, None], (0, (p - T % p) % p), mode="reflect")
        x = x.view(B, 1, -1, p)
        fmaps: List[torch.Tensor] = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), self.slope)
            fmaps.append(x)
        x = self.conv_post(x)
        fmaps.append(x)
        return x.reshape(B, -1), fmaps


MSD_CONVS = ((1, 128, 15, 1, 1), (128, 128, 41, 2, 4), (128, 256, 41, 2, 16),
             (256, 512, 41, 4, 16), (512, 1024, 41, 4, 16),
             (1024, 1024, 41, 1, 16), (1024, 1024, 5, 1, 1))


class ScaleDiscriminator(nn.Module):
    """One scale of the MSD: seven grouped strided convs and conv_post,
    spectral-normed (``SNConv``) or weight-normed."""

    def __init__(self, slope: float = 0.1, use_spectral_norm: bool = False):
        super().__init__()
        self.slope = slope

        def conv(a, b, k, s, g):
            if use_spectral_norm:
                return SNConv(a, b, k, s, g)
            return WNConv(nn.Conv1d(a, b, k, s, padding=_padding(k), groups=g))

        self.convs = nn.ModuleList(conv(*spec) for spec in MSD_CONVS)
        self.conv_post = conv(1024, 1, 3, 1, 1)

    def forward(self, audio: torch.Tensor):
        x = audio[:, None]
        fmaps: List[torch.Tensor] = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), self.slope)
            fmaps.append(x)
        x = self.conv_post(x)
        fmaps.append(x)
        return x.reshape(audio.shape[0], -1), fmaps


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, cfg: HiFiGANConfig, device: str | torch.device = "cuda"):
        super().__init__()
        self.discriminators = nn.ModuleList(
            PeriodDiscriminator(p, cfg.lrelu_slope) for p in cfg.mpd_periods)
        self.to(resolve_device(device))

    def forward(self, real: torch.Tensor, fake: torch.Tensor):
        """Returns (real_logits, fake_logits, real_fmaps, fake_fmaps), one
        entry per period."""
        return _collect([_pair_forward(d, real, fake)
                         for d in self.discriminators])


class MultiScaleDiscriminator(nn.Module):
    def __init__(self, cfg: HiFiGANConfig, device: str | torch.device = "cuda"):
        super().__init__()
        self.discriminators = nn.ModuleList(
            ScaleDiscriminator(cfg.lrelu_slope, use_spectral_norm=(i == 0))
            for i in range(cfg.msd_scales))
        self.to(resolve_device(device))

    def forward(self, real: torch.Tensor, fake: torch.Tensor):
        """As MultiPeriodDiscriminator's, one entry per scale; each scale
        after the first sees the audio average-pooled (4, 2, padding 2,
        padding counted) once more."""
        outs = []
        for i, d in enumerate(self.discriminators):
            if i:
                real, fake = (F.avg_pool1d(a[:, None], 4, 2, padding=2)[:, 0]
                              for a in (real, fake))
            outs.append(_pair_forward(d, real, fake))
        return _collect(outs)


# -- losses -------------------------------------------------------------------

def discriminator_loss(real_logits, fake_logits) -> torch.Tensor:
    """LSGAN: sum of mean((1 - D(y))^2) + mean(D(y_hat)^2)."""
    loss = real_logits[0].new_zeros(())
    for rl, fl in zip(real_logits, fake_logits):
        loss = loss + torch.mean((1.0 - rl) ** 2) + torch.mean(fl ** 2)
    return loss


def generator_loss(fake_logits) -> torch.Tensor:
    """LSGAN: sum of mean((1 - D(y_hat))^2)."""
    loss = fake_logits[0].new_zeros(())
    for fl in fake_logits:
        loss = loss + torch.mean((1.0 - fl) ** 2)
    return loss


def feature_loss(real_fmaps, fake_fmaps) -> torch.Tensor:
    """L1 feature matching over every feature map, times 2."""
    loss = real_fmaps[0][0].new_zeros(())
    for rfs, ffs in zip(real_fmaps, fake_fmaps):
        for rf, ff in zip(rfs, ffs):
            loss = loss + torch.mean(torch.abs(rf - ff))
    return loss * 2.0


def mel_l1_loss(mel_real: torch.Tensor, mel_fake: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(mel_real - mel_fake))

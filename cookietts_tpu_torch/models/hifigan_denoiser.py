"""HiFi-GAN Denoiser, the waveform denoising vocoder
(cookietts_tpu/models/hifigan_denoiser.py).

- :class:`MultiResSpect`: multi-resolution STFT magnitudes, each bank cut
  and reshaped to a common channel height and concatenated.
- :class:`DenoiserWN`: the staged generator, a WN stack and a 1x1
  ``wn_end`` at stage 0; a :class:`PostNet` and ``postnet_end`` after the
  WN at stage >= 1. Every head is built at every stage, so a stage
  promotion resumes the same parameters; only the stage's head runs.
- :class:`WaveDiscriminator` (DW): MelGAN-style multi-scale waveform
  critics with a learned residual/skip mix.
- :class:`SpectDiscriminator` (DS): StarGAN-VC-style conv/BN/GLU blocks
  over the multi-resolution spectrogram.
- :func:`denoiser_loss` and the BCE helpers: stage < 2 is the log-spectral
  L1 plus the audio L1; stage >= 2 is pure BCE over the summed critic
  logits (fakeness: real label 0, fake label 1).

JAX's documented deviations from the reference are kept: DS tracks the
true height through its VALID blocks (the reference's tracking makes its
own default config crash), and DS's BatchNorm uses batch statistics with no
running state (the critics have no eval form).

Audio is [B, T]; the convs run channels-first, [B, C, T]. The WN's convs and
DW's are weight-normed in flax's grouping (``WNConv``: ``weight_v``,
``weight_g`` on the output axis). Parameter names are JAX's module names
(``wn.start``, ``wn.in_layer{i}``, ``wn.res_skip{i}``, ``wn.end``,
``wn_end``, ``postnet.conv{i}``, ``postnet.res_weights``, ``postnet_end``;
``dw{i}.conv{j}``, ``dw{i}.res_weights``, ``dw{i}.layr_weights``;
``block{i}.conv``, ``block{i}.bn_scale``, ``block{i}.bn_bias``,
``block{i}.glu``, ``end_conv``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..audio.stft import STFT
from ..device import resolve_device
from ..parallel.mesh import batch_means
from .hifigan import WNConv
from .waveglow import GATED_UNITS

# the reference config.json's WN dilations: the 1..1024 cycle, twice
_WN_DILATIONS_22 = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024,
                    1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


@dataclasses.dataclass(frozen=True)
class HiFiGANDenoiserConfig:
    # WN generator (config.json WN_config)
    wn_layers: int = 22
    wn_channels: int = 128
    kernel_size: int = 3
    end_kernel_size: int = 5
    wn_dilations: Optional[Tuple[int, ...]] = _WN_DILATIONS_22
    gated_unit: str = "GTU"
    # PostNet (config.json postnet_config; active at stage >= 1)
    postnet_layers: int = 12
    postnet_channels: int = 128
    postnet_kernel_size: int = 32
    # multi-res spect (config.json DS_config; window == filter lengths)
    window_lengths: Tuple[int, ...] = (2400, 1200, 600)
    hop_lengths: Tuple[int, ...] = (600, 300, 150)
    # DW (config.json DW_config)
    dw_n_discriminators: int = 3
    dw_kernel_sizes: Tuple[int, ...] = (15, 41, 41, 41, 41, 5, 3)
    dw_strides: Tuple[int, ...] = (1, 4, 4, 4, 4, 1, 1)
    dw_channels: Tuple[int, ...] = (16, 64, 256, 1024, 1024, 1024, 1)
    dw_group_sizes: Tuple[int, ...] = (1, 4, 16, 64, 256, 1, 1)
    # DS blocks: (kernel_h, kernel_w, stride_h, stride_w, n_channels)
    ds_block_confs: Tuple[Tuple[int, int, int, int, int], ...] = (
        (3, 9, 1, 2, 32), (3, 8, 1, 2, 32),
        (3, 8, 1, 2, 32), (3, 6, 1, 2, 32))
    stage: int = 0


def log_compress(x: torch.Tensor, clip_val: float = 1e-5) -> torch.Tensor:
    """dynamic_range_compression: ln of the magnitude floored at clip_val."""
    return torch.log(x.float().clamp_min(clip_val))


class MultiResSpect:
    """Multi-resolution magnitudes, concatenated channel-major: each bank's
    Nyquist bin dropped (filter_length / 2 channels), every bank cut to a
    common element count (a multiple of the largest bank's height),
    reshaped to [B, max_channels, -1] and concatenated along channels.
    Returns LINEAR magnitudes [B, n_banks * max_channels, T']; callers apply
    :func:`log_compress`."""

    def __init__(self, window_lengths: Sequence[int],
                 hop_lengths: Sequence[int],
                 device: str | torch.device = "cuda"):
        self.banks = [STFT(w, h, w, device=device)
                      for w, h in zip(window_lengths, hop_lengths)]
        self.max_channels = max(int(w) for w in window_lengths) // 2

    def per_bank(self, audio: torch.Tensor) -> List[torch.Tensor]:
        """[B, C_i, T_i] linear magnitudes per bank (Nyquist dropped)."""
        return [bank.transform(audio.float(), return_phase=False)[0]
                .transpose(1, 2)[:, :-1, :] for bank in self.banks]

    def __call__(self, audio: torch.Tensor) -> torch.Tensor:
        specs = self.per_bank(audio)
        mc = self.max_channels
        min_ct = min((s.shape[1] * s.shape[2]) // mc * mc for s in specs)
        return torch.cat([s[:, :, :min_ct // s.shape[1]].reshape(
            s.shape[0], mc, -1) for s in specs], 1)


class WN(nn.Module):
    """Non-causal WaveNet stack with no cond input: layers before the last
    emit 2n channels (the first n into the residual stream, the second n
    into the skip sum), the last emits n, all skip; ``end`` is a
    k=end_kernel_size conv. Every conv is weight-normed."""

    def __init__(self, cfg: HiFiGANDenoiserConfig, n_out_channels: int):
        super().__init__()
        self.cfg = cfg
        n, k = cfg.wn_channels, cfg.kernel_size
        self.gate = GATED_UNITS[cfg.gated_unit]
        self.start = WNConv(nn.Conv1d(1, n, 1))
        for i in range(cfg.wn_layers):
            d = 2 ** i if cfg.wn_dilations is None else int(cfg.wn_dilations[i])
            self.add_module(f"in_layer{i}", WNConv(nn.Conv1d(
                n, 2 * n, k, dilation=d, padding=(k * d - d) // 2)))
            rs = n if i == cfg.wn_layers - 1 else 2 * n
            self.add_module(f"res_skip{i}", WNConv(nn.Conv1d(n, rs, 1)))
        ke = cfg.end_kernel_size
        self.end = WNConv(nn.Conv1d(n, n_out_channels, ke,
                                    padding=(ke - 1) // 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C_in, T] -> [B, n_out_channels, T]."""
        n, L = self.cfg.wn_channels, self.cfg.wn_layers
        h, output = self.start(x), None
        for i in range(L):
            acts = getattr(self, f"in_layer{i}")(h)
            rs = getattr(self, f"res_skip{i}")(self.gate(acts[:, :n],
                                                         acts[:, n:]))
            if i == L - 1:
                skip = rs
            else:
                h = h + rs[:, :n]
                skip = rs[:, n:]
            output = skip if output is None else output + skip
        return self.end(output)


class PostNet(nn.Module):
    """Residual tanh conv refiner: even kernels with alternating asymmetric
    padding, per-layer learned residual weights starting at 0.01."""

    def __init__(self, cfg: HiFiGANDenoiserConfig, n_channels: int,
                 n_out_channels: int):
        super().__init__()
        self.cfg = cfg
        k, L = cfg.postnet_kernel_size, cfg.postnet_layers
        self.res_weights = nn.Parameter(torch.full((L,), 0.01))
        width = n_channels
        for i in range(L):
            out = n_out_channels if i + 1 == L else cfg.postnet_channels
            self.add_module(f"conv{i}", nn.Conv1d(width, out, k))
            width = out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.cfg.postnet_kernel_size
        for i in range(self.cfg.postnet_layers):
            left, right = (k - 1) // 2, -(-(k - 1) // 2)
            if i % 2 == 1:
                left, right = right, left
            y = getattr(self, f"conv{i}")(F.pad(x, (left, right)))
            x = x + self.res_weights[i] * torch.tanh(y)
        return x


class DenoiserWN(nn.Module):
    """The staged generator: [B, T] noisy audio -> [B, T] denoised audio.
    Stage 0: WN -> 1x1 ``wn_end``; stage >= 1: WN -> PostNet -> 1x1
    ``postnet_end``. ``wn_channels > postnet_channels`` is refused: the
    PostNet adds its postnet_channels-wide outputs into the WN's stream."""

    def __init__(self, cfg: HiFiGANDenoiserConfig,
                 device: str | torch.device = "cuda"):
        super().__init__()
        if cfg.wn_channels > cfg.postnet_channels:
            raise ValueError(
                f"wn_channels={cfg.wn_channels} > postnet_channels="
                f"{cfg.postnet_channels}: PostNet residual-adds "
                "postnet_channels-wide conv outputs into the WN output "
                "stream, so postnet_channels must be >= wn_channels")
        self.cfg = cfg
        out_ch = max(cfg.wn_channels, cfg.postnet_channels)
        self.wn = WN(cfg, out_ch)
        self.wn_end = nn.Conv1d(out_ch, 1, 1)
        self.postnet = PostNet(cfg, out_ch, out_ch)
        self.postnet_end = nn.Conv1d(out_ch, 1, 1)
        self.to(resolve_device(device))

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        h = self.wn(audio.float()[:, None, :])
        if self.cfg.stage == 0:
            return self.wn_end(h)[:, 0]
        return self.postnet_end(self.postnet(h))[:, 0]


class DWModule(nn.Module):
    """One waveform critic: VALID grouped strided weight-normed convs, each
    layer's output a learned mix of the conv's response (``res_weights``,
    starting in U[0.01, 0.11]) and a centre crop of its input
    (``layr_weights``, starting at 1) added into the first min(C_in, C_out)
    channels; the mean over time -> [B]."""

    def __init__(self, cfg: HiFiGANDenoiserConfig):
        super().__init__()
        self.cfg = cfg
        L = len(cfg.dw_kernel_sizes)
        self.res_weights = nn.Parameter(torch.rand(L) * 0.1 + 0.01)
        self.layr_weights = nn.Parameter(torch.ones(L))
        width = 1
        for i, (k, s, ch, g) in enumerate(zip(
                cfg.dw_kernel_sizes, cfg.dw_strides, cfg.dw_channels,
                cfg.dw_group_sizes)):
            self.add_module(f"conv{i}", WNConv(nn.Conv1d(width, ch, k,
                                                         stride=s, groups=g)))
            width = ch

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        x = audio.float()[:, None, :]
        for i, k in enumerate(self.cfg.dw_kernel_sizes):
            if x.shape[2] < k:                  # right-pad short inputs
                x = F.pad(x, (0, k - x.shape[2]))
            res = F.leaky_relu(getattr(self, f"conv{i}")(x), 0.2)
            t_in, t_out = x.shape[2], res.shape[2]
            left = (t_in - t_out) // 2
            mc = min(res.shape[1], x.shape[1])
            skip = x[:, :mc, left:left + t_out]
            x = self.res_weights[i] * res
            x = torch.cat([x[:, :mc] + self.layr_weights[i] * skip,
                           x[:, mc:]], 1)
        return x[:, 0].mean(1)


class WaveDiscriminator(nn.Module):
    """DW: ``dw_n_discriminators`` DWModules over successively avg-pooled
    (k=4, s=2) audio; fakeness logits summed -> [B]."""

    def __init__(self, cfg: HiFiGANDenoiserConfig,
                 device: str | torch.device = "cuda"):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.dw_n_discriminators):
            self.add_module(f"dw{i}", DWModule(cfg))
        self.to(resolve_device(device))

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        x, total = audio.float(), None
        n = self.cfg.dw_n_discriminators
        for i in range(n):
            y = getattr(self, f"dw{i}")(x)
            total = y if total is None else total + y
            if i != n - 1:
                x = F.avg_pool1d(x[:, None], 4, 2)[:, 0]
        return total


class StarGANBlock(nn.Module):
    """Conv2d (VALID), BatchNorm on the batch's biased statistics (no
    running state), then a 1x1 GLU."""

    def __init__(self, in_channels: int, channels: int,
                 kernel: Tuple[int, int], strides: Tuple[int, int]):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, channels, kernel, stride=strides)
        self.bn_scale = nn.Parameter(torch.ones(channels))
        self.bn_bias = nn.Parameter(torch.zeros(channels))
        self.glu = nn.Conv2d(channels, 2 * channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x).float()
        # over the global batch under a data-parallel group
        mean = batch_means(x, dims=(0, 2, 3))[0].view(1, -1, 1, 1)
        var = batch_means((x - mean) ** 2, dims=(0, 2, 3))[0].view(1, -1, 1, 1)
        x = ((x - mean) * torch.rsqrt(var + 1e-5)
             * self.bn_scale.view(1, -1, 1, 1) + self.bn_bias.view(1, -1, 1, 1))
        a, b = self.glu(x).chunk(2, 1)
        return a * torch.sigmoid(b)


class SpectDiscriminator(nn.Module):
    """DS: StarGAN blocks over the multi-res spectrogram [B, C, T]
    (log-compressed by the caller) as a one-channel image [B, 1, C, T],
    then a crush conv spanning the remaining frequency height (the true
    height through the VALID blocks), the mean over time -> [B]."""

    def __init__(self, cfg: HiFiGANDenoiserConfig,
                 device: str | torch.device = "cuda"):
        super().__init__()
        self.cfg = cfg
        height = len(cfg.window_lengths) * (max(cfg.window_lengths) // 2)
        width = 1
        for i, (kh, kw, sh, sw, ch) in enumerate(cfg.ds_block_confs):
            self.add_module(f"block{i}", StarGANBlock(width, ch, (kh, kw),
                                                      (sh, sw)))
            height, width = (height - kh) // sh + 1, ch
        self.end_conv = nn.Conv2d(width, 1, (height, 3))
        self.to(resolve_device(device))

    def min_frames(self) -> int:
        """The narrowest spectrogram (frames) the blocks and the crush conv
        take."""
        width = 3
        for _, kw, _, sw, _ in reversed(self.cfg.ds_block_confs):
            width = (width - 1) * sw + kw
        return width

    def forward(self, spect: torch.Tensor) -> torch.Tensor:
        if spect.shape[-1] < self.min_frames():
            # JAX's VALID convs return an empty map here, and DS a NaN
            raise ValueError(
                f"DS takes at least {self.min_frames()} spectrogram frames, "
                f"got {spect.shape[-1]}: lengthen the audio segments")
        x = spect.float()[:, None]
        for i in range(len(self.cfg.ds_block_confs)):
            x = getattr(self, f"block{i}")(x)
        return self.end_conv(x)[:, 0, 0].mean(1)


# -- losses ---------------------------------------------------------------------

def spectral_losses(mrs: MultiResSpect, pred_audio: torch.Tensor,
                    gt_audio: torch.Tensor):
    """(L1, MSE) over the log-compressed multi-res spectrogram."""
    d = log_compress(mrs(pred_audio)) - log_compress(mrs(gt_audio))
    return d.abs().mean(), (d * d).mean()


def fakeness_bce(logits: torch.Tensor, fake_label: float) -> torch.Tensor:
    """BCE(sigmoid(logits), label) with fakeness semantics (real 0, fake 1),
    in stable logit form."""
    return F.softplus(-logits if fake_label else logits).mean()


def denoiser_loss(mrs: MultiResSpect, pred_audio: torch.Tensor,
                  gt_audio: torch.Tensor, stage: int = 0,
                  dw_fake: Optional[torch.Tensor] = None,
                  ds_fake: Optional[torch.Tensor] = None):
    """The generator's loss -> (total, parts). Stage < 2: L1 of the log
    multi-res spectrogram plus L1 of the audio. Stage >= 2: pure
    adversarial BCE over the summed DS + DW fakeness logits toward the real
    label 0 (the reference drops the spectral terms once the critics turn
    on)."""
    if stage >= 2 and dw_fake is not None and ds_fake is not None:
        adv = fakeness_bce(dw_fake + ds_fake, fake_label=0.0)
        return adv, {"adv": adv, "loss": adv}
    l1, mse = spectral_losses(mrs, pred_audio, gt_audio)
    audio_l1 = (pred_audio.float() - gt_audio.float()).abs().mean()
    total = l1 + audio_l1
    return total, {"spec_L1": l1, "spec_MSE": mse, "audio_L1": audio_l1,
                   "loss": total}

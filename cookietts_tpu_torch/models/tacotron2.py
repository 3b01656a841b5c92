"""Tacotron2 (cookietts_tpu/models/tacotron2.py): inference and the
teacher-forced training forward.

Text -> encoder (3 x conv+BN, BiLSTM, sylps head) -> memory (encoder
outputs, speaker embedding, SylpsNet z, crushed torchMoji; bottleneck) ->
autoregressive decoder (prenet with always-on dropout, attention-RNN,
location-sensitive windowed attention, decoder RNNs, mel projection and
gate) -> postnet. Mels are [B, T, n_mel], alignments [B, T_dec, T_enc].

The decoder runs in chunks of steps (``Decoder.decode_chunk``), one step at
a time in Python; the per-step work runs in the ``lstm_gates`` (three cells)
and ``attention_step`` kernels. ``Decoder.inference`` is a loop over chunks,
through ``chunk_fn`` when the caller passes one (``pipeline/chunk_graph.py``:
the chunk captured as a CUDA graph). ``early_exit`` stops one chunk after
every row's gate has fired, as the JAX while-loop does; frames after the last
chunk run stay zero (gates -1e4). ``Tacotron2.inference_prepare`` /
``decode_chunk`` / ``postnet_refine`` expose the same pieces for streaming
(``pipeline/streaming.py``).

``Tacotron2.forward`` is the teacher-forced pass of training
(``Decoder.forward``: frames-per-step grouping, the GO frame, teacher forcing
drawn per step, the per-lane TBPTT carry), with drop-frame and the postnet.
``train()`` switches on the encoder conv dropout, BatchNorm batch statistics
(flax's: the biased variance over every position, momentum 0.99), SylpsNet
sampling, the LSTM cells' zoneout and dropout and the postnet dropout (0.5,
fixed as in JAX). Randomness comes from the ``generator`` passed in. The
model starts in eval mode; the inference methods always run in eval form.

Submodule and parameter names follow the reference torch checkpoint, so its
``state_dict`` (and ``convert.from_jax``'s) loads as it is. The reference's
two LSTM biases are one in JAX; each pair's ``bias_hh`` is frozen.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree
from torch import nn

from ..device import resolve_device
from ..ops.attention import (AttentionState, ConvNorm, LinearNorm,
                             LocationSensitiveAttention)
from ..ops.lstm import ZoneoutLSTMCell
from ..ops.masking import (dropout_frame, get_first_over_thresh,
                           get_mask_from_lengths)
from .sylpsnet import SylpsNet


@dataclasses.dataclass(frozen=True)
class Tacotron2Config:
    # symbols / speakers
    n_symbols: int = 256
    symbols_embedding_dim: int = 512
    n_speakers: int = 512
    speaker_embedding_dim: int = 256
    # mel
    n_mel_channels: int = 80
    n_frames_per_step: int = 1
    # encoder
    encoder_speaker_embed_dim: int = 64
    encoder_concat_speaker_embed: str = "before_conv"  # or "before_lstm"
    encoder_kernel_size: int = 5
    encoder_n_convolutions: int = 3
    encoder_conv_hidden_dim: int = 512
    encoder_lstm_dim: int = 1024          # total (both directions)
    encoder_conv_dropout: float = 0.5
    # sylpsnet
    sylpsnet_layer_dims: Tuple[int, ...] = (32, 32)
    # torchmoji conditioning
    torchmoji_dim: int = 2304
    torchmoji_crushed_dim: int = 32
    torchmoji_batchnorm: bool = True
    # memory bottleneck
    use_memory_bottleneck: bool = True
    memory_bottleneck_dim: int = 512
    memory_bottleneck_bias: bool = False
    # prenet
    prenet_dim: int = 256
    prenet_layers: int = 2
    p_prenet_dropout: float = 0.5
    # attention rnn
    attention_rnn_dim: int = 1280
    p_attrnn_dropout: float = 0.10
    attrnn_zoneout: float = 0.0
    attrnn_extra_decoder_input: bool = True
    # decoder rnn
    decoder_rnn_dim: int = 768
    p_decrnn_dropout: float = 0.25
    decrnn_zoneout: float = 0.0
    decoder_residual_connection: bool = False
    second_decoder_rnn_dim: int = 768     # 0 disables
    second_decoder_residual_connection: bool = True
    # attention
    attention_type: int = 0
    attention_dim: int = 192
    windowed_attention_range: int = 16
    windowed_att_pos_offset: float = 1.25
    windowed_att_pos_learned: bool = True
    attention_learned_temperature: bool = False
    attention_location_n_filters: int = 32
    attention_location_kernel_size: int = 31
    # the JAX opt-in kernel flags; the port always runs its kernels
    use_pallas_attention: bool = False
    use_pallas_lstm: bool = False
    num_att_mixtures: int = 1
    delta_offset: float = 0.005
    delta_min_limit: float = 0.0
    dynamic_filter_num: int = 128
    dynamic_filter_len: int = 21
    # postnet
    use_postnet: bool = True
    postnet_embedding_dim: int = 512
    postnet_kernel_size: int = 5
    postnet_n_convolutions: int = 6
    postnet_residual_connections: int = 3
    # style heads (not in this port yet)
    use_gst: bool = False
    gst_token_num: int = 10
    gst_token_embedding_size: int = 256
    gst_num_heads: int = 8
    gst_att_dim: int = 128
    gst_ref_enc_filters: Tuple[int, ...] = (32, 32, 64, 64, 128, 128)
    use_emotionnet: bool = False
    n_emotion_classes: int = 16
    emotionnet_latent_dim: int = 32
    # inference
    gate_threshold: float = 0.5
    gate_delay: int = 10
    max_decoder_steps: int = 3000
    # precision
    dtype: Any = torch.float32


def _dropout(x: torch.Tensor, p: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with a keep mask drawn from ``generator``."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), 0.0)


class BatchNorm1d(nn.BatchNorm1d):
    """BatchNorm with flax's training statistics: normalise by the biased
    batch variance E[x^2] - E[x]^2 over every position but the channel one
    (padding included), and move the running averages by 1 - 0.99 with that
    same variance. Eval uses the running averages as nn.BatchNorm1d does."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        mean = x.mean(dims)
        var = ((x * x).mean(dims) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
            self.num_batches_tracked.add_(1)
        y = (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
        return y * self.weight.view(shape) + self.bias.view(shape)


class Prenet(nn.Module):
    """Bias-free Linear + ReLU + dropout, dropout ALWAYS on (also at
    inference, like the reference). Keep masks come from ``generator``, or
    from ``masks`` (one bool tensor per layer) when a test injects them."""

    def __init__(self, in_dim: int, cfg: Tacotron2Config):
        super().__init__()
        dims = [in_dim] + [cfg.prenet_dim] * cfg.prenet_layers
        self.layers = nn.ModuleList(
            LinearNorm(a, b, bias=False) for a, b in zip(dims[:-1], dims[1:]))
        self.p = cfg.p_prenet_dropout

    def forward(self, x, generator: Optional[torch.Generator] = None,
                masks=None):
        for i, layer in enumerate(self.layers):
            x = F.relu(layer(x))
            if self.p > 0:
                x = (torch.where(masks[i], x / (1.0 - self.p), 0.0)
                     if masks is not None else _dropout(x, self.p, generator))
        return x


class Postnet(nn.Module):
    """Residual-accumulating conv stack; returns the REFINED mel. Every
    ``postnet_residual_connections``-th conv (and the last) projects to mel
    channels and adds into the running mel; the others are
    conv+BN+tanh at ``postnet_embedding_dim``, with dropout 0.5 after the
    tanh in training (fixed, as in JAX)."""

    def __init__(self, cfg: Tacotron2Config):
        super().__init__()
        n, b_res = cfg.postnet_n_convolutions, cfg.postnet_residual_connections
        self.is_output = [(bool(b_res) and i % b_res == 0) or i == n - 1
                          for i in range(n)]
        convs, in_ch = [], cfg.n_mel_channels
        for out in self.is_output:
            out_ch = cfg.n_mel_channels if out else cfg.postnet_embedding_dim
            layer = [ConvNorm(in_ch, out_ch, cfg.postnet_kernel_size)]
            if not out:
                layer.append(BatchNorm1d(out_ch))
            convs.append(nn.Sequential(*layer))
            in_ch = out_ch
        self.convolutions = nn.ModuleList(convs)

    def forward(self, mel: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x_orig = h = mel.transpose(1, 2)                     # [B, M, T]
        for out, layer in zip(self.is_output, self.convolutions):
            y = layer(h)
            if out:
                x_orig = x_orig + y
                h = x_orig
            else:
                h = torch.tanh(y)
                if self.training:
                    h = _dropout(h, 0.5, generator)
        return x_orig.transpose(1, 2)


class Encoder(nn.Module):
    """Conv stack + BiLSTM with the speaker-embed concat and sylps head."""

    def __init__(self, cfg: Tacotron2Config):
        super().__init__()
        self.cfg = cfg
        spk = cfg.encoder_speaker_embed_dim
        if spk > 0:
            self.encoder_speaker_embedding = nn.Embedding(cfg.n_speakers, spk)
        in_ch = cfg.symbols_embedding_dim + (
            spk if cfg.encoder_concat_speaker_embed == "before_conv" else 0)
        convs = []
        for i in range(cfg.encoder_n_convolutions):
            if i == cfg.encoder_n_convolutions - 1:
                out_ch = cfg.encoder_lstm_dim - (
                    spk if cfg.encoder_concat_speaker_embed == "before_lstm" else 0)
            else:
                out_ch = cfg.encoder_conv_hidden_dim
            convs.append(nn.Sequential(
                ConvNorm(in_ch, out_ch, cfg.encoder_kernel_size),
                BatchNorm1d(out_ch)))
            in_ch = out_ch
        self.convolutions = nn.ModuleList(convs)
        self.lstm = nn.LSTM(cfg.encoder_lstm_dim, cfg.encoder_lstm_dim // 2,
                            batch_first=True, bidirectional=True)
        self.lstm.bias_hh_l0.requires_grad_(False)          # JAX: one bias
        self.lstm.bias_hh_l0_reverse.requires_grad_(False)
        self.sylps_layer = LinearNorm(cfg.encoder_lstm_dim, 1)

    def forward(self, embedded: torch.Tensor, text_lengths: torch.Tensor,
                speaker_embed: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None):
        """embedded [B, T, E] -> (outputs [B, T, lstm_dim], pred_sylps [B])."""
        cfg = self.cfg
        B, T, _ = embedded.shape
        mask = get_mask_from_lengths(text_lengths, T)[:, :, None]
        spk = (None if speaker_embed is None else
               speaker_embed[:, None, :].expand(B, T, speaker_embed.shape[-1]))
        x = embedded
        if spk is not None and cfg.encoder_concat_speaker_embed == "before_conv":
            x = torch.cat([x, spk], dim=-1)
        mask_c = mask.transpose(1, 2)
        x = x.transpose(1, 2)
        for layer in self.convolutions:
            x = F.leaky_relu(layer(x * mask_c), 0.01)
            if self.training and cfg.encoder_conv_dropout > 0:
                x = _dropout(x, cfg.encoder_conv_dropout, generator)
        x = x.transpose(1, 2)
        if spk is not None and cfg.encoder_concat_speaker_embed == "before_lstm":
            x = torch.cat([x, spk], dim=-1)
        x = x * mask

        # the reverse direction runs inside each row's length, like flax's
        # nn.RNN(reverse=True, keep_order=True, seq_lengths=...)
        lengths = text_lengths.clamp_min(1).cpu()
        packed = nn.utils.rnn.pack_padded_sequence(
            x, lengths, batch_first=True, enforce_sorted=False)
        out, _ = self.lstm(packed)
        out, _ = nn.utils.rnn.pad_packed_sequence(
            out, batch_first=True, total_length=T)
        half = cfg.encoder_lstm_dim // 2
        idx = (text_lengths - 1).clamp_min(0)
        h_fwd = out[torch.arange(B, device=out.device), idx, :half]
        h_bwd = out[:, 0, half:]
        pred_sylps = self.sylps_layer(torch.cat([h_fwd, h_bwd], dim=-1))[:, 0]
        return out * mask, pred_sylps


class MemoryBottleneck(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, bias: bool):
        super().__init__()
        self.bottleneck = LinearNorm(in_dim, out_dim, bias=bias)

    def forward(self, x):
        return self.bottleneck(x)


class DecoderState(NamedTuple):
    attn: Tuple[torch.Tensor, torch.Tensor]    # attention-RNN (c, h)
    dec: Tuple[torch.Tensor, torch.Tensor]     # decoder-RNN (c, h)
    dec2: Tuple[torch.Tensor, torch.Tensor]    # second decoder-RNN (c, h)
    attention: AttentionState
    context: torch.Tensor                      # [B, memory_dim]
    prev_output: torch.Tensor                  # [B, n_mel * r]
    finished: torch.Tensor                     # [B] bool


class TrainCarry(NamedTuple):
    """The decoder state a TBPTT segment hands to the next one, and the
    segment's last ground-truth frame group (the next one's GO frame)."""
    state: DecoderState
    prev_teacher: torch.Tensor                 # [B, n_mel * r]


class Decoder(nn.Module):
    def __init__(self, cfg: Tacotron2Config, memory_in_dim: int):
        super().__init__()
        self.cfg = cfg
        mem = memory_in_dim
        if cfg.use_memory_bottleneck:
            self.memory_bottleneck = MemoryBottleneck(
                memory_in_dim, cfg.memory_bottleneck_dim,
                cfg.memory_bottleneck_bias)
            mem = cfg.memory_bottleneck_dim
        self.memory_dim = mem
        mel_dim = cfg.n_mel_channels * cfg.n_frames_per_step
        self.prenet = Prenet(mel_dim, cfg)
        attn_in = cfg.prenet_dim + mem + (
            cfg.decoder_rnn_dim if cfg.attrnn_extra_decoder_input else 0)
        self.attention_rnn = ZoneoutLSTMCell(
            attn_in, cfg.attention_rnn_dim, cfg.attrnn_zoneout,
            cfg.p_attrnn_dropout)
        self.attention_layer = LocationSensitiveAttention(
            cfg.attention_rnn_dim, mem, cfg.attention_dim,
            cfg.attention_location_n_filters,
            cfg.attention_location_kernel_size,
            cfg.windowed_attention_range, cfg.windowed_att_pos_learned,
            cfg.windowed_att_pos_offset, cfg.attention_learned_temperature)
        if cfg.windowed_attention_range > 0:
            self.exp_smoothing_factor = nn.Parameter(torch.zeros(1))
        self.decoder_rnn = ZoneoutLSTMCell(
            cfg.attention_rnn_dim + mem, cfg.decoder_rnn_dim,
            cfg.decrnn_zoneout, cfg.p_decrnn_dropout)
        final = cfg.decoder_rnn_dim
        if cfg.second_decoder_rnn_dim > 0:
            self.second_decoder_rnn = ZoneoutLSTMCell(
                cfg.decoder_rnn_dim, cfg.second_decoder_rnn_dim,
                cfg.decrnn_zoneout, cfg.p_decrnn_dropout)
            final = cfg.second_decoder_rnn_dim
        self.linear_projection = LinearNorm(final + mem, mel_dim)
        self.gate_layer = LinearNorm(final + mem, cfg.n_frames_per_step)

    def init_state(self, batch: int, t_enc: int, device) -> DecoderState:
        cfg = self.cfg
        z = lambda d: (torch.zeros(batch, d, device=device),
                       torch.zeros(batch, d, device=device))
        return DecoderState(
            attn=z(cfg.attention_rnn_dim), dec=z(cfg.decoder_rnn_dim),
            dec2=z(max(cfg.second_decoder_rnn_dim, 1)),
            attention=LocationSensitiveAttention.init_state(batch, t_enc, device),
            context=torch.zeros(batch, self.memory_dim, device=device),
            prev_output=torch.zeros(
                batch, cfg.n_mel_channels * cfg.n_frames_per_step, device=device),
            finished=torch.zeros(batch, dtype=torch.bool, device=device))

    def step(self, s: DecoderState, memory: torch.Tensor,
             const: Dict[str, Any], generator: Optional[torch.Generator] = None,
             dec_input: Optional[torch.Tensor] = None,
             fused: Optional[Dict[str, Any]] = None):
        """One AR decode step -> (state, mel_frame [B, rM], gate [B, r],
        weights [B, T_enc]). The prenet takes ``dec_input`` (by default the
        previous output); ``fused`` holds each cell's ``fused()`` weights,
        built once per decode in training."""
        cfg = self.cfg
        fused = fused or {}
        prev = s.prev_output if dec_input is None else dec_input
        attn_in = [self.prenet(prev, generator), s.context]
        if cfg.attrnn_extra_decoder_input:
            attn_in.append(s.dec[1])
        attn = self.attention_rnn(torch.cat(attn_in, dim=-1), s.attn,
                                  fused.get("attention_rnn"), generator)
        attn_h = attn[1]
        context, weights, att_state = self.attention_layer(
            attn_h, memory, const, s.attention,
            getattr(self, "exp_smoothing_factor", None))
        dec = self.decoder_rnn(torch.cat([attn_h, context], dim=-1), s.dec,
                               fused.get("decoder_rnn"), generator)
        dec_h = dec[1]
        if cfg.decoder_residual_connection:
            dec_h = dec_h + attn_h[..., :dec_h.shape[-1]]
        dec2, final_h = s.dec2, dec_h
        if cfg.second_decoder_rnn_dim > 0:
            dec2 = self.second_decoder_rnn(dec_h, s.dec2,
                                           fused.get("second_decoder_rnn"),
                                           generator)
            final_h = dec2[1]
            if cfg.second_decoder_residual_connection:
                final_h = final_h + dec_h
        proj_in = torch.cat([final_h, context], dim=-1)
        mel = self.linear_projection(proj_in)
        gate = self.gate_layer(proj_in)
        finished = s.finished
        if not self.training:       # the stop mask of a free-running decode
            finished = finished | (torch.sigmoid(gate).amax(-1)
                                   >= cfg.gate_threshold)
        return (DecoderState(attn, dec, dec2, att_state, context, mel, finished),
                mel, gate, weights)

    def forward(self, memory: torch.Tensor, memory_lengths: torch.Tensor,
                mels: torch.Tensor, generator: Optional[torch.Generator] = None,
                p_teacher_forcing: float = 1.0, teacher_force_till: int = 0,
                init_carry: Optional[TrainCarry] = None,
                pres_prev_state: Optional[torch.Tensor] = None):
        """Teacher-forced decode over the padded target mels [B, T_dec, M]
        -> (outputs, TrainCarry). Step t takes ground-truth group t-1 with
        probability ``p_teacher_forcing`` (one draw per step for the whole
        batch; always before ``teacher_force_till``), else its own previous
        output; step 0 takes the GO group: zeros on a fresh utterance, the
        previous segment's last group on a TBPTT continuation. Lanes whose
        ``pres_prev_state`` is 0 start from fresh state even when
        ``init_carry`` is given."""
        cfg = self.cfg
        B, T_dec, M = mels.shape
        r = cfg.n_frames_per_step
        if T_dec % r:
            raise ValueError(f"T_dec={T_dec} must be a multiple of "
                             f"n_frames_per_step={r}")
        steps = T_dec // r
        const, state = self.prepare(memory, memory_lengths)
        carry = TrainCarry(state, torch.zeros(B, M * r, device=memory.device,
                                              dtype=mels.dtype))
        if init_carry is not None and pres_prev_state is not None:
            keep = pres_prev_state.bool()
            carry = pytree.tree_map(
                lambda c, f: torch.where(
                    keep.view((B,) + (1,) * (c.dim() - 1)), c.to(f.dtype), f),
                init_carry, carry)
        elif init_carry is not None:
            carry = init_carry
        groups = mels.reshape(B, steps, r * M)
        teacher = torch.cat([carry.prev_teacher[:, None].to(mels.dtype),
                             groups[:, :-1]], 1)
        tf = torch.rand(steps, generator=generator,
                        device=memory.device) < p_teacher_forcing
        tf = tf | (torch.arange(steps, device=memory.device)
                   < teacher_force_till)
        fused = {n: getattr(self, n).fused() for n in
                 ("attention_rnn", "decoder_rnn", "second_decoder_rnn")
                 if hasattr(self, n)}
        state, mels_out, gates, weights = carry.state, [], [], []
        for t in range(steps):
            dec_input = torch.where(tf[t], teacher[:, t], state.prev_output)
            state, mel, gate, w = self.step(state, memory, const, generator,
                                            dec_input, fused)
            mels_out.append(mel)
            gates.append(gate)
            weights.append(w)
        weights = torch.stack(weights, 1)
        out = {
            "mel_outputs": torch.stack(mels_out, 1).reshape(B, T_dec, M),
            "gate_outputs": torch.stack(gates, 1).reshape(B, T_dec),
            "alignments": (weights if r == 1
                           else weights.repeat_interleave(r, dim=1)),
        }
        return out, TrainCarry(state, groups[:, -1])

    def prepare(self, memory: torch.Tensor, memory_lengths: torch.Tensor
                ) -> Tuple[Dict[str, Any], DecoderState]:
        """(attention const, initial state) of a decode over ``memory``:
        the attention precompute runs here, once per utterance."""
        B, T_enc, _ = memory.shape
        return (self.attention_layer.precompute(memory, memory_lengths),
                self.init_state(B, T_enc, memory.device))

    def decode_chunk(self, memory: torch.Tensor, const: Dict[str, Any],
                     state: DecoderState, steps: int,
                     generator: Optional[torch.Generator] = None):
        """Free-running decode of ``steps`` steps from ``state`` ->
        (mel_raw [B, S*r, M], gate [B, S*r], weights [B, S, T_enc], state).
        The prenet draws from ``generator`` step by step, so chunks of any
        size draw what one whole decode draws."""
        cfg = self.cfg
        B = memory.shape[0]
        r = cfg.n_frames_per_step
        mels, gates, weights = [], [], []
        for _ in range(steps):
            state, mel, gate, w = self.step(state, memory, const, generator)
            mels.append(mel)
            gates.append(gate)
            weights.append(w)
        return (torch.stack(mels, 1).reshape(B, steps * r, cfg.n_mel_channels),
                torch.stack(gates, 1).reshape(B, steps * r),
                torch.stack(weights, 1), state)

    def inference(self, memory: torch.Tensor, memory_lengths: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  max_decoder_steps: Optional[int] = None,
                  early_exit: bool = False, chunk_size: int = 64,
                  gate_threshold=None, gate_delay=None,
                  chunk_fn: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
        """Free-running decode with gate stopping; mel_lengths are the first
        gate crossing + gate_delay, capped at the decoded length. Without
        ``early_exit`` the decode is one chunk of every step. ``chunk_fn``
        (decode_chunk's signature) runs the chunks; by default decode_chunk."""
        cfg = self.cfg
        B, T_enc, _ = memory.shape
        r = cfg.n_frames_per_step
        thr = cfg.gate_threshold if gate_threshold is None else gate_threshold
        delay = cfg.gate_delay if gate_delay is None else gate_delay
        S_req = -(-(max_decoder_steps or cfg.max_decoder_steps) // r)
        const, s = self.prepare(memory, memory_lengths)
        if early_exit:
            if chunk_size * r < cfg.gate_delay:
                raise ValueError("chunk_size must cover gate_delay (one extra "
                                 "chunk runs after all gates fire)")
            S_max = -(-S_req // chunk_size) * chunk_size
        else:
            S_max, chunk_size = S_req, S_req
        chunk_fn = chunk_fn or self.decode_chunk
        mels, gates, weights = [], [], []
        n_done = 0
        for _ in range(0, S_max, chunk_size):
            mel, gate, w, s = chunk_fn(memory, const, s, chunk_size, generator)
            mels.append(mel)
            gates.append(gate)
            weights.append(w)
            if early_exit:
                # one host sync per chunk; stop one chunk after every row's
                # gate has fired, so gate_delay frames exist past it
                n_done = n_done + 1 if bool(s.finished.all()) else 0
                if n_done == 2:
                    break
        T_max = S_max * r
        left = S_max - len(mels) * chunk_size        # never decoded
        dev = memory.device
        if left:
            mels.append(torch.zeros(B, left * r, cfg.n_mel_channels, device=dev))
            gates.append(torch.full((B, left * r), -1e4, device=dev))
            weights.append(torch.zeros(B, left, T_enc, device=dev))
        gates = torch.cat(gates, 1)
        stop = get_first_over_thresh(torch.sigmoid(gates), thr)
        weights = torch.cat(weights, 1)
        return {
            "mel_outputs": torch.cat(mels, 1),
            "gate_outputs": gates,
            "alignments": (weights if r == 1
                           else weights.repeat_interleave(r, dim=1)),
            "mel_lengths": torch.clamp(stop + delay, max=T_max),
        }


def _eval_form(method):
    """Run ``method`` with the model in eval mode and without autograd (the
    JAX inference methods are deterministic whatever the training state),
    then restore the mode."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        was = self.training
        self.eval()
        try:
            with torch.no_grad():
                return method(self, *args, **kwargs)
        finally:
            self.train(was)
    return run


class Tacotron2(nn.Module):
    def __init__(self, cfg: Tacotron2Config, device: str | torch.device = "cuda"):
        super().__init__()
        if cfg.use_gst or cfg.use_emotionnet or cfg.attention_type != 0:
            raise NotImplementedError(
                "GST, EmotionNet and attention types other than 0 are not "
                "ported yet")
        if cfg.dtype != torch.float32:
            raise NotImplementedError("the port's kernels run in float32")
        self.cfg = cfg
        self.embedding = nn.Embedding(cfg.n_symbols, cfg.symbols_embedding_dim)
        self.speaker_embedding = nn.Embedding(cfg.n_speakers,
                                              cfg.speaker_embedding_dim)
        self.encoder = Encoder(cfg)
        self.sylps_net = SylpsNet(cfg.sylpsnet_layer_dims)
        if cfg.torchmoji_batchnorm:
            self.tm_bn = BatchNorm1d(cfg.torchmoji_dim)
        self.tm_linear = nn.Linear(cfg.torchmoji_dim, cfg.torchmoji_crushed_dim)
        self.decoder = Decoder(cfg, cfg.encoder_lstm_dim + cfg.speaker_embedding_dim
                               + 1 + cfg.torchmoji_crushed_dim)
        if cfg.use_postnet:
            self.postnet = Postnet(cfg)
        self.eval()
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.embedding.weight.device

    def _build_memory(self, text, text_lengths, speaker_id, sylps=None,
                      torchmoji_hidden=None, generator=None, sylps_noise=None):
        cfg = self.cfg
        B, T = text.shape
        # out-of-range ids would index out of the table: clamp like JAX
        embedded = self.embedding(text.clamp(0, cfg.n_symbols - 1))
        enc_spk = (self.encoder.encoder_speaker_embedding(speaker_id)
                   if cfg.encoder_speaker_embed_dim > 0 else None)
        enc_out, pred_sylps = self.encoder(embedded, text_lengths, enc_spk,
                                           generator)
        # without a ground-truth rate, the encoder's own prediction
        syl_zu, syl_mu, syl_logvar = self.sylps_net(
            pred_sylps if sylps is None else sylps, generator, sylps_noise)
        spk = self.speaker_embedding(speaker_id)
        tm = (torch.zeros(B, cfg.torchmoji_dim, device=text.device)
              if torchmoji_hidden is None else torchmoji_hidden)
        if cfg.torchmoji_batchnorm:
            tm = self.tm_bn(tm)
        tm = self.tm_linear(tm)
        memory = torch.cat([
            enc_out, spk[:, None, :].expand(B, T, -1),
            syl_zu[:, None, :].expand(B, T, -1), tm[:, None, :].expand(B, T, -1),
        ], dim=-1)
        if cfg.use_memory_bottleneck:
            memory = self.decoder.memory_bottleneck(memory)
        heads = {"pred_sylps": pred_sylps, "syl_mu": syl_mu,
                 "syl_logvar": syl_logvar}
        return memory.contiguous(), heads

    def _inputs(self, text, text_lengths, speaker_id, torchmoji_hidden, sylps):
        """The request's inputs as tensors on the model's device."""
        dev = self.device
        as_t = lambda x, dt=None: (None if x is None else
                                   torch.as_tensor(x, device=dev, dtype=dt))
        return (as_t(text, torch.long), as_t(text_lengths, torch.long),
                as_t(speaker_id, torch.long), as_t(torchmoji_hidden, torch.float32),
                as_t(sylps, torch.float32))

    def forward(self, text, text_lengths, mels, mel_lengths, speaker_id, sylps,
                torchmoji_hidden=None, generator: Optional[torch.Generator] = None,
                p_teacher_forcing: float = 1.0, teacher_force_till: int = 0,
                drop_frame_rate: float = 0.0,
                global_mean: Optional[torch.Tensor] = None,
                init_carry: Optional[TrainCarry] = None,
                pres_prev_state: Optional[torch.Tensor] = None,
                sylps_noise: Optional[torch.Tensor] = None):
        """Teacher-forced forward over tensors on the model's device ->
        (outputs, TrainCarry) (JAX ``Tacotron2.__call__``). In training,
        drop-frame replaces valid input frames with ``global_mean`` at
        ``drop_frame_rate`` (the loss targets stay as they are); every draw
        comes from ``generator`` (``sylps_noise`` [B] sets SylpsNet's eps).
        Mels past ``mel_lengths`` are zeroed in the outputs."""
        cfg = self.cfg
        memory, heads = self._build_memory(text, text_lengths, speaker_id,
                                           sylps, torchmoji_hidden, generator,
                                           sylps_noise)
        dec_target = mels
        if self.training and global_mean is not None:
            dec_target = dropout_frame(mels, global_mean, mel_lengths,
                                       drop_frame_rate, generator)
        out, carry = self.decoder(memory, text_lengths, dec_target, generator,
                                  p_teacher_forcing, teacher_force_till,
                                  init_carry, pres_prev_state)
        mel = out["mel_outputs"]
        post = self.postnet(mel, generator) if cfg.use_postnet else mel
        mask = get_mask_from_lengths(mel_lengths, mels.shape[1])[:, :, None]
        return {**out, "mel_outputs": mel * mask,
                "mel_outputs_postnet": post * mask, **heads}, carry

    # -- chunked inference for streaming (JAX models/tacotron2.py:815-868) --

    @_eval_form
    def inference_prepare(self, text, text_lengths, speaker_id,
                          torchmoji_hidden=None, sylps=None):
        """Encode once for a chunked decode: (memory, attention const,
        initial DecoderState). The attention precompute runs here, once per
        utterance, as in the whole decode."""
        text, text_lengths, speaker_id, tm, sylps = self._inputs(
            text, text_lengths, speaker_id, torchmoji_hidden, sylps)
        memory, _ = self._build_memory(text, text_lengths, speaker_id, sylps, tm)
        return (memory, *self.decoder.prepare(memory, text_lengths))

    @_eval_form
    def decode_chunk(self, memory, const, state: DecoderState, steps: int,
                     generator: Optional[torch.Generator] = None):
        """``steps`` free-running decode steps from ``state`` ->
        (mel_raw [B, S*r, M], gate [B, S*r], weights [B, S, T_enc], state);
        the prenet draws from ``generator`` as the whole decode does, so the
        chunks of a decode give its mels."""
        return self.decoder.decode_chunk(memory, const, state, steps, generator)

    @_eval_form
    def postnet_refine(self, mel: torch.Tensor) -> torch.Tensor:
        """The postnet over a raw mel window [B, T, M] (halos are the
        caller's: the stack's receptive-field radius is
        2 * postnet_n_convolutions frames)."""
        return self.postnet(mel) if self.cfg.use_postnet else mel

    @_eval_form
    def inference(self, text, text_lengths, speaker_id, torchmoji_hidden=None,
                  sylps=None, generator: Optional[torch.Generator] = None,
                  max_decoder_steps: Optional[int] = None,
                  early_exit: bool = False, chunk_size: int = 64,
                  gate_threshold=None, gate_delay=None,
                  chunk_fn: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
        """Free-running inference. ``generator`` draws the prenet dropout
        (the global RNG when None); a ``sylps`` [B] tensor sets the pace;
        ``chunk_fn`` runs the decode's chunks (Decoder.inference)."""
        text, text_lengths, speaker_id, tm, sylps = self._inputs(
            text, text_lengths, speaker_id, torchmoji_hidden, sylps)
        memory, heads = self._build_memory(text, text_lengths, speaker_id,
                                           sylps, tm)
        out = self.decoder.inference(
            memory, text_lengths, generator, max_decoder_steps, early_exit,
            chunk_size, gate_threshold, gate_delay, chunk_fn)
        out["mel_outputs_postnet"] = self.postnet_refine(out["mel_outputs"])
        return {**out, **heads}

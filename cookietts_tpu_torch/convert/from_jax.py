"""JAX param trees -> this package's state dicts.

Weights carried across from a cookietts_tpu model: the trees are nested
dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray, variables)``),
and the state dicts use the reference CookieTTS torch key names, which is
what this package's modules load. Layout rules (the inverse of
cookietts_tpu/convert/*_torch.py):

- flax Dense kernel [in, out]          -> Linear weight [out, in]
- flax Conv kernel [k, in, out]        -> Conv1d weight [out, in, k]
- flax ConvTranspose [k, in, out]      -> ConvTranspose1d [in, out, k], k flipped
- fused zoneout LSTM kernel [In+H, 4H] -> weight_ih [4H, In], weight_hh [4H, H];
  the forget block's in-graph +1 moves into bias_ih (bias_hh = 0)
- flax OptimizedLSTMCell i*/h* gates   -> nn.LSTM *_l0 / *_l0_reverse
- flax BatchNorm scale/bias + stats    -> BatchNorm1d weight/bias/running_*
- flax WeightNorm (v, scale)           -> the folded weight v * scale / ||v||
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_GATES = ("i", "f", "g", "o")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _lin(sd, key, p):
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _conv(sd, key, p):
    sd[f"{key}.weight"] = _t(np.transpose(p["kernel"], (2, 1, 0)))
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _bn(sd, key, p, stats):
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])
    sd[f"{key}.running_mean"] = _t(stats["mean"])
    sd[f"{key}.running_var"] = _t(stats["var"])


def _zoneout_cell(sd, key, p):
    kernel, bias = np.asarray(p["kernel"]), np.array(p["bias"], np.float32)
    H = kernel.shape[1] // 4
    n_in = kernel.shape[0] - H
    bias[H:2 * H] += 1.0
    sd[f"{key}.weight_ih"] = _t(kernel[:n_in].T)
    sd[f"{key}.weight_hh"] = _t(kernel[n_in:].T)
    sd[f"{key}.bias_ih"] = _t(bias)
    sd[f"{key}.bias_hh"] = torch.zeros(4 * H)


def _bilstm_direction(sd, key, suffix, p):
    sd[f"{key}.weight_ih_l0{suffix}"] = _t(np.concatenate(
        [np.asarray(p[f"i{g}"]["kernel"]).T for g in _GATES]))
    sd[f"{key}.weight_hh_l0{suffix}"] = _t(np.concatenate(
        [np.asarray(p[f"h{g}"]["kernel"]).T for g in _GATES]))
    bias = np.concatenate([np.asarray(p[f"h{g}"]["bias"]) for g in _GATES])
    sd[f"{key}.bias_ih_l0{suffix}"] = _t(bias)
    sd[f"{key}.bias_hh_l0{suffix}"] = torch.zeros(bias.shape[0])


def tacotron2_state_dict_from_jax(params: Mapping[str, Any],
                                  batch_stats: Mapping[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """State dict for models/tacotron2.py:Tacotron2 (attention type 0)."""
    sd: Dict[str, torch.Tensor] = {}
    sd["embedding.weight"] = _t(params["embedding"]["embedding"])
    sd["speaker_embedding.weight"] = _t(params["speaker_embedding"]["embedding"])
    if "encoder_speaker_embedding" in params:
        sd["encoder.encoder_speaker_embedding.weight"] = _t(
            params["encoder_speaker_embedding"]["embedding"])

    enc, enc_stats = params["encoder"], batch_stats["encoder"]
    i = 0
    while f"conv{i}" in enc:
        _conv(sd, f"encoder.convolutions.{i}.0.conv", enc[f"conv{i}"])
        _bn(sd, f"encoder.convolutions.{i}.1", enc[f"bn{i}"], enc_stats[f"bn{i}"])
        i += 1
    _bilstm_direction(sd, "encoder.lstm", "", enc["OptimizedLSTMCell_0"])
    _bilstm_direction(sd, "encoder.lstm", "_reverse", enc["OptimizedLSTMCell_1"])
    _lin(sd, "encoder.sylps_layer.linear_layer", enc["sylps_layer"])

    syl = params["sylps_net"]
    sd["sylps_net.res_weight"] = _t(syl["res_weight"])
    i = 0
    while f"Dense_{i}" in syl:   # seq_layers interleaves activations
        _lin(sd, f"sylps_net.seq_layers.{2 * i}.linear_layer", syl[f"Dense_{i}"])
        i += 1

    _lin(sd, "tm_linear", params["tm_linear"])
    if "tm_bn" in params:
        _bn(sd, "tm_bn", params["tm_bn"], batch_stats["tm_bn"])
    if "memory_bottleneck" in params:
        _lin(sd, "decoder.memory_bottleneck.bottleneck.linear_layer",
             params["memory_bottleneck"])

    cell = params["decoder"]["cell"]
    i = 0
    while f"fc{i}" in cell["prenet"]:
        _lin(sd, f"decoder.prenet.layers.{i}.linear_layer", cell["prenet"][f"fc{i}"])
        i += 1
    for name in ("attention_rnn", "decoder_rnn", "second_decoder_rnn"):
        if name in cell:
            _zoneout_cell(sd, f"decoder.{name}", cell[name]["gates"])
    att, key = cell["attention"], "decoder.attention_layer"
    for name in ("query_layer", "memory_layer", "v"):
        _lin(sd, f"{key}.{name}.linear_layer", att[name])
    _conv(sd, f"{key}.location_layer.location_conv.conv", att["location_conv"])
    _lin(sd, f"{key}.location_layer.location_dense.linear_layer",
         att["location_dense"])
    if "window_offset" in att:
        sd[f"{key}.windowed_att_pos_offset"] = _t(att["window_offset"])
    if "exp_smoothing_factor" in att:
        sd["decoder.exp_smoothing_factor"] = _t(att["exp_smoothing_factor"])
    if "inv_temperature" in att:
        sd[f"{key}.softmax_temp"] = _t(att["inv_temperature"])
    _lin(sd, "decoder.linear_projection.linear_layer", cell["linear_projection"])
    _lin(sd, "decoder.gate_layer.linear_layer", cell["gate_layer"])

    if "postnet" in params:
        post, post_stats = params["postnet"], batch_stats["postnet"]
        i = 0
        while f"conv{i}" in post:
            _conv(sd, f"postnet.convolutions.{i}.0.conv", post[f"conv{i}"])
            if f"bn{i}" in post:
                _bn(sd, f"postnet.convolutions.{i}.1", post[f"bn{i}"],
                    post_stats[f"bn{i}"])
            i += 1
    return sd


def _fold_wn(tree, wrapper: str, conv: str) -> np.ndarray:
    """Folded flax WeightNorm kernel: v * scale / ||v|| over all axes but
    the last (models/hifigan.py:_fold_wn_conv)."""
    v = np.asarray(tree[conv]["kernel"], np.float32)
    scale = np.asarray(tree[wrapper][f"{conv}/kernel/scale"], np.float32)
    norm = np.sqrt(np.sum(np.square(v), axis=tuple(range(v.ndim - 1)),
                          keepdims=True))
    return v * (scale / norm)


def hifigan_state_dict_from_jax(params: Mapping[str, Any]
                                ) -> Dict[str, torch.Tensor]:
    """State dict for models/hifigan.py:Generator, weight norm folded."""
    sd: Dict[str, torch.Tensor] = {}

    def conv(key, tree, wrapper, name):
        sd[f"{key}.weight"] = _t(np.transpose(_fold_wn(tree, wrapper, name),
                                              (2, 1, 0)))
        sd[f"{key}.bias"] = _t(tree[name]["bias"])

    conv("conv_pre", params, "conv_pre", "Conv_0")
    n_ups = 0
    while f"up{n_ups}" in params:
        w = _fold_wn(params, f"up{n_ups}", f"ConvTranspose_{n_ups}")
        sd[f"ups.{n_ups}.weight"] = _t(np.transpose(w[::-1], (1, 2, 0)))
        sd[f"ups.{n_ups}.bias"] = _t(params[f"ConvTranspose_{n_ups}"]["bias"])
        n_ups += 1
    conv("conv_post", params, "conv_post", "Conv_1")
    n_kernels = sum(1 for k in params if k.startswith("resblock0_"))
    for i in range(n_ups):
        for j in range(n_kernels):
            rb, n = params[f"resblock{i}_{j}"], i * n_kernels + j
            m = 0
            while f"conv1_{m}" in rb:
                conv(f"resblocks.{n}.convs1.{m}", rb, f"conv1_{m}", f"Conv_{2 * m}")
                conv(f"resblocks.{n}.convs2.{m}", rb, f"conv2_{m}",
                     f"Conv_{2 * m + 1}")
                m += 1
    return sd

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
  (serving), or the pair itself as ``weight_v`` / ``weight_g`` with g [out]
  on the output axis (the HiFi-GAN training form and discriminators)
- flax Conv2d kernel [kh, kw, in, out] -> Conv2d weight [out, in, kh, kw]
- the GAN postnet and its discriminator, the HiFi-GAN denoiser (its
  generator, DW and DS), UnTTS and GAN-TTS keep JAX's module names
- flax MultiHeadDotProductAttention query/key/value [D, heads, head_dim]
  -> Linear [heads * head_dim, D]; out [heads, head_dim, D] -> Linear
  [D, heads * head_dim]; LayerNorm scale -> weight
- flax GRUCell ir/iz/in/hr/hz/hn       -> nn.GRU *_l0 (r, z, n stacked); flax
  has no hidden-side r/z bias, so those are zero and the input-side ones
  carry it, while n keeps its two (r multiplies W_hn h + b_hn)
- torchMoji's hard-sigmoid LSTM ih/hh  -> *_l0 / *_l0_reverse, one bias in
  bias_ih (bias_hh = 0)
- WaveGlow/WaveFlow: 1x1 layers (flax Dense or Conv) -> Conv1d/Conv2d weights
  with unit taps; the WN end layer's output halves swap from (log_s, t) to
  the reference checkpoints' (t, log_s); the 1x1 mixing weight transposes
  (y = x @ w -> conv weight w.T)
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

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


def _gru(sd, key, p):
    sd[f"{key}.weight_ih_l0"] = _t(np.concatenate(
        [np.asarray(p[g]["kernel"]).T for g in ("ir", "iz", "in")]))
    sd[f"{key}.weight_hh_l0"] = _t(np.concatenate(
        [np.asarray(p[g]["kernel"]).T for g in ("hr", "hz", "hn")]))
    sd[f"{key}.bias_ih_l0"] = _t(np.concatenate(
        [np.asarray(p[g]["bias"]) for g in ("ir", "iz", "in")]))
    E = np.asarray(p["hn"]["bias"]).shape[0]
    sd[f"{key}.bias_hh_l0"] = _t(np.concatenate(
        [np.zeros(2 * E, np.float32), np.asarray(p["hn"]["bias"])]))


def _ref_encoder(sd, key, p, stats):
    i = 0
    while f"conv{i}" in p:
        sd[f"{key}.convs.{i}.weight"] = _t(np.transpose(p[f"conv{i}"]["kernel"],
                                                        (3, 2, 0, 1)))
        _bn(sd, f"{key}.convs.{i}.batch_norm", p[f"bn{i}"], stats[f"bn{i}"])
        i += 1
    _gru(sd, f"{key}.gru", p["GRUCell_0"])
    _lin(sd, f"{key}.fc.0", p["fc"])


def gst_state_dict_from_jax(params: Mapping[str, Any],
                            batch_stats: Mapping[str, Any], prefix: str = ""
                            ) -> Dict[str, torch.Tensor]:
    """State dict for models/gst.py:GST (keys under ``prefix``)."""
    sd: Dict[str, torch.Tensor] = {}
    _ref_encoder(sd, f"{prefix}ref_encoder", params["ref_encoder"],
                 batch_stats["ref_encoder"])
    att = params["att"]
    for name in ("conv_Q", "conv_K"):                 # 1x1 Conv1d [U, E, 1]
        sd[f"{prefix}att.{name}.weight"] = _t(
            np.asarray(att[name]["kernel"]).T[:, :, None])
        sd[f"{prefix}att.{name}.bias"] = _t(att[name]["bias"])
    for name in ("fc_Q", "fc_K", "fc_V", "fc_A"):
        _lin(sd, f"{prefix}att.{name}.0", att[name])
    sd[f"{prefix}token_embedding"] = _t(params["token_embedding"])
    _lin(sd, f"{prefix}map_lin.linear_layer", params["map_lin"])
    if "ss_vae_layers" in params:
        _lin(sd, f"{prefix}ss_vae_layers.0", params["ss_vae_layers"])
    return sd


def emotionnet_state_dict_from_jax(params: Mapping[str, Any],
                                   batch_stats: Mapping[str, Any],
                                   prefix: str = "") -> Dict[str, torch.Tensor]:
    """State dict for models/emotionnet.py:EmotionNet."""
    sd: Dict[str, torch.Tensor] = {}
    _ref_encoder(sd, f"{prefix}ref_enc", params["ref_enc"], batch_stats["ref_enc"])
    _gru(sd, f"{prefix}text_rnn", params["GRUCell_0"])
    _lin(sd, f"{prefix}classifier_layer.linear_layer", params["classifier"])
    _lin(sd, f"{prefix}latent_layer.linear_layer", params["latent"])
    return sd


def auxemotionnet_state_dict_from_jax(params: Mapping[str, Any],
                                      prefix: str = ""
                                      ) -> Dict[str, torch.Tensor]:
    """State dict for models/emotionnet.py:AuxEmotionNet (the seq MLP's
    Linears sit at the even Sequential indices)."""
    sd: Dict[str, torch.Tensor] = {}
    i = 0
    while f"seq{i}" in params:
        _lin(sd, f"{prefix}seq_layers.{2 * i}.linear_layer", params[f"seq{i}"])
        i += 1
    _gru(sd, f"{prefix}text_rnn", params["GRUCell_0"])
    _lin(sd, f"{prefix}latent_classifier_layer.linear_layer",
         params["latent_classifier"])
    return sd


def torchmoji_state_dict_from_jax(params: Mapping[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """State dict for models/torchmoji.py:TorchMoji, in the published
    pytorch_model.bin's names."""
    sd = {"embed.weight": _t(params["embed"]["embedding"]),
          "attention_layer.attention_vector": _t(params["attention_vector"])}
    for i in (0, 1):
        for direction, sfx in (("fwd", ""), ("bwd", "_reverse")):
            p, key = params[f"lstm_{i}_{direction}"], f"lstm_{i}"
            sd[f"{key}.weight_ih_l0{sfx}"] = _t(np.asarray(p["ih"]["kernel"]).T)
            sd[f"{key}.weight_hh_l0{sfx}"] = _t(np.asarray(p["hh"]["kernel"]).T)
            sd[f"{key}.bias_ih_l0{sfx}"] = _t(p["ih"]["bias"])
            sd[f"{key}.bias_hh_l0{sfx}"] = torch.zeros(
                np.asarray(p["ih"]["bias"]).shape[0])
    return sd


def tacotron2_state_dict_from_jax(params: Mapping[str, Any],
                                  batch_stats: Mapping[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """State dict for models/tacotron2.py:Tacotron2 of every attention type
    (by the attention params' names), the GST and EmotionNet heads included
    where the params hold them."""
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
    if "gst" in params:
        sd.update(gst_state_dict_from_jax(params["gst"], batch_stats["gst"],
                                          "gst."))
    if "emotion_net" in params:
        sd.update(emotionnet_state_dict_from_jax(
            params["emotion_net"], batch_stats["emotion_net"], "emotion_net."))
        sd.update(auxemotionnet_state_dict_from_jax(params["aux_emotion_net"],
                                                    "aux_emotion_net."))

    cell = params["decoder"]["cell"]
    i = 0
    while f"fc{i}" in cell["prenet"]:
        _lin(sd, f"decoder.prenet.layers.{i}.linear_layer", cell["prenet"][f"fc{i}"])
        i += 1
    for name in ("attention_rnn", "decoder_rnn", "second_decoder_rnn"):
        if name in cell:
            _zoneout_cell(sd, f"decoder.{name}", cell[name]["gates"])
    att, key = cell["attention"], "decoder.attention_layer"
    if "lin" in att:                     # GMM: the reference's F Sequential
        _lin(sd, f"{key}.F.0.linear_layer", att["F"])
        _lin(sd, f"{key}.F.2", att["lin"])
    elif "dynamic_fc" in att:            # DCA: JAX's module names
        for name in ("dynamic_fc", "W_static", "W_dynamic", "v"):
            _lin(sd, f"{key}.{name}", att[name])
        _conv(sd, f"{key}.static_conv", att["static_conv"])
    else:
        for name in ("query_layer", "memory_layer", "v"):
            _lin(sd, f"{key}.{name}.linear_layer", att[name])
        _conv(sd, f"{key}.location_layer.location_conv.conv",
              att["location_conv"])
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


def _wn_pair(sd, key, tree, wrapper: str, conv: str, transposed=False):
    """A flax WeightNorm conv as the port's WNConv: weight_v in torch's
    layout, weight_g the scale on the output axis, the bias."""
    v = np.asarray(tree[conv]["kernel"], np.float32)
    scale = np.asarray(tree[wrapper][f"{conv}/kernel/scale"], np.float32)
    if transposed:                   # [k, in, out] -> [in, out, k], k flipped
        w, g_shape = np.transpose(v[::-1], (1, 2, 0)), (1, -1, 1)
    else:                            # [*taps, in, out] -> [out, in, *taps]
        w = np.moveaxis(v, (-1, -2), (0, 1))
        g_shape = (-1,) + (1,) * (v.ndim - 1)
    sd[f"{key}.weight_v"] = _t(w)
    sd[f"{key}.weight_g"] = _t(scale.reshape(g_shape))
    sd[f"{key}.bias"] = _t(tree[conv]["bias"])


def hifigan_train_state_dict_from_jax(params: Mapping[str, Any]
                                      ) -> Dict[str, torch.Tensor]:
    """State dict for the training form, ``Generator(cfg,
    weight_norm=True)``: every conv's (v, scale) pair as weight_v /
    weight_g. Linear in each leaf, so it maps JAX gradients too."""
    sd: Dict[str, torch.Tensor] = {}
    _wn_pair(sd, "conv_pre", params, "conv_pre", "Conv_0")
    n_ups = 0
    while f"up{n_ups}" in params:
        _wn_pair(sd, f"ups.{n_ups}", params, f"up{n_ups}",
                 f"ConvTranspose_{n_ups}", transposed=True)
        n_ups += 1
    _wn_pair(sd, "conv_post", params, "conv_post", "Conv_1")
    n_kernels = sum(1 for k in params if k.startswith("resblock0_"))
    for i in range(n_ups):
        for j in range(n_kernels):
            rb, n = params[f"resblock{i}_{j}"], i * n_kernels + j
            m = 0
            while f"conv1_{m}" in rb:
                _wn_pair(sd, f"resblocks.{n}.convs1.{m}", rb, f"conv1_{m}",
                         f"Conv_{2 * m}")
                _wn_pair(sd, f"resblocks.{n}.convs2.{m}", rb, f"conv2_{m}",
                         f"Conv_{2 * m + 1}")
                m += 1
    return sd


def hifigan_discriminators_from_jax(mpd: Mapping[str, Any],
                                    msd: Mapping[str, Any], periods
                                    ) -> Tuple[Dict[str, torch.Tensor],
                                               Dict[str, torch.Tensor]]:
    """(MPD, MSD) state dicts from the JAX discriminators' param trees, in
    the reference names (the inverse of cookietts_tpu/convert/
    hifigan_torch.py:convert_hifigan_discriminators): the weight-normed
    convs as weight_v / weight_g, the MSD's spectral-normed first scale as
    weight_orig. Linear in each leaf, so it maps JAX gradients too."""
    mpd_sd: Dict[str, torch.Tensor] = {}
    for i, p in enumerate(periods):
        tree, key = mpd[f"period{p}"], f"discriminators.{i}"
        for j in range(5):
            _wn_pair(mpd_sd, f"{key}.convs.{j}", tree, f"conv{j}", f"Conv_{j}")
        _wn_pair(mpd_sd, f"{key}.conv_post", tree, "conv_post", "Conv_5")
    msd_sd: Dict[str, torch.Tensor] = {}
    i = 0
    while f"scale{i}" in msd:
        tree, key = msd[f"scale{i}"], f"discriminators.{i}"
        names = [(f"convs.{j}", f"conv{j}", f"Conv_{j}") for j in range(7)]
        names.append(("conv_post", "conv_post", "Conv_7"))
        for dst, wrapper, conv in names:
            if i == 0:
                msd_sd[f"{key}.{dst}.weight_orig"] = _t(np.transpose(
                    tree[wrapper]["kernel"], (2, 1, 0)))
                msd_sd[f"{key}.{dst}.bias"] = _t(tree[wrapper]["bias"])
            else:
                _wn_pair(msd_sd, f"{key}.{dst}", tree, wrapper, conv)
        i += 1
    return mpd_sd, msd_sd


def _nd_conv(kernel, ndim: int) -> torch.Tensor:
    """flax Dense [in, out] or Conv [*taps, in, out] kernel -> torch conv
    weight [out, in, *taps] with ``ndim`` dims (unit taps appended)."""
    k = np.moveaxis(np.asarray(kernel, np.float32), (-1, -2), (0, 1))
    return _t(k.reshape(*k.shape, *[1] * (ndim - k.ndim)))


def _flow_wn(sd, key, wn, nd: int = 3):
    """One flax WN (models/waveglow.py: WN or WN2D) -> the port's WN keys
    under ``key``: 1x1 Dense / Conv layers as conv weights of ``nd`` dims,
    the end layer's output halves swapped from JAX's (log_s, t) to the
    reference checkpoints' (t, log_s)."""
    n_layers = sum(1 for name in wn if name.startswith("in_layer"))
    for name, tree, dims in (
            [("start", wn["start"], nd), ("cond_layer", wn["cond_layer"], 3)]
            + [(f"in_layers.{i}", wn[f"in_layer{i}"], nd)
               for i in range(n_layers)]
            + [(f"res_skip_layers.{i}", wn[f"res_skip{i}"], nd)
               for i in range(n_layers)]):
        sd[f"{key}.{name}.weight"] = _nd_conv(tree["kernel"], dims)
        sd[f"{key}.{name}.bias"] = _t(tree["bias"])
    end_w, end_b = _nd_conv(wn["end"]["kernel"], nd), _t(wn["end"]["bias"])
    half = end_b.shape[0] // 2
    sd[f"{key}.end.weight"] = torch.cat([end_w[half:], end_w[:half]])
    sd[f"{key}.end.bias"] = torch.cat([end_b[half:], end_b[:half]])


def _convinv(sd, key, p):
    """The 1x1 mixing weight: y = x @ w -> conv weight w.T."""
    sd[f"{key}.conv.weight"] = _t(np.asarray(p["weight"]).T[:, :, None])


def waveglow_from_jax(params: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """State dict for models/waveglow.py:WaveGlow from a cookietts_tpu
    WaveGlow param tree, for both ``channel_mixing`` modes. ``cfg`` is the
    WaveGlowConfig of either package. The keys are the reference glow.py
    names (see the model's docstring); for ``upsample_mode='single'`` with
    ``couple_transform='second'`` the result is what
    cookietts_tpu/convert/waveglow_torch.py reads."""
    sd: Dict[str, torch.Tensor] = {}
    nd = 4 if cfg.channel_mixing == "permuteheight" else 3
    for k in range(cfg.n_flows):
        _flow_wn(sd, f"WN.{k}", params[f"wn{k}"], nd)
        if f"convinv{k}" in params:
            _convinv(sd, f"convinv.{k}", params[f"convinv{k}"])

    def up(key, tree):
        sd[f"{key}.weight"] = _t(np.transpose(
            np.asarray(tree["kernel"])[::-1], (1, 2, 0)))
        sd[f"{key}.bias"] = _t(tree["bias"])

    if "upsample_single" in params:
        up("upsample", params["upsample_single"])
    else:
        for i in range(len(params["upsample"])):
            up(f"upsample.{i}", params["upsample"][f"up{i}"])
    if "speaker_embed" in params:
        sd["speaker_embed.weight"] = _t(params["speaker_embed"]["embedding"])
    return sd


def gan_postnet_state_dict_from_jax(params: Mapping[str, Any],
                                    batch_stats: Mapping[str, Any]
                                    ) -> Dict[str, torch.Tensor]:
    """State dict for models/gan_postnet.py:GANPostnet or GANDiscriminator
    (JAX's names: ``post_conv{i}`` / ``post_bn{i}``, ``dis_conv{i}`` /
    ``dis_bn{i}``), the BatchNorm statistics included."""
    sd: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        if "conv" in name:
            _conv(sd, name, p)
        else:
            _bn(sd, name, p, batch_stats[name])
    return sd


def _conv2d(sd, key, p):
    sd[f"{key}.weight"] = _t(np.transpose(p["kernel"], (3, 2, 0, 1)))
    sd[f"{key}.bias"] = _t(p["bias"])


def _wn_named(sd, key, tree, wrapper: str):
    """A flax WeightNorm conv whose conv is the wrapper's one scale key's
    module (``Conv_j`` beside the wrapper)."""
    (scale_key,) = tree[wrapper]
    _wn_pair(sd, key, tree, wrapper, scale_key.split("/")[0])


def hifigan_denoiser_from_jax(gen: Mapping[str, Any],
                              dw: Mapping[str, Any] = None,
                              ds: Mapping[str, Any] = None):
    """(generator, DW, DS) state dicts for models/hifigan_denoiser.py from
    the JAX DenoiserWN, WaveDiscriminator and SpectDiscriminator param trees
    (DW and DS None when not given): the weight-normed convs as weight_v /
    weight_g pairs, the 2-D convs [kh, kw, in, out] -> [out, in, kh, kw].
    Linear in each leaf, so it maps JAX gradients too."""
    g: Dict[str, torch.Tensor] = {}
    wn = gen["wn"]
    _wn_named(g, "wn.start", wn, "start")
    i = 0
    while f"in_layer{i}" in wn:
        _wn_named(g, f"wn.in_layer{i}", wn, f"in_layer{i}")
        _wn_named(g, f"wn.res_skip{i}", wn, f"res_skip{i}")
        i += 1
    _wn_named(g, "wn.end", wn, "end")
    _conv(g, "wn_end", gen["wn_end"])
    post = gen["postnet"]
    g["postnet.res_weights"] = _t(post["res_weights"])
    i = 0
    while f"conv{i}" in post:
        _conv(g, f"postnet.conv{i}", post[f"conv{i}"])
        i += 1
    _conv(g, "postnet_end", gen["postnet_end"])

    w = None
    if dw is not None:
        w = {}
        for name, tree in dw.items():
            w[f"{name}.res_weights"] = _t(tree["res_weights"])
            w[f"{name}.layr_weights"] = _t(tree["layr_weights"])
            j = 0
            while f"conv{j}" in tree:
                _wn_named(w, f"{name}.conv{j}", tree, f"conv{j}")
                j += 1
    s = None
    if ds is not None:
        s = {}
        for name, tree in ds.items():
            if name == "end_conv":
                _conv2d(s, name, tree)
                continue
            _conv2d(s, f"{name}.conv", tree["conv"])
            _conv2d(s, f"{name}.glu", tree["glu"])
            s[f"{name}.bn_scale"] = _t(tree["bn_scale"])
            s[f"{name}.bn_bias"] = _t(tree["bn_bias"])
    return g, w, s


# -- UnTTS and GAN-TTS ------------------------------------------------------------

def _mha(sd, key, p):
    """flax MultiHeadDotProductAttention: query/key/value DenseGeneral
    kernels [D, heads, head_dim] -> Linear [heads * head_dim, D]; out
    [heads, head_dim, D] -> Linear [D, heads * head_dim]."""
    for name in ("query", "key", "value"):
        k = np.asarray(p[name]["kernel"])
        sd[f"{key}.{name}.weight"] = _t(k.reshape(k.shape[0], -1).T)
        sd[f"{key}.{name}.bias"] = _t(np.asarray(p[name]["bias"]).reshape(-1))
    k = np.asarray(p["out"]["kernel"])
    sd[f"{key}.out.weight"] = _t(k.reshape(-1, k.shape[-1]).T)
    sd[f"{key}.out.bias"] = _t(p["out"]["bias"])


def _ln(sd, key, p):
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])


def _fft_block(sd, key, p):
    _mha(sd, f"{key}.mha", p["mha"])
    _ln(sd, f"{key}.ln1", p["ln1"])
    _ln(sd, f"{key}.ln2", p["ln2"])
    _conv(sd, f"{key}.ffn1", p["ffn1"])
    _conv(sd, f"{key}.ffn2", p["ffn2"])


def _text_encoder(sd, params):
    """Embeddings, pos_scale and the FFT blocks ``enc{i}`` (UnTTS's and the
    GAN-TTS generator's)."""
    sd["embedding.weight"] = _t(params["embedding"]["embedding"])
    sd["speaker_embedding.weight"] = _t(params["speaker_embedding"]["embedding"])
    sd["pos_scale"] = _t(params["pos_scale"])
    i = 0
    while f"enc{i}" in params:
        _fft_block(sd, f"enc{i}", params[f"enc{i}"])
        i += 1


def _flows(sd, key, p):
    """A MelFlowDecoder's or VarGlow's ``convinv{k}`` / ``wn{k}``."""
    k = 0
    while f"wn{k}" in p:
        _flow_wn(sd, f"{key}.wn.{k}", p[f"wn{k}"])
        _convinv(sd, f"{key}.convinv.{k}", p[f"convinv{k}"])
        k += 1


def untts_params_from_jax(params: Mapping[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """State dict for models/untts.py:UnTTS from a cookietts_tpu UnTTS
    param tree (every option: the predictors, VarGlow, positional
    attention). Linear in each leaf, so it maps JAX gradients too."""
    sd: Dict[str, torch.Tensor] = {}
    _text_encoder(sd, params)
    for name in ("duration_predictor", "f0_predictor", "energy_predictor"):
        if name not in params:
            continue
        p, i = params[name], 0
        while f"conv{i}" in p:
            _conv(sd, f"{name}.conv{i}", p[f"conv{i}"])
            _ln(sd, f"{name}.ln{i}", p[f"ln{i}"])
            i += 1
        _lin(sd, f"{name}.fc", p["fc"])
    for name in ("cond_proj", "prosody_proj"):
        if name in params:
            _lin(sd, name, params[name])
    if "pos_attention" in params:
        p = params["pos_attention"]
        _mha(sd, "pos_attention.mha", p["mha"])
        _ln(sd, "pos_attention.ln", p["ln"])
        _lin(sd, "pos_attention.proj", p["proj"])
    for name in ("decoder", "varglow"):
        if name in params:
            _flows(sd, name, params[name])
    return sd


def _gantts_generator(gen):
    g: Dict[str, torch.Tensor] = {}
    _text_encoder(g, gen)
    i = 0
    while f"gblock{i}" in gen:
        p, key = gen[f"gblock{i}"], f"gblock{i}"
        _lin(g, f"{key}.res_proj", p["res_proj"])
        j = 0
        while f"conv{j}" in p:
            _conv(g, f"{key}.conv{j}", p[f"conv{j}"])
            _lin(g, f"{key}.cbn{j}.scale", p[f"cbn{j}"]["scale"])
            _lin(g, f"{key}.cbn{j}.shift", p[f"cbn{j}"]["shift"])
            j += 1
        i += 1
    _lin(g, "mel_proj", gen["mel_proj"])
    return g


def gantts_params_from_jax(gen: Optional[Mapping[str, Any]],
                           disc: Optional[Mapping[str, Any]] = None
                           ) -> Tuple[Optional[Dict[str, torch.Tensor]],
                                      Optional[Dict[str, torch.Tensor]]]:
    """(generator, discriminator) state dicts for models/gantts.py from
    the JAX GANTTSGenerator and GANTTSDiscriminator param trees (either None
    when its tree is not given). Linear in each leaf."""
    g: Optional[Dict[str, torch.Tensor]] = None
    if gen is not None:
        g = _gantts_generator(gen)
    d = None
    if disc is not None:
        d = {}
        for name, p in disc.items():
            if name.endswith("_out"):
                _lin(d, name, p)
                continue
            _lin(d, f"{name}.res_proj", p["res_proj"])
            j = 0
            while f"conv{j}" in p:
                _conv(d, f"{name}.conv{j}", p[f"conv{j}"])
                j += 1
    return g, d

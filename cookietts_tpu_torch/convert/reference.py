"""Reference (CookieTTS torch) checkpoints -> this package's checkpoints,
the ``convert`` command (cookietts_tpu/cli.py:cmd_convert).

    python -m cookietts_tpu_torch convert --model tacotron2 \
        --torch_ckpt checkpoint_100000 -o taco.pt

The input is a ``.pt``/``.pth`` file (a state dict, a dict holding one under
``state_dict`` or ``model``, or a whole module; it is unpickled, so convert
only files you trust) or an ``.npz`` of the state dict. The port's modules
use the reference key names, so most of the work is checking the layout,
folding what the port holds folded and working out the configuration hints
that JAX's converters read off the tensor shapes
(cookietts_tpu/convert/{tacotron2,waveglow,hifigan,gst}_torch.py):

- ``tacotron2``: the state dict as it is (the GST and EmotionNet heads'
  keys included); only location-sensitive attention (type 0) is taken, as
  JAX's converter takes only that. No hints: as with JAX, the model's
  configuration comes from ``--hparams`` where it differs from the defaults.
- ``waveglow``: weight-norm pairs folded, the reference fork's chain of
  1x1 ``cond_layers`` composed into one ``cond_layer``; the hints of the
  reference-compatible layout (single upsampler, coupling "second"), without
  ``cond_in_channels``. ``hop_length`` is not in the weights.
- ``hifigan``: weight-norm pairs folded as ``Generator``'s load folds them;
  hints for the widths and the upsampling kernels.
- ``torchmoji``: the published ``pytorch_model.bin`` as it is;
  ``nb_tokens``.
- ``gst``, ``emotionnet``, ``auxemotionnet``: the module's own keys (a
  ``gst.`` / ``emotion_net.`` / ``aux_emotion_net.`` prefix taken off, as a
  whole tacotron2_ssvae checkpoint stores them); the widths JAX's command
  writes.

The output is a port checkpoint (``runtime/checkpoint.py:save_checkpoint``:
``{"step": 0, "state_dict": ...}``) with the sidecar ``{"model": name,
"model_config": hints}`` that ``tts``, ``server`` and ``--warm_start`` read.
Floating tensors are stored as float32; integer buffers keep their type.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.hifigan import _fold_weight_norm
from ..runtime.checkpoint import save_checkpoint

StateDict = Dict[str, torch.Tensor]


def load_reference_state_dict(path: str) -> StateDict:
    """The state dict in ``path`` as tensors on the CPU (see the module
    docstring for what the file may hold)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(np.array(z[k])) for k in z.files}
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict", "model"):
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
            break
    if hasattr(ckpt, "state_dict"):          # a whole nn.Module
        ckpt = ckpt.state_dict()
    return {k: torch.as_tensor(v).detach().cpu() for k, v in ckpt.items()}


def _strip(sd: StateDict, prefix: str) -> StateDict:
    """Keys without ``prefix`` where any key has it (only those kept)."""
    if any(k.startswith(prefix) for k in sd):
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return sd


def _f32(sd: StateDict) -> StateDict:
    return {k: v.float() if v.is_floating_point() else v for k, v in sd.items()}


def _fold(sd: StateDict) -> StateDict:
    sd = dict(sd)
    _fold_weight_norm(sd, "")
    return sd


def _indices(sd: StateDict, pattern: str):
    return sorted({int(m.group(1)) for k in sd for m in [re.match(pattern, k)] if m})


def _conv_filters(sd: StateDict, prefix: str):
    """The output widths of ``prefix.convs.{i}`` but the last (the last is
    the embedding width)."""
    n = len(_indices(sd, rf"{re.escape(prefix)}\.convs\.(\d+)\.weight$"))
    return [int(sd[f"{prefix}.convs.{i}.weight"].shape[0]) for i in range(n - 1)]


def convert_tacotron2(sd: StateDict) -> Tuple[StateDict, Optional[Dict]]:
    att = "decoder.attention_layer"
    if f"{att}.query_layer.linear_layer.weight" not in sd:
        kind = ("GMM (attention_type 1)" if f"{att}.F.0.linear_layer.weight" in sd
                else "not location-sensitive")
        raise SystemExit(
            f"this Tacotron2 checkpoint's attention is {kind}: the converter "
            "takes location-sensitive attention (attention_type 0) only, as "
            "cookietts_tpu's does")
    return sd, None


def convert_waveglow(sd: StateDict) -> Tuple[StateDict, Dict[str, Any]]:
    sd = _fold(sd)
    n_flows = 1 + max(_indices(sd, r"WN\.(\d+)\."))
    for k in range(n_flows):
        p = f"WN.{k}"
        chain = _indices(sd, rf"{p}\.cond_layers\.(\d+)\.weight$")
        if chain and f"{p}.cond_layer.weight" not in sd:
            # no nonlinearity between the fork's 1x1 cond convs: one conv
            w = sd.pop(f"{p}.cond_layers.{chain[0]}.weight")[:, :, 0].double()
            b = sd.pop(f"{p}.cond_layers.{chain[0]}.bias").double()
            for i in chain[1:]:
                wn = sd.pop(f"{p}.cond_layers.{i}.weight")[:, :, 0].double()
                b = wn @ b + sd.pop(f"{p}.cond_layers.{i}.bias").double()
                w = wn @ w
            sd[f"{p}.cond_layer.weight"] = w.float()[:, :, None]
            sd[f"{p}.cond_layer.bias"] = b.float()
    sizes = [int(sd[f"convinv.{k}.conv.weight"].shape[0]) for k in range(n_flows)]
    n_early_every = n_early_size = 0
    for k in range(1, n_flows):
        if sizes[k] != sizes[k - 1]:
            n_early_every, n_early_size = k, sizes[k - 1] - sizes[k]
            break
    up = sd["upsample.weight"]                                  # [M, M, win]
    hints = dict(
        n_flows=n_flows, n_group=sizes[0], n_early_every=n_early_every,
        n_early_size=n_early_size, n_mel_channels=int(up.shape[0]),
        n_layers=1 + max(_indices(sd, r"WN\.0\.in_layers\.(\d+)\.")),
        n_channels=int(sd["WN.0.start.weight"].shape[0]),
        kernel_size=int(sd["WN.0.in_layers.0.weight"].shape[-1]),
        upsample_win_length=int(up.shape[2]), upsample_mode="single",
        couple_transform="second", channel_mixing="1x1conv")
    return sd, hints


def convert_hifigan(sd: StateDict) -> Tuple[StateDict, Dict[str, Any]]:
    sd = _fold(sd)
    n_ups = 1 + max(_indices(sd, r"ups\.(\d+)\."))
    n_blocks = len(_indices(sd, r"resblocks\.(\d+)\."))
    pre = sd["conv_pre.weight"]                                 # [C, M, 7]
    hints = dict(
        n_mel_channels=int(pre.shape[1]), upsample_initial_channel=int(pre.shape[0]),
        n_upsamples=n_ups, num_kernels=n_blocks // n_ups,
        upsample_kernel_sizes=[int(sd[f"ups.{i}.weight"].shape[2])
                               for i in range(n_ups)])
    return sd, hints


def convert_torchmoji(sd: StateDict) -> Tuple[StateDict, Dict[str, Any]]:
    return sd, {"nb_tokens": int(sd["embed.weight"].shape[0])}


def convert_gst(sd: StateDict) -> Tuple[StateDict, Dict[str, Any]]:
    sd = _strip(sd, "gst.")
    emb = sd["token_embedding"]
    units = int(sd["att.fc_Q.0.weight"].shape[0])
    return sd, {
        "token_num": int(emb.shape[0]), "token_embedding_size": int(emb.shape[1]),
        "ref_enc_filters": _conv_filters(sd, "ref_encoder"),
        "gst_att_dim": units,
        "num_heads": units // int(sd["att.fc_V.0.weight"].shape[0])}


def convert_emotionnet(sd: StateDict) -> Tuple[StateDict, Dict[str, Any]]:
    sd = _strip(sd, "emotion_net.")
    cls = sd["classifier_layer.linear_layer.weight"]            # [C, cat]
    ref_rnn = int(sd["ref_enc.gru.weight_hh_l0"].shape[1])
    rnn = int(sd["text_rnn.weight_hh_l0"].shape[1])
    return sd, {
        "n_classes": int(cls.shape[0]),
        "latent_dim": int(sd["latent_layer.linear_layer.weight"].shape[0]) // 2,
        "ref_enc_filters": _conv_filters(sd, "ref_enc"),
        "ref_enc_rnn_dim": ref_rnn, "rnn_dim": rnn,
        "speaker_embedding_dim": int(cls.shape[1]) - ref_rnn - rnn}


def convert_auxemotionnet(sd: StateDict) -> Tuple[StateDict, Dict[str, Any]]:
    sd = _strip(sd, "aux_emotion_net.")
    tm = int(sd["seq_layers.0.linear_layer.weight"].shape[1])
    rnn = int(sd["text_rnn.weight_hh_l0"].shape[1])
    cat = int(sd["latent_classifier_layer.linear_layer.weight"].shape[1])
    return sd, {"torchmoji_dim": tm, "rnn_dim": rnn,
                "speaker_embedding_dim": cat - tm - rnn}


CONVERTERS: Dict[str, Callable[[StateDict], Tuple[StateDict, Optional[Dict]]]] = {
    "tacotron2": convert_tacotron2, "waveglow": convert_waveglow,
    "hifigan": convert_hifigan, "torchmoji": convert_torchmoji,
    "gst": convert_gst, "emotionnet": convert_emotionnet,
    "auxemotionnet": convert_auxemotionnet}
MODELS = tuple(CONVERTERS)


def convert_checkpoint(model: str, src: str, dst: str) -> Dict[str, Any]:
    """Convert the reference checkpoint ``src`` of ``model`` into the port
    checkpoint ``dst``; returns the sidecar written beside it."""
    if model not in CONVERTERS:
        raise SystemExit(f"no converter for model {model!r}")
    sd = _strip(load_reference_state_dict(src), "module.")
    sd, hints = CONVERTERS[model](sd)
    meta = {"model": model}
    if hints is not None:
        meta["model_config"] = hints
    save_checkpoint(dst, {"step": 0, "state_dict": _f32(sd)}, meta)
    return meta

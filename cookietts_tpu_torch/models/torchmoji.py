"""torchMoji (DeepMoji), the sentence-emotion encoder
(cookietts_tpu/models/torchmoji.py).

Embedding (50000 x 256, tanh) -> two bidirectional hard-sigmoid LSTMs (512
units per direction) -> a masked softmax attention over
[lstm_1, lstm_0, embed] (2304 wide, the reference's merge order) -> the
attention-weighted sum, the 2304-wide feature that ``T2S.torchmoji_fn``
feeds Tacotron2.

The forward direction runs over each row's tokens; the backward direction
runs over each row's valid tokens reversed and is put back in order, as
flax's ``nn.RNN(reverse=True, keep_order=True)`` with ``seq_lengths`` does,
so padding never reaches a valid position. Outputs at padded positions are
masked out of the attention.

The hard-sigmoid cell (gate order i, f, g, o, no forget +1) is plain
PyTorch: the ``lstm_gates`` kernel applies a true sigmoid and the forget +1.
Parameters keep the published ``pytorch_model.bin`` key names
(``embed.weight``, ``lstm_{0,1}.weight_ih_l0[_reverse]``, ...,
``attention_layer.attention_vector``), so ``load_state_dict`` takes that
file as it is; its emoji classifier (``output_layer.*``) is not part of the
feature encoder and is dropped on load.
"""
from __future__ import annotations

import json
import re
from typing import Dict, List, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from ..device import full_float32, resolve_device

NB_TOKENS = 50000
EMBED_DIM = 256
HIDDEN = 512
FEATURE_DIM = 4 * HIDDEN + EMBED_DIM      # 2304

SPECIAL_TOKENS = (["CUSTOM_MASK", "CUSTOM_UNKNOWN", "CUSTOM_AT",
                   "CUSTOM_URL", "CUSTOM_NUMBER", "CUSTOM_BREAK"]
                  + [f"CUSTOM_BLANK_{i}" for i in range(6, 10)])


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Keras's hard sigmoid, the reference LSTM's gate activation."""
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


class HardSigmoidBiLSTM(nn.Module):
    """One bidirectional LSTM layer with hard-sigmoid gates, under torch's
    ``nn.LSTM`` parameter names (``*_l0`` forward, ``*_l0_reverse``)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        H, bound = hidden_size, hidden_size ** -0.5
        for sfx in ("", "_reverse"):
            for name, shape in (("weight_ih_l0", (4 * H, input_size)),
                                ("weight_hh_l0", (4 * H, H)),
                                ("bias_ih_l0", (4 * H,)),
                                ("bias_hh_l0", (4 * H,))):
                self.register_parameter(name + sfx, nn.Parameter(
                    torch.empty(shape).uniform_(-bound, bound)))

    def _stacked(self, name: str) -> torch.Tensor:
        return torch.stack([getattr(self, name),
                            getattr(self, name + "_reverse")])

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """x [B, T, in], lengths [B] -> [B, T, 2H] (forward, backward)."""
        B, T, _ = x.shape
        H = self.hidden_size
        t = torch.arange(T, device=x.device)
        # each row's valid prefix reversed (its own inverse), padding in place
        rev = torch.where(t[None] < lengths[:, None],
                          lengths[:, None] - 1 - t[None], t[None])
        gather = lambda y: torch.gather(                          # noqa: E731
            y, 1, rev[:, :, None].expand(-1, -1, y.shape[-1]))
        xs = torch.stack([x, gather(x)])                          # [2, B, T, in]
        bias = self._stacked("bias_ih_l0") + self._stacked("bias_hh_l0")
        xw = torch.einsum("dbti,dgi->dbtg", xs,
                          self._stacked("weight_ih_l0")) + bias[:, None, None]
        w_hh = self._stacked("weight_hh_l0").transpose(1, 2)      # [2, H, 4H]
        h = c = x.new_zeros(2, B, H)
        outs = []
        for step in range(T):
            gates = xw[:, :, step] + torch.bmm(h, w_hh)
            i, f, g, o = gates.split(H, dim=-1)
            c = hard_sigmoid(f) * c + hard_sigmoid(i) * torch.tanh(g)
            h = hard_sigmoid(o) * torch.tanh(c)
            outs.append(h)
        out = torch.stack(outs, 2)                                # [2, B, T, H]
        return torch.cat([out[0], gather(out[1])], dim=-1)


class AttentionLayer(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.attention_vector = nn.Parameter(torch.randn(dim) * 0.05)


def _drop_classifier(state_dict, prefix, *args, **kwargs):
    for key in [k for k in state_dict if k.startswith(prefix + "output_layer.")]:
        del state_dict[key]


class TorchMoji(nn.Module):
    """ids [B, T] (0 = padding) -> the feature [B, 2304]."""

    def __init__(self, nb_tokens: int = NB_TOKENS,
                 device: str | torch.device = "cuda"):
        super().__init__()
        self.embed = nn.Embedding(nb_tokens, EMBED_DIM)
        self.lstm_0 = HardSigmoidBiLSTM(EMBED_DIM, HIDDEN)
        self.lstm_1 = HardSigmoidBiLSTM(2 * HIDDEN, HIDDEN)
        self.attention_layer = AttentionLayer(FEATURE_DIM)
        self._register_load_state_dict_pre_hook(_drop_classifier)
        self.eval()
        self.to(resolve_device(device))

    def forward(self, ids: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        T = ids.shape[1]
        if lengths is None:
            lengths = (ids != 0).sum(1).clamp_min(1)
        mask = torch.arange(T, device=ids.device)[None] < lengths[:, None]
        emb = torch.tanh(self.embed(ids))
        h0 = self.lstm_0(emb, lengths)
        h1 = self.lstm_1(h0, lengths)
        feats = torch.cat([h1, h0, emb], dim=-1)                  # [B, T, 2304]
        logits = feats @ self.attention_layer.attention_vector
        peak = logits.masked_fill(~mask, float("-inf")).amax(1, keepdim=True)
        scores = torch.where(mask, torch.exp(logits - peak), 0.0)
        weights = scores / (scores.sum(1, keepdim=True) + 1e-8)
        return torch.einsum("bt,btd->bd", weights, feats)


# -- tokenizer (the JAX package's, kept in step with it) -----------------------

_WORD_RE = re.compile(
    r"https?://\S+|www\.\S+"          # urls
    r"|@[a-zA-Z0-9_]+"                # mentions
    r"|#[a-zA-Z0-9_]+"                # hashtags kept whole
    r"|(?:mr|ms|mrs|dr|prof)\."       # titles kept whole (input is lowercased)
    r"|[a-zA-Z]+(?:'[a-zA-Z]+)?"      # words and contractions ("don't")
    r"|\d+"                           # digit runs ("3.5" is 3 / . / 5)
    r"|[^\sa-zA-Z0-9]+"               # punctuation / emoji runs
)


def tokenize(text: str, vocabulary: Mapping[str, int],
             maxlen: int = 30) -> np.ndarray:
    """text -> a fixed-length id row [maxlen] (0-padded): lowercased,
    CUSTOM_UNKNOWN for out-of-vocabulary words, CUSTOM_URL / CUSTOM_AT for
    URLs and mentions, CUSTOM_NUMBER for digit runs."""
    unknown = vocabulary.get("CUSTOM_UNKNOWN", 1)
    ids: List[int] = []
    for tok in _WORD_RE.findall(text.strip().lower()):
        if tok.startswith(("http://", "https://", "www.")):
            ids.append(vocabulary.get("CUSTOM_URL", 3))
        elif tok.startswith("@"):
            ids.append(vocabulary.get("CUSTOM_AT", 2))
        elif tok[0].isdigit():
            ids.append(vocabulary.get("CUSTOM_NUMBER", 4))
        else:
            ids.append(vocabulary.get(tok, unknown))
        if len(ids) >= maxlen:
            break
    row = np.zeros(maxlen, np.int64)
    row[: len(ids)] = ids[:maxlen]
    return row


def load_vocabulary(path: str) -> Dict[str, int]:
    with open(path) as f:
        return json.load(f)


class TorchMojiEncoder:
    """The host callable ``text -> np.ndarray[2304]`` that ``T2S`` takes as
    ``torchmoji_fn``: ``weights`` is a TorchMoji module or its state dict
    (the published ``pytorch_model.bin`` as it is). Runs on ``device``, the
    card unless the caller asks for the CPU, in full float32."""

    def __init__(self, vocabulary: Mapping[str, int],
                 weights: Union[TorchMoji, Mapping[str, torch.Tensor]],
                 maxlen: int = 30, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.vocab = dict(vocabulary)
        self.maxlen = maxlen
        if isinstance(weights, TorchMoji):
            model = weights
        else:
            model = TorchMoji(weights["embed.weight"].shape[0], device="cpu")
            model.load_state_dict(weights)
        self.model = model.to(self.device).eval()

    @torch.no_grad()
    def __call__(self, text: str) -> np.ndarray:
        ids = torch.from_numpy(tokenize(text, self.vocab, self.maxlen)[None])
        with full_float32():
            return self.model(ids.to(self.device))[0].cpu().numpy()

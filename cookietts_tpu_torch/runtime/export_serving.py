"""Ahead-of-time serving artifacts (cookietts_tpu/runtime/export_serving.py),
through ``torch.export``.

The serving functions are exported ahead of time into ``torch.export``
programs with every weight baked in as a constant, at fixed serving buckets,
and an artifact loads and runs without the model classes, the checkpoint or
the converters: the loader imports ``ops/hopper_kernels.py`` (it registers
the kernels' custom ops, ``torch.ops.cookietts_tpu_torch.*``, that the
programs call) and ``pipeline/chunk_graph.py``, and nothing under
``models/``. A program runs on the device type it was exported on.

Container: as the JAX package's, one ``.npz`` whose entries are the bytes of
``torch.export.save``d programs, plus ``__meta__`` (JSON, with ``"format":
"torch.export"`` and the device type). Per (batch, text) bucket,
``t2s_b{B}_t{T}`` is three programs:

- ``t2s_b{B}_t{T}.encode``: (text i64 [B, T], text_lengths i64 [B],
  speaker_id i64 [B][, torchmoji f32 [B, D]]) -> (memory, the attention's
  per-utterance constants, the decoder's initial state), flat;
- ``t2s_b{B}_t{T}.step``: one decode step, (memory, constants, state,
  prenet keep masks bool [layers, B, prenet_dim]) -> (mel_raw [B, r M],
  gate [B, r], alignment [B, T], state);
- ``t2s_b{B}_t{T}.postnet``: the raw mel of the whole decode, its
  ``max_decoder_steps`` frames (as JAX's scan gives them) -> refined.

The decode is not unrolled over ``max_decoder_steps`` (a 1000-step graph is
tens of thousands of nodes and minutes of export), nor over a chunk (a
64-step chunk is about 0.3 s of export a step on the host): the loader
forms chunks of the live path's size (``chunk_size``, ``max(64,
gate_delay)``) from the step program, and ``ArtifactT2SDecoder.decode``
drives them until one chunk after every row's gate has fired, or to the
baked step count, as the live early-exit decode does. On the card each
chunk runs as a CUDA graph (``DecodeChunkGraphs``: captured per shape, on
its own stream; a failed capture raises), the same graph a chunk program
would give. The programs draw nothing: the
loader draws the prenet's keep masks on the device from a
``torch.Generator`` seeded with the request's seed, one draw per prenet
layer and step in the live decode's order, so the artifact decodes what the
live model decodes from a generator of that seed. ``vocoder_b{B}_t{T}`` is
``(mel f32 [B, T, M]) -> audio`` (HiFi-GAN) or, for a flow vocoder,
``(mel, z) -> audio`` with z drawn by the loader from the seed (sigma
times a standard normal, as ``WaveGlow.infer`` draws it).
"""
from __future__ import annotations

import io
import itertools
import json
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree as pytree

from ..device import full_float32, resolve_device
from ..ops import hopper_kernels as hk  # noqa: F401  (registers the ops)
from ..ops.masking import get_first_over_thresh
from ..pipeline.chunk_graph import DecodeChunkGraphs

FORMAT = "torch.export"
SILENCE = -11.52            # the log-mel a mel is padded with (live vocoding)


class _Program(nn.Module):
    """``fn(*args)`` as a module for ``torch.export``. The model ``fn`` reads
    is not a registered submodule, so the program bakes in, as constants,
    the tensors the function reads and no others."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.__dict__["fn"] = fn

    def forward(self, *args):
        return self.fn(*args)


def export_program(fn: Callable, args: Sequence[Any]) -> bytes:
    """``fn`` traced at ``args`` (tensors on the device it will run on) by
    ``torch.export``, serialized. ``fn`` runs once eagerly first, so that
    the weights the models derive and cache (``hopper_kernels.derived``:
    the kernels' packed layouts, W^-1 of the 1x1 convs, the STFT's bases)
    are baked in as built, not rebuilt in the program at every call."""
    with torch.no_grad():
        fn(*args)
        ep = torch.export.export(_Program(fn), tuple(args), strict=False)
    # each constant saved as a dense tensor of its own: parameters (which
    # require grad) detached; views of a larger storage, and strided values
    # such as W^-1 from LAPACK, copied out
    for name, value in ep.constants.items():
        if isinstance(value, torch.Tensor):
            own = value.is_contiguous() and (value.untyped_storage().nbytes()
                                             == value.numel() * value.element_size())
            ep.constants[name] = (value.detach() if own else value.detach().clone(
                memory_format=torch.contiguous_format))
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def _specs(model, B: int, T: int) -> List[torch.Tensor]:
    """Example encode inputs of a (B, T) bucket: full-length rows."""
    dev = model.device
    args = [torch.ones(B, T, dtype=torch.long, device=dev),
            torch.full((B,), T, dtype=torch.long, device=dev),
            torch.zeros(B, dtype=torch.long, device=dev)]
    if model.cfg.torchmoji_dim:
        args.append(torch.zeros(B, model.cfg.torchmoji_dim, device=dev))
    return args


def export_tacotron2_serving(model, buckets: Sequence[Tuple[int, int]],
                             max_decoder_steps: Optional[int] = None
                             ) -> Dict[str, bytes]:
    """The three programs (``encode``, ``step``, ``postnet``) of each
    (batch, text) bucket of a port ``Tacotron2``, exported on the model's
    device. The decode's ``max_decoder_steps`` (by default the config's)
    frames are the postnet's input; the loader's chunk size is in the meta
    (``tacotron2_meta``)."""
    cfg = model.cfg
    dec = model.decoder
    r = cfg.n_frames_per_step
    T_cap = -(-(max_decoder_steps or cfg.max_decoder_steps) // r) * r
    was = model.training
    model.eval()
    entries: Dict[str, bytes] = {}
    try:
        with torch.no_grad():
            for B, T in buckets:
                args = _specs(model, B, T)
                const, state = _encode_parts(model, *args)[1:]
                spec = pytree.tree_structure((const, state))

                def encode(text, text_lengths, speaker_id, torchmoji=None):
                    memory, c, s = _encode_parts(model, text, text_lengths,
                                                 speaker_id, torchmoji)
                    return (memory, *pytree.tree_leaves((c, s)))

                def step(memory, *rest):
                    *leaves, masks = rest
                    c, s = pytree.tree_unflatten(leaves, spec)
                    s, mel, gate, w = dec.step(s, memory, c, masks=masks)
                    return (mel, gate, w, *pytree.tree_leaves(s))

                def postnet(mel):
                    return model.postnet(mel) if cfg.use_postnet else mel * 1.0

                out = encode(*args)
                masks = torch.ones(cfg.prenet_layers, B, cfg.prenet_dim,
                                   dtype=torch.bool, device=model.device)
                mel = torch.zeros(B, T_cap, cfg.n_mel_channels,
                                  device=model.device)
                key = f"t2s_b{B}_t{T}"
                entries[key + ".encode"] = export_program(encode, args)
                entries[key + ".step"] = export_program(step, (*out, masks))
                entries[key + ".postnet"] = export_program(postnet, (mel,))
    finally:
        model.train(was)
    return entries


def _encode_parts(model, text, text_lengths, speaker_id, torchmoji=None):
    """(memory, attention constants, initial decoder state)."""
    memory, _ = model._build_memory(text, text_lengths, speaker_id, None,
                                    torchmoji)
    const, state = model.decoder.prepare(memory, text_lengths)
    return memory, const, state


def tacotron2_meta(model, buckets, max_decoder_steps=None,
                   **extra) -> Dict[str, Any]:
    """The ``t2s`` meta of ``export_tacotron2_serving``'s programs: JAX's
    keys, and what the port's loader needs to drive the decode (the live
    path's chunk size, the prenet's masks, how many of the encode's outputs
    are the attention's constants)."""
    cfg = model.cfg
    was = model.training
    model.eval()
    with torch.no_grad():
        const = _encode_parts(model, *_specs(model, 1, 2))[1]
    model.train(was)
    return {"buckets": [list(b) for b in buckets],
            "n_mel_channels": cfg.n_mel_channels,
            "torchmoji_dim": cfg.torchmoji_dim,
            "gate_inputs": True, "gate_threshold": cfg.gate_threshold,
            "gate_delay": cfg.gate_delay, "step_inputs": True,
            "max_decoder_steps": int(max_decoder_steps or cfg.max_decoder_steps),
            "chunk_size": max(64, cfg.gate_delay),
            "n_frames_per_step": cfg.n_frames_per_step,
            "prenet_layers": cfg.prenet_layers, "prenet_dim": cfg.prenet_dim,
            "p_prenet_dropout": cfg.p_prenet_dropout,
            "n_const": len(pytree.tree_leaves(const)), **extra}


def export_vocoder_serving(infer_fn: Callable, n_mel_channels: int,
                           buckets: Sequence[Tuple[int, int]],
                           needs_key: bool = False,
                           z_shape: Optional[Callable[[int, int], tuple]] = None,
                           device: str | torch.device = "cuda"
                           ) -> Dict[str, bytes]:
    """One program per (batch, mel frames) bucket: ``infer_fn(mel [B, T,
    M]) -> audio`` (HiFi-GAN) or, with ``needs_key``, ``infer_fn(mel, z) ->
    audio`` (flow vocoders; ``z_shape(B, T)`` is z's shape, which the loader
    draws from a seed)."""
    dev = resolve_device(device)
    entries: Dict[str, bytes] = {}
    for B, T in buckets:
        args = [torch.zeros(B, T, n_mel_channels, device=dev)]
        if needs_key:
            args.append(torch.zeros(z_shape(B, T), device=dev))
        entries[f"vocoder_b{B}_t{T}"] = export_program(infer_fn, args)
    return entries


def save_artifact(path: str, entries: Dict[str, bytes],
                  meta: Optional[Dict[str, Any]] = None) -> None:
    """Write ``entries`` and ``meta`` as one ``.npz`` (atomically)."""
    arrays = {k: np.frombuffer(v, np.uint8) for k, v in entries.items()}
    arrays["__meta__"] = np.frombuffer(
        json.dumps({"format": FORMAT, **(meta or {})}).encode("utf-8"), np.uint8)
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_artifact(path: str, device: str | torch.device = "cuda"
                  ) -> Tuple[Dict[str, Callable], Dict[str, Any]]:
    """(callables, meta): each program of ``path`` loaded as a callable, no
    model code or checkpoint needed. Refuses a JAX (StableHLO) artifact and
    one exported on another device type than ``device``."""
    dev = resolve_device(device)
    data = np.load(path)
    meta = json.loads(bytes(data["__meta__"].tobytes()).decode("utf-8"))
    if meta.get("format") != FORMAT:
        raise ValueError(
            f"{path}: not a torch.export artifact (format "
            f"{meta.get('format')!r}; platforms {meta.get('platforms')}): a "
            "JAX package artifact holds StableHLO, which serves through "
            "cookietts_tpu's --artifact; export a port artifact with "
            "`python -m cookietts_tpu_torch export`")
    if meta.get("device") != dev.type:
        raise ValueError(
            f"{path} was exported on {meta.get('device')!r} and cannot run on "
            f"{dev.type!r}: export it again with --device {dev.type}")
    fns: Dict[str, Callable] = {}
    for k in data.files:
        if k != "__meta__":
            fns[k] = torch.export.load(io.BytesIO(data[k].tobytes())).module()
    return fns, meta


class _ArtifactChunk:
    """A loaded step program in ``Decoder.decode_chunk``'s form, for
    ``DecodeChunkGraphs``: each step's prenet keep masks drawn from
    ``generator`` (as the live prenet draws them, layer by layer), then the
    program."""

    def __init__(self, program, layers: int, dim: int, p: float, n_mel: int):
        self.program, self.layers, self.dim, self.p = program, layers, dim, p
        self.n_mel = n_mel

    def decode_chunk(self, memory, const, state, steps, generator):
        B, dev = memory.shape[0], memory.device
        mels, gates, weights = [], [], []
        for _ in range(steps):
            if self.p > 0:
                masks = torch.stack([
                    torch.rand((B, self.dim), generator=generator, device=dev)
                    < 1.0 - self.p for _ in range(self.layers)])
            else:
                masks = torch.ones(self.layers, B, self.dim, dtype=torch.bool,
                                   device=dev)
            mel, gate, w, *state = self.program(memory, *const, *state, masks)
            mels.append(mel)
            gates.append(gate)
            weights.append(w)
        return (torch.stack(mels, 1).reshape(B, -1, self.n_mel),
                torch.stack(gates, 1).reshape(B, -1), torch.stack(weights, 1),
                state)


class ArtifactT2SDecoder:
    """Serving decoder over a saved artifact: no model classes, checkpoints
    or converters on the host.

    ``decode(text [B, T], lens, speaker_id, torchmoji, seed,
    [gate_threshold, gate_delay, max_steps])`` pads the text to the smallest
    exported text bucket that fits and returns (mels, mel_lengths,
    alignments cropped to T), tensors on the device: the early-exit decode
    of the exported chunks (the module docstring), mel_lengths the first
    gate crossing plus the delay, capped at the baked step count and at
    ``max_steps``. The decode stops one chunk after every row's gate has
    crossed the request's threshold (the live decode: the model's, which the
    live worker caps the request's at), so the frames up to mel_lengths are
    always decoded; the delay is capped at a chunk, as the live worker caps
    it. ``vocoder(mel [B, T_mel, M], seed)`` runs the exported vocoder
    bucket that fits; ``make_vocoder_fn`` makes it a T2S ``vocoder_fn``."""

    def __init__(self, path: str, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        fns, meta = load_artifact(path, self.device)
        t2s = meta.get("t2s")
        if not t2s:
            raise ValueError(f"{path} has no exported t2s functions")
        self.meta = meta
        buckets = sorted(tuple(b) for b in t2s["buckets"])
        self.batch = buckets[0][0]
        if any(b != self.batch for b, _ in buckets):
            raise ValueError("mixed batch sizes in artifact buckets")
        self.text_buckets = sorted(t for _, t in buckets)
        self.torchmoji_dim = int(t2s.get("torchmoji_dim") or 0)
        self.n_mel_channels = int(t2s.get("n_mel_channels", 80))
        self.speaker_ids = t2s.get("speaker_ids") or {"default": 0}
        self.audio = dict(t2s.get("audio") or {})
        self.gate_threshold = float(t2s.get("gate_threshold", 0.5))
        self.gate_delay = int(t2s.get("gate_delay", 10))
        self.max_decoder_steps = int(t2s["max_decoder_steps"])
        self.chunk_size = int(t2s["chunk_size"])
        self.r = int(t2s.get("n_frames_per_step", 1))
        self.n_const = int(t2s["n_const"])
        self._t2s = {}
        for t in self.text_buckets:
            key = f"t2s_b{self.batch}_t{t}"
            chunk = _ArtifactChunk(fns[key + ".step"], int(t2s["prenet_layers"]),
                                   int(t2s["prenet_dim"]),
                                   float(t2s["p_prenet_dropout"]),
                                   self.n_mel_channels)
            self._t2s[t] = (fns[key + ".encode"], DecodeChunkGraphs(chunk),
                            fns[key + ".postnet"])
        self._voc_fns = {}
        voc = meta.get("vocoder")
        if voc:
            self.audio.update(voc.get("audio") or {})
            self._voc_needs_key = bool(voc.get("needs_key", False))
            self._z_shapes = {k: tuple(v) for k, v in
                              (voc.get("z_shapes") or {}).items()}
            self._sigma = float(voc.get("sigma", 1.0))
            for b, t in (tuple(x) for x in voc["buckets"]):
                self._voc_fns[(b, t)] = fns[f"vocoder_b{b}_t{t}"]

    @property
    def has_vocoder(self) -> bool:
        return bool(self._voc_fns)

    @property
    def chunk_programs(self) -> List[DecodeChunkGraphs]:
        """The chunk program of each text bucket (captures, replays)."""
        return [progs[1] for progs in self._t2s.values()]

    def _tensor(self, x, dtype):
        return torch.as_tensor(x, dtype=dtype).to(self.device)

    def decode(self, text, text_lengths, speaker_id, torchmoji, seed,
               gate_threshold=None, gate_delay=None, max_steps=None):
        text = torch.as_tensor(text)
        B, T = text.shape
        if B != self.batch:
            raise ValueError(f"artifact exported at batch {self.batch}, got {B} "
                             "(set T2SConfig.batch_size to match)")
        fit = [t for t in self.text_buckets if t >= T]
        if not fit:
            raise ValueError(f"text length {T} exceeds the largest exported "
                             f"bucket {self.text_buckets[-1]}")
        encode, chunks, postnet = self._t2s[fit[0]]
        padded = torch.zeros(B, fit[0], dtype=torch.long)
        padded[:, :T] = text
        args = [self._tensor(padded, torch.long),
                self._tensor(text_lengths, torch.long),
                self._tensor(speaker_id, torch.long)]
        if self.torchmoji_dim:
            tm = torch.zeros(B, self.torchmoji_dim)
            if torchmoji is not None:
                src = torch.as_tensor(torchmoji, dtype=torch.float32)
                w = min(self.torchmoji_dim, src.shape[-1])
                tm[:, :w] = src[..., :w]
            args.append(self._tensor(tm, torch.float32))
        thr = (self.gate_threshold if gate_threshold is None
               else float(gate_threshold))
        delay = min(self.gate_delay if gate_delay is None else int(gate_delay),
                    self.chunk_size * self.r)
        generator = torch.Generator(device=self.device).manual_seed(int(seed))
        memory, *leaves = encode(*args)
        const, state = leaves[:self.n_const], leaves[self.n_const:]
        r, S = self.r, self.chunk_size
        S_req = -(-self.max_decoder_steps // r)
        n_chunks = -(-S_req // S)
        mels, gates, weights = [], [], []
        fired = torch.zeros(B, dtype=torch.bool, device=self.device)
        n_done = 0
        for _ in range(n_chunks):
            mel, gate, w, state = chunks(memory, const, state, S, generator)
            mels.append(mel)
            gates.append(gate)
            weights.append(w)
            fired |= (torch.sigmoid(gate) >= thr).any(1)
            n_done = n_done + 1 if bool(fired.all()) else 0
            if n_done == 2:
                break
        left = n_chunks - len(mels)
        if left:
            mels.append(torch.zeros(B, left * S * r, self.n_mel_channels,
                                    device=self.device))
            gates.append(torch.full((B, left * S * r), -1e4, device=self.device))
            weights.append(torch.zeros(B, left * S, memory.shape[1],
                                       device=self.device))
        T_cap = S_req * r
        mels = postnet(torch.cat(mels, 1)[:, :T_cap])
        gates = torch.cat(gates, 1)[:, :T_cap]
        align = torch.cat(weights, 1)
        if r > 1:
            align = align.repeat_interleave(r, dim=1)
        stop = get_first_over_thresh(torch.sigmoid(gates), thr)
        lengths = torch.clamp(stop + delay, max=T_cap)
        if max_steps is not None:
            lengths = torch.clamp(lengths, max=max(int(max_steps), 1))
        return mels, lengths, align[:, :T_cap, :T]

    def vocoder(self, mel, seed=0, z: Optional[torch.Tensor] = None):
        """Route ``mel [B, T, M]`` to the smallest exported bucket that fits:
        rows pad with silence up to the bucket's batch, time with the log-mel
        of silence up to its frames; the audio is cropped back to [B,
        T * hop]. A flow vocoder's z is ``z`` when given (the bucket's
        shape), else drawn from ``seed``."""
        if not self._voc_fns:
            raise ValueError("artifact has no exported vocoder")
        mel = torch.as_tensor(mel, dtype=torch.float32)
        B, T = mel.shape[:2]
        keys = sorted(k for k in self._voc_fns if k[0] >= B and k[1] >= T)
        if not keys:
            raise ValueError(f"no vocoder bucket fits mel [{B}, {T}]; "
                             f"exported: {sorted(self._voc_fns)}")
        b, t = min(keys, key=lambda k: (k[0] * k[1], k))
        padded = torch.full((b, t, mel.shape[2]), SILENCE, device=self.device)
        padded[:B, :T] = mel.to(self.device)
        args = [padded]
        if self._voc_needs_key:
            if z is None:
                generator = torch.Generator(device=self.device).manual_seed(
                    int(seed))
                z = self._sigma * torch.randn(
                    self._z_shapes[f"b{b}_t{t}"], generator=generator,
                    device=self.device)
            args.append(z)
        with full_float32():
            audio = self._voc_fns[(b, t)](*args)[:B]
        hop = int(self.audio.get("hop_length", 0))
        return audio[:, :T * hop] if hop else audio

    def make_vocoder_fn(self):
        """A T2S ``vocoder_fn(mel) -> audio``: seeds 0, 1, ... call by call;
        marked ``stochastic`` (a flow vocoder draws per position, so
        chunked vocoding would seam)."""
        counter = itertools.count()

        def fn(mel):
            return self.vocoder(mel, seed=next(counter))

        fn.stochastic = True
        return fn


"""Streaming vocoding and chunked TTS (cookietts_tpu/pipeline/streaming.py).

A whole-utterance pipeline puts out its first sample only after the last mel
frame is vocoded. For a deterministic convolutional vocoder (HiFi-GAN) output
sample ``t`` depends only on the mel frames within the generator's receptive
field around ``t / hop``, so vocoding overlapping windows and cropping their
halos gives the whole run's audio while streaming:

- windows are clamped slices of the real mel (never padded): at a true
  sequence edge the generator applies its own zero padding, as the whole run
  does, and interior crop points sit ``halo`` frames from any window edge;
- every window has the same width (edge windows slide inward), so the
  vocoder sees one shape per batch, and streaming costs only the halo
  recompute (``2 * halo / chunk`` extra frames).

Not for stochastic vocoders: a flow vocoder draws noise per position, so
windows would seam; T2S vocodes those whole.

:func:`streaming_tts` chains the decoder's chunks (``Tacotron2.decode_chunk``
through :func:`make_streaming_fns`'s CUDA-graph chunk program), the postnet
over a window with its halo, and the vocoder over a window with its halo, and
yields audio after the first decode chunk. Pieces are numpy arrays on the
host.
"""
from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..models.hifigan import serving_vocoder
from .chunk_graph import DecodeChunkGraphs


def _host(audio) -> np.ndarray:
    if isinstance(audio, torch.Tensor):
        return audio.detach().float().cpu().numpy()
    return np.asarray(audio, np.float32)


def streaming_vocode(vocoder_fn: Callable, mel, chunk_frames: int = 256,
                     halo_frames: int = 32, hop_length: Optional[int] = None
                     ) -> Iterator[Tuple[int, np.ndarray]]:
    """Yield ``(start_sample, audio_chunk [B, chunk * hop])`` pieces whose
    concatenation equals ``vocoder_fn(mel)`` (see the module docstring for
    the halo condition). ``mel``: [B, T, n_mel], a tensor (vocoded on its
    device) or an array.

    Every window is ``chunk + 2 * halo`` frames wide: edge windows slide
    inward over real frames instead of shrinking. Mels no longer than one
    window vocode whole. A HiFi-GAN ``Generator`` runs with ``infer=True``."""
    vocoder_fn = serving_vocoder(vocoder_fn)
    mel = torch.as_tensor(mel)
    T = mel.shape[1]
    hop = hop_length
    W = chunk_frames + 2 * halo_frames
    if T <= W:
        yield 0, _host(vocoder_fn(mel))
        return
    for s in range(0, T, chunk_frames):
        e = min(s + chunk_frames, T)
        lo = min(max(0, s - halo_frames), T - W)
        audio = vocoder_fn(mel[:, lo: lo + W])
        if hop is None:
            hop = audio.shape[1] // W
        yield s * hop, _host(audio[:, (s - lo) * hop: (e - lo) * hop])


def vocode_streamed(vocoder_fn: Callable, mel, chunk_frames: int = 256,
                    halo_frames: int = 32,
                    hop_length: Optional[int] = None) -> np.ndarray:
    """Assemble :func:`streaming_vocode` pieces into one waveform."""
    return np.concatenate(
        [p for _, p in streaming_vocode(vocoder_fn, mel, chunk_frames,
                                        halo_frames, hop_length)], axis=1)


def make_streaming_fns(taco):
    """(prepare, decode_chunk, postnet_refine) of a Tacotron2; the chunk is
    a :class:`DecodeChunkGraphs` (a CUDA graph per shape on the card). Pass
    them as ``fns=`` to repeated :func:`streaming_tts` calls so they share
    the captured graphs."""
    return (taco.inference_prepare, DecodeChunkGraphs(taco.decoder),
            taco.postnet_refine)


@torch.no_grad()
def streaming_tts(taco, vocoder_fn, *, text, text_lengths, speaker_id,
                  generator: Optional[torch.Generator] = None,
                  torchmoji_hidden=None, sylps=None,
                  max_decoder_steps: int = 512, decode_chunk_steps: int = 32,
                  vocoder_halo: int = 32, hop_length: int = 256,
                  gate_threshold: float = 0.5, gate_delay: int = 10,
                  fns=None) -> Iterator[Tuple[int, np.ndarray]]:
    """End-to-end chunked TTS: yield ``(start_sample, audio_piece [B, n])``,
    the first piece after one decode chunk and one vocoder window.

    - ``inference_prepare`` encodes once (the attention precompute too);
    - the chunk program advances the decoder ``decode_chunk_steps`` steps a
      call, drawing the prenet dropout from ``generator`` as the whole
      decode does (the same raw mels for the same seed);
    - the postnet refines a clamped window with its receptive-field halo
      (``2 * postnet_n_convolutions`` frames);
    - the vocoder renders a clamped window with ``vocoder_halo`` frames.

    Audio for frames ``[a, b)`` is emitted once raw mel exists up to
    ``b + postnet_halo + vocoder_halo``, so the stream matches the whole
    pipeline away from the utterance's tail (a whole fixed-length decode runs
    on past the gate, so the last ``postnet_halo`` frames of a gate-stopped
    stream see other frames after them). Gate stopping is on the host:
    decoding stops once every row's gate has fired and ``gate_delay`` +
    the postnet halo frames exist; the last chunk is trimmed to the step
    budget.
    """
    cfg = taco.cfg
    vocoder_fn = serving_vocoder(vocoder_fn)   # a Generator with infer=True
    r = cfg.n_frames_per_step
    hp = 2 * cfg.postnet_n_convolutions if cfg.use_postnet else 0
    S_total = -(-max_decoder_steps // r)
    prepare, step, refine = fns if fns is not None else make_streaming_fns(taco)
    memory, const, state = prepare(text, text_lengths, speaker_id,
                                   torchmoji_hidden, sylps)
    B = memory.shape[0]

    raw = memory.new_zeros((B, 0, cfg.n_mel_channels))
    gates = np.zeros((B, 0), np.float32)
    emitted = 0                      # frames of audio already yielded
    mel_len = None                   # known once every gate fires
    max_frames = S_total * r         # what the whole fixed-length decode emits
    done_decoding = False
    while not done_decoding:
        mel_c, gate_c, _, state = step(memory, const, state, decode_chunk_steps,
                                       generator)
        raw = torch.cat([raw, mel_c], dim=1)
        gates = np.concatenate([gates, _host(gate_c)], axis=1)
        if raw.shape[1] > max_frames:
            # the last chunk overshoots the step budget when S_total is not
            # a multiple of decode_chunk_steps: the whole decode never makes
            # those frames, so drop them before the gate logic sees them
            raw = raw[:, :max_frames]
            gates = gates[:, :max_frames]
        F = raw.shape[1]
        sig = 1.0 / (1.0 + np.exp(-gates))
        if (sig > gate_threshold).any(axis=1).all():
            stop = np.array([np.argmax(sig[b] > gate_threshold)
                             for b in range(B)])
            mel_len = int(min(np.max(stop) + gate_delay, F))
        if (mel_len is not None and F >= mel_len + hp) or F >= max_frames:
            done_decoding = True
            mel_len = mel_len if mel_len is not None else F
        # emit audio for frames whose postnet and vocoder halos are decoded
        # (everything, after the last chunk)
        safe = mel_len if done_decoding else F - hp - vocoder_halo
        safe = min(safe, F if mel_len is None else mel_len)
        if safe <= emitted:
            continue
        lo_p = max(0, emitted - vocoder_halo - hp)
        hi_p = min(F, safe + vocoder_halo + hp)
        refined = refine(raw[:, lo_p:hi_p])
        # the vocoder window with its halo, in refined-frame coordinates
        lo_v = max(0, emitted - vocoder_halo) - lo_p
        hi_v = min(hi_p - lo_p, (safe + vocoder_halo) - lo_p)
        audio = vocoder_fn(refined[:, lo_v:hi_v])
        a0 = (emitted - (lo_v + lo_p)) * hop_length
        a1 = a0 + (safe - emitted) * hop_length
        yield emitted * hop_length, _host(audio[:, a0:a1])
        emitted = safe

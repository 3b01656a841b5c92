"""GTA (ground-truth-aligned) mel generation for vocoder and postnet
training (cookietts_tpu/pipeline/gta.py), stage 3 of the pipeline:

- teacher-forced synthesis (p_teacher_forcing=1, till=9999) of a trained
  Tacotron2 over the training filelist, saving each utterance's postnet mel
  as ``<audio>.mel.npy`` and a map file, ``map_train_0.txt``, of
  ``wav|mel|speaker`` lines;
- ``extreme_gta``: synthesis again from audio offset 0..hop by a step N,
  saved as ``<audio>.mel{N}.npy``, for vocoder augmentation;
- letter durations from the alignment's argmax histogram, saved as
  ``<audio>.gdur.npy`` (``.gdur{N}.npy`` at an offset).

The forward is validation's (``Tacotron2.eval_forward``): eval form, where
JAX runs ``deterministic=True``, without autograd, with the prenet's
always-on dropout drawing its masks from a ``torch.Generator`` seeded 0 at
every batch (JAX draws from ``PRNGKey(0)`` at every batch: the same rule,
other masks). Every output is checked finite and as long as its mel before
it is saved. On the card, attention type 0 runs ``attention_step`` once a
decoder step and ``lstm_gates`` once a step for each decoder cell.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..device import batch_to_device, full_float32


def durations_from_alignment(alignments: np.ndarray,
                             text_lengths: np.ndarray,
                             mel_lengths: np.ndarray) -> List[np.ndarray]:
    """Per-letter frame counts from the argmax attention histogram
    (reference _2_ttm/tacotron2_tm/GTA.py:43-50)."""
    out = []
    for b in range(alignments.shape[0]):
        T_dec = int(mel_lengths[b])
        T_enc = int(text_lengths[b])
        peaks = alignments[b, :T_dec, :T_enc].argmax(axis=1)
        out.append(np.bincount(peaks, minlength=T_enc).astype(np.int32))
    return out


class GTAGenerator:
    """Teacher-forced batch synthesis with ``model`` (a port Tacotron2 on
    its device) and the vocoder map written under ``outdir``."""

    def __init__(self, model, outdir: str):
        self.model = model
        self.outdir = outdir
        self.decoder_steps = 0          # decoder steps run, for the caller
        os.makedirs(outdir, exist_ok=True)

    def forward(self, batch: Dict[str, Any]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A collated batch -> (postnet mels [B, T, M], alignments [B, T,
        T_enc]) on the model's device, in full float32."""
        device = self.model.device
        generator = torch.Generator(device).manual_seed(0)
        with full_float32():
            out = self.model.eval_forward(batch_to_device(batch, device),
                                          generator)
        self.decoder_steps += (out["alignments"].shape[1]
                               // self.model.cfg.n_frames_per_step)
        return out["mel_outputs_postnet"], out["alignments"]

    def process_batch(self, batch: Dict[str, Any],
                      audiopaths: Sequence[str],
                      offset: int = 0) -> List[str]:
        """Run one batch; save ``.mel.npy`` (``.mel{offset}.npy``) and
        ``.gdur.npy`` (``.gdur{offset}.npy``) beside each audio file.
        Returns the map lines ``wav|mel|speaker``."""
        mels, aligns = self.forward(batch)
        mels = mels.float().cpu().numpy()
        aligns = aligns.float().cpu().numpy()
        mel_lengths = np.asarray(batch["mel_lengths"])
        durs = durations_from_alignment(aligns, np.asarray(batch["text_lengths"]),
                                        mel_lengths)
        speaker_ids = np.asarray(batch["speaker_id"])
        lines = []
        for i, path in enumerate(audiopaths):
            T = int(mel_lengths[i])
            mel = mels[i, :T]
            assert np.isfinite(mel).all(), f"non-finite GTA mel: {path}"
            assert mel.shape[0] == T
            # the reference's names: '.mel.npy' at offset 0, '.mel{N}.npy'
            # at an extremeGTA offset (Mel2Samp reads the offset back);
            # '.gdur': '.dur.npy' belongs to forced-alignment phone
            # durations, which UnTTS trains on
            tag = str(offset) if offset else ""
            mel_path = f"{path}.mel{tag}.npy"
            np.save(mel_path, mel)
            np.save(f"{path}.gdur{tag}.npy", durs[i])
            lines.append(f"{path}|{mel_path}|{int(speaker_ids[i])}")
        return lines

    def write_map(self, lines: Sequence[str]) -> str:
        """``map_train_0.txt`` under ``outdir`` (one shard: the port runs
        one process)."""
        path = os.path.join(self.outdir, "map_train_0.txt")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        return path


def extreme_gta_offsets(hop_length: int, step: int) -> List[int]:
    """Audio-offset schedule for --extremeGTA (GTA.py:268-275)."""
    assert step <= hop_length and hop_length % step == 0
    return list(range(0, hop_length, step))


def offset_item_mels(dataset, items: Sequence[Dict[str, Any]],
                     offset: int) -> List[Dict[str, Any]]:
    """Each item's mel again from its audio trimmed by ``offset`` samples:
    extremeGTA synthesises from shifted audio (reference GTA.py:115-128,
    197-198), not just under another name."""
    if offset == 0:
        return list(items)
    out = []
    for it in items:
        audio = dataset.load_audio(it["audiopath"])
        mel = dataset.stft.mel_spectrogram_np(audio[offset:]).astype(np.float32)
        out.append(dict(it, mel=mel, mel_length=mel.shape[0]))
    return out

"""The default-device rule shared by every entry point, the float32
context every numerics-critical path runs in, and a collated batch's move
to the device.

Entry points default to ``"cuda"``. Without a card they raise instead of
falling back to the CPU; the CPU is used only when the caller asks for it.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict

import numpy as np
import torch

_INT_KEYS = ("text", "text_lengths", "mel_lengths", "speaker_id", "emotion_id",
             "durations", "window_starts")


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


@contextlib.contextmanager
def full_float32():
    """Matrix products and convolutions in full float32 (TF32 off) inside."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A collated numpy batch as tensors on ``device``: ids and lengths as
    int64, the rest as float32; the audio paths are left out."""
    out = {}
    for k, v in batch.items():
        if k == "audiopath":
            continue
        t = torch.as_tensor(np.asarray(v))
        t = t.long() if k in _INT_KEYS else t.float()
        out[k] = t.to(device, non_blocking=True)
    return out

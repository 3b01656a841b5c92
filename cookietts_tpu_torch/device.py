"""The default-device rule shared by every entry point.

Entry points default to ``"cuda"``. Without a card they raise instead of
falling back to the CPU; the CPU is used only when the caller asks for it.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev

"""Length masks, the gate stop index, drop-frame and dropout
(cookietts_tpu/ops/masking.py)."""
from __future__ import annotations

from typing import Optional

import torch

from ..parallel.mesh import draw_rows


def get_mask_from_lengths(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, max_len] bool mask (True inside the sequence)."""
    ids = torch.arange(max_len, device=lengths.device)
    return ids[None, :] < lengths[:, None]


def get_first_over_thresh(x: torch.Tensor, threshold) -> torch.Tensor:
    """Index of the first element of each row >= ``threshold``; rows that
    never cross return the row length (an exclusive stop index)."""
    over = x >= threshold
    first = torch.argmax(over.to(torch.int8), dim=1)
    return torch.where(over.any(dim=1), first,
                       torch.full_like(first, x.shape[1]))


def dropout_frame(mels: torch.Tensor, global_mean: torch.Tensor,
                  mel_lengths: torch.Tensor, drop_frame_rate,
                  generator=None) -> torch.Tensor:
    """Replace random valid mel frames [B, T, n_mel] with the dataset's
    global mean [n_mel], each with probability ``drop_frame_rate``."""
    B, T, _ = mels.shape
    valid = get_mask_from_lengths(mel_lengths, T)
    drop = draw_rows(torch.rand, (B, T), generator=generator,
                     device=mels.device) < drop_frame_rate
    return torch.where((drop & valid)[:, :, None],
                       global_mean.to(mels.dtype)[None, None, :], mels)


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with a keep mask drawn from ``generator``."""
    keep = draw_rows(torch.rand, x.shape, generator=generator,
                     device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), 0.0)

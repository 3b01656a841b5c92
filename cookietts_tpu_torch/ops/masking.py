"""Length masks and the gate stop index (cookietts_tpu/ops/masking.py)."""
from __future__ import annotations

import torch


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

"""Alignment diagnostics for best-of-N scoring
(cookietts_tpu/ops/metrics.py: alignment_metric, weighted_score).

Focus values are in frames (attention mass per encoder token), so the
punishment thresholds (60 frames, 3.6 frames, ...) carry over unchanged.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .masking import get_mask_from_lengths

_SQRT2 = 1.4142135


def alignment_metric(alignments: torch.Tensor, input_lengths: torch.Tensor,
                     output_lengths: torch.Tensor,
                     enc_min_thresh: float = 0.7) -> Dict[str, torch.Tensor]:
    """Score attention matrices [B, T_dec, T_enc]; returns [B] tensors."""
    B, T_dec, T_enc = alignments.shape
    in_len = input_lengths.float().clamp_min(1.0)
    out_len = output_lengths.float().clamp_min(1.0)
    dec_mask = get_mask_from_lengths(output_lengths, T_dec)
    enc_mask = get_mask_from_lengths(input_lengths, T_enc)
    att = alignments.float()

    optimums = torch.sqrt(in_len ** 2 + out_len ** 2)
    values, cur_idx = att.max(dim=-1)
    cur_idx = cur_idx.float()
    prev_idx = torch.cat([cur_idx[:, :1], cur_idx[:, :-1]], dim=1)
    dist = torch.sqrt((prev_idx - cur_idx) ** 2 + 1.0)
    dist = torch.where(dec_mask, dist, 0.0)
    diagonality = (dist.sum(1) + _SQRT2) / optimums

    enc_total = torch.where(dec_mask[:, :, None], att, 0.0).sum(1)
    enc_total = torch.where(enc_mask, enc_total, 0.0)
    encoder_max_focus = enc_total.max(1).values
    encoder_avg_focus = enc_total.sum(1) / in_len
    encoder_min_focus = torch.where(enc_mask, enc_total, 1.0).min(1).values
    avg_prob = torch.where(dec_mask, values, 0.0).sum(1) / out_len
    big = torch.where(enc_mask, enc_total, 1e3)
    p_missing_enc = (big < enc_min_thresh).sum(1).float() / in_len
    return {
        "diagonalitys": diagonality,
        "avg_prob": avg_prob,
        "encoder_max_focus": encoder_max_focus,
        "encoder_min_focus": encoder_min_focus,
        "encoder_avg_focus": encoder_avg_focus,
        "p_missing_enc": p_missing_enc,
    }


def weighted_score(metrics: Dict[str, torch.Tensor],
                   text_lengths: Optional[torch.Tensor] = None,
                   mel_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention confidence minus the server's punishment terms."""
    score = metrics["avg_prob"]
    score = score - (metrics["diagonalitys"] - 1.10).clamp_min(0.0) * 0.25
    score = score - (metrics["encoder_max_focus"] - 60.0).clamp_min(0.0) * 0.005
    score = score - (0.00 - metrics["encoder_min_focus"]).clamp_min(0.0) * 0.5
    score = score - (3.60 - metrics["encoder_avg_focus"]).clamp_min(0.0)
    mis = (metrics["p_missing_enc"] - 0.08).clamp_min(0.0)
    if text_lengths is not None and mel_lengths is not None:
        cond = (text_lengths > 12) & (mel_lengths < mel_lengths.max() * 0.75)
        mis = torch.where(cond, mis, 0.0)
    return score - mis

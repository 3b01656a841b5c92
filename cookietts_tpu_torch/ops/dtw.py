"""Frame time-warp alignment of a GTA mel to its ground truth
(cookietts_tpu/ops/dtw.py).

For every frame, ``scale_factor * range_`` sub-frame shifts of the
prediction (linear interpolation) are tried and the one closest to the
target in per-frame L1 is kept, where it beats the unshifted frame. The
vocoder dataset (data/mel2samp.py) runs it on the host, so it is numpy,
on [B, T, C] arrays.
"""
from __future__ import annotations

import numpy as np


def _upsample_linear(x: np.ndarray, scale: int) -> np.ndarray:
    """[B, T, C] -> [B, T * scale, C], linear (align_corners=False)."""
    T = x.shape[1]
    pos = (np.arange(T * scale, dtype=np.float32) + np.float32(0.5)) \
        / np.float32(scale) - np.float32(0.5)
    lo = np.clip(np.floor(pos).astype(np.int64), 0, T - 1)
    hi = np.clip(lo + 1, 0, T - 1)
    w = np.clip(pos - lo.astype(np.float32), 0.0, 1.0).astype(np.float32)
    return (x[:, lo, :] * (np.float32(1.0) - w)[None, :, None]
            + x[:, hi, :] * w[None, :, None])


def dtw_align(pred: np.ndarray, target: np.ndarray, scale_factor: int = 5,
              range_: int = 3) -> np.ndarray:
    """Align ``pred`` to ``target`` frame by frame; both [B, T, C].
    ``range_`` is odd: the shifts span +-range_ // 2 frames in steps of
    1 / scale_factor frame."""
    if range_ % 2 != 1:
        raise ValueError("range_ must be an odd integer")
    pred = np.asarray(pred, np.float32)
    target = np.asarray(target, np.float32)
    if pred.shape != target.shape:
        raise ValueError(f"shapes differ: {pred.shape} {target.shape}")
    T, half = pred.shape[1], range_ // 2
    up = _upsample_linear(np.pad(pred, ((0, 0), (half, half), (0, 0))),
                          scale_factor)
    cands = np.stack([up[:, j::scale_factor][:, :T]
                      for j in range(scale_factor * range_)])  # [N, B, T, C]
    l1 = np.abs(cands - target[None]).sum(-1)                  # [N, B, T]
    base_l1 = np.abs(pred - target).sum(-1)
    best = np.argmin(l1, axis=0)
    chosen = np.take_along_axis(cands, best[None, :, :, None], axis=0)[0]
    return np.where((l1.min(0) < base_l1)[:, :, None], chosen, pred)

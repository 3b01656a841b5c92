"""Dataset curation from per-file training losses.

Rebuild of the reference's epoch-level curation machinery:

- :func:`filter_by_attention_quality` — drop files whose smoothed
  attention metrics fall below thresholds (train.py:803-825).
- :func:`mse_weighted_resample` — rebuild the filelist with per-speaker
  sampling probability proportional to the speaker's average spec_MSE
  raised to ``exp_factor`` (get_mse_sampled_filelist, train.py:323-369):
  hard speakers get oversampled, easy speakers undersampled, keeping the
  dataset length constant.
"""
from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional, Sequence


def filter_by_attention_quality(entries: Sequence[Dict[str, Any]],
                                file_losses: Dict[str, Dict[str, float]],
                                min_att_score: float = 0.5,
                                min_avg_max_attention: float = 0.45
                                ) -> List[Dict[str, Any]]:
    """Keep entries whose tracked attention quality passes the thresholds.

    Files with no loss record yet are kept (they haven't been judged).
    """
    out = []
    for e in entries:
        rec = file_losses.get(e["path"])
        if rec is None:
            out.append(e)
            continue
        if rec.get("att_score", 1.0) < min_att_score:
            continue
        if rec.get("avg_max_attention", 1.0) < min_avg_max_attention:
            continue
        out.append(e)
    return out


def mse_weighted_resample(entries: Sequence[Dict[str, Any]],
                          file_losses: Dict[str, Dict[str, float]],
                          exp_factor: float = 1.0,
                          seed: Optional[int] = None,
                          loss_key: str = "spec_MSE"
                          ) -> List[Dict[str, Any]]:
    """Per-speaker MSE-proportional resampling (train.py:323-369)."""
    # per-speaker average loss
    speaker_losses: Dict[Any, List[float]] = {}
    path_to_speaker = {e["path"]: e.get("speaker_id", e.get("speaker"))
                       for e in entries}
    for path, rec in file_losses.items():
        spk = path_to_speaker.get(path)
        if spk is None or loss_key not in rec:
            continue
        speaker_losses.setdefault(spk, []).append(float(rec[loss_key]))
    if not speaker_losses:
        return list(entries)
    speaker_avg = {s: sum(v) / len(v) for s, v in speaker_losses.items()}

    # per-speaker file pools, shuffled deterministically
    pools: Dict[Any, List[Dict[str, Any]]] = {}
    for e in entries:
        pools.setdefault(e.get("speaker_id", e.get("speaker")),
                         []).append(e)
    for pool in pools.values():
        random.Random(seed).shuffle(pool)

    out: List[Dict[str, Any]] = []
    # speakers with NO loss record yet keep their files unchanged: the
    # rebuilt list feeds the NEXT epoch's curation (cli), so dropping
    # them here would be irreversible — they could never earn a record
    # again (filter_by_attention_quality keeps unjudged files for the
    # same reason)
    for spk, pool in pools.items():
        if spk not in speaker_avg:
            out.extend(pool)
    n_target = len(entries) - len(out)     # judged share of the length
    total = sum(v ** exp_factor for v in speaker_avg.values())
    for spk, avg in speaker_avg.items():
        pool = pools.get(spk, [])
        if not pool or total <= 0:
            continue
        # every judged speaker keeps at least one file — rounding an
        # easy speaker to zero would also permanently drop it
        n_files = max(1, round((avg ** exp_factor) / total * n_target))
        if len(pool) < n_files:
            pool = pool * math.ceil(n_files / len(pool))
        out.extend(pool[:n_files])
    return out

"""Live (hot-reload) training config overlay.

Capability rebuild of the reference's ``run_every_epoch.py`` mechanism
(CookieTTS/_2_ttm/tacotron2_tm/train.py:644-661): a watched Python file is
re-evaluated every few iterations, letting the user change LR schedule,
loss weights, drop-frame-rate, grad clip, validation cadence etc. WITHOUT
restarting training.

Differences from the reference:
- the file is exec'd into an isolated namespace exposing the loop
  variables (iteration, epoch, ...) read-only — not into the trainer's
  locals;
- reload only happens when the file's mtime changes (no 5-iteration
  re-exec cost);
- a parse error keeps the previous good config instead of crashing.

Also provides :func:`piecewise_warmup_decay_lr`, the reference's
A_/B_/C_-parameter exponential-decay-with-warmup schedule
(run_every_epoch.py:1-80).
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional


DEFAULT_LIVE_CONFIG: Dict[str, Any] = {
    # LR schedule (A=peak, B=decay time-constant in iters, C=offset)
    "A_": 1e-3, "B_": 40000.0, "C_": 0.0,
    "warmup_start": 0, "warmup_end": 1000, "warmup_start_lr": 0.5e-3,
    "decay_start": 40000,
    # stability
    "grad_clip_thresh": 1.0,
    "LossExplosionThreshold": 1e3,
    # regularization
    "drop_frame_rate": 0.25,
    "guided_att_sigma": 0.5,
    "p_teacher_forcing": 1.0,
    "teacher_force_till": 20,
    "val_p_teacher_forcing": 0.8,
    "val_teacher_force_till": 20,
    # cadence
    "validation_interval": 1000,
    "checkpoint_interval": 5000,
    # epoch-boundary dataset curation (reference train.py:803-825)
    "curation_enable": True,
    "curation_min_att_score": 0.5,
    "curation_min_avg_max_attention": 0.45,
    "curation_mse_exponent": 1.0,
    # loss scalars (merged over losses.DEFAULT_LOSS_SCALARS)
    "loss_scalars": {},
}


def piecewise_warmup_decay_lr(iteration: int, cfg: Dict[str, Any]) -> float:
    """The reference's live LR rule: linear warmup to A_, flat, then
    exponential decay with time constant B_ toward offset C_."""
    A = float(cfg.get("A_", 1e-3))
    B = float(cfg.get("B_", 40000.0))
    C = float(cfg.get("C_", 0.0))
    w0 = int(cfg.get("warmup_start", 0))
    w1 = int(cfg.get("warmup_end", 0))
    w_lr = float(cfg.get("warmup_start_lr", A))
    d0 = int(cfg.get("decay_start", 40000))
    if w1 > w0 and iteration < w1:
        t = max(iteration - w0, 0) / max(w1 - w0, 1)
        return w_lr + (A - w_lr) * t
    if iteration < d0:
        return A
    return A * math.exp(-(iteration - d0) / B) + C


class LiveConfig:
    """Watched-file overlay over DEFAULT_LIVE_CONFIG."""

    def __init__(self, path: Optional[str] = None,
                 defaults: Optional[Dict[str, Any]] = None):
        self.path = path
        self.values: Dict[str, Any] = dict(defaults or DEFAULT_LIVE_CONFIG)
        self._mtime: float = -1.0
        # a file whose expressions read `iteration`/`epoch` is re-exec'd
        # on EVERY poll (the reference exec's run_every_epoch.py every 5
        # iterations, train.py:646-661, precisely so schedules over the
        # loop variables stay live); static files only re-exec on mtime
        # change
        self._dynamic: bool = False
        # first read runs with the documented loop variables defaulted:
        # a file using `iteration` (the reference run_every_epoch style)
        # would otherwise NameError here, record its mtime in the error
        # handler, and never be retried by the in-loop polls
        self.poll({"iteration": 0, "epoch": 0})

    def poll(self, context: Optional[Dict[str, Any]] = None) -> bool:
        """Re-exec the file if it changed (always, for files that use the
        loop variables). Returns True on reload."""
        if not self.path or not os.path.exists(self.path):
            return False
        mtime = os.path.getmtime(self.path)
        if mtime == self._mtime and not self._dynamic:
            return False
        ns: Dict[str, Any] = {"iteration": 0, "epoch": 0}
        ns.update(context or {})
        ns.update({"math": math})
        code = ""
        try:
            with open(self.path) as f:
                code = f.read()
            exec(compile(code, self.path, "exec"), ns)  # noqa: S102
        except Exception as e:  # keep previous good config
            if mtime != self._mtime:     # print once per file version
                print(f"[live_config] parse error in {self.path}: {e!r} "
                      f"— keeping previous values")
            self._mtime = mtime
            # a schedule over the loop variables may raise only at one
            # boundary iteration (e.g. a division that hits zero once);
            # keep re-exec'ing it so a transient error cannot silently
            # freeze the schedule for the rest of the run
            self._dynamic = ("iteration" in code) or ("epoch" in code)
            return False
        self._mtime = mtime
        self._dynamic = ("iteration" in code) or ("epoch" in code)
        for k in list(self.values):
            if k in ns:
                self.values[k] = ns[k]
        return True

    def __getitem__(self, k):
        return self.values[k]

    def get(self, k, default=None):
        return self.values.get(k, default)

    def lr(self, iteration: int) -> float:
        return piecewise_warmup_decay_lr(iteration, self.values)


class LossExplosion(Exception):
    """Raised when loss exceeds the live threshold or goes NaN — the train
    loop reloads best_val_model and continues with decayed LR
    (reference train.py:40-42,732-736,831-851)."""

"""Checkpoint save / resume / warm start (cookietts_tpu/runtime/checkpoint.py).

- three checkpoint classes in a run directory: periodic ``checkpoint_<step>``
  (the last ``keep_last`` kept), ``best_val_model`` (lowest validation
  loss) and ``best_inf_attsc`` (best free-running attention score);
- full resume (``restore_train_state``: the model's state dict, the Adam
  moments and the step) and ``warm_start`` (the model's weights only,
  shape-filtered, with ``ignore_layers``);
- a manual save trigger: a file named ``save`` in the run directory.

Format: ``torch.save`` of {"step", "state_dict", "opt_state"} (and the
trainer's generator state in periodic checkpoints). The state
dict keeps the reference CookieTTS key names (every parameter and buffer,
the frozen LSTM biases and the BatchNorm statistics included); metadata
(model kind and config, speakers, audio frontend, best losses, restarts)
goes to a JSON sidecar ``<path>.json``. Writes go through a temporary file
and a rename, so a reader never sees a partial file.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from .optim import AdamState


def save_checkpoint(path: str, tree: Dict[str, Any],
                    metadata: Optional[Dict[str, Any]] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)
    if metadata is not None:
        jtmp = path + ".json.tmp"
        with open(jtmp, "w") as f:
            json.dump(metadata, f, indent=1, default=str)
        os.replace(jtmp, path + ".json")


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], Optional[Dict]]:
    tree = torch.load(path, map_location="cpu", weights_only=True)
    meta = None
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return tree, meta


def restore_train_state(state, path: str,
                        generator: Optional[torch.Generator] = None):
    """Full resume into ``state`` (a TrainState), in place: the model's
    state dict (strict), the optimizer moments and the step; and the state
    of ``generator`` where the checkpoint saved one. Returns (state,
    metadata)."""
    tree, meta = load_checkpoint(path)
    if generator is not None and "generator" in tree:
        generator.set_state(tree["generator"])
    state.model.load_state_dict(tree["state_dict"])
    opt = tree.get("opt_state")
    if opt is not None:
        like = state.opt_state.mu
        if set(opt["mu"]) != set(like):
            raise ValueError(f"{path}: optimizer moments for "
                             f"{sorted(set(opt['mu']) ^ set(like))} do not "
                             "match the model's trainable parameters")
        to = lambda d: {k: d[k].to(like[k].device, like[k].dtype)  # noqa: E731
                        for k in like}
        state.opt_state = AdamState(int(opt["step"]), to(opt["mu"]),
                                    to(opt["nu"]))
    state.step = int(tree.get("step", state.step))
    return state, meta


def warm_start(target: Dict[str, torch.Tensor],
               restored: Dict[str, torch.Tensor],
               ignore_layers: Sequence[str] = ()
               ) -> Tuple[Dict[str, torch.Tensor], int, int]:
    """Partial restore of a state dict: take ``restored``'s entry where the
    name exists and the shape matches, keep ``target``'s elsewhere and for
    names containing any of ``ignore_layers``. Returns (state_dict,
    loaded, skipped)."""
    out, loaded, skipped = dict(target), 0, 0
    for k, v in target.items():
        if any(ig in k for ig in ignore_layers):
            skipped += 1
            continue
        r = restored.get(k)
        if r is not None and tuple(r.shape) == tuple(v.shape):
            out[k] = r.to(v.dtype)
            loaded += 1
        else:
            skipped += 1
    return out, loaded, skipped


class Checkpointer:
    """Run-directory checkpoint manager with best-model tracking; writes
    are synchronous."""

    def __init__(self, run_dir: str, keep_last: int = 3):
        self.run_dir = run_dir
        self.keep_last = keep_last
        os.makedirs(run_dir, exist_ok=True)
        self.best_val_loss = float("inf")
        self.best_inf_attsc = float("-inf")

    def save_periodic(self, step: int, tree, metadata=None) -> str:
        path = os.path.join(self.run_dir, f"checkpoint_{step}")
        save_checkpoint(path, tree, metadata)
        self._gc()
        return path

    def _periodic(self):
        return [f for f in os.listdir(self.run_dir)
                if f.startswith("checkpoint_") and f.split("_", 1)[1].isdigit()]

    def _gc(self):
        for f in sorted(self._periodic(),
                        key=lambda f: int(f.split("_")[1]))[:-self.keep_last]:
            for suffix in ("", ".json"):
                p = os.path.join(self.run_dir, f + suffix)
                if os.path.exists(p):
                    os.remove(p)

    def maybe_save_best_val(self, val_loss: float, tree, metadata=None) -> bool:
        if val_loss < self.best_val_loss:
            self.best_val_loss = val_loss
            metadata = {**(metadata or {}), "best_val_loss": val_loss}
            save_checkpoint(os.path.join(self.run_dir, "best_val_model"),
                            tree, metadata)
            return True
        return False

    def maybe_save_best_attsc(self, att_score: float, tree,
                              metadata=None) -> bool:
        if att_score > self.best_inf_attsc:
            self.best_inf_attsc = att_score
            metadata = {**(metadata or {}), "best_inf_attsc": att_score}
            save_checkpoint(os.path.join(self.run_dir, "best_inf_attsc"),
                            tree, metadata)
            return True
        return False

    def manual_save_requested(self) -> bool:
        trigger = os.path.join(self.run_dir, "save")
        if os.path.exists(trigger):
            try:
                os.remove(trigger)
            except FileNotFoundError:
                return False
            return True
        return False

    def latest(self) -> Optional[str]:
        cks = self._periodic()
        if not cks:
            return None
        return os.path.join(self.run_dir,
                            max(cks, key=lambda f: int(f.split("_")[1])))

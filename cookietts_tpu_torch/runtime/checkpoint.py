"""Checkpoint save / resume / warm start (cookietts_tpu/runtime/checkpoint.py).

- three checkpoint classes in a run directory: periodic ``checkpoint_<step>``
  (the last ``keep_last`` kept), ``best_val_model`` (lowest validation
  loss) and ``best_inf_attsc`` (best free-running attention score);
- full resume (``restore_train_state``: the model's state dict, the Adam
  moments and the step) and ``warm_start`` (the model's weights only,
  shape-filtered, with ``ignore_layers``);
- a manual save trigger: a file named ``save`` in the run directory.

Under a data-parallel group one rank writes (``Checkpointer(writer=...)``,
rank 0): the parameters are the same on every rank, and writers of one run
directory would race on the same temporary file. Under tensor parallelism
the tree it writes is the gathered, full one (runtime/train_state.py).

``Checkpointer(async_save=True)`` writes in the background
(cookietts_tpu/runtime/checkpoint.py:315-360): the caller hands over a host
snapshot it does not touch again (the Trainer's ``to_host_tree()``, a fresh
copy taken at the step), then ``torch.save`` and the rename run on one
thread, one save in flight at a time; ``wait()`` and the process's exit
drain it, and a failed save raises once, at ``wait()``.

Format: ``torch.save`` of {"step", "state_dict", "opt_state"} (and the
trainer's generator state in periodic checkpoints; a GAN's discriminators
under "d_state_dict" and "d_opt_state"). The state
dict keeps the reference CookieTTS key names (every parameter and buffer,
the frozen LSTM biases and the BatchNorm statistics included); metadata
(model kind and config, speakers, audio frontend, best losses, restarts)
goes to a JSON sidecar ``<path>.json``. Writes go through a temporary file
and a rename, so a reader never sees a partial file.
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree

from ..parallel.tp import layout_of
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
    """Full resume into ``state`` (a TrainState or a GANTrainState), in
    place: the model's state dict (strict), the optimizer moments and the
    step, for both sides of a GAN; and the state of ``generator`` where the
    checkpoint saved one. Returns (state, metadata)."""
    tree, meta = load_checkpoint(path)
    if generator is not None and "generator" in tree:
        generator.set_state(tree["generator"])
    if hasattr(state, "d"):                       # a GANTrainState
        if "d_state_dict" not in tree:
            raise SystemExit(f"{path} has no discriminator state; use "
                             "--warm_start for a generator-only load")
        _restore(state.g, tree["state_dict"], tree.get("opt_state"), path)
        if not tree["d_state_dict"] and state.d.params:
            # a stage promotion (the HiFi-GAN denoiser): a pre-adversarial
            # checkpoint has no critics yet; they start fresh
            print("[resume] checkpoint has no critic state (pre-adversarial "
                  "stage); discriminators start fresh")
        else:
            _restore(state.d, tree["d_state_dict"], tree.get("d_opt_state"),
                     path)
        state.g.step = state.d.step = int(tree.get("step", state.step))
        return state, meta
    _restore(state, tree["state_dict"], tree.get("opt_state"), path)
    state.step = int(tree.get("step", state.step))
    return state, meta


def _restore(state, state_dict, opt, path: str) -> None:
    """A full (reference-layout) tree into ``state``: under tp each rank
    takes its shards of it, whatever N the checkpoint was written at."""
    layout = layout_of(state.model)
    local = (lambda d: d) if layout is None else layout.shard
    state.model.load_state_dict(local(state_dict))
    if opt is not None:
        like = state.opt_state.mu
        if set(opt["mu"]) != set(like):
            raise ValueError(f"{path}: optimizer moments for "
                             f"{sorted(set(opt['mu']) ^ set(like))} do not "
                             "match the model's trainable parameters")
        to = lambda d: {k: v.to(like[k].device, like[k].dtype)  # noqa: E731
                        for k, v in local({k: d[k] for k in like}).items()}
        state.opt_state = AdamState(int(opt["step"]), to(opt["mu"]),
                                    to(opt["nu"]))


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
    """Run-directory checkpoint manager with best-model tracking. A
    Checkpointer that is not the ``writer`` tracks the best losses and
    writes nothing (its trees may be None). With ``async_save`` the writer
    writes each tree, a host snapshot that is now its own, on a background
    thread."""

    def __init__(self, run_dir: str, keep_last: int = 3, writer: bool = True,
                 async_save: bool = False):
        self.run_dir = run_dir
        self.keep_last = keep_last
        self.writer = writer
        os.makedirs(run_dir, exist_ok=True)
        self.best_val_loss = float("inf")
        self.best_inf_attsc = float("-inf")
        self._executor = self._pending = None
        if async_save and writer:
            import atexit
            import weakref
            from concurrent.futures import ThreadPoolExecutor
            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt-save")
            # a weak reference: the exit hook must not keep the
            # Checkpointer alive, and a save failing at exit warns
            ref = weakref.ref(self)

            def _drain():
                obj = ref()
                if obj is not None:
                    try:
                        obj.wait()
                    except Exception as e:
                        print(f"[checkpoint] async save failed at exit: {e}")

            atexit.register(_drain)

    def wait(self) -> None:
        """Block until the save in flight is on disk. A failed save raises
        here, once: the pending save is cleared first."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def _save(self, path: str, tree, metadata,
              after: Optional[Callable[[], None]] = None) -> None:
        if not self.writer:
            return
        if self._executor is None:
            save_checkpoint(path, tree, metadata)
            if after is not None:
                after()
            return
        assert all(x.device.type == "cpu" for x in pytree.tree_leaves(tree)
                   if torch.is_tensor(x)), "async saves take a host snapshot"
        self.wait()      # one save in flight

        def job():
            save_checkpoint(path, tree, metadata)
            if after is not None:
                after()

        self._pending = self._executor.submit(job)

    def save_periodic(self, step: int, tree, metadata=None) -> str:
        path = os.path.join(self.run_dir, f"checkpoint_{step}")
        self._save(path, tree, metadata, after=self._gc)
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
            self._save(os.path.join(self.run_dir, "best_val_model"), tree,
                       metadata)
            return True
        return False

    def maybe_save_best_attsc(self, att_score: float, tree,
                              metadata=None) -> bool:
        if att_score > self.best_inf_attsc:
            self.best_inf_attsc = att_score
            metadata = {**(metadata or {}), "best_inf_attsc": att_score}
            self._save(os.path.join(self.run_dir, "best_inf_attsc"), tree,
                       metadata)
            return True
        return False

    def manual_save_requested(self) -> bool:
        if not self.writer:
            return False
        trigger = os.path.join(self.run_dir, "save")
        if os.path.exists(trigger):
            try:
                os.remove(trigger)
            except FileNotFoundError:
                return False
            return True
        return False

    def latest(self) -> Optional[str]:
        self.wait()
        cks = self._periodic()
        if not cks:
            return None
        return os.path.join(self.run_dir,
                            max(cks, key=lambda f: int(f.split("_")[1])))

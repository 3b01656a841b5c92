"""The Tacotron2 training loop (cookietts_tpu/runtime/trainer.py:39-712).

- the train step: the teacher-forced forward in training mode, the loss,
  backward, clipping by the global norm and an Adam step, in place;
  learning rate, teacher forcing, drop-frame and the loss weights come from
  the live config every iteration;
- TBPTT: the decoder state of one iteration feeds the next (detached);
  lanes whose ``pres_prev_state`` is 0 restart from a fresh state inside the
  model;
- loss explosion (above the live threshold, or not finite) reloads
  ``best_val_model`` and decays the LR by 2^(n_restarts / 3);
- validation on the live config's cadence, teacher-forced AND free-running
  (the attention-score checkpoint follows the free-running score), each
  batch with its own seeded generator;
- per-file losses feed the FileLossDB for dataset curation.

Single process; the multi-host and tensor-parallel branches of the JAX
trainer wait for the parallel runtime. Validation images are not logged.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..losses import DEFAULT_LOSS_SCALARS, tacotron2_loss
from ..ops.metrics import alignment_metric, weighted_score
from .checkpoint import Checkpointer, restore_train_state
from .live_config import LiveConfig, LossExplosion
from .logging_util import FileLossDB, MetricsLogger
from .optim import AdamState, clip_by_global_norm
from .train_state import TrainState

_INT_KEYS = ("text", "text_lengths", "mel_lengths", "speaker_id")


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


def _model_inputs(batch):
    return dict(text=batch["text"], text_lengths=batch["text_lengths"],
                mels=batch["mels"], mel_lengths=batch["mel_lengths"],
                speaker_id=batch["speaker_id"], sylps=batch["sylps"],
                torchmoji_hidden=batch.get("torchmoji"))


def _targets(batch):
    return {k: batch[k] for k in ("mels", "mel_lengths", "text_lengths",
                                  "sylps", "gate_target")}


def make_tacotron2_train_step(model, gate_positive_weight: float = 10.0,
                              guided_att_sigma: float = 0.5) -> Callable:
    """step(state, batch, generator, ctrl, carry=None) ->
    (state, metrics, file_losses, carry). ``batch`` holds tensors on the
    model's device; ``ctrl`` the live values: lr, grad_clip,
    p_teacher_forcing, teacher_force_till, drop_frame_rate,
    guided_att_sigma and the loss weights. The state is updated in place."""

    def step(state: TrainState, batch, generator, ctrl, carry=None):
        model.train()
        out, new_carry = model(
            **_model_inputs(batch), generator=generator,
            p_teacher_forcing=ctrl["p_teacher_forcing"],
            teacher_force_till=ctrl["teacher_force_till"],
            drop_frame_rate=ctrl["drop_frame_rate"],
            global_mean=batch.get("global_mean"), init_carry=carry,
            pres_prev_state=(batch.get("pres_prev_state")
                             if carry is not None else None))
        gt = _targets(batch)
        gt["pres_prev_state"] = batch.get(
            "pres_prev_state", torch.zeros_like(batch["sylps"]))
        weights = {k: ctrl[k] for k in DEFAULT_LOSS_SCALARS if k in ctrl}
        total, loss_dict, file_losses = tacotron2_loss(
            out, gt, weights, gate_positive_weight,
            ctrl.get("guided_att_sigma", guided_att_sigma))
        params = state.params
        grads = torch.autograd.grad(total, list(params.values()),
                                    allow_unused=True)
        grads, grad_norm = clip_by_global_norm(dict(zip(params, grads)),
                                               ctrl["grad_clip"])
        state.apply_gradients(grads, ctrl["lr"])
        loss_dict = {k: v.detach() for k, v in loss_dict.items()}
        loss_dict["grad_norm"] = grad_norm
        return (state, loss_dict, file_losses,
                pytree.tree_map(torch.Tensor.detach, new_carry))

    step.carries_state = True
    return step


def make_tacotron2_eval_step(model, gate_positive_weight: float = 10.0
                             ) -> Callable:
    """Teacher-forced validation step in eval form, at full teacher
    forcing whatever the live schedule says (so val_loss stays comparable
    across the run). Returns (loss_dict, file_losses, outputs)."""

    @torch.no_grad()
    def step(state: TrainState, batch, generator, ctrl):
        del ctrl
        model.eval()
        out, _ = model(**_model_inputs(batch), generator=generator)
        _, loss_dict, file_losses = tacotron2_loss(
            out, _targets(batch), gate_positive_weight=gate_positive_weight)
        images = {k: out[k] for k in ("alignments", "mel_outputs_postnet",
                                      "gate_outputs")}
        return loss_dict, file_losses, images

    return step


def make_tacotron2_inference_eval_step(model) -> Callable:
    """Free-running validation step: decodes ``batch['mels'].shape[1]``
    steps and scores the alignments with the gate-derived lengths.
    Returns (loss_dict{inf_weighted_score, inf_diagonality,
    inf_avg_max_attention, inf_gate_fired, inf_len_abs_err},
    file_losses{inf_att_score}, outputs)."""

    def step(state: TrainState, batch, generator, ctrl):
        del ctrl
        out = model.inference(
            batch["text"], batch["text_lengths"], batch["speaker_id"],
            batch.get("torchmoji"), sylps=batch["sylps"], generator=generator,
            max_decoder_steps=int(batch["mels"].shape[1]))
        lengths = out["mel_lengths"]
        atd = alignment_metric(out["alignments"], batch["text_lengths"],
                               lengths)
        scores = weighted_score(atd, batch["text_lengths"], lengths)
        T_dec = out["alignments"].shape[1]
        loss_dict = {
            "inf_weighted_score": scores.mean(),
            "inf_diagonality": atd["diagonalitys"].mean(),
            "inf_avg_max_attention": atd["avg_prob"].mean(),
            # lanes whose gate fired before the step budget
            "inf_gate_fired": (lengths < T_dec).float().mean(),
            # |predicted - ground-truth| length, in frames
            "inf_len_abs_err": (lengths.float()
                                - batch["mel_lengths"].float()).abs().mean(),
        }
        images = {k: out[k] for k in ("alignments", "mel_outputs_postnet",
                                      "gate_outputs")}
        return loss_dict, {"inf_att_score": scores}, images

    return step


def adapt_carry(carry, t_enc: int, batch_size: int):
    """Fit a TBPTT carry to this batch's shapes: lanes past ``batch_size``
    are dropped and new ones zero-filled (a fresh lane's state); attention
    weights over the text axis are truncated or zero-padded to ``t_enc``,
    keeping the common prefix."""
    if carry is None:
        return None
    b_old = carry.state.attention.weights.shape[0]
    if b_old != batch_size:
        def fit(x):
            if x.dim() == 0 or x.shape[0] != b_old:
                return x
            if b_old > batch_size:
                return x[:batch_size]
            pad = x.new_zeros((batch_size - b_old,) + tuple(x.shape[1:]))
            return torch.cat([x, pad])
        carry = pytree.tree_map(fit, carry)
    att = carry.state.attention
    if att.weights.shape[1] == t_enc:
        return carry

    def resize(x):
        if x.shape[1] >= t_enc:
            return x[:, :t_enc]
        return torch.cat([x, x.new_zeros(x.shape[0], t_enc - x.shape[1])], 1)

    att = att._replace(weights=resize(att.weights),
                       weights_cum=resize(att.weights_cum))
    return carry._replace(state=carry.state._replace(attention=att))


def align_file_losses(paths, file_losses) -> Dict[str, np.ndarray]:
    """Per-file loss rows as numpy, paired with ``paths`` (one process: the
    batch's rows are all this process's)."""
    out = {k: v.detach().cpu().numpy() for k, v in file_losses.items()}
    rows = len(next(iter(out.values())))
    if rows != len(paths):
        raise ValueError(f"{rows} per-file rows for {len(paths)} paths")
    return out


@dataclasses.dataclass
class TrainerConfig:
    run_dir: str = "runs/default"
    live_config_path: Optional[str] = None
    log_every: int = 10
    seed: int = 1234
    n_restarts_max: int = 10
    # a torch.profiler trace of iterations [profile_start, profile_stop),
    # written to run_dir/profile/trace.json
    profile_start: Optional[int] = None
    profile_stop: Optional[int] = None


class Trainer:
    """Iteration orchestration: live config, explosion recovery, validation
    cadence, checkpoints, curation statistics."""

    def __init__(self, cfg: TrainerConfig, state: TrainState,
                 train_step: Callable, eval_step: Optional[Callable] = None,
                 val_batches=None, inference_eval_step: Optional[Callable] = None,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.state = state
        self.train_step = train_step
        self.eval_step = eval_step
        self.inference_eval_step = inference_eval_step
        self.val_batches = val_batches
        self.device = torch.device(device)
        self.live = LiveConfig(cfg.live_config_path)
        self.ckpt = Checkpointer(cfg.run_dir)
        self.logger = MetricsLogger(cfg.run_dir)
        self.file_db = FileLossDB()
        self.n_restarts = 0
        self.default_metadata: Dict[str, Any] = {}   # stamped on every ckpt
        self.generator = torch.Generator(self.device).manual_seed(cfg.seed)
        # the explosion fallback when no best_val_model exists yet
        self._init_params = {k: v.detach().cpu().clone()
                             for k, v in state.params.items()}
        self.carry = None            # TBPTT decoder state across iterations
        self._iter_time_ema = None
        self._profiler = None

    def resume(self, path: Optional[str] = None) -> int:
        """Full resume (model, optimizer, step, the generator's state) from
        ``path`` or the latest periodic checkpoint. Returns the step."""
        path = path or self.ckpt.latest()
        if path is None:
            print("[trainer] no checkpoint to resume from; starting fresh")
            return 0
        self.state, meta = restore_train_state(self.state, path,
                                               self.generator)
        if meta:
            self.ckpt.best_val_loss = float(
                meta.get("best_val_loss", self.ckpt.best_val_loss))
            self.ckpt.best_inf_attsc = float(
                meta.get("best_inf_attsc", self.ckpt.best_inf_attsc))
            self.n_restarts = int(meta.get("n_restarts", self.n_restarts))
        print(f"[trainer] resumed from {path} at step {self.state.step}")
        return int(self.state.step)

    def ctrl(self, iteration: int) -> Dict[str, float]:
        live = self.live.values
        lr = self.live.lr(iteration) / (2.0 ** (self.n_restarts / 3.0))
        ctrl = {
            "lr": lr,
            "grad_clip": float(live.get("grad_clip_thresh", 1.0)),
            "p_teacher_forcing": float(live.get("p_teacher_forcing", 1.0)),
            "teacher_force_till": int(live.get("teacher_force_till", 20)),
            "drop_frame_rate": float(live.get("drop_frame_rate", 0.0)),
            "guided_att_sigma": float(live.get("guided_att_sigma", 0.5)),
        }
        weights = dict(DEFAULT_LOSS_SCALARS)
        weights.update(live.get("loss_scalars", {}))
        ctrl.update({k: float(v) for k, v in weights.items()})
        return ctrl

    def _maybe_profile(self, it: int) -> None:
        """Start / stop a torch.profiler trace around the configured
        iteration window (run_dir/profile/trace.json, Chrome format)."""
        cfg = self.cfg
        if cfg.profile_start is None:
            return
        if self._profiler is None and it == cfg.profile_start:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
            self._profiler = profile(activities=acts)
            self._profiler.__enter__()
        elif self._profiler is not None and (cfg.profile_stop is None
                                             or it >= cfg.profile_stop):
            self._profiler.__exit__(None, None, None)
            out = os.path.join(cfg.run_dir, "profile")
            os.makedirs(out, exist_ok=True)
            self._profiler.export_chrome_trace(os.path.join(out, "trace.json"))
            self._profiler = None

    def step(self, batch: Dict[str, Any]) -> Dict[str, float]:
        t_start = time.perf_counter()
        it = int(self.state.step)
        self._maybe_profile(it)
        if it % 5 == 0:
            self.live.poll({"iteration": it})
        ctrl = self.ctrl(it)
        paths = batch.get("audiopath")
        dev = batch_to_device(batch, self.device)
        carry = adapt_carry(self.carry, int(dev["text"].shape[1]),
                            int(dev["text"].shape[0]))
        state, loss_dict, file_losses, new_carry = self.train_step(
            self.state, dev, self.generator, ctrl, carry)

        loss = float(loss_dict["loss"])
        thresh = float(self.live.get("LossExplosionThreshold", 1e3))
        if not np.isfinite(loss) or loss > thresh:
            self.carry = None    # fresh decoder states after a blowup
            self._recover(loss)
            return {"loss": loss, "exploded": 1.0}

        self.state = state
        self.carry = new_carry
        if paths is not None and file_losses:
            self.file_db.update(paths, align_file_losses(paths, file_losses))
        metrics = {k: float(v) for k, v in loss_dict.items()}
        dt = time.perf_counter() - t_start
        self._iter_time_ema = (dt if self._iter_time_ema is None
                               else 0.95 * self._iter_time_ema + 0.05 * dt)
        if it % self.cfg.log_every == 0:
            metrics["lr"] = ctrl["lr"]
            metrics["s_per_iter"] = self._iter_time_ema   # smoothed
            metrics["iter_s"] = dt                        # this iteration
            self.logger.log_scalars(it, metrics)
        hi = int(self.live.get("histogram_interval", 20000) or 0)
        if hi > 0 and int(self.state.step) % hi == 0:
            self.logger.log_histograms(
                int(self.state.step),
                {k: v.detach().cpu().numpy()
                 for k, v in self.state.params.items()})
        if self.ckpt.manual_save_requested():
            self.save(periodic=True)

        it_now = int(self.state.step)
        vi = int(self.live.get("validation_interval", 0) or 0)
        if (self.eval_step is not None and self.val_batches
                and vi > 0 and it_now % vi == 0):
            means = self.validate(self.val_batches, iteration=it_now)
            att_score = means.get("val_weighted_score")
            if self.inference_eval_step is not None:
                inf = self.validate(self.val_batches, iteration=it_now,
                                    step_fn=self.inference_eval_step,
                                    prefix="validation_inf")
                att_score = inf.get("val_inf_weighted_score", att_score)
            self.save(periodic=False, val_loss=means.get("val_loss"),
                      att_score=att_score)
        ci = int(self.live.get("checkpoint_interval", 0) or 0)
        if ci > 0 and it_now % ci == 0:
            self.save(periodic=True)
        return metrics

    def _recover(self, loss: float) -> None:
        """Reload best_val_model (model, optimizer, step) and decay the LR;
        without one, go on from the updated state, or restart from the
        initial parameters with fresh moments if the update left them not
        finite."""
        self.n_restarts += 1
        if self.n_restarts > self.cfg.n_restarts_max:
            raise LossExplosion(
                f"loss {loss} exploded {self.n_restarts} times; giving up")
        best = os.path.join(self.cfg.run_dir, "best_val_model")
        if os.path.exists(best):
            self.state, _ = restore_train_state(self.state, best)
        elif not all(bool(torch.isfinite(p).all())
                     for p in self.state.params.values()):
            self._reset_to_initial()
            print("[trainer] non-finite params with no best checkpoint; "
                  "reset to initial params")
        print(f"[trainer] LossExplosion (loss={loss}); restart "
              f"#{self.n_restarts}, lr decay 2^{self.n_restarts}/3")

    @torch.no_grad()
    def _reset_to_initial(self) -> None:
        for k, p in self.state.params.items():
            p.copy_(self._init_params[k])
        opt = self.state.opt_state
        zeros = lambda d: {k: torch.zeros_like(v) for k, v in d.items()}  # noqa: E731
        self.state.opt_state = AdamState(0, zeros(opt.mu), zeros(opt.nu))

    def save(self, periodic=True, val_loss: Optional[float] = None,
             att_score: Optional[float] = None, metadata=None) -> None:
        tree = self.state.to_host_tree()
        metadata = {**self.default_metadata, **(metadata or {})}
        metadata.setdefault("best_val_loss", self.ckpt.best_val_loss)
        metadata.setdefault("best_inf_attsc", self.ckpt.best_inf_attsc)
        metadata.setdefault("n_restarts", self.n_restarts)
        if periodic:
            # with the generator, so a resume draws what the run would have
            self.ckpt.save_periodic(int(self.state.step), {
                **tree, "generator": self.generator.get_state()}, metadata)
        if val_loss is not None:
            self.ckpt.maybe_save_best_val(val_loss, tree, metadata)
        if att_score is not None:
            self.ckpt.maybe_save_best_attsc(att_score, tree, metadata)

    def validate(self, batches, iteration: Optional[int] = None,
                 step_fn: Optional[Callable] = None,
                 prefix: str = "validation") -> Dict[str, float]:
        """Seeded, reproducible validation over an iterable of batches:
        batch i draws from a generator seeded with ``seed + i``.
        ``step_fn`` defaults to the teacher-forced eval step."""
        step_fn = step_fn or self.eval_step
        it = iteration if iteration is not None else int(self.state.step)
        ctrl = self.ctrl(it)
        agg: Dict[str, list] = {}
        for i, batch in enumerate(batches):
            gen = torch.Generator(self.device).manual_seed(self.cfg.seed + i)
            paths = batch.get("audiopath")
            loss_dict, file_losses, _ = step_fn(
                self.state, batch_to_device(batch, self.device), gen, ctrl)
            if paths is not None and file_losses:
                self.file_db.update(paths,
                                    align_file_losses(paths, file_losses))
            for k, v in loss_dict.items():
                agg.setdefault(k, []).append(float(v))
        means = {f"val_{k}": float(np.mean(v)) for k, v in agg.items()}
        self.logger.log_scalars(it, means, prefix=prefix)
        return means

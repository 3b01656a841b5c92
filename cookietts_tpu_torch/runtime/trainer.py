"""The training loop (cookietts_tpu/runtime/trainer.py) and the steps it
drives: Tacotron2's, UnTTS's (the decoder flow NLL and the predictors'
MSEs), the adversarial ones (a discriminator then a generator step each
iteration, ``make_gan_trainer_step``: HiFi-GAN's, the GAN postnet's, the
staged HiFi-GAN denoiser's and GAN-TTS's) and the flow vocoders' (the flow
NLL; validation through the inverse).

A step is ``step(state, batch, generator, ctrl) -> (state, metrics)``; a
step marked ``carries_state`` (Tacotron2's) takes and returns the TBPTT
carry too, with per-file losses. For Tacotron2:

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

For every model: loss explosion recovery restores every side of the state
(G and D of a GAN), a ``ReduceLROnPlateau`` (``TrainerConfig.plateau``,
the vocoders') stepped with each validation's loss scales the live LR, and
its scale rides the checkpoints' metadata.

Data parallel across processes (parallel/): each step factory takes a
``dp`` (a :class:`~cookietts_tpu_torch.parallel.DataParallel`), runs its
forwards in the group's scope (BatchNorm statistics and row draws over the
global batch), makes its loss terms this rank's parts of the global batch's
terms and sums the gradients over the group before clipping; the metrics
are the global values, equal on every rank, so every rank takes the same
branch of the explosion test. The Trainer's rank 0 reads the live config
and the manual-save trigger and broadcasts them, and alone writes
checkpoints and logs (the others wait at a barrier after each save); every
rank's generator has one state, from the seed, since every draw is made at
the global batch's shape (parallel/mesh.py: draw_rows). Without a group
every path is the one-process one.

Tensor parallel (parallel/tp.py): a model sharded over a tp group trains
its shards with the same steps (the gradients of the sharded weights are
this rank's, those of the replicated ones whole on every rank through the
conjugate collectives; the global norm sums the shards over the group);
``save`` gathers the full tree on every rank (a collective) and rank 0
writes it; ``resume`` reslices a full checkpoint onto this rank's shards.

Sequence parallel (parallel/sp.py, the flow vocoders): each rank of an sp
group holds its run of the batch's time axis; the flow step's forward
exchanges the convolutions' halos, its loss terms are the rank's parts of
the global sums, and its ``dp`` is the replica group (the dp x sp ranks
that hold one tp rank's weights), over which the gradients are summed.
Validation runs the sharded inverse and gathers the audio for the STFT
losses.

The live config's ``validate_at_start`` runs one validation (and the
free-running one, where there is an inference eval step) before iteration
0; each validation logs the first batch's alignment, mels and gate as
images (runtime/plotting.py; rendering never stops training), and
``TrainerConfig.async_save`` writes the checkpoints in the background.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree
from torch import nn

from ..audio.stft import STFT
from ..device import batch_to_device, full_float32
from ..losses import DEFAULT_LOSS_SCALARS, tacotron2_loss
from ..models.hifigan import (discriminator_loss, feature_loss, generator_loss,
                              mel_l1_loss)
from ..models.tacotron2 import batch_inputs
from ..models.waveglow import waveglow_loss
from ..ops.metrics import alignment_metric, weighted_score
from ..parallel.mesh import SINGLE, DataParallel, data_parallel, draw_rows
from ..parallel.tp import layout_of
from .checkpoint import Checkpointer, restore_train_state
from .live_config import LiveConfig, LossExplosion
from .logging_util import FileLossDB, MetricsLogger
from .optim import AdamState, ReduceLROnPlateau, clip_by_global_norm
from .train_state import GANTrainState, TrainState


def _targets(batch):
    """The loss's targets, with the emotion labels for sup_em_nll."""
    keys = ("mels", "mel_lengths", "text_lengths", "sylps", "gate_target")
    if "emotion_id" in batch:
        keys += ("emotion_id", "emotion_onehot")
    return {k: batch[k] for k in keys}


def make_tacotron2_train_step(model, gate_positive_weight: float = 10.0,
                              guided_att_sigma: float = 0.5,
                              dp: Optional[DataParallel] = None) -> Callable:
    """step(state, batch, generator, ctrl, carry=None) ->
    (state, metrics, file_losses, carry). ``batch`` holds tensors on the
    model's device (this rank's rows under ``dp``); ``ctrl`` the live
    values: lr, grad_clip, p_teacher_forcing, teacher_force_till,
    drop_frame_rate, guided_att_sigma and the loss weights. The state is
    updated in place."""
    dp = data_parallel(dp)

    def step(state: TrainState, batch, generator, ctrl, carry=None):
        model.train()
        with dp.scope():
            out, new_carry = model(
                **batch_inputs(batch), generator=generator,
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
            ctrl.get("guided_att_sigma", guided_att_sigma), dp=dp)
        params = state.params
        grads = torch.autograd.grad(total, list(params.values()),
                                    allow_unused=True)
        grads, grad_norm = clip_by_global_norm(
            dp.reduce_gradients(dict(zip(params, grads))), ctrl["grad_clip"],
            layout_of(model))
        state.apply_gradients(grads, ctrl["lr"])
        loss_dict = {k: v.detach() for k, v in loss_dict.items()}
        loss_dict["grad_norm"] = grad_norm
        return (state, loss_dict, file_losses,
                pytree.tree_map(torch.Tensor.detach, new_carry))

    step.carries_state = True
    return step


@torch.no_grad()
def make_tacotron2_eval_step(model, gate_positive_weight: float = 10.0,
                             dp: Optional[DataParallel] = None) -> Callable:
    """Teacher-forced validation step in eval form, at full teacher
    forcing whatever the live schedule says (so val_loss stays comparable
    across the run). Returns (loss_dict, file_losses, outputs); under
    ``dp`` the losses are the global batch's."""
    dp = data_parallel(dp)

    @torch.no_grad()
    def step(state: TrainState, batch, generator, ctrl):
        del ctrl
        with dp.scope():
            out = model.eval_forward(batch, generator)
        _, loss_dict, file_losses = tacotron2_loss(
            out, _targets(batch), gate_positive_weight=gate_positive_weight,
            dp=dp)
        images = {k: out[k] for k in ("alignments", "mel_outputs_postnet",
                                      "gate_outputs")}
        return loss_dict, file_losses, images

    return step


def make_tacotron2_inference_eval_step(model, dp: Optional[DataParallel] = None
                                       ) -> Callable:
    """Free-running validation step: decodes ``batch['mels'].shape[1]``
    steps and scores the alignments with the gate-derived lengths.
    Returns (loss_dict{inf_weighted_score, inf_diagonality,
    inf_avg_max_attention, inf_gate_fired, inf_len_abs_err},
    file_losses{inf_att_score}, outputs); under ``dp`` the means are the
    global batch's."""
    dp = data_parallel(dp)

    def step(state: TrainState, batch, generator, ctrl):
        del ctrl
        with dp.scope():
            out = model.inference(
                batch["text"], batch["text_lengths"], batch["speaker_id"],
                batch.get("torchmoji"), sylps=batch["sylps"],
                generator=generator,
                max_decoder_steps=int(batch["mels"].shape[1]))
        lengths = out["mel_lengths"]
        atd = alignment_metric(out["alignments"], batch["text_lengths"],
                               lengths)
        scores = weighted_score(atd, batch["text_lengths"], lengths)
        T_dec = out["alignments"].shape[1]
        loss_dict = dp.report({k: dp.share(v) for k, v in {
            "inf_weighted_score": scores.mean(),
            "inf_diagonality": atd["diagonalitys"].mean(),
            "inf_avg_max_attention": atd["avg_prob"].mean(),
            # lanes whose gate fired before the step budget
            "inf_gate_fired": (lengths < T_dec).float().mean(),
            # |predicted - ground-truth| length, in frames
            "inf_len_abs_err": (lengths.float()
                                - batch["mel_lengths"].float()).abs().mean(),
        }.items()})
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
    """Per-file loss rows as numpy, paired with ``paths``: this rank's rows
    (under a group each rank loads, and scores, only its own rows)."""
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
    # the live config's grad_clip_thresh under the live file (None: the
    # live default)
    grad_clip: Optional[float] = None
    # stepped with each validation's val_loss; its scale multiplies the LR
    plateau: Optional[ReduceLROnPlateau] = None
    # checkpoints written on a background thread (Checkpointer(async_save))
    async_save: bool = False


class Trainer:
    """Iteration orchestration: live config, explosion recovery, validation
    cadence, checkpoints, curation statistics. Under ``dp`` every rank runs
    one Trainer over its rows of each batch (the steps made with the same
    ``dp``); rank 0 reads the live config and writes."""

    def __init__(self, cfg: TrainerConfig, state: TrainState,
                 train_step: Callable, eval_step: Optional[Callable] = None,
                 val_batches=None, inference_eval_step: Optional[Callable] = None,
                 device: str | torch.device = "cuda",
                 dp: Optional[DataParallel] = None):
        self.cfg = cfg
        self.state = state
        self.train_step = train_step
        self.eval_step = eval_step
        self.inference_eval_step = inference_eval_step
        self.val_batches = val_batches
        self.device = torch.device(device)
        self.dp = data_parallel(dp)
        self.live = LiveConfig(cfg.live_config_path)
        if cfg.grad_clip is not None:
            self.set_live_defaults({"grad_clip_thresh": float(cfg.grad_clip)})
        self.plateau = cfg.plateau
        self.ckpt = Checkpointer(cfg.run_dir, writer=self.dp.primary,
                                 async_save=cfg.async_save)
        self.logger = MetricsLogger(cfg.run_dir, writer=self.dp.primary)
        self.file_db = FileLossDB()
        self.n_restarts = 0
        self.default_metadata: Dict[str, Any] = {}   # stamped on every ckpt
        # one state on every rank: draws are made at the global batch's shape
        self.generator = torch.Generator(self.device).manual_seed(cfg.seed)
        self._live_synced = False
        # the explosion fallback when no best_val_model exists yet
        self._init_params = [{k: v.detach().cpu().clone()
                              for k, v in side.params.items()}
                             for side in self._sides()]
        self.carry = None            # TBPTT decoder state across iterations
        self._iter_time_ema = None
        self._profiler = None
        self._start_validated = False

    def _sides(self):
        """The TrainStates of the state: G and D for a GAN."""
        if isinstance(self.state, GANTrainState):
            return [self.state.g, self.state.d]
        return [self.state]

    def _poll_live(self, it: int) -> None:
        """Re-read the live file; under a group rank 0 reads it and every
        rank takes its values, so ``ctrl`` is the same on every rank."""
        if self.dp.primary:
            self.live.poll({"iteration": it})
        self.live.values = self.dp.replicate_global(self.live.values)
        self._live_synced = True

    def _manual_save_requested(self) -> bool:
        """The run directory's ``save`` trigger, taken by rank 0 for every
        rank."""
        return self.dp.replicate_global(self.ckpt.manual_save_requested())

    def set_live_defaults(self, values: Dict[str, Any]) -> None:
        """Set live-config values, then lay the live file over them again
        (the file wins)."""
        self.live.values.update(values)
        self.live._mtime = -1.0
        self.live.poll()

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
            if self.plateau is not None and "plateau_scale" in meta:
                self.plateau.scale = float(meta["plateau_scale"])
        print(f"[trainer] resumed from {path} at step {self.state.step}")
        return int(self.state.step)

    def ctrl(self, iteration: int) -> Dict[str, float]:
        live = self.live.values
        lr = self.live.lr(iteration) / (2.0 ** (self.n_restarts / 3.0))
        if self.plateau is not None:
            # torch's ReduceLROnPlateau floors the effective LR at min_lr
            lr = max(lr * self.plateau.scale, min(self.plateau.min_lr, lr))
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
        if cfg.profile_start is None or not self.dp.primary:
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
        if it % 5 == 0 or (self.dp.distributed and not self._live_synced):
            self._poll_live(it)
        if (it == 0 and not self._start_validated
                and bool(self.live.get("validate_at_start", False))
                and self.eval_step is not None and self.val_batches):
            # the live config's one-shot validation at iteration 0: the
            # learning curves start at the initial weights
            self._start_validated = True
            self.validate(self.val_batches, iteration=0)
            if self.inference_eval_step is not None:
                self.validate(self.val_batches, iteration=0,
                              step_fn=self.inference_eval_step,
                              prefix="validation_inf")
        ctrl = self.ctrl(it)
        paths = batch.get("audiopath")
        dev = batch_to_device(batch, self.device)
        if getattr(self.train_step, "carries_state", False):
            carry = adapt_carry(self.carry, int(dev["text"].shape[1]),
                                int(dev["text"].shape[0]))
            state, loss_dict, file_losses, new_carry = self.train_step(
                self.state, dev, self.generator, ctrl, carry)
        else:
            state, loss_dict = self.train_step(self.state, dev,
                                               self.generator, ctrl)
            file_losses, new_carry = {}, None

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
            params = {k: v.detach() for k, v in self.state.params.items()}
            layout = layout_of(self.state.model)
            if layout is not None:       # the full weights (a collective)
                params = layout.gather(params)
            self.logger.log_histograms(
                int(self.state.step),
                {k: v.cpu().numpy() for k, v in params.items()})
        if self._manual_save_requested():
            self.save(periodic=True)

        it_now = int(self.state.step)
        vi = int(self.live.get("validation_interval", 0) or 0)
        if (self.eval_step is not None and self.val_batches
                and vi > 0 and it_now % vi == 0):
            means = self.validate(self.val_batches, iteration=it_now)
            if self.plateau is not None and "val_loss" in means:
                self.plateau.step(means["val_loss"])
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
        """Reload best_val_model (model, optimizer, step; both sides of a
        GAN) and decay the LR; without one, go on from the updated state, or
        restart every side from its initial parameters with fresh moments if
        the update left any not finite."""
        self.n_restarts += 1
        if self.n_restarts > self.cfg.n_restarts_max:
            raise LossExplosion(
                f"loss {loss} exploded {self.n_restarts} times; giving up")
        self.ckpt.wait()       # a best-model save may still be in flight
        self.dp.barrier()
        best = os.path.join(self.cfg.run_dir, "best_val_model")
        if os.path.exists(best):
            self.state, _ = restore_train_state(self.state, best)
        elif not all(bool(torch.isfinite(p).all()) for side in self._sides()
                     for p in side.params.values()):
            self._reset_to_initial()
            print("[trainer] non-finite params with no best checkpoint; "
                  "reset to initial params")
        print(f"[trainer] LossExplosion (loss={loss}); restart "
              f"#{self.n_restarts}, lr decay 2^{self.n_restarts}/3")

    @torch.no_grad()
    def _reset_to_initial(self) -> None:
        zeros = lambda d: {k: torch.zeros_like(v) for k, v in d.items()}  # noqa: E731
        for side, init in zip(self._sides(), self._init_params):
            for k, p in side.params.items():
                p.copy_(init[k])
            opt = side.opt_state
            side.opt_state = AdamState(0, zeros(opt.mu), zeros(opt.nu))

    def save(self, periodic=True, val_loss: Optional[float] = None,
             att_score: Optional[float] = None, metadata=None) -> None:
        """Rank 0 writes (every rank tracks the best losses, which are
        global); under a group every rank then waits for the files. A
        tp-sharded state is gathered by every rank (a collective), and rank
        0 writes the full tree."""
        sharded = any(layout_of(side.model) is not None
                      for side in self._sides())
        tree = (self.state.to_host_tree() if self.dp.primary or sharded
                else None)
        metadata = {**self.default_metadata, **(metadata or {})}
        metadata.setdefault("best_val_loss", self.ckpt.best_val_loss)
        metadata.setdefault("best_inf_attsc", self.ckpt.best_inf_attsc)
        metadata.setdefault("n_restarts", self.n_restarts)
        if self.plateau is not None:
            metadata.setdefault("plateau_scale", self.plateau.scale)
        if periodic:
            # with the generator, so a resume draws what the run would have
            self.ckpt.save_periodic(int(self.state.step), tree and {
                **tree, "generator": self.generator.get_state()}, metadata)
        if val_loss is not None:
            self.ckpt.maybe_save_best_val(val_loss, tree, metadata)
        if att_score is not None:
            self.ckpt.maybe_save_best_attsc(att_score, tree, metadata)
        self.dp.barrier()

    def validate(self, batches, iteration: Optional[int] = None,
                 step_fn: Optional[Callable] = None,
                 prefix: str = "validation") -> Dict[str, float]:
        """Seeded, reproducible validation over an iterable of batches
        (this rank's rows of each under a group): batch i draws from a
        generator seeded with ``seed + i``. ``step_fn`` defaults to the
        teacher-forced eval step. The first batch's alignment, mels and gate
        go to TensorBoard as images where the step returns outputs."""
        step_fn = step_fn or self.eval_step
        it = iteration if iteration is not None else int(self.state.step)
        ctrl = self.ctrl(it)
        agg: Dict[str, list] = {}
        first = None
        for i, batch in enumerate(batches):
            gen = torch.Generator(self.device).manual_seed(self.cfg.seed + i)
            paths = batch.get("audiopath")
            loss_dict, file_losses, outputs = step_fn(
                self.state, batch_to_device(batch, self.device), gen, ctrl)
            if paths is not None and file_losses:
                self.file_db.update(paths,
                                    align_file_losses(paths, file_losses))
            for k, v in loss_dict.items():
                agg.setdefault(k, []).append(float(v))
            if i == 0 and outputs is not None:
                first = (batch, outputs)
        means = {f"val_{k}": float(np.mean(v)) for k, v in agg.items()}
        self.logger.log_scalars(it, means, prefix=prefix)
        if first is not None and self.dp.primary:
            self._log_validation_images(it, *first, prefix=prefix)
        return means

    def _log_validation_images(self, it: int, batch, outputs,
                               prefix: str = "validation") -> None:
        """The first row's alignment, predicted and target mel and gate as
        images (cookietts_tpu/runtime/trainer.py:689-706). Rendering never
        stops training: a failure (no matplotlib) is printed."""
        try:
            from .plotting import plot_alignment, plot_gate, plot_spectrogram
            host = lambda x: (x.detach().cpu().numpy()  # noqa: E731
                              if torch.is_tensor(x) else np.asarray(x))
            t_dec = int(host(batch["mel_lengths"])[0])
            t_enc = int(host(batch["text_lengths"])[0])
            align = host(outputs["alignments"])[0, :t_dec, :t_enc]
            self.logger.log_image(it, f"{prefix}/alignment",
                                  plot_alignment(align))
            mel_pred = host(outputs["mel_outputs_postnet"])[0, :t_dec]
            self.logger.log_image(it, f"{prefix}/mel_predicted",
                                  plot_spectrogram(mel_pred, "predicted"))
            mel_gt = host(batch["mels"])[0, :t_dec]
            self.logger.log_image(it, f"{prefix}/mel_target",
                                  plot_spectrogram(mel_gt, "target"))
            if "gate_target" in batch:
                self.logger.log_image(
                    it, f"{prefix}/gate",
                    plot_gate(host(batch["gate_target"])[0, :t_dec],
                              host(outputs["gate_outputs"])[0, :t_dec]))
        except Exception as e:
            print(f"[trainer] image logging failed: {e!r}")


# -- HiFi-GAN ------------------------------------------------------------------

def make_gan_trainer_step(d_step: Callable, g_step: Callable,
                          loss_key: str = "g_loss",
                          d_lr_scale: float = 1.0,
                          prepare: Optional[Callable] = None,
                          dp: Optional[DataParallel] = None) -> Callable:
    """One Trainer step over a GANTrainState from a (d_step, g_step) pair:
    the discriminator step, then the generator step against the updated
    discriminators. ``metrics['loss']`` is ``metrics[loss_key]`` (explosion
    detection and logging read it); ``d_lr_scale`` scales D's LR.
    ``prepare(batch, generator)``, when given, returns the batch both steps
    see (the GAN postnet's draws its noise there, GAN-TTS its z, windows
    and dropout seed, once an iteration, as JAX's two steps share one key).
    The two steps and ``prepare`` stay reachable as ``step.d_step``,
    ``step.g_step`` and ``step.prepare``. Under ``dp`` ``prepare`` draws in
    the group's scope (each rank its rows of the global batch's draws)."""
    dp = data_parallel(dp)

    def step(state: GANTrainState, batch, generator, ctrl):
        if prepare is not None:
            with dp.scope():
                batch = prepare(batch, generator)
        d_ctrl = dict(ctrl, lr=ctrl["lr"] * d_lr_scale)
        _, d_m = d_step(state.d, state.g, batch, d_ctrl)
        _, g_m = g_step(state.g, state.d, batch, ctrl)
        metrics = {**d_m, **g_m}
        metrics["loss"] = metrics[loss_key]
        return state, metrics

    step.d_step, step.g_step, step.prepare = d_step, g_step, prepare
    return step


def _apply_clipped(state: TrainState, loss: torch.Tensor, ctrl,
                   dp: DataParallel = SINGLE):
    """Gradients of ``loss`` (this rank's part of the global loss under a
    group) for the state's parameters, summed over the dp group, clipped by
    their global norm (over the tp group's shards too), and one optimizer
    step. Returns the pre-clip norm."""
    params = state.params
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads, norm = clip_by_global_norm(
        dp.reduce_gradients(dict(zip(params, grads))), ctrl["grad_clip"],
        layout_of(state.model))
    state.apply_gradients(grads, ctrl["lr"])
    return norm


def _real_fake(fake: torch.Tensor, audio: torch.Tensor):
    n = min(fake.shape[1], audio.shape[1])
    return audio[:, :n], fake[:, :n]


def make_hifigan_train_steps(gen, mpd, msd, mel_fn: Callable,
                             mel_weight: float = 45.0, fm_weight: float = 2.0,
                             dp: Optional[DataParallel] = None
                             ) -> Tuple[Callable, Callable]:
    """(d_step, g_step) of HiFi-GAN (cookietts_tpu/runtime/trainer.py:
    make_hifigan_train_steps): LSGAN losses over the MPD and the MSD,
    feature matching, and the mel L1 of ``mel_fn`` (audio [B, T] -> log-mel)
    on real against generated audio. ``d_step(d_state, g_state, batch,
    ctrl)`` and ``g_step(g_state, d_state, batch, ctrl)`` take batch =
    {mels, audio} on the device, update their own side in place and return
    (state, metrics). The generator runs its training form (``infer=False``)
    in both; everything in float32 with TF32 off. Every term is a plain
    mean over shapes equal on every rank, so under ``dp`` each is shared."""
    dp = data_parallel(dp)

    def d_step(d_state, g_state, batch, ctrl):
        with full_float32():
            with torch.no_grad():
                fake = gen(batch["mels"])
            real, fake = _real_fake(fake, batch["audio"])
            rl, fl, _, _ = mpd(real, fake)
            rl2, fl2, _, _ = msd(real, fake)
            loss = dp.share(discriminator_loss(rl + rl2, fl + fl2))
            norm = _apply_clipped(d_state, loss, ctrl, dp)
        return d_state, {**dp.report({"d_loss": loss.detach()}),
                         "d_grad_norm": norm}

    def g_step(g_state, d_state, batch, ctrl):
        with full_float32():
            real, fake = _real_fake(gen(batch["mels"]), batch["audio"])
            _, fl, rf, ff = mpd(real, fake)
            _, fl2, rf2, ff2 = msd(real, fake)
            adv = dp.share(generator_loss(fl + fl2))
            fm = dp.share(feature_loss(rf + rf2, ff + ff2))
            mel_rec = dp.share(mel_l1_loss(mel_fn(real), mel_fn(fake)))
            loss = adv + fm_weight * fm + mel_weight * mel_rec
            norm = _apply_clipped(g_state, loss, ctrl, dp)
        return g_state, {**dp.report({
            "g_adv": adv.detach(), "g_fm": fm.detach(),
            "g_mel_l1": mel_rec.detach(), "g_loss": loss.detach()}),
            "g_grad_norm": norm}

    return d_step, g_step


def make_hifigan_eval_step(gen, mel_fn: Callable,
                           dp: Optional[DataParallel] = None) -> Callable:
    """Validation: the mel L1 of the generator's audio (training form, as
    JAX validates) against the batch's. Returns ({loss, mel_l1}, {}, None)."""
    dp = data_parallel(dp)

    @torch.no_grad()
    def step(state, batch, generator, ctrl):
        del state, generator, ctrl
        with full_float32():
            real, fake = _real_fake(gen(batch["mels"]), batch["audio"])
            l1 = dp.share(mel_l1_loss(mel_fn(real), mel_fn(fake)))
        return dp.report({"loss": l1, "mel_l1": l1}), {}, None

    return step


# -- the GAN postnet ------------------------------------------------------------

@contextlib.contextmanager
def _stats_kept(module: nn.Module):
    """Run ``module`` in training form with its buffers (the BatchNorm
    running statistics) put back afterwards: JAX's D step runs the postnet
    with ``mutable=["batch_stats"]`` and drops what it returns."""
    saved = {k: v.clone() for k, v in module.named_buffers()}
    try:
        yield
    finally:
        with torch.no_grad():
            for k, v in module.named_buffers():
                v.copy_(saved[k])


def gan_postnet_noise(noise_dim: int) -> Callable:
    """``prepare`` for make_gan_trainer_step: the postnet's per-frame noise
    [B, T, noise_dim], standard normal from the trainer's generator, added
    to the batch unless it holds one."""

    def prepare(batch, generator):
        if "noise" in batch:
            return batch
        B, T, _ = batch["decoder_mel"].shape
        return dict(batch, noise=draw_rows(
            torch.randn, (B, T, noise_dim), generator=generator,
            device=batch["decoder_mel"].device))

    return prepare


def make_gan_postnet_train_steps(postnet, disc, mel_weight: float = 1.0,
                                 dp: Optional[DataParallel] = None
                                 ) -> Tuple[Callable, Callable]:
    """(d_step, g_step) of the adversarial postnet
    (cookietts_tpu/runtime/trainer.py:make_gan_postnet_train_steps): the
    postnet refines the decoder mel toward the ground truth while fooling a
    speaker-conditioned fakeness discriminator (real label 0, fake 1, BCE).

    batch = {decoder_mel [B,T,M], gt_mel [B,T,M], speaker_embed [B,S],
    noise [B,T,N], mel_mask [B,T] (optional)} on the device. The D step
    scores the real mel and a detached fake (the postnet in training form,
    its statistics left as they were), moving the discriminator's running
    statistics with both; the G step runs the postnet in training form (its
    statistics move) against the discriminator's running averages, and adds
    ``mel_weight`` times the masked mel MSE to the adversarial loss. Each
    updates its own side in place and returns (state, metrics). Under
    ``dp`` the BatchNorms take the global batch's statistics, the mel MSE's
    frame count is the global batch's and the BCE terms (plain means) are
    shared."""
    from ..models.gan_postnet import gan_postnet_losses
    dp = data_parallel(dp)

    def fake_of(batch):
        postnet.train()
        return postnet(batch["decoder_mel"], batch["speaker_embed"],
                       noise=batch["noise"])

    def d_step(d_state, g_state, batch, ctrl):
        with full_float32(), dp.scope():
            with torch.no_grad(), _stats_kept(postnet):
                fake = fake_of(batch)
            disc.train()
            d_real = disc(batch["gt_mel"], batch["speaker_embed"])
            d_fake = disc(fake, batch["speaker_embed"])
            _, d_loss = gan_postnet_losses(d_real, d_fake)
            d_loss = dp.share(d_loss)
            norm = _apply_clipped(d_state, d_loss, ctrl, dp)
        return d_state, {**dp.report({
            "d_loss": d_loss.detach(),
            "d_real": dp.share(d_real.detach().mean()),
            "d_fake": dp.share(d_fake.detach().mean())}),
            "d_grad_norm": norm}

    def g_step(g_state, d_state, batch, ctrl):
        with full_float32(), dp.scope():
            fake = fake_of(batch)
            disc.eval()
            d_fake = disc(fake, batch["speaker_embed"])
            g_adv, _ = gan_postnet_losses(d_fake, d_fake)
            g_adv = dp.share(g_adv)
            m = batch.get("mel_mask")
            m = (torch.ones_like(fake[..., :1]) if m is None
                 else m[:, :, None].float())
            mel_mse = dp.masked_mean(
                (((fake - batch["gt_mel"]) ** 2) * m).sum(),
                m.sum() * fake.shape[-1])
            total = g_adv + mel_weight * mel_mse
            norm = _apply_clipped(g_state, total, ctrl, dp)
        return g_state, {**dp.report({
            "g_adv": g_adv.detach(), "g_mel_MSE": mel_mse.detach(),
            "g_loss": total.detach()}), "g_grad_norm": norm}

    return d_step, g_step


def make_gan_postnet_eval_step(postnet, dp: Optional[DataParallel] = None
                               ) -> Callable:
    """Validation: the mel MSE of the postnet in eval form (running
    averages) against the ground truth, its noise drawn from the
    validation batch's generator. Returns ({loss, mel_MSE}, {}, None)."""
    dp = data_parallel(dp)

    @torch.no_grad()
    def step(state, batch, generator, ctrl):
        del state, ctrl
        postnet.eval()
        with full_float32(), dp.scope():
            fake = postnet(batch["decoder_mel"], batch["speaker_embed"],
                           generator=generator)
            mse = dp.share(((fake - batch["gt_mel"]) ** 2).mean())
        return dp.report({"loss": mse, "mel_MSE": mse}), {}, None

    return step


# -- the HiFi-GAN denoiser -------------------------------------------------------

def make_hifigan_denoiser_train_steps(gen, dw, ds, mrs, stage: int = 0,
                                      dp: Optional[DataParallel] = None
                                      ) -> Tuple[Callable, Callable]:
    """(d_step, g_step) of the staged denoiser
    (cookietts_tpu/runtime/trainer.py:make_hifigan_denoiser_train_steps).
    Stage 0 and 1: the log multi-res spectral L1 plus the audio L1, and the
    D step is a no-op that returns the state it was given. Stage >= 2: the
    fakeness logits of the wave (DW) and spectrogram (DS) critics are summed
    into one BCE (real label 0, fake 1); the D loss averages its real and
    fake halves. batch = {noisy [B,T], clean [B,T]} on the device. Every
    term is a plain mean over equal shapes, shared under ``dp``; DS's
    BatchNorms take the global batch's statistics."""
    from ..models.hifigan_denoiser import (denoiser_loss, fakeness_bce,
                                           log_compress)
    dp = data_parallel(dp)

    def fakeness(audio):
        return dw(audio) + ds(log_compress(mrs(audio)))

    def g_step(g_state, d_state, batch, ctrl):
        with full_float32(), dp.scope():
            pred = gen(batch["noisy"])
            dw_fake = ds_fake = None
            if stage >= 2:
                dw_fake = dw(pred)
                ds_fake = ds(log_compress(mrs(pred)))
            total, parts = denoiser_loss(mrs, pred, batch["clean"], stage=stage,
                                         dw_fake=dw_fake, ds_fake=ds_fake)
            norm = _apply_clipped(g_state, dp.share(total), ctrl, dp)
        metrics = dp.report({k: dp.share(v.detach())
                             for k, v in parts.items()})
        metrics["g_grad_norm"] = norm
        return g_state, metrics

    if stage < 2:
        def d_step(d_state, g_state, batch, ctrl):    # pre-adversarial
            return d_state, {"d_loss": 0.0}
        return d_step, g_step

    def d_step(d_state, g_state, batch, ctrl):
        with full_float32(), dp.scope():
            with torch.no_grad():
                pred = gen(batch["noisy"])
            loss = dp.share(
                (fakeness_bce(fakeness(batch["clean"]), fake_label=0.0)
                 + fakeness_bce(fakeness(pred), fake_label=1.0)) / 2.0)
            norm = _apply_clipped(d_state, loss, ctrl, dp)
        return d_state, {**dp.report({"d_loss": loss.detach()}),
                         "d_grad_norm": norm}

    return d_step, g_step


def make_hifigan_denoiser_eval_step(gen, mrs, stage: int,
                                    dp: Optional[DataParallel] = None
                                    ) -> Callable:
    """Validation at every stage is spectral only (critic terms would make
    it incomparable across stages). Returns ({loss, spectral}, {}, None)."""
    from ..models.hifigan_denoiser import denoiser_loss
    dp = data_parallel(dp)

    @torch.no_grad()
    def step(state, batch, generator, ctrl):
        del state, generator, ctrl
        with full_float32():
            total, _ = denoiser_loss(mrs, gen(batch["noisy"]), batch["clean"],
                                     stage=min(stage, 1))
            total = dp.share(total)
        return dp.report({"loss": total, "spectral": total}), {}, None

    return step


# -- WaveGlow / WaveFlow ---------------------------------------------------------

def make_waveglow_train_step(model, sigma: float = 1.0,
                             dp: Optional[DataParallel] = None,
                             sp=None) -> Callable:
    """The flow NLL step: step(state, batch{audio, mels[, speaker_id]},
    generator, ctrl{lr, grad_clip}) -> (state, metrics), in place. Under
    ``dp`` (this rank's rows; the shapes are equal on every rank) the loss
    and the metrics are the global batch's means. A model sharded over a tp
    group (parallel/tp.py) trains its shards. Under an sp group (parallel/
    sp.py) the batch holds this rank's runs of the time axis and ``dp`` is
    the replica group: the rank's part of the loss is its sums over the
    global count, and the gradients are summed over the group."""
    dp = data_parallel(dp)

    def step(state: TrainState, batch, generator, ctrl):
        del generator
        out = model(batch["audio"], batch["mels"],
                    speaker_ids=batch.get("speaker_id"), sp=sp)
        loss, loss_dict = waveglow_loss(out, sigma=sigma)
        with full_float32():
            norm = _apply_clipped(state, dp.share(loss), ctrl, dp)
        metrics = dp.report({k: dp.share(v.detach())
                             for k, v in loss_dict.items()})
        metrics["grad_norm"] = norm
        return state, metrics

    return step


def make_waveglow_val_step(model, stft_windows=((1200, 300, 1200),
                                                (2400, 600, 2400)),
                           sigma: float = 1.0,
                           dp: Optional[DataParallel] = None,
                           replica=None, sp=None) -> Callable:
    """Validation through the inverse: audio from z ~ N(0, sigma) drawn from
    ``generator`` (or the ``z`` given), against the batch's audio in STFT
    magnitude at each of ``stft_windows`` (filter, hop, window), averaged.
    step(state, batch, generator, z=None) -> {val_MSE, val_MAE}; under
    ``dp`` the global batch's (each rank its rows of z).

    A model sharded over a tp group (parallel/tp.py) validates on
    ``replica``, an unsharded WaveGlow of its configuration that takes the
    gathered weights once per validation (a new ``state.step``) and runs the
    inverse's kernels on the rank's rows: what GSPMD does with a kernel call
    it cannot partition.

    Under an sp group the batch holds this rank's runs: the sharded
    inverse (``WaveGlow.infer(sp=...)``) gives the run's audio, and the
    generated and the batch's audio are gathered whole for the STFT
    windows, which cross the runs."""
    dp = data_parallel(dp)
    layout = layout_of(model)
    if layout is not None and replica is None:
        raise ValueError("a tp-sharded WaveGlow validates on a replica")
    net = model if layout is None else replica
    banks = [STFT(f, h, w, device=model.device) for f, h, w in stft_windows]
    synced = {"step": None}

    @torch.no_grad()
    def step(state, batch, generator, z=None):
        if layout is not None:
            at = None if state is None else int(state.step)
            if at is None or at != synced["step"]:
                net.load_state_dict(layout.gather(model.state_dict()))
                synced["step"] = at
        with dp.scope():
            gen = net.infer(batch["mels"], generator, sigma=sigma, z=z, sp=sp)
        gt = batch["audio"]
        if sp is not None:
            gen = sp.bind(gen.shape[1]).gather(gen, 1)
            gt = sp.bind(gt.shape[1]).gather(gt, 1)
        gt = gt[:, :gen.shape[1]]
        gen = gen[:, :gt.shape[1]].float()
        mse = mae = gen.new_zeros(())
        with full_float32():
            for bank in banks:
                mag_gen, _ = bank.transform(gen, return_phase=False)
                mag_gt, _ = bank.transform(gt, return_phase=False)
                mse = mse + torch.mean((mag_gen - mag_gt) ** 2)
                mae = mae + torch.mean(torch.abs(mag_gen - mag_gt))
        return dp.report({"val_MSE": dp.share(mse / len(banks)),
                          "val_MAE": dp.share(mae / len(banks))})

    return step


# -- UnTTS -------------------------------------------------------------------

def _untts_loss_fn(model, sigma, dur_weight, f0_weight, energy_weight,
                   varglow_weight):
    """The loss of the train and the eval steps (JAX ``_untts_loss_fn``):
    the decoder flow NLL, the predictors' MSEs and, with VarGlow, its NLL
    weighted by ``varglow_weight``. loss_fn(batch, generator,
    deterministic) -> (total, loss_dict)."""
    from ..models.untts import untts_loss, varglow_loss

    def loss_fn(batch, generator, deterministic):
        out = model(batch["text"], batch["text_lengths"], batch["mels"],
                    batch["mel_lengths"], batch["speaker_id"],
                    batch["durations"], f0=batch.get("f0"),
                    energy=batch.get("energy"), frame_f0=batch.get("frame_f0"),
                    frame_energy=batch.get("frame_energy"),
                    frame_voiced=batch.get("frame_voiced"),
                    deterministic=deterministic, generator=generator)
        gt = {k: batch[k] for k in ("durations", "f0", "energy") if k in batch}
        total, loss_dict = untts_loss(out, gt, sigma=sigma,
                                      dur_weight=dur_weight,
                                      f0_weight=f0_weight,
                                      energy_weight=energy_weight)
        if "varglow_z" in out:
            vnll = varglow_loss(out["varglow_z"], out["varglow_log_s"],
                                out["varglow_logdet_w"], out["varglow_n"])
            total = total + varglow_weight * vnll
            loss_dict = dict(loss_dict, varglow_nll=vnll, loss=total)
        return total, loss_dict

    return loss_fn


def make_untts_train_step(model, sigma: float = 1.0, dur_weight: float = 0.1,
                          f0_weight: float = 0.1, energy_weight: float = 0.1,
                          varglow_weight: float = 1.0) -> Callable:
    """The NAR flow-TTS step (cookietts_tpu/runtime/trainer.py:
    make_untts_train_step): the training forward with dropout from the
    trainer's generator, the loss, backward, clipping by ``ctrl``'s
    grad_clip and an Adam step, in place. batch = {text, text_lengths,
    mels, mel_lengths, speaker_id, durations[, f0, energy, frame_f0,
    frame_energy, frame_voiced]} on the device (char-rate f0 / energy)."""
    loss_fn = _untts_loss_fn(model, sigma, dur_weight, f0_weight,
                             energy_weight, varglow_weight)

    def step(state: TrainState, batch, generator, ctrl):
        with full_float32():
            total, loss_dict = loss_fn(batch, generator, False)
            norm = _apply_clipped(state, total, ctrl)
        metrics = {k: v.detach() for k, v in loss_dict.items()}
        metrics["grad_norm"] = norm
        return state, metrics

    return step


def make_untts_eval_step(model, sigma: float = 1.0, dur_weight: float = 0.1,
                         f0_weight: float = 0.1, energy_weight: float = 0.1,
                         varglow_weight: float = 1.0) -> Callable:
    """Held-out validation: the training loss without dropout and without
    gradients. Returns (loss_dict, {}, None)."""
    loss_fn = _untts_loss_fn(model, sigma, dur_weight, f0_weight,
                             energy_weight, varglow_weight)

    @torch.no_grad()
    def step(state, batch, generator, ctrl):
        with full_float32():
            _, loss_dict = loss_fn(batch, generator, True)
        return loss_dict, {}, None

    return step


# -- GAN-TTS -------------------------------------------------------------------

def gantts_draws(z_dim: int, windows) -> Callable:
    """``prepare`` for make_gan_trainer_step: once an iteration, for both
    steps (as JAX passes one key to both), the generator's z [B, z_dim], the
    discriminator's window starts and the seed of the dropout masks, drawn
    from the trainer's generator; what the batch holds is kept. The starts
    and the seed come to the host here, in one read, as the steps slice and
    seed with them."""
    from ..models.gantts import window_starts

    def prepare(batch, generator):
        mels = batch["mels"]
        out = dict(batch)
        if "z" not in out:
            out["z"] = draw_rows(torch.randn, (mels.shape[0], z_dim),
                                 generator=generator, device=mels.device)
        drawn = []
        if "window_starts" not in out:
            drawn.append(window_starts(mels.shape[1], windows, generator,
                                       mels.device))
        if "dropout_seed" not in out:
            drawn.append(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                       device=mels.device))
        host = torch.cat(drawn).tolist() if drawn else []
        if "window_starts" in out:
            out["window_starts"] = _host_ints(out["window_starts"])
        else:
            out["window_starts"], host = host[:len(windows)], host[len(windows):]
        if "dropout_seed" not in out:
            out["dropout_seed"] = host[0]
        return out

    return prepare


def _host_ints(v) -> list:
    """Window starts as host ints, from a tensor, an array or a list."""
    return v.tolist() if torch.is_tensor(v) else [int(x) for x in v]


def _bce_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Mean softplus BCE on logits, target 1 = real."""
    x = logits.float()
    return torch.mean(F.softplus(x) - target * x)


def make_gantts_train_steps(gen, disc, mel_weight: float = 1.0,
                            dp: Optional[DataParallel] = None
                            ) -> Tuple[Callable, Callable]:
    """(d_step, g_step) of GAN-TTS (cookietts_tpu/runtime/trainer.py:
    make_gantts_train_steps): BCE on the window logits (the generator pulls
    its mels toward "real", the discriminator real toward real and fake
    toward fake) plus ``mel_weight`` times the masked mel L1 for the
    generator. batch = {text, text_lengths, speaker_id, durations, mels
    [B,T,M], mel_lengths, z, window_starts[, dropout_seed]} on the device,
    the starts and the seed as host ints (``gantts_draws`` adds the last
    three): both steps generate from the
    same z with the same dropout masks and score the same windows; the D
    step on a detached fake. Each updates its own side in place and
    returns (state, metrics). Under ``dp`` the mel L1's frame count is the
    global batch's, the BCE terms (plain means over the windows) are
    shared, and the dropout masks are this rank's rows of the global
    batch's."""
    dp = data_parallel(dp)

    def fake_of(batch):
        seed = batch.get("dropout_seed")
        g = None if seed is None else torch.Generator(
            batch["mels"].device).manual_seed(int(seed))
        return gen(batch["text"], batch["text_lengths"], batch["speaker_id"],
                   batch["durations"], z=batch["z"],
                   t_out=batch["mels"].shape[1], generator=g,
                   deterministic=False)

    def d_step(d_state, g_state, batch, ctrl):
        starts = _host_ints(batch["window_starts"])
        with full_float32(), dp.scope():
            with torch.no_grad():
                fake, _ = fake_of(batch)
            real_logits = disc(batch["mels"], starts)
            fake_logits = disc(fake, starts)
            loss = dp.share((sum(_bce_logits(lg, 1.0) for lg in real_logits)
                             + sum(_bce_logits(lg, 0.0) for lg in fake_logits)
                             ) / len(real_logits))
            norm = _apply_clipped(d_state, loss, ctrl, dp)
        return d_state, {**dp.report({
            "d_loss": loss.detach(),
            "d_real_logit": dp.share(real_logits[0].detach().mean()),
            "d_fake_logit": dp.share(fake_logits[0].detach().mean())}),
            "d_grad_norm": norm}

    def g_step(g_state, d_state, batch, ctrl):
        starts = _host_ints(batch["window_starts"])
        with full_float32(), dp.scope():
            fake, frame_mask = fake_of(batch)
            logits = disc(fake, starts)
            g_adv = dp.share(sum(_bce_logits(lg, 1.0) for lg in logits)
                             / len(logits))
            mel_l1 = gantts_mel_l1(fake, batch["mels"], frame_mask, dp)
            total = g_adv + mel_weight * mel_l1
            norm = _apply_clipped(g_state, total, ctrl, dp)
        return g_state, {**dp.report({
            "g_adv": g_adv.detach(), "g_mel_l1": mel_l1.detach(),
            "g_loss": total.detach()}), "g_grad_norm": norm}

    return d_step, g_step


def gantts_mel_l1(fake: torch.Tensor, mels: torch.Tensor,
                  frame_mask: torch.Tensor,
                  dp: DataParallel = SINGLE) -> torch.Tensor:
    """The mel L1 over the valid frames and every channel (of the global
    batch under ``dp``: this rank's part)."""
    m = frame_mask[:, :, None].float()
    return dp.masked_mean((torch.abs(fake - mels) * m).sum(),
                          m.sum() * fake.shape[-1])


def make_gantts_eval_step(gen, dp: Optional[DataParallel] = None) -> Callable:
    """Validation: the masked mel L1 of the generator without dropout, its
    z drawn from the validation batch's generator. Returns ({loss, mel_l1},
    {}, None)."""
    dp = data_parallel(dp)

    @torch.no_grad()
    def step(state, batch, generator, ctrl):
        del state, ctrl
        with full_float32(), dp.scope():
            fake, frame_mask = gen(
                batch["text"], batch["text_lengths"], batch["speaker_id"],
                batch["durations"], t_out=batch["mels"].shape[1],
                generator=generator, deterministic=True)
            l1 = gantts_mel_l1(fake, batch["mels"], frame_mask, dp)
        return dp.report({"loss": l1, "mel_l1": l1}), {}, None

    return step

"""Tacotron2 training loss (cookietts_tpu/losses/tacotron2_loss.py).

Mask-weighted means over the padded shapes: decoder and postnet MSE and
MFSE, the gate BCE with a positive weight, the SylpsNet KLD and regression,
and the diagonal guided-attention prior, and, when the model emits the GST /
EmotionNet heads' outputs, the emotion VAE's KLD, the supervised class NLL
over the rows with a known label and the text-only AuxEmotionNet's MSE to
the (detached) EmotionNet latents; summed with ``DEFAULT_LOSS_SCALARS``
(each overridable). Alongside: per-file losses [B] for dataset curation and
the alignment metrics (no gradient).

Under a data-parallel group (``dp``, parallel/mesh.py) each term is this
rank's part of the global batch's term, and the loss dict holds the global
values, equal on every rank. Masked means reduce their denominator over the
group: the mel MSE and MFSE (valid frames), the guided-attention prior
(valid decoder frames of the fresh rows) and ``sup_em_nll`` (rows with a
known label). Every rank pads to the global batch's widths, so the other
terms are plain means over shapes equal on every rank and are shared: the
gate BCE over the padded [B, T], ``sylps_*``, the KLDs (sums over B), the
aux MSE and the alignment metrics.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.masking import get_first_over_thresh, get_mask_from_lengths
from ..ops.metrics import alignment_metric, weighted_score
from ..parallel.mesh import SINGLE, DataParallel, data_parallel

DEFAULT_LOSS_SCALARS: Dict[str, float] = {
    "spec_MSE_weight": 0.0,
    "spec_MFSE_weight": 1.0,
    "postnet_MSE_weight": 0.0,
    "postnet_MFSE_weight": 1.0,
    "gate_loss_weight": 1.0,
    "sylps_kld_weight": 0.0020,
    "sylps_MSE_weight": 0.01,
    "sylps_MAE_weight": 0.00,
    "diag_att_weight": 0.05,
    # ssvae head terms (only applied when the model emits the keys)
    "em_kld_weight": 0.002,
    "sup_em_nll_weight": 1.0,
    "aux_em_MSE_weight": 0.1,
}
_TERMS = ("spec_MSE", "spec_MFSE", "postnet_MSE", "postnet_MFSE", "gate_loss",
          "sylps_kld", "sylps_MSE", "sylps_MAE", "diag_att", "em_kld",
          "sup_em_nll", "aux_em_MSE")


def _masked_mean(x: torch.Tensor, mask: torch.Tensor,
                 dp: DataParallel = SINGLE) -> torch.Tensor:
    mask = mask.expand_as(x).to(x.dtype)
    return dp.masked_mean((x * mask).sum(), mask.sum())


def _per_item_masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    mask = mask.expand_as(x).to(x.dtype)
    dims = tuple(range(1, x.dim()))
    return (x * mask).sum(dims) / mask.sum(dims).clamp_min(1.0)


def guided_attention_loss(alignments: torch.Tensor, text_lengths: torch.Tensor,
                          mel_lengths: torch.Tensor, sigma: Any = 0.5,
                          item_weights: Optional[torch.Tensor] = None,
                          dp: DataParallel = SINGLE) -> torch.Tensor:
    """Attention mass off the diagonal, W = 1 - exp(-(t_enc/N -
    t_dec/T)^2 / (2 sigma^2)), summed over the valid cells and normalised by
    the frame count; ``item_weights`` [B] leaves rows out (TBPTT
    continuations) of both sums."""
    B, T_dec, T_enc = alignments.shape
    dev = alignments.device
    in_len = text_lengths.float().clamp_min(1.0)
    out_len = mel_lengths.float().clamp_min(1.0)
    dec_pos = (torch.arange(T_dec, device=dev, dtype=torch.float32)[None, :, None]
               / out_len[:, None, None])
    enc_pos = (torch.arange(T_enc, device=dev, dtype=torch.float32)[None, None, :]
               / in_len[:, None, None])
    w = 1.0 - torch.exp(-((enc_pos - dec_pos) ** 2) / (2.0 * sigma * sigma))
    mask = (get_mask_from_lengths(mel_lengths, T_dec)[:, :, None]
            & get_mask_from_lengths(text_lengths, T_enc)[:, None, :])
    per_item = (alignments.float() * w * mask.float()).sum((1, 2))
    iw = (torch.ones(B, device=dev) if item_weights is None
          else item_weights.float())
    return dp.masked_mean((per_item * iw).sum(),
                          (mel_lengths.float() * iw).sum())


def tacotron2_loss(pred: Dict[str, torch.Tensor], gt: Dict[str, torch.Tensor],
                   loss_scalars: Optional[Dict[str, Any]] = None,
                   gate_positive_weight: float = 10.0,
                   guided_att_sigma: Any = 0.5,
                   dp: Optional[DataParallel] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                              Dict[str, torch.Tensor]]:
    """(total, loss_dict, per-file losses [B]) of the model's outputs
    ``pred`` against the batch ``gt`` (mels, mel_lengths, text_lengths,
    gate_target, sylps, optional pres_prev_state, emotion_id and
    emotion_onehot). Under ``dp`` the total is this rank's part of the
    global loss (the gradients sum over the group) and the loss dict holds
    the global values."""
    dp = data_parallel(dp)
    scalars = dict(DEFAULT_LOSS_SCALARS)
    scalars.update(loss_scalars or {})
    gt_mel = gt["mels"].float()
    B, T_dec, _ = gt_mel.shape
    mel_lengths, text_lengths = gt["mel_lengths"], gt["text_lengths"]
    frame_mask = get_mask_from_lengths(mel_lengths, T_dec)[:, :, None]
    loss: Dict[str, torch.Tensor] = {}
    files: Dict[str, torch.Tensor] = {}

    err = pred["mel_outputs"].float() - gt_mel
    err_post = pred["mel_outputs_postnet"].float() - gt_mel
    loss["spec_MSE"] = _masked_mean(err ** 2, frame_mask, dp)
    files["spec_MSE"] = _per_item_masked_mean(err ** 2, frame_mask)
    loss["postnet_MSE"] = _masked_mean(err_post ** 2, frame_mask, dp)
    # MFSE: |err| weighted by its own frame mean
    for name, e in (("spec_MFSE", err.abs()), ("postnet_MFSE", err_post.abs())):
        loss[name] = _masked_mean(e * e.mean(2, keepdim=True), frame_mask, dp)

    # gate BCE with pos_weight over every position (targets cover padding)
    logits = pred["gate_outputs"].float()
    target = gt["gate_target"].float()
    loss["gate_loss"] = dp.share(-(
        gate_positive_weight * target * F.logsigmoid(logits)
        + (1.0 - target) * F.logsigmoid(-logits)).mean())

    mu, logvar = pred["syl_mu"].float(), pred["syl_logvar"].float()
    loss["sylps_kld"] = dp.share(
        -0.5 * (1.0 + logvar - logvar.exp() - mu ** 2).sum() / B)
    d = pred["pred_sylps"].float() - gt["sylps"].float()
    loss["sylps_MAE"] = dp.share(d.abs().mean())
    loss["sylps_MSE"] = dp.share((d ** 2).mean())

    item_w = gt["pres_prev_state"] == 0.0 if "pres_prev_state" in gt else None
    loss["diag_att"] = guided_attention_loss(
        pred["alignments"], text_lengths, mel_lengths, guided_att_sigma, item_w,
        dp)

    if "em_zu_mu" in pred:
        em_mu, em_logvar = pred["em_zu_mu"].float(), pred["em_zu_logvar"].float()
        loss["em_kld"] = dp.share(-0.5 * (1.0 + em_logvar - em_logvar.exp()
                                          - em_mu ** 2).sum() / B)
        em_zs = pred["em_zs"].float()             # log-probabilities
        if "emotion_onehot" in gt and "emotion_id" in gt:
            known = (gt["emotion_id"] != em_zs.shape[-1]).float()
            nll = -(em_zs * gt["emotion_onehot"].float()).sum(-1)
            loss["sup_em_nll"] = dp.masked_mean((nll * known).sum(),
                                                known.sum())
        if "aux_zs" in pred:
            loss["aux_em_MSE"] = dp.share(
                ((pred["aux_zs"].float().exp() - em_zs.exp().detach()) ** 2).mean()
                + ((pred["aux_zu_mu"].float() - em_mu.detach()) ** 2).mean()
                + ((pred["aux_zu_logvar"].float() - em_logvar.detach()) ** 2).mean())

    total = torch.zeros((), device=gt_mel.device)
    for name in _TERMS:
        if name in loss:
            total = total + loss[name] * scalars[f"{name}_weight"]
    loss["loss"] = total

    with torch.no_grad():
        align = pred["alignments"]
        atd = alignment_metric(align, text_lengths, mel_lengths)
        loss["diagonality"] = dp.share(atd["diagonalitys"].mean())
        loss["avg_max_attention"] = dp.share(atd["avg_prob"].mean())
        files["avg_max_attention"] = atd["avg_prob"]
        files["att_diagonality"] = atd["diagonalitys"]
        files["p_missing_enc"] = atd["p_missing_enc"]
        # inference-style score from the predicted gates
        pred_gate = torch.sigmoid(logits)
        pred_gate[:, :5] = 0.0
        pred_lengths = get_first_over_thresh(pred_gate, 0.7).clamp_max(T_dec)
        scores = weighted_score(alignment_metric(align, text_lengths,
                                                 pred_lengths),
                                text_lengths, mel_lengths)
        loss["weighted_score"] = dp.share(scores.mean())
        files["att_score"] = scores
    return total, dp.report(loss), files

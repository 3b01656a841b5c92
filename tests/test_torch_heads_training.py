"""Training with the GST and EmotionNet heads, the port against the JAX
package on the CPU at tiny widths.

The three loss terms (em_kld, sup_em_nll over the rows with a known label,
aux_em_MSE against detached targets) against JAX's tacotron2_loss on the
same arrays; the GST (VAE mode) and EmotionNet / AuxEmotionNet training
forwards with the reparameterisation's eps passed in (JAX draws it from its
key, the port from its generator), the BatchNorm statistics after them
included; collate's emotion_id / emotion_onehot; and the train command with
each head for 2 iterations on a corpus with labelled and unlabelled emotion
ids, then a resume to 3.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cookietts_tpu.data import dataset as jds
from cookietts_tpu.losses import tacotron2_loss as jax_loss
from cookietts_tpu.models import emotionnet as jem
from cookietts_tpu.models import gst as jgst

from cookietts_tpu_torch.cli import main as cli
from cookietts_tpu_torch.convert.from_jax import (
    auxemotionnet_state_dict_from_jax, emotionnet_state_dict_from_jax,
    gst_state_dict_from_jax)
from cookietts_tpu_torch.data import dataset as pds
from cookietts_tpu_torch.data.evidence_corpus import make_corpus
from cookietts_tpu_torch.losses import tacotron2_loss
from cookietts_tpu_torch.models import emotionnet as pem
from cookietts_tpu_torch.models import gst as pgst
from tests.test_torch_trainer import _hparams
from test_torch_threads import _one_thread  # noqa: F401


B, C, Z, T_MEL, T_TXT, M = 4, 3, 2, 24, 9, 16
IDS = np.array([0, C, 2, C])              # rows 1 and 3 unlabelled


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=1e-5, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got)
                                          else got), np.asarray(want),
                               atol=atol, rtol=rtol)


def _pred_and_gt(rng, labels):
    """A model output dict with the heads' keys and its batch."""
    T_dec, T_enc = 10, 7
    ml, tl = np.array([10, 6, 8, 9]), np.array([7, 5, 6, 7])
    zs = rng.normal(0, 1, (B, C))
    log_softmax = lambda x: x - np.log(np.exp(x).sum(-1, keepdims=True))
    pred = {
        "mel_outputs": rng.normal(0, 1, (B, T_dec, 5)),
        "mel_outputs_postnet": rng.normal(0, 1, (B, T_dec, 5)),
        "gate_outputs": rng.normal(0, 1, (B, T_dec)),
        "alignments": rng.dirichlet(np.ones(T_enc), (B, T_dec)),
        "pred_sylps": rng.normal(4, 1, B), "syl_mu": rng.normal(0, 1, B),
        "syl_logvar": rng.normal(0, 0.5, B),
        "em_zs": log_softmax(zs), "em_zu_mu": rng.normal(0, 1, (B, Z)),
        "em_zu_logvar": rng.normal(0, 0.5, (B, Z)),
        "aux_zs": log_softmax(rng.normal(0, 1, (B, C))),
        "aux_zu_mu": rng.normal(0, 1, (B, Z)),
        "aux_zu_logvar": rng.normal(0, 0.5, (B, Z)),
        "gst_style_tokens": rng.dirichlet(np.ones(4), B),
    }
    gt = {"mels": rng.normal(0, 1, (B, T_dec, 5)), "mel_lengths": ml,
          "text_lengths": tl, "sylps": rng.normal(4, 1, B),
          "gate_target": (np.arange(T_dec)[None] >= ml[:, None] - 1) * 1.0,
          "pres_prev_state": np.zeros(B)}
    if labels:
        gt["emotion_id"] = IDS
        gt["emotion_onehot"] = np.eye(C)[np.minimum(IDS, C - 1)] * (IDS < C)[:, None]
    f32 = lambda d: {k: np.asarray(v, np.int32 if "length" in k or k ==
                                   "emotion_id" else np.float32)
                     for k, v in d.items()}
    return f32(pred), f32(gt)


@pytest.mark.parametrize("labels", [True, False], ids=["labelled", "no_labels"])
def test_emotion_loss_terms_match_jax(labels):
    pred, gt = _pred_and_gt(np.random.default_rng(0), labels)
    total_r, ld_r, _ = jax_loss(jax.tree_util.tree_map(jnp.asarray, pred),
                                jax.tree_util.tree_map(jnp.asarray, gt))
    tp = {k: _t(v).requires_grad_() for k, v in pred.items()}
    tg = {k: _t(v) for k, v in gt.items()}
    total, ld, _ = tacotron2_loss(tp, tg)
    terms = ["em_kld", "aux_em_MSE"] + (["sup_em_nll"] if labels else [])
    assert ("sup_em_nll" in ld) == labels
    for k in terms + ["loss"]:
        _close(ld[k], ld_r[k], atol=1e-6, rtol=1e-6)
    _close(total, total_r, atol=1e-6, rtol=1e-6)
    if labels:     # the mean over the two labelled rows only
        nll = -(pred["em_zs"] * gt["emotion_onehot"]).sum(-1)
        _close(ld["sup_em_nll"], nll[[0, 2]].mean(), atol=1e-6)
    # the aux targets are detached (JAX's stop_gradient)
    grads = torch.autograd.grad(ld["aux_em_MSE"], [tp["em_zs"], tp["em_zu_mu"],
                                                   tp["em_zu_logvar"],
                                                   tp["aux_zu_mu"]],
                                allow_unused=True)
    assert grads[0] is None and grads[1] is None and grads[2] is None
    assert float(grads[3].abs().sum()) > 0


def _running_stats(sd):
    return {k: v for k, v in sd.items() if "running" in k}


def test_gst_training_forward_matches_jax():
    """GST in VAE mode from a reference mel, training: BatchNorm on batch
    statistics (flax's biased variance), the token draw's eps passed in;
    the running statistics after the step follow flax's update."""
    cfg = dict(n_mel_channels=M, token_embedding_size=8, token_num=4,
               num_heads=2, gst_att_dim=8, ref_enc_filters=(4, 4),
               torchmoji_dim=6, vae_mode=True)
    rng = np.random.default_rng(1)
    mel = rng.normal(0, 1, (B, T_MEL, M)).astype(np.float32)
    jm = jgst.GST(jgst.GSTConfig(**cfg))
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(mel), 1)
    stats = jax.tree_util.tree_map(
        lambda x: np.asarray(rng.uniform(0.5, 1.5, x.shape), np.float32),
        v["batch_stats"])
    key = jax.random.PRNGKey(3)
    ref, mut = jm.apply({"params": v["params"], "batch_stats": stats},
                        jnp.asarray(mel), 1, key=key, deterministic=False,
                        mutable=["batch_stats"])
    eps = jax.random.normal(key, ref["mu"].shape)
    port = pgst.GST(pgst.GSTConfig(**cfg))
    port.load_state_dict(gst_state_dict_from_jax(v["params"], stats))
    port.train()
    out = port(_t(mel), 1, eps=_t(eps))
    for k in ("style_embedding", "style_tokens", "mu", "logvar"):
        _close(out[k], ref[k])
    want = _running_stats(gst_state_dict_from_jax(v["params"], mut["batch_stats"]))
    got = port.state_dict()
    for k, t in want.items():
        _close(got[k], t, atol=1e-6, rtol=1e-5)
    # without eps the draw comes from the generator, the same for one seed
    a, b = (port(_t(mel), 1, torch.Generator().manual_seed(5))["style_tokens"]
            for _ in range(2))
    assert torch.equal(a, b) and not torch.allclose(a, out["mu"])


def _emotion_inputs(rng, E=10, S=6):
    return (rng.normal(0, 1, (B, T_MEL, M)).astype(np.float32),
            rng.normal(0, 1, (B, S)).astype(np.float32),
            rng.normal(0, 1, (B, T_TXT, E)).astype(np.float32),
            np.array([9, 5, 7, 9]), rng.normal(0, 1, (B, 7)).astype(np.float32))


@pytest.mark.parametrize("net", ["emotionnet", "auxemotionnet"])
def test_emotion_heads_training_forward_match_jax(net):
    """EmotionNet (its known rows take their one-hot) and AuxEmotionNet in
    training, dropouts 0 and zu's eps passed in; then the dropouts on: the
    port's draws come from its generator."""
    kw = dict(n_classes=C, latent_dim=Z, ref_enc_filters=(4, 4),
              ref_enc_rnn_dim=6, rnn_dim=5, speaker_embedding_dim=6,
              torchmoji_dim=7, aux_layer_dims=(8,), n_mel_channels=M,
              classifier_dropout=0.0, encoder_outputs_dropout=0.0)
    rng = np.random.default_rng(2)
    mel, spk, enc, tl, tm = _emotion_inputs(rng)
    onehot = np.eye(C, dtype=np.float32)[np.minimum(IDS, C - 1)] * (IDS < C)[:, None]
    key = jax.random.PRNGKey(4)
    jcfg = jem.EmotionNetConfig(**kw)
    if net == "emotionnet":
        jm = jem.EmotionNet(jcfg)
        args = (mel, spk, enc, tl, IDS, onehot)
    else:
        jm = jem.AuxEmotionNet(jcfg)
        args = (tm, spk, enc, tl)
    args_j = [jnp.asarray(a) for a in args]
    v = jm.init(jax.random.PRNGKey(0), *args_j)
    stats = jax.tree_util.tree_map(
        lambda x: np.asarray(rng.uniform(0.5, 1.5, x.shape), np.float32),
        v.get("batch_stats", {}))
    ref, mut = jm.apply({"params": v["params"], "batch_stats": stats}, *args_j,
                        key=key, deterministic=False, mutable=["batch_stats"])
    eps = _t(jax.random.normal(key, (B, Z)))
    pcfg = pem.EmotionNetConfig(**kw, encoder_dim=enc.shape[-1])
    if net == "emotionnet":
        port = pem.EmotionNet(pcfg)
        port.load_state_dict(emotionnet_state_dict_from_jax(v["params"], stats))
    else:
        port = pem.AuxEmotionNet(pcfg)
        port.load_state_dict(auxemotionnet_state_dict_from_jax(v["params"]))
    port.train()
    args_t = [_t(a) for a in args]
    out = port(*args_t, eps=eps)
    keys = ["zs", "zu", "zu_mu", "zu_logvar"] + (["ss_zs"] if net == "emotionnet"
                                                 else [])
    for k in keys:
        _close(out[k], ref[k])
    if net == "emotionnet":
        # a labelled row's ss_zs is log(one-hot + 1e-6), an unlabelled one's
        # the classifier's
        _close(out["ss_zs"][0], np.log(onehot[0] + 1e-6))
        assert torch.equal(out["ss_zs"][1], out["zs"][1])
        want = _running_stats(emotionnet_state_dict_from_jax(
            v["params"], mut["batch_stats"]))
        got = port.state_dict()
        for k, t in want.items():
            _close(got[k], t, atol=1e-6, rtol=1e-5)
    port.cfg = dataclasses.replace(pcfg, classifier_dropout=0.25,
                                   encoder_outputs_dropout=0.25)
    a, b = (port(*args_t, generator=torch.Generator().manual_seed(6))["zu"]
            for _ in range(2))
    assert torch.equal(a, b) and not torch.allclose(a, out["zu"])


def test_collate_emotion_ids_match_jax():
    """Ids outside [0, n_classes) map to the unknown class n_classes with a
    zero one-hot row, as JAX's collate maps them."""
    rng = np.random.default_rng(3)
    ids = [0, -1, 2, 5, 1]
    items = [{"text": rng.integers(1, 40, n), "mel": rng.normal(
        0, 1, (m, 8)).astype(np.float32), "speaker_id": i, "emotion_id": e,
              "sylps": np.float32(3.0), "audiopath": f"a{i}.wav"}
             for i, (n, m, e) in enumerate(zip((5, 9, 7, 3, 8),
                                               (20, 31, 12, 25, 18), ids))]
    kw = dict(n_mel_channels=8, n_emotion_classes=3)
    got = pds.collate(items, pds.DataConfig(**kw))
    want = jds.collate(items, jds.DataConfig(**kw))
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["emotion_id"], [0, 3, 2, 3, 1])
    for k, v in want.items():
        if k != "audiopath":
            np.testing.assert_array_equal(got[k], v, err_msg=k)


HEADS = dict(gst_token_num=4, gst_token_embedding_size=8, gst_num_heads=2,
             gst_att_dim=8, gst_ref_enc_filters="[4,4]", n_emotion_classes=3,
             emotionnet_latent_dim=2)


@pytest.fixture(scope="module")
def labelled_corpus(tmp_path_factory):
    """The evidence corpus with emotion ids on half of its lines (the
    filelist's fifth column; the rest unlabelled)."""
    fl = make_corpus(str(tmp_path_factory.mktemp("corpus")), seed=0,
                     n_train=6, n_val=3)[0]
    lines = open(fl).read().splitlines()
    with open(fl, "w") as f:
        for i, ln in enumerate(lines):
            f.write(ln + (f"||{i % 3}" if i % 2 == 0 else "") + "\n")
    return fl


@pytest.mark.parametrize("head", ["use_gst", "use_emotionnet"])
def test_train_command_with_a_head_trains_and_resumes(labelled_corpus,
                                                      tmp_path, head):
    run = str(tmp_path / "run")
    args = ["train", "--device", "cpu", "--filelist", labelled_corpus,
            "--run_dir", run, "--seed", "3", "--hparams",
            _hparams(**HEADS, **{head: True}, validation_interval=2,
                     checkpoint_interval=2)]
    trainer = cli(args + ["--iters", "2"])
    assert trainer.state.step == 2
    model = trainer.state.model
    assert model.cfg.use_gst == (head == "use_gst")
    assert model.cfg.use_emotionnet == (head == "use_emotionnet")
    sd = torch.load(os.path.join(run, "checkpoint_2"))["state_dict"]
    name = ("gst.ref_encoder.convs.0.batch_norm.running_mean"
            if head == "use_gst" else
            "emotion_net.ref_enc.convs.0.batch_norm.running_mean")
    assert sd[name].abs().sum() > 0            # the head's statistics moved
    trainer = cli(args + ["--iters", "3", "--resume"])
    assert trainer.state.step == 3
    assert torch.isfinite(torch.stack([p.detach().abs().sum() for p in
                                       trainer.state.model.parameters()])).all()

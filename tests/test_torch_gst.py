"""The port's GST, EmotionNet and AuxEmotionNet against the JAX modules on
the CPU, at tiny widths.

JAX params (with perturbed BatchNorm statistics) come across through
``convert.from_jax``; the same numpy inputs go through both, within 1e-5.
Where the JAX module draws (``deterministic=False``), the port is in
training mode and is handed the JAX module's own normal draw as ``eps``.
The port's state dicts then go through the JAX package's converters for the
reference torch layout (cookietts_tpu/convert/gst_torch.py) and give the
same outputs, which shows the port keeps that layout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cookietts_tpu.convert.gst_torch import (convert_auxemotionnet_state_dict,
                                             convert_emotionnet_state_dict,
                                             convert_gst_state_dict)
from cookietts_tpu.models.emotionnet import (AuxEmotionNet as JAux,
                                             EmotionNet as JEmotionNet,
                                             EmotionNetConfig as JEmCfg)
from cookietts_tpu.models.gst import GST as JGST, GSTConfig as JGSTConfig

from cookietts_tpu_torch.convert.from_jax import (
    auxemotionnet_state_dict_from_jax, emotionnet_state_dict_from_jax,
    gst_state_dict_from_jax)
from cookietts_tpu_torch.models.emotionnet import (AuxEmotionNet, EmotionNet,
                                                   EmotionNetConfig)
from cookietts_tpu_torch.models.gst import GST, GSTConfig
from test_torch_threads import _one_thread  # noqa: F401


B, T_MEL, M, TM = 3, 20, 12, 6
GST_TINY = dict(n_mel_channels=M, token_embedding_size=8, token_num=4,
                num_heads=2, gst_att_dim=8, ref_enc_filters=(4, 6),
                torchmoji_dim=TM, vae_classes=6, ss_vae_zu_dim=3)
EM_TINY = dict(n_classes=3, latent_dim=2, ref_enc_filters=(4, 6),
               ref_enc_rnn_dim=6, rnn_dim=5, speaker_embedding_dim=4,
               torchmoji_dim=TM, aux_layer_dims=(7, 8), n_mel_channels=M)
ENC = 9


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def _perturb_stats(stats, rng):
    stats = jax.tree_util.tree_map(np.array, stats)
    for path, x in jax.tree_util.tree_flatten_with_path(stats)[0]:
        x[...] = (rng.uniform(0.5, 1.5, x.shape)
                  if "var" in jax.tree_util.keystr(path)
                  else rng.normal(0, 0.2, x.shape))
    return stats


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


# (ref_mode, vae_mode, ss_vae, token_activation, draws)
GST_CASES = [(0, False, False, "softmax", False),
             (1, False, False, "softmax", False),
             (3, False, False, "sigmoid", False),
             (1, True, False, "tanh", True),
             (3, True, True, "softmax", True),
             (3, True, True, "linear", False)]


@pytest.mark.parametrize("ref_mode,vae,ss_vae,act,draws", GST_CASES)
def test_gst_matches_jax(ref_mode, vae, ss_vae, act, draws):
    kw = dict(GST_TINY, vae_mode=vae, ss_vae=ss_vae, token_activation=act)
    jm = JGST(JGSTConfig(**kw))
    rng = np.random.default_rng(ref_mode + 10 * vae + 100 * ss_vae)
    n_weights = (kw["vae_classes"] if ss_vae
                 else kw["token_num"] * (1 + int(vae)))
    ref = {0: rng.normal(0, 1, (B, n_weights)),
           1: rng.normal(0, 1, (B, T_MEL, M)),
           3: rng.normal(0, 1, (B, TM))}[ref_mode].astype(np.float32)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(ref), ref_mode=ref_mode)
    params = v["params"]
    stats = _perturb_stats(v["batch_stats"], rng)
    key = jax.random.PRNGKey(3)

    def run_jax(p, bs):
        out = jm.apply({"params": p, "batch_stats": bs}, jnp.asarray(ref),
                       ref_mode=ref_mode, key=key, deterministic=not draws,
                       mutable=["batch_stats"] if draws else False)
        return out[0] if draws else out

    want = run_jax(params, stats)
    port = GST(GSTConfig(**kw))
    port.load_state_dict(gst_state_dict_from_jax(params, stats))
    port.train(draws)
    eps = None
    if draws:
        n = (kw["ss_vae_zu_dim"] if ss_vae else kw["token_num"])
        eps = _t(jax.random.normal(key, (B, n)))
    got = port(_t(ref), ref_mode=ref_mode, eps=eps)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])

    # the port's state dict in the reference layout, read by JAX
    p2, bs2 = convert_gst_state_dict(
        {f"gst.{k}": t.numpy() for k, t in port.state_dict().items()})
    for k, x in run_jax(p2, bs2).items():
        _close(got[k], x)


def _em_inputs(rng):
    lengths = np.array([7, 3, 5])
    return dict(mel=rng.normal(0, 1, (B, T_MEL, M)).astype(np.float32),
                spk=rng.normal(0, 1, (B, 4)).astype(np.float32),
                enc=rng.normal(0, 1, (B, 7, ENC)).astype(np.float32),
                lengths=lengths,
                tm=rng.normal(0, 1, (B, TM)).astype(np.float32),
                emotion_id=np.array([1, 3, 0]),      # 3 = unknown
                onehot=np.eye(3, dtype=np.float32)[[1, 0, 0]])


@pytest.mark.parametrize("draws", [False, True])
def test_emotionnet_matches_jax(draws):
    kw = dict(EM_TINY)
    if draws:   # JAX's dropout masks cannot be drawn by torch
        kw.update(classifier_dropout=0.0, encoder_outputs_dropout=0.0)
    rng = np.random.default_rng(int(draws))
    x = _em_inputs(rng)
    jm = JEmotionNet(JEmCfg(**kw))
    args = (jnp.asarray(x["mel"]), jnp.asarray(x["spk"]), jnp.asarray(x["enc"]),
            jnp.asarray(x["lengths"]))
    v = jm.init(jax.random.PRNGKey(0), *args)
    stats = _perturb_stats(v["batch_stats"], rng)
    key = jax.random.PRNGKey(5)

    def run_jax(p, bs):
        out = jm.apply({"params": p, "batch_stats": bs}, *args,
                       emotion_id=jnp.asarray(x["emotion_id"]),
                       emotion_onehot=jnp.asarray(x["onehot"]), key=key,
                       deterministic=not draws,
                       mutable=["batch_stats"] if draws else False)
        return out[0] if draws else out

    want = run_jax(v["params"], stats)
    port = EmotionNet(EmotionNetConfig(**kw, encoder_dim=ENC))
    port.load_state_dict(emotionnet_state_dict_from_jax(v["params"], stats))
    port.train(draws)
    eps = _t(jax.random.normal(key, (B, kw["latent_dim"]))) if draws else None
    got = port(_t(x["mel"]), _t(x["spk"]), _t(x["enc"]),
               torch.from_numpy(x["lengths"]),
               torch.from_numpy(x["emotion_id"]), _t(x["onehot"]), eps=eps)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])
    p2, bs2 = convert_emotionnet_state_dict(
        {f"emotion_net.{k}": t.numpy() for k, t in port.state_dict().items()})
    for k, y in run_jax(p2, bs2).items():
        _close(got[k], y)


@pytest.mark.parametrize("draws", [False, True])
def test_auxemotionnet_matches_jax(draws):
    kw = dict(EM_TINY)
    if draws:
        kw.update(classifier_dropout=0.0, encoder_outputs_dropout=0.0)
    rng = np.random.default_rng(2 + int(draws))
    x = _em_inputs(rng)
    jm = JAux(JEmCfg(**kw))
    args = (jnp.asarray(x["tm"]), jnp.asarray(x["spk"]), jnp.asarray(x["enc"]),
            jnp.asarray(x["lengths"]))
    params = jm.init(jax.random.PRNGKey(0), *args)["params"]
    key = jax.random.PRNGKey(6)
    run_jax = lambda p: jm.apply({"params": p}, *args, key=key,  # noqa: E731
                                 deterministic=not draws)
    want = run_jax(params)
    port = AuxEmotionNet(EmotionNetConfig(**kw, encoder_dim=ENC))
    port.load_state_dict(auxemotionnet_state_dict_from_jax(params))
    port.train(draws)
    eps = _t(jax.random.normal(key, (B, kw["latent_dim"]))) if draws else None
    got = port(_t(x["tm"]), _t(x["spk"]), _t(x["enc"]),
               torch.from_numpy(x["lengths"]), eps=eps)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])
    p2 = convert_auxemotionnet_state_dict(
        {f"aux_emotion_net.{k}": t.numpy()
         for k, t in port.state_dict().items()})
    for k, y in run_jax(p2).items():
        _close(got[k], y)

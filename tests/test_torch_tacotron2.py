"""The PyTorch port's Tacotron2 against the JAX model on the CPU.

A tiny JAX Tacotron2 (random weights, perturbed BatchNorm statistics and
attention parameters) is carried across with
``convert.from_jax.tacotron2_state_dict_from_jax``; the same numpy inputs
then go through both. Prenet dropout is 0 for the whole-slice checks (JAX
threefry and torch never draw the same bits); the Prenet test feeds the JAX
keep masks into the port instead.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cookietts_tpu.models.tacotron2 import (Prenet as JPrenet, Tacotron2 as JTacotron2,
                                           Tacotron2Config as JConfig)
from cookietts_tpu.ops.attention import AttentionState as JAttentionState
from cookietts_tpu.text import N_SYMBOLS

from cookietts_tpu_torch.convert.from_jax import tacotron2_state_dict_from_jax
from cookietts_tpu_torch.models.tacotron2 import (Prenet, Tacotron2,
                                                  Tacotron2Config)
from cookietts_tpu_torch.ops.attention import AttentionState

TINY = dict(
    n_symbols=N_SYMBOLS, symbols_embedding_dim=16, n_speakers=4,
    speaker_embedding_dim=8, encoder_speaker_embed_dim=4,
    encoder_conv_hidden_dim=16, encoder_lstm_dim=16,
    encoder_n_convolutions=2, torchmoji_dim=8, torchmoji_crushed_dim=4,
    memory_bottleneck_dim=16, prenet_dim=8, attention_rnn_dim=16,
    decoder_rnn_dim=16, second_decoder_rnn_dim=16, attention_dim=8,
    windowed_attention_range=2, postnet_embedding_dim=16,
    postnet_n_convolutions=3, postnet_residual_connections=2,
    p_prenet_dropout=0.0, max_decoder_steps=32)
B, T_TXT = 2, 12
LENGTHS = np.array([12, 7])


def _perturb(variables, rng):
    """Non-trivial BatchNorm statistics and attention scalars, so the
    comparison exercises them."""
    v = jax.tree_util.tree_map(np.array, variables)
    for path, x in jax.tree_util.tree_flatten_with_path(v["batch_stats"])[0]:
        name = jax.tree_util.keystr(path)
        x[...] = (rng.uniform(0.5, 1.5, x.shape) if "var" in name
                  else rng.normal(0, 0.2, x.shape))
    att = v["params"]["decoder"]["cell"]["attention"]
    att["window_offset"][...] = 0.7
    att["exp_smoothing_factor"][...] = -0.4
    return v


@pytest.fixture(scope="module")
def models():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = JConfig(**TINY)
    jm = JTacotron2(cfg)
    rng = np.random.default_rng(0)
    text = rng.integers(1, N_SYMBOLS, (B, T_TXT))
    v = jm.init({"params": jax.random.PRNGKey(0),
                 "dropout": jax.random.PRNGKey(1)},
                text=jnp.asarray(text), text_lengths=jnp.asarray(LENGTHS),
                mels=jnp.zeros((B, 16, 80)),
                mel_lengths=jnp.full((B,), 16), speaker_id=jnp.array([1, 3]),
                sylps=jnp.full((B,), 4.0), key=jax.random.PRNGKey(2),
                deterministic=True)
    v = _perturb(v, rng)
    port = Tacotron2(Tacotron2Config(**TINY), device="cpu")
    port.load_state_dict(tacotron2_state_dict_from_jax(
        v["params"], v["batch_stats"]))
    inputs = dict(text=text, text_lengths=LENGTHS, speaker_id=np.array([1, 3]),
                  torchmoji_hidden=rng.normal(0, 1, (B, 8)).astype(np.float32))
    return jm, v, port, inputs


def _close(a, b, atol=1e-5, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=rtol)


def test_prenet_with_injected_masks(models):
    jm, v, port, _ = models
    cfg = dataclasses.replace(JConfig(**TINY), p_prenet_dropout=0.5)
    p = v["params"]["decoder"]["cell"]["prenet"]
    x = np.random.default_rng(1).normal(0, 1, (3, 80)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = JPrenet(cfg).apply({"params": p}, jnp.asarray(x), key)
    masks, k = [], key          # the JAX module's own split/bernoulli chain
    for _ in range(cfg.prenet_layers):
        k, sub = jax.random.split(k)
        masks.append(torch.from_numpy(np.array(
            jax.random.bernoulli(sub, 0.5, (3, cfg.prenet_dim)))))
    net = Prenet(80, Tacotron2Config(**{**TINY, "p_prenet_dropout": 0.5}))
    net.load_state_dict({k_[len("decoder.prenet."):]: t for k_, t in
                         port.state_dict().items()
                         if k_.startswith("decoder.prenet.")})
    _close(net(torch.from_numpy(x), masks=masks).detach(), ref)


def test_zoneout_lstm_cell(models):
    jm, v, port, _ = models
    rng = np.random.default_rng(2)
    cell = port.decoder.attention_rnn
    x = rng.normal(0, 1, (B, cell.input_size)).astype(np.float32)
    c, h = (rng.normal(0, 1, (B, 16)).astype(np.float32) for _ in range(2))
    (c_ref, h_ref), _ = jm.apply(
        v, (jnp.asarray(c), jnp.asarray(h)), jnp.asarray(x),
        method=lambda m, carry, x_: m.decoder.cell.attention_rnn(
            carry, x_, deterministic=True))
    with torch.no_grad():
        c_p, h_p = cell(torch.from_numpy(x),
                        (torch.from_numpy(c), torch.from_numpy(h)))
    _close(c_p, c_ref)
    _close(h_p, h_ref)


def test_location_sensitive_attention_windowed(models):
    jm, v, port, _ = models
    rng = np.random.default_rng(3)
    T = T_TXT
    q = rng.normal(0, 1, (B, 16)).astype(np.float32)
    mem = rng.normal(0, 1, (B, T, 16)).astype(np.float32)
    w = rng.dirichlet(np.ones(T), B).astype(np.float32)
    wc = (w * 3.0).astype(np.float32)
    pos = np.array([2.3, 5.6], np.float32)   # windows away from the start

    def run(m, q_, mem_, lens, state):
        att = m.decoder.cell.attention
        return att(q_, mem_, att.precompute(mem_, lens), state)

    ctx_r, w_r, st_r = jm.apply(
        v, jnp.asarray(q), jnp.asarray(mem), jnp.asarray(LENGTHS),
        JAttentionState(jnp.asarray(w), jnp.asarray(wc), jnp.asarray(pos),
                        jnp.zeros((B, 1))), method=run)
    att = port.decoder.attention_layer
    with torch.no_grad():
        mem_t = torch.from_numpy(mem)
        ctx, wts, st = att(
            torch.from_numpy(q), mem_t,
            att.precompute(mem_t, torch.from_numpy(LENGTHS)),
            AttentionState(torch.from_numpy(w), torch.from_numpy(wc),
                           torch.from_numpy(pos)),
            port.decoder.exp_smoothing_factor)
    # the window really masks: some in-length positions carry no weight
    assert (w_r[0] == 0).any()
    _close(wts, w_r)
    _close(ctx, ctx_r)
    _close(st.weights_cum, st_r.weights_cum)
    _close(st.position, st_r.position)


def test_encoder_unequal_lengths(models):
    jm, v, port, inputs = models
    rng = np.random.default_rng(4)
    emb = rng.normal(0, 1, (B, T_TXT, 16)).astype(np.float32)
    spk = rng.normal(0, 1, (B, 4)).astype(np.float32)
    out_r, syl_r = jm.apply(
        v, jnp.asarray(emb), jnp.asarray(LENGTHS), jnp.asarray(spk),
        method=lambda m, e, l_, s: m.encoder(e, l_, s, deterministic=True))
    with torch.no_grad():
        out, syl = port.encoder(torch.from_numpy(emb), torch.from_numpy(LENGTHS),
                                torch.from_numpy(spk))
    _close(out, out_r)
    _close(syl, syl_r)


def test_postnet(models):
    jm, v, port, _ = models
    mel = np.random.default_rng(5).normal(0, 1, (B, 20, 80)).astype(np.float32)
    ref = jm.apply(v, jnp.asarray(mel),
                   method=lambda m, x: m.postnet(x, deterministic=True))
    with torch.no_grad():
        _close(port.postnet(torch.from_numpy(mel)), ref)


_JITTED = {}


def _jax_inference(jm, v, inputs, **kw):
    """Jitted JAX inference, one compile per decode form."""
    key = tuple(sorted(kw.items()))
    if key not in _JITTED:
        _JITTED[key] = jax.jit(lambda v_, *a: jm.apply(
            v_, *a, key=jax.random.PRNGKey(7), method=JTacotron2.inference,
            **kw))
    return _JITTED[key](v, *(jnp.asarray(inputs[k]) for k in (
        "text", "text_lengths", "speaker_id", "torchmoji_hidden")))


@pytest.mark.parametrize("early_exit", [False, True])
def test_inference_matches_jax(models, early_exit):
    jm, v, port, inputs = models
    kw = dict(max_decoder_steps=64, early_exit=early_exit, chunk_size=16)
    ref = _jax_inference(jm, v, inputs, **kw)
    out = port.inference(**inputs, **kw)
    np.testing.assert_array_equal(out["mel_lengths"].numpy(),
                                  np.asarray(ref["mel_lengths"]))
    for k in ("mel_outputs", "mel_outputs_postnet", "gate_outputs",
              "alignments"):
        assert out[k].shape == ref[k].shape, k
        _close(out[k], ref[k], atol=1e-4, rtol=1e-3)


def test_early_exit_stops_after_gates_fire(models):
    """With every gate firing at once the chunked decode stops one chunk
    after the first: the rest of the buffers stay as the JAX loop leaves
    them (zero mels, -1e4 gates)."""
    jm, v, port, inputs = models
    v2 = jax.tree_util.tree_map(np.array, v)
    v2["params"]["decoder"]["cell"]["gate_layer"]["bias"][...] = 8.0
    sd = port.state_dict()
    sd["decoder.gate_layer.linear_layer.bias"] = torch.full((1,), 8.0)
    port2 = Tacotron2(Tacotron2Config(**TINY), device="cpu")
    port2.load_state_dict(sd)
    kw = dict(max_decoder_steps=64, early_exit=True, chunk_size=16)
    ref = _jax_inference(jm, v2, inputs, **kw)
    out = port2.inference(**inputs, **kw)
    assert (out["gate_outputs"][:, 32:] == -1e4).all()
    assert (out["mel_outputs"][:, 32:] == 0).all()
    np.testing.assert_array_equal(out["mel_lengths"].numpy(),
                                  np.asarray(ref["mel_lengths"]))
    _close(out["mel_outputs_postnet"], ref["mel_outputs_postnet"],
           atol=1e-4, rtol=1e-3)


def test_weights_round_trip(models):
    """JAX -> port state dict -> cookietts_tpu.convert -> JAX gives back the
    same arrays. The zoneout cells' forget bias takes a +1 and a -1 on the
    way (the reference layout keeps the +1 in the bias), so it comes back
    within one float32 rounding; every other array comes back exactly."""
    from cookietts_tpu.convert import convert_tacotron2_state_dict
    _, v, port, _ = models
    params, stats = convert_tacotron2_state_dict(port.state_dict())
    want = jax.tree_util.tree_flatten_with_path(
        {"params": v["params"], "batch_stats": v["batch_stats"]})[0]
    got = dict(jax.tree_util.tree_flatten_with_path(
        {"params": params, "batch_stats": stats})[0])
    assert len(got) == len(want)
    for path, x in want:
        name = jax.tree_util.keystr(path)
        y = np.asarray(got[path]).reshape(np.shape(x))
        if "rnn" in name and "bias" in name:
            np.testing.assert_allclose(y, x, atol=1.2e-7, rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(y, x, err_msg=name)

"""The port's GMM (attention_type 1) and dynamic convolution (2) attention
against the JAX package's on the CPU, at tiny widths (num_att_mixtures=2,
dynamic_filter_num=4, dynamic_filter_len=7).

One step of each module with padded lengths (GMM with delta_min /
delta_offset set and unset); the whole tiny Tacotron2's inference with the
prenet dropout injected (JAX's keep masks, drawn from its per-step keys,
fed to the port's prenet); decode_chunk's chunks joined against one whole
decode; a teacher-forced training forward's loss and every gradient; and
the from_jax state dict loading strictly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cookietts_tpu.losses import tacotron2_loss as jax_loss
from cookietts_tpu.models.tacotron2 import (Tacotron2 as JTacotron2,
                                           Tacotron2Config as JConfig)
from cookietts_tpu.ops import attention as jatt
from cookietts_tpu.text import N_SYMBOLS

from cookietts_tpu_torch.convert.from_jax import (_conv, _lin,
                                                  tacotron2_state_dict_from_jax)
from cookietts_tpu_torch.losses import tacotron2_loss
from cookietts_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
from cookietts_tpu_torch.ops import attention as patt
from tests.test_torch_train_tacotron2 import (KEY, TINY as TRAIN_TINY,
                                              grads_as_state_dict, make_batch,
                                              sylps_eps)
from test_torch_threads import _one_thread  # noqa: F401


TYPES = dict(num_att_mixtures=2, dynamic_filter_num=4, dynamic_filter_len=7)
B, T, Q, A, D = 2, 11, 16, 8, 12
LENGTHS = np.array([11, 7])


def _t(x):
    return torch.from_numpy(np.array(x))


def _state(rng, k):
    w = rng.dirichlet(np.ones(T), B).astype(np.float32)
    return (w, (w * 2.5).astype(np.float32),
            rng.uniform(0, 3, B).astype(np.float32),
            rng.uniform(0, 4, (B, k)).astype(np.float32))


def _step(jmod, pmod, rng, k):
    """One step of both modules from the same state; returns
    ((ctx, w, state) JAX, (ctx, w, state) port)."""
    q = rng.normal(0, 1, (B, Q)).astype(np.float32)
    mem = rng.normal(0, 1, (B, T, D)).astype(np.float32)
    st = _state(rng, k)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(q), jnp.asarray(mem),
                       {"mask": jnp.ones((B, T), bool)},
                       jatt.AttentionState(*map(jnp.asarray, st)))["params"]
    const = {"mask": jnp.arange(T)[None] < LENGTHS[:, None]}
    ref = jmod.apply({"params": params}, jnp.asarray(q), jnp.asarray(mem),
                     const, jatt.AttentionState(*map(jnp.asarray, st)))
    sd = {}
    if "lin" in params:
        _lin(sd, "F.0.linear_layer", params["F"])
        _lin(sd, "F.2", params["lin"])
    else:
        for name in ("dynamic_fc", "W_static", "W_dynamic", "v"):
            _lin(sd, name, params[name])
        _conv(sd, "static_conv", params["static_conv"])
    pmod.load_state_dict(sd)
    mem_t = _t(mem)
    with torch.no_grad():
        got = pmod(_t(q), mem_t, pmod.precompute(mem_t, _t(LENGTHS)),
                   patt.AttentionState(*map(_t, st)))
    return ref, got


def _close(got, ref, atol=2e-5, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("delta_min,delta_offset", [(0.0, 0.0), (0.4, 0.005)])
def test_gmm_step_matches_jax(delta_min, delta_offset):
    rng = np.random.default_rng(1)
    jmod = jatt.GMMAttention(n_mixtures=2, attention_dim=A, delta_min=delta_min,
                             delta_offset=delta_offset)
    pmod = patt.GMMAttention(Q, 2, A, delta_min, delta_offset)
    (ctx_r, w_r, st_r), (ctx, w, st) = _step(jmod, pmod, rng, 2)
    # padded positions score 0, not -inf: they keep softmax weight
    assert float(w[1, 7:].sum()) > 0
    _close(w, w_r)
    _close(ctx, ctx_r)
    _close(st.mu, st_r.mu)
    _close(st.position, st_r.position)
    _close(st.weights_cum, st_r.weights_cum)


def test_dca_step_matches_jax():
    rng = np.random.default_rng(2)
    jmod = jatt.DynamicConvolutionAttention(
        attention_dim=A, dynamic_channels=4, dynamic_kernel_size=7)
    pmod = patt.DynamicConvolutionAttention(Q, A, dynamic_channels=4,
                                            dynamic_kernel_size=7)
    (ctx_r, w_r, st_r), (ctx, w, st) = _step(jmod, pmod, rng, 1)
    assert float(w[1, 7:].abs().max()) == 0.0      # padded: no weight
    _close(w, w_r)
    _close(ctx, ctx_r)
    _close(st.position, st_r.position)
    np.testing.assert_array_equal(st.mu.numpy(), np.asarray(st_r.mu))
    np.testing.assert_allclose(
        pmod.prior_filter.view(-1).numpy(),
        jatt._beta_binomial_prior(11, 0.1, 0.9)[::-1], rtol=1e-6)
    init = pmod.init_state(B, T, "cpu")
    ref = jmod.init_state(B, T)
    for got, want in zip(init, ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the whole tiny Tacotron2 ---------------------------------------------------

INFER = dict(TRAIN_TINY, p_prenet_dropout=0.5, use_postnet=True, **TYPES)
STEPS = 12


@pytest.fixture(scope="module", params=[1, 2], ids=["gmm", "dca"])
def model(request):
    cfg = dict(INFER, attention_type=request.param)
    jm = JTacotron2(JConfig(**cfg))
    rng = np.random.default_rng(request.param)
    batch = make_batch(rng)
    v = jax.jit(jm.init, static_argnames=("deterministic",))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        text=batch["text"], text_lengths=batch["text_lengths"],
        mels=batch["mels"], mel_lengths=batch["mel_lengths"],
        speaker_id=batch["speaker_id"], sylps=batch["sylps"],
        key=jax.random.PRNGKey(2), deterministic=True)
    stats = jax.tree_util.tree_map(
        lambda x: np.asarray(rng.uniform(0.5, 1.5, x.shape), np.float32),
        v["batch_stats"])
    port = Tacotron2(Tacotron2Config(**cfg), device="cpu")
    sd = tacotron2_state_dict_from_jax(v["params"], stats)
    port.load_state_dict(sd)
    return dict(type=request.param, cfg=cfg, jm=jm, params=v["params"],
                stats=stats, batch=batch, port=port, sd=sd)


def prenet_masks(key, steps, B_, dim, p=0.5, layers=2):
    """JAX inference's prenet keep masks: key -> (_, _, k_dec); one key a
    step; each step's k_pre, split once a layer."""
    _, _, k_dec = jax.random.split(key, 3)
    masks = []
    for k in jax.random.split(k_dec, steps):
        k_pre = jax.random.split(k, 4)[0]
        step = []
        for _ in range(layers):
            k_pre, sub = jax.random.split(k_pre)
            step.append(_t(jax.random.bernoulli(sub, 1.0 - p, (B_, dim))))
        masks.append(step)
    return masks


def test_from_jax_state_dict_loads_strictly_and_round_trips(model):
    port, sd = model["port"], model["sd"]
    got = port.state_dict()
    assert set(sd) <= set(got)
    assert all(k.endswith("num_batches_tracked") for k in set(got) - set(sd))
    for k, t in sd.items():
        assert torch.equal(got[k], t), k
    names = {"gmm": ("F.0.linear_layer.weight", "F.0.linear_layer.bias",
                     "F.2.weight"),
             "dca": ("dynamic_fc.weight", "dynamic_fc.bias", "static_conv.weight",
                     "W_static.weight", "W_dynamic.weight", "W_dynamic.bias",
                     "v.weight")}["gmm" if model["type"] == 1 else "dca"]
    att = sorted(k[len("decoder.attention_layer."):] for k in sd
                 if k.startswith("decoder.attention_layer."))
    assert att == sorted(names)
    assert "decoder.exp_smoothing_factor" not in sd


def test_inference_matches_jax_with_injected_prenet_dropout(model):
    jm, port, b = model["jm"], model["port"], model["batch"]
    key = jax.random.PRNGKey(7)
    args = [jnp.asarray(b[k]) for k in ("text", "text_lengths", "speaker_id",
                                        "torchmoji")]
    ref = jax.jit(lambda p, s, *a: jm.apply(
        {"params": p, "batch_stats": s}, *a, key=key,
        max_decoder_steps=STEPS, method=JTacotron2.inference))(
            model["params"], model["stats"], *args)
    masks = iter(prenet_masks(key, STEPS, b["text"].shape[0],
                              model["cfg"]["prenet_dim"]))
    prenet = port.decoder.prenet
    forward = prenet.forward
    prenet.forward = lambda x, generator=None: forward(x, masks=next(masks))
    try:
        out = port.inference(b["text"], b["text_lengths"], b["speaker_id"],
                             b["torchmoji"], max_decoder_steps=STEPS)
    finally:
        del prenet.forward
    for k in ("mel_outputs", "mel_outputs_postnet", "gate_outputs", "alignments"):
        _close(out[k], ref[k], atol=1e-4, rtol=1e-3)


def test_decode_chunks_joined_equal_one_decode(model):
    port, b = model["port"], model["batch"]
    memory, const, state = port.inference_prepare(
        b["text"], b["text_lengths"], b["speaker_id"], b["torchmoji"])
    whole = port.decode_chunk(memory, const, state, STEPS,
                              torch.Generator().manual_seed(3))
    g, parts = torch.Generator().manual_seed(3), []
    for steps in (5, 4, 3):
        *out, state = port.decode_chunk(memory, const, state, steps, g)
        parts.append(out)
    for i in range(3):
        assert torch.equal(torch.cat([p[i] for p in parts], 1), whole[i])
    for got, want in zip(torch.utils._pytree.tree_leaves(state),
                         torch.utils._pytree.tree_leaves(whole[3])):
        assert torch.equal(got, want)
    assert state.attention.mu.shape == (b["text"].shape[0],
                                        2 if model["type"] == 1 else 1)


def test_training_forward_loss_and_gradients_match_jax(model):
    """Teacher-forced, training mode, dropouts 0 and no postnet (as
    test_torch_train_tacotron2): loss within relative 1e-5, every
    gradient within relative L2 1e-4."""
    cfg = dict(model["cfg"], p_prenet_dropout=0.0, use_postnet=False)
    jm = JTacotron2(JConfig(**cfg))
    b, stats = model["batch"], model["stats"]
    params = {k: v for k, v in model["params"].items() if k != "postnet"}
    stats = {k: v for k, v in stats.items() if k != "postnet"}

    def loss_fn(p):
        (out, _), _ = jm.apply(
            {"params": p, "batch_stats": stats},
            text=b["text"], text_lengths=b["text_lengths"], mels=b["mels"],
            mel_lengths=b["mel_lengths"], speaker_id=b["speaker_id"],
            sylps=b["sylps"], torchmoji_hidden=b["torchmoji"], key=KEY,
            deterministic=False, rngs={"dropout": jax.random.PRNGKey(9)},
            mutable=["batch_stats"])
        gt = {k: b[k] for k in ("mels", "mel_lengths", "text_lengths", "sylps",
                                "gate_target", "pres_prev_state")}
        return jax_loss(out, gt)[0]

    total, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    port = Tacotron2(Tacotron2Config(**cfg), device="cpu")
    port.load_state_dict(tacotron2_state_dict_from_jax(params, stats))
    port.train()
    t = {k: _t(v) for k, v in b.items()}
    for k in ("text", "text_lengths", "mel_lengths", "speaker_id"):
        t[k] = t[k].long()
    out, _ = port(t["text"], t["text_lengths"], t["mels"], t["mel_lengths"],
                  t["speaker_id"], t["sylps"], t["torchmoji"],
                  generator=torch.Generator().manual_seed(0),
                  sylps_noise=_t(sylps_eps(KEY)))
    p_total, _, _ = tacotron2_loss(out, {k: t[k] for k in (
        "mels", "mel_lengths", "text_lengths", "sylps", "gate_target",
        "pres_prev_state")})
    p_total.backward()
    np.testing.assert_allclose(p_total.item(), float(total), rtol=1e-5)
    ref = grads_as_state_dict(grads, stats)
    g_all = np.sqrt(sum(float((r.double() ** 2).sum()) for r in ref.values()))
    for name, p in port.named_parameters():
        if not p.requires_grad:
            continue
        want = ref[name].numpy().astype(np.float64)
        got = p.grad.numpy().astype(np.float64)
        # a gradient zero up to rounding (a conv bias ahead of a training
        # BatchNorm) is held to the whole gradient's norm
        scale = np.linalg.norm(want)
        scale = g_all if scale < 1e-6 * g_all else scale
        assert np.linalg.norm(got - want) <= 1e-4 * scale, name

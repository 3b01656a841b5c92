"""The port's Tacotron2 training against the JAX model's, on the CPU.

A tiny JAX Tacotron2 is carried across with
``convert.from_jax.tacotron2_state_dict_from_jax``; both take the same numpy
batch in training mode (BatchNorm on batch statistics) with dropout and
zoneout 0 and no postnet (its dropout is fixed at 0.5 in JAX), so nothing is
random but SylpsNet's eps, which is taken from the JAX key and passed in.
The loss terms, every parameter's gradient (mapped through the converter:
the trained half of each split bias gets JAX's whole bias gradient), one
clipped Adam step with the BatchNorm running statistics, the TBPTT carry
over two segments and ``adapt_carry`` are held against JAX; so are zoneout
1.0 (every state element held) and the postnet's gradients in eval mode.
The JAX side is computed once for the module: one jitted value_and_grad
serves every case of the base configuration.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cookietts_tpu.losses import tacotron2_loss as jax_loss
from cookietts_tpu.models.tacotron2 import (DecoderCarry, Postnet as JPostnet,
                                           Tacotron2 as JTacotron2,
                                           Tacotron2Config as JConfig)
from cookietts_tpu.ops.attention import AttentionState as JAttentionState
from cookietts_tpu.runtime import optim as jax_optim
from cookietts_tpu.runtime.trainer import adapt_carry as jax_adapt_carry
from cookietts_tpu.text import N_SYMBOLS

from cookietts_tpu_torch.convert.from_jax import tacotron2_state_dict_from_jax
from cookietts_tpu_torch.losses import tacotron2_loss
from cookietts_tpu_torch.models.tacotron2 import (DecoderState, Tacotron2,
                                                  Tacotron2Config, TrainCarry)
from cookietts_tpu_torch.ops.attention import AttentionState
from cookietts_tpu_torch.runtime.optim import adam, clip_by_global_norm
from cookietts_tpu_torch.runtime.train_state import TrainState
from cookietts_tpu_torch.runtime.trainer import adapt_carry

TINY = dict(
    n_symbols=N_SYMBOLS, symbols_embedding_dim=16, n_speakers=4,
    speaker_embedding_dim=8, encoder_speaker_embed_dim=4,
    encoder_conv_hidden_dim=16, encoder_lstm_dim=16,
    encoder_n_convolutions=2, torchmoji_dim=8, torchmoji_crushed_dim=4,
    memory_bottleneck_dim=16, prenet_dim=8, attention_rnn_dim=16,
    decoder_rnn_dim=16, second_decoder_rnn_dim=16, attention_dim=8,
    windowed_attention_range=2, postnet_embedding_dim=16,
    postnet_n_convolutions=3, postnet_residual_connections=2,
    p_prenet_dropout=0.0, encoder_conv_dropout=0.0, p_attrnn_dropout=0.0,
    p_decrnn_dropout=0.0, use_postnet=False)
B, T_TXT, T_DEC, M = 3, 12, 10, 80
KEY = jax.random.PRNGKey(5)
LOSS_RTOL, G_ATOL, G_RTOL = 1e-5, 1e-6, 1e-4
ZONEOUT = dict(TINY, attrnn_zoneout=1.0, decrnn_zoneout=1.0)
# reached only through the rounded window position: zero gradient in JAX too
NO_GRADIENT = ("decoder.exp_smoothing_factor",
               "decoder.attention_layer.windowed_att_pos_offset")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One thread for torch's and for BLAS's pools: as fast here at these
    sizes, and the suite's parallel workers share the machine's cores (a
    BLAS pool spinning on busy cores makes one SVD take seconds)."""
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def make_batch(rng, pres=(0.0, 0.0, 0.0)):
    text = rng.integers(1, N_SYMBOLS, (B, T_TXT))
    tl = np.array([12, 7, 9])
    ml = np.array([10, 6, 8])
    valid = np.arange(T_DEC)[None, :, None] < ml[:, None, None]
    return dict(
        text=text, text_lengths=tl,
        mels=(rng.normal(0, 1, (B, T_DEC, M)) * valid).astype(np.float32),
        mel_lengths=ml, speaker_id=np.array([1, 3, 0]),
        sylps=np.array([3.0, 4.5, 5.0], np.float32),
        torchmoji=rng.normal(0, 1, (B, 8)).astype(np.float32),
        gate_target=(np.arange(T_DEC)[None] >= ml[:, None] - 1).astype(
            np.float32),
        pres_prev_state=np.asarray(pres, np.float32),
        global_mean=rng.normal(0, 1, M).astype(np.float32))


def sylps_eps(key):
    """SylpsNet's eps as the JAX model draws it from ``key``."""
    _, k_mem, _, _ = jax.random.split(key, 4)
    _, syl_key = jax.random.split(k_mem)
    return np.asarray(jax.random.normal(syl_key, (B,)))


def jax_fresh_carry(jm, v):
    return jm.apply(v, B, T_TXT, TINY["memory_bottleneck_dim"], jnp.float32,
                    method=lambda m, *a: m.decoder.init_carry(*a))


def jax_value_and_grad(jm):
    """jitted (params, stats, batch, p_tf, dfr, carry) -> (loss, loss_dict,
    new stats, carry), grads. The carry always goes in: a batch whose
    pres_prev_state is 0 everywhere starts from fresh state, so one program
    serves fresh and continued segments."""
    def loss_fn(params, stats, batch, p_tf, dfr, carry):
        (out, new_carry), mut = jm.apply(
            {"params": params, "batch_stats": stats},
            text=batch["text"], text_lengths=batch["text_lengths"],
            mels=batch["mels"], mel_lengths=batch["mel_lengths"],
            speaker_id=batch["speaker_id"], sylps=batch["sylps"],
            torchmoji_hidden=batch["torchmoji"], key=KEY,
            p_teacher_forcing=p_tf, teacher_force_till=0,
            drop_frame_rate=dfr, global_mean=batch["global_mean"],
            deterministic=False, init_carry=carry,
            pres_prev_state=batch["pres_prev_state"],
            rngs={"dropout": jax.random.PRNGKey(9)}, mutable=["batch_stats"])
        gt = {k: batch[k] for k in ("mels", "mel_lengths", "text_lengths",
                                    "sylps", "gate_target", "pres_prev_state")}
        total, ld, _ = jax_loss(out, gt)
        return total, (ld, mut["batch_stats"], new_carry)
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def to_port_carry(c) -> TrainCarry:
    t = lambda x: torch.from_numpy(np.array(x))
    return TrainCarry(DecoderState(
        (t(c.attn_cell[0]), t(c.attn_cell[1])),
        (t(c.dec_cell[0]), t(c.dec_cell[1])),
        (t(c.dec2_cell[0]), t(c.dec2_cell[1])),
        AttentionState(t(c.attention.weights), t(c.attention.weights_cum),
                       t(c.attention.position)),
        t(c.context), t(c.prev_output), t(c.finished)), t(c.prev_teacher))


def to_jax_carry(c: TrainCarry) -> DecoderCarry:
    a = lambda x: jnp.asarray(x.detach().numpy())
    s = c.state
    return DecoderCarry(
        (a(s.attn[0]), a(s.attn[1])), (a(s.dec[0]), a(s.dec[1])),
        (a(s.dec2[0]), a(s.dec2[1])),
        JAttentionState(a(s.attention.weights), a(s.attention.weights_cum),
                        a(s.attention.position), jnp.zeros((B, 1))),
        a(s.context), a(s.prev_output), a(c.prev_teacher), a(s.finished))


def grads_as_state_dict(grads, stats):
    """JAX gradients under the port's names; the converter adds the forget
    +1 to a zoneout cell's bias_ih, which a gradient must not get."""
    sd = tacotron2_state_dict_from_jax(grads, stats)
    for k in sd:
        if k.endswith("rnn.bias_ih"):
            H = sd[k].shape[0] // 4
            sd[k][H:2 * H] -= 1.0
    return sd


def port_step(port, batch, p_tf=1.0, dfr=0.0, carry=None):
    """Port loss, loss dict, carry and gradients by name, in training mode."""
    t = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    for k in ("text", "text_lengths", "mel_lengths", "speaker_id"):
        t[k] = t[k].long()
    port.train()
    port.zero_grad()
    out, new_carry = port(
        t["text"], t["text_lengths"], t["mels"], t["mel_lengths"],
        t["speaker_id"], t["sylps"], t["torchmoji"],
        generator=torch.Generator().manual_seed(0), p_teacher_forcing=p_tf,
        drop_frame_rate=dfr, global_mean=t["global_mean"], init_carry=carry,
        pres_prev_state=t["pres_prev_state"],
        sylps_noise=torch.from_numpy(np.array(sylps_eps(KEY))))
    total, ld, _ = tacotron2_loss(out, {k: t[k] for k in (
        "mels", "mel_lengths", "text_lengths", "sylps", "gate_target",
        "pres_prev_state")})
    total.backward()
    grads = {n: p.grad for n, p in port.named_parameters() if p.requires_grad}
    return total, ld, new_carry, grads


@pytest.fixture(scope="module")
def setup():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    batch = make_batch(rng)
    jm = JTacotron2(JConfig(**TINY))
    v = jax.jit(jm.init, static_argnames=("deterministic",))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        text=batch["text"], text_lengths=batch["text_lengths"],
        mels=batch["mels"], mel_lengths=batch["mel_lengths"],
        speaker_id=batch["speaker_id"], sylps=batch["sylps"],
        key=jax.random.PRNGKey(2), deterministic=True)
    stats = jax.tree_util.tree_map(
        lambda x: np.asarray(rng.uniform(0.5, 1.5, x.shape), np.float32),
        v["batch_stats"])                 # non-trivial running statistics
    fn = jax_value_and_grad(jm)
    fresh = jax_fresh_carry(jm, v)
    runs = {}
    for name, p_tf, dfr in (("teacher", 1.0, 0.0), ("free", 0.0, 0.0),
                            ("dropframe", 1.0, 1.0)):
        runs[name] = fn(v["params"], stats, batch, p_tf, dfr, fresh)
    # TBPTT: the teacher-forced segment's carry continues lanes 0 and 2
    seg2 = make_batch(np.random.default_rng(1), pres=(1.0, 0.0, 1.0))
    runs["segment2"] = fn(v["params"], stats, seg2, 1.0, 0.0,
                          runs["teacher"][0][1][2])
    # zoneout 1.0: the same parameters in another configuration
    jm_z = JTacotron2(JConfig(**ZONEOUT))
    runs["zoneout"] = jax_value_and_grad(jm_z)(v["params"], stats, batch,
                                               1.0, 0.0, fresh)

    def new_port(cfg=TINY):
        port = Tacotron2(Tacotron2Config(**cfg), device="cpu")
        port.load_state_dict(tacotron2_state_dict_from_jax(v["params"], stats))
        return port
    return dict(jm=jm, v=v, stats=stats, batch=batch, seg2=seg2, runs=runs,
                new_port=new_port)


def check_loss_and_grads(jax_run, port_run, stats):
    (total, (ld, _, _)), grads = jax_run
    p_total, p_ld, _, p_grads = port_run
    np.testing.assert_allclose(p_total.item(), float(total), rtol=LOSS_RTOL)
    for k in ("spec_MSE", "spec_MFSE", "gate_loss", "sylps_kld", "sylps_MSE",
              "sylps_MAE", "diag_att"):
        np.testing.assert_allclose(p_ld[k].item(), float(ld[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    ref = grads_as_state_dict(grads, stats)
    for name, g in p_grads.items():
        if name in NO_GRADIENT:
            assert g is None and not np.any(ref[name].numpy())
            continue
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(),
                                   atol=G_ATOL, rtol=G_RTOL, err_msg=name)


@pytest.mark.parametrize("case", ["teacher", "free", "dropframe"])
def test_loss_and_every_gradient_match_jax(setup, case):
    """Teacher-forced, free-running (p_teacher_forcing 0) and drop-frame 1
    (every valid input frame becomes the global mean)."""
    p_tf, dfr = {"teacher": (1.0, 0.0), "free": (0.0, 0.0),
                 "dropframe": (1.0, 1.0)}[case]
    port = setup["new_port"]()
    run = port_step(port, setup["batch"], p_tf, dfr)
    check_loss_and_grads(setup["runs"][case], run, setup["stats"])


def test_every_trainable_parameter_gets_a_gradient(setup):
    port = setup["new_port"]()
    _, _, _, grads = port_step(port, setup["batch"])
    frozen = sorted(n for n, p in port.named_parameters()
                    if not p.requires_grad)
    # the reference's second LSTM bias of each pair, kept out of training
    assert frozen == sorted(
        ["decoder.attention_rnn.bias_hh", "decoder.decoder_rnn.bias_hh",
         "decoder.second_decoder_rnn.bias_hh", "encoder.lstm.bias_hh_l0",
         "encoder.lstm.bias_hh_l0_reverse"])
    for name, g in grads.items():
        if name not in NO_GRADIENT:
            assert g is not None and bool(g.abs().sum() > 0), name


def test_adam_step_and_batchnorm_statistics_match_jax(setup):
    """One clipped Adam step from the same gradients moves the parameters
    as JAX's; the BatchNorm running statistics follow flax's update."""
    port = setup["new_port"]()
    state = TrainState.create(port, adam())
    _, _, _, grads = port_step(port, setup["batch"])
    clipped, norm = clip_by_global_norm(grads, 0.5)
    state.apply_gradients(clipped, lr=1e-3)

    (_, (_, new_stats, _)), jg = setup["runs"]["teacher"]

    @jax.jit
    def jax_step(params, grads):
        grads, norm = jax_optim.clip_by_global_norm(grads, 0.5)
        tx = jax_optim.adam()
        updates, _ = tx.update(grads, tx.init(params), params, lr=1e-3)
        return jax_optim.apply_updates(params, updates), norm

    new_params, jnorm = jax_step(setup["v"]["params"], jg)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-5)
    assert float(jnorm) > 0.5                 # the clip is active
    ref = tacotron2_state_dict_from_jax(new_params, new_stats)
    for name, t in port.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        atol = 1e-6
        if name.endswith(".0.conv.bias") and ("encoder." in name
                                              or "postnet." in name):
            # a conv bias ahead of a training-mode BatchNorm: its gradient
            # is zero up to rounding, which Adam turns into a step of up to
            # lr of either sign, on both sides
            atol = 1e-3
        np.testing.assert_allclose(t.numpy(), ref[name].numpy(), atol=atol,
                                   rtol=1e-4, err_msg=name)


def test_tbptt_two_segments_match_jax(setup):
    """Segment 1's carry (the decoder state and the last ground-truth
    frame) equals JAX's; segment 2 continues lanes 0 and 2 from it and
    restarts lane 1 (pres_prev_state 1, 0, 1): loss and gradients match."""
    port = setup["new_port"]()
    _, _, carry, _ = port_step(port, setup["batch"])
    jc = setup["runs"]["teacher"][0][1][2]
    for got, want in zip(jax.tree_util.tree_leaves(to_jax_carry(carry)),
                         jax.tree_util.tree_leaves(jc._replace(
                             attention=jc.attention._replace(
                                 mu=jnp.zeros((B, 1)))))):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-5, rtol=1e-4)
    carry = TrainCarry(*torch.utils._pytree.tree_map(
        torch.Tensor.detach, tuple(carry)))
    port2 = setup["new_port"]()
    run = port_step(port2, setup["seg2"], carry=carry)
    check_loss_and_grads(setup["runs"]["segment2"], run, setup["stats"])
    fresh = port_step(setup["new_port"](), setup["seg2"])
    assert abs(float(fresh[0]) - float(run[0])) > 1e-4   # the carry counts


@pytest.mark.parametrize("t_enc,batch", [(16, 3), (8, 3), (12, 5), (9, 2)])
def test_adapt_carry_matches_jax(setup, t_enc, batch):
    """A carry fitted to a new text length (zero-padded or cut) and a new
    batch size (lanes dropped or zero-filled), as JAX's adapt_carry."""
    rng = np.random.default_rng(t_enc * 10 + batch)
    jc = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.normal(0, 1, x.shape).astype(x.dtype)
                              if x.dtype != bool else x),
        setup["runs"]["teacher"][0][1][2])
    want = jax_adapt_carry(jc, t_enc, batch)
    got = adapt_carry(to_port_carry(jc), t_enc, batch)
    want = want._replace(attention=want.attention._replace(
        mu=jnp.zeros((batch, 1))))
    assert got.state.attention.weights.shape == (batch, t_enc)
    got_j = jax.tree_util.tree_leaves(to_jax_carry_any(got, batch))
    for g, w in zip(got_j, jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def to_jax_carry_any(c: TrainCarry, batch):
    a = lambda x: jnp.asarray(x.numpy())
    s = c.state
    return DecoderCarry(
        (a(s.attn[0]), a(s.attn[1])), (a(s.dec[0]), a(s.dec[1])),
        (a(s.dec2[0]), a(s.dec2[1])),
        JAttentionState(a(s.attention.weights), a(s.attention.weights_cum),
                        a(s.attention.position), jnp.zeros((batch, 1))),
        a(s.context), a(s.prev_output), a(c.prev_teacher), a(s.finished))


def test_zoneout_one_holds_the_state_and_matches_jax(setup):
    """Zoneout 1.0 in training keeps every cell's previous (here zero)
    state: the loss and every gradient match JAX's, and the cells' weights
    get none."""
    run = port_step(setup["new_port"](ZONEOUT), setup["batch"])
    check_loss_and_grads(setup["runs"]["zoneout"], run, setup["stats"])
    state = run[2].state
    assert not state.attn[1].any() and not state.dec2[0].any()
    assert not run[3]["decoder.decoder_rnn.weight_hh"].any()


def test_postnet_gradients_in_eval_mode_match_jax(setup):
    """The postnet (dropout 0.5 in JAX training, so compared in eval form:
    BatchNorm on its running statistics) gets JAX's gradients."""
    rng = np.random.default_rng(7)
    cfg = JConfig(**dict(TINY, use_postnet=True))
    mel = rng.normal(0, 1, (B, T_DEC, M)).astype(np.float32)
    r = rng.normal(0, 1, (B, T_DEC, M)).astype(np.float32)
    post = jax.jit(JPostnet(cfg).init, static_argnames=("deterministic",))(
        jax.random.PRNGKey(3), mel, deterministic=True)
    post_stats = jax.tree_util.tree_map(
        lambda x: np.asarray(rng.uniform(0.5, 1.5, x.shape), np.float32),
        post["batch_stats"])

    def loss(p):
        out = JPostnet(cfg).apply({"params": p, "batch_stats": post_stats},
                                  mel, deterministic=True)
        return jnp.mean(out * r)

    grads = jax.jit(jax.grad(loss))(post["params"])
    v = setup["v"]
    ref = tacotron2_state_dict_from_jax(
        {**v["params"], "postnet": grads},
        {**setup["stats"], "postnet": post_stats})
    port = Tacotron2(Tacotron2Config(**dict(TINY, use_postnet=True)),
                     device="cpu")
    port.load_state_dict(tacotron2_state_dict_from_jax(
        {**v["params"], "postnet": post["params"]},
        {**setup["stats"], "postnet": post_stats}))
    port.eval()
    (port.postnet(torch.from_numpy(mel)) * torch.from_numpy(r)).mean().backward()
    names = [n for n, _ in port.named_parameters() if n.startswith("postnet.")]
    assert len(names) == 8              # 3 convs' weight and bias, 1 BatchNorm
    for n, p in port.named_parameters():
        if n in names:
            np.testing.assert_allclose(p.grad.numpy(), ref[n].numpy(),
                                       atol=G_ATOL, rtol=G_RTOL, err_msg=n)

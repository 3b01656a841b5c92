"""The port's UnTTS (models/untts.py, its loss and train step) against the
JAX package's, on the CPU, at a tiny width (16-wide embeddings, one FFT
block, decoder 2 flows x 2 layers x 16 channels over 12 mels, VarGlow 4
flows over groups of 4 chars).

Weights are a JAX init plus noise (std 0.05, so the zero-initialised WN end
layers give nonzero log_s and t and exp(-log_s) stays tame), carried across
with convert/from_jax.py; inputs come from ``numpy.random.default_rng``;
dropout is 0 and the latents are JAX's (or zero). Tolerances: 1e-5 absolute
and 1e-4 relative; one train step's gradients within relative L2 1e-4 of
``jax.value_and_grad``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cookietts_tpu.models import untts as J
from cookietts_tpu.runtime.trainer import _untts_loss_fn as j_loss_fn
from cookietts_tpu_torch.convert.from_jax import untts_params_from_jax
from cookietts_tpu_torch.models import untts as P
from cookietts_tpu_torch.runtime.optim import adam
from cookietts_tpu_torch.runtime.train_state import TrainState
from cookietts_tpu_torch.runtime.trainer import make_untts_train_step
from test_torch_threads import _one_thread  # noqa: F401

TINY = dict(n_symbols=40, symbols_embedding_dim=16, n_speakers=4,
            speaker_embedding_dim=8, n_mel_channels=12, enc_layers=1,
            enc_heads=2, enc_ffn_dim=24, predictor_filter_size=8,
            predictor_layers=1, dec_n_flows=2, dec_n_layers=2,
            dec_n_channels=16, dropout=0.0, use_varglow=True)
VARIANTS = {"varglow": {}, "posattn": dict(use_varglow=False,
                                           use_positional_attention=True)}
B, N, T, MAX_FRAMES = 2, 7, 20, 48
TOL = dict(atol=1e-5, rtol=1e-4)
INTS = ("text", "text_lengths", "mel_lengths", "speaker_id", "durations")


def _batch(rng):
    durations = rng.integers(1, 4, (B, N)).astype(np.int32)
    durations[1, N - 2:] = 0
    return dict(
        text=rng.integers(1, 40, (B, N)).astype(np.int32),
        text_lengths=np.array([N, N - 2], np.int32),
        mels=rng.standard_normal((B, T, 12)).astype(np.float32),
        mel_lengths=np.minimum(durations.sum(1), T).astype(np.int32),
        speaker_id=np.array([0, 3], np.int32), durations=durations,
        f0=rng.standard_normal((B, N)).astype(np.float32),
        energy=rng.standard_normal((B, N)).astype(np.float32),
        frame_f0=rng.standard_normal((B, T)).astype(np.float32),
        frame_energy=rng.standard_normal((B, T)).astype(np.float32),
        frame_voiced=(rng.random((B, T)) > 0.5).astype(np.float32))


def _torch(batch):
    return {k: torch.as_tensor(v.astype(np.int64) if k in INTS else v)
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_side():
    """Per variant: JAX's model, noisy params, a batch, and the port's model
    with the converted weights."""
    out = {}
    for name, extra in VARIANTS.items():
        rng = np.random.default_rng(0)
        cfg = dict(TINY, **extra)
        model = J.UnTTS(J.UnTTSConfig(**cfg))
        batch = _batch(rng)
        v = model.init({"params": jax.random.PRNGKey(0),
                        "dropout": jax.random.PRNGKey(1)}, **batch,
                       deterministic=True)
        params = jax.tree_util.tree_map(
            lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
                np.shape(a)).astype(np.float32), v["params"])
        port = P.UnTTS(P.UnTTSConfig(**cfg), device="cpu")
        port.load_state_dict(untts_params_from_jax(params))
        out[name] = dict(model=model, params={"params": params}, batch=batch,
                         port=port, rng=rng)
    return out


def _close(got, want, what="", **tol):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got)
                                          else got), np.asarray(want),
                               err_msg=what, **(tol or TOL))


def test_converted_keys_are_the_models(jax_side):
    for side in jax_side.values():
        want = set(side["port"].state_dict())
        assert set(untts_params_from_jax(side["params"]["params"])) == want


def test_fft_block_and_predictor_with_padded_rows(jax_side):
    """FFTBlock (flax attention: a row of length 0 attends uniformly) and
    the duration predictor, on rows of length 7, 3 and 0."""
    s = jax_side["varglow"]
    rng = np.random.default_rng(1)
    mask = np.arange(N)[None] < np.array([N, 3, 0])[:, None]
    x = rng.standard_normal((3, N, 16)).astype(np.float32)
    want = s["model"].apply(s["params"], x, mask, method=lambda m, x, k:
                            m.enc_blocks[0](x, k, deterministic=True))
    got = s["port"].enc0(torch.from_numpy(x), torch.from_numpy(mask))
    _close(got, want, "FFTBlock")
    enc = rng.standard_normal((3, N, 24)).astype(np.float32)
    want = s["model"].apply(s["params"], enc, mask, method=lambda m, x, k:
                            m.duration_predictor(x, k, True))
    got = s["port"].duration_predictor(torch.from_numpy(enc),
                                       torch.from_numpy(mask))
    _close(got, want, "TemporalPredictor")


def test_length_regulate():
    """The JAX test's case, and JAX's function on random durations."""
    feats = torch.arange(6, dtype=torch.float32).reshape(1, 3, 2)
    frames, mask = P.length_regulate(feats, torch.tensor([[2, 1, 3]]), 8)
    expect = [[0, 1], [0, 1], [2, 3], [4, 5], [4, 5], [4, 5], [0, 0], [0, 0]]
    assert frames[0].tolist() == expect
    assert mask[0].tolist() == [True] * 6 + [False] * 2
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((2, 5, 3)).astype(np.float32)
    dur = rng.integers(0, 4, (2, 5)).astype(np.int32)
    wf, wm = J.length_regulate(jnp.asarray(feats), jnp.asarray(dur), 12)
    gf, gm = P.length_regulate(torch.from_numpy(feats),
                               torch.from_numpy(dur.astype(np.int64)), 12)
    _close(gf, wf)
    assert (gm.numpy() == np.asarray(wm)).all()


def test_positional_attention(jax_side):
    s = jax_side["posattn"]
    rng = np.random.default_rng(3)
    enc = rng.standard_normal((B, N, 24)).astype(np.float32)
    mask = np.arange(N)[None] < np.array([N, 4])[:, None]
    want = s["model"].apply(s["params"], enc, mask, method=lambda m, e, k:
                            m.pos_attention(e, k, 13, True))
    got = s["port"].pos_attention(torch.from_numpy(enc),
                                  torch.from_numpy(mask), 13)
    _close(got, want)


def test_mel_flow_decoder_forward_inverse_and_roundtrip(jax_side):
    """forward (log_s, log-determinants, z) and inverse against JAX with a
    frame mask, the inverse through WN.forward (the kernel's entry), and
    inverse(forward(mel)) = mel on the valid frames."""
    s = jax_side["varglow"]
    port = s["port"]
    for wn in port.decoder.wn:
        assert float(wn.end.weight.detach().abs().max()) > 0.02
    rng = np.random.default_rng(4)
    mel = rng.standard_normal((B, T, 12)).astype(np.float32)
    cond = rng.standard_normal((B, T, 16)).astype(np.float32)
    mask = np.arange(T)[None] < np.array([T, 13])[:, None]
    wz, wls, wlw, wn_ = s["model"].apply(
        s["params"], mel, cond, mask,
        method=lambda m, *a: m.decoder.forward(*a))
    args = [torch.from_numpy(a) for a in (mel, cond, mask)]
    gz, gls, glw, gn = port.decoder(*args)
    _close(gz, wz, "z")
    _close(gls, wls, "log_s_sum")
    _close(glw, wlw, "logdet_w_sum")
    assert float(gn) == float(wn_) and abs(float(gls.detach())) > 1e-2
    z = rng.standard_normal((B, T, 12)).astype(np.float32)
    want = s["model"].apply(s["params"], z, cond, mask,
                            method=lambda m, *a: m.decoder.inverse(*a))
    _close(port.decoder.inverse(torch.from_numpy(z), *args[1:]), want,
           "inverse")
    back = port.decoder.inverse(gz, *args[1:])
    _close(back * args[2][:, :, None], mel * mask[:, :, None],
           "inverse(forward)", atol=1e-4, rtol=1e-4)


def test_varglow_forward_inverse_sample(jax_side):
    """N = 7 chars in groups of 4 (the tail group edge-padded, masked by
    group), the inverse and sample(sigma=0) against JAX."""
    s = jax_side["varglow"]
    rng = np.random.default_rng(5)
    values = rng.standard_normal((B, N, 2)).astype(np.float32)
    feats = rng.standard_normal((B, N, 24)).astype(np.float32)
    mask = np.arange(N)[None] < np.array([N, 3])[:, None]
    want = s["model"].apply(s["params"], values, feats, mask,
                            method=lambda m, *a: m.varglow.forward(*a))
    got = s["port"].varglow(*[torch.from_numpy(a)
                              for a in (values, feats, mask)])
    for g, w, what in zip(got, want, ("z", "log_s", "logdet_w", "n")):
        _close(g, w, what)
    z = rng.standard_normal((B, 2, 8)).astype(np.float32)
    want = s["model"].apply(s["params"], z, feats,
                            method=lambda m, *a: m.varglow.inverse(*a))
    _close(s["port"].varglow.inverse(torch.from_numpy(z),
                                     torch.from_numpy(feats)), want, "inverse")
    want = s["model"].apply(s["params"], feats, jax.random.PRNGKey(3), 0.0,
                            method=lambda m, *a: m.varglow.sample(*a))
    got = s["port"].varglow.sample(torch.from_numpy(feats), sigma=0.0)
    assert got.shape == (B, 8, 2)
    _close(got, want, "sample(sigma=0)")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_and_losses(jax_side, variant):
    """The training forward, untts_loss and (VarGlow) varglow_loss."""
    s = jax_side[variant]
    b = s["batch"]
    out = s["model"].apply(s["params"], **b, deterministic=True)
    gt = {k: b[k] for k in ("durations", "f0", "energy")}
    w_total, w_ld = J.untts_loss(out, gt)
    got = s["port"](**_torch(b), deterministic=True)
    for k in ("z", "log_s_sum", "logdet_w_sum", "log_dur_pred", "f0_pred",
              "energy_pred", "n_elements", "varglow_z", "varglow_log_s"):
        if k in out:
            _close(got[k], out[k], k)
    g_total, g_ld = P.untts_loss(got, _torch(gt))
    for k, v in w_ld.items():
        _close(g_ld[k], v, k)
    if variant == "varglow":
        args = [out[k] for k in ("varglow_z", "varglow_log_s",
                                 "varglow_logdet_w", "varglow_n")]
        _close(P.varglow_loss(*[got[k] for k in ("varglow_z", "varglow_log_s",
                                                 "varglow_logdet_w",
                                                 "varglow_n")]),
               J.varglow_loss(*args), "varglow_loss")


@pytest.mark.parametrize("case", ["plain", "z", "sample_prosody", "posattn"])
def test_inference(jax_side, case):
    """inference at sigma=0, with JAX's z, with VarGlow's sample_prosody
    (prosody_sigma=0) and with positional attention: the mels, durations
    and lengths."""
    s = jax_side["posattn" if case == "posattn" else "varglow"]
    b = _torch(s["batch"])
    kw = dict(max_frames=MAX_FRAMES, sigma=0.0)
    pkw = dict(kw)
    if case == "z":
        kw["sigma"] = pkw["sigma"] = 1.0
        z = jax.random.normal(jax.random.PRNGKey(5), (B, MAX_FRAMES, 12))
        pkw["z"] = torch.from_numpy(np.array(z))
    if case == "sample_prosody":
        kw.update(sample_prosody=True, prosody_sigma=0.0)
        pkw.update(sample_prosody=True, prosody_sigma=0.0)
    want = s["model"].apply(
        s["params"], s["batch"]["text"], s["batch"]["text_lengths"],
        s["batch"]["speaker_id"], key=jax.random.PRNGKey(5),
        method=J.UnTTS.inference, **kw)
    got = s["port"].inference(b["text"], b["text_lengths"], b["speaker_id"],
                              **pkw)
    assert (got["durations"].numpy() == np.asarray(want["durations"])).all()
    assert (got["mel_lengths"].numpy() == np.asarray(want["mel_lengths"])).all()
    assert int(got["mel_lengths"].min()) > 0
    _close(got["mel_outputs"], want["mel_outputs"], "mel")


def test_train_step_matches_value_and_grad(jax_side):
    """One port train step (dropout 0, no clipping): its loss terms against
    JAX's loss closure, and its gradients (Adam's first moments after one
    step, mu = 0.1 g) against jax.value_and_grad, each within relative L2
    1e-4."""
    s = jax_side["varglow"]
    b = s["batch"]
    loss_fn = j_loss_fn(s["model"], 1.0, 0.1, 0.1, 0.1, 1.0,
                        deterministic=True)
    (total, ld), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        s["params"]["params"], {k: jnp.asarray(v) for k, v in b.items()},
        jax.random.PRNGKey(0))
    port = P.UnTTS(s["port"].cfg, device="cpu")
    port.load_state_dict(s["port"].state_dict())
    state = TrainState.create(port, adam())
    _, metrics = make_untts_train_step(port)(
        state, _torch(b), torch.Generator().manual_seed(0),
        {"lr": 1e-3, "grad_clip": 1e9})
    for k, v in ld.items():
        _close(metrics[k], v, k)
    want = untts_params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    mu = state.opt_state.mu
    assert set(mu) == set(want)
    for k, w in want.items():
        g = mu[k] / 0.1
        if float(w.norm()) < 1e-6:
            # zero but for rounding: the attention key bias, which the
            # softmax cancels
            assert float(g.norm()) < 1e-6, k
            continue
        rel = float((g - w).norm()) / float(w.norm())
        assert rel <= 1e-4, (k, rel, float(w.norm()))

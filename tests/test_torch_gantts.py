"""The port's GAN-TTS (models/gantts.py and its train steps) against the JAX
package's, on the CPU, at a tiny width (16-wide embeddings, one FFT block,
GBlocks of 12 and 8 channels over 10 mels, discriminator windows of 8 and
32 frames over DBlocks of 8, 6 and 4).

Weights are a JAX init plus noise (std 0.05), carried across with
convert/from_jax.py; inputs come from ``numpy.random.default_rng``; dropout
is 0, and the z and window starts JAX draws from its key are passed to the
port. Tolerances: forwards and metrics 1e-5 absolute and 1e-4 relative (the
generator 1e-4, see its test); one D and one G step, the stepped side's
parameters 1e-5 absolute, its Adam moments within relative L2 1e-4 each
(an element of a gradient can be rounding noise beside the rest; nu,
quadratic in the gradient, 2e-4). The attention
key bias has a zero gradient but for rounding (the softmax cancels it),
which Adam's first step turns into a move of up to lr either way: it is
held within 2 lr."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cookietts_tpu.models import gantts as J
from cookietts_tpu.runtime.optim import adam as jadam
from cookietts_tpu.runtime.train_state import TrainState as JTrainState
from cookietts_tpu.runtime.trainer import \
    make_gantts_train_steps as j_make_steps
from cookietts_tpu.runtime.trainer import scalars_to_arrays
from cookietts_tpu_torch.convert.from_jax import gantts_params_from_jax
from cookietts_tpu_torch.models import gantts as P
from cookietts_tpu_torch.runtime.optim import adam
from cookietts_tpu_torch.runtime.train_state import GANTrainState, TrainState
from cookietts_tpu_torch.runtime.trainer import (gantts_draws,
                                                 make_gan_trainer_step,
                                                 make_gantts_train_steps)
from test_torch_threads import _one_thread  # noqa: F401

TINY = dict(n_symbols=40, symbols_embedding_dim=16, n_speakers=4,
            speaker_embedding_dim=8, n_mel_channels=10, z_dim=6,
            enc_layers=1, enc_heads=2, enc_ffn_dim=24, g_channels=(12, 8),
            g_dilations=(1, 2), d_channels=(8, 6, 4), d_windows=(8, 32),
            dropout=0.0)
B, N, T = 2, 6, 21
TOL = dict(atol=1e-5, rtol=1e-4)
CTRL = {"lr": 1e-3, "grad_clip": 10.0}
INTS = ("text", "text_lengths", "mel_lengths", "speaker_id", "durations")


def _noisy(tree, rng, scale=0.05):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(
            np.shape(a)).astype(np.float32), tree)


def _torch(batch):
    return {k: torch.as_tensor(np.asarray(v).astype(np.int64) if k in INTS
                               else np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_side():
    """JAX's generator and discriminator params, a batch, key 7's z and
    window starts, and one D step then one G step of JAX's step factory."""
    cfg = J.GANTTSConfig(**TINY)
    gen, disc = J.GANTTSGenerator(cfg), J.GANTTSDiscriminator(cfg)
    rng = np.random.default_rng(0)
    durations = rng.integers(1, 5, (B, N)).astype(np.int32)
    durations[1, N - 2:] = 0
    batch = dict(text=rng.integers(1, 40, (B, N)).astype(np.int32),
                 text_lengths=np.array([N, N - 2], np.int32),
                 speaker_id=np.array([1, 2], np.int32), durations=durations,
                 mels=rng.standard_normal((B, T, 10)).astype(np.float32),
                 mel_lengths=np.minimum(durations.sum(1), T).astype(np.int32))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    gv = gen.init({"params": jax.random.PRNGKey(0)}, jb["text"],
                  jb["text_lengths"], jb["speaker_id"], jb["durations"],
                  t_out=T, key=jax.random.PRNGKey(1))
    dv = disc.init(jax.random.PRNGKey(2), jb["mels"])
    gp, dp = _noisy(gv["params"], rng), _noisy(dv["params"], rng)
    key = jax.random.PRNGKey(7)
    z = np.array(jax.random.normal(key, (B, TINY["z_dim"])))
    wkey = jax.random.fold_in(key, 1)
    starts = np.array([int(jax.random.randint(jax.random.fold_in(wkey, wi),
                                              (), 0, T - w)) if T > w else 0
                       for wi, w in enumerate(TINY["d_windows"])], np.int64)
    g_state = JTrainState.create(gen.apply, gp, jadam())
    d_state = JTrainState.create(disc.apply, dp, jadam())
    d_step, g_step = j_make_steps(gen, disc, mel_weight=1.5)
    ctrl = scalars_to_arrays(CTRL)
    d_state, d_m = d_step(d_state, g_state, jb, key, ctrl)
    g_state, g_m = g_step(g_state, d_state, jb, key, ctrl)
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(gen=gen, disc=disc, gp=gp, dp=dp, batch=batch, z=z,
                starts=starts, d_state=host(d_state), g_state=host(g_state),
                metrics={k: float(v) for k, v in {**d_m, **g_m}.items()})


def _port(gp=None, dp=None):
    cfg = P.GANTTSConfig(**TINY)
    g, d = gantts_params_from_jax(gp, dp)
    gen = P.GANTTSGenerator(cfg, device="cpu")
    gen.load_state_dict(g)
    disc = P.GANTTSDiscriminator(cfg, device="cpu")
    if d is not None:
        disc.load_state_dict(d)
    return gen, disc


def test_generator_with_z(jax_side):
    """Within 1e-4 of JAX, whose CPU result here lies up to 5.8e-5 from a
    float64 evaluation of the same weights (four GBlocks of dilated convs
    and LayerNorms deep); the port within 1e-5 of its own float64 run."""
    js, b = jax_side, jax_side["batch"]
    want, want_mask = js["gen"].apply(
        {"params": js["gp"]}, b["text"], b["text_lengths"], b["speaker_id"],
        b["durations"], z=js["z"], t_out=T)
    gen, _ = _port(js["gp"], js["dp"])
    tb = _torch(b)
    args = (tb["text"], tb["text_lengths"], tb["speaker_id"], tb["durations"])
    got, mask = gen(*args, z=torch.from_numpy(js["z"]), t_out=T)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    assert (mask.numpy() == np.asarray(want_mask)).all()
    exact, _ = gen.double()(*args, z=torch.from_numpy(js["z"]).double(),
                            t_out=T)
    np.testing.assert_allclose(got.detach().numpy(), exact.detach().numpy(),
                               **TOL)


@pytest.mark.parametrize("t", [21, 40], ids=["odd-T-under-a-window", "T-40"])
def test_discriminator_without_key(jax_side, t):
    """No key: every window from frame 0 (T = 21 is odd and shorter than
    the 32-frame window, so its DBlocks pool odd lengths, flax "SAME")."""
    js = jax_side
    mel = np.random.default_rng(t).standard_normal((B, t, 10)).astype(
        np.float32)
    want = js["disc"].apply({"params": js["dp"]}, mel)
    _, disc = _port(js["gp"], js["dp"])
    got = disc(torch.from_numpy(mel))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)


def test_avg_pool_same_divides_by_the_window():
    x = torch.arange(5, dtype=torch.float32).reshape(1, 5, 1)
    assert P.avg_pool_same(x, 2)[0, :, 0].tolist() == [0.5, 2.5, 2.0]


@pytest.mark.parametrize("which", ["d", "g"])
def test_train_steps_match_jax(jax_side, which):
    """One D step from the initial state, and one G step against JAX's
    updated D, with JAX's z and window starts: the metrics, the stepped
    side's parameters after Adam and its Adam moments."""
    js = jax_side
    jd = js["d_state"]
    gen, disc = _port(js["gp"], js["dp"] if which == "d" else jd.params)
    state = GANTrainState(g=TrainState.create(gen, adam()),
                          d=TrainState.create(disc, adam()))
    d_step, g_step = make_gantts_train_steps(gen, disc, mel_weight=1.5)
    batch = _torch(dict(js["batch"], z=js["z"], window_starts=js["starts"]))
    if which == "d":
        _, metrics = d_step(state.d, state.g, batch, dict(CTRL))
    else:
        _, metrics = g_step(state.g, state.d, batch, dict(CTRL))
    for k, v in metrics.items():
        want = js["metrics"][k]
        assert abs(float(v) - want) <= 1e-5 + 1e-4 * abs(want), k
    stepped = jd if which == "d" else js["g_state"]
    pair = (gantts_params_from_jax(None, stepped.params)[1] if which == "d"
            else gantts_params_from_jax(stepped.params)[0])
    model = disc if which == "d" else gen
    got = model.state_dict()
    for k, v in pair.items():
        tol = 2 * CTRL["lr"] if k.endswith("mha.key.bias") else 1e-5
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=tol,
                                   err_msg=k)
    ours = getattr(state, which).opt_state
    for moment in ("mu", "nu"):
        tree = getattr(stepped.opt_state, moment)
        want = (gantts_params_from_jax(None, tree)[1] if which == "d"
                else gantts_params_from_jax(tree)[0])
        for k, v in getattr(ours, moment).items():
            if k.endswith("mha.key.bias"):
                continue
            rel = float((v - want[k]).norm()) / float(want[k].norm())
            assert rel <= (1e-4 if moment == "mu" else 2e-4), (moment, k, rel)


def test_trainer_step_shares_one_draw():
    """gantts_draws gives both steps one z, one set of window starts (in
    [0, T - window) where T exceeds the window, else 0) and one dropout
    seed from the trainer's generator, the last two as host ints, and
    keeps what the batch holds."""
    seen = []

    def d_step(d, g, batch, ctrl):
        seen.append(batch)
        return d, {"d_loss": 0.0}

    def g_step(g, d, batch, ctrl):
        seen.append(batch)
        return g, {"g_loss": 1.0}

    step = make_gan_trainer_step(d_step, g_step,
                                 prepare=gantts_draws(6, (8, 32)))
    batch = {"mels": torch.zeros(B, T, 10)}
    gen = torch.Generator().manual_seed(3)
    for _ in range(20):
        step(GANTrainState(g=None, d=None), batch, gen, dict(CTRL))
        d, g = seen[-2:]
        for k in ("z", "window_starts", "dropout_seed"):
            assert d[k] is g[k]
        assert d["z"].shape == (B, 6)
        s = d["window_starts"]
        assert all(type(v) is int for v in s + [d["dropout_seed"]])
        assert 0 <= s[0] < T - 8 and s[1] == 0
    z = torch.ones(B, 6)
    step(GANTrainState(g=None, d=None), dict(batch, z=z), gen, dict(CTRL))
    assert seen[-1]["z"] is z
    step(GANTrainState(g=None, d=None),
         dict(batch, window_starts=torch.tensor([3, 0])), gen, dict(CTRL))
    assert seen[-1]["window_starts"] == [3, 0]

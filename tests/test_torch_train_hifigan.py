"""The port's HiFi-GAN training against the JAX package's, on the CPU, at a
tiny generator (16 initial channels, one resblock kernel, hop 128) with the
discriminators at their only width (one period, two scales: the spectral-
normed first and a weight-normed pooled one).

Weights are a JAX init plus noise, carried across with the converters;
inputs come from ``numpy.random.default_rng``. JAX's gradients are read
from its real train steps (``make_hifigan_train_steps``): after one Adam
step from zero moments with no clipping, mu = (1 - b1) * grad. The train
command, resume and explosion recovery run on the port alone."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from cookietts_tpu.audio.stft import TacotronSTFT as JTacotronSTFT
from cookietts_tpu.models import hifigan as J
from cookietts_tpu.runtime.optim import adam as jadam
from cookietts_tpu.runtime.train_state import TrainState as JTrainState
from cookietts_tpu.runtime.trainer import \
    make_hifigan_train_steps as j_make_steps
from cookietts_tpu_torch.audio.stft import TacotronSTFT
from cookietts_tpu_torch.cli import main as cli
from cookietts_tpu_torch.convert.from_jax import (
    hifigan_discriminators_from_jax, hifigan_train_state_dict_from_jax)
from cookietts_tpu_torch.data import audio_io
from cookietts_tpu_torch.models import hifigan as P
from cookietts_tpu_torch.ops import hopper_kernels as hk
from cookietts_tpu_torch.runtime.optim import adam
from cookietts_tpu_torch.runtime.train_state import GANTrainState, TrainState
from cookietts_tpu_torch.runtime.trainer import (
    Trainer, TrainerConfig, make_gan_trainer_step, make_hifigan_eval_step,
    make_hifigan_train_steps)
from test_torch_threads import _one_thread  # noqa: F401


TINY = dict(n_mel_channels=16, resblock_kernel_sizes=(3,),
            resblock_dilations=((1, 3),), upsample_rates=(4, 4, 8),
            upsample_kernel_sizes=(8, 8, 16), upsample_initial_channel=16,
            mpd_periods=(2,), msd_scales=2)
STFT_ARGS = (512, 128, 512, 16, 16000, 0.0, 8000.0)
B, SEG = 2, 2048
B1 = 0.9                                    # Adam's b1 on both sides


def _noisy(tree, rng, scale):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(a.shape).astype(
            np.float32), tree)


def _d_state_dict(mpd, msd):
    m, s = hifigan_discriminators_from_jax(mpd, msd, TINY["mpd_periods"])
    return {**{f"mpd.{k}": v for k, v in m.items()},
            **{f"msd.{k}": v for k, v in s.items()}}


def _port_models(g_params, d_params):
    cfg = P.HiFiGANConfig(**TINY)
    gen = P.Generator(cfg, device="cpu", weight_norm=True)
    gen.load_state_dict(hifigan_train_state_dict_from_jax(g_params))
    disc = torch.nn.ModuleDict({
        "mpd": P.MultiPeriodDiscriminator(cfg, device="cpu"),
        "msd": P.MultiScaleDiscriminator(cfg, device="cpu")})
    disc.load_state_dict(_d_state_dict(*d_params))
    return gen, disc


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    mel = rng.normal(-5, 1.5, (B, SEG // 128, 16)).astype(np.float32)
    t = np.arange(SEG) / 16000
    audio = (0.3 * np.sin(2 * np.pi * 220 * t)[None]
             + 0.05 * rng.standard_normal((B, SEG))).astype(np.float32)
    jc = J.HiFiGANConfig(**TINY)
    jg, jmpd, jmsd = (J.Generator(jc), J.MultiPeriodDiscriminator(jc),
                      J.MultiScaleDiscriminator(jc))
    g_params = _noisy(jg.init(jax.random.PRNGKey(0), jnp.asarray(mel))["params"],
                      rng, 0.1)
    a = jnp.asarray(audio)
    d_params = (
        _noisy(jmpd.init(jax.random.PRNGKey(1), a, a)["params"], rng, 0.02),
        _noisy(jmsd.init(jax.random.PRNGKey(2), a, a)["params"], rng, 0.02))
    mel_fn = JTacotronSTFT(*STFT_ARGS).mel_spectrogram
    return dict(mel=mel, audio=audio, jmods=(jg, jmpd, jmsd), g=g_params,
                d=d_params, jsteps=j_make_steps(jg, jmpd, jmsd, mel_fn))


@pytest.mark.parametrize("which", ["mpd", "msd"])
def test_discriminators_match_jax(setup, which):
    """Logits and every feature map of real and generated audio."""
    _, jmpd, jmsd = setup["jmods"]
    jd, jp = {"mpd": (jmpd, setup["d"][0]), "msd": (jmsd, setup["d"][1])}[which]
    fake = np.roll(setup["audio"], 37, axis=1) * 0.8
    want = jd.apply({"params": jp}, jnp.asarray(setup["audio"]),
                    jnp.asarray(fake))
    _, disc = _port_models(setup["g"], setup["d"])
    with torch.no_grad():
        got = disc[which](torch.from_numpy(setup["audio"]),
                          torch.from_numpy(fake))
    for side in (0, 1):                                  # real, fake logits
        for g, w in zip(got[side], want[side]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                       rtol=1e-4)
    for side in (2, 3):                                  # feature maps
        for gs, ws in zip(got[side], want[side]):
            assert len(gs) == len(ws)
            for g, w in zip(gs, ws):
                # channels-first here, channels-last in JAX
                np.testing.assert_allclose(np.moveaxis(g.numpy(), 1, -1),
                                           np.asarray(w), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("shape", [(8, 5, 1, 1), (4, 3, 16, 2)])
def test_sn_conv_matches_jax(shape):
    """SNConv's output against JAX's on both of its eigh branches (the
    [k * in, out] matrix wider and taller), and its sigma, the top singular
    value."""
    features, k, in_ch, groups = shape
    rng = np.random.default_rng(features)
    x = rng.standard_normal((2, 11, in_ch)).astype(np.float32)
    jm = J.SNConv(features, k, groups=groups)
    v = _noisy(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng,
               0.0)
    want = np.asarray(jm.apply({"params": v}, jnp.asarray(x)))
    port = P.SNConv(in_ch, features, k, groups=groups)
    port.load_state_dict({"weight_orig": torch.from_numpy(
        np.transpose(v["kernel"], (2, 1, 0)).copy()),
        "bias": torch.from_numpy(v["bias"])})
    with torch.no_grad():
        got = port(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
        sigma = float(port.sigma())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)
    top = np.linalg.svd(v["kernel"].reshape(-1, features), compute_uv=False)[0]
    np.testing.assert_allclose(sigma, top, rtol=1e-5)


def test_losses_match_jax(setup):
    rng = np.random.default_rng(4)
    logits = [rng.standard_normal((B, n)).astype(np.float32) for n in (7, 5)]
    fakes = [rng.standard_normal((B, n)).astype(np.float32) for n in (7, 5)]
    fm_r = [[rng.standard_normal((B, 3, n)).astype(np.float32) for n in (9, 4)]]
    fm_f = [[rng.standard_normal((B, 3, n)).astype(np.float32) for n in (9, 4)]]
    t = lambda xs: [torch.from_numpy(x) for x in xs]          # noqa: E731
    j = lambda xs: [jnp.asarray(x) for x in xs]               # noqa: E731
    pairs = [
        (P.discriminator_loss(t(logits), t(fakes)),
         J.discriminator_loss(j(logits), j(fakes))),
        (P.generator_loss(t(fakes)), J.generator_loss(j(fakes))),
        (P.feature_loss([t(f) for f in fm_r], [t(f) for f in fm_f]),
         J.feature_loss([j(f) for f in fm_r], [j(f) for f in fm_f])),
        (P.mel_l1_loss(torch.from_numpy(fakes[0]), torch.from_numpy(logits[0])),
         J.mel_l1_loss(jnp.asarray(fakes[0]), jnp.asarray(logits[0])))]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _jax_step(setup, grad_clip, lr):
    jg = setup["jmods"][0]
    d_step, g_step = setup["jsteps"]                 # compiled once
    g = JTrainState.create(jg.apply, jax.tree_util.tree_map(jnp.asarray,
                                                            setup["g"]),
                           jadam(weight_decay=0.01))
    d = JTrainState.create(None, jax.tree_util.tree_map(jnp.asarray,
                                                        setup["d"]),
                           jadam(weight_decay=0.01))
    batch = {"mels": jnp.asarray(setup["mel"]),
             "audio": jnp.asarray(setup["audio"])}
    ctrl = {"lr": jnp.float32(lr), "grad_clip": jnp.float32(grad_clip)}
    d, d_m = d_step(d, g, batch, ctrl)
    g, g_m = g_step(g, d, batch, ctrl)
    return g, d, {k: float(v) for k, v in {**d_m, **g_m}.items()}


def _port_step(setup, grad_clip, lr):
    gen, disc = _port_models(setup["g"], setup["d"])
    mel_fn = TacotronSTFT(*STFT_ARGS, device="cpu").mel_spectrogram
    step = make_gan_trainer_step(*make_hifigan_train_steps(
        gen, disc["mpd"], disc["msd"], mel_fn))
    state = GANTrainState(TrainState.create(gen, adam(weight_decay=0.01)),
                          TrainState.create(disc, adam(weight_decay=0.01)))
    batch = {"mels": torch.from_numpy(setup["mel"]),
             "audio": torch.from_numpy(setup["audio"])}
    state, metrics = step(state, batch, None, {"lr": lr, "grad_clip": grad_clip})
    return state, {k: float(v) for k, v in metrics.items()}


LR = 1e-4


@pytest.fixture(scope="module")
def stepped(setup):
    """One D and one G step on both sides, each side's global norm clipped
    to 1 (both are above it)."""
    return _jax_step(setup, 1.0, LR), _port_step(setup, 1.0, LR)


def _grads(stepped):
    """{side: [(name, port grad, JAX grad)]}: after one clipped Adam step
    from zero moments, mu = (1 - b1) * grad * min(1, 1 / (norm + 1e-6))."""
    (j_g, j_d, j_m), (state, p_m) = stepped
    want = {"g": hifigan_train_state_dict_from_jax(
                jax.tree_util.tree_map(np.asarray, j_g.opt_state.mu)),
            "d": _d_state_dict(*jax.tree_util.tree_map(np.asarray,
                                                       j_d.opt_state.mu))}
    out = {}
    for side in ("g", "d"):
        mu = getattr(state, side).opt_state.mu
        assert set(mu) == set(want[side]), set(mu) ^ set(want[side])
        p_s, j_s = (min(1.0, 1.0 / (m[f"{side}_grad_norm"] + 1e-6))
                    for m in (p_m, j_m))
        out[side] = [(k, mu[k] / ((1 - B1) * p_s),
                      want[side][k] / ((1 - B1) * j_s)) for k in mu]
    return out


def test_losses_and_every_gradient_match_jax(stepped):
    """D's and G's losses (the adversarial, feature-matching and mel L1
    parts too), their gradient norms and every gradient of both sides, G's
    taken against the updated discriminators as in JAX."""
    (_, _, j_m), (_, p_m) = stepped
    for k in ("d_loss", "g_adv", "g_fm", "g_mel_l1", "g_loss", "d_grad_norm",
              "g_grad_norm"):
        np.testing.assert_allclose(p_m[k], j_m[k], rtol=1e-5, err_msg=k)
    assert p_m["loss"] == p_m["g_loss"]
    for side, rows in _grads(stepped).items():
        for k, got, want in rows:
            # G's gradients reach 32 (the mel L1 weighs 45), where float32
            # resolves ~2e-6, and a weight_v gradient is a projection that
            # cancels: atol 1e-6, or 1e-5 of the tensor's largest entry
            scale = float(want.abs().max())
            torch.testing.assert_close(got, want, rtol=1e-4,
                                       atol=max(1e-6, 1e-5 * scale),
                                       msg=f"{side} {k}")
            assert float((got - want).norm()) <= 1e-4 * float(want.norm()), k


def test_every_trainable_parameter_gets_a_gradient(stepped):
    """Every parameter of G (the resblock convs' g and v included) and of D
    has a nonzero gradient."""
    rows = _grads(stepped)
    for side in ("g", "d"):
        zero = [k for k, got, _ in rows[side] if not got.abs().sum() > 0]
        assert not zero, f"{side}: {zero}"
    names = [k for k, _, _ in rows["g"]]
    assert "resblocks.0.convs1.0.weight_v" in names
    assert "ups.0.weight_g" in names


def test_clipped_adamw_step_matches_jax(stepped):
    """The parameters of both sides after the clipped AdamW step (weight
    decay 0.01). Adam's first step is lr * g / (|g| + eps): where a
    gradient entry is rounding noise (under 1e-5 of its tensor's largest)
    either sign is right, so those entries are held to 2 lr."""
    (j_g, j_d, j_m), (state, p_m) = stepped
    assert min(p_m["g_grad_norm"], p_m["d_grad_norm"], j_m["g_grad_norm"],
               j_m["d_grad_norm"]) > 1.0
    want = {"g": hifigan_train_state_dict_from_jax(
                jax.tree_util.tree_map(np.asarray, j_g.params)),
            "d": _d_state_dict(*jax.tree_util.tree_map(np.asarray,
                                                       j_d.params))}
    grads, noise = _grads(stepped), 0
    for side in ("g", "d"):
        params = getattr(state, side).params
        for k, _, g in grads[side]:
            p, w = params[k].detach(), want[side][k]
            tiny = g.abs() < 1e-5 * float(g.abs().max())
            noise += int(tiny.sum())
            torch.testing.assert_close(p[~tiny], w[~tiny], atol=1e-6,
                                       rtol=1e-4, msg=f"{side} {k}")
            assert bool(((p - w).abs()[tiny] <= 2 * LR).all()), k
    assert noise < 0.01 * sum(g.numel() for rows in grads.values()
                              for _, g, _ in rows)


def test_transposed_conv_weight_norm_gradients_match_flax():
    """A transposed conv under weight norm: the output and the weight_g /
    weight_v / bias gradients against flax's WeightNorm(ConvTranspose),
    which normalises per output channel."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5, 3)).astype(np.float32)
    r = rng.standard_normal((2, 20, 6)).astype(np.float32)
    jm = fnn.WeightNorm(fnn.ConvTranspose(6, (8,), strides=(4,),
                                          padding="SAME"))
    v = _noisy(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng,
               0.3)
    loss = lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(x)) * r)  # noqa: E731
    want = jax.grad(loss)(v)
    port = P.WNConv(torch.nn.ConvTranspose1d(3, 6, 8, 4, padding=2))

    def to_port(tree):          # a bare WeightNorm names its conv layer_instance
        conv = tree["layer_instance"]
        return {"weight_v": torch.from_numpy(np.transpose(
                    np.asarray(conv["kernel"])[::-1], (1, 2, 0)).copy()),
                "weight_g": torch.from_numpy(np.asarray(
                    tree["layer_instance/kernel/scale"]).reshape(1, -1, 1)),
                "bias": torch.from_numpy(np.asarray(conv["bias"]))}

    port.load_state_dict(to_port(v))
    y = port(torch.from_numpy(x).transpose(1, 2))
    np.testing.assert_allclose(
        y.detach().transpose(1, 2).numpy(),
        np.asarray(jm.apply({"params": v}, jnp.asarray(x))), atol=1e-5)
    (y * torch.from_numpy(r).transpose(1, 2)).sum().backward()
    for name, w in to_port(want).items():
        torch.testing.assert_close(getattr(port, name).grad, w, atol=1e-5,
                                   rtol=1e-4, msg=name)


def test_infer_picks_the_kernel_entry_not_the_grad_mode(setup, monkeypatch):
    """infer=True goes through the resblock kernel's entry, without
    autograd, whatever the grad mode; infer=False runs the modules' convs,
    under no_grad too. Both give the same audio."""
    calls = []
    entry = hk.hifigan_resblock
    monkeypatch.setattr(hk, "hifigan_resblock",
                        lambda *a: calls.append(1) or entry(*a))
    gen, _ = _port_models(setup["g"], setup["d"])
    mel = torch.from_numpy(setup["mel"])
    with torch.enable_grad():
        served = gen(mel, infer=True)
    assert len(calls) == len(gen.resblocks) and not served.requires_grad
    with torch.no_grad():
        trained = gen(mel)
    assert len(calls) == len(gen.resblocks)
    torch.testing.assert_close(served, trained, atol=1e-6, rtol=0)


# -- the train command and the trainer ------------------------------------------

FRONT = ("batch_size=2,segment_length=1024,sampling_rate=16000,"
         "filter_length=512,hop_length=128,win_length=512,n_mel_channels=16,"
         "mel_fmax=8000.0,load_from_disk_dtw=False,log_every=1,"
         "resblock_kernel_sizes=[3],resblock_dilations=[[1,3]],"
         "upsample_rates=[4,4,8],upsample_kernel_sizes=[8,8,16],"
         "upsample_initial_channel=16,mpd_periods=[2],msd_scales=1")


@pytest.fixture(scope="module")
def map_file(tmp_path_factory):
    root = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(2)
    lines = []
    for i in range(3):
        t = np.arange(6000) / 16000
        audio = (0.3 * np.sin(2 * np.pi * 330 * (i + 1) * t)
                 + 0.01 * rng.standard_normal(len(t))).astype(np.float32)
        audio_io.save_wav(str(root / f"h{i}.wav"), audio, 16000)
        lines.append(f"{root / f'h{i}.wav'}||{i}")
    (root / "map.txt").write_text("\n".join(lines))
    return str(root / "map.txt")


def _events(run_dir):
    with open(os.path.join(run_dir, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_command_trains_validates_saves_and_resumes(map_file, tmp_path,
                                                          capsys):
    """2 iterations with validation and a checkpoint every 2, then --resume
    to 3: G and D in every checkpoint, the resume at step 2; the trained
    generator's checkpoint serves through a serving Generator (weight norm
    folded at load, infer=True) with the training generator's audio."""
    run = str(tmp_path / "run")
    args = ["train", "--model", "hifigan", "--device", "cpu", "--filelist",
            map_file, "--run_dir", run, "--seed", "3", "--hparams",
            FRONT + ",validation_interval=2,checkpoint_interval=2"]
    trainer = cli(args + ["--iters", "2"])
    assert trainer.state.step == 2 and trainer.state.d.step == 2
    assert {"checkpoint_2", "best_val_model"} <= set(os.listdir(run))
    tree = torch.load(os.path.join(run, "checkpoint_2"))
    assert {"step", "state_dict", "opt_state", "d_state_dict",
            "d_opt_state"} <= set(tree)
    assert any(k.startswith("msd.discriminators.0.convs.0.weight_orig")
               for k in tree["d_state_dict"])
    meta = json.load(open(os.path.join(run, "checkpoint_2.json")))
    assert meta["model"] == "hifigan" and meta["audio"]["hop_length"] == 128
    assert meta["model_config"]["upsample_initial_channel"] == 16
    trainer = cli(args + ["--iters", "3", "--resume"])
    out = capsys.readouterr().out
    assert "resuming G+D" in out and "at step 2" in out
    ev = _events(run)
    steps = [e["step"] for e in ev if e["prefix"] == "train"]
    assert steps == [0, 1, 2]
    assert all(np.isfinite(e[k]) for e in ev if e["prefix"] == "train"
               for k in ("d_loss", "g_loss", "g_mel_l1"))
    assert [e["step"] for e in ev if e["prefix"] == "validation"] == [2]

    serving = P.Generator(trainer.state.model.cfg, device="cpu")
    serving.load_state_dict(torch.load(os.path.join(run, "checkpoint_3"))
                            ["state_dict"])
    mel = torch.from_numpy(np.random.default_rng(1).normal(
        -5, 1.5, (1, 9, 16)).astype(np.float32))
    with torch.no_grad():
        want = trainer.state.model(mel)
    torch.testing.assert_close(serving(mel, infer=True), want, atol=1e-6,
                               rtol=0)

    # warm start: the generator's weights but those named in ignore_layers
    warm = cli(["train", "--model", "hifigan", "--device", "cpu",
                "--filelist", map_file, "--run_dir", str(tmp_path / "warm"),
                "--seed", "4", "--iters", "0", "--warm_start",
                os.path.join(run, "checkpoint_3"), "--hparams",
                FRONT + ",ignore_layers=[conv_post]"])
    saved = torch.load(os.path.join(run, "checkpoint_3"))["state_dict"]
    for k, v in warm.state.model.state_dict().items():
        assert torch.equal(v, saved[k]) != k.startswith("conv_post"), k


def test_train_command_flags(map_file, tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="--tp"):
        cli(["train", "--model", "hifigan", "--device", "cpu", "--tp", "2",
             "--filelist", map_file, "--run_dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="--sp"):
        cli(["train", "--model", "waveglow", "--device", "cpu", "--sp", "2",
             "--filelist", map_file, "--run_dir", str(tmp_path)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli(["train", "--model", "hifigan", "--filelist", map_file,
             "--run_dir", str(tmp_path), "--hparams", FRONT])


def _trainer(run_dir, setup, seed=0, live=None, **cfg):
    """A GAN Trainer on the tiny models, initialised from ``seed``."""
    torch.manual_seed(seed)
    # the period discriminator alone: the MSD's eigh is most of a step here
    pcfg = P.HiFiGANConfig(**dict(TINY, msd_scales=0))
    gen = P.Generator(pcfg, device="cpu", weight_norm=True)
    disc = torch.nn.ModuleDict({
        "mpd": P.MultiPeriodDiscriminator(pcfg, device="cpu"),
        "msd": P.MultiScaleDiscriminator(pcfg, device="cpu")})
    mel_fn = TacotronSTFT(*STFT_ARGS, device="cpu").mel_spectrogram
    state = GANTrainState(TrainState.create(gen, adam(weight_decay=0.01)),
                          TrainState.create(disc, adam(weight_decay=0.01)))
    val = [{"mels": setup["mel"], "audio": setup["audio"]}]
    return Trainer(
        TrainerConfig(run_dir=str(run_dir), live_config_path=live, seed=7,
                      log_every=1, grad_clip=1000.0, **cfg),
        state, make_gan_trainer_step(*make_hifigan_train_steps(
            gen, disc["mpd"], disc["msd"], mel_fn)),
        make_hifigan_eval_step(gen, mel_fn), val_batches=val, device="cpu")


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"mels": rng.normal(-5, 1.5, (B, 8, 16)).astype(np.float32),
             "audio": (0.2 * rng.standard_normal((B, 1024))).astype(np.float32)}
            for _ in range(n)]


def _live(path, text):
    path.write_text(text)
    return str(path)


def _assert_states_equal(a, b):
    for side in ("g", "d"):
        sa, sb = getattr(a.state, side), getattr(b.state, side)
        for k, v in sa.model.state_dict().items():
            torch.testing.assert_close(sb.model.state_dict()[k], v, rtol=0,
                                       atol=0, msg=f"{side} {k}")
        for k, v in sa.opt_state.nu.items():
            torch.testing.assert_close(sb.opt_state.nu[k], v, rtol=0, atol=0)


def test_resume_equals_an_uninterrupted_run(setup, tmp_path):
    """2 iterations straight through (a checkpoint after the first) against
    a fresh trainer (other initial weights) resumed from that checkpoint
    for the second: G, D, both sides' Adam moments and the step agree
    exactly."""
    live = _live(tmp_path / "live.py", "validation_interval = 0\n"
                 "checkpoint_interval = 1\n")
    batches = _batches(2)
    a = _trainer(tmp_path / "a", setup, live=live)
    for b in batches:
        a.step(b)
    c = _trainer(tmp_path / "c", setup, seed=1, live=live)
    assert c.resume(str(tmp_path / "a" / "checkpoint_1")) == 1
    c.step(batches[1])
    assert c.state.step == a.state.step == 2 and c.state.d.step == 2
    _assert_states_equal(a, c)


def test_loss_explosion_restores_g_and_d(setup, tmp_path):
    """An explosion after best_val_model: both sides go back to it (and the
    step); with no checkpoint and a poisoned discriminator, both sides go
    back to their initial weights with fresh moments."""
    live = _live(tmp_path / "live.py", "validation_interval = 1\n"
                 "checkpoint_interval = 0\nLossExplosionThreshold = 1e9\n")
    t = _trainer(tmp_path / "run", setup, live=live)
    b = _batches(2)
    t.step(b[0])                                   # validates: best_val_model
    best = {s: {k: v.clone() for k, v in getattr(t.state, s).model
                .state_dict().items()} for s in ("g", "d")}
    t.live.values["LossExplosionThreshold"] = 1e-3
    assert t.step(b[1])["exploded"] == 1.0 and t.state.step == 1
    for s in ("g", "d"):
        for k, v in best[s].items():
            torch.testing.assert_close(getattr(t.state, s).model.state_dict()[k],
                                       v, rtol=0, atol=0, msg=f"{s} {k}")

    fresh = _trainer(tmp_path / "fresh", setup, live=_live(
        tmp_path / "live2.py", "validation_interval = 0\n"))
    init = {s: {k: v.clone() for k, v in getattr(fresh.state, s).params
                .items()} for s in ("g", "d")}
    with torch.no_grad():
        fresh.state.d.params["mpd.discriminators.0.conv_post.bias"].fill_(
            float("nan"))
    assert fresh.step(b[0])["exploded"] == 1.0
    for s in ("g", "d"):
        side = getattr(fresh.state, s)
        for k, v in init[s].items():
            torch.testing.assert_close(side.params[k], v, msg=f"{s} {k}")
        assert side.opt_state.step == 0
        assert not any(m.any() for m in side.opt_state.mu.values())

"""The port's adversarial postnet (models/gan_postnet.py, its train steps
and ``train --model gan_postnet``) against the JAX package's, on the CPU,
at a tiny width (8 mel channels, 3 convs of 12, noise 4, speaker 4).

Weights are a JAX init plus noise, with random BatchNorm statistics,
carried across with convert/from_jax.py; inputs come from
``numpy.random.default_rng``; the noise JAX draws from its key is passed to
the port. Tolerances: forwards and losses 1e-5 absolute; one D and one G
step, losses relative 1e-5, the updated parameters and the BatchNorm
statistics 1e-5 absolute (a conv bias ahead of a training-form BatchNorm,
whose gradient is rounding noise, 2 lr), the Adam moments relative 1e-4."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cookietts_tpu.models import gan_postnet as J
from cookietts_tpu.runtime.optim import adam as jadam
from cookietts_tpu.runtime.train_state import TrainState as JTrainState
from cookietts_tpu.runtime.trainer import \
    make_gan_postnet_train_steps as j_make_steps
from cookietts_tpu.runtime.trainer import scalars_to_arrays
from cookietts_tpu_torch.cli import main as cli
from cookietts_tpu_torch.convert.from_jax import gan_postnet_state_dict_from_jax
from cookietts_tpu_torch.data import audio_io
from cookietts_tpu_torch.models import gan_postnet as P
from cookietts_tpu_torch.runtime.checkpoint import save_checkpoint
from cookietts_tpu_torch.runtime.optim import adam
from cookietts_tpu_torch.runtime.train_state import GANTrainState, TrainState
from cookietts_tpu_torch.runtime.trainer import (gan_postnet_noise,
                                                 make_gan_postnet_train_steps,
                                                 make_gan_trainer_step)
from test_torch_threads import _one_thread  # noqa: F401


TINY = dict(n_mel_channels=8, speaker_embedding_dim=4, noise_dim=4,
            n_convolutions=3, embedding_dim=12, residual_connections=2)
B, T = 2, 10
ATOL = 1e-5
CTRL = {"lr": 1e-3, "grad_clip": 10.0}


def _noisy(tree, rng, scale=0.05):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(a.shape).astype(
            np.float32), tree)


def _stats(tree, rng):
    """Random running statistics (variances positive)."""
    return {k: {"mean": rng.normal(0, 0.3, v["mean"].shape).astype(np.float32),
                "var": rng.uniform(0.5, 2.0, v["var"].shape).astype(np.float32)}
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def jax_side():
    """JAX's postnet and discriminator variables, a batch, the noise of key
    7, and one D step then one G step of JAX's step factory."""
    cfg = J.GANPostnetConfig(**TINY)
    post, disc = J.GANPostnet(cfg), J.GANDiscriminator(cfg)
    rng = np.random.default_rng(0)
    batch = {"decoder_mel": rng.standard_normal((B, T, 8)).astype(np.float32),
             "gt_mel": rng.standard_normal((B, T, 8)).astype(np.float32),
             "speaker_embed": rng.standard_normal((B, 4)).astype(np.float32)}
    gv = post.init({"params": jax.random.PRNGKey(0)}, batch["decoder_mel"],
                   batch["speaker_embed"], key=jax.random.PRNGKey(1),
                   deterministic=False)
    dv = disc.init({"params": jax.random.PRNGKey(2)}, batch["gt_mel"],
                   batch["speaker_embed"], deterministic=False)
    gv = {"params": _noisy(gv["params"], rng),
          "batch_stats": _stats(gv["batch_stats"], rng)}
    dv = {"params": _noisy(dv["params"], rng),
          "batch_stats": _stats(dv["batch_stats"], rng)}
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.normal(key, (B, T, 4), jnp.float32))

    g_state = JTrainState.create(post.apply, gv["params"], jadam(),
                                 {"batch_stats": gv["batch_stats"]})
    d_state = JTrainState.create(disc.apply, dv["params"], jadam(),
                                 {"batch_stats": dv["batch_stats"]})
    d_step, g_step = j_make_steps(post, disc, mel_weight=1.5)
    ctrl = scalars_to_arrays(CTRL)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    d_state, d_m = d_step(d_state, g_state, jb, key, ctrl)
    g_state, g_m = g_step(g_state, d_state, jb, key, ctrl)
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(cfg=cfg, post=post, disc=disc, gv=gv, dv=dv, batch=batch,
                key=key, noise=noise, d_state=host(d_state),
                g_state=host(g_state),
                metrics={k: float(v) for k, v in {**d_m, **g_m}.items()})


def _port(which, variables):
    cfg = P.GANPostnetConfig(**TINY)
    model = (P.GANPostnet if which == "post" else P.GANDiscriminator)(
        cfg, device="cpu")
    model.load_state_dict(gan_postnet_state_dict_from_jax(
        variables["params"], variables["batch_stats"]))
    return model


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.mark.parametrize("which", ["post", "dis"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_matches_jax(jax_side, which, train):
    """Each model's forward in eval form (running averages) and in training
    form (batch statistics, and the running statistics it moves)."""
    js, b = jax_side, jax_side["batch"]
    variables = js["gv"] if which == "post" else js["dv"]
    mel = b["decoder_mel"] if which == "post" else b["gt_mel"]
    kw = {"key": js["key"]} if which == "post" else {}
    module = js["post"] if which == "post" else js["disc"]
    want, mut = module.apply(variables, mel, b["speaker_embed"],
                             deterministic=not train,
                             mutable=["batch_stats"], **kw)
    model = _port(which, variables).train(train)
    args = (_t(mel), _t(b["speaker_embed"]))
    with torch.no_grad():
        got = (model(*args, noise=_t(js["noise"])) if which == "post"
               else model(*args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    sd = model.state_dict()
    for name, stats in mut["batch_stats"].items():
        for k, buf in (("mean", "running_mean"), ("var", "running_var")):
            np.testing.assert_allclose(sd[f"{name}.{buf}"].numpy(),
                                       np.asarray(stats[k]), atol=ATOL)


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    real, fake = rng.uniform(0.01, 0.99, (2, 5)).astype(np.float32)
    want = J.gan_postnet_losses(jnp.asarray(real), jnp.asarray(fake))
    got = P.gan_postnet_losses(_t(real), _t(fake))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)


def _pre_bn_bias(name):
    """A conv bias ahead of a training-form BatchNorm: its gradient is zero
    up to rounding, which Adam's normalised step turns into a move of up to
    lr either way."""
    return name.endswith(".bias") and "conv" in name and not name.startswith(
        (f"post_conv{TINY['n_convolutions'] - 1}.",
         f"dis_conv{TINY['n_convolutions'] - 1}."))


@pytest.mark.parametrize("which", ["d", "g"])
def test_train_steps_match_jax(jax_side, which):
    """One D step from the initial state, and one G step against JAX's
    updated D: the metrics, the stepped side's parameters after Adam, its
    Adam moments and the BatchNorm statistics of both, against JAX's steps
    (the parameters that ``_pre_bn_bias`` names within 2 lr)."""
    js = jax_side
    jd = js["d_state"]
    dv = js["dv"] if which == "d" else {
        "params": jd.params, "batch_stats": jd.mutables["batch_stats"]}
    post, disc = _port("post", js["gv"]), _port("dis", dv)
    state = GANTrainState(g=TrainState.create(post, adam()),
                          d=TrainState.create(disc, adam()))
    d_step, g_step = make_gan_postnet_train_steps(post, disc, mel_weight=1.5)
    batch = {k: _t(v) for k, v in js["batch"].items()}
    batch["noise"] = _t(js["noise"])
    if which == "d":
        _, metrics = d_step(state.d, state.g, batch, dict(CTRL))
    else:
        _, metrics = g_step(state.g, state.d, batch, dict(CTRL))
    for k, v in metrics.items():
        want = js["metrics"][k]
        assert abs(float(v) - want) <= 1e-5 * max(abs(want), 1e-3), k
    stepped = jd if which == "d" else js["g_state"]
    after = {"params": stepped.params,
             "batch_stats": stepped.mutables["batch_stats"]}
    # the other side's parameters and statistics do not move
    sides = {"d": (after, js["gv"], disc, post),
             "g": (after, dv, post, disc)}[which]
    for want_vars, model in ((sides[0], sides[2]), (sides[1], sides[3])):
        want = gan_postnet_state_dict_from_jax(want_vars["params"],
                                               want_vars["batch_stats"])
        got = model.state_dict()
        for k, v in want.items():
            tol = 2 * CTRL["lr"] if _pre_bn_bias(k) else ATOL
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=tol,
                                       err_msg=k)
    ours = getattr(state, which).opt_state
    for moment in ("mu", "nu"):
        want = gan_postnet_state_dict_from_jax(
            getattr(stepped.opt_state, moment), after["batch_stats"])
        for k, v in getattr(ours, moment).items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-8,
                                       rtol=1e-4, err_msg=f"{moment} {k}")


def test_trainer_step_draws_the_noise_once():
    """make_gan_trainer_step's ``prepare`` (gan_postnet_noise) gives both
    steps one noise draw from the trainer's generator, and keeps a noise
    the batch already holds."""
    seen = []

    def d_step(d, g, batch, ctrl):
        seen.append(batch["noise"])
        return d, {"d_loss": 0.0}

    def g_step(g, d, batch, ctrl):
        seen.append(batch["noise"])
        return g, {"g_loss": 1.0}

    step = make_gan_trainer_step(d_step, g_step, prepare=gan_postnet_noise(4))
    batch = {"decoder_mel": torch.zeros(B, T, 8)}
    gen = torch.Generator().manual_seed(3)
    state = GANTrainState(g=None, d=None)
    _, metrics = step(state, batch, gen, dict(CTRL))
    assert metrics["loss"] == 1.0 and seen[0] is seen[1]
    assert seen[0].shape == (B, T, 4)
    torch.testing.assert_close(
        seen[0], torch.randn(B, T, 4, generator=torch.Generator().manual_seed(3)))
    step(state, dict(batch, noise=seen[0] + 1), gen, dict(CTRL))
    torch.testing.assert_close(seen[2], seen[0] + 1)


HP = ("sampling_rate=8000,filter_length=256,hop_length=64,win_length=256,"
      "n_mel_channels=8,mel_fmax=4000.0,postnet_segment_frames=8,"
      "embedding_dim=12,n_convolutions=3,noise_dim=4,batch_size=2,"
      "validation_interval=1,checkpoint_interval=1,log_every=1")


def _gta_map(tmp_path, n=4, speakers=(0, 1, 0, 1), mels=True):
    """``n`` seeded WAVs at 8 kHz with random 'GTA' mels beside them."""
    rng = np.random.default_rng(5)
    lines = []
    for i in range(n):
        wav = tmp_path / f"u{i}.wav"
        audio_io.save_wav(str(wav), 0.3 * np.sin(
            np.arange(2000) * (0.05 + 0.01 * i)).astype(np.float32), 8000)
        mel = ""
        if mels:
            mel = str(tmp_path / f"u{i}.wav.mel.npy")
            np.save(mel, rng.standard_normal((32, 8)).astype(np.float32))
        lines.append(f"{wav}|{mel}|{speakers[i]}")
    path = tmp_path / "map_train_0.txt"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _taco_checkpoint(path, n_speakers=2, dim=6, table=True):
    sd = {"embedding.weight": torch.zeros(3, 2)}
    if table:
        sd["speaker_embedding.weight"] = torch.randn(n_speakers, dim)
    save_checkpoint(str(path), {"step": 0, "state_dict": sd}, {})
    return str(path)


def test_train_command_writes_checkpoints(tmp_path):
    """``train --model gan_postnet`` for 2 CPU iterations with the speaker
    codes of a Tacotron2 checkpoint: a checkpoint with G and D, the events
    with finite losses and validation's mel_MSE."""
    run = tmp_path / "run"
    ckpt = _taco_checkpoint(tmp_path / "taco.pt")
    trainer = cli(["train", "--model", "gan_postnet", "--device", "cpu",
                   "--filelist", _gta_map(tmp_path), "--run_dir", str(run),
                   "--iters", "2", "--hparams",
                   HP + f",tacotron2_checkpoint={ckpt}"])
    assert trainer.state.step == 2
    tree = torch.load(run / "checkpoint_2", weights_only=True)
    assert "post_conv0.weight" in tree["state_dict"]
    assert "dis_bn0.running_var" in tree["d_state_dict"]
    assert tree["state_dict"]["post_conv0.weight"].shape[1] == 8 + 6 + 4
    events = [json.loads(ln) for ln in
              (run / "events.jsonl").read_text().splitlines()]
    train = [e for e in events if e["prefix"] == "train"]
    val = [e for e in events if e["prefix"] == "validation"]
    assert [e["step"] for e in train] == [0, 1]
    assert all(np.isfinite(e["loss"]) and np.isfinite(e["d_loss"])
               for e in train)
    assert len(val) == 2 and all(np.isfinite(e["val_mel_MSE"]) for e in val)


@pytest.mark.parametrize("case", ["no-mels", "no-table", "speaker-range"])
def test_train_command_refusals(tmp_path, case):
    """JAX's refusals: a map without mel sidecars, a checkpoint without a
    speaker table, a speaker id past the table."""
    fl = _gta_map(tmp_path, mels=case != "no-mels",
                  speakers=(0, 1, 0, 5) if case == "speaker-range"
                  else (0, 1, 0, 1))
    ckpt = _taco_checkpoint(tmp_path / "taco.pt", table=case != "no-table")
    want = {"no-mels": "no mel sidecars", "no-table": "no speaker_embedding",
            "speaker-range": "out of range"}[case]
    with pytest.raises(SystemExit, match=want):
        cli(["train", "--model", "gan_postnet", "--device", "cpu",
             "--filelist", fl, "--run_dir", str(tmp_path / "run"), "--iters",
             "1", "--hparams", HP + f",tacotron2_checkpoint={ckpt}"])

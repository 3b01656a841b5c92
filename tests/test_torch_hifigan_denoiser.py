"""The port's HiFi-GAN denoiser (data/denoiser_data.py,
models/hifigan_denoiser.py, its train steps and ``train --model
hifigan_denoiser``) against the JAX package's, on the CPU, at a tiny width:
a 2-layer WN of 8 channels, a 2-layer PostNet of kernel 4, two STFT banks
(64 and 128), two DW critics of three layers (one grouped) and one DS block.

Weights are a JAX init plus noise, carried across with
convert/from_jax.py:hifigan_denoiser_from_jax; inputs come from
``numpy.random.default_rng``. Tolerances: the dataset bit for bit (the JAX
package resampling with scipy, as the port does); forwards and losses
1e-5 (absolute, or relative for the log-spectra); one step, losses
relative 1e-5, the updated parameters 1e-5 absolute (2 lr for the two
whose gradient is rounding noise, ``_rounding_gradient``), the Adam moments
within 1e-4 of each tensor's largest (of the side's largest for those
two)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cookietts_tpu.data import denoiser_data as JD
from cookietts_tpu.models import hifigan_denoiser as J
from cookietts_tpu.runtime.optim import adam as jadam
from cookietts_tpu.runtime.train_state import TrainState as JTrainState
from cookietts_tpu.runtime.trainer import \
    make_hifigan_denoiser_train_steps as j_make_steps
from cookietts_tpu.runtime.trainer import scalars_to_arrays
from cookietts_tpu_torch.cli import main as cli
from cookietts_tpu_torch.convert.from_jax import hifigan_denoiser_from_jax
from cookietts_tpu_torch.data import audio_io
from cookietts_tpu_torch.data import denoiser_data as PD
from cookietts_tpu_torch.models import hifigan_denoiser as P
from cookietts_tpu_torch.runtime.optim import adam
from cookietts_tpu_torch.runtime.train_state import GANTrainState, TrainState
from cookietts_tpu_torch.runtime.trainer import (
    make_gan_trainer_step, make_hifigan_denoiser_train_steps)
from test_torch_threads import _one_thread  # noqa: F401


TINY = dict(wn_layers=2, wn_channels=8, wn_dilations=None, postnet_layers=2,
            postnet_channels=8, postnet_kernel_size=4,
            window_lengths=(64, 128), hop_lengths=(16, 32),
            dw_n_discriminators=2, dw_kernel_sizes=(5, 5, 3),
            dw_strides=(2, 2, 1), dw_channels=(4, 8, 1),
            dw_group_sizes=(1, 2, 1), ds_block_confs=((2, 3, 1, 2, 4),))
B, T = 2, 512
ATOL = 1e-5
CTRL = {"lr": 1e-3, "grad_clip": 100.0}


def _noisy(tree, rng, scale=0.05):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(a.shape).astype(
            np.float32), tree)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.fixture(scope="module")
def jax_side():
    """JAX's models, their noisy weights, a batch, each forward, the losses
    and the steps: stage 0 (G), then stage 2 (D, then G against the
    updated D)."""
    rng = np.random.default_rng(0)
    t = np.arange(T) / T
    # broadband audio: the log of near-empty STFT bins would magnify
    # rounding into the gradients
    clean = (0.3 * np.sin(2 * np.pi * np.array([[60.0], [97.0]]) * t)
             + 0.2 * rng.standard_normal((B, T))).astype(np.float32)
    noisy = (clean + 0.05 * rng.standard_normal((B, T))).astype(np.float32)
    batch = {"noisy": noisy, "clean": clean}
    out = {"batch": batch}
    mrs = J.MultiResSpect(TINY["window_lengths"], TINY["hop_lengths"])
    out["mrs"] = np.asarray(mrs(jnp.asarray(noisy)))
    for stage in (0, 1):
        cfg = J.HiFiGANDenoiserConfig(stage=stage, **TINY)
        gen = J.DenoiserWN(cfg)
        if stage == 0:
            gp = _noisy(gen.init(jax.random.PRNGKey(0), noisy)["params"], rng)
        out[f"gen{stage}"] = np.asarray(gen.apply({"params": gp}, noisy))
    cfg0 = J.HiFiGANDenoiserConfig(**TINY)
    cfg2 = J.HiFiGANDenoiserConfig(stage=2, **TINY)
    dw, ds = J.WaveDiscriminator(cfg2), J.SpectDiscriminator(cfg2)
    spect = J.log_compress(mrs(jnp.asarray(clean)))
    dwp = _noisy(dw.init(jax.random.PRNGKey(1), clean)["params"], rng)
    dsp = _noisy(ds.init(jax.random.PRNGKey(2), spect)["params"], rng)
    out.update(gp=gp, dwp=dwp, dsp=dsp, spect=np.asarray(spect),
               dw=np.asarray(dw.apply({"params": dwp}, clean)),
               ds=np.asarray(ds.apply({"params": dsp}, spect)))
    fake_dw, fake_ds = rng.standard_normal((2, B)).astype(np.float32)
    out["fakeness"] = (fake_dw, fake_ds)
    out["loss"] = {stage: {k: float(v) for k, v in J.denoiser_loss(
        mrs, jnp.asarray(noisy), jnp.asarray(clean), stage=stage,
        dw_fake=jnp.asarray(fake_dw), ds_fake=jnp.asarray(fake_ds))[1].items()}
        for stage in (0, 2)}

    ctrl = scalars_to_arrays(CTRL)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    host = lambda s: jax.tree_util.tree_map(np.asarray, s)  # noqa: E731
    gen0 = J.DenoiserWN(cfg0)
    g_state = JTrainState.create(gen0.apply, gp, jadam())
    d_state = JTrainState.create(None, (dwp, dsp), jadam())
    d0, g0 = j_make_steps(gen0, None, None, mrs, stage=0)
    same, d_m = d0(d_state, g_state, jb, ctrl)
    assert same is d_state and float(d_m["d_loss"]) == 0.0
    g_after, g_m = g0(g_state, d_state, jb, ctrl)
    out["step0"] = (host(g_after), {k: float(v) for k, v in g_m.items()})
    gen2 = J.DenoiserWN(cfg2)
    g_state = JTrainState.create(gen2.apply, gp, jadam())
    d2, g2 = j_make_steps(gen2, dw, ds, mrs, stage=2)
    d_after, d_m = d2(d_state, g_state, jb, ctrl)
    g_after, g_m = g2(g_state, d_after, jb, ctrl)
    out["step2"] = (host(g_after), host(d_after),
                    {k: float(v) for k, v in {**d_m, **g_m}.items()})
    return out


def _port(js, stage, critics=False):
    cfg = P.HiFiGANDenoiserConfig(stage=stage, **TINY)
    g_sd, w_sd, s_sd = hifigan_denoiser_from_jax(js["gp"], js["dwp"], js["dsp"])
    gen = P.DenoiserWN(cfg, device="cpu")
    gen.load_state_dict(g_sd)
    if not critics:
        return gen
    dw, ds = P.WaveDiscriminator(cfg, "cpu"), P.SpectDiscriminator(cfg, "cpu")
    dw.load_state_dict(w_sd)
    ds.load_state_dict(s_sd)
    return gen, dw, ds


def _wavs(root, names, sr, seconds, seed):
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    paths = []
    for name in names:
        n = int(sr * seconds * rng.uniform(0.5, 1.0))
        audio = 0.3 * np.sin(np.arange(n) * rng.uniform(0.02, 0.2))
        audio = audio + 0.01 * rng.standard_normal(n)
        path = root / f"{name}.wav"
        audio_io.save_wav(str(path), audio.astype(np.float32), sr)
        paths.append(str(path))
    return paths


def test_dataset_items_match_jax(tmp_path, monkeypatch):
    """Noisy/clean pairs (short and long files, the lazy low-pass, white
    noise, a noise file resampled from another rate mixed at a target SNR)
    equal JAX's bit for bit, item after item of one seeded stream."""
    monkeypatch.setenv("COOKIETTS_DISABLE_NATIVE", "1")   # JAX on scipy too
    clean = _wavs(tmp_path / "clean", ["a", "b", "c"], 16000, 0.2, 1)
    noise = _wavs(tmp_path / "noise", ["hum"], 8000, 0.1, 2)
    kw = dict(segment_length=2400, sampling_rate=16000,
              min_augmented_sample_rate=8000, max_augmented_sample_rate=16000)
    jds = JD.DenoiserDataset(clean, JD.DenoiserDataConfig(**kw),
                             noise_files=noise, seed=3)
    pds = PD.DenoiserDataset(clean, PD.DenoiserDataConfig(**kw),
                             noise_files=noise, seed=3)
    for i in range(6):
        want, got = jds[i % 3], pds[i % 3]
        for k in ("clean", "noisy"):
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k])
    want = JD.collate_denoiser([jds[0], jds[1]])
    got = PD.collate_denoiser([pds[0], pds[1]])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_multires_spect_matches_jax(jax_side):
    mrs = P.MultiResSpect(TINY["window_lengths"], TINY["hop_lengths"], "cpu")
    got = mrs(_t(jax_side["batch"]["noisy"]))
    assert got.shape == jax_side["mrs"].shape == (B, 128, 16)
    np.testing.assert_allclose(got.numpy(), jax_side["mrs"], atol=ATOL,
                               rtol=1e-5)


@pytest.mark.parametrize("which", ["gen0", "gen1", "dw", "ds"])
def test_modules_match_jax(jax_side, which):
    """The generator at stage 0 (WN -> wn_end) and stage 1 (WN -> PostNet ->
    postnet_end) from one set of weights, DW on audio and DS on the
    log-compressed multi-res spectrogram (JAX's: the log of the smallest
    magnitudes magnifies the STFT's rounding, which the spectrogram test and
    the steps' tolerances hold)."""
    js, b = jax_side, jax_side["batch"]
    if which.startswith("gen"):
        gen = _port(js, int(which[-1]))
        with torch.no_grad():
            got = gen(_t(b["noisy"]))
    else:
        _, dw, ds = _port(js, 2, critics=True)
        with torch.no_grad():
            got = (dw(_t(b["clean"])) if which == "dw"
                   else ds(_t(js["spect"])))
    np.testing.assert_allclose(got.numpy(), js[which], atol=ATOL, rtol=1e-5)


def test_generator_refuses_narrow_postnet():
    with pytest.raises(ValueError, match="postnet_channels must be >="):
        P.DenoiserWN(P.HiFiGANDenoiserConfig(**dict(TINY, wn_channels=16)),
                     device="cpu")


@pytest.mark.parametrize("stage", [0, 2])
def test_denoiser_loss_matches_jax(jax_side, stage):
    js, b = jax_side, jax_side["batch"]
    mrs = P.MultiResSpect(TINY["window_lengths"], TINY["hop_lengths"], "cpu")
    fake_dw, fake_ds = js["fakeness"]
    _, parts = P.denoiser_loss(mrs, _t(b["noisy"]), _t(b["clean"]),
                               stage=stage, dw_fake=_t(fake_dw),
                               ds_fake=_t(fake_ds))
    want = js["loss"][stage]
    assert set(parts) == set(want)
    for k, v in want.items():
        assert abs(float(parts[k]) - v) <= 1e-5 * max(abs(v), 1e-2), k


def _rounding_gradient(name, param):
    """A parameter whose gradient is zero up to rounding, which Adam's
    normalised step turns into a move of up to lr either way: a DS block's
    conv bias (BatchNorm on the batch's statistics follows) and the
    ``weight_v`` of a weight-norm pair whose norm group is one element
    (``wn.start``: 1 input, kernel 1; the weight is sign(v) g)."""
    return ((name.startswith("ds.block") and name.endswith(".conv.bias"))
            or (name.endswith(".weight_v") and param[0].numel() == 1))


@pytest.mark.parametrize("stage", [0, 2])
def test_train_steps_match_jax(jax_side, stage):
    """Stage 0: the D step returns its state untouched, the G step is the
    spectral one. Stage 2: one D step, then one G step against the updated
    critics, through make_gan_trainer_step. The metrics, both sides'
    parameters after Adam and their Adam moments against JAX's."""
    js, b = jax_side, jax_side["batch"]
    gen, dw, ds = _port(js, stage, critics=True)
    critics = torch.nn.ModuleDict({"dw": dw, "ds": ds})
    state = GANTrainState(g=TrainState.create(gen, adam()),
                          d=TrainState.create(critics, adam()))
    mrs = P.MultiResSpect(TINY["window_lengths"], TINY["hop_lengths"], "cpu")
    d_step, g_step = make_hifigan_denoiser_train_steps(gen, dw, ds, mrs,
                                                       stage=stage)
    before = {k: v.clone() for k, v in critics.state_dict().items()}
    step = make_gan_trainer_step(d_step, g_step, loss_key="loss")
    _, metrics = step(state, {k: _t(v) for k, v in b.items()}, None,
                      dict(CTRL))
    if stage == 0:
        g_after, want_m = js["step0"]
        d_params = (js["dwp"], js["dsp"])
        assert metrics["d_loss"] == 0.0 and state.d.step == 0
    else:
        g_after, d_after, want_m = js["step2"]
        d_params = d_after.params
    for k, v in want_m.items():
        if k != "d_loss" or stage:
            assert abs(float(metrics[k]) - v) <= 1e-5 * max(abs(v), 1e-3), k
    g_sd, w_sd, s_sd = hifigan_denoiser_from_jax(g_after.params, *d_params)
    want = {**g_sd}
    want_d = {**{f"dw.{k}": v for k, v in w_sd.items()},
              **{f"ds.{k}": v for k, v in s_sd.items()}}
    for got, want_sd in ((gen.state_dict(), want),
                         (critics.state_dict(), want_d)):
        for k, v in want_sd.items():
            tol = 2 * CTRL["lr"] if _rounding_gradient(k, v) else ATOL
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=tol,
                                       err_msg=k)
    if stage == 0:
        for k, v in critics.state_dict().items():
            torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    for moment in ("mu", "nu"):
        g_m = hifigan_denoiser_from_jax(getattr(g_after.opt_state, moment))[0]
        sides = [(state.g, g_m)]
        if stage:
            jd = getattr(d_after.opt_state, moment)
            _, wm, sm = hifigan_denoiser_from_jax(js["gp"], *jd)
            sides.append((state.d, {**{f"dw.{k}": v for k, v in wm.items()},
                                    **{f"ds.{k}": v for k, v in sm.items()}}))
        for side, want_sd in sides:
            ours = getattr(side.opt_state, moment)
            top = max(float(want_sd[k].abs().max()) for k in ours)
            for k, v in ours.items():
                # 1e-4 of the tensor's largest moment; of the side's largest
                # where the gradient is rounding noise
                scale = (top if _rounding_gradient(k, side.params[k])
                         else float(want_sd[k].abs().max()))
                np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(),
                                           atol=1e-4 * scale, rtol=0,
                                           err_msg=f"{moment} {k}")


HP = ("segment_length=1024,sampling_rate=16000,"
      "min_augmented_sample_rate=8000,max_augmented_sample_rate=16000,"
      "wn_layers=2,wn_channels=8,postnet_layers=2,postnet_channels=8,"
      "postnet_kernel_size=4,window_lengths=[64,128],hop_lengths=[16,32],"
      "dw_n_discriminators=2,dw_kernel_sizes=[5,5,3],dw_strides=[2,2,1],"
      "dw_channels=[4,8,1],dw_group_sizes=[1,2,1],"
      "ds_block_confs=[[2,3,1,2,4]],batch_size=2,validation_interval=1,"
      "log_every=1")


def test_train_command_stage_promotion(tmp_path):
    """``train --model hifigan_denoiser`` at stage 0 for 2 CPU iterations
    with a noise folder, then ``--resume`` at stage 2 to 4: the generator
    resumes, the critics start fresh and train (as JAX's CLI test does at
    its tiny sizes)."""
    clean = _wavs(tmp_path / "clean", ["d0", "d1"], 16000, 0.5, 3)
    _wavs(tmp_path / "noise" / "sub", ["hum"], 16000, 0.5, 4)
    filelist = tmp_path / "clean.txt"
    filelist.write_text("\n".join(clean) + "\n")
    run = tmp_path / "run"
    base = ["train", "--model", "hifigan_denoiser", "--device", "cpu",
            "--filelist", str(filelist), "--run_dir", str(run)]
    hp = HP + f",noise_dir={tmp_path / 'noise'}"
    t0 = cli(base + ["--iters", "2", "--hparams", hp])
    tree0 = torch.load(run / "checkpoint_2", weights_only=True)
    assert tree0["d_state_dict"] == {} and "wn.start.weight_v" in \
        tree0["state_dict"] and "postnet.res_weights" in tree0["state_dict"]
    assert json.loads((run / "checkpoint_2.json").read_text())["stage"] == 0
    gen0 = {k: v.clone() for k, v in t0.state.g.model.state_dict().items()}
    t2 = cli(base + ["--iters", "4", "--resume", "--hparams",
                     hp + ",stage=2"])
    assert t2.state.step == 4 and "checkpoint_4" in os.listdir(run)
    tree = torch.load(run / "checkpoint_4", weights_only=True)
    assert any(k.startswith("dw.dw1.conv2") for k in tree["d_state_dict"])
    assert any(k.startswith("ds.end_conv") for k in tree["d_state_dict"])
    assert json.loads((run / "checkpoint_4.json").read_text())["stage"] == 2
    # the resumed generator moved on from stage 0's weights, its postnet
    # head (stage 2's output) among them
    moved = [k for k, v in tree["state_dict"].items()
             if not torch.equal(v, gen0[k])]
    assert any(k.startswith("postnet.conv") for k in moved)
    assert any(k.startswith("wn.in_layer") for k in moved)
    events = [json.loads(ln) for ln in
              (run / "events.jsonl").read_text().splitlines()]
    train = [e for e in events if e["prefix"] == "train"]
    assert [e["step"] for e in train] == [0, 1, 2, 3]
    assert "adv" in train[-1] and train[-1]["d_loss"] > 0
    assert all(np.isfinite(e["val_loss"]) for e in events
               if e["prefix"] == "validation")

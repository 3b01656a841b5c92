"""The port's WaveGlow / WaveFlow training against the JAX package's, on the
CPU, at tiny sizes: the training forward (z and the log-determinants), the
flow NLL and every gradient against ``jax.grad``; ``memory_efficient`` on and
off; validation through the inverse (STFT MSE / MAE) with JAX's z; the
inverse after an optimizer step. Weights are a JAX init plus noise (the
init's end layers are zero), carried across with ``waveglow_from_jax``,
which is linear in each leaf and so maps JAX's gradients too. The train
command, resume and the plateau scheduler run on the port alone."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cookietts_tpu.models.waveglow import WaveGlow as JWaveGlow
from cookietts_tpu.models.waveglow import WaveGlowConfig as JConfig
from cookietts_tpu.models.waveglow import waveglow_loss as j_loss
from cookietts_tpu.runtime.train_state import TrainState as JTrainState
from cookietts_tpu.runtime.trainer import \
    make_waveglow_val_step as j_make_val_step
from cookietts_tpu_torch.cli import main as cli
from cookietts_tpu_torch.convert.from_jax import waveglow_from_jax
from cookietts_tpu_torch.data import audio_io
from cookietts_tpu_torch.models.waveglow import (WaveGlow, WaveGlowConfig,
                                                 waveglow_loss)
from cookietts_tpu_torch.runtime.optim import ReduceLROnPlateau, adam
from cookietts_tpu_torch.runtime.train_state import TrainState
from cookietts_tpu_torch.runtime.trainer import (Trainer, TrainerConfig,
                                                 make_waveglow_train_step,
                                                 make_waveglow_val_step)
from test_torch_threads import _one_thread  # noqa: F401


BASE = dict(n_mel_channels=8, n_layers=2, n_channels=16, upsample_channels=8)
# (configuration, audio length, the weights' noise over JAX's init)
CASES = {
    # early outputs, the first half coupled
    "glow": (dict(BASE, n_flows=4, n_group=8, n_early_every=2,
                  n_early_size=2, hop_length=24, upsample_strides=(3,)), 192,
             0.1),
    # the reference's coupling order, speakers, a SIREN unit (its x16 hidden
    # from autograd). sin(16 a) multiplies the rounding of a by 16 a layer:
    # at 0.1 noise both packages' z move 2e-4 apart (each is as exact as
    # float32 allows), at 0.02 a few 1e-6
    "glow-second-siren": (dict(BASE, n_flows=2, n_group=4, n_early_every=0,
                               hop_length=20, upsample_strides=(5,),
                               couple_transform="second", n_speakers=3,
                               speaker_embed_dim=4, gated_unit="GSIRU"), 160,
                          0.02),
    # WaveFlow: 3 flows of 8 rows, a 3-row causal kernel
    "flow": (dict(BASE, n_flows=3, n_group=8, channel_mixing="permuteheight",
                  hop_length=16, upsample_strides=(2,)), 160, 0.1),
}
WINDOWS = ((64, 16, 64), (128, 32, 128))      # validation STFTs at this size
B = 2


def _port(kw, params, **over):
    port = WaveGlow(WaveGlowConfig(**kw, **over), device="cpu")
    port.load_state_dict(waveglow_from_jax(params, port.cfg))
    return port


def _batch_t(c):
    out = {"audio": torch.from_numpy(c["audio"]),
           "mels": torch.from_numpy(c["mel"])}
    if c["spk"] is not None:
        out["speaker_id"] = torch.from_numpy(c["spk"])
    return out


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """JAX's forward, loss and gradients at one case's noisy weights."""
    kw, T, noise = CASES[request.param]
    rng = np.random.default_rng(len(request.param))
    jcfg = JConfig(**kw, memory_efficient=False)
    jm = JWaveGlow(jcfg)
    audio = (0.3 * rng.standard_normal((B, T))).astype(np.float32)
    mel = rng.normal(-5, 1, (B, T // jcfg.hop_length, 8)).astype(np.float32)
    spk = rng.integers(0, 3, (B,)) if jcfg.n_speakers else None
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + noise * rng.standard_normal(a.shape).astype(
            np.float32),
        jm.init(jax.random.PRNGKey(0), jnp.asarray(audio),
                jnp.asarray(mel))["params"])

    def loss_fn(p):
        out = jm.apply({"params": p}, jnp.asarray(audio), jnp.asarray(mel),
                       speaker_ids=None if spk is None else jnp.asarray(spk))
        return j_loss(out)[0], out

    (loss, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return dict(name=request.param, kw=kw, jm=jm, params=params, audio=audio,
                mel=mel, spk=spk, loss=float(loss),
                out={k: np.asarray(v) for k, v in out.items()},
                grads=waveglow_from_jax(jax.tree_util.tree_map(np.asarray,
                                                               grads), jcfg))


def _port_loss_and_grads(port, c):
    b = _batch_t(c)
    out = port(b["audio"], b["mels"], speaker_ids=b.get("speaker_id"))
    loss, parts = waveglow_loss(out)
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(loss, list(port.parameters()))
    return out, loss, parts, dict(zip(names, grads))


def test_training_forward_and_loss_match_jax(case):
    out, loss, parts, _ = _port_loss_and_grads(
        _port(case["kw"], case["params"]), case)
    want = case["out"]
    assert out["z"].shape == want["z"].shape
    np.testing.assert_allclose(out["z"].detach().numpy(), want["z"],
                               atol=1e-5, rtol=1e-5)
    for k in ("log_s_sum", "logdet_w_sum"):
        np.testing.assert_allclose(float(out[k]), float(want[k]), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    assert out["n_elements"] == int(want["n_elements"])
    np.testing.assert_allclose(float(loss), case["loss"], rtol=1e-5)
    assert float(parts["loss"]) == float(loss)


def test_every_gradient_matches_jax(case):
    """Every parameter (the WN layers, the end layer, the 1x1 mixing and the
    upsampler) gets a nonzero gradient equal to JAX's."""
    *_, grads = _port_loss_and_grads(_port(case["kw"], case["params"]), case)
    assert set(grads) == set(case["grads"])
    for k, g in grads.items():
        assert bool(g.abs().sum() > 0), k
        torch.testing.assert_close(g, case["grads"][k], atol=1e-6, rtol=1e-4,
                                   msg=k)


def test_memory_efficient_gives_the_same_gradients(case):
    """Each flow recomputed in the backward (the default) against kept
    activations: the same loss and gradients."""
    runs = [_port_loss_and_grads(_port(case["kw"], case["params"],
                                       memory_efficient=me), case)
            for me in (True, False)]
    assert float(runs[0][1]) == float(runs[1][1])
    for k, g in runs[0][3].items():
        torch.testing.assert_close(g, runs[1][3][k], atol=1e-7, rtol=1e-6,
                                   msg=k)


def test_validation_through_the_inverse_matches_jax(case):
    """make_waveglow_val_step's MSE and MAE, with the z JAX's infer draws
    from its key passed to the port."""
    jm, kw = case["jm"], case["kw"]
    key = jax.random.PRNGKey(4)
    state = JTrainState(step=0, params=case["params"], opt_state=None)
    batch = {"audio": jnp.asarray(case["audio"]),
             "mels": jnp.asarray(case["mel"])}
    want = j_make_val_step(jm, stft_windows=WINDOWS)(state, batch, key)
    n = case["mel"].shape[1] * kw["hop_length"] // kw["n_group"]
    shape = ((B, kw["n_group"], n) if "channel_mixing" in kw
             else (B, n, kw["n_group"]))
    z = np.asarray(jax.random.normal(key, shape, jnp.float32))
    port = _port(kw, case["params"])
    got = make_waveglow_val_step(port, stft_windows=WINDOWS)(
        None, _batch_t(case), None, z=torch.from_numpy(z))
    for k in ("val_MSE", "val_MAE"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   err_msg=k)


def test_validation_after_a_step_sees_the_new_weights(case):
    """Validation after one train step (in-place Adam) equals validation of
    a fresh model loaded with the stepped weights, and differs from the one
    before the step: the inverse's packed kernel weights follow the
    parameters."""
    port = _port(case["kw"], case["params"])
    val = make_waveglow_val_step(port, stft_windows=WINDOWS)
    g = torch.Generator().manual_seed(0)
    n = case["mel"].shape[1] * case["kw"]["hop_length"]
    z = torch.randn(B, n, generator=g).view(
        (B, -1, case["kw"]["n_group"]) if not port.waveflow
        else (B, case["kw"]["n_group"], -1))
    before = val(None, _batch_t(case), None, z=z)["val_MSE"]
    state = TrainState.create(port, adam())
    make_waveglow_train_step(port)(state, _batch_t(case), None,
                                   {"lr": 1e-2, "grad_clip": 100.0})
    after = val(None, _batch_t(case), None, z=z)["val_MSE"]
    fresh = WaveGlow(port.cfg, device="cpu")
    fresh.load_state_dict(port.state_dict())
    again = make_waveglow_val_step(fresh, stft_windows=WINDOWS)(
        None, _batch_t(case), None, z=z)["val_MSE"]
    assert float(after) != float(before)
    assert float(after) == float(again)


# -- the train command and the trainer ------------------------------------------

FRONT = ("batch_size=2,segment_length=2560,sampling_rate=16000,"
         "filter_length=512,hop_length=128,win_length=512,n_mel_channels=16,"
         "mel_fmax=8000.0,load_from_disk_dtw=False,log_every=1,"
         "n_layers=1,n_channels=8,upsample_channels=8,"
         "validation_interval=2,checkpoint_interval=2")
COMMANDS = {
    "waveglow": FRONT + (",n_flows=2,n_group=4,n_early_every=0,"
                         "upsample_strides=[4,8]"),
    "waveflow": FRONT + (",n_flows=2,n_group=8,channel_mixing=permuteheight,"
                         "upsample_strides=[16],optimizer=lamb,"
                         "memory_efficient=False"),
}


@pytest.fixture(scope="module")
def map_file(tmp_path_factory):
    root = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(1)
    lines = []
    for i in range(3):
        t = np.arange(8000) / 16000
        audio = (0.3 * np.sin(2 * np.pi * 220 * (i + 1) * t)
                 + 0.01 * rng.standard_normal(len(t))).astype(np.float32)
        audio_io.save_wav(str(root / f"v{i}.wav"), audio, 16000)
        lines.append(f"{root / f'v{i}.wav'}||{i}")
    (root / "map.txt").write_text("\n".join(lines))
    return str(root / "map.txt")


@pytest.mark.parametrize("model", sorted(COMMANDS))
def test_train_command_trains_validates_saves_and_resumes(map_file, tmp_path,
                                                          model):
    """2 iterations with validation (through the inverse) and a checkpoint
    every 2, then --resume to 3; WaveFlow with LAMB."""
    run = str(tmp_path / "run")
    args = ["train", "--model", "waveglow", "--device", "cpu", "--filelist",
            map_file, "--run_dir", run, "--seed", "3", "--hparams",
            COMMANDS[model]]
    trainer = cli(args + ["--iters", "2"])
    assert trainer.state.step == 2
    assert trainer.state.model.waveflow == (model == "waveflow")
    assert {"checkpoint_2", "best_val_model"} <= set(os.listdir(run))
    meta = json.load(open(os.path.join(run, "checkpoint_2.json")))
    assert meta["model"] == "waveglow" and meta["plateau_scale"] == 1.0
    assert meta["model_config"]["hop_length"] == 128
    trainer = cli(args + ["--iters", "3", "--resume"])
    assert trainer.state.step == 3
    with open(os.path.join(run, "events.jsonl")) as f:
        ev = [json.loads(line) for line in f]
    assert [e["step"] for e in ev if e["prefix"] == "train"] == [0, 1, 2]
    val = [e for e in ev if e["prefix"] == "validation"]
    assert [e["step"] for e in val] == [2]
    assert all(np.isfinite(e[k]) for e in val for k in ("val_MSE", "val_MAE"))
    assert all(np.isfinite(e["loss"]) for e in ev if e["prefix"] == "train")


def _trainer(run_dir, kw, seed=0, live=None):
    torch.manual_seed(seed)
    model = WaveGlow(WaveGlowConfig(**kw), device="cpu")
    val = make_waveglow_val_step(model, stft_windows=WINDOWS)

    def eval_step(state, batch, generator, ctrl):
        m = val(state, batch, generator)
        return {"loss": m["val_MSE"]}, {}, None

    rng = np.random.default_rng(5)
    val_batch = {"audio": (0.3 * rng.standard_normal((B, 192))).astype(
        np.float32), "mels": rng.normal(-5, 1, (B, 8, 8)).astype(np.float32)}
    return Trainer(
        TrainerConfig(run_dir=str(run_dir), live_config_path=live, seed=7,
                      log_every=1, grad_clip=150.0,
                      plateau=ReduceLROnPlateau(patience=0)),
        TrainState.create(model, adam()), make_waveglow_train_step(model),
        eval_step, val_batches=[val_batch], device="cpu")


def test_resume_equals_an_uninterrupted_run(tmp_path):
    """3 iterations straight through (validation every iteration, so the
    plateau scheduler moves; a checkpoint after the second) against a fresh
    trainer with other initial weights resumed from it: the model, the Adam
    moments, the step and the plateau's LR scale agree exactly."""
    kw = CASES["glow"][0]
    live = tmp_path / "live.py"
    live.write_text("validation_interval = 1\ncheckpoint_interval = 2\n")
    rng = np.random.default_rng(6)
    batches = [{"audio": (0.3 * rng.standard_normal((B, 192))).astype(
        np.float32), "mels": rng.normal(-5, 1, (B, 8, 8)).astype(np.float32)}
        for _ in range(3)]
    a = _trainer(tmp_path / "a", kw, live=str(live))
    for b in batches:
        a.step(b)
    c = _trainer(tmp_path / "c", kw, seed=1, live=str(live))
    assert c.resume(str(tmp_path / "a" / "checkpoint_2")) == 2
    assert c.plateau.scale == json.load(open(
        tmp_path / "a" / "checkpoint_2.json"))["plateau_scale"]
    c.step(batches[2])
    assert c.state.step == a.state.step == 3
    assert c.plateau.scale == a.plateau.scale
    for k, v in a.state.model.state_dict().items():
        torch.testing.assert_close(c.state.model.state_dict()[k], v, rtol=0,
                                   atol=0, msg=k)
    for k, v in a.state.opt_state.nu.items():
        torch.testing.assert_close(c.state.opt_state.nu[k], v, rtol=0, atol=0)


def test_plateau_scales_the_live_lr(tmp_path):
    """The plateau's scale multiplies the live LR, floored at min_lr (never
    raising it above the base schedule), as JAX's Trainer applies it."""
    t = _trainer(tmp_path / "run", CASES["glow"][0])
    t.set_live_defaults({"A_": 1e-4, "warmup_end": 0})
    assert t.ctrl(0)["lr"] == 1e-4 and t.ctrl(0)["grad_clip"] == 150.0
    t.plateau.scale = 0.25
    np.testing.assert_allclose(t.ctrl(0)["lr"], 2.5e-5)
    t.plateau = dataclasses.replace(t.plateau, min_lr=5e-5)
    np.testing.assert_allclose(t.ctrl(0)["lr"], 5e-5)
    t.live.values["A_"] = 1e-5
    np.testing.assert_allclose(t.ctrl(0)["lr"], 1e-5)

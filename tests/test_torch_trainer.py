"""The port's training runtime on the CPU, at a tiny size: the ``train``
command end to end on an evidence corpus (train, validate, save, resume),
a resumed run equal to an uninterrupted one, loss-explosion recovery and
the live-config cadence. No JAX here: the numerics are held against JAX in
tests/test_torch_train_tacotron2.py."""
import json
import os

import numpy as np
import pytest
import torch

from cookietts_tpu_torch.cli import main as cli
from cookietts_tpu_torch.data.evidence_corpus import make_corpus
from cookietts_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
from cookietts_tpu_torch.runtime.live_config import LossExplosion
from cookietts_tpu_torch.runtime.optim import adam
from cookietts_tpu_torch.runtime.train_state import TrainState
from cookietts_tpu_torch.runtime.trainer import (
    Trainer, TrainerConfig, make_tacotron2_eval_step,
    make_tacotron2_inference_eval_step, make_tacotron2_train_step)
from cookietts_tpu_torch.text import N_SYMBOLS
from test_torch_threads import _one_thread  # noqa: F401

TINY = dict(
    symbols_embedding_dim=16, n_speakers=4, speaker_embedding_dim=8,
    encoder_speaker_embed_dim=4, encoder_conv_hidden_dim=16,
    encoder_lstm_dim=16, encoder_n_convolutions=2, torchmoji_dim=8,
    torchmoji_crushed_dim=4, memory_bottleneck_dim=16, prenet_dim=8,
    attention_rnn_dim=16, decoder_rnn_dim=16, second_decoder_rnn_dim=16,
    attention_dim=8, windowed_attention_range=2, postnet_embedding_dim=16,
    postnet_n_convolutions=3, postnet_residual_connections=2)


FRONT = ("sampling_rate=22050,filter_length=1024,hop_length=256,"
         "win_length=1024,mel_fmax=8000.0,trim_enable=False,"
         "mel_buckets=[64],max_segment_frames=64,batch_size=3")


def _hparams(**extra):
    kv = {**TINY, **extra}
    return FRONT + "," + ",".join(f"{k}={v}" for k, v in kv.items())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(str(tmp_path_factory.mktemp("corpus")), seed=0,
                       n_train=6, n_val=3)[0]


def _events(run_dir):
    with open(os.path.join(run_dir, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_command_trains_validates_saves_and_resumes(corpus, tmp_path):
    run = str(tmp_path / "run")
    args = ["train", "--model", "tacotron2", "--device", "cpu", "--filelist",
            corpus, "--run_dir", run, "--seed", "3", "--hparams",
            _hparams(validation_interval=2, checkpoint_interval=2,
                     log_every=1)]
    trainer = cli(args + ["--iters", "3"])
    assert trainer.state.step == 3 and trainer.device.type == "cpu"
    files = set(os.listdir(run))
    assert {"checkpoint_2", "checkpoint_3", "best_val_model",
            "best_inf_attsc", "file_losses.csv"} <= files
    meta = json.load(open(os.path.join(run, "checkpoint_3.json")))
    assert meta["model"] == "tacotron2" and meta["audio"]["hop_length"] == 256
    trainer = cli(args + ["--iters", "5", "--resume"])
    assert trainer.state.step == 5
    ev = _events(run)
    steps = [e["step"] for e in ev if e["prefix"] == "train"]
    assert steps == [0, 1, 2, 3, 4]          # the resume went on from 3
    assert all(np.isfinite(e["loss"]) for e in ev if e["prefix"] == "train")
    assert [e["step"] for e in ev if e["prefix"] == "validation"] == [2, 4]
    assert [e["step"] for e in ev if e["prefix"] == "validation_inf"] == [2, 4]

    # warm start: the checkpoint's weights but those named in ignore_layers
    warm = str(tmp_path / "warm")
    trainer = cli(["train", "--device", "cpu", "--filelist", corpus,
                   "--run_dir", warm, "--seed", "4", "--iters", "0",
                   "--warm_start", os.path.join(run, "checkpoint_5"),
                   "--hparams", _hparams(ignore_layers="[speaker_embedding]")])
    saved = torch.load(os.path.join(run, "checkpoint_5"))["state_dict"]
    for k, v in trainer.state.model.state_dict().items():
        assert torch.equal(v, saved[k]) != ("speaker_embedding" in k), k


def test_train_command_needs_a_card_unless_asked(corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli(["train", "--filelist", corpus, "--run_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli(["train", "--model", "gantts", "--filelist", corpus,
             "--run_dir", str(tmp_path)])


def _batches(n, seed=0, B=2, T_txt=9, T_dec=12):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ml = rng.integers(T_dec // 2, T_dec + 1, B)
        valid = np.arange(T_dec)[None, :, None] < ml[:, None, None]
        out.append(dict(
            text=rng.integers(1, N_SYMBOLS, (B, T_txt)),
            text_lengths=rng.integers(T_txt // 2, T_txt + 1, B),
            mels=(rng.normal(-4, 1, (B, T_dec, 80)) * valid).astype(np.float32),
            mel_lengths=ml, speaker_id=rng.integers(0, 4, B),
            sylps=rng.uniform(3, 6, B).astype(np.float32),
            gate_target=(np.arange(T_dec)[None] >= ml[:, None] - 1).astype(
                np.float32),
            pres_prev_state=np.zeros(B, np.float32),
            global_mean=np.full(80, -4.0, np.float32),
            audiopath=[f"u{i}.wav" for i in range(B)]))
    return out


def _trainer(run_dir, seed=0, live=None, **cfg):
    torch.manual_seed(seed)
    model = Tacotron2(Tacotron2Config(n_symbols=N_SYMBOLS, **TINY),
                      device="cpu")
    return Trainer(
        TrainerConfig(run_dir=str(run_dir), live_config_path=live, seed=7,
                      log_every=1, **cfg),
        TrainState.create(model, adam()), make_tacotron2_train_step(model),
        make_tacotron2_eval_step(model), val_batches=_batches(1, seed=9),
        inference_eval_step=make_tacotron2_inference_eval_step(model),
        device="cpu")


def _live(path, text):
    with open(path, "w") as f:
        f.write(text)
    return str(path)


def test_resume_equals_an_uninterrupted_run(tmp_path):
    """4 iterations straight through, against 2, a save, and a fresh
    trainer (other initial weights) resumed for the last 2: the model, the
    Adam moments and the step agree exactly (the generator resumes too)."""
    live = _live(tmp_path / "live.py", "drop_frame_rate = 0.5\n"
                 "validation_interval = 0\ncheckpoint_interval = 0\n")
    batches = _batches(4)
    a = _trainer(tmp_path / "a", live=live)
    for b in batches:
        a.step(b)
    b_ = _trainer(tmp_path / "b", live=live)
    for b in batches[:2]:
        b_.step(b)
    b_.save(periodic=True)
    c = _trainer(tmp_path / "b", seed=1, live=live)
    assert c.resume() == 2
    for b in batches[2:]:
        c.step(b)
    assert c.state.step == a.state.step == 4
    for k, v in a.state.model.state_dict().items():
        torch.testing.assert_close(c.state.model.state_dict()[k], v,
                                   rtol=0, atol=0, msg=k)
    for k, v in a.state.opt_state.nu.items():
        torch.testing.assert_close(c.state.opt_state.nu[k], v, rtol=0, atol=0)


def test_loss_explosion_recovery(tmp_path):
    """A loss over the live threshold: with best_val_model saved, the state
    goes back to it (step included) and the LR decays by 2^(1/3); past
    n_restarts_max the trainer gives up."""
    live_path = tmp_path / "live.py"
    live = _live(live_path, "validation_interval = 2\n"
                 "checkpoint_interval = 0\nLossExplosionThreshold = 1e9\n")
    t = _trainer(tmp_path / "run", live=live, n_restarts_max=2)
    batches = _batches(3)
    t.step(batches[0])
    t.step(batches[1])                      # validates: best_val_model
    best = {k: v.clone() for k, v in t.state.model.state_dict().items()}
    lr0 = t.ctrl(2)["lr"]
    t.live.values["LossExplosionThreshold"] = 1e-3
    out = t.step(batches[2])
    assert out["exploded"] == 1.0 and t.n_restarts == 1
    assert t.state.step == 2 and t.carry is None
    for k, v in best.items():
        torch.testing.assert_close(t.state.model.state_dict()[k], v)
    np.testing.assert_allclose(t.ctrl(2)["lr"], lr0 / 2 ** (1 / 3))
    t.step(batches[2])
    with pytest.raises(LossExplosion):
        t.step(batches[2])


def test_explosion_with_non_finite_params_and_no_checkpoint(tmp_path):
    """No best_val_model yet and parameters that are not finite after the
    step (the non-finite gradient is zeroed, so a poisoned parameter stays
    so): back to the initial parameters with fresh Adam moments."""
    t = _trainer(tmp_path / "run", live=_live(
        tmp_path / "live.py", "validation_interval = 0\n"))
    init = {k: v.clone() for k, v in t.state.params.items()}
    with torch.no_grad():
        t.state.params["decoder.gate_layer.linear_layer.bias"].fill_(np.nan)
    out = t.step(_batches(1)[0])
    assert out["exploded"] == 1.0
    for k, v in init.items():
        torch.testing.assert_close(t.state.params[k], v)
    assert t.state.opt_state.step == 0
    assert not any(m.any() for m in t.state.opt_state.mu.values())


def test_live_config_cadence_and_reload(tmp_path):
    """The live file sets the validation and checkpoint cadence; a new
    version of the file is read at the next 5-iteration poll and moves the
    learning rate from then on. Iteration 1 is traced by torch.profiler."""
    live_path = tmp_path / "live.py"
    _live(live_path, "A_ = 1e-3\nwarmup_end = 0\nvalidation_interval = 2\n"
          "checkpoint_interval = 3\n")
    t = _trainer(tmp_path / "run", live=str(live_path), profile_start=1,
                 profile_stop=2)
    batches = _batches(7)
    for b in batches[:3]:
        t.step(b)
    seen = os.path.getmtime(live_path)
    _live(live_path, "A_ = 5e-4\nwarmup_end = 0\nvalidation_interval = 2\n"
          "checkpoint_interval = 3\n")
    os.utime(live_path, (seen + 10, seen + 10))     # a new version
    for b in batches[3:]:
        t.step(b)
    ev = _events(str(tmp_path / "run"))
    lrs = {e["step"]: e["lr"] for e in ev if e["prefix"] == "train"}
    assert [lrs[i] for i in range(7)] == [1e-3] * 5 + [5e-4] * 2
    assert [e["step"] for e in ev if e["prefix"] == "validation"] == [2, 4, 6]
    assert {"checkpoint_3", "checkpoint_6"} <= set(os.listdir(tmp_path / "run"))
    # the torch.profiler window [1, 2)
    assert os.path.getsize(tmp_path / "run" / "profile" / "trace.json") > 0

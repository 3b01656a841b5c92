"""The rest of the port's trainer against the JAX package's, on the CPU:
``validate_at_start`` (an iteration-0 teacher-forced and free-running
validation, its loss JAX's on the same weights and batch; the train
command honouring it from ``--hparams``), ``async_save`` (the file a
synchronous save writes, a failed save raising once at ``wait()``), the
validation images (through ``MetricsLogger.log_image``, drawn by
runtime/plotting.py, whose arrays equal JAX's on the same input) and
``DynamicLossScaler`` (JAX's scale sequence on a seeded overflow pattern).
"""
import json
import os
import types

import numpy as np
import pytest
import torch

from cookietts_tpu_torch.cli import main as cli
from cookietts_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
from cookietts_tpu_torch.runtime import plotting
from cookietts_tpu_torch.runtime.checkpoint import (Checkpointer,
                                                    load_checkpoint,
                                                    save_checkpoint)
from cookietts_tpu_torch.runtime.logging_util import MetricsLogger
from cookietts_tpu_torch.runtime.optim import DynamicLossScaler, adam
from cookietts_tpu_torch.runtime.train_state import TrainState
from cookietts_tpu_torch.runtime.trainer import (
    Trainer, TrainerConfig, make_tacotron2_eval_step,
    make_tacotron2_inference_eval_step, make_tacotron2_train_step)
from test_torch_threads import _one_thread  # noqa: F401

# a tiny Tacotron2 whose eval form draws nothing (the prenet's dropout,
# always on, at 0)
TACO = dict(
    n_symbols=40, symbols_embedding_dim=16, n_speakers=4,
    speaker_embedding_dim=8, n_mel_channels=10, encoder_speaker_embed_dim=4,
    encoder_conv_hidden_dim=16, encoder_lstm_dim=16, encoder_n_convolutions=1,
    torchmoji_dim=12, torchmoji_crushed_dim=4, memory_bottleneck_dim=16,
    prenet_dim=8, attention_rnn_dim=16, decoder_rnn_dim=12,
    second_decoder_rnn_dim=0, attention_dim=8, windowed_attention_range=4,
    postnet_embedding_dim=16, postnet_n_convolutions=2,
    postnet_residual_connections=0, p_prenet_dropout=0.0)
B, T_TXT, T_DEC = 3, 10, 12


def _batch(seed):
    rng = np.random.default_rng(seed)
    ml = np.array([12, 9, 6])
    valid = np.arange(T_DEC)[None, :, None] < ml[:, None, None]
    return dict(
        text=rng.integers(1, 40, (B, T_TXT)), text_lengths=np.array([10, 8, 5]),
        mels=(rng.normal(-3, 1, (B, T_DEC, 10)) * valid).astype(np.float32),
        mel_lengths=ml, speaker_id=np.array([1, 3, 0]),
        sylps=np.array([3.0, 4.5, 5.0], np.float32),
        torchmoji=rng.normal(0, 1, (B, 12)).astype(np.float32),
        gate_target=(np.arange(T_DEC)[None] >= ml[:, None] - 1).astype(
            np.float32),
        pres_prev_state=np.zeros(B, np.float32),
        global_mean=np.full(10, -3.0, np.float32))


@pytest.fixture(scope="module")
def start(tmp_path_factory):
    """A Trainer with validate_at_start run for one iteration (the images
    captured), and JAX's teacher-forced validation loss on the same
    weights and batch."""
    import jax
    import jax.numpy as jnp
    from cookietts_tpu.convert import convert_tacotron2_state_dict
    from cookietts_tpu.models.tacotron2 import (Tacotron2 as JTacotron2,
                                               Tacotron2Config as JConfig)
    from cookietts_tpu.runtime.trainer import \
        make_tacotron2_eval_step as j_eval_step
    run = str(tmp_path_factory.mktemp("start"))
    torch.manual_seed(0)
    model = Tacotron2(Tacotron2Config(**TACO), device="cpu")
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    val = [_batch(1)]
    trainer = Trainer(
        TrainerConfig(run_dir=run, seed=3, log_every=1, async_save=True),
        TrainState.create(model, adam()), make_tacotron2_train_step(model),
        make_tacotron2_eval_step(model), val_batches=val,
        inference_eval_step=make_tacotron2_inference_eval_step(model),
        device="cpu")
    trainer.live.values.update(validate_at_start=True, validation_interval=0,
                               checkpoint_interval=0)
    images = []
    real = trainer.logger.log_image
    trainer.logger.log_image = lambda it, name, img: (
        images.append((it, name, img.shape, img.dtype)), real(it, name, img))
    trainer.step(_batch(2))
    trainer.save(periodic=True)
    trainer.ckpt.wait()

    from cookietts_tpu.runtime.optim import adam as j_adam
    from cookietts_tpu.runtime.train_state import TrainState as JTrainState
    params, stats = convert_tacotron2_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    jm = JTacotron2(JConfig(**TACO))
    jstate = JTrainState.create(jm.apply, params, j_adam(),
                                {"batch_stats": stats})
    jb = {k: jnp.asarray(v) for k, v in val[0].items()
          if k not in ("pres_prev_state", "global_mean")}
    j_loss = j_eval_step(jm)(jstate, jb, jax.random.PRNGKey(3), {})[0]
    with open(os.path.join(run, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    return dict(run=run, events=events, images=images,
                jax={k: float(v) for k, v in j_loss.items()})


def test_validate_at_start_logs_both_validations_at_iteration_0(start):
    ev = [(e["prefix"], e["step"]) for e in start["events"]]
    assert ev[:3] == [("validation", 0), ("validation_inf", 0), ("train", 0)]
    assert ev.count(("validation", 0)) == 1


def test_validate_at_start_loss_matches_jax(start):
    """The iteration-0 validation ran on the initial weights: its terms
    are JAX's teacher-forced validation of them."""
    val = next(e for e in start["events"] if e["prefix"] == "validation")
    for k in ("loss", "spec_MSE", "postnet_MSE", "gate_loss", "diag_att"):
        np.testing.assert_allclose(val[f"val_{k}"], start["jax"][k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_validation_images_go_through_log_image(start):
    names = [(it, n) for it, n, _, _ in start["images"]]
    for prefix in ("validation", "validation_inf"):
        for what in ("alignment", "mel_predicted", "mel_target", "gate"):
            assert (0, f"{prefix}/{what}") in names
    assert all(len(s) == 3 and s[2] == 3 and d == np.uint8
               for _, _, s, d in start["images"])
    # tensorboardX wrote them into the run's event file
    tb = [f for f in os.listdir(start["run"]) if f.startswith("events.out")]
    assert len(tb) == 1
    raw = open(os.path.join(start["run"], tb[0]), "rb").read()
    assert b"validation/alignment" in raw and b"validation_inf/gate" in raw


def test_a_failed_rendering_never_stops_training(tmp_path, monkeypatch,
                                                 capsys):
    logger = MetricsLogger(str(tmp_path))
    t = types.SimpleNamespace(logger=logger)
    monkeypatch.setattr(plotting, "plot_alignment",
                        lambda *a: (_ for _ in ()).throw(ImportError("x")))
    Trainer._log_validation_images(t, 0, _batch(0), {
        "alignments": torch.zeros(B, T_DEC, T_TXT)})
    assert "image logging failed" in capsys.readouterr().out


@pytest.mark.parametrize("fn", ["plot_alignment", "plot_spectrogram",
                                "plot_gate"])
def test_plots_equal_jax(fn):
    from cookietts_tpu.runtime import plotting as jplot
    rng = np.random.default_rng(4)
    args = {"plot_alignment": (rng.random((20, 12)),),
            "plot_spectrogram": (rng.normal(size=(20, 10)), "predicted"),
            "plot_gate": (rng.random(20), rng.normal(size=20))}[fn]
    got, want = getattr(plotting, fn)(*args), getattr(jplot, fn)(*args)
    assert got.dtype == np.uint8 and got.ndim == 3
    assert np.array_equal(got, want)


def test_async_save_writes_the_synchronous_file(start, tmp_path):
    tree, meta = load_checkpoint(os.path.join(start["run"], "checkpoint_1"))
    assert meta["best_val_loss"] == float("inf") and tree["step"] == 1
    # torch.save names the archive after the file: the same name in another
    # directory
    save_checkpoint(str(tmp_path / "sync" / "checkpoint_1"), tree, meta)
    ck = Checkpointer(str(tmp_path / "run"), async_save=True)
    ck.save_periodic(1, tree, meta)
    ck.wait()
    assert ck.latest() == str(tmp_path / "run" / "checkpoint_1")
    written = open(tmp_path / "run" / "checkpoint_1", "rb").read()
    assert written == open(tmp_path / "sync" / "checkpoint_1", "rb").read()
    assert json.load(open(tmp_path / "run" / "checkpoint_1.json")) == meta
    assert not [f for f in os.listdir(tmp_path / "run") if f.endswith(".tmp")]


def test_async_save_writes_the_state_at_the_call(tmp_path):
    """Trainer.save hands the writer its own host copy: weights changed
    while the write is in flight do not reach the file."""
    torch.manual_seed(0)
    model = Tacotron2(Tacotron2Config(**TACO), device="cpu")
    want = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = Trainer(TrainerConfig(run_dir=str(tmp_path), async_save=True),
                      TrainState.create(model, adam()),
                      make_tacotron2_train_step(model), device="cpu")
    trainer.save(periodic=True)
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    trainer.ckpt.wait()
    got = load_checkpoint(str(tmp_path / "checkpoint_0"))[0]["state_dict"]
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_a_failed_async_save_raises_once_at_wait(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=True)
    (tmp_path / "blocked").write_text("a file where a directory must be")
    ck._save(str(tmp_path / "blocked" / "ckpt"), {"x": torch.ones(2)}, None)
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                                  # once
    ck.save_periodic(2, {"x": torch.ones(2)})  # later saves still land
    ck.wait()
    assert load_checkpoint(str(tmp_path / "checkpoint_2"))[0]["x"].sum() == 2


def test_train_command_honours_both_keys(tmp_path):
    """``validate_at_start`` and ``async_save`` from --hparams (before this
    port's trainer read them, the command dropped both)."""
    from cookietts_tpu_torch.data import audio_io
    rng = np.random.default_rng(1)
    lines = []
    for i in range(3):
        t = np.arange(8000) / 16000
        audio = (0.3 * np.sin(2 * np.pi * 220 * (i + 1) * t)
                 + 0.01 * rng.standard_normal(len(t))).astype(np.float32)
        audio_io.save_wav(str(tmp_path / f"v{i}.wav"), audio, 16000)
        lines.append(f"{tmp_path / f'v{i}.wav'}||{i}")
    (tmp_path / "map.txt").write_text("\n".join(lines))
    run = str(tmp_path / "run")
    trainer = cli([
        "train", "--model", "waveglow", "--device", "cpu", "--filelist",
        str(tmp_path / "map.txt"), "--run_dir", run, "--iters", "2",
        "--hparams",
        "batch_size=2,segment_length=2560,sampling_rate=16000,"
        "filter_length=512,hop_length=128,win_length=512,n_mel_channels=16,"
        "mel_fmax=8000.0,load_from_disk_dtw=False,log_every=1,n_layers=1,"
        "n_channels=8,upsample_channels=8,n_flows=2,n_group=4,"
        "n_early_every=0,upsample_strides=[4,8],validation_interval=2,"
        "checkpoint_interval=2,validate_at_start=True,async_save=True"])
    assert trainer.ckpt._executor is not None
    with open(os.path.join(run, "events.jsonl")) as f:
        ev = [json.loads(line) for line in f]
    assert [e["step"] for e in ev if e["prefix"] == "validation"] == [0, 2]
    assert {"checkpoint_2", "best_val_model"} <= set(os.listdir(run))


def test_dynamic_loss_scaler_follows_jax():
    from cookietts_tpu.runtime.optim import DynamicLossScaler as JScaler
    rng = np.random.default_rng(0)
    overflow = rng.random(400) < 0.03
    ours = DynamicLossScaler(scale=2.0 ** 8, scale_factor=2.0,
                             scale_window=20)
    theirs = JScaler(scale=2.0 ** 8, scale_factor=2.0, scale_window=20)
    got, want = [], []
    for o in overflow:
        ours.step(bool(o))
        theirs.step(bool(o))
        got.append(ours.scale)
        want.append(theirs.scale)
    assert got == want and len(set(got)) > 3
    for _ in range(12):                       # the floor at 1
        ours.step(True)
    assert ours.scale == 1.0
    tree = {"a": torch.full((2,), 8.0), "b": [torch.ones(3), None]}
    ours.scale = 4.0
    out = ours.unscale(tree)
    assert torch.equal(out["a"], torch.full((2,), 2.0))
    assert torch.equal(out["b"][0], torch.full((3,), 0.25))
    assert out["b"][1] is None

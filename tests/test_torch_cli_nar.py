"""``train --model untts`` and ``train --model gantts`` of the port on the
CPU at tiny widths (cookietts_tpu/cli.py:_train_untts, _train_gantts):
checkpoints with their metadata, events with validation, ``--resume``
going on from the saved iteration, and UnTTS's ``--warm_start`` with
``ignore_layers``. Durations come from ``.gdur.npy`` sidecars on half the
files (the gta command's), uniform on the rest."""
import json

import numpy as np
import pytest
import torch

from cookietts_tpu_torch.cli import main as cli
from cookietts_tpu_torch.data import evidence_corpus
from test_torch_threads import _one_thread  # noqa: F401

FRONT = ("sampling_rate=22050,filter_length=512,hop_length=128,"
         "win_length=512,n_mel_channels=20,mel_fmax=8000.0,trim_enable=False,"
         "text_buckets=[16],mel_buckets=[192],batch_size=2,"
         "validation_interval=2,checkpoint_interval=2,log_every=1,"
         "symbols_embedding_dim=16,n_speakers=4,speaker_embedding_dim=8,"
         "enc_layers=1,enc_heads=2,enc_ffn_dim=24,")
# f0 is in Hz, so the f0 MSE (weight 0.1) starts near 1e3-1e4: above the
# default explosion threshold of 1e3, which would roll every step back
UNTTS = FRONT + ("predictor_filter_size=8,predictor_layers=1,dec_n_flows=2,"
                 "dec_n_layers=1,dec_n_channels=16,use_varglow=True,"
                 "loss_explosion_threshold=1e9")
GANTTS = FRONT + ("z_dim=8,g_channels=[16,16],d_channels=[8,8],"
                  "d_windows=[8,16],mel_weight=2.0,d_lr_scale=0.5")


@pytest.fixture(scope="module")
def filelist(tmp_path_factory):
    work = tmp_path_factory.mktemp("corpus")
    train_fl, _ = evidence_corpus.make_corpus(str(work), seed=6, n_train=5,
                                              n_val=0)
    with open(train_fl) as f:
        wavs = [ln.split("|")[0] for ln in f if ln.strip()]
    rng = np.random.default_rng(0)
    for w in wavs[::2]:
        np.save(w + ".gdur.npy", rng.integers(1, 12, 10))
    return train_fl


def _events(run):
    train, val = [], []
    for line in (run / "events.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if rec["prefix"] == "train":
            train.append(rec)
        elif rec["prefix"] == "validation":
            val.append(rec)
    return train, val


def _train(model, filelist, run, iters, hparams, *extra, seed=0):
    return cli(["train", "--model", model, "--device", "cpu", "--filelist",
                filelist, "--run_dir", str(run), "--iters", str(iters),
                "--seed", str(seed), "--hparams", hparams, *extra])


@pytest.mark.parametrize("model,hparams,keys", [
    ("untts", UNTTS, ("flow_nll", "dur_MSE", "f0_MSE", "energy_MSE",
                      "varglow_nll", "grad_norm")),
    ("gantts", GANTTS, ("d_loss", "d_grad_norm", "g_adv", "g_mel_l1",
                        "g_loss", "g_grad_norm"))])
def test_train_validate_save_resume(filelist, tmp_path, model, hparams, keys):
    """2 iterations (validation and a checkpoint at 2), then --resume to 4:
    every logged loss finite, the resume at step 2, checkpoints 2 and 4
    with the model's metadata (GAN-TTS's holding D too)."""
    run = tmp_path / model
    _train(model, filelist, run, 2, hparams)
    trainer = _train(model, filelist, run, 4, hparams, "--resume")
    assert trainer.state.step == 4
    train, val = _events(run)
    assert [r["step"] for r in train] == [0, 1, 2, 3]
    assert [r["step"] for r in val] == [2, 4]
    for r in train:
        assert all(np.isfinite(r[k]) for k in keys + ("loss",)), r
    assert all(np.isfinite(r["val_loss"]) for r in val)
    for step in (2, 4):
        meta = json.loads((run / f"checkpoint_{step}.json").read_text())
        assert meta["model"] == model
        assert meta["model_config"]["n_mel_channels"] == 20
        tree = torch.load(run / f"checkpoint_{step}", map_location="cpu")
        assert tree["step"] == step
        assert ("d_state_dict" in tree) == (model == "gantts")
    if model == "gantts":
        assert all(abs(r["lr"] - 1e-4) < 1e-12 for r in train)


def test_untts_warm_start_ignore_layers(filelist, tmp_path, capsys):
    """--warm_start loads every weight of a checkpoint but the ignored
    layers' (those keep the new run's init, from another seed)."""
    src = tmp_path / "src"
    _train("untts", filelist, src, 2, UNTTS)
    capsys.readouterr()
    dst = tmp_path / "dst"
    trainer = _train("untts", filelist, dst, 1,
                     UNTTS + ",ignore_layers=[decoder]",
                     "--warm_start", str(src / "checkpoint_2"), seed=1)
    sd = trainer.state.model.state_dict()
    n_ignored = sum("decoder" in k for k in sd)
    assert (f"warm start: {len(sd) - n_ignored} loaded, {n_ignored} skipped"
            in capsys.readouterr().out)
    before = torch.load(src / "checkpoint_2", map_location="cpu")["state_dict"]
    lr = 1e-4
    for k in ("embedding.weight", "duration_predictor.fc.bias",
              "decoder.wn.0.start.weight"):
        moved = float((sd[k].cpu() - before[k]).abs().max())
        assert (moved > 10 * lr) == ("decoder" in k), (k, moved)

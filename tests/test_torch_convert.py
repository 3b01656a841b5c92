"""The port's ``convert`` command against the JAX package's on the CPU.

No trained reference checkpoint is in the repository, so each of the seven
models' "reference" files is a seeded port model's state dict (the port
keeps the reference key names), written as an ``.npz`` and as a ``.pt``
(wrapped under ``state_dict``, or a whole module). For each: the converted
state dict equals the source's tensors bit for bit (HiFi-GAN's weight-norm
pairs folded as the port's load folds them), the sidecar's ``model_config``
equals the one JAX's ``cmd_convert`` writes for the same ``.npz``, and the
model loaded from the converted checkpoint (its configuration from the
hints) gives the source model's outputs. A Tacotron2 whose attention is not
type 0 is refused.
"""
import argparse
import json

import numpy as np
import pytest
import torch

from cookietts_tpu_torch.cli import _dataclass_kwargs, main as cli
from cookietts_tpu_torch.models import emotionnet as pem
from cookietts_tpu_torch.models import gst as pgst
from cookietts_tpu_torch.models.hifigan import Generator, HiFiGANConfig
from cookietts_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
from cookietts_tpu_torch.models.torchmoji import TorchMoji
from cookietts_tpu_torch.models.waveglow import WaveGlow, WaveGlowConfig
from cookietts_tpu_torch.runtime.checkpoint import load_checkpoint
from tests.test_torch_tacotron2_heads import HEADS
from test_torch_threads import _one_thread  # noqa: F401


WAVEGLOW = dict(n_mel_channels=4, n_flows=4, n_group=4, n_early_every=2,
                n_early_size=2, n_layers=2, n_channels=8, kernel_size=3,
                hop_length=8, upsample_mode="single", upsample_win_length=16,
                couple_transform="second")
HIFIGAN = dict(n_mel_channels=6, upsample_initial_channel=16,
               upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4))
GST = dict(n_mel_channels=16, token_embedding_size=8, token_num=4, num_heads=2,
           gst_att_dim=8, ref_enc_filters=(4, 4), torchmoji_dim=6)
EMOTION = dict(n_classes=3, latent_dim=2, ref_enc_filters=(4, 4),
               ref_enc_rnn_dim=6, rnn_dim=5, speaker_embedding_dim=6,
               torchmoji_dim=7, aux_layer_dims=(8,), n_mel_channels=16,
               encoder_dim=10)


def _seeded(build, seed=0):
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        return build()


def _source(name):
    """(source model, the state dict written as the reference file, a
    function building the port model from the converted sidecar's hints,
    a function of a model giving its outputs)."""
    g = lambda: torch.Generator().manual_seed(1)           # noqa: E731
    rng = np.random.default_rng(2)
    if name == "tacotron2":
        cfg = Tacotron2Config(**HEADS)
        model = _seeded(lambda: Tacotron2(cfg, device="cpu"))
        text = torch.from_numpy(rng.integers(1, 40, (2, 9)))
        run = lambda m: m.inference(text, torch.tensor([9, 6]),  # noqa: E731
                                    torch.tensor([1, 2]), max_decoder_steps=8,
                                    generator=g())["mel_outputs_postnet"]
        return model, model.state_dict(), lambda h: Tacotron2(cfg, device="cpu"), run
    if name == "waveglow":
        model = _seeded(lambda: WaveGlow(WaveGlowConfig(**WAVEGLOW), device="cpu"))
        mel = torch.from_numpy(rng.normal(0, 1, (1, 5, 4)).astype(np.float32))
        build = lambda h: WaveGlow(WaveGlowConfig(  # noqa: E731
            **_dataclass_kwargs(WaveGlowConfig, h), hop_length=8), device="cpu")
        return model, model.state_dict(), build, lambda m: m.infer(mel, g())
    if name == "hifigan":
        cfg = HiFiGANConfig(**HIFIGAN)
        train = _seeded(lambda: Generator(cfg, device="cpu", weight_norm=True))
        for p in train.parameters():        # weight_g away from its ones
            p.data.mul_(1.0 + 0.1 * torch.rand(p.shape, generator=g()))
        model = Generator(cfg, device="cpu")
        model.load_state_dict(train.state_dict())
        mel = torch.from_numpy(rng.normal(0, 1, (1, 7, 6)).astype(np.float32))

        def build(h):
            kw = _dataclass_kwargs(HiFiGANConfig, h)
            kw["upsample_rates"] = tuple(k // 2 for k in kw["upsample_kernel_sizes"])
            return Generator(HiFiGANConfig(**kw), device="cpu")
        return model, train.state_dict(), build, lambda m: m(mel, infer=True)
    if name == "torchmoji":
        model = _seeded(lambda: TorchMoji(16, device="cpu"))
        ids = torch.from_numpy(rng.integers(1, 16, (2, 5)))
        return (model, model.state_dict(),
                lambda h: TorchMoji(h["nb_tokens"], device="cpu"), lambda m: m(ids))
    mel = torch.from_numpy(rng.normal(0, 1, (2, 12, 16)).astype(np.float32))
    if name == "gst":
        model = _seeded(lambda: pgst.GST(pgst.GSTConfig(**GST)))
        build = lambda h: pgst.GST(pgst.GSTConfig(  # noqa: E731
            **{**GST, **_dataclass_kwargs(pgst.GSTConfig, h)}))
        return model, model.state_dict(), build, lambda m: m(mel, 1)["style_embedding"]
    spk = torch.from_numpy(rng.normal(0, 1, (2, 6)).astype(np.float32))
    enc = torch.from_numpy(rng.normal(0, 1, (2, 4, 10)).astype(np.float32))
    tm = torch.from_numpy(rng.normal(0, 1, (2, 7)).astype(np.float32))
    cls = pem.EmotionNet if name == "emotionnet" else pem.AuxEmotionNet
    model = _seeded(lambda: cls(pem.EmotionNetConfig(**EMOTION)))
    build = lambda h: cls(pem.EmotionNetConfig(  # noqa: E731
        **{**EMOTION, **_dataclass_kwargs(pem.EmotionNetConfig, h)}))
    first = mel if name == "emotionnet" else tm
    return model, model.state_dict(), build, lambda m: m(first, spk, enc)["zu_mu"]


MODELS = ("tacotron2", "waveglow", "hifigan", "torchmoji", "gst", "emotionnet",
          "auxemotionnet")


@pytest.mark.parametrize("name", MODELS)
def test_convert_matches_jax_and_the_source(name, tmp_path):
    from cookietts_tpu.cli import cmd_convert as jax_convert
    source, ref_sd, build, run = _source(name)
    npz = str(tmp_path / "ref.npz")
    np.savez(npz, **{k: v.numpy() for k, v in source.state_dict().items()})
    pt = str(tmp_path / "ref.pt")
    torch.save(source if name == "gst" else {"state_dict": ref_sd}, pt)
    jax_convert(argparse.Namespace(model=name, torch_ckpt=npz,
                                   output=str(tmp_path / "jax.msgpack")))
    want = json.load(open(tmp_path / "jax.msgpack.json"))
    for src in (npz, pt):
        out = str(tmp_path / "port.pt")
        cli(["convert", "--model", name, "--torch_ckpt", src, "-o", out])
        tree, meta = load_checkpoint(out)
        assert meta == {"model": name, **({"model_config": want["model_config"]}
                                          if "model_config" in want else {})}
        sd = tree["state_dict"]
        expect = source.state_dict()   # the serving form: pairs folded
        assert set(sd) == set(expect)
        for k, t in expect.items():
            assert torch.equal(sd[k], t), k
        model = build(meta.get("model_config", {}))
        model.load_state_dict(sd)
        model.eval()
        with torch.no_grad():
            assert torch.equal(run(model), run(source.eval()))


def test_tacotron2_of_another_attention_type_is_refused(tmp_path):
    model = Tacotron2(Tacotron2Config(**dict(HEADS, attention_type=1,
                                             num_att_mixtures=2)), device="cpu")
    src = str(tmp_path / "gmm.pt")
    torch.save({"model": {f"module.{k}": v for k, v in model.state_dict().items()}},
               src)
    with pytest.raises(SystemExit, match="attention_type 0"):
        cli(["convert", "--model", "tacotron2", "--torch_ckpt", src,
             "-o", str(tmp_path / "out.pt")])


def test_converted_checkpoints_serve_through_tts(tmp_path):
    """A converted Tacotron2 (with the heads; as in JAX its configuration
    comes from --hparams) and HiFi-GAN (from the sidecar's hints) behind
    the tts command on the CPU."""
    taco, taco_sd, _, _ = _source("tacotron2")
    gen = _seeded(lambda: Generator(HiFiGANConfig(**dict(
        HIFIGAN, n_mel_channels=80)), device="cpu", weight_norm=True))
    torch.save(taco_sd, tmp_path / "taco_ref.pt")
    torch.save({"state_dict": gen.state_dict()}, tmp_path / "hifigan_ref.pt")
    for name, src in (("tacotron2", "taco_ref.pt"), ("hifigan", "hifigan_ref.pt")):
        cli(["convert", "--model", name, "--torch_ckpt", str(tmp_path / src),
             "-o", str(tmp_path / name)])
    fmt = lambda v: ("[" + ",".join(map(str, v)) + "]"  # noqa: E731
                     if isinstance(v, tuple) else v)
    hp = ",".join(f"{k}={fmt(v)}" for k, v in HEADS.items() if k != "n_symbols")
    stats = cli(["tts", "--device", "cpu", "--checkpoint",
                 str(tmp_path / "tacotron2"), "--vocoder",
                 str(tmp_path / "hifigan"), "--text", "Hello there.",
                 "--hparams", hp + ",batch_size=1,step_buckets=[16],"
                 "max_decoder_steps=16,gate_threshold=2.0",
                 "-o", str(tmp_path / "out.wav"), "--max_attempts", "1"])
    assert stats["out"].endswith("out.wav") and stats["segments"] == 1
    assert stats["audio_seconds"] > 0

"""The port's ``tts`` and ``server`` commands against the JAX package's, on
the CPU at tiny widths (cookietts_tpu/cli.py:1454-1697; mirrors
tests/test_cli.py's tts test and tests/test_pipeline.py's GST style test).

One set of JAX weights (Tacotron2 with the GST and EmotionNet heads, and a
torchMoji with a small vocabulary) is saved as a JAX checkpoint and, through
``convert.from_jax``, as port checkpoints; both ``tts`` commands, with
``--torchmoji``, ``--arpa_dict`` and no vocoder, write the same mel. The
T2S worker's torchMoji path (one feature per segment, zeros for
``style_mode="none"``) is held to JAX's the same way. The vocoder loader's
HiFi-GAN and WaveFlow branches, ``--speaker_info``, ``--denoiser``, the
server wiring and ``--artifact`` refusing a JAX artifact run on the port
alone (tests/test_torch_export.py serves the port's own artifacts).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cookietts_tpu import cli as jcli
from cookietts_tpu.models import torchmoji as jmoji
from cookietts_tpu.models.tacotron2 import Tacotron2 as JTacotron2
from cookietts_tpu.models.tacotron2 import Tacotron2Config as JTConfig
from cookietts_tpu.pipeline.text2speech import T2S as JT2S
from cookietts_tpu.pipeline.text2speech import T2SConfig as JT2SConfig
from cookietts_tpu.runtime.checkpoint import save_checkpoint as jsave
from cookietts_tpu.text import N_SYMBOLS
from cookietts_tpu.text.cmudict import ARPADict as JARPADict

from cookietts_tpu_torch import cli
from cookietts_tpu_torch.convert.from_jax import (tacotron2_state_dict_from_jax,
                                                  torchmoji_state_dict_from_jax)
from cookietts_tpu_torch.models.torchmoji import TorchMojiEncoder
from cookietts_tpu_torch.pipeline.text2speech import T2S, T2SConfig
from cookietts_tpu_torch.runtime.checkpoint import save_checkpoint
from cookietts_tpu_torch.text.cmudict import ARPADict
from test_torch_threads import _one_thread  # noqa: F401


TACO = dict(
    n_symbols=N_SYMBOLS, symbols_embedding_dim=16, n_speakers=4,
    speaker_embedding_dim=8, encoder_speaker_embed_dim=4,
    encoder_conv_hidden_dim=16, encoder_lstm_dim=16, encoder_n_convolutions=1,
    torchmoji_crushed_dim=4, memory_bottleneck_dim=16, prenet_dim=8,
    attention_rnn_dim=16, decoder_rnn_dim=16, second_decoder_rnn_dim=16,
    attention_dim=8, windowed_attention_range=4, postnet_embedding_dim=16,
    postnet_n_convolutions=2, postnet_residual_connections=0,
    p_prenet_dropout=0.0, use_gst=True, gst_token_num=4,
    gst_token_embedding_size=8, gst_num_heads=2, gst_att_dim=8,
    gst_ref_enc_filters=(4, 4), use_emotionnet=True, n_emotion_classes=3,
    emotionnet_latent_dim=2)
SPEAKERS = {"alice": 0, "bob": 2}
AUDIO = {"sampling_rate": 22050, "hop_length": 256, "n_mel_channels": 80}
# the gates of random weights fire at once or never: a threshold above 1
# fixes every decode at its bucket's length
HPARAMS = ("batch_size=2,max_text_len=64,frames_per_char=2.0,"
           "step_buckets=[64],max_decoder_steps=64,gate_threshold=2.0")
T2S_CFG = dict(batch_size=2, max_attempts=1, step_buckets=(64,),
               max_decoder_steps=64, frames_per_char=2.0, gate_threshold=2.0)
ARPA = "HELLO  HH AH0 L OW1\nWORLD  W ER1 L D\nQUICK  K W IH1 K\n"
VOCAB_WORDS = ["hello", "world", "the", "quick", "fox", ".", "!", "happy"]
TEXT = "Hello world, the quick fox!"


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """JAX and port checkpoints of the same weights, a vocabulary, an ARPA
    dictionary; returns the paths and the JAX model and variables."""
    d = tmp_path_factory.mktemp("tts")
    rng = np.random.default_rng(0)
    jm = JTacotron2(JTConfig(**TACO))
    B, T = 2, 16
    v = jax.jit(jm.init, static_argnames=("deterministic",))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        text=jnp.ones((B, T), jnp.int32), text_lengths=jnp.full((B,), T),
        mels=jnp.zeros((B, 16, 80)), mel_lengths=jnp.full((B,), 16),
        speaker_id=jnp.zeros((B,), int), sylps=jnp.full((B,), 4.0),
        key=jax.random.PRNGKey(2), deterministic=True)
    v = jax.tree_util.tree_map(np.array, v)
    for path, x in jax.tree_util.tree_flatten_with_path(v["batch_stats"])[0]:
        x[...] = (rng.uniform(0.5, 1.5, x.shape)
                  if "var" in jax.tree_util.keystr(path)
                  else rng.normal(0, 0.2, x.shape))
    meta = {"model": "tacotron2",
            "model_config": {k: list(x) if isinstance(x, tuple) else x
                             for k, x in TACO.items()},
            "speaker_ids": SPEAKERS, "audio": AUDIO}
    p = {"jax": str(d / "taco_jax"), "port": str(d / "taco.pt"),
         "tm_jax": str(d / "moji_jax"), "tm_port": str(d / "pytorch_model.bin"),
         "vocab": str(d / "vocabulary.json"), "arpa": str(d / "merged.dict"),
         "dir": d}
    jsave(p["jax"], {"params": v["params"],
                     "mutables": {"batch_stats": v["batch_stats"]}}, meta)
    save_checkpoint(p["port"], {"state_dict": tacotron2_state_dict_from_jax(
        v["params"], v["batch_stats"])}, meta)

    vocab = {t: i for i, t in enumerate(jmoji.SPECIAL_TOKENS)}
    vocab.update({w: len(vocab) + i for i, w in enumerate(VOCAB_WORDS)})
    with open(p["vocab"], "w") as f:
        json.dump(vocab, f)
    tm = jmoji.TorchMoji(nb_tokens=32)
    tm_params = jax.tree_util.tree_map(np.array, tm.init(
        jax.random.PRNGKey(4), jnp.ones((1, 4), jnp.int32))["params"])
    tm_params["attention_vector"] *= 20.0
    jsave(p["tm_jax"], {"params": tm_params})
    torch.save(torchmoji_state_dict_from_jax(tm_params), p["tm_port"])
    with open(p["arpa"], "w") as f:
        f.write(ARPA)
    return p, jm, v, tm, tm_params, vocab


def _stats(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_tts_mel_matches_jax(ckpts, capsys):
    p, *_ = ckpts
    args = ["tts", "--text", TEXT, "--max_attempts", "1", "--hparams", HPARAMS,
            "--arpa_dict", p["arpa"], "--torchmoji_vocab", p["vocab"]]
    jcli.main(args + ["--checkpoint", p["jax"], "--torchmoji", p["tm_jax"],
                      "--out", str(p["dir"] / "jax.wav")])
    ref = _stats(capsys)
    cli.main(args + ["--checkpoint", p["port"], "--torchmoji", p["tm_port"],
                     "--out", str(p["dir"] / "port.wav"), "--device", "cpu"])
    got = _stats(capsys)
    assert set(got) == set(ref)
    assert got["out"].endswith("port.mel.npy") and got["segments"] == 1
    mel, mel_ref = np.load(got["out"]), np.load(ref["out"])
    assert mel.shape == mel_ref.shape == (64, 80)
    np.testing.assert_allclose(mel, mel_ref, atol=1e-4, rtol=0)


def test_arpa_dict_matches_jax(tmp_path):
    path = tmp_path / "merged.dict"
    path.write_text(ARPA + "DON'T  D OW1 N T\nCAFE  K AE0 F EY1\n")
    port, ref = ARPADict(str(path)), JARPADict(str(path))
    assert port.arpadict == ref.arpadict
    for text in ("Hello, world!", "(quick) \"hello\" don't cafe.",
                 "unknown words stay", "'world'?", "a - b", ""):
        assert port.get(text) == ref.get(text), text


def test_t2s_torchmoji_path_matches_jax(ckpts):
    """One torchMoji feature per segment under style_mode "torchmoji", zeros
    under "none": the port's T2S gives JAX's mels either way, and the two
    modes differ."""
    p, jm, v, tm, tm_params, vocab = ckpts
    j_enc = jmoji.TorchMojiEncoder(vocab, {"params": tm_params})
    enc = TorchMojiEncoder(vocab, torchmoji_state_dict_from_jax(tm_params),
                           device="cpu")
    np.testing.assert_allclose(enc(TEXT), np.asarray(j_enc(TEXT)), atol=1e-5,
                               rtol=1e-5)
    taco = cli._build_t2s(cli.build_parser().parse_args(
        ["tts", "--text", "-", "--checkpoint", p["port"], "--device", "cpu",
         "--hparams", "gate_threshold=2.0"])).model
    seen = []
    record = lambda text: seen.append(text) or enc(text)   # noqa: E731
    j_t2s = JT2S(JT2SConfig(**T2S_CFG),
                 JTacotron2(JTConfig(**TACO, gate_threshold=2.0)), v, SPEAKERS,
                 torchmoji_fn=j_enc, sample_rate=22050, hop_length=256)
    p_t2s = T2S(T2SConfig(**T2S_CFG), taco, SPEAKERS, torchmoji_fn=record,
                sample_rate=22050, hop_length=256, device="cpu")
    text = 'Hello world. "The quick fox!" said alice.'
    mels = {}
    for mode in ("torchmoji", "none"):
        ref = j_t2s.infer(text, speaker=["alice", "bob"], style_mode=mode, seed=3)
        got = p_t2s.infer(text, speaker=["alice", "bob"], style_mode=mode, seed=3)
        assert got["segments"] == ref["segments"] and len(got["segments"]) == 3
        for m_got, m_ref in zip(got["mels"], ref["mels"]):
            np.testing.assert_allclose(m_got, m_ref, atol=1e-4, rtol=0)
        mels[mode] = got["mels"]
    assert seen == got["segments"]          # once per segment, "none" never
    assert not np.allclose(mels["torchmoji"][0], mels["none"][0], atol=1e-3)


def _hifigan_ckpt(path, meta):
    from cookietts_tpu_torch.models.hifigan import Generator, HiFiGANConfig
    cfg = HiFiGANConfig(resblock_kernel_sizes=(3,), resblock_dilations=((1, 3),),
                        upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
                        upsample_initial_channel=16)
    torch.manual_seed(0)
    train_form = Generator(cfg, device="cpu", weight_norm=True)
    save_checkpoint(path, {"state_dict": train_form.state_dict()}, meta and {
        "model": "hifigan", "audio": AUDIO,
        "model_config": {"resblock_kernel_sizes": [3],
                         "resblock_dilations": [[1, 3]],
                         "upsample_kernel_sizes": [16, 16, 8],
                         "upsample_initial_channel": 16}})
    return train_form


def _waveflow_ckpt(path):
    from cookietts_tpu_torch.models.waveglow import WaveGlow, WaveGlowConfig
    kw = dict(n_mel_channels=80, n_flows=2, n_group=8, n_early_every=0,
              channel_mixing="permuteheight", n_layers=2, n_channels=8,
              kernel_size_h=2, hop_length=256, upsample_strides=(32,),
              upsample_channels=8, sampling_rate=22050)
    torch.manual_seed(1)
    model = WaveGlow(WaveGlowConfig(**kw), device="cpu")
    config = {k: list(x) if isinstance(x, tuple) else x for k, x in kw.items()}
    save_checkpoint(path, {"state_dict": model.state_dict()},
                    {"model": "waveglow", "audio": AUDIO, "model_config": config})
    return model, config


@pytest.mark.parametrize("meta", [True, False])
def test_load_vocoder_hifigan(tmp_path, meta):
    """A trained HiFi-GAN checkpoint (weight-norm pairs) loads folded, from
    its sidecar or, without one, from its key layout."""
    path = str(tmp_path / "hifigan.pt")
    train_form = _hifigan_ckpt(path, meta)
    overrides = {} if meta else {"resblock_kernel_sizes": [3],
                                 "resblock_dilations": [[1, 3]],
                                 "upsample_kernel_sizes": [16, 16, 8],
                                 "upsample_initial_channel": 16}
    vocoder_fn, infer, audio = cli._load_vocoder(path, overrides, device="cpu")
    assert audio["hop_length"] == 256 and audio["n_mel_channels"] == 80
    mel = torch.randn(1, 6, 80, generator=torch.Generator().manual_seed(0))
    want = train_form(mel, infer=True)
    torch.testing.assert_close(vocoder_fn(mel, infer=True), want,
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(infer(mel, None), want, atol=1e-5, rtol=1e-5)


def test_load_vocoder_waveflow_and_tts_with_denoiser(ckpts, tmp_path, capsys):
    """A WaveFlow checkpoint, detected by its layout: a stochastic
    vocoder_fn drawing z from generators seeded 0, 1, ...; then tts through
    it with --denoiser writes a WAV of the decoded length."""
    from cookietts_tpu_torch.data.audio_io import load_wav
    p, *_ = ckpts
    path = str(tmp_path / "waveflow.pt")
    model, config = _waveflow_ckpt(path)
    os.remove(path + ".json")
    with pytest.raises(SystemExit, match="not a vocoder"):
        cli._load_vocoder(p["port"], {}, device="cpu")
    vocoder_fn, infer, audio = cli._load_vocoder(path, config, device="cpu")
    assert vocoder_fn.stochastic is True
    mel = torch.randn(1, 3, 80, generator=torch.Generator().manual_seed(0))
    want = model.infer(mel, torch.Generator().manual_seed(0))
    torch.testing.assert_close(vocoder_fn(mel), want, atol=0, rtol=0)

    _waveflow_ckpt(path)
    out = str(tmp_path / "flow.wav")
    cli.main(["tts", "--checkpoint", p["port"], "--vocoder", path, "--denoiser",
              "--text", "Hello world.", "--out", out, "--max_attempts", "1",
              "--denoise_strength", "0.1", "--hparams", HPARAMS,
              "--device", "cpu"])
    stats = _stats(capsys)
    wav, sr = load_wav(out)
    assert stats["out"] == out and sr == 22050
    assert abs(len(wav) - 64 * 256) <= 256 and stats["audio_seconds"] > 0


def test_tts_hifigan_speaker_info(ckpts, tmp_path, capsys):
    from cookietts_tpu_torch.data.audio_io import load_wav
    p, *_ = ckpts
    voc = str(tmp_path / "hifigan.pt")
    _hifigan_ckpt(voc, True)
    info = tmp_path / "speaker_info.txt"
    info.write_text(";dataset|speaker_name|speaker_id|duration_hrs\n"
                    "ds|Zed|3|1.0\nds|Yan|1|0.5\n")
    args = cli.build_parser().parse_args(
        ["tts", "--checkpoint", p["port"], "--vocoder", voc, "--speaker_info",
         str(info), "--text", "Hello.", "--speaker", "zed", "--out",
         str(tmp_path / "h.wav"), "--max_attempts", "1", "--hparams", HPARAMS,
         "--device", "cpu"])
    assert cli._build_t2s(args).speaker_ids == {"Zed": 3, "Yan": 1}
    stats = args.fn(args)
    wav, sr = load_wav(stats["out"])
    assert sr == 22050 and len(wav) == 64 * 256
    assert _stats(capsys)["segments"] == 1


def test_server_wiring_and_artifact_refused(ckpts, monkeypatch):
    from cookietts_tpu_torch.pipeline import server
    p, *_ = ckpts
    served = {}
    monkeypatch.setattr(server, "serve", lambda t2s, port: served.update(
        t2s=t2s, port=port))
    cli.main(["server", "--checkpoint", p["port"], "--port", "5123",
              "--torchmoji", p["tm_port"], "--torchmoji_vocab", p["vocab"],
              "--device", "cpu"])
    assert served["port"] == 5123 and isinstance(served["t2s"], T2S)
    assert served["t2s"].torchmoji_fn is not None
    from cookietts_tpu.runtime.export_serving import save_artifact as jsave_art
    jax_art = str(p["dir"] / "jax_serving.npz")
    jsave_art(jax_art, {"t2s_b2_t64": b"stablehlo"}, {"platforms": ["cpu"]})
    for cmd in (["server"], ["tts", "--text", "x"]):
        with pytest.raises(ValueError, match="not a torch.export artifact"):
            cli.main(cmd + ["--artifact", jax_art, "--device", "cpu"])
    with pytest.raises(SystemExit, match="--torchmoji_vocab"):
        cli.main(["server", "--checkpoint", p["port"], "--torchmoji",
                  p["tm_port"], "--device", "cpu"])

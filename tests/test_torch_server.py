"""The PyTorch port's HTTP service on the CPU: ``handle_tts`` with the
reference field names and the short aliases, the tornado app through
``tornado.testing`` (the cases of tests/test_pipeline.py's server tests), and
the WAV bytes against the JAX package's."""
import io
import json
import os
import wave

import numpy as np
import pytest
import torch

from cookietts_tpu_torch.models.hifigan import Generator, HiFiGANConfig
from cookietts_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
from cookietts_tpu_torch.pipeline.server import (ModelRegistry, _wav_bytes,
                                                 handle_tts, make_app)
from cookietts_tpu_torch.pipeline.text2speech import T2S, T2SConfig
from cookietts_tpu_torch.text import N_SYMBOLS
from test_torch_threads import _one_thread  # noqa: F401


TACO = dict(
    n_symbols=N_SYMBOLS, symbols_embedding_dim=16, n_speakers=4,
    speaker_embedding_dim=8, encoder_speaker_embed_dim=4,
    encoder_conv_hidden_dim=16, encoder_lstm_dim=16, encoder_n_convolutions=1,
    torchmoji_dim=8, torchmoji_crushed_dim=4, memory_bottleneck_dim=16,
    prenet_dim=8, attention_rnn_dim=16, decoder_rnn_dim=16,
    second_decoder_rnn_dim=16, attention_dim=8, windowed_attention_range=4,
    postnet_embedding_dim=16, postnet_n_convolutions=2,
    postnet_residual_connections=0)
HIFI = dict(resblock_kernel_sizes=(3,), resblock_dilations=((1, 3),),
            upsample_rates=(8, 8, 4, 2), upsample_kernel_sizes=(16, 16, 8, 4),
            upsample_initial_channel=16)
SR, HOP = 44100, 512


@pytest.fixture(scope="module")
def tiny_t2s():
    torch.manual_seed(0)
    taco = Tacotron2(Tacotron2Config(**TACO), device="cpu")
    gen = Generator(HiFiGANConfig(**HIFI), device="cpu")
    return T2S(T2SConfig(batch_size=4, max_attempts=1, step_buckets=(64,),
                         max_decoder_steps=64, frames_per_char=2.0),
               taco, {"Alice": 0, "Bob": 1}, vocoder_fn=gen, sample_rate=SR,
               hop_length=HOP, device="cpu")


REFERENCE = {"input_text": "Hi there.", "input_speaker": "alice",
             "input_multispeaker_mode": "cycle next", "input_target_score": "0.1",
             "input_batch_size": "2", "input_max_attempts": "1",
             "input_max_duration_s": "5", "input_cat_silence_s": "0.05",
             "input_use_arpabet": "on", "input_textseg_len_target": "80",
             "input_ttm_current": "m1"}
ALIASES = {"text": "Hi there.", "speaker": "alice",
           "multispeaker_mode": "cycle next", "target_score": 0.1,
           "batch_size": 2, "max_attempts": 1, "max_duration_s": 5,
           "cat_silence_s": 0.05, "use_arpabet": "1", "textseg_len_target": 80,
           "model": "m1", "gate_threshold": 0.5, "gate_delay": 4}


@pytest.mark.parametrize("fields", [REFERENCE, ALIASES],
                         ids=["reference", "aliases"])
def test_handle_tts_takes_both_spellings(tiny_t2s, tmp_path, fields):
    registry = ModelRegistry({"m1": tiny_t2s, "m2": lambda: tiny_t2s}, "m2")
    stats, wav = handle_tts(registry, fields.get, str(tmp_path), "Bob")
    assert stats["model"] == "m1" and stats["segments"] == ["Hi there."]
    assert stats["speakers"] == ["Alice"]
    for key in ("scores", "attempts", "failure_rate", "audio_seconds",
                "total_time", "xrt", "voice"):
        assert key in stats, key
    assert wav[:4] == b"RIFF" and wav[8:12] == b"WAVE"
    with wave.open(io.BytesIO(wav)) as w:
        assert (w.getframerate(), w.getnchannels(), w.getsampwidth()) == (SR, 1, 2)
        n = w.getnframes()
    assert n == round(stats["audio_seconds"] * SR) and n % HOP == 0 and n > 0
    with open(tmp_path / stats["voice"], "rb") as f:
        assert f.read() == wav


def test_wav_bytes_match_jax():
    from cookietts_tpu.pipeline.server import _wav_bytes as j_wav_bytes
    audio = np.random.default_rng(0).normal(0, 0.6, 3000).astype(np.float32)
    assert _wav_bytes(audio, SR) == j_wav_bytes(audio, SR)


def test_registry_refuses_unknown_models():
    with pytest.raises(KeyError):
        ModelRegistry({"a": object()}, "b")
    with pytest.raises(KeyError, match="unknown model"):
        ModelRegistry({"a": object()}, "a").get("c")


def _run(case_cls, monkeypatch):
    # a request decodes on the CPU, which the whole suite's workers share:
    # give it more than tornado's default 5 s
    monkeypatch.setenv("ASYNC_TEST_TIMEOUT", "120")
    case = case_cls()
    case.setUp()
    try:
        case.runTest()
    finally:
        case.tearDown()


def _case():
    """tornado's AsyncHTTPTestCase with a client timeout to match."""
    import tornado.testing

    class Case(tornado.testing.AsyncHTTPTestCase):
        def fetch(self, path, **kwargs):
            return super().fetch(path, request_timeout=120, **kwargs)
    return Case


def test_server_stats_endpoint(tiny_t2s, tmp_path, monkeypatch):
    class ServerTest(_case()):
        def get_app(self):
            return make_app(tiny_t2s, default_speaker="Alice",
                            output_dir=str(tmp_path))

        def runTest(self):
            resp = self.fetch("/")
            assert resp.code == 200 and b"cookietts_tpu" in resp.body
            resp = self.fetch(
                "/tts", method="POST",
                body="input_text=Hi there.&stats_only=1&batch_size=4"
                     "&max_attempts=1&target_score=0.1")
            assert resp.code == 200, resp.body
            stats = json.loads(resp.body)
            assert stats["segments"] == ["Hi there."] and "xrt" in stats
            # cleared form boxes post empty strings: the defaults apply
            resp = self.fetch(
                "/tts", method="POST",
                body="input_text=Hi there.&stats_only=1&batch_size=4"
                     "&max_attempts=1&input_target_score="
                     "&gate_delay=&input_cat_silence_s=&target_score=0.1")
            assert resp.code == 200, resp.body
            # a WAV body with the stats in a header; a JSON request body
            resp = self.fetch("/tts", method="POST", body=json.dumps(
                {"text": "Hi there.", "batch_size": 2, "max_attempts": 1}),
                headers={"Content-Type": "application/json"})
            assert resp.code == 200, resp.body
            assert resp.headers["Content-Type"] == "audio/wav"
            assert resp.body[:4] == b"RIFF"
            stats = json.loads(resp.headers["X-TTS-Stats"])
            assert os.path.exists(tmp_path / stats["voice"])

    _run(ServerTest, monkeypatch)


def test_server_full_field_surface(tiny_t2s, tmp_path, monkeypatch):
    """Reference form fields, model hot-swap and the /<voice> route, which
    serves files from the output dir and nothing outside it."""
    registry = ModelRegistry({"m1": tiny_t2s, "m2": lambda: tiny_t2s}, "m1")
    outdir = str(tmp_path / "out")

    class ServerTest(_case()):
        def get_app(self):
            return make_app(registry=registry, output_dir=outdir,
                            default_speaker="Alice")

        def runTest(self):
            body = ("input_text=Hi there.&stats_only=1"
                    "&input_speaker=alice&input_multispeaker_mode=quotes"
                    "&input_target_score=0.1&input_batch_size=4"
                    "&input_max_attempts=1&input_max_duration_s=5"
                    "&input_cat_silence_s=0.05&input_use_arpabet=on"
                    "&gate_threshold=0.2&gate_delay=3"
                    "&input_ttm_current=m2")
            resp = self.fetch("/tts", method="POST", body=body)
            assert resp.code == 200, resp.body
            stats = json.loads(resp.body)
            assert stats["model"] == "m2"
            assert stats["segments"] == ["Hi there."]
            with open(os.path.join(outdir, "probe.wav"), "wb") as f:
                f.write(b"RIFFxxxx")
            resp = self.fetch("/probe.wav")
            assert resp.code == 200 and resp.body.startswith(b"RIFF")
            with open(tmp_path / "escape.wav", "wb") as f:
                f.write(b"RIFFxxxx")
            resp = self.fetch("/../escape.wav")
            assert resp.code in (403, 404)
            resp = self.fetch("/missing.wav")
            assert resp.code == 404

    _run(ServerTest, monkeypatch)

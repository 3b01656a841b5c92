"""The PyTorch port's T2S worker against the JAX T2S on the CPU: the same
tiny Tacotron2 and HiFi-GAN weights on both sides (carried across with
``convert.from_jax``), prenet dropout 0, two requests."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cookietts_tpu.models.hifigan import Generator as JGenerator
from cookietts_tpu.models.hifigan import HiFiGANConfig as JHConfig
from cookietts_tpu.models.tacotron2 import Tacotron2 as JTacotron2
from cookietts_tpu.models.tacotron2 import Tacotron2Config as JTConfig
from cookietts_tpu.pipeline.text2speech import T2S as JT2S
from cookietts_tpu.pipeline.text2speech import T2SConfig as JT2SConfig
from cookietts_tpu.text import N_SYMBOLS

from cookietts_tpu_torch.convert.from_jax import (hifigan_state_dict_from_jax,
                                                  tacotron2_state_dict_from_jax)
from cookietts_tpu_torch.models.hifigan import Generator, HiFiGANConfig
from cookietts_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
from cookietts_tpu_torch.pipeline.text2speech import (T2S, T2SConfig,
                                                      interleave_speakers,
                                                      make_flow_vocoder_fn,
                                                      parse_text_into_segments)
from test_torch_threads import _one_thread  # noqa: F401


TACO = dict(
    n_symbols=N_SYMBOLS, symbols_embedding_dim=16, n_speakers=4,
    speaker_embedding_dim=8, encoder_speaker_embed_dim=4,
    encoder_conv_hidden_dim=16, encoder_lstm_dim=16, encoder_n_convolutions=1,
    torchmoji_dim=8, torchmoji_crushed_dim=4, memory_bottleneck_dim=16,
    prenet_dim=8, attention_rnn_dim=16, decoder_rnn_dim=16,
    second_decoder_rnn_dim=16, attention_dim=8, windowed_attention_range=4,
    postnet_embedding_dim=16, postnet_n_convolutions=2,
    postnet_residual_connections=0, p_prenet_dropout=0.0)
HIFI = dict(n_mel_channels=80, resblock_kernel_sizes=(3,),
            resblock_dilations=((1, 3),), upsample_rates=(8, 8, 4, 2),
            upsample_kernel_sizes=(16, 16, 8, 4), upsample_initial_channel=16)
T2S_CFG = dict(batch_size=2, max_attempts=2, step_buckets=(64,),
               max_decoder_steps=64, frames_per_char=2.0)
SPEAKERS = {"alice": 0, "bob": 2, "carol": 3}
REQUESTS = [("Hello world.", ["alice"]),
            ('He said "hi there." Then left.', ["bob", "carol"])]


@pytest.fixture(scope="module")
def tacotrons():
    """(JAX Tacotron2, its variables, the port's Tacotron2 with the same
    weights)."""
    torch.backends.cudnn.allow_tf32 = False
    jm = JTacotron2(JTConfig(**TACO))
    B, T = 2, 32
    tv = jm.init({"params": jax.random.PRNGKey(0),
                  "dropout": jax.random.PRNGKey(1)},
                 text=jnp.ones((B, T), jnp.int32),
                 text_lengths=jnp.full((B,), T), mels=jnp.zeros((B, 16, 80)),
                 mel_lengths=jnp.full((B,), 16), speaker_id=jnp.zeros((B,), int),
                 sylps=jnp.full((B,), 4.0), key=jax.random.PRNGKey(2),
                 deterministic=True)
    tv = jax.tree_util.tree_map(np.asarray, tv)
    taco = Tacotron2(Tacotron2Config(**TACO), device="cpu")
    taco.load_state_dict(tacotron2_state_dict_from_jax(tv["params"],
                                                       tv["batch_stats"]))
    return jm, tv, taco


@pytest.fixture(scope="module")
def results(tacotrons):
    jm, tv, taco = tacotrons
    jg = JGenerator(JHConfig(**HIFI))
    gv = jax.tree_util.tree_map(np.asarray, jg.init(jax.random.PRNGKey(3),
                                                    jnp.zeros((1, 8, 80))))
    j_t2s = JT2S(JT2SConfig(**T2S_CFG), jm, tv, SPEAKERS,
                 vocoder_fn=jax.jit(lambda m: jg.apply(gv, m)),
                 sample_rate=44100, hop_length=512)
    gen = Generator(HiFiGANConfig(**HIFI), device="cpu")
    gen.load_state_dict(hifigan_state_dict_from_jax(gv["params"]))
    p_t2s = T2S(T2SConfig(**T2S_CFG), taco, SPEAKERS, vocoder_fn=gen,
                sample_rate=44100, hop_length=512, device="cpu")
    out = []
    for i, (text, speakers) in enumerate(REQUESTS):
        out.append((j_t2s.infer(text, speaker=speakers, seed=i),
                    p_t2s.infer(text, speaker=speakers, seed=i)))
    return out


@pytest.mark.parametrize("i", range(len(REQUESTS)))
def test_t2s_matches_jax(results, i):
    ref, got = results[i]
    assert got["segments"] == ref["segments"]
    assert got["speakers"] == ref["speakers"]
    np.testing.assert_array_equal(got["mel_lengths"], ref["mel_lengths"])
    np.testing.assert_array_equal(got["attempts"], ref["attempts"])
    np.testing.assert_allclose(got["scores"], ref["scores"], atol=1e-4, rtol=0)
    for m_got, m_ref in zip(got["mels"], ref["mels"]):
        np.testing.assert_allclose(m_got, m_ref, atol=1e-4, rtol=1e-3)
    assert got["audio"].shape == ref["audio"].shape
    assert len(got["audio"]) == got["mel_lengths"].sum() * 512
    np.testing.assert_allclose(got["audio"], ref["audio"], atol=1e-4, rtol=0)


def test_multi_segment_request_splits(results):
    ref, got = results[1]
    assert len(got["segments"]) == 3
    assert got["speakers"] == ["bob", "carol", "bob"]


@pytest.mark.parametrize("mode", ["cycle next", "cycle all", "random",
                                  "quotes", "first"])
def test_text_helpers_match_jax(mode):
    from cookietts_tpu.pipeline.text2speech import (
        interleave_speakers as j_interleave, parse_text_into_segments as j_parse)
    text = ('Once upon a time. "Where are you going?" she asked. '
            + "A very long sentence that goes on " * 12 + 'and "a quote".')
    segs = parse_text_into_segments(text, target_segment_length=60,
                                    max_segment_length=120)
    assert segs == j_parse(text, target_segment_length=60,
                           max_segment_length=120)
    spk = ["narrator", "a", "b"]
    assert (interleave_speakers(segs, spk, mode, np.random.default_rng(3))
            == j_interleave(segs, spk, mode, np.random.default_rng(3)))


# -- a flow vocoder behind T2S, with the spectral denoiser ---------------------

FLOW_VOCODERS = {
    "waveglow": dict(n_mel_channels=80, n_flows=2, n_group=8, n_early_every=1,
                     n_early_size=2, n_layers=2, n_channels=8, hop_length=512,
                     upsample_strides=(8, 8), upsample_channels=8,
                     sampling_rate=44100),
    "waveflow": dict(n_mel_channels=80, n_flows=2, n_group=8, n_early_every=0,
                     channel_mixing="permuteheight", n_layers=2, n_channels=8,
                     kernel_size_h=2, hop_length=512, upsample_strides=(64,),
                     upsample_channels=8, sampling_rate=44100),
}


@pytest.mark.parametrize("kind", list(FLOW_VOCODERS))
def test_t2s_flow_vocoder_and_denoiser_match_jax(tacotrons, kind):
    """A flow vocoder as a stochastic vocoder_fn and a Denoiser built from it,
    one request with denoise_strength > 0. The two frameworks draw different
    noise from the same seed, so sigma is 0 (z = 0 on both sides) and the
    denoiser's near-silent mel is replaced by the same numpy draw."""
    from cookietts_tpu.models.denoiser import Denoiser as JDenoiser
    from cookietts_tpu.models.waveglow import WaveGlow as JWaveGlow
    from cookietts_tpu.models.waveglow import WaveGlowConfig as JWConfig
    from cookietts_tpu_torch.convert.from_jax import waveglow_from_jax
    from cookietts_tpu_torch.models.denoiser import Denoiser
    from cookietts_tpu_torch.models.waveglow import WaveGlow, WaveGlowConfig

    jm, tv, taco = tacotrons
    kw = FLOW_VOCODERS[kind]
    rng = np.random.default_rng(0)
    jw = JWaveGlow(JWConfig(memory_efficient=False, **kw))
    params = jw.init(jax.random.PRNGKey(0), jnp.zeros((1, 1024)),
                     jnp.zeros((1, 2, 80)))["params"]
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(
            np.float32), params)
    quiet = (0.01 * rng.standard_normal((1, 4, 80))).astype(np.float32)
    j_infer = lambda mel, key: jw.apply({"params": params}, mel, key, sigma=0.0,
                                        method=JWaveGlow.infer)
    j_vocoder = lambda mel: j_infer(jnp.asarray(mel), jax.random.PRNGKey(0))
    j_vocoder.stochastic = True
    den_kw = dict(sampling_rate=44100, n_mel_channels=80, filter_length=256,
                  hop_length=64, win_length=256)
    j_t2s = JT2S(JT2SConfig(**T2S_CFG), jm, tv, SPEAKERS, vocoder_fn=j_vocoder,
                 denoiser_fn=JDenoiser(lambda mel, key: j_infer(
                     jnp.asarray(quiet), key), **den_kw),
                 sample_rate=44100, hop_length=512)

    port = WaveGlow(WaveGlowConfig(**kw), device="cpu")
    port.load_state_dict(waveglow_from_jax(params, jw.cfg))
    vocoder_fn, infer_with_generator = make_flow_vocoder_fn(port, sigma=0.0)
    assert vocoder_fn.stochastic is True
    denoiser = Denoiser(lambda mel, g: infer_with_generator(
        torch.from_numpy(quiet), g), **den_kw, device="cpu")
    p_t2s = T2S(T2SConfig(**T2S_CFG), taco, SPEAKERS, vocoder_fn=vocoder_fn,
                denoiser_fn=denoiser, sample_rate=44100, hop_length=512,
                device="cpu")
    text, speakers = REQUESTS[1]
    ref = j_t2s.infer(text, speaker=speakers, seed=1, denoise_strength=0.5)
    got = p_t2s.infer(text, speaker=speakers, seed=1, denoise_strength=0.5)
    plain = p_t2s.infer(text, speaker=speakers, seed=1)
    np.testing.assert_array_equal(got["mel_lengths"], ref["mel_lengths"])
    assert got["audio"].shape == ref["audio"].shape == plain["audio"].shape
    assert np.abs(ref["audio"]).max() > 1e-3          # the flows are not idle
    np.testing.assert_allclose(got["audio"], ref["audio"], atol=2e-4, rtol=0)
    assert np.abs(got["audio"] - plain["audio"]).max() > 1e-4   # it denoised


def test_flow_vocoder_fn_reseeds_every_call():
    from cookietts_tpu_torch.models.waveglow import WaveGlow, WaveGlowConfig
    port = WaveGlow(WaveGlowConfig(**FLOW_VOCODERS["waveglow"]), device="cpu")
    mel = torch.zeros(1, 2, 80)
    a, _ = make_flow_vocoder_fn(port, sigma=1.0, seed=3)
    b, infer = make_flow_vocoder_fn(port, sigma=1.0, seed=3)
    first, second = a(mel), a(mel)
    assert not torch.equal(first, second)
    assert torch.equal(first, b(mel)) and torch.equal(second, b(mel))
    assert torch.equal(first, infer(mel, torch.Generator().manual_seed(3)))

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
                                                      parse_text_into_segments)

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
def results():
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
    jg = JGenerator(JHConfig(**HIFI))
    gv = jax.tree_util.tree_map(np.asarray, jg.init(jax.random.PRNGKey(3),
                                                    jnp.zeros((1, 8, 80))))
    j_t2s = JT2S(JT2SConfig(**T2S_CFG), jm, tv, SPEAKERS,
                 vocoder_fn=jax.jit(lambda m: jg.apply(gv, m)),
                 sample_rate=44100, hop_length=512)

    taco = Tacotron2(Tacotron2Config(**TACO), device="cpu")
    taco.load_state_dict(tacotron2_state_dict_from_jax(tv["params"],
                                                       tv["batch_stats"]))
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

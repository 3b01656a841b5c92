"""The PyTorch port's chunked decode and streaming path against the JAX
package on the CPU, and against the port's own whole decode and vocode.

A tiny JAX Tacotron2 and HiFi-GAN (the configurations of
tests/test_pipeline.py's streaming cases) are carried across with
``convert.from_jax``. Prenet dropout is 0 wherever JAX and the port are
compared (JAX threefry and torch never draw the same bits); the port's
chunked-against-whole checks keep the dropout on and draw it from one seeded
generator. Tolerances: 1e-5 port against JAX (float32 in two frameworks),
exact where the port is held against itself.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cookietts_tpu.models.hifigan import Generator as JGenerator
from cookietts_tpu.models.hifigan import HiFiGANConfig as JHConfig
from cookietts_tpu.models.tacotron2 import Tacotron2 as JTacotron2
from cookietts_tpu.models.tacotron2 import Tacotron2Config as JTConfig

from cookietts_tpu_torch.convert.from_jax import (hifigan_state_dict_from_jax,
                                                  tacotron2_state_dict_from_jax)
from cookietts_tpu_torch.models.hifigan import Generator, HiFiGANConfig
from cookietts_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
from cookietts_tpu_torch.pipeline.chunk_graph import DecodeChunkGraphs
from cookietts_tpu_torch.pipeline.streaming import (make_streaming_fns,
                                                    streaming_tts,
                                                    streaming_vocode,
                                                    vocode_streamed)
from test_torch_threads import _one_thread  # noqa: F401


TACO = dict(
    n_symbols=40, symbols_embedding_dim=16, n_speakers=4,
    speaker_embedding_dim=8, encoder_speaker_embed_dim=4,
    encoder_conv_hidden_dim=16, encoder_lstm_dim=16, encoder_n_convolutions=1,
    torchmoji_dim=8, torchmoji_crushed_dim=4, memory_bottleneck_dim=16,
    prenet_dim=8, attention_rnn_dim=16, decoder_rnn_dim=16,
    second_decoder_rnn_dim=0, attention_dim=8, windowed_attention_range=4,
    postnet_embedding_dim=16, postnet_n_convolutions=2,
    postnet_residual_connections=0, n_mel_channels=12, max_decoder_steps=96,
    p_prenet_dropout=0.0)
HIFI = dict(n_mel_channels=12, resblock_kernel_sizes=(3, 7),
            resblock_dilations=((1, 3, 5), (1, 3, 5)), upsample_rates=(4, 4, 2),
            upsample_kernel_sizes=(8, 8, 4), upsample_initial_channel=24)
HOP = 32
B, T_TXT = 2, 10


@pytest.fixture(scope="module")
def models():
    """(JAX Tacotron2, its variables, JAX vocoder fn, port Tacotron2, port
    Generator, inputs as numpy)."""
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    inputs = dict(text=rng.integers(1, 40, (B, T_TXT)),
                  text_lengths=np.array([10, 7]), speaker_id=np.array([0, 1]))
    jt, jg = JTacotron2(JTConfig(**TACO)), JGenerator(JHConfig(**HIFI))
    tv = jax.jit(jt.init, static_argnames=("deterministic",))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        text=jnp.asarray(inputs["text"]),
        text_lengths=jnp.asarray(inputs["text_lengths"]),
        mels=jnp.asarray(rng.standard_normal((B, 8, 12)), jnp.float32),
        mel_lengths=jnp.full((B,), 8), speaker_id=jnp.asarray(inputs["speaker_id"]),
        sylps=jnp.full((B,), 4.0), key=jax.random.PRNGKey(2), deterministic=False)
    tv = jax.tree_util.tree_map(np.asarray, tv)
    gv = jax.tree_util.tree_map(np.asarray, jax.jit(jg.init)(
        jax.random.PRNGKey(3), jnp.zeros((B, 8, 12), jnp.float32)))
    # op by op: the streamed windows come in many widths, each a compile
    # under jit
    j_voc = lambda m: jg.apply(gv, m)
    taco = Tacotron2(Tacotron2Config(**TACO), device="cpu")
    taco.load_state_dict(tacotron2_state_dict_from_jax(tv["params"],
                                                       tv["batch_stats"]))
    gen = Generator(HiFiGANConfig(**HIFI), device="cpu")
    gen.load_state_dict(hifigan_state_dict_from_jax(gv["params"]))
    return jt, tv, j_voc, taco, gen, inputs


def _close(a, b, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=1e-4)


@functools.lru_cache(maxsize=None)
def _jax_fns(jt):
    """JAX (prepare, step, refine) as make_streaming_fns builds them, the
    refine op by op (each window width would be a compile); one set, so the
    cases share their compiles."""
    from cookietts_tpu.pipeline.streaming import make_streaming_fns as j_fns
    prepare, step, _ = j_fns(jt)
    refine = lambda v, m: jt.apply(v, m, method=JTacotron2.postnet_refine)
    return prepare, step, refine


def test_decode_chunk_chain_matches_jax(models):
    """inference_prepare, two 8-step decode_chunks and postnet_refine."""
    jt, tv, _, taco, _, inputs = models
    j_prepare, j_step, j_refine = _jax_fns(jt)
    args = [jnp.asarray(inputs[k]) for k in ("text", "text_lengths", "speaker_id")]
    j_mem, j_const, carry = j_prepare(tv, *args, None, None)
    memory, const, state = taco.inference_prepare(*(inputs[k] for k in (
        "text", "text_lengths", "speaker_id")))
    _close(memory, j_mem)
    keys = jax.random.split(jax.random.PRNGKey(4), 16)
    mels = []
    for t0 in (0, 8):
        j_out = j_step(tv, j_mem, j_const, carry, keys[t0:t0 + 8])
        carry = j_out[3]
        mel, gate, weights, state = taco.decode_chunk(memory, const, state, 8)
        assert mel.shape == (B, 8, 12) and weights.shape == (B, 8, T_TXT)
        for got, want in zip((mel, gate, weights), j_out[:3]):
            _close(got, want, atol=1e-4)
        mels.append(mel)
    mel = torch.cat(mels, 1)
    _close(taco.postnet_refine(mel), j_refine(tv, jnp.asarray(mel.numpy())),
           atol=1e-4)


def test_chunked_decode_equals_whole(models):
    """With the prenet dropout on, chunks of 16 and 5 steps (through the
    chunk program, eager on the CPU) draw what one whole decode draws and
    give its mels, gates and alignments bit for bit."""
    *_, taco, _, inputs = models
    drop = Tacotron2(Tacotron2Config(**{**TACO, "p_prenet_dropout": 0.5}),
                     device="cpu")
    drop.load_state_dict(taco.state_dict())
    whole = drop.inference(**inputs, generator=torch.Generator().manual_seed(3),
                           max_decoder_steps=48)
    for steps in (16, 5):
        program = DecodeChunkGraphs(drop.decoder)
        gen = torch.Generator().manual_seed(3)
        memory, const, state = drop.inference_prepare(**inputs)
        pieces = []
        for _ in range(-(-48 // steps)):
            mel, gate, weights, state = program(memory, const, state, steps, gen)
            pieces.append((mel, gate, weights))
        for i, key in enumerate(("mel_outputs", "gate_outputs", "alignments")):
            got = torch.cat([p[i] for p in pieces], 1)[:, :48]
            assert torch.equal(got, whole[key]), (steps, key)
        assert program.eager_calls == len(pieces) and program.captures == 0
    # the decoder's own loop over chunks, early exit on
    out = drop.inference(**inputs, generator=torch.Generator().manual_seed(3),
                         max_decoder_steps=48, early_exit=True, chunk_size=16,
                         chunk_fn=DecodeChunkGraphs(drop.decoder))
    n = int(out["mel_lengths"].max())
    assert torch.equal(out["mel_outputs"][:, :n], whole["mel_outputs"][:, :n])


def test_streaming_vocode_windows_share_one_width(models):
    """Every window is chunk + 2 halo frames wide, the pieces come in order
    at the right offsets and join into the whole vocode; a halo too small
    for the generator's reach breaks that (so the test is not vacuous)."""
    *_, gen, _ = models
    T = 173                              # not a multiple of the chunk
    mel = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (B, T, 12)).astype(np.float32))
    widths = []

    def spy(m):
        widths.append(m.shape[1])
        return gen(m, infer=True)

    whole = gen(mel, infer=True).numpy()
    got = vocode_streamed(spy, mel, chunk_frames=48, halo_frames=24)
    assert set(widths) == {48 + 2 * 24} and len(widths) == 4
    assert got.shape == whole.shape
    _close(got, whole, atol=1e-6)
    offsets = [o for o, _ in streaming_vocode(gen, mel, 48, 24)]
    assert offsets == [i * 48 * HOP for i in range(4)]
    loose = vocode_streamed(gen, mel, chunk_frames=48, halo_frames=1)
    assert np.abs(loose - whole).max() > 1e-4


@pytest.mark.parametrize("steps", [96, 90])
def test_streaming_tts_matches_jax_and_the_whole_pipeline(models, steps):
    """gate_threshold=2.0 (a sigmoid never reaches it) decodes every step,
    so every sample has a whole-run counterpart. 90 steps is not a multiple
    of the 24-step chunk: the stream must drop the last chunk's overshoot
    (the whole decode never makes those frames), not emit extra audio."""
    from cookietts_tpu.pipeline.streaming import streaming_tts as j_streaming_tts
    jt, tv, j_voc, taco, gen, inputs = models
    kw = dict(max_decoder_steps=steps, decode_chunk_steps=24, vocoder_halo=24,
              hop_length=HOP, gate_threshold=2.0, gate_delay=4)
    j_pieces = list(j_streaming_tts(
        jt, tv, j_voc, **{k: jnp.asarray(v) for k, v in inputs.items()},
        key=jax.random.PRNGKey(7), fns=_jax_fns(jt), **kw))
    pieces = list(streaming_tts(taco, gen, **inputs, fns=make_streaming_fns(taco),
                                generator=torch.Generator().manual_seed(7), **kw))
    assert len(pieces) >= 2, "the stream must yield before the decode ends"
    assert [o for o, _ in pieces] == [o for o, _ in j_pieces]
    streamed = np.concatenate([p for _, p in pieces], axis=1)
    assert streamed.shape == (B, steps * HOP)
    _close(streamed, np.concatenate([p for _, p in j_pieces], axis=1))
    whole = taco.inference(**inputs, max_decoder_steps=steps)
    _close(streamed, gen(whole["mel_outputs_postnet"], infer=True).numpy(),
           atol=1e-6)


def test_t2s_streaming_over_frames_matches_batch_vocode(models):
    """T2SConfig.streaming_over_frames: a long segment vocodes through
    halo-overlapped windows with the whole-mel run's audio; a stochastic
    vocoder vocodes whole."""
    from cookietts_tpu_torch.pipeline.text2speech import T2S, T2SConfig
    *_, taco, gen, _ = models
    # a gate that never fires, so the segment decodes all 64 steps
    sd = taco.state_dict()
    sd["decoder.gate_layer.linear_layer.bias"] = torch.full((1,), -8.0)
    taco = Tacotron2(Tacotron2Config(**TACO), device="cpu")
    taco.load_state_dict(sd)
    cfg = T2SConfig(batch_size=2, max_attempts=1, step_buckets=(64,),
                    max_decoder_steps=64, text_cleaners=("basic_cleaners",))
    calls = []

    def voc(m):
        calls.append(m.shape[1])
        return gen(m, infer=True)

    t2s = T2S(cfg, taco, {"alice": 0}, vocoder_fn=voc, hop_length=HOP,
              device="cpu")
    text = "streaming test sentence"
    ref = t2s.infer(text, speaker=["alice"], seed=3)
    assert ref["mel_lengths"].tolist() == [64]
    t2s.cfg = dataclasses.replace(cfg, streaming_over_frames=16,
                                  streaming_chunk_frames=16,
                                  streaming_halo_frames=16)
    calls.clear()
    got = t2s.infer(text, speaker=["alice"], seed=3)
    assert len(got["audio"]) > 0 and set(calls) == {48}
    _close(got["audio"], ref["audio"], atol=1e-6)
    voc.stochastic = True
    calls.clear()
    t2s.infer(text, speaker=["alice"], seed=3)
    assert len(calls) == 1


def test_chunk_graph_cache_stays_bounded(monkeypatch):
    """A server meets a new batch size with every client that sends one: the
    chunk program keeps at most ``max_graphs`` graphs, releases the least
    recently used, and replays what it keeps. Capture, replay and release
    are stubbed (there are no graphs on the CPU); the memory stands in for
    a tensor on the card."""
    class Memory:
        def __init__(self, B):
            self.shape, self.device = (B, 16, 8), torch.device("cuda")

    class Decoder:
        def decode_chunk(self, memory, const, state, steps, generator=None):
            return "eager"

    prog = DecodeChunkGraphs(Decoder(), max_graphs=3)
    released = []
    monkeypatch.setattr(prog, "_capture", lambda memory, *a: memory.shape[0])
    monkeypatch.setattr(prog, "_replay", lambda captured, args, gen: captured)
    monkeypatch.setattr(prog, "_release", released.append)
    got = []
    for B in (1, 2, 3, 1, 4, 5, 6, 7, 8, 1, 2, 9, 32, 17, 1):
        got.append(prog(Memory(B), {}, (), 32))
        assert len(prog.graphs) <= 3
    # a shape's first call runs eagerly and captures, a kept shape replays
    assert got == ["eager"] * 3 + [1] + ["eager"] * 11
    assert released == [2, 3, 1, 4, 5, 6, 7, 8, 1, 2, 9]
    assert [k[0][0] for k in prog.graphs] == [32, 17, 1]
    assert prog.captures == 14

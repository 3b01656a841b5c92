"""The port's serving artifacts (runtime/export_serving.py) and the kernels'
custom ops, on the CPU at tiny widths.

- each of the five ``torch.ops.cookietts_tpu_torch`` ops equals its plain
  version bit for bit on the CPU, and passes ``torch.library.opcheck``;
- a tiny Tacotron2 artifact (B = 2, T = 12, 20 decoder steps) round-trips
  through ``save_artifact`` / ``load_artifact`` and decodes what the live
  model decodes from a generator of the same seed (prenet dropout on), and
  the same weights, carried from JAX by ``convert.from_jax``, decode what
  JAX's own artifact decodes (prenet dropout 0, where nothing is drawn);
- HiFi-GAN and WaveGlow vocoder artifacts against JAX's exported vocoders
  at the same weights (the same z for the flow);
- the ``export`` command, then ``tts --artifact --device cpu``, writes a WAV;
- the loader refuses a JAX artifact and one exported on another device.
JAX runs as tests/test_export_serving.py runs it (``platforms=("cpu",)``).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cookietts_tpu.models.hifigan import Generator as JGenerator
from cookietts_tpu.models.hifigan import HiFiGANConfig as JHConfig
from cookietts_tpu.models.tacotron2 import Tacotron2 as JTacotron2
from cookietts_tpu.models.tacotron2 import Tacotron2Config as JConfig
from cookietts_tpu.models.waveglow import WaveGlow as JWaveGlow
from cookietts_tpu.models.waveglow import WaveGlowConfig as JWConfig
from cookietts_tpu.runtime import export_serving as jes
from cookietts_tpu.text import N_SYMBOLS

from cookietts_tpu_torch import cli
from cookietts_tpu_torch.convert.from_jax import (hifigan_state_dict_from_jax,
                                                  tacotron2_state_dict_from_jax,
                                                  waveglow_from_jax)
from cookietts_tpu_torch.models.hifigan import Generator, HiFiGANConfig
from cookietts_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
from cookietts_tpu_torch.models.waveglow import WaveGlow, WaveGlowConfig
from cookietts_tpu_torch.ops import hopper_kernels as hk
from cookietts_tpu_torch.runtime import export_serving as es
from cookietts_tpu_torch.runtime.checkpoint import save_checkpoint
from test_torch_threads import _one_thread  # noqa: F401

TINY = dict(
    n_symbols=N_SYMBOLS, symbols_embedding_dim=16, n_speakers=4,
    speaker_embedding_dim=8, encoder_speaker_embed_dim=4,
    encoder_conv_hidden_dim=16, encoder_lstm_dim=16,
    encoder_n_convolutions=2, torchmoji_dim=8, torchmoji_crushed_dim=4,
    memory_bottleneck_dim=16, prenet_dim=8, attention_rnn_dim=16,
    decoder_rnn_dim=16, second_decoder_rnn_dim=16, attention_dim=8,
    windowed_attention_range=2, postnet_embedding_dim=16,
    postnet_n_convolutions=3, postnet_residual_connections=2,
    p_prenet_dropout=0.0, max_decoder_steps=20)
B, T_TXT, STEPS = 2, 12, 20
HOP, M = 8, 80


def _r(rng, *shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))


def _op_cases():
    rng = np.random.default_rng(0)
    mask = torch.from_numpy(rng.random((2, 9)) < 0.7)
    mask[:, 0] = True
    att = (_r(rng, 2, 6), _r(rng, 2, 9, 6), _r(rng, 2, 9, 6), _r(rng, 6),
           _r(rng, 2, 9, 5), mask, torch.tensor([1.3]), [])
    lstm = (_r(rng, 3, 20), _r(rng, 20, 16, scale=0.3), _r(rng, 16),
            _r(rng, 3, 4))
    res = (_r(rng, 1, 8, 30), _r(rng, 2, 3, 8, 8, scale=0.2), _r(rng, 2, 8),
           _r(rng, 2, 3, 8, 8, scale=0.2), _r(rng, 2, 8), [1, 3], 0.1)
    wn = (_r(rng, 12, 8), _r(rng, 8), _r(rng, 2, 24, 16, scale=0.2),
          _r(rng, 2, 8, 16, scale=0.3), _r(rng, 2, 16), _r(rng, 8, 2),
          _r(rng, 2))
    glow = (_r(rng, 1, 12, 25), _r(rng, 1, 2, 16, 25), *wn, [])
    row_w = (_r(rng, 1, 8), _r(rng, 8), _r(rng, 2, 3 * 3 * 8, 16, scale=0.2),
             *wn[3:])
    row = (_r(rng, 1, 25), _r(rng, 2, 3, 1, 8, 25), 4, _r(rng, 1, 2, 16, 25),
           *row_w, [])
    bf = lambda t: t.to(torch.bfloat16)  # noqa: E731
    att16 = (bf(att[0]), bf(att[1]), bf(att[2]), att[3], bf(att[4]), *att[5:])
    lstm16 = (bf(lstm[0]), bf(lstm[1]), bf(lstm[2]), lstm[3])
    res16 = (bf(res[0]), bf(res[1]), res[2], bf(res[3]), *res[4:])
    # the WN kernels' bf16 forms take the dtypes of hk.WN_BF16_DTYPES
    cast = lambda args, form: tuple(  # noqa: E731
        a.to(d) if torch.is_tensor(a) else a for a, d in zip(
            args, [*hk.WN_BF16_DTYPES[form].values()][:len(args)]))
    glow16 = (*cast(glow[:9], "glow_bf16"), [])
    row16 = (row[0], bf(row[1]), 4,
             *cast((row[0], row[1], *row[3:11]), "flow_bf16")[2:], [])
    return {
        "attention_step": (hk._attention_step_op, att,
                           lambda a: hk.attention_step_plain(*a[:7])),
        # the bf16 forms: the same ops on bf16 operands
        "attention_step_bf16": (hk._attention_step_op, att16,
                                lambda a: hk.attention_step_plain(*a[:7])),
        "lstm_gates_bf16": (hk._lstm_gates_op, lstm16,
                            lambda a: hk.lstm_gates_plain(*a)),
        "hifigan_resblock_bf16": (hk._hifigan_resblock_op, res16,
                                  lambda a: hk.hifigan_resblock_plain(*a)),
        "lstm_gates": (hk._lstm_gates_op, lstm,
                       lambda a: hk.lstm_gates_plain(*a)),
        "hifigan_resblock": (hk._hifigan_resblock_op, res,
                             lambda a: hk.hifigan_resblock_plain(*a)),
        "waveglow_wn_forward": (hk._waveglow_wn_forward_op, glow,
                                lambda a: hk.waveglow_wn_forward_plain(*a[:9])),
        "waveflow_row_step": (hk._waveflow_row_step_op, row, lambda a: torch.stack(
            hk.waveflow_row_step_ring_plain(*a[:11]), 1)),
        "waveglow_wn_forward_bf16": (hk._waveglow_wn_forward_op, glow16,
                                     lambda a: hk.waveglow_wn_forward_plain(*a[:9])),
        "waveflow_row_step_bf16": (hk._waveflow_row_step_op, row16,
                                   lambda a: torch.stack(
                                       hk.waveflow_row_step_ring_plain(*a[:11]), 1)),
    }


@pytest.mark.parametrize("name", list(hk.LAUNCHES))
def test_ops_on_the_cpu_are_their_plain_versions(name):
    """Bit for bit (tolerance 0); the ring the row step updates in place
    too. opcheck runs the op's schema, fake, autograd-registration and
    AOT-dispatch tests at this shape."""
    op, args, plain = _op_cases()[name]
    clone = lambda a: [x.clone() if torch.is_tensor(x) else x for x in a]
    got_args, want_args = clone(args), clone(args)
    got, want = op(*got_args), plain(want_args)
    for g, w in zip(pytree_leaves(got), pytree_leaves(want)):
        assert torch.equal(g, w)
    for g, w in zip(got_args, want_args):
        if torch.is_tensor(g):
            assert torch.equal(g, w)
    assert str(op._opoverload).startswith(
        f"{hk.NAMESPACE}.{name.removesuffix('_bf16')}")
    torch.library.opcheck(op, tuple(clone(args)))


def pytree_leaves(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def _jax_tacotron2(p_prenet_dropout):
    cfg = JConfig(**dict(TINY, p_prenet_dropout=p_prenet_dropout))
    jm = JTacotron2(cfg)
    v = jm.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                text=jnp.ones((B, T_TXT), jnp.int32),
                text_lengths=jnp.full((B,), T_TXT), mels=jnp.zeros((B, 16, M)),
                mel_lengths=jnp.full((B,), 16), speaker_id=jnp.zeros((B,), int),
                sylps=jnp.full((B,), 4.0), key=jax.random.PRNGKey(2),
                deterministic=True)
    rng = np.random.default_rng(1)
    v = jax.tree_util.tree_map(np.array, v)
    for path, x in jax.tree_util.tree_flatten_with_path(v["batch_stats"])[0]:
        x[...] = (rng.uniform(0.5, 1.5, x.shape)
                  if "var" in jax.tree_util.keystr(path)
                  else rng.normal(0, 0.2, x.shape))
    port = Tacotron2(Tacotron2Config(**dict(TINY, p_prenet_dropout=p_prenet_dropout)),
                     device="cpu")
    port.load_state_dict(tacotron2_state_dict_from_jax(v["params"], v["batch_stats"]))
    return jm, v, port


def _request(rng):
    text = rng.integers(1, N_SYMBOLS, (B, 10))
    return (text, np.array([10, 6]), np.array([1, 3]),
            rng.normal(0, 1, (B, 8)).astype(np.float32))


def _port_artifact(port, path, buckets=((B, T_TXT),)):
    entries = es.export_tacotron2_serving(port, list(buckets), STEPS)
    es.save_artifact(path, entries, {
        "device": "cpu", "t2s": es.tacotron2_meta(port, list(buckets), STEPS)})
    return es.ArtifactT2SDecoder(path, device="cpu")


def test_tacotron2_artifact_round_trip_matches_live(tmp_path):
    """Prenet dropout 0.5: the loader's masks, drawn from a generator of the
    request's seed, are the live decode's draws. Mels and alignments within
    1e-5 of the live 20-step decode, mel_lengths equal."""
    _, _, port = _jax_tacotron2(0.5)
    dec = _port_artifact(port, str(tmp_path / "a.npz"))
    assert sorted(es.load_artifact(str(tmp_path / "a.npz"), "cpu")[0]) == [
        "t2s_b2_t12.encode", "t2s_b2_t12.postnet", "t2s_b2_t12.step"]
    text, lens, spk, tm = _request(np.random.default_rng(2))
    mels, lengths, align = dec.decode(text, lens, spk, tm, 7)
    padded = np.zeros((B, T_TXT), np.int64)
    padded[:, :10] = text
    ref = port.inference(padded, lens, spk, tm,
                         generator=torch.Generator().manual_seed(7),
                         max_decoder_steps=STEPS)
    assert mels.shape == (B, STEPS, M) and align.shape == (B, STEPS, 10)
    np.testing.assert_allclose(mels.numpy(), ref["mel_outputs_postnet"].numpy(),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(align.numpy(), ref["alignments"][:, :, :10].numpy(),
                               atol=1e-5, rtol=0)
    assert torch.equal(lengths, ref["mel_lengths"])
    other, _, _ = dec.decode(text, lens, spk, tm, 8)
    assert not torch.equal(other, mels)          # the seed draws the masks
    # decode_chunk's masks entry: the generator's draws, in its order
    memory, const, state = port.inference_prepare(padded, lens, spk, tm)
    g = torch.Generator().manual_seed(3)
    masks = torch.stack([torch.stack([torch.rand(B, 8, generator=g) < 0.5
                                      for _ in range(2)]) for _ in range(4)])
    drawn = port.decode_chunk(memory, const, state, 4,
                              torch.Generator().manual_seed(3))
    given = port.decoder.decode_chunk(memory, const, state, 4, masks=masks)
    for a, b in zip(drawn[:3], given[:3]):
        assert torch.equal(a, b)
    # a per-request step cap clamps mel_lengths; the gate inputs are live
    capped = dec.decode(text, lens, spk, tm, 7, max_steps=5)[1]
    assert int(capped.max()) <= 5
    for thr in (0.0, 0.5):
        _, got, _ = dec.decode(text, lens, spk, tm, 7, gate_threshold=thr,
                               gate_delay=3)
        want = port.inference(padded, lens, spk, tm,
                              generator=torch.Generator().manual_seed(7),
                              max_decoder_steps=STEPS, gate_threshold=thr,
                              gate_delay=3)["mel_lengths"]
        assert torch.equal(got, want)


@pytest.fixture(scope="module")
def quiet(tmp_path_factory):
    """(JAX model, variables, port model, its artifact's path and entries)
    at prenet dropout 0."""
    jm, v, port = _jax_tacotron2(0.0)
    path = str(tmp_path_factory.mktemp("export") / "a.npz")
    entries = es.export_tacotron2_serving(port, [(B, T_TXT)], STEPS)
    es.save_artifact(path, entries, {
        "device": "cpu", "t2s": es.tacotron2_meta(port, [(B, T_TXT)], STEPS)})
    return jm, v, port, path, entries


def test_tacotron2_artifact_matches_jax_artifact(quiet, tmp_path):
    """JAX's export_tacotron2_serving and the port's artifact of the same
    weights, prenet dropout 0: mels within 1e-4, mel_lengths equal."""
    jm, v, port, path, _ = quiet
    dec = es.ArtifactT2SDecoder(path, device="cpu")
    entries = jes.export_tacotron2_serving(jm, dict(v), [(B, T_TXT)],
                                           max_decoder_steps=STEPS,
                                           platforms=("cpu",))
    jes.save_artifact(str(tmp_path / "j.npz"), entries, {})
    jfns, _ = jes.load_artifact(str(tmp_path / "j.npz"))
    text, lens, spk, tm = _request(np.random.default_rng(3))
    padded = np.zeros((B, T_TXT), np.int32)
    padded[:, :10] = text
    for thr in (0.5, 2.0):
        jmel, jlen, _, jalign = jfns[f"t2s_b{B}_t{T_TXT}"](
            jnp.asarray(padded), jnp.asarray(lens, jnp.int32),
            jnp.asarray(spk, jnp.int32), jnp.asarray(tm), jnp.asarray(5, jnp.uint32),
            jnp.asarray(thr, jnp.float32), jnp.asarray(4, jnp.int32),
            jnp.asarray(STEPS, jnp.int32))
        mels, lengths, align = dec.decode(text, lens, spk, tm, 5,
                                          gate_threshold=thr, gate_delay=4,
                                          max_steps=STEPS)
        np.testing.assert_allclose(mels.numpy(), np.asarray(jmel), atol=1e-4,
                                   rtol=0)
        np.testing.assert_allclose(align.numpy(), np.asarray(jalign)[:, :, :10],
                                   atol=1e-4, rtol=0)
        assert lengths.tolist() == np.asarray(jlen).tolist()


def test_vocoder_artifacts_match_jax(quiet, tmp_path):
    """HiFi-GAN and a WaveGlow with ISO 226 de-emphasis off, each exported
    by both packages from the same weights (the flow at the same z): audio
    within 1e-5 (HiFi-GAN) and 1e-4 (the flow's |audio| runs to a few)."""
    rng = np.random.default_rng(4)
    mel = rng.standard_normal((B, 16, M)).astype(np.float32)
    hkw = dict(n_mel_channels=M, resblock_kernel_sizes=(3,),
               resblock_dilations=((1, 3),), upsample_rates=(4, 2),
               upsample_kernel_sizes=(8, 4), upsample_initial_channel=16)
    jg = JGenerator(JHConfig(**hkw))
    gv = jg.init(jax.random.PRNGKey(0), jnp.asarray(mel))
    gen = Generator(HiFiGANConfig(**hkw), device="cpu")
    gen.load_state_dict(hifigan_state_dict_from_jax(gv["params"]))

    wkw = dict(n_mel_channels=M, n_flows=2, n_group=4, n_early_every=4,
               n_early_size=2, n_layers=2, n_channels=16, hop_length=HOP,
               upsample_strides=(2,), upsample_channels=16)
    jw = JWaveGlow(JWConfig(memory_efficient=False, pallas_row_step=False, **wkw))
    audio = jnp.asarray(rng.standard_normal((B, 16 * HOP)).astype(np.float32))
    wv = jw.init(jax.random.PRNGKey(1), audio, jnp.asarray(mel))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(
            np.float32), wv["params"])
    glow = WaveGlow(WaveGlowConfig(**wkw), device="cpu")
    glow.load_state_dict(waveglow_from_jax(params, jw.cfg))
    z = rng.standard_normal((B, 16 * HOP // 4, 4)).astype(np.float32)

    j_entries = {}
    j_entries.update({f"h_{k}": x for k, x in jes.export_vocoder_serving(
        lambda m: jg.apply(gv, m, infer=True), M, [(B, 16)],
        platforms=("cpu",)).items()})
    j_entries.update({f"w_{k}": x for k, x in jes.export_vocoder_serving(
        lambda m: jw.apply({"params": params}, jnp.asarray(z), m,
                           method=JWaveGlow.inverse), M, [(B, 16)],
        platforms=("cpu",)).items()})
    jes.save_artifact(str(tmp_path / "j.npz"), j_entries, {})
    jfns, _ = jes.load_artifact(str(tmp_path / "j.npz"))

    path = str(tmp_path / "h.npz")
    es.save_artifact(path, es.export_vocoder_serving(
        lambda m: gen(m, infer=True), M, [(B, 16)], device="cpu"),
        {"device": "cpu"})
    got = es.load_artifact(path, "cpu")[0][f"vocoder_b{B}_t16"](
        torch.from_numpy(mel))
    np.testing.assert_allclose(got.numpy(), np.asarray(jfns[f"h_vocoder_b{B}_t16"](
        jnp.asarray(mel))), atol=1e-5, rtol=0)

    # the flow through the decoder's vocoder (beside a Tacotron2)
    taco, entries = quiet[2], dict(quiet[4])
    zs = lambda b, t: (b, t * HOP // 4, 4)
    entries.update(es.export_vocoder_serving(
        lambda m, z_: glow.infer(m, z=z_), M, [(B, 16)], needs_key=True,
        z_shape=zs, device="cpu"))
    voc = {"buckets": [[B, 16]], "n_mel_channels": M, "needs_key": True,
           "sigma": 1.0, "audio": {"hop_length": HOP},
           "z_shapes": {"b2_t16": list(zs(B, 16))}}
    path = str(tmp_path / "w.npz")
    es.save_artifact(path, entries, {"device": "cpu", "vocoder": voc,
                                     "t2s": es.tacotron2_meta(taco, [(B, T_TXT)], STEPS)})
    dec = es.ArtifactT2SDecoder(path, device="cpu")
    got = dec.vocoder(mel, z=torch.from_numpy(z))
    assert got.shape == (B, 16 * HOP)
    np.testing.assert_allclose(got.numpy(), np.asarray(jfns[f"w_vocoder_b{B}_t16"](
        jnp.asarray(mel))), atol=1e-4, rtol=0)
    # z from the seed, as WaveGlow.infer draws it from a generator of it
    want = glow.infer(torch.from_numpy(mel), torch.Generator().manual_seed(3),
                      sigma=1.0)
    np.testing.assert_allclose(dec.vocoder(mel, seed=3).numpy(), want.numpy(),
                               atol=1e-5, rtol=0)
    # a ragged batch and length pad to the bucket and crop back
    assert dec.vocoder(mel[:1, :10], seed=3).shape == (1, 10 * HOP)


def test_export_then_tts_artifact_writes_a_wav(tmp_path, capsys):
    """The export command from port checkpoints, then tts --artifact on the
    CPU in-process: a WAV of the decode's length; a JAX-style --denoiser
    without a live --vocoder exits."""
    torch.manual_seed(0)
    cfg = dict(TINY, gate_threshold=2.0, max_decoder_steps=64)
    taco = Tacotron2(Tacotron2Config(**cfg), device="cpu")
    meta = {"model": "tacotron2", "model_config": cfg,
            "speaker_ids": {"alice": 0, "bob": 2},
            "audio": {"sampling_rate": 22050, "hop_length": HOP,
                      "n_mel_channels": M}}
    save_checkpoint(str(tmp_path / "taco.pt"), {"state_dict": taco.state_dict()},
                    meta)
    hkw = dict(n_mel_channels=M, resblock_kernel_sizes=(3,),
               resblock_dilations=((1, 3),), upsample_rates=(4, 2),
               upsample_kernel_sizes=(8, 4), upsample_initial_channel=16)
    gen = Generator(HiFiGANConfig(**hkw), device="cpu")
    save_checkpoint(str(tmp_path / "voc.pt"), {"state_dict": gen.state_dict()},
                    {"model": "hifigan", "model_config": hkw,
                     "audio": {"sampling_rate": 22050}})
    out = str(tmp_path / "serving.npz")
    got = cli.main(["export", "--checkpoint", str(tmp_path / "taco.pt"),
                    "--vocoder", str(tmp_path / "voc.pt"), "-o", out,
                    "--batch", "2", "--text_buckets", "32", "--mel_buckets", "64",
                    "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == got and printed["out"] == out
    assert printed["functions"] == ["t2s_b2_t32.encode", "t2s_b2_t32.postnet",
                                    "t2s_b2_t32.step", "vocoder_b2_t64"]
    assert printed["bytes"] > 0
    wav = str(tmp_path / "out.wav")
    stats = cli.main(["tts", "--artifact", out, "--text", "Hello there.",
                      "--max_attempts", "1", "--hparams",
                      "step_buckets=[64],max_decoder_steps=64,gate_threshold=2.0",
                      "-o", wav,
                      "--device", "cpu"])
    from cookietts_tpu_torch.data.audio_io import load_wav
    audio, sr = load_wav(wav)
    assert sr == 22050 and len(audio) == 64 * HOP and stats["segments"] == 1
    with pytest.raises(SystemExit, match="live --vocoder"):
        cli.main(["tts", "--artifact", out, "--text", "x", "--denoiser",
                  "--device", "cpu"])


def test_loader_refuses_jax_and_other_device_artifacts(tmp_path):
    jes.save_artifact(str(tmp_path / "j.npz"), {"t2s_b2_t12": b"stablehlo"},
                      {"platforms": ["cpu", "tpu"]})
    with pytest.raises(ValueError, match="not a torch.export artifact.*JAX"):
        es.load_artifact(str(tmp_path / "j.npz"), "cpu")
    es.save_artifact(str(tmp_path / "c.npz"), {}, {"device": "cuda"})
    with pytest.raises(ValueError, match="exported on 'cuda'"):
        es.load_artifact(str(tmp_path / "c.npz"), "cpu")

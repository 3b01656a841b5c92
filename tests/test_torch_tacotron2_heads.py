"""The port's Tacotron2 with the GST and EmotionNet heads against the JAX
model on the CPU, at tiny widths and the tolerance of test_torch_tacotron2.

Without a reference mel the heads take the torchMoji hidden (GST ref_mode 3,
AuxEmotionNet); with one, GST ref_mode 1 and EmotionNet. The memory
assembly (with and without a reference), inference and the streaming entry
(without: JAX's inference takes none) and the eval-mode teacher-forced
forward (its target mels are the reference) are held to JAX; the model
with the heads trains, and attention types 1 and 2 build.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cookietts_tpu.models.tacotron2 import (Tacotron2 as JTacotron2,
                                           Tacotron2Config as JConfig)
from cookietts_tpu.text import N_SYMBOLS

from cookietts_tpu_torch.convert.from_jax import tacotron2_state_dict_from_jax
from cookietts_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
from tests.test_torch_tacotron2 import TINY, _perturb
from test_torch_threads import _one_thread  # noqa: F401


HEADS = dict(TINY, use_gst=True, gst_token_num=4, gst_token_embedding_size=8,
             gst_num_heads=2, gst_att_dim=8, gst_ref_enc_filters=(4, 4),
             use_emotionnet=True, n_emotion_classes=3, emotionnet_latent_dim=2)
B, T_TXT, T_MEL = 2, 12, 16
LENGTHS = np.array([12, 7])
KW = dict(max_decoder_steps=32, early_exit=False)


def _close(a, b, atol=1e-4, rtol=1e-3):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def models():
    cfg = JConfig(**HEADS)
    jm = JTacotron2(cfg)
    rng = np.random.default_rng(0)
    text = rng.integers(1, N_SYMBOLS, (B, T_TXT))
    mels = rng.normal(0, 1, (B, T_MEL, 80)).astype(np.float32)
    v = jax.jit(jm.init, static_argnames=("deterministic",))(
        {"params": jax.random.PRNGKey(0),
         "dropout": jax.random.PRNGKey(1)},
        text=jnp.asarray(text), text_lengths=jnp.asarray(LENGTHS),
        mels=jnp.asarray(mels), mel_lengths=jnp.full((B,), T_MEL),
        speaker_id=jnp.array([1, 3]), sylps=jnp.full((B,), 4.0),
        key=jax.random.PRNGKey(2), deterministic=True)
    v = _perturb(v, rng)
    port = Tacotron2(Tacotron2Config(**HEADS), device="cpu")
    port.load_state_dict(tacotron2_state_dict_from_jax(v["params"],
                                                       v["batch_stats"]))
    inputs = dict(text=text, text_lengths=LENGTHS, speaker_id=np.array([1, 3]),
                  torchmoji_hidden=rng.normal(0, 1, (B, 8)).astype(np.float32))
    return jm, v, port, inputs, mels


def _args(inputs):
    return [jnp.asarray(inputs[k]) for k in
            ("text", "text_lengths", "speaker_id", "torchmoji_hidden")]


@pytest.mark.parametrize("with_ref", [False, True])
def test_memory_matches_jax(models, with_ref):
    jm, v, port, inputs, mels = models
    ref = mels if with_ref else None
    want_mem, want_heads = jm.apply(
        v, *_args(inputs), method=lambda m, t, tl, s, tm: m._build_memory(
            t, tl, s, None, tm, None, True,
            ref_mel=None if ref is None else jnp.asarray(ref)))
    t = {k: torch.as_tensor(x) for k, x in inputs.items()}
    with torch.no_grad():
        mem, heads = port._build_memory(
            t["text"], t["text_lengths"], t["speaker_id"], None,
            t["torchmoji_hidden"],
            ref_mel=None if ref is None else torch.from_numpy(ref))
    assert set(heads) == set(want_heads)
    assert ("em_zs" in heads) == with_ref
    _close(mem, want_mem, atol=1e-5, rtol=1e-4)
    for k in want_heads:
        _close(heads[k], want_heads[k], atol=1e-5, rtol=1e-4)


def test_inference_matches_jax(models):
    jm, v, port, inputs, _ = models
    ref = jm.apply(v, *_args(inputs), key=jax.random.PRNGKey(7),
                   method=JTacotron2.inference, **KW)
    out = port.inference(**inputs, **KW)
    np.testing.assert_array_equal(out["mel_lengths"].numpy(),
                                  np.asarray(ref["mel_lengths"]))
    for k in ("mel_outputs", "mel_outputs_postnet", "gate_outputs",
              "alignments", "gst_style_tokens", "aux_zs", "aux_zu_mu"):
        _close(out[k], ref[k])


def test_inference_prepare_and_decode_chunk_match_jax(models):
    """The streaming entry (the CUDA-graph chunk's input) with the heads."""
    jm, v, port, inputs, _ = models
    memory, const, carry = jm.apply(v, *_args(inputs),
                                    method=JTacotron2.inference_prepare)
    ref = jm.apply(v, memory, const, carry,
                   jax.random.split(jax.random.PRNGKey(7), 24),
                   method=JTacotron2.decode_chunk)
    p_memory, p_const, state = port.inference_prepare(**inputs)
    _close(p_memory, memory, atol=1e-5, rtol=1e-4)
    got = port.decode_chunk(p_memory, p_const, state, 24)
    for a, b in zip(got[:3], ref[:3]):
        _close(a, b)


def test_eval_forward_matches_jax(models):
    """The teacher-forced forward in eval mode takes its target mels as the
    heads' reference, as JAX's does."""
    jm, v, port, inputs, mels = models
    mel_lengths = np.array([16, 11])
    ref, _ = jm.apply(v, *_args(inputs)[:2], jnp.asarray(mels),
                      jnp.asarray(mel_lengths), jnp.asarray(inputs["speaker_id"]),
                      jnp.full((B,), 4.0),
                      torchmoji_hidden=jnp.asarray(inputs["torchmoji_hidden"]),
                      key=jax.random.PRNGKey(3), deterministic=True)
    t = {k: torch.as_tensor(x) for k, x in inputs.items()}
    with torch.no_grad():
        out, _ = port(t["text"], t["text_lengths"], torch.from_numpy(mels),
                      torch.from_numpy(mel_lengths), t["speaker_id"],
                      torch.full((B,), 4.0),
                      torchmoji_hidden=t["torchmoji_hidden"])
    for k in ("mel_outputs", "mel_outputs_postnet", "gate_outputs",
              "alignments", "gst_style_tokens", "em_zs", "aux_zs"):
        _close(out[k], ref[k])


def test_training_with_heads_and_other_attention_refused(models, tmp_path):
    """Once refusals, now positive checks (the test keeps its name): the
    model with both heads trains (its loss has the three emotion terms and
    every head gets a gradient), attention types 1 and 2 build, and the
    train command with each head gets past its configuration (to the absent
    filelist)."""
    from cookietts_tpu_torch.cli import main as cli
    from cookietts_tpu_torch.losses import tacotron2_loss
    _, _, port, inputs, mels = models
    t = {k: torch.as_tensor(x) for k, x in inputs.items()}
    ids = torch.tensor([1, HEADS["n_emotion_classes"]])
    onehot = torch.nn.functional.one_hot(ids.clamp_max(2), 3).float()
    onehot[1] = 0.0
    port.train()
    try:
        out, _ = port(t["text"], t["text_lengths"], torch.from_numpy(mels),
                      torch.full((B,), T_MEL), t["speaker_id"],
                      torch.full((B,), 4.0), t["torchmoji_hidden"],
                      generator=torch.Generator().manual_seed(0),
                      emotion_id=ids, emotion_onehot=onehot)
        gate = (torch.arange(T_MEL)[None] >= T_MEL - 1).float().expand(B, -1)
        total, ld, _ = tacotron2_loss(out, {
            "mels": torch.from_numpy(mels), "mel_lengths": torch.full((B,), T_MEL),
            "text_lengths": t["text_lengths"], "sylps": torch.full((B,), 4.0),
            "gate_target": gate, "emotion_id": ids, "emotion_onehot": onehot})
        total.backward()
    finally:
        port.eval()
    assert all(torch.isfinite(ld[k]) for k in ("em_kld", "sup_em_nll",
                                                "aux_em_MSE", "loss"))
    # (GST's map_lin serves the torchMoji path only: no gradient from a mel)
    for head in ("gst.ref_encoder.", "gst.att.", "emotion_net.",
                 "aux_emotion_net."):
        grads = [p.grad for n, p in port.named_parameters() if n.startswith(head)]
        assert grads and all(g is not None for g in grads), head
    port.zero_grad(set_to_none=True)
    for att in (1, 2):
        taco = Tacotron2(Tacotron2Config(**{**TINY, "attention_type": att}),
                         device="cpu")
        assert type(taco.decoder.attention_layer).__name__ == (
            "GMMAttention" if att == 1 else "DynamicConvolutionAttention")
    for heads in ("use_gst=True", "use_emotionnet=True"):
        with pytest.raises(FileNotFoundError):
            cli(["train", "--device", "cpu", "--filelist",
                 str(tmp_path / "absent.txt"), "--run_dir", str(tmp_path),
                 "--hparams", heads])

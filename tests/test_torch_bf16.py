"""The port's bf16 serving path against the JAX package's bf16, on the CPU.

``Tacotron2Config(dtype="bfloat16")`` and ``HiFiGANConfig(dtype=...)`` reach
the JAX models as a string, as ``--hparams dtype=bfloat16`` gives it, and
the port's configs take the same. Checked, at small widths:

- the plain bf16 versions of the three serving kernels against JAX's Pallas
  functions in interpret mode on the same bf16 inputs: attention and the
  LSTM compute in f32 on the bf16 values in both, so they agree to f32
  rounding (1e-5); the resblock rounds to bf16 where JAX's body rounds and
  agrees within two bf16 ulps at the output's largest value (XLA may keep
  excess precision between JAX's bf16 operations);
- the zoneout cell and location-sensitive attention against JAX with its
  Pallas kernel on (f32 rounding) and off (JAX's XLA path rounds the gates
  and energies to bf16, the port's kernels do not: bf16 rounding);
- a Tacotron2 at bench_quality_gate's CPU widths (bench.py:384-399)
  teacher-forced in bf16 against JAX's bf16 forward, and against the
  port's own f32 forward within JAX's gates (mel MSE < 5e-3, MCD < 0.5 dB);
  the first 8 bf16 inference frames against JAX's, with JAX's prenet keep
  masks injected;
- a small HiFi-GAN in bf16 against JAX's bf16 generator with its fused
  Pallas resblocks, and within MCD 1.0 dB of the port's f32;
- T2S, ``streaming_tts``, the server's ``handle_tts`` and ``tts --hparams
  ...,dtype=bfloat16`` end to end, and each refusal of what this slice
  leaves in f32.

Measured on the CPU, one thread: attention and the LSTM 1.5e-7 and 1.2e-7 from JAX's
Pallas kernels; the resblock 0.0156 at a largest value of 10.8 (a quarter of
its bf16 ulp there, the mean 2e-5); the teacher-forced postnet mel 0.0156
from JAX's bf16 (values to 2.7; gate logits 0.004, alignments 0.002);
bf16 against the port's f32, mel MSE 1.2e-5 and MCD 0.071 dB; HiFi-GAN
3.7e-4 from JAX's bf16 (audio to 0.069), MCD 0.23 dB from the port's f32.
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
from cookietts_tpu.ops.attention import AttentionState as JAttentionState
from cookietts_tpu.ops.lstm import ZoneoutLSTMCell as JCell
from cookietts_tpu.ops.pallas_kernels import attention_step as j_attention_step
from cookietts_tpu.ops.pallas_kernels import hifigan_resblock as j_resblock
from cookietts_tpu.ops.pallas_kernels import lstm_gates_step as j_lstm_gates_step
from cookietts_tpu.text import N_SYMBOLS

from cookietts_tpu_torch import cli
from cookietts_tpu_torch.audio.stft import TacotronSTFT
from cookietts_tpu_torch.convert.from_jax import (hifigan_state_dict_from_jax,
                                                  tacotron2_state_dict_from_jax)
from cookietts_tpu_torch.models.gantts import GANTTSConfig, GANTTSGenerator
from cookietts_tpu_torch.models.hifigan import Generator, HiFiGANConfig
from cookietts_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
from cookietts_tpu_torch.models.untts import UnTTS, UnTTSConfig
from cookietts_tpu_torch.models.waveglow import WaveGlow, WaveGlowConfig
from cookietts_tpu_torch.ops import hopper_kernels as hk
from cookietts_tpu_torch.ops.attention import AttentionState
from cookietts_tpu_torch.ops.lstm import ZoneoutLSTMCell
from cookietts_tpu_torch.ops.mcd import mcd
from cookietts_tpu_torch.parallel import WAVEGLOW_TP_RULES
from cookietts_tpu_torch.parallel.tp import shard_model
from cookietts_tpu_torch.pipeline.server import ModelRegistry, handle_tts
from cookietts_tpu_torch.pipeline.streaming import streaming_tts
from cookietts_tpu_torch.pipeline.text2speech import T2S, T2SConfig
from cookietts_tpu_torch.runtime.checkpoint import save_checkpoint
from test_torch_threads import _one_thread  # noqa: F401

BF16 = torch.bfloat16
# bench_quality_gate's CPU widths (bench.py:384-399); prenet dropout 0 where
# the port meets JAX (their generators never draw the same bits)
TACO = dict(
    n_symbols=N_SYMBOLS, symbols_embedding_dim=16, n_speakers=4,
    speaker_embedding_dim=8, encoder_speaker_embed_dim=4,
    encoder_conv_hidden_dim=16, encoder_lstm_dim=16, encoder_n_convolutions=1,
    torchmoji_dim=8, torchmoji_crushed_dim=4, memory_bottleneck_dim=16,
    prenet_dim=8, attention_rnn_dim=16, decoder_rnn_dim=16,
    second_decoder_rnn_dim=0, attention_dim=8, windowed_attention_range=4,
    postnet_embedding_dim=16, postnet_n_convolutions=2,
    postnet_residual_connections=0, p_prenet_dropout=0.0)
B, T_TXT, T_MEL = 2, 12, 32
HIFI = dict(n_mel_channels=80, upsample_rates=(8, 8, 4, 2),
            upsample_kernel_sizes=(16, 16, 8, 4), resblock_kernel_sizes=(3,),
            resblock_dilations=((1, 3),), upsample_initial_channel=32)
GATES = dict(mse=5e-3, mcd_db=0.5, hifigan_mcd_db=1.0)   # bench.py's


def _np(x):
    return np.asarray(torch.as_tensor(x).float() if torch.is_tensor(x)
                      else np.asarray(x, np.float32))


def _bf16_np(x):
    """numpy f32 values rounded to bf16 (the same bits on both sides)."""
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _ulp(x) -> float:
    """One bf16 ulp at the scale of max |x|."""
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


@pytest.fixture(scope="module")
def taco():
    """One set of JAX Tacotron2 weights (perturbed BatchNorm statistics and
    attention scalars), the batch, and the port in f32 and bf16."""
    rng = np.random.default_rng(7)
    batch = dict(
        text=rng.integers(1, N_SYMBOLS, (B, T_TXT)),
        text_lengths=np.array([T_TXT, T_TXT - 4]),
        mels=np.log(np.clip(np.abs(rng.standard_normal((B, T_MEL, 80))), 1e-5,
                            None)).astype(np.float32),
        mel_lengths=np.full((B,), T_MEL), speaker_id=np.array([1, 3]),
        sylps=np.full((B,), 4.0, np.float32))
    jm = JTacotron2(JConfig(**TACO))
    v = jax.jit(jm.init, static_argnames=("deterministic",))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        **{k: jnp.asarray(x) for k, x in batch.items()},
        key=jax.random.PRNGKey(2), deterministic=True)
    v = jax.tree_util.tree_map(np.array, v)
    for path, x in jax.tree_util.tree_flatten_with_path(v["batch_stats"])[0]:
        x[...] = (rng.uniform(0.5, 1.5, x.shape)
                  if "var" in jax.tree_util.keystr(path)
                  else rng.normal(0, 0.2, x.shape))
    att = v["params"]["decoder"]["cell"]["attention"]
    att["window_offset"][...] = 0.7
    att["exp_smoothing_factor"][...] = -0.4
    sd = tacotron2_state_dict_from_jax(v["params"], v["batch_stats"])
    port = {}
    for name, dt in (("f32", "float32"), ("bf16", "bfloat16")):
        port[name] = Tacotron2(Tacotron2Config(**TACO, dtype=dt), device="cpu")
        port[name].load_state_dict(sd)
    return dict(v=v, batch=batch, port=port, sd=sd)


def _jax_bf16(**kw):
    return JTacotron2(JConfig(**{**TACO, **kw}, dtype="bfloat16",
                              use_pallas_attention=True, use_pallas_lstm=True))


# -- the dtype rule and the refusals --------------------------------------------

def test_dtype_rule():
    """torch dtypes or their names, as JAX's configs take the string; any
    other value raises and names it."""
    assert jnp.zeros(1, JConfig(dtype="bfloat16").dtype).dtype == jnp.bfloat16
    for cls in (Tacotron2Config, HiFiGANConfig, WaveGlowConfig, UnTTSConfig,
                GANTTSConfig):
        assert cls(dtype="bfloat16").dtype is BF16
        assert cls(dtype=BF16).dtype is BF16
        assert cls(dtype="float32").dtype is cls().dtype is torch.float32
        for bad in (torch.float16, "float16", "bf16", np.float32):
            with pytest.raises(ValueError, match="float32 or bfloat16"):
                cls(dtype=bad)
    with pytest.raises(ValueError, match="float16"):
        Tacotron2Config(dtype=torch.float16)


def _mel():
    return torch.zeros(1, 8, 80)


def _waveglow():
    return WaveGlow(WaveGlowConfig(n_mel_channels=8, n_flows=2, n_layers=2,
                                   n_channels=8, hop_length=24,
                                   upsample_strides=(3,), upsample_channels=8,
                                   dtype=BF16), device="cpu")


REFUSALS = {
    "waveglow_tp": lambda: shard_model(_waveglow(), WAVEGLOW_TP_RULES, tp=None),
    "waveglow_sp": lambda: _waveglow().inverse(torch.zeros(1, 3, 8),
                                               torch.zeros(1, 1, 8), sp=object()),
    "untts": lambda: UnTTS(UnTTSConfig(dtype=BF16), device="cpu"),
    "gantts": lambda: GANTTSGenerator(GANTTSConfig(dtype=BF16), device="cpu"),
    "gst": lambda: Tacotron2(Tacotron2Config(**TACO, dtype=BF16, use_gst=True),
                             device="cpu"),
    "emotionnet": lambda: Tacotron2(Tacotron2Config(
        **TACO, dtype=BF16, use_emotionnet=True), device="cpu"),
    "gmm": lambda: Tacotron2(Tacotron2Config(**TACO, dtype=BF16,
                                             attention_type=1), device="cpu"),
    "dca": lambda: Tacotron2(Tacotron2Config(**TACO, dtype=BF16,
                                             attention_type=2), device="cpu"),
    "temperature": lambda: Tacotron2(Tacotron2Config(
        **TACO, dtype=BF16, attention_learned_temperature=True), device="cpu"),
    "no_bottleneck": lambda: Tacotron2(Tacotron2Config(
        **TACO, dtype=BF16, use_memory_bottleneck=False), device="cpu"),
    "tacotron2_train": lambda: Tacotron2(Tacotron2Config(**TACO, dtype=BF16),
                                         device="cpu").train(),
    "hifigan_weight_norm": lambda: Generator(HiFiGANConfig(**HIFI, dtype=BF16),
                                             device="cpu", weight_norm=True),
    "hifigan_no_kernel": lambda: Generator(HiFiGANConfig(
        **HIFI, dtype=BF16, pallas_resblocks=False), device="cpu"),
    "hifigan_train_forward": lambda: Generator(
        HiFiGANConfig(**HIFI, dtype=BF16), device="cpu")(_mel()),
    "export": lambda: cli.main(["export", "--device", "cpu", "--hparams",
                                "dtype=bfloat16", "-o", "unused.npz"]),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_out_of_slice_refuses_bf16(case):
    """What the port leaves in f32 refuses bf16 and names its slice; the
    flow vocoders run in bf16 but for tp and sp (tests/test_torch_bf16_flows.py
    holds the rest of their refusals)."""
    with pytest.raises(NotImplementedError,
                       match="bfloat16 comes with a later slice.*float32"):
        REFUSALS[case]()


def test_tp_sharded_cell_refuses_bf16():
    cell = ZoneoutLSTMCell(8, 8)
    cell.tp = object()
    with pytest.raises(NotImplementedError, match="later slice"):
        cell(torch.zeros(1, 8, dtype=BF16), (torch.zeros(1, 8),) * 2)


# -- the kernels' plain bf16 versions against JAX's Pallas functions -------------

def _resblock_case():
    """x [B, C, T] and the port's weights [P, k, C_in, C_out] as bf16 values,
    with JAX's channel-major layout of the same."""
    rng = np.random.default_rng(3)
    Bx, C, T, k, dil = 2, 16, 200, 3, (1, 3)
    x = _bf16_np(rng.standard_normal((Bx, C, T)))
    w1, w2 = (_bf16_np(rng.standard_normal((2, k, C, C)) * 0.25) for _ in range(2))
    b1, b2 = (rng.standard_normal((2, C)).astype(np.float32) * 0.1
              for _ in range(2))
    halo, Wt = 128, 128
    Tp = halo + -(-T // Wt) * Wt + halo
    x_cm = np.zeros((C, Bx, Tp), np.float32)
    x_cm[:, :, halo:halo + T] = x.transpose(1, 0, 2)
    jw = lambda w: np.stack([w[p].reshape(k * C, C).T for p in range(2)])  # noqa: E731
    ref = j_resblock(jnp.asarray(x_cm.reshape(C, -1), jnp.bfloat16),
                     jnp.asarray(jw(w1), jnp.bfloat16), jnp.asarray(b1),
                     jnp.asarray(jw(w2), jnp.bfloat16), jnp.asarray(b2),
                     k=k, C=C, Wt=Wt, halo=halo, T=T, B=Bx, dilations=dil,
                     slope=0.1)
    assert ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32)).reshape(C, Bx, Tp)[
        :, :, halo:halo + T].transpose(1, 0, 2)
    got = hk.hifigan_resblock(*(torch.from_numpy(a).to(BF16) for a in (x, w1)),
                              torch.from_numpy(b1),
                              torch.from_numpy(w2).to(BF16),
                              torch.from_numpy(b2), dil, 0.1)
    assert got.dtype == BF16
    return _np(got), ref


def _lstm_case():
    rng = np.random.default_rng(1)
    H, F = 128, 256                 # 128-aligned: the Pallas path really runs
    xh, k = _bf16_np(rng.standard_normal((3, F)) * 0.3), _bf16_np(
        rng.standard_normal((F, 4 * H)) * 0.1)
    b = _bf16_np(rng.standard_normal(4 * H) * 0.05)
    c = rng.standard_normal((3, H)).astype(np.float32) * 0.5
    ref = j_lstm_gates_step(*(jnp.asarray(a, jnp.bfloat16) for a in (xh, k, b)),
                            jnp.asarray(c), use_pallas=True)
    got = hk.lstm_gates(*(torch.from_numpy(a).to(BF16) for a in (xh, k, b)),
                        torch.from_numpy(c))
    assert got[0].dtype == torch.float32
    return np.concatenate([_np(t) for t in got]), np.concatenate(
        [np.asarray(t) for t in ref])


def _attention_case():
    rng = np.random.default_rng(2)
    Bx, T, A, D = 3, 37, 48, 37     # D odd, as the memory without bottleneck
    f = lambda *s: _bf16_np(rng.standard_normal(s))  # noqa: E731
    qp, lp, mp, mem = f(Bx, A), f(Bx, T, A), f(Bx, T, A), f(Bx, T, D)
    v = rng.standard_normal(A).astype(np.float32) * A ** -0.5
    mask = np.arange(T)[None, :] < np.array([T, T - 9, T - 20])[:, None]
    mask[1, :5] = False
    j = jnp.asarray
    ref = j_attention_step(j(qp, jnp.bfloat16), j(lp, jnp.bfloat16),
                           j(mp, jnp.bfloat16), j(v), j(mem, jnp.bfloat16),
                           j(mask), use_pallas=True)
    t = lambda a: torch.from_numpy(a).to(BF16)  # noqa: E731
    got = hk.attention_step(t(qp), t(lp), t(mp), torch.from_numpy(v), t(mem),
                            torch.from_numpy(mask))
    assert got[0].dtype == got[1].dtype == torch.float32
    return (np.concatenate([_np(got[0]).ravel(), _np(got[1]).ravel()]),
            np.concatenate([np.asarray(ref[0]).ravel(),
                            np.asarray(ref[1]).ravel()]))


@pytest.mark.parametrize("kernel", ["attention_step", "lstm_gates",
                                    "hifigan_resblock"])
def test_plain_bf16_matches_jax_pallas(kernel):
    got, ref = {"attention_step": _attention_case, "lstm_gates": _lstm_case,
                "hifigan_resblock": _resblock_case}[kernel]()
    if kernel == "hifigan_resblock":
        # the same bf16 rounding points; two ulps at the largest value
        np.testing.assert_allclose(got, ref, atol=2 * _ulp(ref), rtol=0)
        assert np.abs(got - ref).mean() < 1e-3 * np.abs(ref).mean()
    else:
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


# -- the modules against JAX with its Pallas kernels on and off -----------------

@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "xla"])
def test_zoneout_cell_matches_jax(use_pallas):
    rng = np.random.default_rng(4)
    In, H = 128, 128
    K = (rng.standard_normal((In + H, 4 * H)) * 0.08).astype(np.float32)
    b = (rng.standard_normal(4 * H) * 0.05).astype(np.float32)
    x = rng.standard_normal((3, In)).astype(np.float32)
    c, h = (rng.standard_normal((3, H)).astype(np.float32) for _ in range(2))
    jcell = JCell(H, zoneout=0.0, dtype=jnp.bfloat16, use_pallas=use_pallas)
    (c_r, h_r), y_r = jcell.apply(
        {"params": {"gates": {"kernel": K, "bias": b}}},
        (jnp.asarray(c), jnp.asarray(h)), jnp.asarray(x, jnp.bfloat16))
    assert y_r.dtype == jnp.bfloat16
    cell = ZoneoutLSTMCell(In, H)
    with torch.no_grad():
        cell.weight_ih.copy_(torch.from_numpy(K[:In].T.copy()))
        cell.weight_hh.copy_(torch.from_numpy(K[In:].T.copy()))
        cell.bias_ih.copy_(torch.from_numpy(b) + torch.cat(
            [torch.zeros(H), torch.ones(H), torch.zeros(2 * H)]))
        cell.bias_hh.zero_()
    cell.eval()
    with torch.no_grad():
        c_p, h_p = cell(torch.from_numpy(x).to(BF16),
                        (torch.from_numpy(c), torch.from_numpy(h)))
    assert c_p.dtype == h_p.dtype == torch.float32
    # JAX's XLA path rounds the gates to bf16 (the port's kernel keeps them
    # f32, as JAX's Pallas kernel does): within 2e-2 there; with Pallas f32
    # rounding of 256-term sums in two orders
    atol, rtol = (1e-5, 1e-4) if use_pallas else (2e-2, 0)
    np.testing.assert_allclose(_np(c_p), np.asarray(c_r), atol=atol, rtol=rtol)
    np.testing.assert_allclose(_np(h_p), np.asarray(h_r), atol=atol, rtol=rtol)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "xla"])
def test_location_attention_matches_jax(taco, use_pallas):
    rng = np.random.default_rng(5)
    T = T_TXT
    q = _bf16_np(rng.normal(0, 1, (B, 16)))
    mem = _bf16_np(rng.normal(0, 1, (B, T, 16)))
    w = rng.dirichlet(np.ones(T), B).astype(np.float32)
    wc = (w * 3.0).astype(np.float32)
    pos = np.array([2.3, 5.6], np.float32)

    def run(m, q_, mem_, lens, state):
        att = m.decoder.cell.attention
        return att(q_, mem_, att.precompute(mem_, lens), state)

    jm = JTacotron2(JConfig(**TACO, dtype="bfloat16",
                            use_pallas_attention=use_pallas))
    ctx_r, w_r, st_r = jm.apply(
        taco["v"], jnp.asarray(q, jnp.bfloat16), jnp.asarray(mem, jnp.bfloat16),
        jnp.asarray(taco["batch"]["text_lengths"]),
        JAttentionState(jnp.asarray(w), jnp.asarray(wc), jnp.asarray(pos),
                        jnp.zeros((B, 1))), method=run)
    port = taco["port"]["bf16"]
    att = port.decoder.attention_layer
    with torch.no_grad():
        mem_t = torch.from_numpy(mem).to(BF16)
        ctx, wts, st = att(
            torch.from_numpy(q).to(BF16), mem_t,
            att.precompute(mem_t, torch.from_numpy(taco["batch"]["text_lengths"])),
            AttentionState(torch.from_numpy(w), torch.from_numpy(wc),
                           torch.from_numpy(pos), torch.zeros(B, 1)),
            port.decoder.exp_smoothing_factor)
    assert ctx.dtype == BF16 and wts.dtype == st.position.dtype == torch.float32
    assert ctx_r.dtype == jnp.bfloat16
    # with Pallas both compute in f32 on the same bf16 projections (a ctx
    # bf16 ulp where the roundings part); JAX's XLA path rounds the energies
    # and the context's products to bf16
    tol_w, tol_c = (1e-5, 2e-2) if use_pallas else (2e-2, 5e-2)
    np.testing.assert_allclose(_np(wts), np.asarray(w_r), atol=tol_w, rtol=0)
    np.testing.assert_allclose(_np(ctx), np.asarray(ctx_r, np.float32),
                               atol=tol_c, rtol=0)
    np.testing.assert_allclose(_np(st.position), np.asarray(st_r.position),
                               atol=max(tol_w * T, 1e-4), rtol=0)


# -- the whole Tacotron2 ---------------------------------------------------------

def _port_inputs(batch):
    return {k: torch.as_tensor(x) for k, x in batch.items()}


def test_teacher_forced_matches_jax_bf16(taco):
    batch = taco["batch"]
    jm = _jax_bf16()
    out_r, _ = jax.jit(lambda v_, b_: jm.apply(
        v_, **b_, key=jax.random.PRNGKey(3), p_teacher_forcing=1.0,
        deterministic=True))(taco["v"], {k: jnp.asarray(x) for k, x in batch.items()})
    assert out_r["mel_outputs_postnet"].dtype == jnp.bfloat16
    out = taco["port"]["bf16"].eval_forward(_port_inputs(batch))
    assert out["mel_outputs_postnet"].dtype == BF16
    assert out["gate_outputs"].dtype == torch.float32
    for k, tol in (("mel_outputs", 3e-2), ("mel_outputs_postnet", 3e-2),
                   ("gate_outputs", 1e-2), ("alignments", 5e-3)):
        np.testing.assert_allclose(_np(out[k]), np.asarray(
            out_r[k]).astype(np.float32), atol=tol, rtol=0, err_msg=k)


def test_bf16_within_jax_gates_of_f32(taco):
    """bench_quality_gate's Tacotron2 gate on the port: the same weights in
    f32 and in bf16, teacher-forced with the prenet's dropout on (the same
    keep masks from one generator seed)."""
    cfg = dict(TACO, p_prenet_dropout=0.5)
    mels = []
    for dt in ("float32", "bfloat16"):
        m = Tacotron2(Tacotron2Config(**cfg, dtype=dt), device="cpu")
        m.load_state_dict(taco["sd"])
        out = m.eval_forward(_port_inputs(taco["batch"]),
                             torch.Generator().manual_seed(3))
        mels.append(_np(out["mel_outputs_postnet"]))
    mse = float(np.mean((mels[0] - mels[1]) ** 2))
    dist = float(np.mean([mcd(mels[0][i], mels[1][i]) for i in range(B)]))
    assert mse < GATES["mse"] and dist < GATES["mcd_db"], (mse, dist)
    assert mse > 0                         # the bf16 path really rounds


def _prenet_masks(key, steps, dim, p=0.5, layers=2):
    """JAX inference's prenet keep masks (tests/test_torch_attention_types.py)."""
    _, _, k_dec = jax.random.split(key, 3)
    masks = []
    for k in jax.random.split(k_dec, steps):
        k_pre = jax.random.split(k, 4)[0]
        step = []
        for _ in range(layers):
            k_pre, sub = jax.random.split(k_pre)
            step.append(torch.from_numpy(np.array(
                jax.random.bernoulli(sub, 1.0 - p, (B, dim)))))
        masks.append(step)
    return masks


def test_first_inference_frames_match_jax_bf16(taco):
    steps, key = 8, jax.random.PRNGKey(7)
    batch = taco["batch"]
    args = ("text", "text_lengths", "speaker_id")
    jm = _jax_bf16(p_prenet_dropout=0.5)
    ref = jax.jit(lambda v_, *a: jm.apply(
        v_, *a, key=key, max_decoder_steps=steps,
        method=JTacotron2.inference))(taco["v"], *(jnp.asarray(batch[k]) for k in args))
    port = Tacotron2(Tacotron2Config(**{**TACO, "p_prenet_dropout": 0.5},
                                     dtype="bfloat16"), device="cpu")
    port.load_state_dict(taco["sd"])
    masks = iter(_prenet_masks(key, steps, TACO["prenet_dim"]))
    prenet = port.decoder.prenet
    forward = prenet.forward
    prenet.forward = lambda x, generator=None: forward(x, masks=next(masks))
    out = port.inference(*(batch[k] for k in args), max_decoder_steps=steps)
    assert out["mel_outputs"].dtype == BF16
    for k in ("mel_outputs", "gate_outputs", "alignments"):
        np.testing.assert_allclose(_np(out[k]), np.asarray(ref[k]).astype(
            np.float32), atol=5e-2, rtol=0, err_msg=k)


# -- HiFi-GAN ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def hifigan():
    mel = np.random.default_rng(8).standard_normal((1, 16, 80)).astype(np.float32)
    jg = JGenerator(JHConfig(**HIFI, pallas_resblocks=False))
    v = jax.tree_util.tree_map(np.asarray, jax.jit(jg.init)(
        jax.random.PRNGKey(0), jnp.asarray(mel)))
    sd = hifigan_state_dict_from_jax(v["params"])
    gens = {}
    for dt in ("float32", "bfloat16"):
        gens[dt] = Generator(HiFiGANConfig(**HIFI, dtype=dt), device="cpu")
        gens[dt].load_state_dict(sd)
    return mel, v, gens, sd


def test_hifigan_bf16_matches_jax_and_f32_gate(hifigan):
    mel, v, gens, _ = hifigan
    jg = JGenerator(JHConfig(**HIFI, dtype="bfloat16", pallas_resblocks=True,
                             pallas_tile=256))
    ref = jax.jit(lambda v_, m: jg.apply(v_, m, infer=True))(v, jnp.asarray(mel))
    assert ref.dtype == jnp.bfloat16
    wav = gens["bfloat16"](torch.from_numpy(mel), infer=True)
    assert wav.dtype == torch.float32
    np.testing.assert_allclose(_np(wav), np.asarray(ref, np.float32), atol=2e-3,
                               rtol=0)
    wav32 = gens["float32"](torch.from_numpy(mel), infer=True)
    stft = TacotronSTFT(filter_length=2048, hop_length=512, win_length=2048,
                        n_mel_channels=80, sampling_rate=44100, mel_fmax=11025.0,
                        device="cpu")
    dist = mcd(stft.mel_spectrogram_np(_np(wav32)[0]),
               stft.mel_spectrogram_np(_np(wav)[0]))
    assert 0 < dist < GATES["hifigan_mcd_db"], dist


# -- serving end to end -------------------------------------------------------------

T2S_CFG = dict(batch_size=2, max_attempts=1, step_buckets=(64,),
               max_decoder_steps=64, frames_per_char=2.0, gate_threshold=2.0)


def test_t2s_streaming_and_server_in_bf16(taco, hifigan, tmp_path):
    model, gen = taco["port"]["bf16"], hifigan[2]["bfloat16"]
    t2s = T2S(T2SConfig(**T2S_CFG), model, {"alice": 0, "bob": 2},
              vocoder_fn=gen, sample_rate=44100, hop_length=512, device="cpu")
    res = t2s.infer("Hello world, the quick fox!", speaker=["alice"], seed=1)
    assert res["audio"].dtype == np.float32 and np.isfinite(res["audio"]).all()
    assert len(res["audio"]) == int(res["mel_lengths"].sum()) * 512
    mel = res["mels"][0]
    assert mel.dtype == np.float32
    np.testing.assert_array_equal(mel, _bf16_np(mel))     # bf16 values

    pieces = list(streaming_tts(
        model, gen, text=torch.as_tensor(taco["batch"]["text"][:1]),
        text_lengths=torch.as_tensor(taco["batch"]["text_lengths"][:1]),
        speaker_id=torch.tensor([1]), generator=torch.Generator().manual_seed(2),
        max_decoder_steps=40, decode_chunk_steps=8, vocoder_halo=4,
        hop_length=512, gate_threshold=2.0))
    audio = np.concatenate([p for _, p in pieces], axis=1)
    assert audio.dtype == np.float32 and audio.shape == (1, 40 * 512)

    registry = ModelRegistry({"bf16": t2s}, "bf16")
    stats, wav = handle_tts(registry, {"text": "Hello world.",
                                       "speaker": "bob"}.get, str(tmp_path))
    assert wav and stats["audio_seconds"] > 0


def test_tts_command_with_hparams_dtype_bfloat16(taco, hifigan, tmp_path, capsys):
    meta = {"model": "tacotron2",
            "model_config": {k: list(x) if isinstance(x, tuple) else x
                             for k, x in TACO.items()},
            "speaker_ids": {"alice": 0}, "audio": {
                "sampling_rate": 44100, "hop_length": 512, "n_mel_channels": 80}}
    save_checkpoint(str(tmp_path / "taco"), {"state_dict": taco["sd"]}, meta)
    save_checkpoint(str(tmp_path / "hifigan"), {"state_dict": hifigan[3]},
                    {"model": "hifigan", "model_config": {
                        k: list(x) if isinstance(x, tuple) else x
                        for k, x in HIFI.items()}})
    hparams = ("batch_size=2,max_text_len=64,frames_per_char=2.0,step_buckets="
               "[64],max_decoder_steps=64,gate_threshold=2.0")
    args = cli.build_parser().parse_args(
        ["tts", "--checkpoint", str(tmp_path / "taco"), "--vocoder",
         str(tmp_path / "hifigan"), "--text", "Hello world.", "--out",
         str(tmp_path / "b.wav"), "--max_attempts", "1", "--device", "cpu",
         "--hparams", hparams + ",dtype=bfloat16"])
    t2s = cli._build_t2s(args)
    assert t2s.model.cfg.dtype is BF16 and t2s.vocoder_fn.func.cfg.dtype is BF16
    stats = args.fn(args)
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1])["segments"] == 1 and stats["audio_seconds"] > 0
    from cookietts_tpu_torch.data.audio_io import load_wav
    wav, sr = load_wav(stats["out"])
    assert sr == 44100 and len(wav) == 64 * 512

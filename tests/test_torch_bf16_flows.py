"""The port's bf16 flow vocoders against the JAX package's bf16, on the CPU.

``WaveGlowConfig(dtype="bfloat16")`` reaches both packages as a string, as
``--hparams dtype=bfloat16`` gives it. Checked, at small widths:

- the plain bf16 versions of the two WN kernels against JAX's Pallas
  functions in interpret mode, on the dtypes JAX's callers pass:
  ``waveglow_wn_forward`` (x f32, bf16 weights and cond_bc, f32 biases;
  f32 arithmetic on the bf16 values) agrees to f32 rounding;
  ``waveflow_row_step`` (bf16 queues, weights, cond_bc and start bias)
  over 4 rows at a width that is not a multiple of 128: log_s, t and the
  queues agree where the same bf16 roundings are taken (a rounding that an
  f32 ulp flips moves an output by a bf16 ulp of an intermediate);
- a WaveGlow at bench_quality_gate's CPU widths (bench.py:449-455; end
  layers filled as bench.py:468-481 fills them) inverted in bf16 against
  JAX's bf16 inverse with its Pallas kernel, with an f32 z (the chain stays
  f32) and with a bf16 z (every coupling step rounds);
- the bf16 WaveFlow inverse against JAX's XLA bf16 path (JAX's Pallas
  model path does not run on this CPU: its bf16 x bf16 = f32 dot has no
  CPU thunk), at a bf16 tolerance, and JAX's own f32;
- bf16 against the port's f32 within JAX's WaveGlow gate (STFT MSE < 0.05,
  MCD < 1.0 dB);
- the bf16 training forward and loss of both models against JAX's, and one
  ``train --model waveglow --hparams dtype=bfloat16`` step through the CLI;
- T2S with a bf16 WaveGlow and the denoiser, ``tts --hparams
  ...,dtype=bfloat16`` with a flow vocoder and ``--denoiser``, and the
  server's ``handle_tts``; each refusal that stays.

Measured on the CPU, one thread (tolerances beside each test): see the
test's docstring.
"""
import json

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from cookietts_tpu.models.waveglow import WaveGlow as JWaveGlow
from cookietts_tpu.models.waveglow import WaveGlowConfig as JConfig
from cookietts_tpu.models.waveglow import waveglow_loss as j_waveglow_loss
from cookietts_tpu.ops.pallas_kernels import waveflow_row_step as j_row_step
from cookietts_tpu.ops.pallas_kernels import waveglow_wn_forward as j_wn_forward

from cookietts_tpu_torch import cli
from cookietts_tpu_torch.audio.stft import STFT, TacotronSTFT
from cookietts_tpu_torch.convert.from_jax import waveglow_from_jax
from cookietts_tpu_torch.data.audio_io import load_wav, save_wav
from cookietts_tpu_torch.models.denoiser import Denoiser
from cookietts_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
from cookietts_tpu_torch.models.untts import UnTTS, UnTTSConfig
from cookietts_tpu_torch.models.waveglow import (WaveGlow, WaveGlowConfig,
                                                 waveglow_loss)
from cookietts_tpu_torch.ops import hopper_kernels as hk
from cookietts_tpu_torch.ops.mcd import mcd
from cookietts_tpu_torch.parallel import WAVEGLOW_TP_RULES
from cookietts_tpu_torch.parallel.tp import shard_model
from cookietts_tpu_torch.pipeline.server import ModelRegistry, handle_tts
from cookietts_tpu_torch.pipeline.text2speech import (T2S, T2SConfig,
                                                      make_flow_vocoder_fn)
from cookietts_tpu_torch.runtime.checkpoint import save_checkpoint
from cookietts_tpu_torch.text import N_SYMBOLS
from test_torch_threads import _one_thread  # noqa: F401

BF16 = torch.bfloat16
# bench_quality_gate's CPU widths (bench.py:449-455)
GATE = dict(n_mel_channels=160, n_flows=4, n_group=24, n_early_every=4,
            n_early_size=2, n_layers=8, n_channels=32, kernel_size=3,
            hop_length=600, upsample_strides=(5, 5), upsample_channels=32,
            memory_efficient=False)
GATE_T_MEL = 4
WAVEGLOW_GATE = dict(stft_mse=0.05, mcd_db=1.0)          # bench.py:517-520
# tiny models for the WaveFlow inverse and the training forward
TINY = dict(n_mel_channels=8, n_layers=3, n_channels=16, upsample_channels=8)
TINY_GLOW = dict(TINY, n_flows=4, n_group=8, n_early_every=2, n_early_size=2,
                 hop_length=24, upsample_strides=(3,))
TINY_FLOW = dict(TINY, n_flows=3, n_group=8, channel_mixing="permuteheight",
                 hop_length=16, upsample_strides=(2,))


def _bf16_np(x):
    """numpy f32 values rounded to bf16 (the same bits on both sides)."""
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _ulp(x) -> float:
    """One bf16 ulp at the scale of max |x|."""
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


def _params(cfg, seed, end_scale=None, bias_scale=0.05):
    """A param tree of JAX's WaveGlow(cfg) filled in numpy: kernels at
    flax's lecun-normal scale, biases small, each 1x1 conv a rotation (det
    +1), the end layers' kernels ``end_scale`` normals (bench_quality_gate's
    0.002 from default_rng(11)) or, by default, as the other kernels. The
    tree's shapes come from jax.eval_shape, not from a compiled init."""
    m = JWaveGlow(JConfig(**cfg))
    T = 2 * cfg["hop_length"]
    shapes = jax.eval_shape(m.init, jax.random.PRNGKey(0), jnp.zeros((1, T)),
                            jnp.zeros((1, 2, cfg["n_mel_channels"])))["params"]
    rng, end_rng = np.random.default_rng(seed), np.random.default_rng(11)

    def fill(kp, leaf):
        path = [getattr(k, "key", "") for k in kp]
        shape = leaf.shape
        if path[-1] == "weight":                     # Invertible1x1Conv
            q, _ = np.linalg.qr(rng.standard_normal(shape))
            q[:, 0] *= np.sign(np.linalg.det(q))
            return q.astype(np.float32)
        if "end" in path and len(shape) >= 2 and end_scale is not None:
            return (end_scale * end_rng.standard_normal(shape)).astype(np.float32)
        if len(shape) >= 2:
            fan_in = int(np.prod(shape[:-1])) if path[-1] == "kernel" else shape[-1]
            return (rng.standard_normal(shape) * fan_in ** -0.5).astype(np.float32)
        return (bias_scale * rng.standard_normal(shape)).astype(np.float32)

    return jtu.tree_map_with_path(fill, shapes)


def _port(cfg, params, dtype):
    model = WaveGlow(WaveGlowConfig(**cfg, dtype=dtype), device="cpu")
    model.load_state_dict(waveglow_from_jax(params, JConfig(**cfg)))
    return model


# -- the two kernels' plain bf16 versions against JAX's Pallas functions -------

def _wn_weights(rng, Cin, C, Cout, L, rows, kw):
    """Random WN weights in the port's layouts, f32 values."""
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    k = rows * kw * C
    rs_w, rs_b = f(L, C, 2 * C, scale=C ** -0.5), f(L, 2 * C, scale=0.1)
    rs_w[-1, :, :C] = 0                      # the last layer has no res half
    rs_b[-1, :C] = 0
    return [f(Cin, C), f(C, scale=0.1), f(L, k, 2 * C, scale=k ** -0.5), rs_w,
            rs_b, f(C, Cout, scale=C ** -0.5), f(Cout, scale=0.1)]


def _padded(a, halo, Tp):
    """[B, C, T] -> the Pallas kernels' [C, B * T'] with a zero halo."""
    B, C, T = a.shape
    out = np.zeros((C, B, Tp), np.float32)
    out[:, :, halo:halo + T] = a.transpose(1, 0, 2)
    return out.reshape(C, B * Tp)


def _t(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def test_plain_bf16_wn_forward_matches_jax_pallas():
    """waveglow_wn_forward's plain bf16 form against JAX's kernel in
    interpret mode on the dtypes JAX's caller passes (x stays f32, the
    weights and cond_bc are bf16, the biases f32): f32 arithmetic on the
    same bf16 values in both, so f32 rounding. Measured 6.0e-7 at outputs
    up to 4.5; held to 1e-5."""
    rng = np.random.default_rng(3)
    B, T, Cin, C, Cout, L, kw, halo, Wt = 2, 200, 4, 16, 8, 3, 3, 128, 128
    sw, sb, k_all, rs_w, rs_b, ew, eb = _wn_weights(rng, Cin, C, Cout, L, 1, kw)
    sw, k_all, rs_w, ew = (_bf16_np(a) for a in (sw, k_all, rs_w, ew))
    x = rng.standard_normal((B, Cin, T)).astype(np.float32)
    cond = _bf16_np(rng.standard_normal((B, L, 2 * C, T)))
    Tp = 2 * halo + -(-T // Wt) * Wt
    b16, f32 = jnp.bfloat16, jnp.float32
    pad16 = lambda w: np.pad(w, ((0, 16 - w.shape[0]), (0, 0)))  # noqa: E731
    st = j_wn_forward(
        jnp.asarray(pad16(_padded(x, halo, Tp)), f32),
        jnp.asarray(np.stack([_padded(cond[:, i], halo, Tp) for i in range(L)]), b16),
        jnp.asarray(pad16(sw).T, b16), jnp.asarray(sb[:, None], f32),
        jnp.asarray(k_all.transpose(0, 2, 1), b16),
        jnp.asarray(rs_w.transpose(0, 2, 1), b16), jnp.asarray(rs_b, f32),
        jnp.asarray(pad16(ew.T), b16), jnp.asarray(pad16(eb[:, None]), f32),
        L=L, kw=kw, C=C, Wt=Wt, halo=halo, T=T, B=B)
    ref = np.asarray(st)[:Cout].reshape(Cout, B, Tp)[:, :, halo:halo + T]
    got = hk.waveglow_wn_forward(
        _t(x, torch.float32), _t(cond, BF16), _t(sw, BF16), _t(sb, torch.float32),
        _t(k_all, BF16), _t(rs_w, BF16), _t(rs_b, torch.float32), _t(ew, BF16),
        _t(eb, torch.float32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref.transpose(1, 0, 2), atol=1e-5,
                               rtol=0)


def test_plain_bf16_row_step_matches_jax_pallas():
    """waveflow_row_step's plain bf16 form (through the port's ring) against
    JAX's kernel in interpret mode with its bf16 queues, 4 rows at W = 150
    (not a multiple of 128), kh = 3: log_s and t of every row and the queues
    after the last. The same four bf16 roundings on both sides, the products
    summed in f32: measured log_s and t within 1.2e-7 (values up to 2.7),
    the queues equal. Held to 1e-5, and the queues to one bf16 ulp at their
    largest value (an f32 ulp of another summation order may flip a
    rounding)."""
    rng = np.random.default_rng(5)
    B, W, C, L, kh, kw, halo, Wt = 2, 150, 16, 3, 3, 3, 128, 128
    sw, sb, k_all, rs_w, rs_b, ew, eb = _wn_weights(rng, 1, C, 2, L, kh, kw)
    sw, sb, k_all, rs_w, ew = (_bf16_np(a) for a in (sw, sb, k_all, rs_w, ew))
    cond = _bf16_np(rng.standard_normal((B, L, 2 * C, W)))
    Wp = 2 * halo + -(-W // Wt) * Wt
    b16, f32 = jnp.bfloat16, jnp.float32
    cond_j = jnp.asarray(np.stack([_padded(cond[:, i], halo, Wp)
                                   for i in range(L)]), b16)
    w_j = [jnp.asarray(sw.T, b16), jnp.asarray(sb[:, None], b16),
           jnp.asarray(k_all.transpose(0, 2, 1), b16),
           jnp.asarray(rs_w.transpose(0, 2, 1), b16), jnp.asarray(rs_b, f32),
           jnp.asarray(ew.T, b16), jnp.asarray(eb[:, None], f32)]
    w_t = [_t(sw, BF16), _t(sb, BF16), _t(k_all, BF16), _t(rs_w, BF16),
           _t(rs_b, torch.float32), _t(ew, BF16), _t(eb, torch.float32)]
    queues_j = jnp.zeros((L, kh - 1, C, B * Wp), b16)
    ring = torch.zeros(L, kh, B, C, W, dtype=BF16)
    x_prev = np.zeros((B, W), np.float32)
    for step in range(4):
        x_pad = np.zeros((B, Wp), np.float32)
        x_pad[:, halo:halo + W] = x_prev
        ls_r, t_r, queues_j = j_row_step(
            jnp.asarray(x_pad), queues_j, cond_j, *w_j, L=L, kh=kh, kw=kw, C=C,
            Wt=Wt, halo=halo, W=W)
        log_s, t = hk.waveflow_row_step(_t(x_prev, torch.float32), ring, step,
                                        _t(cond, BF16), *w_t)
        for got, ref in ((log_s, ls_r), (t, t_r)):
            ref = np.asarray(ref)[:, halo:halo + W]
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
        x_prev = rng.standard_normal((B, W)).astype(np.float32)
    q_ref = np.asarray(queues_j.astype(f32)).reshape(L, kh - 1, C, B, Wp)[
        ..., halo:halo + W].transpose(0, 1, 3, 2, 4)
    np.testing.assert_allclose(hk.ring_queues(ring, 4).float().numpy(), q_ref,
                               atol=_ulp(q_ref), rtol=0)


@pytest.mark.parametrize("kernel", ["waveglow_wn_forward", "waveflow_row_step"])
def test_wn_kernels_refuse_dtype_mixes(kernel):
    """A bf16 cond_bc picks the bf16 form, which takes only the dtypes JAX's
    callers pass; an f32 cond_bc takes f32 only."""
    rng = np.random.default_rng(0)
    rows = 1 if kernel == "waveglow_wn_forward" else 2
    w = [_t(a, torch.float32) for a in _wn_weights(rng, 1, 8, 2, 2, rows, 3)]
    cond = torch.zeros(1, 2, 16, 10)
    if kernel == "waveglow_wn_forward":
        call = lambda c, ws, x=torch.zeros(1, 1, 10): hk.waveglow_wn_forward(x, c, *ws)  # noqa: E731
    else:
        def call(c, ws, ring=None):
            ring = torch.zeros(2, 2, 1, 8, 10, dtype=c.dtype) if ring is None else ring
            return hk.waveflow_row_step(torch.zeros(1, 10), ring, 0, c, *ws)
    bf16_w = [t.to(d) for t, d in zip(w, list(hk.WN_BF16_DTYPES[
        "glow_bf16" if rows == 1 else "flow_bf16"].values())[-7:])]
    call(cond.to(BF16), bf16_w)                         # the bf16 form runs
    with pytest.raises(ValueError, match="k_all must be torch.bfloat16"):
        call(cond.to(BF16), bf16_w[:2] + [w[2]] + bf16_w[3:])
    with pytest.raises(ValueError, match="start_w must be torch.float32"):
        call(cond, bf16_w[:1] + w[1:])
    if kernel == "waveflow_row_step":
        with pytest.raises(ValueError, match="ring must be torch.bfloat16"):
            call(cond.to(BF16), bf16_w, torch.zeros(2, 2, 1, 8, 10))


# -- the inverse against JAX's bf16 ---------------------------------------------

@pytest.fixture(scope="module")
def gate():
    """bench_quality_gate's WaveGlow at its CPU widths with its end-layer
    fill, one f32 z, and JAX's inverses of it: bf16 with the Pallas kernel
    (f32 z and z rounded to bf16) and f32 at the highest precision."""
    params = _params(GATE, 0, end_scale=0.002)
    rng = np.random.default_rng(7)
    mel = rng.standard_normal((1, GATE_T_MEL, 160)).astype(np.float32)
    z = rng.standard_normal((1, GATE_T_MEL * 600 // 24, 24)).astype(np.float32)
    j16 = JWaveGlow(JConfig(**GATE, dtype="bfloat16", pallas_row_step=True))
    j32 = JWaveGlow(JConfig(**GATE, pallas_row_step=False))
    inv = lambda m, zz: np.asarray(m.apply(  # noqa: E731
        {"params": params}, zz, jnp.asarray(mel), method=JWaveGlow.inverse
    ).astype(jnp.float32))
    ref = {"f32z": inv(j16, jnp.asarray(z)),
           "bf16z": inv(j16, jnp.asarray(z, jnp.bfloat16))}
    with jax.default_matmul_precision("highest"):
        ref["f32"] = inv(j32, jnp.asarray(z))
    return dict(params=params, mel=mel, z=z, ref=ref,
                port={dt: _port(GATE, params, dt) for dt in ("float32", "bfloat16")})


@pytest.mark.parametrize("z_dtype", ["f32z", "bf16z"])
def test_waveglow_bf16_inverse_matches_jax(gate, z_dtype):
    """The bf16 WaveGlow inverse against JAX's bf16 inverse with its Pallas
    kernel. An f32 z keeps the coupling chain f32 against bf16 log_s and t
    (a flipped bf16 rounding of log_s or t moves the audio by that ulp):
    measured 5.2e-5 at audio up to 3.6, held to 5e-4. A bf16 z rounds every
    coupling step and the 1x1 inverses (XLA may keep f32 between JAX's
    fused bf16 operations): measured one bf16 ulp at the largest value
    (0.0156), mean 1.1e-4; held to two ulps, the mean to 1e-3."""
    port = gate["port"]["bfloat16"]
    z = torch.from_numpy(gate["z"])
    got = port.inverse(z if z_dtype == "f32z" else z.to(BF16),
                       torch.from_numpy(gate["mel"]))
    ref = gate["ref"][z_dtype]
    assert got.dtype == torch.float32 and got.shape == ref.shape
    got = got.numpy()
    np.testing.assert_array_equal(got, _bf16_np(got) if z_dtype == "bf16z" else got)
    if z_dtype == "f32z":
        np.testing.assert_allclose(got, ref, atol=5e-4, rtol=0)
    else:
        np.testing.assert_allclose(got, ref, atol=2 * _ulp(ref), rtol=0)
        assert np.abs(got - ref).mean() < 1e-3


def _gate_metrics(a, b):
    """JAX's WaveGlow gate (bench.py:497-516): multi-window STFT magnitude
    MSE and the mel-cepstral distortion, 48 kHz."""
    a, b = (torch.as_tensor(v, dtype=torch.float32) for v in (a, b))
    mse = 0.0
    for f, h, w in ((1200, 300, 1200), (2400, 600, 2400)):
        bank = STFT(f, h, w, device="cpu")
        ma, _ = bank.transform(a, return_phase=False)
        mb, _ = bank.transform(b, return_phase=False)
        mse += float(torch.mean((ma - mb) ** 2)) / 2
    stft = TacotronSTFT(filter_length=2400, hop_length=600, win_length=2400,
                        n_mel_channels=160, sampling_rate=48000,
                        mel_fmax=16000.0, device="cpu")
    return mse, mcd(stft.mel_spectrogram_np(a[0].numpy()),
                    stft.mel_spectrogram_np(b[0].numpy()))


def test_waveglow_bf16_within_jax_gate_of_f32(gate):
    """bf16 against the port's f32 from the same weights and f32 z, under
    JAX's gate (STFT MSE < 0.05, MCD < 1.0 dB). Measured MSE 3.5e-3, MCD
    0.082 dB; the f32 port is JAX's f32 to 2.8e-6 (held to 2e-5)."""
    mel, z = torch.from_numpy(gate["mel"]), torch.from_numpy(gate["z"])
    a32 = gate["port"]["float32"].inverse(z, mel)
    a16 = gate["port"]["bfloat16"].inverse(z, mel)
    np.testing.assert_allclose(a32.numpy(), gate["ref"]["f32"], atol=2e-5, rtol=0)
    mse, mcd_db = _gate_metrics(a32, a16)
    assert mse < WAVEGLOW_GATE["stft_mse"] and mcd_db < WAVEGLOW_GATE["mcd_db"]


@pytest.fixture(scope="module")
def flow():
    params = _params(TINY_FLOW, 1, end_scale=0.05)
    rng = np.random.default_rng(8)
    T = 96
    mel = rng.standard_normal((2, T // 16, 8)).astype(np.float32)
    z = rng.standard_normal((2, 8, T // 8)).astype(np.float32)
    return dict(params=params, mel=mel, z=z)


def test_waveflow_bf16_inverse_matches_jax(flow):
    """The bf16 WaveFlow inverse (JAX's Pallas path: f32 z and rows, bf16
    queues, the audio rounded to bf16) against JAX's XLA bf16 path, which
    rounds elsewhere (its x_prev and partial sums bf16), and against JAX's
    f32 (end layers at 0.05, so that the 3 flows stay conditioned).
    Measured: 0.0100 from JAX's bf16 (audio up to 3.5, mean 2.0e-3), 0.0103
    from JAX's f32 (mean 1.6e-3): under one bf16 ulp at the largest value,
    the audio's own rounding to bf16 most of it. Held to two ulps there,
    the means to 4e-3."""
    mel, z = (jnp.asarray(flow[k]) for k in ("mel", "z"))
    refs = []
    for dt in ("bfloat16", "float32"):
        jm = JWaveGlow(JConfig(**TINY_FLOW, dtype=dt, pallas_row_step=False))
        with jax.default_matmul_precision("highest"):
            refs.append(np.asarray(jm.apply({"params": flow["params"]}, z, mel,
                                            method=JWaveGlow.inverse
                                            ).astype(jnp.float32)))
    port = _port(TINY_FLOW, flow["params"], "bfloat16")
    got = port.inverse(torch.from_numpy(flow["z"]), torch.from_numpy(flow["mel"]))
    assert got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_array_equal(got, _bf16_np(got))
    for ref in refs:
        np.testing.assert_allclose(got, ref, atol=2 * _ulp(ref), rtol=0)
        assert np.abs(got - ref).mean() < 4e-3


# -- training --------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["waveglow", "waveflow"])
def test_bf16_training_forward_matches_jax(kind):
    """WaveGlow.forward and waveglow_loss in bf16 against JAX's bf16
    training forward (flax's bf16 WN, the audio rounded to bf16, the 1x1
    product in bf16, slogdet and the log_s sums in f32). Both round every
    layer's output to bf16; XLA may keep f32 between fused bf16 operations,
    so z agrees within a bf16 ulp or so. Measured: z 0.0078 (WaveGlow) and
    0.0117 (WaveFlow) at values up to 2.1, under one ulp there; the sum of
    log_s, a sum of bf16 terms, 0.018 and 0.0042 apart; the loss 6e-5 and
    7.3e-4 relative; the 1x1 log-determinants 7e-6. Held to two ulps at the
    largest value, 0.05, rel 5e-3 and 1e-4. The backward reaches every f32
    parameter."""
    cfg = TINY_GLOW if kind == "waveglow" else TINY_FLOW
    params = _params(cfg, 2, end_scale=0.05)
    rng = np.random.default_rng(9)
    T = 96
    audio = (0.5 * rng.standard_normal((2, T))).astype(np.float32)
    mel = rng.standard_normal((2, T // cfg["hop_length"], 8)).astype(np.float32)
    jm = JWaveGlow(JConfig(**cfg, dtype="bfloat16"))
    out_j = jm.apply({"params": params}, jnp.asarray(audio), jnp.asarray(mel))
    loss_j = float(j_waveglow_loss(out_j)[0])
    port = _port(cfg, params, "bfloat16").train()
    out = port(torch.from_numpy(audio), torch.from_numpy(mel))
    loss, parts = waveglow_loss(out)
    assert out["z"].dtype == BF16 and loss.dtype == torch.float32
    z_j = np.asarray(out_j["z"].astype(jnp.float32))
    np.testing.assert_allclose(out["z"].float().detach().numpy(), z_j,
                               atol=2 * _ulp(z_j), rtol=0)
    assert out["log_s_sum"].dtype == torch.float32
    np.testing.assert_allclose(float(out["log_s_sum"].detach()), float(out_j["log_s_sum"]),
                               atol=0.05, rtol=0)
    np.testing.assert_allclose(float(loss.detach()), loss_j, rtol=5e-3, atol=0)
    np.testing.assert_allclose(float(out["logdet_w_sum"].detach()),
                               float(out_j["logdet_w_sum"]), atol=1e-4)
    loss.backward()
    grads = [p.grad for p in port.parameters()]
    assert all(g is not None and g.dtype == torch.float32
               and bool(torch.isfinite(g).all()) for g in grads)


def test_train_command_in_bf16(tmp_path):
    """train --model waveglow --hparams ...,dtype=bfloat16 on the CPU: two
    iterations, a validation through the bf16 inverse, finite losses, and
    the checkpoint's sidecar keeps the dtype for tts."""
    rng = np.random.default_rng(1)
    lines = []
    for i in range(3):
        t = np.arange(8000) / 16000
        audio = (0.3 * np.sin(2 * np.pi * 220 * (i + 1) * t)
                 + 0.01 * rng.standard_normal(len(t))).astype(np.float32)
        save_wav(str(tmp_path / f"v{i}.wav"), audio, 16000)
        lines.append(f"{tmp_path / f'v{i}.wav'}||{i}")
    (tmp_path / "map.txt").write_text("\n".join(lines))
    hparams = ("batch_size=2,segment_length=2560,sampling_rate=16000,"
               "filter_length=512,hop_length=128,win_length=512,"
               "n_mel_channels=16,mel_fmax=8000.0,load_from_disk_dtw=False,"
               "log_every=1,n_layers=2,n_channels=8,upsample_channels=8,"
               "validation_interval=2,checkpoint_interval=2,n_flows=2,"
               "n_group=4,n_early_every=0,upsample_strides=[4,8],"
               "dtype=bfloat16")
    run = tmp_path / "run"
    trainer = cli.main(["train", "--model", "waveglow", "--device", "cpu",
                        "--filelist", str(tmp_path / "map.txt"), "--run_dir",
                        str(run), "--seed", "3", "--iters", "2", "--hparams",
                        hparams])
    assert trainer.state.step == 2 and trainer.state.model.cfg.dtype is BF16
    assert all(p.dtype == torch.float32 for p in trainer.state.model.parameters())
    with open(run / "events.jsonl") as f:
        ev = [json.loads(line) for line in f]
    assert all(np.isfinite(e["loss"]) for e in ev if e["prefix"] == "train")
    val = [e for e in ev if e["prefix"] == "validation"]
    assert val and all(np.isfinite(e["val_MSE"]) for e in val)
    meta = json.loads((run / "checkpoint_2.json").read_text())
    assert meta["model_config"]["dtype"] == "bfloat16"


# -- serving ---------------------------------------------------------------------

# bench_quality_gate's CPU Tacotron2 (bench.py:389-401), prenet dropout 0
TACO = dict(
    n_symbols=N_SYMBOLS, symbols_embedding_dim=16, n_speakers=4,
    speaker_embedding_dim=8, encoder_speaker_embed_dim=4,
    encoder_conv_hidden_dim=16, encoder_lstm_dim=16, encoder_n_convolutions=1,
    torchmoji_dim=8, torchmoji_crushed_dim=4, memory_bottleneck_dim=16,
    prenet_dim=8, attention_rnn_dim=16, decoder_rnn_dim=16,
    second_decoder_rnn_dim=0, attention_dim=8, windowed_attention_range=4,
    postnet_embedding_dim=16, postnet_n_convolutions=2,
    postnet_residual_connections=0, p_prenet_dropout=0.0)
SERVE = {"waveglow": dict(n_mel_channels=80, n_flows=2, n_group=8,
                          n_early_every=0, n_layers=2, n_channels=8,
                          hop_length=256, upsample_strides=(32,),
                          upsample_channels=8, sampling_rate=22050),
         "waveflow": dict(n_mel_channels=80, n_flows=2, n_group=8,
                          channel_mixing="permuteheight", n_layers=2,
                          n_channels=8, kernel_size_h=2, hop_length=256,
                          upsample_strides=(32,), upsample_channels=8,
                          sampling_rate=22050)}
T2S_CFG = dict(batch_size=2, max_attempts=1, step_buckets=(64,),
               max_decoder_steps=64, frames_per_char=2.0, gate_threshold=2.0)
HPARAMS = ("batch_size=2,max_text_len=64,frames_per_char=2.0,step_buckets="
           "[64],max_decoder_steps=64,gate_threshold=2.0")


def _lists(cfg):
    return {k: list(x) if isinstance(x, tuple) else x for k, x in cfg.items()}


@pytest.mark.parametrize("kind", sorted(SERVE))
def test_t2s_denoiser_and_server_with_bf16_flow_vocoder(kind, tmp_path):
    """T2S over a bf16 Tacotron2 with a bf16 flow vocoder as its stochastic
    vocoder_fn and a Denoiser built from it: the denoiser's bias audio and
    its STFT stay f32 (JAX's denoiser casts the same way), the request's
    audio is finite f32 within a hop of the decoded length; then the
    server's handle_tts."""
    torch.manual_seed(0)
    taco = Tacotron2(Tacotron2Config(**TACO, dtype="bfloat16"), device="cpu")
    glow = _port(SERVE[kind], _params(SERVE[kind], 3, end_scale=0.05), "bfloat16")
    vocoder_fn, infer = make_flow_vocoder_fn(glow, sigma=0.6)
    mel = torch.randn(1, 4, 80, generator=torch.Generator().manual_seed(1))
    audio = vocoder_fn(mel)
    assert audio.dtype == torch.float32 and audio.shape == (1, 4 * 256)
    np.testing.assert_array_equal(audio.numpy(), _bf16_np(audio.numpy()))
    denoiser = Denoiser(infer, sampling_rate=22050, n_mel_channels=80,
                        device="cpu")
    assert denoiser.bias_spec.dtype == torch.float32
    assert denoiser(audio).dtype == torch.float32
    t2s = T2S(T2SConfig(**T2S_CFG), taco, {"alice": 0, "bob": 2},
              vocoder_fn=vocoder_fn, denoiser_fn=denoiser, sample_rate=22050,
              hop_length=256, device="cpu")
    res = t2s.infer("Hello world, the quick fox!", speaker=["alice"], seed=1,
                    denoise_strength=0.1)
    assert res["audio"].dtype == np.float32 and np.isfinite(res["audio"]).all()
    # the denoiser's overlap-add trims to whole STFT hops
    assert abs(len(res["audio"]) - int(res["mel_lengths"].sum()) * 256) <= 256
    stats, wav = handle_tts(ModelRegistry({"bf16": t2s}, "bf16"),
                            {"text": "Hello world.", "speaker": "bob"}.get,
                            str(tmp_path))
    assert wav and stats["audio_seconds"] > 0


def test_tts_command_bf16_with_flow_vocoder_and_denoiser(tmp_path, capsys):
    """tts --hparams ...,dtype=bfloat16 with a WaveGlow checkpoint and
    --denoiser: both models load in bf16 (f32 parameters) and the WAV holds
    the decoded length within a hop."""
    torch.manual_seed(0)
    audio = {"sampling_rate": 22050, "hop_length": 256, "n_mel_channels": 80}
    save_checkpoint(str(tmp_path / "taco"), {"state_dict": Tacotron2(
        Tacotron2Config(**TACO), device="cpu").state_dict()},
        {"model": "tacotron2", "model_config": _lists(TACO),
         "speaker_ids": {"alice": 0}, "audio": audio})
    glow = _port(SERVE["waveglow"], _params(SERVE["waveglow"], 4, end_scale=0.05),
                 "float32")
    save_checkpoint(str(tmp_path / "glow"), {"state_dict": glow.state_dict()},
                    {"model": "waveglow", "audio": audio,
                     "model_config": _lists(SERVE["waveglow"])})
    kind, model, _ = cli._vocoder_model(str(tmp_path / "glow"),
                                        {"dtype": "bfloat16"}, device="cpu")
    assert kind == "waveglow" and model.cfg.dtype is BF16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    out = str(tmp_path / "b.wav")
    cli.main(["tts", "--checkpoint", str(tmp_path / "taco"), "--vocoder",
              str(tmp_path / "glow"), "--denoiser", "--text", "Hello world.",
              "--out", out, "--max_attempts", "1", "--denoise_strength", "0.1",
              "--device", "cpu", "--hparams", HPARAMS + ",dtype=bfloat16"])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    wav, sr = load_wav(out)
    assert sr == 22050 and abs(len(wav) - 64 * 256) <= 256
    assert stats["audio_seconds"] > 0
    assert np.isfinite(wav).all()


def _glow_bf16():
    return WaveGlow(WaveGlowConfig(**TINY_GLOW, dtype="bfloat16"), device="cpu")


# what stays in f32, each naming its later slice
REFUSALS = {
    "sp_forward": lambda: _glow_bf16()(torch.zeros(1, 96), torch.zeros(1, 4, 8),
                                       sp=object()),
    "sp_inverse": lambda: _glow_bf16().inverse(torch.zeros(1, 12, 8),
                                               torch.zeros(1, 4, 8), sp=object()),
    "sp_infer": lambda: _glow_bf16().infer(torch.zeros(1, 4, 8), sp=object()),
    "tp": lambda: shard_model(_glow_bf16(), WAVEGLOW_TP_RULES, tp=None),
    "untts": lambda: UnTTS(UnTTSConfig(dtype=BF16), device="cpu"),
    "export": lambda: cli.main(["export", "--device", "cpu", "--hparams",
                                "dtype=bfloat16", "-o", "unused.npz"]),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_what_stays_f32_refuses_bf16(case):
    with pytest.raises(NotImplementedError,
                       match="bfloat16 comes with a later slice.*float32"):
        REFUSALS[case]()

"""The PyTorch port's flow vocoders (WaveGlow and WaveFlow inverse), STFT and
spectral denoiser against the JAX package on the CPU, at tiny sizes.

Inputs come from ``numpy.random.default_rng``; weights are a JAX init plus
noise (the init's end layers are zero, which would make every flow the
identity), carried across with ``waveglow_from_jax``; the latent z is the JAX
forward's output and is passed in on both sides. On the CPU the port's kernel
entries take their plain versions; JAX runs its stock path and, in one case
per kernel, its Pallas path in interpret mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cookietts_tpu.audio.stft import STFT as JSTFT
from cookietts_tpu.convert.waveglow_torch import convert_waveglow_state_dict
from cookietts_tpu.models.denoiser import Denoiser as JDenoiser
from cookietts_tpu.models.waveglow import GATED_UNITS as J_GATED_UNITS
from cookietts_tpu.models.waveglow import UpsampleNet as JUpsampleNet
from cookietts_tpu.models.waveglow import WaveGlow as JWaveGlow
from cookietts_tpu.models.waveglow import WaveGlowConfig as JConfig
from cookietts_tpu.models.waveglow import permute_height_order as j_order

from cookietts_tpu_torch.audio.stft import STFT
from cookietts_tpu_torch.convert.from_jax import waveglow_from_jax
from cookietts_tpu_torch.models.denoiser import Denoiser
from cookietts_tpu_torch.models.waveglow import (GATED_UNITS, UpsampleNet,
                                                 WaveGlow, WaveGlowConfig,
                                                 permute_height_order)
from test_torch_threads import _one_thread  # noqa: F401


BASE = dict(n_mel_channels=8, n_layers=3, n_channels=16, upsample_channels=8)
GLOW = dict(BASE, n_flows=4, n_group=8, n_early_every=2, n_early_size=2,
            hop_length=24, upsample_strides=(3,))
FLOW = dict(BASE, n_flows=3, n_group=8, channel_mixing="permuteheight",
            hop_length=16, upsample_strides=(2,))
CASES = {
    # WaveGlow: early outputs, both couplings, both upsamplers, speakers
    "glow-first-early": (GLOW, 192),
    "glow-second-speakers": (dict(GLOW, hop_length=40, upsample_strides=(5,),
                                  couple_transform="second", n_speakers=3,
                                  speaker_embed_dim=4), 160),
    "glow-single-second": (dict(GLOW, n_early_every=0, hop_length=16,
                                upsample_mode="single", upsample_win_length=64,
                                couple_transform="second"), 128),
    "glow-single-first-early": (dict(GLOW, hop_length=16, upsample_mode="single",
                                     upsample_win_length=48), 128),
    "glow-two-stage-upsampler": (dict(GLOW, hop_length=120,
                                      upsample_strides=(5, 3)), 240),
    "glow-other-unit": (dict(GLOW, gated_unit="TTU"), 96),
    # WaveFlow: kh 1-3, a width (T / 8) that is not a multiple of 128
    "flow-kh1": (dict(FLOW, kernel_size_h=1), 144),
    "flow-kh2": (dict(FLOW, kernel_size_h=2), 144),
    "flow-kh3": (dict(FLOW, kernel_size_h=3), 2 * 16 * 67),
    "flow-stride75-speakers": (dict(FLOW, n_flows=2, n_group=4, hop_length=300,
                                    upsample_strides=(75,), n_speakers=2,
                                    speaker_embed_dim=4), 600),
    "flow-other-unit": (dict(FLOW, gated_unit="GSIU"), 96),
}
# one case per TPU kernel against the JAX Pallas path in interpret mode
PALLAS_CASES = {
    "glow-pallas": (dict(GLOW, hop_length=8, upsample_strides=(1,),
                         pallas_row_tile=256), 128),
    "flow-pallas": (dict(FLOW, pallas_row_tile=256), 64),
}


def noisy(params, rng, scale=0.1):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(a.shape).astype(
            np.float32), params)


def build(kw, T, B=2, seed=0):
    """(JAX model, its params, port model, audio, mel, speaker ids, z)."""
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(seed)
    jcfg = JConfig(memory_efficient=False, **kw)
    jm = JWaveGlow(jcfg)
    audio = rng.standard_normal((B, T)).astype(np.float32)
    mel = rng.standard_normal((B, T // jcfg.hop_length,
                               jcfg.n_mel_channels)).astype(np.float32)
    spk = (rng.integers(0, jcfg.n_speakers, (B,)) if jcfg.n_speakers else None)
    params = noisy(jm.init(jax.random.PRNGKey(seed), jnp.asarray(audio),
                           jnp.asarray(mel))["params"], rng)
    z = np.asarray(jm.apply({"params": params}, jnp.asarray(audio),
                            jnp.asarray(mel), spk)["z"])
    port = WaveGlow(WaveGlowConfig(**kw), device="cpu")
    port.load_state_dict(waveglow_from_jax(params, jcfg))
    return jm, params, port, audio, mel, spk, z


@pytest.mark.parametrize("case", list(CASES))
def test_inverse_matches_jax(case):
    kw, T = CASES[case]
    jm, params, port, audio, mel, spk, z = build(kw, T)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(z),
                              jnp.asarray(mel), spk, method=JWaveGlow.inverse))
    got = port.inverse(torch.from_numpy(z), torch.from_numpy(mel),
                       None if spk is None else torch.from_numpy(spk)).numpy()
    assert got.shape == ref.shape == (2, T)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    # and the inverse undoes the JAX forward
    np.testing.assert_allclose(got, audio, atol=1e-4, rtol=0)


@pytest.mark.parametrize("case", list(PALLAS_CASES))
def test_inverse_matches_jax_pallas_path(case):
    kw, T = PALLAS_CASES[case]
    jm, params, port, audio, mel, spk, z = build(kw, T)
    pallas = JWaveGlow(dataclasses.replace(jm.cfg, pallas_row_step=True))
    ref = np.asarray(pallas.apply({"params": params}, jnp.asarray(z),
                                  jnp.asarray(mel), method=JWaveGlow.inverse))
    got = port.inverse(torch.from_numpy(z), torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("k", [0, 3])
def test_wn_matches_jax(k):
    """One flow's WN (through waveglow_wn_forward) against the JAX module,
    before and after the early split (4 and 3 input channels)."""
    jm, params, port, *_ = build(GLOW, 192)
    rng = np.random.default_rng(k)
    n_in, T = port.WN[k].start.in_channels, 50
    x = rng.standard_normal((2, T, n_in)).astype(np.float32)
    cond = rng.standard_normal((2, T, 8)).astype(np.float32)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(cond),
                              method=lambda m, x, c: m.wn[k](x, c)))
    log_s, t = port.WN[k](torch.from_numpy(x).transpose(1, 2),
                          torch.from_numpy(cond).transpose(1, 2))
    got = torch.cat([log_s, t], dim=1).transpose(1, 2).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kh", [1, 2, 3])
def test_wn2d_row_steps_match_jax(kh):
    """WN2D.row_step over more rows than the ring has slots against the JAX
    module's row_step_fused (its partial sums) and row_step (its queues)."""
    jm, params, port, *_ = build(dict(FLOW, kernel_size_h=kh, n_flows=1), 64)
    rng = np.random.default_rng(kh)
    B, W, L, C = 2, 21, 3, 16
    cond = rng.standard_normal((B, W, 8)).astype(np.float32)
    run = lambda fn, *a: jm.apply({"params": params}, *a, method=fn)
    cond_all = run(lambda m, c: m.wn[0].precompute_cond(c), jnp.asarray(cond))
    partials = jnp.zeros((L, kh - 1, B, W, 2 * C), jnp.float32)
    queues = jnp.zeros((L, B, kh - 1, W, C), jnp.float32)
    wn = port.WN[0]
    ring = wn.init_ring(B, W)
    cond_bc = wn.cond_bc(torch.from_numpy(cond).transpose(1, 2))
    for step in range(kh + 2):
        x_prev = rng.standard_normal((B, W)).astype(np.float32)
        st, partials = run(lambda m, *a: m.wn[0].row_step_fused(*a), partials,
                           jnp.asarray(x_prev[..., None]), cond_all)
        st_q, queues = run(lambda m, *a: m.wn[0].row_step(*a), queues,
                           jnp.asarray(x_prev[..., None]), cond_all)
        with torch.no_grad():
            log_s, t = wn.row_step(torch.from_numpy(x_prev), ring, step, cond_bc)
        got = torch.stack([log_s, t], dim=-1).numpy()
        np.testing.assert_allclose(got, np.asarray(st), atol=1e-5, rtol=0)
        np.testing.assert_allclose(got, np.asarray(st_q), atol=1e-5, rtol=0)
    from cookietts_tpu_torch.ops.hopper_kernels import ring_queues
    np.testing.assert_allclose(            # [L, kh-1, B, C, W] vs [L, B, kh-1, W, C]
        ring_queues(ring, kh + 2).numpy(),
        np.asarray(queues).transpose(0, 2, 1, 4, 3), atol=1e-5, rtol=0)


@pytest.mark.parametrize("stride", [2, 3, 5, 75])
def test_upsampler_matches_flax_same_padding(stride):
    """flax's "SAME" transposed conv (kernel 2s, stride s): output length
    T * s and the same offset, for odd strides too."""
    rng = np.random.default_rng(stride)
    mel = rng.standard_normal((2, 7, 6)).astype(np.float32)
    jn = JUpsampleNet((stride, 2), channels=5)
    params = noisy(jn.init(jax.random.PRNGKey(0), jnp.asarray(mel))["params"],
                   rng)
    ref = np.asarray(jn.apply({"params": params}, jnp.asarray(mel)))
    net = UpsampleNet(6, (stride, 2), 5)
    sd = waveglow_from_jax({"upsample": params},
                           JConfig(n_flows=0, upsample_strides=(stride, 2)))
    net.load_state_dict({k[len("upsample."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = net(torch.from_numpy(mel).transpose(1, 2)).transpose(1, 2).numpy()
    assert got.shape == ref.shape == (2, 7 * stride * 2, 5)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("unit", sorted(J_GATED_UNITS))
def test_gated_units_match_jax(unit):
    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal((4, 16)).astype(np.float32) for _ in range(2))
    ref = np.asarray(J_GATED_UNITS[unit](jnp.asarray(a), jnp.asarray(b)))
    got = GATED_UNITS[unit](torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-6, rtol=1e-5)


def test_gated_units_cover_the_jax_table():
    assert sorted(GATED_UNITS) == sorted(J_GATED_UNITS)


@pytest.mark.parametrize("kind", ["reverse", "bipartize"])
def test_permute_height_order_matches_jax(kind):
    for k in range(3):
        np.testing.assert_array_equal(permute_height_order(8, kind, k),
                                      j_order(8, kind, k))


def test_vanilla_state_dict_round_trips_through_the_jax_converter():
    """upsample_mode='single', couple_transform='second': a dump of the port's
    weights goes back through convert_waveglow_state_dict to equal params."""
    kw, T = CASES["glow-single-second"]
    kw = dict(kw, n_early_every=2)
    jm, params, port, *_ = build(kw, T)
    dump = {k: v.numpy() for k, v in port.state_dict().items()}
    back, hints = convert_waveglow_state_dict(dump)
    flat = lambda tree: {jax.tree_util.keystr(p): np.asarray(a) for p, a in
                         jax.tree_util.tree_leaves_with_path(tree)}
    want, got = flat(params), flat(back)
    assert sorted(got) == sorted(want)
    for key, a in want.items():
        np.testing.assert_allclose(got[key].reshape(a.shape), a, atol=1e-7,
                                   rtol=0, err_msg=key)
    for name in ("n_flows", "n_group", "n_early_every", "n_early_size",
                 "n_mel_channels", "n_layers", "n_channels", "kernel_size",
                 "upsample_win_length", "upsample_mode", "couple_transform"):
        assert hints[name] == getattr(jm.cfg, name), name


@pytest.mark.parametrize("mixing", ["1x1conv", "permuteheight"])
def test_infer_draws_z_from_the_generator(mixing):
    kw = GLOW if mixing == "1x1conv" else FLOW
    port = WaveGlow(WaveGlowConfig(**kw), device="cpu")
    for wn in port.WN:      # non-zero end layers, or audio = z
        torch.nn.init.normal_(wn.end.weight, std=0.05)
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 3, 8)).astype(np.float32))
    gen = lambda seed: torch.Generator().manual_seed(seed)
    a, b, c = (port.infer(mel, gen(s), sigma=0.7) for s in (1, 1, 2))
    assert a.shape == (2, 3 * kw["hop_length"]) and bool(torch.isfinite(a).all())
    assert torch.equal(a, b) and not torch.equal(a, c)
    n = 3 * kw["hop_length"] // 8
    z = torch.zeros((2, 8, n) if mixing == "permuteheight" else (2, n, 8))
    assert torch.equal(port.infer(mel, z=z), port.inverse(z, mel))
    assert torch.equal(port.infer(mel, gen(5), sigma=0.0), port.inverse(z, mel))


def test_unported_options_raise():
    """bf16 builds and inverts (tests/test_torch_bf16_flows.py); only its
    sequence-parallel forms refuse, in float32's name."""
    port = WaveGlow(WaveGlowConfig(**GLOW, dtype=torch.bfloat16), device="cpu")
    n = 3 * GLOW["hop_length"] // 8
    with pytest.raises(NotImplementedError, match="float32"):
        port.inverse(torch.zeros(1, n, 8), torch.zeros(1, 3, BASE["n_mel_channels"]),
                     sp=object())
    with pytest.raises(ValueError, match="hop_length"):
        WaveGlow(WaveGlowConfig(**dict(GLOW, hop_length=25)), device="cpu")


def test_iso226_deemphasis_matches_jax(monkeypatch):
    """ISO226.inverse, and WaveGlow.infer with iso226_deemphasis at a given
    z, against JAX's ISO226 and its infer (the inverse, then the
    de-emphasis) at the STFT tests' tolerances. Both sides build the
    same float64 pseudo-inverse of the 2400-point DFT basis; it is computed
    once here."""
    from cookietts_tpu.audio.iso226 import ISO226 as JISO226
    from cookietts_tpu_torch.audio.iso226 import ISO226
    pinv, memo = np.linalg.pinv, {}

    def cached_pinv(a, *args, **kwargs):
        key = (a.shape, hash(a.tobytes()))
        if key not in memo:
            memo[key] = pinv(a, *args, **kwargs)
        return memo[key]

    monkeypatch.setattr(np.linalg, "pinv", cached_pinv)
    rng = np.random.default_rng(3)
    audio = (0.3 * rng.standard_normal((2, 3000))).astype(np.float32)
    for kw in ({"filter_length": 256, "hop_length": 64, "win_length": 256},
               {}):
        ref = np.asarray(JISO226(sampling_rate=22050, **kw).inverse(
            jnp.asarray(audio)))
        got = ISO226(sampling_rate=22050, device="cpu", **kw).inverse(
            torch.from_numpy(audio)).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)

    kw = dict(GLOW, iso226_deemphasis=True)
    jm, params, port, audio, mel, spk, z = build(kw, 3000)
    ref = JISO226(sampling_rate=jm.cfg.sampling_rate).inverse(
        jm.apply({"params": params}, jnp.asarray(z), jnp.asarray(mel),
                 method=JWaveGlow.inverse))
    got = port.infer(torch.from_numpy(mel), z=torch.from_numpy(z)).numpy()
    assert got.shape == (2, 3000)
    # the de-emphasis lifts this flow's audio to |20|: the STFT round trip's
    # tolerance (test_stft_round_trip_reconstructs_audio)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-4, rtol=0)


def test_tpu_knobs_are_accepted_and_ignored():
    kw, T = CASES["flow-kh2"]
    _, _, port, _, mel, _, z = build(kw, T)
    other = WaveGlow(WaveGlowConfig(**kw, pallas_row_step=False,
                                    pallas_row_tile=128, inverse_height_unroll=1,
                                    fused_height_inverse=False,
                                    memory_efficient=False), device="cpu")
    other.load_state_dict(port.state_dict())
    assert torch.equal(other.inverse(z, mel), port.inverse(z, mel))


# -- STFT and the spectral denoiser -------------------------------------------

STFT_SHAPES = [(64, 16, 64), (100, 25, 80)]


@pytest.mark.parametrize("shape", STFT_SHAPES, ids=str)
def test_stft_transform_matches_jax(shape):
    audio = np.random.default_rng(0).standard_normal((2, 500)).astype(np.float32)
    mag_r, phase_r = JSTFT(*shape).transform(jnp.asarray(audio))
    mag, phase = STFT(*shape, device="cpu").transform(torch.from_numpy(audio))
    np.testing.assert_allclose(mag.numpy(), np.asarray(mag_r), atol=2e-5, rtol=0)
    # the phase of a near-zero bin is ill-conditioned: compare it as a vector
    np.testing.assert_allclose((mag * torch.cos(phase)).numpy(),
                               np.asarray(mag_r * jnp.cos(phase_r)), atol=2e-5)
    np.testing.assert_allclose((mag * torch.sin(phase)).numpy(),
                               np.asarray(mag_r * jnp.sin(phase_r)), atol=2e-5)


@pytest.mark.parametrize("shape", STFT_SHAPES, ids=str)
def test_stft_inverse_matches_jax(shape):
    rng = np.random.default_rng(1)
    cutoff = shape[0] // 2 + 1
    mag = np.abs(rng.standard_normal((2, 21, cutoff))).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, (2, 21, cutoff)).astype(np.float32)
    ref = np.asarray(JSTFT(*shape).inverse(jnp.asarray(mag), jnp.asarray(phase)))
    got = STFT(*shape, device="cpu").inverse(torch.from_numpy(mag),
                                             torch.from_numpy(phase)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)


def test_stft_round_trip_reconstructs_audio():
    audio = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 640)).astype(np.float32))
    np.testing.assert_allclose(STFT(64, 16, 64, device="cpu")(audio).numpy(),
                               audio.numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("strength", [0.1, 1.0])
def test_denoiser_matches_jax(strength):
    """The same bias audio on both sides (the infer_fn returns it)."""
    rng = np.random.default_rng(3)
    bias = (0.05 * rng.standard_normal((1, 20 * 30))).astype(np.float32)
    audio = rng.standard_normal((2, 900)).astype(np.float32)
    kw = dict(sampling_rate=4000, n_mel_channels=8)
    seen = {}

    def infer_fn(mel, generator):
        seen["mel"], seen["generator"] = mel, generator
        return torch.from_numpy(bias)

    ref = JDenoiser(lambda mel, key: jnp.asarray(bias), **kw)(
        jnp.asarray(audio), strength)
    den = Denoiser(infer_fn, **kw, device="cpu")
    got = den(torch.from_numpy(audio), strength)
    assert seen["mel"].shape == (1, 20, 8) and float(seen["mel"].std()) < 0.05
    assert isinstance(seen["generator"], torch.Generator)
    np.testing.assert_allclose(den.bias_spec.numpy(), np.asarray(
        JDenoiser(lambda mel, key: jnp.asarray(bias), **kw).bias_spec), atol=2e-5)
    assert got.shape == tuple(ref.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5, rtol=0)


def test_denoiser_refuses_non_finite_bias():
    with pytest.raises(ValueError, match="non-finite"):
        Denoiser(lambda mel, g: torch.full((1, 600), float("nan")),
                 sampling_rate=4000, n_mel_channels=8, device="cpu")

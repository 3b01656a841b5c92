"""The port's fused feature frontend (audio/features.py), its processing and
DSP helpers (audio/processing.py, audio/dsp.py) and Griffin-Lim against the
JAX package on the CPU, on the same seeded inputs.

Tolerances (chip_smoke.py phase 15's): mel max abs 1e-3, loudness 1e-3 LU,
energy rel 1e-4; f0 and the voicing flags agree on at least 99% of frames
(an argmax over the autocorrelation can flip on a near tie between FFT
libraries). Griffin-Lim with JAX's initial angles within 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_threads import _one_thread  # noqa: F401

from cookietts_tpu.audio import dsp as jdsp
from cookietts_tpu.audio import features as jfeat
from cookietts_tpu.audio import processing as jproc
from cookietts_tpu.audio.stft import TacotronSTFT as JaxSTFT
from cookietts_tpu.data.audio_io import estimate_f0_autocorr
from cookietts_tpu_torch.audio import dsp, features, processing
from cookietts_tpu_torch.audio.stft import TacotronSTFT

SR = 22050
FILTER, HOP = 1024, 256


def _speech(seconds, f0, seed, amp=0.3, silence=0.15):
    """Harmonics with vibrato, noise, and ``silence`` s at both ends."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    inst = f0 * (1 + 0.05 * np.sin(2 * np.pi * 5 * t))
    phase = 2 * np.pi * np.cumsum(inst) / SR
    x = sum(np.sin(k * phase) / k for k in range(1, 6))
    x = amp * x / np.abs(x).max() + 0.01 * rng.standard_normal(t.shape)
    x *= np.clip(np.minimum(t, t[-1] - t) / 0.05, 0, 1)
    sil = np.zeros(int(silence * SR))
    return np.concatenate([sil, x, sil]).astype(np.float32)


@pytest.fixture(scope="module")
def batch():
    """Three clips padded to one bucket: 1.2 s, 0.8 s and 0.25 s (shorter
    than a 0.4 s loudness block), each row's pad its own reflection."""
    clips = [_speech(0.9, 140.0, 0), _speech(0.5, 230.0, 1, amp=0.05),
             _speech(0.25, 180.0, 2, silence=0.0)]
    T = max(len(c) for c in clips) + 600
    audio = np.zeros((3, T), np.float32)
    for j, c in enumerate(clips):
        audio[j, :len(c)] = c
        m = min(FILTER, len(c) - 1, T - len(c))
        audio[j, len(c):len(c) + m] = c[::-1][1:1 + m]
    return clips, audio, np.array([len(c) for c in clips], np.int32)


@pytest.fixture(scope="module")
def jax_side(batch):
    """Every JAX output the tests compare with, computed once."""
    clips, audio, lengths = batch
    a = jnp.asarray(audio)
    out = {}
    for center in (False, True):
        f0, voiced = jfeat.estimate_f0(a, SR, hop_length=HOP,
                                       frame_length=FILTER, center=center)
        out["f0", center] = (np.asarray(f0), np.asarray(voiced))
    out["lufs"] = np.asarray(jfeat.measure_loudness(a, sr=SR))
    out["lufs_masked"] = np.asarray(
        jfeat.measure_loudness(a, jnp.asarray(lengths), sr=SR))
    out["lufs_short"] = np.asarray(jfeat.measure_loudness(a[:, :6000], sr=SR))
    stft = JaxSTFT(FILTER, HOP, FILTER, 40, SR, 0.0, 8000.0)
    for lufs in (-27.0, None):
        fn = jfeat.fused_frontend(stft, sr=SR, target_lufs=lufs)
        out["fused", lufs] = {k: np.asarray(v)
                              for k, v in fn(a, jnp.asarray(lengths)).items()}
    small = JaxSTFT(256, 64, 256, 20, SR, 0.0, 8000.0)
    mag, _ = small.stft.transform(jnp.asarray(clips[0][None, :6400]))
    key = jax.random.PRNGKey(3)
    out["gl_mag"] = np.array(mag)
    out["gl_angles"] = np.array(jax.random.uniform(
        key, mag.shape, minval=-np.pi, maxval=np.pi, dtype=mag.dtype))
    out["gl"] = np.asarray(small.griffin_lim(mag, n_iters=30, key=key))
    return out


def _agree(a, b):
    return float(np.mean(np.asarray(a) == np.asarray(b)))


@pytest.mark.parametrize("center", [False, True])
def test_estimate_f0_matches_jax(batch, jax_side, center):
    _, audio, _ = batch
    f0, voiced = features.estimate_f0(torch.from_numpy(audio), SR,
                                      hop_length=HOP, frame_length=FILTER,
                                      center=center)
    jf0, jvoiced = jax_side["f0", center]
    assert f0.shape == jf0.shape
    n = 1 + audio.shape[1] // HOP if center else \
        1 + (audio.shape[1] - FILTER) // HOP
    assert f0.shape[1] == n
    close = np.isclose(f0.numpy(), jf0, rtol=1e-5, atol=1e-3)
    assert close.mean() >= 0.99, close.mean()
    assert _agree(voiced.numpy(), jvoiced) >= 0.99
    assert jvoiced.any() and not jvoiced.all()


def test_estimate_f0_matches_host_anchor(batch):
    """Start-aligned frames are audio_io.estimate_f0_autocorr's."""
    clips, _, _ = batch
    for clip in clips[:2]:
        f0, voiced = features.estimate_f0(torch.from_numpy(clip[None]), SR,
                                          hop_length=HOP, frame_length=FILTER)
        hf0, hvoiced = estimate_f0_autocorr(clip, SR, hop_length=HOP,
                                            frame_length=FILTER)
        assert np.isclose(f0[0].numpy(), hf0, rtol=1e-4, atol=1e-3).mean() \
            >= 0.99
        assert _agree(voiced[0].numpy(), hvoiced) >= 0.99


def test_frame_clamps_a_clip_shorter_than_a_frame():
    x = torch.arange(10.0)[None]
    framed = features._frame(x, 16, 4)
    assert framed.shape == (1, 1, 16)
    assert framed[0, 0, -1] == 9 and framed[0, 0, 9] == 9
    np.testing.assert_array_equal(
        features._frame(torch.arange(40.0)[None], 16, 4).numpy(),
        np.asarray(jfeat._frame(jnp.arange(40.0)[None], 16, 4)))


@pytest.mark.parametrize("branch", ["whole", "masked", "shorter_than_block"])
def test_measure_loudness_matches_jax(batch, jax_side, branch):
    """Every branch: blocks over the whole row; the length mask, with the
    0.25 s clip keeping block 0 alone (none of its blocks fits); and
    T < block."""
    _, audio, lengths = batch
    a = torch.from_numpy(audio)
    got, want = {
        "whole": (lambda: features.measure_loudness(a, sr=SR), "lufs"),
        "masked": (lambda: features.measure_loudness(
            a, torch.from_numpy(lengths), sr=SR), "lufs_masked"),
        "shorter_than_block": (lambda: features.measure_loudness(
            a[:, :6000], sr=SR), "lufs_short")}[branch]
    got = got().numpy()
    assert lengths[2] < int(0.4 * SR) <= audio.shape[1]
    np.testing.assert_allclose(got, jax_side[want], atol=1e-3, rtol=0)
    assert np.all(np.isfinite(got))


def test_measure_loudness_matches_bs1770_host(batch):
    clips, _, _ = batch
    for clip in clips[:2]:
        dev = float(features.measure_loudness(torch.from_numpy(clip[None]),
                                              sr=SR)[0])
        assert abs(dev - dsp.measure_loudness_lufs(clip, SR)) < 0.1


@pytest.mark.parametrize("target_lufs", [-27.0, None])
def test_fused_frontend_matches_jax(batch, jax_side, target_lufs):
    _, audio, lengths = batch
    stft = TacotronSTFT(FILTER, HOP, FILTER, 40, SR, 0.0, 8000.0,
                        device="cpu")
    fn = features.fused_frontend(stft, sr=SR, target_lufs=target_lufs,
                                 device="cpu")
    got = {k: v.numpy() for k, v in fn(audio, lengths).items()}
    want = jax_side["fused", target_lufs]
    assert set(got) == set(want) == {"audio", "loudness", "mel", "energy",
                                     "f0", "voiced"}
    for k in want:
        assert got[k].shape == want[k].shape, k
    assert got["mel"].shape[1] == 1 + audio.shape[1] // HOP
    np.testing.assert_allclose(got["mel"], want["mel"], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["loudness"], want["loudness"], atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(got["energy"], want["energy"], rtol=1e-4,
                               atol=1e-9)
    np.testing.assert_allclose(got["audio"], want["audio"], rtol=1e-4,
                               atol=1e-6)
    assert np.isclose(got["f0"], want["f0"], rtol=1e-5, atol=1e-3).mean() \
        >= 0.99
    assert _agree(got["voiced"], want["voiced"]) >= 0.99


def test_fused_frontend_refuses_an_stft_on_another_device(monkeypatch):
    stft = TacotronSTFT(256, 64, 256, 8, SR, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="lives on cpu"):
        features.fused_frontend(stft, sr=SR, device="cuda")


def test_processing_matches_jax():
    rng = np.random.default_rng(5)
    x = np.abs(rng.standard_normal((3, 7))).astype(np.float32)
    x[0, 0] = 1e-9
    np.testing.assert_allclose(
        processing.dynamic_range_compression(torch.from_numpy(x)).numpy(),
        np.asarray(jproc.dynamic_range_compression(jnp.asarray(x))),
        rtol=1e-6)
    np.testing.assert_allclose(
        processing.dynamic_range_decompression(torch.from_numpy(x),
                                               C=2.0).numpy(),
        np.asarray(jproc.dynamic_range_decompression(jnp.asarray(x), C=2.0)),
        rtol=1e-6)
    np.testing.assert_array_equal(processing.periodic_hann(400),
                                  jproc.periodic_hann(400))
    np.testing.assert_array_equal(processing.pad_center(np.ones(5), 12),
                                  jproc.pad_center(np.ones(5), 12))
    for args in (("hann", 9, 64, 256, 256), ("hann", 3, 256, 200, 256)):
        got = processing.window_sumsquare(*args)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jproc.window_sumsquare(*args))


def test_dsp_matches_jax(batch):
    clip = batch[0][0]
    pairs = [
        (dsp.resample(clip, SR, 16000), jdsp.resample(clip, SR, 16000)),
        (dsp.butter_highpass(clip, SR, 150.0),
         jdsp.butter_highpass(clip, SR, 150.0)),
        (dsp.dc_offset_removal(clip + 0.1), jdsp.dc_offset_removal(clip + 0.1)),
        (dsp.trim_silence(clip, SR), jdsp.trim_silence(clip, SR)),
        (dsp.trim_silence_multipass(clip, SR),
         jdsp.trim_silence_multipass(clip, SR)),
        (dsp.normalize_loudness(clip, SR), jdsp.normalize_loudness(clip, SR)),
        (np.float64(dsp.measure_loudness_lufs(clip, SR)),
         np.float64(jdsp.measure_loudness_lufs(clip, SR))),
        (np.concatenate([np.ravel(c) for c in dsp._k_weighting_coeffs(SR)]),
         np.concatenate([np.ravel(c) for c in jdsp._k_weighting_coeffs(SR)])),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got, want)
    assert len(pairs[3][0]) < len(clip)
    np.testing.assert_array_equal(features._k_weighting_fir(SR),
                                  jfeat._k_weighting_fir(SR))


def test_griffin_lim_matches_jax_with_its_angles(jax_side):
    stft = TacotronSTFT(256, 64, 256, 20, SR, 0.0, 8000.0, device="cpu")
    mag = torch.from_numpy(jax_side["gl_mag"])
    got = stft.griffin_lim(mag, n_iters=30,
                           angles=torch.from_numpy(jax_side["gl_angles"]))
    assert got.shape == jax_side["gl"].shape
    np.testing.assert_allclose(got.numpy(), jax_side["gl"], atol=1e-4, rtol=0)


def test_griffin_lim_draws_from_its_generator(jax_side):
    stft = TacotronSTFT(256, 64, 256, 20, SR, 0.0, 8000.0, device="cpu")
    mag = torch.from_numpy(jax_side["gl_mag"])
    a, b = (stft.griffin_lim(mag, n_iters=2,
                             generator=torch.Generator().manual_seed(s))
            for s in (1, 1))
    c = stft.griffin_lim(mag, n_iters=2,
                         generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # the default draw is the one of a generator seeded 0
    assert torch.equal(stft.griffin_lim(mag, n_iters=2),
                       stft.griffin_lim(mag, n_iters=2,
                                        generator=torch.Generator()
                                        .manual_seed(0)))

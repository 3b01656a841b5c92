"""The port's vocoder data path and optimisers against the JAX package's, on
the CPU: Mel2Samp items (plain wavs, blur, GTA mels with and without DTW,
an extremeGTA offset with logvar channels, a file shorter than a segment)
and collate_mel2samp, dtw_align, LAMB and ReduceLROnPlateau. Both datasets
read the same WAVs and GTA dumps, written to a temporary directory; both
packages' optional native audio libraries are kept out: both run the
numpy/scipy path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cookietts_tpu.data import mel2samp as jm2s
from cookietts_tpu.ops.dtw import dtw_align as j_dtw_align
from cookietts_tpu.runtime import optim as joptim
from cookietts_tpu_torch.data import audio_io
from cookietts_tpu_torch.data import mel2samp as pm2s
from cookietts_tpu_torch.ops.dtw import dtw_align
from cookietts_tpu_torch.runtime import optim as poptim
from test_torch_threads import _one_thread  # noqa: F401


FRONT = dict(sampling_rate=16000, filter_length=512, hop_length=128,
             win_length=512, n_mel_channels=16, mel_fmax=8000.0,
             segment_length=2048)
CASES = {
    "wav": dict(),
    "blur": dict(blur_prob=1.0, blur_strength=1.5),
    "gta-dtw": dict(load_mel_from_disk=1.0, dtw_scale_factor=4, dtw_range=3),
    "gta-offset-logvar": dict(load_mel_from_disk=1.0, load_from_disk_dtw=False,
                              max_l1_err=50.0, max_mse_err=2500.0),
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A map file: three tones with noise (one shorter than a segment), each
    with a GTA dump (the ground-truth mel shifted by a frame, plus noise);
    the last one's dump is named for a 64-sample offset and carries logvar
    channels."""
    root = tmp_path_factory.mktemp("voc")
    rng = np.random.default_rng(0)
    stft = pm2s.TacotronSTFT(512, 128, 512, 16, 16000, 0.0, 8000.0,
                             device="cpu")
    lines = []
    for i, n in enumerate((6000, 1500, 8000)):
        t = np.arange(n) / 16000
        audio = (0.3 * np.sin(2 * np.pi * 200 * (i + 1) * t)
                 + 0.02 * rng.standard_normal(n)).astype(np.float32)
        wav = str(root / f"a{i}.wav")
        audio_io.save_wav(wav, audio, 16000)
        audio, _ = audio_io.load_wav(wav)
        mel = stft.mel_spectrogram_np(audio)
        gta = np.roll(mel, 1, axis=0) + 0.1 * rng.standard_normal(mel.shape)
        if i == 2:
            gta = np.concatenate([gta, np.zeros_like(gta)], axis=1)
            mel_path = str(root / f"a{i}.mel64.npy")
        else:
            mel_path = str(root / f"a{i}.mel.npy")
        np.save(mel_path, gta.astype(np.float32))
        lines.append(f"{wav}|{mel_path}|{i}")
    path = root / "map.txt"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mel2samp_items_and_collate_match_jax(corpus, case, monkeypatch):
    monkeypatch.setenv("COOKIETTS_DISABLE_NATIVE", "1")
    entries = pm2s.load_map_file(corpus)
    assert entries == jm2s.load_map_file(corpus)
    kw = dict(FRONT, **CASES[case])
    pset = pm2s.Mel2Samp(entries, pm2s.Mel2SampConfig(**kw), seed=5)
    jset = jm2s.Mel2Samp(entries, jm2s.Mel2SampConfig(**kw), seed=5)
    p_items, j_items = [], []
    for i in [0, 1, 2, 2, 0]:            # the segment draws go on
        p_items.append(pset[i])
        j_items.append(jset[i])
        a, b = p_items[-1], j_items[-1]
        assert set(a) == set(b) and a["speaker_id"] == b["speaker_id"]
        np.testing.assert_array_equal(a["audio"], b["audio"])
        # the same float32 arithmetic; the DTW's L1 sums may round apart
        np.testing.assert_allclose(a["mel"], b["mel"], atol=1e-5, rtol=1e-5)
        assert a["audio"].shape == (2048,) and a["mel"].shape == (17, 16)
    got, want = pm2s.collate_mel2samp(p_items), jm2s.collate_mel2samp(j_items)
    assert set(got) == set(want) and got["audiopath"] == want["audiopath"]
    for k in ("audio", "mels", "speaker_id"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("scale,rng_", [(5, 3), (4, 1), (3, 5)])
def test_dtw_align_matches_jax(scale, rng_):
    rng = np.random.default_rng(scale + rng_)
    target = rng.normal(-5, 2, (2, 24, 8)).astype(np.float32)
    pred = (np.roll(target, 1, axis=1)
            + 0.3 * rng.standard_normal(target.shape)).astype(np.float32)
    got = dtw_align(pred, target, scale, rng_)
    want = np.asarray(j_dtw_align(jnp.asarray(pred), jnp.asarray(target),
                                  scale, rng_))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    if rng_ > 1:                          # some frames did move
        assert not np.array_equal(got, pred)
    with pytest.raises(ValueError, match="odd"):
        dtw_align(pred, target, scale, 2)


def test_gaussian_blur_mel_matches_jax():
    mel = np.random.default_rng(3).normal(-5, 2, (20, 16)).astype(np.float32)
    np.testing.assert_array_equal(pm2s.gaussian_blur_mel(mel, 1.5),
                                  jm2s.gaussian_blur_mel(mel, 1.5))


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_lamb_steps_match_jax(weight_decay):
    """Four LAMB steps on a few tensors (one all zero, where the trust ratio
    is 1): the parameters after each step as JAX's."""
    rng = np.random.default_rng(7)
    shapes = {"a": (4, 3), "b": (5,), "zero": (2, 2)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    p0["zero"][:] = 0
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(4)]
    jopt = joptim.lamb(weight_decay=weight_decay)
    popt = poptim.lamb(weight_decay=weight_decay)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    pp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ps = jopt.init(jp), popt.init(pp)
    for g in grads:
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp,
                             lr=1e-2)
        jp = joptim.apply_updates(jp, ju)
        pu, ps = popt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             ps, pp, lr=1e-2)
        poptim.apply_updates(pp, pu)
        for k in shapes:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-7, rtol=1e-6, err_msg=k)
    assert ps.step == int(js.step) == 4


def test_reduce_lr_on_plateau_matches_jax():
    metrics = [5.0, 4.0, 4.0, 4.1, 3.9999, 4.2, 4.3, 4.4, 4.5, 4.6, 4.7, 4.8,
               3.0, 3.1, 3.2, 3.3, 3.4, 3.5, 3.6, 3.7]
    jp = joptim.ReduceLROnPlateau(patience=2)
    pp = poptim.ReduceLROnPlateau(patience=2)
    scales = [(pp.step(m), jp.step(m)) for m in metrics]
    assert [a for a, _ in scales] == [b for _, b in scales]
    assert scales[-1][0] < 0.2            # it did reduce, several times

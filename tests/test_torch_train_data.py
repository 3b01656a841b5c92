"""The port's training data path against the JAX package's, on the CPU:
TacotronSTFT's mel spectrogram on a corpus tone, and TTSDataset +
TBPTTSampler + collate on a tiny evidence corpus written to a temporary
directory (both read the same WAVs; mel caching off, so each computes its
own mels)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cookietts_tpu.audio.stft import TacotronSTFT as JTacotronSTFT
from cookietts_tpu.data import dataset as jds
from cookietts_tpu.data import evidence_corpus as jcorpus
from cookietts_tpu_torch.audio.stft import TacotronSTFT
from cookietts_tpu_torch.data import dataset as pds
from cookietts_tpu_torch.data import evidence_corpus as pcorpus
from cookietts_tpu_torch.data.filelist import load_filelist
from test_torch_threads import _one_thread  # noqa: F401


# the evidence corpus' front end, as chip_smoke.py phase 7 trains with it
FRONT = dict(filter_length=1024, hop_length=256, win_length=1024,
             n_mel_channels=80, sampling_rate=22050, mel_fmax=8000.0)
DATA = dict(sampling_rate=22050, filter_length=1024, hop_length=256,
            win_length=1024, n_mel_channels=80, mel_fmin=0.0, mel_fmax=8000.0,
            trim_enable=False, cache_mels=False, max_segment_frames=48,
            mel_buckets=(64, 128, 192), text_buckets=(16, 32))


def test_mel_spectrogram_matches_jax():
    audio = jcorpus.char_tone("c", np.random.default_rng(0), dur_s=0.3)
    want = np.asarray(JTacotronSTFT(**FRONT).mel_spectrogram(
        jnp.asarray(audio[None])))
    port = TacotronSTFT(**FRONT, device="cpu")
    got = port.mel_spectrogram(torch.from_numpy(audio[None])).numpy()
    # two float32 DFTs in different orders: bands 50 dB under the tone
    # differ by a few 1e-5 relative; rtol as tests/test_audio.py holds the
    # JAX log-mel to its reference
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(port.mel_spectrogram_np(audio),
                                  JTacotronSTFT(**FRONT).mel_spectrogram_np(audio))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    work = tmp_path_factory.mktemp("corpus")
    train_fl, _ = pcorpus.make_corpus(str(work), seed=3, n_train=5, n_val=2)
    return work, train_fl


def test_evidence_corpus_is_the_jax_packages(corpus, tmp_path):
    work, train_fl = corpus
    jcorpus.make_corpus(str(tmp_path), seed=3, n_train=5, n_val=2)
    for name in ["u000.wav", "u004.wav", "u006.wav"]:
        assert (work / name).read_bytes() == (tmp_path / name).read_bytes()
    assert [e["quote"] for e in load_filelist(train_fl)] == [
        e["quote"] for e in load_filelist(str(tmp_path / "filelist_train.txt"))]


def test_dataset_sampler_collate_match_jax(corpus, monkeypatch):
    """Items, TBPTT segment plans (48-frame segments, so utterances span
    several) and every collated array of every planned batch. Both
    packages' optional native audio libraries are kept out: both run the
    numpy/scipy path."""
    monkeypatch.setenv("COOKIETTS_DISABLE_NATIVE", "1")
    _, train_fl = corpus
    entries = load_filelist(train_fl)
    jset = jds.TTSDataset(entries, jds.DataConfig(**DATA))
    pset = pds.TTSDataset(entries, pds.DataConfig(**DATA))
    lengths = pset.mel_frame_lengths()
    assert lengths == jset.mel_frame_lengths() and max(lengths) > 96
    for i in range(len(entries)):
        a, b = pset[i], jset[i]
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)
    plan = lambda mod: [[dataclasses.astuple(s) for s in batch] for batch in
                        mod.TBPTTSampler(lengths, 2, 48, seed=1)]
    plans = plan(pds)
    assert plans == plan(jds) and any(s[1] > 0 for b in plans for s in b)
    cfg_p, cfg_j = pds.DataConfig(**DATA), jds.DataConfig(**DATA)
    for batch in pds.TBPTTSampler(lengths, 2, 48, seed=1):
        segs_j = [jds.Segment(*dataclasses.astuple(s)) for s in batch]
        got = pds.collate([pset[s.file_idx] for s in batch], cfg_p, batch)
        want = jds.collate([jset[s.file_idx] for s in segs_j], cfg_j, segs_j)
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)


def test_unported_features_raise(corpus):
    """A feature the dataset does not know raises; "audio" (unported before
    the preprocess slice) is served now."""
    with pytest.raises(NotImplementedError, match="pitch"):
        pds.TTSDataset([], pds.DataConfig(**DATA), features=("audio", "pitch"))
    pds.TTSDataset([], pds.DataConfig(**DATA), features=("audio",))

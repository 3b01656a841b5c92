"""The port's durations, f0 and energy (data/dio.py, data/mfa.py's TextGrid
reader, audio_io.estimate_f0_dio and the dataset's features and collate)
against the JAX package's, on the CPU: bit for bit on the same inputs.

The corpus is the evidence corpus (22050 Hz tones, 80 mels) written to a
temporary directory, mel caching off, both packages' native audio
libraries kept out (both run the numpy path)."""
import numpy as np
import pytest

from cookietts_tpu.data import audio_io as jaudio
from cookietts_tpu.data import dataset as jds
from cookietts_tpu.data import dio as jdio
from cookietts_tpu.data import mfa as jmfa
from cookietts_tpu_torch.data import audio_io as paudio
from cookietts_tpu_torch.data import dataset as pds
from cookietts_tpu_torch.data import dio as pdio
from cookietts_tpu_torch.data import evidence_corpus as pcorpus
from cookietts_tpu_torch.data import mfa as pmfa
from cookietts_tpu_torch.data.filelist import load_filelist
from test_torch_threads import _one_thread  # noqa: F401

DATA = dict(sampling_rate=22050, filter_length=1024, hop_length=256,
            win_length=1024, n_mel_channels=80, mel_fmin=0.0, mel_fmax=8000.0,
            trim_enable=False, cache_mels=False, mel_buckets=(64, 128, 192),
            text_buckets=(16, 32))
FEATURES = ("text", "mel", "speaker_id", "f0", "energy", "durations")
TEXTGRID = ('File type = "ooTextFile"\nObject class = "TextGrid"\n'
            'item [1]:\n  class = "IntervalTier"\n  name = "words"\n'
            '  intervals [1]:\n    xmin = 0.0\n    xmax = 0.25\n'
            '    text = "HI"\n'
            'item [2]:\n  class = "IntervalTier"\n  name = "phones"\n'
            '  intervals [1]:\n    xmin = 0.0\n    xmax = 0.1\n'
            '    text = "HH"\n'
            '  intervals [2]:\n    xmin = 0.1\n    xmax = 0.2337\n'
            '    text = "AY"\n'
            '  intervals [3]:\n    xmin = 0.2337\n    xmax = 0.25\n'
            '    text = ""\n')


def _voice(sr, seconds, seed):
    """A harmonic voice with vibrato, silences and noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    f0 = 140 + 25 * np.sin(2 * np.pi * 3 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    x = sum(0.3 / h * np.sin(h * phase) for h in range(1, 5))
    x = x * (np.sin(2 * np.pi * 0.7 * t) > -0.3)
    return (x + 0.01 * rng.standard_normal(t.shape)).astype(np.float32)


@pytest.mark.parametrize("sr,hop", [(22050, 256), (16000, 160)])
def test_dio_and_estimate_f0_dio_bit_for_bit(sr, hop):
    x = _voice(sr, 1.3, seed=sr)
    f0, times = pdio.dio(x, sr, frame_period_ms=hop / sr * 1000.0)
    jf0, jtimes = jdio.dio(x, sr, frame_period_ms=hop / sr * 1000.0)
    np.testing.assert_array_equal(f0, jf0)
    np.testing.assert_array_equal(times, jtimes)
    assert (f0 > 0).any() and (f0 == 0).any()
    got = paudio.estimate_f0_dio(x, sr, hop_length=hop)
    want = jaudio.estimate_f0_dio(x, sr, hop_length=hop)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1].dtype == bool and (got[0] > 3).all()


def test_textgrid_parse_and_durations(tmp_path):
    path = tmp_path / "a.TextGrid"
    path.write_text(TEXTGRID)
    tiers = pmfa.parse_textgrid(str(path))
    assert tiers == jmfa.parse_textgrid(str(path))
    assert [lbl for _, _, lbl in tiers["phones"]] == ["HH", "AY", ""]
    for hop in (0.01, 256 / 22050):
        got = pmfa.durations_from_textgrid(tiers, "phones", hop)
        assert got == jmfa.durations_from_textgrid(tiers, "phones", hop)
    assert pmfa.durations_from_textgrid(tiers, "none", 0.01) == []


def test_duration_helpers():
    rng = np.random.default_rng(0)
    for _ in range(50):
        dur = rng.integers(0, 9, int(rng.integers(0, 12)))
        n_text, t_mel = int(rng.integers(1, 14)), int(rng.integers(1, 80))
        got = pds.fit_durations(dur, n_text, t_mel)
        np.testing.assert_array_equal(got, jds.fit_durations(dur, n_text,
                                                             t_mel))
        assert got.sum() == t_mel and len(got) == n_text
        np.testing.assert_array_equal(pds.uniform_durations(n_text, t_mel),
                                      jds.uniform_durations(n_text, t_mel))
        vals = rng.standard_normal(t_mel).astype(np.float32)
        np.testing.assert_array_equal(pds.char_average(vals, got),
                                      jds.char_average(vals, got))
    np.testing.assert_allclose(pds.char_average(
        np.arange(10, dtype=np.float32), np.array([2, 3, 5])), [0.5, 3.0, 7.0])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    work = tmp_path_factory.mktemp("corpus")
    train_fl, _ = pcorpus.make_corpus(str(work), seed=4, n_train=4, n_val=0)
    return work, load_filelist(train_fl)


def test_duration_sources_in_order(corpus, tmp_path):
    """.dur.npy, then .gdur.npy, then .TextGrid / .textgrid, then uniform;
    each fitted to the text and mel lengths, as JAX's."""
    wav = str(tmp_path / "a.wav")
    pset = pds.TTSDataset([], pds.DataConfig(**DATA), features=FEATURES)
    jset = jds.TTSDataset([], jds.DataConfig(**DATA), features=FEATURES)

    def both(t_mel=30, n_text=3):
        got = pset._get_durations(wav, t_mel, n_text)
        np.testing.assert_array_equal(got, jset._get_durations(wav, t_mel,
                                                               n_text))
        return got.tolist()

    assert both() == [10, 10, 10]                          # uniform
    (tmp_path / "a.textgrid").write_text(TEXTGRID)
    assert both() == [9, 11, 10]                           # phones, fitted
    (tmp_path / "a.textgrid").rename(tmp_path / "a.TextGrid")
    assert both() == [9, 11, 10]
    np.save(wav + ".gdur.npy", np.array([4, 4, 4, 4]))
    assert both() == [4, 4, 22]                            # gta's sidecar
    np.save(wav + ".dur.npy", np.array([1, 2]))
    assert both() == [1, 29, 0]                            # alignment's


def test_items_and_collate_match_jax(corpus, monkeypatch):
    """Every item's f0, voiced, energy, durations and char averages, and
    every collated array, against JAX's, with .gdur.npy sidecars on half
    the files (the rest uniform)."""
    monkeypatch.setenv("COOKIETTS_DISABLE_NATIVE", "1")
    work, entries = corpus
    rng = np.random.default_rng(1)
    for e in entries[::2]:
        np.save(e["path"] + ".gdur.npy", rng.integers(1, 9, 12))
    pset = pds.TTSDataset(entries, pds.DataConfig(**DATA), features=FEATURES)
    jset = jds.TTSDataset(entries, jds.DataConfig(**DATA), features=FEATURES)
    items_p = [pset[i] for i in range(len(entries))]
    items_j = [jset[i] for i in range(len(entries))]
    for a, b in zip(items_p, items_j):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)
        assert a["durations"].sum() == a["mel_length"]
    for rows in ([0, 1], [2, 3, 0]):
        got = pds.collate([items_p[i] for i in rows], pset.cfg)
        want = jds.collate([items_j[i] for i in rows], jset.cfg)
        assert set(got) == set(want)
        for k in ("durations", "f0", "energy", "frame_f0", "frame_energy",
                  "frame_voiced", "mels", "mel_lengths", "text"):
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)
        np.testing.assert_array_equal(got["durations"].sum(1),
                                      got["mel_lengths"])


def test_autocorr_f0_method(corpus, monkeypatch):
    monkeypatch.setenv("COOKIETTS_DISABLE_NATIVE", "1")
    _, entries = corpus
    cfg = dict(DATA, f0_method="autocorr")
    got = pds.TTSDataset(entries[:1], pds.DataConfig(**cfg),
                         features=("mel", "f0"))[0]
    want = jds.TTSDataset(entries[:1], jds.DataConfig(**cfg),
                          features=("mel", "f0"))[0]
    np.testing.assert_array_equal(got["f0"], want["f0"])


def test_durations_refuse_tbptt_segments(corpus):
    _, entries = corpus
    pset = pds.TTSDataset(entries, pds.DataConfig(**DATA),
                          features=("text", "mel", "durations"))
    items = [pset[0], pset[1]]
    segs = [pds.Segment(0, 0, 2), pds.Segment(1, 0, 1)]
    with pytest.raises(NotImplementedError, match="TBPTT"):
        pds.collate(items, pset.cfg, segs)
    pds.collate(items, pset.cfg, [pds.Segment(0, 0, 1), pds.Segment(1, 0, 1)])

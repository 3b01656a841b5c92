"""Stages 0 and 1 of the port's pipeline against the JAX package's.

``run_preprocess`` of both packages, each on its own copy of one seeded
corpus (preprocess rewrites the wavs in place), on one audio path (the C++
kernels: JAX's binding is pointed at the library the port built from the
same source) and with the feature dump on: the filelists, speaker and
emotion info, ``meta_dump.json`` and ``missing_vocab.txt`` equal, the wavs
within 1 LSB, the mel caches within 2e-3, the len sidecars equal, the
``.gt.f0`` dumps equal on at least 99% of frames, and the forced alignment's
``.dur.npy`` sidecars equal (a fake ``mfa_align`` on PATH writes the
TextGrids). Also the dataset fixes and archives, ``download`` with its
fetches monkeypatched, the ``preprocess`` command, and the port's
``TTSDataset`` served from the written caches."""
import contextlib
import dataclasses
import io
import json
import os
import shutil
import sys
import tarfile
import zipfile
from pathlib import Path

import numpy as np
import pytest
from scipy.io import wavfile
from test_torch_threads import _one_thread  # noqa: F401

from cookietts_tpu.data import native as jax_native
from cookietts_tpu.data.dataset import DataConfig as JaxDataConfig
from cookietts_tpu.data.dataset import TTSDataset as JaxTTSDataset
from cookietts_tpu.pipeline import preprocess as jax_pre
from cookietts_tpu_torch.data import audio_io, native
from cookietts_tpu_torch.data.dataset import DataConfig, TTSDataset, collate
from cookietts_tpu_torch.data.filelist import load_filelist
from cookietts_tpu_torch.pipeline import preprocess as pre

SR_IN = 16000
FRONTEND = dict(filter_length=1024, hop_length=256, win_length=1024,
                n_mel_channels=40, mel_fmin=0.0, mel_fmax=8000.0)
LEXICON = ("HELLO HH AH0 L OW1\nTHERE DH EH1 R\nFRIEND F R EH1 N D\n"
           "PLEASE P L IY1 Z\nCALL K AO1 L\nNUMBER N AH1 M B ER0\n")

_FAKE_MFA = '''#!{python}
"""mfa_align CORPUS LEXICON MODEL OUT: one TextGrid a clip, the clip's
duration split evenly over its words' phones between two silences."""
import os, sys, wave
corpus, lexicon, _, out = sys.argv[1:5]
lex = {{}}
for ln in open(lexicon):
    parts = ln.split()
    lex[parts[0].upper()] = parts[1:]
os.makedirs(out, exist_ok=True)
def tier(name, items, dur):
    body = "".join(
        f'        intervals [{{i + 1}}]:\\n            xmin = {{a:.6f}}\\n'
        f'            xmax = {{b:.6f}}\\n            text = "{{t}}"\\n'
        for i, (a, b, t) in enumerate(items))
    return (f'    item [{{name[0]}}]:\\n        class = "IntervalTier"\\n'
            f'        name = "{{name[1]}}"\\n        xmin = 0\\n'
            f'        xmax = {{dur:.6f}}\\n'
            f'        intervals: size = {{len(items)}}\\n' + body)
for f in sorted(os.listdir(corpus)):
    if not f.endswith(".wav"):
        continue
    base = f[:-4]
    with wave.open(os.path.join(corpus, f)) as w:
        dur = w.getnframes() / w.getframerate()
    words = [w.strip(".,!?").upper()
             for w in open(os.path.join(corpus, base + ".lab")).read().split()]
    phones = [(w, p) for w in words for p in lex.get(w, ["spn"])]
    step = dur / (len(phones) + 2)
    ph = [(0.0, step, "sil")]
    wd = [(0.0, step, "")]
    t = step
    for w in words:
        mine = [p for ww, p in phones if ww == w][:len(lex.get(w, ["spn"]))]
        wd.append((t, t + step * len(mine), w.lower()))
        for p in mine:
            ph.append((t, t + step, p))
            t += step
    ph.append((t, dur, "sil"))
    wd.append((t, dur, ""))
    with open(os.path.join(out, base + ".TextGrid"), "w") as g:
        g.write('File type = "ooTextFile"\\nObject class = "TextGrid"\\n'
                f'xmin = 0\\nxmax = {{dur:.6f}}\\ntiers? <exists>\\n'
                'size = 2\\nitem []:\\n' + tier((1, "words"), wd, dur)
                + tier((2, "phones"), ph, dur))
'''


def _clip(seconds, f0, seed, amp=0.3):
    """Speech-like: harmonics with vibrato, noise, and 0.2 s of quiet noise
    before and after (trim has work)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR_IN * seconds)) / SR_IN
    phase = 2 * np.pi * np.cumsum(f0 * (1 + 0.04 * np.sin(2 * np.pi * 5 * t)))
    x = sum(np.sin(k * phase / SR_IN) / k for k in range(1, 6))
    x = amp * x / np.abs(x).max() + 0.01 * rng.standard_normal(t.shape)
    x *= np.clip(np.minimum(t, t[-1] - t) / 0.05, 0, 1)
    sil = lambda: 1e-4 * rng.standard_normal(int(0.2 * SR_IN))  # noqa: E731
    return np.concatenate([sil(), x, sil()]).astype(np.float32)


def make_corpus(root: Path, lexicon: Path) -> list:
    """Three datasets in layouts data/metadata.py detects: LJSpeech (one
    speaker, a metadata.csv), Clipper_MLP (two speakers, per-clip .txt, a
    noisy clip to delete, one clip inside a zip) and VCTK (mic1/mic2
    takes). Returns the dataset directories."""
    lexicon.write_text(LEXICON)
    lj = root / "LJSpeech"
    (lj / "wavs").mkdir(parents=True)
    lines = []
    for i, (sec, f0) in enumerate([(0.9, 120.0), (1.3, 150.0), (0.7, 170.0)]):
        name = f"LJ001-{i + 1:04d}"
        audio_io.save_wav(str(lj / "wavs" / f"{name}.wav"),
                          _clip(sec, f0, i), SR_IN)
        quote = f"Hello there friend number {i}, hello."
        lines.append(f"{name}|{quote}|{quote}")
    (lj / "metadata.csv").write_text("\n".join(lines) + "\n")

    clip = root / "Clipper_MLP"
    clip.mkdir()
    stems = [("00_00_01_Twilight_Neutral__Hello there friend", 210.0),
             ("00_00_02_Rarity_Happy__Please call Stella", 240.0),
             ("00_00_03_Twilight_Neutral_Noisy_Bad clip here", 200.0)]
    for j, (stem, f0) in enumerate(stems):
        audio_io.save_wav(str(clip / f"{stem}.wav"), _clip(1.0, f0, 10 + j),
                          SR_IN)
        (clip / f"{stem}.txt").write_text(stem.split("_")[-1] + ".")
    stem = "00_00_04_Rarity_Happy__Call there friend"
    audio_io.save_wav(str(root / f"{stem}.wav"), _clip(1.1, 260.0, 20), SR_IN)
    with zipfile.ZipFile(clip / "extra.zip", "w") as z:
        z.write(root / f"{stem}.wav", f"{stem}.wav")
        z.writestr(f"{stem}.txt", "Call there friend.")
    (root / f"{stem}.wav").unlink()

    vctk = root / "VCTK" / "p225"
    vctk.mkdir(parents=True)
    for mic in ("mic1", "mic2"):
        audio_io.save_wav(str(vctk / f"p225_001_{mic}.wav"),
                          _clip(0.8, 300.0, 30), SR_IN)
    (vctk / "p225_001.txt").write_text("Please call Stella.")
    return [str(lj), str(clip), str(root / "VCTK")]


def _config(root: Path, lexicon: Path, **kw):
    return dict(dataset_dirs=[str(root / d) for d in
                              ("LJSpeech", "Clipper_MLP", "VCTK")],
                target_sr=22050, target_lufs=-27.0, min_duration=0.3,
                delete_noisy=True, arpa_dict_path=str(lexicon),
                use_forced_aligner=True, on_device_features=True,
                feature_batch=4, out_dir=str(root / "out"), **FRONTEND, **kw)


@pytest.fixture(scope="module")
def lib_path():
    native.load(build_if_missing=True)
    return native.library_path()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, lib_path):
    """(JAX's root, the port's root, the port's printed output)."""
    base = tmp_path_factory.mktemp("preprocess")
    src, lexicon = base / "src", base / "merged.dict"
    make_corpus(src, lexicon)
    bin_dir = base / "bin"
    bin_dir.mkdir()
    (bin_dir / "mfa_align").write_text(_FAKE_MFA.format(python=sys.executable))
    (bin_dir / "mfa_align").chmod(0o755)
    roots = {k: base / k for k in ("jax", "port")}
    for r in roots.values():
        shutil.copytree(src, r)
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
        mp.delenv("COOKIETTS_DISABLE_NATIVE", raising=False)
        mp.setattr(jax_native, "_LIB_PATH", str(lib_path))
        mp.setattr(jax_native, "_lib", None)
        jax_pre.run_preprocess(jax_pre.PreprocessConfig(
            **_config(roots["jax"], lexicon, threads=1)))
        with contextlib.redirect_stdout(out):
            pre.run_preprocess(pre.PreprocessConfig(
                **_config(roots["port"], lexicon, threads=2)), device="cpu")
    return roots["jax"], roots["port"], out.getvalue()


def _tree(root: Path, suffix=""):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*" + suffix)
                  if p.is_file())


def test_outputs_equal_jax(runs):
    jroot, proot, _ = runs
    jout, pout = jroot / "out", proot / "out"
    assert _tree(jout) == _tree(pout)
    for name in ("filelist_train.txt", "filelist_validation.txt",
                 "speaker_info.txt", "emotion_info.txt", "meta_dump.json",
                 "missing_vocab.txt", "preprocess_config.json",
                 "Clipper_MLP/filelist_train.txt",
                 "LJSpeech/filelist_train.txt"):
        assert name in _tree(pout), name
    for name in _tree(jout):
        if name == "preprocess_config.json":
            continue
        want = (jout / name).read_text().replace(str(jroot), str(proot))
        assert (pout / name).read_text() == want, name
    jcfg, pcfg = (json.loads((o / "preprocess_config.json").read_text())
                  for o in (jout, pout))
    assert set(jcfg) == set(pcfg) == {
        f.name for f in dataclasses.fields(jax_pre.PreprocessConfig)}
    assert {k: v for k, v in pcfg.items()
            if k not in ("dataset_dirs", "out_dir", "threads")} \
        == {k: v for k, v in jcfg.items()
            if k not in ("dataset_dirs", "out_dir", "threads")}
    speakers = {ln.split("|")[1] for ln in
                (pout / "speaker_info.txt").read_text().splitlines()[1:]}
    assert {"Twilight", "Rarity", "LJSpeech", "VCTK"} <= speakers
    assert "stella" in (pout / "missing_vocab.txt").read_text()
    entries = load_filelist(str(pout / "filelist_train.txt")) + \
        load_filelist(str(pout / "filelist_validation.txt"))
    assert len(entries) == 7
    # the aligner's phones replace the ARPAbet lookup's transcript
    assert any(e.get("phoneme_transcript", "").startswith("{sil HH AH0 L OW1")
               for e in entries)


def test_dataset_fixes_and_archive_applied_alike(runs):
    jroot, proot, _ = runs
    for root in (jroot, proot):
        clip = root / "Clipper_MLP"
        assert not any("Noisy" in p.name for p in clip.iterdir())
        assert (clip / "extra.zip.extracted").exists()
        assert (clip / "00_00_04_Rarity_Happy__Call there friend.wav").exists()
        assert sorted(p.name for p in (root / "VCTK" / "p225").iterdir()
                      if p.suffix == ".wav") == ["p225_001.wav"]
    assert _tree(jroot / "Clipper_MLP") == _tree(proot / "Clipper_MLP")


def test_wavs_equal_jax_within_one_lsb(runs):
    jroot, proot, _ = runs
    wavs = _tree(jroot, ".wav")
    assert wavs == _tree(proot, ".wav") and len(wavs) == 7
    for name in wavs:
        (jsr, ja), (psr, pa) = (wavfile.read(r / name) for r in (jroot, proot))
        assert jsr == psr == 22050 and ja.dtype == pa.dtype == np.int16
        assert ja.shape == pa.shape, name
        assert np.abs(ja.astype(np.int32) - pa).max() <= 1, name
        assert len(ja) < 1.3 * 22050 * (1.3 + 0.4) and np.abs(ja).max() > 0


def test_feature_caches_equal_jax(runs):
    """Mel caches within 2e-3, len sidecars equal, .gt.f0 equal on 99% of
    frames, .gt.energy within rel 1e-2 (the exp of the mel's 2e-3)."""
    jroot, proot, _ = runs
    h = pre.feature_cache_hash(pre.PreprocessConfig(target_sr=22050,
                                                    **FRONTEND))
    for name in _tree(jroot, ".wav"):
        jp, pp = str(jroot / name), str(proot / name)
        jm, pm = (np.load(p + f".{h}.mel.npy") for p in (jp, pp))
        assert jm.shape == pm.shape and jm.shape[1] == 40
        np.testing.assert_allclose(pm, jm, atol=2e-3, rtol=0)
        n = int(np.load(pp + f".{h}.len.npy"))
        assert n == int(np.load(jp + f".{h}.len.npy")) == len(pm)
        assert n == len(audio_io.load_wav(pp)[0]) // 256 + 1
        jf, pf = (np.load(p + ".gt.f0.npy") for p in (jp, pp))
        assert jf.shape == pf.shape == (n,)
        assert np.mean(np.isclose(pf, jf, rtol=1e-5, atol=1e-3)) >= 0.99
        np.testing.assert_allclose(np.load(pp + ".gt.energy.npy"),
                                   np.load(jp + ".gt.energy.npy"), rtol=1e-2)


def test_forced_alignment_equals_jax(runs):
    jroot, proot, _ = runs
    durs = _tree(jroot, ".dur.npy")
    assert durs == _tree(proot, ".dur.npy") and len(durs) == 7
    for name in durs:
        np.testing.assert_array_equal(np.load(proot / name),
                                      np.load(jroot / name))
        assert np.load(proot / name).sum() > 0


def test_run_logs_the_native_path_and_its_stats(runs):
    _, _, printed = runs
    assert "[preprocess] audio path: native (" in printed
    stats = json.loads(printed.strip().splitlines()[-1])["preprocess_stats"]
    assert stats["audio_path"] == "native" and stats["wavs"] == 7
    feats = stats["features"]
    assert feats["clips"] == 7 and feats["batches"] == 2
    assert feats["device"] == "cpu" and len(feats["batch_ms"]) == 2


def test_dataset_is_served_from_the_written_caches(runs):
    _, proot, _ = runs
    dcfg = DataConfig(sampling_rate=22050, trim_enable=False,
                      target_lufs=None, p_arpabet=0.0, **FRONTEND)
    entries = load_filelist(str(proot / "out" / "filelist_train.txt"))
    ds = TTSDataset(entries, dcfg, features=["text", "mel", "speaker_id"])

    def refuse(*_a, **_k):
        raise AssertionError("mel recomputed despite the preprocess cache")
    ds.stft.mel_spectrogram_np = refuse
    items = [ds[i] for i in range(len(entries))]
    h = pre.feature_cache_hash(pre.PreprocessConfig(target_sr=22050,
                                                    **FRONTEND))
    for e, item in zip(entries, items):
        np.testing.assert_array_equal(item["mel"],
                                      np.load(e["path"] + f".{h}.mel.npy"))
        assert "audio" not in item
    batch = collate(items[:4], dcfg)
    assert batch["mels"].shape[0] == 4


def test_dataset_audio_feature_with_a_cached_mel_equals_jax(runs):
    """Asked for ["audio", "mel"] over a cached corpus, the port loads the
    clip as JAX's dataset does (cookietts_tpu/data/dataset.py:431-440) and
    serves the mel from the cache."""
    _, proot, _ = runs
    entries = load_filelist(str(proot / "out" / "filelist_train.txt"))
    kw = dict(sampling_rate=22050, trim_enable=False, target_lufs=None,
              p_arpabet=0.0, **FRONTEND)
    ds = TTSDataset(entries, DataConfig(**kw), features=["audio", "mel"])
    jds = JaxTTSDataset(entries, JaxDataConfig(**kw),
                        features=["audio", "mel"])
    for i in range(len(entries)):
        got, want = ds[i], jds[i]
        assert "audio" in got and "audio" in want
        np.testing.assert_array_equal(got["audio"], want["audio"])
        np.testing.assert_array_equal(got["mel"], want["mel"])


def test_dataset_fixes_and_nested_archives_match_jax(tmp_path):
    """apply_dataset_fixes' counts (Clipper noisy and very noisy clips, the
    VCTK aux mic) and a zip inside a tar, extracted to depth."""
    outcome = {}
    for pkg, name in ((jax_pre, "jax"), (pre, "port")):
        root = tmp_path / name
        clip, vctk = root / "Clipper_X", root / "vctk" / "p1"
        clip.mkdir(parents=True)
        vctk.mkdir(parents=True)
        for stem in ("a_Noisy_1", "b_Very Noisy_2", "c_Clean_3"):
            (clip / f"{stem}.wav").write_bytes(b"x")
        for mic in ("mic1", "mic2"):
            (vctk / f"p1_001_{mic}.wav").write_bytes(b"y")
        cfg = pkg.PreprocessConfig(
            dataset_dirs=[str(clip), str(root / "vctk")], delete_noisy=True,
            delete_very_noisy=True, vctk_use_aux_mic=True)
        counts = pkg.apply_dataset_fixes(cfg)
        inner = root / "inner.zip"
        with zipfile.ZipFile(inner, "w") as z:
            z.writestr("deep/clip.txt", "hello")
        with tarfile.open(root / "outer.tar.gz", "w:gz") as t:
            t.add(inner, "inner.zip")
        inner.unlink()
        n = pkg.extract_archives_recursively(str(root))
        assert n == 2 and (root / "deep" / "clip.txt").exists()
        assert pkg.extract_archives_recursively(str(root)) == 0
        outcome[name] = (counts, sorted(p.name for p in clip.iterdir()),
                         sorted(p.name for p in vctk.iterdir()))
    assert outcome["port"] == outcome["jax"]
    assert outcome["port"][0] == {"clipper_deleted": 2, "vctk_renamed": 1}
    assert outcome["port"][2] == ["p1_001.wav"]


def test_download_methods_with_fetches_monkeypatched(tmp_path, monkeypatch):
    """LibriTTS clean/other selection, the skip of fetched files, the
    Clipper master folder through mega, and run_downloads over a config
    (tests/test_pipeline2.py's checks)."""
    from cookietts_tpu_torch.pipeline import download as dl
    fetched = []
    monkeypatch.setattr(dl, "download_http",
                        lambda url, dest, progress=None: (
                            fetched.append(url), dest)[1])
    entry = {"name": "LibriTTS", "dest": str(tmp_path / "lt"),
             "urls_clean": ["http://x/clean1.tar", "http://x/clean2.tar"],
             "urls_other": ["http://x/other.tar"],
             "download_clean": True, "download_other": False,
             "extract": False}
    dl.download_dataset(entry)
    assert fetched == ["http://x/clean1.tar", "http://x/clean2.tar"]
    fetched.clear()
    entry["download_other"] = True
    entry["dest"] = str(tmp_path / "lt2")
    dl.download_dataset(entry)
    assert "http://x/other.tar" in fetched

    called = {}
    monkeypatch.setattr(dl, "download_mega",
                        lambda url, dest: called.update(url=url) or dest)
    dl.download_dataset({"name": "Clipper_MLP", "method": "clipper_master",
                         "dest": str(tmp_path / "clip"),
                         "url": "mega://folder"})
    assert called["url"] == "mega://folder"

    # the command: an archive fetched by the (monkeypatched) HTTP fetch is
    # extracted into the dataset's folder; a disabled entry is skipped
    def fetch(url, dest, progress=None):
        with zipfile.ZipFile(dest, "w") as z:
            z.writestr("LJ/metadata.csv", "a|b|c\n")
        fetched.append(url)
        return dest
    monkeypatch.setattr(dl, "download_http", fetch)
    fetched.clear()
    cfg = tmp_path / "download.json"
    cfg.write_text(json.dumps({"datasets": [
        {"name": "LJSpeech", "urls": ["http://x/lj.zip"],
         "dest": str(tmp_path / "ds")},
        {"name": "Off", "enabled": False, "urls": ["http://x/off.zip"],
         "dest": str(tmp_path / "off")}]}))
    from cookietts_tpu_torch.cli import main as cli
    cli(["download", "-c", str(cfg)])
    assert fetched == ["http://x/lj.zip"]
    assert (tmp_path / "ds" / "LJ" / "metadata.csv").exists()
    assert not (tmp_path / "off").exists()


@pytest.mark.parametrize("disable_native", [False, True])
def test_preprocess_command_on_the_cpu(tmp_path, capsys, monkeypatch,
                                       lib_path, disable_native):
    """``preprocess -c cfg --device cpu`` writes the inventory and the
    caches, and logs which audio path it ran."""
    from cookietts_tpu_torch.cli import main as cli
    if disable_native:
        monkeypatch.setenv("COOKIETTS_DISABLE_NATIVE", "1")
    make_corpus(tmp_path, tmp_path / "merged.dict")
    conf = _config(tmp_path, tmp_path / "merged.dict", threads=1)
    conf.update(dataset_dirs=conf["dataset_dirs"][:1],
                use_forced_aligner=False)
    (tmp_path / "pre.json").write_text(json.dumps(conf))
    result = cli(["preprocess", "-c", str(tmp_path / "pre.json"),
                  "--device", "cpu"])
    assert len(result["train"]) + len(result["validation"]) == 3
    printed = capsys.readouterr().out
    assert ("audio path: numpy/scipy" if disable_native
            else "audio path: native (") in printed
    stats = json.loads(printed.strip().splitlines()[-1])["preprocess_stats"]
    assert stats["features"]["clips"] == 3
    h = pre.feature_cache_hash(pre.PreprocessConfig(**conf))
    for p in (tmp_path / "LJSpeech" / "wavs").glob("*.wav"):
        assert Path(f"{p}.{h}.mel.npy").exists()
        assert Path(f"{p}.gt.f0.npy").exists()
    for name in ("filelist_train.txt", "speaker_info.txt", "meta_dump.json",
                 "preprocess_config.json"):
        assert (tmp_path / "out" / name).exists()


def test_bucket_batch_pads_with_each_clips_reflection():
    cfg = pre.PreprocessConfig(filter_length=8, hop_length=4)
    clips = [np.arange(1, 11, dtype=np.float32),
             np.arange(1, 41, dtype=np.float32)]
    batch, lengths = pre.bucket_batch(clips, cfg)
    assert batch.shape == (2, 64) and list(lengths) == [10, 40]
    assert pre.bucket_len(32, cfg) == 32 and pre.bucket_len(33, cfg) == 64
    np.testing.assert_array_equal(batch[0, 10:18], np.arange(9, 1, -1))
    assert not batch[0, 18:].any()
    np.testing.assert_array_equal(batch[1, 40:48], np.arange(39, 31, -1))

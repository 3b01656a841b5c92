"""The port's native audio library (data/native.py): it builds
native/audio_kernels.cpp into build/ (never into native/), concurrent builds
rename into place, its four entry points match the JAX package's binding
(data/native.py there, pointed at the same compiled source) and scipy, and
audio_io takes it when it is built and numpy/scipy under
COOKIETTS_DISABLE_NATIVE=1. Tolerances against scipy are
tests/test_native.py's."""
import hashlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from scipy import signal as scipy_signal
from test_torch_threads import _one_thread  # noqa: F401

from cookietts_tpu.data import native as jax_native
from cookietts_tpu_torch.data import audio_io, native

ROOT = Path(__file__).resolve().parent.parent
NATIVE_DIR = ROOT / "native"


def _sources():
    """native/'s tracked sources: contents and modification times."""
    return {p.name: (hashlib.sha256(p.read_bytes()).hexdigest(),
                     p.stat().st_mtime_ns)
            for p in (NATIVE_DIR / "Makefile",
                      NATIVE_DIR / "audio_kernels.cpp")}


@pytest.fixture(scope="module")
def lib_path():
    native.load(build_if_missing=True)
    assert native.available()
    return native.library_path()


@pytest.fixture
def jax_binding(monkeypatch, lib_path):
    """The JAX package's binding over the library the port built (the same
    source and flags as native/Makefile's), so both bindings drive one
    compiled kernel and nothing is written under native/."""
    monkeypatch.setattr(jax_native, "_LIB_PATH", str(lib_path))
    monkeypatch.setattr(jax_native, "_lib", None)
    assert jax_native.available()
    return jax_native


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(0)
    t = np.arange(48000) / 48000
    return (0.3 * np.sin(2 * np.pi * 440 * t)
            + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


def test_build_goes_to_build_dir_and_leaves_native_alone(tmp_path,
                                                         monkeypatch):
    before = _sources()
    commands = []
    run = subprocess.run
    monkeypatch.setattr(native.subprocess, "run",
                        lambda cmd, **kw: (commands.append(cmd),
                                           run(cmd, **kw))[1])
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    assert native.load() is None and not native.available()
    lib = native.load(build_if_missing=True)
    path = native.library_path()
    assert lib is not None and path.exists()
    assert path.is_relative_to(tmp_path / "build")
    assert path.parent.name.startswith("native-")
    [cmd] = commands
    out = Path(cmd[cmd.index("-o") + 1])
    assert out.parent == path.parent and not out.is_relative_to(NATIVE_DIR)
    assert cmd[-1] == str(NATIVE_DIR / "audio_kernels.cpp")
    for flag in ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared"):
        assert flag in cmd
    assert sorted(p.name for p in path.parent.iterdir()) == [
        "libcookieaudio.so"]                 # the temporary name is gone
    assert _sources() == before
    # a second load builds nothing
    monkeypatch.setattr(native, "_lib", None)
    native.load(build_if_missing=True)
    assert len(commands) == 1


_BUILD = """
import sys
from pathlib import Path
from cookietts_tpu_torch.data import native
native.BUILD_ROOT = Path(sys.argv[1])
native.load(build_if_missing=True)
import numpy as np
print(native.bs1770_loudness(np.sin(np.arange(8000) / 5.0).astype(np.float32),
                             16000))
"""


def test_concurrent_builds_rename_into_place(tmp_path):
    """Three processes building the same library at once all load a whole
    file and leave no temporary one behind."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD,
                               str(tmp_path)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    assert len({o.strip() for o, _ in outs}) == 1
    [d] = list(tmp_path.iterdir())
    assert sorted(p.name for p in d.iterdir()) == ["libcookieaudio.so"]


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    cxx = tmp_path / "broken-cxx"
    cxx.write_text("#!/bin/sh\necho 'audio_kernels.cpp: error: boom' >&2\n"
                   "exit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="error: boom"):
        native.load(build_if_missing=True)
    assert not native.library_path().exists()
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run"):
        native.build_native()


def test_preprocess_raises_on_a_failed_build(tmp_path, monkeypatch):
    """preprocess builds the library before its pool and never drops to
    numpy quietly: a failed build stops it before any wav is rewritten."""
    from cookietts_tpu_torch.pipeline.preprocess import (PreprocessConfig,
                                                         run_preprocess)
    cxx = tmp_path / "broken-cxx"
    cxx.write_text("#!/bin/sh\necho 'error: no compiler here' >&2\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    wav = tmp_path / "ds" / "a.wav"
    wav.parent.mkdir()
    audio_io.save_wav(str(wav), np.zeros(8000, np.float32), 16000)
    before = wav.read_bytes()
    with pytest.raises(RuntimeError, match="no compiler here"):
        run_preprocess(PreprocessConfig(dataset_dirs=[str(wav.parent)],
                                        target_sr=22050,
                                        out_dir=str(tmp_path / "out")),
                       device="cpu")
    assert wav.read_bytes() == before and not (tmp_path / "out").exists()


def test_resample_matches_jax_binding_and_scipy(audio, jax_binding):
    y = native.resample(audio, 48000, 22050)
    np.testing.assert_array_equal(y, jax_binding.resample(audio, 48000, 22050))
    g = np.gcd(48000, 22050)
    y_s = scipy_signal.resample_poly(audio, 22050 // g, 48000 // g)
    n = min(len(y), len(y_s))
    assert abs(len(y) - len(y_s)) <= 1
    np.testing.assert_allclose(y[100:n - 100], y_s[100:n - 100], atol=5e-4)


def test_filtfilt_matches_jax_binding_and_scipy(audio, jax_binding):
    sos = scipy_signal.butter(2, 150, btype="highpass", fs=48000,
                              output="sos")
    f = native.sos_filtfilt(audio, sos)
    np.testing.assert_array_equal(f, jax_binding.sos_filtfilt(audio, sos))
    np.testing.assert_allclose(f[1000:-1000],
                               scipy_signal.sosfiltfilt(sos, audio)[1000:-1000],
                               atol=1e-5)


def test_loudness_matches_jax_binding_and_numpy(audio, jax_binding,
                                                monkeypatch):
    got = native.bs1770_loudness(audio, 48000)
    assert got == jax_binding.bs1770_loudness(audio, 48000)
    monkeypatch.setenv("COOKIETTS_DISABLE_NATIVE", "1")
    assert abs(got - audio_io.bs1770_loudness(audio, 48000)) < 1e-6


def test_trim_bounds_match_jax_binding(audio, jax_binding):
    padded = np.concatenate([np.zeros(8000, np.float32), audio,
                             np.zeros(8000, np.float32)])
    s, e = native.trim_bounds(padded, 2048, 512, 45.0)
    assert (s, e) == jax_binding.trim_bounds(padded, 2048, 512, 45.0)
    assert 8000 - 2048 - 512 < s <= 8000
    assert e >= len(padded) - 8000 - 512


def test_audio_io_takes_native_when_built_numpy_when_disabled(
        audio, lib_path, monkeypatch):
    sos = scipy_signal.butter(2, 150.0, btype="highpass", fs=48000,
                              output="sos")
    assert audio_io._native() is native
    np.testing.assert_array_equal(audio_io.resample(audio, 48000, 16000),
                                  native.resample(audio, 48000, 16000))
    np.testing.assert_array_equal(audio_io.butter_highpass(audio, 48000, 150.0),
                                  native.sos_filtfilt(audio, sos))
    padded = np.concatenate([np.zeros(8000, np.float32), audio])
    s, e = native.trim_bounds(padded, 2048, 512, 45.0)
    np.testing.assert_array_equal(audio_io.trim_silence(padded, 48000),
                                  padded[s:e])

    monkeypatch.setenv("COOKIETTS_DISABLE_NATIVE", "1")
    assert audio_io._native() is None
    np.testing.assert_array_equal(
        audio_io.resample(audio, 48000, 16000),
        scipy_signal.resample_poly(audio, 1, 3).astype(np.float32))
    np.testing.assert_array_equal(
        audio_io.butter_highpass(audio, 48000, 150.0),
        scipy_signal.sosfiltfilt(sos, audio).astype(np.float32))


def test_unbuilt_library_leaves_audio_io_on_numpy(tmp_path, monkeypatch,
                                                  audio):
    """The JAX package's rule: the native path only when already built."""
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "absent")
    monkeypatch.setattr(native, "_lib", None)
    assert audio_io._native() is None
    assert not (tmp_path / "absent").exists()
    np.testing.assert_array_equal(
        audio_io.resample(audio, 48000, 16000),
        scipy_signal.resample_poly(audio, 1, 3).astype(np.float32))

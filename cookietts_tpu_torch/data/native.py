"""ctypes bindings of the native audio kernels (native/audio_kernels.cpp;
cookietts_tpu/data/native.py).

The C++ library implements the preprocessing hot path: polyphase
resampling, zero-phase biquad filtering, the silence-trim bound search and
BS.1770 loudness. Every entry point has a numpy/scipy counterpart in
:mod:`.audio_io`, which takes the native path when the library is built.

The port compiles the source that is in the checkout with ``g++`` and the
flags of ``native/Makefile`` into ``build/cookietts_tpu_torch/native-<hash>/``
(the hash covers the source, the compiler, the flags and the CPU's
features, since ``-march=native`` builds for them), never into
``native/``. The library is written under a temporary name and renamed into
place, so processes that build at once (test workers, the preprocess pool)
never load a half-written file. A failed build raises with the compiler's
output.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "audio_kernels.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "cookietts_tpu_torch"
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall"]

_lib: Optional[ctypes.CDLL] = None


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def _cpu_flags() -> str:
    """The host CPU's feature flags: ``-march=native`` builds for them, so a
    library built on another machine's CPU is not reused."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((ln for ln in f if ln.startswith("flags")), "")
    except OSError:
        return ""


def library_path() -> Path:
    """Where the library of this source, compiler, flags and CPU lives."""
    return _library_path(_cxx(), str(BUILD_ROOT))


@functools.lru_cache(maxsize=8)
def _library_path(cxx: str, root: str) -> Path:
    h = hashlib.sha256(" ".join([cxx, *CXXFLAGS]).encode())
    h.update(_cpu_flags().encode())
    h.update(SOURCE.read_bytes())
    return Path(root) / f"native-{h.hexdigest()[:16]}" / "libcookieaudio.so"


def build_native() -> Path:
    """Compile the library (reused when already built); returns its path.
    Raises RuntimeError with the compiler's output if the build fails."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(
        f"libcookieaudio.{os.getpid()}.{threading.get_ident()}.tmp.so")
    cmd = [_cxx(), *CXXFLAGS, "-shared", "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native audio build: cannot run {cmd[0]}: {e}"
                           ) from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native audio build failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load(build_if_missing: bool = False) -> Optional[ctypes.CDLL]:
    """The loaded library; None when it is not built and
    ``build_if_missing`` is False."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        if not build_if_missing:
            return None
        build_native()
    lib = ctypes.CDLL(str(path))
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    longp = ctypes.POINTER(ctypes.c_long)

    lib.resample_poly.restype = ctypes.c_long
    lib.resample_poly.argtypes = [f32p, ctypes.c_long, ctypes.c_int,
                                  ctypes.c_int, f32p, ctypes.c_long]
    lib.sos_filtfilt.restype = None
    lib.sos_filtfilt.argtypes = [f32p, ctypes.c_long, f64p, ctypes.c_int]
    lib.trim_bounds.restype = None
    lib.trim_bounds.argtypes = [f32p, ctypes.c_long, ctypes.c_long,
                                ctypes.c_long, ctypes.c_double, longp,
                                longp]
    lib.bs1770_loudness.restype = ctypes.c_double
    lib.bs1770_loudness.argtypes = [f32p, ctypes.c_long, ctypes.c_int]
    _lib = lib
    return lib


def available() -> bool:
    return load() is not None


def _loaded() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError("the native audio library is not built: call "
                           "native.load(build_if_missing=True) first")
    return lib


def _f32(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, np.float32)


def _ptr(x: np.ndarray, ctype=ctypes.c_float):
    return x.ctypes.data_as(ctypes.POINTER(ctype))


def resample(audio: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    lib = _loaded()
    g = int(np.gcd(sr, target_sr))
    up, down = target_sr // g, sr // g
    x = _f32(audio)
    out_cap = (len(x) * up + down - 1) // down + 8
    out = np.empty(out_cap, np.float32)
    n = lib.resample_poly(_ptr(x), len(x), up, down, _ptr(out), out_cap)
    return out[:n].copy()


def sos_filtfilt(audio: np.ndarray, sos: np.ndarray) -> np.ndarray:
    """sos: [n_sections, 6] scipy layout (b0 b1 b2 a0 a1 a2, a0=1)."""
    lib = _loaded()
    x = _f32(audio).copy()
    sos = np.asarray(sos, np.float64)
    coef = np.ascontiguousarray(
        np.concatenate([sos[:, :3], sos[:, 4:6]], axis=1))  # drop a0
    lib.sos_filtfilt(_ptr(x), len(x), _ptr(coef, ctypes.c_double),
                     coef.shape[0])
    return x


def trim_bounds(audio: np.ndarray, frame: int, hop: int,
                top_db: float) -> Tuple[int, int]:
    lib = _loaded()
    x = _f32(audio)
    start = ctypes.c_long()
    end = ctypes.c_long()
    lib.trim_bounds(_ptr(x), len(x), frame, hop, top_db, ctypes.byref(start),
                    ctypes.byref(end))
    return start.value, end.value


def bs1770_loudness(audio: np.ndarray, sr: int) -> float:
    lib = _loaded()
    x = _f32(audio)
    return float(lib.bs1770_loudness(_ptr(x), len(x), sr))

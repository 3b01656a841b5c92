"""DIO fundamental-frequency estimation, ported to numpy (a copy of
cookietts_tpu/data/dio.py: the port imports nothing of the JAX package).

The reference extracts f0 with pyworld's ``dio`` (the WORLD vocoder's
C++ estimator) at default limits 71-800 Hz and the mel hop as frame
period (CookieTTS/utils/dataset/data_utils.py:815-838 — DIO only, no
StoneMask refinement). pyworld is unavailable here, so this is an
in-repo port of the algorithm (M. Morise, H. Kawahara, H. Katayose:
"Fast and reliable F0 estimation method based on the period extraction
of vocal fold vibration of singing voice and speech", AES 2009):

1. band-pass the signal with half-octave-spaced Nuttall low-pass
   filters between f0_floor and f0_ceil;
2. in each band, read FOUR interval-based instantaneous-F0 tracks from
   the zero crossings of the waveform (negative- and positive-going)
   and of its first difference (peaks and dips) — for a clean sinusoid
   of the band's frequency all four agree, so their standard deviation
   scores the band's reliability per frame;
3. pick the band whose candidate maximizes f0/(deviation+eps) per
   frame, then clean the contour: drop frame-to-frame jumps beyond
   ``allowed_range``, drop voiced runs too short to be speech, and
   re-extend segment edges from the per-band candidate pool.

Accuracy is validated on synthetic signals with known ground truth
(tests/test_features.py): pure tones, vibrato, harmonic complexes with
a dominant 2nd harmonic (the classic octave-error trap for the
autocorrelation estimator this replaces as the default).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

_EPS = 1e-12
_BIG_DEV = 1e5


def _nuttall(n: int) -> np.ndarray:
    t = np.arange(n) * (2.0 * np.pi / max(n - 1, 1))
    return (0.355768 - 0.487396 * np.cos(t) + 0.144232 * np.cos(2 * t)
            - 0.012604 * np.cos(3 * t))


def _zero_crossing_track(s: np.ndarray, fs: float
                         ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Negative-going zero crossings of ``s`` -> (interval midpoints [s],
    interval-based f0 [Hz]); None when fewer than 3 crossings."""
    pos = s > 0.0
    idx = np.where(pos[:-1] & ~pos[1:])[0]
    if len(idx) < 3:
        return None
    frac = s[idx] / (s[idx] - s[idx + 1] + _EPS)
    t = (idx + frac) / fs
    dt = np.diff(t)
    good = dt > _EPS
    if good.sum() < 2:
        return None
    f0 = 1.0 / dt[good]
    loc = ((t[:-1] + t[1:]) / 2.0)[good]
    return loc, f0


def _band_candidate(filtered: np.ndarray, fs: float,
                    temporal: np.ndarray, boundary_f0: float,
                    f0_floor: float, f0_ceil: float
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-frame (candidate f0, deviation) for one band."""
    n = len(temporal)
    diff = np.diff(filtered)
    tracks = [
        _zero_crossing_track(filtered, fs),          # negative-going
        _zero_crossing_track(-filtered, fs),         # positive-going
        _zero_crossing_track(diff, fs),              # peaks
        _zero_crossing_track(-diff, fs),             # dips
    ]
    if any(t is None for t in tracks):
        return np.zeros(n), np.full(n, _BIG_DEV)
    interp = np.stack([np.interp(temporal, loc, f0)
                       for loc, f0 in tracks])       # [4, n]
    cand = interp.mean(axis=0)
    dev = np.sqrt(np.sum((interp - cand) ** 2, axis=0) / 3.0)
    bad = ((cand > boundary_f0) | (cand < boundary_f0 / 2.0)
           | (cand > f0_ceil) | (cand < f0_floor))
    cand = np.where(bad, 0.0, cand)
    dev = np.where(bad, _BIG_DEV, dev)
    return cand, dev


def _voiced_runs(f0: np.ndarray) -> List[Tuple[int, int]]:
    """[start, end) index pairs of contiguous voiced (f0 > 0) runs."""
    v = np.concatenate([[0], (f0 > 0).astype(np.int8), [0]])
    d = np.diff(v)
    starts = np.where(d == 1)[0]
    ends = np.where(d == -1)[0]
    return list(zip(starts, ends))


def _fix_contour(best: np.ndarray, cand: np.ndarray,
                 frame_period_ms: float, f0_floor: float,
                 allowed_range: float) -> np.ndarray:
    """Contour cleaning (DIO's fix steps): drop over-``allowed_range``
    frame-to-frame jumps, drop voiced runs shorter than one vocal-fold
    period's worth of frames, then re-extend run edges from the
    candidate pool where a band agrees within the allowed range."""
    n = len(best)
    vrm = int(0.5 + 1000.0 / frame_period_ms / f0_floor) * 2 + 1
    # step 1: relative-jump removal
    f0 = best.copy()
    for i in range(1, n):
        if f0[i] <= 0 or f0[i - 1] <= 0:
            continue
        if abs(f0[i] - f0[i - 1]) / f0[i] > allowed_range:
            f0[i] = 0.0
    # step 2: voiced runs shorter than vrm frames are spurious
    for s, e in _voiced_runs(f0):
        if e - s < vrm:
            f0[s:e] = 0.0
    # steps 3/4: extend each run forward/backward with the closest
    # in-range candidate from any band
    def closest(i, ref):
        c = cand[:, i]
        ok = c > 0
        if not ok.any():
            return 0.0
        j = np.argmin(np.where(ok, np.abs(c - ref), np.inf))
        val = c[j]
        return val if abs(val - ref) / max(ref, _EPS) <= allowed_range \
            else 0.0

    for s, e in _voiced_runs(f0):
        i = e
        ref = f0[e - 1]
        while i < n and f0[i] <= 0:
            val = closest(i, ref)
            if val <= 0:
                break
            f0[i] = ref = val
            i += 1
        i = s - 1
        ref = f0[s]
        while i >= 0 and f0[i] <= 0:
            val = closest(i, ref)
            if val <= 0:
                break
            f0[i] = ref = val
            i -= 1
    return f0


def dio(x: np.ndarray, fs: int, f0_floor: float = 71.0,
        f0_ceil: float = 800.0, channels_in_octave: float = 2.0,
        frame_period_ms: float = 5.0, allowed_range: float = 0.1
        ) -> Tuple[np.ndarray, np.ndarray]:
    """Estimate f0 of ``x`` -> (f0 [n_frames] float32, times [s]).

    Unvoiced frames are 0, matching pyworld's contract; pyworld's
    default parameters are the defaults here."""
    x = np.asarray(x, np.float64)
    n_frames = int(len(x) / fs * 1000.0 / frame_period_ms) + 1
    temporal = np.arange(n_frames) * frame_period_ms / 1000.0
    n_bands = max(int(np.ceil(np.log2(f0_ceil / f0_floor)
                              * channels_in_octave)), 1)
    boundaries = f0_floor * 2.0 ** ((np.arange(n_bands) + 1)
                                    / channels_in_octave)

    # one spectrum of the drift-removed signal, reused by every band;
    # the margin leaves room for the longest filter's tail
    longest = 4 * int(round(fs / boundaries[0] / 2.0))
    fft_size = 1 << int(np.ceil(np.log2(len(x) + longest + 1)))
    y = x - x.mean()
    spec = np.fft.rfft(y, fft_size)
    freqs = np.fft.rfftfreq(fft_size, 1.0 / fs)
    spec = spec * np.clip(freqs / 50.0, 0.0, 1.0)     # low-cut drift

    cand = np.zeros((n_bands, n_frames))
    dev = np.full((n_bands, n_frames), _BIG_DEV)
    for b, bf in enumerate(boundaries):
        half = max(int(round(fs / bf / 2.0)), 2)
        w = _nuttall(4 * half)
        lpf = np.fft.rfft(w, fft_size)
        full = np.fft.irfft(spec * lpf, fft_size)
        delay = (4 * half - 1) // 2                  # linear-phase FIR
        filtered = full[delay: delay + len(x)]
        cand[b], dev[b] = _band_candidate(filtered, float(fs), temporal,
                                          float(bf), f0_floor, f0_ceil)

    score = cand / (dev + _EPS)
    pick = np.argmax(score, axis=0)
    best = cand[pick, np.arange(n_frames)]
    f0 = _fix_contour(best, cand, frame_period_ms, f0_floor,
                      allowed_range)
    return f0.astype(np.float32), temporal

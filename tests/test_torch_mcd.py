"""The port's mel-cepstral distortion and f0 metrics (cookietts_tpu_torch/
ops/mcd.py) against the JAX package's (cookietts_tpu/ops/mcd.py) on seeded
inputs: the same floats, bit for bit (both are host numpy and scipy)."""
import numpy as np
import pytest

from cookietts_tpu.ops import mcd as jax_mcd
from cookietts_tpu_torch import ops
from test_torch_threads import _one_thread  # noqa: F401


def mels(seed, T_a=23, T_b=19, n_mel=80):
    rng = np.random.default_rng(seed)
    return (rng.normal(-5, 2, (T_a, n_mel)).astype(np.float32),
            rng.normal(-5, 2, (T_b, n_mel)).astype(np.float32))


@pytest.mark.parametrize("n_mfcc", [13, 25])
def test_cepstrum_is_jax_s(n_mfcc):
    a, _ = mels(0)
    got = ops.cepstrum_from_mel(a, n_mfcc)
    want = jax_mcd.cepstrum_from_mel(a, n_mfcc)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("exclude_c0", [True, False])
def test_mcd_is_jax_s(exclude_c0):
    for seed in range(3):
        a, b = mels(seed)
        assert ops.mcd(a, b, exclude_c0=exclude_c0) == jax_mcd.mcd(
            a, b, exclude_c0=exclude_c0)


def test_mcd_dtw_is_jax_s():
    """Short mels: the DTW loop is Python."""
    for seed in range(2):
        a, b = mels(seed, 17, 12, 40)
        got = ops.mcd_dtw(a, b)
        assert got == jax_mcd.mcd_dtw(a, b) and np.isfinite(got)
    a, _ = mels(5, 9, 9, 40)
    assert ops.mcd_dtw(a, a) == jax_mcd.mcd_dtw(a, a) == 0.0


@pytest.mark.parametrize("voiced", ["some", "one", "none"])
def test_f0_metrics_are_jax_s(voiced):
    """Co-voiced frames, a single co-voiced frame (correlation undefined:
    zeros), and none at all."""
    rng = np.random.default_rng(7)
    a = rng.uniform(80, 300, 40)
    b = a + rng.normal(0, 10, 40)
    if voiced == "some":
        a[rng.random(40) < 0.3] = 0
        b[rng.random(40) < 0.3] = 0
    elif voiced == "one":
        a[1:] = 0
    else:
        a[:] = 0
    got = ops.f0_metrics(a, b[:35])
    assert got == jax_mcd.f0_metrics(a, b[:35])
    if voiced != "some":
        assert got[0] == got[2] == 0.0

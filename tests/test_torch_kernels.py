"""The plain versions of the port's Hopper kernels against the JAX functions
they replace, on the CPU.

JAX runs its Pallas kernels in interpret mode here (``use_pallas=True``) as
well as its plain jnp path. The CUDA kernels themselves need the card:
``chip_smoke.py`` holds them against these plain versions there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cookietts_tpu.models.hifigan import Generator as JGenerator
from cookietts_tpu.models.hifigan import HiFiGANConfig as JConfig
from cookietts_tpu.ops.pallas_kernels import attention_step as j_attention_step
from cookietts_tpu.ops.pallas_kernels import lstm_gates_step as j_lstm_gates_step

from cookietts_tpu_torch.convert.from_jax import hifigan_state_dict_from_jax
from cookietts_tpu_torch.models.hifigan import Generator, HiFiGANConfig
from cookietts_tpu_torch.ops import _build
from cookietts_tpu_torch.ops import hopper_kernels as hk


def _attention_inputs(B=3, T=37, A=48, D=56, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    lengths = np.array([T, T - 9, T - 20])[:B]
    mask = np.arange(T)[None, :] < lengths[:, None]
    mask[1, :5] = False                      # a window start, as decode makes
    return f(B, A), f(B, T, A), f(B, T, A), f(A), f(B, T, D), mask


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("scale", [None, 1.7])
def test_attention_step_matches_jax(use_pallas, scale):
    qp, lp, mp, v, mem, mask = _attention_inputs()
    # an energy scale s equals the JAX step with v scaled by s
    v_j = v if scale is None else v * np.float32(scale)
    ctx_r, w_r = j_attention_step(*(jnp.asarray(a) for a in
                                    (qp, lp, mp, v_j, mem, mask)),
                                  use_pallas=use_pallas)
    t = [torch.from_numpy(a) for a in (qp, lp, mp, v, mem, mask)]
    ctx, w = hk.attention_step(
        *t, None if scale is None else torch.tensor([scale], dtype=torch.float32))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_r), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(ctx_r),
                               atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("H", [128, 384])
def test_lstm_gates_matches_jax(use_pallas, H):
    # 128-aligned dims, so the Pallas path really runs (multi-tile at 384)
    rng = np.random.default_rng(H)
    In = 128
    xh = (rng.standard_normal((3, In + H)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((In + H, 4 * H)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((4 * H,)) * 0.05).astype(np.float32)
    c = (rng.standard_normal((3, H)) * 0.5).astype(np.float32)
    c_r, h_r = j_lstm_gates_step(*(jnp.asarray(a) for a in (xh, k, b, c)),
                                 use_pallas=use_pallas)
    c_p, h_p = hk.lstm_gates(*(torch.from_numpy(a) for a in (xh, k, b, c)))
    np.testing.assert_allclose(c_p.numpy(), np.asarray(c_r), atol=1e-5, rtol=0)
    np.testing.assert_allclose(h_p.numpy(), np.asarray(h_r), atol=1e-5, rtol=0)


def test_hifigan_resblock_matches_jax_fused_generator():
    """The port's generator (MRF through hifigan_resblock) against the JAX
    generator with its fused Pallas resblocks, in interpret mode."""
    cfg = dict(n_mel_channels=8, upsample_rates=(4, 2),
               upsample_kernel_sizes=(8, 4), upsample_initial_channel=32,
               resblock_kernel_sizes=(3, 5), resblock_dilations=((1, 2), (1, 2)))
    jg = JGenerator(JConfig(**cfg, pallas_tile=256, pallas_resblocks=True))
    mel = np.random.default_rng(0).standard_normal((2, 40, 8)).astype(np.float32)
    v = jg.init(jax.random.PRNGKey(0), jnp.asarray(mel))
    ref = np.asarray(jg.apply(v, jnp.asarray(mel), infer=True))
    port = Generator(HiFiGANConfig(**cfg), device="cpu")
    port.load_state_dict(hifigan_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, v["params"])))
    np.testing.assert_allclose(port(torch.from_numpy(mel)).numpy(), ref,
                               atol=2e-6, rtol=1e-5)


def test_hifigan_resblock_plain_is_torch_resblock():
    """The plain version equals the per-dilation conv chain it fuses."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 8, 50)).astype(np.float32))
    w = [torch.from_numpy((rng.standard_normal((2, 5, 8, 8)) * 0.2
                           ).astype(np.float32)) for _ in range(2)]
    b = [torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32))
         for _ in range(2)]
    y = hk.hifigan_resblock(x, w[0], b[0], w[1], b[1], (1, 3), 0.1)
    ref = x
    for p, d in enumerate((1, 3)):
        conv1 = torch.nn.Conv1d(8, 8, 5, dilation=d, padding=2 * d)
        conv2 = torch.nn.Conv1d(8, 8, 5, padding=2)
        with torch.no_grad():
            conv1.weight.copy_(w[0][p].permute(2, 1, 0))
            conv1.bias.copy_(b[0][p])
            conv2.weight.copy_(w[1][p].permute(2, 1, 0))
            conv2.bias.copy_(b[1][p])
            h = conv2(torch.nn.functional.leaky_relu(
                conv1(torch.nn.functional.leaky_relu(ref, 0.1)), 0.1))
        ref = ref + h
    np.testing.assert_allclose(y.numpy(), ref.numpy(), atol=1e-5, rtol=0)


def test_wrappers_refuse_other_devices():
    t = torch.empty(2, 4, device="meta")
    with pytest.raises(ValueError):
        hk.lstm_gates(t, torch.empty(4, 4, device="meta"),
                      torch.empty(4, device="meta"), torch.empty(2, 1, device="meta"))


def test_kernels_have_no_backward_yet():
    with pytest.raises(NotImplementedError):
        hk._NoBackward.backward(None, torch.zeros(1))


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()

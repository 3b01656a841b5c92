"""The plain versions of the port's Hopper kernels against the JAX functions
they replace, on the CPU.

JAX runs its Pallas kernels in interpret mode here (``use_pallas=True``) as
well as its plain jnp path. The CUDA kernels themselves need the card:
``chip_smoke.py`` holds them against these plain versions there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cookietts_tpu.models.hifigan import Generator as JGenerator
from cookietts_tpu.models.hifigan import HiFiGANConfig as JConfig
from cookietts_tpu.ops.pallas_kernels import attention_step as j_attention_step
from cookietts_tpu.ops.pallas_kernels import lstm_gates_step as j_lstm_gates_step
from cookietts_tpu.ops.pallas_kernels import waveflow_row_step as j_waveflow_row_step
from cookietts_tpu.ops.pallas_kernels import waveglow_wn_forward as j_waveglow_wn_forward

from cookietts_tpu_torch.convert.from_jax import hifigan_state_dict_from_jax
from cookietts_tpu_torch.models.hifigan import Generator, HiFiGANConfig
from cookietts_tpu_torch.ops import _build
from cookietts_tpu_torch.ops import hopper_kernels as hk
from test_torch_threads import _one_thread  # noqa: F401


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
    # D = 37 is odd, as the decoder memory without its bottleneck (1313)
    for D in (56, 37):
        qp, lp, mp, v, mem, mask = _attention_inputs(D=D)
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
    np.testing.assert_allclose(port(torch.from_numpy(mel), infer=True).numpy(), ref,
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


@pytest.mark.parametrize("d", [1, 3, 5])
@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("C", [6, 8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512])
def test_hifigan_resblock_plan_fits_and_covers(C, k, d):
    """Every HiFi-GAN width from 6 to 512 channels (those of 512- and
    384-wide generators among them), with the kernel sizes and dilations of
    the repo's configurations: the launch fits a block's shared memory,
    fuses the pair at C of 8 to 64, and its tiles cover [0, T) and the
    channels exactly once, padding the channels by the least of the split
    variant's row counts."""
    for T in (1, 100, 1024, 4096 + 7):
        tile, grid, smem, variant = hk.hifigan_resblock_plan(3, C, T, k, d)
        assert smem <= 232448
        assert variant == ("fused" if C in (8, 16, 32, 64) else "split")
        if variant == "split":
            rows = hk.resblock_split_rows(C)
            assert grid[1:] == (-(-C // rows), 3)
            assert rows * grid[1] - C < 32 and (C % 128 or rows == 128)
        else:
            assert grid[1:] == (3, 1)
        covered = np.zeros(T, np.int64)
        for x in range(grid[0]):
            covered[x * tile:min(T, (x + 1) * tile)] += 1
        assert (covered == 1).all() and grid[0] * tile - T < tile


def test_hifigan_resblock_plan_refuses_what_the_kernel_does_not_take():
    for C, k, d in ((32, 4, 1), (96, 4, 1), (0, 3, 1), (256, 11, 60)):
        with pytest.raises(ValueError):
            hk.hifigan_resblock_plan(1, C, 100, k, d)
    assert hk.hifigan_resblock_launches(64, 3) == 3
    assert hk.hifigan_resblock_launches(256, 3) == 6
    assert hk.hifigan_resblock_launches(96, 3) == 6


@pytest.mark.parametrize("B", [1, 4, 32, 128])
@pytest.mark.parametrize("F,H", [(2816, 1280), (2560, 768), (1536, 768)])
def test_lstm_gates_plan_assigns_w_once(B, F, H):
    """Each element of W belongs to exactly one block of a row group, the
    grid is about two blocks per SM, and the scratch sizes match."""
    plan = hk.lstm_gates_plan(B, F, H)
    tiles, slices, groups = plan.grid
    assert slices == plan.slices and groups == -(-B // 32)
    assert 132 <= tiles * slices * groups <= 264
    owner = np.zeros((F, H), np.int64)
    for y in range(slices):
        rows = slice(y * plan.f_per_slice, min(F, (y + 1) * plan.f_per_slice))
        assert rows.start < F
        for x in range(tiles):
            owner[rows, x * hk.LSTM_COLS:min(H, (x + 1) * hk.LSTM_COLS)] += 1
    assert (owner == 1).all()
    assert plan.partial == slices * B * 4 * H
    assert plan.tickets == groups * tiles


@pytest.mark.parametrize("T", [250, 1500, 10000, 30000])
@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("C", [32, 64, 128, 256])
def test_wn_layer_plan_fits_and_covers(C, rows, T):
    """Both launches of a WN layer at every width the kernels take, for
    WaveGlow's one row and WaveFlow's three: each fits a block's shared
    memory and stages a window as wide as its taps read, its blocks write
    every (batch row, output channel, sample) exactly once, and from
    T' = 1500 on a single batch row gives every SM of the card a block."""
    for B in (1, 2):
        plan = hk.wn_layer_plan(B, C, T, rows, 3)
        for launch, kw in ((plan.conv, 3), (plan.rs, 1)):
            wm, wn, nj = hk.WN_TILES[launch.tile]
            m, n = launch.m, launch.n
            assert (m, n, launch.threads) == (16 * wm, 8 * wn * nj, 32 * wm * wn)
            assert launch.smem <= 232448
            assert launch.win_stride >= kw * n
            gx, gy, gz = launch.grid
            covered = np.zeros((B, C, T), np.uint8)
            for z in range(gz):
                for y in range(gy):
                    for x in range(gx):
                        covered[z, y * m:(y + 1) * m, x * n:(x + 1) * n] += 1
            assert (covered == 1).all() and gx * n - T < n
            if T >= 1500 and B == 1:
                assert launch.blocks >= 132


def test_wn_layer_plan_refuses_what_the_kernels_do_not_take():
    for C, kw in ((0, 3), (64, 4), (64, 0)):
        with pytest.raises(ValueError):
            hk.wn_layer_plan(1, C, 100, 1, kw)
    with pytest.raises(ValueError):
        hk.wn_launch(0, 1, 32, 100, 401)     # a window past shared memory


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("C", [24, 48, 96, 384, 512])
def test_wn_layer_plan_takes_every_width(C, rows):
    """Widths past 256 and widths that are not a multiple of 32 (or of a
    block's channel pairs) plan too: the last channel block and K step are
    staged with zeros past C, so a launch's blocks cover C rounded up to
    its channel block exactly once, the block that pads C least is taken,
    and the tiles fit shared memory whatever C (C = 512 is WaveFlow's
    reference width)."""
    for B, T in ((1, 250), (4, 1500)):
        plan = hk.wn_layer_plan(B, C, T, rows, 3)
        for launch, kw in ((plan.conv, 3), (plan.rs, 1)):
            m = launch.m
            pad = min(-(-C // (16 * wm)) * 16 * wm for wm, _, _ in hk.WN_TILES)
            assert launch.grid[1] * m == pad and launch.grid[1] * m >= C
            assert launch.grid[0] * launch.n >= T and launch.grid[2] == B
            assert launch.smem <= hk.SMEM_MAX and launch.win_stride >= kw * launch.n
        assert len(plan.ints()) == 6


@pytest.mark.parametrize("C,L,B,T", [
    (192, 3, 4, 1024), (192, 3, 8, 200), (192, 3, 1, 5),
    (64, 2, 4, 8), (64, 2, 1, 2), (64, 2, 8, 30)])
def test_wn_layer_plan_at_untts_widths(C, L, B, T):
    """UnTTS's WNs: the mel decoder's (C = 192, a request's frames) and
    VarGlow's (C = 64 over char groups, T' down to 2, below one block's
    samples): each launch fits shared memory and its blocks cover every
    (batch row, channel, sample) once; a call makes wn_launches(L)."""
    plan = hk.wn_layer_plan(B, C, T, 1, 3)
    for launch, kw in ((plan.conv, 3), (plan.rs, 1)):
        gx, gy, gz = launch.grid
        assert launch.smem <= hk.SMEM_MAX and launch.win_stride >= kw * launch.n
        assert gy * launch.m == C and gz == B
        assert gx * launch.n >= T > (gx - 1) * launch.n
    assert hk.wn_launches(L) == 2 * L + 2


def test_wn_launches_follow_the_plan():
    """Each layer makes the plan's launches (the conv, then res/skip); the
    start and end products make two more."""
    per_layer = len(dataclasses.fields(hk.WnPlan))
    for L in (1, 4, 8):
        assert hk.wn_launches(L) == 2 + per_layer * L
    plan = hk.wn_layer_plan(1, 64, 500, 3, 3)
    assert list(plan.ints()) == [getattr(launch, k) for launch in (plan.conv, plan.rs)
                                 for k in ("tile", "win_stride", "smem")]


def _tf32(a):
    """What the tensor core reads of an f32 operand in a TF32 product: the
    top 10 mantissa bits, the 13 low bits cleared."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _products(mode):
    """w [K, M], x [K, N] -> w^T x in f64 ("f64"), in f32 ("f32", the plain
    version), or as the tensor cores compute it in 3xTF32 ("3x": lo*hi +
    hi*lo + hi*hi with hi = tf32(a), lo = tf32(a - hi)) or 1xTF32 ("1x":
    hi*hi)."""
    def prod(w, x):
        if mode == "f64":
            return w.T.astype(np.float64) @ x.astype(np.float64)
        if mode == "f32":
            return w.T @ x
        wh, xh = _tf32(w), _tf32(x)
        if mode == "1x":
            return wh.T @ xh
        wl, xl = _tf32(w - wh), _tf32(x - xh)
        return wl.T @ xh + wh.T @ xl + wh.T @ xh
    return prod


def _shifted(a, off):
    """a [C, T] shifted by off samples (out[:, t] = a[:, t + off]), zeros
    outside [0, T)."""
    out = np.zeros_like(a)
    T = a.shape[1]
    lo, hi = max(0, -off), min(T, T - off)
    out[:, lo:hi] = a[:, lo + off:hi + off]
    return out


def _emulated_wn(prod, x, queues, cond, weights, rows, kw):
    """One WN evaluation as wn_layer.cuh computes it: the conv and res/skip
    products through ``prod``, the start and end products in f32 (the
    kernels' scalar start and end). x [Cin, T]; queues [L, rows-1, C, T]:
    each layer's earlier input rows, oldest first; cond [L, 2C, T]."""
    start_w, start_b, k_all, rs_w, rs_b, end_w, end_b = weights
    L, C = rs_w.shape[:2]
    h = start_w.T @ x + start_b[:, None]
    skip = 0
    for i in range(L):
        d = 2 ** i
        ins = list(queues[i]) + [h]
        cols = np.concatenate([_shifted(ins[r], (tap - kw // 2) * d)
                               for r in range(rows) for tap in range(kw)])
        acts = prod(k_all[i], cols) + cond[i]
        z = np.tanh(acts[:C]) / (1 + np.exp(-acts[C:]))
        rs = prod(rs_w[i], z) + rs_b[i][:, None]
        if i < L - 1:
            h = h + rs[:C]
        skip = skip + rs[C:]
    return end_w.T @ skip + end_b[:, None]


@pytest.mark.parametrize("case", ["resblock", "waveglow_wn", "waveflow_wn"])
def test_3xtf32_keeps_f32_accuracy_where_1xtf32_does_not(case):
    """Why hifigan_resblock.cu and wn_layer.cuh take three tensor-core
    products, emulated in numpy: a k=11, C=64 dilated conv as the resblock
    kernel computes it; a whole WN (C=64, 4 layers, T'=256, the weight
    scales of chip_smoke.py) as the WN kernels do, WaveGlow-like (one row,
    3 taps) and WaveFlow-like (3 rows x 3 taps). With hi = tf32(a) and
    lo = a - hi (itself read as TF32), lo*hi + hi*lo + hi*hi stays within
    the kernels' tolerance against their f32 plain versions; hi*hi alone
    misses it."""
    rng = np.random.default_rng(0)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    if case == "resblock":
        C, k, d, T = 64, 11, 3, 256
        x = f(C, T)
        w = f(k, C, C, scale=(C * k) ** -0.5)
        xp = np.pad(x, ((0, 0), (d * (k // 2),) * 2))
        cols = np.concatenate([xp[:, j * d:j * d + T] for j in range(k)])  # [kC, T]
        wm = w.reshape(k * C, C)                                           # [kC, Co]
        run = lambda mode: _products(mode)(wm, cols)
        tol = (1e-4, 1e-4)
    else:
        rows, Cin = (1, 4) if case == "waveglow_wn" else (3, 1)
        C, L, kw, T = 64, 4, 3, 256
        K = rows * kw * C
        rs_w = f(L, C, 2 * C, scale=C ** -0.5)
        rs_b = f(L, 2 * C, scale=0.1)
        rs_w[-1, :, :C] = 0                  # the last layer has no res half
        rs_b[-1, :C] = 0
        weights = (f(Cin, C, scale=Cin ** -0.5), f(C, scale=0.1),
                   f(L, K, 2 * C, scale=K ** -0.5), rs_w, rs_b,
                   f(C, 2 * Cin, scale=(C * L) ** -0.5), f(2 * Cin, scale=0.1))
        x, queues, cond = f(Cin, T), f(L, rows - 1, C, T), f(L, 2 * C, T)
        run = lambda mode: _emulated_wn(_products(mode), x, queues, cond,
                                        weights, rows, kw)
        tol = (2e-5, 1e-4)
    ref, f32, three, one = run("f64"), run("f32"), run("3x"), run("1x")
    scale = np.abs(ref).max()
    assert np.abs(f32 - ref).max() / scale < 1e-6
    assert np.abs(three - f32).max() / scale < 1e-5
    assert np.allclose(three, f32, atol=tol[0], rtol=tol[1])
    assert not np.allclose(one, f32, atol=tol[0], rtol=tol[1])
    assert np.abs(one - f32).max() > 10 * np.abs(three - f32).max()


def _wn_weights(rng, Cin, C, Cout, L, rows, kw):
    """Random WN weights in the port's layouts (hopper_kernels.py)."""
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    k = rows * kw * C
    rs_w, rs_b = f(L, C, 2 * C, scale=C ** -0.5), f(L, 2 * C, scale=0.1)
    rs_w[-1, :, :C] = 0                      # the last layer has no res half
    rs_b[-1, :C] = 0
    return (f(Cin, C), f(C, scale=0.1), f(L, k, 2 * C, scale=k ** -0.5), rs_w,
            rs_b, f(C, Cout, scale=C ** -0.5), f(Cout, scale=0.1))


def _padded(a, halo, Tp):
    """[B, C, T] -> the Pallas kernels' [C, B * T'] with a zero halo."""
    B, C, T = a.shape
    out = np.zeros((C, B, Tp), np.float32)
    out[:, :, halo:halo + T] = a.transpose(1, 0, 2)
    return out.reshape(C, B * Tp)


def _pad_rows(w, n):
    return np.pad(w, ((0, n - w.shape[0]), (0, 0)))


@pytest.mark.parametrize("B,T", [(2, 200), (1, 300)])
def test_waveglow_wn_forward_matches_jax_pallas(B, T):
    """The plain version against the TPU kernel in interpret mode: the same
    weights in both layouts, looking at the whole width, both ends included
    (T > 2 * the reach of the dilations, 7)."""
    rng = np.random.default_rng(T)
    Cin, C, Cout, L, kw, halo, Wt = 4, 16, 8, 3, 3, 128, 128
    sw, sb, k_all, rs_w, rs_b, ew, eb = _wn_weights(rng, Cin, C, Cout, L, 1, kw)
    x = rng.standard_normal((B, Cin, T)).astype(np.float32)
    cond = rng.standard_normal((B, L, 2 * C, T)).astype(np.float32)
    Tp = 2 * halo + -(-T // Wt) * Wt
    cond_j = np.stack([_padded(cond[:, i], halo, Tp) for i in range(L)])
    st = j_waveglow_wn_forward(
        *(jnp.asarray(a) for a in (
            _pad_rows(_padded(x, halo, Tp), 16), cond_j,
            _pad_rows(sw, 16).T, sb[:, None], k_all.transpose(0, 2, 1),
            rs_w.transpose(0, 2, 1), rs_b, _pad_rows(ew.T, 16),
            _pad_rows(eb[:, None], 16))),
        L=L, kw=kw, C=C, Wt=Wt, halo=halo, T=T, B=B)
    ref = np.asarray(st)[:Cout].reshape(Cout, B, Tp)[:, :, halo:halo + T]
    got = hk.waveglow_wn_forward(*(torch.from_numpy(a) for a in (
        x, cond, sw, sb, k_all, rs_w, rs_b, ew, eb)))
    np.testing.assert_allclose(got.numpy(), ref.transpose(1, 0, 2), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("kh", [2, 3])
def test_waveflow_row_step_ring_matches_jax_pallas(kh):
    """Four consecutive rows through the port's ring against the TPU kernel
    in interpret mode with its queues, at a width that is not a multiple of
    128: (log_s, t) of every row and the queues after the last."""
    rng = np.random.default_rng(kh)
    B, W, C, L, kw, halo, Wt = 2, 150, 16, 3, 3, 128, 128
    weights = _wn_weights(rng, 1, C, 2, L, kh, kw)
    sw, sb, k_all, rs_w, rs_b, ew, eb = weights
    cond = rng.standard_normal((B, L, 2 * C, W)).astype(np.float32)
    Wp = 2 * halo + -(-W // Wt) * Wt
    cond_j = jnp.asarray(np.stack([_padded(cond[:, i], halo, Wp)
                                   for i in range(L)]))
    w_j = [jnp.asarray(a) for a in (
        sw.T, sb[:, None], k_all.transpose(0, 2, 1), rs_w.transpose(0, 2, 1),
        rs_b, ew.T, eb[:, None])]
    queues_j = jnp.zeros((L, kh - 1, C, B * Wp), jnp.float32)
    ring = torch.zeros(L, kh, B, C, W)
    w_t = [torch.from_numpy(a) for a in weights]
    x_prev = np.zeros((B, W), np.float32)
    for step in range(4):
        x_pad = np.zeros((B, Wp), np.float32)
        x_pad[:, halo:halo + W] = x_prev
        ls_r, t_r, queues_j = j_waveflow_row_step(
            jnp.asarray(x_pad), queues_j, cond_j, *w_j, L=L, kh=kh, kw=kw, C=C,
            Wt=Wt, halo=halo, W=W)
        log_s, t = hk.waveflow_row_step(torch.from_numpy(x_prev), ring, step,
                                        torch.from_numpy(cond), *w_t)
        for got, ref in ((log_s, ls_r), (t, t_r)):
            np.testing.assert_allclose(
                got.numpy(), np.asarray(ref)[:, halo:halo + W], atol=1e-5, rtol=0)
        x_prev = rng.standard_normal((B, W)).astype(np.float32)
    q_ref = np.asarray(queues_j).reshape(L, kh - 1, C, B, Wp)[..., halo:halo + W]
    np.testing.assert_allclose(hk.ring_queues(ring, 4).numpy(),
                               q_ref.transpose(0, 1, 3, 2, 4), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kh", [1, 2, 3])
def test_waveflow_ring_matches_plain_queues(kh):
    """The ring (slot step % kh, kernel rows rotated) against the plain
    version's queues (shift and append) over more rows than the ring has
    slots."""
    rng = np.random.default_rng(10 + kh)
    B, W, C, L = 2, 37, 8, 2
    w = [torch.from_numpy(a) for a in _wn_weights(rng, 1, C, 2, L, kh, 3)]
    cond = torch.from_numpy(rng.standard_normal((B, L, 2 * C, W)).astype(np.float32))
    ring = torch.zeros(L, kh, B, C, W)
    queues = torch.zeros(L, kh - 1, B, C, W)
    for step in range(2 * kh + 1):
        x_prev = torch.from_numpy(rng.standard_normal((B, W)).astype(np.float32))
        log_s, t = hk.waveflow_row_step(x_prev, ring, step, cond, *w)
        ls_p, t_p, queues = hk.waveflow_row_step_plain(x_prev, queues, cond, *w)
        assert torch.equal(log_s, ls_p) and torch.equal(t, t_p)
        assert torch.equal(hk.ring_queues(ring, step + 1), queues)


def test_waveglow_wn_forward_pads_with_zeros_at_both_ends():
    """The start bias must not leak into the padding: the plain version on a
    sequence equals its middle part computed with explicit zero-padded h."""
    rng = np.random.default_rng(5)
    Cin, C, L, kw, T = 2, 8, 3, 3, 40
    w = [torch.from_numpy(a) for a in _wn_weights(rng, Cin, C, 4, L, 1, kw)]
    x = torch.from_numpy(rng.standard_normal((1, Cin, T)).astype(np.float32))
    cond = torch.from_numpy(rng.standard_normal((1, L, 2 * C, T)).astype(np.float32))
    st = hk.waveglow_wn_forward(x, cond, *w)
    sw, sb, k_all, rs_w, rs_b, ew, eb = w
    h = sw.t() @ x[0] + sb[:, None]
    skip = torch.zeros(C, T)
    for i in range(L):
        d = 2 ** i
        hp = torch.nn.functional.pad(h, (d, d))
        taps = torch.cat([hp[:, j * d:j * d + T] for j in range(kw)])
        acts = k_all[i].t() @ taps + cond[0, i]
        rs = rs_w[i].t() @ (torch.tanh(acts[:C]) * torch.sigmoid(acts[C:])) + rs_b[i][:, None]
        h, skip = h + rs[:C], skip + rs[C:]
    np.testing.assert_allclose(st[0].numpy(), (ew.t() @ skip + eb[:, None]).numpy(),
                               atol=1e-5, rtol=0)


def test_launch_counters_cover_every_kernel():
    assert set(hk.LAUNCHES) == {"attention_step", "lstm_gates", "hifigan_resblock",
                                "waveglow_wn_forward", "waveflow_row_step",
                                "attention_step_bf16", "lstm_gates_bf16",
                                "hifigan_resblock_bf16", "waveglow_wn_forward_bf16",
                                "waveflow_row_step_bf16"}
    assert hk.wn_launches(8) == 18
    hk.LAUNCHES["waveglow_wn_forward"] = 3
    hk.reset_launch_counts()
    assert not any(hk.LAUNCHES.values())


@pytest.mark.parametrize("name", ["waveglow_wn_forward", "waveflow_row_step"])
def test_wn_wrappers_refuse_other_devices(name):
    m = lambda *s: torch.empty(*s, device="meta")
    w = (m(1, 8), m(8), m(2, 24, 16), m(2, 8, 16), m(2, 16), m(8, 2), m(2))
    with pytest.raises(ValueError, match="unsupported device"):
        if name == "waveglow_wn_forward":
            hk.waveglow_wn_forward(m(1, 1, 5), m(1, 2, 16, 5), *w)
        else:
            hk.waveflow_row_step(m(1, 5), m(2, 1, 1, 8, 5), 0, m(1, 2, 16, 5), *w)


def test_wrappers_refuse_other_devices():
    t = torch.empty(2, 4, device="meta")
    with pytest.raises(ValueError):
        hk.lstm_gates(t, torch.empty(4, 4, device="meta"),
                      torch.empty(4, device="meta"), torch.empty(2, 1, device="meta"))


def test_kernels_have_no_backward_yet():
    with pytest.raises(NotImplementedError):
        hk._no_backward(None, torch.zeros(1))


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


def test_lstm_counters_are_private_to_each_stream_and_capture(monkeypatch):
    """lstm_gates' ticket counters: one set per stream for eager launches and
    one per CUDA-graph capture, so launches that can run at the same time
    never share a set; launches on one stream, or in one capture, do."""
    monkeypatch.setattr(hk, "_TICKETS", {})
    monkeypatch.setattr(hk, "_KEEP", {})
    dev = torch.device("cpu")
    stream, capture = [77], [0]           # the current stream and capture id

    class Stream:
        @property
        def cuda_stream(self):
            return stream[0]
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capture[0] != 0)
    monkeypatch.setattr(hk, "_capture_id", lambda s: capture[0])

    sets = {}
    for stream[0], capture[0] in ((11, 0), (12, 0), (11, 1), (11, 2)):
        key = hk._counter_key(dev)
        assert key == (("capture", dev, capture[0]) if capture[0]
                       else ("stream", dev, stream[0]))
        sets[key] = hk._tickets(dev, 64)
        assert hk._tickets(dev, 64) is sets[key]
    assert len({t.data_ptr() for t in sets.values()}) == 4
    assert all(t.dtype == torch.int32 and not t.any() for t in sets.values())
    stream[0], capture[0] = 11, 0
    grown = hk._tickets(dev, 10000)
    assert grown.numel() >= 10000 and not grown.any()
    assert any(t is sets[("stream", dev, 11)]                      # kept alive
               for t in hk._KEEP[("stream", dev, 11)])
    hk.release_tickets([("capture", dev, 1)])      # a released graph's set
    assert ("capture", dev, 1) not in hk._TICKETS and ("capture", dev, 1) not in hk._KEEP
    assert ("capture", dev, 2) in hk._TICKETS

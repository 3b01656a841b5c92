"""The launch plans of the two bf16 kernels of the serving path, and CPU
emulations of how each kernel lays out its work, held against the plain
versions: the LSTM gate step's fixed-order split-K over a thread-block
cluster (csrc/lstm_gates_bf16.cu) and the resblock's tiles with their halos
and bf16 rounding points (csrc/hifigan_resblock_bf16.cu). These catch halo
and offset errors before the card; the kernels themselves run only there
(chip_smoke.py phase 20)."""
import collections
import ctypes

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cookietts_tpu_torch.models.hifigan import HiFiGANConfig
from cookietts_tpu_torch.ops import hopper_kernels as hk
from test_torch_threads import _one_thread  # noqa: F401

BF16 = torch.bfloat16
# the three decoder cells of Tacotron2Config(): (F = in + H, H)
CELLS = ((2816, 1280), (2560, 768), (1536, 768))
# phase 18a's tolerances: the LSTM's f32 rounding; two bf16 ulps at the
# largest output of the resblock
LSTM_TOL = (2e-5, 1e-4)


def bf16_ulp(x: torch.Tensor) -> float:
    m = float(x.abs().max())
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


# -- lstm_gates_bf16 ------------------------------------------------------------

@pytest.mark.parametrize("F_,H", CELLS)
def test_lstm_bf16_plan_covers_w_once_and_fits(F_, H):
    for B in range(1, 129):
        plan = hk.lstm_gates_bf16_plan(B, F_, H)
        nb = 8 * plan.nt
        S, col_tiles, groups = plan.grid
        assert plan.nt in (2, 4, 8, 16) and nb >= min(B, 16)
        assert groups * nb >= B and (groups - 1) * nb < B
        assert col_tiles * hk.LSTM_COLS >= H > (col_tiles - 1) * hk.LSTM_COLS
        assert S == plan.cluster and 1 <= S <= hk.LSTM_BF16_CLUSTER_MAX
        assert plan.smem == hk.lstm_gates_bf16_smem(nb, plan.ring) <= hk.SMEM_MAX
        # the ranks' runs of 64-row stages partition W's rows
        runs = plan.runs()
        owner = np.zeros(plan.n_stages, int)
        for first, n in runs:
            assert n >= 1
            owner[first:first + n] += 1
        assert (owner == 1).all() and plan.n_stages * hk.LSTM_BF16_ROWS >= F_
        assert 1 <= plan.ring <= min(hk.LSTM_BF16_RING, max(n for _, n in runs))
        # every cluster resident at once where the plan found one that is
        assert S == 1 or hk.clusters_fit(col_tiles * groups, S, plan.smem,
                                         hk.LSTM_BF16_THREADS)


def test_lstm_bf16_plan_main_path():
    """The decode step's cells at B=4 put 80-96 blocks to work in clusters
    of 4 to 8, each streaming at least 3 stages of W."""
    for F_, H in CELLS:
        plan = hk.lstm_gates_bf16_plan(4, F_, H)
        assert 80 <= plan.cluster * plan.grid[1] <= hk.N_SM
        assert min(n for _, n in plan.runs()) >= 3


def test_lstm_bf16_plan_refuses():
    with pytest.raises(ValueError):
        hk.lstm_gates_bf16_plan(4, 256, 127)      # odd H: rows not 4-byte aligned
    with pytest.raises(ValueError):
        hk.lstm_gates_bf16_plan(0, 256, 128)
    with pytest.raises(ValueError):
        hk.lstm_gates_bf16_plan(4, 0, 128)


def emulate_lstm_bf16(xh, W, b, c, plan):
    """The kernel's algorithm: each rank's run of stages summed in f32 on
    the bf16 operands (exact products), the ranks' partials added in rank
    order, then the bias and the f32 epilogue."""
    xf, wf = xh.float(), W.float()
    F_ = xh.shape[1]
    total = None
    for first, n in plan.runs():
        rows = slice(first * hk.LSTM_BF16_ROWS, min(F_, (first + n) * hk.LSTM_BF16_ROWS))
        part = xf[:, rows] @ wf[rows]
        total = part if total is None else total + part
    i, f, g, o = (total + b.float()).chunk(4, dim=-1)
    c_new = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    return c_new, torch.sigmoid(o) * torch.tanh(c_new)


@pytest.mark.parametrize("B", [1, 4, 32])
@pytest.mark.parametrize("F_,H", CELLS)
def test_lstm_bf16_cluster_reduction_matches_plain(B, F_, H):
    rng = np.random.default_rng(F_ + B)
    xh = torch.tensor(rng.standard_normal((B, F_)), dtype=BF16)
    W = torch.tensor(rng.standard_normal((F_, 4 * H)) * F_ ** -0.5, dtype=BF16)
    b = torch.tensor(rng.standard_normal(4 * H) * 0.1, dtype=BF16)
    c = torch.tensor(rng.standard_normal((B, H)), dtype=torch.float32)
    plan = hk.lstm_gates_bf16_plan(B, F_, H)
    got = emulate_lstm_bf16(xh, W, b, c, plan)
    want = hk.lstm_gates_plain(xh, W, b, c)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=LSTM_TOL[0], rtol=LSTM_TOL[1])


# -- hifigan_resblock_bf16 ------------------------------------------------------

def generator_widths(cfg):
    return [cfg.upsample_initial_channel // 2 ** (i + 1)
            for i in range(len(cfg.upsample_rates))]


BENCH_SERVING = HiFiGANConfig(upsample_rates=(8, 8, 4, 2),
                              upsample_kernel_sizes=(16, 16, 8, 4))
RESBLOCK_CASES = sorted(
    {(C, k, d) for cfg in (HiFiGANConfig(), BENCH_SERVING)
     for C in generator_widths(cfg)
     for k, ds in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilations)
     for d in ds}
    | {(C, 7, d) for C in (96, 24, 6) for d in (1, 3, 5)}
    | {(C, k, 5) for C in (192, 48) for k in (3, 7, 11)})


@pytest.mark.parametrize("C,k,d", RESBLOCK_CASES)
def test_resblock_bf16_plan_covers_outputs_once_and_fits(C, k, d):
    # the bench-serving generator's lengths at T_mel = 512 for its widths,
    # and a ragged one
    for T in (512 * 8 * 256 // C, 4096 + 7):
        plan = hk.hifigan_resblock_bf16_plan(3, C, T, k, d)
        assert plan.C8 % 8 == 0 and C <= plan.C8 < C + 8
        assert plan.N in (16, 32, 64, 128, 256) and plan.KC % 16 == 0
        assert plan.fused == (plan.C8 <= hk.RESBLOCK_BF16_FUSED_C)
        # the kernel builds two launches a pair only at N = 128 and 256
        assert plan.fused or plan.N >= 128
        assert plan.smem == hk.hifigan_resblock_bf16_smem(
            plan.N, plan.fused, k, d, plan.KC, plan.TG, plan.ring) <= hk.SMEM_MAX
        assert 2 <= plan.ring <= hk.RESBLOCK_BF16_RING
        rows = hk.resblock_bf16_rows(plan.N)
        assert plan.TG * (plan.KC // 16) <= hk.resblock_bf16_steps(plan.N)
        assert hk.hifigan_resblock_launches(C, 3, True) == (3 if plan.fused else 6)
        # the fused tile keeps conv2's halo inside the rows conv1 computed
        assert plan.tile % 8 == 0 and plan.tile + (
            k - 1 if plan.fused else 0) <= rows
        # every output sample and channel written by exactly one tile
        owner = np.zeros((plan.C8, T), np.int32)
        co_tiles = -(-plan.C8 // plan.N)
        for ct in range(co_tiles):
            for t0 in range(0, T, plan.tile):
                owner[ct * plan.N:(ct + 1) * plan.N, t0:t0 + plan.tile] += 1
        assert (owner == 1).all()
        # every input channel in exactly one K chunk, every tap in one stage
        chunks = np.zeros(plan.C8, int)
        for c0 in range(0, plan.C8, plan.KC):
            chunks[c0:c0 + plan.KC] += 1
        assert (chunks == 1).all()
        groups = -(-k // plan.TG)
        assert plan.stages == groups * (2 if plan.fused else -(-plan.C8 // plan.KC))


def test_resblock_bf16_plan_refuses():
    with pytest.raises(ValueError):
        hk.hifigan_resblock_bf16_plan(1, 64, 100, 4, 1)       # even k
    with pytest.raises(ValueError):
        hk.hifigan_resblock_bf16_plan(1, 0, 100, 3, 1)
    with pytest.raises(ValueError):
        hk.hifigan_resblock_bf16_plan(1, 256, 100, 11, 400)   # window past smem
    with pytest.raises(ValueError):
        hk.hifigan_resblock_bf16_plan(1, 32, 100, 511, 1)     # no fused tile left


def window(src, start, n):
    """src[:, start:start + n] with zeros outside [0, T)."""
    C, T = src.shape
    out = torch.zeros(C, n)
    lo, hi = max(start, 0), min(start + n, T)
    if hi > lo:
        out[:, lo - start:hi - start] = src[:, lo:hi]
    return out


def conv_rows(win, w, kd, rows):
    """[rows, C_out]: sum over taps of the window's rows m + tap kd (the
    sample-major A operand) times the tap's weights."""
    return sum(win[:, t * kd:t * kd + rows].T @ w[t] for t in range(w.shape[0]))


def emulate_resblock_bf16(x, w1, b1, w2, b2, dilations, slope):
    """hifigan_resblock_bf16.cu's tiles: the window holds lrelu_bf16(x)
    (zeros outside [0, T)); fused (C8 <= 64): conv1 over the tile's rows
    from t0 - k // 2 with f32 sums, h = bf16(lrelu(. + b1)) zeroed outside
    [0, T), conv2 from h, bf16(. + b2), the first `tile` rows written as
    bf16(x + .); else conv1 over every 128-row tile into h (bf16), then
    conv2 over h's tiles with the residual."""
    B, C, T = x.shape
    k = w1.shape[1]
    half = k // 2
    plan0 = hk.hifigan_resblock_bf16_plan(B, C, T, k, dilations[0])
    pad = plan0.C8 - C
    if pad:        # the wrapper's zero channels
        x = F.pad(x, (0, 0, 0, pad))
        w1, w2 = (F.pad(w, (0, pad, 0, pad)) for w in (w1, w2))
        b1, b2 = (F.pad(b, (0, pad)) for b in (b1, b2))
    for p, d in enumerate(dilations):
        plan = hk.hifigan_resblock_bf16_plan(B, C, T, k, d)
        rows, tile = hk.resblock_bf16_rows(plan.N), plan.tile
        wa, wb = w1[p].float(), w2[p].float()
        y = torch.empty_like(x)
        h_all = torch.empty_like(x)
        for b in range(B):
            lx = hk.leaky_relu_bf16(x[b], slope).float()
            if plan.fused:
                for t0 in range(0, T, tile):
                    u0 = t0 - half
                    h = conv_rows(window(lx, u0 - half * d, rows + (k - 1) * d), wa, d,
                                  rows) + b1[p]
                    h = F.leaky_relu(h, slope)
                    u = torch.arange(u0, u0 + rows)
                    h[(u < 0) | (u >= T)] = 0.0
                    h = h.to(BF16).float().T                  # [C8, rows]
                    hp = torch.cat([h, torch.zeros(h.shape[0], k - 1)], 1)
                    v = (conv_rows(hp, wb, 1, rows) + b2[p]).to(BF16).float().T
                    n = min(tile, T - t0)
                    y[b, :, t0:t0 + n] = (x[b, :, t0:t0 + n].float() + v[:, :n]).to(BF16)
            else:
                for t0 in range(0, T, rows):
                    h = conv_rows(window(lx, t0 - half * d, rows + (k - 1) * d), wa, d,
                                  rows) + b1[p]
                    n = min(rows, T - t0)
                    h_all[b, :, t0:t0 + n] = F.leaky_relu(h, slope).to(BF16).T[:, :n]
                hb = h_all[b].float()
                for t0 in range(0, T, rows):
                    v = (conv_rows(window(hb, t0 - half, rows + k - 1), wb, 1, rows)
                         + b2[p]).to(BF16).float().T
                    n = min(rows, T - t0)
                    y[b, :, t0:t0 + n] = (x[b, :, t0:t0 + n].float() + v[:, :n]).to(BF16)
        x = y
    return x[:, :C] if pad else x


@pytest.mark.parametrize("C,T,k", [(32, 1100, 7), (24, 1031, 11), (6, 700, 3),
                                   (64, 600, 11), (48, 530, 3), (128, 300, 7),
                                   (96, 263, 3)])
def test_resblock_bf16_tiles_match_plain(C, T, k):
    rng = np.random.default_rng(C * T + k)
    P, dil = 3, (1, 3, 5)
    x = torch.tensor(rng.standard_normal((2, C, T)), dtype=BF16)
    w = lambda: torch.tensor(rng.standard_normal((P, k, C, C)) * (C * k) ** -0.5,
                             dtype=BF16)
    b = lambda: torch.tensor(rng.standard_normal((P, C)) * 0.1, dtype=torch.float32)
    w1, b1, w2, b2 = w(), b(), w(), b()
    got = emulate_resblock_bf16(x, w1, b1, w2, b2, dil, 0.1)
    want = hk.hifigan_resblock_plain(x, w1, b1, w2, b2, dil, 0.1)
    assert got.dtype == BF16 and got.shape == want.shape
    err = (got.float() - want.float()).abs()
    assert float(err.max()) <= 2 * bf16_ulp(want.float())
    assert float(err.mean()) < 2e-3


# -- the weights' TMA maps ------------------------------------------------------

class FakeLib:
    """The built library's stand-in on the CPU: a weight map holds the
    pointer it was encoded for; each launch records the bytes behind its
    maps' pointers as it is made."""

    def __init__(self, nbytes):
        self.nbytes, self.seen = nbytes, []

    def _encode(self, w, m):
        ctypes.memmove(m, ctypes.byref(ctypes.c_uint64(w.value)), 8)
        return 0

    def _launch(self, *maps):
        ptrs = [ctypes.c_uint64.from_buffer(m).value for m in maps]
        self.seen.append((ptrs, [ctypes.string_at(q, self.nbytes) for q in ptrs]))
        return 0

    def hifigan_resblock_bf16_weight_map(self, w, P, k, C, N, KC, TG, m):
        return self._encode(w, m)

    def hifigan_resblock_pair_bf16(self, m1, m2, *args):
        return self._launch(m1, m2)

    def lstm_gates_bf16_weight_map(self, w, F_, H, m):
        return self._encode(w, m)

    def lstm_gates_bf16(self, m, *args):
        return self._launch(m)


def offset_view(rng, shape):
    """A bf16 tensor of `shape` that starts 2 bytes into its storage."""
    n = int(np.prod(shape))
    base = torch.tensor(rng.standard_normal(n + 1), dtype=BF16)
    return base[1:].view(shape)


def as_bytes(t):
    return t.contiguous().view(torch.int16).numpy().tobytes()


@pytest.fixture
def fake_build(monkeypatch):
    def install(nbytes):
        lib = FakeLib(nbytes)
        monkeypatch.setattr(hk._build, "library", lambda name: lib)
        monkeypatch.setattr(hk, "_stream", lambda: ctypes.c_void_p(None))
        monkeypatch.setattr(hk, "_MAPS", collections.OrderedDict())
        monkeypatch.setattr(hk, "LAUNCHES", collections.Counter())
        return lib
    return install


def test_resblock_bf16_weight_maps_name_live_copies(fake_build):
    """Weights off 16 bytes are copied for TMA: each conv's map names its
    own copy, alive and holding that conv's weights at every launch."""
    rng = np.random.default_rng(0)
    P, k, C, T = 3, 3, 16, 200
    w1, w2 = offset_view(rng, (P, k, C, C)), offset_view(rng, (P, k, C, C))
    assert w1.data_ptr() % 16 and w2.data_ptr() % 16
    lib = fake_build(w1.numel() * 2)
    x = torch.tensor(rng.standard_normal((1, C, T)), dtype=BF16)
    b = torch.zeros(P, C)
    hk._hifigan_resblock_bf16_cuda(x, w1, b, w2, b, (1, 3, 5), 0.1)
    assert len(lib.seen) == P
    for (p1, p2), (got1, got2) in lib.seen:
        assert p1 != p2 and p1 % 16 == 0 and p2 % 16 == 0
        assert got1 == as_bytes(w1) and got2 == as_bytes(w2)
    assert len({key[2] for key in hk._MAPS}) == 2


def test_lstm_bf16_weight_map_names_live_copy(fake_build):
    rng = np.random.default_rng(1)
    B, F_, H = 2, 64, 32
    W = offset_view(rng, (F_, 4 * H))
    lib = fake_build(W.numel() * 2)
    xh = torch.tensor(rng.standard_normal((B, F_)), dtype=BF16)
    hk._lstm_gates_bf16_cuda(xh, W, torch.zeros(4 * H, dtype=BF16), torch.zeros(B, H))
    ((ptr,), (got,)), = lib.seen
    assert ptr % 16 == 0 and got == as_bytes(W)


def test_weight_maps_keep_the_most_recent(monkeypatch):
    monkeypatch.setattr(hk, "_MAPS", collections.OrderedDict())
    monkeypatch.setattr(hk, "_MAPS_MAX", 2)
    encoded = []

    def get(key):
        return hk._weight_map(("k", key), lambda m: encoded.append(key) or 0)
    a = get(1)
    get(2)
    assert get(1) is a                  # a hit makes 1 the most recent
    get(3)                              # 2 goes
    assert list(hk._MAPS) == [("k", 1), ("k", 3)]
    get(2)
    assert encoded == [1, 2, 3, 2]

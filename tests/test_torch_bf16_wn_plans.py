"""The launch plans of the flow vocoders' two bf16 WN kernels, and CPU
emulations of how each kernel computes, held against the plain versions and
against JAX's Pallas kernels in interpret mode: waveglow_wn_forward_bf16's
64-sample tiles with the f32 activations split into three bf16 pieces and z
kept in its threads' fragment order (csrc/waveglow_wn_bf16.cu), and
waveflow_row_step_bf16's 128-sample tiles over the ring's slots with z fed
from the registers (csrc/waveflow_row_bf16.cu). The shared-memory offsets
the kernels read are mirrored here and held to the layouts TMA writes. The
kernels themselves run only on the card (chip_smoke.py phase 21)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cookietts_tpu.ops.pallas_kernels import waveflow_row_step as j_row_step
from cookietts_tpu.ops.pallas_kernels import waveglow_wn_forward as j_wn_forward

from cookietts_tpu_torch.ops import hopper_kernels as hk
from test_torch_threads import _one_thread  # noqa: F401

BF16 = torch.bfloat16
KW = KH = 3
# (B, C, T') the repo runs: the main path (a 5 s infer), the ragged widths,
# T' not a multiple of 8, a validation batch (phase 8b: 24000 samples, 24 or
# 8 groups), a request's length
GLOW_SHAPES = [(1, 256, 10000), (1, 48, 1500), (1, 50, 250), (4, 256, 1000),
               (1, 256, 250), (1, 512, 1500), (2, 16, 100)]
FLOW_SHAPES = [(1, 64, 30000), (1, 48, 1500), (1, 50, 250), (4, 64, 3000),
               (1, 128, 251), (2, 16, 100)]


# -- the plans -------------------------------------------------------------------

@pytest.mark.parametrize("kernel,B,C,T", [("glow", *s) for s in GLOW_SHAPES]
                         + [("flow", *s) for s in FLOW_SHAPES])
def test_bf16_wn_plan_covers_outputs_once_and_fits(kernel, B, C, T):
    """Every (batch row, channel, sample) of a layer's outputs belongs to
    exactly one (block, pass, warpgroup), shared memory holds the ring of
    at least two stages, and the ring is no deeper than the stages a block
    walks through."""
    rows = 1 if kernel == "glow" else KH
    p = hk.wn_bf16_plan(kernel, B, C, T, rows, KW)
    assert p.C8 % 8 == 0 and C <= p.C8 < C + 8 and p.Tp % 8 == 0 and T <= p.Tp < T + 8
    assert p.CB in hk.WN_BF16_CB
    tile = hk.WN_BF16_TILE[kernel]
    owner = np.zeros((B, p.C8, T), int)
    for x in range(p.grid[0]):
        for b in range(p.grid[1]):
            for q in range(p.passes):
                for w in range(2):
                    if kernel == "glow":          # warpgroups split the channels
                        cs, ts = (2 * q + w) * p.CB, x * tile
                        owner[b, cs:cs + p.CB, ts:ts + tile] += 1
                    else:                         # ... or the samples
                        ts = x * tile + 64 * w
                        owner[b, :p.CB, ts:ts + 64] += 1
    assert (owner == 1).all()
    if kernel == "glow":
        # every warpgroup's block starts below C8 where C8 > 16
        assert C <= 16 or (2 * p.passes - 1) * p.CB < p.C8
    assert 2 <= p.ring <= min(hk.WN_BF16_RING, p.stages)
    assert p.smem == hk.wn_bf16_smem(kernel, p.CB, p.passes, p.ring) <= hk.SMEM_MAX
    nk = -(-p.C8 // 16)
    want = (p.passes * nk * (KW + 1) if kernel == "glow"
            else (p.CB // min(p.CB, 64)) * (KH * KW + 1))
    assert p.stages == want


def test_bf16_wn_plans_at_the_main_path():
    """The main path's shapes: WaveGlow at C = 256 in one pass of 128-channel
    blocks, 157 blocks of 64 samples; WaveFlow at C = 64, 235 blocks of 128."""
    g = hk.wn_bf16_plan("glow", 1, 256, 10000, 1, 3)
    assert (g.CB, g.passes, g.grid, g.ring) == (128, 1, (157, 1), 7)
    f = hk.wn_bf16_plan("flow", 1, 64, 30000, 3, 3)
    assert (f.CB, f.passes, f.grid) == (64, 1, (235, 1)) and f.ring >= 3
    assert g.ints() == (128, 1, 7) and f.ints() == (64, f.ring)


def test_bf16_wn_plan_refuses():
    with pytest.raises(ValueError, match="kw odd"):
        hk.wn_bf16_plan("glow", 1, 64, 100, 1, 2)
    with pytest.raises(ValueError, match="kw odd"):
        hk.wn_bf16_plan("flow", 1, 64, 0, 3, 3)
    with pytest.raises(ValueError, match="above 128"):
        hk.wn_bf16_plan("flow", 1, 136, 100, 3, 3)
    with pytest.raises(ValueError, match="shared memory"):
        hk.wn_bf16_plan("glow", 1, 1024, 100, 1, 3)
    with pytest.raises(ValueError, match="unknown kernel"):
        hk.wn_bf16_plan("wavenet", 1, 64, 100, 1, 3)


@pytest.mark.parametrize("L", [1, 3, 8])
def test_wn_launches_per_form(L):
    """The f32 form: the start, a conv and a res/skip launch a layer, the
    end; the bf16 forms: one launch a layer."""
    assert hk.wn_launches(L) == hk.wn_launches(L, "f32") == 2 * L + 2
    assert hk.wn_launches(L, "glow_bf16") == hk.wn_launches(L, "flow_bf16") == L + 2


# -- shared-memory layouts ----------------------------------------------------------

def tma_swizzled(row: int, col_byte: int, row_bytes: int, span: int) -> int:
    """The byte TMA writes element byte ``col_byte`` of box row ``row`` to,
    with the swizzle of ``span`` bytes (128, 64, 32): the 16-byte chunk
    index XOR the row within the swizzle's repeat."""
    addr = row * row_bytes + col_byte
    chunks = span // 16
    return addr ^ (((addr // span) % chunks) << 4) if span > 16 else addr


def glow_win_off(k, m):
    """csrc/waveglow_wn_bf16.cu: win_off."""
    return (m >> 5) * (16 * 128) + k * 128 + ((((m & 31) >> 2) ^ (k & 7)) << 4) + (m & 3) * 4


def flow_box_off(k, m):
    """csrc/waveflow_row_bf16.cu: box_off."""
    return k * 128 + (((m >> 3) ^ (k & 7)) << 4) + (m & 7) * 2


def test_window_offsets_match_tma_and_spread_over_banks():
    """The f32 window (three 32-sample boxes of 16 channels, read up to 3
    rows past the tile) and the bf16 boxes (64 samples a row) at the bytes
    TMA's 128-byte swizzle writes them; a warp's fragment loads and ldmatrix
    rows fall on distinct banks."""
    for k in range(16):
        for m in range(96):
            box, mm = divmod(m, 32)
            assert glow_win_off(k, m) == box * 2048 + tma_swizzled(k, 4 * mm, 128, 128)
    for k in range(64):
        for m in range(64):
            assert flow_box_off(k, m) == tma_swizzled(k, 2 * m, 128, 128)
    # the glow A fragment: lane (g, t) reads (k = 2t + e (+ 8), m = 16 w4 + g (+ 8))
    for w4 in range(4):
        for e in range(2):
            for dk, dm in ((0, 0), (0, 8), (8, 0), (8, 8)):
                banks = {glow_win_off(2 * (ln & 3) + e + dk, 16 * w4 + (ln >> 2) + dm) // 4 % 32
                         for ln in range(32)}
                assert len(banks) == 32
    # ldmatrix.trans rows: 8 channels k0 + r at one 8-sample chunk
    for k0 in range(0, 64, 8):
        for chunk in range(8):
            starts = [flow_box_off(k0 + r, 8 * chunk) for r in range(8)]
            assert all(s % 16 == 0 for s in starts)
            assert len({s // 16 % 8 for s in starts}) == 8


def test_accumulator_is_the_next_products_a_fragment():
    """z fed on chip: a thread's accumulator value i (row 16 w + g + 8 (i % 4
    // 2), column 8 (i // 4) + 2 t + i % 2) is, for the k16 chunk at column
    lc, value i - lc / 2 of that chunk's A fragment in register order (a0 lo,
    a0 hi, a1 lo, ..., a3 hi: rows g, g + 8, columns 2 t, 2 t + 8), as both
    kernels read it back (glow: zs[lc / 2 + e]; flow: zf[i / 8][i % 8 / 2])."""
    for CB in hk.WN_BF16_CB:
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for lc in range(0, CB, 16):
                for e in range(8):
                    i = lc // 2 + e
                    acc_rc = (g + 8 * ((i % 4) // 2), 8 * (i // 4) + 2 * t + i % 2)
                    r, half = divmod(e, 2)
                    frag_rc = (g + 8 * (r & 1), lc + 2 * t + half + 8 * (r >> 1))
                    assert acc_rc == frag_rc
                    assert (i >> 3, (i & 7) >> 1, i & 1) == (lc // 16, r, half)


# -- the three-piece split -----------------------------------------------------------

def split3(v: torch.Tensor):
    """csrc/wn_bf16.cuh: split3, hi + mid + lo in bf16."""
    hi = v.to(BF16)
    r = v - hi.float()
    mid = r.to(BF16)
    return hi, mid, (r - mid.float()).to(BF16)


def test_split3_is_exact_and_its_products_are_f32_grade():
    rng = np.random.default_rng(0)
    v = torch.from_numpy((rng.standard_normal(200000)
                          * 10.0 ** rng.uniform(-6, 6, 200000)).astype(np.float32))
    hi, mid, lo = split3(v)
    back = hi.double() + mid.double() + lo.double()
    assert torch.equal(back, v.double())
    w = torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32)).to(BF16)
    parts = [(w.float() * p.float()).double() for p in (hi, mid, lo)]
    # each piece's product with a bf16 weight is exact in f32
    for p, q in zip(parts, (hi, mid, lo)):
        assert torch.equal(p, w.double() * q.double())
    assert torch.equal(sum(parts), w.double() * v.double())


# -- CPU emulations of the two kernels ------------------------------------------------

def shifted(src: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """src[..., start:start + n] with zeros outside [0, T'): a TMA box."""
    T = src.shape[-1]
    lo, hi = max(start, 0), min(start + n, T)
    out = src.new_zeros(*src.shape[:-1], n)
    if hi > lo:
        out[..., lo - start:hi - start] = src[..., lo:hi]
    return out


def pieces_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A [.., M, K] f32 times a bf16-valued w [K, N]: lo, mid, hi products
    into one f32 sum, as a stage's three wgmmas."""
    hi, mid, lo = split3(a)
    return (lo.float() @ w + mid.float() @ w) + hi.float() @ w


def emulate_glow(x, cond, start_w, start_b, k_all, rs_w, rs_b, end_w, end_b):
    """waveglow_wn_forward_bf16 as the kernel computes it: zero-padded
    channels to C8, 64-sample tiles, pass p and warpgroup w on channel
    block 2 p + w (the a and g halves as one product), stages of 16 input
    channels of one tap with the f32 window split in three, z kept per tile
    and fed back split in three, h into the other buffer."""
    B, Cin, T = x.shape
    L, _, C2 = k_all.shape
    C = C2 // 2
    kw = k_all.shape[1] // C
    p = hk.wn_bf16_plan("glow", B, C, T, 1, kw)
    C8, CB = p.C8, p.CB
    d = C8 - C
    w16 = [t.float() for t in (start_w, k_all, rs_w, end_w)]
    start_w, k_all, rs_w, end_w = w16
    start_w, start_b = F.pad(start_w, (0, d)), F.pad(start_b, (0, d))
    k_all = F.pad(k_all.reshape(L, kw, C, 2, C), (0, d, 0, 0, 0, d))
    rs_w = F.pad(rs_w.reshape(L, C, 2, C), (0, d, 0, 0, 0, d))
    rs_b = F.pad(rs_b.reshape(L, 2, C), (0, d))
    end_w = F.pad(end_w, (0, 0, 0, d))
    cond = F.pad(cond.float().reshape(B, L, 2, C, T), (0, 0, 0, d))
    nch = 2 * p.passes * CB              # channels the blocks compute

    def cols(w, j):                      # [.., 2, C8] -> block j's 2 CB columns
        w = F.pad(w, (0, nch - C8))
        return torch.cat([w[..., 0, j * CB:(j + 1) * CB], w[..., 1, j * CB:(j + 1) * CB]], -1)

    h = torch.einsum("ic,bit->bct", start_w, x.to(BF16).float()) + start_b[:, None]
    skip = torch.zeros(B, C8, T)
    for i in range(L):
        dil = 2 ** i
        h_out = h.clone()
        for t0 in range(0, T, 64):
            z = torch.zeros(B, nch, 64)
            for j in range(nch // CB):
                acc = torch.zeros(B, 64, 2 * CB)
                for tap in range(kw):
                    win = shifted(h, t0 + (tap - kw // 2) * dil, 64)      # [B, C8, 64]
                    for k0 in range(0, C8, 16):
                        acc = acc + pieces_product(win[:, k0:k0 + 16].transpose(1, 2),
                                                   cols(k_all[i, tap, k0:k0 + 16], j))
                ca = shifted(cond[:, i, 0], t0, 64).transpose(1, 2)
                cg = shifted(cond[:, i, 1], t0, 64).transpose(1, 2)
                ca, cg = (F.pad(c, (0, nch - C8))[..., j * CB:(j + 1) * CB] for c in (ca, cg))
                zj = hk.gtu(acc[..., :CB] + ca, acc[..., CB:] + cg)
                ch = j * CB + torch.arange(CB)
                z[:, j * CB:(j + 1) * CB] = torch.where(ch[None, None] < C8, zj, 0.0
                                                        ).transpose(1, 2)
            n = min(64, T - t0)
            for j in range(nch // CB):
                acc = torch.zeros(B, 64, 2 * CB)
                for k0 in range(0, C8, 16):
                    k1 = min(k0 + 16, C8)
                    acc = acc + pieces_product(z[:, k0:k1].transpose(1, 2),
                                               cols(rs_w[i, k0:k1], j))
                lo, hi = j * CB, min((j + 1) * CB, C8)
                if lo >= C8:
                    continue
                res = acc[:, :n, :hi - lo].transpose(1, 2) + rs_b[i, 0, lo:hi, None]
                sk = acc[:, :n, CB:CB + hi - lo].transpose(1, 2) + rs_b[i, 1, lo:hi, None]
                if i < L - 1:
                    h_out[:, lo:hi, t0:t0 + n] = h[:, lo:hi, t0:t0 + n] + res
                skip[:, lo:hi, t0:t0 + n] = sk if i == 0 else skip[:, lo:hi, t0:t0 + n] + sk
        h = h_out
    return torch.einsum("co,bct->bot", end_w, skip) + end_b[:, None]


def emulate_flow(x_prev, ring, step, cond, start_w, start_b, k_all, rs_w, rs_b, end_w,
                 end_b):
    """waveflow_row_step_bf16 as the kernel computes it: 128-sample tiles,
    each warpgroup 64 samples by N = 2 CB columns, stages of (kernel row
    r reading slot (step % kh + 1 + r) % kh, tap, KC channels) with the
    window a zero-filled box of the slot's row, bf16 products summed in
    f32; z rounded to bf16 and fed to res/skip; h + bf16(res) written into
    slot step % kh of the next layer's ring. Updates ``ring``."""
    B, W = x_prev.shape
    L, kh, _, C, _ = ring.shape
    kw = k_all.shape[1] // (kh * C)
    p = hk.wn_bf16_plan("flow", B, C, W, kh, kw)
    CB = p.CB
    KC = min(CB, 64)
    d = CB - C
    rot = step % kh
    k_all = F.pad(k_all.float().reshape(L, kh * kw, C, 2, C), (0, d, 0, 0, 0, d))
    rs_w = F.pad(rs_w.float().reshape(L, C, 2, C), (0, d, 0, 0, 0, d))
    rs_b = F.pad(rs_b.reshape(L, 2, C), (0, d))
    condp = F.pad(cond.float().reshape(B, L, 2, C, W), (0, 0, 0, d))
    cat = lambda w: torch.cat([w[..., 0, :], w[..., 1, :]], -1)  # noqa: E731
    h0 = (start_w.float()[0][None, :, None] * x_prev[:, None, :]
          + start_b.float()[None, :, None]).to(BF16)
    ring[0, rot] = h0
    skip = torch.zeros(B, C, W)
    for i in range(L):
        dil = 2 ** i
        rows = F.pad(ring[i].float(), (0, 0, 0, d))                 # [kh, B, CB, W]
        nxt = ring[i + 1, rot].clone() if i < L - 1 else None
        for t0 in range(0, W, 128):
            for w in range(2):
                ts = t0 + 64 * w
                acc = torch.zeros(B, 64, 2 * CB)
                for r in range(kh):
                    slot = (rot + 1 + r) % kh
                    for tap in range(kw):
                        win = shifted(rows[slot], ts + (tap - kw // 2) * dil, 64)
                        for k0 in range(0, CB, KC):
                            acc = acc + win[:, k0:k0 + KC].transpose(1, 2) @ \
                                cat(k_all[i, r * kw + tap, k0:k0 + KC])
                ca = shifted(condp[:, i, 0], ts, 64).transpose(1, 2)
                cg = shifted(condp[:, i, 1], ts, 64).transpose(1, 2)
                z = hk.gtu(acc[..., :CB] + ca, acc[..., CB:] + cg).to(BF16).float()
                acc = z @ cat(rs_w[i])
                n = max(0, min(64, W - ts))
                if n == 0:
                    continue
                res = acc[:, :n, :C].transpose(1, 2) + rs_b[i, 0, :C, None]
                sk = acc[:, :n, CB:CB + C].transpose(1, 2) + rs_b[i, 1, :C, None]
                if nxt is not None:
                    hcur = ring[i, rot, :, :, ts:ts + n].float()
                    nxt[:, :, ts:ts + n] = (hcur + res.to(BF16).float()).to(BF16)
                skip[:, :, ts:ts + n] = sk if i == 0 else skip[:, :, ts:ts + n] + sk
        if nxt is not None:
            ring[i + 1, rot] = nxt
    st = torch.einsum("co,bct->bot", end_w.float(), skip.to(BF16).float()) + end_b[:, None]
    return st[:, 0], st[:, 1]


def wn_weights(rng, Cin, C, Cout, L, rows, kw, form):
    """Random WN weights in the port's layouts and the bf16 form's dtypes."""
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    k = rows * kw * C
    rs_w, rs_b = f(L, C, 2 * C, scale=C ** -0.5), f(L, 2 * C, scale=0.1)
    rs_w[-1, :, :C] = 0
    rs_b[-1, :C] = 0
    ws = [f(Cin, C, scale=Cin ** -0.5), f(C, scale=0.1), f(L, k, 2 * C, scale=k ** -0.5),
          rs_w, rs_b, f(C, Cout, scale=(C * L) ** -0.5), f(Cout, scale=0.1)]
    dtypes = list(hk.WN_BF16_DTYPES[form].values())[-7:]
    return [torch.from_numpy(a).to(dt) for a, dt in zip(ws, dtypes)]


@pytest.mark.parametrize("B,C,T,Cin", [(2, 64, 200, 4), (1, 50, 131, 3), (1, 24, 70, 2)])
def test_glow_emulation_matches_plain(B, C, T, Cin):
    """The tiles, the split and z in fragment order agree with the plain bf16
    form to f32 rounding (chip_smoke's tolerance, 2e-5 + 1e-4 |x|): C = 50
    (padded to 56) and T' = 131 (not a multiple of 8), C = 24 (two 16-channel
    blocks, the second one half past C)."""
    rng = np.random.default_rng(C)
    L = 4
    w = wn_weights(rng, Cin, C, 2 * Cin, L, 1, KW, "glow_bf16")
    x = torch.from_numpy(rng.standard_normal((B, Cin, T)).astype(np.float32))
    cond = torch.from_numpy(rng.standard_normal((B, L, 2 * C, T)).astype(np.float32)).to(BF16)
    got = emulate_glow(x, cond, *w)
    want = hk.waveglow_wn_forward_plain(x, cond, *w)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


def test_flow_emulation_matches_plain_over_four_rows():
    """Four rows at C = 50 (padded to 64), W = 150: log_s, t and the ring's
    queues within two bf16 ulps of the plain bf16 form (an f32 ulp of another
    summation order can flip a rounding)."""
    rng = np.random.default_rng(7)
    B, C, W, L = 2, 50, 150, 4
    w = wn_weights(rng, 1, C, 2, L, KH, KW, "flow_bf16")
    cond = torch.from_numpy(rng.standard_normal((B, L, 2 * C, W)).astype(np.float32)).to(BF16)
    ring = torch.zeros(L, KH, B, C, W, dtype=BF16)
    ring_p = ring.clone()
    x_prev = torch.zeros(B, W)
    for step in range(4):
        got = emulate_flow(x_prev, ring, step, cond, *w)
        want = hk.waveflow_row_step_ring_plain(x_prev, ring_p, step, cond, *w)
        for g_, w_ in zip(got, want):
            torch.testing.assert_close(g_, w_, atol=2 * _ulp(w_), rtol=0)
        torch.testing.assert_close(ring.float(), ring_p.float(), atol=2 * _ulp(ring_p), rtol=0)
        x_prev = torch.from_numpy(rng.standard_normal((B, W)).astype(np.float32))


def _ulp(x: torch.Tensor) -> float:
    return float(2.0 ** (np.floor(np.log2(float(x.float().abs().max()))) - 7))


def _padded(a, halo, Tp):
    """[B, C, T] -> the Pallas kernels' [C, B * T'] with a zero halo."""
    B, C, T = a.shape
    out = np.zeros((C, B, Tp), np.float32)
    out[:, :, halo:halo + T] = a.transpose(1, 0, 2)
    return out.reshape(C, B * Tp)


def test_glow_emulation_matches_jax_pallas():
    """The emulation against JAX's kernel in interpret mode at C = 64, 4
    layers, on the dtypes JAX's caller passes: f32 arithmetic on the same
    bf16 values in both, f32 rounding apart."""
    rng = np.random.default_rng(11)
    B, T, Cin, C, Cout, L, halo, Wt = 2, 200, 4, 64, 8, 4, 128, 128
    w = wn_weights(rng, Cin, C, Cout, L, 1, KW, "glow_bf16")
    sw, sb, k_all, rs_w, rs_b, ew, eb = (t.float().numpy() for t in w)
    x = rng.standard_normal((B, Cin, T)).astype(np.float32)
    cond = torch.from_numpy(rng.standard_normal((B, L, 2 * C, T)).astype(np.float32)).to(BF16)
    c_np = cond.float().numpy()
    Tp = 2 * halo + -(-T // Wt) * Wt
    b16, f32 = jnp.bfloat16, jnp.float32
    pad16 = lambda a: np.pad(a, ((0, 16 - a.shape[0]), (0, 0)))  # noqa: E731
    st = j_wn_forward(
        jnp.asarray(pad16(_padded(x, halo, Tp)), f32),
        jnp.asarray(np.stack([_padded(c_np[:, i], halo, Tp) for i in range(L)]), b16),
        jnp.asarray(pad16(sw).T, b16), jnp.asarray(sb[:, None], f32),
        jnp.asarray(k_all.transpose(0, 2, 1), b16),
        jnp.asarray(rs_w.transpose(0, 2, 1), b16), jnp.asarray(rs_b, f32),
        jnp.asarray(pad16(ew.T), b16), jnp.asarray(pad16(eb[:, None]), f32),
        L=L, kw=KW, C=C, Wt=Wt, halo=halo, T=T, B=B)
    ref = np.asarray(st)[:Cout].reshape(Cout, B, Tp)[:, :, halo:halo + T].transpose(1, 0, 2)
    got = emulate_glow(torch.from_numpy(x), cond, *w).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)


def test_flow_emulation_matches_jax_pallas():
    """The emulation against JAX's kernel in interpret mode with its bf16
    queues at C = 64, 4 layers, 3 rows at W = 150: log_s and t within two
    bf16 ulps, the queues after the last row too."""
    rng = np.random.default_rng(13)
    B, W, C, L, halo, Wt = 1, 150, 64, 4, 128, 128
    w = wn_weights(rng, 1, C, 2, L, KH, KW, "flow_bf16")
    sw, sb, k_all, rs_w, rs_b, ew, eb = (t.float().numpy() for t in w)
    cond = torch.from_numpy(rng.standard_normal((B, L, 2 * C, W)).astype(np.float32)).to(BF16)
    c_np = cond.float().numpy()
    Wp = 2 * halo + -(-W // Wt) * Wt
    b16, f32 = jnp.bfloat16, jnp.float32
    cond_j = jnp.asarray(np.stack([_padded(c_np[:, i], halo, Wp) for i in range(L)]), b16)
    w_j = [jnp.asarray(sw.T, b16), jnp.asarray(sb[:, None], b16),
           jnp.asarray(k_all.transpose(0, 2, 1), b16),
           jnp.asarray(rs_w.transpose(0, 2, 1), b16), jnp.asarray(rs_b, f32),
           jnp.asarray(ew.T, b16), jnp.asarray(eb[:, None], f32)]
    queues_j = jnp.zeros((L, KH - 1, C, B * Wp), b16)
    ring = torch.zeros(L, KH, B, C, W, dtype=BF16)
    x_prev = np.zeros((B, W), np.float32)
    for step in range(3):
        x_pad = np.zeros((B, Wp), np.float32)
        x_pad[:, halo:halo + W] = x_prev
        ls_r, t_r, queues_j = j_row_step(jnp.asarray(x_pad), queues_j, cond_j, *w_j, L=L,
                                         kh=KH, kw=KW, C=C, Wt=Wt, halo=halo, W=W)
        got = emulate_flow(torch.from_numpy(x_prev), ring, step, cond, *w)
        for g_, r_ in zip(got, (ls_r, t_r)):
            r_ = np.array(r_)[:, halo:halo + W]
            np.testing.assert_allclose(g_.numpy(), r_, atol=2 * _ulp(torch.from_numpy(r_)),
                                       rtol=0)
        x_prev = rng.standard_normal((B, W)).astype(np.float32)
    q_ref = np.array(queues_j.astype(f32)).reshape(L, KH - 1, C, B, Wp)[
        ..., halo:halo + W].transpose(0, 1, 3, 2, 4)
    q_got = hk.ring_queues(ring, 3).float().numpy()
    np.testing.assert_allclose(q_got, q_ref, atol=2 * _ulp(torch.from_numpy(q_ref)), rtol=0)

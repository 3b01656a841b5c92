"""The port's hand-written Hopper kernels, with their plain PyTorch versions.

Each kernel has three parts here:

- ``<name>_plain``: the same function in plain PyTorch. The CPU tests run
  it, and ``chip_smoke.py`` holds the kernel against it on the card.
- a ``torch.autograd.Function`` that launches the CUDA kernel (sources in
  ``csrc/``, built by ``_build.py``). ``attention_step`` and ``lstm_gates``
  run in training too: as the JAX package's ``custom_vjp`` does
  (cookietts_tpu/ops/pallas_kernels.py:146-169, 285-303), the forward
  launches the kernel and saves its inputs, and the backward is autograd
  of the plain version recomputed from them (``<name>_vjp``). The other
  three kernels are inference-only, in the JAX package too, and their
  ``backward`` raises.
- ``<name>``: the entry the models call. A CPU tensor takes the plain
  version; a CUDA tensor launches the kernel (and counts the launch in
  ``LAUNCHES``) or raises. There is no fallback from the card to the plain
  version.

The TPU kernel each one replaces, and what bounds it on the H100, is noted
at the head of its ``.cu`` source.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import _build

NEG = -1e30
LAUNCHES: Dict[str, int] = {"attention_step": 0, "lstm_gates": 0,
                            "hifigan_resblock": 0, "waveglow_wn_forward": 0,
                            "waveflow_row_step": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _check(name: str, t: torch.Tensor, shape: Sequence[int],
           dtype: torch.dtype = torch.float32) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")


def _dispatch(t: torch.Tensor, kernel: str) -> bool:
    """True for the card (launch the kernel), False for the CPU (plain)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{kernel}: unsupported device {t.device}")


class _NoBackward(torch.autograd.Function):
    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "inference-only kernel: it has no backward, as its Pallas "
            "counterpart in the JAX package has none")


def _plain_vjp(plain, diff, grads, needs):
    """Gradients of ``plain(*diff)`` with respect to the tensors of
    ``diff`` whose ``needs`` flag is set (None for the others): the plain
    version recomputed from detached copies under enable_grad, as JAX's
    custom_vjp backward takes the VJP of its plain expression."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(bool(n))
                  for t, n in zip(diff, needs)]
        outs = plain(*leaves)
        wanted = [t for t in leaves if t is not None and t.requires_grad]
        got = iter(torch.autograd.grad(outs, wanted, grads, allow_unused=True)
                   if wanted else ())
    return tuple(next(got) if t is not None and t.requires_grad else None
                 for t in leaves)


def derived(module: nn.Module, name: str, sources: Sequence[torch.Tensor],
            build: Callable[[], object]):
    """A value computed from ``sources`` and cached on ``module``; rebuilt
    when any source gets new storage (``.to``, ``load_state_dict`` into a
    new tensor) or is updated in place (its version counter moves)."""
    key = tuple((t.data_ptr(), t._version) for t in sources)
    hit = module.__dict__.get(name)
    if hit is None or hit[0] != key:
        with torch.no_grad():
            hit = (key, build())
        module.__dict__[name] = hit
    return hit[1]


# -- attention_step ------------------------------------------------------------

def attention_step_plain(qp, lp, mp, v, memory, mask, scale=None):
    """qp [B, A]; lp/mp [B, T, A]; v [A]; memory [B, T, D]; mask [B, T] bool
    (length and window); scale: None or a 1-element energy scale.
    Returns (context [B, D], weights [B, T])."""
    e = torch.einsum("bta,a->bt", torch.tanh(qp[:, None, :] + lp + mp), v)
    if scale is not None:
        e = e * scale
    e = e.masked_fill(~mask, NEG)
    w = torch.softmax(e, dim=-1)
    return torch.einsum("bt,btd->bd", w, memory), w


SMEM_MAX = 232448                    # shared memory a block may use (H100)
N_SM = 132                           # SMs of an H100 SXM
SM_SMEM, BLOCK_RESERVED = 233472, 1024   # an SM's shared memory; the system's share a block
# A cluster's blocks share one GPC. Its SMs vary from chip to chip (132 over
# 8 GPCs); counting 14 per GPC kept the plans whose clusters did not all fit
# at once out (tools/bench_attention.py: those ran in two waves).
N_GPC, GPC_SMS = 8, 14
ATTN_THREADS = 256                   # threads of an attention_step block
ATTN_CLUSTER_MAX = 16                # blocks a cluster may hold (non-portable above 8)
ATTN_MISC = 64                       # floats of a block's counts and statistics
# Rows a stage holds at most by default: the decoder's window of 2 x 16 + 1
# rows fits one stage, so it is read in one round trip.
ATTN_STAGE_ROWS = 48


def _attn_seg(n: int) -> int:
    """attention_step.cu's seg: floats of a staged row segment of n values
    (room for a 0-3 float shift, whole 16-byte words)."""
    return (n + 6) // 4 * 4


def attention_step_smem(A: int, D: int, rows: int, stage_rows: int) -> int:
    """Dynamic shared memory of a block (attention_step.cu's layout): q, v,
    the energies and admitted-row list of its rows, a stage's weights, the
    statistics, the partial context, and the staged rows."""
    fixed = (2 * A + 2 * rows + stage_rows + ATTN_MISC + D + 3) // 4 * 4
    return 4 * (fixed + stage_rows * (2 * _attn_seg(A) + _attn_seg(D)))


def clusters_fit(B: int, S: int, smem: int) -> bool:
    """Whether B clusters of S blocks, each using ``smem`` bytes of shared
    memory, are all resident at once (by the conservative GPC count)."""
    per_sm = min(2048 // ATTN_THREADS, SM_SMEM // (smem + BLOCK_RESERVED))
    return B <= N_GPC * (GPC_SMS * per_sm // S)


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """Launch plan of attention_step v3: a cluster of ``cluster`` blocks per
    batch row, block r owning rows [r rows, (r + 1) rows) of T; a stage
    holds ``stage_rows`` admitted rows, so a block whose rows are all
    admitted takes ``stages`` stages; ``smem`` bytes of shared memory a
    block."""
    cluster: int
    rows: int
    stage_rows: int
    stages: int
    smem: int

    def ints(self):
        """The plan as the C side takes it."""
        return self.cluster, self.rows, self.stage_rows


@functools.lru_cache(maxsize=None)
def attention_step_plan(B: int, T: int, A: int, D: int,
                        cluster: Optional[int] = None,
                        stage_rows: Optional[int] = None) -> AttentionPlan:
    """Split each batch row's T rows over a cluster of S blocks: by default
    the fewest (a power of two up to 16, at most T) that give B x S at least
    one block per SM, then as few as still cover T in R = ceil(T / S) rows
    a block, so none is empty. A stage holds R rows, at most
    ATTN_STAGE_ROWS; where B such clusters would not all be resident at
    once, S is halved until they are. ``cluster`` and ``stage_rows`` force
    the plan (tools/bench_attention.py). Raises where shared memory cannot
    hold one row."""
    if min(B, T, A, D) < 1:
        raise ValueError(f"attention_step: B={B}, T={T}, A={A}, D={D} must "
                         "be positive")
    S = cluster
    if S is None:
        S = 1
        while 2 * S <= min(ATTN_CLUSTER_MAX, T) and B * S < N_SM:
            S *= 2
    if not 1 <= S <= ATTN_CLUSTER_MAX:
        raise ValueError(f"attention_step: a cluster of {S} blocks (1 to "
                         f"{ATTN_CLUSTER_MAX})")
    while True:
        R = -(-T // S)
        S = -(-T // R)
        rows = min(R, stage_rows or ATTN_STAGE_ROWS)
        while rows > 1 and attention_step_smem(A, D, R, rows) > SMEM_MAX:
            rows -= 1
        smem = attention_step_smem(A, D, R, rows)
        if cluster or S == 1 or clusters_fit(B, S, smem):
            break
        S //= 2
    if smem > SMEM_MAX:
        raise ValueError(f"attention_step: A={A}, D={D}, T={T} need {smem} B "
                         f"of shared memory a block (max {SMEM_MAX}) for one "
                         "row a stage")
    return AttentionPlan(S, R, rows, -(-R // rows), smem)


def attention_step_vjp(qp, lp, mp, v, memory, mask, scale, grad_ctx,
                       grad_w, needs=(True,) * 6):
    """Backward of the attention step: gradients for (qp, lp, mp, v,
    memory, scale) from those of (context, weights), by autograd of
    attention_step_plain; ``needs`` picks which to compute. The plain
    version reads every row, so masked rows must hold finite values."""
    return _plain_vjp(
        lambda qp_, lp_, mp_, v_, mem_, sc_: attention_step_plain(
            qp_, lp_, mp_, v_, mem_, mask, sc_),
        (qp, lp, mp, v, memory, scale), (grad_ctx, grad_w), needs)


class _AttentionStep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qp, lp, mp, v, memory, mask, scale, plan):
        B, T, A = lp.shape
        D = memory.shape[-1]
        for name, t, shape in (("qp", qp, (B, A)), ("lp", lp, (B, T, A)),
                               ("mp", mp, (B, T, A)), ("v", v, (A,)),
                               ("memory", memory, (B, T, D))):
            _check(f"attention_step {name}", t, shape)
        _check("attention_step mask", mask, (B, T), torch.bool)
        if scale is not None:
            _check("attention_step scale", scale, (1,))
        plan = plan or attention_step_plan(B, T, A, D)
        lib = _build.library("attention_step")
        out_ctx = torch.empty((B, D), device=qp.device, dtype=torch.float32)
        out_w = torch.empty((B, T), device=qp.device, dtype=torch.float32)
        err = lib.attention_step(
            _ptr(qp), _ptr(lp), _ptr(mp), _ptr(v), _ptr(memory), _ptr(mask),
            _ptr(scale), B, T, A, D, *plan.ints(), _ptr(out_ctx), _ptr(out_w),
            _stream())
        _raise_on(err, "attention_step")
        LAUNCHES["attention_step"] += 1
        ctx.save_for_backward(qp, lp, mp, v, memory, mask, scale)
        return out_ctx, out_w

    @staticmethod
    def backward(ctx, grad_ctx, grad_w):
        qp, lp, mp, v, memory, mask, scale = ctx.saved_tensors
        n = ctx.needs_input_grad
        g = attention_step_vjp(qp, lp, mp, v, memory, mask, scale, grad_ctx,
                               grad_w, n[:5] + n[6:7])
        return (*g[:5], None, g[5], None)


def attention_step(qp, lp, mp, v, memory, mask, scale=None,
                   plan: Optional[AttentionPlan] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused location-sensitive attention step (see attention_step_plain);
    on the card one launch, split over T by ``plan`` (by default
    attention_step_plan's), reading only the rows the mask admits."""
    if not _dispatch(qp, "attention_step"):
        return attention_step_plain(qp, lp, mp, v, memory, mask, scale)
    return _AttentionStep.apply(qp, lp, mp, v, memory, mask, scale, plan)


# -- lstm_gates ----------------------------------------------------------------

def lstm_gates_plain(xh, weight, bias, c_prev):
    """xh [B, F]; weight [F, 4H] (gate blocks i, f, g, o); bias [4H];
    c_prev [B, H]. Returns (c_new, h_new); the forget gate gets +1."""
    i, f, g, o = (xh @ weight + bias).chunk(4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    return c, torch.sigmoid(o) * torch.tanh(c)


LSTM_COLS = 64          # columns of each gate block per block (lstm_gates.cu)
LSTM_GROUP_ROWS = 32    # batch rows per block pass (lstm_gates.cu)


@dataclasses.dataclass(frozen=True)
class LstmPlan:
    """Launch plan of the one-launch lstm_gates kernel. Block (x, y, z) of
    ``grid`` owns columns [64 x, 64 x + 64) of each gate block, rows
    [y f_per_slice, (y + 1) f_per_slice) of W, batch rows [32 z, 32 z + 32).
    ``partial`` (floats) and ``tickets`` (ints) are the scratch sizes."""
    grid: Tuple[int, int, int]
    slices: int
    f_per_slice: int
    partial: int
    tickets: int


def lstm_gates_plan(B: int, F: int, H: int, target_blocks: int = 264,
                    min_rows: int = 32) -> LstmPlan:
    """Split F into slices so that the grid is about two blocks per SM of
    the card's 132, with at least ``min_rows`` rows of W per slice."""
    col_tiles = -(-H // LSTM_COLS)
    groups = -(-B // LSTM_GROUP_ROWS)
    slices = max(1, min(target_blocks // (col_tiles * groups), F // min_rows))
    f_per_slice = -(-F // slices)
    slices = -(-F // f_per_slice)
    return LstmPlan((col_tiles, slices, groups), slices, f_per_slice,
                    slices * B * 4 * H, groups * col_tiles)


# lstm_gates' ticket counters, one set per thing that can run at the same
# time as another: a stream (eager launches) or a CUDA-graph capture.
_TICKETS: Dict[tuple, torch.Tensor] = {}
_KEEP: Dict[tuple, list] = {}   # every counter tensor handed out, by key: a
                                # launch in flight or a captured graph may
                                # still use a replaced one


def _capture_id(stream: int) -> int:
    """The id of the CUDA-graph capture under way on ``stream`` (0: none)."""
    cid = ctypes.c_ulonglong(0)
    _raise_on(_build.library("lstm_gates").lstm_capture_id(
        ctypes.c_void_p(stream), ctypes.byref(cid)), "lstm_capture_id")
    return cid.value


def _counter_key(device: torch.device) -> tuple:
    """("capture", device, id) while the current stream is being captured
    into a CUDA graph, else ("stream", device, stream)."""
    stream = torch.cuda.current_stream(device).cuda_stream
    if torch.cuda.is_current_stream_capturing():
        return ("capture", device, _capture_id(stream))
    return ("stream", device, stream)


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """The ticket counters of lstm_gates for ``_counter_key(device)``:
    zeroed when allocated, left at 0 by every
    launch (see csrc/lstm_gates.cu). Launches on one stream, or recorded
    into one graph, run one after another and share a set; two streams, or
    two graphs replayed at once, never do. A capture's set is allocated
    during the capture, so its zeroing memset is a node of the graph (one
    per replay, not per launch), and it is kept until ``release_tickets``
    drops it with its graph."""
    key = _counter_key(device)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _TICKETS[key] = t
        _KEEP.setdefault(key, []).append(t)
    return t


def release_tickets(keys) -> None:
    """Drop the counter sets of ``keys`` (those of a capture whose graph is
    released); the caller makes sure nothing that uses them is in flight."""
    for key in keys:
        _TICKETS.pop(key, None)
        _KEEP.pop(key, None)


def lstm_gates_vjp(xh, weight, bias, c_prev, grad_c, grad_h,
                   needs=(True,) * 4):
    """Backward of the LSTM gate step: gradients for (xh, weight, bias,
    c_prev) from those of (c_new, h_new), by autograd of lstm_gates_plain."""
    return _plain_vjp(lstm_gates_plain, (xh, weight, bias, c_prev),
                      (grad_c, grad_h), needs)


class _LstmGates(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xh, weight, bias, c_prev):
        B, F_ = xh.shape
        H = c_prev.shape[-1]
        for name, t, shape in (("xh", xh, (B, F_)), ("weight", weight, (F_, 4 * H)),
                               ("bias", bias, (4 * H,)), ("c_prev", c_prev, (B, H))):
            _check(f"lstm_gates {name}", t, shape)
        lib = _build.library("lstm_gates")
        plan = lstm_gates_plan(B, F_, H)
        partial = torch.empty(plan.partial, device=xh.device, dtype=torch.float32)
        tickets = _tickets(xh.device, plan.tickets)
        c_new = torch.empty((B, H), device=xh.device, dtype=torch.float32)
        h_new = torch.empty_like(c_new)
        err = lib.lstm_gates(_ptr(xh), _ptr(weight), _ptr(bias), _ptr(c_prev),
                             B, F_, H, plan.grid[0], plan.slices,
                             plan.f_per_slice, _ptr(partial), _ptr(tickets),
                             _ptr(c_new), _ptr(h_new), _stream())
        _raise_on(err, "lstm_gates")
        LAUNCHES["lstm_gates"] += 1
        ctx.save_for_backward(xh, weight, bias, c_prev)
        return c_new, h_new

    @staticmethod
    def backward(ctx, grad_c, grad_h):
        return lstm_gates_vjp(*ctx.saved_tensors, grad_c, grad_h,
                              ctx.needs_input_grad)


def lstm_gates(xh, weight, bias, c_prev) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused LSTM gate step (see lstm_gates_plain)."""
    if not _dispatch(xh, "lstm_gates"):
        return lstm_gates_plain(xh, weight, bias, c_prev)
    return _LstmGates.apply(xh, weight, bias, c_prev)


# -- hifigan_resblock ----------------------------------------------------------

def hifigan_resblock_plain(x, w1, b1, w2, b2, dilations, slope):
    """One MRF ResBlock1. x [B, C, T]; w1/w2 [P, k, C_in, C_out] (weight
    norm folded); b1/b2 [P, C]; dilations: P ints. Returns [B, C, T]."""
    k = w1.shape[1]
    for p, d in enumerate(dilations):
        h = F.conv1d(F.leaky_relu(x, slope), w1[p].permute(2, 1, 0), b1[p],
                     padding=d * (k - 1) // 2, dilation=d)
        h = F.conv1d(F.leaky_relu(h, slope), w2[p].permute(2, 1, 0), b2[p],
                     padding=(k - 1) // 2)
        x = x + h
    return x


# C -> (conv columns a block computes, input channels of a weight slab)
RESBLOCK_FUSED = {8: (1024, 8), 16: (1024, 16), 32: (512, 32), 64: (256, 64)}
RESBLOCK_SPLIT_TILE = 64                # samples per block of the split variant


def _pad_stride(w: int) -> int:
    """hifigan_resblock.cu's pad_stride: the least stride >= w that is 8
    mod 16 (conflict-free fragment loads)."""
    return (w - 8 + 15) // 16 * 16 + 8


def resblock_split_rows(C: int) -> int:
    """Output channels per block of the split variant: of 128, 64 and 32,
    the one that pads C least (the larger on a tie)."""
    return min((128, 64, 32), key=lambda m: -(-C // m) * m)


def hifigan_resblock_plan(B: int, C: int, T: int, k: int, d: int
                          ) -> Tuple[int, Tuple[int, int, int], int, str]:
    """Launch plan of one dilation pair: (tile, grid, smem_bytes, variant).
    Block x of the grid writes output samples [x tile, (x + 1) tile) of
    [0, T). "fused" (C of 8, 16, 32 or 64): one launch, grid (tiles, B, 1);
    "split" (every other C): two launches through a scratch h, grid (tiles,
    ceil(C / rows), B) with rows = resblock_split_rows(C). Raises for what
    the kernel does not take: an even k, or a k and d whose window overflows
    shared memory."""
    if k % 2 == 0:
        raise ValueError(f"hifigan_resblock: k={k} must be odd")
    if C <= 0:
        raise ValueError(f"hifigan_resblock: C={C} must be positive")
    half = k // 2
    if C in RESBLOCK_FUSED:
        n1, kc = RESBLOCK_FUSED[C]
        tile = n1 - 2 * half
        smem = 4 * (C * (_pad_stride(n1 + 2 * half * d) + _pad_stride(n1 + 2 * half))
                    + 3 * kc * _pad_stride(C))
        grid, variant = (-(-T // max(tile, 1)), B, 1), "fused"
    else:
        tile, rows = RESBLOCK_SPLIT_TILE, resblock_split_rows(C)
        smem = 4 * 3 * 32 * (_pad_stride(tile + (k - 1) * d) + _pad_stride(rows))
        grid, variant = (-(-T // tile), -(-C // rows), B), "split"
    if tile <= 0 or smem > SMEM_MAX:
        raise ValueError(f"hifigan_resblock: C={C} k={k} d={d} needs {smem} B "
                         f"of shared memory (max {SMEM_MAX}) and a tile of "
                         f"{tile} samples")
    return tile, grid, smem, variant


def hifigan_resblock_launches(C: int, n_pairs: int) -> int:
    """Kernel launches of one resblock on the card."""
    return n_pairs * (1 if C in RESBLOCK_FUSED else 2)


class _HifiganResblock(_NoBackward):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, dilations, slope):
        B, C, T = x.shape
        P, k = w1.shape[:2]
        if len(dilations) != P:
            raise ValueError(f"hifigan_resblock: {P} weight pairs, "
                             f"{len(dilations)} dilations")
        for name, t, shape in (("x", x, (B, C, T)), ("w1", w1, (P, k, C, C)),
                               ("b1", b1, (P, C)), ("w2", w2, (P, k, C, C)),
                               ("b2", b2, (P, C))):
            _check(f"hifigan_resblock {name}", t, shape)
        plans = [hifigan_resblock_plan(B, C, T, k, int(d)) for d in dilations]
        lib = _build.library("hifigan_resblock")
        h = (torch.empty_like(x) if plans[0][3] == "split" else None)
        stream = _stream()
        for p, (d, (tile, _, smem, variant)) in enumerate(zip(dilations, plans)):
            y = torch.empty_like(x)
            err = lib.hifigan_resblock_pair(
                _ptr(x), _ptr(w1[p]), _ptr(b1[p]), _ptr(w2[p]), _ptr(b2[p]),
                B, C, T, k, int(d), ctypes.c_float(slope),
                0 if variant == "fused" else 1, tile, resblock_split_rows(C),
                ctypes.c_longlong(smem),
                _ptr(h), _ptr(y), stream)
            _raise_on(err, "hifigan_resblock")
            LAUNCHES["hifigan_resblock"] += hifigan_resblock_launches(C, 1)
            x = y
        return x


def hifigan_resblock(x, w1, b1, w2, b2, dilations: Sequence[int],
                     slope: float) -> torch.Tensor:
    """Fused MRF resblock (see hifigan_resblock_plain); on the card one
    launch per dilation pair at C of 8, 16, 32 or 64, two at every other C
    (hifigan_resblock_plan)."""
    if not _dispatch(x, "hifigan_resblock"):
        return hifigan_resblock_plain(x, w1, b1, w2, b2, dilations, slope)
    return _HifiganResblock.apply(x, w1, b1, w2, b2, tuple(dilations),
                                  float(slope))


# -- waveglow_wn_forward and waveflow_row_step -----------------------------------
#
# Both evaluate a WaveNet coupling net (WN) on channel-major activations
# with the batch a real axis, so no tap crosses from one utterance into the
# next. The weights are input-major (flax's own layouts), so a kernel
# thread's output channels are contiguous:
#   start_w [Cin, C], start_b [C]
#   k_all   [L, rows*kw*C, 2C]  (kernel row, tap, channel; rows = 1 or kh)
#   rs_w    [L, C, 2C], rs_b [L, 2C]  (res half first; the last layer's res
#           half is zero and is not computed)
#   end_w   [C, Cout], end_b [Cout]
#   cond_bc [B, L, 2C, T]: the cond projection with the conv biases folded in
# Layer i has dilation 2**i; taps sit at (tap - kw // 2) * 2**i; zero padding
# at both ends of the sequence.

def gtu(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return torch.tanh(a) * torch.sigmoid(g)


def _wn_layer(i, L, conv, cond_bc, rs_w, rs_b, gate, h, skip):
    C = rs_w.shape[1]
    acts = conv + cond_bc[:, i]
    out = gate(acts[:, :C], acts[:, C:])
    rs = torch.matmul(rs_w[i].t(), out) + rs_b[i][:, None]
    if i < L - 1:
        h = h + rs[:, :C]
    return h, (rs[:, C:] if skip is None else skip + rs[:, C:])


def waveglow_wn_forward_plain(x, cond_bc, start_w, start_b, k_all, rs_w, rs_b,
                              end_w, end_b, gate: Callable = gtu):
    """One flow's whole WN. x [B, Cin, T] -> st [B, Cout, T]: start 1x1, L
    layers of {kw-tap dilated conv + cond -> gate -> res/skip 1x1}, end 1x1
    on the summed skips."""
    L, _, C2 = k_all.shape
    C = C2 // 2
    kw = k_all.shape[1] // C
    h = torch.matmul(start_w.t(), x) + start_b[:, None]
    skip = None
    for i in range(L):
        d = 2 ** i
        w = k_all[i].view(kw, C, C2).permute(2, 1, 0)        # [2C, C, kw]
        conv = F.conv1d(h, w, padding=(kw // 2) * d, dilation=d)
        h, skip = _wn_layer(i, L, conv, cond_bc, rs_w, rs_b, gate, h, skip)
    return torch.matmul(end_w.t(), skip) + end_b[:, None]


# The layer kernel's tile shapes (csrc/wn_layer.cuh, launch_layer), by id:
# (WM, WN, NJ) = WM x WN warps, each 32 rows (16 channel pairs) x 8 NJ
# samples; a block owns m = 16 WM channel pairs by 8 WN NJ samples.
WN_TILES = ((4, 2, 4), (4, 2, 2), (4, 2, 1), (4, 1, 1),
            (2, 4, 2), (2, 4, 1), (2, 2, 1), (2, 1, 1))
WN_KC, WN_STAGES = 32, 3        # input channels a K step; weight slabs in flight
# Samples (B x T') from which a launch must give every SM a block; below,
# half of them. A layer at a request's length is a few K steps of latency,
# where larger blocks on fewer SMs measured faster (tools/bench_wn_tiles.py).
WN_FILL_FROM = 1500


@dataclasses.dataclass(frozen=True)
class WnLaunch:
    """One launch of a WN layer. Block (x, y, z) of ``grid`` writes batch
    row z, channels [y m, (y + 1) m) of its output (z for the conv; h_out
    and the skip sum for res/skip), samples [x n, (x + 1) n) of [0, T).
    ``win_stride`` is the padded row stride of a staged input window (floats),
    ``smem`` the shared memory bytes."""
    tile: int
    m: int
    n: int
    threads: int
    grid: Tuple[int, int, int]
    win_stride: int
    smem: int

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


@dataclasses.dataclass(frozen=True)
class WnPlan:
    """The two launches of every layer of one WN call: the conv (into z),
    then res/skip (from z)."""
    conv: WnLaunch
    rs: WnLaunch

    def ints(self):
        """The plan as the C side takes it (csrc/wn_layer.cuh: wn::Plan)."""
        return (ctypes.c_int * 6)(self.conv.tile, self.conv.win_stride,
                                  self.conv.smem, self.rs.tile,
                                  self.rs.win_stride, self.rs.smem)


def wn_launch(tile: int, B: int, C: int, T: int, kw: int) -> WnLaunch:
    """The launch of tile shape ``tile`` over B rows of T samples, C channel
    pairs, kw taps (1: the res/skip product). Raises where it does not fit."""
    wm, wn, nj = WN_TILES[tile]
    m, n, threads = 16 * wm, 8 * wn * nj, 32 * wm * wn
    if C % m or C % WN_KC:
        raise ValueError(f"WN tile {tile}: C={C} is not a multiple of {m}")
    win_stride = _pad_stride(kw * n)
    smem = 4 * WN_KC * (WN_STAGES * _pad_stride(2 * m)
                        + (2 if kw >= 2 else 3) * win_stride)
    if smem > SMEM_MAX:
        raise ValueError(f"WN tile {tile}: kw={kw} needs {smem} B of shared "
                         f"memory (max {SMEM_MAX})")
    return WnLaunch(tile, m, n, threads, (-(-T // n), C // m, B), win_stride,
                    smem)


def _wn_pick(B: int, C: int, T: int, kw: int) -> WnLaunch:
    """The largest block (channel pairs x samples; at equal size the fewer
    pairs) that still gives every SM a block, or half of them below
    WN_FILL_FROM samples; where none does, the tile with the most blocks."""
    fits = [wn_launch(i, B, C, T, kw) for i, (wm, _, _) in enumerate(WN_TILES)
            if C % (16 * wm) == 0]
    need = N_SM if B * T >= WN_FILL_FROM else N_SM // 2
    ok = [f for f in fits if f.blocks >= need] or [max(fits, key=lambda f: f.blocks)]
    return max(ok, key=lambda f: (f.m * f.n, -f.m))


def wn_layer_plan(B: int, C: int, T: int, rows: int, kw: int) -> WnPlan:
    """Launch plan of every layer of a WN over B rows of T samples at C
    channels with a (rows x kw)-tap conv: the tile of each of its two
    launches, picked by the blocks it gives and the SMs they fill. Raises
    for what the kernels do not take."""
    if C not in (32, 64, 128, 256):
        raise ValueError(f"WN: n_channels={C} unsupported (32, 64, 128 or "
                         "256: a layer's tiles must fit shared memory)")
    if kw % 2 == 0 or rows < 1 or B < 1 or T < 1:
        raise ValueError(f"WN: B={B}, T={T}, rows={rows}, kw={kw} unsupported "
                         "(kw odd, the rest positive)")
    return WnPlan(_wn_pick(B, C, T, kw), _wn_pick(B, C, T, 1))


def wn_launches(L: int) -> int:
    """Kernel launches of one WN evaluation on the card: the start product,
    two per layer (WnPlan's conv and res/skip), the end product."""
    return 2 * L + 2


def _launch_wn(kernel: str, fn, *args) -> None:
    launches = ctypes.c_int(0)
    _raise_on(fn(*args, ctypes.byref(launches), _stream()), kernel)
    LAUNCHES[kernel] += launches.value


class _WaveglowWnForward(_NoBackward):
    @staticmethod
    def forward(ctx, x, cond_bc, start_w, start_b, k_all, rs_w, rs_b, end_w,
                end_b, plan):
        B, Cin, T = x.shape
        L, KC, C2 = k_all.shape
        C, Cout = C2 // 2, end_w.shape[1]
        kw = KC // C
        for name, t, shape in (
                ("x", x, (B, Cin, T)), ("cond_bc", cond_bc, (B, L, C2, T)),
                ("start_w", start_w, (Cin, C)), ("start_b", start_b, (C,)),
                ("k_all", k_all, (L, kw * C, C2)), ("rs_w", rs_w, (L, C, C2)),
                ("rs_b", rs_b, (L, C2)), ("end_w", end_w, (C, Cout)),
                ("end_b", end_b, (Cout,))):
            _check(f"waveglow_wn_forward {name}", t, shape)
        plan = plan or wn_layer_plan(B, C, T, 1, kw)
        lib = _build.library("waveglow_wn")
        scratch = torch.empty((3, B, C, T), device=x.device, dtype=torch.float32)
        st = torch.empty((B, Cout, T), device=x.device, dtype=torch.float32)
        _launch_wn("waveglow_wn_forward", lib.waveglow_wn_forward,
                   _ptr(x), _ptr(cond_bc), _ptr(start_w), _ptr(start_b),
                   _ptr(k_all), _ptr(rs_w), _ptr(rs_b), _ptr(end_w), _ptr(end_b),
                   B, Cin, C, Cout, T, L, kw, plan.ints(), _ptr(scratch), _ptr(st))
        return st


def waveglow_wn_forward(x, cond_bc, start_w, start_b, k_all, rs_w, rs_b,
                        end_w, end_b, plan: Optional[WnPlan] = None
                        ) -> torch.Tensor:
    """WN of one WaveGlow flow, GTU only (see waveglow_wn_forward_plain); on
    the card two launches per layer (the conv, then res/skip, tiled by
    ``plan``, by default wn_layer_plan's) plus the start and end products."""
    args = (x, cond_bc, start_w, start_b, k_all, rs_w, rs_b, end_w, end_b)
    if not _dispatch(x, "waveglow_wn_forward"):
        return waveglow_wn_forward_plain(*args)
    return _WaveglowWnForward.apply(*args, plan)


def waveflow_row_step_plain(x_prev, queues, cond_bc, start_w, start_b, k_all,
                            rs_w, rs_b, end_w, end_b, gate: Callable = gtu):
    """One height row of the WaveFlow inverse. x_prev [B, W] (the previous
    generated row, zeros for row 0); queues [L, kh-1, B, C, W]: each layer's
    last kh-1 input rows, oldest first. Each layer convolves (kh rows x kw
    taps) over its queue plus the current row. Returns (log_s [B, W],
    t [B, W], new queues: oldest row dropped, current row appended)."""
    L, khm1, _, C, _ = queues.shape
    kh, C2 = khm1 + 1, 2 * C
    kw = k_all.shape[1] // (kh * C)
    h = start_w[0][None, :, None] * x_prev[:, None, :] + start_b[None, :, None]
    skip, new_queues = None, []
    for i in range(L):
        d = 2 ** i
        rows = torch.cat([queues[i], h[None]], 0)            # [kh, B, C, W]
        w = k_all[i].view(kh, kw, C, C2).permute(3, 2, 0, 1)  # [2C, C, kh, kw]
        conv = F.conv2d(rows.permute(1, 2, 0, 3), w, padding=(0, (kw // 2) * d),
                        dilation=(1, d))[:, :, 0]
        new_queues.append(rows[1:])
        h, skip = _wn_layer(i, L, conv, cond_bc, rs_w, rs_b, gate, h, skip)
    st = torch.matmul(end_w.t(), skip) + end_b[:, None]
    return st[:, 0], st[:, 1], torch.stack(new_queues)


def ring_queues(ring: torch.Tensor, step: int) -> torch.Tensor:
    """The queues [L, kh-1, B, C, W] (oldest first) that a ring
    [L, kh, B, C, W] holds before row ``step``: slot ``s % kh`` of a layer
    holds its input row of step s, so the rows before ``step`` sit in slots
    step+1 ... step+kh-1 (mod kh)."""
    kh = ring.shape[1]
    return ring[:, [(step + 1 + r) % kh for r in range(kh - 1)]]


def waveflow_row_step_ring_plain(x_prev, ring, step: int, cond_bc, *weights,
                                 gate: Callable = gtu):
    """waveflow_row_step in plain PyTorch: the plain row step on the ring's
    queues, then the current row of every layer into slot ``step % kh``."""
    log_s, t, queues = waveflow_row_step_plain(
        x_prev, ring_queues(ring, step), cond_bc, *weights, gate=gate)
    if ring.shape[1] > 1:
        ring[:, step % ring.shape[1]] = queues[:, -1]
    return log_s, t


class _WaveflowRowStep(_NoBackward):
    @staticmethod
    def forward(ctx, x_prev, ring, step, cond_bc, start_w, start_b, k_all,
                rs_w, rs_b, end_w, end_b, plan):
        B, W = x_prev.shape
        L, kh, _, C, _ = ring.shape
        C2 = 2 * C
        kw = k_all.shape[1] // (kh * C)
        for name, t, shape in (
                ("x_prev", x_prev, (B, W)), ("ring", ring, (L, kh, B, C, W)),
                ("cond_bc", cond_bc, (B, L, C2, W)),
                ("start_w", start_w, (1, C)), ("start_b", start_b, (C,)),
                ("k_all", k_all, (L, kh * kw * C, C2)),
                ("rs_w", rs_w, (L, C, C2)), ("rs_b", rs_b, (L, C2)),
                ("end_w", end_w, (C, 2)), ("end_b", end_b, (2,))):
            _check(f"waveflow_row_step {name}", t, shape)
        plan = plan or wn_layer_plan(B, C, W, kh, kw)
        lib = _build.library("waveflow_row")
        scratch = torch.empty((2, B, C, W), device=ring.device, dtype=torch.float32)
        st = torch.empty((B, 2, W), device=ring.device, dtype=torch.float32)
        _launch_wn("waveflow_row_step", lib.waveflow_row_step,
                   _ptr(x_prev), _ptr(ring), int(step), _ptr(cond_bc),
                   _ptr(start_w), _ptr(start_b), _ptr(k_all), _ptr(rs_w),
                   _ptr(rs_b), _ptr(end_w), _ptr(end_b), B, C, W, L, kh, kw,
                   plan.ints(), _ptr(scratch), _ptr(st))
        return st[:, 0], st[:, 1]


def waveflow_row_step(x_prev, ring, step: int, cond_bc, start_w, start_b,
                      k_all, rs_w, rs_b, end_w, end_b,
                      plan: Optional[WnPlan] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One WaveFlow inverse row step, GTU only, with the queues kept as a
    ring of kh row slots per layer, ``ring`` [L, kh, B, C, W], updated in
    place: row ``step`` of every layer's input lands in slot ``step % kh``,
    the oldest row there, and the conv reads the slots with its kernel rows
    rotated by ``step % kh``. Nothing is shifted or copied, and since a
    layer's conv only reads its own ring and its res/skip launch writes only
    the next layer's oldest slot, no block reads what another writes. Start with a zero ring at step 0.
    Returns (log_s [B, W], t [B, W]); ``ring_queues(ring, step + 1)`` are
    then the new queues of waveflow_row_step_plain. On the card: two
    launches per layer, tiled by ``plan`` (by default wn_layer_plan's), plus
    the start and end products."""
    args = (x_prev, ring, step, cond_bc, start_w, start_b, k_all, rs_w, rs_b,
            end_w, end_b)
    if not _dispatch(x_prev, "waveflow_row_step"):
        return waveflow_row_step_ring_plain(*args)
    return _WaveflowRowStep.apply(*args, plan)

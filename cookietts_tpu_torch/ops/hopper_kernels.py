"""The port's hand-written Hopper kernels, with their plain PyTorch versions.

Each kernel has three parts here:

- ``<name>_plain``: the same function in plain PyTorch. The CPU tests run
  it, and ``chip_smoke.py`` holds the kernel against it on the card.
- a ``torch.autograd.Function`` that launches the CUDA kernel (sources in
  ``csrc/``, built by ``_build.py``). Inference only: ``backward`` raises
  until the training slice brings backward kernels.
- ``<name>``: the entry the models call. A CPU tensor takes the plain
  version; a CUDA tensor launches the kernel (and counts the launch in
  ``LAUNCHES``) or raises. There is no fallback from the card to the plain
  version.

The TPU kernel each one replaces, and what bounds it on the H100, is noted
at the head of its ``.cu`` source.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import _build

NEG = -1e30
LAUNCHES: Dict[str, int] = {"attention_step": 0, "lstm_gates": 0,
                            "hifigan_resblock": 0}


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
            "inference-only kernel: its backward kernel comes with the "
            "training slice")


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


class _AttentionStep(_NoBackward):
    @staticmethod
    def forward(ctx, qp, lp, mp, v, memory, mask, scale):
        B, T, A = lp.shape
        D = memory.shape[-1]
        for name, t, shape in (("qp", qp, (B, A)), ("lp", lp, (B, T, A)),
                               ("mp", mp, (B, T, A)), ("v", v, (A,)),
                               ("memory", memory, (B, T, D))):
            _check(f"attention_step {name}", t, shape)
        _check("attention_step mask", mask, (B, T), torch.bool)
        if scale is not None:
            _check("attention_step scale", scale, (1,))
        if D % 4:
            raise ValueError(f"attention_step: D={D} must be a multiple of 4")
        lib = _build.library("attention_step")
        out_ctx = torch.empty((B, D), device=qp.device, dtype=torch.float32)
        out_w = torch.empty((B, T), device=qp.device, dtype=torch.float32)
        err = lib.attention_step(
            _ptr(qp), _ptr(lp), _ptr(mp), _ptr(v), _ptr(memory), _ptr(mask),
            _ptr(scale), B, T, A, D, _ptr(out_ctx), _ptr(out_w), _stream())
        _raise_on(err, "attention_step")
        LAUNCHES["attention_step"] += 1
        return out_ctx, out_w


def attention_step(qp, lp, mp, v, memory, mask, scale=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused location-sensitive attention step (see attention_step_plain)."""
    if not _dispatch(qp, "attention_step"):
        return attention_step_plain(qp, lp, mp, v, memory, mask, scale)
    return _AttentionStep.apply(qp, lp, mp, v, memory, mask, scale)


# -- lstm_gates ----------------------------------------------------------------

def lstm_gates_plain(xh, weight, bias, c_prev):
    """xh [B, F]; weight [F, 4H] (gate blocks i, f, g, o); bias [4H];
    c_prev [B, H]. Returns (c_new, h_new); the forget gate gets +1."""
    i, f, g, o = (xh @ weight + bias).chunk(4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    return c, torch.sigmoid(o) * torch.tanh(c)


def lstm_gates_slices(B: int, F: int, H: int, target_blocks: int = 264,
                      min_rows: int = 64) -> int:
    """Slices of F for the product kernel: enough blocks for two per SM of
    the card's 132, with at least ``min_rows`` rows of W per slice."""
    blocks = -(-H // 32) * -(-B // 8)
    return max(1, min(-(-target_blocks // blocks), F // min_rows))


class _LstmGates(_NoBackward):
    @staticmethod
    def forward(ctx, xh, weight, bias, c_prev):
        B, F_ = xh.shape
        H = c_prev.shape[-1]
        for name, t, shape in (("xh", xh, (B, F_)), ("weight", weight, (F_, 4 * H)),
                               ("bias", bias, (4 * H,)), ("c_prev", c_prev, (B, H))):
            _check(f"lstm_gates {name}", t, shape)
        lib = _build.library("lstm_gates")
        slices = lstm_gates_slices(B, F_, H)
        partial = torch.empty((slices, B, 4 * H), device=xh.device,
                              dtype=torch.float32)
        c_new = torch.empty((B, H), device=xh.device, dtype=torch.float32)
        h_new = torch.empty_like(c_new)
        err = lib.lstm_gates(_ptr(xh), _ptr(weight), _ptr(bias), _ptr(c_prev),
                             B, F_, H, slices, _ptr(partial), _ptr(c_new),
                             _ptr(h_new), _stream())
        _raise_on(err, "lstm_gates")
        LAUNCHES["lstm_gates"] += 1
        return c_new, h_new


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


class _HifiganResblock(_NoBackward):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, dilations, slope):
        B, C, T = x.shape
        P, k = w1.shape[:2]
        if len(dilations) != P:
            raise ValueError(f"hifigan_resblock: {P} weight pairs, "
                             f"{len(dilations)} dilations")
        if C % 8 or 256 % (C // 8) or 16384 // C <= 2 * (k // 2):
            raise ValueError(f"hifigan_resblock: C={C}, k={k} unsupported "
                             "(C a power of two, 16384 / C > k - 1)")
        for name, t, shape in (("x", x, (B, C, T)), ("w1", w1, (P, k, C, C)),
                               ("b1", b1, (P, C)), ("w2", w2, (P, k, C, C)),
                               ("b2", b2, (P, C))):
            _check(f"hifigan_resblock {name}", t, shape)
        lib = _build.library("hifigan_resblock")
        lib.hifigan_resblock_smem.restype = ctypes.c_longlong
        for d in dilations:
            smem = lib.hifigan_resblock_smem(C, k, int(d))
            if smem > 232448:
                raise ValueError(f"hifigan_resblock: C={C} k={k} d={d} needs "
                                 f"{smem} B of shared memory (max 232448)")
        stream = _stream()
        for p, d in enumerate(dilations):
            y = torch.empty_like(x)
            err = lib.hifigan_resblock_pair(
                _ptr(x), _ptr(w1[p]), _ptr(b1[p]), _ptr(w2[p]), _ptr(b2[p]),
                B, C, T, k, int(d), ctypes.c_float(slope), _ptr(y), stream)
            _raise_on(err, "hifigan_resblock")
            LAUNCHES["hifigan_resblock"] += 1
            x = y
        return x


def hifigan_resblock(x, w1, b1, w2, b2, dilations: Sequence[int],
                     slope: float) -> torch.Tensor:
    """Fused MRF resblock (see hifigan_resblock_plain); on the card one
    launch per dilation pair."""
    if not _dispatch(x, "hifigan_resblock"):
        return hifigan_resblock_plain(x, w1, b1, w2, b2, dilations, slope)
    return _HifiganResblock.apply(x, w1, b1, w2, b2, tuple(dilations),
                                  float(slope))

"""The port's hand-written Hopper kernels, with their plain PyTorch versions.

Each kernel has three parts here:

- ``<name>_plain``: the same function in plain PyTorch. The CPU tests run
  it, and ``chip_smoke.py`` holds the kernel against it on the card.
- a ``torch.library`` custom op, ``torch.ops.cookietts_tpu_torch.<name>``
  (``NAMESPACE``), so that ``torch.export`` can trace the kernels into a
  serving artifact (runtime/export_serving.py). Its CPU implementation is
  the plain version; its CUDA implementation launches the kernel (sources
  in ``csrc/``, built by ``_build.py``, called through ctypes), counts the
  launch in ``LAUNCHES`` and raises when the build or the launch fails;
  its fake implementation gives shapes and dtypes only. No other device
  has an implementation. ``attention_step`` and ``lstm_gates`` run in
  training too: as the JAX package's ``custom_vjp`` does
  (cookietts_tpu/ops/pallas_kernels.py:146-169, 285-303), their autograd
  formula (``register_autograd``) saves the inputs and takes autograd of
  the plain version recomputed from them (``<name>_vjp``). The other three
  kernels are inference-only, in the JAX package too, and their backward
  raises. ``waveflow_row_step`` updates its ring in place
  (``mutates_args``).
- ``<name>``: the entry the models call, with the op's arguments in the
  models' types (plans as dataclasses, tuples of dilations). There is no
  fallback from the card to the plain version.

Every kernel has a bf16 form too, for the bf16 models: the same op, with a
C entry of its own (``<entry>_bf16``) and a launch count of its own
(``<name>_bf16``). ``attention_step``, ``lstm_gates`` and
``hifigan_resblock`` pick it by the dtype of their first input; the two WN
kernels by the dtype of ``cond_bc`` (their first input, x or x_prev, stays
f32 in the bf16 form, as in JAX's). Every other input must then have the
dtype that form takes (``_check``, ``_wn_form``): nothing is cast on the way
in. The plain versions take the same bf16 inputs and compute what the bf16
kernels compute: f32 math on the widened values, rounded to bf16 where the
kernel rounds.

The TPU kernel each one replaces, and what bounds it on the H100, is noted
at the head of its ``.cu`` source.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from . import _build

NEG = -1e30
NAMESPACE = "cookietts_tpu_torch"
LAUNCHES: Dict[str, int] = {"attention_step": 0, "lstm_gates": 0,
                            "hifigan_resblock": 0, "waveglow_wn_forward": 0,
                            "waveflow_row_step": 0, "attention_step_bf16": 0,
                            "lstm_gates_bf16": 0, "hifigan_resblock_bf16": 0,
                            "waveglow_wn_forward_bf16": 0,
                            "waveflow_row_step_bf16": 0}
BF16 = torch.bfloat16


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


def _form(t: torch.Tensor) -> Tuple[torch.dtype, str]:
    """(dtype, suffix) of the form a kernel's first input picks: bf16 for a
    bf16 tensor, else f32 (whose _check then refuses anything but f32)."""
    return (BF16, "_bf16") if t.dtype == BF16 else (torch.float32, "")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")


def _refuse_other_devices(t: torch.Tensor, kernel: str) -> None:
    """The ops have a CPU (plain) and a CUDA (kernel) implementation only."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: unsupported device {t.device}")


def _custom_op(name: str, schema: str, plain: Callable,
               mutates_args: Tuple[str, ...] = ()):
    """The op ``NAMESPACE::name`` with ``plain`` as its CPU implementation;
    the caller registers the CUDA and fake implementations."""
    return torch.library.custom_op(f"{NAMESPACE}::{name}", plain,
                                   mutates_args=mutates_args,
                                   device_types="cpu", schema=schema)


def _no_backward(ctx, *grads):
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
    new tensor) or is updated in place (its version counter moves).

    Under ``torch.export`` (or ``torch.compile``) nothing is stored: a value
    cached for these very sources (an eager call before the export, as
    runtime/export_serving.py makes) is returned, and the program bakes it
    in as a constant; else (sources without storage, traced as a module's
    parameters) the value is built in the traced program."""
    try:
        key = tuple((t.data_ptr(), t._version) for t in sources)
    except RuntimeError:            # a traced tensor has no storage
        key = None
    hit = module.__dict__.get(name)
    if hit is not None and key is not None and hit[0] == key:
        return hit[1]
    with torch.no_grad():
        value = build()
    if key is not None and not torch.compiler.is_compiling():
        module.__dict__[name] = (key, value)
    return value


# -- attention_step ------------------------------------------------------------

def attention_step_plain(qp, lp, mp, v, memory, mask, scale=None):
    """qp [B, A]; lp/mp [B, T, A]; v [A]; memory [B, T, D]; mask [B, T] bool
    (length and window); scale: None or a 1-element energy scale.
    Returns (context [B, D], weights [B, T]), f32. bf16 qp, lp, mp and
    memory (the bf16 form) are widened to f32 first: all the math is f32."""
    qp, lp, mp, memory = qp.float(), lp.float(), mp.float(), memory.float()
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


def _attn_seg(n: int, elem: int = 4) -> int:
    """attention_step.cu's seg_bytes: bytes of a staged row segment of n
    values of ``elem`` bytes (room for a 0-12 byte shift, for bf16 2 bytes
    either side, whole 16-byte words)."""
    return (n * elem + 12 + (4 if elem == 2 else 0) + 15) // 16 * 16


def attention_step_smem(A: int, D: int, rows: int, stage_rows: int,
                        elem: int = 4) -> int:
    """Dynamic shared memory of a block (attention_step.cu's layout): q, v,
    the energies and admitted-row list of its rows, a stage's weights, the
    statistics, the partial context (all f32), and the staged rows of
    ``elem``-byte values (4: the f32 form, 2: bf16)."""
    fixed = (2 * A + 2 * rows + stage_rows + ATTN_MISC + D + 3) // 4 * 4
    return 4 * fixed + stage_rows * (2 * _attn_seg(A, elem) + _attn_seg(D, elem))


def clusters_fit(B: int, S: int, smem: int, threads: int = ATTN_THREADS) -> bool:
    """Whether B clusters of S blocks of ``threads`` threads, each using
    ``smem`` bytes of shared memory, are all resident at once (by the
    conservative GPC count)."""
    per_sm = min(2048 // threads, SM_SMEM // (smem + BLOCK_RESERVED))
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
                        stage_rows: Optional[int] = None,
                        elem: int = 4) -> AttentionPlan:
    """Split each batch row's T rows over a cluster of S blocks: by default
    the fewest (a power of two up to 16, at most T) that give B x S at least
    one block per SM, then as few as still cover T in R = ceil(T / S) rows
    a block, so none is empty. A stage holds R rows, at most
    ATTN_STAGE_ROWS; where B such clusters would not all be resident at
    once, S is halved until they are. ``cluster`` and ``stage_rows`` force
    the plan (tools/bench_attention.py); ``elem`` is the bytes of a staged
    value (2 for the bf16 form, whose rows take half the room). Raises
    where shared memory cannot hold one row."""
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
        while rows > 1 and attention_step_smem(A, D, R, rows, elem) > SMEM_MAX:
            rows -= 1
        smem = attention_step_smem(A, D, R, rows, elem)
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


def _attention_step_cuda(qp, lp, mp, v, memory, mask, scale, plan):
    B, T, A = lp.shape
    D = memory.shape[-1]
    dt, form = _form(qp)
    for name, t, shape, t_dt in (
            ("qp", qp, (B, A), dt), ("lp", lp, (B, T, A), dt),
            ("mp", mp, (B, T, A), dt), ("v", v, (A,), torch.float32),
            ("memory", memory, (B, T, D), dt)):
        _check(f"attention_step{form} {name}", t, shape, t_dt)
    _check(f"attention_step{form} mask", mask, (B, T), torch.bool)
    if scale is not None:
        _check(f"attention_step{form} scale", scale, (1,))
    ints = tuple(plan) or attention_step_plan(B, T, A, D,
                                              elem=qp.element_size()).ints()
    lib = _build.library("attention_step")
    out_ctx = torch.empty((B, D), device=qp.device, dtype=torch.float32)
    out_w = torch.empty((B, T), device=qp.device, dtype=torch.float32)
    err = getattr(lib, "attention_step" + form)(
        _ptr(qp), _ptr(lp), _ptr(mp), _ptr(v), _ptr(memory), _ptr(mask),
        _ptr(scale), B, T, A, D, *ints, _ptr(out_ctx), _ptr(out_w), _stream())
    _raise_on(err, "attention_step" + form)
    LAUNCHES["attention_step" + form] += 1
    return out_ctx, out_w


_attention_step_op = _custom_op(
    "attention_step",
    "(Tensor qp, Tensor lp, Tensor mp, Tensor v, Tensor memory, Tensor mask, "
    "Tensor? scale, int[] plan) -> (Tensor, Tensor)",
    lambda qp, lp, mp, v, memory, mask, scale, plan: tuple(
        attention_step_plain(qp, lp, mp, v, memory, mask, scale)))
_attention_step_op.register_kernel("cuda")(_attention_step_cuda)


@_attention_step_op.register_fake
def _(qp, lp, mp, v, memory, mask, scale, plan):
    return (memory.new_empty((memory.shape[0], memory.shape[2]),
                             dtype=torch.float32),
            memory.new_empty(memory.shape[:2], dtype=torch.float32))


def _attention_step_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:7])


def _attention_step_backward(ctx, grad_ctx, grad_w):
    qp, lp, mp, v, memory, mask, scale = ctx.saved_tensors
    n = ctx.needs_input_grad
    g = attention_step_vjp(qp, lp, mp, v, memory, mask, scale, grad_ctx,
                           grad_w, n[:5] + n[6:7])
    return (*g[:5], None, g[5], None)


_attention_step_op.register_autograd(_attention_step_backward,
                                     setup_context=_attention_step_setup)


def attention_step(qp, lp, mp, v, memory, mask, scale=None,
                   plan: Optional[AttentionPlan] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused location-sensitive attention step (see attention_step_plain);
    on the card one launch, split over T by ``plan`` (by default
    attention_step_plan's), reading only the rows the mask admits. bf16
    qp, lp, mp and memory take the bf16 form; ctx and weights are f32."""
    _refuse_other_devices(qp, "attention_step")
    return _attention_step_op(qp, lp, mp, v, memory, mask, scale,
                              list(plan.ints()) if plan else [])


# -- lstm_gates ----------------------------------------------------------------

def lstm_gates_plain(xh, weight, bias, c_prev):
    """xh [B, F]; weight [F, 4H] (gate blocks i, f, g, o); bias [4H];
    c_prev [B, H] f32. Returns (c_new, h_new), f32; the forget gate gets
    +1. bf16 xh, weight and bias (the bf16 form) are widened to f32 first:
    the gates are f32, not rounded to bf16."""
    xh, weight, bias = xh.float(), weight.float(), bias.float()
    i, f, g, o = (xh @ weight + bias).chunk(4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    return c, torch.sigmoid(o) * torch.tanh(c)


LSTM_COLS = 64          # columns of each gate block per block (lstm_gates.cu)
LSTM_GROUP_ROWS = 32    # batch rows per block pass (lstm_gates.cu)
LSTM_STAGE_BYTES = 16384   # bytes of W a pipeline stage holds (lstm_gates.cu)


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


def lstm_gates_plan(B: int, F: int, H: int, target_blocks: int = 264
                    ) -> LstmPlan:
    """Split F into slices so that the grid is about two blocks per SM of
    the card's 132, with at least two pipeline stages (32 rows of f32) of
    W rows per slice. The bf16 form has a plan of its own
    (lstm_gates_bf16_plan)."""
    min_rows = 2 * LSTM_STAGE_BYTES // (4 * LSTM_COLS * 4)
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


LSTM_BF16_ROWS = 64          # rows of W a stage holds (lstm_gates_bf16.cu)
LSTM_BF16_RING = 8           # stages in flight at most (lstm_gates_bf16.cu)
LSTM_BF16_CLUSTER_MAX = 8    # blocks of a cluster the plan takes at most
LSTM_BF16_THREADS = 288      # eight consumer warps and a producer warp
LSTM_BF16_ROWS_MAX = 128     # batch rows a block takes in one pass


def lstm_gates_bf16_smem(nb: int, ring: int) -> int:
    """lstm_gates_bf16.cu's smem_bytes: alignment slack, a ring of stages
    (W's 64 rows x 256 columns and xh's 64 columns of nb rows, bf16) or the
    [nb][256] f32 partial sums that reuse it, and the barriers."""
    stage = 4 * LSTM_BF16_ROWS * LSTM_COLS * 2 + nb * LSTM_BF16_ROWS * 2
    return 1024 + max(ring * stage, nb * 4 * LSTM_COLS * 4) + 2 * LSTM_BF16_RING * 8


@dataclasses.dataclass(frozen=True)
class LstmBf16Plan:
    """Launch plan of lstm_gates_bf16: grid (cluster, col_tiles, groups) in
    clusters of ``cluster`` blocks; block (r, x, z) owns columns [64 x, 64 x
    + 64) of each gate block, batch rows [8 nt z, 8 nt (z + 1)) and the
    ``runs()[r]`` run of W's ``n_stages`` 64-row stages; ``ring`` stages in
    flight; ``smem`` bytes of shared memory a block."""
    nt: int
    cluster: int
    ring: int
    n_stages: int
    grid: Tuple[int, int, int]
    smem: int

    def ints(self):
        """The plan as the C side takes it."""
        return self.nt, self.cluster, self.ring

    def runs(self):
        """(first stage, stages) of each rank: the kernel's even split."""
        S, n = self.cluster, self.n_stages
        return [(r * n // S, (r + 1) * n // S - r * n // S) for r in range(S)]


@functools.lru_cache(maxsize=None)
def lstm_gates_bf16_plan(B: int, F: int, H: int) -> LstmBf16Plan:
    """Plan of the bf16 LSTM step: the batch in passes of 16, 32, 64 or 128
    rows (the least power of two from 16 that holds B, at most 128); W in
    64-row stages split over a cluster of S blocks per 64-column tile, S
    (at most 8, at most the stages) the one that puts the most blocks to
    work (at most one per SM) with every cluster resident at once (the
    smaller S on a tie, S = 1 where none is); the ring as deep as the
    longest run, up to 8 stages and shared memory. Raises for an odd H (W's rows must start on 4-byte boundaries for TMA)."""
    if min(B, F, H) < 1:
        raise ValueError(f"lstm_gates bf16: B={B}, F={F}, H={H} must be positive")
    if H % 2:
        raise ValueError(f"lstm_gates bf16: H={H} must be even")
    nb = 16
    while nb < min(B, LSTM_BF16_ROWS_MAX):
        nb *= 2
    groups, col_tiles = -(-B // nb), -(-H // LSTM_COLS)
    n_stages = -(-F // LSTM_BF16_ROWS)
    stage = 4 * LSTM_BF16_ROWS * LSTM_COLS * 2 + nb * LSTM_BF16_ROWS * 2
    ring_cap = min(LSTM_BF16_RING, (SMEM_MAX - 1024 - 2 * LSTM_BF16_RING * 8) // stage)
    best = None
    for S in range(1, min(LSTM_BF16_CLUSTER_MAX, n_stages) + 1):
        ring = max(1, min(-(-n_stages // S), ring_cap))
        smem = lstm_gates_bf16_smem(nb, ring)
        fits = clusters_fit(col_tiles * groups, S, smem, LSTM_BF16_THREADS)
        score = (fits, min(S * col_tiles * groups, N_SM) if fits else -S, -S)
        if best is None or score > best[0]:
            best = (score, S, ring, smem)
    _, S, ring, smem = best
    return LstmBf16Plan(nb // 8, S, ring, n_stages, (S, col_tiles, groups), smem)


# TMA descriptors (CUtensorMap, 128 bytes) of the bf16 kernels' weights, by
# (kernel, device, pointer, shape and box): a map depends on nothing else,
# so one encoded for a weight serves every later call on that storage. A
# launch copies the map into its parameters (a captured graph keeps the
# copy), so the least recently used of more than _MAPS_MAX can go.
_MAPS: "collections.OrderedDict[tuple, ctypes.Array]" = collections.OrderedDict()
_MAPS_MAX = 256


def _weight_map(key: tuple, encode: Callable[[ctypes.Array], int]) -> ctypes.Array:
    m = _MAPS.get(key)
    if m is None:
        m = ctypes.create_string_buffer(128)
        _raise_on(encode(m), f"{key[0]} tensor map")
        _MAPS[key] = m
        if len(_MAPS) > _MAPS_MAX:
            _MAPS.popitem(last=False)
    else:
        _MAPS.move_to_end(key)
    return m


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where it does not start on 16 bytes (TMA's
    alignment); the caller keeps the result alive until its launch."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _lstm_gates_bf16_cuda(xh, weight, bias, c_prev):
    B, F_ = xh.shape
    H = c_prev.shape[-1]
    plan = lstm_gates_bf16_plan(B, F_, H)
    lib = _build.library("lstm_gates_bf16")
    weight = _aligned16(weight)
    w_map = _weight_map(
        ("lstm_gates_bf16", xh.device.index, weight.data_ptr(), F_, H),
        lambda m: lib.lstm_gates_bf16_weight_map(_ptr(weight), F_, H, m))
    pad = -F_ % 8                  # xh's rows must be whole 16-byte words
    if pad or xh.data_ptr() % 16:
        xh = F.pad(xh, (0, pad))
    c_new = torch.empty((B, H), device=xh.device, dtype=torch.float32)
    h_new = torch.empty_like(c_new)
    err = lib.lstm_gates_bf16(w_map, _ptr(xh), _ptr(bias), _ptr(c_prev), B,
                              F_ + pad, H, *plan.ints(), _ptr(c_new),
                              _ptr(h_new), _stream())
    _raise_on(err, "lstm_gates_bf16")
    LAUNCHES["lstm_gates_bf16"] += 1
    return c_new, h_new


def lstm_gates_vjp(xh, weight, bias, c_prev, grad_c, grad_h,
                   needs=(True,) * 4):
    """Backward of the LSTM gate step: gradients for (xh, weight, bias,
    c_prev) from those of (c_new, h_new), by autograd of lstm_gates_plain."""
    return _plain_vjp(lstm_gates_plain, (xh, weight, bias, c_prev),
                      (grad_c, grad_h), needs)


def _lstm_gates_cuda(xh, weight, bias, c_prev):
    B, F_ = xh.shape
    H = c_prev.shape[-1]
    dt, form = _form(xh)
    for name, t, shape, t_dt in (
            ("xh", xh, (B, F_), dt), ("weight", weight, (F_, 4 * H), dt),
            ("bias", bias, (4 * H,), dt),
            ("c_prev", c_prev, (B, H), torch.float32)):
        _check(f"lstm_gates{form} {name}", t, shape, t_dt)
    if dt == BF16:
        return _lstm_gates_bf16_cuda(xh, weight, bias, c_prev)
    lib = _build.library("lstm_gates")
    plan = lstm_gates_plan(B, F_, H)
    partial = torch.empty(plan.partial, device=xh.device, dtype=torch.float32)
    tickets = _tickets(xh.device, plan.tickets)
    c_new = torch.empty((B, H), device=xh.device, dtype=torch.float32)
    h_new = torch.empty_like(c_new)
    err = lib.lstm_gates(
        _ptr(xh), _ptr(weight), _ptr(bias), _ptr(c_prev), B, F_, H,
        plan.grid[0], plan.slices, plan.f_per_slice, _ptr(partial),
        _ptr(tickets), _ptr(c_new), _ptr(h_new), _stream())
    _raise_on(err, "lstm_gates")
    LAUNCHES["lstm_gates"] += 1
    return c_new, h_new


_lstm_gates_op = _custom_op(
    "lstm_gates",
    "(Tensor xh, Tensor weight, Tensor bias, Tensor c_prev) -> (Tensor, Tensor)",
    lambda xh, weight, bias, c_prev: tuple(
        lstm_gates_plain(xh, weight, bias, c_prev)))
_lstm_gates_op.register_kernel("cuda")(_lstm_gates_cuda)


@_lstm_gates_op.register_fake
def _(xh, weight, bias, c_prev):
    return c_prev.new_empty(c_prev.shape), c_prev.new_empty(c_prev.shape)


def _lstm_gates_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _lstm_gates_backward(ctx, grad_c, grad_h):
    return lstm_gates_vjp(*ctx.saved_tensors, grad_c, grad_h,
                          ctx.needs_input_grad)


_lstm_gates_op.register_autograd(_lstm_gates_backward,
                                 setup_context=_lstm_gates_setup)


def lstm_gates(xh, weight, bias, c_prev) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused LSTM gate step (see lstm_gates_plain); bf16 xh, weight and
    bias take the bf16 form (lstm_gates_bf16_plan), c_prev and the outputs
    are f32."""
    _refuse_other_devices(xh, "lstm_gates")
    return _lstm_gates_op(xh, weight, bias, c_prev)


# -- hifigan_resblock ----------------------------------------------------------

def bf16_value(c: float) -> float:
    """``c`` rounded to bf16, as a Python float: what a weak-typed constant
    becomes in the JAX package's bf16 arithmetic (``slope * x`` on a bf16
    x multiplies by bf16(slope))."""
    return float(torch.tensor(c, dtype=BF16))


def leaky_relu_bf16(x: torch.Tensor, slope: float) -> torch.Tensor:
    """JAX's leaky ReLU of a bf16 x: x, or bf16(slope) * x rounded to bf16."""
    return torch.where(x >= 0, x, x * bf16_value(slope))


def hifigan_resblock_plain(x, w1, b1, w2, b2, dilations, slope):
    """One MRF ResBlock1. x [B, C, T]; w1/w2 [P, k, C_in, C_out] (weight
    norm folded); b1/b2 [P, C] f32; dilations: P ints. Returns [B, C, T].
    With bf16 x and weights (the bf16 form) it rounds where the kernel
    does: lrelu on the bf16 input, each conv in f32 on the bias, conv1's
    lrelu rounded to bf16, conv2's sum rounded to bf16, then the residual
    sum rounded to bf16."""
    k = w1.shape[1]
    if x.dtype == BF16:
        for p, d in enumerate(dilations):
            h = F.conv1d(leaky_relu_bf16(x, slope).float(),
                         w1[p].float().permute(2, 1, 0), b1[p],
                         padding=d * (k - 1) // 2, dilation=d)
            h = F.leaky_relu(h, slope).to(BF16).float()
            h = F.conv1d(h, w2[p].float().permute(2, 1, 0), b2[p],
                         padding=(k - 1) // 2)
            x = x + h.to(BF16)
        return x
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


RESBLOCK_BF16_FUSED_C = 64      # widths at most that run a pair in one launch
RESBLOCK_BF16_RING = 32         # stages the kernel's ring holds at most
RESBLOCK_BF16_STAGE = 32768     # bytes a stage of a ring holds at most


def hifigan_resblock_launches(C: int, n_pairs: int, bf16: bool = False) -> int:
    """Kernel launches of one resblock on the card: f32, one a pair at C of
    8, 16, 32 or 64, two at every other C; bf16, one a pair where C (padded
    to a multiple of 8) is at most 64 (h on chip), two above."""
    if bf16:
        return n_pairs * (1 if -(-C // 8) * 8 <= RESBLOCK_BF16_FUSED_C else 2)
    return n_pairs * (1 if C in RESBLOCK_FUSED else 2)


def resblock_bf16_rows(N: int) -> int:
    """Rows (samples) a tile of the bf16 kernel computes: 64 a row block,
    two consumer warpgroups of 1 (N = 256), 2 (N = 128, 64) or 4 row
    blocks."""
    return 128 * (1 if N == 256 else 2 if N >= 64 else 4)


def resblock_bf16_steps(N: int) -> int:
    """The kernel's max_steps: k steps of 16 channels a stage holds at most
    (their A fragments stay in registers until its products are done): 4 at
    N = 256, 128 and 64, 2 below."""
    return 4 if N == 256 else 8 // (resblock_bf16_rows(N) // 128)


def _resblock_bf16_stage(N: int, KC: int, TG: int) -> int:
    aw = min(N, 64)
    return -(-(N // aw) * TG * KC * 2 * aw // 1024) * 1024


def hifigan_resblock_bf16_smem(N: int, fused: bool, k: int, d: int, KC: int,
                               TG: int, ring: int) -> int:
    """hifigan_resblock_bf16.cu's shared memory a block (the larger of the
    two launches when not fused): alignment slack, the ring of weight
    stages, two window buffers of KC + 8 values a row, the staging area
    (the output tile channel-major; fused, first h), the channel tile's two
    biases, the barriers."""
    rows = resblock_bf16_rows(N)

    def one(kd):
        window = -(-(rows + 7 + (k - 1) * kd) // 8) * 8 * (KC + 8)
        staging = max(N * (rows + 8),
                      -(-(rows + k - 1) // 16) * 16 * (KC + 8) if fused else 0)
        return (1024 + ring * _resblock_bf16_stage(N, KC, TG) + 2 * window * 2
                + staging * 2 + 2 * N * 4 + (2 * RESBLOCK_BF16_RING + 4) * 8)
    return one(d) if fused else max(one(d), one(1))


@dataclasses.dataclass(frozen=True)
class ResblockBf16Plan:
    """Launch plan of one dilation pair in bf16 (hifigan_resblock_bf16.cu):
    C8, the width the kernel runs (C padded to a multiple of 8); N output
    channels a tile (16 to 256, 256-wide channel tiles past that), KC input
    channels a chunk, TG taps a ring stage, ``ring`` stages; ``fused``: one
    launch with h on chip, else two through h; ``tile`` output samples a
    tile; ``stages`` the weight stages of a tile (a ring that deep keeps
    them all in place); ``smem`` bytes of shared memory a block."""
    C8: int
    N: int
    KC: int
    TG: int
    ring: int
    fused: bool
    tile: int
    stages: int
    smem: int

    def ints(self):
        """The plan as the C side takes it (after x, biases and shapes)."""
        return int(self.fused), self.N, self.KC, self.TG, self.ring


@functools.lru_cache(maxsize=None)
def hifigan_resblock_bf16_plan(B: int, C: int, T: int, k: int, d: int
                               ) -> ResblockBf16Plan:
    """Plan of one dilation pair in bf16: N the least power of two from 16
    that holds C8 (at most 256), KC = min(64, C8 rounded up to 16, 16
    resblock_bf16_steps(N)), taps a stage as many as keep a stage within 32
    KB and its products within resblock_bf16_steps; fused where C8 <= 64.
    The ring holds every stage of a tile where shared memory allows (the
    weights then stay in place across tiles), else as many stages as fit,
    at most 8. A fused tile writes its rows less the k - 1 of conv2's halo,
    a multiple of 8. Raises for an even k or what shared memory cannot hold
    (two stages and both windows)."""
    if k % 2 == 0:
        raise ValueError(f"hifigan_resblock: k={k} must be odd")
    if C <= 0 or T <= 0:
        raise ValueError(f"hifigan_resblock: C={C}, T={T} must be positive")
    C8 = -(-C // 8) * 8
    C16 = -(-C8 // 16) * 16
    N = 16
    while N < min(C16, 256):
        N *= 2
    steps = resblock_bf16_steps(N)
    KC = min(64, C16, 16 * steps)
    TG = max(1, min(k, steps // (KC // 16), RESBLOCK_BF16_STAGE // (KC * N * 2)))
    fused = C8 <= RESBLOCK_BF16_FUSED_C
    groups = -(-k // TG)
    stages = groups * (2 if fused else -(-C8 // KC))
    stage = _resblock_bf16_stage(N, KC, TG)
    fixed = hifigan_resblock_bf16_smem(N, fused, k, d, KC, TG, 0)
    ring = stages if stages <= RESBLOCK_BF16_RING and \
        fixed + stages * stage <= SMEM_MAX else min(8, (SMEM_MAX - fixed) // stage)
    rows = resblock_bf16_rows(N)
    tile = (rows - (k - 1)) // 8 * 8 if fused else rows
    if ring < 2 or tile < 8:
        raise ValueError(f"hifigan_resblock bf16: C={C} k={k} d={d} needs "
                         f"{fixed + 2 * stage} B of shared memory (max "
                         f"{SMEM_MAX}) and a tile of {tile} samples")
    return ResblockBf16Plan(C8, N, KC, TG, ring, fused, tile, stages,
                            fixed + ring * stage)


def _hifigan_resblock_bf16_cuda(x, w1, b1, w2, b2, dilations, slope):
    B, C, T = x.shape
    P, k = w1.shape[:2]
    plans = [hifigan_resblock_bf16_plan(B, C, T, k, d) for d in dilations]
    C8 = plans[0].C8
    if C8 != C:                    # zero channels: exact, and sliced off
        pad = C8 - C
        x = F.pad(x, (0, 0, 0, pad))
        w1, w2 = (F.pad(w, (0, pad, 0, pad)) for w in (w1, w2))
        b1, b2 = (F.pad(b, (0, pad)) for b in (b1, b2))
    lib = _build.library("hifigan_resblock_bf16")
    w1, w2 = _aligned16(w1), _aligned16(w2)
    maps = []
    for w in (w1, w2):
        key = ("hifigan_resblock_bf16", x.device.index, w.data_ptr(), P, k, C8,
               plans[0].N, plans[0].KC, plans[0].TG)
        maps.append(_weight_map(key, lambda m, w=w: lib.hifigan_resblock_bf16_weight_map(
            _ptr(w), P, k, C8, plans[0].N, plans[0].KC, plans[0].TG, m)))
    h = None if plans[0].fused else torch.empty_like(x)
    stream = _stream()
    for p, (d, plan) in enumerate(zip(dilations, plans)):
        y = torch.empty_like(x)
        err = lib.hifigan_resblock_pair_bf16(
            maps[0], maps[1], _ptr(x), _ptr(b1[p]), _ptr(b2[p]), B, C8, T, k,
            d, p, ctypes.c_float(slope), *plan.ints(), _ptr(h), _ptr(y), stream)
        _raise_on(err, "hifigan_resblock_bf16")
        LAUNCHES["hifigan_resblock_bf16"] += hifigan_resblock_launches(C8, 1, True)
        x = y
    return x[:, :C].contiguous() if C8 != C else x


def _hifigan_resblock_cuda(x, w1, b1, w2, b2, dilations, slope):
    B, C, T = x.shape
    P, k = w1.shape[:2]
    if len(dilations) != P:
        raise ValueError(f"hifigan_resblock: {P} weight pairs, "
                         f"{len(dilations)} dilations")
    dt, form = _form(x)
    for name, t, shape, t_dt in (
            ("x", x, (B, C, T), dt), ("w1", w1, (P, k, C, C), dt),
            ("b1", b1, (P, C), torch.float32), ("w2", w2, (P, k, C, C), dt),
            ("b2", b2, (P, C), torch.float32)):
        _check(f"hifigan_resblock{form} {name}", t, shape, t_dt)
    if dt == BF16:
        return _hifigan_resblock_bf16_cuda(x, w1, b1, w2, b2, dilations, slope)
    plans = [hifigan_resblock_plan(B, C, T, k, d) for d in dilations]
    lib = _build.library("hifigan_resblock")
    h = (torch.empty_like(x) if plans[0][3] == "split" else None)
    stream = _stream()
    for p, (d, (tile, _, smem, variant)) in enumerate(zip(dilations, plans)):
        y = torch.empty_like(x)
        err = lib.hifigan_resblock_pair(
            _ptr(x), _ptr(w1[p]), _ptr(b1[p]), _ptr(w2[p]), _ptr(b2[p]),
            B, C, T, k, d, ctypes.c_float(slope),
            0 if variant == "fused" else 1, tile, resblock_split_rows(C),
            ctypes.c_longlong(smem), _ptr(h), _ptr(y), stream)
        _raise_on(err, "hifigan_resblock")
        LAUNCHES["hifigan_resblock"] += hifigan_resblock_launches(C, 1)
        x = y
    return x


_hifigan_resblock_op = _custom_op(
    "hifigan_resblock",
    "(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2, int[] dilations, "
    "float slope) -> Tensor", hifigan_resblock_plain)
_hifigan_resblock_op.register_kernel("cuda")(_hifigan_resblock_cuda)
_hifigan_resblock_op.register_fake(
    lambda x, w1, b1, w2, b2, dilations, slope: torch.empty_like(x))
_hifigan_resblock_op.register_autograd(_no_backward)


def hifigan_resblock(x, w1, b1, w2, b2, dilations: Sequence[int],
                     slope: float) -> torch.Tensor:
    """Fused MRF resblock (see hifigan_resblock_plain); on the card one
    launch per dilation pair at C of 8, 16, 32 or 64, two at every other C
    (hifigan_resblock_plan). bf16 x and weights (f32 biases) take the bf16
    form: one launch a pair up to C = 64 (h on chip), two above
    (hifigan_resblock_bf16_plan)."""
    _refuse_other_devices(x, "hifigan_resblock")
    return _hifigan_resblock_op(x, w1, b1, w2, b2, [int(d) for d in dilations],
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
#
# Each has a bf16 form, picked by a bf16 cond_bc, which takes the dtypes
# JAX's Pallas callers pass (cookietts_tpu/models/waveglow.py:681-719 for
# WaveGlow, :905-956 for WaveFlow) and rounds where JAX's kernel bodies
# round (cookietts_tpu/ops/pallas_kernels.py:544-600, :360-456):
# - WaveGlow: x (padded as f32 by the caller) and every activation stay
#   f32; the weights and cond_bc are bf16 values, the biases f32; x is
#   rounded to bf16 as the start product's operand only. A dot of a bf16
#   and an f32 array widens the bf16 side, so this is f32 arithmetic on
#   bf16-valued weights.
# - WaveFlow: x_prev and the skip sum f32, the queues (the ring), cond_bc,
#   the weights and the start bias bf16, the rs and end biases f32; h is
#   rounded to bf16 after the start, the gate's output before the res/skip
#   product, h + bf16(res) is a bf16 sum, and the skip sum is rounded
#   before the end product. Products accumulate in f32.

F32 = torch.float32
_GLOW_NAMES = ("x", "cond_bc", "start_w", "start_b", "k_all", "rs_w", "rs_b",
               "end_w", "end_b")
_FLOW_NAMES = ("x_prev", "ring", "cond_bc", "start_w", "start_b", "k_all",
               "rs_w", "rs_b", "end_w", "end_b")
# the dtype of each input in the bf16 forms
WN_BF16_DTYPES = {
    "glow_bf16": dict(zip(_GLOW_NAMES, (F32, BF16, BF16, F32, BF16, BF16, F32,
                                        BF16, F32))),
    "flow_bf16": dict(zip(_FLOW_NAMES, (F32, BF16, BF16, BF16, BF16, BF16, BF16,
                                        F32, BF16, F32))),
}

def _wn_form(kernel: str, bf16_form: str, named) -> str:
    """The form ``named`` (name -> tensor, cond_bc among them) picks:
    ``bf16_form`` for a bf16 cond_bc, else "f32". Raises where an input's
    dtype is not the one that form takes (a mix JAX never passes)."""
    form = bf16_form if named["cond_bc"].dtype == BF16 else "f32"
    for name, t in named.items():
        want = WN_BF16_DTYPES[bf16_form][name] if form != "f32" else F32
        if t.dtype != want:
            raise ValueError(f"{kernel} ({form}): {name} must be {want}, "
                             f"got {t.dtype}")
    return form


def gtu(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return torch.tanh(a) * torch.sigmoid(g)


def _round(t: torch.Tensor, act: Optional[torch.dtype]) -> torch.Tensor:
    """t rounded to ``act`` and widened back to f32 (no-op for None)."""
    return t if act is None else t.to(act).float()


def _wn_layer(i, L, conv, cond_bc, rs_w, rs_b, gate, h, skip, act=None):
    """Layer i's gate and res/skip product on its conv; ``act`` (the
    WaveFlow bf16 form) rounds the gate's output, the residual and the
    residual sum to bf16, else everything stays f32."""
    C = rs_w.shape[1]
    acts = conv + cond_bc[:, i]
    out = _round(gate(acts[:, :C], acts[:, C:]), act)
    rs = torch.matmul(rs_w[i].t(), out) + rs_b[i][:, None]
    if i < L - 1:
        h = _round(h + _round(rs[:, :C], act), act)
    return h, (rs[:, C:] if skip is None else skip + rs[:, C:])


def waveglow_wn_forward_plain(x, cond_bc, start_w, start_b, k_all, rs_w, rs_b,
                              end_w, end_b, gate: Callable = gtu):
    """One flow's whole WN. x [B, Cin, T] -> st [B, Cout, T] f32: start 1x1,
    L layers of {kw-tap dilated conv + cond -> gate -> res/skip 1x1}, end
    1x1 on the summed skips. The bf16 form (a bf16 cond_bc; see the section
    comment): f32 arithmetic on the bf16 values, x rounded to bf16 for the
    start product."""
    form = _wn_form("waveglow_wn_forward", "glow_bf16", dict(zip(
        _GLOW_NAMES, (x, cond_bc, start_w, start_b, k_all, rs_w, rs_b, end_w,
                      end_b))))
    if form != "f32":
        x = _round(x, BF16)
        cond_bc, start_w, k_all, rs_w, end_w = (
            t.float() for t in (cond_bc, start_w, k_all, rs_w, end_w))
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
    ``win_stride`` is the padded row stride of a staged input window
    (elements), ``smem`` the shared memory bytes."""
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

    def ints(self) -> Tuple[int, ...]:
        """The plan as the C side takes it (csrc/wn_layer.cuh: wn::Plan)."""
        return (self.conv.tile, self.conv.win_stride, self.conv.smem,
                self.rs.tile, self.rs.win_stride, self.rs.smem)


def wn_launch(tile: int, B: int, C: int, T: int, kw: int) -> WnLaunch:
    """The launch of tile shape ``tile`` over B rows of T samples, C channel
    pairs, kw taps (1: the res/skip product). Where m does not divide C the
    last channel block, and where 32 does not divide C the last K step,
    stage the channels past C as zeros (csrc/wn_layer.cuh). Raises where it
    does not fit."""
    wm, wn, nj = WN_TILES[tile]
    m, n, threads = 16 * wm, 8 * wn * nj, 32 * wm * wn
    win_stride = _pad_stride(kw * n)
    smem = 4 * WN_KC * (WN_STAGES * _pad_stride(2 * m)
                        + (2 if kw >= 2 else 3) * win_stride)
    if smem > SMEM_MAX:
        raise ValueError(f"WN tile {tile}: kw={kw} needs {smem} B of shared "
                         f"memory (max {SMEM_MAX})")
    return WnLaunch(tile, m, n, threads, (-(-T // n), -(-C // m), B),
                    win_stride, smem)


def _wn_pick(B: int, C: int, T: int, kw: int) -> WnLaunch:
    """The largest block (channel pairs x samples; at equal size the fewer
    pairs) that still gives every SM a block, or half of them below
    WN_FILL_FROM samples; where none does, the tile with the most blocks.
    Only the tiles whose channel block pads C least are candidates."""
    pad = min(-(-C // (16 * wm)) * 16 * wm for wm, _, _ in WN_TILES)
    fits = [wn_launch(i, B, C, T, kw)
            for i, (wm, _, _) in enumerate(WN_TILES)
            if -(-C // (16 * wm)) * 16 * wm == pad]
    need = N_SM if B * T >= WN_FILL_FROM else N_SM // 2
    ok = [f for f in fits if f.blocks >= need] or [max(fits, key=lambda f: f.blocks)]
    return max(ok, key=lambda f: (f.m * f.n, -f.m))


def wn_layer_plan(B: int, C: int, T: int, rows: int, kw: int) -> WnPlan:
    """Launch plan of every layer of an f32 WN over B rows of T samples at C
    channels with a (rows x kw)-tap conv: the tile of each of its two
    launches, picked by the blocks it gives and the SMs they fill. Every
    width C takes it (a tile's shared memory does not depend on C). Raises
    for what the kernels do not take."""
    if kw % 2 == 0 or min(rows, B, C, T) < 1:
        raise ValueError(f"WN: B={B}, C={C}, T={T}, rows={rows}, kw={kw} "
                         "unsupported (kw odd, the rest positive)")
    return WnPlan(_wn_pick(B, C, T, kw), _wn_pick(B, C, T, 1))


# The bf16 forms' layer kernels (csrc/waveglow_wn_bf16.cu,
# csrc/waveflow_row_bf16.cu over csrc/wn_bf16.cuh): a block of a producer
# and two consumer warpgroups on wgmma. A consumer warpgroup's channel block
# is CB channels (16, 32, 64 or 128), a product of N = 2 CB columns (the a
# and g halves of the conv, res and skip of the res/skip product).
WN_BF16_RING = 8                 # stages in flight at most
WN_BF16_CB = (128, 64, 32, 16)
WN_BF16_TILE = {"glow": 64, "flow": 128}     # samples a block
WN_BF16_FLOW_C_MAX = 128         # WaveFlow: one channel block holds all C


def wn_bf16_stage(kernel: str, CB: int) -> int:
    """Bytes of a ring stage: the window, three TMA boxes from the shifted
    first sample rounded down to 16 bytes (glow: 16 input channels x 32 f32
    samples each; flow: KC = min(CB, 64) channels x 64 bf16 samples each),
    and the weights (glow: both warpgroups', 16 rows of 4 CB columns; flow:
    KC rows of 2 CB columns)."""
    if kernel == "glow":
        return 3 * 16 * 128 + 128 * CB
    KC = min(CB, 64)
    return 3 * KC * 128 + 4 * KC * CB


def wn_bf16_smem(kernel: str, CB: int, passes: int, ring: int) -> int:
    """The kernel's smem_bytes: alignment slack, the ring, glow's z (f32,
    2 x passes x CB / 2 values a thread) or flow's cond_bc tile (2 x 2 x CB
    channels x 64 samples bf16), the barriers."""
    if kernel == "glow":
        return 1024 + ring * wn_bf16_stage(kernel, CB) + 512 * passes * CB \
            + 2 * WN_BF16_RING * 8
    return 1024 + 512 * CB + ring * wn_bf16_stage(kernel, CB) \
        + (2 * WN_BF16_RING + 1) * 8


@dataclasses.dataclass(frozen=True)
class WnBf16Plan:
    """Launch plan of one bf16 WN call's layer kernel: the kernel runs C8 =
    C padded to a multiple of 8 (the caller pads the weights with zero
    channels) with rows of Tp = T' padded to a multiple of 8; warpgroup w of
    pass p owns channel block 2 p + w of CB channels; ``ring`` stages;
    ``grid`` (sample tiles, B); ``stages`` a block walks through; ``smem``
    bytes of shared memory a block."""
    kernel: str
    C8: int
    Tp: int
    CB: int
    passes: int
    ring: int
    grid: Tuple[int, int]
    stages: int
    smem: int

    def ints(self) -> Tuple[int, ...]:
        """The plan as the C side takes it."""
        if self.kernel == "glow":
            return self.CB, self.passes, self.ring
        return self.CB, self.ring


@functools.lru_cache(maxsize=None)
def wn_bf16_plan(kernel: str, B: int, C: int, T: int, rows: int = 1,
                 kw: int = 3) -> WnBf16Plan:
    """Plan of a bf16 WN call: ``kernel`` "glow" (waveglow_wn_forward_bf16,
    rows 1) or "flow" (waveflow_row_step_bf16, rows = kh). glow: the CB
    whose 2 x passes blocks cover C8 with the fewest channels (the larger
    CB on a tie), every block starting below C8 where one does; flow: the
    least CB that holds C8 (at most 128), one pass. The ring as deep as
    shared memory allows, up to 8 stages and no deeper than the stages a
    block walks through. Raises for an even kw, what is not positive, a
    WaveFlow wider than 128 channels, or what shared memory cannot hold."""
    if kw % 2 == 0 or min(B, C, T, rows, kw) < 1:
        raise ValueError(f"WN bf16: B={B}, C={C}, T={T}, rows={rows}, kw={kw} "
                         "unsupported (kw odd, the rest positive)")
    C8, Tp = -(-C // 8) * 8, -(-T // 8) * 8
    if kernel == "glow":
        def score(cb):
            p = -(-C8 // (2 * cb))
            return ((2 * p - 1) * cb < C8, -p * cb, cb)
        CB = max(WN_BF16_CB, key=score)
        passes = -(-C8 // (2 * CB))
        nk = -(-C8 // 16)
        stages = passes * nk * (kw + 1)
    elif kernel == "flow":
        if C8 > WN_BF16_FLOW_C_MAX:
            raise ValueError(f"waveflow_row_step bf16: C={C} above "
                             f"{WN_BF16_FLOW_C_MAX} channels")
        CB = min(cb for cb in WN_BF16_CB if cb >= C8)
        passes = 1
        stages = (CB // min(CB, 64)) * (rows * kw + 1)
    else:
        raise ValueError(f"WN bf16: unknown kernel {kernel!r}")
    fixed = wn_bf16_smem(kernel, CB, passes, 0)
    ring = min(WN_BF16_RING, stages, (SMEM_MAX - fixed) // wn_bf16_stage(kernel, CB))
    if ring < 2:
        raise ValueError(f"WN bf16 {kernel}: C={C} needs "
                         f"{fixed + 2 * wn_bf16_stage(kernel, CB)} B of shared "
                         f"memory (max {SMEM_MAX})")
    grid = (-(-T // WN_BF16_TILE[kernel]), B)
    return WnBf16Plan(kernel, C8, Tp, CB, passes, ring, grid, stages,
                      wn_bf16_smem(kernel, CB, passes, ring))


def wn_launches(L: int, form: str = "f32") -> int:
    """Kernel launches of one WN evaluation on the card: the start product,
    the layers (f32: two each, WnPlan's conv and res/skip; the bf16 forms
    "glow_bf16" and "flow_bf16": one each), the end product."""
    return (2 * L if form == "f32" else L) + 2


def _launch_wn(kernel: str, fn, *args) -> None:
    launches = ctypes.c_int(0)
    _raise_on(fn(*args, ctypes.byref(launches), _stream()), kernel)
    LAUNCHES[kernel] += launches.value


def _plan_ints(plan: Sequence[int], make: Callable[[], WnPlan]):
    return (ctypes.c_int * 6)(*(tuple(plan) or make().ints()))


def _suffix(form: str) -> str:
    return "" if form == "f32" else "_bf16"


def _wn_bf16_operands(weights, cond_bc, C: int, C8: int, T: int, Tp: int,
                      taps: int):
    """The bf16 kernels' operands: the weights (start_w, ..., end_b; k_all
    with ``taps`` row blocks) with C padded to C8 by zero channels, exact
    since a zero channel stays zero through every layer, and cond_bc as
    [B, L, 2 C8, Tp] (zeros past C and T'); as they are where C and T' are
    multiples of 8. Each starts on 16 bytes (TMA's alignment)."""
    start_w, start_b, k_all, rs_w, rs_b, end_w, end_b = weights
    d = C8 - C
    if d:
        L = k_all.shape[0]
        start_w, start_b = F.pad(start_w, (0, d)), F.pad(start_b, (0, d))
        k_all = F.pad(k_all.reshape(L, taps, C, 2, C),
                      (0, d, 0, 0, 0, d)).reshape(L, taps * C8, 2 * C8)
        rs_w = F.pad(rs_w.reshape(L, C, 2, C), (0, d, 0, 0, 0, d)).reshape(L, C8, 2 * C8)
        rs_b = F.pad(rs_b.reshape(L, 2, C), (0, d)).reshape(L, 2 * C8)
        end_w = F.pad(end_w, (0, 0, 0, d))
    if d or Tp != T:
        B, L = cond_bc.shape[:2]
        cond_bc = F.pad(cond_bc.reshape(B, L, 2, C, T),
                        (0, Tp - T, 0, d)).reshape(B, L, 2 * C8, Tp)
    return ([_aligned16(t) for t in (start_w, start_b, k_all, rs_w, rs_b, end_w,
                                     end_b)], _aligned16(cond_bc))


def _waveglow_wn_bf16_cuda(x, cond_bc, weights, plan):
    B, Cin, T = x.shape
    L, KC, C2 = weights[2].shape
    C, Cout = C2 // 2, weights[5].shape[1]
    kw = KC // C
    p = wn_bf16_plan("glow", B, C, T, 1, kw)
    weights, cond_bc = _wn_bf16_operands(weights, cond_bc, C, p.C8, T, p.Tp, kw)
    ints = tuple(plan) or p.ints()
    lib = _build.library("waveglow_wn_bf16")
    scratch = torch.empty((3, B, p.C8, p.Tp), device=x.device, dtype=torch.float32)
    st = torch.empty((B, Cout, T), device=x.device, dtype=torch.float32)
    _launch_wn("waveglow_wn_forward_bf16", lib.waveglow_wn_forward_bf16, _ptr(x),
               _ptr(cond_bc), *(_ptr(t) for t in weights), B, Cin, p.C8, Cout, T,
               p.Tp, L, kw, (ctypes.c_int * len(ints))(*ints), _ptr(scratch),
               _ptr(st))
    return st


def _waveglow_wn_forward_cuda(x, cond_bc, start_w, start_b, k_all, rs_w, rs_b,
                              end_w, end_b, plan):
    B, Cin, T = x.shape
    L, KC, C2 = k_all.shape
    C, Cout = C2 // 2, end_w.shape[1]
    kw = KC // C
    args = (x, cond_bc, start_w, start_b, k_all, rs_w, rs_b, end_w, end_b)
    form = _wn_form("waveglow_wn_forward", "glow_bf16", dict(zip(_GLOW_NAMES, args)))
    kernel = "waveglow_wn_forward" + _suffix(form)
    for name, t, shape in zip(_GLOW_NAMES, args, (
            (B, Cin, T), (B, L, C2, T), (Cin, C), (C,), (L, kw * C, C2),
            (L, C, C2), (L, C2), (C, Cout), (Cout,))):
        _check(f"{kernel} {name}", t, shape, t.dtype)
    if form != "f32":
        return _waveglow_wn_bf16_cuda(x, cond_bc, args[2:], plan)
    ints = _plan_ints(plan, lambda: wn_layer_plan(B, C, T, 1, kw))
    lib = _build.library("waveglow_wn")
    scratch = torch.empty((3, B, C, T), device=x.device, dtype=torch.float32)
    st = torch.empty((B, Cout, T), device=x.device, dtype=torch.float32)
    _launch_wn(kernel, lib.waveglow_wn_forward, *(_ptr(t) for t in args),
               B, Cin, C, Cout, T, L, kw, ints, _ptr(scratch), _ptr(st))
    return st


_waveglow_wn_forward_op = _custom_op(
    "waveglow_wn_forward",
    "(Tensor x, Tensor cond_bc, Tensor start_w, Tensor start_b, Tensor k_all, "
    "Tensor rs_w, Tensor rs_b, Tensor end_w, Tensor end_b, int[] plan) -> Tensor",
    lambda x, cond_bc, start_w, start_b, k_all, rs_w, rs_b, end_w, end_b, plan:
    waveglow_wn_forward_plain(x, cond_bc, start_w, start_b, k_all, rs_w, rs_b,
                              end_w, end_b))
_waveglow_wn_forward_op.register_kernel("cuda")(_waveglow_wn_forward_cuda)
_waveglow_wn_forward_op.register_fake(
    lambda x, cond_bc, start_w, start_b, k_all, rs_w, rs_b, end_w, end_b, plan:
    x.new_empty((x.shape[0], end_w.shape[1], x.shape[2]), dtype=torch.float32))
_waveglow_wn_forward_op.register_autograd(_no_backward)


def waveglow_wn_forward(x, cond_bc, start_w, start_b, k_all, rs_w, rs_b,
                        end_w, end_b,
                        plan: Optional[Union[WnPlan, WnBf16Plan]] = None
                        ) -> torch.Tensor:
    """WN of one WaveGlow flow, GTU only (see waveglow_wn_forward_plain); on
    the card two launches per layer (the conv, then res/skip, tiled by
    ``plan``, by default wn_layer_plan's) plus the start and end products,
    at every width. A bf16 cond_bc takes the bf16 form (the dtypes of
    WN_BF16_DTYPES["glow_bf16"]): one launch a layer on wgmma
    (csrc/waveglow_wn_bf16.cu; ``plan`` a WnBf16Plan, by default
    wn_bf16_plan's); st is f32 in both."""
    _refuse_other_devices(x, "waveglow_wn_forward")
    return _waveglow_wn_forward_op(x, cond_bc, start_w, start_b, k_all, rs_w,
                                   rs_b, end_w, end_b,
                                   list(plan.ints()) if plan else [])


def waveflow_row_step_plain(x_prev, queues, cond_bc, start_w, start_b, k_all,
                            rs_w, rs_b, end_w, end_b, gate: Callable = gtu):
    """One height row of the WaveFlow inverse. x_prev [B, W] (the previous
    generated row, zeros for row 0); queues [L, kh-1, B, C, W]: each layer's
    last kh-1 input rows, oldest first. Each layer convolves (kh rows x kw
    taps) over its queue plus the current row. Returns (log_s [B, W] f32,
    t [B, W] f32, new queues: oldest row dropped, current row appended, in
    the queues' dtype). The bf16 form (a bf16 cond_bc; see the section
    comment) rounds h, the gate's output, the residual sum and the skip sum
    where JAX's kernel does."""
    form = _wn_form("waveflow_row_step", "flow_bf16", dict(zip(
        _FLOW_NAMES, (x_prev, queues, cond_bc, start_w, start_b, k_all, rs_w,
                      rs_b, end_w, end_b))))
    act = None if form == "f32" else BF16
    if act is not None:
        queues, cond_bc, start_w, start_b, k_all, rs_w, end_w = (
            t.float() for t in (queues, cond_bc, start_w, start_b, k_all, rs_w,
                                end_w))
    L, khm1, _, C, _ = queues.shape
    kh, C2 = khm1 + 1, 2 * C
    kw = k_all.shape[1] // (kh * C)
    h = _round(start_w[0][None, :, None] * x_prev[:, None, :]
               + start_b[None, :, None], act)
    skip, new_queues = None, []
    for i in range(L):
        d = 2 ** i
        rows = torch.cat([queues[i], h[None]], 0)            # [kh, B, C, W]
        w = k_all[i].view(kh, kw, C, C2).permute(3, 2, 0, 1)  # [2C, C, kh, kw]
        conv = F.conv2d(rows.permute(1, 2, 0, 3), w, padding=(0, (kw // 2) * d),
                        dilation=(1, d))[:, :, 0]
        new_queues.append(rows[1:])
        h, skip = _wn_layer(i, L, conv, cond_bc, rs_w, rs_b, gate, h, skip, act)
    st = torch.matmul(end_w.t(), _round(skip, act)) + end_b[:, None]
    new_queues = torch.stack(new_queues)
    return st[:, 0], st[:, 1], (new_queues if act is None else new_queues.to(act))


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


def _waveflow_row_bf16_cuda(x_prev, ring, step, cond_bc, weights, plan):
    B, W = x_prev.shape
    L, kh, _, C, _ = ring.shape
    kw = weights[2].shape[1] // (kh * C)
    p = wn_bf16_plan("flow", B, C, W, kh, kw)
    weights, cond_bc = _wn_bf16_operands(weights, cond_bc, C, p.C8, W, p.Tp, kh * kw)
    # the kernel updates the ring in place; a ring it cannot address as it is
    # (C or W not a multiple of 8, or not on 16 bytes) runs as a padded copy
    # that is copied back
    direct = (p.C8, p.Tp) == (C, W) and ring.data_ptr() % 16 == 0
    ring_k = ring if direct else F.pad(ring, (0, p.Tp - W, 0, p.C8 - C))
    ints = tuple(plan) or p.ints()
    lib = _build.library("waveflow_row_bf16")
    scratch = torch.empty((B, p.C8, p.Tp), device=ring.device, dtype=torch.float32)
    st = torch.empty((B, 2, W), device=ring.device, dtype=torch.float32)
    _launch_wn("waveflow_row_step_bf16", lib.waveflow_row_step_bf16, _ptr(x_prev),
               _ptr(ring_k), step, _ptr(cond_bc), *(_ptr(t) for t in weights), B,
               p.C8, W, p.Tp, L, kh, kw, (ctypes.c_int * len(ints))(*ints),
               _ptr(scratch), _ptr(st))
    if not direct:
        ring.copy_(ring_k[..., :C, :W])
    return st


def _waveflow_row_step_cuda(x_prev, ring, step, cond_bc, start_w, start_b,
                            k_all, rs_w, rs_b, end_w, end_b, plan):
    B, W = x_prev.shape
    L, kh, _, C, _ = ring.shape
    C2 = 2 * C
    kw = k_all.shape[1] // (kh * C)
    args = (x_prev, ring, cond_bc, start_w, start_b, k_all, rs_w, rs_b, end_w,
            end_b)
    form = _wn_form("waveflow_row_step", "flow_bf16", dict(zip(_FLOW_NAMES, args)))
    kernel = "waveflow_row_step" + _suffix(form)
    for name, t, shape in zip(_FLOW_NAMES, args, (
            (B, W), (L, kh, B, C, W), (B, L, C2, W), (1, C), (C,),
            (L, kh * kw * C, C2), (L, C, C2), (L, C2), (C, 2), (2,))):
        _check(f"{kernel} {name}", t, shape, t.dtype)
    if form != "f32":
        return _waveflow_row_bf16_cuda(x_prev, ring, step, cond_bc, args[3:], plan)
    ints = _plan_ints(plan, lambda: wn_layer_plan(B, C, W, kh, kw))
    lib = _build.library("waveflow_row")
    scratch = torch.empty((2, B, C, W), device=ring.device, dtype=torch.float32)
    st = torch.empty((B, 2, W), device=ring.device, dtype=torch.float32)
    ptrs = [_ptr(t) for t in args]
    _launch_wn(kernel, lib.waveflow_row_step, *ptrs[:2], step, *ptrs[2:],
               B, C, W, L, kh, kw, ints, _ptr(scratch), _ptr(st))
    return st


def _waveflow_row_step_cpu(x_prev, ring, step, cond_bc, start_w, start_b,
                           k_all, rs_w, rs_b, end_w, end_b, plan):
    return torch.stack(waveflow_row_step_ring_plain(
        x_prev, ring, step, cond_bc, start_w, start_b, k_all, rs_w, rs_b,
        end_w, end_b), 1)


# The op returns st [B, 2, W] = (log_s, t), which the entry splits: an op's
# outputs may not be views of one another.
_waveflow_row_step_op = _custom_op(
    "waveflow_row_step",
    "(Tensor x_prev, Tensor(a!) ring, int step, Tensor cond_bc, "
    "Tensor start_w, Tensor start_b, Tensor k_all, Tensor rs_w, Tensor rs_b, "
    "Tensor end_w, Tensor end_b, int[] plan) -> Tensor",
    _waveflow_row_step_cpu, mutates_args=("ring",))
_waveflow_row_step_op.register_kernel("cuda")(_waveflow_row_step_cuda)
_waveflow_row_step_op.register_fake(
    lambda x_prev, ring, step, cond_bc, *weights_and_plan:
    x_prev.new_empty((x_prev.shape[0], 2, x_prev.shape[1]), dtype=torch.float32))


def waveflow_row_step(x_prev, ring, step: int, cond_bc, start_w, start_b,
                      k_all, rs_w, rs_b, end_w, end_b,
                      plan: Optional[Union[WnPlan, WnBf16Plan]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One WaveFlow inverse row step, GTU only, with the queues kept as a
    ring of kh row slots per layer, ``ring`` [L, kh, B, C, W], updated in
    place: row ``step`` of every layer's input lands in slot ``step % kh``,
    the oldest row there, and the conv reads the slots with its kernel rows
    rotated by ``step % kh``. Nothing is shifted or copied, and since a
    layer's conv only reads its own ring and its res/skip launch writes only
    the next layer's oldest slot, no block reads what another writes. Start
    with a zero ring at step 0.
    Returns (log_s [B, W], t [B, W]); ``ring_queues(ring, step + 1)`` are
    then the new queues of waveflow_row_step_plain. On the card: two
    launches per layer, tiled by ``plan`` (by default wn_layer_plan's), plus
    the start and end products, at every width. A bf16 cond_bc takes the
    bf16 form (a bf16 ring; the dtypes of WN_BF16_DTYPES["flow_bf16"]): one
    launch a layer on wgmma (csrc/waveflow_row_bf16.cu; ``plan`` a
    WnBf16Plan, by default wn_bf16_plan's; at most 128 channels); log_s and
    t are f32 in both. The op has no autograd formula (a backward
    raises), as an op that mutates an input may not."""
    _refuse_other_devices(x_prev, "waveflow_row_step")
    st = _waveflow_row_step_op(x_prev, ring, int(step), cond_bc, start_w,
                               start_b, k_all, rs_w, rs_b, end_w, end_b,
                               list(plan.ints()) if plan else [])
    return st[:, 0], st[:, 1]

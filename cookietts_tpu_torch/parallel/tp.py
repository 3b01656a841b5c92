"""Tensor parallelism (cookietts_tpu/parallel/tp.py) as explicit,
Megatron-style sharding on a torch.distributed group.

JAX assigns ``PartitionSpec``s over its mesh's ``tp`` axis to the big
matmul weights and lets GSPMD insert the collectives. Here each rank of a
tp group holds its shard of those weights (and of their Adam moments,
which are made from the sharded parameters), the model's forward computes
its part and makes the collectives itself, and the numbers are those of
one process:

- a column-parallel product (a weight sharded by output) takes a
  replicated input through :meth:`TensorParallel.copy_in` (identity
  forward, gradient all-reduced over the group: every rank's part of the
  gradient of a replicated input) and gives a sharded output, which
  :meth:`TensorParallel.gather` all-gathers (backward: the rank's slice);
- a row-parallel product (a weight sharded by input) sums its partial
  results with :meth:`TensorParallel.reduce` (all-reduce forward, identity
  backward).

So every replicated weight sees the whole gradient on every rank and the
replicas never drift; the gradients are then summed over the dp group only.

A rule is (regex over the reference ``state_dict`` name, :class:`Shard`).
``Shard(dim)`` splits axis ``dim`` into N contiguous parts.
``Shard(dim, unit)`` splits it by block: the axis is a run of blocks as wide
as the owning module's attribute ``unit`` (an LSTM cell's ``hidden_size``:
the four gate blocks i, f, g, o; a WN's ``n_channels``: the two halves of a
gated layer, and the layers of the cond projection), and rank k holds the
k-th N-th of every block, so that each unit's gates (or each gated pair,
channel j with channel j + C) stay on one rank. JAX's contiguous
``P(None, "tp")`` on the [F, 4H] gate kernel would put whole gate blocks on
different ranks; GSPMD gathers them back, a hand-sharded cell cannot.

A rule fires only where every block divides by N (``_spec_fits``, as JAX's
``tp.py:71-84``); otherwise the tensor stays replicated and its module runs
the one-process code, so the same rules serve tiny configurations.
"""
from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn


class Shard(NamedTuple):
    dim: int
    unit: Optional[str] = None


TPRule = Tuple[str, Shard]

# Tacotron2: the decoder cells' gate matrices (attention_rnn [1536+1280,
# 5120] at the reference widths) by hidden unit, and the encoder convs by
# output channel with their BatchNorms (per-channel statistics).
_CELLS = r"decoder\.(attention_rnn|decoder_rnn|second_decoder_rnn)"
TACOTRON2_TP_RULES: List[TPRule] = [
    (_CELLS + r"\.(weight_ih|weight_hh|bias_ih|bias_hh)$",
     Shard(0, "hidden_size")),
    (r"encoder\.convolutions\.\d+\.0\.conv\.(weight|bias)$", Shard(0)),
    (r"encoder\.convolutions\.\d+\.1\.(weight|bias|running_mean|running_var)$",
     Shard(0)),
]

# WaveGlow / WaveFlow: the start (by output channel), each gated layer and
# the matching layers of the cond projection by channel pair, each
# res/skip layer row-parallel over those channels (its bias is added once,
# after the sum).
_WN = r"WN\.\d+\."
WAVEGLOW_TP_RULES: List[TPRule] = [
    (_WN + r"start\.(weight|bias)$", Shard(0)),
    (_WN + r"cond_layer\.(weight|bias)$", Shard(0, "n_channels")),
    (_WN + r"in_layers\.\d+\.(weight|bias)$", Shard(0, "n_channels")),
    (_WN + r"res_skip_layers\.\d+\.weight$", Shard(1)),
]

# HiFi-GAN's generator, carried as data as JAX carries it: no trainer of
# either package shards HiFi-GAN (the transposed convs' output axis is 1).
HIFIGAN_TP_RULES: List[TPRule] = [
    (r"ups\.\d+\.weight$", Shard(1)),
    (r"(conv_pre|conv_post)\.weight$", Shard(0)),
    (r"resblocks\.\d+\.convs\d\.\d+\.weight$", Shard(0)),
]


# -- the group and its conjugate operations ------------------------------------

class TensorParallel:
    """One tp group: this rank's index in it and its size."""

    def __init__(self, group, ranks: Sequence[int]):
        self.group = group
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.rank = self.ranks.index(dist.get_rank())

    def part(self, n: int) -> slice:
        """This rank's part of an axis of ``n`` (contiguous)."""
        w = n // self.size
        return slice(self.rank * w, (self.rank + 1) * w)

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated input of a column-parallel product."""
        return _CopyIn.apply(x, self)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order."""
        return _Gather.apply(x, dim, self)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's partial ``x``."""
        return _Reduce.apply(x, self)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """A sum over the group, without gradient."""
        x = x.detach().clone()
        dist.all_reduce(x, group=self.group)
        return x

    def all_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``x``, without gradient (equal shapes)."""
        x = x.detach().contiguous()
        out = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(out, x, group=self.group)
        return out


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.tp.group)
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return torch.cat(tp.all_gather(x), dim)

    @staticmethod
    def backward(ctx, grad):
        part = ctx.tp.part(grad.shape[ctx.dim])
        return (grad.narrow(ctx.dim, part.start, part.stop - part.start)
                .contiguous(), None, None)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=tp.group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


# -- the plan: which tensor is sharded how -------------------------------------

class Placement(NamedTuple):
    dim: int
    block: int       # the width of one block of the full axis


def _owner_attr(model: nn.Module, name: str, attr: str) -> int:
    """``attr`` of the nearest module on ``name``'s path that has it."""
    parts = name.split(".")[:-1]
    for i in range(len(parts), -1, -1):
        mod = model.get_submodule(".".join(parts[:i])) if i else model
        if hasattr(mod, attr):
            return int(getattr(mod, attr))
    raise ValueError(f"no module on the path of {name} has {attr!r}")


def _spec_fits(shape: Sequence[int], dim: int, block: int, n: int) -> bool:
    """Whether every block of axis ``dim`` splits into ``n`` equal parts."""
    if dim >= len(shape) or block <= 0 or shape[dim] % block:
        return False
    return block % n == 0


def plan(model: nn.Module, rules: Sequence[TPRule], n: int
         ) -> Dict[str, Placement]:
    """{state_dict name: Placement} of the tensors the first matching rule
    shards over ``n`` ranks (the unsharded model's shapes); the rest stay
    replicated."""
    out = {}
    for name, t in model.state_dict().items():
        for pat, spec in rules:
            if not re.search(pat, name):
                continue
            if spec.dim >= t.dim():
                continue
            block = (t.shape[spec.dim] if spec.unit is None
                     else _owner_attr(model, name, spec.unit))
            if _spec_fits(t.shape, spec.dim, block, n):
                out[name] = Placement(spec.dim, block)
                break
    return out


def describe(placements: Dict[str, Placement], shapes: Dict[str, tuple],
             n: int) -> str:
    """The sharded tensors, one line each (full shape, axis, blocks)."""
    lines = [f"{k}  {tuple(shapes[k])}  -> dim {p.dim} over tp={n}"
             + (f" by blocks of {p.block}" if p.block != shapes[k][p.dim]
                else "")
             for k, p in placements.items()]
    return "\n".join(lines) or "(nothing tp-sharded)"


def shard_tensor(full: torch.Tensor, p: Placement, rank: int, n: int
                 ) -> torch.Tensor:
    """Rank ``rank``'s shard of a full tensor: the rank's N-th of every
    block of axis ``p.dim``."""
    shape = list(full.shape)
    blocks = shape[p.dim] // p.block
    w = p.block // n
    x = full.reshape(shape[:p.dim] + [blocks, p.block] + shape[p.dim + 1:])
    x = x.narrow(p.dim + 1, rank * w, w)
    return x.reshape(shape[:p.dim] + [blocks * w] + shape[p.dim + 1:]).clone()


def join_shards(shards: Sequence[torch.Tensor], p: Placement) -> torch.Tensor:
    """The full tensor from every rank's shard, in rank order."""
    n = len(shards)
    shape = list(shards[0].shape)
    w = p.block // n
    blocks = shape[p.dim] // w
    parts = [s.reshape(shape[:p.dim] + [blocks, w] + shape[p.dim + 1:])
             for s in shards]
    full = torch.cat(parts, p.dim + 1)
    return full.reshape(shape[:p.dim] + [blocks * p.block]
                        + shape[p.dim + 1:])


class Layout:
    """A model's tp layout: the group and the placements of its sharded
    tensors, by state_dict name (the trainable parameters and the Adam
    moments are keyed by the same names)."""

    def __init__(self, tp: TensorParallel, placements: Dict[str, Placement]):
        self.tp = tp
        self.placements = placements
        self.names = frozenset(placements)

    def shard(self, full: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's tree from a full one (a checkpoint's state dict or
        moments); entries the layout does not shard pass as they are."""
        return {k: (shard_tensor(v, self.placements[k], self.tp.rank,
                                 self.tp.size)
                    if k in self.placements else v) for k, v in full.items()}

    def gather(self, local: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """The full tree from every rank's (a collective: every rank of the
        group calls it with the same keys)."""
        return {k: (join_shards(self.tp.all_gather(v), self.placements[k])
                    if k in self.placements else v) for k, v in local.items()}


def shard_model(model: nn.Module, rules: Sequence[TPRule],
                tp: TensorParallel) -> Layout:
    """Cut ``model``'s tensors that ``rules`` shard down to this rank's
    shards, in place, and mark their modules with ``tp`` (the modules'
    forwards read ``module.tp``). The model keeps its layout as
    ``model.tp_layout``. Returns it."""
    cfg = getattr(model, "cfg", None)
    if getattr(cfg, "dtype", None) == torch.bfloat16:
        raise NotImplementedError(
            "tensor parallelism in bfloat16 comes with a later slice of the "
            "port (bf16 tp and sp); it runs in float32")
    placements = plan(model, rules, tp.size)
    for name, p in placements.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        t = getattr(mod, leaf)
        local = shard_tensor(t.detach(), p, tp.rank, tp.size)
        if isinstance(t, nn.Parameter):
            setattr(mod, leaf, nn.Parameter(local,
                                            requires_grad=t.requires_grad))
        else:
            mod._buffers[leaf] = local
        mod.tp = tp
    layout = Layout(tp, placements)
    model.tp_layout = layout
    return layout


def layout_of(model: nn.Module) -> Optional[Layout]:
    """A model's tp layout (None: not sharded)."""
    return getattr(model, "tp_layout", None)

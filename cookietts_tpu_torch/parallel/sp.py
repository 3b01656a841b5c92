"""Sequence parallelism (the sp axis of cookietts_tpu/parallel/mesh.py) as
explicit halo exchanges on a torch.distributed group.

JAX shards the vocoders' time axis over its mesh's ``sp`` axis and lets
GSPMD insert every convolution's halo exchange; around a Pallas call, which
it cannot partition, it gathers. Here each rank of an sp group holds a
contiguous run of the time axis (the group's ranks in order) and the models
exchange what their convolutions reach across the run's ends:

- :meth:`SequenceParallel.halo_pad` pads the time axis as ``F.pad`` does,
  with zeros at the utterance's two ends but the neighbours' columns inside
  (a training conv's "SAME" padding). It is differentiable: its backward
  sends the halos' gradients back to their owners, who add them to their
  edge columns' gradients, so each rank's parameter gradient is its share
  of one process's and a sum over the ranks gives the whole;
- :meth:`SequenceParallel.widen` widens a run by the neighbours' columns
  and nothing past the utterance's ends, so that a whole network (the WN
  kernel, the HiFi-GAN generator) runs on the widened run with its own edge
  padding where one process has it, and the rank keeps the centre;
- a halo wider than a rank's run comes from as many ranks as it spans.

Each rank sends what each other rank needs of its run and receives what it
needs of theirs (``batch_isend_irecv`` within the group). Every rank of the
group makes the same exchanges in the same order, so a training backward
that recomputes a flow (``torch.utils.checkpoint``) recomputes its
exchanges on every rank. On gloo a card's tensors go through host memory
(gloo's point-to-point takes host buffers); NCCL takes them as they are.

A :class:`SequenceParallel` is the group; ``sp.along(sizes)`` binds it to
one time axis split into the ranks' lengths (``sp.bind(n)`` gathers them
from each rank's ``n``), which gives the rank's global ``offset`` and
``length`` and the utterance's ``total``. Runs may differ in length: a training batch's mel has
one frame more than its audio has hops, which the last rank holds.
"""
from __future__ import annotations

import copy
from fractions import Fraction
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .mesh import VOCODER_TIME_AXES, draw_rows

# this process's halo exchanges since the last reset: how many (forward
# and backward), the bytes it sent, and of those the bytes sent outside
# autograd (inference); read by the smoke test's records
HALO = {"exchanges": 0, "bytes": 0, "bytes_no_grad": 0}


def reset_halo_counts() -> None:
    HALO.update(exchanges=0, bytes=0, bytes_no_grad=0)


class SequenceParallel:
    """One sp group: this rank's position in it, its size and, once bound
    to a time axis (:meth:`along`), every rank's length there."""

    def __init__(self, group, ranks: Sequence[int]):
        self.group = group
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.rank = self.ranks.index(dist.get_rank())
        self.sizes: Optional[Tuple[int, ...]] = None

    # -- the time axis ---------------------------------------------------------

    def along(self, sizes: Sequence[int]) -> "SequenceParallel":
        """This group bound to a time axis of which rank k holds
        ``sizes[k]`` steps, in rank order."""
        if len(sizes) != self.size:
            raise ValueError(f"{len(sizes)} lengths for an sp group of "
                             f"{self.size}")
        out = copy.copy(self)
        out.sizes = tuple(int(n) for n in sizes)
        return out

    def bind(self, n: int) -> "SequenceParallel":
        """Bound to the time axis of which this rank holds ``n`` steps
        (every rank's length from one small all-gather)."""
        t = torch.tensor([int(n)], dtype=torch.int64, device=self._device())
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t, group=self.group)
        return self.along([int(v) for v in out])

    def _bound(self) -> Tuple[int, ...]:
        if self.sizes is None:
            raise RuntimeError("bind the sp group to a time axis first "
                               "(SequenceParallel.along / bind)")
        return self.sizes

    @property
    def offset(self) -> int:
        """This rank's first step of the utterance."""
        return sum(self._bound()[:self.rank])

    @property
    def length(self) -> int:
        return self._bound()[self.rank]

    @property
    def total(self) -> int:
        return sum(self._bound())

    def _device(self) -> torch.device:
        if dist.get_backend(self.group) == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    # -- exchanges -------------------------------------------------------------

    def _plan(self, left: int, right: int):
        """(recv, send): [(rank, lo, hi)] global step ranges this rank
        receives of each other rank's run (in global order) and sends of
        its own, for halos of ``left`` / ``right`` steps clipped to the
        utterance."""
        sizes = self._bound()
        offs = [sum(sizes[:k]) for k in range(self.size)]
        total = sum(sizes)

        def need(k):
            o, n = offs[k], sizes[k]
            return [(max(0, o - left), o), (o + n, min(total, o + n + right))]

        def cut(ranges, k):
            o, n = offs[k], sizes[k]
            return [(max(lo, o), min(hi, o + n)) for lo, hi in ranges
                    if max(lo, o) < min(hi, o + n)]

        me = self.rank
        recv = [(k, lo, hi) for k in range(self.size) if k != me
                for lo, hi in cut(need(me), k)]
        send = [(k, lo, hi) for k in range(self.size) if k != me
                for lo, hi in cut(need(k), me)]
        return recv, send

    def _p2p(self, sends, recvs, grad: bool = True) -> None:
        """Post every send ([(rank, tensor)]) and receive into every buffer
        ([(rank, tensor)]) at once, and wait for all. ``grad``: the
        exchange belongs to a forward or backward under autograd."""
        stage = (dist.get_backend(self.group) == "gloo"
                 and any(t.is_cuda for _, t in sends + recvs))
        ops, staged = [], []
        for k, t in sends:
            buf = t.detach().contiguous()
            buf = buf.cpu() if stage else buf
            ops.append(dist.P2POp(dist.isend, buf, self.ranks[k], self.group))
            n = buf.numel() * buf.element_size()
            HALO["bytes"] += n
            HALO["bytes_no_grad"] += 0 if grad else n
        for k, t in recvs:
            buf = torch.empty(t.shape, dtype=t.dtype) if stage else t
            staged.append((t, buf))
            ops.append(dist.P2POp(dist.irecv, buf, self.ranks[k], self.group))
        if ops:
            HALO["exchanges"] += 1
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        if stage:
            for t, buf in staged:
                t.copy_(buf)

    def widen(self, x: torch.Tensor, left: int, right: int, dim: int = -1
              ) -> Tuple[torch.Tensor, int, int]:
        """(x with up to ``left`` / ``right`` of the neighbours' steps on
        either side of ``dim``, none past the utterance's ends; the steps
        added on the left; on the right). Differentiable."""
        dim = dim % x.dim()
        out = _Widen.apply(x, self, int(left), int(right), dim,
                           torch.is_grad_enabled())
        l = min(left, self.offset)
        return out, l, out.shape[dim] - x.shape[dim] - l

    def halo_pad(self, x: torch.Tensor, left: int, right: int
                 ) -> torch.Tensor:
        """``F.pad`` of ``left`` / ``right`` zeros on the last axis over the
        whole utterance, seen from this rank's run: the neighbours' steps
        where the utterance has them, zeros past its ends.
        Differentiable."""
        out, l, r = self.widen(x, left, right)
        if l == left and r == right:
            return out
        return F.pad(out, (left - l, right - r))

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The whole utterance along ``dim`` from every rank's run, on
        every rank (no gradient)."""
        dim = dim % x.dim()
        sizes = self._bound()
        width = max(sizes)
        x = x.detach()
        pad = [0, 0] * (x.dim() - 1 - dim) + [0, width - x.shape[dim]]
        buf = F.pad(x, pad).contiguous()
        stage = dist.get_backend(self.group) == "gloo" and buf.is_cuda
        src = buf.cpu() if stage else buf
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        full = torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, sizes)],
                         dim)
        return full.to(x.device) if stage else full

    def columns(self, full: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's run of a tensor that holds the whole utterance."""
        return full.narrow(dim, self.offset, self.length)

    def draw(self, draw: Callable, shape: Sequence[int], dim: int,
             **kwargs) -> torch.Tensor:
        """``draw(shape)`` (torch.randn, torch.rand) for this rank's run of
        axis ``dim``: drawn at the utterance's length (and, under a dp
        scope, at the global batch's rows: parallel/mesh.py draw_rows) and
        cut to the run, so every rank consumes its generator as one process
        does and each step gets one process's value."""
        shape = list(shape)
        if shape[dim] != self.length:
            raise ValueError(f"a draw of {shape[dim]} steps on axis {dim}; "
                             f"this rank's run holds {self.length}")
        shape[dim] = self.total
        return self.columns(draw_rows(draw, shape, **kwargs), dim)

    # -- the batch -------------------------------------------------------------

    def shard_batch(self, batch: Dict, rates: Dict[str, int]) -> Dict:
        """This rank's run of each ``rates`` entry of a batch (after the
        dp rows are taken: every rank of the group holds the same rows).
        ``rates[key]`` is how many audio samples one step of the key spans
        (1 for the audio, the hop for the mels); the audio splits into
        equal runs, each a whole number of every key's steps, and each key
        follows it; the last rank also holds a key's steps past the audio's
        end (a segment's mel has a frame more than its audio has hops)."""
        samples = {k: batch[k].shape[VOCODER_TIME_AXES[k]] * r
                   for k, r in rates.items() if k in batch}
        span = min(samples.values())
        per = span // self.size
        if span % self.size or any(per % r for r in rates.values()):
            raise ValueError(
                f"{span} samples do not split into {self.size} runs of "
                f"whole steps of {sorted(set(rates.values()))} samples")
        out = dict(batch)
        for k, r in rates.items():
            if k not in batch:
                continue
            ax, n = VOCODER_TIME_AXES[k], per // r
            start = self.rank * n
            stop = (start + n if self.rank < self.size - 1
                    else batch[k].shape[ax])
            idx = [slice(None)] * batch[k].ndim
            idx[ax] = slice(start, stop)
            out[k] = batch[k][tuple(idx)]
        return out


class _Widen(torch.autograd.Function):
    """The run widened by its neighbours' steps; the backward returns each
    halo's gradient to the rank that owns its steps."""

    @staticmethod
    def forward(ctx, x, sp, left, right, dim, grad):
        recv, send = sp._plan(left, right)
        off = sp.offset
        sends = [(k, x.narrow(dim, lo - off, hi - lo)) for k, lo, hi in send]
        bufs = []
        for k, lo, hi in recv:
            shape = list(x.shape)
            shape[dim] = hi - lo
            bufs.append((k, x.new_empty(shape)))
        sp._p2p(sends, bufs, grad)
        before = [b for (k, lo, _), (_, b) in zip(recv, bufs) if lo < off]
        after = [b for (k, lo, _), (_, b) in zip(recv, bufs) if lo >= off]
        ctx.sp, ctx.dim, ctx.plan, ctx.off = sp, dim, (recv, send), off
        ctx.n = x.shape[dim]
        return torch.cat(before + [x] + after, dim)

    @staticmethod
    def backward(ctx, grad):
        sp, dim, (recv, send), off = ctx.sp, ctx.dim, ctx.plan, ctx.off
        grad = grad.contiguous()
        left = sum(hi - lo for _, lo, hi in recv if lo < off)
        # each halo's gradient goes back to its owner
        at, sends = 0, []
        for k, lo, hi in recv:
            if lo < off:
                sends.append((k, grad.narrow(dim, at, hi - lo)))
                at += hi - lo
        at = left + ctx.n
        for k, lo, hi in recv:
            if lo >= off:
                sends.append((k, grad.narrow(dim, at, hi - lo)))
                at += hi - lo
        mine = grad.narrow(dim, left, ctx.n).clone()
        bufs = []
        for k, lo, hi in send:
            shape = list(mine.shape)
            shape[dim] = hi - lo
            bufs.append((k, mine.new_empty(shape)))
        sp._p2p(sends, bufs)
        for (k, lo, hi), (_, b) in zip(send, bufs):
            mine.narrow(dim, lo - off, hi - lo).add_(b)
        return mine, None, None, None, None, None


# -- reaches --------------------------------------------------------------------

def conv_transpose_reach(kernel: int, stride: int, cut: int
                         ) -> Tuple[Fraction, Fraction]:
    """(left, right) reach in input steps of a transposed conv whose output
    n is the full transposed conv's n + ``cut`` (output n sits at input
    position n / stride; input j feeds outputs j * stride - cut .. + kernel
    - 1)."""
    return (Fraction(kernel - 1 - cut, stride), Fraction(cut, stride))

"""cookietts_tpu/parallel/mesh.py on torch.distributed: the world as a
dp x tp x sp mesh (:func:`make_mesh`) and the data-parallel axis.

The world of W ranks is dp x tp x sp: rank r = (d tp + t) sp + s, the order
in which JAX's ``make_mesh`` reshapes the devices, so an sp group is a run
of consecutive ranks. Each (d, t) has one sp group (the ranks that hold
one batch's rows, each its run of the time axis: parallel/sp.py), each
(d, s) one tp group (the ranks that shard the weights: parallel/tp.py), and
each t one replica group: the dp x sp ranks that hold the same weights and
whose gradients are summed. Without tp and sp that group is the world.

JAX trains data-parallel by sharding the batch over a mesh's dp axis;
GSPMD then takes every reduction of the step over the global batch. Here
each rank holds its rows of the global batch (:meth:`DataParallel.
shard_batch`) and the step makes the global reductions itself:

- a loss term is this rank's contribution to the global term, so the
  global loss is the sum over ranks and the gradients are summed
  (:meth:`DataParallel.reduce_gradients`, one flat all-reduce a side). A
  masked mean contributes its numerator over the denominator summed over
  the group (:meth:`~DataParallel.masked_mean`): ranks differ in valid
  frames, and a mean of local means is another number. A plain mean over
  a shape that is equal on every rank contributes its local mean over the
  group's size (:meth:`~DataParallel.share`);
- training BatchNorm takes its statistics from sums all-reduced over the
  group, with gradient (:func:`batch_means`);
- a random draw for the batch's rows is drawn at the global batch's shape
  from a generator state every rank shares, and the rank keeps its rows
  (:func:`draw_rows`); a draw for the whole batch is the same on every
  rank. So N ranks draw what one process draws.

The step runs its forward inside :meth:`DataParallel.scope`, which the
BatchNorms and the draws read. Without a group (:data:`SINGLE`) every path
is the one-process code, unchanged.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .launch import global_batch_slice

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("dp", default=None)


class DataParallel:
    """The dp axis over every rank of the process group."""

    distributed = True

    def __init__(self, group=None, rows: Optional[Tuple[int, int]] = None):
        """The dp axis over ``group`` (the world by default): its ranks
        hold replicas of the weights and their loss terms and gradients are
        summed. ``rows`` (index, count) is this rank's place among the
        holders of distinct batch rows, by default its place in the group;
        under sp the ranks of an sp group hold the same rows."""
        if not dist.is_initialized():
            raise RuntimeError("DataParallel needs a process group; "
                               "parallel.initialize() first")
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.row_index, self.row_count = (
            (self.rank, self.size) if rows is None else rows)

    @property
    def primary(self) -> bool:
        """The world's rank 0: the one that reads the live config and
        writes."""
        return dist.get_rank() == 0

    @contextlib.contextmanager
    def scope(self):
        """BatchNorm statistics and row draws over the group inside."""
        token = _ACTIVE.set(self)
        try:
            yield self
        finally:
            _ACTIVE.reset(token)

    # -- the batch ------------------------------------------------------------

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` (the dp ranks in
        order)."""
        return global_batch_slice(n, self.row_index, self.row_count)

    def shard_batch(self, batch: Dict[str, Any],
                    replicated: Sequence[str] = ("global_mean",)
                    ) -> Dict[str, Any]:
        """This rank's rows of every entry of a global batch (arrays,
        tensors and lists along axis 0) but the ``replicated`` ones."""
        sizes = {len(v) for k, v in batch.items() if k not in replicated}
        if len(sizes) != 1:
            raise ValueError(f"batch entries disagree on the batch size: "
                             f"{sorted(sizes)}")
        rows = self.rows(sizes.pop())
        return {k: v if k in replicated else v[rows]
                for k, v in batch.items()}

    def replicate_global(self, x):
        """A global (non-batch) value, rank 0's on every rank: the
        dataset's mel mean, which one rank computes, the live config's
        values and the save trigger, which rank 0 reads."""
        box = [x]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def barrier(self) -> None:
        dist.barrier()

    # -- the loss and the gradients -------------------------------------------

    def denominator(self, den: torch.Tensor) -> torch.Tensor:
        """A masked mean's denominator summed over the group (no
        gradient: lengths and masks)."""
        den = den.detach().clone()
        dist.all_reduce(den, group=self.group)
        return den

    def masked_mean(self, num: torch.Tensor, den: torch.Tensor
                    ) -> torch.Tensor:
        """This rank's part of sum(num) / sum(den) over the group."""
        return num / self.denominator(den).clamp_min(1.0)

    def share(self, mean: torch.Tensor) -> torch.Tensor:
        """This rank's part of a plain mean over equal shapes."""
        return mean / self.size

    def batch_moments(self, sums: torch.Tensor, count: int) -> torch.Tensor:
        """Means from this rank's ``sums`` over ``count`` elements each:
        the sums all-reduced over the group with their gradient (every
        rank's backward adds into every rank's activations)."""
        return _AllReduceSum.apply(sums, self.group) / float(
            count * self.size)

    def reduce_gradients(self, grads: Dict[str, Optional[torch.Tensor]]
                         ) -> Dict[str, Optional[torch.Tensor]]:
        """Gradients summed over the group, through one flat buffer (None,
        a parameter no rank's loss reaches, stays None)."""
        names = [k for k, g in grads.items() if g is not None]
        if not names:
            return grads
        flat = torch.cat([grads[k].reshape(-1) for k in names])
        dist.all_reduce(flat, group=self.group)
        out, i = dict(grads), 0
        for k in names:
            n = grads[k].numel()
            out[k] = flat[i:i + n].view_as(grads[k])
            i += n
        return out

    def report(self, parts: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The global values of loss terms from this rank's parts (their
        sum over the group), detached; one all-reduce."""
        keys = list(parts)
        if not keys:
            return {}
        ref = next((v for v in parts.values() if torch.is_tensor(v)), None)
        dev = ref.device if ref is not None else torch.device("cpu")
        flat = torch.stack([torch.as_tensor(parts[k], dtype=torch.float32,
                                            device=dev).detach().reshape(())
                            for k in keys])
        dist.all_reduce(flat, group=self.group)
        return dict(zip(keys, flat.unbind()))


class _AllReduceSum(torch.autograd.Function):
    """A sum over the group whose backward is the sum of every rank's
    gradient (torch.distributed.nn.functional.all_reduce's rule, which
    newer torch marks deprecated)."""

    @staticmethod
    def forward(ctx, x, group=None):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


class SingleProcess(DataParallel):
    """No group: one process holds the whole batch; every operation is the
    identity and nothing is communicated."""

    distributed = False
    rank, size, group = 0, 1, None
    row_index, row_count = 0, 1

    def __init__(self):
        pass

    @contextlib.contextmanager
    def scope(self):
        yield self

    def shard_batch(self, batch, replicated=("global_mean",)):
        return batch

    def replicate_global(self, x):
        return x

    def barrier(self) -> None:
        pass

    def denominator(self, den):
        return den

    def share(self, mean):
        return mean

    @property
    def primary(self) -> bool:
        return True

    def reduce_gradients(self, grads):
        return grads

    def report(self, parts):
        return parts


SINGLE = SingleProcess()


def mesh_dp(world: int, tp: int = 1, sp: int = 1) -> int:
    """The dp size of a world of ``world`` ranks as dp x tp x sp; a world
    that tp sp does not divide refuses (JAX's message inside)."""
    if tp < 1 or sp < 1 or world % (tp * sp):
        what = f"--tp {tp}" + (f" x --sp {sp}" if sp > 1 else "")
        raise SystemExit(
            f"a world of {world} ranks is not a multiple of {what} ({world} "
            f"devices not divisible by tp*sp={tp * sp}): start N x {tp * sp} "
            f"ranks with torchrun (the mesh is dp x tp x sp)")
    return world // (tp * sp)


def make_mesh(tp: int = 1, sp: int = 1):
    """(DataParallel, TensorParallel, SequenceParallel) of the world as dp x
    tp x sp, dp = world / (tp sp) (JAX's ``make_mesh(dp=-1)``): the
    DataParallel over this rank's replica group (dp x sp ranks) with its dp
    index for the rows, the TensorParallel over its tp group or None at
    ``tp`` 1, the SequenceParallel over its sp group or None at ``sp`` 1.
    Every rank calls it: each group is made by all. A world that tp sp does
    not divide refuses."""
    from .sp import SequenceParallel
    from .tp import TensorParallel
    world, rank = dist.get_world_size(), dist.get_rank()
    dp = mesh_dp(world, tp, sp)
    if tp == 1 and sp == 1:
        return DataParallel(), None, None
    at = lambda d, t, s: (d * tp + t) * sp + s  # noqa: E731
    mine = {}
    groups = {"sp": [[at(d, t, s) for s in range(sp)]
                     for d in range(dp) for t in range(tp)],
              "tp": [[at(d, t, s) for t in range(tp)]
                     for d in range(dp) for s in range(sp)],
              "replica": [[at(d, t, s) for d in range(dp) for s in range(sp)]
                          for t in range(tp)]}
    for axis, lists in groups.items():
        if axis != "replica" and len(lists[0]) == 1:
            continue
        for ranks in lists:
            g = dist.new_group(ranks)
            if rank in ranks:
                mine[axis] = (g, ranks)
    replica = DataParallel(mine["replica"][0], rows=(rank // (tp * sp), dp))
    return (replica, TensorParallel(*mine["tp"]) if tp > 1 else None,
            SequenceParallel(*mine["sp"]) if sp > 1 else None)


# batch keys whose axis 1 is the time axis (audio samples, mel frames): the
# axis the vocoder flows treat pointwise given their conditioning
VOCODER_TIME_AXES: Dict[str, int] = {"audio": 1, "mels": 1}


def data_parallel(dp: Optional[DataParallel]) -> DataParallel:
    """``dp``, or :data:`SINGLE` for None."""
    return SINGLE if dp is None else dp


def draw_rows(draw: Callable, shape: Sequence[int], **kwargs) -> torch.Tensor:
    """``draw(shape, **kwargs)`` (torch.rand, torch.randn) for a tensor whose
    axis 0 is the batch: under a group's scope, this rank's rows of the draw
    at the global batch's shape, so every rank consumes the generator as
    one process does and each row gets one process's values."""
    dp = _ACTIVE.get()
    shape = tuple(shape)
    if dp is None or not shape:
        return draw(shape, **kwargs)
    n = shape[0]
    full = draw((n * dp.row_count,) + shape[1:], **kwargs)
    return full[dp.row_index * n:(dp.row_index + 1) * n]


def batch_means(*xs: torch.Tensor, dims: Sequence[int]):
    """``x.mean(dims)`` of each of ``xs`` (one shape), over the global
    batch under a group's scope: the sums all-reduced together, with
    gradient."""
    dp = _ACTIVE.get()
    if dp is None:
        return tuple(x.mean(dims) for x in xs)
    sums = torch.stack([x.sum(dims) for x in xs])
    count = xs[0].numel() // sums[0].numel()
    return tuple(dp.batch_moments(sums, count).unbind())


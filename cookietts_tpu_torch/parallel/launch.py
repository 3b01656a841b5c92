"""Process-group launch (cookietts_tpu/parallel/launch.py) on
torch.distributed.

One process per card. On one host:

    torchrun --nproc_per_node N -m cookietts_tpu_torch train ...

and across hosts the same command on each with ``--nnodes``,
``--node_rank`` and ``--master_addr`` / ``--master_port``. torchrun sets
RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT; :func:`initialize`
reads them, joins the group and pins the rank to ``cuda:LOCAL_RANK``. Without
them it does nothing and returns False: one process, as before.

The backend is NCCL on the card and gloo on the CPU; ``backend="gloo"`` on
the card lets several ranks share one card (NCCL refuses two ranks on one
GPU). Nothing switches backend after a failure.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def launched() -> bool:
    """Whether torchrun's environment is there."""
    return all(k in os.environ for k in ENV)


def initialize(device: str | torch.device = "cuda",
               backend: str | None = None,
               timeout: Optional[float] = None) -> bool:
    """Join the process group torchrun describes, on ``device``'s type:
    ``backend`` (default NCCL on "cuda", gloo on "cpu"). On the card the
    rank is pinned to ``cuda:LOCAL_RANK`` (ranks past the card count share
    cards, which only gloo allows). ``timeout`` (seconds; torch's default
    when None) bounds the rendezvous and every collective. Returns False
    without a torchrun environment, True once the group exists (again on a
    second call)."""
    if dist.is_initialized():
        return True
    if not launched():
        return False
    kind = torch.device(device).type
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if kind == "cpu" and backend != "gloo":
        raise SystemExit(f"--dist_backend {backend} needs the card; the CPU "
                         "trains with gloo")
    if kind == "cuda":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("CUDA is not available; pass --device cpu "
                               "to train on the CPU")
        local = int(os.environ["LOCAL_RANK"])
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", local + 1))
        if backend == "nccl" and per_host > n:
            raise SystemExit(
                f"{per_host} ranks on this host share {n} card(s), which "
                "NCCL refuses; pass --dist_backend gloo, or start one rank "
                "per card")
        torch.cuda.set_device(local % n)
    dist.init_process_group(
        backend, rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=None if timeout is None else datetime.timedelta(seconds=timeout))
    return True


def rank_device(device: str | torch.device) -> torch.device:
    """The device this rank computes on: its pinned card under a group on
    "cuda", else ``device`` itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def shutdown() -> None:
    """Leave the group (the end of a torchrun process)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def global_batch_slice(global_batch: int, index: int | None = None,
                       count: int | None = None) -> slice:
    """The half-open row range of the global batch this rank feeds (ranks
    in order; ``index`` of ``count`` ranks, by default this process of the
    world). A batch that does not divide by the ranks raises: every row
    belongs to exactly one rank."""
    n = process_count() if count is None else count
    if global_batch % n != 0:
        raise ValueError(
            f"global batch {global_batch} is not divisible by the "
            f"{n} processes — every row must belong to exactly one rank")
    per = global_batch // n
    i = process_index() if index is None else index
    return slice(i * per, (i + 1) * per)


def allgather_object(obj):
    """Every rank's copy of a picklable object, as a list indexed by rank
    (``[obj]`` in one process)."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out

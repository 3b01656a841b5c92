"""Gloo ranks of a test module, started as subprocesses of the pytest process.

A module that checks a distributed path starts itself ``world`` times with
torchrun's environment (``Ranks(script, out, world)``), computes its
one-process runs meanwhile, and then waits for the ranks (``wait``).

- The rendezvous store lives in this process: a ``TCPStore`` bound to a port
  the OS picks and held until the launch ends, so no other process (another
  test worker's launch, a gloo connection's ephemeral port) can take the
  port between its choice and the ranks' connection. The ranks join it as
  clients, as under torchrun's agent store (``TORCHELASTIC_USE_AGENT_STORE``).
- A rank that exits with an error ends the launch at once: the others are
  killed, not left waiting in a collective for a peer that is gone.
- The launch waits at most ``RANK_TIMEOUT`` seconds, about three times what
  the slowest module's ranks take (45-70 s with the three modules at once on
  six cores); ranks pass the same timeout to ``init_process_group``.
"""
from __future__ import annotations

import datetime
import os
import subprocess
import sys
import time

import torch.distributed as dist

RANK_TIMEOUT = 240.0
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Ranks:
    def __init__(self, script: str, out: str, world: int):
        self.out = out
        self.store = dist.TCPStore(
            "127.0.0.1", 0, world, is_master=True, wait_for_workers=False,
            timeout=datetime.timedelta(seconds=RANK_TIMEOUT))
        self.procs = []
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(self.store.port),
                       TORCHELASTIC_USE_AGENT_STORE="True",
                       TORCHELASTIC_RESTART_COUNT="0",
                       GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
                       PYTHONPATH=os.pathsep.join(
                           [ROOT, os.environ.get("PYTHONPATH", "")]))
            log = open(self.log_path(rank), "w")
            self.procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(script), out], env=env,
                stdout=log, stderr=subprocess.STDOUT, cwd=out), log))

    def log_path(self, rank: int) -> str:
        return os.path.join(self.out, f"rank{rank}.log")

    def wait(self) -> None:
        """Wait for every rank, at most RANK_TIMEOUT seconds from now; stop
        at the first rank that fails. Raises, with the failed rank's log,
        unless all exited with 0."""
        deadline = time.monotonic() + RANK_TIMEOUT
        try:
            while True:
                codes = [p.poll() for p, _ in self.procs]
                if all(c == 0 for c in codes) or any(c for c in codes):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks still running after "
                                       f"{RANK_TIMEOUT:.0f} s")
                time.sleep(0.2)
        finally:
            self.close()
        codes = [p.returncode for p, _ in self.procs]
        failed = ([r for r, c in enumerate(codes) if c > 0]
                  or [r for r, c in enumerate(codes) if c])
        if failed:
            text = open(self.log_path(failed[0])).read()
            raise AssertionError(f"rank {failed[0]} failed (exit codes "
                                 f"{codes}):\n{text[-4000:]}")

    def close(self) -> None:
        """Kill what still runs, close the logs and let the port go."""
        for p, log in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        self.store = None

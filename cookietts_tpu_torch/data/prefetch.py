"""Background batch prefetching.

The reference hides dataset CPU work behind the accelerator with
torch DataLoader worker processes (num_workers=4,
_2_ttm/tacotron2_tm/train.py:160-166). The equivalent here is a
thread pool that materializes the next batches while the device executes
the current step — audio decode / mel extraction release the GIL inside
numpy/scipy, so threads (no pickling, shared caches) are the right
tool on a single host.

Usage::

    loader = Prefetcher(make_batch_fn, schedule_iter, depth=2)
    for batch in loader:          # batches arrive in schedule order
        state, metrics = train_step(state, batch, ...)
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator


class Prefetcher:
    """Run ``make_batch(item)`` for each schedule item in background
    threads, yielding results IN ORDER with at most ``depth`` batches
    in flight. Exceptions re-raise at the point of iteration."""

    def __init__(self, make_batch: Callable[[Any], Any],
                 schedule: Iterable[Any], depth: int = 2,
                 workers: int = 2):
        self.make_batch = make_batch
        self.schedule = list(schedule)
        self.depth = max(1, depth)
        self.workers = max(1, min(workers, self.depth))

    def __len__(self) -> int:
        return len(self.schedule)

    def __iter__(self) -> Iterator[Any]:
        if not self.schedule:
            return
        done: "queue.Queue[tuple[int, Any, BaseException | None]]" = \
            queue.Queue()
        tickets: "queue.Queue[int]" = queue.Queue()
        for i in range(len(self.schedule)):
            tickets.put(i)
        in_flight = threading.Semaphore(self.depth)
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                # acquire BEFORE taking a ticket: permits must go to the
                # lowest outstanding indices, otherwise a worker holding
                # ticket w can starve behind peers that grabbed both
                # permits for w+1/w+2, deadlocking the in-order consumer
                in_flight.acquire()
                if stop.is_set():
                    return
                try:
                    i = tickets.get_nowait()
                except queue.Empty:
                    in_flight.release()
                    return
                try:
                    done.put((i, self.make_batch(self.schedule[i]), None))
                except BaseException as e:       # surfaced to the consumer
                    done.put((i, None, e))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.workers)]
        for t in threads:
            t.start()
        try:
            buffered: dict[int, tuple[Any, BaseException | None]] = {}
            for want in range(len(self.schedule)):
                while want not in buffered:
                    i, batch, err = done.get()
                    buffered[i] = (batch, err)
                batch, err = buffered.pop(want)
                in_flight.release()
                if err is not None:
                    raise err
                yield batch
        finally:
            stop.set()
            # unblock any worker waiting on the in-flight semaphore
            for _ in threads:
                in_flight.release()
            for t in threads:
                t.join(timeout=5.0)

"""The closed loop of one client with ``IN_FLIGHT`` batches in flight.

A step dispatches the next batch (``Detector.raw_result`` on the next frames
of the pool, then a non-blocking copy of its five result fields into a pinned
host slot and an event), and, once ``IN_FLIGHT`` batches are out, waits for
the oldest one's event: its results are then on the host.  A batch's time
runs from the start of its ``raw_result`` call to the moment the host sees
its event; its enqueue time from that start to the call's return.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, NamedTuple

import torch

IN_FLIGHT = 2


class Done(NamedTuple):
    """One completed batch, host clock (``time.perf_counter``) seconds."""

    index: int
    pool: int       # which batch of the frame pool it served
    start: float    # raw_result called
    enqueued: float  # raw_result returned
    done: float     # results seen on the host


class _HostEvent:
    """A completed event, for a CPU run (every copy is synchronous there)."""

    def synchronize(self) -> None:
        return None


class ClosedLoop:
    def __init__(self, call: Callable, frames: torch.Tensor,
                 on_done: "Callable[[Done, tuple], None] | None" = None) -> None:
        self.call = call
        self.frames = frames
        self.depth = IN_FLIGHT
        self.on_done = on_done
        self.cuda = frames.device.type == "cuda"
        self.slots: "list[tuple | None]" = [None] * self.depth
        self.flying: collections.deque = collections.deque()
        self.next = 0
        self.done: list[Done] = []

    def _slot(self, res) -> tuple:
        i = self.next % self.depth
        if self.slots[i] is None:
            self.slots[i] = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=self.cuda)
                                  for t in res)
        return self.slots[i]

    def dispatch(self) -> None:
        pool = self.next % self.frames.shape[0]
        with torch.profiler.record_function("bench.dispatch"):
            start = time.perf_counter()
            res = self.call(self.frames[pool])
            enqueued = time.perf_counter()
            slot = self._slot(res)
            for dst, src in zip(slot, res):
                dst.copy_(src, non_blocking=self.cuda)
            if self.cuda:
                event = torch.cuda.Event()
                event.record()
            else:
                event = _HostEvent()
        self.flying.append((self.next, pool, start, enqueued, res, slot, event))
        self.next += 1

    def complete(self) -> Done:
        index, pool, start, enqueued, res, slot, event = self.flying.popleft()
        with torch.profiler.record_function("bench.wait"):
            event.synchronize()
        d = Done(index, pool, start, enqueued, time.perf_counter())
        del res  # the device result may be freed now that the copy is done
        self.done.append(d)
        if self.on_done is not None:
            self.on_done(d, slot)
        return d

    def step(self) -> "Done | None":
        """Dispatch one batch; complete the oldest once ``IN_FLIGHT`` are out."""
        self.dispatch()
        return self.complete() if len(self.flying) >= self.depth else None

    def drain(self) -> None:
        while self.flying:
            self.complete()

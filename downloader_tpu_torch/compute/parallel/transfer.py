"""Double-buffered host↔device transfer queue + per-hop billing.

Held from ``downloader_tpu.compute.parallel.transfer`` (that package's
``__init__`` imports JAX, so the port keeps its own); the port's
``HopSink`` names its layer and ``timed_hop`` also marks the profiler's
timeline, which the reference's does not.

The upscale step is three hops, not one: ``h2d`` (stage the planes onto
the card), ``compute`` (the model step itself), ``d2h`` (gather display
planes back).  Serializing them idles the device while the host copies.
``TransferQueue`` keeps ``depth`` batches in flight: while batch N
computes, batch N+1's h2d is already enqueued and batch N-1's d2h drains
through a non-blocking copy into pinned memory started at dispatch time.

Billing: each hop is timed at the point the host actually blocks, so
the numbers are honest on an async-dispatch backend —

- ``h2d``: wall time of the staging call (pinned copy + non-blocking
  upload).  This stays near-zero until the transfer queue backs up; a
  regression that turns staging synchronous balloons exactly this hop.
- ``compute``: wall time of the wait on the batch's completion event.
- ``d2h``: wall time of the host gather after the result is ready
  (mostly prefetched by the async copy — that's the point).

The engine and the trainer bill more hops of their host threads the
same way (``compute/pipeline.py``, ``compute/trainer.py``).

``HopSink`` carries the billing target as thread-local state so a
worker thread deep inside ``engine.upscale_to`` can bill the current
job's HopLedger without threading a parameter through the decoder
stack.  ``timed_hop`` is the one host span of the port's compute plane:
while a torch profiler records, the block is the range
``host.<layer>.<hop>`` on the profiler's clock, beside the device's
operations; while a target is bound, the block's wall time is noted;
with neither, it reads no clock and opens no range.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Callable, Iterator, Optional

import torch

Sink = Callable[[str, int, float], None]


class HopSink:
    """Thread-local hop billing target of one layer (``"engine"``,
    ``"trainer"``).

    ``bound(note_hop)`` installs a sink for the current thread;
    ``note`` forwards to it (or drops the sample when unbound, so the
    engine works identically outside a job context — benches, tests,
    direct calls).
    """

    def __init__(self, layer: str) -> None:
        self.layer = layer
        self._local = threading.local()

    @contextlib.contextmanager
    def bound(self, note_hop: Sink):
        prev = getattr(self._local, "sink", None)
        self._local.sink = note_hop
        try:
            yield
        finally:
            self._local.sink = prev

    def is_bound(self) -> bool:
        """Whether a sink is bound on this thread."""
        return getattr(self._local, "sink", None) is not None

    def note(self, hop: str, nbytes: int, seconds: float) -> None:
        sink = getattr(self._local, "sink", None)
        if sink is not None:
            sink(hop, nbytes, seconds)


class Billed:
    """The bytes a :func:`timed_hop` block bills; a block that learns its
    bytes only as it runs (a read, a synchronous compute) sets them."""

    __slots__ = ("nbytes",)

    def __init__(self, nbytes: int) -> None:
        self.nbytes = nbytes


@contextlib.contextmanager
def timed_hop(sink: Optional[HopSink], hop: str, nbytes: int = 0):
    """Bill ``hop`` with the wall time of the enclosed block, and mark the
    block on the profiler's timeline as ``host.<layer>.<hop>``.  Yields
    the :class:`Billed` bytes."""
    billed = Billed(nbytes)
    note = getattr(sink._local, "sink", None) if sink is not None else None
    # the profiler's own flag: record_function costs ~10 us even with no
    # profiler running, this check a tenth of a microsecond
    profiling = sink is not None and torch.autograd._profiler_enabled()
    if note is None and not profiling:
        yield billed
        return
    t0 = time.monotonic()
    with (torch.profiler.record_function(f"host.{sink.layer}.{hop}")
          if profiling else contextlib.nullcontext()):
        try:
            yield billed
        finally:
            if note is not None:
                note(hop, billed.nbytes, time.monotonic() - t0)


def timed_next(sink: Optional[HopSink], hop: str, items: Iterator):
    """``next(items, None)`` billed as ``hop`` with the bytes of the tuple
    of arrays it returns; the call that finds the end is billed too, with
    no bytes (it may wait on a source that is closing)."""
    with timed_hop(sink, hop) as billed:
        item = next(items, None)
        if item is not None:
            billed.nbytes = sum(a.nbytes for a in item)
    return item


class TransferQueue:
    """Bounded in-flight queue of dispatched device batches.

    ``dispatch(*args)`` must enqueue device work and return a handle;
    ``fetch(handle)`` must block until that work is done and return the
    host-side result.  ``submit`` dispatches, then drains until fewer
    than ``depth`` handles remain in flight — so ``depth=1`` is the
    drain-after-every-dispatch serial bound (the overlap probe's lower
    reference) and ``depth >= 2`` is the classic double buffer: the
    host stages batch N+1 while the device runs batch N.  ``drain``
    flushes the tail.
    """

    def __init__(self, dispatch: Callable, fetch: Callable, *,
                 depth: int = 2) -> None:
        if depth < 1:
            raise ValueError(f"transfer queue depth must be >= 1: {depth}")
        self._dispatch = dispatch
        self._fetch = fetch
        self.depth = depth
        self._inflight: deque = deque()
        self.submitted = 0
        self.drained = 0

    def __len__(self) -> int:
        return len(self._inflight)

    def submit(self, *args) -> Iterator:
        """Enqueue one batch; yield any results that had to drain to
        keep fewer than ``depth`` batches in flight."""
        self._inflight.append(self._dispatch(*args))
        self.submitted += 1
        while len(self._inflight) >= self.depth:
            yield self._pop()

    def drain(self) -> Iterator:
        """Yield remaining results in submission order."""
        while self._inflight:
            yield self._pop()

    def _pop(self):
        out = self._fetch(self._inflight.popleft())
        self.drained += 1
        return out

"""Download stall detection.

The reference arms two timers around a torrent download: a 240 s metadata
timeout (upstream lib/download.js:21,47-50) and a 240 s no-progress
watchdog that rejects with ``err.code = 'ERRDLSTALL'``
(lib/download.js:90-101).  The orchestrator treats that code as permanent —
ack and drop the job (lib/main.js:144-146).

Here the watchdog is a reusable primitive any transfer can feed.
"""

from __future__ import annotations

import asyncio
from typing import Optional

# Parity constant (reference lib/download.js:21).
STALL_TIMEOUT_SECONDS = 240.0


class DownloadStalledError(Exception):
    """A transfer made no progress for a full watchdog window.

    Carries ``code == 'ERRDLSTALL'`` like the reference error object so the
    orchestrator's drop-vs-retry policy can key on it."""

    code = "ERRDLSTALL"

    def __init__(self, message: str = "Download stalled."):
        super().__init__(message)


class MetadataTimeoutError(Exception):
    """Metadata (or first byte) never arrived within the window
    (reference 'Metadata fetch stalled', lib/download.js:49)."""


class StallWatchdog:
    """Monitors a monotonically-increasing progress value.

    Call :meth:`feed` with the latest progress; :meth:`watch` wraps a
    coroutine and raises :class:`DownloadStalledError` if progress is flat
    across a full ``timeout`` window — same check the reference does by
    comparing ``progress === lastProgress`` every 240 s
    (lib/download.js:92-100).
    """

    def __init__(self, timeout: float = STALL_TIMEOUT_SECONDS,
                 on_feed=None):
        self.timeout = timeout
        # optional per-feed tap: every transfer loop already feeds the
        # watchdog its cumulative byte count, which makes this the one
        # cheap place to mirror live progress into the job's
        # control-plane record (flight-recorder throughput sampling)
        # without touching each chunk loop
        self._on_feed = on_feed
        self._progress: Optional[float] = None

    def feed(self, progress: float) -> None:
        self._progress = progress
        if self._on_feed is not None:
            self._on_feed(progress)

    async def watch(self, coro):
        task = asyncio.ensure_future(coro)
        try:
            last: Optional[float] = None
            while True:
                done, _pending = await asyncio.wait({task}, timeout=self.timeout)
                if done:
                    return task.result()
                if self._progress == last:
                    raise DownloadStalledError()
                last = self._progress
        finally:
            if not task.done():
                task.cancel()
                try:
                    await task
                except (asyncio.CancelledError, Exception):
                    pass
            else:
                # unwinding abnormally (external cancel) with the inner
                # task already settled: retrieve its exception so a
                # simultaneous inner error (e.g. a cooperative
                # JobCancelled racing the cancel) isn't logged as a
                # never-retrieved task exception
                try:
                    task.exception()
                except (asyncio.CancelledError, Exception):
                    pass

"""Cooperative job cancellation.

The reference service has exactly one intervention for a job in flight:
kill the whole worker (upstream lib/main.js:197-204).  The control
plane replaces that with a :class:`CancelToken` carried in every job's
``StageContext`` and checked cooperatively at the natural yield points —
HTTP chunk loops, the torrent client's drive loop between piece batches,
the upload stage's per-file loop — plus :meth:`CancelToken.guard`, which
bounds any long await (admission wait, scheduler queue, a whole stage
dispatch) by the token without requiring the awaited code to poll.

Cancellation is an *operator decision about this delivery*: the
orchestrator settles a cancelled job with ``ack`` (no requeue), removes
its partial staging files, and records the terminal ``CANCELLED`` state
in the registry.  A cancelled singleflight leader rejects its flight, so
coalesced same-content waiters fail over to their own fetch instead of
dying with it (store/cache.py's retry loop).
"""

from __future__ import annotations

import asyncio
from typing import Any, Awaitable, Optional


class JobCancelled(Exception):
    """Raised inside a job's pipeline when its token was cancelled.

    Deliberately NOT an ``asyncio.CancelledError``: it must be
    distinguishable from task teardown (shutdown cancels handlers too)
    and must traverse the orchestrator's generic stage-error handling
    without being retried — the orchestrator catches it and settles the
    delivery with ``ack``.
    """

    code = "ERRCANCELLED"

    def __init__(self, job_id: str = "", reason: str = ""):
        self.job_id = job_id
        self.reason = reason
        detail = f" ({reason})" if reason else ""
        super().__init__(f"job {job_id or '?'} cancelled{detail}")


class CancelToken:
    """One job's cancellation flag; fire-once, observed cooperatively."""

    __slots__ = ("job_id", "reason", "_event")

    def __init__(self, job_id: str = ""):
        self.job_id = job_id
        self.reason: Optional[str] = None
        self._event = asyncio.Event()

    def __repr__(self) -> str:  # registry/API debugging
        state = f"cancelled={self.reason!r}" if self.cancelled else "live"
        return f"CancelToken({self.job_id!r}, {state})"

    @property
    def cancelled(self) -> bool:
        return self._event.is_set()

    def cancel(self, reason: str = "cancelled") -> bool:
        """Fire the token; False when it was already fired."""
        if self._event.is_set():
            return False
        self.reason = reason
        self._event.set()
        return True

    def raise_if_cancelled(self) -> None:
        """The cooperative check stages call inside their chunk loops."""
        if self._event.is_set():
            raise JobCancelled(self.job_id, self.reason or "")

    async def wait(self) -> None:
        await self._event.wait()

    async def guard(self, awaitable: Awaitable[Any]) -> Any:
        """Await ``awaitable``, aborting with :class:`JobCancelled` the
        moment this token fires first.

        The inner work is cancelled (``asyncio`` task cancellation) and
        *joined* before the error is raised, so its cleanup paths — fd
        teardown, thread-pool drains — finish before the orchestrator
        starts removing the job's files.
        """
        task = asyncio.ensure_future(awaitable)
        if self.cancelled:
            await self._reap(task)
            raise JobCancelled(self.job_id, self.reason or "")
        watcher = asyncio.ensure_future(self._event.wait())
        try:
            done, _pending = await asyncio.wait(
                {task, watcher}, return_when=asyncio.FIRST_COMPLETED
            )
        except asyncio.CancelledError:
            # the caller itself is being torn down (e.g. shutdown):
            # propagate, but never orphan the inner task
            await self._reap(task)
            raise
        finally:
            watcher.cancel()
        if task in done:
            return task.result()  # raises the task's own error, if any
        await self._reap(task)
        raise JobCancelled(self.job_id, self.reason or "")

    @staticmethod
    async def _reap(task: "asyncio.Future") -> None:
        task.cancel()
        try:
            await task
        except (asyncio.CancelledError, Exception):
            pass

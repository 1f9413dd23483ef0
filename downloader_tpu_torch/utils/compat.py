"""Runtime compatibility backports.

The codebase targets Python 3.11+ (``asyncio.timeout`` is used at ~60
call sites across the orchestrator, broker, and torrent stack), but
deployment images sometimes pin 3.10.  Rather than fork every call
site, :func:`install` backports the missing pieces onto the stdlib
module once, at package import (``downloader_tpu_torch/__init__.py``) — a
no-op on 3.11+.

The backported ``timeout`` implements the contract the repo relies on:
a cancellation raised BY the timeout surfaces as builtin
``TimeoutError`` at the ``async with`` exit; an external cancellation
passes through untouched.  The 3.11 ``Task.uncancel`` bookkeeping has
no 3.10 equivalent, so a timeout firing in the same tick as an external
cancel resolves in the timeout's favor — acceptable for the drain/join
loops and test deadlines this repo uses it for.
"""

from __future__ import annotations

import asyncio


class _Timeout:
    __slots__ = ("_delay", "_task", "_handle", "_expired")

    def __init__(self, delay):
        self._delay = delay
        self._task = None
        self._handle = None
        self._expired = False

    async def __aenter__(self):
        self._task = asyncio.current_task()
        if self._delay is not None:
            loop = asyncio.get_running_loop()
            self._handle = loop.call_later(self._delay, self._fire)
        return self

    def _fire(self) -> None:
        self._expired = True
        if self._task is not None:
            self._task.cancel()

    async def __aexit__(self, exc_type, exc, tb):
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None
        if self._expired and exc_type is asyncio.CancelledError:
            raise TimeoutError from exc
        return False


def _timeout(delay):
    """3.10 backport of :func:`asyncio.timeout` (see module docstring)."""
    return _Timeout(delay)


def install() -> None:
    """Install the backports onto :mod:`asyncio`; no-op when present."""
    if not hasattr(asyncio, "timeout"):
        asyncio.timeout = _timeout

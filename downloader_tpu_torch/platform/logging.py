"""Structured JSON logging with child loggers.

Capability-equivalent to the reference's pino usage: per-file logger names
(upstream index.js:12-14) and per-job child loggers carrying
``{jobId, fileId}`` bindings (upstream lib/main.js:75-79,103-105).

Log lines are single-line JSON on stderr: ``{"level":..., "time":...,
"name":..., "msg":..., **bindings}`` — the same shape pino emits, so existing
log tooling keyed on that shape keeps working.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, IO, Optional

_LEVELS = {"debug": 20, "info": 30, "warn": 40, "error": 50, "fatal": 60}
_lock = threading.Lock()


def _min_level() -> int:
    return _LEVELS.get(os.environ.get("LOG_LEVEL", "info").lower(), 30)


class Logger:
    """A pino-style structured logger.

    ``child(**bindings)`` returns a logger whose every line carries the
    merged bindings — used by the orchestrator to tag all stage logs with
    the job/file ids.
    """

    def __init__(
        self,
        name: str,
        bindings: Optional[dict] = None,
        stream: Optional[IO[str]] = None,
    ):
        self.name = name
        self.bindings = dict(bindings or {})
        self._stream = stream

    def child(self, **bindings: Any) -> "Logger":
        merged = dict(self.bindings)
        merged.update(bindings)
        name = bindings.pop("name", None) or self.name
        merged.pop("name", None)
        return Logger(name, merged, self._stream)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<{type(self).__name__} {self.name} {self.bindings}>"

    def _emit(self, level: str, msg: str, extra: dict) -> None:
        if _LEVELS[level] < _min_level():
            return
        record = {
            "level": _LEVELS[level],
            "time": int(time.time() * 1000),
            "name": self.name,
            **self.bindings,
            **extra,
            "msg": msg,
        }
        stream = self._stream or sys.stderr
        line = json.dumps(record, default=str)
        with _lock:
            stream.write(line + "\n")

    def debug(self, msg: str, **extra: Any) -> None:
        self._emit("debug", msg, extra)

    def info(self, msg: str, **extra: Any) -> None:
        self._emit("info", msg, extra)

    def warn(self, msg: str, **extra: Any) -> None:
        self._emit("warn", msg, extra)

    # alias so call sites can use stdlib-style naming
    warning = warn

    def error(self, msg: str, **extra: Any) -> None:
        self._emit("error", msg, extra)

    def fatal(self, msg: str, **extra: Any) -> None:
        self._emit("fatal", msg, extra)


def get_logger(name: str, **bindings: Any) -> Logger:
    """Create a named logger (reference: ``pino({name: basename(__filename)})``)."""
    return Logger(name, bindings)


class NullLogger(Logger):
    """A logger that drops everything — the reference tests' ``mockLogger``
    (upstream test/process/filter_dirs.js:10-14)."""

    def __init__(self) -> None:
        super().__init__("null")

    def child(self, **bindings: Any) -> "Logger":
        return self

    def _emit(self, level: str, msg: str, extra: dict) -> None:
        pass

"""Small shared utilities."""

import datetime

from .events import EventEmitter

__all__ = ["EventEmitter", "utcnow_iso"]


def utcnow_iso() -> str:
    """Millisecond UTC timestamp with a ``Z`` suffix — the one format
    used for ``Convert.created_at`` wire timestamps and control-plane
    job records (a single definition so they can never diverge)."""
    return (
        datetime.datetime.now(datetime.timezone.utc)
        .isoformat(timespec="milliseconds")
        .replace("+00:00", "Z")
    )

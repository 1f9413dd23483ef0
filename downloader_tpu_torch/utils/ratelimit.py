"""Async token-bucket rate limiting.

Beyond-reference production knob: the reference downloads at whatever the
NIC allows (webtorrent/request have no caps wired up,
upstream lib/download.js), which on a shared media host starves
co-tenant services.  One bucket is shared across all of a service's
transfers, so the cap is per-process, not per-job.
"""

from __future__ import annotations

import asyncio
import time
from typing import Optional


class TokenBucket:
    """Classic token bucket: sustained ``rate`` bytes/s, bursts up to
    ``burst`` bytes (default: one second's worth).

    ``consume(n)`` deducts immediately and sleeps off any deficit, which
    paces the *average* rate without chunk-size-dependent stalls: a 1 MiB
    chunk against a 64 KiB/s cap sleeps ~16 s once instead of deadlocking
    on an undersized bucket.
    """

    def __init__(self, rate: float, burst: Optional[float] = None):
        if rate <= 0:
            raise ValueError(f"rate must be positive, got {rate}")
        self.rate = float(rate)
        self.capacity = float(burst if burst is not None else rate)
        self.tokens = self.capacity
        self.updated = time.monotonic()
        self._lock = asyncio.Lock()

    async def consume(self, n: int) -> None:
        if n <= 0:
            return
        async with self._lock:
            now = time.monotonic()
            self.tokens = min(
                self.capacity, self.tokens + (now - self.updated) * self.rate
            )
            self.updated = now
            self.tokens -= n
            deficit = -self.tokens
        if deficit > 0:
            await asyncio.sleep(deficit / self.rate)


class ChainedLimiter:
    """Serial composition of token buckets: a transfer must clear EVERY
    bucket in the chain, so the effective rate is the minimum of the
    chained caps.  Used to stack a per-tenant byte quota
    (control/tenancy.py) on top of the per-service limiter without the
    stages knowing which (if either) is configured.
    """

    def __init__(self, *buckets: Optional[TokenBucket]):
        self.buckets = [b for b in buckets if b is not None]

    async def consume(self, n: int) -> None:
        for bucket in self.buckets:
            await bucket.consume(n)


def chain_limiters(*buckets) -> Optional[object]:
    """Compose limiters, eliding absent ones: None when nothing is
    configured, the single bucket when only one is, else a chain."""
    live = [b for b in buckets if b is not None]
    if not live:
        return None
    if len(live) == 1:
        return live[0]
    return ChainedLimiter(*live)


def bucket_from_config(config, key: str) -> Optional[TokenBucket]:
    """Build a bucket from ``config.instance.<key>`` (bytes/s; absent,
    empty, or 0 disables limiting).

    A malformed or negative value raises instead of silently running
    uncapped — an operator who set a cap must not get unlimited ingress
    because of a typo like ``"128k"``.
    """
    from ..platform.config import cfg_get

    raw = cfg_get(config, f"instance.{key}", None)
    if raw in (None, "", 0):
        return None
    try:
        rate = float(raw)
    except (TypeError, ValueError):
        raise ValueError(
            f"config instance.{key}={raw!r} is not a number of bytes/s"
        ) from None
    if rate < 0:
        raise ValueError(f"config instance.{key}={raw!r} must be >= 0")
    if rate == 0:
        return None
    return TokenBucket(rate)


def shared_bucket(resources: dict, config, key: str) -> Optional[TokenBucket]:
    """Per-SERVICE bucket memoized in the cross-job ``resources`` dict.

    Stage factories run once per job, so a bucket built inline there
    would be per-job — N concurrent jobs would each get the full rate,
    multiplying the configured cap by the concurrency.  Memoizing under
    the orchestrator's shared ``stage_resources`` makes the cap genuinely
    per instance (standalone stage use, with a fresh resources dict per
    context, degrades to per-context — the same scope as before).
    """
    cache_key = f"rate_limiter:{key}"
    if cache_key not in resources:
        resources[cache_key] = bucket_from_config(config, key)
    return resources[cache_key]

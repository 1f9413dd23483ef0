"""Saturation-aware overload control: shed BULK work before thrashing.

The dependency breakers shed when *someone else* is down; nothing
shed when *this worker* is drowning — a saturated worker kept accepting
BULK backlog until the disk-headroom gate or the poison guard started
killing healthy jobs.  :class:`OverloadController` closes that gap: it
samples the autoscale signal trio (``Orchestrator.autoscale_signals()``:
queue depth, oldest-queued age, cache disk headroom) plus the event-loop
lag the :class:`~..platform.obs.LoopLagMonitor` already measures, and
declares the worker *saturated* once any configured threshold has been
breached for ``overload.sustain`` consecutive samples (a single GC pause
or burst must not flip the switch).

While saturated, the orchestrator sheds **BULK** deliveries at admission
with the park-then-nack discipline — the delivery is parked briefly
(``overload.shed_backoff``) and nacked back to the broker, *never*
FAILED permanently and never charged against the poison budget, so the
work simply waits out the pressure (or lands on a less-loaded fleet
peer).  HIGH and NORMAL traffic keeps flowing: shedding exists to
protect it.  Sheds are attributed on
``jobs_shed_total{reason,tenant}``.

All thresholds default to *off* except event-loop lag (a worker whose
loop is seconds behind cannot serve anyone), so an unconfigured
deployment only sheds in a state where it previously thrashed:

    overload:
      enabled: true            # false removes the controller entirely
      interval: 1.0            # sampling cadence, seconds
      sustain: 3               # consecutive breached samples => saturated
      max_loop_lag: 1.5        # seconds; 0 disables the lag trigger
      min_headroom_bytes: 0    # shed when cache/download disk headroom
                               # falls below this (0 = disabled)
      max_queue_depth: 0       # shed when more jobs than this are queued
      max_oldest_seconds: 0    # shed when the oldest queued job is older
      shed_backoff: 5.0        # park before the shed nack, seconds
"""

from __future__ import annotations

import asyncio
import time
from typing import Callable, List, Optional

from ..platform.config import cfg_get

DEFAULT_INTERVAL = 1.0
DEFAULT_SUSTAIN = 3
DEFAULT_MAX_LOOP_LAG = 1.5
DEFAULT_SHED_BACKOFF = 5.0


class OverloadController:
    """Sampled saturation detector + BULK shed policy (module docstring)."""

    def __init__(
        self,
        signals_fn: Callable[[], dict],
        lag_fn: Callable[[], Optional[float]],
        *,
        interval: float = DEFAULT_INTERVAL,
        sustain: int = DEFAULT_SUSTAIN,
        max_loop_lag: float = DEFAULT_MAX_LOOP_LAG,
        min_headroom_bytes: int = 0,
        max_queue_depth: int = 0,
        max_oldest_seconds: float = 0.0,
        shed_backoff: float = DEFAULT_SHED_BACKOFF,
        metrics=None,
        logger=None,
    ):
        if interval <= 0:
            raise ValueError(f"overload.interval must be > 0, got {interval}")
        if sustain < 1:
            raise ValueError(f"overload.sustain must be >= 1, got {sustain}")
        self.signals_fn = signals_fn
        self.lag_fn = lag_fn
        self.interval = float(interval)
        self.sustain = int(sustain)
        self.max_loop_lag = float(max_loop_lag)
        self.min_headroom_bytes = int(min_headroom_bytes)
        self.max_queue_depth = int(max_queue_depth)
        self.max_oldest_seconds = float(max_oldest_seconds)
        self.shed_backoff = float(shed_backoff)
        self.metrics = metrics
        self.logger = logger
        self.saturated = False
        self.reasons: List[str] = []
        self.saturated_since: Optional[float] = None
        self._streak = 0
        self._task: Optional[asyncio.Task] = None
        self._last_signals: dict = {}

    # -- config ---------------------------------------------------------
    @classmethod
    def from_config(cls, config, signals_fn, lag_fn, *, metrics=None,
                    logger=None) -> Optional["OverloadController"]:
        """Build from ``overload.*``; None when explicitly disabled."""
        if not bool(cfg_get(config, "overload.enabled", True)):
            return None
        return cls(
            signals_fn, lag_fn,
            interval=float(cfg_get(config, "overload.interval",
                                   DEFAULT_INTERVAL)),
            sustain=int(cfg_get(config, "overload.sustain",
                                DEFAULT_SUSTAIN)),
            max_loop_lag=float(cfg_get(config, "overload.max_loop_lag",
                                       DEFAULT_MAX_LOOP_LAG)),
            min_headroom_bytes=int(cfg_get(
                config, "overload.min_headroom_bytes", 0)),
            max_queue_depth=int(cfg_get(
                config, "overload.max_queue_depth", 0)),
            max_oldest_seconds=float(cfg_get(
                config, "overload.max_oldest_seconds", 0.0)),
            shed_backoff=float(cfg_get(config, "overload.shed_backoff",
                                       DEFAULT_SHED_BACKOFF)),
            metrics=metrics, logger=logger,
        )

    # -- sampling -------------------------------------------------------
    def sample(self) -> bool:
        """Take one pressure sample; returns the (possibly new)
        saturated verdict.  Exposed for tests and for callers that want
        an on-demand reading between timer ticks."""
        reasons: List[str] = []
        try:
            signals = dict(self.signals_fn())
        except Exception as err:  # a broken probe must not kill the loop
            if self.logger is not None:
                self.logger.warn("overload signal probe failed",
                                 error=str(err)[:200])
            signals = {}
        lag = None
        try:
            lag = self.lag_fn()
        except Exception:
            pass
        signals["loop_lag_seconds"] = lag
        self._last_signals = signals
        if self.max_loop_lag > 0 and lag is not None \
                and lag >= self.max_loop_lag:
            reasons.append("loop_lag")
        headroom = signals.get("cache_headroom_bytes")
        if self.min_headroom_bytes > 0 and headroom is not None \
                and headroom < self.min_headroom_bytes:
            reasons.append("disk_headroom")
        depth = signals.get("queue_depth")
        if self.max_queue_depth > 0 and depth is not None \
                and depth > self.max_queue_depth:
            reasons.append("queue_depth")
        oldest = signals.get("oldest_queued_seconds")
        if self.max_oldest_seconds > 0 and oldest is not None \
                and oldest > self.max_oldest_seconds:
            reasons.append("queue_age")
        self._streak = self._streak + 1 if reasons else 0
        was = self.saturated
        self.saturated = self._streak >= self.sustain
        if self.saturated:
            self.reasons = reasons
            if not was:
                self.saturated_since = time.monotonic()
                if self.logger is not None:
                    self.logger.warn(
                        "worker saturated: shedding BULK work",
                        reasons=reasons, signals=signals,
                    )
        else:
            self.reasons = []
            if was:
                self.saturated_since = None
                if self.logger is not None:
                    self.logger.info("worker pressure cleared, "
                                     "BULK intake restored")
        if self.metrics is not None:
            self.metrics.overload_saturated.set(1.0 if self.saturated
                                                else 0.0)
        return self.saturated

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.interval)
            self.sample()

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(
                self._loop(), name="overload-controller"
            )

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    # -- policy ---------------------------------------------------------
    def should_shed(self, priority: str) -> Optional[str]:
        """The shed reason when this delivery should be bounced, else
        None.  Only BULK is sheddable — the controller exists to protect
        HIGH/NORMAL time-to-staged, not to ration it."""
        if not self.saturated or priority != "BULK":
            return None
        return self.reasons[0] if self.reasons else "saturated"

    # -- introspection --------------------------------------------------
    def snapshot(self) -> dict:
        """JSON state for ``GET /v1/tenants`` and ``/readyz``."""
        return {
            "saturated": self.saturated,
            "reasons": list(self.reasons),
            "saturatedForSeconds": (
                round(time.monotonic() - self.saturated_since, 3)
                if self.saturated_since is not None else None
            ),
            "signals": dict(self._last_signals),
            "thresholds": {
                "maxLoopLag": self.max_loop_lag or None,
                "minHeadroomBytes": self.min_headroom_bytes or None,
                "maxQueueDepth": self.max_queue_depth or None,
                "maxOldestSeconds": self.max_oldest_seconds or None,
            },
            "sustain": self.sustain,
            "interval": self.interval,
        }

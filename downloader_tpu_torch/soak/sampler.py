"""Growth sampling for soak runs: /metrics, /readyz, RSS, journal,
coordination store, shared cache tier.

One :class:`GrowthSampler` task scrapes every live worker each
``profile.sample_interval`` and appends one :class:`Sample` to its
series.  The series is the input to the bounded-growth SLO guards
(:mod:`~.slo`): journal bytes over time, coordination-document census,
shared-tier footprint, and per-generation RSS — sampled from the
*outside* (the /proc filesystem and the durable store), so a worker
dying mid-run costs a gap in its series, never the series itself.
"""

from __future__ import annotations

import os
import resource
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import aiohttp

# /metrics families the sampler keeps (matched by suffix: the service
# namespace prefix varies with the configured service name)
SCRAPE_SUFFIXES = (
    "journal_bytes",
    "journal_lines",
    "fleet_coord_docs_total",
    "recorder_ring_evictions_total",
    "jobs_shed_total",
    "overload_saturated",
    # degraded-profile observables: when did the slow-call policy open
    # the breaker (brownout_shed_ms), with what attribution, and how
    # many stale cross-worker writes did the fence reject
    "breaker_state",
    "breaker_opened_total",
    "dependency_slow_total",
    "fleet_fenced_writes_total",
    "jobs_parked_total",
)

_PAGE_SIZE = resource.getpagesize()


def parse_prometheus(text: str, suffixes=SCRAPE_SUFFIXES) -> Dict[str, float]:
    """Exposition-format lines -> ``{family{labels}: value}`` for the
    families whose (namespace-stripped) name ends with a suffix."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name_part, _, value = line.rpartition(" ")
        family = name_part.split("{", 1)[0]
        if not any(family.endswith(suffix) for suffix in suffixes):
            continue
        try:
            out[name_part] = float(value)
        except ValueError:
            continue
    return out


def rss_bytes(pid: int) -> int:
    """Resident set size of ``pid`` via /proc (0 when unreadable —
    non-Linux hosts or a pid that died between listing and reading)."""
    try:
        with open(f"/proc/{pid}/statm", "r", encoding="ascii") as fh:
            fields = fh.read().split()
        return int(fields[1]) * _PAGE_SIZE
    except (OSError, IndexError, ValueError):
        return 0


def journal_size(path: str) -> int:
    try:
        return os.path.getsize(path)
    except OSError:
        return 0


@dataclass
class Sample:
    """One sampling pass across the whole rig."""

    t_mono: float
    #: jobs resolved (staged or terminal) when the sample was taken —
    #: the x-axis of the RSS-slope fit
    done_jobs: int = 0
    #: worker index -> journal file bytes (direct stat of the file the
    #: scraped ``journal_bytes`` gauge also reads)
    journal_bytes: Dict[int, int] = field(default_factory=dict)
    #: (worker index, generation) -> RSS bytes
    rss_bytes: Dict[tuple, int] = field(default_factory=dict)
    #: coordination-store census by prefix (workers/leases/telemetry),
    #: counted from the durable store (tombstones included: disk
    #: reality, not liveness)
    coord_docs: Dict[str, int] = field(default_factory=dict)
    #: `.fleet-cache/` shared-tier footprint
    shared_cache_bytes: int = 0
    #: worker index -> scraped metric subset (empty when the scrape
    #: failed; failures are tallied on the sampler)
    scraped: Dict[int, Dict[str, float]] = field(default_factory=dict)
    #: worker index -> /readyz HTTP status (0 = unreachable)
    ready_status: Dict[int, int] = field(default_factory=dict)

    def metric(self, index: int, suffix: str,
               labels: str = "") -> Optional[float]:
        """The scraped value whose name ends with ``suffix`` (plus a
        label-selector substring when given)."""
        for name, value in (self.scraped.get(index) or {}).items():
            family = name.split("{", 1)[0]
            if not family.endswith(suffix):
                continue
            if labels and labels not in name:
                continue
            return value
        return None


class GrowthSampler:
    """Periodic sampler over a :class:`~.rig.SoakRig`.

    The rig is duck-typed: it exposes ``live_workers()`` (index,
    generation, pid, health port, journal path), ``resolved_jobs()``,
    and ``store_census()`` (coord docs by prefix + shared-tier bytes).
    """

    def __init__(self, rig, interval: float = 0.5):
        self.rig = rig
        self.interval = max(float(interval), 0.05)
        self.samples: List[Sample] = []
        self.scrape_failures = 0
        self._session: Optional[aiohttp.ClientSession] = None

    async def __aenter__(self) -> "GrowthSampler":
        self._session = aiohttp.ClientSession(
            timeout=aiohttp.ClientTimeout(total=3.0))
        return self

    async def __aexit__(self, *_exc) -> None:
        if self._session is not None:
            await self._session.close()
            self._session = None

    async def run(self, stop_event) -> None:
        """Sample until ``stop_event`` is set (one final pass after)."""
        import asyncio

        while not stop_event.is_set():
            await self.sample_once()
            try:
                await asyncio.wait_for(stop_event.wait(), self.interval)
            except asyncio.TimeoutError:
                continue
        await self.sample_once()

    async def sample_once(self) -> Sample:
        sample = Sample(t_mono=time.monotonic(),
                        done_jobs=self.rig.resolved_jobs())
        for worker in self.rig.live_workers():
            sample.journal_bytes[worker.index] = journal_size(
                worker.journal_path)
            rss = rss_bytes(worker.pid)
            if rss:
                sample.rss_bytes[(worker.index, worker.generation)] = rss
            await self._scrape(worker, sample)
        try:
            docs, shared = await self.rig.store_census()
            sample.coord_docs = docs
            sample.shared_cache_bytes = shared
        except Exception:
            # the store census shares the staging store with the
            # workload: a transient listing failure is a gap, not a
            # soak failure (the guards read peaks over many samples)
            if self.samples:
                sample.coord_docs = dict(self.samples[-1].coord_docs)
                sample.shared_cache_bytes = \
                    self.samples[-1].shared_cache_bytes
        self.samples.append(sample)
        return sample

    async def _scrape(self, worker, sample: Sample) -> None:
        base = f"http://127.0.0.1:{worker.health_port}"
        try:
            async with self._session.get(base + "/metrics") as resp:
                text = await resp.text()
            sample.scraped[worker.index] = parse_prometheus(text)
            async with self._session.get(base + "/readyz") as resp:
                await resp.read()
                sample.ready_status[worker.index] = resp.status
        except (aiohttp.ClientError, OSError, RuntimeError):
            # a worker killed between listing and scraping (tallied and
            # judged against the kill count by the SLO layer) — or the
            # session already closed during an exception unwind, which
            # must not mask the original error
            sample.ready_status[worker.index] = 0
            self.scrape_failures += 1

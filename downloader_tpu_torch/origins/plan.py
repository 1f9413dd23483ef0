"""Origin identity + cross-job origin health (EWMA throughput).

An *origin* is one URL serving the entity (the primary
``Media.source_uri`` or a ``Download.mirrors`` entry).  Everything the
fleet keys on an origin — metrics labels, breaker/retry dependency
names, the health table — uses :func:`origin_label`, which is the URL's
host[:port] **bounded** to ``origins.max_labels`` distinct values per
process (overflow collapses to ``"other"``): origin names arrive in job
payloads, and unbounded label cardinality would let submitters mint
Prometheus series and breaker instances at will — the same posture the
tenant table takes with unconfigured tenant names.
"""

from __future__ import annotations

import time
import urllib.parse
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..platform.config import cfg_get

DEFAULT_MAX_LABELS = 16
# EWMA smoothing for per-origin throughput samples: high enough to react
# within a few ranges, low enough that one cold TCP slow-start sample
# doesn't erase an origin's history
EWMA_ALPHA = 0.3
OVERFLOW_LABEL = "other"


def origin_label(url: str) -> str:
    """The unbounded raw label for one origin URL: host[:port], with
    dots flattened to dashes — the label rides inside dotted dependency
    seams (``origin:<label>.fetch``) and dotted config paths
    (``breakers.origin:<label>.threshold``), where a literal dot would
    split the host and silently collapse distinct origins onto one
    breaker."""
    try:
        parsed = urllib.parse.urlsplit(url)
        host = (parsed.hostname or "").replace(".", "-")
        if parsed.port:
            return f"{host}:{parsed.port}"
        return host or OVERFLOW_LABEL
    except ValueError:
        return OVERFLOW_LABEL


@dataclass
class Origin:
    """One member of a job's origin set."""

    url: str
    label: str
    primary: bool = False
    # per-JOB liveness: a dead origin is skipped for the rest of the job
    # (its breaker + health table remember it across jobs)
    dead: bool = False
    failures: int = field(default=0, compare=False)


class OriginHealth:
    """Cross-job per-origin throughput EWMA + the bounded label table.

    Fed from the racing fetch's per-chunk progress hook — the same
    observation points that bill the hop ledger — so ``bps(label)`` is
    the observed landing rate, not a request-level guess.  Shared across
    jobs via ``ctx.resources`` (one instance per service), like the
    content cache and the retrier.
    """

    def __init__(self, max_labels: int = DEFAULT_MAX_LABELS):
        self.max_labels = max(int(max_labels), 1)
        # label -> [ewma_bps, total_bytes, last_feed_mono]
        self._table: Dict[str, list] = {}
        self._labels: set = set()

    @classmethod
    def shared(cls, resources: dict, config=None) -> "OriginHealth":
        health = resources.get("origin_health")
        if health is None:
            health = cls(max_labels=int(cfg_get(
                config, "origins.max_labels", DEFAULT_MAX_LABELS
            )))
            resources["origin_health"] = health
        return health

    def label(self, url: str) -> str:
        """Bounded label for ``url`` (stable for the process lifetime)."""
        raw = origin_label(url)
        if raw in self._labels:
            return raw
        if len(self._labels) >= self.max_labels:
            return OVERFLOW_LABEL
        self._labels.add(raw)
        return raw

    def feed(self, label: str, nbytes: int, seconds: float) -> None:
        """One throughput sample: ``nbytes`` landed over ``seconds``."""
        if seconds <= 0 or nbytes < 0:
            return
        rate = nbytes / seconds
        entry = self._table.get(label)
        if entry is None:
            self._table[label] = [rate, nbytes, time.monotonic()]
            return
        entry[0] += EWMA_ALPHA * (rate - entry[0])
        entry[1] += nbytes
        entry[2] = time.monotonic()

    def bps(self, label: str) -> float:
        """EWMA landing rate for ``label`` (0.0 = never observed)."""
        entry = self._table.get(label)
        return entry[0] if entry is not None else 0.0

    def total_bytes(self, label: str) -> int:
        entry = self._table.get(label)
        return int(entry[1]) if entry is not None else 0

    def snapshot(self) -> Dict[str, dict]:
        """label -> {bps, bytes} for logs/debug surfaces."""
        return {
            label: {"bps": round(entry[0], 1), "bytes": int(entry[1])}
            for label, entry in sorted(self._table.items())
        }

    def seed(self, rows: Dict[str, dict]) -> int:
        """Import fleet-shared rows (fleet/plane.py origin-health table)
        for labels this process has NOT yet observed itself — a peer's
        EWMA is a cold-start head start, never an override of local
        evidence.  ``bytes`` stays 0: total_bytes accounts bytes THIS
        worker moved.  Returns the number of labels seeded."""
        seeded = 0
        for label, row in rows.items():
            if not isinstance(label, str) or label in self._table:
                continue
            if (label not in self._labels
                    and len(self._labels) >= self.max_labels):
                continue  # the bounded label table stays bounded
            try:
                bps = float(row.get("bps", 0.0) or 0.0)
            except (TypeError, ValueError, AttributeError):
                continue
            if bps <= 0:
                continue
            self._table[label] = [bps, 0, time.monotonic()]
            self._labels.add(label)
            seeded += 1
        return seeded


def resolve_mirrors(primary_url: str, mirrors,
                    schemes=("http", "https")) -> List[str]:
    """The usable mirror URLs for one job: scheme-filtered, de-duplicated
    against the primary and each other, order preserved (submitters list
    their preferred mirrors first)."""
    seen = {primary_url}
    out: List[str] = []
    for url in mirrors or ():
        if not isinstance(url, str) or url in seen:
            continue
        try:
            scheme = urllib.parse.urlsplit(url).scheme.lower()
        except ValueError:
            continue
        if scheme not in schemes:
            continue
        seen.add(url)
        out.append(url)
    return out


def build_origin_set(primary_url: str, mirrors,
                     health: Optional[OriginHealth] = None) -> List[Origin]:
    """Primary + usable mirrors as :class:`Origin` records (primary
    always first; labels bounded through ``health`` when given)."""
    labeler = health.label if health is not None else origin_label
    origins = [Origin(url=primary_url, label=labeler(primary_url),
                      primary=True)]
    for url in resolve_mirrors(primary_url, mirrors):
        origins.append(Origin(url=url, label=labeler(url)))
    return origins

"""Origin plane: multi-origin racing fetch + segment-manifest ingest.

Turns "one job = one origin" into "one job = a set of interchangeable
origins plus an optional live manifest" (ROADMAP item 4):

- :mod:`plan` — origin identity: URL -> bounded metric/breaker label,
  and the cross-job :class:`~.plan.OriginHealth` EWMA throughput table
  the scheduler's assignment and straggler decisions read.
- :mod:`racing` — :class:`~.racing.RangeScheduler`: work-stealing byte
  ranges across origins, per-origin Retrier/CircuitBreaker seams
  (``origin:<label>``), straggler-tail duplication (first-byte-wins,
  loser cancelled), and failover that never fails the job while any
  origin lives; plus :class:`~.racing.SegmentFetcher`, the hedged
  per-segment variant the manifest ingest drives.
- :mod:`manifest` — HLS-style media-playlist ingest: bounded-interval
  refresh, live-edge window, ``#EXT-X-ENDLIST`` termination, VOD fast
  path, each durable segment announced into the job's FileStream so the
  streaming pipeline stages it while later segments are still being
  produced.

The byte-moving mechanism stays in ``stages/download.py`` (the same
``.partial``/splice/If-Range machinery single-origin fetches use); this
package owns only the *policy*: which origin fetches which bytes next.
"""

from .plan import Origin, OriginHealth, origin_label, resolve_mirrors
from .racing import RangeScheduler, SegmentFetcher

__all__ = [
    "Origin", "OriginHealth", "RangeScheduler", "SegmentFetcher",
    "origin_label", "resolve_mirrors",
]

"""Fleet coordination plane: worker registry, cross-worker singleflight,
and a shared cache tier.

the cache+singleflight, the control plane, and the breakers all
live inside one process; this package is the layer that makes N worker
processes draining ``v1.download`` behave like one cache-coherent
downloader:

- :mod:`.coord` — the conditional-put key/value substrate (in-memory
  backend for tests/benches, staging-bucket backend for production).
- :mod:`.plane` — :class:`~.plane.FleetPlane`: worker
  registration/heartbeats with liveness expiry, content-key leases with
  TTL + takeover (cross-worker singleflight), and the shared cache tier
  (manifest-last spill of local cache entries, peer materialization).

Disabled by default (``fleet.enabled`` / env ``FLEET_ENABLED``); a lone
worker pays nothing for it.
"""

from .coord import (
    ABSENT,
    ANY,
    BucketCoordStore,
    CasBucketCoordStore,
    CoordError,
    CoordStore,
    MemoryCoordStore,
)
from .plane import (
    LED,
    SHARED,
    UNCOORDINATED,
    FleetPlane,
    resolve_worker_id,
)

__all__ = [
    "ABSENT", "ANY", "LED", "SHARED", "UNCOORDINATED",
    "BucketCoordStore", "CasBucketCoordStore", "CoordError",
    "CoordStore", "FleetPlane", "MemoryCoordStore",
    "resolve_worker_id",
]

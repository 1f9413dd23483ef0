"""Control plane: job registry, lifecycle API, cooperative cancellation,
and priority-class start scheduling.

The reference worker is fire-and-forget (the only intervention is killing
the process, upstream lib/main.js:174-204); this package gives
operators and the downstream converter steering:

- :mod:`.registry` — every delivery tracked through a validated state
  machine from receipt to a terminal state, with a bounded ring of
  finished records for post-hoc inspection.
- :mod:`.cancel` — a cooperative :class:`CancelToken` carried in every
  job's ``StageContext``, checked at the stages' chunk loops and by the
  torrent client between piece batches.
- :mod:`.api` — ``/v1/jobs``, cancel, intake pause/resume, and drain
  endpoints mounted on the health app.
- :mod:`.scheduler` — priority-class (HIGH/NORMAL/BULK) start ordering
  over the concurrency slots, with a starvation-proof aging bump.
"""

from .cancel import CancelToken, JobCancelled
from .registry import (
    ADMITTED,
    CANCELLED,
    DONE,
    DROPPED_POISON,
    EXPIRED,
    FAILED,
    PARKED,
    PUBLISHING,
    RECEIVED,
    RUNNING,
    TERMINAL_STATES,
    IllegalTransition,
    JobRecord,
    JobRegistry,
)
from .scheduler import (
    PRIORITY_RANK,
    PriorityScheduler,
    priority_name,
    priority_rank,
)

__all__ = [
    "ADMITTED", "CANCELLED", "DONE", "DROPPED_POISON", "EXPIRED",
    "FAILED", "PARKED", "PUBLISHING", "RECEIVED", "RUNNING",
    "TERMINAL_STATES", "PRIORITY_RANK",
    "CancelToken", "IllegalTransition", "JobCancelled", "JobRecord",
    "JobRegistry", "PriorityScheduler", "priority_name", "priority_rank",
]

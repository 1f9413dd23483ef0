"""Shared reclaim policy for pid-named temp files.

Two subsystems write ``<dst>.<marker>-<pid>.<seq>`` temps that a SIGKILL
can orphan: the fs object store's ingest temps (``store/fs.py``) and the
transcoder's part-files (``compute/transcode.py``).  Both need the same
three-way judgement, kept here so a policy tuning lands in one place:

- the pid probes **live locally** -> not stale (a concurrent writer owns
  the rename race);
- the temp is **younger than the grace** -> not stale even with a dead
  pid, because over NFS the pid probe is host-local and a sibling host's
  in-flight writer would read as dead here;
- the probe is **inconclusive** (EPERM: recycled pid under another uid;
  OverflowError: pid field beyond pid_t) -> stale only past a day-scale
  max age, when no real writer could still be running.

A copy of ``downloader_tpu.utils.stale``, kept so the port never imports
the JAX package.
"""

from __future__ import annotations

import os
import re
import time
from typing import Optional, Tuple

STALE_GRACE_S = 300.0
STALE_MAX_AGE_S = 24 * 3600.0

# the transcoder's part-file naming (the seq group is optional so temps
# from the short-lived earlier naming, .part-<pid><ext> with no counter,
# are still reclaimable).  Lives here, not in compute/, because the
# process stage's media walk must skip these without importing the
# compute subsystem (the staging pipeline never imports JAX).
PART_TEMP_RE = re.compile(r"\.part-(\d+)(?:\.\d+)?(\.[^.]+)?$")

# what the media walk skips: ONLY the full two-number form the
# transcoder actually writes (.part-<pid>.<seq><ext>).  The lenient
# pattern above is safe for reclaim because its glob is anchored to a
# known dst, but in a walk it would also swallow legitimate content
# named like "Movie.part-2.mkv" (review r5).
PART_TEMP_STRICT_RE = re.compile(r"\.part-(\d+)\.(\d+)(\.[^.]+)?$")


def probe_stale(path: str, pid: int, *,
                grace: float = STALE_GRACE_S,
                max_age: float = STALE_MAX_AGE_S,
                ) -> Tuple[bool, Optional[float]]:
    """Judge one temp: returns ``(stale, age_seconds)``.

    ``age`` is None when the file vanished under us (concurrent
    replace/reclaim — never stale).  ``stale=False`` with a large age
    means the pid probes live: either a genuine long-running writer or a
    foreign file whose pid field happens to collide (the fs store logs
    the latter).
    """
    try:
        age = time.time() - os.stat(path).st_mtime
    except OSError:
        return False, None
    if age < grace:
        return False, age
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True, age
    except (OSError, OverflowError):
        return age > max_age, age  # inconclusive probe
    return False, age  # provably live local writer

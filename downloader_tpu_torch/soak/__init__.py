"""Sustained-load soak harness.

Every subsystem built since the fault-tolerance layer has its own
targeted chaos/bench rig — fault plans (``make chaos``), the SIGKILL
crash harness (``make crash``), racing chaos, the fairness bench — but
none of them exercise the subsystems *together* under sustained load,
which is exactly the regime a production fleet lives in.  This package
is that missing rig:

- :class:`~.workload.SoakWorkload` builds a deterministic mixed job
  schedule — cache-hot fan-in, multi-origin racing, segment-manifest
  ingest, multi-tenant BULK pressure with deadlines — against origin
  endpoints the caller provides;
- :class:`~.rig.SoakRig` drives that schedule through a REAL
  multi-worker fleet (``python -m downloader_tpu_torch`` subprocesses over a
  real-wire broker + object store), SIGKILLs and restarts workers on a
  cadence, and tracks per-job time-to-staged from the durable world
  (done markers), not from any worker's memory;
- :class:`~.sampler.GrowthSampler` scrapes ``/metrics`` + ``/readyz``,
  worker RSS, journal size, coordination-store document counts, and
  shared-cache bytes throughout the run;
- :mod:`~.slo` turns the run into hard SLO verdicts: p99
  time-to-staged per priority class, bounded RSS slope, bounded
  journal/coord-store/shared-cache growth (compaction and GC must hold
  the line under duress, not merely exist), zero leaked leases or
  orphan workdirs at drain, zero poison-budget burn, and hop-ledger
  totals that reconcile with stage wall clock.

Profiles: :meth:`SoakProfile.smoke` is the tier-1-safe ≤60 s run
(``make soak-smoke``); :meth:`SoakProfile.full` is the slow-marked
capacity run (``make soak``); :meth:`SoakProfile.degraded` swaps the
SIGKILL chaos for *degraded-world* chaos — a SIGSTOP/SIGCONT worker
stall that overruns the lease TTL (split-brain rehearsal for the
fencing layer) plus a windowed store brownout that must open the
breaker via the slow-call policy (``bench.py --degraded`` emits
``brownout_shed_ms`` / ``split_brain_stale_writes``).  ``bench.py
--soak`` emits ``soak_p99_ms`` / ``soak_rss_slope_mb_per_kjob`` /
``soak_journal_peak_bytes`` from the same rig.  Knobs ``soak.jobs`` /
``soak.workers`` / ``soak.kill_interval`` / ``soak.stalls`` /
``soak.stall_interval`` / ``soak.stall_duration`` override any profile
(see docs/OPERATIONS.md "Capacity & SLOs").

The backends (broker, store, origins) are injected: tests and the
bench own the MiniAmqp/MiniS3/origin servers, the package owns the
workload, the chaos, the sampling, and the verdicts.
"""

from .rig import SoakRig, SoakWorld
from .sampler import GrowthSampler, Sample, parse_prometheus
from .slo import (Guard, SoakReport, brownout_shed_seconds, evaluate,
                  fenced_writes_total, fit_slope, percentile,
                  slow_opens_total)
from .workload import (JobSpec, SoakEndpoints, SoakProfile, SoakWorkload,
                       WorkloadOrigin, download_msg)

__all__ = [
    "SoakRig",
    "SoakWorld",
    "GrowthSampler",
    "Sample",
    "parse_prometheus",
    "Guard",
    "SoakReport",
    "evaluate",
    "fit_slope",
    "percentile",
    "brownout_shed_seconds",
    "slow_opens_total",
    "fenced_writes_total",
    "JobSpec",
    "SoakEndpoints",
    "SoakProfile",
    "SoakWorkload",
    "WorkloadOrigin",
    "download_msg",
]

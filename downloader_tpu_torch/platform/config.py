"""YAML config loading with env overrides.

Capability-equivalent to the reference's ``triton-core/config``:
``Config('converter')`` loads the YAML config for the shared service key
(upstream index.js:18), and the only key the reference consumes
in-tree is ``config.instance.download_path``
(upstream lib/download.js:235,240).

Config files live in ``$CONFIG_PATH`` (default ``./config``) as
``<service>.yaml``.  Missing files fall back to built-in defaults so the
service boots hermetically.  Nested keys are exposed with attribute access
(``config.instance.download_path``) to keep call sites readable.
"""

from __future__ import annotations

import os
from typing import Any, Mapping, Optional

import yaml

DEFAULTS: dict = {
    "instance": {
        # Relative paths are resolved against the repo root at use time,
        # matching the reference's relative-path fixup
        # (upstream lib/download.js:234-240).
        "download_path": "downloading",
        # Max concurrently-processed jobs (the MQ consumer prefetch).  2
        # is the reference's qos (PARITY.md "AMQP constructor constants");
        # raise it for fan-in traffic where the content cache makes extra
        # in-flight jobs cheap.  Env: MAX_CONCURRENT_JOBS.
        "max_concurrent_jobs": 2,
        # Content-addressed staging cache (store/cache.py).  Disabled
        # unless ``cache.enabled`` is true or ``cache.path`` is set
        # (CACHE_ENABLED / CACHE_DIR).  ``cache.max_bytes`` caps the LRU
        # disk budget (CACHE_MAX_BYTES); ``cache.min_free_bytes`` is the
        # free-disk floor job admission maintains on the cache volume
        # (CACHE_MIN_FREE_BYTES).
        # "cache": {"enabled": True, "path": "...", "max_bytes": ...,
        #           "min_free_bytes": ...},
        #
        # Control plane (control/):
        # "scheduler_backlog": 0,        # extra consumer-prefetch
        #     deliveries held for priority reordering (SCHEDULER_BACKLOG;
        #     0 = FIFO parity, nothing to reorder)
        # "scheduler_aging_seconds": 60, # starvation bump: one priority
        #     class per interval waited (SCHEDULER_AGING_SECONDS)
        # "upload_rate_limit": 0,        # bytes/s egress cap to the
        #     staging store (mirror of download_rate_limit; 0=unlimited)
    },
    # Control-plane admin API (control/api.py, mounted on the health
    # port): "control": {"token": "..."} — bearer token gating the
    # mutating endpoints (env CONTROL_TOKEN); "errored_on_cancel": True
    # keeps legacy telemetry consumers on ERRORED instead of CANCELLED.
    #
    # Dependency fault tolerance (platform/errors.py):
    # "retry": {
    #   "default": {"attempts": 3, "base": 0.1, "cap": 2.0},
    #       # in-process retry budget for transient dependency failures
    #       # (total tries / backoff floor seconds / backoff ceiling);
    #       # per-dependency overrides under "store" | "publish" |
    #       # "http" | "tracker" | "disk"
    #   "redelivery": {"base": 0.25, "cap": 15.0},
    #       # park-then-nack: a transiently-failed delivery waits
    #       # base * 2^(failures-1) (capped) before its nack, so the
    #       # broker redelivers AFTER the blip; base 0 = instant nack
    # },
    # "breakers": {
    #   "enabled": True,
    #   "default": {"threshold": 5, "reset": 30.0},
    #       # consecutive transient failures that open a dependency's
    #       # circuit breaker / seconds until its half-open probe;
    #       # per-dependency overrides like "retry".  "http" (origin
    #       # fetch) is breaker-less by default — one job's dead origin
    #       # must not block the fleet — opt in via
    #       # breakers.http.enabled: true
    # },
    # "faults": {"plan": [...]}  # deterministic fault injection for
    #       # chaos drills (platform/faults.py; env FAULT_PLAN) — see
    #       # docs/OPERATIONS.md "Failure model"
    #
    # Multi-tenant overload control (control/tenancy.py +
    # control/overload.py; docs/OPERATIONS.md "Tenancy & overload"):
    # "tenants": {
    #   "<name>": {
    #     "weight": 1,             # weighted-fair share of run slots
    #         # WITHIN each priority class (stride scheduling; priority
    #         # and aging still dominate)
    #     "max_concurrent": None,  # run slots this tenant may hold at
    #         # once (None = unbounded)
    #     "download_rate_limit": 0,  # per-tenant ingress bytes/s,
    #         # stacked UNDER instance.download_rate_limit
    #     "upload_rate_limit": 0,    # per-tenant egress bytes/s
    #   },
    # },
    # # Absent/unknown Download.tenant runs as "default" (the
    # # unknown-priority -> NORMAL posture); no "tenants" section = the
    # # exact pre-tenancy behavior.
    # "overload": {
    #   "enabled": True,           # false removes the controller
    #   "interval": 1.0,           # pressure sampling cadence, seconds
    #   "sustain": 3,              # consecutive breached samples before
    #       # the worker is declared saturated (and after: one healthy
    #       # sample clears)
    #   "max_loop_lag": 1.5,       # seconds of event-loop lag; 0 off
    #   "min_headroom_bytes": 0,   # shed when disk headroom drops below
    #   "max_queue_depth": 0,      # shed when more jobs are queued
    #   "max_oldest_seconds": 0,   # shed when the oldest queued job ages
    #   "shed_backoff": 5.0,       # park before the shed nack, seconds
    # },
    # # While saturated, BULK deliveries are parked+nacked (never FAILED
    # # permanently, no poison charge); HIGH/NORMAL keep flowing.
    # # Download.ttl_seconds (deadline from receipt): expired BULK is
    # # dropped as EXPIRED, expired HIGH/NORMAL is surfaced but runs.
    #
    # Origin plane (origins/; docs/OPERATIONS.md "Origins & live
    # ingest").  Zero config needed: a job without Download.mirrors
    # and with source_kind AUTO behaves exactly as before.
    # "origins": {
    #   "max_labels": 16,      # distinct origin metric/breaker labels
    #       # per process; overflow hosts collapse to "other" (job
    #       # payloads must not mint Prometheus series — the tenant
    #       # posture)
    #   "dup_factor": 1.25,    # an idle origin duplicates a straggler
    #       # tail only when its EWMA beats the owner's by this factor
    #   "min_dup_bytes": 1048576,  # tails smaller than this are waited
    #       # out, not duplicated
    #   "stall_takeover": 10.0,    # an in-flight range that lands
    #       # nothing for this long is treated as black-holed: idle
    #       # origins may duplicate/take it over regardless of the
    #       # EWMA and min-tail gates
    #   "hedge_delay": 1.0,    # manifest segment fetch: seconds to wait
    #       # for an origin's FIRST byte before hedging to the next
    #   "manifest": {
    #     "min_poll": 0.25,    # playlist refresh clamp (refresh runs at
    #     "max_poll": 6.0,     # target_duration/2 between these bounds)
    #     "stall_timeout": 240.0,  # live playlist unchanged this long
    #         # => ERRDLSTALL (ack + drop, the dead-stream policy)
    #     "live_window": 0,    # join a live playlist at most this many
    #         # segments behind the live edge (0 = from the beginning)
    #   },
    # },
    # # Per-origin fault seams inherit family config:
    # # retry.origin.{attempts,base,cap} and
    # # breakers.origin.{threshold,reset,enabled} cover every
    # # origin:<host> dependency (breakers default ON per origin — a
    # # dead mirror must open ITS breaker without parking the fleet;
    # # admission still keys only on store/publish).
    #
    # Fleet coordination plane (fleet/): disabled by default — a lone
    # worker pays nothing.  See docs/ARCHITECTURE.md "Fleet plane".
    # "fleet": {
    #   "enabled": False,            # FLEET_ENABLED; join the fleet
    #   "backend": "bucket",         # coordination store: staging-bucket
    #       # objects under .fleet/ (default) | "memory" (hermetic,
    #       # single-process tests/benches)
    #   "worker_id": None,           # WORKER_ID; default host-pid-nonce
    #   "heartbeat_interval": 5.0,   # registry re-beat cadence, seconds
    #   "liveness_ttl": 15.0,        # heartbeat age at which a worker
    #       # is considered dead (must exceed heartbeat_interval)
    #   "lease_ttl": 20.0,           # content-lease expiry; a crashed
    #       # leader's work is taken over after this long
    #   "poll_interval": 0.25,       # lease-waiter poll cadence
    #   "max_wait": 600.0,           # waiter livelock bound before an
    #       # uncoordinated fallback fetch
    #   "shared_tier": True,         # spill cache fills to the staging
    #       # bucket (.fleet-cache/<key>/) for peers to materialize
    #   "gc_interval": 300.0,        # shared-tier + tombstone GC sweep
    #       # cadence (0 disables); bounds .fleet-cache/ and .fleet/
    #       # growth on the bucket backend
    #   "shared_max_age": 86400.0,   # evict shared-tier entries older
    #       # than this (manifest age), seconds
    #   "shared_max_bytes": 0,       # shared-tier size budget (oldest
    #       # evicted first; 0 = age bound only)
    # },
    #
    # In-process SLO accounting (control/slo.py; docs/OPERATIONS.md
    # "SLOs, burn rates & the fleet overview").  On by default — the
    # tracker is a deque append per settle.
    # "slo": {
    #   "enabled": True,         # false removes the tracker entirely
    #   "objectives": {          # per-priority-class targets; a key
    #     "HIGH": {              # matching a configured tenant name
    #       "p99_ms": 30000.0,   # creates a tenant-scoped objective
    #       "availability": 0.999,
    #     },
    #   },
    #   "fast_window": 300.0,    # burn-rate fast window, seconds
    #   "slow_window": 3600.0,   # burn-rate slow window, seconds
    #   "budget_window": 86400.0,  # error budget accounting window
    #   "max_events": 8192,      # bounded per-objective event ring
    # },
    "minio": {
        "endpoint": os.environ.get("MINIO_ENDPOINT", "localhost:9000"),
        "access_key": os.environ.get("MINIO_ACCESS_KEY", ""),
        "secret_key": os.environ.get("MINIO_SECRET_KEY", ""),
        "ssl": False,
    },
    "rabbitmq": {
        # "memory" boots hermetically; "amqp" connects to dyn('rabbitmq')
        "backend": "memory",
    },
    "services": {
        # service-discovery name -> address map consumed by dyn()
        "rabbitmq": os.environ.get("RABBITMQ", "amqp://localhost"),
        "minio": os.environ.get("MINIO", "http://localhost:9000"),
    },
}


class ConfigNode(Mapping):
    """Read-only mapping with attribute access over a nested dict."""

    def __init__(self, data: dict):
        self._data = data

    def __getattr__(self, key: str) -> Any:
        try:
            value = self._data[key]
        except KeyError:
            raise AttributeError(key) from None
        return ConfigNode(value) if isinstance(value, dict) else value

    def __getitem__(self, key: str) -> Any:
        value = self._data[key]
        return ConfigNode(value) if isinstance(value, dict) else value

    def __iter__(self):
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key: str, default: Any = None) -> Any:
        value = self._data.get(key, default)
        return ConfigNode(value) if isinstance(value, dict) else value

    def to_dict(self) -> dict:
        return dict(self._data)

    def __repr__(self) -> str:
        return f"ConfigNode({self._data!r})"


def _deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for key, value in override.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = _deep_merge(out[key], value)
        else:
            out[key] = value
    return out


def load_config(service: str = "converter", path: Optional[str] = None) -> ConfigNode:
    """Load ``<service>.yaml`` from the config dir, merged over defaults.

    Mirrors ``Config('converter')`` (upstream index.js:18): the
    downloader shares the converter service's config file.
    """
    config_dir = path or os.environ.get("CONFIG_PATH", "config")
    config_file = os.path.join(config_dir, f"{service}.yaml")
    data: dict = {}
    if os.path.exists(config_file):
        with open(config_file, "r", encoding="utf-8") as fh:
            loaded = yaml.safe_load(fh) or {}
            if not isinstance(loaded, dict):
                raise ValueError(f"config file {config_file} must contain a mapping")
            data = loaded
    return ConfigNode(_deep_merge(DEFAULTS, data))


def cfg_get(config, path: str, default: Any = None) -> Any:
    """Safe nested lookup: ``cfg_get(config, "health.sane", False)``.

    Tolerates a None/dict-less config, missing intermediate sections, and
    explicit None values (which fall back to ``default``).  The one place
    config-gated features resolve their keys, instead of each hand-rolling
    the try/except ladder.
    """
    node = config
    for key in path.split("."):
        if node is None or not hasattr(node, "get"):
            return default
        node = node.get(key)
    return default if node is None else node


def dyn(name: str, config: Optional[ConfigNode] = None) -> str:
    """Service-discovery: resolve a service name to an address.

    Capability-equivalent to ``triton-core/dynamics``' ``dyn('rabbitmq')``
    (upstream lib/main.js:46,49).  Resolution order: env var
    ``<NAME>`` (uppercased), then the config ``services`` map, then
    ``localhost``.
    """
    env = os.environ.get(name.upper())
    if env:
        return env
    if config is not None:
        services = config.get("services")
        if services is not None and name in services:
            return services[name]
    defaults = DEFAULTS["services"]
    return defaults.get(name, "localhost")

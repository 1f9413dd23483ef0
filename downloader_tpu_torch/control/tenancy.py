"""Tenant identity, weights, and per-tenant quotas.

The reference service has no notion of *who* submitted a job: one noisy
library import starves every other submitter behind it in the flat
``v1.download`` queue (PAPER.md §1).  Priority classes reorder
starts but a single tenant can still monopolize every run slot and every
byte of ingress/egress.  This module gives the control plane a tenant
axis:

- ``Download.tenant`` (proto field 4) names the submitter.  Absent or
  empty means the ``"default"`` tenant; a name with no ``tenants.<name>``
  config entry *degrades to* ``"default"`` too — the exact posture of the
  unknown-priority -> NORMAL degrade in :func:`..control.scheduler.
  priority_name` — so tenancy is opt-in per name, label cardinality on
  /metrics stays bounded by config, and a deployment with no ``tenants``
  section behaves byte-for-byte like the pre-tenancy service.
- :class:`TenantTable` resolves wire names and holds each configured
  tenant's scheduling weight (``tenants.<name>.weight``, consumed by the
  weighted-fair pick in :class:`~.scheduler.PriorityScheduler`),
  concurrency cap (``tenants.<name>.max_concurrent``), and ingress/
  egress byte quotas (``tenants.<name>.download_rate_limit`` /
  ``upload_rate_limit``, bytes/s) built on the same
  :class:`~..utils.ratelimit.TokenBucket` machinery as the per-service
  caps.  Tenant buckets stack *under* the service-wide limiter
  (:class:`~..utils.ratelimit.ChainedLimiter`): a transfer pays both.

Config shape::

    tenants:
      vip:   {weight: 4, max_concurrent: 4}
      batch: {weight: 1, max_concurrent: 1,
              download_rate_limit: 8000000, upload_rate_limit: 8000000}

Weights apportion run-slot grants *within* a priority class (priority
still dominates; aging still starvation-proofs both axes).  ``default``
may be configured like any other tenant; unconfigured it has weight 1
and no caps.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..platform.config import cfg_get
from ..utils.ratelimit import TokenBucket, chain_limiters

DEFAULT_TENANT = "default"
DEFAULT_WEIGHT = 1.0

# per-tenant quota/shape knobs a tenants.<name> section may carry
_RATE_KEYS = ("download_rate_limit", "upload_rate_limit")


class TenantTable:
    """Configured tenants: weights, concurrency caps, byte quotas.

    Built once per orchestrator and shared (via ``stage_resources``) with
    the stages, so per-tenant token buckets are per-SERVICE singletons —
    the same memoization discipline as :func:`~..utils.ratelimit.
    shared_bucket` (a per-job bucket would multiply the quota by the
    concurrency).
    """

    def __init__(self, config=None, logger=None):
        self.logger = logger
        self._specs: Dict[str, dict] = {}
        self._buckets: Dict[str, Optional[TokenBucket]] = {}
        raw = cfg_get(config, "tenants", None)
        if raw:
            for name in raw:
                spec = raw.get(name) or {}
                self._specs[str(name)] = self._parse(str(name), spec)
        self._specs.setdefault(DEFAULT_TENANT, self._parse(DEFAULT_TENANT, {}))

    @staticmethod
    def _parse(name: str, spec) -> dict:
        def _get(key, default=None):
            getter = getattr(spec, "get", None)
            return getter(key, default) if getter is not None else default

        weight = _get("weight", DEFAULT_WEIGHT)
        try:
            weight = float(weight)
        except (TypeError, ValueError):
            raise ValueError(
                f"tenants.{name}.weight={weight!r} is not a number"
            ) from None
        if weight <= 0:
            raise ValueError(f"tenants.{name}.weight must be > 0, got {weight}")
        cap = _get("max_concurrent")
        if cap is not None:
            cap = int(cap)
            if cap < 1:
                raise ValueError(
                    f"tenants.{name}.max_concurrent must be >= 1, got {cap}"
                )
        out = {"weight": weight, "max_concurrent": cap}
        for key in _RATE_KEYS:
            rate = _get(key)
            if rate is not None:
                rate = float(rate)
                if rate < 0:
                    raise ValueError(
                        f"tenants.{name}.{key} must be >= 0, got {rate}"
                    )
            out[key] = rate or None  # 0/absent = unlimited
        return out

    # -- identity -------------------------------------------------------
    @property
    def configured(self) -> bool:
        """True when the deployment opted into tenancy (any ``tenants``
        entry beyond the implicit default)."""
        return len(self._specs) > 1 or any(
            v is not None
            for k, v in self._specs[DEFAULT_TENANT].items()
            if k != "weight"
        ) or self._specs[DEFAULT_TENANT]["weight"] != DEFAULT_WEIGHT

    def names(self) -> list:
        """Every tenant the table can attribute work to (bounded by
        config — the /metrics label set)."""
        return sorted(self._specs)

    def resolve(self, wire_name: Optional[str]) -> str:
        """Wire ``Download.tenant`` -> the tenant this worker runs the
        job as.  Absent/empty -> ``default``; a name without a config
        entry degrades to ``default`` (unknown-priority->NORMAL posture)
        so an un-onboarded submitter gets baseline service instead of an
        error, and metric label cardinality stays config-bounded."""
        name = (wire_name or "").strip()
        if not name or name == DEFAULT_TENANT:
            return DEFAULT_TENANT
        if name in self._specs:
            return name
        if self.logger is not None:
            self.logger.debug("unknown tenant, degrading to default",
                              tenant=name)
        return DEFAULT_TENANT

    # -- scheduling inputs ---------------------------------------------
    def weight(self, tenant: str) -> float:
        spec = self._specs.get(tenant)
        return spec["weight"] if spec else DEFAULT_WEIGHT

    def max_concurrent(self, tenant: str) -> Optional[int]:
        spec = self._specs.get(tenant)
        return spec["max_concurrent"] if spec else None

    # -- byte quotas ----------------------------------------------------
    def _bucket(self, tenant: str, key: str) -> Optional[TokenBucket]:
        cache_key = f"{tenant}:{key}"
        if cache_key not in self._buckets:
            spec = self._specs.get(tenant)
            rate = spec.get(key) if spec else None
            self._buckets[cache_key] = TokenBucket(rate) if rate else None
        return self._buckets[cache_key]

    def ingress_limiter(self, tenant: str) -> Optional[TokenBucket]:
        return self._bucket(tenant, "download_rate_limit")

    def egress_limiter(self, tenant: str) -> Optional[TokenBucket]:
        return self._bucket(tenant, "upload_rate_limit")

    # -- introspection --------------------------------------------------
    def describe(self) -> Dict[str, dict]:
        """Static per-tenant config, JSON-shaped for ``GET /v1/tenants``."""
        out = {}
        for name, spec in self._specs.items():
            out[name] = {
                "weight": spec["weight"],
                "maxConcurrent": spec["max_concurrent"],
                "downloadRateLimit": spec["download_rate_limit"],
                "uploadRateLimit": spec["upload_rate_limit"],
            }
        return out


def stage_limiter(ctx, direction: str, base) -> Any:
    """Stack the job's per-tenant byte quota under the service limiter.

    ``ctx`` is the stage's :class:`~..stages.base.StageContext`;
    ``direction`` is ``"ingress"`` or ``"egress"``; ``base`` is the
    service-wide bucket (may be None).  Outside the orchestrator (no
    tenant table in resources, or no registry record) this returns
    ``base`` unchanged — standalone stage use pays nothing.
    """
    table = ctx.resources.get("tenant_table") if ctx.resources else None
    tenant = getattr(ctx.record, "tenant", None)
    if table is None or not tenant:
        return base
    if direction == "ingress":
        quota = table.ingress_limiter(tenant)
    else:
        quota = table.egress_limiter(tenant)
    return chain_limiters(base, quota)

"""Dependency fault tolerance: error taxonomy, retries, circuit breakers.

The reference service's only failure policy is "nack and hope"
(upstream lib/main.js:148-150): every stage error triggers an
*instant* broker redelivery, and the poison guard counts attempts with
no notion of *why* they failed — a 30-second S3 or tracker blip can burn
the whole poison budget in milliseconds and permanently drop healthy
jobs.  At production scale transient dependency failures are the steady
state, not the exception; this module gives every dependency seam a
shared vocabulary and machinery to ride them out:

- **Taxonomy** — :func:`classify` buckets any exception into
  :data:`TRANSIENT` (dependency blip: timeouts, resets, 5xx, disk
  pressure — retry with backoff), :data:`PERMANENT` (will never succeed:
  4xx, bad protocol, missing file — fail fast, never burn retries), or
  :data:`POISON` (the *content* is bad: no media files — drop, don't
  redeliver).  Exceptions may pre-classify themselves by carrying a
  ``fault_class`` attribute; the injected faults (platform/faults.py)
  and the S3 driver's status-code errors do.
- **Retry** — :class:`Retrier` runs a dependency call under a
  per-dependency :class:`RetryPolicy` (config ``retry.<dependency>``,
  falling back to ``retry.default``): bounded attempts, exponential
  backoff with decorrelated jitter (AWS architecture-blog style:
  ``sleep = min(cap, uniform(base, prev * 3))``), cancel token honored
  *during* the backoff sleeps, every retry visible as a flight-recorder
  event and a ``dependency_retries_total{seam}`` metric.
- **Circuit breakers** — :class:`CircuitBreaker` per dependency
  (closed → open after ``threshold`` consecutive transient failures →
  half-open probe after ``reset`` seconds → closed on probe success),
  aggregated in a :class:`BreakerBoard` the orchestrator consults at
  admission: when the staging store or convert publish breaker is open,
  intake parks jobs instead of failing them, ``/readyz`` answers 503
  with the breaker states, and the half-open probe restores service
  without operator action.  State rides ``breaker_state{dependency}``
  (0=closed, 1=open, 2=half-open) and
  ``breaker_transitions_total{dependency,to_state}``.
- **Slow-call policy** ("slow is the new down") — a browned-out
  dependency that answers every call successfully but slowly never
  trips a failure-count breaker, and by the time timeouts fire the
  whole pipeline is wedged behind it.  With
  ``breakers.<dep>.slow_threshold_ms`` set, every *answered* attempt
  (success or transient failure) is classified fast/slow into a
  bounded ring of the last ``slow_window`` calls; once at least
  ``slow_min_calls`` are in the ring and the slow fraction reaches
  ``slow_ratio``, the breaker opens with ``open_reason = "slow"`` —
  the same park-not-fail shedding as a failure-opened breaker, before
  the timeout cascade.  A half-open probe that answers slowly re-opens
  (the dependency is back, but not usable).  Slow calls count on
  ``dependency_slow_total{dependency}``; every open is attributed on
  ``breaker_opened_total{dependency,reason=failure|slow}`` and the
  reason rides ``/readyz``.

Seams are dotted names (``store.put``, ``http.fetch``,
``tracker.announce``); the dependency — the retry-policy and breaker
key — is the first component (``store``, ``publish``, ``http``,
``tracker``, ``disk``).
"""

from __future__ import annotations

import asyncio
import random
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional

from .config import cfg_get

# -- the taxonomy -------------------------------------------------------
TRANSIENT = "transient"   # dependency blip: retry with backoff
PERMANENT = "permanent"   # will never succeed: fail fast, no retries
POISON = "poison"         # the content is bad: drop, never redeliver

FAULT_CLASSES = (TRANSIENT, PERMANENT, POISON)

# exception codes the retry machinery must always pass through untouched:
# cooperative cancellation settles the job, and a stall has its own
# orchestrator policy (ack + drop, reference lib/main.js:144-146)
_PASSTHROUGH_CODES = frozenset({"ERRCANCELLED", "ERRDLSTALL"})

# type names classified without importing their modules (stages/store
# import this package; importing them back would cycle)
_POISON_TYPE_NAMES = frozenset({"NoMediaFilesError"})
_PERMANENT_TYPE_NAMES = frozenset({"ObjectNotFound"})

# HTTP statuses that are retryable despite being client errors
_TRANSIENT_HTTP_STATUSES = frozenset({408, 429})


def _passthrough_code(err: BaseException) -> bool:
    """True for the cancel/stall marker codes.  Reads ``code`` off the
    CLASS (our marker exceptions define it there) — instance getattr
    would trip aiohttp's deprecated ``ClientResponseError.code``
    property."""
    code = getattr(type(err), "code", None)
    return isinstance(code, str) and code in _PASSTHROUGH_CODES


def seam_dependency(seam: str) -> str:
    """``store.put`` -> ``store``: the retry-policy / breaker key."""
    return seam.split(".", 1)[0]


def dependency_family(dependency: str) -> Optional[str]:
    """``origin:mirror-a:8080`` -> ``origin``: the config family a
    *labeled* dependency inherits knobs from.  Per-origin breakers and
    retry budgets key on ``origin:<label>`` so each origin trips
    independently, but nobody configures per-host thresholds — the
    ``retry.origin`` / ``breakers.origin`` sections cover the family.
    None for plain (unlabeled) dependencies."""
    if ":" not in dependency:
        return None
    return dependency.split(":", 1)[0]


def classify(err: BaseException) -> str:
    """Bucket ``err`` into TRANSIENT / PERMANENT / POISON.

    An explicit ``fault_class`` attribute wins (injected faults, the S3
    driver's status-coded errors, and anything a seam pre-classified).
    Unknown errors default to TRANSIENT: at-least-once delivery already
    assumes redelivery is safe, and misclassifying a transient blip as
    permanent drops real work while the reverse merely wastes a bounded
    retry budget.
    """
    explicit = getattr(err, "fault_class", None)
    if explicit in FAULT_CLASSES:
        return explicit
    name = type(err).__name__
    if name in _POISON_TYPE_NAMES:
        return POISON
    if name in _PERMANENT_TYPE_NAMES:
        return PERMANENT
    if _passthrough_code(err):
        # never reached via the Retrier (it passes these through before
        # classifying); callers classifying directly must not retry them
        return PERMANENT
    # aiohttp response errors carry the origin's verdict
    status = getattr(err, "status", None)
    if isinstance(status, int) and status >= 400:
        return (TRANSIENT if status >= 500
                or status in _TRANSIENT_HTTP_STATUSES else PERMANENT)
    if isinstance(err, (PermissionError, FileNotFoundError,
                        NotADirectoryError, IsADirectoryError)):
        return PERMANENT
    if isinstance(err, (ValueError, TypeError, KeyError, LookupError,
                        NotImplementedError, AttributeError)):
        # contract/config errors ("Protocol not supported.", bad stage
        # payloads): retrying re-runs the same deterministic code path
        return PERMANENT
    if isinstance(err, (ConnectionError, TimeoutError, OSError,
                        asyncio.TimeoutError)):
        return TRANSIENT
    return TRANSIENT


def tag_fault(err: BaseException, fault_class: Optional[str] = None,
              seam: Optional[str] = None) -> BaseException:
    """Best-effort annotation of ``err`` with its classification/seam
    (slotted exceptions simply stay untagged)."""
    try:
        if fault_class is not None:
            err.fault_class = fault_class
        if seam is not None:
            err.fault_seam = seam
    except (AttributeError, TypeError):
        pass
    return err


class BreakerOpen(RuntimeError):
    """A dependency's circuit breaker rejected the call without trying.

    TRANSIENT by class (the dependency is expected back), but it must
    NOT advance the poison counter — the job never got to fail; the
    orchestrator parks and redelivers it without charging the budget.
    """

    fault_class = TRANSIENT
    counts_toward_poison = False

    def __init__(self, dependency: str, retry_after: float):
        self.dependency = dependency
        self.fault_seam = dependency
        self.retry_after = retry_after
        super().__init__(
            f"{dependency} circuit breaker is open "
            f"(probe in ~{retry_after:.1f}s)"
        )


# -- retry policy -------------------------------------------------------

@dataclass(frozen=True)
class RetryPolicy:
    """Per-dependency in-process retry budget.

    ``attempts`` counts total tries (1 = no retries).  ``base``/``cap``
    bound the decorrelated-jitter backoff.  Defaults are deliberately
    small — a media pipeline's in-process retries ride *inside* the
    broker's at-least-once redelivery, which handles the long outages
    (see ``retry.redelivery``); production deployments raise them per
    dependency (docs/OPERATIONS.md "Failure model").
    """

    attempts: int = 3
    base: float = 0.1
    cap: float = 2.0

    @classmethod
    def from_config(cls, config, dependency: str) -> "RetryPolicy":
        family = dependency_family(dependency)

        def knob(name: str, fallback):
            fallback = cfg_get(config, f"retry.default.{name}", fallback)
            if family is not None:
                fallback = cfg_get(config, f"retry.{family}.{name}",
                                   fallback)
            return cfg_get(config, f"retry.{dependency}.{name}", fallback)

        attempts = int(knob("attempts", cls.attempts))
        base = float(knob("base", cls.base))
        cap = float(knob("cap", cls.cap))
        if attempts < 1:
            raise ValueError(
                f"retry.{dependency}.attempts must be >= 1, got {attempts}"
            )
        if base < 0 or cap < base:
            raise ValueError(
                f"retry.{dependency}: need 0 <= base <= cap, "
                f"got base={base} cap={cap}"
            )
        return cls(attempts=attempts, base=base, cap=cap)


# -- circuit breaker ----------------------------------------------------

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

_STATE_GAUGE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}

DEFAULT_BREAKER_THRESHOLD = 5
DEFAULT_BREAKER_RESET = 30.0
# slow-call policy defaults (slow_threshold 0 = policy off)
DEFAULT_SLOW_RATIO = 0.5
DEFAULT_SLOW_WINDOW = 16
DEFAULT_SLOW_MIN_CALLS = 8

# breaker open reasons (``breaker_opened_total{reason}`` / readyz)
OPEN_FAILURE = "failure"
OPEN_SLOW = "slow"
OPEN_DISK = "disk"


class CircuitBreaker:
    """Closed/open/half-open breaker for one dependency.

    Counts *consecutive* transient failures; at ``threshold`` it opens
    and :meth:`allow` rejects calls until ``reset`` seconds pass, then
    admits exactly one half-open probe.  Probe success closes the
    breaker; probe failure re-opens it (fresh reset window).  Only
    transient failures should be recorded — a 404 is not an outage.

    With ``slow_threshold`` > 0 the breaker also watches latency: each
    answered attempt lands fast/slow in a bounded ring, and a sustained
    slow fraction (>= ``slow_ratio`` over >= ``slow_min_calls`` of the
    last ``slow_window`` answers) opens the breaker with
    ``open_reason = "slow"`` even though every call succeeded — the
    brownout shape failure counting is blind to.
    """

    __slots__ = ("dependency", "threshold", "reset", "metrics", "logger",
                 "state", "failures", "_opened_mono", "_probe_inflight",
                 "transitions", "slow_threshold", "slow_ratio",
                 "slow_window", "slow_min_calls", "_slow_ring",
                 "open_reason")

    def __init__(self, dependency: str,
                 threshold: int = DEFAULT_BREAKER_THRESHOLD,
                 reset: float = DEFAULT_BREAKER_RESET,
                 slow_threshold: float = 0.0,
                 slow_ratio: float = DEFAULT_SLOW_RATIO,
                 slow_window: int = DEFAULT_SLOW_WINDOW,
                 slow_min_calls: int = DEFAULT_SLOW_MIN_CALLS,
                 metrics=None, logger=None):
        if threshold < 1:
            raise ValueError(
                f"breakers.{dependency}.threshold must be >= 1, "
                f"got {threshold}"
            )
        if reset <= 0:
            raise ValueError(
                f"breakers.{dependency}.reset must be > 0, got {reset}"
            )
        if slow_threshold < 0:
            raise ValueError(
                f"breakers.{dependency}.slow_threshold_ms must be >= 0"
            )
        if not 0.0 < slow_ratio <= 1.0:
            raise ValueError(
                f"breakers.{dependency}.slow_ratio must be in (0, 1], "
                f"got {slow_ratio}"
            )
        if slow_window < 1 or slow_min_calls < 1:
            raise ValueError(
                f"breakers.{dependency}.slow_window/slow_min_calls "
                "must be >= 1"
            )
        self.dependency = dependency
        self.threshold = threshold
        self.reset = reset
        self.slow_threshold = float(slow_threshold)
        self.slow_ratio = float(slow_ratio)
        self.slow_window = int(slow_window)
        self.slow_min_calls = min(int(slow_min_calls), int(slow_window))
        self.metrics = metrics
        self.logger = logger
        self.state = CLOSED
        self.failures = 0          # consecutive transient failures
        self._opened_mono = 0.0
        self._probe_inflight = False
        self.transitions = 0
        # fast/slow verdicts of the last slow_window ANSWERED attempts
        self._slow_ring: "deque[bool]" = deque(maxlen=self.slow_window)
        # why the breaker last opened ("failure" | "slow"); None while
        # it has never opened or has closed again
        self.open_reason: Optional[str] = None
        if metrics is not None:
            metrics.breaker_state.labels(dependency=dependency).set(0)

    def _move(self, state: str) -> None:
        if state == self.state:
            return
        self.state = state
        self.transitions += 1
        if self.metrics is not None:
            self.metrics.breaker_state.labels(
                dependency=self.dependency
            ).set(_STATE_GAUGE[state])
            self.metrics.breaker_transitions.labels(
                dependency=self.dependency, to_state=state
            ).inc()
        if self.logger is not None:
            self.logger.warn("circuit breaker transition",
                             dependency=self.dependency, state=state,
                             failures=self.failures,
                             reason=self.open_reason)

    def _open(self, reason: str) -> None:
        """Open with attribution: the triage path for a slow-opened
        breaker (shed + wait out the brownout) differs from a
        failure-opened one (check the dependency is up at all)."""
        self.open_reason = reason
        self._opened_mono = time.monotonic()
        if self.metrics is not None:
            self.metrics.breaker_opened.labels(
                dependency=self.dependency, reason=reason
            ).inc()
        self._move(OPEN)

    def force_open(self, reason: str) -> None:
        """Open now on an out-of-band verdict the call counters never
        see — the disk-headroom gate (``reason="disk"``): the volume
        filling up fails no store call until the ENOSPC cascade is
        already underway.  Re-forcing while open refreshes the reset
        window; recovery is the normal half-open probe (the first
        successful call after ``reset`` closes it)."""
        self._open(reason)

    def note_latency(self, elapsed: Optional[float]) -> bool:
        """Land one answered attempt's latency in the slow ring;
        returns whether it was slow.  No-op when the policy is off."""
        if self.slow_threshold <= 0 or elapsed is None:
            return False
        slow = elapsed >= self.slow_threshold
        self._slow_ring.append(slow)
        if slow and self.metrics is not None:
            self.metrics.dependency_slow.labels(
                dependency=self.dependency
            ).inc()
        return slow

    def _slow_trip_due(self) -> bool:
        ring = self._slow_ring
        return (len(ring) >= self.slow_min_calls
                and sum(ring) / len(ring) >= self.slow_ratio)

    def retry_after(self) -> float:
        """Seconds until the next half-open probe window (0 = now)."""
        if self.state != OPEN:
            return 0.0
        return max(0.0, self._opened_mono + self.reset - time.monotonic())

    @property
    def blocking(self) -> bool:
        """True while calls would be rejected (open, window not elapsed)."""
        return self.state == OPEN and self.retry_after() > 0

    def allow(self) -> bool:
        """May a call proceed right now?  Handles the open -> half-open
        transition; in half-open only one in-flight probe is admitted."""
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            if self.retry_after() > 0:
                return False
            self._move(HALF_OPEN)
            self._probe_inflight = False
        # half-open: exactly one probe at a time
        if self._probe_inflight:
            return False
        self._probe_inflight = True
        return True

    def release_probe(self) -> None:
        """A half-open probe ended without a dependency verdict (the job
        was cancelled, the transfer stalled): free the slot so the next
        caller can probe — otherwise the breaker wedges half-open."""
        self._probe_inflight = False

    def record_success(self, elapsed: Optional[float] = None) -> None:
        slow = self.note_latency(elapsed)
        self._probe_inflight = False
        if slow and self.state != CLOSED:
            # a slow answer while not closed: the half-open probe came
            # back without the dependency being usable (re-open, fresh
            # reset window), or an in-flight slow success landed after
            # the open — either way it must not close the breaker
            self._slow_ring.clear()
            if self.state == HALF_OPEN:
                self._open(OPEN_SLOW)
            return
        self.failures = 0
        if self.state != CLOSED:
            self.open_reason = None
            self._slow_ring.clear()
            self._move(CLOSED)
            return
        if self._slow_trip_due():
            # every call "succeeds" and the failure counter never moves,
            # yet the dependency is browned out: open on the slow ratio
            # (ring cleared so the post-reset probe is judged fresh)
            self._slow_ring.clear()
            self._open(OPEN_SLOW)

    def record_failure(self, elapsed: Optional[float] = None) -> None:
        self.note_latency(elapsed)
        self._probe_inflight = False
        if self.state == HALF_OPEN:
            # failed probe: back to open, fresh reset window — and
            # RE-attributed: a probe that ERRORED means the dependency
            # is down now, even if the original open was slow-call (a
            # brownout hardening into an outage must steer operators to
            # the failure runbook, not "wait it out")
            self._open(OPEN_FAILURE)
            return
        self.failures += 1
        if self.state == CLOSED:
            if self.failures >= self.threshold:
                self._open(OPEN_FAILURE)
            elif self._slow_trip_due():
                # slow transient failures count toward the brownout
                # verdict too (a timing-out store answers *eventually*)
                self._slow_ring.clear()
                self._open(OPEN_SLOW)


# dependencies that are per-JOB concerns, not shared infrastructure: a
# breaker would let ONE job's dead origin block every other job's
# downloads, so no breaker is kept for them unless config opts in
# (``breakers.<dep>.enabled: true``) — retries still apply
_PER_JOB_DEPENDENCIES = frozenset({"http"})


class BreakerBoard:
    """Per-dependency breakers, built lazily from config.

    Config: ``breakers.<dependency>.{threshold,reset,enabled}`` over
    ``breakers.default``.  ``breakers.enabled: false`` disables the
    whole board (every call allowed, nothing recorded).  The ``http``
    dependency defaults to breaker-less: an origin is one job's
    problem, not the fleet's (see :data:`_PER_JOB_DEPENDENCIES`).
    """

    def __init__(self, config=None, metrics=None, logger=None):
        self.config = config
        self.metrics = metrics
        self.logger = logger
        self.enabled = bool(cfg_get(config, "breakers.enabled", True))
        self._breakers: Dict[str, CircuitBreaker] = {}

    def get(self, dependency: str) -> Optional[CircuitBreaker]:
        family = dependency_family(dependency)
        enabled_fallback = dependency not in _PER_JOB_DEPENDENCIES
        if family is not None:
            enabled_fallback = bool(cfg_get(
                self.config, f"breakers.{family}.enabled",
                enabled_fallback,
            ))
        if not bool(cfg_get(
            self.config, f"breakers.{dependency}.enabled",
            enabled_fallback,
        )):
            return None
        breaker = self._breakers.get(dependency)
        if breaker is None:
            def knob(name: str, fallback):
                fallback = cfg_get(self.config,
                                   f"breakers.default.{name}", fallback)
                if family is not None:
                    fallback = cfg_get(
                        self.config, f"breakers.{family}.{name}", fallback
                    )
                return cfg_get(
                    self.config, f"breakers.{dependency}.{name}", fallback
                )

            breaker = CircuitBreaker(
                dependency,
                threshold=int(knob("threshold",
                                   DEFAULT_BREAKER_THRESHOLD)),
                reset=float(knob("reset", DEFAULT_BREAKER_RESET)),
                # slow-call policy (ms in config, seconds inside): 0
                # keeps the exact failure-count-only behavior
                slow_threshold=float(
                    knob("slow_threshold_ms", 0.0)) / 1000.0,
                slow_ratio=float(knob("slow_ratio", DEFAULT_SLOW_RATIO)),
                slow_window=int(knob("slow_window", DEFAULT_SLOW_WINDOW)),
                slow_min_calls=int(knob("slow_min_calls",
                                        DEFAULT_SLOW_MIN_CALLS)),
                metrics=self.metrics, logger=self.logger,
            )
            self._breakers[dependency] = breaker
        return breaker

    def states(self) -> Dict[str, str]:
        """dependency -> state, for ``/readyz`` and the admin API."""
        return {dep: b.state for dep, b in sorted(self._breakers.items())}

    def open_reasons(self) -> Dict[str, str]:
        """dependency -> why its breaker last opened (``failure`` |
        ``slow``), for every breaker not currently closed — the triage
        attribution ``/readyz`` carries beside the states."""
        return {dep: b.open_reason
                for dep, b in sorted(self._breakers.items())
                if b.state != CLOSED and b.open_reason}

    def blocking_dependencies(
        self, dependencies: Optional[Iterable[str]] = None
    ) -> List[str]:
        """Dependencies whose breaker would reject a call right now."""
        deps = (self._breakers.keys() if dependencies is None
                else dependencies)
        out = []
        for dep in deps:
            breaker = self._breakers.get(dep)
            if breaker is not None and breaker.blocking:
                out.append(dep)
        return out

    async def wait_ready(self, dependencies: Iterable[str],
                         poll: float = 0.05) -> None:
        """Park until none of ``dependencies`` is hard-open.

        Returns as soon as every breaker is closed or due a half-open
        probe — released jobs then race for the single probe slot; the
        losers get :class:`BreakerOpen` from their seams and are parked
        for redelivery without advancing the poison counter.
        """
        deps = list(dependencies)
        while True:
            blocked = self.blocking_dependencies(deps)
            if not blocked:
                return
            retry_after = min(
                self._breakers[dep].retry_after() for dep in blocked
            )
            await asyncio.sleep(min(max(retry_after, poll), 1.0))


# -- the retry executor -------------------------------------------------

class Retrier:
    """Runs dependency calls under per-dependency retry + breaker policy.

    One instance per service (the orchestrator shares its own through
    ``ctx.resources``); standalone stage use builds one from config via
    :meth:`shared`.
    """

    def __init__(self, config=None, breakers: Optional[BreakerBoard] = None,
                 metrics=None, logger=None,
                 rng: Optional[random.Random] = None):
        self.config = config
        self.breakers = breakers
        self.metrics = metrics
        self.logger = logger
        self._rng = rng or random.Random()
        self._policies: Dict[str, RetryPolicy] = {}

    @classmethod
    def shared(cls, resources: dict, config, metrics=None,
               logger=None) -> "Retrier":
        """Per-service retrier memoized in the cross-job ``resources``
        dict (same idiom as the rate-limit buckets): the orchestrator
        pre-installs its instance so the stages share its breaker board;
        standalone stage use lazily builds one from config."""
        retrier = resources.get("retrier")
        if retrier is None:
            retrier = cls(
                config=config,
                breakers=BreakerBoard(config, metrics=metrics,
                                      logger=logger),
                metrics=metrics, logger=logger,
            )
            resources["retrier"] = retrier
        return retrier

    def policy(self, dependency: str) -> RetryPolicy:
        policy = self._policies.get(dependency)
        if policy is None:
            policy = RetryPolicy.from_config(self.config, dependency)
            self._policies[dependency] = policy
        return policy

    def _observe(self, dependency: str, seam: str, outcome: str,
                 elapsed: float) -> None:
        """One RED sample per dependency *attempt* — the latency
        distribution behind every seam (``dependency_request_seconds``),
        labeled with how the dependency answered.  Breaker rejections
        are NOT observed: no request was made, and a wall of sub-ms
        "failures" would bury the real latency signal."""
        if self.metrics is not None:
            self.metrics.dependency_request_seconds.labels(
                dependency=dependency, op=seam, outcome=outcome
            ).observe(elapsed)

    async def run(self, seam: str, factory: Callable[[], Any], *,
                  cancel=None, record=None, logger=None) -> Any:
        """Await ``factory()`` with bounded transient retries.

        ``factory`` is a zero-arg callable returning a fresh awaitable
        per attempt.  TRANSIENT failures back off (decorrelated jitter,
        cancel-aware sleeps) and feed the dependency's breaker;
        PERMANENT/POISON failures, cancellation, and stalls re-raise
        immediately.  The final error is tagged with ``fault_class`` and
        ``fault_seam`` so the orchestrator's redelivery policy can key
        on them.
        """
        dependency = seam_dependency(seam)
        policy = self.policy(dependency)
        breaker = (self.breakers.get(dependency)
                   if self.breakers is not None and self.breakers.enabled
                   else None)
        log = logger or self.logger
        prev_delay = policy.base
        for attempt in range(1, policy.attempts + 1):
            if breaker is not None and not breaker.allow():
                raise BreakerOpen(dependency, breaker.retry_after())
            attempt_started = time.monotonic()
            try:
                result = await factory()
            except Exception as err:
                elapsed = time.monotonic() - attempt_started
                if _passthrough_code(err):
                    # cancellation / stall: never retried, never tagged —
                    # and no breaker verdict (the dependency didn't get
                    # to answer), but a held half-open probe slot must
                    # be freed or the breaker wedges
                    if breaker is not None:
                        breaker.release_probe()
                    self._observe(dependency, seam, "cancelled", elapsed)
                    raise
                fault = classify(err)
                self._observe(dependency, seam, fault, elapsed)
                if fault != TRANSIENT:
                    # the dependency ANSWERED (404, 403, bad request) —
                    # not an outage, so no failure is recorded; but not
                    # a success either: a store failing only its WRITE
                    # path must not have interleaved healthy 404 probes
                    # (e.g. the idempotency marker check) resetting the
                    # consecutive-failure count.  Free any held probe
                    # slot and let a real success close the breaker.
                    if breaker is not None:
                        breaker.release_probe()
                    raise tag_fault(err, fault, seam)
                if breaker is not None:
                    breaker.record_failure(elapsed)
                if attempt >= policy.attempts:
                    raise tag_fault(err, TRANSIENT, seam)
                delay = min(policy.cap,
                            self._rng.uniform(policy.base,
                                              max(prev_delay * 3,
                                                  policy.base)))
                prev_delay = delay
                if self.metrics is not None:
                    self.metrics.dependency_retries.labels(seam=seam).inc()
                if record is not None:
                    record.event("retry", seam=seam, attempt=attempt,
                                 of=policy.attempts,
                                 delay_s=round(delay, 3),
                                 type=type(err).__name__,
                                 error=str(err)[:160])
                    record.retry = {
                        "seam": seam, "attempt": attempt,
                        "of": policy.attempts,
                        "nextDelayS": round(delay, 3),
                    }
                if log is not None:
                    log.warn("transient dependency failure, retrying",
                             seam=seam, attempt=attempt,
                             of=policy.attempts, delay_s=round(delay, 3),
                             error=str(err)[:200])
                if cancel is not None:
                    await cancel.guard(asyncio.sleep(delay))
                else:
                    await asyncio.sleep(delay)
            else:
                elapsed = time.monotonic() - attempt_started
                self._observe(dependency, seam, "ok", elapsed)
                if breaker is not None:
                    # elapsed feeds the slow-call ring: a browned-out
                    # dependency's all-successes-but-slow train opens
                    # the breaker with reason "slow"
                    breaker.record_success(elapsed)
                if record is not None:
                    record.retry = None
                return result
        raise AssertionError("unreachable: retry loop exits via return/raise")

"""Deterministic fault injection at the dependency seams.

The fault-tolerance layer (platform/errors.py) is only as trustworthy
as the failures it was proven against, so the same seams the taxonomy
covers — store/S3 ops, convert publish, HTTP origin fetch, tracker
announce, disk preflight — carry injection hooks driven by a declarative
**fault plan**:

.. code-block:: yaml

    faults:
      plan:
        - seam: "store.put"     # fnmatch pattern over the seam name
          match: "job-7"        # optional substring filter on the call key
          kind: error           # error | delay | partial | hang
          count: 5              # how many matching calls to affect
          after: 0              # matching calls to let through first
          fault: transient      # taxonomy class carried by the error
          delay_s: 0.05         # delay/partial sleep length

(env ``FAULT_PLAN`` takes the same list as JSON).  Kinds:

- ``error``   — raise an :class:`InjectedFault` carrying ``fault``
- ``delay``   — sleep ``delay_s`` then let the call through
- ``partial`` — sleep ``delay_s`` (simulated partial progress) then
  raise, modelling a mid-transfer connection drop
- ``hang``    — block until cancelled (exercises cancel tokens and
  watchdogs against a black-holed dependency)
- ``crash``   — SIGKILL this very process at the seam: a deterministic
  crash point for the kill-based chaos harness (tests/test_crash.py,
  ``make crash``).  A real, uncatchable kill — no atexit, no finally,
  no flush — exactly the torn state an OOM-kill leaves, so restart
  reconciliation (control/journal.py) is proven against the worst
  case, not a polite simulation.  ``after``/``count`` place the kill
  precisely (e.g. ``seam: store.put, after: 1`` dies between the first
  staged file and the done marker); the restarted process starts with
  fresh rule counters, so the same plan does not re-kill unless its
  ``after`` is reached again

**Windowed network-degradation kinds** (the degraded-world chaos plane,
``make degraded``).  Per-call counts cannot express "the store is slow
for ten seconds" or "the coordination store flaps" — the failure modes
that defeat count-based breakers in production — so three kinds are
scoped by *wall-clock window* instead: active while ``start_s <=
(now - install time) < start_s + window_s`` (``window_s: 0`` = open-
ended).  ``after``/``count`` still apply to matching calls inside the
window:

- ``brownout``  — add latency to every matching call, then let it
  through: ``latency_ms`` base plus a deterministic ``jitter_ms``
  spread (a fixed sample sequence, no RNG — reruns see identical
  latency trains).  The call SUCCEEDS slowly: exactly the
  "slow is the new down" shape failure-count breakers never see and
  the slow-call policy (platform/errors.py) exists for.
- ``partition`` — refuse the whole seam family for the window: raise
  an :class:`InjectedFault` per call, or black-hole it
  (``blackhole: true`` — block until cancelled).  ``mode``
  (``all`` | ``writes`` | ``reads``) makes it asymmetric: the classic
  degraded coord store that answers reads while conditional puts
  time out is ``mode: writes``.
- ``flap``      — a periodic partition: partitioned for the first
  ``duty`` fraction of every ``period_s`` cycle, healthy for the
  rest.  Same ``mode``/``blackhole`` knobs.  The waiter-livelock
  regression (fleet.max_wait aging) drills with exactly this kind.

**Disk faults** (the storage fault plane, ``make bench-disk``).  The
zero-copy staging path (io_uring landing, sendfile/mmap uploads, the
hardlinked peer tier) has failure modes no network kind can model —
ENOSPC mid-part, EIO on a completion, a short write the caller must
resume, a torn tail across a crash — so a ``disk`` kind injects them
through the VFS shim (platform/vfs.py) every landing/staging write
routes through.  ``disk_mode`` selects the failure shape:

- ``enospc``  — raise :class:`DiskFault` carrying ``errno.ENOSPC``
  (classified ``fault`` — PERMANENT by default for space exhaustion
  drills, or transient when the window models an operator freeing
  space)
- ``eio``     — raise :class:`DiskFault` carrying ``errno.EIO``
- ``short``   — the shim truncates one write syscall (the kernel
  accepted fewer bytes than asked): the caller's resume loop must
  carry on at the right offset, no error raised
- ``latency`` — a slow device: sleep ``latency_ms`` (+ deterministic
  ``jitter_ms``) around the write.  Only enacted where the write
  already runs off the event loop (the io_pool landing thread); on-loop
  writes skip the sleep rather than stall every job
- ``torn``    — crash-consistency: at promote time, rename WITHOUT the
  fsync, corrupt the tail of the renamed file, then SIGKILL — the
  exact page-cache-loss state a power cut leaves, which boot recovery
  must demote back to resumable instead of serving

``disk`` rules are windowed like the network kinds (``start_s`` /
``window_s`` against install time; both 0 = always on), so a drill can
say "the disk is full for ten seconds" — and
``analysis/drift.py``'s windowed-coverage lint enforces that the
family stays drillable (its exemption list is empty).

Count-scoped kinds stay fully deterministic — activation is by *call
count* per rule, no randomness — so a chaos test
(tests/test_faults.py, ``make chaos``) asserts exact retry/breaker
sequences; windowed kinds are deterministic *given the clock* (phase
helpers :meth:`FaultRule.window_active` / :meth:`FaultRule.flap_on`
are pure functions of elapsed time, unit-testable without sleeping).
When no plan is installed the seams pay one module-level ``None``
check (:func:`enabled`), nothing else.

The injector is process-global (:func:`install` / :func:`uninstall`):
the seams live in stages, stores, and the tracker, and threading a
handle through every call path would put a test-harness concern in
every production signature.  The orchestrator installs from config at
construction and uninstalls at shutdown; tests use
``install(...)``/``uninstall()`` in fixtures.
"""

from __future__ import annotations

import asyncio
import fnmatch
import json
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

from .config import cfg_get
from .errors import FAULT_CLASSES, TRANSIENT

_ENV_PLAN = "FAULT_PLAN"

KINDS = ("error", "delay", "partial", "hang", "crash",
         "brownout", "partition", "flap", "disk")
#: kinds scoped by wall-clock window (anchored at injector install)
WINDOWED_KINDS = frozenset({"brownout", "partition", "flap"})
#: partition/flap asymmetry: which side of the dependency is degraded
MODES = ("all", "writes", "reads")
#: ``disk`` failure shapes (see module docstring)
DISK_MODES = ("enospc", "eio", "short", "latency", "torn")

#: seam ops (the last dotted component) that mutate shared state —
#: what an asymmetric ``mode: writes`` partition refuses while reads
#: pass.  ``bucket`` creates, ``announce`` mutates tracker state.
_WRITE_OPS = frozenset({"put", "delete", "remove", "bucket", "write",
                        "publish", "spill", "announce", "ack", "nack"})

#: the declarative surface of a rule — exactly the keys from_dict
#: accepts and to_dict emits.  The incident plane's bundle/compile
#: round-trip (downloader_tpu_torch/incident) leans on this: a serialized
#: rule must re-load through from_dict on any later version.
RULE_FIELDS = ("seam", "kind", "match", "count", "after", "fault",
               "delay_s", "start_s", "window_s", "latency_ms",
               "jitter_ms", "mode", "blackhole", "period_s", "duty",
               "disk_mode")

#: brownout jitter: a fixed sample sequence standing in for a latency
#: distribution — deterministic across reruns (indexed by per-rule
#: fire count), spread roughly uniform over [0, 1)
_JITTER_SEQ = (0.00, 0.63, 0.21, 0.87, 0.44, 0.95, 0.10, 0.71,
               0.33, 0.52, 0.79, 0.05)


def seam_is_write(seam: str) -> bool:
    """``coord.put`` -> True, ``coord.get`` -> False: the asymmetric-
    partition classification (reads-ok/writes-failing is the classic
    degraded object store)."""
    return seam.rsplit(".", 1)[-1] in _WRITE_OPS


def _crash_now(seam: str) -> None:
    """SIGKILL this process — the deterministic crash point.

    ``signal.SIGKILL`` (not ``os._exit``): the process must die the way
    an OOM-kill kills it — no interpreter teardown, no buffered-file
    flush — so the journal/workdir state the restart reconciles is the
    real torn state, not a softened one.  The raw stderr write is a
    best-effort breadcrumb for the harness log (fd 2, unbuffered — it
    survives the kill).
    """
    import signal

    try:
        os.write(2, f"FAULT CRASH at seam {seam}\n".encode())
    except OSError:
        pass
    os.kill(os.getpid(), signal.SIGKILL)


class InjectedFault(RuntimeError):
    """A failure manufactured by the fault plan (classified per rule)."""

    def __init__(self, seam: str, kind: str, fault_class: str):
        self.fault_seam = seam
        self.kind = kind
        self.fault_class = fault_class
        super().__init__(f"injected {fault_class} fault at {seam} ({kind})")


class DiskFault(OSError):
    """An injected storage failure.  An :class:`OSError` subclass with a
    REAL ``errno`` (ENOSPC/EIO) so every ``err.errno`` check on the
    write path — the multipart abort classifier, the uring fallback,
    the headroom breaker — handles a drill exactly like the kernel's
    own error, while ``fault_class`` keeps the retrier taxonomy
    deterministic per rule."""

    def __init__(self, seam: str, disk_mode: str, err_no: int,
                 fault_class: str):
        self.fault_seam = seam
        self.kind = "disk"
        self.disk_mode = disk_mode
        self.fault_class = fault_class
        super().__init__(
            err_no, f"injected disk fault at {seam} ({disk_mode})")


@dataclass
class FaultRule:
    """One line of the fault plan (see module docstring)."""

    seam: str
    kind: str = "error"
    match: str = ""
    count: Optional[int] = None   # None = every matching call
    after: int = 0
    fault: str = TRANSIENT
    delay_s: float = 0.05
    # -- windowed kinds (brownout | partition | flap) only --------------
    start_s: float = 0.0      # window opens this long after install
    window_s: float = 0.0     # window length (0 = open-ended)
    latency_ms: float = 250.0  # brownout base added latency
    jitter_ms: float = 0.0     # brownout deterministic latency spread
    mode: str = "all"          # partition/flap asymmetry (all|writes|reads)
    blackhole: bool = False    # partition/flap: hang instead of raising
    period_s: float = 2.0      # flap cycle length
    duty: float = 0.5          # flap: partitioned fraction of each cycle
    # -- disk kind only -------------------------------------------------
    disk_mode: str = "enospc"  # enospc|eio|short|latency|torn
    # runtime counters (not config)
    calls: int = field(default=0, compare=False)
    fired: int = field(default=0, compare=False)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"fault rule kind must be one of {KINDS}, got {self.kind!r}"
            )
        if self.fault not in FAULT_CLASSES:
            raise ValueError(
                f"fault rule fault must be one of {FAULT_CLASSES}, "
                f"got {self.fault!r}"
            )
        if self.after < 0 or (self.count is not None and self.count < 0):
            raise ValueError("fault rule after/count must be >= 0")
        if self.mode not in MODES:
            raise ValueError(
                f"fault rule mode must be one of {MODES}, got {self.mode!r}"
            )
        if self.start_s < 0 or self.window_s < 0:
            raise ValueError("fault rule start_s/window_s must be >= 0")
        if self.latency_ms < 0 or self.jitter_ms < 0:
            raise ValueError(
                "fault rule latency_ms/jitter_ms must be >= 0")
        if self.kind == "flap" and (
                self.period_s <= 0 or not 0.0 < self.duty <= 1.0):
            raise ValueError(
                "flap rule needs period_s > 0 and 0 < duty <= 1")
        if self.disk_mode not in DISK_MODES:
            raise ValueError(
                f"fault rule disk_mode must be one of {DISK_MODES}, "
                f"got {self.disk_mode!r}")

    @classmethod
    def from_dict(cls, raw: dict) -> "FaultRule":
        unknown = set(raw) - set(RULE_FIELDS)
        if unknown:
            raise ValueError(f"unknown fault rule keys: {sorted(unknown)}")
        if "seam" not in raw:
            raise ValueError("fault rule needs a 'seam'")
        return cls(**raw)

    def to_dict(self) -> dict:
        """The rule's declarative config (RULE_FIELDS only — runtime
        counters excluded), round-trippable through :meth:`from_dict`.
        This is what an incident bundle ships as the fault plan in
        force, so a compiled replay re-arms the exact same rules."""
        return {name: getattr(self, name) for name in RULE_FIELDS}

    # -- windowed phase helpers (pure functions of elapsed time) --------
    def window_active(self, elapsed: float) -> bool:
        """Is the wall-clock window open ``elapsed`` seconds after
        install?  (``window_s: 0`` = open-ended once ``start_s`` passes.)"""
        if elapsed < self.start_s:
            return False
        if self.window_s <= 0:
            return True
        return elapsed < self.start_s + self.window_s

    def flap_on(self, elapsed: float) -> bool:
        """Is a ``flap`` rule in its partitioned phase at ``elapsed``?
        Each ``period_s`` cycle starts partitioned for ``duty`` of it."""
        phase = (elapsed - self.start_s) % self.period_s
        return phase < self.period_s * self.duty

    def mode_covers(self, seam: str) -> bool:
        """Does this rule's asymmetry (``mode``) include ``seam``?"""
        if self.mode == "all":
            return True
        is_write = seam_is_write(seam)
        return is_write if self.mode == "writes" else not is_write

    def brownout_delay_s(self) -> float:
        """The next deterministic brownout latency sample (seconds):
        ``latency_ms`` plus the fire-count-indexed jitter sample."""
        jitter = self.jitter_ms * _JITTER_SEQ[self.fired % len(_JITTER_SEQ)]
        return (self.latency_ms + jitter) / 1000.0

    def applies(self, seam: str, key: str,
                elapsed: Optional[float] = None) -> bool:
        """Match + window + count bookkeeping; True when this call is
        affected.  ``elapsed`` (seconds since injector install) gates
        the windowed kinds; calls outside the window are not counted
        against ``after``/``count``."""
        if not fnmatch.fnmatch(seam, self.seam):
            return False
        if self.match and self.match not in key:
            return False
        if self.kind in WINDOWED_KINDS:
            if not self.mode_covers(seam):
                return False
            if elapsed is None or not self.window_active(elapsed):
                return False
            if self.kind == "flap" and not self.flap_on(elapsed):
                return False
        elif self.kind == "disk":
            # windowed like the network kinds; the 0/0 defaults make an
            # unwindowed rule always-on, so count-scoped disk drills
            # (``after``/``count``) still work unchanged
            if elapsed is None or not self.window_active(elapsed):
                return False
        n = self.calls
        self.calls += 1
        if n < self.after:
            return False
        if self.count is not None and n >= self.after + self.count:
            return False
        return True


class FaultInjector:
    """Executes a fault plan at the seams; tracks firing for tests/bench."""

    def __init__(self, rules: List[FaultRule], logger=None):
        self.rules = rules
        self.logger = logger
        self.fired_total = 0
        # monotonic time of the LAST injected failure: the recovery-time
        # bench measures "dependency healthy -> first completed job" from
        # this moment
        self.last_fired_mono: Optional[float] = None
        # the windowed kinds' wall-clock anchor; install() re-stamps it
        # so a plan built early and installed late still means "window
        # opens start_s after the drill began"
        self.installed_mono = time.monotonic()

    @classmethod
    def from_config(cls, config, logger=None) -> "Optional[FaultInjector]":
        """Build from env ``FAULT_PLAN`` (JSON list) or ``faults.plan``;
        None when no plan is configured."""
        raw_env = os.environ.get(_ENV_PLAN)
        if raw_env:
            try:
                plan = json.loads(raw_env)
            except ValueError as err:
                raise ValueError(f"{_ENV_PLAN} is not valid JSON: {err}")
        else:
            plan = cfg_get(config, "faults.plan", None)
        if not plan:
            return None
        if not isinstance(plan, (list, tuple)):
            raise ValueError("faults.plan must be a list of rules")
        rules = [FaultRule.from_dict(dict(rule)) for rule in plan]
        return cls(rules, logger=logger)

    def disk_action(self, seam: str, key: str = "",
                    thread_ok: bool = False) -> Optional[str]:
        """Consult ``disk`` rules for one write syscall (the VFS shim's
        hook — platform/vfs.py).  Raising modes raise a
        :class:`DiskFault` here; ``latency`` sleeps (only when
        ``thread_ok`` — the caller attests it is off the event loop);
        ``short``/``torn`` return their mode string for the shim to
        enact, since only the shim knows the buffer/rename at hand.
        Returns None when no rule fires."""
        import errno as _errno

        elapsed = time.monotonic() - self.installed_mono
        for rule in self.rules:
            if rule.kind != "disk" or not rule.applies(seam, key, elapsed):
                continue
            self._note_fired(rule)
            mode = rule.disk_mode
            if mode == "latency":
                if thread_ok:
                    time.sleep(rule.brownout_delay_s())
                continue  # the write proceeds (slowly); later rules apply
            self.last_fired_mono = time.monotonic()
            if mode == "enospc":
                raise DiskFault(seam, mode, _errno.ENOSPC, rule.fault)
            if mode == "eio":
                raise DiskFault(seam, mode, _errno.EIO, rule.fault)
            return mode  # "short" | "torn": enacted by the shim
        return None

    def _note_fired(self, rule: FaultRule) -> None:
        rule.fired += 1
        self.fired_total += 1
        if self.logger is not None:
            self.logger.warn("fault injected", seam=rule.seam,
                             kind=rule.kind, fault=rule.fault,
                             fired=rule.fired)

    async def fire(self, seam: str, key: str = "") -> None:
        """Apply the plan to one seam call (raise / delay / hang)."""
        elapsed = time.monotonic() - self.installed_mono
        for rule in self.rules:
            if not rule.applies(seam, key, elapsed):
                continue
            self._note_fired(rule)
            if rule.kind == "crash":
                _crash_now(seam)
            if rule.kind == "disk":
                # async seams (e.g. ``disk.land``) honor the raising and
                # latency modes; short/torn are write-shim mechanics the
                # VFS layer enacts, meaningless at an async hook
                import errno as _errno

                if rule.disk_mode == "latency":
                    await asyncio.sleep(rule.brownout_delay_s())
                    continue
                if rule.disk_mode == "enospc":
                    self.last_fired_mono = time.monotonic()
                    raise DiskFault(seam, "enospc", _errno.ENOSPC,
                                    rule.fault)
                if rule.disk_mode == "eio":
                    self.last_fired_mono = time.monotonic()
                    raise DiskFault(seam, "eio", _errno.EIO, rule.fault)
                continue
            if rule.kind == "brownout":
                # the call SUCCEEDS, slowly: sample the deterministic
                # latency train, sleep, let it through (later rules —
                # e.g. a stacked error — still apply)
                await asyncio.sleep(rule.brownout_delay_s())
                continue
            if rule.kind in ("partition", "flap") and rule.blackhole:
                await asyncio.Event().wait()  # until cancelled
            if rule.kind == "delay":
                await asyncio.sleep(rule.delay_s)
                continue  # delayed, not failed: later rules still apply
            if rule.kind == "hang":
                await asyncio.Event().wait()  # until cancelled
            if rule.kind == "partial":
                # partial progress then a mid-transfer failure
                await asyncio.sleep(rule.delay_s)
            self.last_fired_mono = time.monotonic()
            raise InjectedFault(seam, rule.kind, rule.fault)

    def fire_sync(self, seam: str, key: str = "") -> None:
        """Synchronous seams (disk preflight) support ``error``,
        ``crash``, the refusing (non-blackhole) side of
        ``partition``/``flap``, and the raising ``disk`` modes
        (ENOSPC/EIO) — a blocking sleep would stall the event loop, so
        latency kinds never inject here (disk latency rides the VFS
        shim's off-loop writes instead)."""
        import errno as _errno

        elapsed = time.monotonic() - self.installed_mono
        for rule in self.rules:
            if not rule.applies(seam, key, elapsed):
                continue
            if rule.kind == "crash":
                self._note_fired(rule)
                _crash_now(seam)
            if rule.kind == "disk":
                if rule.disk_mode in ("enospc", "eio"):
                    self._note_fired(rule)
                    self.last_fired_mono = time.monotonic()
                    raise DiskFault(
                        seam, rule.disk_mode,
                        _errno.ENOSPC if rule.disk_mode == "enospc"
                        else _errno.EIO,
                        rule.fault)
                continue
            if rule.kind in ("partition", "flap") and not rule.blackhole:
                self._note_fired(rule)
                self.last_fired_mono = time.monotonic()
                raise InjectedFault(seam, rule.kind, rule.fault)
            if rule.kind != "error":
                continue
            self._note_fired(rule)
            self.last_fired_mono = time.monotonic()
            raise InjectedFault(seam, rule.kind, rule.fault)


# -- process-global installation ---------------------------------------

_ACTIVE: Optional[FaultInjector] = None


def install(injector: FaultInjector) -> FaultInjector:
    global _ACTIVE
    # anchor the windowed kinds at install time: "start_s after the
    # drill began", not after the plan object happened to be built
    injector.installed_mono = time.monotonic()
    _ACTIVE = injector
    return injector


def uninstall(injector: Optional[FaultInjector] = None) -> None:
    """Remove the active injector.  Pass the instance you installed to
    make uninstall idempotent across owners (the orchestrator only
    removes its own, never a test's)."""
    global _ACTIVE
    if injector is None or _ACTIVE is injector:
        _ACTIVE = None


def active() -> Optional[FaultInjector]:
    return _ACTIVE


def enabled() -> bool:
    """The zero-overhead guard seams check before awaiting :func:`fire`."""
    return _ACTIVE is not None


async def fire(seam: str, key: str = "") -> None:
    if _ACTIVE is not None:
        await _ACTIVE.fire(seam, key)


def fire_sync(seam: str, key: str = "") -> None:
    if _ACTIVE is not None:
        _ACTIVE.fire_sync(seam, key)


def disk_action(seam: str, key: str = "",
                thread_ok: bool = False) -> Optional[str]:
    """The VFS shim's per-syscall hook (see
    :meth:`FaultInjector.disk_action`); None when no injector or no
    matching ``disk`` rule."""
    if _ACTIVE is not None:
        return _ACTIVE.disk_action(seam, key, thread_ok=thread_ok)
    return None

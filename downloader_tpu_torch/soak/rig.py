"""The soak rig: a real multi-worker fleet under sustained mixed load.

Generalizes the crash harness's one-worker pattern (tests/test_crash.py
``CrashRig``) to N ``python -m downloader_tpu_torch`` subprocess workers that
share one real-wire broker and one staging store, then holds them under
the full workload mix while SIGKILLing and restarting workers on a
cadence.  Per-job time-to-staged is measured from the *durable world*
— the staging store's done markers — so a worker dying mid-run can
never lose the measurement, only slow the job.

The rig owns no backends: the broker URL, object store, and origin
endpoints are injected (tests stand up MiniAmqp/MiniS3; a production
soak could point at real RabbitMQ/MinIO the same way).
"""

from __future__ import annotations

import asyncio
import os
import signal
import socket
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import aiohttp
import yaml

from .. import schemas
from ..control.journal import JOURNAL_DIRNAME, JOURNAL_FILENAME, replay
from ..fleet.coord import BucketCoordStore
from ..incident.replay import collect_incidents
from ..mq.amqp import AmqpQueue
from ..stages.upload import (STAGING_BUCKET, done_marker_name,
                             object_name)
from ..store.base import ObjectNotFound
from .sampler import GrowthSampler
from .slo import SoakReport, evaluate
from .workload import JobSpec, SoakProfile, SoakWorkload, download_msg

#: terminal states the admin-API fallback accepts as "resolved without
#: a done marker" (EXPIRED is legitimate for deadline-carrying BULK;
#: the others are guard violations the SLO layer flags)
_TERMINAL_NO_MARKER = ("EXPIRED", "FAILED", "DROPPED_POISON",
                       "CANCELLED")


def _flip_byte(path: str) -> None:
    """Deterministic single-byte bit-rot at the file's midpoint."""
    size = os.path.getsize(path)
    if size <= 0:
        raise OSError(0, "empty file")
    offset = size // 2
    with open(path, "r+b") as fh:
        fh.seek(offset)
        byte = fh.read(1)
        fh.seek(offset)
        fh.write(bytes([byte[0] ^ 0xFF]))


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _open_log(path: str):
    return open(path, "ab")


@dataclass
class WorkerSlot:
    """One worker identity: stable across kill/restart generations."""

    index: int
    worker_id: str
    downloads: str
    cache_dir: str
    config_dir: str
    log_dir: str
    health_port: int
    proc: Optional[object] = None
    generation: int = 0
    #: set once /readyz answered for the CURRENT generation — the
    #: sampler must not scrape (and tally failures against) a process
    #: still booting after a chaos respawn (cleared again while the
    #: stall chaos holds the process under SIGSTOP)
    ready: bool = False
    #: monotonic time the current generation's /readyz first answered —
    #: the anchor the degraded profile's brownout-window measurements
    #: (``brownout_shed_ms``) are taken from
    ready_mono: float = 0.0

    @property
    def pid(self) -> int:
        return self.proc.pid if self.proc is not None else 0

    @property
    def alive(self) -> bool:
        return (self.ready and self.proc is not None
                and self.proc.returncode is None)

    @property
    def journal_path(self) -> str:
        return os.path.join(self.downloads, JOURNAL_DIRNAME,
                            JOURNAL_FILENAME)


@dataclass
class JobOutcome:
    """One published job's fate, as observed from the durable world."""

    spec: JobSpec
    published_mono: float
    staged_mono: Optional[float] = None
    terminal_state: Optional[str] = None
    resolved_mono: Optional[float] = None


@dataclass
class SoakWorld:
    """The end-of-run census the SLO guards judge drain hygiene on."""

    leaked_leases: List[str] = field(default_factory=list)
    orphan_workdirs: Dict[int, List[str]] = field(default_factory=dict)
    records: List[dict] = field(default_factory=list)
    #: LIVE coordination docs per prefix at drain (tombstones resolved
    #: away — the per-sample census counts raw objects instead, which
    #: include tombstones until the fleet GC's sweep compacts them)
    coord_live: Dict[str, int] = field(default_factory=dict)
    journal_final_bytes: Dict[int, int] = field(default_factory=dict)
    unsettled_journal_jobs: List[str] = field(default_factory=list)
    byte_mismatches: List[str] = field(default_factory=list)
    scrape_failures: int = 0
    kills_delivered: int = 0
    #: SIGSTOP/SIGCONT stalls delivered (degraded profile) — like a
    #: kill, a stall can fail at most one in-flight scrape
    stalls_delivered: int = 0


class SoakRig:
    """Drive one profile's workload through a real worker fleet."""

    def __init__(self, profile: SoakProfile, *, amqp_url: str, store,
                 s3_endpoint: str, access_key: str = "AKIA",
                 secret_key: str = "SECRET", root: str,
                 bucket: str = STAGING_BUCKET, logger=None):
        self.profile = profile
        self.amqp_url = amqp_url
        self.store = store
        self.s3_endpoint = s3_endpoint
        self.access_key = access_key
        self.secret_key = secret_key
        self.root = root
        self.bucket = bucket
        self.logger = logger
        self.outcomes: Dict[str, JobOutcome] = {}
        self.kills_delivered = 0
        self.stalls_delivered = 0
        self.world: Optional[SoakWorld] = None
        #: the growth sampler's series, kept after run() for callers
        #: that inspect the raw timelines (tests, the bench)
        self.samples: List = []
        #: the fleet's auto-exported incident bundles,
        #: pulled from every live worker's /v1/incidents just before
        #: drain — the replay diff's raw material
        self.incidents: List[dict] = []
        #: the bit-rot phase's record (disk profile): seeded corrupt
        #: paths, scrub totals before seeding, and the final totals —
        #: the bench's ``scrub_repaired == seeded`` guard reads these
        self.seeded_corruptions: List[str] = []
        self.scrub_base: Dict[str, int] = {}
        self.scrub_final: Dict[str, int] = {}
        self.slots = [self._make_slot(i) for i in range(profile.workers)]
        self._session: Optional[aiohttp.ClientSession] = None

    def _make_slot(self, index: int) -> WorkerSlot:
        base = os.path.join(self.root, f"w{index}")
        return WorkerSlot(
            index=index,
            worker_id=f"soak-w{index}",
            downloads=os.path.join(base, "downloads"),
            cache_dir=os.path.join(base, "cache"),
            config_dir=os.path.join(base, "config"),
            log_dir=base,
            health_port=_free_port(),
        )

    # -- sampler duck-type ---------------------------------------------
    def live_workers(self) -> List[WorkerSlot]:
        return [slot for slot in self.slots if slot.alive]

    def resolved_jobs(self) -> int:
        return sum(1 for o in self.outcomes.values()
                   if o.resolved_mono is not None)

    async def store_census(self) -> "tuple[Dict[str, int], int]":
        """(coordination docs by prefix, `.fleet-cache/` bytes) counted
        from the durable store — tombstones included: disk reality."""
        docs = {"workers": 0, "leases": 0, "telemetry": 0}
        async for info in self.store.list_objects(self.bucket, ".fleet/"):
            rest = info.name[len(".fleet/"):]
            prefix = rest.split("/", 1)[0]
            if prefix in docs:
                docs[prefix] += 1
        shared = 0
        async for info in self.store.list_objects(self.bucket,
                                                  ".fleet-cache/"):
            shared += info.size
        return docs, shared

    # -- worker lifecycle ----------------------------------------------
    def write_config(self, slot: WorkerSlot) -> None:
        profile = self.profile
        cfg = {
            "instance": {
                "download_path": slot.downloads,
                "max_concurrent_jobs": profile.max_concurrent_jobs,
                "scheduler_backlog": profile.scheduler_backlog,
                "cache": {
                    "enabled": True,
                    "path": slot.cache_dir,
                    "max_bytes": 256 << 20,
                    "min_free_bytes": 1 << 20,
                },
            },
            "rabbitmq": {"backend": "amqp"},
            "minio": {"backend": "s3", "endpoint": self.s3_endpoint,
                      "access_key": self.access_key,
                      "secret_key": self.secret_key},
            "services": {"rabbitmq": self.amqp_url},
            "journal": {
                "max_bytes": profile.journal_max_bytes,
                # retire peer-settled placeholders fast: the kill chaos
                # hands redeliveries to surviving workers on purpose
                "staged_probe_interval": 1.5,
            },
            "retry": {
                "default": {"attempts": 2, "base": 0.05, "cap": 0.25},
                "redelivery": {"base": 0.05, "cap": 0.5},
            },
            "fleet": {
                "enabled": True, "backend": "bucket",
                # short lease TTL: a killed lease-holder must not park
                # fan-in waiters for tens of seconds — takeover at
                # ttl*1.25 bounds the worst hot-key stall the p99
                # guards can see (the degraded profile shrinks it so a
                # SIGSTOP stall reliably overruns it)
                "lease_ttl": profile.lease_ttl,
                "heartbeat_interval": 1.0,
                "liveness_ttl": 4.0, "poll_interval": 0.2,
                "max_wait": 30.0,
                "gc_interval": profile.gc_interval,
                "telemetry_ttl": profile.telemetry_ttl,
                "shared_max_age": profile.shared_max_age,
                "shared_max_bytes": profile.shared_max_bytes,
            },
            "tenants": {
                "vip": {"weight": 4},
                "batch": {"weight": 1,
                          "max_concurrent": max(
                              profile.max_concurrent_jobs - 1, 1)},
            },
            "origins": {"manifest": {"min_poll": 0.1, "max_poll": 0.5,
                                     "stall_timeout": 15.0}},
        }
        if profile.retry:
            # the disk profile paces redelivery at disk-heal timescales
            for section, knobs in profile.retry.items():
                cfg["retry"].setdefault(section, {}).update(knobs)
        if profile.scrub:
            # the disk profile shrinks the scrub interval so repairs
            # land inside the run's bit-rot phase
            cfg["scrub"] = dict(profile.scrub)
        if profile.breakers:
            # the degraded profile arms the slow-call policy here
            cfg["breakers"] = dict(profile.breakers)
        if profile.slo:
            # fleet-overview tests tighten the objectives so brownout
            # latency visibly burns budget inside a short run
            cfg["slo"] = dict(profile.slo)
        os.makedirs(slot.config_dir, exist_ok=True)
        with open(os.path.join(slot.config_dir, "converter.yaml"), "w",
                  encoding="utf-8") as fh:
            yaml.safe_dump(cfg, fh)

    async def spawn(self, slot: WorkerSlot, fault_plan: str = "") -> None:
        slot.generation += 1
        slot.ready = False
        env = {key: value for key, value in os.environ.items()
               if key not in ("FAULT_PLAN", "PIPELINE_MODE", "CACHE_DIR",
                              "CACHE_ENABLED", "UPLOAD_CONCURRENCY",
                              "CONFIG_PATH", "PORT", "WORKER_ID")}
        env["CONFIG_PATH"] = slot.config_dir
        env["PORT"] = str(slot.health_port)
        env["WORKER_ID"] = slot.worker_id  # stable across generations
        if fault_plan:
            env["FAULT_PLAN"] = fault_plan
        log_path = os.path.join(
            slot.log_dir, f"worker-gen{slot.generation}.log")
        log = await asyncio.to_thread(_open_log, log_path)
        try:
            slot.proc = await asyncio.create_subprocess_exec(
                sys.executable, "-m", "downloader_tpu_torch",
                env=env, stdout=log, stderr=log, cwd=_repo_root(),
            )
        finally:
            log.close()
        await self._wait_ready(slot)

    async def _wait_ready(self, slot: WorkerSlot,
                          timeout: float = 30.0) -> None:
        async with asyncio.timeout(timeout):
            while True:
                if slot.proc.returncode is not None:
                    raise AssertionError(
                        f"worker {slot.worker_id} gen{slot.generation} "
                        f"exited {slot.proc.returncode} before ready "
                        f"(see {slot.log_dir})"
                    )
                try:
                    async with self._session.get(
                            self._url(slot, "/readyz")) as resp:
                        if resp.status == 200:
                            slot.ready = True
                            slot.ready_mono = time.monotonic()
                            return
                except aiohttp.ClientError:
                    pass
                await asyncio.sleep(0.1)

    def _url(self, slot: WorkerSlot, path: str) -> str:
        return f"http://127.0.0.1:{slot.health_port}{path}"

    async def kill_worker(self, slot: WorkerSlot) -> None:
        """True SIGKILL — no shutdown hooks, no journal flush."""
        slot.ready = False
        slot.proc.send_signal(signal.SIGKILL)
        await slot.proc.wait()
        self.kills_delivered += 1

    async def stall_worker(self, slot: WorkerSlot,
                           duration: float) -> None:
        """SIGSTOP the worker for ``duration`` seconds, then SIGCONT.

        A stalled worker is NOT a killed worker: its leases expire and
        peers take over (fence + 1) while its process state — in-flight
        transfers, held "leases", unacked deliveries — survives intact
        and resumes mid-takeover.  Exactly the GC-pause split-brain the
        fencing enforcement exists for.  ``ready`` is cleared for the
        stall window so the sampler doesn't tally the frozen process's
        unanswered scrapes as failures."""
        slot.ready = False
        slot.proc.send_signal(signal.SIGSTOP)
        self.stalls_delivered += 1
        try:
            await asyncio.sleep(duration)
        finally:
            slot.proc.send_signal(signal.SIGCONT)
            if slot.proc.returncode is None:
                slot.ready = True

    async def _stall_loop(self) -> None:
        profile = self.profile
        if profile.stalls <= 0 or profile.stall_duration <= 0:
            return
        stalls = 0
        while stalls < profile.stalls:
            await asyncio.sleep(profile.stall_interval)
            # stall workers from the TOP index down, away from worker 0
            # (the fault-plan host): the brownout and the stall must
            # degrade different workers or the scenario collapses into
            # one sick process
            slot = self.slots[len(self.slots) - 1
                              - (stalls % len(self.slots))]
            if not slot.alive:
                continue
            await self.stall_worker(slot, profile.stall_duration)
            stalls += 1

    async def stop_workers(self) -> None:
        """Clean TERM (deregister + journal close); KILL stragglers."""
        for slot in self.slots:
            # raw process check, not `alive`: a still-BOOTING worker
            # (ready not yet set) must be terminated too
            if slot.proc is not None and slot.proc.returncode is None:
                slot.proc.send_signal(signal.SIGTERM)
        for slot in self.slots:
            if slot.proc is None:
                continue
            try:
                async with asyncio.timeout(12):
                    await slot.proc.wait()
            except TimeoutError:
                slot.proc.send_signal(signal.SIGKILL)
                await slot.proc.wait()

    # -- workload -------------------------------------------------------
    async def publish_all(self, specs: List[JobSpec],
                          rate: float = 0.0) -> None:
        """Publish the schedule; ``rate`` > 0 paces arrivals open-loop
        (jobs/s) so long profiles measure service under load, not the
        drain time of one giant burst."""
        queue = AmqpQueue(self.amqp_url, heartbeat=10)
        await queue.connect()
        try:
            for index, spec in enumerate(specs):
                await queue.publish(schemas.DOWNLOAD_QUEUE,
                                    download_msg(spec))
                self.outcomes[spec.job_id] = JobOutcome(
                    spec, time.monotonic())
                if rate > 0 and index + 1 < len(specs):
                    await asyncio.sleep(1.0 / rate)
        finally:
            await queue.close()

    async def _check_marker(self, outcome: JobOutcome) -> None:
        try:
            await self.store.stat_object(
                self.bucket, done_marker_name(outcome.spec.job_id))
        except ObjectNotFound:
            return
        except Exception:
            return  # store blip: next pass decides
        now = time.monotonic()
        outcome.staged_mono = now
        outcome.resolved_mono = now
        outcome.terminal_state = "DONE"

    async def _poll_admin_terminal(self, outcome: JobOutcome) -> None:
        for slot in self.live_workers():
            try:
                async with self._session.get(self._url(
                        slot, f"/v1/jobs/{outcome.spec.job_id}")) as resp:
                    if resp.status != 200:
                        continue
                    body = await resp.json()
            except (aiohttp.ClientError, OSError):
                continue
            if body.get("state") in _TERMINAL_NO_MARKER:
                outcome.terminal_state = body["state"]
                outcome.resolved_mono = time.monotonic()
                return

    async def _completion_loop(self, deadline_mono: float,
                               expected: int) -> bool:
        """Poll until every one of ``expected`` jobs resolves (paced
        publishing means outcomes appear over time — an empty pending
        set only counts once the whole schedule has been published)."""
        tick = 0
        while time.monotonic() < deadline_mono:
            pending = [o for o in self.outcomes.values()
                       if o.resolved_mono is None]
            if not pending and len(self.outcomes) >= expected:
                return True
            for start in range(0, len(pending), 16):
                await asyncio.gather(*(
                    self._check_marker(o)
                    for o in pending[start:start + 16]))
            tick += 1
            if tick % 5 == 0:
                now = time.monotonic()
                for outcome in pending:
                    if (outcome.resolved_mono is None
                            and now - outcome.published_mono > 8.0):
                        await self._poll_admin_terminal(outcome)
            await asyncio.sleep(0.2)
        return (len(self.outcomes) >= expected
                and all(o.resolved_mono is not None
                        for o in self.outcomes.values()))

    async def _attribution_probe(self, specs: List[JobSpec]) -> None:
        """Run the probe jobs one at a time on the now-quiescent fleet.

        Sequential + fresh content + rate-limited origins = a stage
        wall that is genuinely attributable, the regime the hop-ledger
        reconciliation guard (≤ 10%) is defined over.  The mixed phase
        deliberately runs dozens of concurrent jobs whose wall clock is
        contention — reconciling THAT against per-job ledgers would
        punish the load the soak exists to create.
        """
        if not specs:
            return
        queue = AmqpQueue(self.amqp_url, heartbeat=10)
        await queue.connect()
        try:
            for spec in specs:
                await queue.publish(schemas.DOWNLOAD_QUEUE,
                                    download_msg(spec))
                outcome = JobOutcome(spec, time.monotonic())
                self.outcomes[spec.job_id] = outcome
                try:
                    async with asyncio.timeout(30):
                        while outcome.resolved_mono is None:
                            await self._check_marker(outcome)
                            if outcome.resolved_mono is None:
                                await asyncio.sleep(0.1)
                except TimeoutError:
                    # a hung probe must not abort the run with a bare
                    # traceback: the job stays unresolved and the
                    # unresolved_jobs guard fails WITH the rest of the
                    # report's attribution intact
                    continue
        finally:
            await queue.close()

    async def _chaos_loop(self, expected: int) -> None:
        profile = self.profile
        if profile.kill_interval <= 0 or profile.kills <= 0:
            return
        kills = 0
        while kills < profile.kills:
            await asyncio.sleep(profile.kill_interval)
            if self.resolved_jobs() >= expected:
                return  # workload already drained: chaos window over
            slot = self.slots[kills % len(self.slots)]
            if not slot.alive:
                continue
            await self.kill_worker(slot)
            kills += 1
            await asyncio.sleep(0.25)
            # same worker id: boot-time lease reclaim + journal replay
            await self.spawn(slot)

    # -- drain + census -------------------------------------------------
    async def drain_workers(self, grace: float = 10.0) -> None:
        for slot in self.live_workers():
            try:
                async with self._session.post(self._url(
                        slot, f"/v1/drain?grace={grace}")) as resp:
                    await resp.read()
            except (aiohttp.ClientError, OSError):
                continue

    async def live_leases(self) -> List[str]:
        """Lease keys whose coordination doc is LIVE (tombstoned and
        expired docs resolve to None, like real readers see them)."""
        coord = BucketCoordStore(self.store, self.bucket)
        out = []
        async for info in self.store.list_objects(self.bucket,
                                                  ".fleet/leases/"):
            key = info.name[len(".fleet/"):]
            if await coord.get(key) is not None:
                out.append(info.name)
        return out

    async def live_coord_census(self) -> Dict[str, int]:
        """LIVE docs per prefix (tombstones resolved away) — the drain
        census: what the fleet GC is accountable for leaving behind."""
        coord = BucketCoordStore(self.store, self.bucket)
        out = {"workers": 0, "leases": 0, "telemetry": 0}
        for prefix in out:
            for key in await coord.list_keys(prefix + "/"):
                try:
                    if await coord.get(key) is not None:
                        out[prefix] += 1
                except Exception:
                    continue
        return out

    async def collect_records(self) -> List[dict]:
        """Merged ``GET /v1/jobs`` across live workers: per job, prefer
        the DONE record (the settle that counts), else the latest."""
        merged: Dict[str, dict] = {}
        for slot in self.live_workers():
            try:
                async with self._session.get(
                        self._url(slot, "/v1/jobs")) as resp:
                    if resp.status != 200:
                        continue
                    body = await resp.json()
            except (aiohttp.ClientError, OSError):
                continue
            for record in body.get("jobs", []):
                job_id = record.get("id")
                if not job_id:
                    continue
                prior = merged.get(job_id)
                if prior is None or (record.get("state") == "DONE"
                                     and prior.get("state") != "DONE"):
                    merged[job_id] = record
        return list(merged.values())

    def _orphan_workdirs(self, slot: WorkerSlot) -> List[str]:
        try:
            entries = os.listdir(slot.downloads)
        except OSError:
            return []
        return sorted(
            entry for entry in entries
            if not entry.startswith(".")
            and os.path.isdir(os.path.join(slot.downloads, entry)))

    async def verify_staged_bytes(self) -> List[str]:
        """Byte-identity of every DONE job's staged set against what
        its origin served — kills or not, a staged byte is exact."""
        mismatches: List[str] = []
        for outcome in self.outcomes.values():
            if outcome.terminal_state != "DONE":
                continue
            for basename, payload in outcome.spec.origin.files:
                name = object_name(outcome.spec.job_id, basename)
                try:
                    staged = await self.store.get_object(
                        self.bucket, name)
                except Exception:
                    mismatches.append(
                        f"{outcome.spec.job_id}:{basename}:missing")
                    continue
                if staged != payload:
                    mismatches.append(
                        f"{outcome.spec.job_id}:{basename}:diverged")
        return mismatches

    # -- the bit-rot phase (disk profile) -------------------------------
    async def scrub_totals(self) -> Dict[str, int]:
        """Fleet-summed scrubber verdict counters, read from each live
        worker's own SLO digest (``local.digest.scrub`` on the fleet
        overview endpoint — no aggregation TTL in the way)."""
        totals = {"passes": 0, "clean": 0, "repaired": 0,
                  "quarantined": 0}
        for slot in self.live_workers():
            try:
                async with self._session.get(self._url(
                        slot, "/v1/fleet/overview")) as resp:
                    if resp.status != 200:
                        continue
                    body = await resp.json()
            except (aiohttp.ClientError, OSError):
                continue
            snap = (((body.get("local") or {}).get("digest") or {})
                    .get("scrub") or {})
            for key in totals:
                totals[key] += int(snap.get(key) or 0)
        return totals

    def _cache_entry_files(self, slot: WorkerSlot) -> List[tuple]:
        """(key, path) for every payload file in this worker's cache."""
        entries_dir = os.path.join(slot.cache_dir, "entries")
        out: List[tuple] = []
        try:
            keys = sorted(os.listdir(entries_dir))
        except OSError:
            return out
        for key in keys:
            key_dir = os.path.join(entries_dir, key)
            for dirpath, _dirnames, filenames in os.walk(key_dir):
                for name in sorted(filenames):
                    if name.startswith("."):
                        continue  # .meta.json / transient temps
                    out.append((key, os.path.join(dirpath, name)))
        return out

    async def _repairable_keys(self) -> set:
        """Cache keys whose shared-tier manifest is live — the set the
        scrubber can repair (not just quarantine)."""
        keys = set()
        async for info in self.store.list_objects(self.bucket,
                                                  ".fleet-cache/"):
            rest = info.name[len(".fleet-cache/"):]
            if rest.endswith("/manifest.json"):
                keys.add(rest[: -len("/manifest.json")])
        return keys

    async def seed_bitrot(self, count: int) -> List[str]:
        """Flip one byte in up to ``count`` cache-entry files whose key
        has a live shared-tier replica.  Returns the corrupted paths —
        the oracle the ``scrub_repaired == seeded`` guard compares
        against."""
        repairable = await self._repairable_keys()
        seeded: List[str] = []
        for slot in self.slots:
            for key, path in await asyncio.to_thread(
                    self._cache_entry_files, slot):
                if len(seeded) >= count:
                    return seeded
                if key not in repairable:
                    continue
                try:
                    await asyncio.to_thread(_flip_byte, path)
                except OSError:
                    continue
                seeded.append(path)
        return seeded

    async def _bitrot_phase(self) -> None:
        """Seed bit-rot on the drained fleet, then hold it up until the
        scrubber has accounted for every seed (repair or quarantine —
        the guard that they were all *repairs* is the bench's)."""
        profile = self.profile
        if profile.corrupt_files <= 0:
            return
        self.scrub_base = await self.scrub_totals()
        self.seeded_corruptions = await self.seed_bitrot(
            profile.corrupt_files)
        deadline = time.monotonic() + profile.scrub_wall
        while True:
            self.scrub_final = await self.scrub_totals()
            found = ((self.scrub_final["repaired"]
                      - self.scrub_base["repaired"])
                     + (self.scrub_final["quarantined"]
                        - self.scrub_base["quarantined"]))
            if found >= len(self.seeded_corruptions):
                return
            if time.monotonic() >= deadline:
                return  # the bench guard reports the shortfall
            await asyncio.sleep(0.3)

    async def collect_world(self, scrape_failures: int) -> SoakWorld:
        world = SoakWorld(scrape_failures=scrape_failures,
                          kills_delivered=self.kills_delivered,
                          stalls_delivered=self.stalls_delivered)
        world.leaked_leases = await self.live_leases()
        world.coord_live = await self.live_coord_census()
        world.records = await self.collect_records()
        await self.stop_workers()
        settled: set = set()
        live: set = set()
        for slot in self.slots:
            state = await asyncio.to_thread(replay, slot.journal_path)
            try:
                world.journal_final_bytes[slot.index] = os.path.getsize(
                    slot.journal_path)
            except OSError:
                world.journal_final_bytes[slot.index] = 0
            for job_id, job in state.jobs.items():
                if job.settle == "ack":
                    settled.add(job_id)
                elif job.redelivery_expected:
                    live.add(job_id)
            world.orphan_workdirs[slot.index] = await asyncio.to_thread(
                self._orphan_workdirs, slot)
        world.unsettled_journal_jobs = sorted(live - settled)
        world.byte_mismatches = await self.verify_staged_bytes()
        return world

    # -- the run --------------------------------------------------------
    async def run(self, workload: SoakWorkload) -> SoakReport:
        profile = self.profile
        self._session = aiohttp.ClientSession(
            timeout=aiohttp.ClientTimeout(total=5.0))
        sampler = GrowthSampler(self, interval=profile.sample_interval)
        stop_sampling = asyncio.Event()
        chaos_task = None
        sampler_task = None
        try:
            for slot in self.slots:
                await asyncio.to_thread(self.write_config, slot)
                await self.spawn(
                    slot,
                    fault_plan=(profile.fault_plan
                                if slot.index == 0 else ""))
            async with sampler:
                sampler_task = asyncio.get_running_loop().create_task(
                    sampler.run(stop_sampling))
                expected = len(workload.specs)
                publisher = asyncio.get_running_loop().create_task(
                    self.publish_all(workload.specs,
                                     rate=profile.publish_rate))
                chaos_task = asyncio.get_running_loop().create_task(
                    self._chaos_loop(expected))
                stall_task = asyncio.get_running_loop().create_task(
                    self._stall_loop())
                deadline = time.monotonic() + profile.max_wall
                try:
                    await self._completion_loop(deadline, expected)
                finally:
                    for task in (chaos_task, stall_task, publisher):
                        task.cancel()
                        try:
                            await task
                        except asyncio.CancelledError:
                            pass
                    # a stall window interrupted mid-cancel must not
                    # leave a worker frozen into the census
                    if profile.stalls > 0:
                        for slot in self.slots:
                            if (slot.proc is not None
                                    and slot.proc.returncode is None
                                    and not slot.ready):
                                slot.proc.send_signal(signal.SIGCONT)
                                slot.ready = True
                # quiescent-fleet attribution probe (the hop-ledger
                # reconciliation guard's measurement set)
                await self._attribution_probe(workload.probe_specs)
                # disk profile: seed bit-rot between phases and hold
                # the fleet up until the scrubber accounts for it
                await self._bitrot_phase()
                # let the elected sweeper age out telemetry digests and
                # shared-tier entries before the final census
                await asyncio.sleep(
                    max(profile.telemetry_ttl,
                        2 * profile.gc_interval) + 0.5)
                # incident bundles: pull every worker's
                # auto-exported ring while the admin APIs still answer
                self.incidents = await collect_incidents(
                    [self._url(slot, "") for slot in self.live_workers()])
                await self.drain_workers()
                await sampler.sample_once()
                world = await self.collect_world(sampler.scrape_failures)
                self.world = world
                stop_sampling.set()
                await sampler_task
                sampler_task = None
            self.samples = sampler.samples
            report = evaluate(profile, list(self.outcomes.values()),
                              sampler.samples, world)
            report.stats["wall_s"] = round(
                sampler.samples[-1].t_mono - sampler.samples[0].t_mono,
                3) if sampler.samples else 0.0
            return report
        finally:
            if chaos_task is not None and not chaos_task.done():
                chaos_task.cancel()
            if sampler_task is not None and not sampler_task.done():
                stop_sampling.set()
                try:
                    await sampler_task
                except Exception:
                    # unwind path: the sampler's closed-session noise
                    # must never mask the exception that got us here
                    pass
            await self.stop_workers()
            if self._session is not None:
                await self._session.close()
                self._session = None

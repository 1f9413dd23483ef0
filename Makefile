# Build/test entry points (reference Makefile renders CI config,
# /root/reference/Makefile:1-7; here make drives the whole dev loop).

.PHONY: test bench bench-overlap bench-fleet bench-fairness bench-crash bench-obs bench-racing bench-soak bench-degraded bench-disk bench-slo bench-zerocopy bench-multichip bench-incident compute-shard chaos crash degraded disk fleet fleet-v2 incident fuzz-scenarios obs origins scrub slo soak soak-smoke soak-full proto lint run docker integration

# hermetic gate: never touches localhost services, even when something
# happens to be listening on 5672/9000
test:
	python -m pytest tests/ -x -q -m "not integration and not slow"

# opt-in: real RabbitMQ + MinIO (docker compose up -d --wait first);
# the tests auto-skip when the services are unreachable
integration:
	python -m pytest tests/ -m integration -v

# fault-injection chaos suite: the taxonomy/retry/breaker layer proven
# against deterministic store/publish/http/tracker/disk failures
chaos:
	python -m pytest tests/test_faults.py -v

# kill-based crash-chaos suite: a real worker subprocess SIGKILLed at
# chosen seams (mid-download, mid-upload, pre-ack, lease-holder) and
# restarted; asserts DONE exactly once, staged bytes hash-identical,
# no orphan workdirs/leases, retry counters monotone across the kill
crash:
	python -m pytest tests/test_crash.py tests/test_journal.py -v

# degraded-world chaos suite (ISSUE 14): windowed brownout/partition/
# flap fault kinds, the slow-call breaker policy (a latency-only store
# brownout must open the breaker with reason "slow" and shed via
# park-then-nack), asymmetric-partition degradation + GC stand-down,
# split-brain fencing at every cross-worker write (a stalled leader
# resumed mid-takeover must lose), the fleet.max_wait aging fix, and
# the degraded soak scenario (SIGSTOP stall past the lease TTL against
# a real 2-worker subprocess fleet)
degraded:
	python -m pytest tests/test_degraded.py -v

# storage fault plane suite (ISSUE 20): the disk fault kind + VFS shim
# (ENOSPC/EIO/short/latency/torn at the landing, spill, promote and
# sidecar seams), fsync-before-rename crash consistency + boot-time
# torn-tail demotion, the background scrubber (clean/repair/quarantine,
# copy-on-repair fresh inodes for hardlinked entries), and disk-full
# graceful degradation (workdir free-space admission floors, the disk
# breaker force-open, BULK shed via cache_headroom_bytes)
disk:
	python -m pytest tests/test_disk.py -v

# one full scrub pass over the local store, from the CLI (point
# DOWNLOADER_CONFIG at the instance config first; repairs pull from the
# shared tier, mismatches without a healthy replica are quarantined)
scrub:
	python -m downloader_tpu.cli scrub

# multi-worker fleet suite: coordination-store semantics, N-orchestrator
# coalescing over MiniS3, lease takeover, coord-store chaos
fleet:
	python -m pytest tests/test_fleet.py -v

# fleet data plane v2 suite (ISSUE 17): conditional-put CAS backend +
# watch/subscribe (event vs poll equivalence, brownout degradation),
# the content router decision table, the elected placement/autoscale
# controller (decision-table units + CAS-published plan), the shared
# origin-health table cold-start win, and the 3-worker same-content
# routing acceptance rig
fleet-v2:
	python -m pytest tests/test_fleet_v2.py -v

# observability suite: flight recorder + runtime introspection
# (test_obs) plus the fleet-wide trace/RED/hop-ledger layer
# (test_trace: 3-worker trace assembly, degraded-mode local-only view,
# RED histogram seams, hop-ledger attribution)
obs:
	python -m pytest tests/test_obs.py tests/test_trace.py -v

# origin-plane suite: multi-origin racing fetch (work-stealing ranges,
# per-origin breakers, straggler duplication, failover) + HLS-style
# segment-manifest ingest (live polling, VOD fast path, live window,
# overlap acceptance through the full orchestrator)
origins:
	python -m pytest tests/test_origins.py -v

# sustained-load soak suite (downloader_tpu/soak, ISSUE 13): a real
# multi-worker subprocess fleet under the full mixed workload (fan-in +
# racing + manifest + BULK deadlines) with SIGKILL chaos, held to hard
# SLO guards — p99 time-to-staged per class, bounded journal/coord/
# cache/RSS growth, zero leaked leases or orphan workdirs at drain,
# hop-ledger reconciliation.  `soak` runs the slow capacity profile
# (300 jobs, 3 workers, 3 kills); `soak-smoke` is the <60 s tier-1
# profile plus the harness's own unit tests.  Resize either with the
# soak.* knobs (docs/OPERATIONS.md "Capacity & SLOs").
soak:
	python -m pytest tests/test_soak.py -v -m slow

soak-smoke:
	python -m pytest tests/test_soak.py -v -m "not slow"

# the full 100k-job capacity profile (ROADMAP item 5's standing entry
# point): the same test_soak_full guards, resized via the SOAK_* env
# knobs — hours of wall clock, opt-in before capacity-sensitive
# releases, deliberately NOT a CI job (docs/OPERATIONS.md
# "Capacity & SLOs")
soak-full:
	SOAK_JOBS=100000 SOAK_WORKERS=3 SOAK_PUBLISH_RATE=60 \
	SOAK_MAX_WALL=7200 SOAK_KILLS=20 SOAK_KILL_INTERVAL=120 \
	python -m pytest tests/test_soak.py::test_soak_full -v -m slow

# incident plane suite (ISSUE 18): bundle-schema freeze (fields never
# renumbered/retyped; the checked-in v1 fixture must keep loading and
# compiling), compile_bundle purity + window re-anchoring (no sleeps,
# per the window_active/flap_on discipline), breach-signature diffing,
# the auto-export ring, the /v1/incidents degradation contract, and
# the fuzzer's determinism
incident:
	python -m pytest tests/test_incident.py -v

# seeded incident-scenario fuzzer (ISSUE 18 stretch): mutates the
# fixture bundle's compiled plan (shift windows, swap fault kinds,
# scale job counts) and replays each variant on a fresh SoakRig fleet
# hunting for NEW breach signatures — minutes per variant, opt-in,
# deliberately NOT a CI job (like soak-full).  Re-run any campaign
# with the same --seed to reproduce it; drop --execute (edit below)
# to just print the bred variants.
fuzz-scenarios:
	python -m downloader_tpu.incident.fuzz --seed 1818 --variants 4 --execute

# SLO plane suite (ISSUE 15): burn-rate/budget math against
# hand-computed windows, settle classification, the /readyz slo block,
# heartbeat digests + the aggregated fleet overview (mixed-shape
# compat, brownout-bounded peer/coord queries, degradation contract),
# per-hop budget guard, and the 3-worker fleet-overview acceptance run
slo:
	python -m pytest tests/test_slo.py tests/test_overview.py -v

# sharded compute plane suite (ISSUE 16): the pjit/shard_map chooser
# (decisions pinned per (shape, mesh)), the regex->PartitionSpec table
# (every upscaler param matches exactly one rule, unmatched raises),
# buffer donation, the double-buffered TransferQueue, hop billing, and
# the mesh-reshape parity tests ({'data':4,'model':2} vs
# {'data':2,'model':4} produce identical losses and updated params)
compute-shard:
	python -m pytest tests/test_compute_shard.py tests/test_multichip.py -v

# graftlint (downloader_tpu/analysis, docs/ANALYSIS.md): the repo-
# invariant static analyzer over the full tree (JSON for CI parsing),
# then the tier-1 gate (zero unsuppressed findings + <10 s budget +
# registry fixtures); then the port's own gate (downloader_tpu_torch/
# analysis over the port's package, its tests and chip_smoke.py)
lint:
	python -m downloader_tpu.analysis --json
	python -m pytest tests/test_lint.py tests/test_analysis.py -q
	python -m downloader_tpu_torch.analysis --json
	python -m pytest tests/test_torch_lint.py tests/test_torch_analysis.py -q

bench:
	python bench.py

# standalone streaming-vs-barrier stage-overlap bench (one JSON line:
# stage_overlap_speedup must stay >= 1.25, time_to_staged_ms alongside)
bench-overlap:
	python bench.py --overlap

# standalone fleet-coordination bench (one JSON line: M workers x same
# hot content, fleet_origin_bytes_ratio must stay >= 2.0; plus the v22
# weak-scaling arm — fleet_scaling_ratio, 1 -> 3 worker throughput on
# a same-content-heavy workload, must stay >= 0.8x linear)
bench-fleet:
	python bench.py --fleet

# standalone multi-tenant fairness bench (one JSON line: a saturating
# BULK tenant must not degrade a HIGH tenant's p99 time-to-staged by
# more than 1.25x vs the idle-worker baseline)
bench-fairness:
	python bench.py --fairness

# standalone crash-durability bench (one JSON line: journal_overhead_ms
# must stay < 1 ms/job; restart_recovery_ms = SIGKILL -> restart ->
# recovered job DONE through a real worker subprocess)
bench-crash:
	python bench.py --crash

# standalone fleet-observability bench (one JSON line: hop-ledger and
# trace-propagation A-B overheads must each stay < 1 ms/job;
# hop_ledger_coverage = summed hop seconds / stage wall on a real
# end-to-end job, must stay within 5% of 1.0)
bench-obs:
	python bench.py --obs

# standalone origin-plane racing bench (one JSON line: with one fast +
# one throttled mirror, racing must beat the slow origin alone by
# >= 1.5x AND stay within 10% of the fast origin alone)
bench-racing:
	python bench.py --racing

# standalone sustained-load soak bench (one JSON line: soak_ok = every
# SLO guard green over the mixed-workload + kill-chaos run; soak_p99_ms,
# soak_rss_slope_mb_per_kjob, soak_journal_peak_bytes alongside)
bench-soak:
	python bench.py --soak

# standalone degraded-world soak bench (one JSON line: degraded_ok =
# every SLO guard green under the stall + brownout scenario;
# brownout_shed_ms = brownout onset -> slow-opened breaker;
# split_brain_stale_writes must stay 0)
bench-degraded:
	python bench.py --degraded

# standalone storage-fault-plane bench (one JSON line: disk_ok = every
# SLO guard green under the windowed ENOSPC brownout — including zero
# corrupt bytes served — AND the scrubber repaired every seeded bit-rot
# flip with zero quarantines; disk_scrub_repaired /
# disk_scrub_quarantined / disk_corrupt_bytes_served alongside)
bench-disk:
	python bench.py --disk

# standalone SLO-plane bench (one JSON line: slo_overhead_ms must stay
# < 1 ms/job; fleet_overview_age_s must sit under 2x the heartbeat
# interval in steady state; hop_budget_ok = every hop inside its
# BASELINE_HOPS.json budget, failures name the guilty hop)
bench-slo:
	python bench.py --slo

# standalone zero-copy staging A/B (one JSON line:
# zerocopy_cpu_ratio = buffered-path CPU per staged GB / zero-copy-path
# CPU per staged GB on the same calibration job — > 1.0 means the
# mmap/sendfile upload path is cheaper per byte; a ratio sliding to
# 1.0 flags a quietly re-introduced buffered copy)
bench-zerocopy:
	python bench.py --zerocopy

# standalone incident round-trip bench (one JSON line:
# incident_replay_signature_match = a degraded-world breach bundle,
# compiled and replayed on 2 consecutive fresh fleets, reproduced its
# breach signature with zero stale split-brain writes — the ISSUE 18
# acceptance guard)
bench-incident:
	python bench.py --incident

# standalone sharded-compute bench (one JSON line:
# multichip_scaling_efficiency = single-device wall / data=4-sharded
# wall for the same total batch on the dry-run mesh, must stay >= 0.8
# — virtual devices share one CPU, so this bounds sharding OVERHEAD)
bench-multichip:
	python bench.py --multichip

# regenerate protobuf gencode (no protoc in the image: the script
# applies the declarative edits in scripts/gen_proto.py to the current
# serialized descriptor and re-emits downloader_pb2.py; keep
# downloader.proto in sync by hand).  tests/test_schemas.py guards
# against the committed module drifting from this output.
proto:
	python scripts/gen_proto.py

run:
	python -m downloader_tpu

docker:
	docker build -t downloader-tpu .

"""The port's graftlint checker fixtures: one true-positive and one
compliant negative per rule, plus the suppression-syntax contract.

These are tests/test_analysis.py's fixtures run against the port's
registry (``downloader_tpu_torch.analysis``), held to them definition by
definition by tests/test_torch_service_copies.py; the fixture path
``LIB`` lies in the port's package, so its repo-scope rules see the
fixtures.  tests/test_torch_lint.py is the tier-1 gate that runs the
registry over the port's tree; THIS file proves each checker actually
fires on the defect it encodes and stays quiet on compliant code.  The
tests after the fixtures hold the two registries against each other.
"""

import os
import re
import shutil
import textwrap

from downloader_tpu import analysis as reference
from downloader_tpu_torch import analysis
from downloader_tpu_torch.analysis import (
    ModuleSource,
    RepoContext,
    all_rules,
    analyze_module,
    analyze_repo,
    apply_suppressions,
)
from downloader_tpu_torch.analysis.core import MODULE_RULES, REPO_RULES

LIB = "downloader_tpu_torch/fixture_mod.py"   # library profile


def module(source, path=LIB):
    return ModuleSource(path, textwrap.dedent(source))


def run_rule(source, rule, path=LIB):
    return [f for f in analyze_module(module(source, path), rules=[rule])
            if f.rule == rule]


def repo_ctx(sources=None, operations="", proto="", architecture=""):
    modules = [module(src, path) for path, src in (sources or {}).items()]
    return RepoContext(modules, operations_md=operations,
                       proto_text=proto, architecture_md=architecture)


def run_repo_rule(rule, **kwargs):
    return [f for f in analyze_repo(repo_ctx(**kwargs), rules=[rule])
            if f.rule == rule]


# ---------------------------------------------------------------------------
# registry sanity
# ---------------------------------------------------------------------------

def test_all_semantic_checkers_registered():
    ids = {rule.id for rule in all_rules()}
    # the 8 repo-semantic checkers
    assert {"ack-settle-atomicity", "unbounded-timeout",
            "blocking-call-in-async", "swallowed-cancellation",
            "knob-drift", "metric-drift", "seam-coverage",
            "proto-freeze"} <= ids
    # the folded eslint-parity rules
    assert {"tabs", "unused-import", "bare-except", "print-in-library",
            "mutable-default", "empty-fstring", "literal-comparison",
            "raise-notimplemented", "redefinition",
            "discarded-task"} <= ids
    assert not (set(MODULE_RULES) & set(REPO_RULES))


# ---------------------------------------------------------------------------
# ack-settle atomicity
# ---------------------------------------------------------------------------

ACK_BAD = """
    async def settle(delivery, registry, record, telemetry):
        await delivery.ack()
        await telemetry.emit_status(record.job_id)
        registry.transition(record, "DONE")
"""

ACK_GOOD = """
    async def settle(delivery, registry, record, telemetry):
        await delivery.ack()
        registry.transition(record, "DONE")
        await telemetry.emit_status(record.job_id)
"""

ACK_BRANCH_RETURNS = """
    async def settle(delivery, registry, record, flaky):
        if flaky:
            await delivery.nack()
            return
        await cleanup()
        registry.transition(record, "DONE")
"""


def test_ack_settle_flags_await_between_ack_and_transition():
    found = run_rule(ACK_BAD, "ack-settle-atomicity")
    assert len(found) == 1
    assert "registry.transition" in found[0].message


def test_ack_settle_accepts_transition_first():
    assert run_rule(ACK_GOOD, "ack-settle-atomicity") == []


def test_ack_settle_ignores_settling_branch_that_returns():
    # a nack in a branch that returns never flows into the outer
    # block's later transition — must not be flagged
    assert run_rule(ACK_BRANCH_RETURNS, "ack-settle-atomicity") == []


def test_ack_settle_ignores_mutually_exclusive_branches():
    # an await in one branch must not count against a transition in
    # its SIBLING branch — no execution path awaits before settling
    good = """
        async def settle(delivery, registry, record, errored):
            await delivery.ack()
            if errored:
                await emit_error(record)
            else:
                registry.transition(record, "DONE")
    """
    assert run_rule(good, "ack-settle-atomicity") == []
    # ...while an await SEQUENTIALLY before the transition in the SAME
    # branch is still caught
    bad = """
        async def settle(delivery, registry, record, errored):
            await delivery.ack()
            if errored:
                await emit_error(record)
                registry.transition(record, "FAILED")
    """
    assert len(run_rule(bad, "ack-settle-atomicity")) == 1


def test_ack_settle_ignores_nested_function_definitions():
    # defining a closure between ack and transition executes nothing —
    # its body must not leak awaits (or transitions) into the scan
    good = """
        async def settle(delivery, registry, record):
            await delivery.ack()

            async def _notify():
                await emit(record)

            registry.transition(record, "DONE")
            return _notify
    """
    assert run_rule(good, "ack-settle-atomicity") == []


def test_ack_settle_sees_await_inside_the_transition_statement():
    # argument evaluation precedes the call: this await resolves in the
    # limbo window even though it shares the transition's statement
    bad = """
        async def settle(delivery, registry, record):
            await delivery.ack()
            registry.transition(record, await final_state(record))
    """
    assert len(run_rule(bad, "ack-settle-atomicity")) == 1
    # ...but an await AFTER the transition inside the same compound
    # statement is the blessed pattern (transition, then cleanup)
    good = """
        async def settle(delivery, registry, record, cond):
            await delivery.ack()
            if cond:
                registry.transition(record, "DONE")
                await cleanup(record)
    """
    assert run_rule(good, "ack-settle-atomicity") == []


# ---------------------------------------------------------------------------
# unbounded timeout
# ---------------------------------------------------------------------------

def test_unbounded_timeout_flags_none():
    bad = """
        async def probe(session, url):
            async with session.get(url, timeout=None) as resp:
                return resp.status
    """
    assert len(run_rule(bad, "unbounded-timeout")) == 1
    bad_ct = """
        def build():
            return aiohttp.ClientTimeout(total=None)
    """
    assert len(run_rule(bad_ct, "unbounded-timeout")) == 1


def test_unbounded_timeout_accepts_bounded_and_default():
    good = """
        async def probe(session, url):
            async with session.get(
                url, timeout=aiohttp.ClientTimeout(total=10)
            ) as resp:
                return resp.status

        async def inherit(session, url):
            async with session.get(url) as resp:  # session default
                return resp.status
    """
    assert run_rule(good, "unbounded-timeout") == []


# ---------------------------------------------------------------------------
# blocking call in async
# ---------------------------------------------------------------------------

def test_blocking_call_flags_sync_io_on_the_loop():
    bad = """
        async def stage(path):
            time.sleep(1)
            with open(path) as fh:
                return json.load(fh)
    """
    rules = run_rule(bad, "blocking-call-in-async")
    assert len(rules) == 3  # sleep, open, json.load


def test_blocking_call_accepts_offloaded_and_sync_helpers():
    good = """
        async def stage(path):
            return await asyncio.to_thread(_read, path)

        def _read(path):
            with open(path) as fh:   # sync helper: runs on the thread
                return json.load(fh)
    """
    assert run_rule(good, "blocking-call-in-async") == []


def test_blocking_call_exempts_non_library_profiles():
    bad = """
        async def drive():
            time.sleep(1)
    """
    assert run_rule(bad, "blocking-call-in-async",
                    path="tests/fixture_test.py") == []
    assert run_rule(bad, "blocking-call-in-async",
                    path="bench.py") == []


# ---------------------------------------------------------------------------
# swallowed cancellation
# ---------------------------------------------------------------------------

def test_swallowed_cancellation_flags_base_exception_sink():
    bad = """
        async def join(fut):
            try:
                await fut
            except BaseException:
                pass
    """
    assert len(run_rule(bad, "swallowed-cancellation")) == 1


def test_swallowed_cancellation_accepts_reraise_and_narrow_catch():
    good = """
        async def join(fut):
            try:
                await fut
            except BaseException:
                cleanup()
                raise
            try:
                await fut
            except Exception:   # CancelledError is BaseException-only
                pass
    """
    assert run_rule(good, "swallowed-cancellation") == []


# ---------------------------------------------------------------------------
# knob drift
# ---------------------------------------------------------------------------

KNOB_MOD = """
    from ..platform.config import cfg_get

    def read(config):
        return cfg_get(config, "journal.fancy_knob", 1)
"""


def test_knob_drift_flags_undocumented_read():
    found = run_repo_rule("knob-drift", sources={LIB: KNOB_MOD},
                          operations="# Operations\n\nnothing here\n")
    assert len(found) == 1 and "journal.fancy_knob" in found[0].message


def test_knob_drift_accepts_documented_read():
    docs = "## Config\n\nset `journal.fancy_knob` to taste\n"
    assert run_repo_rule("knob-drift", sources={LIB: KNOB_MOD},
                         operations=docs) == []


def test_knob_drift_flags_dead_documented_knob():
    docs = "## Config\n\n```yaml\njournal:\n  ghost_knob: 5\n```\n"
    found = run_repo_rule("knob-drift", sources={LIB: "x = 1\n"},
                          operations=docs)
    assert len(found) == 1
    assert "journal.ghost_knob" in found[0].message
    assert found[0].path == "docs/OPERATIONS.md"


def test_knob_drift_dead_check_sees_cfg_get_and_attr_reads():
    docs = ("## Config\n\n```yaml\njournal:\n  ghost_knob: 5\n"
            "instance:\n  download_path: /x\n```\n")
    mod = """
        from ..platform.config import cfg_get

        def read(config):
            path = config.instance.download_path
            return cfg_get(config, "journal.ghost_knob"), path
    """
    assert run_repo_rule("knob-drift", sources={LIB: mod},
                         operations=docs) == []


def test_knob_drift_sees_config_read_nested_in_wider_expression():
    # wrap(config.journal.ghost_knob).value: the inner chain is a real
    # read even though it sits inside a larger attribute expression
    docs = "## Config\n\n```yaml\njournal:\n  ghost_knob: 5\n```\n"
    mod = """
        def read(config):
            return wrap(config.journal.ghost_knob).value
    """
    assert run_repo_rule("knob-drift", sources={LIB: mod},
                         operations=docs) == []


def test_knob_drift_bare_section_attribute_is_not_a_read():
    # self.journal / ctx.store style attributes must not blanket-mark
    # their section as live — that made the dead-knob check vacuous
    docs = "## Config\n\n```yaml\njournal:\n  ghost_knob: 5\n```\n"
    mod = """
        class Worker:
            def poke(self):
                return self.journal.append("x")
    """
    found = run_repo_rule("knob-drift", sources={LIB: mod},
                          operations=docs)
    assert len(found) == 1 and "journal.ghost_knob" in found[0].message


# ---------------------------------------------------------------------------
# metric drift
# ---------------------------------------------------------------------------

METRIC_MOD = """
    from prometheus_client import Counter

    def build(ns, registry):
        return Counter(f"{ns}_widgets_total", "widgets", ["tenant"],
                       registry=registry)
"""


def test_metric_drift_flags_missing_catalog_row():
    docs = "## Metrics catalog\n\n| none |\n\n## Next\n"
    found = run_repo_rule("metric-drift", sources={LIB: METRIC_MOD},
                          operations=docs)
    assert len(found) == 1 and "widgets_total" in found[0].message


def test_metric_drift_accepts_cataloged_metric():
    docs = ("## Metrics catalog\n\n| `widgets_total` | counter | w |\n\n"
            "## Next\n")
    assert run_repo_rule("metric-drift", sources={LIB: METRIC_MOD},
                         operations=docs) == []


def test_metric_drift_rejects_substring_catalog_rides():
    # "widgets" must not pass on the strength of a `widgets_total` row
    docs = ("## Metrics catalog\n\n| `widgets_total` | counter | w |\n\n"
            "## Next\n")
    mod = METRIC_MOD.replace("_widgets_total", "_widgets")
    found = run_repo_rule("metric-drift", sources={LIB: mod},
                          operations=docs)
    assert len(found) == 1 and '"widgets"' in found[0].message


def test_metric_drift_reads_catalog_as_last_doc_section():
    # the catalog must still parse when it is the FINAL ## section
    docs = "## Other\n\nx\n\n## Metrics catalog\n\n| `widgets_total` | c |\n"
    assert run_repo_rule("metric-drift", sources={LIB: METRIC_MOD},
                         operations=docs) == []


def test_metric_drift_flags_unbounded_label():
    docs = ("## Metrics catalog\n\n| `widgets_total{user_id}` | c | w |\n\n"
            "## Next\n")
    mod = METRIC_MOD.replace('["tenant"]', '["user_id"]')
    found = run_repo_rule("metric-drift", sources={LIB: mod},
                          operations=docs)
    assert len(found) == 1 and "user_id" in found[0].message


# ---------------------------------------------------------------------------
# seam coverage
# ---------------------------------------------------------------------------

SEAM_DOCS = "## Failure model\n\nretry.store covers the store seams\n"


def test_seam_coverage_flags_unknown_family():
    mod = """
        async def put(self, fn):
            return await self.retrier.run("zorp.put", fn)
    """
    found = run_repo_rule("seam-coverage", sources={LIB: mod},
                          operations=SEAM_DOCS)
    assert any("zorp" in f.message for f in found)


def test_seam_coverage_flags_seam_without_fault_hook():
    mod = """
        async def put(self, fn):
            return await self.retrier.run("store.put", fn)
    """
    found = run_repo_rule("seam-coverage", sources={LIB: mod},
                          operations=SEAM_DOCS)
    assert len(found) == 1 and "faults.fire" in found[0].message


def test_seam_coverage_accepts_drillable_documented_seam():
    mod = """
        from ..platform import faults

        async def put(self, fn):
            if faults.enabled():
                await faults.fire("store.put", key="k")
            return await self.retrier.run("store.put", fn)
    """
    assert run_repo_rule("seam-coverage", sources={LIB: mod},
                         operations=SEAM_DOCS) == []


def test_seam_coverage_sees_renamed_retrier_receivers():
    # self._retrier / probe_retrier must not blind the rule
    mod = """
        async def put(self, fn):
            return await self._retrier.run("zorp.put", fn)
    """
    found = run_repo_rule("seam-coverage", sources={LIB: mod},
                          operations=SEAM_DOCS)
    assert any("zorp" in f.message for f in found)


def test_seam_coverage_flags_sync_only_family_for_windowed_kinds():
    # a family drillable only via fire_sync cannot take brownout
    # latency or a blackhole partition — `make degraded` blind spot
    mod = """
        from ..platform import faults

        async def put(self, fn):
            faults.fire_sync("store.put", key="k")
            return await self.retrier.run("store.put", fn)
    """
    found = run_repo_rule("seam-coverage", sources={LIB: mod},
                          operations=SEAM_DOCS)
    assert any("windowed" in f.message and "store" in f.message
               for f in found)


def test_seam_coverage_async_hook_satisfies_windowed_drillability():
    # one async fire hook in the family covers the windowed kinds even
    # when a sync hook also exists
    mod = """
        from ..platform import faults

        async def put(self, fn):
            faults.fire_sync("store.preflight", key="k")
            if faults.enabled():
                await faults.fire("store.put", key="k")
            return await self.retrier.run("store.put", fn)
    """
    assert run_repo_rule("seam-coverage", sources={LIB: mod},
                         operations=SEAM_DOCS) == []


def test_seam_coverage_windowed_exemption_ratchet(monkeypatch):
    # the storage fault plane emptied drift.WINDOWED_EXEMPT: a
    # sync-only `disk` hook is now a finding like any other family
    # (the ratchet must not quietly regrow)
    from downloader_tpu_torch.analysis import drift

    assert drift.WINDOWED_EXEMPT == {}
    mod = """
        from ..platform import faults

        def preflight(self):
            faults.fire_sync("disk.preflight", key="/tmp")
    """
    docs = SEAM_DOCS + "\nretry.disk covers the preflight\n"
    found = run_repo_rule("seam-coverage", sources={LIB: mod},
                          operations=docs)
    assert any("windowed" in f.message and "disk" in f.message
               for f in found)
    # the exemption mechanism itself still works when justified
    monkeypatch.setattr(drift, "WINDOWED_EXEMPT",
                        {"disk": "sync-only by design (test)"})
    found = run_repo_rule("seam-coverage", sources={LIB: mod},
                          operations=docs)
    assert not any("windowed" in f.message for f in found)


def test_seam_coverage_resolves_fstring_origin_seams():
    mod = """
        from ..platform import faults

        async def fetch(self, origin, fn):
            await faults.fire(f"origin:{origin.label}.fetch", key="k")
            return await self.retrier.run(
                f"origin:{origin.label}.fetch", fn)
    """
    docs = SEAM_DOCS + "\nper-origin retry.origin budgets\n"
    assert run_repo_rule("seam-coverage", sources={LIB: mod},
                         operations=docs) == []


# ---------------------------------------------------------------------------
# proto freeze
# ---------------------------------------------------------------------------

def _proto(download_fields):
    return textwrap.dedent(f"""
        syntax = "proto3";
        package downloader.v1;
        enum SourceType {{
          TORRENT = 0;
          HTTP = 1;
          FILE = 2;
          BUCKET = 3;
        }}
        enum MediaType {{
          TV = 0;
          MOVIE = 1;
        }}
        enum TelemetryStatus {{
          CREATED = 0;
          QUEUED = 1;
          DOWNLOADING = 2;
          CONVERTING = 3;
          UPLOADING = 4;
          DEPLOYED = 5;
          ERRORED = 6;
          CANCELLED = 7;
        }}
        enum JobPriority {{
          NORMAL = 0;
          HIGH = 1;
          BULK = 2;
        }}
        enum SourceKind {{
          AUTO = 0;
          DIRECT = 1;
          MANIFEST = 2;
        }}
        message Media {{
          string id = 1;
          string creator_id = 2;
          string name = 3;
          MediaType type = 4;
          SourceType source = 5;
          string source_uri = 6;
        }}
        message Download {{
          {download_fields}
        }}
        message Convert {{
          string created_at = 1;
          Media media = 2;
          double deadline_seconds = 3;
        }}
        message TelemetryStatusEvent {{
          string media_id = 1;
          TelemetryStatus status = 2;
        }}
        message TelemetryProgressEvent {{
          string media_id = 1;
          TelemetryStatus status = 2;
          int32 percent = 3;
        }}
    """)


DOWNLOAD_OK = """
          Media media = 1;
          string created_at = 2;
          JobPriority priority = 3;
          string tenant = 4;
          double ttl_seconds = 5;
          repeated string mirrors = 6;
          SourceKind source_kind = 7;
"""


def test_proto_freeze_accepts_current_schema_and_additive_growth():
    assert run_repo_rule("proto-freeze", proto=_proto(DOWNLOAD_OK)) == []
    grown = DOWNLOAD_OK + "          string shiny_new = 8;\n"
    assert run_repo_rule("proto-freeze", proto=_proto(grown)) == []


def test_proto_freeze_flags_retype_renumber_and_reuse():
    retyped = DOWNLOAD_OK.replace("double ttl_seconds = 5",
                                  "int32 ttl_seconds = 5")
    assert any("ttl_seconds" in f.message for f in
               run_repo_rule("proto-freeze", proto=_proto(retyped)))
    renumbered = DOWNLOAD_OK.replace("string tenant = 4",
                                     "string tenant = 9")
    assert any("tenant" in f.message for f in
               run_repo_rule("proto-freeze", proto=_proto(renumbered)))
    # a "new" field reusing a burned number below the high-water mark
    reused = DOWNLOAD_OK.replace("string tenant = 4;",
                                 "string owner = 4;")
    found = run_repo_rule("proto-freeze", proto=_proto(reused))
    assert any("owner" in f.message and "reuses" in f.message
               for f in found)
    assert any("tenant" in f.message and "removed" in f.message
               for f in found)


def test_proto_freeze_flags_enum_mutation():
    bad = _proto(DOWNLOAD_OK).replace("ERRORED = 6", "ERRORED = 9")
    found = run_repo_rule("proto-freeze", proto=bad)
    assert any("ERRORED" in f.message for f in found)


# ---------------------------------------------------------------------------
# generic (folded eslint-parity) rules: true positive + negative each
# ---------------------------------------------------------------------------

GENERIC_CASES = [
    ("tabs", "def f():\n\treturn 1\n", "def f():\n    return 1\n"),
    ("unused-import", "import os\n", "import os\n\nprint(os.sep)\n"),
    ("bare-except",
     "try:\n    x()\nexcept:\n    pass\n",
     "try:\n    x()\nexcept ValueError:\n    pass\n"),
    ("mutable-default",
     "def f(a=[]):\n    return a\n",
     "def f(a=None):\n    return a\n"),
    ("empty-fstring",
     "x = f'static'\n",
     "y = 2\nx = f'{y:.2f}'\n"),
    ("literal-comparison",
     "def f(x):\n    return x == None\n",
     "def f(x):\n    return x is None\n"),
    ("raise-notimplemented",
     "def f():\n    raise NotImplemented\n",
     "def f():\n    raise NotImplementedError\n"),
    ("redefinition",
     "def f():\n    pass\ndef f():\n    pass\n",
     "def f():\n    pass\ndef g():\n    pass\n"),
    ("discarded-task",
     "def go(loop, coro):\n    loop.create_task(coro)\n",
     "def go(loop, coro):\n    t = loop.create_task(coro)\n    return t\n"),
]


def test_generic_rules_fire_and_stay_quiet():
    for rule, bad, good in GENERIC_CASES:
        assert run_rule(bad, rule), f"{rule}: true positive missed"
        assert not run_rule(good, rule), f"{rule}: false positive"


def test_print_rule_is_profile_scoped():
    src = "print('hi')\n"
    assert run_rule(src, "print-in-library", path=LIB)
    for exempt in ("downloader_tpu_torch/cli.py", "tests/t.py", "scripts/s.py",
                   "bench.py"):
        assert not run_rule(src, "print-in-library", path=exempt)


def test_syntax_error_is_reported_not_raised():
    bad = module("def broken(:\n")
    found = analyze_module(bad)
    assert [f.rule for f in found] == ["syntax-error"]


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------

def test_justified_suppression_silences_the_finding():
    src = ("try:\n"
           "    x()\n"
           "# graftlint: disable=bare-except -- fixture: deliberate sink\n"
           "except:\n"
           "    pass\n")
    mod = module(src)
    kept, suppressed = apply_suppressions(
        analyze_module(mod, rules=["bare-except"]), mod.rel_path, mod.lines)
    assert kept == [] and suppressed == 1


def test_same_line_suppression_works():
    src = ("def f(x):\n"
           "    return x == None  "
           "# graftlint: disable=literal-comparison -- fixture\n")
    mod = module(src)
    kept, suppressed = apply_suppressions(
        analyze_module(mod, rules=["literal-comparison"]),
        mod.rel_path, mod.lines)
    assert kept == [] and suppressed == 1


def test_unjustified_suppression_is_itself_a_finding():
    src = ("try:\n"
           "    x()\n"
           "# graftlint: disable=bare-except\n"
           "except:\n"
           "    pass\n")
    mod = module(src)
    kept, suppressed = apply_suppressions(
        analyze_module(mod, rules=["bare-except"]), mod.rel_path, mod.lines)
    rules = sorted(f.rule for f in kept)
    # the disable without '-- why' suppresses NOTHING and adds its own
    # finding: silencing a rule always costs a written justification
    assert rules == ["bare-except", "suppression-syntax"]
    assert suppressed == 0


def test_directive_inside_a_string_literal_is_not_a_suppression():
    # a quoted fixture ("# graftlint: disable=...") must not register
    # as a live suppression of its host file — only real comments do
    src = ('FIXTURE = "x()  # graftlint: disable=bare-except -- quoted"\n'
           "try:\n"
           "    x()\n"
           "except:\n"
           "    pass\n")
    mod = module(src)
    assert analysis.core.scan_suppressions(mod.lines) == []
    kept, suppressed = apply_suppressions(
        analyze_module(mod, rules=["bare-except"]), mod.rel_path,
        mod.lines)
    assert [f.rule for f in kept] == ["bare-except"]
    assert suppressed == 0


def test_proto_freeze_anchors_removed_field_to_its_message():
    removed = DOWNLOAD_OK.replace("          string tenant = 4;\n", "")
    found = [f for f in run_repo_rule("proto-freeze",
                                      proto=_proto(removed))
             if "removed" in f.message]
    assert found and all(f.line > 1 for f in found), found


def test_scoped_run_still_sees_the_whole_package(tmp_path):
    """A targeted walk (e.g. ``... tests``) must not starve the
    repo-scope drift rules of the package — that read every documented
    knob as dead and failed clean trees."""
    pkg = tmp_path / "downloader_tpu_torch"
    pkg.mkdir()
    (pkg / "mod.py").write_text(
        "from .config import cfg_get\n\n\n"
        "def read(config):\n"
        "    return cfg_get(config, \"journal.enabled\")\n")
    docs = tmp_path / "docs"
    docs.mkdir()
    (docs / "OPERATIONS.md").write_text(
        "## Config\n\n```yaml\njournal:\n  enabled: true\n```\n\n"
        "set `journal.enabled` to taste\n")
    tests_dir = tmp_path / "tests"
    tests_dir.mkdir()
    (tests_dir / "test_x.py").write_text("X = 1\n")
    result = analysis.analyze(str(tmp_path), targets=("tests",))
    assert [f.render() for f in result.findings] == []


def test_cli_exit_codes(tmp_path):
    from downloader_tpu_torch.analysis.__main__ import main

    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "clean.py").write_text("X = 1\n")
    assert main(["--root", str(tmp_path), "pkg"]) == 0
    (pkg / "dirty.py").write_text("try:\n    x()\nexcept:\n    pass\n")
    assert main(["--root", str(tmp_path), "pkg", "--json"]) == 1
    # a typo'd path is a usage error, never a clean tree
    assert main(["--root", str(tmp_path), "pgk"]) == 2


def test_stacked_suppressions_merge_per_line():
    # a comment-line disable above plus an inline disable on the line
    # must BOTH apply (rule sets merge; neither clobbers the other)
    src = ("# graftlint: disable=literal-comparison -- fixture: stacked\n"
           "def f(x):\n"
           "    return x == None  "
           "# graftlint: disable=literal-comparison -- fixture: inline\n")
    mod = module(src)
    kept, suppressed = apply_suppressions(
        analyze_module(mod, rules=["literal-comparison"]),
        mod.rel_path, mod.lines)
    assert kept == [] and suppressed == 1
    src2 = ("try:\n"
            "    x()\n"
            "# graftlint: disable=bare-except -- fixture: above\n"
            "except:  # graftlint: disable=tabs -- fixture: other rule\n"
            "    pass\n")
    mod2 = module(src2)
    kept2, suppressed2 = apply_suppressions(
        analyze_module(mod2, rules=["bare-except"]),
        mod2.rel_path, mod2.lines)
    assert kept2 == [] and suppressed2 == 1


def test_suppression_for_wrong_rule_does_not_apply():
    src = ("try:\n"
           "    x()\n"
           "# graftlint: disable=tabs -- fixture: wrong rule on purpose\n"
           "except:\n"
           "    pass\n")
    mod = module(src)
    kept, suppressed = apply_suppressions(
        analyze_module(mod, rules=["bare-except"]), mod.rel_path, mod.lines)
    assert [f.rule for f in kept] == ["bare-except"]
    assert suppressed == 0


# ---------------------------------------------------------------------------
# event drift (events that slipped past the event-schema docs)
# ---------------------------------------------------------------------------

EVENT_CATALOG_DOC = """
### Per-job flight recorder (`platform/obs.py`)

Each event is one flat JSON object.

| kind | fields | emitted by |
|---|---|---|
| `received` | `priority` | registry |
| `queue_wait` / `sched_wait` | `seconds` | orchestrator |
| `origin_probe` | `origin`, `ok` | racing fetch |

### Runtime introspection

Prose mentioning `totally_undocumented_kind` outside the table must
NOT count as catalog coverage.
"""

EVENT_MOD_BAD = """
    def emit(record):
        record.event("totally_undocumented_kind", x=1)
"""

EVENT_MOD_GOOD = """
    def emit(record, recorder):
        record.event("received", priority="HIGH")
        record.event("origin_probe", origin="o1", ok=True)
        record.event("sched_wait", seconds=0.1)   # combined-row name
        recorder.record("queue_wait", seconds=0.2)
"""

EVENT_MOD_WRAPPER = """
    class Racer:
        def _event(self, kind, **fields):
            self.record.event(kind, **fields)

        def go(self):
            self._event("range_assign", origin="o1")
"""


def test_event_drift_flags_undocumented_event():
    found = run_repo_rule("event-drift",
                          sources={LIB: EVENT_MOD_BAD},
                          architecture=EVENT_CATALOG_DOC)
    assert len(found) == 1
    assert "totally_undocumented_kind" in found[0].message
    assert "ARCHITECTURE" in found[0].message


def test_event_drift_accepts_cataloged_events():
    # table rows cover record.event, combined-name rows, and direct
    # recorder.record calls alike
    assert run_repo_rule("event-drift",
                         sources={LIB: EVENT_MOD_GOOD},
                         architecture=EVENT_CATALOG_DOC) == []


def test_event_drift_sees_wrapper_emitters():
    # the origin plane's self._event("...") wrapper is an emitter too
    # (range_assign is exactly an event that drifted) — and
    # prose mentions outside the catalog table do not count
    found = run_repo_rule("event-drift",
                          sources={LIB: EVENT_MOD_WRAPPER},
                          architecture=EVENT_CATALOG_DOC)
    assert len(found) == 1
    assert "range_assign" in found[0].message


def test_event_drift_one_finding_per_kind_and_dynamic_kinds_skipped():
    src = """
    def emit(record, kind):
        record.event(kind, x=1)          # dynamic: the wrapper seam
        record.event("drifted", a=1)
        record.event("drifted", b=2)     # same kind: one finding
    """
    found = run_repo_rule("event-drift", sources={LIB: src},
                          architecture=EVENT_CATALOG_DOC)
    assert len(found) == 1
    assert "drifted" in found[0].message


# ---------------------------------------------------------------------------
# the port's registry against the reference's
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: every tree of the repo: both packages, both suites, the root scripts
#: and the entry points
ALL_TARGETS = ("downloader_tpu", "downloader_tpu_torch", "tests", "scripts",
               "bench.py", "__graft_entry__.py", "chip_smoke.py")

#: files the two registries profile differently: the port's multi-card
#: entry point and the card's smoke script are CLIs there, and the
#: port's spikes under downloader_tpu_torch/scripts/ are scripts
PROFILE_DIFFERS = (
    "chip_smoke.py",
    "downloader_tpu_torch/graft_entry.py",
    "downloader_tpu_torch/scripts/__init__.py",
    "downloader_tpu_torch/scripts/head_spike.py",
    "downloader_tpu_torch/scripts/head_sweep.py",
)

#: rules whose reference doc ends in a remark on the reference project's
#: history, which the port's doc leaves out word for word
DOCS_WITHOUT_HISTORY = ("ack-settle-atomicity", "event-drift",
                        "unbounded-timeout")


def _rename(text):
    return re.sub(r"\bdownloader_tpu\b", "downloader_tpu_torch", text)


def _words_kept(short, long):
    """True when ``short``'s words are ``long``'s with some left out."""
    words = iter(re.findall(r"\w+", long))
    return all(word in words for word in re.findall(r"\w+", short))


def _in_package(rel, package):
    """``rel`` as the registry of ``package`` reads it: a file of either
    package under that package's name, as its own gate would."""
    return re.sub(r"^downloader_tpu(_torch)?/", package + "/", rel)


def _module_findings(registry, rel, text, package):
    mod = registry.ModuleSource(_in_package(rel, package), text)
    return mod.profile, [(f.rule, f.line, f.message)
                         for f in registry.analyze_module(mod)]


def test_registries_hold_the_same_rules():
    """Two registries in one process: the port's checkers register into
    the port's tables only, and the catalogs match after the mapping."""
    assert MODULE_RULES is not reference.core.MODULE_RULES
    assert REPO_RULES is not reference.core.REPO_RULES
    port = {rule.id: rule for rule in all_rules()}
    ref = {rule.id: rule for rule in reference.all_rules()}
    assert sorted(port) == sorted(ref)
    for rule_id, rule in port.items():
        assert rule.scope == ref[rule_id].scope
        assert rule.fn.__module__.startswith("downloader_tpu_torch.analysis.")
        assert ref[rule_id].fn.__module__.startswith("downloader_tpu.analysis.")
        want = _rename(ref[rule_id].doc)
        if rule_id in DOCS_WITHOUT_HISTORY:
            assert rule.doc != want and _words_kept(rule.doc, want), rule_id
        else:
            assert rule.doc == want, rule_id


def test_registries_agree_on_every_file_where_profiles_agree():
    """Every .py of the repo through both registries' module rules: the
    findings (rule, line, message) are the same wherever the two file
    profiles agree, and the profiles differ only on the listed files."""
    differ, mismatched, compared = [], [], 0
    for rel in reference.iter_source_files(REPO, ALL_TARGETS):
        with open(os.path.join(REPO, rel), encoding="utf-8") as fh:
            text = fh.read()
        port_profile, port = _module_findings(analysis, rel, text,
                                              "downloader_tpu_torch")
        ref_profile, ref = _module_findings(reference, rel, text,
                                            "downloader_tpu")
        if port_profile != ref_profile:
            differ.append(rel)
            continue
        compared += len(ref)
        if port != ref:
            mismatched.append((rel, port, ref))
    assert differ == sorted(PROFILE_DIFFERS)
    assert mismatched == []
    assert compared > 0  # the suppressed sites' raw findings, at least


def test_each_registry_finds_its_own_package_clean():
    for registry, package in ((reference, "downloader_tpu"),
                              (analysis, "downloader_tpu_torch")):
        modules = [registry.ModuleSource.load(REPO, rel)
                   for rel in registry.iter_source_files(REPO, (package,))]
        ctx = registry.RepoContext.from_root(REPO, modules)
        assert [f.render() for f in registry.analyze_repo(ctx)] == [], package


INJECTED = '''
from prometheus_client import Counter

from .platform.config import cfg_get


def read(config, ns, registry):
    return cfg_get(config, "journal.injected_knob", 1), Counter(
        f"{ns}_injected_widgets_total", "widgets", ["tenant"],
        registry=registry)
'''


def test_each_registry_catches_injected_drift(tmp_path):
    """An undocumented knob, an uncatalogued metric and a retyped proto
    field, injected into a copy of each package: each registry reports
    each of the three, and nothing else."""
    def not_source(directory, names):
        return [name for name in names if name == "__pycache__" or not (
            name.endswith((".py", ".proto"))
            or os.path.isdir(os.path.join(directory, name)))]

    (tmp_path / "docs").mkdir()
    for doc in ("OPERATIONS.md", "ARCHITECTURE.md"):
        shutil.copy(os.path.join(REPO, "docs", doc), tmp_path / "docs")
    for registry, package in ((reference, "downloader_tpu"),
                              (analysis, "downloader_tpu_torch")):
        shutil.copytree(os.path.join(REPO, package), tmp_path / package,
                        ignore=not_source)
        (tmp_path / package / "injected_drift.py").write_text(INJECTED)
        proto = tmp_path / package / "schemas" / "downloader.proto"
        text = proto.read_text()
        assert "double ttl_seconds = 5;" in text
        proto.write_text(text.replace("double ttl_seconds = 5;",
                                      "int32 ttl_seconds = 5;"))
        result = registry.analyze(
            str(tmp_path), targets=(package,),
            rules=["knob-drift", "metric-drift", "proto-freeze"])
        found = sorted((f.rule, f.path) for f in result.findings)
        assert found == [
            ("knob-drift", f"{package}/injected_drift.py"),
            ("metric-drift", f"{package}/injected_drift.py"),
            ("proto-freeze", f"{package}/schemas/downloader.proto"),
        ], [f.render() for f in result.findings]
        messages = " ".join(f.message for f in result.findings)
        for needle in ("journal.injected_knob", "injected_widgets_total",
                       "ttl_seconds"):
            assert needle in messages, (package, needle)

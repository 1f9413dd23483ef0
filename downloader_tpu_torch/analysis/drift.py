"""Drift rules: code vs the docs/OPERATIONS.md catalogs and the seam map.

Three repo-scope checkers, each encoding a recurring defect (knobs and metrics shipped without catalog rows; seams wired
without fault-injection reachability):

- **knob-drift** — every ``cfg_get("a.b.c")`` key must be documented in
  docs/OPERATIONS.md (a catalog row, a config example, or the dotted
  path in prose), and every knob the OPERATIONS config examples
  document must be read somewhere (dead-knob reverse check).
- **metric-drift** — every metric family registered in
  platform/metrics.py must have a row in the OPERATIONS "Metrics
  catalog" section, and label sets must be literal and drawn from the
  bounded-label allowlist (job payloads must not mint Prometheus
  series — the tenant/origin posture).
- **seam-coverage** — every ``Retrier.run("<seam>")`` seam must key on
  a known dependency family (the ``retry.*`` config families
  platform/errors.py resolves) that the OPERATIONS failure-model docs
  name, and must be reachable by the fault-injection plan (a
  ``faults.fire``/``fire_sync`` hook exists for the same family, so
  ``make chaos`` can actually drill it).
"""

from __future__ import annotations

import ast
import fnmatch
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .core import Finding, ModuleSource, RepoContext, repo_checker

# -- shared extraction helpers -----------------------------------------


def _literal_or_pattern(expr: ast.expr) -> Optional[str]:
    """A string Constant as-is; an f-string with ``*`` for each
    placeholder (``f"retry.{dep}.{k}"`` -> ``retry.*.*``); else None."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value
    if isinstance(expr, ast.JoinedStr):
        parts = []
        for value in expr.values:
            if isinstance(value, ast.Constant):
                parts.append(str(value.value))
            else:
                parts.append("*")
        return "".join(parts)
    return None


def _attr_chain(node: ast.Attribute) -> List[str]:
    """Outermost attribute chain names, root-first (``config.a.b`` ->
    ``["a", "b"]`` — the root expression itself is ignored so
    ``self.config.a.b`` and ``ctx.config.a.b`` normalize the same)."""
    chain: List[str] = []
    current: ast.expr = node
    while isinstance(current, ast.Attribute):
        chain.append(current.attr)
        current = current.value
    chain.reverse()
    return chain


# -- knob drift ---------------------------------------------------------

#: top-level config sections (platform/config.py DEFAULTS + the
#: documented opt-in sections).  Attribute chains / .get() keys rooted
#: here count as config reads; a *new* top-level section must be added
#: both here and to the OPERATIONS docs.
CONFIG_SECTIONS = frozenset({
    "instance", "minio", "rabbitmq", "services", "store", "tracing",
    "health", "control", "retry", "breakers", "faults", "tenants",
    "overload", "origins", "fleet", "journal", "integrity", "obs",
    "wire_remap", "slo", "incident", "download", "scrub",
})

#: documented knobs that are deliberately not read via cfg_get /
#: attribute traversal — each entry names the mechanism that consumes
#: it, so the dead-knob check stays honest instead of silently skipped.
DOCUMENTED_ONLY_KNOBS: Dict[str, str] = {
    # the store backends receive the whole `minio` section as
    # constructor kwargs (store/__init__.py builds from config["minio"])
    "minio.backend": "consumed wholesale by store backend factory",
    "minio.access_key": "consumed wholesale by store backend factory",
    "minio.secret_key": "consumed wholesale by store backend factory",
    # dyn() resolves service names against the whole `services` map
    "services.rabbitmq": "read dynamically via dyn('rabbitmq')",
    "services.minio": "read dynamically via dyn('minio')",
}

_DOTTED_TOKEN_RE = re.compile(
    r"[A-Za-z_][A-Za-z0-9_]*(?:\.[A-Za-z0-9_<>*-]+)+")
_YAML_FENCE_RE = re.compile(r"```yaml\n(.*?)```", re.DOTALL)
_YAML_KEY_RE = re.compile(r"^(\s*)([A-Za-z_][A-Za-z0-9_]*):(.*)$")


def _doc_tokens(doc: str) -> Set[str]:
    """Dotted config paths mentioned anywhere in the doc text, with
    ``<placeholder>`` segments normalized to ``*``."""
    out = set()
    for token in _DOTTED_TOKEN_RE.findall(doc):
        out.add(re.sub(r"<[^.>]*>", "*", token))
    return out


def _yaml_block_paths(doc: str) -> List[Tuple[str, int]]:
    """(dotted path, doc line) for every key in the doc's fenced yaml
    config examples — parsed with a comment-stripping indentation
    stack, because the examples carry ``...`` placeholders real YAML
    loaders reject."""
    paths: List[Tuple[str, int]] = []
    for match in _YAML_FENCE_RE.finditer(doc):
        start_line = doc[:match.start(1)].count("\n") + 1
        stack: List[Tuple[int, str]] = []  # (indent, key)
        list_indent: Optional[int] = None  # inside a "- item" list
        for offset, raw in enumerate(match.group(1).splitlines()):
            line = raw.split("#", 1)[0].rstrip()
            stripped = line.strip()
            indent_now = len(line) - len(line.lstrip())
            if stripped.startswith("-"):
                # a list: its items are payload shapes (fault-plan rule
                # fields, tenant examples), not config knob paths
                list_indent = indent_now
                continue
            if list_indent is not None:
                if stripped and indent_now > list_indent:
                    continue
                list_indent = None
            key_match = _YAML_KEY_RE.match(line)
            if key_match is None:
                continue
            indent = len(key_match.group(1))
            key = key_match.group(2)
            while stack and stack[-1][0] >= indent:
                stack.pop()
            stack.append((indent, key))
            path = ".".join(k for _, k in stack)
            paths.append((path, start_line + offset))
            # inline mappings ({backend: amqp}) contribute their keys too
            rest = key_match.group(3).strip()
            if rest.startswith("{") and rest.endswith("}"):
                for part in rest[1:-1].split(","):
                    inner = part.split(":", 1)[0].strip()
                    if re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", inner):
                        paths.append((f"{path}.{inner}",
                                      start_line + offset))
    return paths


class _KnobReads(ast.NodeVisitor):
    """Collects every way a module reads config: cfg_get literals,
    cfg_get f-string patterns, attribute chains rooted in a known
    section, and ``.get("section")`` literals."""

    def __init__(self, rel_path: str):
        self.rel_path = rel_path
        self.exact: List[Tuple[str, int]] = []
        self.patterns: List[Tuple[str, int]] = []
        self.prefixes: Set[str] = set()
        self._attr_seen: Set[int] = set()

    def visit_Call(self, node: ast.Call):
        func = node.func
        name = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else "")
        if name == "cfg_get" and len(node.args) >= 2:
            key = _literal_or_pattern(node.args[1])
            if key is not None:
                if "*" in key:
                    self.patterns.append((key, node.lineno))
                else:
                    self.exact.append((key, node.lineno))
        elif name == "get" and node.args:
            arg = node.args[0]
            if (isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)
                    and arg.value in CONFIG_SECTIONS):
                self.prefixes.add(arg.value)
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute):
        if id(node) in self._attr_seen:
            # interior link of a chain already recorded: don't re-root
            # a shorter (over-broad) prefix, but keep walking into the
            # root expression (it may hold calls/chains of its own)
            self.generic_visit(node)
            return
        chain = _attr_chain(node)
        # mark only this chain's own SPINE as seen — chains nested in
        # the subtree (call arguments, subscripts) must still be rooted
        # when the visitor reaches them
        current: ast.expr = node
        while isinstance(current, ast.Attribute):
            self._attr_seen.add(id(current))
            current = current.value
        for start, first in enumerate(chain):
            if first in CONFIG_SECTIONS:
                tail = chain[start:]
                # a bare one-element chain (self.store, ctx.origins, …)
                # is almost never a config read — any attribute named
                # like a section would otherwise blanket-mark the whole
                # section as live and make the dead-knob check vacuous
                if len(tail) >= 2:
                    self.prefixes.add(".".join(tail))
                break
        self.generic_visit(node)


def _collect_knob_reads(modules: Iterable[ModuleSource]):
    exact: Dict[str, Tuple[str, int]] = {}
    patterns: Dict[str, Tuple[str, int]] = {}
    prefixes: Set[str] = set()
    for module in modules:
        if module.tree is None:
            continue
        visitor = _KnobReads(module.rel_path)
        visitor.visit(module.tree)
        for key, line in visitor.exact:
            exact.setdefault(key, (module.rel_path, line))
        for key, line in visitor.patterns:
            patterns.setdefault(key, (module.rel_path, line))
        prefixes |= visitor.prefixes
    return exact, patterns, prefixes


@repo_checker(
    "knob-drift",
    "cfg_get keys must have a docs/OPERATIONS.md row; documented config "
    "knobs must be read somewhere (dead-knob reverse check).  "
    "Deliberate exceptions live in drift.DOCUMENTED_ONLY_KNOBS with "
    "the consuming mechanism on record.")
def check_knob_drift(ctx: RepoContext) -> List[Finding]:
    out: List[Finding] = []
    doc = ctx.operations_md
    tokens = _doc_tokens(doc)
    yaml_paths = _yaml_block_paths(doc)
    documented: Set[str] = tokens | {path for path, _ in yaml_paths}

    def is_documented(key: str) -> bool:
        if key in documented:
            return True
        return any("*" in tok and fnmatch.fnmatch(key, tok)
                   for tok in documented)

    exact, patterns, prefixes = _collect_knob_reads(
        ctx.package_modules())

    # forward: every read knob has a doc row (single-component keys —
    # whole sections like "tenants" — count as documented when the
    # bare word appears in the doc)
    for key, (path, line) in sorted(exact.items()):
        if not is_documented(key) and not (
                "." not in key and re.search(
                    rf"(?:^|[\s`\"']){re.escape(key)}(?:$|[\s:`\"'.])",
                    doc)):
            out.append(Finding(
                "knob-drift", path, line,
                f'config knob "{key}" has no docs/OPERATIONS.md row — '
                "document it (knob table or config example) before it "
                "ships"))
    for key, (path, line) in sorted(patterns.items()):
        family = key.split("*", 1)[0].rstrip(".")
        if family and not any(tok == family or tok.startswith(family + ".")
                              for tok in documented):
            out.append(Finding(
                "knob-drift", path, line,
                f'config knob family "{family}.*" has no '
                "docs/OPERATIONS.md coverage"))

    # reverse: every documented yaml-example knob is read somewhere.
    # Only LEAF paths count (section headers are structure, not knobs).
    all_paths = {path for path, _ in yaml_paths}
    seen: Set[str] = set()
    for path, line in yaml_paths:
        if path in seen:
            continue
        seen.add(path)
        if any(other != path and other.startswith(path + ".")
               for other in all_paths):
            continue  # interior node
        if path.split(".", 1)[0] not in CONFIG_SECTIONS:
            continue
        if path in DOCUMENTED_ONLY_KNOBS:
            continue
        used = (
            path in exact
            or any(fnmatch.fnmatch(path, pattern) for pattern in patterns)
            or any(path == p or path.startswith(p + ".")
                   or p.startswith(path + ".") for p in prefixes)
        )
        if not used:
            out.append(Finding(
                "knob-drift", ctx.operations_path, line,
                f'documented knob "{path}" is read nowhere in '
                "downloader_tpu_torch/ — dead doc row, stale name, or a "
                "mechanism drift.DOCUMENTED_ONLY_KNOBS must name"))
    return out


# -- metric drift -------------------------------------------------------

#: label names whose value sets are bounded by construction (config,
#: enums, code literals) — the only sources allowed to mint Prometheus
#: series.  Adding a label here asserts its cardinality is bounded;
#: say where the bound comes from.
BOUNDED_LABELS = frozenset({
    "state",        # control-plane lifecycle enum
    "from_state", "to_state",   # same enum
    "reason",       # code literals at each inc() site
    "seam", "dependency", "op",  # seam/dependency names (code literals;
                                 # origin:<label> bounded by
                                 # origins.max_labels)
    "outcome",      # taxonomy enum / terminal states
    "stage",        # pipeline stage names
    "hop",          # hop ledger's fixed hop set
    "queue",        # the two queue names
    "protocol",     # download protocol literals
    "direction",    # in/out
    "kind", "mode",  # code literals
    "tenant",       # config-bounded tenant table
    "origin",       # bounded by origins.max_labels (overflow -> other)
    "prefix",       # the three coordination-store key prefixes
                    # (workers/leases/telemetry — fleet/plane.py literals)
    "class",        # SLO objective names: the priority-class enum plus
                    # config-bounded tenant-objective keys
                    # (control/slo.py SloTracker.from_config)
    "window",       # the fast|slow burn-rate window pair (literals)
    "trigger",      # the breach|manual export-trigger pair
                    # (incident/bundle.py TRIGGER_* literals)
})

_METRIC_CTORS = frozenset({"Counter", "Gauge", "Histogram", "Summary"})


def _metric_registrations(module: ModuleSource):
    """(family name, labels expr, lineno) for each prometheus metric
    constructed in ``module``.  Family names follow the repo idiom
    ``f"{ns}_<family>"``."""
    for node in module.nodes:
        if not isinstance(node, ast.Call):
            continue
        name = node.func.id if isinstance(node.func, ast.Name) else (
            node.func.attr if isinstance(node.func, ast.Attribute) else "")
        if name not in _METRIC_CTORS or not node.args:
            continue
        family = _literal_or_pattern(node.args[0])
        if family is None:
            continue
        family = family.lstrip("*_")
        labels_expr: Optional[ast.expr] = None
        for arg in node.args[1:]:
            if isinstance(arg, (ast.List, ast.Tuple)):
                labels_expr = arg
        for kw in node.keywords:
            if kw.arg == "labelnames":
                labels_expr = kw.value
        yield family, labels_expr, node.lineno


def _catalog_section(doc: str) -> str:
    match = re.search(r"^## Metrics catalog.*?(?=^## |\Z)", doc,
                      re.DOTALL | re.MULTILINE)
    return match.group(0) if match else ""


@repo_checker(
    "metric-drift",
    "Every metric family registered with prometheus_client in "
    "downloader_tpu_torch/ must have a row in the OPERATIONS 'Metrics "
    "catalog' section, and label sets must be literal names from "
    "drift.BOUNDED_LABELS (bounded sources only — payloads must not "
    "mint series).")
def check_metric_drift(ctx: RepoContext) -> List[Finding]:
    out: List[Finding] = []
    catalog = _catalog_section(ctx.operations_md)
    for module in ctx.package_modules():
        if module.tree is None:
            continue
        if "prometheus_client" not in module.text:
            continue
        for family, labels_expr, line in _metric_registrations(module):
            # word-bounded match: "cache_hits" must NOT ride on the
            # "cache_hits_total" row (underscores are \w, so a partial
            # family name fails the lookahead)
            if family and not re.search(
                    rf"(?<!\w){re.escape(family)}(?!\w)", catalog):
                out.append(Finding(
                    "metric-drift", module.rel_path, line,
                    f'metric "{family}" has no row in the '
                    "docs/OPERATIONS.md metrics catalog"))
            if labels_expr is None:
                continue
            if not isinstance(labels_expr, (ast.List, ast.Tuple)):
                out.append(Finding(
                    "metric-drift", module.rel_path, line,
                    f'metric "{family}" labels are not a literal list '
                    "— label sets must be statically bounded"))
                continue
            for elt in labels_expr.elts:
                if not (isinstance(elt, ast.Constant)
                        and isinstance(elt.value, str)):
                    out.append(Finding(
                        "metric-drift", module.rel_path, line,
                        f'metric "{family}" has a non-literal label'))
                elif elt.value not in BOUNDED_LABELS:
                    out.append(Finding(
                        "metric-drift", module.rel_path, line,
                        f'metric "{family}" label "{elt.value}" is not '
                        "in the bounded-label allowlist "
                        "(drift.BOUNDED_LABELS) — prove its value set "
                        "is bounded, then add it there"))
    return out


# -- seam coverage ------------------------------------------------------

#: dependency families platform/errors.py's retry/breaker config covers
#: (``retry.<family>`` / ``breakers.<family>``).  ``settle`` is the
#: crash-only pre-ack fault seam (no Retrier rides it).
KNOWN_DEPENDENCIES = frozenset({
    "store", "publish", "http", "tracker", "disk", "coord", "origin",
    "settle", "compute",
})

#: families exempt from the WINDOWED-drillability requirement (every
#: family must carry at least one async ``faults.fire`` hook so the
#: windowed kinds — brownout latency, blackhole partitions — can
#: inject; ``fire_sync`` cannot sleep without stalling the event
#: loop).  EMPTY since the storage fault plane landed: ``disk`` — the
#: last holdout — now carries the async ``disk.land`` hook in the
#: landing loop (stages/download.py) plus thread-side latency drills
#: through the vfs shim, so every dependency family is windowed-
#: drillable.  A new sync-only family is a finding, not a silent gap;
#: adding an entry here requires naming why the exemption is sound.
WINDOWED_EXEMPT: Dict[str, str] = {}


def _seam_dependency(seam: str) -> str:
    dependency = seam.split(".", 1)[0]
    return dependency.split(":", 1)[0]


def _collect_seams(modules, attr_names: frozenset,
                   require_retrier: bool):
    """(seam-or-pattern, path, line) for each literal/f-string seam
    passed to a matching call.  ``require_retrier`` narrows ``.run``
    to receivers named ``retrier`` (Retrier.run), since ``.run`` alone
    is too common a method name."""
    out = []
    for module in modules:
        if module.tree is None:
            continue
        for node in module.nodes:
            if not isinstance(node, ast.Call) or not node.args:
                continue
            func = node.func
            name = func.attr if isinstance(func, ast.Attribute) else (
                func.id if isinstance(func, ast.Name) else "")
            if name not in attr_names:
                continue
            if require_retrier:
                receiver = func.value if isinstance(func, ast.Attribute) \
                    else None
                rname = receiver.attr if isinstance(
                    receiver, ast.Attribute) else (
                    receiver.id if isinstance(receiver, ast.Name)
                    else "")
                # suffix match so self._retrier / probe_retrier stay
                # covered — a renamed instance must not blind the rule
                if not rname.lower().endswith("retrier"):
                    continue
            seam = _literal_or_pattern(node.args[0])
            if seam is None:
                continue
            out.append((seam, module.rel_path, node.lineno))
    return out


@repo_checker(
    "seam-coverage",
    "Retrier seams must key on a known dependency family "
    "(drift.KNOWN_DEPENDENCIES — the retry.* config families), the "
    "family must be named in the OPERATIONS failure-model/runbook "
    "docs, and a faults.fire()/fire_sync() hook must exist for the "
    "family so the chaos suite can actually drill the seam.  Families "
    "must also be drillable by the WINDOWED kinds (brownout/partition/"
    "flap): at least one async faults.fire() hook — a seam you cannot "
    "brownout is a seam you cannot rehearse.  Sync-only families need "
    "a justified entry in drift.WINDOWED_EXEMPT.")
def check_seam_coverage(ctx: RepoContext) -> List[Finding]:
    out: List[Finding] = []
    modules = ctx.package_modules()
    retrier_seams = _collect_seams(modules, frozenset({"run"}),
                                   require_retrier=True)
    async_fault_seams = _collect_seams(modules, frozenset({"fire"}),
                                       require_retrier=False)
    sync_fault_seams = _collect_seams(modules, frozenset({"fire_sync"}),
                                      require_retrier=False)
    fault_seams = async_fault_seams + sync_fault_seams
    fault_families = {_seam_dependency(seam) for seam, _, _ in fault_seams}
    async_families = {_seam_dependency(seam)
                      for seam, _, _ in async_fault_seams}

    # windowed drillability: a family whose only hooks are fire_sync
    # cannot take brownout latency or a blackhole partition — `make
    # degraded` would silently skip it.  Anchored at the family's first
    # sync hook (the place an async hook belongs next to).
    flagged_windowed: Set[str] = set()
    for seam, path, line in sync_fault_seams:
        family = _seam_dependency(seam)
        if (family in KNOWN_DEPENDENCIES
                and family not in async_families
                and family not in WINDOWED_EXEMPT
                and family not in flagged_windowed):
            flagged_windowed.add(family)
            out.append(Finding(
                "seam-coverage", path, line,
                f'dependency family "{family}" is only drillable '
                "synchronously (fire_sync) — the windowed fault kinds "
                "(brownout/partition/flap) cannot inject latency here; "
                "add an async faults.fire() hook or a justified "
                "drift.WINDOWED_EXEMPT entry"))

    for seam, path, line in fault_seams:
        family = _seam_dependency(seam)
        if family not in KNOWN_DEPENDENCIES:
            out.append(Finding(
                "seam-coverage", path, line,
                f'fault seam "{seam}" keys on unknown dependency '
                f'family "{family}" — add it to '
                "drift.KNOWN_DEPENDENCIES and the OPERATIONS docs"))

    for seam, path, line in retrier_seams:
        family = _seam_dependency(seam)
        if family not in KNOWN_DEPENDENCIES:
            out.append(Finding(
                "seam-coverage", path, line,
                f'Retrier seam "{seam}" keys on unknown dependency '
                f'family "{family}" — retry.{family}/breakers.{family} '
                "config would silently fall back to defaults; add the "
                "family to drift.KNOWN_DEPENDENCIES + OPERATIONS"))
            continue
        if not re.search(rf"\b{re.escape(family)}\b",
                         ctx.operations_md):
            out.append(Finding(
                "seam-coverage", path, line,
                f'Retrier dependency family "{family}" is not named in '
                "docs/OPERATIONS.md — operators cannot tune what the "
                "docs do not admit exists"))
        if family != "settle" and family not in fault_families:
            out.append(Finding(
                "seam-coverage", path, line,
                f'Retrier seam "{seam}" has no faults.fire() hook in '
                f'its family "{family}" — the chaos suite cannot '
                "inject failures at this seam (make chaos blind spot)"))
    return out


# -- event drift --------------------------------------------------------

#: regex for a catalog-able event name (the flight-recorder kinds are
#: all lower_snake identifiers)
_EVENT_NAME_RE = re.compile(r"`([a-z][a-z0-9_]*)`")


def _catalog_events(architecture_md: str) -> Set[str]:
    """Event kinds documented in the ARCHITECTURE.md event-schema
    catalog: every backticked identifier in the FIRST column of the
    markdown table rows inside the flight-recorder section (rows like
    ``| `queue_wait` / `sched_wait` | ... |`` contribute both names)."""
    match = re.search(
        r"^### Per-job flight recorder.*?(?=^### |^## |\Z)",
        architecture_md, re.DOTALL | re.MULTILINE)
    section = match.group(0) if match else ""
    out: Set[str] = set()
    for line in section.splitlines():
        stripped = line.strip()
        if not stripped.startswith("|"):
            continue
        cells = stripped.split("|")
        if len(cells) < 3:
            continue
        out.update(_EVENT_NAME_RE.findall(cells[1]))
    return out


def _emitted_events(modules: Iterable[ModuleSource]):
    """(event name, path, line) for every literal flight-recorder event
    emitted in the package: ``<record>.event("<kind>", ...)`` and the
    origin plane's ``self._event("<kind>", ...)`` wrapper, plus direct
    ``<recorder>.record("<kind>", ...)`` calls (receiver named
    *recorder — a bare ``.record`` is too common a method name)."""
    out = []
    for module in modules:
        if module.tree is None:
            continue
        for node in module.nodes:
            if not isinstance(node, ast.Call) or not node.args:
                continue
            func = node.func
            if not isinstance(func, ast.Attribute):
                continue
            if func.attr == "record":
                receiver = func.value
                rname = receiver.attr if isinstance(
                    receiver, ast.Attribute) else (
                    receiver.id if isinstance(receiver, ast.Name)
                    else "")
                if not rname.lower().endswith("recorder"):
                    continue
            elif func.attr not in ("event", "_event"):
                continue
            arg = node.args[0]
            if not (isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)):
                continue  # dynamic kind: the wrapper seams themselves
            out.append((arg.value, module.rel_path, node.lineno))
    return out


@repo_checker(
    "event-drift",
    "Every FlightRecorder event kind emitted in downloader_tpu_torch/ "
    "(record.event(\"<kind>\") / self._event(\"<kind>\") / "
    "recorder.record(\"<kind>\")) must appear in the "
    "docs/ARCHITECTURE.md event-schema catalog table — the per-job "
    "timeline is an operator API.")
def check_event_drift(ctx: RepoContext) -> List[Finding]:
    out: List[Finding] = []
    catalog = _catalog_events(getattr(ctx, "architecture_md", ""))
    flagged: Set[str] = set()
    for name, path, line in _emitted_events(ctx.package_modules()):
        if name in catalog or name in flagged:
            continue
        flagged.add(name)  # one finding per kind, at its first emitter
        out.append(Finding(
            "event-drift", path, line,
            f'flight-recorder event "{name}" is not in the '
            "docs/ARCHITECTURE.md event catalog (the Per-job flight "
            "recorder table) — document its fields and emitter before "
            "it ships"))
    return out

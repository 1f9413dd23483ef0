"""graftlint core: findings, suppressions, the file walk, the registry.

Why this exists: the same classes of bug kept coming back — an
``await`` slipped between ``delivery.ack()`` and the terminal
``registry.transition``, an aiohttp ``timeout=None`` that is
*unbounded* rather than "session default", knobs and metrics shipped
without their docs/OPERATIONS.md catalog rows.  This package turns them
into a static-analysis gate: a registry of stdlib-``ast`` checkers run
per module (syntax-local rules) and once per repo (cross-file drift
rules), with findings suppressible only by an inline, *justified*
comment.

Vocabulary:

- **Finding** — one rule violation at ``path:line``.
- **Module checker** — ``fn(module: ModuleSource) -> findings``; sees
  one parsed file (tree with parent links, raw lines, file profile).
- **Repo checker** — ``fn(ctx: RepoContext) -> findings``; sees every
  package module plus the docs/proto corpus, for drift rules that
  compare code against catalogs.
- **Suppression** — ``# graftlint: disable=<rule>[,<rule>] -- <why>``
  on the finding's line or the comment-only line directly above it.
  The justification after ``--`` is REQUIRED: a bare disable leaves
  the original finding live and adds a ``suppression-syntax`` finding,
  so silencing a rule always costs a written sentence of intent.

The CLI lives in ``__main__`` (``python -m downloader_tpu_torch.analysis``,
``make lint``); the tier-1 entry point is tests/test_torch_lint.py,
which runs this same registry and asserts zero unsuppressed findings.
The rules are the reference's (downloader_tpu/analysis, held to it by
tests/test_torch_service_copies.py); only the walk and the file
profiles are the port's.
See docs/ANALYSIS.md for the rule catalog and how to add a checker.
"""

from __future__ import annotations

import ast
import os
import re
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

# -- file walk ----------------------------------------------------------

#: Roots the full-tree analysis covers, relative to the repo root: the
#: port's package, the port's own tests, and the card's smoke script.
#: The reference's trees (downloader_tpu, its tests, the root scripts/,
#: bench.py, __graft_entry__.py) are the reference's gate's to lint.
#: A target holding a glob character names the files it matches.
DEFAULT_TARGETS = (
    "downloader_tpu_torch",
    "tests/test_torch_*.py",
    "chip_smoke.py",
)

#: path suffixes excluded from the walk, with the reason on record:
#: *_pb2.py is generated by scripts/gen_proto.py (regenerate, don't
#: lint; tests/test_schemas.py guards its drift instead).
EXCLUDED_SUFFIXES = ("_pb2.py",)

EXCLUDED_DIRS = frozenset({"__pycache__"})

#: files whose job is to print: CLI entry points, benches, experiment
#: scripts, tests.  The ``print-in-library`` rule keys on this profile.
#: The port's multi-card entry point and the card's smoke script are
#: CLIs, as the reference's ``__graft_entry__.py`` is.
_CLI_BASENAMES = frozenset({"cli.py", "codec.py", "__main__.py",
                            "bench.py", "__graft_entry__.py",
                            "graft_entry.py", "chip_smoke.py"})


def file_profile(rel_path: str) -> str:
    """``library`` | ``cli`` | ``test`` | ``script`` for one rel path."""
    parts = rel_path.replace(os.sep, "/").split("/")
    if parts[0] == "tests":
        return "test"
    # the port keeps its spikes in downloader_tpu_torch/scripts/
    if parts[0] == "scripts" or parts[:2] == ["downloader_tpu_torch",
                                               "scripts"]:
        return "script"
    if parts[-1] in _CLI_BASENAMES:
        return "cli"
    return "library"


def iter_source_files(root: str,
                      targets: Iterable[str] = DEFAULT_TARGETS) -> List[str]:
    """Every analyzable ``.py`` under ``targets``, sorted, repo-relative;
    a target holding a glob character stands for what it matches."""
    import glob

    out: List[str] = []
    for target in targets:
        full = os.path.join(root, target)
        if any(ch in target for ch in "*?["):
            out.extend(iter_source_files(
                root, [os.path.relpath(match, root)
                       for match in glob.glob(full)]))
            continue
        if os.path.isfile(full):
            if full.endswith(".py"):
                out.append(os.path.relpath(full, root))
            continue
        for dirpath, dirnames, filenames in os.walk(full):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in EXCLUDED_DIRS)
            for name in sorted(filenames):
                if not name.endswith(".py"):
                    continue
                if name.endswith(EXCLUDED_SUFFIXES):
                    continue
                out.append(os.path.relpath(os.path.join(dirpath, name),
                                           root))
    return sorted(set(out))


# -- findings & suppressions -------------------------------------------

@dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to a file line."""

    rule: str
    path: str       # repo-relative
    line: int
    message: str

    def as_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message}

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*disable=([A-Za-z0-9_\-, ]+?)"
    r"\s*(?:--\s*(\S.*?))?\s*$"
)


@dataclass(frozen=True)
class Suppression:
    line: int
    rules: Tuple[str, ...]
    justification: Optional[str]


def _comment_lines(lines: List[str]):
    """(lineno, comment text) for every real COMMENT token — a disable
    directive quoted inside a string literal (checker fixtures, docs)
    must NOT register as a live suppression of its host file.  Files
    the tokenizer rejects (syntax errors) fall back to the whole-line
    scan: their only finding is ``syntax-error`` anyway."""
    import io
    import tokenize

    try:
        tokens = list(tokenize.generate_tokens(
            io.StringIO("\n".join(lines) + "\n").readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return list(enumerate(lines, start=1))
    return [(tok.start[0], tok.string) for tok in tokens
            if tok.type == tokenize.COMMENT]


def scan_suppressions(lines: List[str]) -> List[Suppression]:
    """Parse every graftlint disable comment in ``lines`` (1-based)."""
    if not any("graftlint:" in line for line in lines):
        return []  # fast path: most files carry no suppressions
    out = []
    for lineno, text in _comment_lines(lines):
        match = _SUPPRESS_RE.search(text)
        if match is None:
            continue
        rules = tuple(r.strip() for r in match.group(1).split(",")
                      if r.strip())
        out.append(Suppression(lineno, rules, match.group(2)))
    return out


def _comment_only(line: str) -> bool:
    stripped = line.strip()
    return stripped.startswith("#") or stripped.startswith("//")


def apply_suppressions(findings: List[Finding], path: str,
                       lines: List[str]) -> Tuple[List[Finding], int]:
    """Drop findings covered by a *justified* disable comment.

    A suppression covers its own line and — when it sits on a
    comment-only line — the next line down.  Un-justified disables
    suppress nothing and surface as ``suppression-syntax`` findings;
    that rule itself is deliberately unsuppressible (silencing the
    silencer would defeat the justification requirement).
    """
    suppressions = scan_suppressions(lines)
    covered: Dict[int, set] = {}   # line -> union of disabled rules
    kept: List[Finding] = list(findings)
    for sup in suppressions:
        if sup.justification is None:
            kept.append(Finding(
                "suppression-syntax", path, sup.line,
                "graftlint disable without a justification: write "
                "'# graftlint: disable=<rule> -- <why>'",
            ))
            continue
        # rule sets MERGE per covered line: an inline disable and a
        # comment-line disable above may both apply to the same line
        covered.setdefault(sup.line, set()).update(sup.rules)
        line_text = lines[sup.line - 1] if sup.line <= len(lines) else ""
        if _comment_only(line_text):
            covered.setdefault(sup.line + 1, set()).update(sup.rules)
    out: List[Finding] = []
    suppressed = 0
    for finding in kept:
        rules = covered.get(finding.line)
        if (rules and finding.rule != "suppression-syntax"
                and finding.rule in rules):
            suppressed += 1
            continue
        out.append(finding)
    return out, suppressed


# -- parsed module ------------------------------------------------------

class ModuleSource:
    """One parsed source file plus the derived maps checkers need."""

    def __init__(self, rel_path: str, text: str):
        self.rel_path = rel_path
        self.text = text
        self.lines = text.splitlines()
        self.profile = file_profile(rel_path)
        self.parse_error: Optional[SyntaxError] = None
        try:
            self.tree: Optional[ast.AST] = ast.parse(text,
                                                     filename=rel_path)
        except SyntaxError as err:
            self.tree = None
            self.parse_error = err
        self._parents: Optional[Dict[int, ast.AST]] = None
        self._nodes: Optional[List[ast.AST]] = None

    @classmethod
    def load(cls, root: str, rel_path: str) -> "ModuleSource":
        with open(os.path.join(root, rel_path), "r",
                  encoding="utf-8") as fh:
            return cls(rel_path, fh.read())

    @property
    def nodes(self) -> List[ast.AST]:
        """Every AST node, breadth-first (parents before children) —
        one shared walk instead of one ``ast.walk`` per checker, which
        is what keeps the full-tree gate inside its wall-clock budget."""
        if self._nodes is None:
            self._nodes = (list(ast.walk(self.tree))
                           if self.tree is not None else [])
        return self._nodes

    @property
    def parents(self) -> Dict[int, ast.AST]:
        """``id(child) -> parent`` for the whole tree (built lazily)."""
        if self._parents is None:
            parents: Dict[int, ast.AST] = {}
            for parent in self.nodes:
                for child in ast.iter_child_nodes(parent):
                    parents[id(child)] = parent
            self._parents = parents
        return self._parents

    def enclosing_function(self, node: ast.AST):
        """Nearest FunctionDef/AsyncFunctionDef above ``node`` (or None)."""
        current = self.parents.get(id(node))
        while current is not None:
            if isinstance(current, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return current
            current = self.parents.get(id(current))
        return None

    def in_async_code(self, node: ast.AST) -> bool:
        """True when ``node`` executes on the event loop: its nearest
        enclosing function is ``async def``.  A *sync* def nested in an
        async one is excluded — those are the executor/``to_thread``
        targets the blocking-call rule exists to push work into."""
        fn = self.enclosing_function(node)
        return isinstance(fn, ast.AsyncFunctionDef)


# -- repo context -------------------------------------------------------

class RepoContext:
    """Everything the cross-file drift checkers compare: the package
    modules, the operations doc, and the wire schema."""

    def __init__(self, modules: List[ModuleSource],
                 operations_md: str = "", proto_text: str = "",
                 operations_path: str = "docs/OPERATIONS.md",
                 proto_path: str = "downloader_tpu_torch/schemas/downloader.proto",
                 architecture_md: str = "",
                 architecture_path: str = "docs/ARCHITECTURE.md"):
        self.modules = modules
        self.operations_md = operations_md
        self.operations_path = operations_path
        self.proto_text = proto_text
        self.proto_path = proto_path
        # the flight-recorder event catalog lives in ARCHITECTURE.md
        # (the event-schema table) — the event-drift rule's corpus
        self.architecture_md = architecture_md
        self.architecture_path = architecture_path

    @classmethod
    def from_root(cls, root: str,
                  modules: List[ModuleSource]) -> "RepoContext":
        def read(rel):
            full = os.path.join(root, rel)
            if not os.path.exists(full):
                return ""
            with open(full, "r", encoding="utf-8") as fh:
                return fh.read()

        return cls(
            modules,
            operations_md=read("docs/OPERATIONS.md"),
            proto_text=read("downloader_tpu_torch/schemas/downloader.proto"),
            architecture_md=read("docs/ARCHITECTURE.md"),
        )

    def package_modules(self) -> List[ModuleSource]:
        """Modules under downloader_tpu_torch/ — the surfaces the repo-level
        invariants govern (tests/scripts exercise them, they don't
        define knobs, metrics, or seams)."""
        return [m for m in self.modules
                if m.rel_path.replace(os.sep, "/")
                .startswith("downloader_tpu_torch/")]


# -- registry -----------------------------------------------------------

@dataclass(frozen=True)
class Rule:
    id: str
    doc: str
    scope: str                      # "module" | "repo"
    fn: Callable = field(compare=False)


MODULE_RULES: Dict[str, Rule] = {}
REPO_RULES: Dict[str, Rule] = {}


def module_checker(rule_id: str, doc: str):
    def register(fn):
        MODULE_RULES[rule_id] = Rule(rule_id, doc, "module", fn)
        return fn
    return register


def repo_checker(rule_id: str, doc: str):
    def register(fn):
        REPO_RULES[rule_id] = Rule(rule_id, doc, "repo", fn)
        return fn
    return register


def all_rules() -> List[Rule]:
    out = list(MODULE_RULES.values()) + list(REPO_RULES.values())
    return sorted(out, key=lambda r: r.id)


# -- running the analysis ---------------------------------------------

@dataclass
class AnalysisResult:
    findings: List[Finding]
    files: int
    suppressed: int
    duration_s: float

    def as_dict(self) -> dict:
        return {
            "findings": [f.as_dict() for f in self.findings],
            "files": self.files,
            "suppressed": self.suppressed,
            "duration_s": round(self.duration_s, 3),
        }


def _selected(rules: Optional[Iterable[str]],
              table: Dict[str, Rule]) -> List[Rule]:
    if rules is None:
        return list(table.values())
    wanted = set(rules)
    unknown = wanted - set(MODULE_RULES) - set(REPO_RULES)
    if unknown:
        raise ValueError(f"unknown graftlint rules: {sorted(unknown)}")
    return [rule for rid, rule in table.items() if rid in wanted]


def analyze_module(module: ModuleSource,
                   rules: Optional[Iterable[str]] = None) -> List[Finding]:
    """Run the module-scope registry over one parsed file.

    A file that does not parse yields exactly one ``syntax-error``
    finding — the other rules need a tree.
    """
    if module.parse_error is not None:
        err = module.parse_error
        return [Finding("syntax-error", module.rel_path,
                        err.lineno or 1, f"does not parse: {err.msg}")]
    findings: List[Finding] = []
    for rule in _selected(rules, MODULE_RULES):
        findings.extend(rule.fn(module))
    return findings


def analyze_repo(ctx: RepoContext,
                 rules: Optional[Iterable[str]] = None) -> List[Finding]:
    findings: List[Finding] = []
    for rule in _selected(rules, REPO_RULES):
        findings.extend(rule.fn(ctx))
    return findings


def analyze(root: str, targets: Iterable[str] = DEFAULT_TARGETS,
            rules: Optional[Iterable[str]] = None) -> AnalysisResult:
    """Full-tree analysis: walk, module rules, repo rules, suppressions.

    Repo-checker findings anchored in a module file honor that file's
    inline suppressions too (same justified-disable contract); findings
    anchored in docs/proto cannot carry Python comments, so their
    deliberate exceptions live in the checkers' allowlists instead.
    """
    started = time.monotonic()
    rel_paths = iter_source_files(root, targets)
    modules = [ModuleSource.load(root, rel) for rel in rel_paths]
    by_path = {m.rel_path: m for m in modules}

    raw: Dict[str, List[Finding]] = {}
    for module in modules:
        raw.setdefault(module.rel_path, []).extend(
            analyze_module(module, rules))
    # repo-scope drift rules always see the WHOLE package, even when
    # ``targets`` scopes the module walk — otherwise a targeted run
    # (``... tests``) would read every knob/metric/seam as dead and
    # drown the user in false drift findings.  Skipped entirely when
    # the rule selection contains no repo rules, so scoped module-rule
    # runs stay cheap.
    if _selected(rules, REPO_RULES):
        pkg_modules = []
        for rel in iter_source_files(root, ("downloader_tpu_torch",)):
            module = by_path.get(rel)
            if module is None:
                module = ModuleSource.load(root, rel)
                by_path[rel] = module
            pkg_modules.append(module)
        ctx = RepoContext.from_root(root, pkg_modules)
        for finding in analyze_repo(ctx, rules):
            raw.setdefault(finding.path, []).append(finding)

    findings: List[Finding] = []
    suppressed = 0
    for path, path_findings in raw.items():
        module = by_path.get(path)
        if module is None:
            findings.extend(path_findings)
            continue
        kept, dropped = apply_suppressions(path_findings, path,
                                           module.lines)
        findings.extend(kept)
        suppressed += dropped
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return AnalysisResult(findings, len(modules), suppressed,
                          time.monotonic() - started)

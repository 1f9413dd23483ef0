"""graftlint: the repo-invariant static analyzer, the port's own gate.

Machine-checks the service's correctness rules: ack-settle atomicity, bounded aiohttp timeouts, no blocking
calls on the event loop, cancellation hygiene, knob/metric catalog
drift, Retrier-seam fault coverage, and the additive-only wire
schema — plus the generic eslint-parity rules.  The rules are the
reference package's (downloader_tpu/analysis), run over the port's own
tree.  See docs/ANALYSIS.md for the rule catalog.

Usage::

    python -m downloader_tpu_torch.analysis          # the port's walk, text
    python -m downloader_tpu_torch.analysis --json   # machine output
    make lint                                        # CLI + tier-1 gates

Importing the checker modules registers their rules; keep the imports
even though nothing references them by name.
"""

from . import asynchrony, drift, generic, staging, wire
from .core import (
    DEFAULT_TARGETS,
    AnalysisResult,
    Finding,
    ModuleSource,
    RepoContext,
    all_rules,
    analyze,
    analyze_module,
    analyze_repo,
    apply_suppressions,
    iter_source_files,
    module_checker,
    repo_checker,
)

__all__ = [
    "DEFAULT_TARGETS",
    "AnalysisResult",
    "Finding",
    "ModuleSource",
    "RepoContext",
    "all_rules",
    "analyze",
    "analyze_module",
    "analyze_repo",
    "apply_suppressions",
    "iter_source_files",
    "module_checker",
    "repo_checker",
    "asynchrony",
    "drift",
    "generic",
    "staging",
    "wire",
]

"""Lint-as-test for the port: graftlint over the port's walk (tier-1).

``downloader_tpu_torch/analysis`` is the reference's graftlint, walking
the port's own tree: its package, its tests (``tests/test_torch_*.py``)
and ``chip_smoke.py``.  This file mirrors tests/test_lint.py, which
gates the reference's trees, and holds the port's gate to the same
contract:

- zero unsuppressed findings over the walk (a justified
  ``# graftlint: disable=<rule> -- <why>`` is the only escape);
- the whole walk inside the same 10 s wall-clock budget.

Per-rule fixtures live in tests/test_torch_analysis.py.
"""

import os

import pytest

from downloader_tpu_torch import analysis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the wall-clock ceiling ``make lint`` is held to, as the reference's
FULL_TREE_BUDGET_S = 10.0

FILES = analysis.iter_source_files(REPO)


@pytest.fixture(scope="module")
def modules():
    return {rel: analysis.ModuleSource.load(REPO, rel) for rel in FILES}


def _unsuppressed(findings, path, modules):
    module = modules.get(path)
    if module is None:
        return list(findings)
    kept, _ = analysis.apply_suppressions(list(findings), path,
                                          module.lines)
    return kept


@pytest.mark.parametrize("rel", FILES, ids=FILES)
def test_module_lints_clean(rel, modules):
    """Every file of the port's walk, against every module-scope rule."""
    kept = _unsuppressed(analysis.analyze_module(modules[rel]), rel,
                         modules)
    assert not kept, "\n".join(f.render() for f in kept) + (
        "\n\nFix the defect, or — for a deliberate site — add "
        "'# graftlint: disable=<rule> -- <why>' (docs/ANALYSIS.md)"
    )


def test_repo_invariants_clean(modules):
    """The cross-file drift rules over the port's package: knob, metric,
    seam and event catalogs, and the additive-only wire schema of the
    port's proto."""
    ctx = analysis.RepoContext.from_root(REPO, list(modules.values()))
    assert ctx.proto_path == "downloader_tpu_torch/schemas/downloader.proto"
    assert ctx.proto_text and len(ctx.package_modules()) > 100
    by_path = {}
    for finding in analysis.analyze_repo(ctx):
        by_path.setdefault(finding.path, []).append(finding)
    kept = [f for path, findings in by_path.items()
            for f in _unsuppressed(findings, path, modules)]
    assert not kept, "\n".join(f.render() for f in kept)


def test_full_tree_analysis_fits_wall_clock_budget():
    """One end-to-end run of exactly what ``make lint`` executes for the
    port: a clean walk, inside the 10 s budget."""
    result = analysis.analyze(REPO)
    assert not result.findings, \
        "\n".join(f.render() for f in result.findings)
    assert result.files == len(FILES)
    assert result.duration_s < FULL_TREE_BUDGET_S, (
        f"graftlint took {result.duration_s:.2f}s for {result.files} "
        f"files (budget {FULL_TREE_BUDGET_S:.0f}s) — profile the slow "
        "checker, or narrow the walk"
    )


def test_walk_covers_the_expected_tree():
    """The walk covers the port's package, its tests and the smoke
    script, and nothing of the reference's trees, which the reference's
    gate holds."""
    files = set(FILES)
    assert "downloader_tpu_torch/orchestrator.py" in files
    assert "downloader_tpu_torch/analysis/core.py" in files  # lints itself
    assert "downloader_tpu_torch/compute/pipeline.py" in files
    assert "downloader_tpu_torch/graft_entry.py" in files
    assert "chip_smoke.py" in files
    assert "tests/test_torch_lint.py" in files
    tests = {rel for rel in files if rel.startswith("tests/")}
    assert tests == {
        "tests/" + name for name in os.listdir(os.path.join(REPO, "tests"))
        if name.startswith("test_torch_") and name.endswith(".py")}
    assert not [rel for rel in files if rel.startswith((
        "downloader_tpu/", "scripts/", "bench.py", "__graft_entry__.py"))]
    # generated protobuf output is excluded BY DESIGN
    assert "downloader_tpu_torch/schemas/downloader_pb2.py" not in files


def test_port_entry_points_and_spikes_print():
    """The port's CLIs and spikes are profiled as such, so printing is
    their job and not a ``print-in-library`` finding."""
    profile = analysis.core.file_profile
    assert profile("chip_smoke.py") == "cli"
    assert profile("downloader_tpu_torch/graft_entry.py") == "cli"
    assert profile("downloader_tpu_torch/cli.py") == "cli"
    assert profile("downloader_tpu_torch/scripts/head_spike.py") == "script"
    assert profile("downloader_tpu_torch/compute/pipeline.py") == "library"
    src = "print('hi')\n"
    for rel, printing in (("downloader_tpu_torch/graft_entry.py", False),
                          ("downloader_tpu_torch/scripts/head_sweep.py",
                           False),
                          ("chip_smoke.py", False),
                          ("downloader_tpu_torch/compute/infer.py", True)):
        found = analysis.analyze_module(analysis.ModuleSource(rel, src),
                                        rules=["print-in-library"])
        assert bool(found) == printing, rel


def test_every_suppression_carries_a_justification(modules):
    """Redundant with the zero-findings gate (an unjustified disable
    surfaces as a suppression-syntax finding), but stated explicitly."""
    unjustified = [
        (rel, sup.line)
        for rel, module in modules.items()
        for sup in analysis.core.scan_suppressions(module.lines)
        if sup.justification is None
    ]
    assert unjustified == []

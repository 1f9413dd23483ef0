"""A run may load neither JAX nor the JAX package; names are compared
by their whole top-level part."""

import ast
import sys
import types

import pytest

from portbench import harness
from portbench.tests import tiny


@pytest.mark.parametrize("modules, found", [
    (["downloader_tpu_torch", "downloader_tpu_torch.compute.pipeline"], []),
    (["downloader_tpu", "downloader_tpu.compute"], ["downloader_tpu"]),
    (["jax", "jax.numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen", "optax", "orbax.checkpoint"], ["flax", "optax", "orbax"]),
    (["jaxtyping", "flaxen", "optaxis", "orbaxy", "downloader_tpu_x"], []),
])
def test_forbidden_names_compared_whole(modules, found):
    assert harness.loaded_forbidden(modules) == found


def test_run_with_jax_loaded_fails_and_prints_no_result(tmp_path, monkeypatch):
    bench = tiny.bench_copy(tmp_path)
    tiny.add_cell(bench, "tiny-x2", "x2-1080p-stream", tiny.SERVE_CONFIG, tiny.SERVE_TRAFFIC)
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, line, err = tiny.run(bench, "tiny-x2")
    assert rc != 0 and line is None
    assert "jax" in err


def test_benchmark_sources_import_nothing_forbidden():
    for path in harness.BENCH_DIR.rglob("*.py"):
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not harness.loaded_forbidden(names), (path, names)


def test_references_import_nothing_of_the_program():
    for path in (harness.BENCH_DIR / "reference").glob("*.py"):
        text = path.read_text()
        assert "downloader_tpu" not in text, path

"""Tiny cells for the CPU tests: a copy of the benchmark's folder with
small configurations, traffic and cells added as new files, run through
the harness's rehearsal path (the CPU, no look for a card)."""

from __future__ import annotations

import io
import json
import shutil
import time
from contextlib import redirect_stderr
from pathlib import Path

from portbench import harness

SERVE_CONFIG = {"features": 16, "depth": 2, "batch": 2}
SERVE_TRAFFIC = {"width": 64, "height": 48, "pool": 4, "warm_batches": 2}
TRAIN_TRAFFIC = {"width": 96, "height": 64, "frames": 4, "batch": 2, "crop": 16,
                 "warm_steps": 4}


def bench_copy(tmp_path: Path) -> Path:
    dest = tmp_path / "portbench"
    shutil.copytree(harness.BENCH_DIR, dest,
                    ignore=shutil.ignore_patterns("_cache", "__pycache__", "tests"))
    return dest


def _derive(path: Path, name: str, changes: dict, **keys) -> None:
    data = json.loads(path.read_text())
    data.update(changes, **keys)
    (path.parent / f"{name}.json").write_text(json.dumps(data))


def add_cell(bench: Path, name: str, like: str, config: dict, traffic: dict,
             chips: int = 1) -> None:
    """A new cell ``name``, shaped like the cell ``like`` with smaller sizes,
    as three new files (its configuration, traffic and cell)."""
    cell = json.loads((bench / "workloads" / f"{like}.json").read_text())
    _derive(bench / "configs" / f"{cell['config']}.json", name, config)
    _derive(bench / "traffic" / f"{cell['traffic']}.json", name, traffic)
    _derive(bench / "workloads" / f"{like}.json", name,
            {"config": name, "traffic": name, "chips": chips})


def run(bench: Path, cell: str, seed: int = 3_000_000_019, seconds: float = 1.5,
        trace: int = 0, rehearsal: bool = True):
    """(exit code, the result line or None, standard error); on the CPU
    unless ``rehearsal`` is off."""
    lines, err = [], io.StringIO()
    with redirect_stderr(err):
        rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds",
                           str(seconds), "--trace", str(trace)], time.monotonic(),
                          rehearsal=rehearsal, bench_dir=bench, emit=lines.append)
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()

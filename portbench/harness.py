"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result line.

Everything that belongs to a cell is found by name:

- ``workloads/<cell>.json``: the cell's configuration, traffic and cards,
  and the limits its comparison holds the program to;
- ``configs/<config>.json``: the model's sizes as they are run;
- ``traffic/<traffic>.json``: the traffic's parameters, whose
  ``driver`` names the general generator ``traffic/<driver>.py``;
- ``metrics/<metric>.py``: one reader per per-layer metric, ``UNIT``
  and ``read(readings) -> float | None``.

A run prints its checks (each number compared, with its limit) as the
last lines of standard error, and the result as the last line of
standard output.  It prints no result, and exits non-zero, without
enough cards, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "downloader_tpu")


@dataclasses.dataclass
class Check:
    """One number the comparison holds below its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a traffic driver hands back."""

    metrics: Dict[str, tuple]          # end-to-end metric -> (value, unit)
    attempted: int
    failed: int
    checks: List[Check]
    memory_peak_bytes: int
    readings: dict                     # what the per-layer readers read
    # the checks' numbers with the control in the program's place, for
    # the calibration (``calibrate.py``); no benchmark run calls it
    control: Optional[Callable[[str], Dict[str, float]]] = None


@dataclasses.dataclass
class Context:
    """What a traffic driver is given."""

    cell: str
    seed: int
    seconds: float
    trace: bool
    device: str                        # "cuda", or "cpu" in a rehearsal
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    tracer: object
    started: float                     # time.monotonic() at process start
    window_open: Optional[float] = None
    phases: List[tuple] = dataclasses.field(default_factory=list)

    def log(self, msg: str) -> None:
        print(f"portbench: {msg}", file=sys.stderr, flush=True)

    def mark(self, phase: str) -> None:
        """Note that set-up's ``phase`` has ended (logged with the run)."""
        self.phases.append((phase, time.monotonic() - self.started))


def _json(path: Path) -> dict:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def load_module(path: Path):
    """A module of the benchmark by its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_cell(name: str, bench_dir: Path = BENCH_DIR):
    """(cell, config, traffic) files of the cell called ``name``."""
    cell = _json(bench_dir / "workloads" / f"{name}.json")
    config = _json(bench_dir / "configs" / f"{cell['config']}.json")
    traffic = _json(bench_dir / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def load_cell(name: str, bench_dir: Path = BENCH_DIR):
    """(cell, config, traffic, driver module) of the cell called ``name``."""
    cell, config, traffic = read_cell(name, bench_dir)
    driver = load_module(bench_dir / "traffic" / f"{traffic['driver']}.py")
    return cell, config, traffic, driver


def readers(bench_dir: Path = BENCH_DIR) -> Dict[str, object]:
    """Every per-layer metric's reader, by metric name."""
    return {path.name[:-3]: load_module(path)
            for path in sorted((bench_dir / "metrics").glob("*.py"))}


def loaded_forbidden(modules=None) -> List[str]:
    """Top-level names of loaded modules that a run may not load,
    compared whole (``downloader_tpu_torch`` is not ``downloader_tpu``)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names.intersection(FORBIDDEN))


def _select_cards(chips: int) -> None:
    """Make exactly the first ``chips`` cards visible, before CUDA starts."""
    listed = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = ([i.strip() for i in listed.split(",") if i.strip()] if listed
           else [str(i) for i in range(chips)])
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(ids[:chips])


def _fix_caches() -> None:
    """Compiler caches at fixed places inside the checkout."""
    cache = BENCH_DIR / "_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def _parse(argv: List[str]) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="portbench/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def device_info(torch, chips: int, peak: int, rehearsal: bool) -> dict:
    if rehearsal:
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": peak}


def make_context(name: str, cell: dict, config: dict, traffic: dict, seed: int,
                 seconds: float, trace: bool, rehearsal: bool,
                 started: float) -> Context:
    from portbench.devtrace import Tracer

    chips = int(cell["chips"])
    return Context(cell=name, seed=seed, seconds=seconds, trace=trace,
                   device="cpu" if rehearsal else "cuda", chips=chips,
                   config=config, traffic=traffic,
                   limits={k: float(v["limit"]) for k, v in cell["checks"].items()},
                   tracer=Tracer(trace, list(range(chips))), started=started)


def main(argv: List[str], started: float, rehearsal: bool = False,
         bench_dir: Path = BENCH_DIR,
         emit: Callable[[str], None] = print) -> int:
    """Run one cell; returns the exit code.  ``rehearsal`` runs on the
    CPU without looking for a card (the CPU tests' path)."""
    args = _parse(argv)
    cell, config, traffic = read_cell(args.workload, bench_dir)
    chips = int(cell["chips"])
    if not rehearsal:
        _select_cards(chips)
        _fix_caches()
    driver = load_module(bench_dir / "traffic" / f"{traffic['driver']}.py")
    import torch

    if not rehearsal:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"portbench: {args.workload} needs {chips} CUDA card(s), "
                  f"found {found}", file=sys.stderr)
            return 2
    ctx = make_context(args.workload, cell, config, traffic, args.seed,
                       args.seconds, bool(args.trace), rehearsal, started)
    outcome = driver.run(ctx)
    ctx.log("set-up ended at (s): " + ", ".join(f"{p} {t:.3f}" for p, t in ctx.phases))
    gc.collect()
    metrics = {}
    line: dict = {"correct": all(c.ok for c in outcome.checks) and not outcome.failed,
                  "attempted": outcome.attempted, "failed": outcome.failed}
    device = device_info(torch, chips, outcome.memory_peak_bytes, rehearsal)
    if args.trace:
        timeline = ctx.tracer.timeline
        readings = dict(outcome.readings, config=config, traffic=traffic,
                        chips=chips, timeline=timeline,
                        card=None if rehearsal else device["kind"])
        for name, reader in readers(bench_dir).items():
            value = reader.read(readings)
            if value is not None:
                metrics[name] = {"value": value, "unit": reader.UNIT}
        if timeline is not None:
            device["busy_s"] = timeline.mean_busy_s()
            device["window_s"] = timeline.window_s
            line["breakdown"] = {"device_ops": timeline.device_ops(),
                                 "idle_gaps": timeline.idle_gaps()}
    else:
        metrics = {name: {"value": value, "unit": unit}
                   for name, (value, unit) in outcome.metrics.items()}
        metrics["setup_s"] = {"value": ctx.window_open - started, "unit": "s"}
    line["metrics"] = metrics
    line["device"] = device
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in outcome.checks}
    found = loaded_forbidden()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; "
              "the benchmark measures the port alone", file=sys.stderr)
        return 3
    for c in outcome.checks:
        print(f"check {c.name}: {c.value} against limit {c.limit} "
              f"({'ok' if c.ok else 'FAILED'})", file=sys.stderr, flush=True)
    emit(json.dumps(line))
    return 0


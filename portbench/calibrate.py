"""Readings that the limits of a cell's comparison are set from: the
program's numbers over many seeds and the control's (the plain reference
computed in float8 e4m3, put in the program's place) over some of them,
in one process on the card:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 --seconds 3 [--fault half_batch]

With ``--fault`` the program runs with that fault planted
(:mod:`portbench.faults`), for a training cell's upper readings.
One JSON line per seed, then the largest program reading and the
smallest control reading of each number.  Benchmark runs never run the
control."""

import time

STARTED = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import contextlib  # noqa: E402

from portbench import faults, harness  # noqa: E402


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv) -> int:
    parser = argparse.ArgumentParser(prog="portbench/calibrate.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=_seeds, required=True)
    parser.add_argument("--control-seeds", type=_seeds, default=[])
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--fault", choices=faults.FAULTS, default=None,
                        help="plant this fault under the timed path")
    parser.add_argument("--detail", action="store_true",
                        help="print each frame's or step's and leaf's gaps")
    args = parser.parse_args(argv)
    cell, config, traffic = harness.read_cell(args.workload)
    harness._select_cards(int(cell["chips"]))
    harness._fix_caches()
    _, _, _, driver = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench: calibrate needs a CUDA card", file=sys.stderr)
        return 2
    program, control = {}, {}
    for seed in args.seeds:
        ctx = harness.make_context(args.workload, cell, config, traffic, seed,
                                   args.seconds, False, False, time.monotonic())
        with (faults.planted(args.fault, ctx.chips) if args.fault
              else contextlib.nullcontext()):
            outcome = driver.run(ctx)
        line = {"seed": seed, "fault": args.fault, "program": {c.name: c.value for c in outcome.checks},
                "metrics": {k: v[0] for k, v in outcome.metrics.items()}}
        if seed in args.control_seeds:
            line["control"] = outcome.control("fp8")
        if args.detail:
            line["detail"] = outcome.readings.get("compare_detail")
        print(json.dumps(line), flush=True)
        for name, value in line["program"].items():
            program[name] = max(program.get(name, value), value)
        for name, value in line.get("control", {}).items():
            control[name] = min(control.get(name, value), value)
        del outcome
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"largest_program": program, "smallest_control": control}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

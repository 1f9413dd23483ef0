"""Run one cell of the port's benchmark on this machine's cards:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  See ``portbench/harness.py``."""

import time

STARTED = time.monotonic()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, not this folder, is where imports start
sys.path[0] = ROOT

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], STARTED))
